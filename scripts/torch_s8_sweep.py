"""The int8 GEMM of ``csrc/hiera_block.cu`` against its bf16 GEMM and the
libraries, at every product shape of the W8A8 blocks, on the card.

    python3 scripts/torch_s8_sweep.py

Shapes (M, K, N): SigLIP-SO400M's qkv / proj / fc1 / fc2 at M = 32 frames x
729 tokens = 23328, and SAM2 Hiera-L's four products at each of its four
stages (C = 144 / 288 / 576 / 1152, MLP 4C) at the rows of 4 frames
(262144 / 65536 / 16384 / 4096). For each, four products on the same
random operands:

- ``s8 kernel``: ``probe_int8_rate.gemm_s8_alone``, the int8 GEMM alone
  (int8 operands already rounded, K zero-padded to a multiple of 32 and the
  weights transposed to [N, Kp], as the W8A8 entry points hand them over;
  int32 out), checked equal to ``torch._int_mm``;
- ``_int_mm``: ``torch._int_mm`` (cuBLASLt) on the same int8 values, the
  weights K-contiguous, the layout its int8 kernels take (int32 out);
- ``bf16 kernel``: ``probe_int8_rate.probe_step(quant=False)``, the bf16
  GEMM of the same file (f32 out);
- ``torch.mm``: cuBLAS on bf16 operands (bf16 out).

Each time is ``chip_smoke.Timer``'s (median of 20 CUDA-event timings, L2
flushed before each launch). Each line gives the four times, the s8
kernel's rate and its bound (``chip_smoke.bound_ms``: 2·M·K·N int8
operations at 1979 TOP/s, or its operands read once and its int32 sums
written once at 3.35 TB/s, whichever is longer), and the
int8 : bf16 rate through the kernels (bf16 kernel ms / s8 kernel ms) and
through the libraries (``torch.mm`` ms / ``_int_mm`` ms). The card's name
and power limit come first. Needs one CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from ufvideo_tpu_torch import probe_int8_rate as pr  # noqa: E402


def shapes():
    """(label, M, K, N) of every int8 product of the W8A8 blocks."""
    out = []
    c, mlp, rows = 1152, 4304, 32 * 729
    for name, k, n in (("qkv", c, 3 * c), ("proj", c, c), ("fc1", c, mlp), ("fc2", mlp, c)):
        out.append((f"SigLIP {name}", rows, k, n))
    for stage, (c, rows) in enumerate(((144, 262144), (288, 65536), (576, 16384),
                                       (1152, 4096)), start=1):
        for name, k, n in (("qkv", c, 3 * c), ("proj", c, c), ("fc1", c, 4 * c),
                           ("fc2", 4 * c, c)):
            out.append((f"Hiera stage {stage} {name}", rows, k, n))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_s8_sweep.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, m, k, n in shapes():
        kp = -(-k // 32) * 32
        q = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        qa = torch.nn.functional.pad(q, (0, kp - k)).contiguous()
        bt = torch.nn.functional.pad(w.t(), (0, kp - k)).contiguous()
        w_cols = w.t().contiguous().t()
        x, wf = q.to(torch.bfloat16), w.to(torch.bfloat16)
        got, want = pr.gemm_s8_alone(qa, bt), torch._int_mm(q, w_cols)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            print(f"FAILED: {label}: the s8 kernel's sums differ from torch._int_mm's")
            return 1
        del got, want
        ms = {
            "s8 kernel": timer.ms(lambda: pr.gemm_s8_alone(qa, bt)),
            "_int_mm": timer.ms(lambda: torch._int_mm(q, w_cols)),
            "bf16 kernel": timer.ms(lambda: pr.probe_step(x, wf, False)),
            "torch.mm": timer.ms(lambda: torch.mm(x, wf)),
        }
        ops = 2.0 * m * k * n
        bound, by = cs.bound_ms(cs.nbytes(q, w) + 4 * m * n, 0.0, ops)
        print(f"{label} [M {m}, K {k}, N {n}]: "
              + ", ".join(f"{v} {t:.4f} ms" for v, t in ms.items())
              + f"; s8 kernel {ops / ms['s8 kernel'] / 1e9:.0f} TOP/s, bound {bound:.4f} ms "
              f"({by}); int8 : bf16 kernels {ms['bf16 kernel'] / ms['s8 kernel']:.3f}, libraries "
              f"{ms['torch.mm'] / ms['_int_mm']:.3f}", flush=True)
        del q, w, qa, bt, w_cols, x, wf
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
