"""The card's raw matrix-product rate, s8 × s8 → s32 against bf16 × bf16 →
f32, through the library and through the hand-written kernels (the
counterpart of ``scripts/probe_int8_rate.py``).

    python -m ufvideo_tpu_torch.probe_int8_rate [--iters 50]

from the root of a checkout (the package is not installed: ``-m`` finds it
on the path of the working directory); it needs an NVIDIA GPU.

At SigLIP's fc1 shape, rows of one 64-image batch rounded to 8192:
[8192, 1152] × [1152, 4304]. Four variants, one JSON line each with its
milliseconds a product and its rate in TOP/s (2·M·K·N operations):

- ``bf16_torch``: ``torch.mm`` on bf16 operands (cuBLAS; bf16 out);
- ``int8_torch``: ``torch._int_mm`` on int8 operands (cuBLASLt; the x side
  quantised before the timed products: the raw s8 rate), the weights handed
  over K-contiguous (column-major), the layout its int8 kernels take;
- ``bf16_kernel``: ``probe_step(x, w, quant=False)``, the bf16 GEMM of
  ``csrc/hiera_block.cu`` with an f32 epilogue;
- ``int8_kernel``: ``probe_step(x, wq, quant=True)``, its int8 GEMM, with x
  rounded half to even and clipped to ±127 by a pass of its own, as the TPU
  kernel ``_pallas_dot_kernel`` does in its body, and the weights transposed
  first.

Each time is the mean of ``iters`` products back to back between two CUDA
events after a warm-up (operands stay in L2 between products: the probe
measures the product's rate, not the memory's). Bound on an H100 at this
shape: 81.2 G operations, 0.041 ms at 1979 TOP/s (int8), 0.082 ms at 989
TFLOP/s (bf16). The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from . import _build
from .ops.hiera_block import _lib, _pad32

# SigLIP fc1: rows of one 64-image batch of 729 tokens, rounded; (in, out)
ROWS, DIN, DOUT = 8192, 1152, 4304


def round_clip_s8_plain(x: torch.Tensor, kp: int) -> torch.Tensor:
    """The probe's int8 x in plain PyTorch: x [M, K] rounded half to even and
    clipped to ±127, as int8 [M, kp] with zeros in columns K..kp (the kernel
    ``round_clip_s8`` writes the same into the GEMM's scratch)."""
    q = torch.round(x.float()).clamp(-127, 127).to(torch.int8)
    return torch.nn.functional.pad(q, (0, kp - x.shape[1]))


def probe_step_plain(x: torch.Tensor, w: torch.Tensor, quant: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch: with ``quant`` x rounded half
    to even and clipped to ±127, times int8 w, the int32 sums exact (float64
    holds them); else x · w in f32."""
    if quant:
        q = round_clip_s8_plain(x, x.shape[1])
        return (q.double() @ w.double()).to(torch.int32)
    return x.float() @ w.float()


def probe_step(x: torch.Tensor, w: torch.Tensor, quant: bool) -> torch.Tensor:
    """One product of the probe: bf16 x [M, K] with bf16 w [K, N] → f32, or
    with ``quant`` int8 w [K, N] → int32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (K a multiple of 8; N a multiple
    of 8, or even with ``quant``)."""
    if x.device.type == "cpu":
        return probe_step_plain(x, w, quant)
    if x.device.type != "cuda":
        raise ValueError(f"probe_step: unsupported device {x.device}")
    want = torch.int8 if quant else torch.bfloat16
    if x.dtype != torch.bfloat16 or w.dtype != want:
        raise TypeError(f"probe_step takes bf16 x and {want} w")
    m, k = x.shape
    n = w.shape[1]
    if w.shape[0] != k or k % 8 or n % (2 if quant else 8) or min(m, k, n) == 0:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    x, w = x.contiguous(), w.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    if quant:
        wt = torch.empty((n, _pad32(k)), dtype=torch.int8, device=x.device)
        xq = torch.empty((m, _pad32(k)), dtype=torch.int8, device=x.device)
        y = torch.empty((m, n), dtype=torch.int32, device=x.device)
        code = lib.probe_gemm_s8(x.data_ptr(), w.data_ptr(), wt.data_ptr(), xq.data_ptr(),
                                 y.data_ptr(), m, k, n, stream)
    else:
        y = torch.empty((m, n), dtype=torch.float32, device=x.device)
        code = lib.probe_gemm_bf16(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n, stream)
    _build.check(lib, code, "probe_step")
    _build.count_launch(probe_step)
    return y


probe_step.launches = 0


def gemm_s8_alone(qa: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The int8 GEMM of ``probe_step`` without its two preparation passes:
    int32 [M, N] = qa [M, Kp] · bt [N, Kp]ᵀ, both int8 and K-contiguous (Kp a
    multiple of 16, N even), on the card only. A measuring instrument
    (``scripts/torch_s8_sweep.py``): no model path calls it, so it counts
    nothing."""
    if qa.device.type != "cuda" or bt.device != qa.device:
        raise ValueError(f"gemm_s8_alone: unsupported devices {qa.device}, {bt.device}")
    if qa.dtype != torch.int8 or bt.dtype != torch.int8:
        raise TypeError("gemm_s8_alone takes int8 qa and bt")
    (m, kp), n = qa.shape, bt.shape[0]
    if bt.shape[1] != kp or kp % 16 or n % 2 or min(m, kp, n) == 0:
        raise ValueError(f"unsupported shapes qa {tuple(qa.shape)} bt {tuple(bt.shape)}")
    qa, bt = qa.contiguous(), bt.contiguous()
    y = torch.empty((m, n), dtype=torch.int32, device=qa.device)
    lib = _lib()
    code = lib.gemm_s8_s32(qa.data_ptr(), bt.data_ptr(), y.data_ptr(), m, kp, n,
                           torch.cuda.current_stream(qa.device).cuda_stream)
    _build.check(lib, code, "gemm_s8_alone")
    return y


def probe_inputs(dev, seed: int = 0, rows: int = ROWS, din: int = DIN, dout: int = DOUT):
    """(x bf16 [rows, din] of scale 4, bf16 w, int8 w of scale 30), drawn on
    ``dev`` from ``seed``, as the JAX probe draws them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = (rn(rows, din) * 4.0).to(torch.bfloat16)
    wf = rn(din, dout).to(torch.bfloat16)
    wq = torch.round(rn(din, dout) * 30).clamp(-127, 127).to(torch.int8)
    return x, wf, wq


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(dev, iters: int = 50, seed: int = 0) -> list:
    """The four variants on ``dev``: [{"variant", "ms", "tops"}]."""
    x, wf, wq = probe_inputs(dev, seed)
    xq = round_clip_s8_plain(x, DIN)
    wq_cols = wq.t().contiguous().t()
    ops = 2.0 * ROWS * DIN * DOUT
    variants = [
        ("bf16_torch", lambda: torch.mm(x, wf)),
        ("int8_torch", lambda: torch._int_mm(xq, wq_cols)),
        ("bf16_kernel", lambda: probe_step(x, wf, False)),
        ("int8_kernel", lambda: probe_step(x, wq, True)),
    ]
    out = []
    for tag, fn in variants:
        ms = time_ms(fn, iters)
        out.append({"variant": tag, "ms": ms, "tops": ops / (ms * 1e-3) / 1e12})
    return out


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_int8_rate: CUDA is not available; the probe needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    for rec in run(torch.device("cuda", 0), args.iters, args.seed):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
