"""Where a tile's time goes in the block GEMM's ping-pong kernel, on the card.

    python3 scripts/torch_gemm_stamps.py

Builds ``csrc/hiera_block.cu`` a second time with ``-DUFV_STAMPS`` (``nvcc``
with the package's flags) into ``ufvideo_tpu_torch/_build/stamps/``; the
package's own build, without it, is the one the port runs. With
``UFV_STAMPS`` every consumer warpgroup of ``gemm_pp_kernel`` reads
``clock64`` at four points of each of its tiles: before its first wait on
the ring, when the tile's first stage has landed, after its last product,
after its epilogue, into a buffer sized here for the launch.

For each product, through the C entry ``block_gemm_bf16`` on the ping-pong
route, on random operands: the product's time in the package's build and in
the stamped one (``chip_smoke.Timer``: median of 20 CUDA-event timings, L2
flushed before each launch), cuBLAS's time for the same product
(``torch.addmm`` or ``torch.mm``), and from one stamped launch the mean
cycles a tile spends waiting for its first stage, in its products and in
its epilogue. The stamped build's output must equal the package's bit for
bit. Products: SigLIP-SO400M's qkv (no activation), proj and fc2
(residual), fc1 (tanh GELU) at M = 23328, Hiera stage 4's fc1 (erf GELU) at
M = 4096, and the probe's product with its f32 sum. The card's name and
power limit come first; the SM clock last. Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ufvideo_tpu_torch import _build  # noqa: E402
from ufvideo_tpu_torch.ops import hiera_block as hb  # noqa: E402

# (label, M, N, K, epilogue): none, res (residual), f32, or a GELU
PRODUCTS = (
    ("SigLIP qkv", 23328, 3456, 1152, "none"),
    ("SigLIP proj", 23328, 1152, 1152, "res"),
    ("SigLIP fc1", 23328, 4304, 1152, "gelu_tanh"),
    ("SigLIP fc2", 23328, 1152, 4304, "res"),
    ("Hiera stage 4 fc1", 4096, 4608, 1152, "gelu_exact"),
    ("probe bf16", 8192, 4304, 1152, "f32"),
)
PP = 0  # block_gemm_bf16's route code of the ping-pong kernel


def build_stamped() -> ctypes.CDLL:
    out = os.path.join(str(_build.BUILD_DIR), "stamps")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "hiera_block.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DUFV_STAMPS", "-I", str(_build.CSRC), "-o", so,
           str(_build.CSRC / "hiera_block.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    lines = proc.stdout.splitlines()
    for i, line in enumerate(lines):
        if "gemm_pp_kernel" in line and "entry function" in line:
            print(f"  stamped: {line.split('entry function')[1].strip()[:60]} "
                  f"{' | '.join(x.split(':', 1)[-1].strip() for x in lines[i + 1:i + 3])}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.block_gemm_bf16.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.ufv_stamps_set.argtypes = [p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {"package": hb._lib(), "stamped": build_stamped()}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, m, n, k, epi in PRODUCTS:
        a = rn(m, k).to(torch.bfloat16)
        w = (rn(k, n) * k ** -0.5).to(torch.bfloat16)
        bias = None if epi == "f32" else 0.1 * rn(n)
        r = rn(m, n).to(torch.bfloat16) if epi == "res" else None
        y = torch.empty(m, n, dtype=torch.float32 if epi == "f32" else torch.bfloat16,
                        device=dev)
        code = 2 if epi == "f32" else 1 if epi == "res" else 0
        act = hb._ACT_CODES.get(epi, 0)
        ptr = lambda t: None if t is None else t.data_ptr()

        def run(lib):
            e = lib.block_gemm_bf16(ptr(a), ptr(w), ptr(bias), ptr(r), y.data_ptr(), m, n, k,
                                    act, code, PP, stream)
            if e:
                cs.fail(f"{label}: CUDA error {e}")

        if epi == "f32":
            lib_ms = timer.ms(lambda: torch.mm(a, w))
        else:
            lib_ms = timer.ms(lambda: torch.addmm(bias.to(torch.bfloat16), a, w))
        ms = {"package": timer.ms(lambda: run(libs["package"]))}
        run(libs["package"])
        want = y.clone()
        # [grid][2 warpgroups][tiles a warpgroup takes at most][4 stamps]
        plan = hb.gemm_route_plan("pp", m, n, k, sms, f32=epi == "f32")
        per = -(-plan.tiles // (2 * plan.grid))
        stamps = torch.zeros(plan.grid * 2 * per, 4, dtype=torch.int64, device=dev)
        libs["stamped"].ufv_stamps_set(stamps.data_ptr())
        ms["stamped"] = timer.ms(lambda: run(libs["stamped"]))
        stamps.zero_()
        run(libs["stamped"])
        torch.cuda.synchronize()
        libs["stamped"].ufv_stamps_set(None)
        same = torch.equal(want, y)
        st = stamps[stamps[:, 3] != 0].double().cpu()
        wait, main, epil = ((st[:, i + 1] - st[:, i]).mean().item() for i in range(3))
        tflops = 2 * m * n * k / ms["package"] * 1e-9
        print(f"{label} [M {m}, N {n}, K {k}, {epi}]: {ms['package']:.4f} ms "
              f"({tflops:.0f} TFLOP/s), stamped {ms['stamped']:.4f} ms, cuBLAS {lib_ms:.4f} ms; "
              f"a tile's cycles: wait {wait:.0f}, products {main:.0f}, epilogue {epil:.0f} "
              f"({len(st)} of {plan.tiles} tiles stamped); stamped output equal: {same}",
              flush=True)
        if not same or len(st) != plan.tiles:
            cs.fail(f"{label}: the stamped build changed the result or missed a tile")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"SM clock, max: {clocks.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
