"""The block GEMM's routes against each other at every product it runs, on the card.

    python3 scripts/torch_gemm_routes.py

``ops/hiera_block.block_gemm_plan`` picks one route for each product from
its shape: the ping-pong kernel ("pp"), ``gemm_kernel``'s 128 x 128 tile
("128"), or its 128 x 256 tile for the f32 sum ("256"). This script times
every route at every product shape the block GEMM runs on the main path,
through ``block_gemm_alone`` on random operands with the product's own
epilogue: SigLIP-SO400M's four products on 32 frames, Hiera-L's on 4 frames
(each stage's qkv, proj and fc2, stage 4's fc1, the q-pool fronts) and the
int8-rate probe's f32 sum. Each time is ``chip_smoke.Timer``'s (median of 20
CUDA-event timings, L2 flushed before each launch), beside cuBLAS's for the
same product (``torch.addmm``, or ``torch.mm`` for the f32 sum). A line per
product names the plan's route and the fastest; the card's name and power
limit come first. Needs one CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ufvideo_tpu_torch.configs import UFVideoConfig  # noqa: E402
from ufvideo_tpu_torch.ops import hiera_block as hb  # noqa: E402

SAM_FRAMES = 4  # a [SEG] request's Hiera pass (chip_smoke phase 4)


def products(cfg=None):
    """(label, M, N, K, epilogue) of every product the block GEMM runs on
    the main path; epilogue "none", "res" (residual), "f32" or a GELU."""
    cfg = cfg or UFVideoConfig()
    v, h = cfg.vision, cfg.sam.hiera
    rows = cfg.budget.num_frames * v.num_patches
    c, hw, mlp = v.hidden_size, v.num_heads * v.head_dim, v.intermediate_size
    out = [("SigLIP qkv", rows, 3 * hw, c, "none"), ("SigLIP proj", rows, c, hw, "res"),
           ("SigLIP fc1", rows, mlp, c, "gelu_tanh"), ("SigLIP fc2", rows, c, mlp, "res")]
    side = h.image_size // h.patch_stride
    for i in range(len(h.stages)):
        c = int(h.embed_dim * h.dim_mul ** i)
        mlp, rows = int(c * h.mlp_ratio), SAM_FRAMES * (side >> i) ** 2
        if i:  # the q-pool block's front: stage i - 1's rows into [q | k | v | shortcut]
            out.append((f"Hiera q-pool front {i + 1}", SAM_FRAMES * (side >> (i - 1)) ** 2,
                        4 * c, int(c / h.dim_mul), "none"))
        out += [(f"Hiera stage {i + 1} qkv", rows, 3 * c, c, "none"),
                (f"Hiera stage {i + 1} proj", rows, c, c, "res"),
                (f"Hiera stage {i + 1} fc2", rows, c, mlp, "res")]
        if c > hb.LN_MAX_C:  # narrower stages run LN2 -> fc1 on the LayerNorm-band GEMM
            out.append((f"Hiera stage {i + 1} fc1", rows, mlp, c, "gelu_exact"))
    return out + [("probe bf16", 8192, 4304, 1152, "f32")]


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    worse = []
    for label, m, n, k, epi in products():
        f32 = epi == "f32"
        a = rn(m, k).to(torch.bfloat16)
        w = (rn(k, n) * k ** -0.5).to(torch.bfloat16)
        bias = None if f32 else 0.1 * rn(n)  # the probe's sum has no bias
        r = rn(m, n).to(torch.bfloat16) if epi == "res" else None
        act = epi if epi.startswith("gelu") else None
        plan = hb.block_gemm_plan(m, n, k, sms, f32=f32)
        ms = {}
        for route in ("pp", "128") + (("256",) if f32 else ()):
            ms[route] = timer.ms(lambda: hb.block_gemm_alone(a, w, bias, residual=r, act=act,
                                                             f32=f32, route=route))
        if f32:
            lib_ms = timer.ms(lambda: torch.mm(a, w))
        else:
            lib_ms = timer.ms(lambda: torch.addmm(bias.to(torch.bfloat16), a, w))
        fastest = min(ms, key=ms.get)
        tflops = 2 * m * n * k / ms[plan.route] * 1e-9
        print(f"{label} [M {m}, N {n}, K {k}, {epi}]: "
              + ", ".join(f"{rt} {t:.4f}" for rt, t in ms.items())
              + f" ms; cuBLAS {lib_ms:.4f}; plan {plan.route} ({tflops:.0f} TFLOP/s, "
              f"{ms[plan.route] / lib_ms:.3f}x cuBLAS), fastest {fastest} "
              f"({ms[plan.route] / ms[fastest]:.3f}x)", flush=True)
        if fastest != plan.route:
            worse.append(f"{label}: {fastest} {ms[fastest]:.4f} < {plan.route} "
                         f"{ms[plan.route]:.4f} ms")
    print("the plan's route is the fastest at every product" if not worse else
          "a faster route than the plan's: " + "; ".join(worse), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
