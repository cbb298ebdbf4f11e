"""The batched quantised decode step on the card: its wall time, its
device-busy time and the device time of its quantised products.

    python3 scripts/torch_batch_decode.py [--package-root DIR] [--repeats 3]

Builds the int8 serving runtime (``quant_llm="int8"``, int8 KV cache, W8A8
SigLIP) and the int4 runtime (bf16 cache and towers) of full-width UFVideo
(random weights, seed 0), encodes one video of 32 uint8 frames (480x640)
and decodes ``chip_smoke.BATCH_QUESTIONS`` (8 questions of different
lengths) on it through ``UFVideoRuntime.generate_batch``, as phase 5b of
``chip_smoke.py`` does. Under ``torch.profiler``, ``--repeats`` times: one
call for 1 new token, one for 16; a decode step is their difference over
15 steps, in wall time, in device-busy time (the union of kernel
intervals) and in the device time of the kernels of ``int8_matvec`` /
``int4_matmul``. One JSON line a runtime and repeat, after the card's name
and power limit.

``--package-root`` imports ``ufvideo_tpu_torch`` (which builds its kernels
from its own sources) and ``chip_smoke`` from another checkout, such as a
parent commit unpacked beside this one, so that two versions are compared
in one call on one card: parent, change, change, parent. Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_trace  # noqa: E402  (puts this checkout's root on sys.path)

NEW_TOKENS = 16
# the quantised products' kernels, before and after their 2-32-row redesign
PRODUCT_KERNELS = ("int8_matvec_kernel", "int4_matmul_kernel", "rows_kernel",
                   "matvec_row_kernel", "finish_kernel")


def _stage_times(prof) -> dict:
    """Per ``stage:`` range: wall, device-busy and product-kernel ms."""
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in events if e.name.startswith("stage:") and e.device_type == cpu}
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith("stage:")]
    out = {}
    for stage, (s, e) in ranges.items():
        inside = [k for k in kernels if s <= k.time_range.start < e]
        out[stage] = {
            "wall": (e - s) / 1e3,
            "busy": torch_trace._busy_us(
                [(k.time_range.start, k.time_range.end) for k in inside]) / 1e3,
            "products": sum(k.time_range.end - k.time_range.start for k in inside
                            if any(p in k.name for p in PRODUCT_KERNELS)) / 1e3,
        }
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package-root", default="",
                    help="import ufvideo_tpu_torch and chip_smoke from this checkout")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: needs a CUDA card", flush=True)
        return 1
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))

    import ufvideo_tpu_torch
    from chip_smoke import BATCH_QUESTIONS
    from ufvideo_tpu_torch import model_init
    from ufvideo_tpu_torch.api import _assemble_input_ids
    from ufvideo_tpu_torch.configs import UFVideoConfig
    from ufvideo_tpu_torch.ops.image_pipeline import siglip_preprocess_device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    package = os.path.dirname(os.path.dirname(os.path.abspath(ufvideo_tpu_torch.__file__)))
    dev = torch.device("cuda", 0)
    frames = np.random.default_rng(2).integers(0, 256, (32, 480, 640, 3), dtype=np.uint8)
    full = UFVideoConfig()
    for label, cfg in (("int8", full.replace(quant_llm="int8", quant_kv=True, quant_vision=True)),
                       ("int4", full.replace(quant_llm="int4"))):
        rt, _, tok = model_init(cfg=cfg, device=dev, seed=0)
        pixels = siglip_preprocess_device(torch.from_numpy(frames).to(dev), rt.cfg.compute_dtype)
        feats = rt.encode_video(pixels[None])
        ids = [_assemble_input_ids(q, 1, "<video>", tok) for q in BATCH_QUESTIONS]
        vf = feats.expand(len(ids), -1, -1)
        rt.generate_batch(ids, vf, max_new_tokens=2)  # build and warm up
        torch.cuda.synchronize()
        for rep in range(args.repeats):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for n in (1, NEW_TOKENS):
                    with record_function(f"stage:{n}"):
                        out, _ = rt.generate_batch(ids, vf, max_new_tokens=n)
                        torch.cuda.synchronize()
            t = _stage_times(prof)
            steps = max(len(o[0]) for o in out) - 1
            step = {k: (t[f"stage:{NEW_TOKENS}"][k] - t["stage:1"][k]) / steps
                    for k in ("wall", "busy", "products")}
            print(json.dumps({
                "package": package, "runtime": label, "batch": len(ids), "repeat": rep,
                "steps": steps, "step_wall_ms": step["wall"], "step_busy_ms": step["busy"],
                "step_products_ms": step["products"],
                "step_idle_share": 1 - step["busy"] / step["wall"]}), flush=True)
        del rt, feats, vf, pixels
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
