"""The decode-attention kernels (bf16 and int8 cache) at every chunk of
``decode_split_plan``'s set, on the card: which chunk the plan picks, the
time of the kernel pair at each chunk, and how that time splits between the
partial pass and the combine pass.

    python3 scripts/torch_decode_sweep.py

At each of ``chip_smoke.DECODE_SHAPES`` (Qwen2-7B's 4 kv heads of 7 query
heads, a 2944-position cache, batch 1 and a ragged batch of 4), on the
inputs ``chip_smoke.decode_inputs`` makes, and each chunk: the kernel
against its plain version (``chip_smoke.check_close``), the pair's time as
``chip_smoke.Timer`` takes it (median of 20 CUDA-event timings, L2 flushed
before each), SDPA's time on the same inputs, the rate on the valid
cache's bytes, and the device time of each of the two kernels from
``torch.profiler`` over 20 back-to-back calls (L2 warm).
Prints one line a (kind, shape, chunk) and the card's name and power
limit. Needs one CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from ufvideo_tpu_torch.ops import decode_attention as da  # noqa: E402


def split_us(fn, n=20):
    """Device microseconds a call of each decode kernel, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = defaultdict(float)
    for e in prof.key_averages():
        if "decode_partial" in e.key or "decode_combine" in e.key:
            us["partial" if "partial" in e.key else "combine"] += e.device_time_total / n
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for kind in ("bf16", "q8"):
        for label, b, s, lens in cs.DECODE_SHAPES:
            lens = lens or cs.DECODE_B1_LENS[kind]
            t = cs.decode_inputs(kind, b, s, lens, gen, dev)
            lib = timer.ms(t["library"])
            plan = da.decode_split_plan(b, 4, s, sms)
            for chunk in da.CHUNKS:
                name = f"{kind} B={b} lens {lens} chunk {chunk}"
                got, want = t["launch"](chunk), t["plain"]()
                torch.cuda.synchronize()
                cs.check_close(name, got, want)
                ms = timer.ms(lambda: t["launch"](chunk))
                us = split_us(lambda: t["launch"](chunk))
                print(f"{name}{' (plan)' if chunk == plan else ''}: {ms:.4f} ms, SDPA "
                      f"{lib:.4f} ms, ratio {ms / lib:.3f}, {t['seen'] / ms / 1e6:.0f} GB/s; "
                      f"warm device us: partial {us['partial']:.2f}, combine "
                      f"{us['combine']:.2f}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
