"""The quantised products (``int8_matvec``, ``int4_matmul``) at several
grids, on the card: which grid the wrapper's plan picks, the time of each
grid, and ``torch.mm``.

    python3 scripts/torch_matvec_sweep.py                 # one row
    python3 scripts/torch_matvec_sweep.py --rows 1,8,32   # and the 2-32-row kernel

At each of Qwen2-7B's five projections (``chip_smoke.projection_shapes``),
each row count of ``--rows``, weights quantised from a random float kernel
as phase 2 of ``chip_smoke.py`` makes them (int4: group 64), and each grid:
at one row, ``matvec_plan``'s and 1 to 16 slices of the contraction, each
split of 2 to 8 slices in one launch and in two; at 2-32 rows,
``rows_plan``'s and, for each count of column groups of warps, every
split into 1 to 8 slices that fits the block's shared memory, in one
launch where it has 2 to 8 slices and in two. For
each: the kernel against its plain version (``chip_smoke.check_close`` at
``QREL``), its time as ``chip_smoke.Timer`` takes it (median of 20
CUDA-event timings, L2 flushed before each), the rate on the weight and
scale bytes, and the device time of the streaming pass and of the second
pass (0 in one launch) from ``torch.profiler`` over 20 back-to-back calls
(L2 warm). Prints one line a (bits, projection, rows, grid) and the card's
name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from ufvideo_tpu_torch import quant  # noqa: E402
from ufvideo_tpu_torch.configs import UFVideoConfig  # noqa: E402
from ufvideo_tpu_torch.ops import quant_matmul as qm  # noqa: E402

GROUP = 64


def pass_us(fn, n=20):
    """Device microseconds a call of the streaming pass and the second pass."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = defaultdict(float)
    for e in prof.key_averages():
        if "matvec_row_kernel" in e.key or "rows_kernel" in e.key:
            us["stream"] += e.device_time_total / n
        elif "finish_kernel" in e.key:
            us["finish"] += e.device_time_total / n
    return us


def rows_grids(rows, din, dout, bits, sms):
    """The 2-32-row plan and, for each count of column groups of warps the
    kernel has (one or two with 16-byte loads, two or four with 8), each split of
    the contraction into 1 to 8 slices of whole block steps that fits the
    block's shared memory, each split of 2 or more in one launch and in
    two."""
    plan = qm.rows_plan(rows, din, dout, bits, sms, True, GROUP)
    depth = din if bits == 8 else din // 2
    steps = -(-depth // qm._RW_STEP)
    grids = {plan}
    narrow = 2 if plan.vec == 8 else 1
    for wc in (narrow, 2 * narrow):
        cols = wc * 8 * plan.vec
        for want in range(1, 9):
            per_slice = -(-steps // want)
            kchunk = per_slice * qm._RW_STEP
            smem = qm.rows_smem(bits, plan.tiles, plan.vec, wc, kchunk, GROUP)
            if smem > qm._RW_SMEM:
                continue
            ksplit = -(-steps // per_slice)
            for cluster in {1, ksplit}:
                grids.add(plan._replace(wc=wc, cols=cols, ksplit=ksplit, kchunk=kchunk,
                                        cluster=cluster, blocks=-(-dout // cols) * ksplit,
                                        smem=smem))
    return plan, grids


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1", help="comma-separated row counts, 1 to 32")
    args = ap.parse_args()
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
    for bits in (8, 4):
        for pname, (din, dout) in cs.projection_shapes(UFVideoConfig()).items():
            w = torch.randn(din, dout, generator=gen, device=dev) * din ** -0.5
            if bits == 8:
                qd = quant.quantize_kernel(w)
                wb = (qd["q"].float() * qd["scale"]).to(torch.bfloat16)
                plain = lambda x: qm.int8_matvec_plain(x, qd["q"], qd["scale"])
            else:
                qd = quant.quantize_kernel4(w, GROUP)
                wb = qm.dequantize_int4(qd["q"], qd["scale"], GROUP, torch.bfloat16)
                plain = lambda x: qm.int4_matmul_plain(x, qd["q"], qd["scale"], GROUP)
            del w
            q, s = qd["q"], qd["scale"]
            nbytes = cs.nbytes(q, s)
            for rows in (int(r) for r in args.rows.split(",")):
                x = torch.randn(rows, din, generator=gen, device=dev).to(torch.bfloat16)
                lib = timer.ms(lambda: torch.mm(x, wb))
                want = plain(x)
                if rows == 1:
                    plan = qm.matvec_plan(din, dout, bits, sms)
                    grids = {plan}
                    for n_split in (1, 2, 4, 5, 6, 7, 8, 12, 16):
                        for one_launch in (True, False):
                            grids.add(qm.split_rows(q.shape[0], dout, plan.vec, n_split,
                                                    one_launch))
                    launch = qm._launch_row
                else:
                    plan, grids = rows_grids(rows, din, dout, bits, sms)
                    launch = qm._launch_rows
                for p in sorted(grids):
                    name = f"int{bits} {pname} [{rows},{din}]x[{din},{dout}] {p}"
                    run = lambda: launch(x, q, s, bits, GROUP, p)
                    got = run()
                    torch.cuda.synchronize()
                    cs.check_close(name, got, want, row_rel=cs.QREL, rtol=cs.QREL,
                                   fro=cs.QREL)
                    ms = timer.ms(run)
                    us = pass_us(run)
                    print(f"{name}{' (plan)' if p == plan else ''}: {ms:.4f} ms, "
                          f"{nbytes / ms / 1e6:.0f} GB/s, torch.mm {lib:.4f} ms, ratio "
                          f"{ms / lib:.3f}; warm device us: stream {us['stream']:.2f}, "
                          f"finish {us['finish']:.2f}", flush=True)
            del qd, q, s, wb
            torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
