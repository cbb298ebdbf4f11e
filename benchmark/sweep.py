"""The rate sweep: the highest rate of an open loop that the port sustains.

    python3 benchmark/sweep.py --rates 1.5,2,2.5,3,3.5,4,5 --seconds 40 --seed 1

Builds the configuration's runtime once (``--config``, default
``ufvideo-7b.bf16``), then for each rate a fresh engine with ``--max-slots``
slots, one warm-up request, and the open loop of the traffic mix
(``--traffic``, default ``qa_open``: short answers) at that rate for
``--seconds``, every due request waited for. One JSON line a rate: the
latency p50 / p85 / p90 from the due time, the requests outstanding at
mid-window and at the close, and the median latency of the window's last
third over its first third. The backlog grew where the close holds more than
half the slots more outstanding requests than mid-window does, or the last
third waited more than one and a half times as long. An open-loop cell runs
at 0.8 of the highest rate whose backlog did not grow; run this again when
that knee moves.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def percentile(values, q: float) -> float:
    """Nearest rank: the smallest value with at least ``q`` of them at or below."""
    v = sorted(values)
    return v[max(math.ceil(q * len(v)) - 1, 0)]


def outstanding(records, t: float) -> int:
    return sum(r.sent <= t and not (r.done <= t) for r in records)


def measure(rt, tok, params, slots: int, rate: float, seconds: float, seed: int,
            video_tokens: int) -> dict:
    """One rate of the sweep: a fresh engine, one warm-up request, the open
    loop for ``seconds``, the line's readings."""
    import numpy as np

    from benchmark import generator, harness, port

    params = dict(params, rate=rate)
    pool = generator.make_pool(params, seed)
    reqs = generator.requests(params, seed, int(math.ceil(rate * seconds)) + 2 * params["stratum"])
    engine = port.make_engine(rt, tok, {"max_slots": slots, "max_new_cap": 512})
    try:
        harness.warm_up(engine, params, pool, seed, 1, video_tokens, {r.offset for r in reqs})
        records, w0, w1, lateness = harness.open_loop(engine, reqs, params, pool, seconds,
                                                      video_tokens)
    finally:
        engine.close()
    lat = [1e3 * (r.done - r.due) if r.finished() else math.inf for r in records]
    third = len(records) // 3
    ratio = (float(np.median(lat[-third:])) / float(np.median(lat[:third]))
             if third else math.nan)
    mid, end = outstanding(records, (w0 + w1) / 2), outstanding(records, w1)
    return {
        "rate": rate, "requests": len(records),
        "failed": sum(r.error is not None for r in records),
        "p50_ms": percentile(lat, 0.5), "p85_ms": percentile(lat, 0.85),
        "p90_ms": percentile(lat, 0.9), "late_max_ms": 1e3 * max(lateness, default=0.0),
        "outstanding_mid": mid, "outstanding_end": end, "last_over_first": ratio,
        "grew": bool(end - mid > slots / 2 or ratio > 1.5),
    }


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="ufvideo-7b.bf16")
    ap.add_argument("--traffic", default="qa_open")
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    from benchmark import harness, port
    from benchmark.reference import checkpoint, model as ref_model

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    params = harness.load_json(harness.HERE / "traffic" / f"{args.traffic}.json")
    if params["loop"] != "open":
        print(f"{args.traffic} is not an open loop", file=sys.stderr)
        return 2
    model_cfg = harness.load_json(harness.HERE / "configs" / f"{args.config}.json")["model"]
    dev = torch.device("cuda:0")
    port.build_kernels()
    sd = checkpoint.make_state_dict(model_cfg, args.seed, dev)
    rt, tok = port.build_runtime(model_cfg, sd, dev)
    del sd
    torch.cuda.empty_cache()
    video_tokens = ref_model.video_token_count(model_cfg)
    for rate in (float(r) for r in args.rates.split(",")):
        print(json.dumps(measure(rt, tok, params, args.max_slots, rate, args.seconds,
                                 args.seed, video_tokens)), flush=True)
        time.sleep(1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
