"""Offered-load benchmark of the serving core (the port of
``scripts/loadtest.py``).

Drives N concurrent clients against the in-process engine or scheduler (no
HTTP: this measures the serving core) and prints requests/s, token
throughput and latency percentiles as ONE JSON line::

    # smoke: random tiny weights on the CPU
    python -m ufvideo_tpu_torch.loadtest --tiny --device cpu --mode engine \\
        --clients 8 --requests 32

    # full width on the card, random weights
    python -m ufvideo_tpu_torch.loadtest --mode engine --quant int8 \\
        --pixel-dtype uint8 --clients 8 --requests 16 --max-new 32

The line's ``name`` is ``serve_loadtest``, or ``serve_loadtest_zero_llm``
with ``"zero_llm": true`` under ``--zero-llm``: a synthetic workload is never
reported under the plain name. It runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from .serve import add_model_args, runtime_from_args


def zero_llm(rt) -> None:
    """Zero every parameter and buffer of the LLM (on a quantised model the
    int8 / packed int4 weights and their scales too): constant logits make
    generation repetitive, so prompt-lookup speculation accepts almost every
    draft. The towers stay random, so admission costs what it costs."""
    with torch.no_grad():
        for t in list(rt.model.llm.parameters()) + list(rt.model.llm.buffers()):
            t.zero_()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m ufvideo_tpu_torch.loadtest",
                                description="offered-load benchmark of the serving core")
    add_model_args(p, quant="none")
    p.add_argument("--mode", default="engine", choices=["engine", "scheduler"],
                   help="engine = slot continuous batching; scheduler = admission batching")
    p.add_argument("--spec", type=int, default=0,
                   help="speculative draft length (engine: spec_k; scheduler: spec_decode)")
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--stream-every", type=int, default=0,
                   help="every Nth request streams (0 = none)")
    p.add_argument("--zero-llm", action="store_true",
                   help="zero the LLM's weights after init: the upper bracket of "
                        "speculation's acceptance (random weights are the floor); the run "
                        "is labelled synthetic")
    p.add_argument("--pixel-dtype", default="float32", choices=["float32", "uint8"],
                   help="client frames: float32 = preprocessed frames; uint8 = raw frames "
                        "resized and normalised on the device")
    args = p.parse_args(argv)

    extra = {"spec_decode": args.spec} if args.spec and args.mode == "scheduler" else {}
    model, tok = runtime_from_args(args, **extra)
    if args.zero_llm:
        zero_llm(model)
    cfg = model.cfg
    rng = np.random.RandomState(0)
    shape = (cfg.budget.num_frames, cfg.vision.image_size, cfg.vision.image_size, 3)
    if args.pixel_dtype == "uint8":
        videos = [rng.randint(0, 256, size=shape, dtype=np.uint8) for _ in range(4)]
    else:
        videos = [rng.randn(*shape).astype(np.float32) for _ in range(4)]

    if args.mode == "engine":
        from .engine import StreamingEngine

        backend = StreamingEngine(model, tok, max_slots=args.max_batch,
                                  max_new_cap=max(args.max_new + 8, 32), spec_k=args.spec)
    else:
        from .serve import BatchingScheduler

        backend = BatchingScheduler(model, tok, max_batch=args.max_batch)

    # one request first, so that the window holds no first-use cost (the
    # kernels' build and load, the allocator's first blocks)
    backend.submit({"video": videos[0], "instruct": "warmup?"},
                   max_new_tokens=args.max_new).result(timeout=3600)

    lat, tokens_out, errors, error_msgs = [], [0], [0], []
    lock = threading.Lock()
    next_i = [0]

    def client() -> None:
        while True:
            with lock:
                i = next_i[0]
                if i >= args.requests:
                    return
                next_i[0] += 1
            t0 = time.perf_counter()
            sample = {"video": videos[i % len(videos)], "instruct": f"Describe scene {i % 7}."}
            try:
                if args.stream_every and i % args.stream_every == 0:
                    text = "".join(backend.submit_stream(sample, max_new_tokens=args.max_new))
                    ntok = max(len(text.split()), 1)
                else:
                    _text, out = backend.submit(sample, max_new_tokens=args.max_new).result(
                        timeout=3600)
                    ntok = len(out["output"])
                with lock:
                    lat.append(time.perf_counter() - t0)
                    tokens_out[0] += ntok
            except Exception as e:  # noqa: BLE001 — counted and sampled in the line
                with lock:
                    errors[0] += 1
                    if len(error_msgs) < 4:
                        error_msgs.append(f"{type(e).__name__}: {e}"[:400])

    t_start = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    backend.close()

    lat.sort()
    print(json.dumps({
        "name": "serve_loadtest_zero_llm" if args.zero_llm else "serve_loadtest",
        "zero_llm": bool(args.zero_llm),
        "mode": args.mode,
        "spec": args.spec,
        "quant": args.quant,
        "tiny": bool(args.tiny),
        "device": (torch.cuda.get_device_name(model.device) if model.device.type == "cuda"
                   else str(model.device)),
        "pixel_dtype": args.pixel_dtype,
        "clients": args.clients,
        "requests": args.requests,
        "completed": len(lat),
        "errors": errors[0],
        "error_msgs": error_msgs,
        "wall_s": round(wall, 4),
        "requests_per_s": round(len(lat) / wall, 4) if wall else None,
        "gen_tokens_per_s": round(tokens_out[0] / wall, 2) if wall else None,
        "latency_s": {
            "p50": round(lat[len(lat) // 2], 4) if lat else None,
            "p95": round(lat[min(len(lat) - 1, int(len(lat) * 0.95))], 4) if lat else None,
        },
        "backend_stats": backend.stats(),
    }), flush=True)


if __name__ == "__main__":
    main()
