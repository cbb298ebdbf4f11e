"""One run of one cell: set-up, the measured window, the readings and the
check of what the window served against the plain reference.

Everything is found by name: the cell ``cells/<workload>.json`` (engine
settings, traffic parameters, the check's sample and limits), its
configuration ``configs/<config>.json`` (``model``: the program's
configuration fields; ``control``: what the control switches on), its
traffic mix ``traffic/<mix>.json`` (read by ``generator.py``) and each metric's
reader ``metrics/<metric>.py``; ``BENCHMARK.json`` says which metrics a cell
reports.

Set-up: the state dict drawn on the device from the seed, written into the
program through its checkpoint loader and freed; the engine; one warm-up
request for every admission sub-batch size the cell's traffic reaches, the
prompts spread over its prefill length buckets; then the closed loop's
clients' first requests, until every slot is busy. The window then runs for
``--seconds``. Afterwards the engine is closed and freed, the state dict is
drawn again, and the reference reads a sample of the window's finished
requests, drawn from the seed, the longest among them. The open loop here
is the rate sweep's (``sweep.py``); a cell's traffic is a closed loop.
"""

from __future__ import annotations

import collections
import gc
import importlib.util
import json
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

from . import generator
from .reference import checkpoint, model as ref_model, prompt as ref_prompt

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PACKAGE = "ufvideo_tpu_torch"
ADMIT_SIZES = 4  # the engine admits at most four requests a dispatch
CLOSE_WAIT_S = 60.0  # how long past the window a due answer is waited for


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    """A cell and everything it names."""

    workload: Dict[str, Any]
    cell: Dict[str, Any]
    config: Dict[str, Any]
    params: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def spec(name: str, bench: Optional[Dict[str, Any]] = None) -> Spec:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(HERE / "cells" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    params = dict(load_json(HERE / "traffic" / f"{workload['traffic']}.json"), **cell["traffic"])
    reports = lambda m: name in m.get("workloads", [name])
    return Spec(workload, cell, config, params,
                [m for m in bench["end_to_end"] if reports(m)],
                [m for m in bench["per_layer"] if reports(m)])


def metric_reader(name: str) -> ModuleType:
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- requests --

@dataclass
class Record:
    req: generator.Request
    prompt_len: int  # positions of the spliced prompt
    due: float  # host clock
    sent: float = math.nan
    done: float = math.nan
    served: List[int] = field(default_factory=list)
    deltas: List[tuple] = field(default_factory=list)  # (host clock, tokens) of a stream
    error: Optional[str] = None
    cancelled: bool = False

    def finished(self) -> bool:
        return self.error is None and not self.cancelled and not math.isnan(self.done)


def _sample(params, pool, req) -> Dict[str, Any]:
    return {"video": generator.frames(pool, params, req), "instruct": req.question}


def _record(req, params, video_tokens: int, due: float) -> Record:
    return Record(req, ref_prompt.spliced_length(req.question, video_tokens), due)


def _serve_one(engine, rec: Record, sample, stream: bool, current=None, slot=None) -> None:
    """Send one request and collect its reply into ``rec``."""
    from .port import text_ids

    rec.sent = time.perf_counter()
    try:
        if stream:
            fut = engine.submit_stream(sample, max_new_tokens=rec.req.max_new)
            if current is not None:
                current[slot] = (rec, fut)
            text = []
            for delta in fut:
                rec.deltas.append((time.perf_counter(), len(delta)))
                text.append(delta)
            rec.served = text_ids("".join(text))
            rec.cancelled = fut.cancelled
        else:
            _, out = engine.submit(sample, max_new_tokens=rec.req.max_new).result()
            rec.served = [int(t) for t in out["output"]]
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not raised
        rec.error = f"{type(e).__name__}: {e}"[:300]
    rec.done = time.perf_counter()


def warm_up(engine, params, pool, seed: int, max_slots: int, video_tokens: int,
            avoid) -> List[generator.Request]:
    """Serve waves of 4, 3, 2 and 1 requests (at most ``max_slots`` a wave),
    each wave's prompts spread over the traffic's question lengths and so
    over its prefill length buckets; return the requests served."""
    waves = list(range(min(ADMIT_SIZES, max_slots), 0, -1))
    reqs = generator.requests(dict(params, answer_tokens={"dist": "uniform", "low": 8, "high": 8}),
                              seed, sum(waves), stream=generator.STREAM_WARMUP, avoid=avoid)
    lo, hi = params["question_bytes"]
    n = 0
    for g in waves:
        threads = []
        for j in range(g):
            r = reqs[n]
            r.question = "w" + "x" * (lo + (hi - lo) * j // max(g - 1, 1) - 2) + "?"
            rec = _record(r, params, video_tokens, time.perf_counter())
            t = threading.Thread(target=_serve_one, name="bench-warmup", daemon=True,
                                 args=(engine, rec, _sample(params, pool, r), False))
            t.start()
            threads.append((t, rec))
            n += 1
        for t, rec in threads:
            t.join(300)
            if rec.error or t.is_alive():
                raise RuntimeError(f"warm-up request failed: {rec.error}")
    return reqs[:n]


@dataclass
class Window:
    """What a metric reader reads."""

    spec: Spec
    seconds: float
    setup_s: float
    w0: float
    w1: float
    records: List[Record]
    stats0: Dict[str, Any]
    stats1: Dict[str, Any]
    warm: int  # requests installed before the run's own
    trace: Any = None

    @property
    def model(self) -> Dict[str, Any]:
        return self.spec.config["model"]

    def delta(self, key: str) -> float:
        return float(self.stats1[key]) - float(self.stats0[key])

    def admitted(self) -> List[Record]:
        """The requests installed in the window: the engine's installs are
        counted in its ``admissions``; requests are installed in the order
        they were sent."""
        a0 = int(self.stats0["admissions"]) - self.warm
        a1 = int(self.stats1["admissions"]) - self.warm
        ordered = sorted(self.records, key=lambda r: r.sent)
        return ordered[max(a0, 0):max(a1, 0)]

    def window_tokens(self) -> List[tuple]:
        """(record, first token index, count) of the tokens generated in the
        window: the streams' deltas received in it."""
        out = []
        for r in self.records:
            j = 0
            for t, n in r.deltas:
                if self.w0 <= t < self.w1:
                    out.append((r, j, n))
                j += n
        return out


def open_loop(engine, reqs, params, pool, seconds, video_tokens) -> tuple:
    """Send each request at its due time (``sweep.py``); return (records due
    in the window, w0, w1, lateness)."""
    records: List[Record] = []
    waiters: List[threading.Thread] = []
    lateness: List[float] = []
    w0 = time.perf_counter()
    for req in reqs:
        if req.due >= seconds:
            break
        due = w0 + req.due
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        rec = _record(req, params, video_tokens, due)
        lateness.append(time.perf_counter() - due)
        records.append(rec)
        t = threading.Thread(target=_serve_one, name="bench-client", daemon=True,
                             args=(engine, rec, _sample(params, pool, req), params["stream"]))
        t.start()
        waiters.append(t)
    else:
        raise RuntimeError("the schedule ran out before the window closed")
    wait = w0 + seconds - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    w1 = time.perf_counter()
    for t in waiters:
        t.join(max(w1 + CLOSE_WAIT_S - time.perf_counter(), 0.0))
    return records, w0, w1, lateness


def closed_loop(engine, reqs, more, params, pool, seconds, video_tokens, trace,
                log=print) -> tuple:
    """``clients`` threads each send their next request when the last one is
    answered: ``reqs`` in order, then ``more(n)``'s n-th further block. The
    window opens once every client's first request streams (each its own
    slot); at its close the replies in flight are cancelled. A client that
    dies fails the run."""
    lock = threading.Lock()
    pending = collections.deque(reqs)
    drawn = [0]  # further blocks drawn
    stop = threading.Event()
    records: List[Record] = []
    current: Dict[int, tuple] = {}
    died: List[str] = []

    def client(k: int) -> None:
        try:
            while True:
                with lock:
                    if stop.is_set():
                        return
                    if not pending:
                        pending.extend(more(drawn[0]))
                        drawn[0] += 1
                    req = pending.popleft()
                    rec = _record(req, params, video_tokens, time.perf_counter())
                    records.append(rec)
                _serve_one(engine, rec, _sample(params, pool, req), True, current, k)
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            died.append(f"client {k}: {type(e).__name__}: {e}"[:300])

    def alive() -> None:
        if died:
            stop.set()
            raise RuntimeError("a client thread died: " + "; ".join(died))

    clients = [threading.Thread(target=client, args=(k,), name="bench-client", daemon=True)
               for k in range(int(params["clients"]))]
    for c in clients:
        c.start()
    # the ramp: every client's first request admitted and streaming
    deadline = time.perf_counter() + 300
    while sum(bool(r.deltas) for r in list(records)) < len(clients):
        alive()
        if time.perf_counter() > deadline:
            raise RuntimeError("the closed loop's first requests were never all admitted")
        time.sleep(0.01)
    if trace is not None:
        trace.__enter__()
    stats0 = engine.stats()
    w0 = time.perf_counter()
    time.sleep(seconds)
    w1 = time.perf_counter()
    stats1 = engine.stats()
    with lock:
        stop.set()
    if trace is not None:
        trace.__exit__(None, None, None)
    deadline = time.perf_counter() + CLOSE_WAIT_S
    while any(c.is_alive() for c in clients) and time.perf_counter() < deadline:
        for _, fut in list(current.values()):  # a reply sent as the window closed too
            fut.cancel()
        time.sleep(0.05)
    alive()
    log(f"closed loop: {len(records)} requests sent, {drawn[0]} blocks drawn beyond the "
        f"{len(reqs)} drawn at first")
    in_window = [r for r in records if r.sent < w1]
    return in_window, w0, w1, stats0, stats1


# ---------------------------------------------------------------- check --

def pick_sample(records: List[Record], w1: float, n: int, seed: int) -> List[Record]:
    """The requests finished in the window, the longest and ``n - 1`` more
    drawn from the seed."""
    done = [r for r in records if r.finished() and r.done <= w1
            and (r.served and (len(r.served) == r.req.max_new or r.served[-1] == EOS))]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.served), -r.req.index))
    rest = [r for r in done if r is not longest]
    rng = generator.rng(seed, generator.STREAM_SAMPLE)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


EOS = ref_prompt.SPECIAL["<|im_end|>"]


def logit_gaps(sample: List[Record], params, pool, seed: int, model_cfg, device
               ) -> List[torch.Tensor]:
    """For each sampled request, the gap at each served token: how far its
    reference logit lies below the reference's best at its position."""
    sd = checkpoint.make_state_dict(model_cfg, seed, device)
    reqs = [{"frames": torch.from_numpy(generator.frames(pool, params, r.req)).to(device),
             "question": r.req.question, "served": r.served} for r in sample]
    gaps = []
    for r, logits in zip(reqs, ref_model.served_logits(reqs, sd, model_cfg)):
        tok = torch.as_tensor(r["served"], device=logits.device)
        got = logits.gather(1, tok[:, None])[:, 0]
        gaps.append((logits.max(dim=1).values - got).float().cpu())
    del sd
    return gaps


# ------------------------------------------------------------------ run --

def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(sp: Spec, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False, log=print) -> Dict[str, Any]:
    """One run → the result line's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` and, traced, ``breakdown``, then
    ``check``)."""
    from . import port

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    model_cfg = sp.config["model"]
    params = sp.params
    overrides = sp.config["control"] if control else None
    if cuda:
        port.build_kernels()
    t = time.perf_counter()
    sd = checkpoint.make_state_dict(model_cfg, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    t_drawn = time.perf_counter()
    rt, tok = port.build_runtime(model_cfg, sd, dev, overrides)
    del sd
    _free(dev)
    log(f"set-up: imports and kernels by {t - t_start:.3f} s, weights drawn in "
        f"{t_drawn - t:.3f} s and loaded in {time.perf_counter() - t_drawn:.3f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    video_tokens = ref_model.video_token_count(model_cfg)
    engine = port.make_engine(rt, tok, sp.cell["engine"])
    max_slots = int(sp.cell["engine"]["max_slots"])
    pool = generator.make_pool(params, seed)
    if params["loop"] != "closed":
        raise ValueError(f"a cell's traffic is a closed loop, not {params['loop']!r}")
    reqs = generator.requests(params, seed, int(params["requests"]))
    used = {r.offset for r in reqs}
    t = time.perf_counter()
    warmed = warm_up(engine, params, pool, seed, max_slots, video_tokens, used)
    warm = len(warmed)
    used |= {r.offset for r in warmed}
    if cuda:
        torch.cuda.synchronize(dev)
    log(f"set-up: {warm} warm-up requests in {time.perf_counter() - t:.3f} s")

    def more(n: int) -> List[generator.Request]:
        block = generator.more(params, seed, n, len(reqs) + n * int(params["stratum"]), used)
        used.update(r.offset for r in block)
        return block

    window_trace = None
    if trace:
        from .tracing import DeviceTrace

        window_trace = DeviceTrace(PACKAGE)
    records, w0, w1, stats0, stats1 = closed_loop(
        engine, reqs, more, params, pool, seconds, video_tokens, window_trace, log)
    setup_s = w0 - t_start
    t = time.perf_counter()
    engine.close()
    log(f"window {w1 - w0:.3f} s; setup_s {setup_s:.3f}; replies drained "
        f"{t - w1:.3f} s and the engine closed {time.perf_counter() - w1:.3f} s after the window")
    win = Window(sp, w1 - w0, setup_s, w0, w1, records, stats0, stats1, warm, window_trace)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    lat = sorted(1e3 * (r.done - r.due) for r in records if r.finished())
    if lat:
        log("latency ms from send to reply, finished requests: " + ", ".join(
            f"p{q} {lat[min(int(q / 100 * len(lat)), len(lat) - 1)]:.1f}" for q in (50, 90))
            + f", max {lat[-1]:.1f}, mean {sum(lat) / len(lat):.1f} over {len(lat)}")
    log(f"engine stats over the window: " + json.dumps(
        {k: win.delta(k) for k in ("admissions", "prefills", "decode_steps", "chunks",
                                   "prep_s", "step_s", "install_s", "errors",
                                   "admit_fallback_requests")}))

    metrics: Dict[str, Any] = {}
    for m in (sp.per_layer if trace else sp.end_to_end):
        value = metric_reader(m["name"]).read(win)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: every request due in the window answered, none failed, and
    # the served tokens against the reference
    failed = sum(r.error is not None for r in records)
    missing = sum(r.error is None and math.isnan(r.done) for r in records)
    chk = sp.cell["check"]
    sample = pick_sample(records, w1, int(chk["sample"]), seed)
    del engine, rt
    _free(dev)
    t = time.perf_counter()
    per_req = logit_gaps(sample, params, pool, seed, model_cfg, dev) if sample else []
    gaps = [float(g.max()) for g in per_req]
    every = torch.cat(per_req) if per_req else torch.zeros(0)
    log(f"checked {len(sample)} requests, {every.numel()} served tokens in "
        f"{time.perf_counter() - t:.3f} s; widest logit gap of each: {gaps}; tokens off the "
        f"reference's best: {int((every > 0).sum())}, mean gap a token "
        f"{float(every.mean()) if every.numel() else 0.0}")
    check = {"logit_gap": {"value": max(gaps) if gaps else None, "limit": chk["logit_gap"]},
             "failed": {"value": failed, "limit": 0},
             "missing": {"value": missing, "limit": 0}}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in check.values())
    device_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": correct, "attempted": len(records), "failed": failed,
                           "metrics": metrics, "device": device_info}
    if window_trace is not None:
        log("device seconds by operation: " + json.dumps(window_trace.top_ops(200)))
        device_info["busy_s"] = window_trace.busy_s()
        device_info["window_s"] = window_trace.window_s
        out["breakdown"] = {"device_ops": window_trace.top_ops(),
                            "idle_gaps": window_trace.idle_gaps()}
    out["check"] = check
    return out
