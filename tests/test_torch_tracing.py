"""The port's span recorder (``ufvideo_tpu_torch/utils/tracing.py``) and the
engine's spans and counters on the CPU: spans are recorded only inside a
``torch.profiler`` session while the counters move always; spans nest, carry
their parent's and their requests' ids, and a span's self time is its
duration less its children's; the ring keeps its bound; a span around an
operation contains that operation's kineto interval (one clock);
``profile_trace`` writes the spans into its Chrome trace; one engine
request's spans run in the order of its life, and a decode step's phases
add up to no more than the step. The card's clock: ``tests/test_torch_cuda.py
-k span``."""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_cores  # noqa: F401  (one share of the cores a worker)
from ufvideo_tpu_torch.api import model_init
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.engine import StreamingEngine
from ufvideo_tpu_torch.utils import tracing
from ufvideo_tpu_torch.utils.logging import profile_trace


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _split(requests=(7,)):
    """A step of launch → wait → launch → emit around small products."""
    a = torch.randn(64, 64)
    with tracing.Split("step", "launch", requests) as sp:
        a = a @ a
        with tracing.wait():
            float(a.sum())
        a = a @ a
        sp.switch("emit")
        time.sleep(0.001)
    return sp


def _mine(t0):
    return [s for s in tracing.RECORDER.spans(t0) if s.thread == threading.current_thread().name]


def test_spans_only_inside_a_profiler_session_counters_always():
    assert not tracing.on()
    t0 = time.time_ns()
    sp = _split()
    assert _mine(t0) == []
    assert sp.wall_ns["launch"] > 0 and sp.wall_ns["wait"] > 0 and sp.wall_ns["emit"] >= 1e6
    assert sp.cpu_ns["launch"] > 0
    with _cpu_profile():
        assert tracing.on()
        sp = _split()
    assert not tracing.on()
    assert [s.name for s in _mine(t0)] == ["launch", "wait", "launch", "emit", "step"]
    assert sp.wall_ns["emit"] >= 1e6


def test_spans_nest_with_parent_and_request_ids_and_self_time():
    t0 = time.time_ns()
    with _cpu_profile():
        sp = _split(requests=(3, 4))
    spans = _mine(t0)
    step = spans[-1]
    assert step.name == "step" and step.id == sp.id and step.parent == 0
    kids = spans[:-1]
    assert all(k.parent == step.id and k.requests == (3, 4) for k in kids)
    assert all(step.start_ns <= k.start_ns <= k.end_ns <= step.end_ns for k in kids)
    # the phases tile the step: no gap between one and the next
    assert [k.end_ns for k in kids[:-1]] == [k.start_ns for k in kids[1:]]
    assert tracing.self_time_ns(step, spans) == 0
    for kind in ("launch", "wait", "emit"):
        total = sum(k.end_ns - k.start_ns for k in kids if k.name == kind)
        assert total == sp.wall_ns[kind]
    assert all(k.cpu_ns >= 0 for k in kids) and step.cpu_ns >= 0


@pytest.mark.parametrize("kids, self_ns", [
    ([], 100),
    ([(10, 20), (30, 60)], 60),
    ([(10, 40), (30, 60)], 50),  # overlapping children count once
    ([(-5, 20), (90, 130)], 70),  # clipped to the parent
])
def test_self_time_is_duration_less_children(kids, self_ns):
    parent = tracing.Span("p", 0, 100, 1, 0, (), "t", -1)
    spans = [parent] + [tracing.Span("c", s, e, 10 + i, 1, (), "t", -1)
                        for i, (s, e) in enumerate(kids)]
    spans.append(tracing.Span("other", 0, 100, 99, 5, (), "t", -1))  # not a child
    assert tracing.self_time_ns(parent, spans) == self_ns


def test_ring_keeps_its_bound():
    rec = tracing.Recorder(size=8)
    ids = [rec.add("s", i, i + 1) for i in range(20)]
    kept = rec.spans()
    assert len(kept) == 8 and [s.id for s in kept] == ids[-8:]
    assert [s.start_ns for s in rec.spans(15, 16)] == [14, 15, 16]


def test_a_span_contains_its_operations_kineto_interval():
    a = torch.randn(256, 256)
    with _cpu_profile() as prof:
        with tracing.Split("mm", "launch") as sp:
            a @ a
    span = next(s for s in tracing.RECORDER.spans() if s.id == sp.id)
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert span.start_ns <= mm[0].start_ns()
    assert mm[0].start_ns() + mm[0].duration_ns() <= span.end_ns
    off = tracing.perf_offset_ns()
    assert abs(time.perf_counter_ns() + off - time.time_ns()) < 1_000_000


def test_wait_outside_a_split_counts_nowhere():
    with tracing.wait():
        pass
    with tracing.Split("outer", "launch") as outer:
        with tracing.Split("inner", "launch") as inner:
            with tracing.wait():
                time.sleep(0.002)
        with tracing.wait():
            pass
    assert inner.wall_ns["wait"] >= 2e6
    assert outer.wall_ns["wait"] < 2e6  # the inner split held the sleep


def test_profile_trace_writes_the_spans_beside_kinetos_events(tmp_path):
    a = torch.randn(128, 128)
    with profile_trace(str(tmp_path)):
        with tracing.Split("traced", "launch") as sp:
            a @ a
    trace = json.load(open(tmp_path / "trace.json"))
    ev = trace["traceEvents"]
    mine = [e for e in ev if e.get("cat") == "ufvideo" and e["args"]["id"] == sp.id]
    assert [e["name"] for e in mine] == ["traced"]
    mm = [e for e in ev if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert mm and mine[0]["ts"] <= mm[-1]["ts"]
    assert mm[-1]["ts"] + mm[-1]["dur"] <= mine[0]["ts"] + mine[0]["dur"] + 1e-3


# ------------------------------------------------------------ the engine --

@pytest.fixture(scope="module")
def tiny():
    rt, _, tok = model_init(cfg=tiny_config(), device="cpu", seed=0)
    return rt, tok


def _video(seed):
    return np.random.RandomState(seed).randn(4, 56, 56, 3).astype(np.float32)


ORDER = ["queue", "slot_wait", "admit.transfer", "admit.encode", "admit.splice",
         "admit.prefill", "ready_wait", "install", "emit", "retire"]


def test_engine_request_spans_share_its_id_in_order(tiny):
    rt, tok = tiny
    t0 = time.time_ns()
    with StreamingEngine(rt, tok, max_slots=2, chunk=2, max_new_cap=8) as eng, _cpu_profile():
        fut = eng.submit({"video": _video(1), "instruct": "What happens?"}, max_new_tokens=6)
        fut.result(timeout=600)
    spans = tracing.RECORDER.spans(t0)
    req = next(s for s in spans if s.name == "request")
    rid = req.id
    assert req.requests == (rid,)
    mine = sorted((s for s in spans if rid in s.requests), key=lambda s: (s.start_ns, s.end_ns))
    names = [s.name for s in mine]
    firsts = [names.index(n) for n in ORDER]
    assert firsts == sorted(firsts), names
    assert {"launch", "wait", "step", "admit"} <= set(names)
    by_id = {s.id: s for s in spans}
    for s in mine:  # begun in the request's life; its own children inside it
        assert req.start_ns <= s.start_ns <= req.end_ns, s
        if s.name in ("queue", "slot_wait", "ready_wait", "install", "retire"):
            assert s.parent == rid and s.end_ns <= req.end_ns, s
    for s in mine:
        if s.name.startswith("admit."):
            assert by_id[s.parent].name == "admit"
        if s.name in ("launch", "wait", "emit"):
            assert by_id[s.parent].name == "step"


@pytest.mark.parametrize("traced", [False, True])
def test_engine_step_phases_and_counters(tiny, traced):
    rt, tok = tiny
    eng = StreamingEngine(rt, tok, max_slots=3, chunk=2, max_new_cap=8)
    with eng, (_cpu_profile() if traced else contextlib.nullcontext()):
        futs = [eng.submit({"video": _video(20 + i), "instruct": f"Scene {i}?"},
                           max_new_tokens=5 + i) for i in range(4)]
        served = [len(f.result(timeout=600)[1]["output"]) for f in futs]
        st = eng.stats()
    assert st["completed"] == 4 and st["errors"] == 0
    phases = st["launch_s"] + st["wait_s"] + st["emit_s"]
    assert 0 < phases <= st["step_s"] + 2e-3  # each rounded to the millisecond
    assert st["launch_s"] > 0 and st["wait_s"] > 0
    assert 0 < st["launch_cpu_s"] <= st["launch_s"] + 2e-3
    assert 0 < st["decode_rows"] <= eng.max_slots * st["decode_steps"]
    # every served token but each reply's first (the prefill's) came from a
    # decode step; a row may run on to its chunk's end past its budget
    made = sum(n - 1 for n in served)
    assert made <= st["decode_rows"] <= made + (eng.chunk - 1) * len(served)
    assert 0 < st["kv_live_pos_steps"] <= st["kv_reserved_pos_steps"]
    assert st["kv_reserved_pos_steps"] == eng.max_slots * eng.cache_positions * st["decode_steps"]
    assert st["ready_wait_s"] >= 0
    stages = [st[f"admit_{s}_device_s"] for s in ("transfer", "encode", "splice", "prefill")]
    assert st["admit_device_s"] == pytest.approx(sum(stages), abs=3e-3)
    assert st["admit_encode_device_s"] > 0 and st["admit_prefill_device_s"] > 0
