"""The readers of the engine's own layer split on hand-made windows: each
counter ratio from known counters, None where the program lacks the counter
(an older checkout) or the window moved none; the card's idle time inside
the worker's ``launch`` spans from known spans and device intervals."""

import pytest

from benchmark import harness
from benchmark.engine_layers import idle_in_launch, uncovered_ns
from benchmark.tracing import DeviceTrace

from ufvideo_tpu_torch.utils import tracing

COUNTERS0 = {"decode_steps": 100, "launch_s": 1.0, "wait_s": 0.5, "emit_s": 0.25,
             "launch_cpu_s": 0.9, "decode_rows": 1000, "kv_live_pos_steps": 10_000,
             "kv_reserved_pos_steps": 50_000, "ready_wait_s": 2.0, "admissions": 10,
             "admit_device_s": 1.0}
MOVED = {"decode_steps": 200, "launch_s": 10.0, "wait_s": 3.0, "emit_s": 1.0,
         "launch_cpu_s": 8.0, "decode_rows": 4800, "kv_live_pos_steps": 60_000,
         "kv_reserved_pos_steps": 100_000, "ready_wait_s": 1.5, "admissions": 5,
         "admit_device_s": 2.0}


def _window(stats0, stats1, w0=10.0, w1=11.0, events=()):
    sp = harness.Spec({"name": "qa-describe.int8"}, {"engine": {"max_slots": 32}}, {}, {}, [], [])
    w = harness.Window(sp, w1 - w0, 0.0, w0, w1, [], stats0, stats1, 0)
    w.trace = DeviceTrace("ufvideo_tpu_torch")
    w.trace.events = list(events)
    w.trace.window_s = w1 - w0
    return w


def _moved():
    return _window(COUNTERS0, {k: COUNTERS0[k] + v for k, v in MOVED.items()})


@pytest.mark.parametrize("metric, value", [
    ("decode_launch_ms.gen", 1e3 * 10.0 / 200),
    ("decode_wait_ms.gen", 1e3 * 3.0 / 200),
    ("decode_emit_ms.gen", 1e3 * 1.0 / 200),
    ("worker_offcpu.gen", 100 * (1 - 8.0 / 10.0)),
    ("slot_occupancy.gen", 100 * 4800 / (32 * 200)),
    ("kv_used.gen", 100 * 60_000 / 100_000),
    ("install_wait_ms.gen", 1e3 * 1.5 / 5),
    ("admit_device_ms.gen", 1e3 * 2.0 / 5),
])
def test_counter_readers(metric, value):
    reader = harness.metric_reader(metric)
    assert reader.read(_moved()) == pytest.approx(value)
    assert reader.LAYER in ("engine decode loop", "engine admission")
    assert reader.MOVES == "gen_tok_s"
    # an older program without the counters, a window that moved nothing
    old = {"decode_steps": 1, "admissions": 1}
    assert reader.read(_window(old, {"decode_steps": 9, "admissions": 9})) is None
    assert reader.read(_window(COUNTERS0, COUNTERS0)) is None


@pytest.mark.parametrize("spans, busy, free", [
    ([(0, 10)], [], 10),
    ([(0, 10)], [(2, 4), (6, 7)], 7),
    ([(0, 10), (20, 30)], [(5, 25)], 10),
    ([(5, 8)], [(0, 20)], 0),
    ([(0, 10)], [(-5, 1), (9, 40)], 8),
])
def test_uncovered(spans, busy, free):
    assert uncovered_ns(spans, busy) == free


def test_idle_in_launch():
    """Window [10 s, 11 s] on perf_counter, offset 0: launch spans over
    100-300 ms and 500-600 ms (and one outside the window, one of another
    name), device busy 150-250 ms and 550-700 ms: idle inside launch 100 + 50
    ms, 15% of the window."""
    ms = lambda t: int(10e9 + t * 1e6)
    rec = tracing.Recorder()
    rec.add("launch", ms(100), ms(300))
    rec.add("launch", ms(500), ms(600))
    rec.add("launch", ms(1100), ms(1200))
    rec.add("wait", ms(0), ms(1000))
    events = [("k", ms(150), ms(250)), ("k", ms(550), ms(700)), ("k", ms(-50), ms(20))]
    w = _window(COUNTERS0, COUNTERS0, events=events)
    assert idle_in_launch(w, rec, 0) == pytest.approx(15.0, rel=1e-6)
    assert idle_in_launch(w, tracing.Recorder(), 0) is None  # nothing to read
    assert harness.metric_reader("idle_in_launch.gen").LAYER == "device"


def test_the_program_s_recorder_is_read_by_default():
    """Without arguments the reader reads the program's ring on the
    program's clock: a launch span stamped now lies inside a window around
    now."""
    import time

    w0 = time.perf_counter()
    start = time.time_ns()
    tracing.RECORDER.add("launch", start, start + 50_000_000)
    w = _window(COUNTERS0, COUNTERS0, w0=w0, w1=w0 + 0.1)
    assert idle_in_launch(w) == pytest.approx(50.0, abs=1.0)
