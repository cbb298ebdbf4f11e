"""The harness's pieces on the CPU at the tiny configuration: a run's last
line, the closed loop drawing requests past those drawn at first and failing
the run when a client dies, the check failing under the control and under a
fault planted in the timed path, the per-layer readers on a stand-in trace,
the rate sweep's open loop, and the entry point refusing to run without a
card or without the program."""

import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness

from conftest import ROOT, tiny_spec

SEED = 2**31 + 77
CELL = "qa-describe.int8"
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def _run(sp, control=False, seconds=2.0):
    import time

    torch.manual_seed(0)
    return harness.run(sp, SEED, seconds, False, "cpu", time.perf_counter(),
                       control=control, log=lambda m: None)


def test_last_line(tiny_frames):
    out = _run(tiny_spec(CELL))
    assert list(out) == KEYS  # ``check`` last
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"gen_tok_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["check"]["logit_gap"]["value"] <= out["check"]["logit_gap"]["limit"]
    json.dumps(out)


def test_closed_loop_draws_more_requests(tiny_frames):
    """A run that sends more than the requests drawn at first goes on with
    further blocks, each video new, instead of losing its clients."""
    sp = tiny_spec(CELL)
    sp.params["requests"] = sp.params["stratum"]  # 8 drawn at first, for 4 clients
    out = _run(sp, seconds=3.0)
    assert out["correct"] and out["attempted"] > sp.params["requests"]


def test_a_dead_client_fails_the_run(tiny_frames, monkeypatch):
    import threading

    real, calls = harness._record, []

    def dies(*a, **kw):  # a client's sixth request: after the ramp
        if threading.current_thread().name == "bench-client":
            calls.append(1)
            if len(calls) == 6:
                raise RuntimeError("planted")
        return real(*a, **kw)

    monkeypatch.setattr(harness, "_record", dies)
    with pytest.raises(RuntimeError, match="client thread died.*planted"):
        _run(tiny_spec(CELL), seconds=3.0)


def test_control_int4_fails(tiny_frames):
    out = _run(tiny_spec(CELL), control=True)
    assert not out["correct"]
    assert out["check"]["logit_gap"]["value"] > out["check"]["logit_gap"]["limit"]


def test_altered_token_fails(tiny_frames, monkeypatch):
    """A token altered where the decode loop produces it."""
    from ufvideo_tpu_torch import engine

    real = engine.decode_chunk

    def altered(*a, **kw):
        out = list(real(*a, **kw))
        tokens = out[0].clone()
        tokens[:, 0] = (tokens[:, 0] + 1) % 500
        out[0] = tokens
        return tuple(out)

    monkeypatch.setattr(engine, "decode_chunk", altered)
    out = _run(tiny_spec(CELL))
    assert not out["correct"]
    assert out["check"]["logit_gap"]["value"] > 10 * out["check"]["logit_gap"]["limit"]


class _Trace:
    """A stand-in for the profiler's readings: every family busy a second."""

    window_s = 10.0

    def busy_s(self):
        return 4.0

    def device_seconds(self, pattern):
        return 1.0


def test_per_layer_readers(tiny_frames, monkeypatch):
    sp = tiny_spec(CELL)
    seen = {}
    real = harness.Window

    def keep(*a, **kw):
        w = real(*a, **kw)
        seen["w"] = w
        return w

    monkeypatch.setattr(harness, "Window", keep)
    _run(sp)
    w = seen["w"]
    w.trace = _Trace()
    values = {m["name"]: harness.metric_reader(m["name"]).read(w) for m in sp.per_layer}
    assert set(values) == {m["name"] for m in sp.per_layer}
    assert values["idle.gen"] == pytest.approx(60.0)
    for name, v in values.items():
        assert v is not None and v > 0 and math.isfinite(v), name
        mod = harness.metric_reader(name)
        entry = next(m for m in sp.per_layer if m["name"] == name)
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])


def test_every_metric_has_a_reader():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.metric_reader(m["name"]).MOVES in {e["name"] for e in bench["end_to_end"]}
    for w in bench["workloads"]:
        sp = harness.spec(w["name"], bench)
        assert {"setup_s"} < {m["name"] for m in sp.end_to_end}
        assert sp.per_layer


def test_sweep_open_loop(tiny_frames):
    """One rate of the sweep on the tiny runtime: every request due in the
    window sent on time and answered."""
    from benchmark import sweep
    from ufvideo_tpu_torch.configs import tiny_config

    from benchmark import generator, port
    from benchmark.reference import checkpoint, model as ref_model
    from conftest import TINY_TRAFFIC

    model = port.config_dict(tiny_config())
    params = dict(harness.load_json(harness.HERE / "traffic" / "qa_open.json"), **TINY_TRAFFIC)
    params["stratum"] = 4
    torch.manual_seed(0)
    rt, tok = port.build_runtime(model, checkpoint.make_state_dict(model, SEED, "cpu"), "cpu")
    line = sweep.measure(rt, tok, params, 2, 2.0, 2.0, SEED, ref_model.video_token_count(model))
    due = generator.requests(dict(params, rate=2.0), SEED, 8)
    assert line["requests"] == sum(r.due < 2.0 for r in due)
    assert line["requests"] > 0 and line["failed"] == 0
    assert math.isfinite(line["p90_ms"]) and line["p50_ms"] <= line["p85_ms"] <= line["p90_ms"]
    assert line["late_max_ms"] < 500


def _entry(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "qa-describe.int8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_entry_refuses_without_a_card():
    r = _entry(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_entry_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _entry(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
