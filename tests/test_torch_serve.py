"""The port's serving layer (``ufvideo_tpu_torch/serve.py``) against the JAX
package's: every case of ``tests/test_serve.py`` on the port's module with
the same stubs (through ``serve_mod.mm_infer_batch`` / ``mm_infer_stream``);
``_build_sample`` and ``_encode_result`` equal to JAX's on the same bodies
and results; the batch key on tensors; the HTTP front end over a
``tiny_config()`` runtime loaded with JAX's weights (float32, CPU).

Tolerances: tokens and text exactly (greedy decoding on the same weights;
the port's batch equals its own ``mm_infer``, ``tests/test_torch_batch_api.py``);
the ``[SEG]`` masks bit for bit wherever the port's upsampled logit lies more
than 1e-3 from the threshold (``tests/test_torch_seg.py``'s rule); decoded
arrays exactly.
"""

import contextlib
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import ufvideo_tpu_torch.serve as serve_mod
from test_torch_seg import (  # noqa: F401  (runtimes is a fixture)
    CONV,
    LABEL,
    _assert_masks_equal_outside_band,
    _inputs,
    _logits_at_label_size,
    runtimes,
)
from ufvideo_tpu import serve as jserve
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu_torch import rle
from ufvideo_tpu_torch.api import _assemble_input_ids, mm_infer
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.constants import DEFAULT_VIDEO_TOKEN
from ufvideo_tpu_torch.serve import (
    BatchingScheduler,
    _batch_key,
    _build_sample,
    _encode_result,
    _Request,
    np_to_b64,
    serve_http,
)


class _Recorder:
    """Stands in for mm_infer_batch: records call batch compositions and
    returns per-sample results derived from the instruct string."""

    def __init__(self, fail_instructs=(), latency_s=0.0):
        self.calls = []
        self.grad_enabled = []
        self.fail_instructs = set(fail_instructs)
        self.latency_s = latency_s
        self.lock = threading.Lock()

    def __call__(self, samples, model, tokenizer, modal="video", choice=1, **kwargs):
        with self.lock:
            self.calls.append([s["instruct"] for s in samples])
            self.grad_enabled.append(torch.is_grad_enabled())
        if self.latency_s:
            time.sleep(self.latency_s)
        for s in samples:
            if s["instruct"] in self.fail_instructs:
                raise RuntimeError(f"poisoned: {s['instruct']}")
        return [
            (f"echo:{s['instruct']}:mnt{kwargs.get('max_new_tokens', 1024)}",
             {"output": [1, 2], "pred_masks": []})
            for s in samples
        ]


@pytest.fixture
def stub(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(serve_mod, "mm_infer_batch", rec)
    return rec


def _sched(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 80)
    return BatchingScheduler(model=None, tokenizer=None, **kw)


def _sample(name, t=4):
    return {"video": np.zeros((t, 8, 8, 3), np.float32), "instruct": name}


class _Cfg:
    class budget:
        num_frames = 4

    class vision:
        image_size = 8


class _Model:
    cfg = _Cfg()


@contextlib.contextmanager
def _serving(scheduler):
    """serve_http on a free local port, served from a thread; yields the port."""
    server = serve_http(scheduler, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()


def _post(port, body, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _events(raw: bytes) -> list:
    return [json.loads(line[len(b"data: "):]) for line in raw.split(b"\n\n")
            if line.startswith(b"data: ")]


# ------------------------------------------- tests/test_serve.py on the port --

def test_requests_coalesce_into_one_batch(stub):
    with _sched() as s:
        futs = [s.submit(_sample(f"q{i}"), max_new_tokens=8) for i in range(3)]
        out = [f.result(timeout=10) for f in futs]
    assert [t for t, _ in out] == [f"echo:q{i}:mnt8" for i in range(3)]
    assert stub.calls == [["q0", "q1", "q2"]]
    st = s.stats()
    assert st["batches"] == 1 and st["mean_batch_size"] == 3.0


def test_single_request_flushes_after_window(stub):
    with _sched(max_wait_ms=30) as s:
        t0 = time.perf_counter()
        s.submit(_sample("solo"), max_new_tokens=8).result(timeout=10)
        dt = time.perf_counter() - t0
    assert stub.calls == [["solo"]]
    assert dt < 5.0  # the window, not the 10 s future timeout


def test_full_batch_dispatches_without_waiting(stub):
    with _sched(max_batch=2, max_wait_ms=10_000) as s:
        futs = [s.submit(_sample(f"q{i}"), max_new_tokens=8) for i in range(2)]
        for f in futs:
            f.result(timeout=10)
    assert stub.calls == [["q0", "q1"]]


def test_incompatible_requests_split_batches(stub):
    with _sched() as s:
        f1 = s.submit(_sample("a"), max_new_tokens=8)
        f2 = s.submit(_sample("b"), max_new_tokens=16)
        f3 = s.submit(_sample("c", t=8), max_new_tokens=8)
        for f in (f1, f2, f3):
            f.result(timeout=10)
    assert sorted(map(tuple, stub.calls)) == [("a",), ("b",), ("c",)]


def test_oversize_group_splits_at_max_batch(stub):
    with _sched(max_batch=2, max_wait_ms=200) as s:
        futs = [s.submit(_sample(f"q{i}"), max_new_tokens=8) for i in range(5)]
        for f in futs:
            f.result(timeout=10)
    assert sorted(len(c) for c in stub.calls) == [1, 2, 2]
    assert sum(stub.calls, []) == [f"q{i}" for i in range(5)]  # FIFO


def test_poisoned_request_falls_back_per_sample(monkeypatch):
    rec = _Recorder(fail_instructs={"bad"})
    monkeypatch.setattr(serve_mod, "mm_infer_batch", rec)
    with _sched() as s:
        good = s.submit(_sample("good"), max_new_tokens=8)
        bad = s.submit(_sample("bad"), max_new_tokens=8)
        assert good.result(timeout=10)[0] == "echo:good:mnt8"
        with pytest.raises(RuntimeError, match="poisoned"):
            bad.result(timeout=10)
    st = s.stats()
    assert st["fallback_samples"] == 1 and st["errors"] == 1
    assert [len(c) for c in rec.calls] == [2, 1, 1]  # the batch, then each alone


def test_close_drains_pending_then_rejects(stub):
    s = _sched(max_wait_ms=5_000)
    fut = s.submit(_sample("last"), max_new_tokens=8)
    s.close()  # flushes the window early and runs the pending request
    assert fut.result(timeout=1)[0] == "echo:last:mnt8"
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(_sample("late"))


def test_greedy_ignores_seed_in_batch_key(stub):
    with _sched() as s:
        f1 = s.submit(_sample("g1"), max_new_tokens=8, seed=0)
        f2 = s.submit(_sample("g2"), max_new_tokens=8, seed=7)
        for f in (f1, f2):
            f.result(timeout=10)
        assert stub.calls == [["g1", "g2"]]
        f3 = s.submit(_sample("s1"), max_new_tokens=8, do_sample=True, seed=0)
        f4 = s.submit(_sample("s2"), max_new_tokens=8, do_sample=True, seed=7)
        for f in (f3, f4):
            f.result(timeout=10)
    assert sorted(map(tuple, stub.calls[1:])) == [("s1",), ("s2",)]


def test_http_round_trip(stub):
    with _sched() as s:
        s.model = _Model()
        with _serving(s) as port:
            body = {"instruct": "hello", "max_new_tokens": 8,
                    "video_b64": np_to_b64(np.zeros((4, 8, 8, 3), np.float32))}
            with _post(port, body) as r:
                out = json.loads(r.read())
            assert out == {"text": "echo:hello:mnt8", "tokens": [1, 2], "pred_masks_rle": []}
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=10) as r:
                assert json.loads(r.read())["requests"] == 1
            with pytest.raises(urllib.error.HTTPError) as ei:  # malformed: a 400
                _post(port, {"instruct": "x"}, timeout=10)
            assert ei.value.code == 400


def _stub_stream(deltas, fail_after=None):
    def fake(video, instruct, model, tokenizer, modal="video", choice=1,
             masks=None, ann_indices=None, frame=None, chunk=16, **kw):
        for i, d in enumerate(deltas):
            if fail_after is not None and i == fail_after:
                raise RuntimeError("stream blew up")
            yield d
    return fake


def test_submit_stream_yields_deltas(stub, monkeypatch):
    monkeypatch.setattr(serve_mod, "mm_infer_stream", _stub_stream(["Hello ", "world"]))
    with _sched() as s:
        fut = s.submit_stream(_sample("q"), max_new_tokens=8, chunk=4)
        assert list(fut) == ["Hello ", "world"]
        plain = s.submit(_sample("p"), max_new_tokens=8)  # a plain request alongside
        assert plain.result(timeout=10)[0] == "echo:p:mnt8"
    st = s.stats()
    assert st["streamed"] == 1 and st["requests"] == 2


def test_stream_error_raises_at_consumer(stub, monkeypatch):
    monkeypatch.setattr(serve_mod, "mm_infer_stream", _stub_stream(["a", "b"], fail_after=1))
    with _sched() as s:
        fut = s.submit_stream(_sample("q"))
        got = []
        with pytest.raises(RuntimeError, match="blew up"):
            for d in fut:
                got.append(d)
        assert got == ["a"]
    assert s.stats()["errors"] == 1


def test_http_streaming(stub, monkeypatch):
    monkeypatch.setattr(serve_mod, "mm_infer_stream", _stub_stream(["He", "llo"]))
    with _sched() as s:
        s.model = _Model()
        with _serving(s) as port:
            body = {"instruct": "hi", "stream": True, "chunk": 2,
                    "video_b64": np_to_b64(np.zeros((4, 8, 8, 3), np.float32))}
            with _post(port, body) as r:
                assert r.headers["Content-Type"] == "text/event-stream"
                events = _events(r.read())
    assert events == [{"delta": "He"}, {"delta": "llo"}, {"done": True}]


def test_stream_cancel_stops_producer(stub, monkeypatch):
    produced, closed = [], []

    def fake(video, instruct, model, tokenizer, **kw):
        try:
            for i in range(100):
                produced.append(i)
                yield f"d{i}"
                time.sleep(0.02)
        finally:
            closed.append(len(produced))

    monkeypatch.setattr(serve_mod, "mm_infer_stream", fake)
    with _sched() as s:
        fut = s.submit_stream(_sample("q"))
        next(iter(fut))  # the first delta arrived
        fut.cancel()
    # cancellation cut the stream short, and the worker closed the generator
    # itself (no further chunk after the one in flight)
    assert len(produced) < 100
    assert closed == [len(produced)]


def test_latency_percentiles_in_stats(stub):
    with _sched() as s:
        s.submit(_sample("q"), max_new_tokens=8).result(timeout=10)
        st = s.stats()
    assert st["latency_s"]["p50"] >= 0.0
    assert st["latency_s"]["p95"] >= st["latency_s"]["p50"]


def test_mask_rle_round_trips_through_encoding():
    masks = np.random.RandomState(0).rand(1, 2, 6, 5) > 0.5
    enc = _encode_result(("t", {"output": [3], "pred_masks": list(masks)}))
    dec = np.stack([np.stack([rle.decode(f) for f in obj])
                    for obj in enc["pred_masks_rle"]]).astype(bool)
    assert (dec == masks).all()


# ------------------------------------------------------- the port's own cases --

def test_batch_key_reads_frame_counts_of_tensors_on_any_device():
    """A tensor's frame count is read without copying it to the host: a
    meta tensor (which has no data, as a card tensor has none on the host)
    gives the numpy array's key."""
    def key(video, sam):
        return _batch_key(_Request({"instruct": "q", "video": video, "images_sam": sam},
                                   "video", 1, {"max_new_tokens": 8}, None))

    want = key(np.zeros((4, 8, 8, 3), np.uint8), np.zeros((3, 8, 8, 3), np.uint8))
    assert want[2:4] == (4, 3)
    assert key(torch.zeros((4, 8, 8, 3), dtype=torch.uint8),
               torch.zeros((3, 8, 8, 3), dtype=torch.uint8)) == want
    assert key(torch.empty((4, 8, 8, 3), device="meta"),
               torch.empty((3, 8, 8, 3), device="meta")) == want


def test_worker_runs_with_autograd_off(stub):
    """Grad mode is per thread: the worker's dispatches build no graph."""
    assert torch.is_grad_enabled()
    with _sched() as s:
        s.submit(_sample("q"), max_new_tokens=8).result(timeout=10)
    assert stub.grad_enabled == [False]


def test_closed_server_and_scheduler_release_the_model(stub):
    """Once the server is shut and the scheduler closed, dropping them frees
    the model at once, without the cycle collector: a later runtime finds
    the card's memory free."""
    import gc
    import weakref

    model = _Model()
    alive = weakref.ref(model)
    s = _sched()
    s.model = model
    with _serving(s) as port:
        with _post(port, {"instruct": "q", "video_b64": np_to_b64(np.zeros((4, 8, 8, 3)))}) as r:
            assert json.loads(r.read())["text"] == "echo:q:mnt1024"
    s.close()
    gc.disable()
    try:
        del s, model
        assert alive() is None
    finally:
        gc.enable()


@pytest.fixture(scope="module")
def video_file(tmp_path_factory):
    """An mp4 of 17 frames at 8 fps, 30 x 40, written with cv2."""
    import cv2

    path = str(tmp_path_factory.mktemp("serve") / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (40, 30))
    for f in np.random.default_rng(3).integers(0, 256, (17, 30, 40, 3), dtype=np.uint8):
        writer.write(f)
    writer.release()
    return path


def _bodies(video_file):
    rng = np.random.default_rng(11)
    mask = rng.random((30, 40)) > 0.5
    return {
        "region-and-seg": {
            "instruct": "What is <region> doing?", "choice": 1,
            "video_b64": np_to_b64(rng.integers(0, 256, (4, 30, 40, 3), dtype=np.uint8)),
            "masks_rle": [rle.encode(mask), rle.encode(~mask)], "ann_indices": [[0], [1]],
            "frame_b64": np_to_b64(rng.standard_normal((2, 56, 56, 3)).astype(np.float32)),
            "images_sam_b64": np_to_b64(rng.integers(0, 256, (3, 30, 40, 3), dtype=np.uint8)),
            "label_size": [30, 40],
        },
        "video-path": {"instruct": "What happens?", "video_path": video_file},
        "video-path-window": {"instruct": "What happens?", "video_path": video_file,
                              "s": 0.5, "e": 1.5, "num_frames": 6},
        "text": {"instruct": "Hello?", "modal": "text"},
    }


@pytest.mark.parametrize("name", ["region-and-seg", "video-path", "video-path-window", "text"])
def test_build_sample_equals_jax(video_file, name):
    body = _bodies(video_file)[name]
    got = _build_sample(body, tiny_config())
    want = jserve._build_sample(body, j_tiny_config())
    assert got[1:] == want[1:]
    sample, jsample = got[0], want[0]
    assert sorted(sample) == sorted(jsample)
    for k, v in jsample.items():
        if isinstance(v, np.ndarray):
            assert sample[k].dtype == v.dtype
            np.testing.assert_array_equal(sample[k], v)
        else:
            assert sample[k] == v


def test_encode_result_equals_jax():
    rng = np.random.RandomState(4)
    masks = [rng.rand(3, 30, 40) > 0.5, rng.rand(3, 30, 40) > 0.9]
    for res in (("a text", {"output": [5, 6, 7], "pred_masks": masks}),
                (None, {"output": None, "pred_masks": masks[:1], "gt_masks": None}),
                ("", {"output": [], "pred_masks": []})):
        assert _encode_result(res) == jserve._encode_result(res)


@pytest.mark.parametrize("package,body", [
    ("cv2", {"video_path": "clip.mp4"}),
    ("PIL", {"video_path": "."}),
])
def test_video_path_without_its_package_is_a_400_naming_it(stub, monkeypatch, package, body):
    """On a machine without cv2 / PIL (the card's), a ``video_path`` request
    is refused with the missing package's name; the server stays up."""
    monkeypatch.setitem(sys.modules, package, None)
    with _sched() as s:
        s.model = _Model()
        with _serving(s) as port:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(port, dict(body, instruct="q"), timeout=10)
            assert ei.value.code == 400
            assert package in json.loads(ei.value.read())["error"]
            body = {"instruct": "ok", "video_b64": np_to_b64(np.zeros((4, 8, 8, 3), np.uint8))}
            with _post(port, body) as r:
                assert json.loads(r.read())["text"] == "echo:ok:mnt1024"
    assert stub.calls == [["ok"]]


# ---------------------------------------------- a tiny runtime over HTTP --

def test_http_serves_the_tiny_runtime_as_jax_mm_infer(runtimes):
    """Concurrent HTTP requests on a tiny runtime with JAX's weights: two
    questions and a ``<region>`` request form one batch whose tokens and
    text are JAX ``mm_infer``'s; a ``[SEG]`` request's RLE masks are JAX's
    outside the band; a streamed question's deltas join to JAX's text."""
    (jrt, jtok), (rt, tok) = runtimes
    rng = np.random.default_rng(21)
    videos = [_inputs(30 + i)[0] for i in range(4)]
    seg_frames, images_sam = _inputs(34)
    mask = (rng.random((30, 44)) > 0.5).astype(np.float32)
    frame = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    asks = [
        dict(instruct="What happens in scene 0?", video=videos[0]),
        dict(instruct="Who is there?", video=videos[1]),
        dict(instruct="What is <region> doing?", video=videos[2], masks=mask[None],
             frame=frame, ann_indices=[[0]]),
    ]
    bodies = [{"instruct": a["instruct"], "video_b64": np_to_b64(a["video"]),
               "max_new_tokens": 5} for a in asks]
    bodies[2].update(masks_rle=[rle.encode(mask)], frame_b64=np_to_b64(frame),
                     ann_indices=[[0]])
    bodies.append({"instruct": CONV, "choice": 3, "video_b64": np_to_b64(seg_frames),
                   "images_sam_b64": np_to_b64(images_sam), "label_size": list(LABEL)})
    bodies.append({"instruct": "Describe it.", "video_b64": np_to_b64(videos[3]),
                   "max_new_tokens": 6, "stream": True, "chunk": 2})

    replies = [None] * len(bodies)

    def send(i):
        with _post(port, bodies[i], timeout=300) as r:
            replies[i] = r.read()

    with BatchingScheduler(rt, tok, max_batch=4, max_wait_ms=1000) as s:
        with _serving(s) as port:
            threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=10) as r:
                st = json.loads(r.read())
    assert (st["batches"], st["batched_samples"], st["streamed"]) == (2, 4, 1)
    assert st["fallback_samples"] == 0 and st["errors"] == 0

    for a, raw in zip(asks, replies):
        got = json.loads(raw)
        kw = {k: a[k] for k in ("masks", "frame", "ann_indices") if k in a}
        jtext, jout = j_mm_infer(a["video"], a["instruct"], jrt, jtok, max_new_tokens=5, **kw)
        assert got["tokens"] == list(map(int, jout["output"])) and got["text"] == jtext
        assert got["pred_masks_rle"] == []

    seg = json.loads(replies[3])
    assert seg["text"] is None and seg["tokens"] is None and len(seg["pred_masks_rle"]) == 1
    masks = [np.stack([rle.decode(f) for f in obj]).astype(bool) for obj in seg["pred_masks_rle"]]
    want = j_mm_infer(seg_frames, CONV, jrt, jtok, modal="video", choice=3,
                      images_sam=images_sam, label_size=LABEL, seg=True)["pred_masks"]
    ids = _assemble_input_ids(CONV, 3, DEFAULT_VIDEO_TOKEN, tok)
    hidden, plan = rt.forward_hidden_states(
        ids, rt.encode_video(torch.from_numpy(seg_frames)[None]))
    pos = [int(plan.text_pos_map[0][i]) - 1 for i, t in enumerate(ids) if t == rt.ids.seg]
    logits = _logits_at_label_size(rt, hidden[0, pos], images_sam, LABEL)
    _assert_masks_equal_outside_band(masks, list(want), logits, "served [SEG]")

    events = _events(replies[4])
    assert events[-1] == {"done": True} and all("delta" in e for e in events[:-1])
    jtext, _ = j_mm_infer(videos[3], "Describe it.", jrt, jtok, max_new_tokens=6)
    assert "".join(e["delta"] for e in events[:-1]).strip() == jtext


def test_scheduler_matches_mm_infer_on_tiny_runtime(runtimes):
    """Concurrent ``submit``s, one video a CPU tensor, ride one batch whose
    results are the port's and JAX's ``mm_infer``'s."""
    (jrt, jtok), (rt, tok) = runtimes
    videos = [_inputs(40 + i)[0] for i in range(3)]
    prompts = [f"What happens in scene {i}?" for i in range(3)]
    with BatchingScheduler(rt, tok, max_batch=4, max_wait_ms=200) as s:
        futs = [s.submit({"video": torch.from_numpy(v) if i == 1 else v, "instruct": p},
                         max_new_tokens=5)
                for i, (v, p) in enumerate(zip(videos, prompts))]
        got = [f.result(timeout=600) for f in futs]
        st = s.stats()
    assert st["batches"] == 1 and st["batched_samples"] == 3
    for (text, out), v, p in zip(got, videos, prompts):
        ref_text, ref_out = mm_infer(v, p, rt, tok, max_new_tokens=5)
        jtext, jout = j_mm_infer(v, p, jrt, jtok, max_new_tokens=5)
        assert text == ref_text == jtext
        assert list(out["output"]) == list(ref_out["output"]) == list(map(int, jout["output"]))
