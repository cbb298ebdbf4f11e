"""The port's continuous-batching engine (``ufvideo_tpu_torch/engine.py``)
against the JAX package: every case of ``tests/test_engine.py`` on a
``tiny_config()`` runtime loaded with JAX's weights (float32, CPU), each
reply's text against JAX ``mm_infer``'s; ``spec_slot_admit`` /
``spec_set_done`` and ``_copy_slot`` against JAX's on seeded states; the
engine's threads with autograd off; CPU tensor inputs with
``Tensor.__array__`` refused; the chunk kept inside the cache; the build
lock and the launch counter under threads.

Tolerances: text exactly (greedy decoding on the same weights: the engine's
rows are row-independent); a batched admission's first token and length
exactly against the same request admitted alone, its scratch rows within
1e-5 (the JAX test holds them bit for bit: on the CPU, PyTorch's float32
GEMMs sum a row in another order when the batch has another row count,
~3e-6 on the tower's outputs; the prefill rows alone are bit for bit,
``test_prefill_rows_of_a_batch_equal_their_solo_rows``); the
speculative helpers and the slot copy bit for bit (they move values, they
compute none).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_jax_init as jax_init

from test_torch_tensor_inputs import no_numpy_view  # noqa: F401  (a fixture)
from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch import _build
from ufvideo_tpu_torch import engine as engine_mod
from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids, model_init
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.constants import DEFAULT_VIDEO_TOKEN
from ufvideo_tpu_torch.engine import StreamingEngine
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.serve import ServeFuture
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.utils import tracing
from ufvideo_tpu_torch.weights import load_jax_params


def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


def _pair(params, **kw):
    """A JAX runtime on ``params`` and the port's runtime loaded from the
    same tree, both with the config changes ``kw``."""
    jtok, jids = j_byte_tokenizer()
    tok, ids = byte_tokenizer_with_ids()
    jrt = JRuntime(_with_ids(j_tiny_config(), jids).replace(**kw), params, jids)
    cfg = _with_ids(tiny_config(), ids).replace(**kw)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)


@pytest.fixture(scope="module")
def params():
    """The JAX tree of ``UFVideoModel.init_params`` (no SAM2 weights: the QA
    path needs none)."""
    _, jids = j_byte_tokenizer()
    return dict(jax_init.model_params(_with_ids(j_tiny_config(), jids), 0))


@pytest.fixture(scope="module")
def runtimes(params):
    return _pair(params)


_jax_texts = {}


def _jax_text(jrt, jtok, video, prompt, max_new, **kw):
    """JAX ``mm_infer``'s text, cached per request."""
    key = (id(jrt), video.tobytes(), prompt, max_new, tuple(sorted(kw)))
    if key not in _jax_texts:
        _jax_texts[key] = j_mm_infer(video, prompt, jrt, jtok, max_new_tokens=max_new, **kw)[0]
    return _jax_texts[key]


def _video(seed):
    return np.random.RandomState(seed).randn(4, 56, 56, 3).astype(np.float32)


# ------------------------------------------------------ tests/test_engine.py --

def test_engine_matches_mm_infer_with_staggered_admission(runtimes):
    (jrt, jtok), (rt, tok) = runtimes
    videos = [_video(i) for i in range(3)]
    prompts = [f"What happens in scene {i}?" for i in range(3)]
    expect = [_jax_text(jrt, jtok, v, p, 6) for v, p in zip(videos, prompts)]
    with StreamingEngine(rt, tok, max_slots=2, chunk=2, max_new_cap=8) as eng:
        # request 0 starts alone; 1 joins mid-decode; 2 waits behind the
        # 2-slot limit and is admitted when a slot frees
        f0 = eng.submit({"video": videos[0], "instruct": prompts[0]}, max_new_tokens=6)
        time.sleep(0.3)
        f1 = eng.submit({"video": videos[1], "instruct": prompts[1]}, max_new_tokens=6)
        f2 = eng.submit({"video": videos[2], "instruct": prompts[2]}, max_new_tokens=6)
        got = [f.result(timeout=600) for f in (f0, f1, f2)]
        st = eng.stats()
    for i, (text, out) in enumerate(got):
        assert text == expect[i], i
        assert out["pred_masks"] == []
    assert st["completed"] == 3 and st["errors"] == 0
    assert st["admissions"] == 3


def test_engine_streams_share_the_batch(runtimes):
    (jrt, jtok), (rt, tok) = runtimes
    v = _video(7)
    expect = _jax_text(jrt, jtok, v, "Describe.", 6)
    with StreamingEngine(rt, tok, max_slots=3, chunk=2, max_new_cap=8) as eng:
        futs = [eng.submit_stream({"video": v, "instruct": "Describe."}, max_new_tokens=6)
                for _ in range(3)]
        texts = ["".join(f).strip() for f in futs]
        st = eng.stats()
    assert texts == [expect] * 3
    # three streams decoded in shared chunks: serialized ones would need ~3x
    assert st["chunks"] <= 2 * (6 // 2 + 2)


def test_engine_spec_mode_matches_mm_infer(runtimes):
    """spec_k with slot batching: staggered admission, text still JAX's."""
    (jrt, jtok), (rt, tok) = runtimes
    videos = [_video(20 + i) for i in range(2)]
    prompts = [f"Describe object {i}." for i in range(2)]
    expect = [_jax_text(jrt, jtok, v, p, 6) for v, p in zip(videos, prompts)]
    with StreamingEngine(rt, tok, max_slots=2, chunk=2, max_new_cap=8, spec_k=2) as eng:
        f0 = eng.submit({"video": videos[0], "instruct": prompts[0]}, max_new_tokens=6)
        time.sleep(0.3)
        f1 = eng.submit({"video": videos[1], "instruct": prompts[1]}, max_new_tokens=6)
        got = [f.result(timeout=600) for f in (f0, f1)]
        st = eng.stats()
    for i, (text, _out) in enumerate(got):
        assert text == expect[i], i
    assert st["completed"] == 2 and st["errors"] == 0
    assert st["spec"]["drafted"] > 0  # the spec path ran


def test_engine_rejects_unsupported(runtimes):
    _, (rt, tok) = runtimes
    with StreamingEngine(rt, tok, max_slots=2, max_new_cap=8) as eng:
        with pytest.raises(ValueError, match="greedy-only"):
            eng.submit({"instruct": "x"}, modal="text", do_sample=True)
        with pytest.raises(ValueError, match="QA-only"):
            eng.submit({"instruct": "x", "images_sam": np.zeros((1, 8, 8, 3))}, modal="text")
        with pytest.raises(ValueError, match="cap"):
            eng.submit({"instruct": "x"}, modal="text", max_new_tokens=99)
        # a [SEG] in the prompt fails at admission, delivered to the caller
        with pytest.raises(ValueError, match="QA-only"):
            eng.submit({"instruct": "Segment [SEG]."}, modal="text",
                       max_new_tokens=4).result(timeout=600)
    with pytest.raises(RuntimeError, match="engine is closed"):
        eng.submit({"instruct": "x"}, modal="text", max_new_tokens=4)


def test_engine_queue_full(runtimes):
    """One admitter held inside its preparation: the next request waits in
    the one-place queue and the one after is refused."""
    _, (rt, tok) = runtimes
    eng = StreamingEngine(rt, tok, max_slots=2, max_new_cap=8, max_queue=1, admitters=1)
    entered, release = threading.Event(), threading.Event()
    real = eng._prepare

    def held(reqs):
        entered.set()
        release.wait(60)
        return real(reqs)

    eng._prepare = held
    try:
        f1 = eng.submit({"instruct": "a"}, modal="text", max_new_tokens=3)
        assert entered.wait(60)
        f2 = eng.submit({"instruct": "b"}, modal="text", max_new_tokens=3)
        with pytest.raises(RuntimeError, match="queue full"):
            eng.submit({"instruct": "c"}, modal="text", max_new_tokens=3)
    finally:
        release.set()
        eng.close(timeout=600)
    assert isinstance(f1.result(timeout=1)[0], str) and isinstance(f2.result(timeout=1)[0], str)


def test_engine_batched_admission_matches_solo(runtimes):
    """Queued same-shaped video requests share one encode / splice / prefill
    chain. Every stage is row-independent, so the first token and length
    equal the request's solo chain's and the scratch rows agree to float32
    rounding (the module docstring)."""
    _, (rt, tok) = runtimes
    videos = [_video(40 + i) for i in range(3)]
    prompts = ["What happens?", "Describe the third object in this scene in detail.", "Why?"]
    make = lambda v, p: engine_mod._EngineRequest(
        {"video": v, "instruct": p}, "video", 1, {"max_new_tokens": 6}, ServeFuture(), False)
    with StreamingEngine(rt, tok, max_slots=4, max_new_cap=8) as eng:
        with torch.no_grad():
            batched = eng._prepare([make(v, p) for v, p in zip(videos, prompts)])
            assert all(isinstance(b, engine_mod._Prepared) for b in batched)
            assert batched[0].scratch is batched[1].scratch  # one scratch: batched
            for v, p, prep in zip(videos, prompts, batched):
                ids = _assemble_input_ids(p, 1, DEFAULT_VIDEO_TOKEN, tok)
                solo = eng._prepare_one(make(v, p), ids)
                assert prep.t0 == solo.t0
                assert prep.real_len == solo.real_len
                for name, t in prep.scratch.items():
                    torch.testing.assert_close(t[:, prep.src], solo.scratch[name][:, 0],
                                               rtol=1e-5, atol=1e-5, msg=name)


def test_prefill_rows_of_a_batch_equal_their_solo_rows(runtimes):
    """The admission's prefill alone, on the same spliced rows: a row of a
    batched prefill equals the row prefilled alone bit for bit (cache and
    first token), so the admission's only drift is the tower's."""
    _, (rt, tok) = runtimes
    prompts = ["What happens?", "Describe the third object in this scene in detail.", "Why?"]
    ids = [_assemble_input_ids(p, 1, DEFAULT_VIDEO_TOKEN, tok) for p in prompts]
    with torch.no_grad():
        feats = rt.encode_video(torch.from_numpy(np.stack([_video(40 + i) for i in range(3)])))
        plan, embeds = rt._splice_plan(ids, feats)
        with StreamingEngine(rt, tok, max_slots=4, max_new_cap=8) as eng:
            batch, t0 = eng._prefill(embeds, plan.seq_lens)
            for i in range(3):
                solo, s0 = eng._prefill(embeds[i:i + 1], plan.seq_lens[i:i + 1])
                assert t0[i] == s0[0]
                for name, t in batch.items():
                    assert torch.equal(t[:, i], solo[name][:, 0]), name


def test_engine_kv_quant_cache(params):
    """The int8 persistent cache: the slot copy carries the scale leaves and
    the text is JAX's on the same quantisation."""
    (jrt, jtok), (rt, tok) = _pair(params, quant_kv=True)
    v = _video(11)
    expect = _jax_text(jrt, jtok, v, "What is shown?", 5)
    with StreamingEngine(rt, tok, max_slots=2, chunk=2, max_new_cap=8) as eng:
        got = eng.submit({"video": v, "instruct": "What is shown?"},
                         max_new_tokens=5).result(timeout=600)
        assert set(eng._cache) == {"k", "v", "k_scale", "v_scale"}
    assert got[0] == expect


def test_engine_close_drains_queue(runtimes):
    (jrt, jtok), (rt, tok) = runtimes
    v = _video(9)
    eng = StreamingEngine(rt, tok, max_slots=1, chunk=2, max_new_cap=8)
    f1 = eng.submit({"video": v, "instruct": "a?"}, max_new_tokens=4)
    f2 = eng.submit({"video": v, "instruct": "b?"}, max_new_tokens=4)
    eng.close(timeout=600)
    assert f1.result(timeout=1)[0] == _jax_text(jrt, jtok, v, "a?", 4)
    assert f2.result(timeout=1)[0] == _jax_text(jrt, jtok, v, "b?", 4)
    assert not eng._worker.is_alive() and not any(t.is_alive() for t in eng._admitters)


def test_engine_concurrent_admitters_exact(runtimes):
    """admitters=3: eight requests from eight client threads flood a 4-slot
    engine; every text is JAX's and every request is admitted once."""
    (jrt, jtok), (rt, tok) = runtimes
    videos = [_video(20 + i) for i in range(8)]
    prompts = [f"Scene {i} shows?" for i in range(8)]
    expect = [_jax_text(jrt, jtok, v, p, 5) for v, p in zip(videos, prompts)]
    results = [None] * 8
    with StreamingEngine(rt, tok, max_slots=4, chunk=2, max_new_cap=8, admitters=3) as eng:
        def client(i):
            results[i] = eng.submit({"video": videos[i], "instruct": prompts[i]},
                                    max_new_tokens=5).result(timeout=600)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        assert not any(t.is_alive() for t in threads)
        st = eng.stats()
    for i, got in enumerate(results):
        assert got is not None and got[0] == expect[i], i
    assert st["completed"] == 8 and st["errors"] == 0
    assert st["admissions"] == 8
    assert st["admit_batched_requests"] == 8


# ---------------------------------------------------------------- the port --

def test_engine_threads_run_with_autograd_off(runtimes, monkeypatch):
    """Grad mode is per thread: the admitters' prefills and the worker's
    decode steps run under no_grad though the caller's thread has it on."""
    _, (rt, tok) = runtimes
    seen = []

    def recording(fn):
        def wrapped(*a, **k):
            seen.append((fn.__name__, torch.is_grad_enabled()))
            return fn(*a, **k)
        return wrapped

    for name in ("prefill_cache", "decode_chunk"):
        monkeypatch.setattr(engine_mod, name, recording(getattr(engine_mod, name)))
    assert torch.is_grad_enabled()
    with StreamingEngine(rt, tok, max_slots=2, chunk=2, max_new_cap=8) as eng:
        eng.submit({"video": _video(3), "instruct": "Hm?"}, max_new_tokens=4).result(timeout=600)
    assert {n for n, _ in seen} == {"prefill_cache", "decode_chunk"}
    assert not any(grad for _, grad in seen)


def test_engine_takes_cpu_tensors(runtimes, no_numpy_view):  # noqa: F811
    """Frames as CPU tensors (the batched path) and a ``<region>`` request
    whose frames, annotated frame and mask are tensors (the solo path), with
    ``Tensor.__array__`` refused: JAX's text on the same inputs as numpy."""
    (jrt, jtok), (rt, tok) = runtimes
    rng = np.random.default_rng(5)
    v = [_video(60 + i) for i in range(2)]
    frame = rng.standard_normal((1, 56, 56, 3)).astype(np.float32)
    mask = (rng.random((1, 30, 44)) > 0.5).astype(np.float32)
    region = "What is <region> doing?"
    expect = [_jax_text(jrt, jtok, v[0], "What happens?", 5),
              _jax_text(jrt, jtok, v[1], region, 5, frame=frame, masks=mask)]
    t = torch.from_numpy
    with StreamingEngine(rt, tok, max_slots=2, chunk=2, max_new_cap=8) as eng:
        futs = [eng.submit({"video": t(v[0]), "instruct": "What happens?"}, max_new_tokens=5),
                eng.submit({"video": t(v[1]), "instruct": region, "frame": t(frame),
                            "masks": t(mask)}, max_new_tokens=5)]
        got = [f.result(timeout=600)[0] for f in futs]
        assert eng.stats()["errors"] == 0
    assert got == expect


def test_engine_stage_sync_splits_prep(runtimes):
    """The admission stages without a fence: inside a profiler session the
    dispatch is an ``admit`` span with one ``admit.<stage>`` child a stage,
    in the chain's order, and each stage's device seconds (on the CPU its
    host interval) go to ``admit_<stage>_device_s`` and their sum to
    ``admit_device_s``; the text stays JAX's."""
    (jrt, jtok), (rt, tok) = runtimes
    v = _video(13)
    t0 = time.time_ns()
    with StreamingEngine(rt, tok, max_slots=2, chunk=2, max_new_cap=8) as eng, \
            profile(activities=[ProfilerActivity.CPU]):
        got = eng.submit({"video": v, "instruct": "What is shown?"},
                         max_new_tokens=5).result(timeout=600)
        st = eng.stats()
    assert got[0] == _jax_text(jrt, jtok, v, "What is shown?", 5)
    stages = ("transfer", "encode", "splice", "prefill")
    assert not any(k.startswith("stage_") for k in st)
    spans = tracing.RECORDER.spans(t0)
    admit = next(s for s in spans if s.name == "admit")
    kids = [s for s in spans if s.parent == admit.id]
    assert [s.name for s in kids] == [f"admit.{n}" for n in stages]
    assert all(admit.start_ns <= s.start_ns <= s.end_ns <= admit.end_ns for s in kids)
    assert all(s.requests == admit.requests for s in kids) and len(admit.requests) == 1
    assert all(st[f"admit_{n}_device_s"] >= 0 for n in stages)
    assert st["admit_encode_device_s"] > 0 and st["admit_prefill_device_s"] > 0
    assert st["admit_device_s"] == pytest.approx(
        sum(st[f"admit_{n}_device_s"] for n in stages), abs=3e-3)
    assert st["admit_device_s"] <= st["prep_s"] + 1e-3


def test_engine_failed_dispatch_retries_alone(runtimes, monkeypatch):
    """A failed batched dispatch leaves its requests to the solo chain, which
    gives JAX's text, and ``admit_fallback_requests`` counts them."""
    (jrt, jtok), (rt, tok) = runtimes

    def broken(self, reqs, members, results):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(StreamingEngine, "_prepare_video_subgroup", broken)
    v = _video(14)
    with StreamingEngine(rt, tok, max_slots=2, chunk=2, max_new_cap=8) as eng:
        got = eng.submit({"video": v, "instruct": "Why?"}, max_new_tokens=5).result(timeout=600)
        st = eng.stats()
    assert got[0] == _jax_text(jrt, jtok, v, "Why?", 5)
    assert (st["admit_fallback_requests"], st["admit_batches"], st["errors"]) == (1, 0, 0)


def test_engine_failed_prestage_returns_its_place(runtimes):
    """A request whose staging raised is refused and gives its place in the
    staging budget back."""
    _, (rt, tok) = runtimes
    with StreamingEngine(rt, tok, max_slots=2, max_new_cap=8) as eng:
        def failing(req):
            with eng._prestage_lock:
                eng._prestaged += 1
            req.prestaged = True
            raise RuntimeError("copy failed")

        eng._prestage = failing
        for _ in range(3):
            with pytest.raises(RuntimeError, match="copy failed"):
                eng.submit({"video": _video(15), "instruct": "x"}, max_new_tokens=2)
        assert eng._prestaged == 0
        assert eng.stats()["requests"] == 0


def test_engine_chunk_stays_inside_the_cache():
    """A zeroed LM never emits eos, so each request runs to its budget. At a
    chunk of 7 a request decodes in whole chunks up to 6 tokens past its
    budget of 128 before the host retires it; from a prompt near the
    sequence budget that runs past the cache's last position. The chunk ends
    there instead: no write past the cache (plain mode) and every request
    gets exactly its budget."""
    rt, _, tok = model_init(cfg=tiny_config(), device="cpu", seed=1)
    with torch.no_grad():
        for p in list(rt.model.llm.parameters()) + list(rt.model.llm.buffers()):
            p.zero_()
    long_q = "x" * 60  # with 4 frames' video tokens, close to max_seq_len = 128
    with StreamingEngine(rt, tok, max_slots=2, chunk=7, max_new_cap=128) as eng:
        assert eng.cache_positions == 256
        futs = [eng.submit({"video": _video(i), "instruct": q}, max_new_tokens=128)
                for i, q in enumerate((long_q, "Short?"))]
        outs = [f.result(timeout=600)[1]["output"] for f in futs]
        st = eng.stats()
    assert [len(o) for o in outs] == [128, 128] and st["errors"] == 0
    ids = _assemble_input_ids(long_q, 1, DEFAULT_VIDEO_TOKEN, tok)
    plan, _ = rt._splice_plan([ids], rt.encode_video(torch.from_numpy(_video(0))[None]))
    whole_chunks = 1 + 7 * -(-(128 - 1) // 7)  # tokens after the prefill's and whole chunks
    assert int(plan.seq_lens[0]) + whole_chunks - 2 >= 256  # the last write would run off


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_spec_slot_admit_and_set_done_equal_jax(quant):
    """Seeded loop states, a two-row scratch shorter than the cache, src 1
    into slot 2, then a done mask: every field equals JAX's."""
    from ufvideo_tpu.models import speculative as jspec
    from ufvideo_tpu_torch.models import speculative as tspec

    rng = np.random.default_rng(7 + quant)
    b, cap, s_off, hid, shape = 4, 6, 10, 8, (2, 4, 2, 32, 16)  # [L, B, Hkv, S, D]

    def cache(batch, s):
        sh = shape[:1] + (batch,) + shape[2:3] + (s,) + shape[4:]
        if not quant:
            x = rng.standard_normal(sh).astype(np.float32)
            return {"k": x, "v": x + 1}
        q = lambda: rng.integers(-127, 128, sh, dtype=np.int8)
        sc = lambda: rng.random(sh[:-1]).astype(np.float32)
        return {"k": q(), "v": q(), "k_scale": sc(), "v_scale": sc()}

    state = dict(
        tokens=rng.integers(0, 500, (b, cap)), hiddens=rng.standard_normal((b, cap, hid)),
        cache=cache(b, 32), cache_len=rng.integers(1, 30, b), cur=rng.integers(0, 500, b),
        done=rng.random(b) > 0.5, gen_lens=rng.integers(1, cap, b),
        hist=rng.integers(-1, 500, (b, s_off + cap)), n_drafted=rng.integers(0, 9, b),
        n_accepted=rng.integers(0, 9, b))
    scratch = cache(2, 16)
    hist_row = rng.integers(-1, 500, s_off + cap)
    mask = np.array([True, False, False, True])
    names = ("tokens", "hiddens", "cache", "cache_len", "cur", "done", "gen_lens", "hist",
             "n_drafted", "n_accepted")

    jdt = lambda a: (jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32 and not quant
                     and a.ndim == 5 else jnp.asarray(
                         a.astype(np.int32) if a.dtype == np.int64 else a))
    jcache = lambda c: {k: jdt(a) for k, a in c.items()}
    jstate = (jnp.asarray(3, jnp.int32),) + tuple(
        jcache(state[n]) if n == "cache" else jdt(state[n].astype(np.float32) if n == "hiddens"
                                                   else state[n]) for n in names)
    jstate = jspec.spec_slot_admit(jstate, 2, jcache(scratch), jnp.asarray(7, jnp.int32),
                                   jnp.asarray(9, jnp.int32), jdt(hist_row), src=1)
    jstate = jspec.spec_set_done(jstate, jnp.asarray(mask))

    tdt = lambda a: (torch.from_numpy(a).to(torch.bfloat16) if a.dtype == np.float32
                     and not quant and a.ndim == 5 else torch.from_numpy(a.copy()))
    tcache = lambda c: {k: tdt(a) for k, a in c.items()}
    tstate = tspec.SpecState(it=3, **{
        n: tcache(state[n]) if n == "cache" else tdt(
            state[n].astype(np.float32) if n == "hiddens" else state[n]) for n in names})
    out = tspec.spec_slot_admit(tstate, 2, tcache(scratch), 7, 9, torch.from_numpy(hist_row),
                                src=1)
    out = tspec.spec_set_done(out, mask)

    as_np = lambda x: np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x) \
        if not torch.is_tensor(x) else x.float().numpy() if x.dtype == torch.bfloat16 \
        else x.numpy()
    assert int(jstate[0]) == out.it == 3
    for name, jv in zip(names, jstate[1:]):
        tv = getattr(out, name)
        if name == "cache":
            for k in jv:
                np.testing.assert_array_equal(as_np(tv[k]), as_np(jv[k]), err_msg=k)
        else:
            np.testing.assert_array_equal(as_np(tv), as_np(jv), err_msg=name)
    assert bool(out.done[2]) is False and bool(out.done[0]) is True


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_copy_slot_equals_jax(quant):
    """Row 1 of a shorter two-row scratch into slot 3, every leaf."""
    from ufvideo_tpu.engine import _copy_slot as j_copy_slot
    from ufvideo_tpu.models.qwen2 import make_kv_cache as j_make_kv_cache
    from ufvideo_tpu_torch.models.qwen2 import make_kv_cache

    cfg = tiny_config().llm
    rng = np.random.default_rng(11 + quant)
    fill = lambda sh, dt: (rng.integers(-127, 128, sh, dtype=np.int8) if dt == torch.int8
                           else rng.standard_normal(sh).astype(np.float32))
    big = {k: fill(tuple(t.shape), t.dtype) for k, t in make_kv_cache(
        cfg, 4, 256, dtype=torch.float32, quant=quant).items()}
    small = {k: fill(tuple(t.shape), t.dtype) for k, t in make_kv_cache(
        cfg, 2, 128, dtype=torch.float32, quant=quant).items()}
    assert set(big) == set(j_make_kv_cache(j_tiny_config().llm, 1, 8, quant=quant))
    cache = {k: torch.from_numpy(a.copy()) for k, a in big.items()}
    engine_mod._copy_slot(cache, {k: torch.from_numpy(a) for k, a in small.items()}, 3, 1)
    want = j_copy_slot({k: jnp.asarray(a) for k, a in big.items()},
                       {k: jnp.asarray(a) for k, a in small.items()}, 3, 1)
    for k in big:
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------- threads and builds --

def test_build_load_builds_once_under_threads(monkeypatch, tmp_path):
    """Two threads' first use of one library: one build, one load, both get
    the same library; each build's temporary path names its process and
    thread."""
    builds, tmp_names = [], []

    def slow_build(names):
        builds.append(tuple(names))
        time.sleep(0.2)  # the window in which a second thread would start a build too
        return {n: 0.0 for n in names}

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: type("Lib", (), {
        "ufv_error_string": type("F", (), {})()})())
    got = [None, None]

    def first_use(i):
        got[i] = _build.load("quant_matmul")

    threads = [threading.Thread(target=first_use, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert builds == [("quant_matmul",)]
    assert got[0] is got[1] is not None

    # the build step's temporary path (nvcc stubbed): unique per thread
    monkeypatch.undo()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")

    both_alive = threading.Barrier(2)  # so that no thread id is reused

    class Proc:
        returncode = 1

        def __init__(self, cmd, **kw):
            tmp_names.append(cmd[cmd.index("-o") + 1])
            both_alive.wait(60)

        def communicate(self):
            return "stubbed", None

    monkeypatch.setattr(_build.subprocess, "Popen", Proc)

    def try_build():
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.build(["quant_matmul"])

    threads = [threading.Thread(target=try_build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert len(tmp_names) == 2 and len(set(tmp_names)) == 2


def test_launch_counts_lose_nothing_under_threads():
    """Sixteen threads add to one wrapper's count 20000 times each, the
    interpreter switching threads every microsecond: a lost update would
    show in the total; and every write of the count happens under the
    counter's lock (CPython's interpreter lock alone happens to keep this
    read-modify-write whole today; nothing promises it)."""
    import sys

    class Wrapper:
        unlocked_writes = 0

        @property
        def launches(self):
            return self._n

        @launches.setter
        def launches(self, n):
            self.unlocked_writes += not _build._count_lock.locked()
            self._n = n

    wrapper = Wrapper()
    wrapper.launches = 0
    wrapper.unlocked_writes = 0

    def add():
        for _ in range(20000):
            _build.count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 20000 and wrapper.unlocked_writes == 0
