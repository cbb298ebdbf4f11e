"""Streaming decode in the port against the JAX package (``tiny_config()``,
float32, CPU): ``stream_generate`` / ``prefill_start`` / ``decode_chunk`` on
``load_qwen2`` weights against JAX's on the same tree (also on the int8 +
int8-KV and int4 models, quantised by the JAX functions),
``TextDeltaStreamer`` against its JAX original, and ``mm_infer_stream``
against JAX's and against the port's ``mm_infer``.

Tolerances: tokens, ``n`` and the loop state exactly; hidden states within
2e-4, the JAX package's own limit in ``tests/test_streaming.py`` (the same
float32 math summed in another order through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu import quant as jq
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.mm_utils import TextDeltaStreamer as JTextDeltaStreamer
from ufvideo_tpu.models import generate as jgen
from ufvideo_tpu.models.qwen2 import Qwen2LM as JQwen2LM
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.mm_utils import TextDeltaStreamer
from ufvideo_tpu_torch.models import generate as tgen
from ufvideo_tpu_torch.models.qwen2 import Qwen2LM
from ufvideo_tpu_torch.weights import load_qwen2

TOL = 2e-4


def _pair(quant=False):
    """A JAX LM and the port's LM on one tree, quantised by the JAX
    functions for ``quant``."""
    jcfg = j_tiny_config().llm
    params = JQwen2LM(jcfg, dtype=jnp.float32, param_dtype=jnp.float32).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))["params"]
    if quant:
        params = jq.quantize_qwen2_params(params, bits=4 if quant == "int4" else 8)
    jlm = JQwen2LM(jcfg, dtype=jnp.float32, param_dtype=jnp.float32, quant=quant)
    with torch.device("meta"):
        lm = Qwen2LM(tiny_config().llm, dtype=torch.float32, quant=quant)
    lm = lm.to_empty(device="cpu")
    load_qwen2(lm, jax.tree.map(np.asarray, params))
    return (jlm, params), lm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _embeds(seed, b=2, s=20):
    return np.random.default_rng(seed).standard_normal((b, s, 64)).astype(np.float32)


def _drain_jax(jlm, params, embeds, lens, **kw):
    return [tuple(np.asarray(a) for a in y) for y in jgen.stream_generate(
        jlm, params, jnp.asarray(embeds), jnp.asarray(lens), **kw)]


def _drain(lm, embeds, lens, **kw):
    return [tuple(a.numpy() for a in y) for y in tgen.stream_generate(
        lm, torch.from_numpy(embeds), torch.from_numpy(lens), **kw)]


def _assert_yields_equal(got, want):
    """Yield for yield: tokens and n exactly, hidden states of the valid
    steps within TOL, the same done."""
    assert len(got) == len(want)
    for (tok, n, hid, done), (jtok, jn, jhid, jdone) in zip(got, want):
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(done, jdone)
        np.testing.assert_array_equal(tok, jtok)
        for i, k in enumerate(n):
            np.testing.assert_allclose(hid[i, :k], jhid[i, :k], atol=TOL, rtol=TOL)


def _rows(yields):
    rows = [[] for _ in range(yields[0][0].shape[0])]
    for tok, n, _, _ in yields:
        for i, k in enumerate(n):
            rows[i].extend(tok[i, :k].tolist())
    return rows


@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
def test_stream_matches_jax_and_the_fused_loop(pair, chunk):
    (jlm, params), lm = pair
    embeds, lens = _embeds(0), np.asarray([20, 13], np.int32)
    kw = dict(max_new_tokens=17, stop_ids=(-1,), cache_max_len=20 + 17)
    got = _drain(lm, embeds, lens, chunk=chunk, **kw)
    _assert_yields_equal(got, _drain_jax(jlm, params, embeds, lens, chunk=chunk, **kw))
    fused = tgen.greedy_generate(lm, torch.from_numpy(embeds), torch.from_numpy(lens), **kw)
    for i, row in enumerate(_rows(got)):
        assert row == fused.tokens[i, :int(fused.gen_lens[i])].tolist()


@pytest.mark.parametrize("quant,kv_quant", [("int8", True), ("int4", False)],
                         ids=["int8-kv8", "int4"])
def test_stream_matches_jax_on_quantised_models(quant, kv_quant):
    """The quantised models (weights quantised by the JAX functions), the
    int8 model on an int8 KV cache: yield for yield JAX's."""
    (jlm, params), lm = _pair(quant)
    embeds, lens = _embeds(2), np.asarray([20, 13], np.int32)
    kw = dict(max_new_tokens=10, stop_ids=(-1,), cache_max_len=30, chunk=3,
              kv_quant=kv_quant)
    _assert_yields_equal(_drain(lm, embeds, lens, **kw),
                         _drain_jax(jlm, params, embeds, lens, **kw))


def test_stream_stop_id_mid_chunk(pair):
    (jlm, params), lm = pair
    embeds, lens = _embeds(4), np.asarray([20, 20], np.int32)
    base = tgen.greedy_generate(lm, torch.from_numpy(embeds), torch.from_numpy(lens),
                                max_new_tokens=16, stop_ids=(-1,), cache_max_len=36)
    stop = int(base.tokens[0, 5])  # a token row 0 emits
    kw = dict(max_new_tokens=16, stop_ids=(stop,), cache_max_len=36, chunk=4)
    got = _drain(lm, embeds, lens, **kw)
    _assert_yields_equal(got, _drain_jax(jlm, params, embeds, lens, **kw))
    assert len(_rows(got)[0]) <= 6 and _rows(got)[0][-1] == stop


def test_prefill_start_and_decode_chunk_state_match_jax(pair):
    """The loop state after the prefill and after one chunk that a done row
    sits out and another row finishes inside: cache_len, cur, done, the
    tokens, n and the cache."""
    (jlm, params), lm = pair
    embeds, lens = _embeds(7, b=3), np.asarray([20, 15, 9], np.int32)
    jcache, jt0, jlast, _ = jgen.prefill_start(
        jlm, params, jnp.asarray(embeds), jnp.asarray(lens), cache_max_len=40)
    cache, t0, last = tgen.prefill_start(
        lm, torch.from_numpy(embeds), torch.from_numpy(lens), cache_max_len=40)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(jt0))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=TOL, rtol=TOL)
    ahead = tgen.greedy_generate(lm, torch.from_numpy(embeds), torch.from_numpy(lens),
                                 max_new_tokens=6, stop_ids=(-1,), cache_max_len=40)
    stop = int(ahead.tokens[1, 3])  # row 1 stops inside the chunk
    done = np.asarray([True, False, False])
    jout = jgen.decode_chunk(jlm, params, jcache, jnp.asarray(lens), jt0, jnp.asarray(done),
                             chunk=5, stop_ids=(stop,))
    out = tgen.decode_chunk(lm, cache, torch.from_numpy(lens), t0, torch.from_numpy(done),
                            chunk=5, stop_ids=(stop,))
    tokens, n, hid, cache, cache_len, cur, done_after = out
    jtokens, jn, jhid, jcache, jcache_len, jcur, jdone_after, _ = jout
    for a, b in ((tokens, jtokens), (n, jn), (cache_len, jcache_len), (cur, jcur),
                 (done_after, jdone_after)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(n[0]) == 0 and int(cache_len[0]) == 20  # the done row did not move
    for i, k in enumerate(n.tolist()):
        np.testing.assert_allclose(hid[i, :k].numpy(), np.asarray(jhid)[i, :k],
                                   atol=TOL, rtol=TOL)
    for name in ("k", "v"):
        for i, k in enumerate(cache_len.tolist()):
            np.testing.assert_allclose(cache[name][:, i, :, :k].numpy(),
                                       np.asarray(jcache[name])[:, i, :, :k],
                                       atol=TOL, rtol=TOL)


def test_sampled_stream_equals_the_fused_sampled_loop(pair):
    """One seed, the same draws in the same order: the stream's sampled
    tokens are ``greedy_generate``'s. (The port draws with torch.multinomial,
    JAX with jax.random.categorical, so sampled tokens are held against the
    port's own fused loop.)"""
    _, lm = pair
    embeds, lens = _embeds(8), np.asarray([20, 20], np.int32)
    kw = dict(max_new_tokens=12, stop_ids=(-1,), cache_max_len=32, do_sample=True,
              temperature=0.9, top_p=0.8)
    fused = tgen.greedy_generate(lm, torch.from_numpy(embeds), torch.from_numpy(lens),
                                 generator=torch.Generator().manual_seed(42), **kw)
    rows = _rows(_drain(lm, embeds, lens, chunk=5,
                        generator=torch.Generator().manual_seed(42), **kw))
    for i, row in enumerate(rows):
        assert row == fused.tokens[i, :int(fused.gen_lens[i])].tolist()
    other = tgen.greedy_generate(lm, torch.from_numpy(embeds), torch.from_numpy(lens),
                                 generator=torch.Generator().manual_seed(43), **kw)
    assert not torch.equal(other.tokens, fused.tokens)  # the draws do matter


# --------------------------------------------------------- TextDeltaStreamer --

class _ByteTok:
    def decode(self, ids, skip_special_tokens=True):
        return bytes(ids).decode("utf-8", errors="replace")


def _drain_text(streamer, chunks):
    out = []
    for c in chunks:
        d, stopped = streamer.push(c)
        out.append((d, stopped))
        if stopped:
            return out
    out.append((streamer.finish(), streamer.stopped))
    return out


def _random_chunks():
    rng = np.random.RandomState(0)
    cases = []
    for _ in range(20):
        n = rng.randint(1, 60)
        ids = [int(b) for b in rng.bytes(n)]
        cuts = sorted(rng.choice(n + 1, size=min(4, n), replace=True))
        chunks, prev = [], 0
        for c in list(cuts) + [n]:
            if c > prev:
                chunks.append(ids[prev:c])
                prev = c
        cases.append(chunks)
    return cases


_SPLIT = list("ab".encode()) + list("日".encode()) + list("c".encode())
TEXT_CASES = {
    # a multi-byte character split across chunks never leaks a U+FFFD
    "holds-partial-utf8": ([], [[_SPLIT[:3], _SPLIT[3:4], _SPLIT[4:]]], "ab日c"),
    # generation that ends mid-character flushes the replacement at finish
    "trailing-partial-at-finish": ([], [[list("x".encode()) + list("日".encode())[:2]]],
                                   "x�"),
    # a stop string across a chunk boundary never streams its prefix
    "stop-across-chunks": (["###"], [[list("answer #".encode()), list("##tail".encode())]],
                           "answer "),
    "stop-inside-one-chunk": (["STOP"], [[list("hello STOP world".encode())]], "hello "),
    "random-bytes": ([], _random_chunks(), None),
}


@pytest.mark.parametrize("cls", [TextDeltaStreamer, JTextDeltaStreamer],
                         ids=["port", "jax"])
@pytest.mark.parametrize("case", list(TEXT_CASES))
def test_text_delta_streamer(cls, case):
    """Each case of the JAX package's streamer tests through both classes:
    the deltas (and the stop flags) of the port's class equal JAX's, and
    their join is the one-shot decode, stop-trimmed."""
    stops, runs, want = TEXT_CASES[case]
    for chunks in runs:
        got = _drain_text(cls(_ByteTok(), stop_strings=stops), chunks)
        assert got == _drain_text(JTextDeltaStreamer(_ByteTok(), stop_strings=stops), chunks)
        text = "".join(d for d, _ in got)
        whole = bytes(sum(chunks, [])).decode("utf-8", errors="replace")
        assert text == (want if want is not None else whole)
        if not stops:
            assert all("�" not in d for d, _ in got[:-1]) or "�" in whole
    if case == "stop-across-chunks":
        assert got[0] == ("answer", False) and got[1] == (" ", True)


# ------------------------------------------------------------ mm_infer_stream --

@pytest.fixture(scope="module")
def runtimes():
    """A JAX runtime on ``init_params`` (no SAM2 weights: the QA path needs
    none) and the port's runtime loaded from the same tree."""
    from ufvideo_tpu.api import UFVideoRuntime as JRuntime
    from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
    from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
    from ufvideo_tpu_torch.api import UFVideoRuntime
    from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
    from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
    from ufvideo_tpu_torch.weights import load_jax_params

    jtok, jids = j_byte_tokenizer()
    with_ids = lambda cfg, ids: cfg.replace(
        region_token_id=ids.region, seg_token_id=ids.seg,
        temporal_token_start_id=ids.temporal_start)
    jcfg = with_ids(j_tiny_config(), jids)
    params = jax.jit(JUFVideoModel(jcfg).init_params)(jax.random.PRNGKey(0))
    tok, ids = byte_tokenizer_with_ids()
    cfg = with_ids(tiny_config(), ids)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return (JRuntime(jcfg, dict(params), jids), jtok), (UFVideoRuntime(cfg, model, ids, "cpu"),
                                                         tok)


def test_mm_infer_stream_matches_jax_and_mm_infer(runtimes):
    """Joined deltas == JAX's joined deltas == the port's ``mm_infer`` text;
    also under ``spec_decode`` (speculation and streaming compose); a
    ``[SEG]`` in the input raises."""
    from ufvideo_tpu.api import UFVideoRuntime as JRuntime
    from ufvideo_tpu.api import mm_infer_stream as j_mm_infer_stream
    from ufvideo_tpu_torch.api import UFVideoRuntime, mm_infer, mm_infer_stream

    (jrt, jtok), (rt, tok) = runtimes
    frames = np.random.default_rng(3).standard_normal((4, 56, 56, 3)).astype(np.float32)
    kw = dict(max_new_tokens=8)
    text, out = mm_infer(frames, "What happens?", rt, tok, **kw)
    deltas = list(mm_infer_stream(frames, "What happens?", rt, tok, chunk=3, **kw))
    jdeltas = list(j_mm_infer_stream(frames, "What happens?", jrt, jtok, chunk=3, **kw))
    assert "".join(deltas).strip() == "".join(jdeltas).strip() == text
    assert len(deltas) >= 1
    ids = []
    for chunk_ids, _ in rt.generate_stream(
            *_request(rt, tok, frames, "What happens?"), max_new_tokens=8, chunk=3):
        ids.extend(chunk_ids)
    assert ids == out["output"]

    spec = UFVideoRuntime(rt.cfg.replace(spec_decode=3), rt.model, rt.ids, "cpu")
    jspec = JRuntime(jrt.cfg.replace(spec_decode=3), jrt.params, jrt.ids)
    sdeltas = list(mm_infer_stream(frames, "What happens?", spec, tok, chunk=3, **kw))
    jsdeltas = list(j_mm_infer_stream(frames, "What happens?", jspec, jtok, chunk=3, **kw))
    assert "".join(sdeltas).strip() == "".join(jsdeltas).strip() == text
    with pytest.raises(ValueError, match="SEG"):
        list(mm_infer_stream(frames, "Segment [SEG].", rt, tok))


@pytest.mark.parametrize("kw", [dict(quant_llm="int8", quant_kv=True), dict(quant_llm="int4")],
                         ids=["int8-kv8", "int4"])
def test_mm_infer_stream_on_quantised_runtimes(runtimes, kw):
    """The JAX tree's LM quantised by the JAX functions: the port's stream
    gives JAX's ``mm_infer`` ids and text, and the port's own."""
    from ufvideo_tpu.api import UFVideoRuntime as JRuntime
    from ufvideo_tpu.api import mm_infer as j_mm_infer
    from ufvideo_tpu_torch.api import UFVideoRuntime, mm_infer, mm_infer_stream
    from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
    from ufvideo_tpu_torch.weights import load_jax_params

    (jrt, jtok), (rt, tok) = runtimes
    bits = 4 if kw["quant_llm"] == "int4" else 8
    params = dict(jrt.params, llm=jq.quantize_qwen2_params(jrt.params["llm"], bits=bits))
    jq_rt = JRuntime(jrt.cfg.replace(**kw), params, jrt.ids)
    model = UFVideoModel.empty(rt.cfg.replace(**kw), "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    q_rt = UFVideoRuntime(rt.cfg.replace(**kw), model, rt.ids, "cpu")
    frames = np.random.default_rng(4).standard_normal((4, 56, 56, 3)).astype(np.float32)
    jtext, jout = j_mm_infer(frames, "Describe it.", jq_rt, jtok, max_new_tokens=8)
    text, out = mm_infer(frames, "Describe it.", q_rt, tok, max_new_tokens=8)
    ids = []
    for chunk_ids, _ in q_rt.generate_stream(*_request(q_rt, tok, frames, "Describe it."),
                                             max_new_tokens=8, chunk=3):
        ids.extend(chunk_ids)
    deltas = list(mm_infer_stream(frames, "Describe it.", q_rt, tok, chunk=3,
                                  max_new_tokens=8))
    assert ids == out["output"] == jout["output"]
    assert "".join(deltas).strip() == text == jtext


def _request(rt, tok, frames, question):
    from ufvideo_tpu_torch.api import _assemble_input_ids, _encode_video_input

    return _assemble_input_ids(question, 1, "<video>", tok), _encode_video_input(
        rt, frames, "video")
