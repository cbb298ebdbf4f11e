"""Prompt-lookup speculation in the port against the JAX package
(``tiny_config()`` LM, float32, CPU): ``spec_generate`` on ``load_qwen2``
weights against JAX ``spec_generate`` on the same tree, on ragged prompts,
an int8 KV cache, stop ids, int8 and int4 weights quantised by
``ufvideo_tpu.quant``, and the degenerate model whose drafts are all
accepted; ``spec_stream_generate`` against ``spec_generate``; one ``verify``
forward (output and cache) against JAX's, on a float and an int8 cache.

Tolerances: tokens, ``gen_lens``, ``n_drafted``, ``n_accepted`` and the
iteration count exactly; hidden states within 2e-4, the JAX package's own
limit in ``tests/test_speculative.py``. The port's speculative tokens must
also be its own plain greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu import quant as jq
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models import speculative as jspec
from ufvideo_tpu.models.qwen2 import Qwen2LM as JQwen2LM
from ufvideo_tpu.models.qwen2 import make_kv_cache as j_make_kv_cache
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models import speculative as tspec
from ufvideo_tpu_torch.models.generate import greedy_generate
from ufvideo_tpu_torch.models.qwen2 import Qwen2LM, make_kv_cache
from ufvideo_tpu_torch.weights import load_qwen2

TOL = 2e-4


def _pair(seed=0, quant=False, zero=False):
    """A JAX LM and the port's LM on one tree (quantised by the JAX
    functions for ``quant``, all zeros for ``zero``)."""
    jcfg = j_tiny_config().llm
    params = JQwen2LM(jcfg, dtype=jnp.float32, param_dtype=jnp.float32).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    if zero:
        params = jax.tree.map(jnp.zeros_like, params)
    if quant:
        params = jq.quantize_qwen2_params(params, bits=4 if quant == "int4" else 8)
    jlm = JQwen2LM(jcfg, dtype=jnp.float32, param_dtype=jnp.float32, quant=quant)
    with torch.device("meta"):
        lm = Qwen2LM(tiny_config().llm, dtype=torch.float32, quant=quant)
    lm = lm.to_empty(device="cpu")
    load_qwen2(lm, jax.tree.map(np.asarray, params))
    return (jlm, params), lm.eval()


def _prompt(b, s, seed=1):
    """Prompt ids with a repeated phrase, so that lookup finds matches."""
    rng = np.random.RandomState(seed)
    phrase = rng.randint(3, 512, size=s // 3)
    ids = np.concatenate([phrase, rng.randint(3, 512, size=s // 3), phrase])[:s]
    ids = np.concatenate([ids, rng.randint(3, 512, size=s - len(ids))])
    return np.stack([np.roll(ids, i) for i in range(b)]).astype(np.int32)


def _run(pair, ids, lens, max_new=24, k=3, stop_ids=(-1,), kv_quant=False):
    """(port SpecResult, JAX SpecResult, port greedy result)."""
    (jlm, params), lm = pair
    s = ids.shape[1]
    kw = dict(max_new_tokens=max_new, stop_ids=stop_ids, cache_max_len=s + max_new + k + 1,
              draft_k=k, kv_quant=kv_quant)
    jemb = jlm.apply({"params": params}, jnp.asarray(np.maximum(ids, 0)),
                     method=JQwen2LM.embed)
    want = jspec.spec_generate(jlm, params, jemb, jnp.asarray(lens), jnp.asarray(ids), **kw)
    emb = torch.from_numpy(np.array(jemb))
    got = tspec.spec_generate(lm, emb, torch.from_numpy(lens), torch.from_numpy(ids), **kw)
    kw.pop("draft_k")
    plain = greedy_generate(lm, emb, torch.from_numpy(lens), **kw)
    return got, want, plain


def _assert_equal(got, want, plain):
    np.testing.assert_array_equal(got.gen_lens.numpy(), np.asarray(want.gen_lens))
    np.testing.assert_array_equal(got.gen_lens.numpy(), plain.gen_lens.numpy())
    np.testing.assert_array_equal(got.n_drafted.numpy(), np.asarray(want.n_drafted))
    np.testing.assert_array_equal(got.n_accepted.numpy(), np.asarray(want.n_accepted))
    assert got.n_iters == int(want.n_iters)
    for i, n in enumerate(got.gen_lens.tolist()):
        np.testing.assert_array_equal(got.tokens[i, :n].numpy(), np.asarray(want.tokens)[i, :n])
        np.testing.assert_array_equal(got.tokens[i, :n].numpy(), plain.tokens[i, :n].numpy())
        np.testing.assert_allclose(got.hidden[i, :n].numpy(), np.asarray(want.hidden)[i, :n],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got.hidden[i, :n].numpy(), plain.hidden[i, :n].numpy(),
                                   atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def float_pair():
    return _pair(seed=3)


def test_spec_matches_jax(float_pair):
    ids = _prompt(2, 30)
    _assert_equal(*_run(float_pair, ids, np.asarray([30, 30], np.int32)))


def test_spec_matches_jax_on_ragged_prompts(float_pair):
    ids = _prompt(3, 24, seed=5)
    lens = np.asarray([24, 17, 9], np.int32)
    # -1 at pad positions, as plan_lookup_ids marks non-text slots
    ids = np.where(np.arange(24)[None, :] < lens[:, None], ids, -1).astype(np.int32)
    _assert_equal(*_run(float_pair, ids, lens))


def test_spec_matches_jax_with_the_int8_kv_cache(float_pair):
    ids = _prompt(2, 20, seed=9)
    _assert_equal(*_run(float_pair, ids, np.asarray([20, 20], np.int32), kv_quant=True))


def test_spec_matches_jax_with_stop_ids(float_pair):
    """Stop at what greedy emits 4th: both loops cut at its first
    occurrence."""
    ids = _prompt(1, 18, seed=13)
    lens = np.asarray([18], np.int32)
    _, _, plain = _run(float_pair, ids, lens, max_new=16)
    stop = int(plain.tokens[0, 3])
    expect = int(np.argmax(plain.tokens[0].numpy() == stop)) + 1
    got, want, plain = _run(float_pair, ids, lens, max_new=16, stop_ids=(stop,))
    _assert_equal(got, want, plain)
    assert int(got.gen_lens[0]) == expect <= 4


def test_spec_accepts_drafts_on_the_degenerate_model():
    """Zero weights: every logit equal, greedy emits token 0 forever, the
    (0, 0) bigram matches everywhere and every draft is accepted: about
    max_new / (K + 1) forwards instead of max_new."""
    pair = _pair(zero=True)
    ids = _prompt(1, 12)
    max_new, k = 25, 4
    got, want, plain = _run(pair, ids, np.asarray([12], np.int32), max_new=max_new, k=k)
    _assert_equal(got, want, plain)
    assert int(got.gen_lens[0]) == max_new and not got.tokens.any()
    assert got.n_iters <= 2 + (max_new - 1 + k) // (k + 1)
    assert int(got.n_accepted[0]) >= max_new - got.n_iters


@pytest.mark.parametrize("quant,kv_quant", [("int8", False), ("int8", True), ("int4", False)],
                         ids=["int8", "int8-kv8", "int4"])
def test_spec_matches_jax_on_quantised_weights(quant, kv_quant):
    pair = _pair(seed=15, quant=quant)
    ids = _prompt(2, 16, seed=17)
    _assert_equal(*_run(pair, ids, np.asarray([16, 16], np.int32), kv_quant=kv_quant))


def test_spec_stream_matches_spec_generate(float_pair):
    """The per-iteration stream gives spec_generate's tokens, and one yield
    after the prefill plus one a verify step (n_iters)."""
    _, lm = float_pair
    ids = _prompt(2, 24, seed=23)
    lens = torch.tensor([24, 24])
    emb = lm.embed(torch.from_numpy(ids).long())
    kw = dict(max_new_tokens=18, stop_ids=(-1,), cache_max_len=24 + 18 + 4, draft_k=4)
    sp = tspec.spec_generate(lm, emb, lens, torch.from_numpy(ids), **kw)
    rows, yields = [[], []], 0
    for tokens, gen_lens, hiddens, done in tspec.spec_stream_generate(
            lm, emb, lens, torch.from_numpy(ids), **kw):
        yields += 1
        for i in range(2):
            n = int(gen_lens[i])
            assert tokens[i, :len(rows[i])].tolist() == rows[i]  # earlier tokens stay
            rows[i] = tokens[i, :n].tolist()
    for i in range(2):
        assert rows[i] == sp.tokens[i, :int(sp.gen_lens[i])].tolist()
    assert yields == sp.n_iters


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float-cache", "int8-cache"])
def test_verify_mode_matches_jax(float_pair, kv_quant):
    """One verify forward of 3 tokens at ragged write positions over a
    prefilled cache: the hidden states and every cache entry (int8 values
    and scales on the int8 cache) equal JAX's."""
    (jlm, params), lm = float_pair
    cfg = lm.cfg
    rng = np.random.default_rng(40)
    b, s, smax = 2, 20, 128
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    lens = np.asarray([20, 11], np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    step = rng.standard_normal((b, 3, 64)).astype(np.float32)
    vpos = lens[:, None] + np.arange(3, dtype=np.int32)[None]

    def jax_side():
        back = lambda *a: jlm.apply({"params": params}, *a, method=JQwen2LM.backbone)
        _, cache = back(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(lens),
                        j_make_kv_cache(j_tiny_config().llm, b, smax, dtype=jnp.float32,
                                        quant=kv_quant), None, "prefill")
        return back(jnp.asarray(step), jnp.asarray(vpos), None, cache, jnp.asarray(lens),
                    "verify")

    jh, jcache = jax_side()
    with torch.no_grad():
        cache = make_kv_cache(cfg, b, smax, dtype=torch.float32, quant=kv_quant)
        _, cache = lm.backbone(torch.from_numpy(x), torch.from_numpy(pos),
                               torch.from_numpy(lens), cache, None, "prefill")
        h, cache = lm.backbone(torch.from_numpy(step), torch.from_numpy(vpos), None, cache,
                               torch.from_numpy(lens), "verify")
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
    assert set(cache) == set(jcache)
    for name, t in cache.items():
        want = np.asarray(jcache[name])
        if t.dtype == torch.int8:
            # a value on a rounding boundary may land one int8 step apart
            assert np.abs(t.numpy().astype(np.int32) - want).max() <= 1
            assert (t.numpy() == want).mean() > 0.999
        else:
            np.testing.assert_allclose(t.numpy(), want, atol=TOL, rtol=TOL)
