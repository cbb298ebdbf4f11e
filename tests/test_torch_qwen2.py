"""The port's Qwen2 LM and greedy decode loop against the JAX package on
``tiny_config()`` weights (float32, CPU).

Tolerances: 1e-4 on logits and hidden states (the same float32 math over
two layers, summed in another order); greedy tokens must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models.generate import greedy_generate as j_greedy_generate
from ufvideo_tpu.models.qwen2 import Qwen2LM as JQwen2LM
from ufvideo_tpu.models.qwen2 import make_kv_cache as j_make_kv_cache
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models.generate import greedy_generate
from ufvideo_tpu_torch.models.qwen2 import Qwen2LM, make_kv_cache
from ufvideo_tpu_torch.weights import load_qwen2

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = j_tiny_config()
    jlm = JQwen2LM(jcfg.llm, dtype=jnp.float32, param_dtype=jnp.float32)
    params = jlm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = tiny_config()
    with torch.device("meta"):
        lm = Qwen2LM(cfg.llm, dtype=torch.float32)
    lm = lm.to_empty(device="cpu")
    load_qwen2(lm, params)
    return jlm, params, lm


def _embeds(seed, b, s, hidden):
    return np.random.default_rng(seed).standard_normal((b, s, hidden)).astype(np.float32)


def test_prefill_logits_and_cache_match(pair):
    jlm, params, lm = pair
    cfg = lm.cfg
    b, s = 2, 24
    x = _embeds(0, b, s, cfg.hidden_size)
    lens = np.array([24, 17], np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jh, jcache = jlm.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(lens),
        j_make_kv_cache(cfg, b, 32, dtype=jnp.float32), None, "prefill",
        method=JQwen2LM.backbone,
    )
    jlogits = np.asarray(jlm.apply({"params": params}, jh, method=JQwen2LM.logits))
    with torch.no_grad():
        cache = make_kv_cache(cfg, b, 32, dtype=torch.float32)
        th, cache = lm.backbone(
            torch.from_numpy(x), torch.from_numpy(pos.copy()), torch.from_numpy(lens),
            cache, None, "prefill",
        )
        tlogits = lm.logits(th).numpy()
    np.testing.assert_allclose(tlogits, jlogits, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]), atol=TOL, rtol=TOL)


def test_decode_steps_match(pair):
    """One decode step at ragged cache lengths, through the same cache."""
    jlm, params, lm = pair
    cfg = lm.cfg
    b, s, smax = 2, 20, 128
    x = _embeds(1, b, s, cfg.hidden_size)
    lens = np.array([20, 9], np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    step = _embeds(2, b, 1, cfg.hidden_size)
    _, jcache = jlm.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(lens),
        j_make_kv_cache(cfg, b, smax, dtype=jnp.float32), None, "prefill",
        method=JQwen2LM.backbone,
    )
    jh, _ = jlm.apply(
        {"params": params}, jnp.asarray(step), jnp.asarray(lens)[:, None], None,
        jcache, jnp.asarray(lens), "decode", method=JQwen2LM.backbone,
    )
    with torch.no_grad():
        cache = make_kv_cache(cfg, b, smax, dtype=torch.float32)
        lm.backbone(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                    torch.from_numpy(lens), cache, None, "prefill")
        tl = torch.from_numpy(lens)
        th, _ = lm.backbone(torch.from_numpy(step), tl[:, None], None, cache, tl, "decode")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)


def test_greedy_generate_matches(pair):
    """Eos stop, then a two-token stop sequence taken from the first run's
    own output so that it fires mid-generation."""
    jlm, params, lm = pair
    cfg = lm.cfg
    b, s = 2, 16
    x = _embeds(3, b, s, cfg.hidden_size)
    lens = np.array([16, 11], np.int32)
    stops = ()
    for _ in range(2):
        kw = dict(max_new_tokens=6, stop_ids=(2,), cache_max_len=s + 6,
                  vocab_size=cfg.vocab_size, stop_sequences=stops)
        jres = j_greedy_generate(jlm, params, jnp.asarray(x), jnp.asarray(lens), **kw)
        tres = greedy_generate(lm, torch.from_numpy(x), torch.from_numpy(lens), **kw)
        np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
        np.testing.assert_array_equal(tres.gen_lens.numpy(), np.asarray(jres.gen_lens))
        np.testing.assert_allclose(
            tres.hidden.numpy(), np.asarray(jres.hidden), atol=TOL, rtol=TOL
        )
        first = tres.tokens[0].tolist()
        stops = ((first[1], first[2]),)
    assert int(tres.gen_lens[0]) <= 3


def test_vocab_padding_is_masked():
    from ufvideo_tpu_torch.models.generate import _mask_vocab_logits

    logits = torch.zeros(1, 512)
    logits[0, 400] = 5.0
    assert int(_mask_vocab_logits(logits, 300).argmax()) != 400
