"""Batched decode, the serving path that hands the quantised products 2 to
32 rows: the port's ``UFVideoRuntime.generate_batch`` on ``tiny_config()``
(f32) must give exactly the greedy tokens of JAX ``ufvideo_tpu.api.
UFVideoRuntime.generate_batch`` on the same weights, for three prompts of
different lengths (ragged prefill and decode positions) on one set of video
tokens, on the float model, the int8 model with an int8 KV cache and the
int4 model, whose weights are quantised by the JAX package's functions and
carried across.

The JAX runtime is built from ``UFVideoModel.init_params`` directly (no
SAM2 weights), as in tests/test_torch_slice.py; the video tokens are drawn
with numpy and handed to both runtimes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_init as jax_init

from ufvideo_tpu import quant as jq
from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.weights import load_jax_params

QUANT_CASES = {
    "float": {},
    "int8-kv8": dict(quant_llm="int8", quant_kv=True),
    "int4": dict(quant_llm="int4"),
}
QUESTIONS = ("What happens?", "What happens in this video?", "Describe it.")


def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


@pytest.fixture(scope="module", params=list(QUANT_CASES))
def runtimes(request):
    """JAX float parameters, quantised by the JAX functions where the case
    asks; one JAX runtime on them and the port's runtime loaded from the
    same tree."""
    kw = QUANT_CASES[request.param]
    jtok, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    params = dict(jax_init.model_params(jcfg, 0))
    if kw.get("quant_llm"):
        params["llm"] = jq.quantize_qwen2_params(
            params["llm"], bits=4 if kw["quant_llm"] == "int4" else 8)
    jrt = JRuntime(jcfg.replace(**kw), params, jids)
    tok, ids = byte_tokenizer_with_ids()
    cfg = _with_ids(tiny_config(), ids).replace(**kw)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return request.param, (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)


def test_generate_batch_tokens_match_jax(runtimes):
    name, (jrt, jtok), (rt, tok) = runtimes
    cfg = rt.cfg
    ids = [_assemble_input_ids(q, 1, "<video>", tok) for q in QUESTIONS]
    assert ids == [_assemble_input_ids(q, 1, "<video>", jtok) for q in QUESTIONS]
    assert len({len(i) for i in ids}) == len(QUESTIONS)  # ragged prompts
    rng = np.random.default_rng(31)
    feats = (rng.standard_normal((1, cfg.num_video_tokens, cfg.llm.hidden_size)) * 0.5
             ).astype(np.float32)
    feats = np.repeat(feats, len(QUESTIONS), axis=0)
    jout, jplan = jrt.generate_batch(ids, jnp.asarray(feats), max_new_tokens=8)
    out, plan = rt.generate_batch(ids, torch.from_numpy(feats), max_new_tokens=8)
    assert list(plan.seq_lens) == list(jplan.seq_lens)
    for (toks, hidden), (jtoks, jhidden) in zip(out, jout):
        assert toks == jtoks, name
        assert hidden.shape == (len(toks), cfg.llm.hidden_size)
        np.testing.assert_allclose(hidden.float().numpy(), np.asarray(jhidden, np.float32),
                                   rtol=1e-3, atol=1e-3)
