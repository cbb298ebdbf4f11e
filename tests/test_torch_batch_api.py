"""Batched serving in the port against the JAX package (``tiny_config()``,
float32, CPU, weights carried by ``load_jax_params``): ``mm_infer_batch`` on
path A (questions and a ``<region>`` request), path B (a ``[SEG]`` in the
input), a mixed batch, and uint8 frames on the float, int8 + int8-KV and
int4 models; ``generate_batch`` under ``cfg.prefill_chunk``; and the top-p
kept set of ``_sample_token``.

Tolerances: greedy tokens and text exactly. Masks: the share of equal
pixels at least 0.99, JAX's own limit between batched and per-sample masks
(``tests/test_api.py``); the float masks of one request agree bit for bit
but within 1e-3 of the threshold (``tests/test_torch_seg.py``), and random
weights put well under 1% of the pixels there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.api import mm_infer_batch as j_mm_infer_batch
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models import generate as jgen
from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids, mm_infer, mm_infer_batch
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models import generate as tgen
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.weights import load_jax_params

MASK_AGREE = 0.99
LABEL = (32, 40)


def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


@pytest.fixture(scope="module")
def runtimes():
    """JAX runtime with SAM2 weights (path B segments) and the port's
    runtime loaded from the same tree."""
    jtok, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    params = dict(jax.jit(JUFVideoModel(jcfg).init_params)(jax.random.PRNGKey(0)))
    sam = JSAM2(jcfg.sam, dtype=jnp.float32, param_dtype=jnp.float32)
    size = jcfg.sam.hiera.image_size
    params["sam"] = jax.jit(lambda k: sam.init(k, jnp.zeros((1, size, size, 3)))["params"])(
        jax.random.PRNGKey(1))
    jrt = JRuntime(jcfg, params, jids)
    tok, ids = byte_tokenizer_with_ids()
    cfg = _with_ids(tiny_config(), ids)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)


def _video(rng):
    return rng.standard_normal((4, 56, 56, 3)).astype(np.float32)


def _sam(rng):
    return rng.standard_normal((3, 128, 128, 3)).astype(np.float32)


def _assert_same(got, want):
    """Item for item: the text and the tokens exactly, the same number of
    mask stacks of the same shapes, the masks agreeing on MASK_AGREE of the
    pixels."""
    assert len(got) == len(want)
    for (text, out), (jtext, jout) in zip(got, want):
        assert text == jtext
        assert out["output"] == jout["output"]
        assert out.get("gt_masks") is jout.get("gt_masks") or np.array_equal(
            out.get("gt_masks"), jout.get("gt_masks"))
        assert len(out["pred_masks"]) == len(jout["pred_masks"])
        for a, b in zip(out["pred_masks"], jout["pred_masks"]):
            assert a.shape == b.shape and a.dtype == np.bool_
            agree = float((a == b).mean())
            print(f"mask agreement {agree:.5f}, foreground {b.mean():.3f}")
            assert agree >= MASK_AGREE


def test_mm_infer_batch_path_a_matches_jax(runtimes):
    """Two questions and a referring request (``<region>``, an annotated
    frame and its mask) in one batch: JAX's batch, and the port's own
    ``mm_infer`` of each sample."""
    (jrt, jtok), (rt, tok) = runtimes
    rng = np.random.default_rng(0)
    samples = [{"video": _video(rng), "instruct": f"What happens in scene {i}?",
                "images_sam": _sam(rng), "label_size": LABEL} for i in range(2)]
    samples.append({"video": _video(rng), "instruct": "What is <region> doing?",
                    "frame": rng.standard_normal((1, 56, 56, 3)).astype(np.float32),
                    "masks": (rng.random((1, 30, 44)) > 0.5).astype(np.float32),
                    "ann_indices": [[0]]})
    got = mm_infer_batch(samples, rt, tok, max_new_tokens=6)
    _assert_same(got, j_mm_infer_batch(samples, jrt, jtok, max_new_tokens=6))
    for s, (text, out) in zip(samples, got):
        kw = {k: s[k] for k in ("images_sam", "label_size", "frame", "masks", "ann_indices")
              if k in s}
        one_text, one = mm_infer(s["video"], s["instruct"], rt, tok, max_new_tokens=6, **kw)
        assert (text, out["output"]) == (one_text, one["output"])


def _seg_conv(i):
    return [{"from": "human", "value": f"<video>\nSegment object {i}."},
            {"from": "gpt", "value": "Sure, it is [SEG]."}]


def test_mm_infer_batch_path_b_matches_jax(runtimes):
    """Two ``[SEG]``-input requests: one forward over both, one batched
    propagation; JAX's batch, and the port's own ``mm_infer`` of each."""
    (jrt, jtok), (rt, tok) = runtimes
    rng = np.random.default_rng(7)
    samples = [{"video": _video(rng), "instruct": _seg_conv(i), "images_sam": _sam(rng),
                "label_size": LABEL, "masks": [f"gt-{i}"]} for i in range(2)]
    got = mm_infer_batch(samples, rt, tok, choice=3)
    _assert_same(got, j_mm_infer_batch(samples, jrt, jtok, choice=3))
    for s, (text, out) in zip(samples, got):
        assert text is None and out["output"] is None and out["gt_masks"] == s["masks"]
        one = mm_infer(s["video"], s["instruct"], rt, tok, choice=3, seg=True,
                       images_sam=s["images_sam"], label_size=LABEL)
        _assert_same([(None, out)], [(None, dict(one, gt_masks=out["gt_masks"]))])
        assert len(out["pred_masks"]) == 1 and out["pred_masks"][0].shape == (3, *LABEL)


def test_mm_infer_batch_mixed_paths_match_jax(runtimes):
    """A ``[SEG]``-input request (path B, two objects: it propagates on its
    own) beside a question (path A): each takes its path, the output order
    follows the input."""
    (jrt, jtok), (rt, tok) = runtimes
    rng = np.random.default_rng(9)
    samples = [
        {"video": _video(rng), "images_sam": _sam(rng), "label_size": LABEL,
         "instruct": [{"from": "human", "value": "<video>\nCat, dog?"},
                      {"from": "gpt", "value": "[SEG] and [SEG]."}]},
        {"video": _video(rng), "instruct": [{"from": "human", "value": "<video>\nWhat happens?"}]},
    ]
    got = mm_infer_batch(samples, rt, tok, choice=3, max_new_tokens=4)
    _assert_same(got, j_mm_infer_batch(samples, jrt, jtok, choice=3, max_new_tokens=4))
    assert got[0][0] is None and len(got[0][1]["pred_masks"]) == 2
    assert isinstance(got[1][0], str) and got[1][1]["output"]


QUESTIONS = ("What happens?", "What happens in this video?", "Describe it.", "Why?",
             "Who is there?")


@pytest.mark.parametrize("chunk,b,kw", [
    (2, 3, {}), (2, 5, {}), (3, 5, {}),
    (3, 5, dict(quant_llm="int8", quant_kv=True)),
], ids=["c2-b3", "c2-b5", "c3-b5", "c3-b5-int8-kv8"])
def test_prefill_chunk_tokens_match_unchunked_and_jax(runtimes, chunk, b, kw):
    """``cfg.prefill_chunk`` = c on B samples, c not dividing B: the last
    chunk's start clamps to B - c. The tokens are the unchunked run's and
    JAX's under the same chunk; the hidden states within 1e-3 of JAX's
    (``tests/test_torch_batch.py``'s limit). The int8 case quantises the
    JAX tree with the JAX functions."""
    from ufvideo_tpu import quant as jq

    (jrt, jtok), (rt, tok) = runtimes
    if kw:
        params = dict(jrt.params, llm=jq.quantize_qwen2_params(jrt.params["llm"], bits=8))
        jrt = JRuntime(jrt.cfg.replace(**kw), params, jrt.ids)
        model = UFVideoModel.empty(rt.cfg.replace(**kw), "cpu")
        load_jax_params(model, jax.tree.map(np.asarray, params))
        rt = UFVideoRuntime(rt.cfg.replace(**kw), model, rt.ids, "cpu")
    ids = [_assemble_input_ids(q, 1, "<video>", tok) for q in QUESTIONS[:b]]
    feats = (np.random.default_rng(31).standard_normal((b, rt.cfg.num_video_tokens, 64))
             * 0.5).astype(np.float32)
    chunked = UFVideoRuntime(rt.cfg.replace(prefill_chunk=chunk), rt.model, rt.ids, "cpu")
    jchunked = JRuntime(jrt.cfg.replace(prefill_chunk=chunk), jrt.params, jrt.ids)
    out, _ = chunked.generate_batch(ids, torch.from_numpy(feats), max_new_tokens=6)
    whole, _ = rt.generate_batch(ids, torch.from_numpy(feats), max_new_tokens=6)
    jout, _ = jchunked.generate_batch(ids, jnp.asarray(feats), max_new_tokens=6)
    for (toks, hid), (wtoks, _), (jtoks, jhid) in zip(out, whole, jout):
        assert toks == wtoks == jtoks
        np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("temperature,top_p", [(1.0, 0.5), (0.7, 0.9), (1.3, 0.99),
                                               (0.2, 0.9)])
def test_sample_token_top_p_kept_set_matches_jax(monkeypatch, temperature, top_p):
    """The tokens top-p keeps, read from what each package hands its
    sampler (JAX ``jax.random.categorical``'s logits, the port's
    ``torch.multinomial``'s probabilities) on the same seeded logits, with
    ties among them: the same set. The draws themselves differ by design."""
    rng = np.random.default_rng(int(top_p * 100))
    logits = (rng.standard_normal((4, 512)) * 3).astype(np.float32)
    logits[0, 10:14] = logits[0].max()  # a four-way tie at the top
    logits[1, :256] = np.round(logits[1, :256])  # many ties
    seen = {}
    real_cat, real_multi = jax.random.categorical, torch.multinomial

    def cat(key, lg, axis=-1):
        seen["jax"] = np.asarray(lg) > np.finfo(np.float32).min
        return real_cat(key, lg, axis=axis)

    def multi(probs, n, generator=None):
        seen["port"] = probs.numpy() > 0
        return real_multi(probs, n, generator=generator)

    monkeypatch.setattr(jax.random, "categorical", cat)
    monkeypatch.setattr(torch, "multinomial", multi)
    jtok = jgen._sample_token(jnp.asarray(logits), jax.random.PRNGKey(0), True, temperature,
                              top_p)
    tok = tgen._sample_token(torch.from_numpy(logits), torch.Generator().manual_seed(0), True,
                             temperature, top_p)
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    kept = seen["port"]
    assert 1 <= kept.sum(axis=1).min() and kept.sum(axis=1).max() < 512
    assert kept[np.arange(4), tok.numpy()].all() and kept[np.arange(4), np.asarray(jtok)].all()


@pytest.mark.parametrize("kw", [{}, dict(quant_llm="int8", quant_kv=True), dict(quant_llm="int4")],
                         ids=["float", "int8-kv8", "int4"])
def test_mm_infer_batch_on_uint8_frames_and_quantised_models(runtimes, kw):
    """uint8 frames (resized and normalised on the device, as in
    ``mm_infer``) on the float model and on the LM quantised by the JAX
    functions: JAX's batch, and each sample's own ``mm_infer``."""
    from ufvideo_tpu import quant as jq

    (jrt, jtok), (rt, tok) = runtimes
    if kw:
        bits = 4 if kw["quant_llm"] == "int4" else 8
        params = dict(jrt.params, llm=jq.quantize_qwen2_params(jrt.params["llm"], bits=bits))
        jrt = JRuntime(jrt.cfg.replace(**kw), params, jrt.ids)
        model = UFVideoModel.empty(rt.cfg.replace(**kw), "cpu")
        load_jax_params(model, jax.tree.map(np.asarray, params))
        rt = UFVideoRuntime(rt.cfg.replace(**kw), model, rt.ids, "cpu")
    rng = np.random.default_rng(13)
    samples = [{"video": rng.integers(0, 256, (4, 40, 52, 3), dtype=np.uint8),
                "instruct": q} for q in ("What happens?", "Describe the scene.")]
    got = mm_infer_batch(samples, rt, tok, max_new_tokens=6)
    _assert_same(got, j_mm_infer_batch(samples, jrt, jtok, max_new_tokens=6))
    for s, (text, out) in zip(samples, got):
        one_text, one = mm_infer(s["video"], s["instruct"], rt, tok, max_new_tokens=6)
        assert (text, out["output"]) == (one_text, one["output"])
