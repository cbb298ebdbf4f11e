"""The slice as a whole: the port's ``mm_infer`` on ``load_jax_params``
weights must give exactly the greedy tokens of JAX ``ufvideo_tpu.api.
mm_infer`` on ``tiny_config()``, for float frames, uint8 frames (which go
through the 384-pixel bicubic resize) and the image and text modals; and
for a region-referring request (``masks`` / ``frame`` / ``ann_indices`` and
``<region>`` placeholders) on the float model, on the int8 model (int8 KV
cache, W8A8 SigLIP) and on the int4 model, whose weights are quantised by
the JAX package's functions and carried across.

The JAX runtime is built from ``UFVideoModel.init_params`` directly: the
video-QA path needs no SAM2 weights, whose random init is most of
``model_init``'s time on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

import torch_jax_init as jax_init

from ufvideo_tpu import quant as jq
from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids, mm_infer
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.weights import load_jax_params


def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


@pytest.fixture(scope="module")
def runtimes():
    jtok, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    params = jax_init.model_params(jcfg, 0)
    jrt = JRuntime(jcfg, dict(params), jids)
    tok, ids = byte_tokenizer_with_ids()
    cfg = _with_ids(tiny_config(), ids)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)


CASES = [
    pytest.param("video", np.float32, (4, 56, 56, 3), id="float-video"),
    pytest.param("video", np.uint8, (4, 40, 52, 3), id="uint8-video-resized"),
    pytest.param("image", np.float32, (1, 56, 56, 3), id="image"),
    pytest.param("text", None, None, id="text"),
]


@pytest.mark.parametrize("modal,dtype,shape", CASES)
def test_mm_infer_tokens_match_jax(runtimes, modal, dtype, shape):
    (jrt, jtok), (rt, tok) = runtimes
    rng = np.random.default_rng(11)
    if dtype is None:
        frames = None
    elif dtype == np.uint8:
        frames = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        frames = rng.standard_normal(shape).astype(np.float32)
    question = "What happens in this video?"
    jtext, jout = j_mm_infer(frames, question, jrt, jtok, modal=modal, max_new_tokens=8)
    text, out = mm_infer(frames, question, rt, tok, modal=modal, max_new_tokens=8)
    assert out["output"] == jout["output"]
    assert text == jtext
    assert out["pred_masks"] == jout["pred_masks"] == []


def test_mm_infer_stop_strings_match_jax(runtimes):
    """Keyword stop taken from the unstopped output, so it fires."""
    (jrt, jtok), (rt, tok) = runtimes
    frames = np.random.default_rng(12).standard_normal((4, 56, 56, 3)).astype(np.float32)
    _, out = mm_infer(frames, "Describe.", rt, tok, max_new_tokens=8)
    stop = tok.decode(out["output"][2:4])
    kw = dict(max_new_tokens=8, stop_strings=[stop])
    jtext, jout = j_mm_infer(frames, "Describe.", jrt, jtok, **kw)
    text, out = mm_infer(frames, "Describe.", rt, tok, **kw)
    assert out["output"] == jout["output"]
    assert text == jtext


QUANT_CASES = {
    "float": {},
    "int8": dict(quant_llm="int8", quant_kv=True, quant_vision=True),
    "int4": dict(quant_llm="int4"),
}


def _on_fused_route(fn):
    """Run a stage of the JAX runtime with the W8A8 tower on its fused route
    (``fused_block_w8a8`` in interpret mode, as tests/test_hiera_block.py
    runs it): off-TPU the tower would take its unfused ``W8A8Dense`` branch,
    which quantises at other points (5e-2 apart)."""
    import ufvideo_tpu.models.siglip as sig
    import ufvideo_tpu.ops.hiera_block as hb

    real = hb.fused_block_w8a8

    def wrapped(*args):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(hb, "fused_block_w8a8",
                      lambda x, p, h, d, interpret=False, **kw: real(
                          x, p, h, d, interpret=True, **kw))
            m.setattr(sig.jax, "default_backend", lambda: "tpu")
            return jax.block_until_ready(fn(*args))

    return wrapped


@pytest.fixture(scope="module", params=list(QUANT_CASES))
def quant_runtimes(request):
    """JAX float parameters quantised by the JAX functions, one JAX runtime
    on them and the port's runtime loaded from the same tree."""
    kw = QUANT_CASES[request.param]
    jtok, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    params = dict(jax_init.model_params(jcfg, 0))
    if kw.get("quant_llm"):
        params["llm"] = jq.quantize_qwen2_params(
            params["llm"], bits=4 if kw["quant_llm"] == "int4" else 8)
    if kw.get("quant_vision"):
        params["vision"] = jq.quantize_vision_params(params["vision"])
    jrt = JRuntime(jcfg.replace(**kw), params, jids)
    if kw.get("quant_vision"):
        jrt._encode_video = _on_fused_route(jrt._encode_video)
        jrt._encode_regions = _on_fused_route(jrt._encode_regions)
    tok, ids = byte_tokenizer_with_ids()
    cfg = _with_ids(tiny_config(), ids).replace(**kw)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return request.param, (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)


def test_mm_infer_region_referring_tokens_match_jax(quant_runtimes):
    """Two ``<region>`` placeholders over three annotated frames (padded to
    four), float video and annotated frames: the greedy tokens are JAX's,
    exactly. A uint8 annotated frame: tests/test_torch_parity_repairs.py."""
    name, (jrt, jtok), (rt, tok) = quant_runtimes
    rng = np.random.default_rng(21)
    frames = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    ann = rng.standard_normal((3, 56, 56, 3)).astype(np.float32)
    masks = (rng.random((3, 30, 44)) > 0.5).astype(np.float32)
    question = "Is <region> next to <region>?"
    kw = dict(masks=masks, frame=ann, ann_indices=[[0, 2], [1]], max_new_tokens=8)
    jtext, jout = j_mm_infer(frames, question, jrt, jtok, **kw)
    text, out = mm_infer(frames, question, rt, tok, **kw)
    assert out["output"] == jout["output"], name
    assert text == jtext
    # the prompt holds the regions' merged tokens: two for the first region's
    # two frames, one for the second
    ids = _assemble_input_ids(question, 1, "<video>", tok)
    feats, counts = rt.pack_and_encode_regions(ann, masks, [[0, 2], [1]])
    _, _, plan = rt.generate(ids, None, feats, counts, max_new_tokens=1)
    assert counts == [2, 1] and int((plan.src_kind[0] == 2).sum()) == 3


def test_quantised_runtime_uses_the_quantised_modules(quant_runtimes):
    from ufvideo_tpu_torch.models.qwen2 import QuantLinear

    name, _, (rt, _) = quant_runtimes
    llm = rt.model.llm
    assert isinstance(llm.lm_head, QuantLinear) == (name != "float")
    if name != "float":
        assert llm.lm_head.bits == (4 if name == "int4" else 8)
        assert all(isinstance(l.down_proj, QuantLinear) for l in llm.layers)
    assert rt.model.vision.quant == (name == "int8")
    assert rt.model.vision.layers[0].qkv_kernel.dtype == (
        torch.int8 if name == "int8" else torch.float32)


def test_unported_inputs_raise(runtimes):
    """The serving options that once raised are served: speculative
    decoding and chunked prefill give JAX's tokens under the same
    configuration (tests/test_torch_speculative.py and
    tests/test_torch_batch_api.py hold them in depth). Segmentation on a
    ``quant_vision`` runtime is served (tests/test_torch_seg_quant.py holds
    its masks against JAX). ``images_sam`` and a ``[SEG]`` in the input are
    served (tests/test_torch_seg.py) and, with nothing to segment, give no
    masks."""
    (jrt, jtok), (rt, tok) = runtimes
    frames = np.zeros((4, 56, 56, 3), np.float32)
    for kw in (dict(spec_decode=4), dict(prefill_chunk=2)):
        held = UFVideoRuntime(rt.cfg.replace(**kw), rt.model, rt.ids, "cpu")
        jheld = JRuntime(jrt.cfg.replace(**kw), jrt.params, jrt.ids)
        text, out = mm_infer(frames, "x", held, tok, max_new_tokens=6)
        jtext, jout = j_mm_infer(frames, "x", jheld, jtok, max_new_tokens=6)
        assert out["output"] == jout["output"] and text == jtext, kw
    held = UFVideoRuntime(rt.cfg.replace(quant_vision=True), rt.model, rt.ids, "cpu")
    masks = held.segment_video(np.zeros((2, 128, 128, 3), np.float32), torch.zeros(1, 32), 8, 8)
    assert masks.shape == (1, 2, 8, 8) and masks.dtype == np.bool_
    # no [SEG] among the generated tokens: SAM2 is never reached
    _, out = mm_infer(frames, "x", rt, tok, images_sam=np.zeros((2, 128, 128, 3), np.float32),
                      max_new_tokens=2)
    assert rt.ids.seg not in out["output"] and out["pred_masks"] == []
    # [SEG] in the input but no frames to segment
    out = mm_infer(frames, "Segment [SEG].", rt, tok)
    assert out == {"output": None, "pred_masks": [], "gt_masks": None}


def test_model_init_is_seeded():
    from ufvideo_tpu_torch import model_init

    a, _, _ = model_init(cfg=tiny_config(), device="cpu", seed=5)
    b, _, _ = model_init(cfg=tiny_config(), device="cpu", seed=5)
    c, _, _ = model_init(cfg=tiny_config(), device="cpu", seed=6)
    wa, wb, wc = (r.model.llm.lm_head.weight for r in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    # lecun_normal: truncated at 2 sigma of the untruncated normal
    fan_in = wa.shape[1]
    assert float(wa.abs().max()) <= 2.0 * (1.0 / fan_in) ** 0.5 / 0.8796256610342398 + 1e-6


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quantised_model_init_is_the_quantisation_of_the_float_model(name):
    """Each quantised layer draws the float layer's weights and quantises
    them: same seed, same float model underneath."""
    from ufvideo_tpu_torch import model_init
    from ufvideo_tpu_torch import quant as tq

    f, _, _ = model_init(cfg=tiny_config(), device="cpu", seed=5)
    q, _, _ = model_init(cfg=tiny_config().replace(**QUANT_CASES[name]), device="cpu", seed=5)
    qfn = tq.quantize_kernel if name == "int8" else tq.quantize_kernel4
    for fl, ql in ((f.model.llm.lm_head, q.model.llm.lm_head),
                   (f.model.llm.layers[1].down_proj, q.model.llm.layers[1].down_proj)):
        want = qfn(fl.weight.t())
        assert torch.equal(ql.kernel_q, want["q"]) and torch.equal(ql.kernel_scale, want["scale"])
    if name == "int8":
        want = tq.quantize_kernel(f.model.vision.layers[1].fc1_kernel)
        assert torch.equal(q.model.vision.layers[1].fc1_kernel, want["q"])
    # the modules that stay float drew the same numbers
    assert torch.equal(f.model.text_fcs.fc0.weight, q.model.text_fcs.fc0.weight)
    assert torch.equal(f.model.region.fc0.weight, q.model.region.fc0.weight)
