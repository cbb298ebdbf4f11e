"""The slice as a whole: the port's ``mm_infer`` on ``load_jax_params``
weights must give exactly the greedy tokens of JAX ``ufvideo_tpu.api.
mm_infer`` on ``tiny_config()``, for float frames, uint8 frames (which go
through the 384-pixel bicubic resize) and the image and text modals.

The JAX runtime is built from ``UFVideoModel.init_params`` directly: the
video-QA path needs no SAM2 weights, whose random init is most of
``model_init``'s time on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch.api import UFVideoRuntime, mm_infer
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
    params = jax.jit(JUFVideoModel(jcfg).init_params)(jax.random.PRNGKey(0))
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


def test_unported_inputs_raise(runtimes):
    """Region inputs still wait for their slice; ``images_sam`` and a
    ``[SEG]`` in the input are served (tests/test_torch_seg.py holds their
    masks against JAX) and, with nothing to segment, give no masks."""
    _, (rt, tok) = runtimes
    frames = np.zeros((4, 56, 56, 3), np.float32)
    with pytest.raises(NotImplementedError, match="region"):
        mm_infer(frames, "x", rt, tok, masks=np.zeros((1, 8, 8)), frame=frames[:1])
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
