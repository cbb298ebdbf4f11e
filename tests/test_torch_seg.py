"""The ``[SEG]`` slice as a whole: the port's ``mm_infer`` with
``images_sam`` on ``load_jax_params`` weights against JAX
``ufvideo_tpu.api.mm_infer`` on ``tiny_config()`` (float32, CPU).

Path B (a ``[SEG]`` in the input, the choice-3 conversation) is one forward
of the LLM, the hidden state before each ``[SEG]``, the text head, and SAM2
over the frames: the boolean masks must equal JAX's bit for bit wherever the
upsampled logit is more than 1e-3 from the threshold 0 (the two packages sum
in another order; the count of pixels inside that band is printed). Path A
(the model generates ``[SEG]``) cannot be reached with random weights, in
either package's tests, so its extraction runs on a generated token list
with ``[SEG]`` planted at two steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch.api import (
    UFVideoRuntime,
    _assemble_input_ids,
    mm_infer,
    seg_masks_of_generation,
)
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.constants import DEFAULT_VIDEO_TOKEN
from ufvideo_tpu_torch.models.sam2.video import encode_video_frames, propagate_video
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.ops.interp import resize_hw
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.weights import load_jax_params

BAND = 1e-3  # logits closer than this to 0 may threshold either way
LABEL = (48, 64)
CONV = [
    {"from": "human", "value": "<video>\nPlease segment the cat."},
    {"from": "gpt", "value": "It is [SEG]."},
]


def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


@pytest.fixture(scope="module")
def runtimes():
    jtok, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    params = dict(jax.jit(JUFVideoModel(jcfg).init_params)(jax.random.PRNGKey(0)))
    sam = JSAM2(jcfg.sam, dtype=jnp.float32, param_dtype=jnp.float32)
    size = jcfg.sam.hiera.image_size
    params["sam"] = jax.jit(lambda k: sam.init(k, jnp.zeros((1, size, size, 3)))["params"])(
        jax.random.PRNGKey(1)
    )
    jrt = JRuntime(jcfg, params, jids)
    tok, ids = byte_tokenizer_with_ids()
    cfg = _with_ids(tiny_config(), ids)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)


def _inputs(seed, t_sam=4):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    images_sam = rng.standard_normal((t_sam, 128, 128, 3)).astype(np.float32)
    return frames, images_sam


def _logits_at_label_size(rt, seg_hidden, images_sam, label):
    """The port's upsampled mask logits [n_obj, T, H, W] for the band."""
    embeds = rt.model.seg_embeddings(seg_hidden)
    feats = encode_video_frames(rt.model.sam, torch.from_numpy(images_sam))
    low = propagate_video(rt.model.sam, feats, embeds[:, None, :])
    return resize_hw(low.float(), *label, "bilinear")[:, :, 0].permute(1, 0, 2, 3).numpy()


def _assert_masks_equal_outside_band(got, want, logits, what):
    assert len(got) == len(want) == logits.shape[0]
    for g, w, lg in zip(got, want, logits):
        assert g.dtype == np.bool_ and g.shape == w.shape == lg.shape
        band = np.abs(lg) < BAND
        print(f"{what}: {int(band.sum())} of {band.size} pixels within {BAND} of the threshold, "
              f"{int((g != w).sum())} differ, foreground share {w.mean():.3f}")
        assert (g == w)[~band].all()
        assert band.mean() < 0.01
        assert 0.0 < w.mean() < 1.0  # neither empty nor full: the comparison says something


@pytest.mark.parametrize(
    "conv,n_obj",
    [
        pytest.param(CONV, 1, id="one-object"),
        pytest.param(
            # short: tiny_config's sequence budget is 128 byte-level tokens
            [{"from": "human", "value": "<video>\nCat, dog?"},
             {"from": "gpt", "value": "[SEG] and [SEG]."}], 2,
            id="two-objects",
        ),
    ],
)
def test_mm_infer_path_b_masks_match_jax(runtimes, conv, n_obj):
    (jrt, jtok), (rt, tok) = runtimes
    frames, images_sam = _inputs(5)
    kw = dict(modal="video", choice=3, images_sam=images_sam, label_size=LABEL, seg=True)
    want = j_mm_infer(frames, conv, jrt, jtok, **kw)
    got = mm_infer(frames, conv, rt, tok, **kw)
    assert got["output"] is None and got["gt_masks"] is None
    assert len(got["pred_masks"]) == n_obj
    assert all(m.shape == (4, *LABEL) for m in got["pred_masks"])

    input_ids = _assemble_input_ids(conv, 3, DEFAULT_VIDEO_TOKEN, tok)
    feats = rt.encode_video(torch.from_numpy(frames)[None])
    hidden, plan = rt.forward_hidden_states(input_ids, feats)
    pos = [int(plan.text_pos_map[0][i]) - 1 for i, t in enumerate(input_ids) if t == rt.ids.seg]
    assert len(pos) == n_obj
    logits = _logits_at_label_size(rt, hidden[0, pos], images_sam, LABEL)
    _assert_masks_equal_outside_band(got["pred_masks"], want["pred_masks"], logits, "path B")


def test_path_b_default_label_size_is_the_sam_image_size(runtimes):
    (jrt, jtok), (rt, tok) = runtimes
    frames, images_sam = _inputs(6, t_sam=2)
    kw = dict(modal="video", choice=3, images_sam=images_sam, seg=True)
    got = mm_infer(frames, CONV, rt, tok, **kw)["pred_masks"]
    want = j_mm_infer(frames, CONV, jrt, jtok, **kw)["pred_masks"]
    assert got[0].shape == want[0].shape == (2, 128, 128)
    assert (got[0] != want[0]).mean() < 1e-3


def test_forward_hidden_and_seg_head_match_jax(runtimes):
    """The LLM's no-cache forward (``train`` mode) and the ``[SEG]`` text
    head. Tolerance 1e-4: float32 through two layers, summed in another
    order."""
    from ufvideo_tpu.splicing import plan_splice as j_plan_splice

    (jrt, jtok), (rt, tok) = runtimes
    frames, _ = _inputs(7)
    input_ids = _assemble_input_ids(CONV, 3, DEFAULT_VIDEO_TOKEN, tok)
    feats = rt.encode_video(torch.from_numpy(frames)[None])
    hidden, plan = rt.forward_hidden_states(input_ids, feats)
    jfeats = jrt.encode_video(jnp.asarray(frames)[None])
    jplan = j_plan_splice(
        [input_ids], num_video_tokens=jfeats.shape[1], region_token_counts=[[]],
        region_token_id=jrt.ids.region, max_seq_len=jrt.cfg.budget.max_seq_len,
        region_stride=jrt.cfg.region.region_token_num,
    )
    want = np.asarray(jrt.forward_hidden_states(jplan, jfeats))
    n = int(plan.seq_lens[0])
    assert n == int(jplan.seq_lens[0])
    np.testing.assert_allclose(hidden[0, :n].numpy(), want[0, :n], atol=1e-4, rtol=1e-4)
    emb = rt.model.seg_embeddings(hidden[0, :n]).numpy()
    jemb = np.asarray(jrt._seg_embed(jrt.params, jnp.asarray(want[0, :n])))
    assert emb.shape == (n, 32)
    np.testing.assert_allclose(emb, jemb, atol=1e-4, rtol=1e-4)


def test_path_a_extraction_on_planted_seg_tokens_matches_jax(runtimes):
    """Path A takes the hidden state of the decode step that produced each
    ``[SEG]``. Generate greedily in both packages (the tokens are equal),
    plant ``[SEG]`` at steps 1 and 4, and segment from those steps' hidden
    states."""
    (jrt, jtok), (rt, tok) = runtimes
    frames, images_sam = _inputs(8)
    text, out = mm_infer(frames, "Where is the cat?", rt, tok, max_new_tokens=6,
                         images_sam=images_sam, label_size=LABEL)
    assert out["pred_masks"] == []  # random weights generate no [SEG]
    input_ids = _assemble_input_ids("Where is the cat?", 1, DEFAULT_VIDEO_TOKEN, tok)
    feats = rt.encode_video(torch.from_numpy(frames)[None])
    tokens, hidden, _ = rt.generate(input_ids, feats, max_new_tokens=6)
    jtokens, jhidden, _ = jrt.generate(
        input_ids, jrt.encode_video(jnp.asarray(frames)[None]), None, None, max_new_tokens=6
    )
    assert tokens == out["output"] == list(jtokens) and len(tokens) == 6
    planted = list(tokens)
    planted[1] = planted[4] = rt.ids.seg
    got = seg_masks_of_generation(rt, planted, hidden, images_sam, LABEL)
    jembeds = jrt._seg_embed(jrt.params, jhidden[jnp.asarray([1, 4])])
    want = jrt.segment_video(images_sam, jembeds, *LABEL)
    logits = _logits_at_label_size(rt, hidden[[1, 4]], images_sam, LABEL)
    _assert_masks_equal_outside_band(got, list(want), logits, "path A")
    # without frames to segment, or without a [SEG], there is nothing to do
    assert seg_masks_of_generation(rt, planted, hidden, None, LABEL) == []
    assert seg_masks_of_generation(rt, tokens, hidden, images_sam, LABEL) == []


def test_segment_video_shapes_and_region_inputs_still_raise(runtimes):
    _, (rt, tok) = runtimes
    frames, images_sam = _inputs(9, t_sam=3)
    embeds = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 32)).astype("f"))
    masks = rt.segment_video(images_sam, embeds, 30, 40)
    assert masks.shape == (2, 3, 30, 40) and masks.dtype == np.bool_
    # region inputs are served on path B too (they raised before the region
    # encoder was ported): with no <region> in the prompt they change
    # nothing, and the given masks come back as ``gt_masks``
    gt = np.zeros((1, 8, 8), np.float32)
    out = mm_infer(frames, CONV, rt, tok, choice=3, images_sam=images_sam,
                   label_size=LABEL, masks=gt, frame=frames[:1])
    want = mm_infer(frames, CONV, rt, tok, choice=3, images_sam=images_sam, label_size=LABEL)
    assert out["gt_masks"] is gt and len(out["pred_masks"]) == 1
    np.testing.assert_array_equal(out["pred_masks"][0], want["pred_masks"][0])
