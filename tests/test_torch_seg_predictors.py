"""SAM2's general and batched-video predictors on the float model against
the JAX package, on ``tiny_config()`` (float32, CPU, image 128):
``propagate_video_general`` (forward / reverse / both, stride 1 to 3,
several prompted frames, language / points / box prompts), its memory slot
choice, and ``propagate_videos_batched``; logits within ``TOL`` (f32 sums in
another order). The model and its JAX twin are ``tests/test_torch_seg_quant.py``'s
``float_pair``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_seg_quant import TOL, _randn, float_pair  # noqa: F401  (a fixture)
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models.sam2 import video as jvideo
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models.sam2 import video as tvideo
from ufvideo_tpu_torch.models.sam2.common import NO_OBJ_SCORE

# ------------------------------------------------------- general predictor --

T_GEN = 7


@pytest.fixture(scope="module")
def video_feats(float_pair):
    jm, params, model = float_pair
    imgs = _randn(40, T_GEN, 128, 128, 3)
    jfeats = jvideo.encode_video_frames(jm, params, jnp.asarray(imgs))
    feats = tvideo.encode_video_frames(model, torch.from_numpy(imgs), chunk=4)
    return jfeats, feats


def _conditions(kinds, b=2):
    """[(frame, kind)] → (JAX conditions, port conditions) on the same
    numpy prompts."""
    jconds, tconds = [], []
    for frame, kind in kinds:
        rng = np.random.default_rng(100 + frame)
        kw = {}
        if kind == "language":
            kw["language_embd"] = rng.standard_normal((b, 1, 32)).astype(np.float32)
        elif kind == "points":
            kw["point_coords"] = rng.uniform(8, 120, (b, 2, 2)).astype(np.float32)
            kw["point_labels"] = np.asarray([[1, 0]] * b, np.int32)
        elif kind == "box":
            lo = rng.uniform(8, 56, (b, 2))
            kw["box"] = np.concatenate([lo, lo + rng.uniform(16, 60, (b, 2))], 1).astype(
                np.float32)
        elif kind == "box+point":
            lo = rng.uniform(8, 56, (b, 2))
            kw["box"] = np.concatenate([lo, lo + 40.0], 1).astype(np.float32)
            kw["point_coords"] = (lo[:, None] + 20.0).astype(np.float32)
            kw["point_labels"] = np.ones((b, 1), np.int32)
        jconds.append(jvideo.FrameCondition(frame, **{k: jnp.asarray(v) for k, v in kw.items()}))
        tconds.append(tvideo.FrameCondition(
            frame, **{k: torch.from_numpy(v) for k, v in kw.items()}))
    return jconds, tconds


GENERAL_CASES = [
    pytest.param([(0, "language")], 1, "forward", id="frame0-language-forward"),
    pytest.param([(T_GEN - 1, "language")], 1, "reverse", id="last-frame-reverse"),
    pytest.param([(3, "points")], 1, "both", id="mid-video-points-both"),
    pytest.param([(0, "language")], 2, "forward", id="stride2-forward"),
    pytest.param([(5, "box")], 3, "reverse", id="stride3-box-reverse"),
    pytest.param([(2, "language"), (5, "box+point")], 2, "both",
                 id="two-prompted-frames-stride2-both"),
    pytest.param([(4, "points"), (1, "language")], 1, "forward",
                 id="prompted-out-of-order-forward"),
]


@pytest.mark.parametrize("kinds,stride,direction", GENERAL_CASES)
def test_propagate_video_general_matches_jax(float_pair, video_feats, kinds, stride, direction):
    """Logits on every frame within ``TOL``: the slot choice, the validity
    masks and the temporal position indices are JAX's. Frames a
    one-directional call never reaches hold ``NO_OBJ_SCORE``, prompted frames
    their conditioning output."""
    jm, params, model = float_pair
    jfeats, feats = video_feats
    jconds, tconds = _conditions(kinds)
    want = np.asarray(jvideo.propagate_video_general(
        jm, params, jfeats, jconds, stride=stride, direction=direction))
    got = tvideo.propagate_video_general(
        model, feats, tconds, stride=stride, direction=direction).numpy()
    assert got.shape == want.shape == (T_GEN, 2, 1, 32, 32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    prompted = [f for f, _ in kinds]
    anchor = min(prompted)
    for fi in range(T_GEN):
        unreached = fi not in prompted and (
            (direction == "forward" and fi < anchor) or (direction == "reverse" and fi > anchor))
        assert (got[fi] == NO_OBJ_SCORE).all() == unreached, fi


def test_general_with_frame0_forward_equals_propagate_video(float_pair, video_feats):
    """One language prompt on frame 0, stride 1, forward: the general
    predictor is the ``[SEG]`` path's ``propagate_video`` (the same modules
    on the same slots; the ring gather changes no value)."""
    model = float_pair[2]
    _, feats = video_feats
    lang = torch.from_numpy(_randn(41, 2, 1, 32))
    want = tvideo.propagate_video(model, feats, lang)
    got = tvideo.propagate_video_general(
        model, feats, [tvideo.FrameCondition(0, language_embd=lang)], direction="forward")
    torch.testing.assert_close(got, want.float(), atol=1e-5, rtol=1e-5)


def test_box_equals_its_corner_points(float_pair, video_feats):
    model = float_pair[2]
    _, feats = video_feats
    box = torch.tensor([[20.0, 24.0, 90.0, 100.0]])
    via_box = tvideo.propagate_video_general(
        model, feats, [tvideo.FrameCondition(1, box=box)], direction="forward")
    via_pts = tvideo.propagate_video_general(
        model, feats,
        [tvideo.FrameCondition(1, point_coords=box.reshape(1, 2, 2),
                               point_labels=torch.tensor([[2, 3]], dtype=torch.int32))],
        direction="forward")
    assert torch.equal(via_box, via_pts)


def test_general_predictor_refuses_what_it_cannot_run(float_pair, video_feats):
    model = float_pair[2]
    _, feats = video_feats
    with pytest.raises(ValueError, match="direction"):
        tvideo.propagate_video_general(model, feats, [], direction="sideways")
    with pytest.raises(ValueError, match="at least one"):
        tvideo.propagate_video_general(model, feats, [])
    with pytest.raises(ValueError, match="frame 2"):
        tvideo.propagate_video_general(model, feats, [tvideo.FrameCondition(2)])


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_memory_slot_selection_equals_jax(stride, reverse):
    """Slot, validity and temporal index for every frame of a 12-frame walk
    with two prompted frames, against the JAX function on a concrete index."""
    cfg, jcfg = tiny_config().sam, j_tiny_config().sam
    cond = (3, 8) if not reverse else (9, 4)
    anchor = min(cond)
    frames = range(anchor + 1, 12) if not reverse else range(anchor - 1, -1, -1)
    assert tvideo._ring_len(cfg, stride) == jvideo._ring_len(jcfg, stride)
    for fi in frames:
        want = jvideo._select_mem_slots(jcfg, jnp.int32(fi), anchor, cond, stride, reverse)
        got = tvideo._select_mem_slots(cfg, fi, anchor, cond, stride, reverse)
        for g, w in zip(got, want):
            assert list(g) == np.asarray(w).tolist(), (fi, got, want)


# ------------------------------------------------------------ batched videos --

def test_propagate_videos_batched_matches_jax_and_per_video_calls(float_pair):
    jm, params, model = float_pair
    v, t = 3, 4
    imgs = _randn(50, v, t, 128, 128, 3)
    lang = _randn(51, v, 1, 32)
    jfeats = jvideo.encode_video_frames(jm, params, jnp.asarray(imgs.reshape(v * t, 128, 128, 3)))
    jv = jfeats.map_frames(lambda a: a.reshape((v, t) + a.shape[1:]))
    want = np.asarray(jvideo.propagate_videos_batched(jm, params, jv, jnp.asarray(lang)))
    feats = tvideo.encode_video_frames(model, torch.from_numpy(imgs.reshape(v * t, 128, 128, 3)))
    per_video = lambda a: a.reshape((v, t) + tuple(a.shape[1:]))
    vfeats = feats._replace(s0=per_video(feats.s0), s1=per_video(feats.s1),
                            s2=per_video(feats.s2))
    got = tvideo.propagate_videos_batched(model, vfeats, torch.from_numpy(lang))
    assert tuple(got.shape) == (t, v, 1, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    for i in range(v):
        one = tvideo.FrameFeatures(vfeats.s0[i], vfeats.s1[i], vfeats.s2[i], vfeats.pos2)
        alone = tvideo.propagate_video(model, one, torch.from_numpy(lang[i:i + 1]))
        torch.testing.assert_close(got[:, i:i + 1], alone, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="videos"):
        tvideo.propagate_videos_batched(model, vfeats, torch.from_numpy(lang[:2]))
