"""The port's region encoder against the JAX package, on the CPU: the same
numpy inputs through ``ufvideo_tpu.models.region_encoder`` and its
counterpart, function by function, then ``encode_regions`` and
``pack_and_encode_regions`` on ``load_jax_params`` weights. Limit 1e-5: the
same f32 math summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_init as jax_init

from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models import region_encoder as jre
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu.tokenization import parse_temporal_tokens as j_parse_temporal_tokens
from ufvideo_tpu_torch.api import UFVideoRuntime
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models import region_encoder as tre
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids, parse_temporal_tokens
from ufvideo_tpu_torch.weights import load_jax_params

ATOL = 1e-5


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_mask_pool_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 4, 4, 8)).astype(np.float32)
    masks = (rng.random((3, 4, 4)) > 0.5).astype(np.float32)
    masks[1] = 0.0  # an empty mask: the 1e-8 in the denominator
    masks[2] *= 0.3  # fractional values count as inside (mask > 0)
    _close(tre.mask_pool(*_t(feats, masks)), jre.mask_pool(jnp.asarray(feats), jnp.asarray(masks)))


@pytest.mark.parametrize("shape,grid", [((2, 40, 52), 4), ((1, 7, 9), 4), ((2, 4, 4), 4)],
                         ids=["down", "down-odd", "identity"])
def test_resize_mask_to_grid_matches_jax_and_host_twin(shape, grid):
    masks = (np.random.default_rng(1).random(shape) > 0.6).astype(np.float32)
    want = np.asarray(jre.resize_mask_to_grid(jnp.asarray(masks), grid))
    _close(tre.resize_mask_to_grid(torch.from_numpy(masks), grid), want)
    host = tre.resize_mask_to_grid_np(masks, grid)
    _close(host, jre.resize_mask_to_grid_np(masks, grid))
    # what mask_pool thresholds on is the same set of cells
    np.testing.assert_array_equal(host > 0, want > 0)


def _merge_both(tokens, valid, out_tokens):
    want = jre.token_merge_static(jnp.asarray(tokens), jnp.asarray(valid), out_tokens)
    got = tre.token_merge_static(*_t(tokens, valid), out_tokens)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    return got


@pytest.mark.parametrize("n,n_valid,out_tokens", [
    pytest.param(8, 8, 4, id="merge-8-to-4"),
    pytest.param(8, 5, 4, id="padding-frames"),
    pytest.param(8, 3, 4, id="n_valid-below-budget"),
    pytest.param(4, 4, 4, id="nothing-to-merge"),
    pytest.param(2, 2, 4, id="fewer-tokens-than-budget"),
    pytest.param(1, 1, 4, id="one-token"),
])
def test_token_merge_static_matches_jax(n, n_valid, out_tokens):
    tokens = np.random.default_rng(2).standard_normal((n, 16)).astype(np.float32)
    valid = np.arange(n) < n_valid
    merged, out_valid = _merge_both(tokens, valid, out_tokens)
    assert merged.shape == (out_tokens, 16)
    assert int(out_valid.sum()) == min(n_valid, out_tokens)


def test_token_merge_static_tie_goes_to_the_earlier_boundary():
    """Boundaries 0 and 2 are equally similar (identical neighbours); with
    one merge to make, the earlier one merges, as JAX's stable argsort has it."""
    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    tokens = np.stack([a, a, b, b, c])
    merged, out_valid = _merge_both(tokens, np.ones(5, bool), 4)
    np.testing.assert_allclose(merged[0].numpy(), a, atol=ATOL)
    np.testing.assert_allclose(merged[1].numpy(), b, atol=ATOL)  # b, b stay two tokens
    assert bool(out_valid.all())


def test_extract_region_tokens_matches_jax():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((4, 16, 8)).astype(np.float32)  # 4 frames, 4x4 grid
    masks = (rng.random((4, 20, 28)) > 0.5).astype(np.float32)
    frame_valid = np.asarray([True, True, True, False])
    segments = np.asarray([[True, False, True, True], [False, True, False, False]])
    want = jre.extract_region_tokens(*map(jnp.asarray, (feats, masks, frame_valid, segments)), 2)
    got = tre.extract_region_tokens(*_t(feats, masks, frame_valid, segments), 2)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].shape == (2, 2, 8)


def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


@pytest.fixture(scope="module")
def runtimes():
    _, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    params = jax_init.model_params(jcfg, 0)
    jrt = JRuntime(jcfg, dict(params), jids)
    _, ids = byte_tokenizer_with_ids()
    cfg = _with_ids(tiny_config(), ids)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jrt, UFVideoRuntime(cfg, model, ids, "cpu")


def test_region_projector_and_encode_regions_match_jax(runtimes):
    jrt, rt = runtimes
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    _close(rt.model.region(torch.from_numpy(x)).detach(),
           jrt.model.region.apply({"params": jrt.params["region"]}, jnp.asarray(x)))
    frames = rng.standard_normal((1, 2, 56, 56, 3)).astype(np.float32)
    masks = (rng.random((1, 2, 4, 4)) > 0.4).astype(np.float32)
    fv = np.asarray([[True, True]])
    seg = np.asarray([[[True, False], [True, True]]])
    want = jrt.model.encode_regions(jrt.params, *map(jnp.asarray, (frames, masks, fv, seg)))
    got = rt.model.encode_regions(*_t(frames, masks, fv, seg))
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n_frames,ann_indices,counts", [
    pytest.param(1, None, [1], id="one-frame-default-regions"),
    pytest.param(3, [[0, 2], [1]], [2, 1], id="3-frames-padded-to-4"),
    pytest.param(6, [[0, 1, 2, 3, 4, 5]], [4], id="6-frames-merged-to-4-tokens"),
])
def test_pack_and_encode_regions_matches_jax(runtimes, n_frames, ann_indices, counts):
    """Frame and region counts padded to powers of two; counts capped at
    ``region_token_num`` (4)."""
    jrt, rt = runtimes
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((n_frames, 56, 56, 3)).astype(np.float32)
    masks = (rng.random((n_frames, 30, 44)) > 0.5).astype(np.float32)
    want, want_counts = jrt.pack_and_encode_regions(frames, masks, ann_indices)
    got, got_counts = rt.pack_and_encode_regions(frames, masks, ann_indices)
    assert got_counts == want_counts == counts
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_parse_temporal_tokens_equals_jax():
    for text in ("from <TEMP-007> to <TEMP-099>.", "<TEMP-000>", "no tokens", "<TEMP-12> <TEMP-1234>"):
        assert parse_temporal_tokens(text) == j_parse_temporal_tokens(text)
    assert parse_temporal_tokens("<TEMP-099>") == [1.0]
