"""The port's SigLIP tower, STC-v35 projector and device preprocessing
against the JAX package on ``tiny_config()`` weights (float32, CPU).

Tolerances: 1e-4 for the tower and projector (float32 math through several
layers, summed in another order). Preprocessing: the bicubic weights are
the same float32 formula, but the two resize contractions sum in another
order, so a value within an ulp of x.5 can round to the neighbouring
uint8 level before normalisation: at most one level (2/255) apart, and
almost every value identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.ops.image_pipeline import siglip_preprocess_device as j_preprocess
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.ops.image_pipeline import bicubic_weights, siglip_preprocess_device
from ufvideo_tpu_torch.weights import load_jax_params

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jmodel = JUFVideoModel(j_tiny_config())
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(1)))
    model = load_jax_params(UFVideoModel.empty(tiny_config(), "cpu"), params)
    return jmodel, params, model


def _frames(seed, t, h, w):
    return np.random.default_rng(seed).standard_normal((t, h, w, 3)).astype(np.float32)


def test_siglip_tower_matches(pair):
    jmodel, params, model = pair
    px = _frames(0, 3, 60, 58)  # larger than 56: exercises the crop
    want = np.asarray(jmodel.vision.apply({"params": params["vision"]}, jnp.asarray(px)))
    with torch.no_grad():
        got = model.vision(torch.from_numpy(px)).numpy()
    assert got.shape == (3, 16, 32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_projector_matches(pair):
    jmodel, params, model = pair
    feats = np.random.default_rng(1).standard_normal((2, 4, 16, 32)).astype(np.float32)
    want = np.asarray(jmodel.projector.apply({"params": params["projector"]}, jnp.asarray(feats)))
    with torch.no_grad():
        got = model.projector(torch.from_numpy(feats)).numpy()
    assert got.shape == (2, 8, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_projector_drops_odd_frames_and_rows(pair):
    """Conv3d padding 0 floor-divides odd t / h / w, as flax VALID does."""
    jmodel, params, model = pair
    feats = np.random.default_rng(2).standard_normal((1, 5, 25, 32)).astype(np.float32)
    want = np.asarray(jmodel.projector.apply({"params": params["projector"]}, jnp.asarray(feats)))
    with torch.no_grad():
        got = model.projector(torch.from_numpy(feats)).numpy()
    assert got.shape == (1, 2 * 2 * 2, 64) == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_encode_video_matches(pair):
    jmodel, params, model = pair
    px = _frames(3, 4, 56, 56)[None]
    want = np.asarray(jmodel.encode_video(params, jnp.asarray(px)))
    got = model.encode_video(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("in_size,out_size", [(40, 384), (480, 384), (640, 384), (384, 384)])
def test_bicubic_weights_match_jax(in_size, out_size):
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

    want = np.asarray(
        compute_weight_mat(in_size, out_size, out_size / in_size, 0.0,
                           _fill_keys_cubic_kernel, True)
    )
    got = bicubic_weights(in_size, out_size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(2, 40, 52, 3), (1, 480, 640, 3)], ids=["up", "down"])
def test_siglip_preprocess_matches(shape):
    frames = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(j_preprocess(jnp.asarray(frames), out_dtype=jnp.float32))
    got = siglip_preprocess_device(torch.from_numpy(frames), out_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (shape[0], 384, 384, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 / 255.0 + 1e-6
    assert (diff > 1e-6).mean() < 1e-3
