"""The JAX package's random parameters for the tests' configurations, made
once a worker process. ``UFVideoModel.init_params`` and SAM2's ``init`` each
cost a JAX compile of 10-20 s on the CPU, and a dozen of the port's test
files (and several fixtures of one file) ask for the same trees. Each call
returns fresh containers around the same immutable JAX arrays, so a caller
may add, replace or drop entries."""

import functools

import jax
import jax.numpy as jnp

from ufvideo_tpu.models.sam2 import SAM2
from ufvideo_tpu.models.ufvideo import UFVideoModel


@functools.lru_cache(maxsize=None)
def _model_params(cfg, seed: int):
    return jax.jit(UFVideoModel(cfg).init_params)(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _sam2_params(sam_cfg, seed: int):
    sam = SAM2(sam_cfg, dtype=jnp.float32, param_dtype=jnp.float32)
    size = sam_cfg.hiera.image_size
    return jax.jit(lambda k: sam.init(k, jnp.zeros((1, size, size, 3)))["params"])(
        jax.random.PRNGKey(seed))


def model_params(cfg, seed: int) -> dict:
    """``jax.jit(UFVideoModel(cfg).init_params)(PRNGKey(seed))``."""
    return jax.tree.map(lambda a: a, dict(_model_params(cfg, seed)))


def sam2_params(sam_cfg, seed: int) -> dict:
    """The float32 SAM2 tree ``SAM2(sam_cfg).init`` makes from
    ``PRNGKey(seed)`` on one frame at the configuration's image size."""
    return jax.tree.map(lambda a: a, dict(_sam2_params(sam_cfg, seed)))
