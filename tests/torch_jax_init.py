"""The JAX package's random parameters for the tests' configurations, made
once a test run. ``UFVideoModel.init_params`` and SAM2's ``init`` each cost
a JAX compile of 15-35 s on the CPU, and a dozen of the port's test files
(and several fixtures of one file) ask for the same trees. The first worker
process that needs a tree computes it and writes it, as numpy, to a file
named by the configuration, the seed, the JAX version and a digest of the
JAX package's sources, under the temporary directory; the others wait on
its lock and read it (the same values, bit for bit). Each call returns
fresh containers around the same immutable JAX arrays, so a caller may add,
replace or drop entries."""

import fcntl
import functools
import hashlib
import os
import pathlib
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

import torch_cores  # noqa: F401  (one share of the cores a test worker)

from ufvideo_tpu.models.sam2 import SAM2
from ufvideo_tpu.models.ufvideo import UFVideoModel

_ROOT = pathlib.Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def _source_digest() -> str:
    h = hashlib.sha256()
    for path in sorted((_ROOT / "ufvideo_tpu").rglob("*.py")):
        h.update(path.read_bytes())
    h.update(pathlib.Path(__file__).read_bytes())
    return h.hexdigest()


def _shared(name: str, key, compute):
    """``compute()``'s tree, computed by one process of the run and read by
    the others (a file lock orders them)."""
    digest = hashlib.sha256(
        repr((name, key, jax.__version__, _source_digest())).encode()).hexdigest()[:32]
    cache = os.path.join(tempfile.gettempdir(), "ufvideo_jax_init")
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"{name}-{digest}.pkl")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, "rb") as f:
                tree = pickle.load(f)
        else:
            tree = jax.tree.map(np.asarray, compute())
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(tree, f)
            os.replace(tmp, path)
    return jax.tree.map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model_params(cfg, seed: int):
    return _shared("model", (cfg, seed), lambda: jax.jit(UFVideoModel(cfg).init_params)(
        jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _sam2_params(sam_cfg, seed: int):
    sam = SAM2(sam_cfg, dtype=jnp.float32, param_dtype=jnp.float32)
    size = sam_cfg.hiera.image_size
    return _shared("sam2", (sam_cfg, seed), lambda: jax.jit(
        lambda k: sam.init(k, jnp.zeros((1, size, size, 3)))["params"])(
        jax.random.PRNGKey(seed)))


def model_params(cfg, seed: int) -> dict:
    """``jax.jit(UFVideoModel(cfg).init_params)(PRNGKey(seed))``."""
    return jax.tree.map(lambda a: a, dict(_model_params(cfg, seed)))


def sam2_params(sam_cfg, seed: int) -> dict:
    """The float32 SAM2 tree ``SAM2(sam_cfg).init`` makes from
    ``PRNGKey(seed)`` on one frame at the configuration's image size."""
    return jax.tree.map(lambda a: a, dict(_sam2_params(sam_cfg, seed)))
