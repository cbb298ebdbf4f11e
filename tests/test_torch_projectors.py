"""Every projector type of the port (``models/projector.build_projector``)
against ``ufvideo_tpu.models.projector.build_projector`` on the same seeded
inputs and the JAX module's parameters (``weights.load_projector``, which
``load_jax_params`` calls), within 1e-5 in f32; ``token_grid`` against the
JAX formula; the converter and the exporter against JAX's key for key; and
``mm_infer`` on ``tiny_config()`` with the ``stc_connector`` and the
``mlp2x_gelu`` projector, whose greedy tokens must be JAX's exactly.

A JAX hazard the port does not carry: JAX's ``token_grid`` tests only
``("linear", "mlp2x_gelu")``, so it counts ``mlp3x_gelu`` as an STC grid
though its module emits one frame's grid; the port's count is held to the
JAX module's output shape there. JAX's converter and exporter ask for
RegStage and sampler keys that the ``stp_connector``, ``spatial_conv`` and
``spatial_pool`` modules do not have, and so raise on those types; the port
lists only the layers a type has, and its round trip is held to the JAX
module's parameters instead.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_init as jax_init

from ufvideo_tpu import export as jexport
from ufvideo_tpu import weights as jweights
from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.configs import ProjectorConfig as JProjectorConfig
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models.projector import build_projector as j_build_projector
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch.api import UFVideoRuntime, mm_infer
from ufvideo_tpu_torch.configs import ProjectorConfig, tiny_config
from ufvideo_tpu_torch.export import export_projector
from ufvideo_tpu_torch.models.projector import (
    LinearProjector, STCConnector, build_projector)
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.weights import (
    TensorWriter, convert_projector, load_jax_params, load_projector)

TYPES = ["linear", "mlp2x_gelu", "mlp3x_gelu", "stc_connector", "stc_connector_v35",
         "stp_connector", "spatial_conv", "spatial_pool"]
# the types whose keys the JAX converter and exporter hold
JAX_CONVERTIBLE = ["linear", "mlp2x_gelu", "mlp3x_gelu", "stc_connector", "stc_connector_v35"]
WIDTHS = dict(encoder_hidden_size=16, hidden_size=32, depth=2, mlp_depth=2)
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_module(ptype, t=5, grid=5, seed=0):
    """(JAX params as numpy, JAX output, the input) at an odd grid and frame
    count, so that each sampler's floor and padding show; computed once a
    type (read only)."""
    cfg = JProjectorConfig(projector_type=ptype, **WIDTHS)
    mod = j_build_projector(cfg, dtype=jnp.float32, param_dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, t, grid * grid, 16)).astype(np.float32)
    params = mod.init(jax.random.PRNGKey(seed + 1), jnp.asarray(x))["params"]
    out = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    return jax.tree.map(np.asarray, params), out, x


def _port_module(ptype, params=None):
    proj = build_projector(ProjectorConfig(projector_type=ptype, **WIDTHS), torch.float32)
    if params is not None:
        load_projector(proj, params)
    return proj


@pytest.mark.parametrize("ptype", TYPES)
def test_projector_equals_jax(ptype):
    params, want, x = _jax_module(ptype)
    proj = _port_module(ptype, params)
    assert isinstance(proj, LinearProjector if "x_gelu" in ptype or ptype == "linear"
                      else STCConnector)
    got = proj(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    cfg = ProjectorConfig(projector_type=ptype, **WIDTHS)
    assert got.shape[1] == cfg.num_video_tokens(5, 5)


@pytest.mark.parametrize("ptype", TYPES)
def test_token_grid_equals_jax(ptype):
    cfg = ProjectorConfig(projector_type=ptype)
    jcfg = JProjectorConfig(projector_type=ptype)
    for t, grid in ((32, 27), (32, 24), (5, 5), (4, 4), (1, 7)):
        got = cfg.token_grid(t, grid)
        if ptype == "mlp3x_gelu":  # the JAX formula's hazard: held to its module
            assert got == (1, grid, grid) != jcfg.token_grid(t, grid)
        else:
            assert got == jcfg.token_grid(t, grid), (t, grid)
    if ptype == "mlp3x_gelu":
        _, out, _ = _jax_module(ptype)
        assert out.shape[1] == ProjectorConfig(projector_type=ptype,
                                               **WIDTHS).num_video_tokens(5, 5)
    with pytest.raises(ValueError):
        ProjectorConfig(projector_type="mlp_gelu").token_grid(32, 27)
    with pytest.raises(ValueError):
        build_projector(ProjectorConfig(projector_type="mlp_gelu"))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("ptype", JAX_CONVERTIBLE)
def test_export_and_convert_equal_jax(ptype):
    """The port's export of the JAX module's parameters equals JAX's export
    key for key and value for value; each converter reads the other's state
    dict back to the same parameters."""
    params, _, x = _jax_module(ptype)
    jcfg = JProjectorConfig(projector_type=ptype, **WIDTHS)
    proj = _port_module(ptype, params)
    got = export_projector(proj)
    want = jexport.export_projector(params, jcfg)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    back = jweights.convert_projector(got, jcfg)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    fresh = _port_module(ptype)
    w = TensorWriter()
    convert_projector(w, fresh, {f"mm_projector.{k}": v for k, v in want.items()})
    w.check_all_written(fresh)
    for (n, a), b in zip(proj.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("ptype", ["stp_connector", "spatial_conv", "spatial_pool"])
def test_export_and_convert_round_trip_where_jax_raises(ptype):
    """The keys the module's layers carry and no others (no RegStage where
    depth is 0, no sampler where it pools), back to the JAX module's
    parameters bit for bit; the JAX exporter raises on these types."""
    params, want, x = _jax_module(ptype)
    proj = _port_module(ptype, params)
    sd = export_projector(proj)
    n_leaves = len(jax.tree.leaves(params))
    assert len(sd) == n_leaves
    assert ("sampler.0.weight" in sd) == (ptype == "spatial_conv")
    assert any(k.startswith("s1.") for k in sd) == (ptype == "stp_connector")
    fresh = _port_module(ptype)
    w = TensorWriter()
    convert_projector(w, fresh, sd)
    w.check_all_written(fresh)
    got = fresh(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with pytest.raises(KeyError):
        jexport.export_projector(params, JProjectorConfig(projector_type=ptype, **WIDTHS))


def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


@pytest.fixture(scope="module", params=["stc_connector", "mlp2x_gelu"])
def runtimes(request):
    """One JAX runtime on ``UFVideoModel.init_params`` of ``tiny_config()``
    with the projector type, and the port's loaded from the same tree."""
    jtok, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    jcfg = jcfg.replace(projector=dataclasses.replace(jcfg.projector,
                                                      projector_type=request.param))
    params = jax_init.model_params(jcfg, 0)
    jrt = JRuntime(jcfg, dict(params), jids)
    tok, ids = byte_tokenizer_with_ids()
    cfg = _with_ids(tiny_config(), ids)
    cfg = cfg.replace(projector=dataclasses.replace(cfg.projector,
                                                    projector_type=request.param))
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return request.param, (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)


@pytest.mark.parametrize("dtype,shape", [(np.float32, (4, 56, 56, 3)), (np.uint8, (4, 40, 52, 3))],
                         ids=["float-video", "uint8-video-resized"])
def test_mm_infer_tokens_match_jax(runtimes, dtype, shape):
    ptype, (jrt, jtok), (rt, tok) = runtimes
    rng = np.random.default_rng(21)
    frames = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == np.uint8
              else rng.standard_normal(shape).astype(np.float32))
    q = "What happens in this video?"
    jtext, jout = j_mm_infer(frames, q, jrt, jtok, max_new_tokens=8)
    text, out = mm_infer(frames, q, rt, tok, max_new_tokens=8)
    assert out["output"] == jout["output"]
    assert text == jtext
    feats = rt.encode_video(torch.zeros((1, 4, 56, 56, 3)))
    assert feats.shape[1] == rt.cfg.num_video_tokens == {"stc_connector": 27,
                                                         "mlp2x_gelu": 16}[ptype]
