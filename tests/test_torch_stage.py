"""Stage fusion, the polynomial GELUs and the bf16 routing of the ``[SEG]``
slice against the JAX package, on the CPU (float32).

- The four polynomial GELUs against the JAX ``_ACTS``: the f32 ones to 1e-6
  (the same polynomial, Horner steps in the same order); the ``_bf16`` ones,
  evaluated on bf16 values with a rounding after each step, to two bf16
  steps of the value (XLA may keep a step in f32 or round a constant at
  another point).
- ``fused_hiera_stage_plain`` (nb = 1..4) against the JAX
  ``fused_hiera_stage`` off the TPU (the fold of ``_reference``) to 1e-5 in
  f32, and against its Pallas ``_stage_kernel`` in interpret mode to the
  1e-4 of the single-block kernel test (the TPU kernel's A-S erf and exp2
  softmax).
- Hiera with ``hiera_stage_nb=4``, ``qpool_fused=False`` and the polynomial
  GELU against the JAX Hiera with ``UFVIDEO_HIERA_STAGE_NB=4``,
  ``UFVIDEO_QPOOL_FUSED=0`` and ``UFVIDEO_HIERA_GELU=poly`` (set on the JAX
  side only) on a (2, 3, 2, 1) trunk that has a run to group.
- The float generic block (a window over 512 tokens), and the W8A8 Hiera
  with ``sam2_int8_special=False`` against JAX with
  ``UFVIDEO_SAM2_INT8_SPECIAL=0`` (its stages on their mean difference).
- The slice: ``mm_infer`` ``[SEG]`` path B and greedy QA under the routing
  of ``chip_smoke.py`` phase 7a (unfused bf16-LayerNorm SigLIP, split q-pool,
  stage fusion, polynomial GELU) against JAX with the same switches:
  tokens equal, masks equal outside ``BAND`` of the threshold.

The JAX package reads its switches at trace time: each JAX side is traced
after its variables are set, and ``jax.clear_caches()`` runs between
routings, so that no cached trace hides a switch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.configs import SAM2HieraConfig as JHieraConfig
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models import siglip as j_siglip
from ufvideo_tpu.models import ufvideo as j_ufvideo
from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu import quant as jq
from ufvideo_tpu.models.sam2.hiera import Hiera as JHiera
from ufvideo_tpu.models.sam2.hiera import MultiScaleBlock as JBlock
from ufvideo_tpu.ops import hiera_block as jhb
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids, mm_infer
from ufvideo_tpu_torch.configs import SAM2HieraConfig, VisionRouting, tiny_config
from ufvideo_tpu_torch.constants import DEFAULT_VIDEO_TOKEN
from ufvideo_tpu_torch import quant as tq
from ufvideo_tpu_torch.models.sam2.hiera import Hiera, MultiScaleBlock
from ufvideo_tpu_torch.models.sam2.video import encode_video_frames, propagate_video
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.ops import hiera_block as hb
from ufvideo_tpu_torch.ops.interp import resize_hw
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.weights import load_by_name, load_jax_params

TOL = 1e-5
BAND = 1e-3  # logits closer than this to 0 may threshold either way
LABEL = (48, 64)
CONV = [
    {"from": "human", "value": "<video>\nPlease segment the cat."},
    {"from": "gpt", "value": "It is [SEG]."},
]
# chip_smoke.py phase 7a
ROUTING_7A = VisionRouting(siglip_ln_dtype="bf16", qpool_fused=False, hiera_stage_nb=4,
                           hiera_gelu="poly")
ENV_7A = {"UFVIDEO_HIERA_STAGE_NB": "4", "UFVIDEO_QPOOL_FUSED": "0",
          "UFVIDEO_HIERA_GELU": "poly"}


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy(params, seed):
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        for a in leaves])


def _held(got, want, what):
    """A W8A8 trunk on its mean difference (as tests/test_torch_seg_quant.py
    holds the fused one): a flipped int8 step in an early block spreads
    through the later ones."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    print(f"{what}: mean difference {diff.mean():.6f}, largest {diff.max():.4f}")
    assert diff.mean() < 0.05 and diff.max() < 0.25


# ------------------------------------------------------------ activations --

@pytest.mark.parametrize("act", ["gelu_poly", "gelu_tanh_poly", "gelu_poly_bf16",
                                 "gelu_tanh_poly_bf16"])
def test_polynomial_gelus_match_jax(act):
    x = np.concatenate([np.linspace(-8, 8, 4001, dtype=np.float32), 3 * _randn(0, 4000)])
    want = np.asarray(jhb._ACTS[act](jnp.asarray(x)), np.float32)
    got = hb._ACTS[act](torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    if act.endswith("_bf16"):
        # bf16-representable values, within two bf16 steps of JAX's
        assert np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())
        np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -8, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the fits themselves: within 1.1e-4 of the erf GELU / 1e-5 of the tanh form
    exact = "gelu_tanh" if "tanh" in act else "gelu_exact"
    ref = hb._ACTS[exact](torch.from_numpy(x).double()).numpy()
    assert np.abs(got - ref).max() < (0.04 if act.endswith("_bf16") else 1.2e-4)


def _block_params(seed, c, heads, hd, mlp):
    hw = heads * hd
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (
        1.0 + 0.1 * r(c), 0.1 * r(c),
        c ** -0.5 * r(c, 3 * hw), 0.1 * r(3 * hw),
        hw ** -0.5 * r(hw, c), 0.1 * r(c),
        1.0 + 0.1 * r(c), 0.1 * r(c),
        c ** -0.5 * r(c, mlp), 0.1 * r(mlp),
        mlp ** -0.5 * r(mlp, c), 0.1 * r(c),
    )


@pytest.mark.parametrize("act", ["gelu_poly", "gelu_tanh_poly"])
def test_hiera_block_plain_with_a_polynomial_gelu_matches_jax(act):
    n, s, c, heads = 4, 16, 32, 2
    x = _randn(3, n, s, c)
    params = _block_params(4, c, heads, c // heads, 4 * c)
    got = hb.fused_hiera_block(torch.from_numpy(x), tuple(map(torch.from_numpy, params)),
                               heads, c // heads, act=act).numpy()
    want = jhb._reference(jnp.asarray(x), tuple(map(jnp.asarray, params)), heads, c // heads,
                          c // heads, act, 1e-6)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


# ----------------------------------------------------------------- stage --

@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_stage_plain_matches_jax_fold_and_stage_kernel(nb):
    n, s, c, heads = 4, 16, 32, 2
    hd = c // heads
    x = _randn(10 + nb, n, s, c)
    plist = [_block_params(20 + i, c, heads, hd, 4 * c) for i in range(nb)]
    got = hb.fused_hiera_stage(torch.from_numpy(x),
                               [tuple(map(torch.from_numpy, p)) for p in plist], heads, hd,
                               act="gelu_exact")
    assert hb.fused_hiera_stage.launches == 0  # CPU tensors take the plain version
    jplist = tuple(tuple(map(jnp.asarray, p)) for p in plist)
    fold = jhb.fused_hiera_stage(jnp.asarray(x), jplist, heads, hd, 0, False, "gelu_exact",
                                 1e-6, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(fold), atol=TOL, rtol=TOL)
    if nb <= 2:  # the Pallas stage kernel itself, in interpret mode
        pallas = jhb.fused_hiera_stage(jnp.asarray(x), jplist, heads, hd, 0, True,
                                       "gelu_exact", 1e-6, False)
        # the TPU kernel's A-S erf and bf16-free exp2 softmax: as the
        # single-block kernel test holds it
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-4, rtol=1e-4)
    one_by_one = torch.from_numpy(x)
    for p in plist:
        one_by_one = hb.fused_hiera_block_plain(one_by_one, tuple(map(torch.from_numpy, p)),
                                                heads, hd)
    torch.testing.assert_close(got, one_by_one, rtol=0, atol=0)


def test_stage_refuses_no_blocks_and_unknown_activations():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="at least one block"):
        hb.fused_hiera_stage(x, [], 1, 8)
    with pytest.raises(ValueError, match="unknown activation"):
        hb.fused_hiera_stage(x, [()], 1, 8, act="relu")


# ----------------------------------------------------------------- Hiera --

HIERA = dict(embed_dim=16, num_heads=1, stages=(2, 3, 2, 1), global_att_blocks=(4,),
             window_spec=(4, 2, 4, 2), image_size=64)


@pytest.fixture
def jax_env(monkeypatch):
    """Sets JAX switches for one test, with clean trace caches around it."""
    jax.clear_caches()

    def set_env(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        jax.clear_caches()

    yield set_env
    jax.clear_caches()


@pytest.fixture(scope="module")
def hiera_pair():
    """A JAX Hiera (2, 3, 2, 1), its parameters (init plus seeded noise, so
    that zero-initialised leaves take part) and an input."""
    jm = JHiera(JHieraConfig(**HIERA), dtype=jnp.float32, param_dtype=jnp.float32)
    x = _randn(7, 1, 64, 64, 3)
    params = jax.jit(lambda k: jm.init(k, jnp.asarray(x))["params"])(jax.random.PRNGKey(1))
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(2)
    params = jax.tree.unflatten(treedef, [np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32) for a in leaves])
    return jm, params, x


@pytest.mark.parametrize("env,routing", [
    pytest.param(ENV_7A, ROUTING_7A, id="stage4-split-qpool-poly"),
    pytest.param({"UFVIDEO_HIERA_STAGE_NB": "2", "UFVIDEO_HIERA_GELU": "poly_bf16"},
                 VisionRouting(hiera_stage_nb=2, hiera_gelu="poly_bf16"), id="stage2-poly-bf16"),
])
def test_hiera_routing_matches_jax(hiera_pair, jax_env, env, routing):
    jm, params, x = hiera_pair
    jax_env(env)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, jnp.asarray(x))
    model = Hiera(SAM2HieraConfig(**HIERA), torch.float32, routing=routing).eval()
    load_by_name(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert ("stage" in model.call_routes()) == (routing.hiera_stage_nb > 1)
    assert ("qpool" in model.call_routes()) == routing.qpool_fused
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if routing.hiera_gelu == "poly_bf16":
            # the two sides round the polynomial's steps at other points
            # (XLA may keep one in f32), so GELU outputs sit up to two bf16
            # steps apart (test_polynomial_gelus_match_jax) and every later
            # value moves by a fraction of a percent
            d = np.abs(g - w)
            assert d.mean() < 1e-2 and d.max() < 0.05, (d.mean(), d.max())
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_float_generic_block_matches_jax():
    """A windowed block of 576 tokens takes the generic route in both
    packages (no shipped configuration has one)."""
    jb = JBlock(16, 16, 1, 4.0, None, 24, jnp.float32, jnp.float32)
    x = _randn(6, 2, 576, 16)
    params = _noisy(jb.init(jax.random.PRNGKey(6), jnp.asarray(x))["params"], 7)
    want = jb.apply({"params": params}, jnp.asarray(x))
    blk = MultiScaleBlock(16, 16, 1, 4.0, None, 24, torch.float32)
    assert blk.route == "generic"
    load_by_name(blk, _np_tree(params))
    with torch.no_grad():
        got = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_w8a8_hiera_generic_special_blocks_match_jax(jax_env):
    cfg = j_tiny_config().sam.hiera
    jm = JHiera(cfg, dtype=jnp.float32, param_dtype=jnp.float32)
    px = _randn(8, 2, 128, 128, 3)
    params = _noisy(jax.jit(lambda k: jm.init(k, jnp.asarray(px))["params"])(
        jax.random.PRNGKey(2)), 9)
    qparams = {k: (jq._quantize_dense_tree(v, jq.quantize_kernel) if k.startswith("blocks_")
                   else v) for k, v in params.items()}
    jq_model = JHiera(cfg, dtype=jnp.float32, param_dtype=jnp.float32, quant=True)
    jax_env({"UFVIDEO_SAM2_INT8_SPECIAL": "0"})
    want = jax.jit(lambda p, x: jq_model.apply({"params": p}, x))(qparams, jnp.asarray(px))
    model = Hiera(tiny_config().sam.hiera, torch.float32, quant=True,
                  routing=VisionRouting(sam2_int8_special=False)).eval()
    assert [b.route for b in model.blocks] == ["block", "generic", "generic", "generic",
                                               "generic"]
    load_by_name(model, _np_tree(qparams))
    before = tq.w8a8_linear.calls
    with torch.no_grad():
        got = model(torch.from_numpy(px))
    # 3 q-pool blocks: qkv, proj, shortcut, fc1, fc2; the global block: 4
    assert tq.w8a8_linear.calls - before == 3 * 5 + 4
    for stage, (g, w) in enumerate(zip(got, want)):
        _held(g, w, f"generic W8A8 Hiera, stage {stage}")


def test_stage_groups_follow_the_jax_grouping():
    """Runs of identical windowed blocks, at most nb long, never across a
    q-pool or a global block; Hiera-L's 36-block stage 3 splits at its
    globals (23, 33, 43)."""
    with torch.device("meta"):
        small = Hiera(SAM2HieraConfig(**HIERA), torch.float32,
                      routing=VisionRouting(hiera_stage_nb=4))
        from ufvideo_tpu_torch.configs import UFVideoConfig

        large = Hiera(UFVideoConfig().sam.hiera, torch.bfloat16,
                      routing=VisionRouting(hiera_stage_nb=4))
        large_q = Hiera(UFVideoConfig().sam.hiera, torch.bfloat16, quant=True,
                        routing=VisionRouting(hiera_stage_nb=4))
    assert small.groups == [[0, 1], [2], [3], [4], [5], [6], [7]]
    runs = [g for g in large.groups if len(g) > 1]
    assert [len(g) for g in runs] == [2, 4, 4, 4, 4, 2, 4, 4, 4, 4, 3]
    assert [g for g in large.groups if len(g) == 1 and large.blocks[g[0]].route == "block"] == [
        [7], [32], [42]]
    assert all(len(g) == 1 for g in large_q.groups)  # the W8A8 trunk is never grouped


# ------------------------------------------------------------------ slice --

def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


class _BF16LayerNormTower(j_siglip.SiglipVisionTower):
    """The JAX tower with ``ln_dtype=bf16``: its unfused float layer."""

    ln_dtype: object = jnp.bfloat16


@pytest.fixture(scope="module")
def runtimes_7a():
    """JAX and port runtimes on one tree, Hiera (2, 3, 2, 1) so that the
    stage fusion has a run to group; the JAX side under phase 7a's switches
    for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV_7A.items():
            mp.setenv(k, v)
        mp.setattr(j_ufvideo, "SiglipVisionTower", _BF16LayerNormTower)
        jax.clear_caches()
        jtok, jids = j_byte_tokenizer()
        jbase = j_tiny_config()
        jcfg = _with_ids(jbase, jids).replace(
            sam=dataclasses.replace(jbase.sam, hiera=JHieraConfig(**{**HIERA, "image_size": 128})))
        params = dict(jax.jit(j_ufvideo.UFVideoModel(jcfg).init_params)(jax.random.PRNGKey(0)))
        sam = JSAM2(jcfg.sam, dtype=jnp.float32, param_dtype=jnp.float32)
        params["sam"] = jax.jit(lambda k: sam.init(k, jnp.zeros((1, 128, 128, 3)))["params"])(
            jax.random.PRNGKey(1))
        jrt = JRuntime(jcfg, params, jids)
        tok, ids = byte_tokenizer_with_ids()
        base = tiny_config()
        cfg = _with_ids(base, ids).replace(sam=dataclasses.replace(
            base.sam, hiera=SAM2HieraConfig(**{**HIERA, "image_size": 128})))
        model = UFVideoModel.empty(cfg, "cpu", ROUTING_7A)
        load_jax_params(model, jax.tree.map(np.asarray, params))
        yield (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)
    jax.clear_caches()


def test_7a_runtime_takes_the_routing(runtimes_7a):
    _, (rt, _) = runtimes_7a
    assert all(not layer.fused and layer.ln_dtype == torch.bfloat16
               for layer in rt.model.vision.layers)
    routes = rt.model.sam.image_encoder_trunk.call_routes()
    assert routes == ["stage", "split", "block", "split", "split", "block", "split"]


def test_mm_infer_under_the_bf16_routing_matches_jax(runtimes_7a):
    (jrt, jtok), (rt, tok) = runtimes_7a
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    images_sam = rng.standard_normal((4, 128, 128, 3)).astype(np.float32)
    # greedy QA: the tokens of the unfused bf16-LN tower's video tokens
    got = mm_infer(frames, "What happens?", rt, tok, max_new_tokens=6)[1]["output"]
    want = j_mm_infer(frames, "What happens?", jrt, jtok, max_new_tokens=6)[1]["output"]
    assert list(got) == list(want)
    # [SEG] path B
    kw = dict(modal="video", choice=3, images_sam=images_sam, label_size=LABEL, seg=True)
    got = mm_infer(frames, CONV, rt, tok, **kw)["pred_masks"]
    want = j_mm_infer(frames, CONV, jrt, jtok, **kw)["pred_masks"]
    input_ids = _assemble_input_ids(CONV, 3, DEFAULT_VIDEO_TOKEN, tok)
    hidden, plan = rt.forward_hidden_states(input_ids, rt.encode_video(
        torch.from_numpy(frames)[None]))
    pos = [int(plan.text_pos_map[0][i]) - 1 for i, t in enumerate(input_ids) if t == rt.ids.seg]
    embeds = rt.model.seg_embeddings(hidden[0, pos])
    feats = encode_video_frames(rt.model.sam, torch.from_numpy(images_sam))
    low = propagate_video(rt.model.sam, feats, embeds[:, None, :])
    logits = resize_hw(low.float(), *LABEL, "bilinear")[:, :, 0].permute(1, 0, 2, 3).numpy()
    assert len(got) == len(want) == 1
    band = np.abs(logits[0]) < BAND
    print(f"7a path B: {int(band.sum())} of {band.size} pixels within {BAND}, "
          f"{int((got[0] != want[0]).sum())} differ")
    assert (got[0] == want[0])[~band].all()
    assert band.mean() < 0.01 and 0.0 < want[0].mean() < 1.0
