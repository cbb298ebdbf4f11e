"""The vision towers' other routings against the JAX package, on the CPU
(``tiny_config()`` sizes, float32).

- ``W8A8Linear`` against the JAX ``W8A8Dense``: equal (same quantiser, exact
  integer sums, the same rescale).
- The unfused SigLIP layers: the float layer with a bf16 LayerNorm
  (``SiglipVisionTower(ln_dtype=bf16)``) to ``TOL``; the W8A8 layer (the JAX
  int8 tower takes it off the TPU) on the measure of ``_held``.
- ``MultiScaleAttention`` on its four branches (q-stride, global, windowed
  with at most 512 tokens → ``fused_window_attention``, larger windows),
  float to ``TOL`` and W8A8 on ``_held`` (the routed Hiera trunks:
  ``tests/test_torch_stage.py``).
- One JAX tree loads into every routing, parameter for parameter.
- The slice: ``mm_infer`` ``[SEG]`` path B and greedy QA under the routing
  of ``chip_smoke.py`` phase 7b (int8 serving configuration, unfused W8A8
  SigLIP, generic W8A8 special blocks) against JAX with the same switches:
  tokens equal, masks equal outside ``BAND`` of the threshold.

W8A8 measure (``_held``, as ``tests/test_torch_seg_quant.py`` holds its
trunk): both sides quantise the same f32 values at the same points, so
values agree to f32 order except where one sits on a rounding boundary and
flips an int8 step; ``BULK`` of the elements within ``TIGHT``, the mean
difference below ``MEAN`` and every element within ``STEP``. The JAX
package reads its switches at trace time: each JAX side is traced after its
variables are set, with ``jax.clear_caches()`` around it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_init as jax_init

from ufvideo_tpu import quant as jq
from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models import siglip as j_siglip
from ufvideo_tpu.models.sam2 import hiera as j_hiera
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch import quant as tq
from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids, mm_infer
from ufvideo_tpu_torch.configs import VisionRouting, tiny_config
from ufvideo_tpu_torch.constants import DEFAULT_VIDEO_TOKEN
from ufvideo_tpu_torch.models.sam2 import hiera as t_hiera
from ufvideo_tpu_torch.models.sam2.video import encode_video_frames, propagate_video
from ufvideo_tpu_torch.models.siglip import SiglipVisionTower
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.ops.interp import resize_hw
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.weights import load_by_name, load_jax_params, load_siglip

TOL = 1e-5
TIGHT, BULK, MEAN, STEP = 1e-4, 0.95, 0.05, 0.25
BAND, IN_BAND = 0.05, 0.25  # W8A8 masks: as tests/test_torch_seg_quant.py
LABEL = (48, 64)
CONV = [
    {"from": "human", "value": "<video>\nPlease segment the cat."},
    {"from": "gpt", "value": "It is [SEG]."},
]
# chip_smoke.py phase 7b
ROUTING_7B = VisionRouting(siglip_int8_fused=False, sam2_int8_special=False)
SERVING = dict(quant_llm="int8", quant_kv=True, quant_vision=True)


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
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    close = diff <= TIGHT + TIGHT * np.abs(want)
    print(f"{what}: {close.mean():.5f} within {TIGHT}, mean difference {diff.mean():.6f}, "
          f"largest {diff.max():.4f}")
    assert close.mean() > BULK
    assert diff.mean() < MEAN
    assert diff.max() < STEP


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


# ---------------------------------------------------------------- quant.py --

@pytest.mark.parametrize("shape", [(5, 24), (2, 3, 40)])
def test_w8a8_linear_equals_jax_w8a8_dense(shape):
    din, dout = shape[-1], 48
    x = 3 * _randn(0, *shape)
    w = _randn(1, din, dout) * 0.2
    dense = jq.W8A8Dense(dout, dtype=jnp.float32)
    params = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    qd = jq.quantize_kernel(jnp.asarray(w))
    params = {"kernel_q": qd["q"], "kernel_scale": qd["scale"], "bias": jnp.asarray(_randn(2, dout))}
    want = np.asarray(dense.apply({"params": params}, jnp.asarray(x)))
    lin = tq.W8A8Linear(din, dout, torch.float32)
    load_by_name(lin, _np_tree(params))
    before = tq.w8a8_linear.calls
    got = lin(torch.from_numpy(x))
    assert tq.w8a8_linear.calls == before + 1
    np.testing.assert_array_equal(got.detach().numpy(), want)


# ------------------------------------------------------------------ SigLIP --

@pytest.fixture(scope="module")
def vision_params():
    jcfg = j_tiny_config()
    params = jax.jit(JUFVideoModel(jcfg).init_params)(jax.random.PRNGKey(1))
    return _noisy(params["vision"], 3)


def test_unfused_bf16_layernorm_siglip_matches_jax(vision_params):
    jcfg = j_tiny_config()
    jt = j_siglip.SiglipVisionTower(jcfg.vision, dtype=jnp.float32, param_dtype=jnp.float32,
                                    ln_dtype=jnp.bfloat16)
    px = _randn(4, 3, 56, 56, 3)
    want = np.asarray(jax.jit(lambda p, x: jt.apply({"params": p}, x))(
        vision_params, jnp.asarray(px)))
    tower = SiglipVisionTower(tiny_config().vision, torch.float32,
                              routing=VisionRouting(siglip_ln_dtype="bf16"))
    assert all(not layer.fused for layer in tower.layers)
    load_siglip(tower, vision_params)
    with torch.no_grad():
        got = tower(torch.from_numpy(px)).numpy()
    # LayerNorm outputs round to bf16 on both sides: a sum taken in another
    # order may land one bf16 step apart, rarely
    close = np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want)
    print(f"bf16-LN tower: {close.mean():.5f} within 1e-4, largest {np.abs(got - want).max()}")
    assert close.mean() > 0.99 and np.abs(got - want).max() < 0.05
    fused = SiglipVisionTower(tiny_config().vision, torch.float32)
    load_siglip(fused, vision_params)
    with torch.no_grad():
        assert (fused(torch.from_numpy(px)) - torch.from_numpy(got)).abs().max() > 1e-4


def test_unfused_w8a8_siglip_matches_jax(vision_params):
    jcfg = j_tiny_config()
    qparams = jq.quantize_vision_params(vision_params)
    jt = j_siglip.SiglipVisionTower(jcfg.vision, dtype=jnp.float32, param_dtype=jnp.float32,
                                    quant=True)
    px = _randn(5, 3, 56, 56, 3)
    # off the TPU the JAX W8A8 tower takes its unfused branch
    want = jax.jit(lambda p, x: jt.apply({"params": p}, x))(qparams, jnp.asarray(px))
    tower = SiglipVisionTower(tiny_config().vision, torch.float32, quant=True,
                              routing=VisionRouting(siglip_int8_fused=False))
    assert all(not layer.fused and layer.quant for layer in tower.layers)
    load_siglip(tower, _np_tree(qparams))
    before = tq.w8a8_linear.calls
    with torch.no_grad():
        got = tower(torch.from_numpy(px))
    assert tq.w8a8_linear.calls - before == 4 * len(tower.layers)
    _held(got, want, "unfused W8A8 tower")


# ----------------------------------------------------- MultiScaleAttention --

MSA_CASES = [
    # dim, dim_out, heads, window side, q-stride, tokens a window
    pytest.param(16, 32, 2, 4, (2, 2), 16, id="q-stride"),
    pytest.param(32, 32, 2, 0, None, 64, id="global"),
    pytest.param(32, 32, 2, 4, None, 16, id="window-kernel"),
    pytest.param(16, 16, 1, 24, None, 576, id="window-over-512"),
]


def _msa_pair(dim, dim_out, heads, side, q_stride, s, quant):
    jm = j_hiera.MultiScaleAttention(dim_out, heads, side, q_stride, jnp.float32, jnp.float32)
    x = _randn(side + heads, 3, s, dim)
    params = _noisy(jm.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"], 5)
    if quant:
        params = jq._quantize_dense_tree(params, jq.quantize_kernel)
        jm = j_hiera.MultiScaleAttention(dim_out, heads, side, q_stride, jnp.float32,
                                         jnp.float32, 0, True)
    msa = t_hiera.MultiScaleAttention(dim, dim_out, heads, side, q_stride, torch.float32, quant)
    load_by_name(msa, _np_tree(params))
    return jm, params, msa, x


@pytest.mark.parametrize("quant", [False, True], ids=["float", "w8a8"])
@pytest.mark.parametrize("dim,dim_out,heads,side,q_stride,s", MSA_CASES)
def test_multiscale_attention_branches_match_jax(dim, dim_out, heads, side, q_stride, s, quant):
    from ufvideo_tpu_torch.ops.window_attention import fused_window_attention

    jm, params, msa, x = _msa_pair(dim, dim_out, heads, side, q_stride, s, quant)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = msa(torch.from_numpy(x))
    assert fused_window_attention.launches == 0  # CPU tensors take the plain version
    assert got.shape == (3, s // (4 if q_stride else 1), dim_out)
    if quant:
        _held(got, want, f"W8A8 MultiScaleAttention {side} {q_stride}")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_window_branch_runs_the_window_kernel_wrapper(monkeypatch):
    """The windowed branch with at most 512 tokens goes through
    ``fused_window_attention`` (its plain version with ``use_kernels`` off)."""
    import ufvideo_tpu_torch.models.sam2.hiera as mod

    seen = []
    real = mod.fused_window_attention
    monkeypatch.setattr(mod, "fused_window_attention",
                        lambda *a: seen.append(a[0].shape) or real(*a))
    _, _, msa, x = _msa_pair(32, 32, 2, 4, None, 16, False)
    with torch.no_grad():
        msa(torch.from_numpy(x))
    assert seen == [(3, 16, 96)]


def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


@pytest.fixture(scope="module")
def jax_tree():
    """A JAX UFVideo tree with SAM2 (seeded noise on SAM2's leaves) and the
    byte tokenizer's ids."""
    jtok, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    params = dict(jax_init.model_params(jcfg, 0))
    params["sam"] = _noisy(jax_init.sam2_params(jcfg.sam, 1), 1)
    return jcfg, jtok, jids, params


def _quantised(params):
    """The serving configuration's tree, quantised by the JAX functions."""
    params = dict(params)
    params["sam"] = jq.quantize_sam2_params(params["sam"])
    params["vision"] = jq.quantize_vision_params(params["vision"])
    params["llm"] = jq.quantize_qwen2_params(params["llm"], bits=8)
    return params


ROUTINGS = [VisionRouting(), VisionRouting(siglip_ln_dtype="bf16", qpool_fused=False,
                                           hiera_stage_nb=4, hiera_gelu="poly"),
            ROUTING_7B, VisionRouting(sam2_int8_special=False, siglip_int8_fused=False,
                                      hiera_stage_nb=3, qpool_fused=False)]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "quantised"])
def test_one_jax_tree_loads_into_every_routing(jax_tree, quant):
    """The fused and the unfused holders share names: the same tree fills
    every routing's modules, and every routing holds the same tensors."""
    _, _, _, params = jax_tree
    cfg = tiny_config()
    if quant:
        params = _quantised(params)
        cfg = cfg.replace(**SERVING)
    params = _np_tree(params)
    states = []
    for routing in ROUTINGS:
        model = load_jax_params(UFVideoModel.empty(cfg, "cpu", routing), params)
        # flax creates the mask-prompt convolutions lazily: not in the tree
        states.append({k: v for k, v in model.state_dict().items()
                       if "mask_downscaling" not in k})
    for state in states[1:]:
        assert state.keys() == states[0].keys()
        for k in state:
            torch.testing.assert_close(state[k], states[0][k], rtol=0, atol=0)


@pytest.mark.parametrize("routing", ROUTINGS)
def test_unfused_w8a8_weights_lie_k_contiguous(routing):
    """An int8 weight that ``w8a8_linear`` reads lies K-contiguous, as
    ``torch._int_mm`` takes it (no copy a call); one that a fused kernel
    reads stays row-major."""
    model = UFVideoModel.empty(tiny_config().replace(**SERVING), "cpu", routing)
    trunk = model.sam.image_encoder_trunk
    want = {f"vision.layers.{i}.{n}_kernel" for i in range(len(model.vision.layers))
            for n in ("qkv", "out", "fc1", "fc2") if not routing.siglip_int8_fused}
    want |= {f"sam.image_encoder_trunk.blocks.{i}.{n}.kernel_q"
             for i, b in enumerate(trunk.blocks) if b.route == "generic"
             for n in ("attn.qkv", "attn.proj", "mlp_layers_0", "mlp_layers_1", "proj")
             if n != "proj" or b.dim != b.dim_out}
    int8 = {k: v for k, v in model.state_dict().items()
            if v.dtype == torch.int8 and ("vision." in k or "trunk." in k)}
    assert want <= int8.keys()
    for k, v in int8.items():
        assert (v.stride() == (1, v.shape[0])) == (k in want), k
        assert (v.stride() == (v.shape[1], 1)) == (k not in want), k


# ------------------------------------------------------------------ slice --

@pytest.fixture(scope="module")
def runtimes_7b(jax_tree):
    """The serving configuration on JAX-quantised weights; the JAX side with
    ``UFVIDEO_SAM2_INT8_SPECIAL=0`` for the whole module (off the TPU its
    W8A8 SigLIP takes the unfused branch by itself)."""
    jcfg, jtok, jids, params = jax_tree
    params = _quantised(params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UFVIDEO_SAM2_INT8_SPECIAL", "0")
        jax.clear_caches()
        jrt = JRuntime(jcfg.replace(**SERVING), params, jids)
        tok, ids = byte_tokenizer_with_ids()
        cfg = _with_ids(tiny_config(), ids).replace(**SERVING)
        model = UFVideoModel.empty(cfg, "cpu", ROUTING_7B)
        load_jax_params(model, _np_tree(params))
        yield (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)
    jax.clear_caches()


def test_mm_infer_under_the_w8a8_routing_matches_jax(runtimes_7b):
    (jrt, jtok), (rt, tok) = runtimes_7b
    assert all(not layer.fused for layer in rt.model.vision.layers)
    assert rt.model.sam.image_encoder_trunk.call_routes() == [
        "block", "generic", "generic", "generic", "generic"]
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    images_sam = rng.standard_normal((4, 128, 128, 3)).astype(np.float32)
    got = mm_infer(frames, "What happens?", rt, tok, max_new_tokens=6)[1]["output"]
    want = j_mm_infer(frames, "What happens?", jrt, jtok, max_new_tokens=6)[1]["output"]
    assert list(got) == list(want)
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
    print(f"7b path B: {int(band.sum())} of {band.size} pixels within {BAND}, "
          f"{int((got[0] != want[0]).sum())} differ, foreground share {want[0].mean():.3f}")
    assert (got[0] == want[0])[~band].all()
    assert band.mean() < IN_BAND and 0.0 < want[0].mean() < 1.0
