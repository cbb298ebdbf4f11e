"""Quantised ``[SEG]`` segmentation and the batched-videos entry point
against the JAX package, on ``tiny_config()`` (float32, CPU, image 128).

Quantised trunk: the JAX float tree (random init plus seeded noise on every
leaf) is quantised by ``ufvideo_tpu.quant.quantize_sam2_params`` and carried
across by the port's loader. Off the TPU the JAX W8A8 kernels run their XLA
references, which quantise at the kernels' points; the port's plain versions
quantise at the same points from the same f32 values, so on the same input
one block agrees to f32 summation order, except where a value sits on a
rounding boundary and flips one int8 step: each block is held on the port's
own input to it (``BULK`` of the elements within ``TIGHT``, every element
within ``STEP``). A flip in an early block moves every later activation a
little (the LayerNorms and the global attention spread it), so the trunk and
FPN outputs as a whole are held on their mean difference (``MEAN``, about 2%
of their rms) and every element within ``STEP``. Masks must be equal
wherever the upsampled logit is further than ``BAND`` from the threshold 0
(the logits differ by up to 0.013 on these inputs; with random weights they
are small, rms 0.5, so up to ``IN_BAND`` of the pixels may lie inside).

``segment_videos_batched`` on the quantised runtimes: masks equal to
``segment_video`` on each video alone, and to JAX's outside the band. The
float predictors are held in ``tests/test_torch_seg_predictors.py``.
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
from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch import quant as tq
from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids, mm_infer
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.constants import DEFAULT_VIDEO_TOKEN
from ufvideo_tpu_torch.models.sam2 import SAM2
from ufvideo_tpu_torch.models.sam2 import video as tvideo
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.ops.interp import resize_hw
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.weights import load_by_name, load_jax_params

TOL = 2e-4  # float model: f32 sums in another order (as tests/test_torch_sam2.py)
TIGHT, BULK = 1e-4, 0.95  # one quantised block: the share of elements that agree closely
STEP = 0.25  # ... and the most flipped int8 steps move any element (values of order 1-10)
MEAN = 0.05  # whole quantised trunk: mean absolute difference (activations of rms 1.4-2.6)
BAND = 0.05  # quantised masks: logits closer than this to 0 may threshold either way
IN_BAND = 0.25  # ... and the largest share of pixels that may lie that close
LABEL = (48, 64)
CONV = [
    {"from": "human", "value": "<video>\nPlease segment the cat."},
    {"from": "gpt", "value": "It is [SEG]."},
]


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy_sam_params(jcfg):
    """SAM2's random init plus seeded noise on every leaf, so that leaves
    that start at zero take part."""
    jm = JSAM2(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax_init.sam2_params(jcfg, 1)
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(leaf) + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
              for leaf in leaves]
    return jm, jax.tree.unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def float_pair():
    """(JAX SAM2, its parameters, the port's SAM2 with the same weights)."""
    jm, params = _noisy_sam_params(j_tiny_config().sam)
    model = SAM2(tiny_config().sam, dtype=torch.float32).eval()
    load_by_name(model, params)
    return jm, params, model


@pytest.fixture(scope="module")
def quant_pair(float_pair):
    """The same weights with the trunk quantised by the JAX function."""
    _, params, _ = float_pair
    qparams = jq.quantize_sam2_params(params)
    jmq = JSAM2(j_tiny_config().sam, dtype=jnp.float32, param_dtype=jnp.float32, quant=True)
    model = SAM2(tiny_config().sam, dtype=torch.float32, quant=True).eval()
    load_by_name(model, _np_tree(qparams))
    return jmq, qparams, model


def _held(got, want, what, bulk=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    close = diff <= TIGHT + TIGHT * np.abs(want)
    print(f"{what}: {close.mean():.5f} within {TIGHT}, mean difference {diff.mean():.5f}, "
          f"largest {diff.max():.4f}, on values of rms {np.sqrt((want ** 2).mean()):.2f}")
    if bulk:
        assert close.mean() > BULK
    assert diff.mean() < MEAN
    assert diff.max() < STEP


# ---------------------------------------------------------------- quant.py --

def test_quantize_sam2_params_equals_jax(float_pair):
    """Integers and scales, value for value; only the trunk's blocks change."""
    _, params, _ = float_pair
    want = _np_tree(jq.quantize_sam2_params(params))
    got = tq.quantize_sam2_params(_np_tree(params))
    assert set(got) == set(want)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    n_q = 0
    for (path, g), (_, w) in zip(flat_g, flat_w):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
        n_q += g.dtype == np.int8
    # tiny Hiera: 5 blocks x (qkv, proj, fc1, fc2) + 3 width-changing shortcuts
    assert n_q == 23
    names = ["/".join(k.key for k in path) for path, _ in flat_g]
    assert "image_encoder_neck/convs_0/kernel" in names
    assert any(n.startswith("image_encoder_trunk/patch_embed/") and n.endswith("/kernel")
               or n == "image_encoder_trunk/patch_embed/kernel" for n in names)
    assert not any(n.endswith("kernel_q") and "/blocks_" not in n for n in names)


def test_quantised_loader_fills_the_holders_and_names_a_float_leaf(float_pair, quant_pair):
    _, params, _ = float_pair
    _, qparams, model = quant_pair
    blk = model.image_encoder_trunk.blocks[1]
    want = qparams["image_encoder_trunk"]["blocks_1"]
    assert blk.proj.kernel_q.dtype == torch.int8
    np.testing.assert_array_equal(blk.proj.kernel_q.numpy(), np.asarray(want["proj"]["kernel_q"]))
    np.testing.assert_array_equal(
        blk.attn.qkv.kernel_scale.numpy(), np.asarray(want["attn"]["qkv"]["kernel_scale"]))
    fresh = SAM2(tiny_config().sam, dtype=torch.float32, quant=True)
    with pytest.raises(KeyError, match=r"image_encoder_trunk\.blocks_0\.attn\.(proj|qkv) has kernel"):
        load_by_name(fresh, params)
    with pytest.raises(KeyError, match="kernel_q"):
        load_by_name(SAM2(tiny_config().sam, dtype=torch.float32), _np_tree(qparams))


def test_quantised_block_folds_the_shortcut_into_the_front_exactly(quant_pair):
    """int8 columns, scales and biases of the width-changing shortcut follow
    the qkv columns unchanged; the kernel-ready tuple is built once."""
    blk = quant_pair[2].image_encoder_trunk.blocks[1]
    assert blk.route == "qpool" and blk.quant
    p = blk._kernel_params()
    assert p is blk._kernel_params() and len(p) == 16
    hw = blk.num_heads * blk.head_dim
    assert p[2].dtype == torch.int8 and tuple(p[2].shape) == (blk.dim, 3 * hw + blk.dim_out)
    assert torch.equal(p[2][:, 3 * hw:], blk.proj.kernel_q)
    assert torch.equal(p[3][3 * hw:], blk.proj.kernel_scale)
    assert torch.equal(p[4][:3 * hw], blk.attn.qkv.bias.float())


# ------------------------------------------------------------------ trunk --

@pytest.fixture(scope="module")
def images():
    return _randn(0, 2, 128, 128, 3)


@pytest.fixture(scope="module")
def quant_trunk_outputs(quant_pair, images):
    jmq, qparams, model = quant_pair
    want = jmq.apply({"params": qparams}, jnp.asarray(images), method=lambda m, x: m.trunk(x))
    with torch.no_grad():
        got = model.image_encoder_trunk(torch.from_numpy(images))
    return got, want


@pytest.mark.parametrize("index,route", enumerate(["block", "qpool", "split", "qpool", "qpool"]))
def test_quantised_block_matches_the_jax_block_on_the_same_input(quant_pair, images, index,
                                                                 route):
    """Each block of the port's quantised trunk against the JAX
    ``MultiScaleBlock(quant=True)`` on the input the port's trunk gave it:
    every W8A8 route (whole block, q-pool, and the global block's front,
    attention and tail) with JAX's quantised parameters."""
    from ufvideo_tpu.models.sam2.hiera import MultiScaleBlock as JBlock

    _, qparams, model = quant_pair
    blk = model.image_encoder_trunk.blocks[index]
    assert blk.route == route and blk.quant
    seen = {}
    hook = blk.register_forward_hook(lambda m, args, out: seen.update(x=args[0], out=out))
    with torch.no_grad():
        model.image_encoder_trunk(torch.from_numpy(images))
    hook.remove()
    jblk = JBlock(blk.dim, blk.dim_out, blk.num_heads, 4.0, blk.q_stride, blk.window_side,
                  jnp.float32, jnp.float32, 0, True)
    want = jblk.apply({"params": qparams["image_encoder_trunk"][f"blocks_{index}"]},
                      jnp.asarray(seen["x"].numpy()))
    _held(seen["out"], want, f"block {index} ({route})", bulk=True)


@pytest.mark.parametrize("stage", range(4))
def test_quantised_hiera_stage_outputs_match(quant_trunk_outputs, stage):
    """Every W8A8 route is on the way to some output: stage 0 ends after the
    whole block, stages 1-3 after q-pool blocks, the global block (front,
    attention, tail) sits inside stage 1."""
    got, want = quant_trunk_outputs
    side, dim = 32 >> stage, 16 << stage
    assert tuple(got[stage].shape) == (2, side, side, dim)
    _held(got[stage], want[stage], f"stage {stage}")


def test_quantised_trunk_differs_from_the_float_trunk(float_pair, quant_trunk_outputs, images):
    """The comparison above is not one of two float trunks."""
    with torch.no_grad():
        flt = float_pair[2].image_encoder_trunk(torch.from_numpy(images))
    diff = (quant_trunk_outputs[0][3] - flt[3]).abs().max()
    assert 1e-3 < float(diff) < 1.0


def test_quantised_sam2_fpn_features_match(quant_pair, images):
    jmq, qparams, model = quant_pair
    want = jmq.apply({"params": qparams}, jnp.asarray(images), method=JSAM2.forward_image)
    with torch.no_grad():
        got = model.forward_image(torch.from_numpy(images))
    for level, (g, w) in enumerate(zip(got["backbone_fpn"], want["backbone_fpn"])):
        _held(g, w, f"fpn level {level}")


# ------------------------------------------------------- the slice as a whole --

def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


def _on_fused_route(fn):
    """Run a stage of the JAX runtime with the W8A8 SigLIP tower on its fused
    route (``fused_block_w8a8`` in interpret mode): off the TPU the tower
    would take its unfused branch, which quantises at other points."""
    import ufvideo_tpu.models.siglip as sig
    import ufvideo_tpu.ops.hiera_block as hb

    real = hb.fused_block_w8a8

    def wrapped(*args):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(hb, "fused_block_w8a8",
                      lambda x, p, h, d, interpret=False, **kw: real(
                          x, p, h, d, interpret=True, **kw))
            m.setattr(sig.jax, "default_backend", lambda: "tpu")
            return jax.block_until_ready(fn(*args))

    return wrapped


RUNTIME_CASES = {
    "quant-vision": dict(quant_vision=True),
    "serving": dict(quant_llm="int8", quant_kv=True, quant_vision=True),
}


@pytest.fixture(scope="module")
def float_model_params():
    """The composite's float parameters, initialised (and so compiled) once
    for both runtime cases."""
    _, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    return dict(jax_init.model_params(jcfg, 0))


@pytest.fixture(scope="module", params=list(RUNTIME_CASES))
def quant_runtimes(request, float_pair, float_model_params):
    """JAX float parameters quantised by the JAX functions, a JAX runtime on
    them and the port's runtime loaded from the same tree."""
    kw = RUNTIME_CASES[request.param]
    jtok, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    params = dict(float_model_params)
    params["sam"] = jq.quantize_sam2_params(float_pair[1])
    params["vision"] = jq.quantize_vision_params(params["vision"])
    if kw.get("quant_llm"):
        params["llm"] = jq.quantize_qwen2_params(params["llm"], bits=8)
    jrt = JRuntime(jcfg.replace(**kw), params, jids)
    jrt._encode_video = _on_fused_route(jrt._encode_video)
    tok, ids = byte_tokenizer_with_ids()
    cfg = _with_ids(tiny_config(), ids).replace(**kw)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, _np_tree(params))
    return request.param, (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)


def _inputs(seed, t_sam=4):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    images_sam = rng.standard_normal((t_sam, 128, 128, 3)).astype(np.float32)
    return frames, images_sam


def _assert_masks_equal_outside_band(got, want, logits, what):
    """``logits`` [n_obj, T, H, W]: the port's upsampled mask logits."""
    assert len(got) == len(want) == logits.shape[0]
    for g, w, lg in zip(got, want, logits):
        assert g.dtype == np.bool_ and g.shape == w.shape == lg.shape
        band = np.abs(lg) < BAND
        print(f"{what}: {int(band.sum())} of {band.size} pixels within {BAND} of the "
              f"threshold, {int((g != w).sum())} differ, foreground share {w.mean():.3f}")
        assert (g == w)[~band].all()
        assert band.mean() < IN_BAND
        assert 0.0 < w.mean() < 1.0  # neither empty nor full


def _logits_at_label_size(rt, embeds, images_sam, label):
    feats = tvideo.encode_video_frames(rt.model.sam, torch.from_numpy(images_sam))
    low = tvideo.propagate_video(rt.model.sam, feats, embeds[:, None, :])
    return resize_hw(low.float(), *label, "bilinear")[:, :, 0].permute(1, 0, 2, 3).numpy()


def test_quantised_runtime_builds_a_quantised_sam2(quant_runtimes):
    _, _, (rt, _) = quant_runtimes
    sam = rt.model.sam
    assert sam.quant and sam.image_encoder_trunk.quant
    assert all(blk.quant for blk in sam.image_encoder_trunk.blocks)
    assert sam.image_encoder_trunk.blocks[0].mlp_layers_0.kernel_q.dtype == torch.int8
    assert sam.image_encoder_neck.convs[0].weight.dtype == torch.float32
    assert sam.memory_attention.layers[0].linear1.weight.dtype == torch.float32


def test_segment_video_on_a_quantised_runtime_matches_jax(quant_runtimes):
    name, (jrt, _), (rt, _) = quant_runtimes
    _, images_sam = _inputs(31)
    embeds = _randn(32, 2, 32)
    want = jrt.segment_video(images_sam, jnp.asarray(embeds), *LABEL)
    got = rt.segment_video(images_sam, torch.from_numpy(embeds), *LABEL)
    assert got.shape == want.shape == (2, 4, *LABEL) and got.dtype == np.bool_
    logits = _logits_at_label_size(rt, torch.from_numpy(embeds), images_sam, LABEL)
    _assert_masks_equal_outside_band(list(got), list(want), logits, f"segment_video {name}")


def test_mm_infer_path_b_on_a_quantised_runtime_matches_jax(quant_runtimes):
    name, (jrt, jtok), (rt, tok) = quant_runtimes
    frames, images_sam = _inputs(33)
    kw = dict(modal="video", choice=3, images_sam=images_sam, label_size=LABEL, seg=True)
    want = j_mm_infer(frames, CONV, jrt, jtok, **kw)
    got = mm_infer(frames, CONV, rt, tok, **kw)
    assert got["output"] is None and len(got["pred_masks"]) == 1
    input_ids = _assemble_input_ids(CONV, 3, DEFAULT_VIDEO_TOKEN, tok)
    feats = rt.encode_video(torch.from_numpy(frames)[None])
    hidden, plan = rt.forward_hidden_states(input_ids, feats)
    pos = [int(plan.text_pos_map[0][i]) - 1 for i, t in enumerate(input_ids) if t == rt.ids.seg]
    embeds = rt.model.seg_embeddings(hidden[0, pos])
    logits = _logits_at_label_size(rt, embeds, images_sam, LABEL)
    _assert_masks_equal_outside_band(
        got["pred_masks"], want["pred_masks"], logits, f"path B {name}")


def test_path_a_extraction_on_a_quantised_runtime_matches_jax(quant_runtimes):
    """Path A: generate (int8 LM and int8 KV cache in the serving case; the
    tokens are JAX's), plant ``[SEG]`` at one step, segment from that step's
    hidden state."""
    from ufvideo_tpu_torch.api import seg_masks_of_generation

    name, (jrt, jtok), (rt, tok) = quant_runtimes
    frames, images_sam = _inputs(34, t_sam=3)
    input_ids = _assemble_input_ids("Where is the cat?", 1, DEFAULT_VIDEO_TOKEN, tok)
    tokens, hidden, _ = rt.generate(
        input_ids, rt.encode_video(torch.from_numpy(frames)[None]), max_new_tokens=4)
    jtokens, jhidden, _ = jrt.generate(
        input_ids, jrt.encode_video(jnp.asarray(frames)[None]), None, None, max_new_tokens=4)
    assert tokens == list(jtokens)
    planted = list(tokens)
    planted[2] = rt.ids.seg
    got = seg_masks_of_generation(rt, planted, hidden, images_sam, LABEL)
    jembeds = jrt._seg_embed(jrt.params, jhidden[jnp.asarray([2])])
    want = jrt.segment_video(images_sam, jembeds, *LABEL)
    logits = _logits_at_label_size(
        rt, rt.model.seg_embeddings(hidden[[2]]), images_sam, LABEL)
    _assert_masks_equal_outside_band(got, list(want), logits, f"path A {name}")


# ------------------------------------------------------------ batched videos --

def test_segment_videos_batched_equals_per_video_calls(quant_runtimes):
    """The entry point on the quantised runtime: [V, T, H, W] masks equal to
    ``segment_video`` on each video alone, and to JAX's outside the band."""
    name, (jrt, _), (rt, _) = quant_runtimes
    videos = _randn(52, 2, 3, 128, 128, 3)
    embeds = torch.from_numpy(_randn(53, 2, 32))
    got = rt.segment_videos_batched(videos, embeds, *LABEL)
    assert got.shape == (2, 3, *LABEL) and got.dtype == np.bool_
    for i in range(2):
        alone = rt.segment_video(videos[i], embeds[i:i + 1], *LABEL)[0]
        assert (got[i] != alone).mean() < 1e-3
    want = jrt.segment_videos_batched(videos, jnp.asarray(embeds.numpy()), *LABEL)
    logits = np.stack([
        _logits_at_label_size(rt, embeds[i:i + 1], videos[i], LABEL)[0] for i in range(2)])
    _assert_masks_equal_outside_band(list(got), list(want), logits, f"batched {name}")
