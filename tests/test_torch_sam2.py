"""The port's SAM2 (Hiera trunk, FPN, prompt encoder + mask decoder, memory
encoder, memory attention, video propagation) against the JAX package,
module by module, on ``tiny_config()`` weights (float32, CPU, image 128:
every window side divides its stage grid).

The JAX tree is SAM2's random init plus seeded noise on every leaf, so that
zero-initialised leaves (position embeddings, biases, layer scale) take
part. In float32 the JAX trunk takes its unfused branches and the port the
plain versions of its kernels: the same function, summed in another order.
Tolerance 2e-4 absolute and relative on activations of order 1-10 (the
largest difference seen is under 1e-5); masks must be equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_init as jax_init

from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.models.sam2 import hiera as j_hiera
from ufvideo_tpu.models.sam2.video import encode_video_frames as j_encode_video_frames
from ufvideo_tpu.models.sam2.video import masks_to_video_res as j_masks_to_video_res
from ufvideo_tpu.models.sam2.video import propagate_video as j_propagate_video
from ufvideo_tpu.ops import interp as j_interp
from ufvideo_tpu.ops import rope as j_rope
from ufvideo_tpu.ops.image_pipeline import sam_preprocess_device as j_sam_preprocess
from ufvideo_tpu_torch.configs import SAM2HieraConfig, UFVideoConfig, tiny_config
from ufvideo_tpu_torch.models.sam2 import SAM2
from ufvideo_tpu_torch.models.sam2 import hiera as t_hiera
from ufvideo_tpu_torch.models.sam2.video import (
    encode_video_frames,
    masks_to_video_res,
    propagate_video,
)
from ufvideo_tpu_torch.ops import interp as t_interp
from ufvideo_tpu_torch.ops import rope as t_rope
from ufvideo_tpu_torch.ops.image_pipeline import sam_preprocess_device
from ufvideo_tpu_torch.weights import load_by_name

TOL = 2e-4


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(x)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def pair():
    """(JAX SAM2, its variables, the port's SAM2 with the same weights)."""
    jcfg = j_tiny_config().sam
    jm = JSAM2(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax_init.sam2_params(jcfg, 1)
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    leaves = [
        np.asarray(leaf) + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        for leaf in leaves
    ]
    params = jax.tree.unflatten(treedef, leaves)
    model = SAM2(tiny_config().sam, dtype=torch.float32).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    load_by_name(model, params)
    return jm, {"params": params}, model


@pytest.fixture(scope="module")
def images():
    return _randn(0, 2, 128, 128, 3)


@pytest.fixture(scope="module")
def trunk_outputs(pair, images):
    jm, variables, model = pair
    want = jm.apply(variables, jnp.asarray(images), method=lambda m, x: m.trunk(x))
    with torch.no_grad():
        got = model.image_encoder_trunk(torch.from_numpy(images))
    return got, want


@pytest.mark.parametrize("stage", range(4))
def test_hiera_trunk_stage_outputs_match(trunk_outputs, stage):
    """Stage 0 ends after a windowed block, stages 1, 2 and 3 after q-pool
    blocks, with the global block inside stage 1: every routing of the port
    is on the way to some output."""
    got, want = trunk_outputs
    side, dim = 32 >> stage, 16 << stage
    assert len(got) == len(want) == 4
    assert tuple(got[stage].shape) == (2, side, side, dim)
    _close(got[stage], want[stage])


def test_hiera_tiny_routes_cover_every_kernel_route(pair):
    model = pair[2]
    routes = [blk.route for blk in model.image_encoder_trunk.blocks]
    assert routes == ["block", "qpool", "split", "qpool", "qpool"]


def test_hiera_full_width_routes_are_what_the_kernels_are_counted_by():
    """Hiera-Large: 42 windowed blocks, 3 q-pool blocks, 3 global blocks."""
    with torch.device("meta"):
        trunk = t_hiera.Hiera(UFVideoConfig().sam.hiera, torch.bfloat16)
    routes = [blk.route for blk in trunk.blocks]
    assert len(routes) == 48
    assert {r: routes.count(r) for r in set(routes)} == {"block": 42, "qpool": 3, "split": 3}
    assert [i for i, r in enumerate(routes) if r == "qpool"] == [2, 8, 44]
    assert [i for i, r in enumerate(routes) if r == "split"] == [23, 33, 43]
    sides = [trunk.blocks[i].window_side for i in (0, 2, 3, 8, 9, 23, 44, 45)]
    assert sides == [8, 8, 4, 4, 16, 0, 16, 8]
    heads = [(blk.num_heads, blk.head_dim) for blk in trunk.blocks]
    assert heads[0] == (2, 72) and heads[2] == (4, 72) and heads[8] == (8, 72)
    assert heads[44] == (16, 72)


def test_hiera_refuses_a_window_that_does_not_divide_its_grid():
    cfg = SAM2HieraConfig(
        embed_dim=16, num_heads=1, stages=(1, 2, 1, 1), global_att_blocks=(2,),
        window_spec=(5, 2, 4, 2), image_size=128,
    )
    with pytest.raises(ValueError, match="does not divide"):
        t_hiera.Hiera(cfg, torch.float32)
    with pytest.raises(ValueError, match="does not divide"):
        t_hiera.to_windows(torch.zeros(1, 6, 8, 4), 4)


@pytest.mark.parametrize("dim,dim_out,q_stride", [(16, 16, None), (16, 32, (2, 2))])
def test_block_kernel_params_follow_a_weight_write(dim, dim_out, q_stride):
    """The kernel-ready parameters (f32 vectors, folded front weight) are
    built once and reused, and rebuilt after weights are written in place."""
    blk = t_hiera.MultiScaleBlock(dim, dim_out, 2, 4.0, q_stride, 4, torch.float32)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        x = torch.randn(3, 16, dim, generator=gen)
        first = blk(x)
        assert blk._kernel_params() is blk._kernel_params()
        assert blk._kernel_params()[2].shape == (dim, 3 * dim_out + (dim_out if q_stride else 0))
        torch.testing.assert_close(blk(x), first, rtol=0, atol=0)
        blk.mlp_layers_1.bias.copy_(blk.mlp_layers_1.bias + 1.0)
        blk.attn.qkv.kernel.mul_(0.5)
        second = blk(x)
        fresh = t_hiera.MultiScaleBlock(dim, dim_out, 2, 4.0, q_stride, 4, torch.float32)
        fresh.load_state_dict(blk.state_dict())
        torch.testing.assert_close(second, fresh(x), rtol=0, atol=0)
    assert (second - first).abs().max() > 0.5


def test_quantised_hiera_full_width_routes_are_the_float_ones():
    """Hiera-Large with ``quant=True``: the same 42 / 3 / 3 routes, every
    dense layer of every block an int8 holder, and the shortcut projection
    folded into the front of the three q-pool blocks (K = 144 and 288 are
    padded to a multiple of 32 inside the kernels, not here)."""
    with torch.device("meta"):
        trunk = t_hiera.Hiera(UFVideoConfig().sam.hiera, torch.bfloat16, quant=True)
        flt = t_hiera.Hiera(UFVideoConfig().sam.hiera, torch.bfloat16)
    assert [b.route for b in trunk.blocks] == [b.route for b in flt.blocks]
    for blk in trunk.blocks:
        dense = [blk.attn.qkv, blk.attn.proj, blk.mlp_layers_0, blk.mlp_layers_1]
        dense += [blk.proj] if blk.dim != blk.dim_out else []
        assert all(d.kernel_q.dtype == torch.int8 and d.kernel_scale.dtype == torch.float32
                   and d.bias.dtype == torch.bfloat16 for d in dense)
        assert not any(isinstance(m, t_hiera.DenseParams) for m in blk.modules())
    assert trunk.patch_embed.weight.dtype == torch.bfloat16
    shapes = [(tuple(trunk.blocks[i].attn.qkv.kernel_q.shape),
               tuple(trunk.blocks[i].proj.kernel_q.shape)) for i in (2, 8, 44)]
    assert shapes == [((144, 864), (144, 288)), ((288, 1728), (288, 576)),
                      ((576, 3456), (576, 1152))]


@pytest.mark.parametrize("dim,dim_out,q_stride,side", [
    (16, 16, None, 4), (16, 32, (2, 2), 4), (16, 16, None, 0)], ids=["block", "qpool", "split"])
def test_quantised_block_kernel_params_follow_a_weight_write(dim, dim_out, q_stride, side):
    """The quantised twin of the kernel-ready parameters: built once, rebuilt
    after ``set_kernel`` or a bias write, and the block then computes what a
    fresh block with those weights computes."""
    blk = t_hiera.MultiScaleBlock(dim, dim_out, 2, 4.0, q_stride, side, torch.float32, True)
    gen = torch.Generator().manual_seed(4)
    rnd = lambda *shape: torch.randn(*shape, generator=gen) * 0.2
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, t_hiera.W8A8Linear):
                m.set_kernel(rnd(*m.kernel_q.shape))
                m.bias.copy_(rnd(*m.bias.shape))
            elif isinstance(m, t_hiera.LayerNormParams):
                m.scale.fill_(1.0)
                m.bias.zero_()
        x = rnd(3, 16, dim) * 5
        first = blk(x)
        assert blk._kernel_params() is blk._kernel_params()
        assert len(blk._kernel_params()) == 16 and blk._kernel_params()[2].dtype == torch.int8
        blk.mlp_layers_1.bias.add_(1.0)
        blk.attn.qkv.set_kernel(rnd(*blk.attn.qkv.kernel_q.shape))
        second = blk(x)
        fresh = t_hiera.MultiScaleBlock(dim, dim_out, 2, 4.0, q_stride, side, torch.float32, True)
        fresh.load_state_dict(blk.state_dict())
        torch.testing.assert_close(second, fresh(x), rtol=0, atol=0)
    assert tuple(first.shape) == (3, 16 // (4 if q_stride else 1), dim_out)
    assert (second - first).abs().max() > 0.5


@pytest.mark.parametrize("ws", [2, 4, 8])
def test_window_layout_matches(ws):
    x = _randn(2, 2, 8, 16, 5)
    jw, _ = j_hiera.to_windows(jnp.asarray(x), ws)
    tw = t_hiera.to_windows(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(tw.numpy(), _np(jw))
    back = t_hiera.from_windows(tw, ws, (8, 16))
    np.testing.assert_array_equal(back.numpy(), x)


def test_image_encoder_fpn_matches(pair, images):
    jm, variables, model = pair
    want = jm.apply(variables, jnp.asarray(images), method=JSAM2.forward_image)
    with torch.no_grad():
        got = model.forward_image(torch.from_numpy(images))
    shapes = [tuple(t.shape) for t in got["backbone_fpn"]]
    assert shapes == [(2, 32, 32, 4), (2, 16, 16, 8), (2, 8, 8, 32)]
    for g, w in zip(got["backbone_fpn"], want["backbone_fpn"]):
        _close(g, w)
    for g, w in zip(got["vision_pos_enc"], want["vision_pos_enc"]):
        _close(g, w, 1e-6)


@pytest.mark.parametrize(
    "multimask,n_points",
    [
        pytest.param(True, 0, id="language-prompt-multimask"),
        pytest.param(True, 1, id="one-point-multimask"),
        pytest.param(False, 2, id="box-single-mask-stability-rule"),
    ],
)
def test_sam_heads_match(pair, multimask, n_points):
    """Prompt encoder + two-way transformer + mask decoder + object pointer.
    The single-mask case goes through the dynamic-multimask stability rule."""
    jm, variables, model = pair
    b, c, s = 2, 32, 8
    pix = _randn(3, b, s, s, c)
    high = [_randn(4, b, 4 * s, 4 * s, c // 8), _randn(5, b, 2 * s, 2 * s, c // 4)]
    lang = _randn(6, b, 1, c) if n_points == 0 else None
    coords = labels = None
    if n_points:
        coords = np.random.default_rng(7).uniform(0, 128, (b, n_points, 2)).astype(np.float32)
        labels = np.asarray([[1], [0]] if n_points == 1 else [[2, 3], [2, 3]], np.int32)
    j = lambda x: None if x is None else jnp.asarray(x)
    t = lambda x: None if x is None else torch.from_numpy(x)
    want = jm.apply(
        variables, j(pix), [j(h) for h in high], j(lang), j(coords), j(labels), None, multimask,
        method=JSAM2.forward_sam_heads,
    )
    with torch.no_grad():
        got = model.forward_sam_heads(
            t(pix), [t(h) for h in high], t(lang), t(coords), t(labels), None, multimask
        )
    assert tuple(got.low_res_masks.shape) == (b, 1, 4 * s, 4 * s)
    assert tuple(got.high_res_masks.shape) == (b, 1, 128, 128)
    for name in got._fields:
        _close(getattr(got, name), getattr(want, name))


def test_memory_encoder_matches(pair):
    jm, variables, model = pair
    pix = _randn(8, 2, 8, 8, 32)
    logits = 4.0 * _randn(9, 2, 128, 128, 1)
    want = jm.apply(variables, jnp.asarray(pix), jnp.asarray(logits), method=JSAM2.encode_memory)
    with torch.no_grad():
        got = model.encode_memory(torch.from_numpy(pix), torch.from_numpy(logits))
    assert tuple(got.shape) == (2, 8, 8, 16)
    _close(got, want)


@pytest.mark.parametrize(
    "valid_slots,valid_ptrs",
    [
        pytest.param(1, 1, id="first-tracked-frame"),
        pytest.param(3, 3, id="banks-filling"),
        pytest.param(7, 16, id="banks-full"),
    ],
)
def test_memory_attention_matches(pair, valid_slots, valid_ptrs):
    """Memory attention as ``condition_on_memory`` drives it: RoPE tiled
    over the stacked memory slots, object-pointer tokens without rotation,
    and a ``kv_mask`` that hides the empty slots (whole trailing runs of
    keys on the first tracked frame)."""
    jm, variables, model = pair
    b, hw, c, md, slots, ptrs = 2, 64, 32, 16, 7, 16
    curr, pos = _randn(10, b, hw, c), _randn(11, b, hw, c)
    mem = _randn(12, b, slots, hw, md)
    obj_ptrs = _randn(13, b, ptrs, c)
    mem_valid = np.broadcast_to(np.arange(slots) < valid_slots, (b, slots)).copy()
    ptr_valid = np.broadcast_to(np.arange(ptrs) < valid_ptrs, (b, ptrs)).copy()
    tpos = np.asarray([slots - 1] + list(range(slots - 1)), np.int32)
    args = (curr, pos, mem, mem_valid, tpos, obj_ptrs, ptr_valid)
    want = jm.apply(
        variables, *map(jnp.asarray, args), (8, 8), method=JSAM2.condition_on_memory
    )
    with torch.no_grad():
        got = model.condition_on_memory(*map(torch.from_numpy, args), (8, 8))
    assert tuple(got.shape) == (b, hw, c)
    _close(got, want)
    # what lies in the masked slots does not reach the output
    mem2 = mem.copy()
    mem2[:, valid_slots:] = 1e3
    with torch.no_grad():
        again = model.condition_on_memory(
            *map(torch.from_numpy, (curr, pos, mem2, mem_valid, tpos, obj_ptrs, ptr_valid)),
            (8, 8),
        )
    if valid_slots < slots:
        np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_propagate_video_matches(pair):
    """Frame-0 conditioning on two objects' language embeddings, then
    propagation over ``num_frames_sam`` + 2 = 4 frames: the memory and
    pointer banks fill and nothing is evicted. Logits within the tolerance,
    masks at video resolution equal bit for bit (up- and downsampled)."""
    jm, variables, model = pair
    t = tiny_config().budget.num_frames_sam + 2
    imgs = _randn(14, t, 128, 128, 3)
    lang = _randn(15, 2, 1, 32)
    params = variables["params"]
    jfeats = j_encode_video_frames(jm, params, jnp.asarray(imgs))
    jlow = np.array(j_propagate_video(jm, params, jfeats, jnp.asarray(lang)))
    feats = encode_video_frames(model, torch.from_numpy(imgs), chunk=3)
    for name in ("s0", "s1", "s2"):
        _close(getattr(feats, name), getattr(jfeats, name))
    low = propagate_video(model, feats, torch.from_numpy(lang))
    assert tuple(low.shape) == (t, 2, 1, 32, 32)
    _close(low, jlow)
    assert np.abs(jlow).max() > 1.0  # the logits are not all near the threshold
    for h, w in ((48, 64), (20, 24)):
        want = _np(j_masks_to_video_res(jnp.asarray(jlow), h, w))
        got = masks_to_video_res(low, h, w).numpy()
        assert got.dtype == np.bool_ and got.shape == (t, 2, h, w)
        near = np.abs(_np(t_interp.resize_hw(torch.from_numpy(jlow), h, w, "bilinear"))) < 1e-3
        assert (got == want)[~near[:, :, 0]].all()
        assert 0.02 < want.mean() < 0.98


@pytest.mark.parametrize("src,dst", [(7, 32), (7, 8), (14, 64), (8, 8)])
def test_bicubic_matrix_matches(src, dst):
    """Hiera's background position embedding: Keys a = -0.75, as
    ``F.interpolate`` computes it."""
    got = t_interp.bicubic_matrix(src, dst)
    np.testing.assert_allclose(got, _np(j_interp.bicubic_matrix(src, dst)), atol=1e-6, rtol=0)
    x = torch.from_numpy(_randn(16, 1, 1, src, src))
    want = torch.nn.functional.interpolate(x, size=(dst, dst), mode="bicubic",
                                           align_corners=False)[0, 0]
    m = torch.from_numpy(got)
    torch.testing.assert_close(m @ x[0, 0] @ m.T, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,size", [((32, 32), (128, 128)), ((32, 32), (48, 64)),
                                        ((32, 32), (20, 24))])
def test_bilinear_resize_matches_jax_image_resize(shape, size):
    x = _randn(17, 2, 3, *shape)
    want = _np(jax.image.resize(jnp.asarray(x), (2, 3, *size), method="bilinear"))
    got = t_interp.resize_hw(torch.from_numpy(x), *size, "bilinear").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_axial_rope_matches():
    cos, sin = t_rope.axial_rope_cos_sin(32, 8, 8, 10000.0)
    jcos, jsin = j_rope.axial_rope_cos_sin(32, 8, 8, 10000.0)
    _close(cos, jcos, 1e-6)
    _close(sin, jsin, 1e-6)
    x = _randn(18, 2, 64, 2, 32)
    want = j_rope.apply_rope_interleaved(
        jnp.asarray(x), jcos[None, :, None, :], jsin[None, :, None, :]
    )
    got = t_rope.apply_rope_interleaved(
        torch.from_numpy(x), cos[None, :, None, :], sin[None, :, None, :]
    )
    _close(got, want, 1e-5)


def test_sam_preprocess_matches():
    """uint8 frames -> 1024 x 1024 bicubic -> round / clip -> SAM mean / std.
    A value within an ulp of x.5 may round to the neighbouring level: at
    most one level (1 / 57.12 after normalisation) apart, almost all equal."""
    frames = np.random.default_rng(19).integers(0, 256, (1, 120, 160, 3), dtype=np.uint8)
    want = _np(j_sam_preprocess(jnp.asarray(frames), out_dtype=jnp.float32))
    got = sam_preprocess_device(torch.from_numpy(frames), out_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (1, 1024, 1024, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 / 57.12 + 1e-5
    assert (diff > 1e-5).mean() < 1e-3


def test_fill_holes_matches():
    """Host-side hole filling (off by default; ``cv2`` imported inside it)."""
    from ufvideo_tpu.models.sam2.post import fill_holes_in_mask_scores as j_fill
    from ufvideo_tpu_torch.models.sam2.post import fill_holes_in_mask_scores

    scores = np.ones((24, 24), np.float32)
    scores[2:4, 2:4] = -1.0  # a 4-pixel hole: filled at max_area 8
    scores[10:20, 10:20] = -1.0  # a 100-pixel hole: kept
    got = fill_holes_in_mask_scores(scores, 8)
    np.testing.assert_array_equal(got, j_fill(scores, 8))
    assert (got[2:4, 2:4] == np.float32(0.1)).all() and (got[10:20, 10:20] == -1.0).all()
    assert fill_holes_in_mask_scores(scores, 0) is scores
