"""The block GEMM's plan and the plain block at SigLIP's widths, on the CPU.

``block_gemm_plan`` decides from shapes alone how the card runs every
product of a bf16 block (qkv, proj, fc1, fc2, a q-pool block's front) and
the probe's bf16 product: the 128 x 128 tile at N <= 144 and at K <= 144
with N < 1024 (Hiera stage 1's products), every other bf16 output on the
persistent ping-pong kernel (one block an SM at most; its two consumer
warpgroups take alternate 128 x 128 tiles of the block), the f32 sum on
the 128 x 256 tile. Here at
every product shape that SigLIP-SO400M (32 frames), Hiera-L (4 frames,
every stage and the q-pool fronts) and ``tiny_config()`` give: the route,
the shared memory of an H100 block (227 KB), the grid against the SM count
passed in, and the tiles each consumer warpgroup takes. The card's C side
must give the same plan (tests/test_torch_cuda.py reads it through
``block_gemm_plan_query``); this module imports no JAX at the top, so that
test can take its shape list from here.

The plain ``fused_hiera_block`` is what the wrapper runs on CPU tensors and
what the kernel is held to on the card: here against the JAX reference and
the Pallas kernel in interpret mode at SigLIP's real widths (C = 1152, 16
heads x 72, MLP 4304, gelu_tanh) on a few tokens, float32, to 1e-4 as in
tests/test_torch_kernels.py (the interpret-mode kernel sums in another
order).
"""

import numpy as np
import pytest
import torch

from ufvideo_tpu_torch.configs import UFVideoConfig, tiny_config
from ufvideo_tpu_torch.ops import hiera_block as hb
from ufvideo_tpu_torch.ops.hiera_block import block_gemm_plan, fused_hiera_block

SAM_FRAMES = 4  # frames of a [SEG] request's Hiera pass (chip_smoke phase 4)


def siglip_products(vcfg, frames):
    """(M, N, K) of the four products of one SigLIP layer on ``frames``
    frames: qkv, proj, fc1, fc2."""
    rows = frames * vcfg.num_patches
    c, hw, mlp = vcfg.hidden_size, vcfg.num_heads * vcfg.head_dim, vcfg.intermediate_size
    return [(rows, 3 * hw, c), (rows, c, hw), (rows, mlp, c), (rows, c, mlp)]


def hiera_products(hcfg, frames=SAM_FRAMES):
    """(M, N, K) of every product of Hiera's blocks: at each stage qkv,
    proj, fc1 and fc2 (head dim C / heads, so H * hd = C), and from stage 2
    on the q-pool block's front, stage i - 1's rows into [q | k | v |
    shortcut] = 4 C (its tail runs the stage's proj, fc1 and fc2)."""
    side = hcfg.image_size // hcfg.patch_stride
    out = []
    for i in range(len(hcfg.stages)):
        c = int(hcfg.embed_dim * hcfg.dim_mul ** i)
        mlp = int(c * hcfg.mlp_ratio)
        rows = frames * (side >> i) ** 2
        out += [(rows, 3 * c, c), (rows, c, c), (rows, mlp, c), (rows, c, mlp)]
        if i:
            out.append((frames * (side >> (i - 1)) ** 2, 4 * c, int(c / hcfg.dim_mul)))
    return out


PROBE = (8192, 4304, 1152)  # the int8-rate probe's bf16 product
_full, _tiny = UFVideoConfig(), tiny_config()
PRODUCT_SHAPES = sorted(set(
    siglip_products(_full.vision, _full.budget.num_frames) + hiera_products(_full.sam.hiera)
    + siglip_products(_tiny.vision, _tiny.budget.num_frames)
    + hiera_products(_tiny.sam.hiera, _tiny.budget.num_frames_sam) + [PROBE]))


def test_the_shape_lists_are_siglip_hiera_l_and_tiny():
    assert siglip_products(_full.vision, 32) == [
        (23328, 3456, 1152), (23328, 1152, 1152), (23328, 4304, 1152), (23328, 1152, 4304)]
    hiera = hiera_products(_full.sam.hiera)
    assert (4096, 3456, 1152) in hiera and (4096, 1152, 4608) in hiera
    assert (16384, 4608, 576) in hiera and (262144, 432, 144) in hiera
    assert len(hiera) == 4 * 4 + 3
    assert {k for _, _, k in PRODUCT_SHAPES} >= {16, 32, 64, 128, 512}


def pp_tiles(plan, block, warpgroup):
    """The tiles consumer ``warpgroup`` of ``block`` computes, as
    gemm_pp_kernel walks them: tile block + (warpgroup + 2 i) * grid."""
    return range(block + warpgroup * plan.grid, plan.tiles, 2 * plan.grid)


@pytest.mark.parametrize("sms", [hb.H100_SMS, 114])
@pytest.mark.parametrize("m,n,k", PRODUCT_SHAPES)
def test_plan_fits_and_gives_every_tile_to_one_warpgroup(m, n, k, sms):
    plan = block_gemm_plan(m, n, k, sms)
    assert plan.tiles == -(-m // 128) * -(-n // 128)
    assert plan.smem <= hb.SMEM_MAX == 227 * 1024
    if n <= 144 or (k <= 144 and n < 1024):  # Hiera stage 1's products
        assert plan.route == "128" and plan.grid == plan.tiles and plan.stages == 3
        assert plan.smem == 3 * (32768 + 16) + 128 * 4 + 1024  # ring, barriers, bias row, pad
        return
    assert plan.route == "pp"
    assert plan.grid == min(sms, plan.tiles) <= sms
    # 32 KB stages (and their three barriers) beside the 32 KB residual tile,
    # its three barriers and both warpgroups' bias rows: as many as fit
    fixed = 1024 + 32768 + 3 * 8 + 2 * 128 * 4
    assert plan.stages == 6 and plan.smem == fixed + plan.stages * (32768 + 3 * 8)
    assert plan.smem + 32768 + 24 > hb.SMEM_MAX
    seen = []
    for b in range(plan.grid):
        mine = [list(pp_tiles(plan, b, w)) for w in (0, 1)]
        assert mine[0], "every block has a tile"
        # warpgroup 1 idles only in a block that has a single tile
        assert mine[1] or len(mine[0]) == 1
        assert len(mine[0]) - len(mine[1]) in (0, 1)
        seen += mine[0] + mine[1]
    assert sorted(seen) == list(range(plan.tiles))


def test_plan_at_the_siglip_products_and_the_probe():
    """Every SigLIP product fills the card, each block with 12-48 tiles;
    the one-tile product keeps a grid of one; the probe's f32 sum takes the
    128 x 256 tile, a block a tile."""
    for m, n, k in siglip_products(_full.vision, 32) + [PROBE]:
        plan = block_gemm_plan(m, n, k)
        assert (plan.route, plan.stages, plan.grid, plan.smem) == ("pp", 6, 132, 231592)
        assert 12 <= plan.tiles // plan.grid <= 48
    probe = block_gemm_plan(*PROBE, f32=True)
    assert probe.code == (256, 4, 4 * (16384 + 32768 + 16) + 256 * 4 + 1024, 64 * 17, 64 * 17)
    assert block_gemm_plan(23328, 4304, 1152).tiles == 183 * 34
    assert block_gemm_plan(1, 8, 1152).code == (128, 3, 99888, 1, 1)  # N <= 144
    assert hb.gemm_route_plan("pp", 1, 8, 1152)[2:] == (231592, 1, 1)  # one tile: a grid of one
    assert hb.gemm_route_plan("pp", 1, 8, 1152).code == (0, 6, 231592, 1, 1)
    assert block_gemm_plan(129, 4304, 1152).grid == 68  # fewer tiles than SMs
    assert block_gemm_plan(65536, 288, 1152).route == "pp"  # Hiera stage 2's fc2
    assert block_gemm_plan(65536, 1152, 288).code == (0, 6, 231592, 132, 4608)
    assert block_gemm_plan(262144, 144, 576).code == (128, 3, 99888, 4096, 4096)  # stage 1's
    assert block_gemm_plan(262144, 432, 144).route == "128"
    assert block_gemm_plan(262144, 1152, 144).route == "pp"  # the q-pool front into stage 2


@pytest.mark.parametrize("m,n,k,sms", [(0, 8, 1152, 132), (8, 12, 1152, 132), (8, 8, 1020, 132),
                                       (8, 8, -8, 132), (8, 0, 1152, 132), (8, 8, 1152, 0)])
def test_plan_refuses_what_the_gemm_cannot_take(m, n, k, sms):
    with pytest.raises(ValueError):
        block_gemm_plan(m, n, k, sms)


@pytest.mark.parametrize("m,n,k", PRODUCT_SHAPES)
def test_plan_gives_the_f32_sum_the_256_tile(m, n, k):
    plan = block_gemm_plan(m, n, k, f32=True)
    assert plan.route == "256" and plan.grid == plan.tiles == -(-m // 128) * -(-n // 256)
    assert plan.stages == 4 and plan.smem <= hb.SMEM_MAX


def test_a_route_plan_takes_each_route_the_gemm_has():
    """What block_gemm_alone may force: every route at a SigLIP shape, the
    256-wide tile for the f32 sum only; no other width."""
    m, n, k = 23328, 1152, 1152
    for route, tiles in (("pp", 183 * 9), ("128", 183 * 9)):
        plan = hb.gemm_route_plan(route, m, n, k)
        assert plan.route == route and plan.tiles == tiles and plan.smem <= hb.SMEM_MAX
        assert plan == hb.gemm_route_plan(route, m, n, k, f32=True)
    assert hb.gemm_route_plan("256", m, n, k, f32=True).tiles == 183 * 5
    assert hb.gemm_route_plan("pp", m, n, k).code == block_gemm_plan(m, n, k).code
    for route, f32 in (("256", False), ("64", False), ("144", False), ("144", True)):
        with pytest.raises(ValueError):
            hb.gemm_route_plan(route, m, n, k, f32=f32)


def test_siglip_block_plain_matches_pallas_and_reference_at_its_widths():
    import jax.numpy as jnp

    from ufvideo_tpu.ops import hiera_block as jhb

    v = _full.vision
    n, s, c, heads, hd, mlp = 1, 16, v.hidden_size, v.num_heads, v.head_dim, v.intermediate_size
    assert (c, heads, hd, mlp) == (1152, 16, 72, 4304)
    rng = np.random.default_rng(14)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    hw = heads * hd
    params = (1.0 + 0.1 * r(c), 0.1 * r(c), c ** -0.5 * r(c, 3 * hw), 0.1 * r(3 * hw),
              hw ** -0.5 * r(hw, c), 0.1 * r(c), 1.0 + 0.1 * r(c), 0.1 * r(c),
              c ** -0.5 * r(c, mlp), 0.1 * r(mlp), mlp ** -0.5 * r(mlp, c), 0.1 * r(c))
    x = r(n, s, c)
    got = fused_hiera_block(torch.from_numpy(x), tuple(map(torch.from_numpy, params)), heads,
                            hd, act="gelu_tanh", eps=1e-6).numpy()
    jp = tuple(map(jnp.asarray, params))
    ref = np.asarray(jhb._reference(jnp.asarray(x), jp, heads, hd, hd, "gelu_tanh", 1e-6))
    pallas = np.asarray(
        jhb.fused_hiera_block(jnp.asarray(x), jp, heads, hd, 0, True, "gelu_tanh", 1e-6))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, pallas, atol=1e-4, rtol=1e-4)
    assert fused_hiera_block.launches == 0
