"""The LayerNorm-band GEMM's plan and the plain versions of the two wrappers
that run on it (``fused_ln_matmul``, ``fused_block_tail``), on the CPU.

``ln_gemm_plan`` decides from shapes alone how the card runs the LN1 -> qkv
front of a global block and the LN2 -> fc1 step of every block tail: one
launch that normalises a band of 128 rows in shared memory for C <= 576, the
LayerNorm pass and the GEMM above. Its shared memory must fit an H100 block
(227 KB), and a tail's proj and fc2 take the block GEMM's route
(``block_gemm_plan``): its 128 x 128 tile at C <= 144 (Hiera's stage 1),
its ping-pong kernel at wider C.

The plain versions are what the wrappers run on CPU tensors and what the
kernels are held to on the card: here against the JAX package's Pallas
kernels in interpret mode and their XLA references, on the same numpy
inputs in float32, at Hiera's widths and row counts off the 128-row band.
Tolerances as in tests/test_torch_kernels.py: 1e-5 for the LN-matmul (the
JAX package's own for that kernel), 1e-4 for the tail (its interpret-mode
kernel sums in another order and its erf is within 1.5e-7 of erf).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.ops import hiera_block as jhb
from ufvideo_tpu_torch.configs import UFVideoConfig, tiny_config
from ufvideo_tpu_torch.ops import hiera_block as hb
from ufvideo_tpu_torch.ops.hiera_block import (
    fused_block_tail,
    fused_block_tail_plain,
    fused_ln_matmul,
    fused_ln_matmul_plain,
    ln_gemm_plan,
)

SAM_FRAMES = 4  # frames of a [SEG] request's Hiera pass (chip_smoke phase 4)


def _hiera_shapes(hcfg, frames=SAM_FRAMES):
    """(rows, C, N) of every LN-matmul and block-tail call the Hiera trunk
    makes: a tail (N = 4 C) and a global block's front (N = 3 C) at each
    stage, and the split route's q-pool front (stage i - 1's rows and width
    into [q | k | v | shortcut] = 4 C_i)."""
    side = hcfg.image_size // hcfg.patch_stride
    shapes = []
    for i in range(len(hcfg.stages)):
        c = int(hcfg.embed_dim * hcfg.dim_mul ** i)
        rows = frames * (side >> i) ** 2
        shapes += [(rows, c, 4 * c), (rows, c, 3 * c)]
        if i:
            shapes.append((frames * (side >> (i - 1)) ** 2, c // 2, 4 * c))
    return shapes


HIERA_L = _hiera_shapes(UFVideoConfig().sam.hiera)
TINY = _hiera_shapes(tiny_config().sam.hiera)


def test_the_shape_lists_are_hiera_l_and_tiny():
    assert (16384, 576, 1728) in HIERA_L and (262144, 144, 576) in HIERA_L
    assert {c for _, c, _ in HIERA_L} == {144, 288, 576, 1152}
    assert {c for _, c, _ in TINY} == {16, 32, 64, 128}


@pytest.mark.parametrize("rows,c,n", HIERA_L + TINY)
def test_plan_fits_and_takes_every_width_up_to_576(rows, c, n):
    plan = ln_gemm_plan(rows, c, n)
    if c > hb.LN_MAX_C:
        assert plan.route == "pair"
        assert plan.args == (0, 0, 0, 0) and plan.smem == 0
        return
    assert plan.route == "ln_gemm"
    assert (plan.bm, plan.bn, plan.cluster) == (128, 128, 1)
    assert plan.bands == -(-rows // 128)
    band = -(-c // 64) * 128 * 128  # 64-column chunks of 128 rows, bf16
    ring = plan.stages * 64 * 128 * 2  # W tiles of 64 K rows x 128 columns
    barriers = (8 + 3 * plan.stages) * 8  # 16-row groups; full (two) and empty a stage
    assert plan.smem == 1024 + band + ring + barriers + 2 * 128 * 4
    assert plan.smem <= hb.SMEM_MAX == 227 * 1024
    # the ring has as many stages as fit, up to 8, and at least two
    assert 2 <= plan.stages <= hb.LN_MAX_STAGES
    assert plan.stages == hb.LN_MAX_STAGES or plan.smem + 64 * 128 * 2 + 24 > hb.SMEM_MAX
    # the tail's proj and fc2 (N = C; K = C and the MLP's 4 C)
    routes = {hb.block_gemm_plan(rows, c, k).route for k in (c, 4 * c)}
    assert routes == ({"128"} if c <= 144 else {"pp"})


def test_plan_at_hiera_l_widths():
    """C = 576 leaves 5 ring stages beside its 147 KB band; C <= 288 gets 8;
    a tail's proj / fc2 take the 128 x 128 tile at 144, the ping-pong
    kernel above; 1152 keeps the pair."""
    assert ln_gemm_plan(16384, 576, 1728).stages == 5
    assert ln_gemm_plan(16384, 576, 1728).smem == 231608
    assert ln_gemm_plan(65536, 288, 1152).stages == 8
    assert ln_gemm_plan(262144, 144, 576).stages == 8
    assert [hb.block_gemm_plan(1, c, c).route for c in (144, 288, 576)] == ["128", "pp", "pp"]
    assert ln_gemm_plan(4096, 1152, 4608).route == "pair"


@pytest.mark.parametrize("rows,c,n", [(0, 576, 1728), (16, 20, 64), (16, 576, 100),
                                      (16, -8, 64), (16, 576, 0)])
def test_plan_refuses_what_the_kernel_cannot_take(rows, c, n):
    with pytest.raises(ValueError):
        ln_gemm_plan(rows, c, n)


def _rand(seed):
    rng = np.random.default_rng(seed)
    return lambda *s: rng.standard_normal(s).astype(np.float32)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


# (frames, tokens) of each case: rows 1, 127, 129 and 2 x 130 = 260, off
# and around the 128-row band
ROWS = [(1, 1), (1, 127), (1, 129), (2, 130)]


@pytest.mark.parametrize("c", [144, 288, 576])
@pytest.mark.parametrize("n,s", ROWS)
def test_ln_matmul_plain_matches_pallas_and_reference(c, n, s):
    r = _rand(20 + c + s)
    d = 3 * c
    x = 0.5 * r(n, s, c)
    ln_s, ln_b, w, b = 1.0 + 0.1 * r(c), 0.1 * r(c), c ** -0.5 * r(c, d), 0.1 * r(d)
    got = fused_ln_matmul(*_t(x, ln_s, ln_b, w, b), eps=1e-6)
    assert got.shape == (n, s, d)
    torch.testing.assert_close(
        got, fused_ln_matmul_plain(*_t(x, ln_s, ln_b, w, b), eps=1e-6), atol=0, rtol=0)
    jargs = tuple(map(jnp.asarray, (x, ln_s, ln_b, w, b)))
    ref = np.asarray(jhb._ln_matmul_reference(*jargs, 1e-6))
    pallas = np.asarray(jhb.fused_ln_matmul(*jargs, True))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=1e-5)
    assert fused_ln_matmul.launches == 0


@pytest.mark.parametrize("c", [144, 288, 576])
@pytest.mark.parametrize("n,s", ROWS)
def test_block_tail_plain_matches_pallas_and_reference(c, n, s):
    r = _rand(40 + c + s)
    mlp = 4 * c
    shortcut, att = 0.5 * r(n, s, c), 0.5 * r(n, s, c)
    params = (c ** -0.5 * r(c, c), 0.1 * r(c), 1.0 + 0.1 * r(c), 0.1 * r(c),
              c ** -0.5 * r(c, mlp), 0.1 * r(mlp), mlp ** -0.5 * r(mlp, c), 0.1 * r(c))
    got = fused_block_tail(*_t(shortcut, att), tuple(_t(*params)), act="gelu_exact", eps=1e-6)
    torch.testing.assert_close(
        got, fused_block_tail_plain(*_t(shortcut, att), tuple(_t(*params)), act="gelu_exact",
                                    eps=1e-6), atol=0, rtol=0)
    jp = tuple(map(jnp.asarray, params))
    js, ja = jnp.asarray(shortcut), jnp.asarray(att)
    ref = np.asarray(jhb._tail_reference(js, ja, jp, "gelu_exact", 1e-6))
    pallas = np.asarray(jhb.fused_block_tail(js, ja, jp, True, "gelu_exact", 1e-6))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=1e-4)
    assert fused_block_tail.launches == 0
