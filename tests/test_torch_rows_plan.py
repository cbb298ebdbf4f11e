"""The 2-32-row quantised products' grid, on the CPU: the plan that
``ops/quant_matmul.py`` hands the tensor-core kernel (``rows_plan``), and
that plan's split of the contraction in plain PyTorch
(``rows_slices_plain``: each slice's f32 sums, the slices added in order,
the int8 scale last), held against ``int8_matvec_plain`` /
``int4_matmul_plain`` and the JAX Pallas kernels in interpret mode.

Plan: whole block steps cover the contraction with no empty slice, one
n-tile of 8 rows for the serving batch of 8 (two at 9-16 rows, four
above), 16-byte loads (8 at four n-tiles and for int4 at two) only where
every weight row starts so aligned, the slice of x (and int4's scales) and the warps' sums
fit the shared memory the plan gives the block, and below four n-tiles a
split of 2 to 8 slices in one wave is one cluster that divides the grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu import quant as jq
from ufvideo_tpu.ops import quant_matmul as jqm
from ufvideo_tpu_torch.ops import quant_matmul as qm

H100_SMS = 132
# (din, dout) of Qwen2-7B's projections: qkv, o, gate / up, down, lm_head
QWEN2_7B = [(3584, 4608), (3584, 3584), (3584, 18944), (18944, 3584), (3584, 152064)]
SMALL = [(256, 128), (256, 132), (1024, 260), (1096, 272), (1088, 132)]
# bytes of dynamic shared memory a block may take: two blocks an SM (H100:
# 228 KB an SM, 1 KB of it kept a block)
SMEM_CAP = 113 * 1024


def _group(din):
    return 64 if din % 64 == 0 else 8


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows", [2, 8, 16, 17, 32])
@pytest.mark.parametrize("din,dout", QWEN2_7B + SMALL)
def test_rows_plan_covers_the_contraction_in_whole_steps(din, dout, rows, bits, aligned):
    group = _group(din)
    p = qm.rows_plan(rows, din, dout, bits, H100_SMS, aligned, group)
    depth = din if bits == 8 else din // 2
    assert p.rows == rows and p.tiles == (1 if rows <= 8 else 2 if rows <= 16 else 4)
    assert p.kchunk % 128 == 0  # whole steps: 8 warps x 16 rows
    assert (p.ksplit - 1) * p.kchunk < depth <= p.ksplit * p.kchunk  # no empty slice
    # 16-byte loads, 8-byte ones at 4 n-tiles and for int4 at 2 (two column
    # groups of warps, so a lane's sums stay at most 64 floats), 4 bytes
    # where rows are not aligned to the wide load
    wide = 8 if p.tiles == 4 or (p.tiles == 2 and bits == 4) else 16
    assert p.vec == (wide if aligned and dout % wide == 0 else 4)
    assert p.wc in ((2, 4) if wide == 8 else (1, 2))
    assert p.cols == p.wc * 8 * p.vec and dout % p.vec == 0
    assert p.blocks == -(-dout // p.cols) * p.ksplit
    # below 4 n-tiles, one launch where the slices fit a portable cluster
    # and the clusters one wave (0.85 of two blocks an SM); the cluster is
    # a column tile's slices, so it divides the grid
    one_wave = p.blocks <= int(0.85 * 2 * H100_SMS)
    assert p.cluster == (p.ksplit if p.tiles < 4 and 1 < p.ksplit <= 8 and one_wave else 1)
    assert p.blocks % p.cluster == 0
    # slices of one length, as short as that many slices allow
    assert p.kchunk // 128 == -(-(-(-depth // 128)) // p.ksplit)
    # x's slice (8 * tiles rows of kchunk weight rows' bf16 values, padded)
    # and int4's scales, or the warps' sums, within the plan's shared memory
    xw = 1 if bits == 8 else 2
    x_bytes = 8 * p.tiles * (2 * p.kchunk * xw + 32 * xw)
    scale_bytes = 0 if bits == 8 else (-(-p.kchunk // (group // 2)) + 1) * 4 * p.cols
    sums_bytes = 4 * p.tiles * p.vec * 2 * 32 * 4 + 8 * p.tiles * p.cols * 4
    assert p.smem == qm.rows_smem(bits, p.tiles, p.vec, p.wc, p.kchunk, group)
    assert max(x_bytes + scale_bytes, sums_bytes) <= p.smem <= SMEM_CAP
    assert qm.rows_plan(rows, din, dout, bits, H100_SMS, aligned, group) is p  # cached


@pytest.mark.parametrize("bits", [8, 4])
def test_rows_plan_at_the_serving_batch(bits):
    """Eight rows take one n-tile and 16-byte loads. qkv, o and down: the
    one-row kernel's 128-column tiles, their slices added in one launch (a
    cluster of one wave). gate / up and lm_head: two column groups of warps
    (256 columns a block), gate / up in one wave of 3 slices (a cluster),
    lm_head in two slices added by a second pass."""
    plans = [qm.rows_plan(8, din, dout, bits, H100_SMS) for din, dout in QWEN2_7B]
    for p in plans:
        assert p.tiles == 1 and p.vec == 16 and p.blocks >= H100_SMS, p
    qkv, o, gate_up, down, lm_head = plans
    for p in (qkv, o, down):
        assert p.wc == 1 and p.cluster == p.ksplit > 1
    assert gate_up.wc == lm_head.wc == 2
    assert gate_up.ksplit == gate_up.cluster == 3
    assert lm_head.ksplit == 2 and lm_head.cluster == 1


def _case(seed, rows, din, dout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, din)).astype(np.float32)
    w = (rng.standard_normal((din, dout)) * 0.3).astype(np.float32)
    return x, w


def _t(*xs):
    return [torch.from_numpy(np.array(a)) for a in xs]


# f32 sums of at most 1096 terms in another order: 2e-6 of the largest
# output (tests/test_torch_matvec_plan.py)
SUM_TOL = 2e-6


def _close(got, want, tol=SUM_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("rows", [2, 5, 17, 32])
@pytest.mark.parametrize("din,dout", [(1096, 132), (1096, 272), (256, 128)])
def test_int8_rows_sliced_plain_matches_plain_and_pallas_interpret(rows, din, dout):
    x, w = _case(13, rows, din, dout)
    qd = jq.quantize_kernel(jnp.asarray(w))
    xt, q, s = _t(x, qd["q"], qd["scale"])
    p = qm.rows_plan(rows, din, dout, 8, H100_SMS)
    if din == 1096:
        assert p.ksplit > 1 and din % p.kchunk  # the last slice is short
    got = qm.rows_slices_plain(xt, q, s, p, 8)
    assert got.shape == (rows, dout) and got.dtype == torch.float32
    _close(got, qm.int8_matvec_plain(xt, q, s))
    # the JAX test's own limits: both sides take bf16 x and f32 sums
    want = np.asarray(jqm.int8_matvec(jnp.asarray(x), qd["q"], qd["scale"], interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("rows", [2, 5, 17, 32])
@pytest.mark.parametrize("din,dout,group", [(1096, 132, 8), (1088, 272, 64), (256, 128, 64)])
def test_int4_rows_sliced_plain_matches_plain_reference_and_pallas_interpret(
        rows, din, dout, group):
    x, w = _case(14, rows, din, dout)
    qd = jq.quantize_kernel4(jnp.asarray(w), group)
    xt, q, s = _t(x, qd["q"], qd["scale"])
    p = qm.rows_plan(rows, din, dout, 4, H100_SMS, group=group)
    if din > 256:
        assert p.ksplit > 1 and (din // 2) % p.kchunk  # the last slice is short
    got = qm.rows_slices_plain(xt, q, s, p, 4, group)
    assert got.shape == (rows, dout) and got.dtype == torch.float32
    _close(got, qm.int4_matmul_plain(xt, q, s, group))
    # the XLA reference: the same bf16 weights
    ref = np.asarray(jqm.int4_matmul_reference(jnp.asarray(x), qd["q"], qd["scale"], group))
    _close(got, ref)
    # the Pallas kernel rounds (w + 8)·s to bf16: the JAX test's own limits
    pallas = np.asarray(jqm.int4_matmul(jnp.asarray(x), qd["q"], qd["scale"], group,
                                        interpret=True))
    err = np.abs(got.numpy() - pallas) / np.abs(pallas).max()
    assert err.max() < 2e-2 and np.median(err) < 2e-3, (err.max(), np.median(err))
