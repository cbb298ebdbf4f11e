"""The one-row quantised products' grid, on the CPU: the plan that
``ops/quant_matmul.py`` hands the one-row kernel (``matvec_plan``), and
that plan's split of the contraction in plain PyTorch
(``matvec_slices_plain``: each slice's f32 sum, the slices added in order,
the int8 scale last), held against ``int8_matvec_plain`` /
``int4_matmul_plain`` and the JAX Pallas kernels in interpret mode.

Plan: whole block steps cover the contraction exactly, 16-byte loads only
where every weight row
starts on 16 bytes, a slice's x fits the kernel's shared memory, a split
of 2 to 8 slices is one cluster (one launch), and the grid gives every SM
of an H100 a block at Qwen2-7B's five projections.
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
SMEM = 48 * 1024  # csrc/quant_matmul.cu row::kMaxSmem: x slice + reduction


@pytest.mark.parametrize("sm_count", [H100_SMS, 16, 1])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("din,dout", QWEN2_7B + SMALL)
def test_plan_covers_the_contraction_in_whole_steps(din, dout, bits, aligned, sm_count):
    p = qm.matvec_plan(din, dout, bits, sm_count, aligned)
    depth = din if bits == 8 else din // 2
    assert p.kchunk % 128 == 0  # whole steps: 8 warps x 4 rows x 4 rows a lane
    assert (p.ksplit - 1) * p.kchunk < depth <= p.ksplit * p.kchunk  # no empty slice
    # a lane takes 4 packed rows from a multiple of 4; every group the int4
    # wrapper takes (a multiple of 8 logical rows) holds a whole number of them
    assert p.vec == (16 if aligned and dout % 16 == 0 else 4)
    assert p.cols == 8 * p.vec and dout % p.vec == 0
    assert p.blocks == -(-dout // p.cols) * p.ksplit
    # one launch only where the slices fit a portable cluster: the cluster
    # is a column tile's slices, so it divides the grid
    assert p.cluster in (1, p.ksplit) and p.cluster <= 8
    assert p.blocks % p.cluster == 0
    x_bytes = p.kchunk * (1 if bits == 8 else 2) * 4
    assert x_bytes + 8 * p.cols * 4 <= SMEM
    assert qm.matvec_plan(din, dout, bits, sm_count, aligned) is p  # cached


@pytest.mark.parametrize("bits", [8, 4])
def test_plan_gives_every_h100_sm_a_block_at_the_qwen2_shapes(bits):
    """qkv, o and down in one launch on one wave of clusters; gate / up in
    two passes over four blocks an SM; lm_head one slice (1188 tiles)."""
    plans = [qm.matvec_plan(din, dout, bits, H100_SMS) for din, dout in QWEN2_7B]
    for p in plans:
        assert p.blocks >= H100_SMS and p.vec == 16, p
    qkv, o, gate_up, down, lm_head = plans
    for p in (qkv, o, down):
        assert p.cluster == p.ksplit > 1 and p.blocks <= 0.85 * 2 * H100_SMS
    assert gate_up.cluster == 1 and gate_up.blocks >= 4 * H100_SMS
    assert lm_head.ksplit == 1


def _case(seed, din, dout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, din)).astype(np.float32)
    w = (rng.standard_normal((din, dout)) * 0.3).astype(np.float32)
    return x, w


def _t(*xs):
    return [torch.from_numpy(np.array(a)) for a in xs]


# f32 sums of at most 1096 terms in another order: 2e-6 of the largest
# output (about 16 roundings of 2^-24 at the worst, times the terms' sizes)
SUM_TOL = 2e-6


def _close(got, want, tol=SUM_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("din,dout", [(1096, 132), (1096, 260), (1096, 272), (256, 128)])
def test_int8_sliced_plain_matches_plain_and_pallas_interpret(din, dout):
    x, w = _case(11, din, dout)
    qd = jq.quantize_kernel(jnp.asarray(w))
    xt, q, s = _t(x, qd["q"], qd["scale"])
    p = qm.matvec_plan(din, dout, 8, H100_SMS)
    if din == 1096:
        assert p.ksplit > 1 and din % p.kchunk  # the last slice is short
    got = qm.matvec_slices_plain(xt, q, s, p, 8)
    assert got.shape == (dout,) and got.dtype == torch.float32
    _close(got, qm.int8_matvec_plain(xt, q, s)[0])
    # the JAX test's own limits: both sides take bf16 x and f32 sums
    want = np.asarray(jqm.int8_matvec(jnp.asarray(x), qd["q"], qd["scale"], interpret=True))
    np.testing.assert_allclose(got.numpy(), want[0], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("din,dout,group", [
    (1096, 132, 8), (1096, 260, 8), (1088, 272, 64), (1088, 132, 64), (256, 128, 64)])
def test_int4_sliced_plain_matches_plain_reference_and_pallas_interpret(din, dout, group):
    x, w = _case(12, din, dout)
    qd = jq.quantize_kernel4(jnp.asarray(w), group)
    xt, q, s = _t(x, qd["q"], qd["scale"])
    p = qm.matvec_plan(din, dout, 4, H100_SMS)
    if din > 256:
        assert p.ksplit > 1 and (din // 2) % p.kchunk  # the last slice is short
    got = qm.matvec_slices_plain(xt, q, s, p, 4, group)
    assert got.shape == (dout,) and got.dtype == torch.float32
    _close(got, qm.int4_matmul_plain(xt, q, s, group)[0])
    # the XLA reference: the same bf16 weights
    ref = np.asarray(jqm.int4_matmul_reference(jnp.asarray(x), qd["q"], qd["scale"], group))
    _close(got, ref[0])
    # the Pallas kernel rounds (w + 8)·s to bf16: the JAX test's own limits
    pallas = np.asarray(jqm.int4_matmul(jnp.asarray(x), qd["q"], qd["scale"], group,
                                        interpret=True))[0]
    err = np.abs(got.numpy() - pallas) / np.abs(pallas).max()
    assert err.max() < 2e-2 and np.median(err) < 2e-3, (err.max(), np.median(err))
