"""The port's CUDA kernels against their plain PyTorch versions, in bf16,
on the card. Skipped on a machine without CUDA; imports no JAX, so the
file runs on the card's machine:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: bf16 operands with f32 accumulation on both sides, the output
rounded to bf16 once at other places in the sum (one bf16 step is
2^-8..2^-7 of a value). An element may differ by 1e-2 of its row's RMS
(the last axis: one head's output, one token's residual) plus 2e-2 (2.5
bf16 steps) of itself, the whole tensor by 1e-2 in relative Frobenius norm:
a limit scaled to the output, so a dropped key chunk or a length mask off
by one key fails even where outputs are small. The block rounds four
intermediates to bf16 (LN output, qkv, attention, MLP hidden), each of which
may land one bf16 step apart on the two sides, so its elements get 5e-2 of
the row's RMS (the unfused cuBLAS / SDPA block needs 2.3e-2 against the same
plain version on an H100).
"""

import dataclasses
import functools
import time

import pytest
import torch

from ufvideo_tpu_torch.ops.decode_attention import (
    ragged_decode_attention,
    ragged_decode_attention_plain,
)
from ufvideo_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from ufvideo_tpu_torch.ops.hiera_block import (
    fused_block_tail,
    fused_block_tail_plain,
    fused_hiera_block,
    fused_hiera_block_plain,
    fused_ln_matmul,
    fused_ln_matmul_plain,
    fused_qpool_block,
    fused_qpool_block_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


def _assert_close(got, want, row_rel=1e-2, rtol=2e-2, rel=1e-2):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    err = (got - want).abs()
    row_rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    excess = err - (row_rel * row_rms + rtol * want.abs() + 1e-6)
    need = float(((err - rtol * want.abs()) / row_rms.clamp_min(1e-30)).max())
    assert float(excess.max()) <= 0, f"needs {need:.3e}*rms(row)"
    rel_fro = float((got - want).norm() / want.norm().clamp_min(1e-30))
    assert rel_fro <= rel, f"relative Frobenius error {rel_fro:.3e}"


def _randn(dev, *shape, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g, device=dev)).to(torch.bfloat16)


@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,d,causal,lens,masked",
    [
        (2, 300, 300, 8, 2, 128, True, [300, 170], False),
        (1, 100, 450, 4, 4, 64, True, [450], False),
        (2, 129, 200, 2, 1, 72, False, [200, 77], True),
        (2, 200, 200, 8, 8, 72, False, None, False),  # Hiera global block
        (1, 150, 150, 1, 1, 256, False, None, False),  # memory self-attention
        (2, 70, 333, 1, 1, 256, False, None, True),  # memory cross-attention
        (1, 7, 300, 8, 8, 32, False, None, False),  # mask decoder, tokens to image
        (1, 300, 7, 8, 8, 16, False, None, False),  # mask decoder, image to tokens
        (1, 9, 9, 8, 8, 32, False, None, False),  # mask decoder, tokens on themselves
        (1, 8, 4096, 8, 8, 16, False, None, False),  # mask decoder at full width
        (1, 4096, 9, 8, 8, 16, False, None, False),
    ],
)
def test_flash_kernel_matches_plain(dev, b, sq, skv, hq, hkv, d, causal, lens, masked):
    q = _randn(dev, b, sq, hq, d, seed=1)
    k = _randn(dev, b, skv, hkv, d, seed=2)
    v = _randn(dev, b, skv, hkv, d, seed=3)
    kv_lens = None if lens is None else torch.tensor(lens, device=dev)
    kv_mask = None
    if masked:
        g = torch.Generator(device=dev).manual_seed(4)
        kv_mask = torch.rand(b, skv, generator=g, device=dev) > 0.3
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, kv_lens=kv_lens, kv_mask=kv_mask)
    want = flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens, kv_mask=kv_mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_close(got, want)


def test_flash_kernel_skips_fully_masked_chunks(dev):
    """SAM2's memory bank on the first tracked frame: slot 0 valid, slots
    1-6 (whole 128-key chunks) and most pointer tokens masked."""
    hw, slots, ptr = 256, 7, 64
    skv = slots * hw + ptr
    q = _randn(dev, 2, hw, 1, 256, seed=1)
    k = _randn(dev, 2, skv, 1, 256, seed=2)
    v = _randn(dev, 2, skv, 1, 256, seed=3)
    kv_mask = torch.zeros(2, skv, dtype=torch.bool, device=dev)
    kv_mask[:, :hw] = True
    kv_mask[:, slots * hw:slots * hw + 4] = True
    got = flash_attention(q, k, v, kv_mask=kv_mask)
    want = flash_attention_plain(q, k, v, kv_mask=kv_mask)
    torch.cuda.synchronize()
    _assert_close(got, want)
    # nothing visible at all: zeros, not NaN
    none = flash_attention(q, k, v, kv_mask=torch.zeros_like(kv_mask))
    torch.cuda.synchronize()
    assert torch.count_nonzero(none) == 0


@pytest.mark.parametrize("d", [16, 32, 72, 128, 256])
@pytest.mark.parametrize("sq,skv,causal,masked,split", [
    (9, 4096, False, False, True),  # few queries: the keys split across the card
    (9, 4096, False, True, True),  # ... with kv_mask
    (40, 3000, True, False, True),  # ... causal (buffer-end diagonal), kv_lens
    (2100, 2100, True, False, False),  # 17 x 8 query tiles fill an H100: no split
])
def test_flash_kernel_head_dims_split_and_whole(dev, d, sq, skv, causal, masked, split):
    """Every head-dim instance, on the split path (few query tiles) and the
    whole one; the split path merges its chunks in a second pass."""
    from ufvideo_tpu_torch.ops import flash_attention as fa

    b, hq, hkv = 1, 8, 2
    splits, _ = fa.split_plan(b, hq, sq, skv, d, torch.cuda.get_device_properties(dev)
                              .multi_processor_count)
    assert (splits > 1) == split
    q = _randn(dev, b, sq, hq, d, seed=11)
    k = _randn(dev, b, skv, hkv, d, seed=12)
    v = _randn(dev, b, skv, hkv, d, seed=13)
    kv_lens = torch.tensor([skv - 77], device=dev) if causal else None
    kv_mask = None
    if masked:  # whole key tiles empty, the rest random
        g = torch.Generator(device=dev).manual_seed(14)
        kv_mask = torch.rand(b, skv, generator=g, device=dev) > 0.5
        kv_mask[:, 256:1280] = False
    got = flash_attention(q, k, v, causal=causal, kv_lens=kv_lens, kv_mask=kv_mask)
    want = flash_attention_plain(q, k, v, causal=causal, kv_lens=kv_lens, kv_mask=kv_mask)
    torch.cuda.synchronize()
    _assert_close(got, want)


def test_decode_kernel_matches_plain(dev):
    q = _randn(dev, 3, 4, 7, 128, seed=5)
    kc = _randn(dev, 3, 4, 640, 128, seed=6)
    vc = _randn(dev, 3, 4, 640, 128, seed=7)
    lens = torch.tensor([640, 1, 333], device=dev)
    got = ragged_decode_attention(q, kc, vc, lens)
    want = ragged_decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    _assert_close(got, want)


def _block_params(dev, c, mlp):
    vec = lambda m, seed: (1.0 + _randn(dev, m, seed=seed, scale=0.1).float()).to(torch.bfloat16)
    return (
        vec(c, 10), _randn(dev, c, seed=11, scale=0.1),
        _randn(dev, c, 3 * c, seed=12, scale=c ** -0.5), _randn(dev, 3 * c, seed=13, scale=0.1),
        _randn(dev, c, c, seed=14, scale=c ** -0.5), _randn(dev, c, seed=15, scale=0.1),
        vec(c, 16), _randn(dev, c, seed=17, scale=0.1),
        _randn(dev, c, mlp, seed=18, scale=c ** -0.5), _randn(dev, mlp, seed=19, scale=0.1),
        _randn(dev, mlp, c, seed=20, scale=mlp ** -0.5), _randn(dev, c, seed=21, scale=0.1),
    )


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu_exact"])
def test_hiera_kernel_matches_plain(dev, act):
    n, s, c, heads, hd, mlp = 3, 100, 144, 2, 72, 576
    params = _block_params(dev, c, mlp)
    x = _randn(dev, n, s, c, seed=22)
    got = fused_hiera_block(x, params, heads, hd, act=act)
    want = fused_hiera_block_plain(x, params, heads, hd, act=act)
    torch.cuda.synchronize()
    _assert_close(got, want, row_rel=5e-2)


def test_hiera_kernel_attention_part_matches_plain(dev):
    """The residual stream hides the attention part: with the MLP's output
    zeroed and the projection the identity, block(x) - x is the window
    attention's output (x small, so its bf16 rounding hides nothing)."""
    n, s, c, heads, hd, mlp = 3, 100, 144, 2, 72, 576
    p = list(_block_params(dev, c, mlp))
    p[4] = torch.eye(c, device=dev, dtype=torch.bfloat16)
    p[5] = p[11] = torch.zeros(c, device=dev, dtype=torch.bfloat16)
    p[10] = torch.zeros_like(p[10])
    x = _randn(dev, n, s, c, seed=22, scale=1e-2)
    got = fused_hiera_block(x, tuple(p), heads, hd, act="gelu_tanh")
    want = fused_hiera_block_plain(x, tuple(p), heads, hd, act="gelu_tanh")
    torch.cuda.synchronize()
    _assert_close(got.float() - x.float(), want.float() - x.float(), row_rel=5e-2)


# Hiera-L's windowed blocks at full width, few windows: (tokens, C, heads)
HIERA_SHAPES = [(64, 144, 2), (16, 288, 4), (256, 576, 8), (64, 1152, 16)]


@pytest.mark.parametrize("s,c,heads", HIERA_SHAPES)
def test_hiera_kernel_at_hiera_shapes(dev, s, c, heads):
    params = _block_params(dev, c, 4 * c)
    x = _randn(dev, 5, s, c, seed=23)
    before = fused_hiera_block.launches
    got = fused_hiera_block(x, params, heads, 72, act="gelu_exact")
    want = fused_hiera_block_plain(x, params, heads, 72, act="gelu_exact")
    torch.cuda.synchronize()
    assert fused_hiera_block.launches == before + 1
    _assert_close(got, want, row_rel=5e-2)


def test_ln_matmul_kernel_matches_plain(dev):
    n, s, c, d = 2, 300, 576, 1728
    x = _randn(dev, n, s, c, seed=30)
    ln_s = (1.0 + _randn(dev, c, seed=31, scale=0.1).float()).to(torch.bfloat16)
    ln_b = _randn(dev, c, seed=32, scale=0.1)
    w, b = _randn(dev, c, d, seed=33, scale=c ** -0.5), _randn(dev, d, seed=34, scale=0.1)
    before = fused_ln_matmul.launches
    got = fused_ln_matmul(x, ln_s, ln_b, w, b)
    want = fused_ln_matmul_plain(x, ln_s, ln_b, w, b)
    torch.cuda.synchronize()
    assert fused_ln_matmul.launches == before + 1
    assert got.shape == (n, s, d)
    _assert_close(got, want)


def _tail_params(dev, a, c, mlp):
    p = _block_params(dev, c, mlp)
    return (_randn(dev, a, c, seed=40, scale=a ** -0.5),) + p[5:]


@pytest.mark.parametrize("a,c", [(576, 576), (144, 288)])
def test_block_tail_kernel_matches_plain(dev, a, c):
    n, s, mlp = 2, 300, 4 * c
    shortcut, att = _randn(dev, n, s, c, seed=41), _randn(dev, n, s, a, seed=42)
    params = _tail_params(dev, a, c, mlp)
    before = fused_block_tail.launches
    got = fused_block_tail(shortcut, att, params, act="gelu_exact")
    want = fused_block_tail_plain(shortcut, att, params, act="gelu_exact")
    torch.cuda.synchronize()
    assert fused_block_tail.launches == before + 1
    _assert_close(got, want, row_rel=5e-2)


def _qpool_params(dev, cin, cout, heads, hd):
    hw = heads * hd
    p = _block_params(dev, cout, 4 * cout)
    vec = (1.0 + _randn(dev, cin, seed=50, scale=0.1).float()).to(torch.bfloat16)
    return (
        vec, _randn(dev, cin, seed=51, scale=0.1),
        _randn(dev, cin, 3 * hw + cout, seed=52, scale=cin ** -0.5),
        _randn(dev, 3 * hw + cout, seed=53, scale=0.1),
        _randn(dev, hw, cout, seed=54, scale=hw ** -0.5),
    ) + p[5:]


# Hiera-L's three stage transitions at full width: (tokens, Cin, Cout, heads)
QPOOL_SHAPES = [(64, 144, 288, 4), (16, 288, 576, 8), (256, 576, 1152, 16)]


@pytest.mark.parametrize("s,cin,cout,heads", QPOOL_SHAPES)
def test_qpool_kernel_matches_plain(dev, s, cin, cout, heads):
    params = _qpool_params(dev, cin, cout, heads, 72)
    x = _randn(dev, 5, s, cin, seed=55)
    before = fused_qpool_block.launches
    got = fused_qpool_block(x, params, heads, 72, (2, 2), act="gelu_exact")
    want = fused_qpool_block_plain(x, params, heads, 72, (2, 2), act="gelu_exact")
    torch.cuda.synchronize()
    assert fused_qpool_block.launches == before + 1
    assert got.shape == (5, s // 4, cout)
    _assert_close(got, want, row_rel=5e-2)


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu_exact", "gelu_poly", "gelu_poly_bf16",
                                 "gelu_tanh_poly", "gelu_tanh_poly_bf16"])
def test_block_gemm_epilogues_off_the_tile(dev, act):
    """The bf16 GEMM with M, N and K off its 128 x 128 x 64 tile, through
    every epilogue: the tail's proj and fc2 (bias + bf16 residual), its fc1
    (bias + each activation) at K = 144 and N = 4304, and the LN-matmul
    (bias alone)."""
    rows, c, a, mlp = 3 * 77, 144, 72, 4304
    params = _tail_params(dev, a, c, mlp)
    shortcut, att = _randn(dev, 3, 77, c, seed=15), _randn(dev, 3, 77, a, seed=16)
    got = fused_block_tail(shortcut, att, params, act=act)
    want = fused_block_tail_plain(shortcut, att, params, act=act)
    torch.cuda.synchronize()
    assert rows % 128 and mlp % 64 and c % 64
    _assert_close(got, want, row_rel=5e-2)
    x = _randn(dev, 3, 77, c, seed=17)
    ln_s, ln_b = _randn(dev, c, seed=18) * 0.1 + 1, _randn(dev, c, seed=19) * 0.1
    w, bias = _randn(dev, c, mlp, seed=20, scale=c ** -0.5), _randn(dev, mlp, seed=21)
    got = fused_ln_matmul(x, ln_s, ln_b, w, bias)
    want = fused_ln_matmul_plain(x, ln_s, ln_b, w, bias)
    torch.cuda.synchronize()
    _assert_close(got, want)


def test_block_gemm_alone_at_the_siglip_rows(dev):
    """The GEMM's f32 epilogue (the probe's bf16 product) at M = 32 · 729 =
    23328 rows, K = 144, N = 4304: every edge of the tile ragged."""
    from ufvideo_tpu_torch.probe_int8_rate import probe_step, probe_step_plain

    x = _randn(dev, 23328, 144, seed=22)
    w = _randn(dev, 144, 4304, seed=23, scale=144 ** -0.5)
    got = probe_step(x, w, False)
    want = probe_step_plain(x, w, False)
    torch.cuda.synchronize()
    rel = float((got - want).norm() / want.norm())
    assert rel <= 1e-3, rel


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = _randn(dev, 1, 8, 2, 16).float()
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        ragged_decode_attention(
            _randn(dev, 1, 1, 9, 16), *(_randn(dev, 1, 1, 8, 16),) * 2,
            torch.tensor([8], device=dev),
        )
    odd = _randn(dev, 1, 8, 2, 20)  # head dim not a multiple of 8
    with pytest.raises(ValueError):
        flash_attention(odd, odd, odd)
    with pytest.raises(ValueError):
        ragged_decode_attention(odd, odd, odd, torch.tensor([8], device=dev))
    shifted = _randn(dev, 1, 8 * 2 * 16 + 1)[:, 1:].view(1, 8, 2, 16)  # 2-byte offset
    with pytest.raises(ValueError):
        flash_attention(shifted, shifted, shifted)
    wide = _randn(dev, 1, 8, 1, 264)  # head dim above 256
    with pytest.raises(ValueError):
        flash_attention(wide, wide, wide)
    x32 = _randn(dev, 2, 16, 32).float()
    with pytest.raises(TypeError):
        fused_ln_matmul(x32, x32[0, 0], x32[0, 0], x32[0, :, :24].T.contiguous(), x32[0, 0, :16])
    x = _randn(dev, 2, 15, 16)  # 15 tokens are no square window
    with pytest.raises(ValueError):
        fused_qpool_block(x, _qpool_params(dev, 16, 32, 1, 16), 1, 16)
    # the redesigned tile and GEMM: 3 query heads on 2 kv heads, a row stride
    # that TMA cannot take (not a multiple of 16 bytes), a width off 8
    g3, k2 = _randn(dev, 1, 8, 3, 16), _randn(dev, 1, 8, 2, 16)
    with pytest.raises(ValueError):
        flash_attention(g3, k2, k2)
    rows = _randn(dev, 1, 8, 2 * 16 + 4)[..., :32].view(1, 8, 2, 16)  # row stride 36
    with pytest.raises(ValueError):
        flash_attention(rows, rows, rows)
    x = _randn(dev, 2, 16, 20)
    with pytest.raises(ValueError):
        fused_ln_matmul(x, x[0, 0], x[0, 0], _randn(dev, 20, 24), _randn(dev, 24))
    from ufvideo_tpu_torch.probe_int8_rate import probe_step

    with pytest.raises(ValueError):
        probe_step(_randn(dev, 16, 24), _randn(dev, 24, 20), False)


# ------------------------------------------------------ quantised kernels --
# int8_matvec / int4_matmul: f32 sums of the same exact terms in another
# order, held to 1e-3 of a row's RMS. The q8 decode: as its bf16 sibling. The
# W8A8 block: the int32 sums are exact on both sides; with the projection
# zeroed (the MLP half alone: both sides quantise the same f32 values) the
# JAX package's own kernel-test limits apply (0.999 of the elements within
# 1e-3 absolute or 1e-2 relative, all within 2.0 + 5e-2·|plain|); through the
# whole block the kernel quantises the attention output from bf16, the plain
# version from f32, and the residual stream rounds to bf16 twice, so it is
# held to the float block's limits (5e-2 of the row's RMS).

from ufvideo_tpu_torch import quant as tq  # noqa: E402
from ufvideo_tpu_torch.models.qwen2 import QuantLinear, quantize_kv  # noqa: E402
from ufvideo_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from ufvideo_tpu_torch.ops import decode_attention as da  # noqa: E402
from ufvideo_tpu_torch.ops.decode_attention import (  # noqa: E402
    ragged_decode_attention_q8,
    ragged_decode_attention_q8_plain,
)
from ufvideo_tpu_torch.ops.hiera_block import (  # noqa: E402
    fused_block_w8a8,
    fused_block_w8a8_plain,
)

QUANT_SHAPES = [
    (1, 256, 128), (3, 512, 132), (8, 3584, 4608), (17, 1024, 260), (32, 3584, 3584),
    (1, 18944, 3584), (2, 3584, 18944), (1, 3584, 152064),
    # the verify block of speculative decoding (B = 1, K = 4): qkv, down, lm_head
    (5, 3584, 4608), (5, 18944, 3584), (5, 3584, 152064),
]


@pytest.mark.parametrize("rows,din,dout", QUANT_SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_kernels_match_plain(dev, bits, rows, din, dout):
    g = torch.Generator(device=dev).manual_seed(20)
    w = torch.randn(din, dout, generator=g, device=dev) * din ** -0.5
    x = _randn(dev, rows, din, seed=21)
    before = (qm.int8_matvec.launches, qm.int4_matmul.launches)
    if bits == 8:
        qd = tq.quantize_kernel(w)
        got = qm.int8_matvec(x, qd["q"], qd["scale"])
        want = qm.int8_matvec_plain(x, qd["q"], qd["scale"])
    else:
        qd = tq.quantize_kernel4(w, 64)
        got = qm.int4_matmul(x, qd["q"], qd["scale"], 64)
        want = qm.int4_matmul_plain(x, qd["q"], qd["scale"], 64)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows, dout)
    _assert_close(got, want, row_rel=1e-3, rtol=1e-3, rel=1e-3)
    after = (qm.int8_matvec.launches, qm.int4_matmul.launches)
    assert after == (before[0] + (bits == 8), before[1] + (bits == 4))


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_linear_routes_by_rows_and_refuses_what_the_kernel_cannot_take(dev, bits):
    lin = QuantLinear(256, 128, True, torch.bfloat16, bits=bits).to(dev)
    g = torch.Generator(device=dev).manual_seed(22)
    lin.reset_parameters(g)
    wrapper = qm.int8_matvec if bits == 8 else qm.int4_matmul
    n = wrapper.launches
    few, many = _randn(dev, 2, 3, 256, seed=23), _randn(dev, 40, 256, seed=24)
    y_few, y_many = lin(few), lin(many)
    assert wrapper.launches == n + 1  # 6 rows: the kernel; 40 rows: one matmul
    lin.use_kernels = False
    _assert_close(y_few, lin(few))
    assert wrapper.launches == n + 1
    assert y_few.shape == (2, 3, 128) and y_many.shape == (40, 128)
    # both routes give the same function: the first 6 of the 40 rows
    lin.use_kernels = True
    _assert_close(lin(many[:6]), y_many[:6])
    with pytest.raises(ValueError, match="at most 32 rows"):
        wrapper(*((many, lin.kernel_q, lin.kernel_scale) + ((64,) if bits == 4 else ())))
    with pytest.raises(TypeError):
        wrapper(*((few, lin.kernel_q.float(), lin.kernel_scale) + ((64,) if bits == 4 else ())))


# The one-row kernel through its private launcher at the plan the wrapper
# gives it, at the same split added the other way (one launch through a
# cluster, or a second pass), and at a split in 4 and in 12; the same limit
# as above against the plain version and against the plain split of that
# plan (matvec_slices_plain). One launch and a second pass add the slices
# in one order: equal bit for bit.
ROW_SHAPES = [(din, dout) for rows, din, dout in QUANT_SHAPES if rows == 1] + [
    (3584, 4608), (3584, 3584), (3584, 18944), (256, 132), (1024, 260), (1096, 272)]


def _row_inputs(dev, bits, din, dout, group=64, seed=40):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(din, dout, generator=g, device=dev) * din ** -0.5
    qd = tq.quantize_kernel(w) if bits == 8 else tq.quantize_kernel4(w, group)
    return _randn(dev, 1, din, seed=seed + 1), qd["q"], qd["scale"]


def _row_plain(x, q, s, bits, group=64):
    if bits == 8:
        return qm.int8_matvec_plain(x, q, s)
    return qm.int4_matmul_plain(x, q, s, group)


@pytest.mark.parametrize("bits,group,din,dout", [
    (bits, group, din, dout) for bits, group in ((8, 64), (4, 64), (4, 8))
    for din, dout in ROW_SHAPES if bits == 8 or din % group == 0])
def test_quant_row_kernel_matches_plain_at_each_split(dev, bits, group, din, dout):
    x, q, s = _row_inputs(dev, bits, din, dout, group)
    plan = qm.matvec_plan(din, dout, bits, qm._sm_count(dev.index or 0))
    want = _row_plain(x, q, s, bits, group)
    splits = [plan, plan._replace(cluster=plan.ksplit if plan.cluster == 1 else 1)]
    splits += [qm.split_rows(q.shape[0], dout, plan.vec, n, one_launch=n <= 8) for n in (4, 12)]
    for p in splits:
        got = qm._launch_row(x, q, s, bits, group, p)
        torch.cuda.synchronize()
        assert got.shape == (1, dout) and got.dtype == torch.float32
        _assert_close(got, want, row_rel=1e-3, rtol=1e-3, rel=1e-3)
        _assert_close(got[0], qm.matvec_slices_plain(x, q, s, p, bits, group),
                      row_rel=1e-3, rtol=1e-3, rel=1e-3)
        if 1 < p.ksplit <= 8:  # a cluster holds at most 8 slices
            other = p._replace(cluster=1 if p.cluster > 1 else p.ksplit)
            assert torch.equal(got, qm._launch_row(x, q, s, bits, group, other))


@pytest.mark.parametrize("k", [0, 1, 130, 1023])
def test_quant_row_kernel_int8_conversion_is_exact(dev, k):
    """x one-hot at row k, whose 256 columns hold every byte -128..127:
    the output is float(q[k]) * scale, bit for bit."""
    q = torch.randint(-128, 128, (1024, 256), dtype=torch.int8, device=dev)
    q[k] = torch.arange(-128, 128, device=dev).to(torch.int8)
    s = torch.rand(256, device=dev) + 0.5
    x = torch.zeros(1, 1024, dtype=torch.bfloat16, device=dev)
    x[0, k] = 1
    got = qm.int8_matvec(x, q, s)
    assert qm.int8_matvec.last_plan.vec == 16
    assert torch.equal(got[0], q[k].float() * s)


@pytest.mark.parametrize("group", [64, 8])
@pytest.mark.parametrize("k", [0, 1, 130, 511])
def test_quant_row_kernel_int4_conversion_is_exact(dev, group, k):
    """x one-hot at logical row 2k or 2k+1, packed row k holding every byte
    0..255: the output is bf16(w * s) of that row, bit for bit."""
    q = torch.randint(-128, 128, (512, 256), dtype=torch.int8, device=dev)
    q[k] = torch.arange(256, device=dev).to(torch.uint8).view(torch.int8)
    s = torch.rand(1024 // group, 256, device=dev) * 0.1 + 1e-3
    w = qm.dequantize_int4(q, s, group, torch.bfloat16).float()
    for row in (2 * k, 2 * k + 1):
        x = torch.zeros(1, 1024, dtype=torch.bfloat16, device=dev)
        x[0, row] = 1
        got = qm.int4_matmul(x, q, s, group)
        assert isinstance(qm.int4_matmul.last_plan, qm.MatvecPlan)
        assert torch.equal(got[0], w[row])


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_row_kernel_repeats_bit_for_bit(dev, bits):
    x, q, s = _row_inputs(dev, bits, 3584, 4608)
    wrapper = qm.int8_matvec if bits == 8 else qm.int4_matmul
    args = (x, q, s) + ((64,) if bits == 4 else ())
    first = wrapper(*args)
    assert qm.matvec_plan(3584, 4608, bits, qm._sm_count(dev.index or 0)).cluster > 1
    assert torch.equal(first, wrapper(*args))


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_wrappers_route_one_row_to_the_row_kernel(dev, bits):
    """1 row launches the one-row kernel at matvec_plan's plan; 2 and 32
    rows the 2-32-row kernel at rows_plan's plan."""
    din, dout = 1024, 260
    _, q, s = _row_inputs(dev, bits, din, dout)
    wrapper = qm.int8_matvec if bits == 8 else qm.int4_matmul
    sms = qm._sm_count(dev.index or 0)
    for rows in (1, 2, 32):
        x = _randn(dev, rows, din, seed=42)
        n = wrapper.launches
        got = wrapper(*((x, q, s) + ((64,) if bits == 4 else ())))
        assert wrapper.launches == n + 1
        _assert_close(got, _row_plain(x, q, s, bits, 64), row_rel=1e-3, rtol=1e-3, rel=1e-3)
        if rows == 1:
            assert wrapper.last_plan == qm.matvec_plan(din, dout, bits, sms)
        else:
            assert wrapper.last_plan == qm.rows_plan(rows, din, dout, bits, sms)


# The 2-32-row kernel through its private launcher at the plan the wrapper
# gives it and at the same split added the other way (one launch through a
# cluster, or a second pass): the same limit against the plain version and
# against the plain split of that plan (rows_slices_plain); the two ways of
# adding the slices equal bit for bit. Unaligned weights (an offset of 4
# bytes) take the 4-byte loads.
RW_ROWS = [2, 3, 8, 16, 17, 32]
RW_SHAPES = sorted({(din, dout) for _, din, dout in QUANT_SHAPES} | set(ROW_SHAPES))


def _rows_inputs(dev, bits, rows, din, dout, group=64, seed=50, offset=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(din, dout, generator=g, device=dev) * din ** -0.5
    qd = tq.quantize_kernel(w) if bits == 8 else tq.quantize_kernel4(w, group)
    q = qd["q"]
    if offset:  # the same weights starting off a 16-byte boundary
        flat = torch.empty(q.numel() + offset, dtype=torch.int8, device=dev)
        q = flat[offset:].view(q.shape)
        q.copy_(qd["q"])
    return _randn(dev, rows, din, seed=seed + 1), q, qd["scale"]


@pytest.mark.parametrize("bits,group,din,dout,offset", [
    (bits, group, din, dout, offset) for bits, group in ((8, 64), (4, 64), (4, 8))
    for din, dout in RW_SHAPES if (bits == 8 or din % group == 0)
    and (group == 64 or din <= 1096) for offset in ((0, 4) if dout <= 18944 else (0,))])
def test_quant_rows_kernel_matches_plain_at_each_split(dev, bits, group, din, dout, offset):
    sms = qm._sm_count(dev.index or 0)
    for rows in RW_ROWS:
        x, q, s = _rows_inputs(dev, bits, rows, din, dout, group, offset=offset)
        plan = qm.rows_plan(rows, din, dout, bits, sms, offset == 0, group)
        wide = 8 if plan.tiles == 4 or (plan.tiles == 2 and bits == 4) else 16
        assert plan.vec == (wide if offset == 0 and dout % wide == 0 else 4)
        want = _row_plain(x, q, s, bits, group)
        got = qm._launch_rows(x, q, s, bits, group, plan)
        torch.cuda.synchronize()
        assert got.shape == (rows, dout) and got.dtype == torch.float32
        _assert_close(got, want, row_rel=1e-3, rtol=1e-3, rel=1e-3)
        _assert_close(got, qm.rows_slices_plain(x, q, s, plan, bits, group),
                      row_rel=1e-3, rtol=1e-3, rel=1e-3)
        if 1 < plan.ksplit <= 8:  # a cluster holds at most 8 slices
            other = plan._replace(cluster=1 if plan.cluster > 1 else plan.ksplit)
            assert torch.equal(got, qm._launch_rows(x, q, s, bits, group, other))


@pytest.mark.parametrize("rows", [2, 32])
def test_quant_rows_kernel_int8_conversion_is_exact(dev, rows):
    """x row i one-hot at weight row k_i, each of whose 256 columns holds
    one byte of -128..127 (in another order for each k): the output is
    float(q[k_i]) * scale, bit for bit."""
    ks = [0, 1, 130, 1023]
    q = torch.randint(-128, 128, (1024, 256), dtype=torch.int8, device=dev)
    for j, k in enumerate(ks):
        q[k] = torch.roll(torch.arange(-128, 128, device=dev), 37 * j).to(torch.int8)
    s = torch.rand(256, device=dev) + 0.5
    x = torch.zeros(rows, 1024, dtype=torch.bfloat16, device=dev)
    for i in range(rows):
        x[i, ks[i % 4]] = 1
    got = qm.int8_matvec(x, q, s)
    plan = qm.int8_matvec.last_plan
    assert isinstance(plan, qm.RowsPlan) and plan.vec == (8 if plan.tiles == 4 else 16)
    for i in range(rows):
        assert torch.equal(got[i], q[ks[i % 4]].float() * s), i


@pytest.mark.parametrize("group", [64, 8])
@pytest.mark.parametrize("rows", [2, 32])
def test_quant_rows_kernel_int4_conversion_is_exact(dev, group, rows):
    """x row i one-hot at logical row 2k or 2k + 1 of a packed row k that
    holds every byte 0..255: the output is bf16(w * s) of that row, bit for
    bit."""
    ks = [0, 1, 130, 511]
    q = torch.randint(-128, 128, (512, 256), dtype=torch.int8, device=dev)
    for j, k in enumerate(ks):
        q[k] = torch.roll(torch.arange(256, device=dev), 53 * j).to(torch.uint8).view(
            torch.int8)
    s = torch.rand(1024 // group, 256, device=dev) * 0.1 + 1e-3
    w = qm.dequantize_int4(q, s, group, torch.bfloat16).float()
    # both nibbles at 2 rows; every packed row's both nibbles at 32
    logical = [2 * ks[i % 4] + (i + i // 4) % 2 for i in range(rows)]
    x = torch.zeros(rows, 1024, dtype=torch.bfloat16, device=dev)
    for i, r in enumerate(logical):
        x[i, r] = 1
    got = qm.int4_matmul(x, q, s, group)
    assert isinstance(qm.int4_matmul.last_plan, qm.RowsPlan)
    for i, r in enumerate(logical):
        assert torch.equal(got[i], w[r]), i


@pytest.mark.parametrize("rows", [8, 32])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_rows_kernel_repeats_bit_for_bit(dev, bits, rows):
    x, q, s = _rows_inputs(dev, bits, rows, 3584, 4608)
    wrapper = qm.int8_matvec if bits == 8 else qm.int4_matmul
    args = (x, q, s) + ((64,) if bits == 4 else ())
    first = wrapper(*args)
    # slices added in one launch at 8 rows, by the second pass at 32
    plan = wrapper.last_plan
    assert plan.ksplit > 1 and (plan.cluster > 1) == (rows == 8)
    assert torch.equal(first, wrapper(*args))


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_products_on_two_threads_equal_one_thread(dev, bits):
    """The serving engine's admitters and decode worker launch the quantised
    products from several threads, each on a stream of its own. At a
    two-pass plan (the slices' partial sums go through the per-stream
    scratch), two threads launching at once on their own streams get their
    single-threaded results bit for bit, and the launch count loses none."""
    import threading

    wrapper = qm.int8_matvec if bits == 8 else qm.int4_matmul
    extra = (64,) if bits == 4 else ()
    inputs = [_rows_inputs(dev, bits, 32, 3584, 4608, seed=70 + 2 * i) for i in range(2)]
    want = [wrapper(*args, *extra) for args in inputs]
    plan = wrapper.last_plan
    assert plan.ksplit > 1 and plan.cluster == 1  # the second pass reads the partials
    torch.cuda.synchronize()
    got, errors, n = [[], []], [], 50
    together = threading.Barrier(2)
    before = wrapper.launches

    def run(i):
        try:
            stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(stream):
                together.wait(60)
                for _ in range(n):
                    got[i].append(wrapper(*inputs[i], *extra))
                stream.synchronize()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors and all(len(g) == n for g in got)
    assert wrapper.launches - before == 2 * n
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i]), i


@pytest.mark.parametrize(
    "b,hkv,g,s,d,lens",
    [
        (1, 4, 7, 2944, 128, [2800]),
        (4, 4, 7, 2944, 128, [2944, 1, 1500, 129]),
        (2, 2, 8, 256, 64, [256, 130]),
        (3, 1, 1, 200, 16, [5, 200, 128]),
    ],
)
def test_decode_q8_kernel_matches_plain(dev, b, hkv, g, s, d, lens):
    q = _randn(dev, b, hkv, g, d, seed=30)
    (k8, ks), (v8, vs) = (quantize_kv(_randn(dev, b, hkv, s, d, seed=sd)) for sd in (31, 32))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ragged_decode_attention_q8(q, k8, v8, ks, vs, lens_t)
    want = ragged_decode_attention_q8_plain(q, k8, v8, ks, vs, lens_t)
    torch.cuda.synchronize()
    _assert_close(got, want)
    # past lens[b] nothing is read: garbage there changes nothing
    k8b, vsb = k8.clone(), vs.clone()
    for i, n in enumerate(lens):
        k8b[i, :, n:] = 127
        vsb[i, :, n:] = 1e9
    again = ragged_decode_attention_q8(q, k8b, v8, ks, vsb, lens_t)
    assert torch.equal(got, again)


def test_decode_q8_kernel_empty_row_gives_zero(dev):
    q = _randn(dev, 2, 2, 4, 64, seed=33)
    (k8, ks), (v8, vs) = (quantize_kv(_randn(dev, 2, 2, 256, 64, seed=sd)) for sd in (34, 35))
    lens_t = torch.tensor([0, 9], dtype=torch.int32, device=dev)
    got = ragged_decode_attention_q8(q, k8, v8, ks, vs, lens_t)
    assert float(got[0].float().abs().max()) == 0.0 and float(got[1].float().abs().max()) > 0.0


# Both decode kernels at every chunk that decode_split_plan can return,
# through the private launcher that takes the chunk: G 1 / 4 / 7 / 8, D 16 /
# 64 / 128, ragged lens with 0, 1, chunk boundaries and S.
DECODE_SHAPES = [
    (1, 4, 7, 2944, 128, [2771]),
    (4, 4, 7, 2944, 128, [2944, 1, 1500, 129]),
    (2, 2, 8, 300, 64, [300, 64]),
    (3, 1, 1, 200, 16, [5, 200, 128]),
    (2, 3, 4, 520, 128, [257, 0]),
]


def _decode_inputs(dev, kind, b, hkv, g, s, d):
    q = _randn(dev, b, hkv, g, d, seed=40)
    k, v = _randn(dev, b, hkv, s, d, seed=41), _randn(dev, b, hkv, s, d, seed=42)
    if kind == "bf16":
        return q, k, v, None, None
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    return q, k8, v8, ks, vs


@pytest.mark.parametrize("chunk", da.CHUNKS)
@pytest.mark.parametrize("b,hkv,g,s,d,lens", DECODE_SHAPES)
@pytest.mark.parametrize("kind", ["bf16", "q8"])
def test_decode_kernels_match_plain_at_every_chunk(dev, kind, b, hkv, g, s, d, lens, chunk):
    q, k, v, ks, vs = _decode_inputs(dev, kind, b, hkv, g, s, d)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    launch = lambda k, v, vs: da._launch(q, k, v, lens_t, chunk, None, ks, vs)
    got = launch(k, v, vs)
    if kind == "bf16":
        want = da.ragged_decode_attention_plain(q, k, v, lens_t)
    else:
        want = da.ragged_decode_attention_q8_plain(q, k, v, ks, vs, lens_t)
    torch.cuda.synchronize()
    _assert_close(got, want)
    assert torch.equal(got, launch(k, v, vs))  # two calls equal bit for bit
    # past lens[b] nothing is read: garbage there changes nothing
    kb, vb = k.clone(), v.clone()
    vsb = None if vs is None else vs.clone()
    for i, n in enumerate(lens):
        kb[i, :, n:] = 127 if kind == "q8" else 3e4
        vb[i, :, n:] = -127 if kind == "q8" else -3e4
        if vsb is not None:
            vsb[i, :, n:] = 1e9
    assert torch.equal(got, launch(kb, vb, vsb))


@pytest.mark.parametrize("kind", ["bf16", "q8"])
def test_decode_wrappers_launch_the_planned_chunk(dev, kind):
    b, hkv, g, s, d, lens = DECODE_SHAPES[1]
    q, k, v, ks, vs = _decode_inputs(dev, kind, b, hkv, g, s, d)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    chunk = da.decode_split_plan(b, hkv, s, torch.cuda.get_device_properties(dev).multi_processor_count)
    wrapper = da.ragged_decode_attention if kind == "bf16" else da.ragged_decode_attention_q8
    n = wrapper.launches
    if kind == "bf16":
        got = wrapper(q, k, v, lens_t)
    else:
        got = wrapper(q, k, v, ks, vs, lens_t)
    assert wrapper.launches == n + 1
    assert wrapper.last_split == (chunk, b * hkv * -(-s // chunk))
    assert torch.equal(got, da._launch(q, k, v, lens_t, chunk, None, ks, vs))


def _w8a8_block_params(dev, c, hw, mlp, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *sh: torch.randn(*sh, generator=g, device=dev)
    bf = torch.bfloat16
    q = lambda w: tuple(tq.quantize_kernel(w).values())
    return (
        (1 + 0.1 * rn(c)).to(bf), (0.1 * rn(c)).to(bf),
        *q(rn(c, 3 * hw) * c ** -0.5), (0.1 * rn(3 * hw)).to(bf),
        *q(rn(hw, c) * hw ** -0.5), (0.1 * rn(c)).to(bf),
        (1 + 0.1 * rn(c)).to(bf), (0.1 * rn(c)).to(bf),
        *q(rn(c, mlp) * c ** -0.5), (0.1 * rn(mlp)).to(bf),
        *q(rn(mlp, c) * mlp ** -0.5), (0.1 * rn(c)).to(bf),
    )


@pytest.mark.parametrize(
    "n,s,c,heads,hd,mlp,act",
    [
        (4, 64, 128, 2, 64, 512, "gelu_tanh"),
        (2, 128, 64, 4, 16, 256, "gelu_exact"),
        (3, 50, 144, 2, 72, 430, "gelu_tanh"),  # K = 430 zero-padded to 448; ragged tiles
        (2, 729, 1152, 16, 72, 4304, "gelu_tanh"),  # SigLIP: K = 4304 padded to 4320
        # act code 4: the GELU output quantised in bf16 steps on both sides
        (8, 64, 144, 2, 72, 576, "gelu_poly_bf16"),
    ],
)
def test_w8a8_block_kernel_matches_plain(dev, n, s, c, heads, hd, mlp, act):
    params = _w8a8_block_params(dev, c, heads * hd, mlp, seed=40)
    x = _randn(dev, n, s, c, seed=41)
    launches = fused_block_w8a8.launches
    got = fused_block_w8a8(x, params, heads, hd, act=act)
    want = fused_block_w8a8_plain(x, params, heads, hd, act=act)
    torch.cuda.synchronize()
    assert fused_block_w8a8.launches == launches + 1
    _assert_close(got, want, row_rel=5e-2)
    # the MLP half alone (projection zeroed): identical quantisation points
    half = params[:5] + (torch.zeros_like(params[5]),) + params[6:]
    got = fused_block_w8a8(x, half, heads, hd, act=act).float()
    want = fused_block_w8a8_plain(x, half, heads, hd, act=act).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    close = (err < 1e-3) | (err / (want.abs() + 1e-3) < 1e-2)
    assert float(close.float().mean()) > 0.999
    assert float((err - (2.0 + 5e-2 * want.abs())).max()) <= 0


# ---------------------------------------------------- W8A8 Hiera block parts --
# The quantised trunk's kernels: the whole block at Hiera's window sizes with
# the exact GELU (K = 144 zero-padded to 160), the LN-matmul front, the tail
# and the q-pool block. The front and the tail quantise the same values on
# both sides (the float kernels' limits); the q-pool block quantises its
# attention output from bf16 in the kernel and from f32 in the plain version,
# as the whole block does (5e-2 of a row's RMS).

from ufvideo_tpu_torch.ops import hiera_block as hb  # noqa: E402


@pytest.mark.parametrize("n,s,c,heads", [(64, 64, 144, 2), (64, 16, 288, 4), (4, 256, 576, 8),
                                         (8, 64, 1152, 16)])
def test_w8a8_block_kernel_at_hiera_shapes(dev, n, s, c, heads):
    params = _w8a8_block_params(dev, c, heads * 72, 4 * c, seed=42)
    x = _randn(dev, n, s, c, seed=43)
    got = fused_block_w8a8(x, params, heads, 72, act="gelu_exact")
    want = fused_block_w8a8_plain(x, params, heads, 72, act="gelu_exact")
    torch.cuda.synchronize()
    _assert_close(got, want, row_rel=5e-2)


@pytest.mark.parametrize("c,d", [(576, 1728), (144, 432), (50, 66)])
def test_ln_matmul_w8a8_kernel_matches_plain(dev, c, d):
    """(50, 66): K padded from 50 to 64, a ragged column tile."""
    g = torch.Generator(device=dev).manual_seed(44)
    qd = tq.quantize_kernel(torch.randn(c, d, generator=g, device=dev) * c ** -0.5)
    x = _randn(dev, 3, 200, c, seed=45)
    ln_s, ln_b, b = _randn(dev, c, seed=46) * 0.1 + 1, _randn(dev, c, seed=47) * 0.1, \
        _randn(dev, d, seed=48) * 0.1
    launches = hb.fused_ln_matmul_w8a8.launches
    got = hb.fused_ln_matmul_w8a8(x, ln_s, ln_b, qd["q"], qd["scale"], b)
    want = hb.fused_ln_matmul_w8a8_plain(x, ln_s, ln_b, qd["q"], qd["scale"], b)
    torch.cuda.synchronize()
    assert hb.fused_ln_matmul_w8a8.launches == launches + 1
    assert got.shape == (3, 200, d) and got.dtype == torch.bfloat16
    _assert_close(got, want)


@pytest.mark.parametrize("a,c,mlp,act", [(576, 576, 2304, "gelu_exact"),
                                         (144, 288, 1152, "gelu_exact"),
                                         (72, 50, 430, "gelu_tanh"),
                                         (576, 576, 2304, "gelu_poly_bf16")])
def test_block_tail_w8a8_kernel_matches_plain(dev, a, c, mlp, act):
    params = _w8a8_block_params(dev, c, a, mlp, seed=49)[5:]
    # the projection of that recipe is [hw, c] = [a, c]
    shortcut, att = _randn(dev, 2, 300, c, seed=50), _randn(dev, 2, 300, a, seed=51)
    launches = hb.fused_block_tail_w8a8.launches
    got = hb.fused_block_tail_w8a8(shortcut, att, params, act=act)
    want = hb.fused_block_tail_w8a8_plain(shortcut, att, params, act=act)
    torch.cuda.synchronize()
    assert hb.fused_block_tail_w8a8.launches == launches + 1
    _assert_close(got, want, row_rel=5e-2)


def _w8a8_qpool_params(dev, cin, cout, hw, mlp, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *sh: torch.randn(*sh, generator=g, device=dev)
    bf = torch.bfloat16
    q = lambda w: tuple(tq.quantize_kernel(w).values())
    nf = 3 * hw + cout
    return (
        (1 + 0.1 * rn(cin)).to(bf), (0.1 * rn(cin)).to(bf),
        *q(rn(cin, nf) * cin ** -0.5), (0.1 * rn(nf)).to(bf),
        *q(rn(hw, cout) * hw ** -0.5), (0.1 * rn(cout)).to(bf),
        (1 + 0.1 * rn(cout)).to(bf), (0.1 * rn(cout)).to(bf),
        *q(rn(cout, mlp) * cout ** -0.5), (0.1 * rn(mlp)).to(bf),
        *q(rn(mlp, cout) * mlp ** -0.5), (0.1 * rn(cout)).to(bf),
    )


@pytest.mark.parametrize("n,s,cin,cout,heads", [(32, 64, 144, 288, 4), (32, 16, 288, 576, 8),
                                                (4, 256, 576, 1152, 16), (6, 4, 32, 64, 1)])
def test_qpool_w8a8_kernel_matches_plain(dev, n, s, cin, cout, heads):
    hd = cout // heads
    params = _w8a8_qpool_params(dev, cin, cout, heads * hd, 4 * cout, seed=52)
    x = _randn(dev, n, s, cin, seed=53)
    launches = hb.fused_qpool_block_w8a8.launches
    got = hb.fused_qpool_block_w8a8(x, params, heads, hd, (2, 2))
    want = hb.fused_qpool_block_w8a8_plain(x, params, heads, hd, (2, 2))
    torch.cuda.synchronize()
    assert hb.fused_qpool_block_w8a8.launches == launches + 1
    assert got.shape == (n, s // 4, cout)
    _assert_close(got, want, row_rel=5e-2)
    # zero projection and zero MLP: the block returns the pooled shortcut,
    # taken from the bf16 front after its rescale (exact on both sides up to
    # a flipped step in the front's rows)
    zeroed = list(params)
    for i in (5, 7, 10, 12, 13, 15):  # the kernels and biases of proj, fc1 and fc2
        zeroed[i] = torch.zeros_like(params[i])
    got = hb.fused_qpool_block_w8a8(x, tuple(zeroed), heads, hd, (2, 2))
    want = hb.fused_qpool_block_w8a8_plain(x, tuple(zeroed), heads, hd, (2, 2))
    torch.cuda.synchronize()
    _assert_close(got, want)


def test_qpool_w8a8_kernel_with_the_bf16_polynomial_matches_plain(dev):
    """Act code 4 (``hiera_gelu="poly_bf16"``): the q-pool block's GELU
    output is quantised in bf16 steps by the kernel's row quantiser and by
    the plain version."""
    n, s, cin, cout, heads = 32, 64, 144, 288, 4
    params = _w8a8_qpool_params(dev, cin, cout, cout, 4 * cout, seed=56)
    x = _randn(dev, n, s, cin, seed=57)
    got = hb.fused_qpool_block_w8a8(x, params, heads, cout // heads, (2, 2),
                                    act="gelu_poly_bf16")
    want = hb.fused_qpool_block_w8a8_plain(x, params, heads, cout // heads, (2, 2),
                                           act="gelu_poly_bf16")
    torch.cuda.synchronize()
    _assert_close(got, want, row_rel=5e-2)


def test_w8a8_part_wrappers_refuse_what_the_kernels_do_not_take(dev):
    params = _w8a8_block_params(dev, 64, 64, 256, seed=54)
    x = _randn(dev, 2, 16, 64, seed=55)
    with pytest.raises(TypeError, match="bf16 activations and int8 weights"):
        hb.fused_ln_matmul_w8a8(x.float(), *params[:5])
    with pytest.raises(TypeError, match="bf16 activations and int8 weights"):
        hb.fused_block_tail_w8a8(x, x, (params[5].float(),) + params[6:])
    with pytest.raises(ValueError, match="shapes do not match"):
        hb.fused_block_tail_w8a8(x, x[..., :32], params[5:])
    with pytest.raises(ValueError, match="weight shapes do not match"):
        hb.fused_qpool_block_w8a8(x, params, 2, 32, (2, 2))
    with pytest.raises(ValueError, match="unsupported shapes"):
        hb.fused_ln_matmul_w8a8(x[..., :32], *params[:5])


def test_quantised_hiera_trunk_kernel_path_matches_plain_path(dev):
    """A narrow quantised trunk with every route (whole block, q-pool,
    global front + flash + tail) on the card: kernel path against plain
    path, cosine >= 0.99 per stage (re-quantise flips through 5 blocks)."""
    from ufvideo_tpu_torch.configs import SAM2HieraConfig
    from ufvideo_tpu_torch.models import init
    from ufvideo_tpu_torch.models.sam2.hiera import Hiera

    cfg = SAM2HieraConfig(embed_dim=72, num_heads=1, stages=(1, 2, 1, 1), global_att_blocks=(2,),
                          window_spec=(8, 4, 8, 4), image_size=256)
    trunk = Hiera(cfg, torch.bfloat16, quant=True).to(dev).eval()
    init.reset_tree_(trunk, torch.Generator(device=dev).manual_seed(56))
    assert [b.route for b in trunk.blocks] == ["block", "qpool", "split", "qpool", "qpool"]
    x = _randn(dev, 2, 256, 256, 3, seed=57)
    counted = (hb.fused_block_w8a8, hb.fused_qpool_block_w8a8, hb.fused_ln_matmul_w8a8,
               hb.fused_block_tail_w8a8)
    before = [f.launches for f in counted]
    with torch.no_grad():
        got = trunk(x)
        for blk in trunk.blocks:
            blk.use_kernels = False
        want = trunk(x)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counted, before)] == [1, 3, 1, 1]
    for g, w in zip(got, want):
        cos = torch.nn.functional.cosine_similarity(
            g.float().flatten(), w.float().flatten(), dim=0)
        assert torch.isfinite(g).all() and float(cos) > 0.99


# ------------------------------------ packed attention, the stage, the probe --
# The packed-qkv attention kernels (unfused SigLIP, Hiera's windowed
# MultiScaleAttention), the multi-block stage, the polynomial GELUs in the
# block kernels and the int8-rate probe's two products.

from ufvideo_tpu_torch.ops.vit_attention import (  # noqa: E402
    mha_full_attention_packed, mha_full_attention_packed_plain)
from ufvideo_tpu_torch.ops.window_attention import (  # noqa: E402
    fused_window_attention, fused_window_attention_plain)


@pytest.mark.parametrize("b,s,heads,d", [(2, 729, 16, 72), (3, 50, 2, 72), (2, 17, 4, 16)])
def test_packed_mha_kernel_matches_plain(dev, b, s, heads, d):
    qkv = _randn(dev, b, s, 3 * heads * d, seed=60)
    before = mha_full_attention_packed.launches
    got = mha_full_attention_packed(qkv, heads, d)
    want = mha_full_attention_packed_plain(qkv, heads, d)
    torch.cuda.synchronize()
    assert mha_full_attention_packed.launches == before + 1
    assert got.shape == (b, s, heads * d)
    # probabilities rounded to bf16 before normalising (kernel) or after
    # (plain): over few keys each is large enough for its bf16 step to show,
    # as in the block's attention part
    _assert_close(got.reshape(b, s, heads, d), want.reshape(b, s, heads, d), row_rel=5e-2)


@pytest.mark.parametrize("nw,s,heads,d", [(64, 16, 2, 72), (16, 64, 4, 72), (4, 256, 8, 72),
                                          (5, 50, 2, 72), (7, 16, 1, 16)])
def test_window_attention_kernel_matches_plain(dev, nw, s, heads, d):
    qkv = _randn(dev, nw, s, 3 * heads * d, seed=61)
    got = fused_window_attention(qkv, heads, d)
    want = fused_window_attention_plain(qkv, heads, d)
    torch.cuda.synchronize()
    _assert_close(got.reshape(nw, s, heads, d), want.reshape(nw, s, heads, d), row_rel=5e-2)


def test_window_attention_kernel_keeps_windows_apart(dev):
    """A 16-token window fills a quarter of the kernel's 64-row tile: new
    keys and values in one window leave every other window's output
    unchanged, bit for bit, and windows past the 65535th are reached (the
    persistent grid walks every window)."""
    nw, s, heads, d = 70000, 16, 1, 8
    qkv = _randn(dev, nw, s, 3 * heads * d, seed=62)
    base = fused_window_attention(qkv, heads, d)
    for w in (5, 66000):
        pert = qkv.clone()
        pert[w, :, heads * d:] = _randn(dev, s, 2 * heads * d, seed=63 + w)
        got = fused_window_attention(pert, heads, d)
        torch.cuda.synchronize()
        moved = (got.float() - base.float()).abs().amax(dim=(1, 2))
        assert float(moved[w]) > 1e-2
        moved[w] = 0
        assert float(moved.max()) == 0.0
    tail = fused_window_attention_plain(qkv[-8:], heads, d)
    _assert_close(base[-8:].reshape(8, s, heads, d), tail.reshape(8, s, heads, d),
                  row_rel=5e-2)


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_stage_kernel_matches_plain_and_the_block_kernel(dev, nb):
    from ufvideo_tpu_torch.ops.hiera_block import fused_hiera_stage, fused_hiera_stage_plain

    n, s, c, heads = 8, 64, 144, 2
    plist = [tuple((t.float() * (1 + 0.05 * j)).to(t.dtype) for t in _block_params(dev, c, 4 * c))
             for j in range(nb)]
    x = _randn(dev, n, s, c, seed=64)
    before = (fused_hiera_stage.launches, fused_hiera_block.launches)
    got = fused_hiera_stage(x, plist, heads, 72)
    want = fused_hiera_stage_plain(x, plist, heads, 72)
    torch.cuda.synchronize()
    assert (fused_hiera_stage.launches, fused_hiera_block.launches) == (before[0] + 1, before[1])
    _assert_close(got, want, row_rel=5e-2)
    # the same launches as nb block calls, in the same order: equal bits
    seq = x
    for p in plist:
        seq = fused_hiera_block(seq, p, heads, 72)
    torch.cuda.synchronize()
    assert torch.equal(got, seq)


@pytest.mark.parametrize("act", ["gelu_poly", "gelu_poly_bf16", "gelu_tanh_poly",
                                 "gelu_tanh_poly_bf16"])
def test_polynomial_gelus_in_the_block_kernels(dev, act):
    n, s, c, heads = 6, 50, 144, 2
    params = _block_params(dev, c, 4 * c)
    x = _randn(dev, n, s, c, seed=65)
    got = fused_hiera_block(x, params, heads, 72, act=act)
    want = fused_hiera_block_plain(x, params, heads, 72, act=act)
    torch.cuda.synchronize()
    _assert_close(got, want, row_rel=5e-2)
    # the GELU alone, through the tail with the projection and fc2 the identity
    h = _randn(dev, 1, 64, 64, seed=66, scale=3.0)
    eye, z = torch.eye(64, device=dev, dtype=torch.bfloat16), torch.zeros(64, device=dev)
    one = torch.ones(64, device=dev)
    tail = (torch.zeros_like(eye), z, one, z, eye, z, eye, z)  # x1 = h; LN; GELU; + x1
    got = fused_block_tail(h, h, tail, act=act)
    want = fused_block_tail_plain(h, h, tail, act=act)
    torch.cuda.synchronize()
    _assert_close(got, want)
    wq = _w8a8_block_params(dev, c, heads * 72, 4 * c, seed=67)
    got = fused_block_w8a8(x, wq, heads, 72, act=act)
    want = fused_block_w8a8_plain(x, wq, heads, 72, act=act)
    torch.cuda.synchronize()
    _assert_close(got, want, row_rel=5e-2)


@pytest.mark.parametrize("m,k,n", [(40, 144, 56), (8192, 1152, 4304), (77, 1160, 130)])
def test_probe_kernels_match_plain(dev, m, k, n):
    from ufvideo_tpu_torch.probe_int8_rate import probe_inputs, probe_step, probe_step_plain

    x, wf, wq = probe_inputs(dev, 68, m, k, n)
    x[0, :3] = torch.tensor([200.0, -300.0, 2.5], device=dev)  # clipped, clipped, a tie
    before = probe_step.launches
    got = probe_step(x, wq, True)
    want = probe_step_plain(x, wq, True)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if n % 8 == 0:
        got = probe_step(x, wf, False)
        want = probe_step_plain(x, wf, False)
        torch.cuda.synchronize()
        rel = float((got - want).norm() / want.norm())
        assert got.dtype == torch.float32 and rel <= 1e-3, rel
    assert probe_step.launches == before + 1 + (n % 8 == 0)


@pytest.mark.parametrize("rows,din,dout", [(5, 50, 24), (729, 1152, 3456), (40, 144, 30)])
def test_w8a8_linear_on_the_card_equals_the_cpu(dev, rows, din, dout):
    """``torch._int_mm`` (rows padded past 16, K and N to multiples of 8)
    gives the exact integer sums the CPU computes in float64, from the
    layer's K-contiguous weights and from a row-major copy alike."""
    from ufvideo_tpu_torch.quant import W8A8Linear

    lin = W8A8Linear(din, dout, torch.bfloat16)
    lin.set_kernel(torch.randn(din, dout, generator=torch.Generator().manual_seed(69)))
    with torch.no_grad():
        lin.bias.copy_(torch.randn(dout, generator=torch.Generator().manual_seed(70)))
    x = torch.randn(rows, din, generator=torch.Generator().manual_seed(71)).to(torch.bfloat16)
    q, xs = tq.quantize_rows(x)
    q_d, xs_d = tq.quantize_rows(x.to(dev))
    assert torch.equal(q_d.cpu(), q) and torch.equal(xs_d.cpu(), xs)
    acc = tq._int8_matmul(q, lin.kernel_q)
    acc_d = tq._int8_matmul(q_d, lin.kernel_q.to(dev)).cpu()
    bad = (acc_d != acc).nonzero()
    assert bad.numel() == 0, (bad[:5].tolist(), acc_d[tuple(bad[0])], acc[tuple(bad[0])])
    assert lin.kernel_q.to(dev).stride() == (1, din)
    assert torch.equal(tq._int8_matmul(q_d, lin.kernel_q.contiguous().to(dev)).cpu(), acc)
    want = lin(x)
    got = lin.to(dev)(x.to(dev)).cpu()
    torch.cuda.synchronize()
    bad = (got != want).nonzero()
    assert bad.numel() == 0, (bad.shape[0], bad[:5].tolist(), got[tuple(bad[0])],
                              want[tuple(bad[0])])


def test_routed_hiera_kernel_paths_match_plain_paths(dev):
    """A narrow Hiera under the bf16 routing of chip_smoke.py phase 7a
    (stage fusion, split q-pool, polynomial GELU) and its W8A8 twin under
    7b's (generic special blocks), each against its plain path."""
    from ufvideo_tpu_torch.configs import SAM2HieraConfig, VisionRouting
    from ufvideo_tpu_torch.models import init
    from ufvideo_tpu_torch.models.sam2.hiera import Hiera
    from ufvideo_tpu_torch.quant import w8a8_linear

    cfg = SAM2HieraConfig(embed_dim=72, num_heads=1, stages=(2, 3, 2, 1), global_att_blocks=(4,),
                          window_spec=(8, 4, 8, 4), image_size=256)
    x = _randn(dev, 2, 256, 256, 3, seed=72)
    for quant, routing, want_calls in (
            (False, VisionRouting(qpool_fused=False, hiera_stage_nb=4, hiera_gelu="poly"),
             {"stage": 1, "split": 4, "block": 2}),
            (True, VisionRouting(sam2_int8_special=False), {"block": 4, "generic": 4})):
        trunk = Hiera(cfg, torch.bfloat16, quant=quant, routing=routing).to(dev).eval()
        init.reset_tree_(trunk, torch.Generator(device=dev).manual_seed(73))
        routes = trunk.call_routes()
        assert {r: routes.count(r) for r in set(routes)} == want_calls
        calls = w8a8_linear.calls
        with torch.no_grad():
            got = trunk(x)
            for m in trunk.modules():
                if hasattr(m, "use_kernels"):
                    m.use_kernels = False
            want = trunk(x)
        torch.cuda.synchronize()
        assert (w8a8_linear.calls - calls > 0) == quant
        for g, w in zip(got, want):
            cos = torch.nn.functional.cosine_similarity(
                g.float().flatten(), w.float().flatten(), dim=0)
            assert torch.isfinite(g).all() and float(cos) > 0.99


# ------------------------------------------------------------ int8 GEMM --
# The TMA + wgmma s8 GEMM behind the probe's int8 product and every int8
# product of the four W8A8 entry points. int32 sums are exact on both sides,
# so the probe's product equals its plain version: at row counts off the
# 128-row tile, column counts off both tile widths (128, 256), and every K
# the W8A8 blocks use (144 and 288 leave most of a 128-byte K stage to TMA's
# zero fill; K >= 1024 with N >= 2048 takes the 256-wide tile). Row 0 holds
# ties and values past ±127, so the rounding pass is held to half-to-even
# and the clip.

from ufvideo_tpu_torch import probe_int8_rate as pr  # noqa: E402

S8_M, S8_N = (1, 200, 2917), (432, 1728, 2066, 4304)
S8_K = (144, 288, 576, 1152, 2304, 4304, 4608)


def _s8_inputs(dev, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (40 * torch.randn(m, k, generator=g, device=dev)).to(torch.bfloat16)
    ties = torch.tensor([0.5, -0.5, 1.5, -1.5, 126.5, -126.5, 127.5, -127.5, 128.0, -300.0],
                        device=dev)
    x[0, :ties.numel()] = ties.to(torch.bfloat16)
    w = torch.randint(-127, 128, (k, n), generator=g, device=dev).to(torch.int8)
    return x, w


@pytest.mark.parametrize("k", S8_K)
@pytest.mark.parametrize("n", S8_N)
@pytest.mark.parametrize("m", S8_M)
def test_s8_gemm_equals_plain(dev, m, k, n):
    x, w = _s8_inputs(dev, m, k, n, seed=80)
    launches = pr.probe_step.launches
    got = pr.probe_step(x, w, True)
    want = pr.probe_step_plain(x, w, True)
    torch.cuda.synchronize()
    assert pr.probe_step.launches == launches + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(2917, 144, 4304), (200, 1152, 4304), (2917, 4304, 1152)])
def test_s8_gemm_repeats_bit_for_bit_and_alone_equals_plain(dev, m, k, n):
    """Two probe calls agree bit for bit, and the GEMM alone on operands
    already rounded, padded and transposed equals the same plain sums."""
    x, w = _s8_inputs(dev, m, k, n, seed=81)
    first, second = pr.probe_step(x, w, True), pr.probe_step(x, w, True)
    kp = -(-k // 32) * 32
    qa = pr.round_clip_s8_plain(x, kp)
    bt = torch.nn.functional.pad(w.t(), (0, kp - k)).contiguous()
    alone = pr.gemm_s8_alone(qa, bt)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(alone, pr.probe_step_plain(x, w, True))
    with pytest.raises(ValueError):
        pr.gemm_s8_alone(qa[:, :24], bt[:, :24])  # Kp not a multiple of 16


# ------------------------------------------------ the LayerNorm-band GEMM --
# fused_ln_matmul and the LN2 -> fc1 step of fused_block_tail on one launch of
# ln_gemm_kernel for C <= 576 (a band of 128 rows normalised in shared
# memory, W streamed past it); C = 1152 keeps the pair of launches. Rows on
# and off the band (1, 127, 129, 16384), N on and off the 128-column tile.

from ufvideo_tpu_torch.ops import hiera_block as hb  # noqa: E402

LN_GEMM_ROWS = [1, 127, 129, 16384]


def _ln_inputs(dev, rows, c, d, seed):
    x = _randn(dev, 1, rows, c, seed=seed)
    ln_s = (1.0 + _randn(dev, c, seed=seed + 1, scale=0.1).float()).to(torch.bfloat16)
    ln_b = _randn(dev, c, seed=seed + 2, scale=0.1)
    w = _randn(dev, c, d, seed=seed + 3, scale=c ** -0.5)
    return x, ln_s, ln_b, w, _randn(dev, d, seed=seed + 4, scale=0.1)


@pytest.mark.parametrize("rows", LN_GEMM_ROWS)
@pytest.mark.parametrize("c,d", [(144, 432), (144, 1024), (288, 864), (288, 1024),
                                 (576, 1728), (576, 2304)])
def test_ln_gemm_ln_matmul_matches_plain(dev, rows, c, d):
    assert hb.ln_gemm_plan(rows, c, d).route == "ln_gemm"
    args = _ln_inputs(dev, rows, c, d, seed=90)
    before = fused_ln_matmul.launches
    got = fused_ln_matmul(*args)
    want = fused_ln_matmul_plain(*args)
    torch.cuda.synchronize()
    assert fused_ln_matmul.launches == before + 1
    assert got.shape == (1, rows, d)
    _assert_close(got, want)


@pytest.mark.parametrize("rows", LN_GEMM_ROWS)
@pytest.mark.parametrize("c", [144, 288, 576])
def test_ln_gemm_block_tail_matches_plain(dev, rows, c):
    mlp = 4 * c
    assert hb.ln_gemm_plan(rows, c, mlp).route == "ln_gemm"
    shortcut, att = _randn(dev, 1, rows, c, seed=91), _randn(dev, 1, rows, c, seed=92)
    params = _tail_params(dev, c, c, mlp)
    before = fused_block_tail.launches
    got = fused_block_tail(shortcut, att, params, act="gelu_exact")
    want = fused_block_tail_plain(shortcut, att, params, act="gelu_exact")
    torch.cuda.synchronize()
    assert fused_block_tail.launches == before + 1
    _assert_close(got, want, row_rel=5e-2)


@pytest.mark.parametrize("act", list(hb._ACT_CODES))
def test_ln_gemm_block_tail_every_gelu(dev, act):
    shortcut, att = _randn(dev, 2, 150, 576, seed=93), _randn(dev, 2, 150, 576, seed=94)
    params = _tail_params(dev, 576, 576, 2304)
    got = fused_block_tail(shortcut, att, params, act=act)
    want = fused_block_tail_plain(shortcut, att, params, act=act)
    torch.cuda.synchronize()
    _assert_close(got, want, row_rel=5e-2)


def test_ln_gemm_repeats_bit_for_bit(dev):
    args = _ln_inputs(dev, 3000, 576, 1728, seed=95)
    first, second = fused_ln_matmul(*args), fused_ln_matmul(*args)
    shortcut, att = _randn(dev, 1, 3000, 288, seed=96), _randn(dev, 1, 3000, 288, seed=97)
    params = _tail_params(dev, 288, 288, 1152)
    t1 = fused_block_tail(shortcut, att, params)
    t2 = fused_block_tail(shortcut, att, params)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(t1, t2)


def test_ln_gemm_wide_rows_keep_the_pair(dev):
    """C = 1152 (SigLIP, Hiera's stage 4): the plan gives the pair of
    launches, and both wrappers run it."""
    rows, c = 300, 1152
    assert hb.ln_gemm_plan(rows, c, 4 * c).route == "pair"
    shortcut, att = _randn(dev, 1, rows, c, seed=98), _randn(dev, 1, rows, c, seed=99)
    params = _tail_params(dev, c, c, 4 * c)
    before = fused_block_tail.launches
    got = fused_block_tail(shortcut, att, params, act="gelu_tanh")
    want = fused_block_tail_plain(shortcut, att, params, act="gelu_tanh")
    args = _ln_inputs(dev, rows, c, 3 * c, seed=100)
    got_ln, want_ln = fused_ln_matmul(*args), fused_ln_matmul_plain(*args)
    torch.cuda.synchronize()
    assert fused_block_tail.launches == before + 1
    _assert_close(got, want, row_rel=5e-2)
    _assert_close(got_ln, want_ln)


def test_ln_gemm_entry_refuses_another_plan(dev):
    """The C entry points launch only the plan they were built for."""
    x, ln_s, ln_b, w, b = _ln_inputs(dev, 256, 576, 1728, seed=101)
    vecs = [t.float().contiguous() for t in (ln_s, ln_b, b)]
    out = torch.empty(256, 1728, dtype=torch.bfloat16, device=dev)
    plan = hb.ln_gemm_plan(256, 576, 1728)
    lib = hb._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (x, vecs[0], vecs[1], w, vecs[2], out)]
    for bad in ((plan.bm, plan.bn, plan.stages + 1, 1), (plan.bm, 256, plan.stages, 1),
                (plan.bm, plan.bn, plan.stages, 2), (0, 0, 0, 0)):
        assert lib.ln_matmul_bf16(*ptrs, 256, 576, 1728, *bad, 1e-6, stream) != 0
    assert lib.ln_matmul_bf16(*ptrs, 256, 576, 1728, *plan.args, 1e-6, stream) == 0
    xn = torch.empty_like(x)
    pair = ptrs[:5] + [xn.data_ptr(), out.data_ptr()]
    assert lib.ln_matmul_pair_bf16(*pair, 256, 576, 1728, 1e-6, stream) != 0
    torch.cuda.synchronize()
    _assert_close(out[None], fused_ln_matmul_plain(x, ln_s, ln_b, w, b))


# The block GEMM (gemm in csrc/hiera_block.cu) on each of its routes. The
# ping-pong kernel (the plan's route but at Hiera stage 1) at SigLIP's four products
# (M = 23328) and off every edge: M = 1, 127, 129; N on and off the
# 128-column tile (N must be a multiple of 8: 136 for "off"); K = 1152 and
# 4304; fewer tiles than SMs, a block with a single tile (its second
# warpgroup idle) and an odd tile count. The ping-pong kernel and
# gemm_kernel's 128 x 128 tile (the plan's for Hiera stage 1) at K < 1024,
# at Hiera's products and off their edges, and gemm_kernel's 128 x 256 tile
# for the f32 sum.
# Every epilogue: none, the residual, the six GELUs and the f32 sum, against
# the plain math, twice, bit for bit.

from test_torch_gemm_plan import PRODUCT_SHAPES  # noqa: E402

PP_SHAPES = [(23328, 3456, 1152), (23328, 1152, 1152), (23328, 4304, 1152),
             (23328, 1152, 4304), (1, 1152, 1152), (127, 4304, 1152), (129, 136, 4304),
             (129, 1152, 4304)]
TILE_SHAPES = [(65536, 288, 1152), (262144, 144, 144), (129, 288, 288), (127, 136, 576),
               (1, 1152, 144)]
EPILOGUES = ["none", "residual", "f32", *hb._ACT_CODES]


def _check_block_gemm(dev, m, n, k, epi, route):
    """The f32 sums (the f32 epilogue: acc + bias) on ``route`` against the
    plain f32 product to the probe's 1e-3; every bf16 epilogue equal to the
    plain epilogue on those same sums, bit for bit (no activation, the
    residual, the bf16 polynomials), or, where the card's f32 activation
    rounds otherwise than PyTorch's (tanhf / erff, the f32 polynomials'
    contracted multiply-adds), within one bf16 step of the output plus a few
    f32 steps of the input (2^-20 of |x|: the GELU's tail cancels 0.5 against
    x·Q down to outputs far below |x|); two launches bit for bit."""
    a = _randn(dev, m, k, seed=110)
    w = _randn(dev, k, n, seed=111, scale=k ** -0.5)
    bias = _randn(dev, n, seed=112, scale=0.1)
    act = epi if epi in hb._ACT_CODES else None
    res = _randn(dev, m, n, seed=113) if epi == "residual" else None
    run = functools.partial(hb.block_gemm_alone, a, w, bias, route=route)
    sums = run(f32=True)
    first = run(residual=res, act=act, f32=epi == "f32")
    second = run(residual=res, act=act, f32=epi == "f32")
    want = hb.block_gemm_plain(a, w, bias, f32=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _assert_close(sums, want, row_rel=1e-3, rtol=1e-3, rel=1e-3)
    if epi == "f32":
        assert torch.equal(first, sums)
        return
    own = hb.block_gemm_epilogue(sums, res, act)
    if epi in ("gelu_tanh", "gelu_exact", "gelu_poly", "gelu_tanh_poly"):
        d = (first.float() - own.float()).abs()
        excess = d - (2.0 ** -7 * own.float().abs() + 2.0 ** -20 * sums.abs())
        worst = int(excess.argmax())
        assert float(excess.max()) <= 0, (
            f"x {float(sums.flatten()[worst])}: {float(first.flatten()[worst])} against "
            f"{float(own.flatten()[worst])}")
    else:
        assert torch.equal(first, own)


@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("m,n,k", PP_SHAPES)
def test_block_gemm_ping_pong_every_epilogue(dev, m, n, k, epi):
    """The ping-pong kernel, the plan's route at these shapes' bf16 outputs
    but N = 136 (the 128 x 128 tile's), through every epilogue
    (_check_block_gemm)."""
    assert hb.block_gemm_plan(m, n, k).route == ("128" if n <= 144 else "pp")
    _check_block_gemm(dev, m, n, k, epi, "pp")


@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("m,n,k", TILE_SHAPES)
@pytest.mark.parametrize("route", ["pp", "128"])
def test_block_gemm_tiles_every_epilogue(dev, route, m, n, k, epi):
    """The ping-pong kernel and the 128 x 128 tile at Hiera's short K
    through every epilogue (_check_block_gemm)."""
    _check_block_gemm(dev, m, n, k, epi, route)


@pytest.mark.parametrize("m,n,k", TILE_SHAPES + PP_SHAPES)
def test_block_gemm_f32_sum_on_the_256_tile(dev, m, n, k):
    """The plan's route for the f32 sum (the probe's product)."""
    assert hb.block_gemm_plan(m, n, k, f32=True).route == "256"
    _check_block_gemm(dev, m, n, k, "f32", None)


def test_block_gemm_plan_on_the_card_equals_python(dev):
    """The C side's plan (block_gemm_plan_query) is the Python one at every
    product shape of tests/test_torch_gemm_plan.py, on 132 and 114 SMs and
    on this card's count; both refuse K or N off a multiple of 8."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, n, k in PRODUCT_SHAPES:
        for f32 in (False, True):
            for s in (132, 114):
                assert (hb.block_gemm_plan_on_card(m, n, k, s, f32)
                        == hb.block_gemm_plan(m, n, k, s, f32).code)
            assert (hb.block_gemm_plan_on_card(m, n, k, 0, f32)
                    == hb.block_gemm_plan(m, n, k, sms, f32).code)
    for m, n, k in ((8, 130, 1152), (8, 8, 1020), (0, 8, 1152)):
        with pytest.raises(ValueError):
            hb.block_gemm_plan(m, n, k)
        with pytest.raises(RuntimeError):
            hb.block_gemm_plan_on_card(m, n, k)


# ------------------------------------------------ streaming and speculation --
# Qwen2-7B's widths at a depth of two layers, random bf16 weights from a
# seed, on the card: the streamed decode runs the fused loop's kernels at
# the same shapes, so it must equal it bit for bit; a speculative verify
# step runs other products (K + 1 rows) and the plain masked attention, so
# its tokens equal greedy decoding's but where the greedy logits' gap
# between the two tokens is below the runs' largest logit difference there.

def _card_lm(dev, quant=False, seed=0):
    from ufvideo_tpu_torch.configs import UFVideoConfig
    from ufvideo_tpu_torch.models.qwen2 import Qwen2LM

    cfg = dataclasses.replace(UFVideoConfig().llm, num_layers=2)
    with torch.device("meta"):
        lm = Qwen2LM(cfg, dtype=torch.bfloat16, quant=quant)
    lm = lm.to_empty(device=dev)
    lm.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return lm.eval()


def _card_prompt(dev, lm, lens, seed=1):
    """Ids with a phrase repeated (so that lookup drafts), their embeddings."""
    g = torch.Generator(device=dev).manual_seed(seed)
    phrase = torch.randint(3, 150000, (len(lens), 40), generator=g, device=dev)
    rest = torch.randint(3, 150000, (len(lens), max(lens) - 80), generator=g, device=dev)
    ids = torch.cat([phrase, rest, phrase], dim=1)
    with torch.no_grad():
        return ids, lm.embed(ids)


class _Logits:
    """Keeps what ``lm.logits`` returns (f32) while active."""

    def __init__(self, lm):
        self.lm = lm

    def __enter__(self):
        real, self.calls = self.lm.logits, []
        self.lm.logits = lambda h: self.calls.append(real(h).float()) or self.calls[-1]
        return self

    def __exit__(self, *exc):
        del self.lm.logits


@pytest.mark.parametrize("quant,kv_quant", [(False, False), (False, True), ("int8", True),
                                            ("int4", False)],
                         ids=["bf16", "bf16-kv8", "int8-kv8", "int4"])
def test_stream_generate_equals_greedy_bit_for_bit(dev, quant, kv_quant):
    from ufvideo_tpu_torch.models.generate import greedy_generate, stream_generate

    lm = _card_lm(dev, quant)
    lens = torch.tensor([300, 211], device=dev)
    _, emb = _card_prompt(dev, lm, [300, 300])
    kw = dict(max_new_tokens=12, stop_ids=(-1,), cache_max_len=312, vocab_size=152064,
              kv_quant=kv_quant)
    fused = greedy_generate(lm, emb, lens, **kw)
    rows, hid = [[], []], [[], []]
    for tokens, n, hiddens, _ in stream_generate(lm, emb, lens, chunk=5, **kw):
        for i, k in enumerate(n.tolist()):
            rows[i] += tokens[i, :k].tolist()
            hid[i].append(hiddens[i, :k])
    for i in range(2):
        k = int(fused.gen_lens[i])
        assert rows[i] == fused.tokens[i, :k].tolist()
        assert torch.equal(torch.cat(hid[i]), fused.hidden[i, :k])


@pytest.mark.parametrize("quant,kv_quant", [(False, False), ("int8", True), ("int4", False)],
                         ids=["bf16", "int8-kv8", "int4"])
def test_spec_generate_equals_greedy_tokens_but_at_a_near_tie(dev, quant, kv_quant):
    from ufvideo_tpu_torch.models.generate import greedy_generate
    from ufvideo_tpu_torch.models.speculative import spec_stream_generate
    from ufvideo_tpu_torch.ops import quant_matmul as qm

    lm = _card_lm(dev, quant, seed=2)
    lens = torch.tensor([300], device=dev)
    ids, emb = _card_prompt(dev, lm, [300], seed=3)
    kw = dict(max_new_tokens=16, stop_ids=(-1,), vocab_size=152064, kv_quant=kv_quant)
    with _Logits(lm) as plain:
        fused = greedy_generate(lm, emb, lens, cache_max_len=320, **kw)
    toks, logits = [], []
    with _Logits(lm) as rec:
        prev = 0
        for tokens, gen_lens, _, _ in spec_stream_generate(
                lm, emb, lens, ids, cache_max_len=320, draft_k=4, **kw):
            n = int(gen_lens[0])
            toks += tokens[0, prev:n].tolist()
            logits += list(rec.calls[-1][0, :n - prev])
            prev = n
    if quant:
        wrapper = qm.int4_matmul if quant == "int4" else qm.int8_matvec
        assert wrapper.last_plan.rows == 5  # the verify block, B = 1 and K = 4
    want = fused.tokens[0, :int(fused.gen_lens[0])].tolist()
    assert len(toks) == len(want)
    for p, (a, b) in enumerate(zip(want, toks)):
        if a != b:
            lp, ls = plain.calls[p][0, -1], logits[p]
            assert float(lp[a] - lp[b]) < float((lp - ls).abs().max()), p
            break


# ------------------------------------------------------- frames on the card --
# tests/test_torch_tensor_inputs.py's cases with every input a tensor on the
# card, against the same inputs as numpy arrays, on a tiny runtime on the
# card. Its float32 widths are not the kernels' (bf16 at the model's widths),
# so it runs the plain versions there: what is under test is the input path.
# chip_smoke.py phase 6b sends card frames through the kernels at full width.

@pytest.fixture
def card_runtime(dev):
    from ufvideo_tpu_torch.api import model_init
    from ufvideo_tpu_torch.configs import tiny_config

    rt, _, tok = model_init(cfg=tiny_config(), device=dev, seed=3)
    rt.model.set_use_kernels(False)
    return rt, tok


@pytest.mark.parametrize("entry", ["mm_infer", "mm_infer_stream", "mm_infer_batch"])
def test_entry_points_take_card_tensors(card_runtime, entry):
    from test_torch_tensor_inputs import CHECKS

    CHECKS[entry](*card_runtime, "cuda")


@pytest.mark.parametrize("fn", ["quantize_kernel", "quantize_kernel4", "quantize_rows",
                                "quantize_kv"])
def test_quantisers_on_the_card_equal_the_cpu(dev, fn):
    """Each quantiser divides by its constant as the CPU does (a Python
    divisor would be a product with the reciprocal on the card): 4096
    amax values give the same scales and int8 steps bit for bit."""
    f = {"quantize_kernel": tq.quantize_kernel, "quantize_rows": tq.quantize_rows,
         "quantize_kernel4": lambda w: tq.quantize_kernel4(w, 64),
         "quantize_kv": quantize_kv}[fn]
    x = torch.randn(256, 4096, generator=torch.Generator().manual_seed(5)) * 3.0
    want, got = f(x), f(x.to(dev))
    for a, b in zip(want.values() if isinstance(want, dict) else want,
                    got.values() if isinstance(got, dict) else got):
        assert b.device.type == "cuda" and torch.equal(b.cpu(), a), fn


@pytest.mark.parametrize("quant", [{}, dict(quant_llm="int8", quant_kv=True, quant_vision=True)],
                         ids=["bf16", "int8-kv8-w8a8"])
def test_checkpoint_loads_to_the_card_as_to_the_cpu(dev, tmp_path, quant):
    """A tiny bf16 checkpoint loaded by ``model_init(model_path=)`` to the
    card equals the same loaded to the CPU bit for bit, every parameter and
    buffer, float and quantised (each layer quantised on the card)."""
    from ufvideo_tpu_torch.api import model_init
    from ufvideo_tpu_torch.configs import tiny_config
    from ufvideo_tpu_torch.export import save_hf_checkpoint

    cfg = tiny_config().replace(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    src, _, _ = model_init(cfg=cfg, device="cpu", seed=3)
    save_hf_checkpoint(str(tmp_path), src.model)
    cfg = cfg.replace(**quant)
    cpu, _, _ = model_init(str(tmp_path), cfg=cfg, device="cpu")
    card, _, _ = model_init(str(tmp_path), cfg=cfg, device=dev)
    want = dict([*cpu.model.named_parameters(), *cpu.model.named_buffers()])
    got = dict([*card.model.named_parameters(), *card.model.named_buffers()])
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.device.type == "cuda" and t.dtype == want[k].dtype, k
        assert torch.equal(t.cpu(), want[k]), k


def test_safetensors_views_copy_to_the_card(dev, tmp_path):
    """The port's ``.safetensors`` reader (the card's machine has no
    ``safetensors`` package): its read-only views of the file, at offsets
    that are not multiples of their element size too, copy to the card
    intact, and convert on the way as on the CPU."""
    import json
    import struct

    from ufvideo_tpu_torch.checkpoints import read_safetensors

    g = torch.Generator().manual_seed(0)
    f = torch.randn(37, 19, generator=g)
    tensors = {"a_i8": torch.arange(-3, 0, dtype=torch.int8), "b_bf16": f.bfloat16(),
               "c_f16": f.half(), "d_f32": f, "e_i64": torch.arange(5) - 2,
               "f_bool": torch.tensor([True, False, True]), "g_u8": torch.arange(7, dtype=torch.uint8)}
    names = {torch.int8: "I8", torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32", torch.int64: "I64", torch.bool: "BOOL", torch.uint8: "U8"}
    header, blobs, at = {}, [], 0
    for k, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [at, at + len(raw)]}
        blobs.append(raw)
        at += len(raw)
    head = json.dumps(header).encode()
    path = tmp_path / "m.safetensors"
    path.write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))
    got = read_safetensors(str(path))
    assert got.keys() == tensors.keys()
    for k, t in tensors.items():
        on_card = got[k].to(dev)
        assert torch.equal(on_card.cpu(), t), k
        if t.is_floating_point():
            dst = torch.empty(t.shape, dtype=torch.float32, device=dev)
            dst.copy_(got[k])
            assert torch.equal(dst.cpu(), t.float()), k


# ---------------------------------------------------------------------------
# gradients through the kernels (ops/autograd.py): the eight wrappers with a
# JAX custom_vjp launch their kernel in the forward and recompute the plain
# version in the backward; every other wrapper refuses a grad input
# ---------------------------------------------------------------------------

from ufvideo_tpu_torch.ops.vit_attention import mha_full_attention_packed  # noqa: E402
from ufvideo_tpu_torch.ops.window_attention import fused_window_attention  # noqa: E402


def _grad_cases(dev):
    """name → (wrapper, plain, args, kwargs, row_rel of the forward)."""
    p144 = _block_params(dev, 144, 576)
    return {
        "flash_attention": (
            flash_attention, flash_attention_plain,
            (_randn(dev, 1, 100, 4, 64, seed=80), _randn(dev, 1, 100, 2, 64, seed=81),
             _randn(dev, 1, 100, 2, 64, seed=82)),
            dict(causal=True, kv_lens=torch.tensor([90], device=dev)), 1e-2),
        "fused_hiera_block": (
            fused_hiera_block, fused_hiera_block_plain,
            (_randn(dev, 3, 100, 144, seed=83), p144, 2, 72), dict(act="gelu_exact"), 5e-2),
        "fused_hiera_stage": (
            hb.fused_hiera_stage, hb.fused_hiera_stage_plain,
            (_randn(dev, 3, 64, 144, seed=84), [p144, _block_params(dev, 144, 576)], 2, 72),
            dict(act="gelu_exact"), 5e-2),
        "fused_ln_matmul": (
            fused_ln_matmul, fused_ln_matmul_plain,
            (_randn(dev, 2, 64, 144, seed=85), p144[0], p144[1],
             _randn(dev, 144, 432, seed=86, scale=144 ** -0.5), p144[3]), {}, 1e-2),
        "fused_block_tail": (
            fused_block_tail, fused_block_tail_plain,
            (_randn(dev, 2, 64, 144, seed=87), _randn(dev, 2, 64, 144, seed=88), p144[4:]),
            dict(act="gelu_exact"), 5e-2),
        "fused_qpool_block": (
            fused_qpool_block, fused_qpool_block_plain,
            (_randn(dev, 5, 64, 144, seed=89), _qpool_params(dev, 144, 288, 4, 72), 4, 72,
             (2, 2)), dict(act="gelu_exact"), 5e-2),
        "fused_window_attention": (
            fused_window_attention, fused_window_attention_plain,
            (_randn(dev, 16, 64, 3 * 4 * 72, seed=90), 4, 72), {}, 5e-2),
        "mha_full_attention_packed": (
            mha_full_attention_packed, mha_full_attention_packed_plain,
            (_randn(dev, 2, 50, 3 * 2 * 72, seed=91), 2, 72), {}, 5e-2),
    }


def _float_leaves(tree, out):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _float_leaves(t, out)
    elif torch.is_tensor(tree) and tree.is_floating_point():
        out.append(tree)
    return out


def _fresh(tree):
    """The same values as new leaves that require a gradient."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_fresh(t) for t in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.detach().clone().requires_grad_(True)
    return tree


GRAD_WRAPPERS = ["flash_attention", "fused_hiera_block", "fused_hiera_stage", "fused_ln_matmul",
                 "fused_block_tail", "fused_qpool_block", "fused_window_attention",
                 "mha_full_attention_packed"]


@pytest.mark.parametrize("name", GRAD_WRAPPERS)
def test_kernel_route_gradients_equal_the_plain_route(dev, name):
    """Inputs and weights requiring gradients: the forward launches the
    kernel once (and agrees with the plain version within the file's
    limits), and the gradient of every input equals the plain route's
    within the same limits (the backward is the plain version's,
    recomputed on the same inputs, so only the upstream gradient's path
    differs: none here, the loss is linear in the output)."""
    wrapper, plain, args, kw, row_rel = _grad_cases(dev)[name]
    ka, pa = _fresh(args), _fresh(args)
    before = wrapper.launches
    out = wrapper(*ka, **kw)
    assert wrapper.launches == before + 1 and out.grad_fn is not None
    ref = plain(*pa, **kw)
    _assert_close(out.detach(), ref.detach(), row_rel=row_rel)
    w = _randn(dev, *out.shape, seed=99)
    got = torch.autograd.grad((out.float() * w.float()).sum(), _float_leaves(ka, []))
    want = torch.autograd.grad((ref.float() * w.float()).sum(), _float_leaves(pa, []))
    assert wrapper.launches == before + 1  # the backward launched nothing
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape, i
        _assert_close(g.reshape(-1, g.shape[-1]) if g.dim() > 1 else g[None],
                      r.reshape(-1, r.shape[-1]) if r.dim() > 1 else r[None], row_rel=row_rel)


def _no_backward_calls(dev):
    m = lambda *shape, dt=torch.bfloat16: torch.zeros(*shape, dtype=dt, device=dev)
    i8 = functools.partial(m, dt=torch.int8)
    f32 = functools.partial(m, dt=torch.float32)
    lens = torch.tensor([5], dtype=torch.int32, device=dev)
    return {
        "ragged_decode_attention": lambda q: ragged_decode_attention(
            q(1, 2, 2, 64), m(1, 2, 16, 64), m(1, 2, 16, 64), lens),
        "ragged_decode_attention_q8": lambda q: da.ragged_decode_attention_q8(
            q(1, 2, 2, 64), i8(1, 2, 16, 64), i8(1, 2, 16, 64), f32(1, 2, 16), f32(1, 2, 16),
            lens),
        "int8_matvec": lambda q: qm.int8_matvec(q(1, 64), i8(64, 32), f32(32)),
        "int4_matmul": lambda q: qm.int4_matmul(q(1, 64), i8(32, 32), f32(1, 32), 64),
        "probe_step": lambda q: pr.probe_step(q(8, 64), m(64, 32), False),
    }


@pytest.mark.parametrize("name", ["ragged_decode_attention", "ragged_decode_attention_q8",
                                  "int8_matvec", "int4_matmul", "probe_step"])
def test_kernels_without_backward_refuse_a_grad_input(dev, name):
    """A CUDA input that requires a gradient raises instead of returning a
    tensor cut off from the graph."""
    call = _no_backward_calls(dev)[name]
    grad = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16, device=dev,
                                      requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        call(grad)


def _w8a8_backward_cases(dev):
    """name → (wrapper, args, kwargs) at Hiera-L's smallest windowed shapes."""
    p = _w8a8_block_params(dev, 144, 144, 576, seed=93)
    return {
        "fused_block_w8a8": (hb.fused_block_w8a8, (_randn(dev, 8, 64, 144, seed=94), p, 2, 72),
                             dict(act="gelu_exact")),
        "fused_qpool_block_w8a8": (
            hb.fused_qpool_block_w8a8,
            (_randn(dev, 8, 64, 144, seed=95), _w8a8_qpool_params(dev, 144, 288, 288, 1152, 96),
             4, 72, (2, 2)), {}),
        "fused_ln_matmul_w8a8": (hb.fused_ln_matmul_w8a8,
                                 (_randn(dev, 2, 64, 144, seed=97), *p[:5]), {}),
        "fused_block_tail_w8a8": (
            hb.fused_block_tail_w8a8,
            (_randn(dev, 2, 64, 144, seed=98), _randn(dev, 2, 64, 144, seed=99), p[5:]),
            dict(act="gelu_exact")),
    }


def _w8a8_grads(fn, args, kw, use_kernel, g=None):
    leaves = []

    def copy(t):
        if isinstance(t, (tuple, list)):
            return type(t)(copy(x) for x in t)
        if torch.is_tensor(t) and t.is_floating_point():
            t = t.detach().clone().requires_grad_(True)
            leaves.append(t)
        return t

    out = fn(*copy(args), **kw, use_kernel=use_kernel)
    g = _randn(out.device, *out.shape, seed=100) if g is None else g
    return torch.autograd.grad(out, leaves, g), g


@pytest.mark.parametrize("name", ["fused_block_w8a8", "fused_qpool_block_w8a8",
                                  "fused_ln_matmul_w8a8", "fused_block_tail_w8a8"])
def test_w8a8_backward_on_the_card(dev, name):
    """The kernel forward with the straight-through backward against the
    plain W8A8 forward with the same backward: every float input's gradient
    within the training limits (cosine 0.99 together, 0.95 a tensor); one
    launch in the forward, none in the backward, none on the plain route."""
    fn, args, kw = _w8a8_backward_cases(dev)[name]
    before = fn.launches
    got, g = _w8a8_grads(fn, args, kw, True)
    assert fn.launches == before + 1
    want, _ = _w8a8_grads(fn, args, kw, False, g)
    assert fn.launches == before + 1
    cos = lambda a, b: float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))
    assert len(got) == len(want) >= 5
    assert all(torch.isfinite(t).all() for t in got)
    assert cos(torch.cat([t.flatten() for t in got]), torch.cat([t.flatten() for t in want])) \
        >= 0.99
    assert min(cos(a, b) for a, b in zip(got, want)) >= 0.95


def test_flash_attention_at_the_clip_shape(dev):
    """CLIP-L/14-336's attention (32 frames of 577 tokens, 16 heads of 64):
    the 128-key tile and masked tails of both the query block and the key
    tile; the tower launches it once a layer."""
    from ufvideo_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower

    q, k, v = (_randn(dev, 32, 577, 16, 64, seed=101 + i) for i in range(3))
    n = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == n + 1
    _assert_close(got, flash_attention_plain(q, k, v), row_rel=1e-2)
    cfg = dataclasses.replace(CLIPVisionConfig(), num_layers=4)
    tower = CLIPVisionTower(cfg).to(dev)
    tower.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    px = _randn(dev, 2, 336, 336, 3, seed=104)
    with torch.no_grad():
        n = flash_attention.launches
        out = tower(px)
        assert flash_attention.launches == n + cfg.num_encode_layers
        want = tower(px, use_kernel=False)
    cos = torch.nn.functional.cosine_similarity(out.float().flatten(), want.float().flatten(),
                                                dim=0)
    assert out.shape == (2, 576, 1024) and float(cos) >= 0.999


# ------------------------------------------------------------------- eval --
# The eval harness's host pieces (the PNG codec, the boundary dilation) on
# data that went through the card, and a tiny run_benchmark on the card
# against the same on the CPU; chip_smoke.py phase 9 drives the harness at
# full width through the kernels.

def test_png_and_dilation_on_frames_staged_to_the_card(dev, tmp_path):
    """Frames read by the PNG codec, staged to the card and back, are the
    written frames bit for bit; masks thresholded on the card, written as
    PNGs and read back, give the CPU's masks, dilations and J&F."""
    import numpy as np

    from ufvideo_tpu_torch.eval import metrics, png, util

    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (3, 48, 64, 3), np.uint8)
    for i, f in enumerate(frames):
        png.write_png(str(tmp_path / f"{i}.png"), f)
    card = torch.from_numpy(np.stack([png.read_png(str(tmp_path / f"{i}.png"))
                                      for i in range(3)])).to(dev)
    assert torch.equal(card.cpu(), torch.from_numpy(frames))
    on_card = (card.float().mean(-1) > 127.5).cpu().numpy()
    on_cpu = frames.astype(np.float32).mean(-1) > 127.5
    util.save_mask_pngs(str(tmp_path / "masks"), "v", on_card)
    back = np.stack(util.load_mask_pngs(str(tmp_path / "masks"), "v"))
    np.testing.assert_array_equal(back, on_cpu.astype(np.uint8))
    kernel = metrics._disk(3)
    for a, b in zip(back, on_cpu):
        np.testing.assert_array_equal(metrics.dilate(a, kernel), metrics.dilate(b, kernel))
        assert metrics.j_and_f(a, b[::-1]) == metrics.j_and_f(b, b[::-1])


def test_run_benchmark_on_the_card_equals_the_cpu(dev, tmp_path, monkeypatch):
    """A tiny float32 runtime loaded from one checkpoint on the CPU and on
    the card (plain versions: the tiny widths are not the kernels' shapes):
    mvbench at --batch 1 and 2 gives the same records on both; mevis at
    --batch 2 the same records, its mask PNGs agreeing on >= 99% of each
    frame's pixels (float32 sums in another order near the threshold)."""
    import json

    import numpy as np

    from ufvideo_tpu_torch.api import model_init
    from ufvideo_tpu_torch.configs import tiny_config
    from ufvideo_tpu_torch.eval import run as eval_run
    from ufvideo_tpu_torch.eval.png import write_png
    from ufvideo_tpu_torch.eval.util import load_mask_pngs, read_all_ranks
    from ufvideo_tpu_torch.export import save_hf_checkpoint

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.delenv("RANK", raising=False)
    cfg = tiny_config()
    cfg = cfg.replace(budget=dataclasses.replace(cfg.budget, max_seq_len=512, max_text_len=384))
    src, _, _ = model_init(cfg=cfg, device="cpu", seed=3)
    save_hf_checkpoint(str(tmp_path / "ckpt"), src.model)
    rng = np.random.default_rng(8)
    for v in range(2):
        (tmp_path / "videos" / f"vid{v}").mkdir(parents=True)
        for f in range(6):
            write_png(str(tmp_path / "videos" / f"vid{v}" / f"{f}.png"),
                      rng.integers(0, 256, (48, 64, 3), np.uint8))
    files = {
        "mvbench": [{"id": f"q{v}", "data": {"video": f"vid{v}", "question": "Which color?",
                                             "candidates": ["red", "green"], "answer": "red"}}
                    for v in range(2)],
        "mevis": [{"id": f"m{v}", "video": f"vid{v}", "conversations": [
            {"from": "human", "value": "<video>\nSegment it."},
            {"from": "gpt", "value": "It is [SEG]."}]} for v in range(2)],
    }
    for name, obj in files.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(obj))
    outs = {}
    for where in ("cpu", dev):
        bundle = model_init(str(tmp_path / "ckpt"), cfg=cfg, device=where)
        bundle[0].model.set_use_kernels(False)
        for bench, batch in (("mvbench", 1), ("mvbench", 2), ("mevis", 2)):
            out = str(tmp_path / f"{torch.device(where).type}_{bench}_{batch}.json")
            eval_run.run_benchmark(eval_run.build_parser().parse_args([
                "--benchmark", bench, "--video-folder", str(tmp_path / "videos"),
                "--question-file", str(tmp_path / f"{bench}.json"), "--output", out,
                "--num-frames", "4", "--max-new-tokens", "6", "--batch", str(batch)]),
                runtime=bundle)
            outs[torch.device(where).type, bench, batch] = out
    for bench, batch in (("mvbench", 1), ("mvbench", 2), ("mevis", 2)):
        cpu, card = outs["cpu", bench, batch], outs["cuda", bench, batch]
        assert read_all_ranks(card) == read_all_ranks(cpu) and len(read_all_ranks(cpu)) == 2
    for v in range(2):
        root = lambda d: outs[d, "mevis", 2].replace(".json", "_masks")
        a, b = load_mask_pngs(root("cuda"), f"m{v}"), load_mask_pngs(root("cpu"), f"m{v}")
        assert len(a) == len(b) == 4
        assert min(float((x == y).mean()) for x, y in zip(a, b)) >= 0.99


def test_span_holds_its_kernels_device_interval(dev):
    """The program's spans and the device trace share one clock: a span
    around a product's launch and ``torch.cuda.synchronize()`` contains the
    product's kineto device interval within 50 µs, for each of five spans,
    under the profiler the benchmark's traced window runs (CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    from ufvideo_tpu_torch.utils import tracing

    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    a @ a  # cuBLAS's handle and workspace
    torch.cuda.synchronize(dev)
    ids = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with tracing.Split("product", "launch") as sp:
                a @ a
                with tracing.wait():
                    torch.cuda.synchronize(dev)
            ids.append(sp.id)
            time.sleep(0.01)
    spans = {s.id: s for s in tracing.RECORDER.spans() if s.id in ids}
    assert len(spans) == 5
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda and e.duration_ns() > 0)
    assert len(kernels) >= 5
    slack = 50_000
    for s in spans.values():
        inside = [(k0, k1) for k0, k1 in kernels if s.start_ns - slack <= k0 <= s.end_ns + slack]
        assert inside, (s, kernels)
        assert all(s.start_ns - slack <= k0 and k1 <= s.end_ns + slack for k0, k1 in inside), \
            (s, inside)
    for k0, k1 in kernels:  # and every kernel lies in a span
        assert any(s.start_ns - slack <= k0 and k1 <= s.end_ns + slack for s in spans.values())
