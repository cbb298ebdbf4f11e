"""The decode kernels' split of the cache row, on the CPU: the chunk that
``ops/decode_attention.py`` hands both kernels (bf16 and int8 cache), and
the two passes' arithmetic in plain PyTorch (each chunk's partial sums,
then their merge), held against ``ragged_decode_attention_plain`` /
``ragged_decode_attention_q8_plain`` and the JAX Pallas kernels in
interpret mode.

Plan: the chunk comes from a fixed set, the chunks tile ``[0, S)``
exactly, and it leaves 64 positions for 32 only to give every SM a block.
Merge: every input is f32 (for the
int8 cache the q, the scales and the dequantised sums are f32, so neither
side rounds probabilities to bf16), so the only differences are the order
of f32 sums and exp against the reference's softmax (``TOL``). An empty
row gives 0 on the port's side (the JAX kernel's is the mean of v, a hazard
of the reference that the port does not copy), and chunks wholly past
``lens`` weigh 0 with no NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.ops.decode_attention import ragged_decode_attention as j_decode
from ufvideo_tpu.ops.decode_attention import ragged_decode_attention_q8 as j_decode_q8
from ufvideo_tpu_torch.models.qwen2 import quantize_kv
from ufvideo_tpu_torch.ops import decode_attention as da
from ufvideo_tpu_torch.ops.flash_attention import merge_splits_plain

TOL = 2e-5
H100_SMS = 132


@pytest.mark.parametrize("sm_count", [H100_SMS, 16, 1])
@pytest.mark.parametrize("b,hkv,s", [
    (1, 4, 2944), (4, 4, 2944), (32, 4, 2944), (1, 4, 33), (1, 1, 1), (2, 2, 700),
    (1, 4, 40000), (8, 8, 256), (256, 4, 2944),
])
def test_split_plan_tiles_the_cache(b, hkv, s, sm_count):
    chunk = da.decode_split_plan(b, hkv, s, sm_count)
    assert chunk in da.CHUNKS
    n = -(-s // chunk)
    assert (n - 1) * chunk < s <= n * chunk  # whole chunks, none empty
    # 32 exactly where 64 would leave an SM without a block
    assert (chunk == 32) == (b * hkv * -(-s // 64) < sm_count)


def test_split_plan_fills_the_h100_at_the_qwen2_decode_shape():
    """Qwen2-7B decode at batch 1: 4 kv heads on a 2944-position cache."""
    chunk = da.decode_split_plan(1, 4, 2944, H100_SMS)
    blocks = 4 * -(-2944 // chunk)
    assert chunk in (32, 64) and blocks >= H100_SMS


def test_split_plan_grows_the_chunk_only_for_deep_grids():
    """The chunk is 64 only where its grid still gives every SM a block: the
    smoke script's ragged batch of 4 (736 blocks, 5.6 an SM) and 64
    sequences keep 64 positions; a short cache at batch 1 (64 blocks at 64)
    takes 32."""
    assert da.decode_split_plan(4, 4, 2944, H100_SMS) == 64
    assert da.decode_split_plan(64, 4, 2944, H100_SMS) == 64
    assert da.decode_split_plan(1, 4, 1000, H100_SMS) == 32


CASES = [
    # b, hkv, g, s, d, lens: 0, 1, a chunk boundary (32 / 64 / 128), S
    pytest.param(4, 2, 7, 300, 128, [0, 1, 128, 300], id="g7-d128-ragged"),
    pytest.param(3, 1, 8, 257, 64, [64, 257, 33], id="g8-d64"),
    pytest.param(2, 3, 1, 200, 16, [32, 199], id="g1-d16"),
]


def _inputs(b, hkv, g, s, d, lens):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


def _merged(parts):
    """merge_splits_plain over the chunks → [B, Hkv, G, D]."""
    got = merge_splits_plain(*parts).numpy()
    assert np.isfinite(got).all()
    return got


def _chunks_past(lens, chunk, s):
    """(chunk index, row) of every chunk that starts at or past lens[row]."""
    return [(i, r) for r, n in enumerate(lens) for i in range(-(-s // chunk)) if i * chunk >= n]


@pytest.mark.parametrize("b,hkv,g,s,d,lens", CASES)
def test_split_merge_matches_plain_and_jax_bf16_kernel(b, hkv, g, s, d, lens):
    q, k, v, lens_np = _inputs(b, hkv, g, s, d, lens)
    t = torch.from_numpy
    want = da.ragged_decode_attention_plain(t(q), t(k), t(v), t(lens_np)).numpy()
    jax_out = np.asarray(j_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens_np), interpret=True))
    live = lens_np > 0
    np.testing.assert_allclose(want[live], jax_out[live], rtol=TOL, atol=TOL)
    assert np.count_nonzero(want[~live]) == 0
    for chunk in da.CHUNKS:
        parts = da.decode_partials_plain(t(q), t(k), t(v), t(lens_np), chunk)
        for i, r in _chunks_past(lens, chunk, s):
            assert float(parts[0][i, r].abs().max()) == 0.0
            assert float(parts[2][i, r].abs().max()) == 0.0
        np.testing.assert_allclose(_merged(parts), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,hkv,g,s,d,lens", CASES)
def test_split_merge_matches_plain_and_jax_int8_kernel(b, hkv, g, s, d, lens):
    q, k, v, lens_np = _inputs(b, hkv, g, s, d, lens)
    t = torch.from_numpy
    (k8, ks), (v8, vs) = quantize_kv(t(k)), quantize_kv(t(v))
    args = (t(q), k8, v8, ks, vs, t(lens_np))
    want = da.ragged_decode_attention_q8_plain(*args).numpy()
    jax_out = np.asarray(j_decode_q8(
        *(jnp.asarray(a.numpy()) for a in args), interpret=True))
    live = lens_np > 0
    np.testing.assert_allclose(want[live], jax_out[live], rtol=TOL, atol=TOL)
    assert np.count_nonzero(want[~live]) == 0
    for chunk in da.CHUNKS:
        parts = da.decode_partials_plain(t(q), k8, v8, t(lens_np), chunk, k_scale=ks, v_scale=vs)
        for i, r in _chunks_past(lens, chunk, s):
            assert float(parts[2][i, r].abs().max()) == 0.0
        np.testing.assert_allclose(_merged(parts), want, rtol=TOL, atol=TOL)


def test_cpu_wrappers_take_the_plain_versions():
    q, k, v, lens_np = _inputs(2, 2, 7, 100, 64, [100, 0])
    t = torch.from_numpy
    n = (da.ragged_decode_attention.launches, da.ragged_decode_attention_q8.launches)
    out = da.ragged_decode_attention(t(q), t(k), t(v), t(lens_np))
    assert torch.equal(out, da.ragged_decode_attention_plain(t(q), t(k), t(v), t(lens_np)))
    (k8, ks), (v8, vs) = quantize_kv(t(k)), quantize_kv(t(v))
    out8 = da.ragged_decode_attention_q8(t(q), k8, v8, ks, vs, t(lens_np))
    assert torch.equal(out8, da.ragged_decode_attention_q8_plain(t(q), k8, v8, ks, vs, t(lens_np)))
    assert (da.ragged_decode_attention.launches, da.ragged_decode_attention_q8.launches) == n
