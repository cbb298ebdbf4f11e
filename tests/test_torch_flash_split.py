"""The flash kernel's split of the keys, on the CPU: the plan that
``ops/flash_attention.py`` hands the kernel when its query tiles cannot
fill the card, and the two passes' arithmetic in plain PyTorch (the
partial sums of each chunk, then their merge), held against
``flash_attention_plain`` and the JAX ``flash_attention`` (Pallas, in
interpret mode off the TPU).

Plan: the chunks tile ``[0, Skv)`` exactly, on key-tile boundaries, every
chunk holds a key, a grid that fills the card is not split, and a split
grid stays within one wave. Merge: f32 inputs, so the only differences are
the order of f32 sums (``TOL``); fully masked rows and chunks whose keys
are all masked give 0 and no NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.ops.flash_attention import flash_attention as j_flash_attention
from ufvideo_tpu_torch.ops import flash_attention as fa

TOL = 2e-5
H100_SMS = 132

# (B, Hq, Sq, Skv, D) of the calls the port makes at full width
PATH_SHAPES = [
    (1, 28, 2816, 2816, 128),  # Qwen2-7B prefill
    (4, 8, 4096, 4096, 72),  # Hiera global block
    (1, 1, 4096, 4096, 256),  # SAM2 memory self-attention
    (1, 1, 4096, 7 * 4096 + 64, 256),  # memory cross-attention
    (1, 8, 9, 9, 32), (1, 8, 9, 4096, 16), (1, 8, 4096, 9, 16),  # mask decoder
    (1, 8, 8, 4096, 16),
    (32, 16, 729, 729, 72),  # packed SigLIP attention
]


@pytest.mark.parametrize("sm_count", [H100_SMS, 16])
@pytest.mark.parametrize("b,hq,sq,skv,d", PATH_SHAPES + [(2, 3, 70, 333, 64), (1, 1, 1, 1, 8)])
def test_split_plan_tiles_the_keys(b, hq, sq, skv, d, sm_count):
    splits, chunk = fa.split_plan(b, hq, sq, skv, d, sm_count)
    bn = fa.block_kv(d)
    tiles = -(-sq // fa.block_q(sq)) * hq * b
    assert chunk % bn == 0 and 1 <= splits <= fa.MAX_SPLITS
    assert (splits - 1) * chunk < skv <= splits * chunk  # exact cover, none empty
    if tiles >= sm_count:
        assert splits == 1
    if splits > 1:
        assert tiles * splits <= sm_count


def test_split_plan_splits_the_calls_that_leave_the_card_idle():
    """The default [SEG] request's small grids on an H100: the mask
    decoder's 9 queries on 4096 keys (8 blocks) and memory self-attention
    (32 blocks) are split; prefill (616 blocks) is not."""
    assert fa.split_plan(1, 8, 9, 4096, 16, H100_SMS)[0] > 1
    assert fa.split_plan(1, 1, 4096, 4096, 256, H100_SMS)[0] == 4
    assert fa.split_plan(1, 28, 2816, 2816, 128, H100_SMS)[0] == 1


CASES = [
    # b, sq, skv, hq, hkv, d, causal, lens, mask
    pytest.param(2, 40, 300, 4, 2, 32, True, [300, 170], None, id="causal-gqa-lens"),
    pytest.param(1, 9, 700, 2, 2, 16, False, None, "chunks", id="mask-empties-chunks"),
    pytest.param(2, 24, 520, 2, 1, 64, False, [520, 37], "random", id="lens-and-mask"),
    pytest.param(1, 8, 256, 1, 1, 256, False, None, "none-visible", id="nothing-visible"),
]


def _inputs(b, sq, skv, hq, hkv, d, lens, mask):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    kv_lens = None if lens is None else np.asarray(lens, np.int32)
    kv_mask = None
    if mask == "chunks":  # keys 128-383 (two whole key tiles of 128) and 600-699 masked
        kv_mask = np.ones((b, skv), bool)
        kv_mask[:, 128:384] = False
        kv_mask[:, 600:] = False
    elif mask == "random":
        kv_mask = rng.random((b, skv)) > 0.4
    elif mask == "none-visible":
        kv_mask = np.zeros((b, skv), bool)
    return q, k, v, kv_lens, kv_mask


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,lens,mask", CASES)
def test_split_merge_matches_plain_and_jax(b, sq, skv, hq, hkv, d, causal, lens, mask):
    q, k, v, kv_lens, kv_mask = _inputs(b, sq, skv, hq, hkv, d, lens, mask)
    t = lambda a: None if a is None else torch.from_numpy(a)
    kw = dict(causal=causal, kv_lens=t(kv_lens), kv_mask=t(kv_mask))
    want = fa.flash_attention_plain(t(q), t(k), t(v), **kw).numpy()
    jkw = dict(causal=causal, kv_lens=None if kv_lens is None else jnp.asarray(kv_lens),
               kv_mask=None if kv_mask is None else jnp.asarray(kv_mask), interpret=True)
    jax_out = np.asarray(j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))
    np.testing.assert_allclose(want, jax_out, rtol=TOL, atol=TOL)
    bn = fa.block_kv(d)
    plans = {fa.split_plan(b, hq, sq, skv, d, 16), (3, bn * -(-skv // (3 * bn))),
             (-(-skv // bn), bn)}
    for splits, chunk in plans:
        parts = fa.flash_attention_partials_plain(t(q), t(k), t(v), splits, chunk, **kw)
        if mask == "chunks" and chunk == bn:  # key tiles 1, 2 and 5 hold no visible key
            for i in (1, 2, 5):
                assert float(parts[2][i].abs().max()) == 0.0
                assert float(parts[0][i].abs().max()) == 0.0
        got = fa.merge_splits_plain(*parts).permute(0, 2, 1, 3).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if mask == "none-visible":
        assert np.count_nonzero(got) == 0
