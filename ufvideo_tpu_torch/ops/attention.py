"""Attention entry points (mirrors ``ufvideo_tpu/ops/attention.py``).

Conventions: q [B, Sq, Hq, D], k / v [B, Skv, Hkv, D] with Hq % Hkv == 0
(GQA); output [B, Sq, Hq, D] in q's dtype; softmax in float32.

``attention`` and ``decode_attention`` go to the hand-written kernels
(``flash_attention`` / ``ragged_decode_attention``), whose wrappers launch
the CUDA kernel for CUDA tensors and run the plain version for CPU tensors.
``use_kernel=False`` asks for the plain version explicitly, on any device
(the on-card comparison of the two paths uses it).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = float(torch.finfo(torch.float32).min)


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain reference attention in float32 (the JAX ``xla_attention``).

    Causal masking aligns the last query with the last kv position
    (query row r sits at r + Skv - Sq). ``mask``: [Sq, Skv] or
    [B, Sq, Skv] booleans. Fully masked rows give 0."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    groups = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    # grouped-query layout: contract against the shared kv head directly
    qf = (q.to(torch.float32) * scale).reshape(b, sq, hkv, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32))
    logits = logits.reshape(b, hq, sq, skv)
    ki = torch.arange(skv, device=q.device)
    if causal:
        qi = torch.arange(sq, device=q.device)
        causal_mask = (ki[None, :] - (skv - sq)) <= qi[:, None]
        logits = logits.masked_fill(~causal_mask[None, None], _NEG_INF)
    if kv_lens is not None:
        valid = ki[None, :] < kv_lens.to(q.device)[:, None]
        logits = logits.masked_fill(~valid[:, None, None, :], _NEG_INF)
    if mask is not None:
        mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
        logits = logits.masked_fill(~mask, _NEG_INF)

    row_max = logits.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF / 2)
    probs = torch.exp(logits - row_max)
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = probs.reshape(b, hkv, groups, sq, skv)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Skv] per-token validity
    scale: Optional[float] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Multi-head (grouped-query) attention."""
    from .flash_attention import flash_attention, flash_attention_plain

    fn = flash_attention if use_kernel else flash_attention_plain
    return fn(q, k, v, causal=causal, kv_lens=kv_lens, kv_mask=kv_mask, scale=scale)


def window_dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float
) -> torch.Tensor:
    """Unmasked attention for small windows in the inputs' dtype with a
    float32 softmax; no GQA, no masks. Plain PyTorch, as the JAX function is
    plain XLA: the only caller is a q-pool block that keeps its width, which
    no shipped Hiera has."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # [B] valid entries, current step included
    *,
    k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, S] f32: the cache is int8
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Single-step decode attention against a padded KV cache. With
    ``k_scale`` / ``v_scale`` the cache holds int8 values quantised per
    position; the scales fold into the scores and the probabilities."""
    from . import decode_attention as da

    b, _, hq, d = q.shape
    hkv = k_cache.shape[1]
    qg = q[:, 0].reshape(b, hkv, hq // hkv, d)
    if k_scale is not None:
        fn = da.ragged_decode_attention_q8 if use_kernel else da.ragged_decode_attention_q8_plain
        out = fn(qg, k_cache, v_cache, k_scale, v_scale, cache_len, scale=scale)
    else:
        fn = da.ragged_decode_attention if use_kernel else da.ragged_decode_attention_plain
        out = fn(qg, k_cache, v_cache, cache_len, scale=scale)
    return out.reshape(b, 1, hq, d)
