"""Ragged decode attention: hand-written CUDA kernels + their plain versions.

``ragged_decode_attention`` replaces the TPU kernel
``ufvideo_tpu/ops/decode_attention.py`` ``ragged_decode_attention`` (Pallas
``_kernel``): one query token per (batch, kv head) with its G grouped query
heads, against the padded cache row, masked at ``lens[b]``, f32 softmax.
``ragged_decode_attention_q8`` replaces ``ragged_decode_attention_q8``
(``_kernel_q8``): the same on an int8 cache whose per-position f32 scales
fold into the scores and the probabilities. Both are one CUDA template,
``csrc/decode_attention.cu`` (written and verified on the card); its header
comment gives what bounds it on an H100 (memory bytes: the cache is read
once per step) and how the design meets that: ``decode_split_plan`` cuts
the cache row into chunks so the grid fills the card at batch 1, each
block copies its whole chunk into shared memory with coalesced
asynchronous copies before it computes, and a second pass merges the
chunks in a fixed order (``decode_partials_plain`` + ``merge_splits_plain``
are those two passes in plain PyTorch).

Layouts: q [B, Hkv, G, D]; cache [B, Hkv, S, D]; scales [B, Hkv, S].

On the card, this kernel alone (phase 2 of the smoke script, then the card
tests)::

    python3 chip_smoke.py --match decode && \
        python -m pytest tests/test_torch_cuda.py -q --noconftest -k decode
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .autograd import refuse_grad
from .attention import _NEG_INF, xla_attention

# cache positions a block (csrc/decode_attention.cu takes multiples of its
# 32-position copy group up to kMaxChunk = 64)
CHUNKS = (32, 64)


def decode_split_plan(b: int, hkv: int, s: int, sm_count: int) -> int:
    """Cache positions a block: 64 (two copy groups, so one group's copy
    overlaps the other's compute), or 32 where the grid B·Hkv·ceil(S / 64)
    would leave an SM without a block. A function of shapes alone (never of
    ``lens``), so a shape always runs the same chunks and sums in the same
    order. On an H100, 64 ran fastest of 32 / 64 / 128 / 256 at both of the
    smoke script's decode shapes, batch 1 and 4 (``scripts/torch_decode_sweep.py``
    while the kernel took all four); no shape yet measured asks for more."""
    return 64 if b * hkv * -(-s // 64) >= sm_count else 32


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_bf16.argtypes = [p] * 8 + [i] * 6 + [f, p]
    lib.decode_attention_bf16.restype = ctypes.c_int
    lib.decode_attention_q8.argtypes = [p] * 10 + [i] * 6 + [f, p]
    lib.decode_attention_q8.restype = ctypes.c_int
    return lib


def ragged_decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lens: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (float32 softmax)."""
    b, hkv, g, d = q.shape
    out = xla_attention(
        q.reshape(b, 1, hkv * g, d),
        k_cache.transpose(1, 2),
        v_cache.transpose(1, 2),
        kv_lens=lens,
        scale=scale,
    )
    return out[:, 0].reshape(b, hkv, g, d)


def _check_cache(name: str, q, k_cache, v_cache, cache_dtype, vec: int) -> None:
    """What both kernels ask of their inputs; ``vec`` is the number of
    cache values in one 16-byte load."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, hkv, g, d = q.shape
    s = k_cache.shape[2]
    if q.dtype != torch.bfloat16 or k_cache.dtype != cache_dtype or v_cache.dtype != cache_dtype:
        raise TypeError(f"{name} kernel takes bf16 q and a {cache_dtype} cache")
    if k_cache.shape != (b, hkv, s, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"shape mismatch q {q.shape} cache {k_cache.shape}")
    if g > 8 or d > 128 or d % vec or s == 0:
        raise ValueError(f"unsupported shape q {q.shape} cache {k_cache.shape}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name} needs a contiguous cache")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned cache")


def decode_partials_plain(
    q: torch.Tensor,  # [B, Hkv, G, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,
    lens: torch.Tensor,
    chunk: int,
    *,
    k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, S], int8 cache only
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """The kernel's first pass in plain PyTorch, in f32: for chunk i, over
    positions [i·chunk, (i+1)·chunk), the unnormalised output
    Σ exp(score − m)·(v_scale·v), its max m and sum Σ exp(score − m), with
    scores (times ``k_scale``) masked at ``lens`` to finfo(f32).min and m
    clamped at min/2 before the exponent, so a chunk wholly past ``lens``
    gives m = min, sum 0 and output 0. ``ops.flash_attention.
    merge_splits_plain`` is the second pass. The kernel keeps m in log2
    units (exp2 of log2(e)-scaled scores), the same weights.
    → (part_acc [n, B, Hkv, G, D], part_m, part_l [n, B, Hkv, G])."""
    b, hkv, g, d = q.shape
    s = k_cache.shape[2]
    scale = float(d ** -0.5) if scale is None else float(scale)
    neg = torch.finfo(torch.float32).min
    logits = torch.einsum("bhgd,bhsd->bhgs", q.float(), k_cache.float()) * scale
    v = v_cache.float()
    if k_scale is not None:
        logits = logits * k_scale.float()[:, :, None, :]
        v = v * v_scale.float()[..., None]
    valid = torch.arange(s, device=q.device)[None, :] < lens.to(q.device)[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], neg)
    n = -(-s // chunk)
    part_acc = torch.zeros(n, b, hkv, g, d, device=q.device)
    part_m = torch.full((n, b, hkv, g), neg, device=q.device)
    part_l = torch.zeros(n, b, hkv, g, device=q.device)
    for i in range(n):
        lo, hi = i * chunk, min((i + 1) * chunk, s)
        m = logits[..., lo:hi].amax(dim=-1)
        p = torch.exp(logits[..., lo:hi] - m.clamp_min(neg / 2)[..., None])
        part_m[i], part_l[i] = m, p.sum(dim=-1)
        part_acc[i] = torch.einsum("bhgs,bhsd->bhgd", p, v[:, :, lo:hi])
    return part_acc, part_m, part_l


def _launch(q, k_cache, v_cache, lens, chunk: int, scale: Optional[float],
            k_scale=None, v_scale=None) -> torch.Tensor:
    """Both kernels (int8 when scales are given) at a given chunk, after
    the wrappers' checks; adds one to the public wrapper's count and keeps
    the split it launched (chunk, blocks) in its ``last_split``."""
    b, hkv, g, d = q.shape
    s = k_cache.shape[2]
    q = q.contiguous()
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    n = -(-s // chunk)
    part_m = torch.empty((b, hkv, n, g), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hkv, n, g, d), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    scale = float(d ** -0.5) if scale is None else float(scale)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch = (out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
               b, hkv, g, s, d, chunk, scale, stream)
    lib = _lib()
    if k_scale is None:
        code = lib.decode_attention_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(), *scratch)
        _build.check(lib, code, "ragged_decode_attention")
        wrapper = ragged_decode_attention
    else:
        code = lib.decode_attention_q8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lens.data_ptr(), *scratch)
        _build.check(lib, code, "ragged_decode_attention_q8")
        wrapper = ragged_decode_attention_q8
    _build.count_launch(wrapper)
    wrapper.last_split = (chunk, b * hkv * n)
    return out


def _plan(q: torch.Tensor, s: int) -> int:
    b, hkv = q.shape[:2]
    return decode_split_plan(b, hkv, s, _sm_count(q.device.index or 0))


def ragged_decode_attention(
    q: torch.Tensor,  # [B, Hkv, G, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D]
    v_cache: torch.Tensor,
    lens: torch.Tensor,  # [B] valid cache lengths
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, G <= 8, D a multiple of 8 up to 128, contiguous aligned cache)."""
    if q.device.type == "cpu":
        return ragged_decode_attention_plain(q, k_cache, v_cache, lens, scale=scale)
    refuse_grad("ragged_decode_attention", q, k_cache, v_cache)
    _check_cache("ragged_decode_attention", q, k_cache, v_cache, torch.bfloat16, 8)
    return _launch(q, k_cache, v_cache, lens, _plan(q, k_cache.shape[2]), scale)


ragged_decode_attention.launches = 0
ragged_decode_attention.last_split = None


def ragged_decode_attention_q8_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    lens: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The q8 kernel's function in plain PyTorch (the math of the Pallas
    ``_kernel_q8``): scores rescaled by ``k_scale``, f32 softmax,
    probabilities times ``v_scale`` cast to q's dtype, then P·V. An empty
    row gives 0, as the bf16 version does."""
    b, hkv, g, d = q.shape
    s = k_cache.shape[2]
    scale = float(d ** -0.5) if scale is None else float(scale)
    logits = torch.einsum("bhgd,bhsd->bhgs", q.float(), k_cache.float()) * scale
    logits = logits * k_scale.float()[:, :, None, :]
    valid = torch.arange(s, device=q.device)[None, :] < lens.to(q.device)[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG_INF)
    row_max = logits.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF / 2)
    probs = torch.exp(logits - row_max)
    probs = probs / probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = (probs * v_scale.float()[:, :, None, :]).to(q.dtype)
    return torch.einsum("bhgs,bhsd->bhgd", probs.float(), v_cache.float()).to(q.dtype)


def ragged_decode_attention_q8(
    q: torch.Tensor,  # [B, Hkv, G, D]
    k_cache: torch.Tensor,  # [B, Hkv, S, D] int8
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [B, Hkv, S] f32
    v_scale: torch.Tensor,
    lens: torch.Tensor,  # [B] valid cache lengths
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 q, int8 cache, f32 scales, G <= 8, D a multiple of 16 up to 128,
    contiguous aligned cache)."""
    if q.device.type == "cpu":
        return ragged_decode_attention_q8_plain(
            q, k_cache, v_cache, k_scale, v_scale, lens, scale=scale)
    refuse_grad("ragged_decode_attention_q8", q, k_cache, v_cache, k_scale, v_scale)
    _check_cache("ragged_decode_attention_q8", q, k_cache, v_cache, torch.int8, 16)
    b, hkv = q.shape[:2]
    s = k_cache.shape[2]
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or t.shape != (b, hkv, s) or not t.is_contiguous():
            raise ValueError("ragged_decode_attention_q8 needs contiguous f32 scales [B, Hkv, S]")
    return _launch(q, k_cache, v_cache, lens, _plan(q, s), scale, k_scale, v_scale)


ragged_decode_attention_q8.launches = 0
ragged_decode_attention_q8.last_split = None
