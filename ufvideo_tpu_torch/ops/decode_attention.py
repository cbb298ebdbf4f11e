"""Ragged decode attention: hand-written CUDA kernels + their plain versions.

``ragged_decode_attention`` replaces the TPU kernel
``ufvideo_tpu/ops/decode_attention.py`` ``ragged_decode_attention`` (Pallas
``_kernel``): one query token per (batch, kv head) with its G grouped query
heads, against the padded cache row, masked at ``lens[b]``, f32 softmax.
``ragged_decode_attention_q8`` replaces ``ragged_decode_attention_q8``
(``_kernel_q8``): the same on an int8 cache whose per-position f32 scales
fold into the scores and the probabilities. The CUDA source is
``csrc/decode_attention.cu``; its header comment gives what bounds it on an
H100 (memory bytes: the cache is read once per step) and how the design
meets that (the cache row is split over 128-position chunks and merged in a
second pass, so batch 1 still fills the card).

Layouts: q [B, Hkv, G, D]; cache [B, Hkv, S, D]; scales [B, Hkv, S].
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .attention import _NEG_INF, xla_attention

_CHUNK = 128  # cache positions per block (csrc/decode_attention.cu kChunk)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_bf16.argtypes = [p] * 8 + [i] * 5 + [f, p]
    lib.decode_attention_bf16.restype = ctypes.c_int
    lib.decode_attention_q8.argtypes = [p] * 10 + [i] * 5 + [f, p]
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


def _scratch(q: torch.Tensor, s: int):
    b, hkv, g, d = q.shape
    nchunks = -(-s // _CHUNK)
    part_m = torch.empty((b, hkv, nchunks, g), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b, hkv, nchunks, g, d), dtype=torch.float32, device=q.device)
    return part_m, torch.empty_like(part_m), part_acc


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
    _check_cache("ragged_decode_attention", q, k_cache, v_cache, torch.bfloat16, 8)
    b, hkv, g, d = q.shape
    s = k_cache.shape[2]
    q = q.contiguous()
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    part_m, part_l, part_acc = _scratch(q, s)
    out = torch.empty_like(q)
    scale = float(d ** -0.5) if scale is None else float(scale)
    lib = _lib()
    code = lib.decode_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        b, hkv, g, s, d, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "ragged_decode_attention")
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0


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
    _check_cache("ragged_decode_attention_q8", q, k_cache, v_cache, torch.int8, 16)
    b, hkv, g, d = q.shape
    s = k_cache.shape[2]
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or t.shape != (b, hkv, s) or not t.is_contiguous():
            raise ValueError("ragged_decode_attention_q8 needs contiguous f32 scales [B, Hkv, S]")
    q = q.contiguous()
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    part_m, part_l, part_acc = _scratch(q, s)
    out = torch.empty_like(q)
    scale = float(d ** -0.5) if scale is None else float(scale)
    lib = _lib()
    code = lib.decode_attention_q8(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lens.data_ptr(), out.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), b, hkv, g, s, d, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "ragged_decode_attention_q8")
    ragged_decode_attention_q8.launches += 1
    return out


ragged_decode_attention_q8.launches = 0
