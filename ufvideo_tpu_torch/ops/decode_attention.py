"""Ragged decode attention: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``ufvideo_tpu/ops/decode_attention.py``
``ragged_decode_attention`` (Pallas ``_kernel``): one query token per
(batch, kv head) with its G grouped query heads, against the padded cache
row, masked at ``lens[b]``, f32 softmax. The CUDA source is
``csrc/decode_attention.cu``; its header comment gives what bounds it on an
H100 (memory bytes: the cache is read once per step) and how the design
meets that (the cache row is split over 128-position chunks and merged in a
second pass, so batch 1 still fills the card).

Layouts: q [B, Hkv, G, D]; cache [B, Hkv, S, D].
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .attention import xla_attention

_CHUNK = 128  # cache positions per block (csrc/decode_attention.cu kChunk)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_bf16.argtypes = [p] * 8 + [i] * 5 + [f, p]
    lib.decode_attention_bf16.restype = ctypes.c_int
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
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_attention: unsupported device {q.device}")
    b, hkv, g, d = q.shape
    s = k_cache.shape[2]
    if not all(t.dtype == torch.bfloat16 for t in (q, k_cache, v_cache)):
        raise TypeError("ragged_decode_attention kernel takes bf16 q / cache")
    if k_cache.shape != (b, hkv, s, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"shape mismatch q {q.shape} cache {k_cache.shape}")
    if g > 8 or d > 128 or d % 8 or s == 0:
        raise ValueError(f"unsupported shape q {q.shape} cache {k_cache.shape}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("ragged_decode_attention needs a contiguous cache")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("ragged_decode_attention needs a 16-byte aligned cache")
    q = q.contiguous()
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    nchunks = -(-s // _CHUNK)
    part_m = torch.empty((b, hkv, nchunks, g), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hkv, nchunks, g, d), dtype=torch.float32, device=q.device)
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
