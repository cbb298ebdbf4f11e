"""Flash attention forward: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``ufvideo_tpu/ops/flash_attention.py``
``flash_attention`` (Pallas ``_kernel``). The CUDA source is
``csrc/flash_attention.cu`` over ``csrc/attention_tile.cuh``; its header
comment gives what bounds it on an H100 (tensor-core operations at the
Qwen2-7B prefill shape) and how the design meets that. Callers: Qwen2
prefill and full forward (head dim 128, causal), Hiera global blocks (head
dim 72), SAM2 memory attention (one head of dim 256, ``kv_mask`` over the
memory slots) and the mask decoder's small attentions (head dim 16 / 32).

Causal alignment contract (as in the TPU kernel): query row r sits at
position r + (Skv - Sq), a static offset from the buffer end; ``kv_lens``
only masks tail padding and does not shift the diagonal.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .attention import xla_attention


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_bf16.argtypes = (
        [p] * 6 + [i] * 6 + [ll] * 12 + [f, i, p]
    )
    lib.flash_attention_bf16.restype = ctypes.c_int
    return lib


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (float32 softmax)."""
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.bool)[:, None, :].expand(-1, q.shape[1], -1)
    return xla_attention(
        q, k, v, causal=causal, kv_lens=kv_lens, mask=mask, scale=scale
    )


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int
    kv_mask: Optional[torch.Tensor] = None,  # [B, Skv] bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention forward. CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16, head dim a multiple of
    8 up to 256)."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, kv_lens=kv_lens, kv_mask=kv_mask, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash_attention kernel takes bf16 q / k / v")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {q.shape} k {k.shape} v {v.shape}")
    if hq % hkv or d > 256 or min(b, sq, skv) == 0 or max(hq, b) > 65535:
        raise ValueError(f"unsupported shape q {q.shape} k {k.shape}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a unit stride along head dim")
    if d % 8 or not all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
        for t in (q, k, v)
    ):
        raise ValueError(
            "flash_attention reads rows as 16-byte vectors: head dim and strides "
            "must be multiples of 8 and q / k / v 16-byte aligned"
        )
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lens = (
        kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_lens is not None else None
    )
    mask = (
        kv_mask.to(device=q.device, dtype=torch.uint8).contiguous()
        if kv_mask is not None else None
    )
    scale = float(d ** -0.5) if scale is None else float(scale)
    lib = _lib()
    code = lib.flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr() if lens is not None else None,
        mask.data_ptr() if mask is not None else None,
        b, sq, skv, hq, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        scale, int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
