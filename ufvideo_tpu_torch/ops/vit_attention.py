"""Full multi-head attention over a packed qkv buffer (the ViT towers):
hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``ufvideo_tpu/ops/vit_attention.py``
``mha_full_attention_packed`` (Pallas ``_kernel``): q / k / v arrive packed
in one [B, S, 3·H·D] projection buffer, lanes [q heads | k heads | v
heads], and the output is [B, S, H·D]. The unfused SigLIP layers run it
(729 tokens, 16 heads of 72). The CUDA source is ``csrc/packed_attention.cu``
over ``csrc/attention_tile.cuh``; its header comment gives the bound on an
H100 and the design.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("packed_attention")
    for fn in (lib.mha_packed_bf16, lib.window_attention_packed_bf16):
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def packed_attention_plain(qkv: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """softmax(q·kᵀ·d^-½)·v per batch entry and head on a packed buffer
    (the JAX ``_reference_packed`` / window ``_reference``): f32 scores and
    softmax, probabilities rounded to the input's type before P·V."""
    b, s, _ = qkv.shape
    hw = num_heads * head_dim
    dtype = qkv.dtype
    q, k, v = (qkv[..., i * hw:(i + 1) * hw].reshape(b, s, num_heads, head_dim).float()
               for i in range(3))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * head_dim ** -0.5
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v)
    return o.reshape(b, s, hw).to(dtype)


def check_packed(name: str, qkv: torch.Tensor, num_heads: int, head_dim: int) -> None:
    """What the packed-attention kernel takes, checked before a launch."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes a bf16 qkv buffer")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * num_heads * head_dim or min(qkv.shape) == 0:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is not [B, S, 3*{num_heads}*{head_dim}]")
    if head_dim % 8 or head_dim > 256:
        raise ValueError(f"{name}: head dim {head_dim} (a multiple of 8 up to 256), "
                         f"{num_heads} heads")


def mha_full_attention_packed_plain(qkv: torch.Tensor, num_heads: int,
                                    head_dim: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    return packed_attention_plain(qkv, num_heads, head_dim)


def mha_full_attention_packed(
    qkv: torch.Tensor,  # [B, S, 3·H·D], lanes [q heads | k heads | v heads]
    num_heads: int,
    head_dim: int,
) -> torch.Tensor:  # [B, S, H·D]
    """Unmasked full attention of each image on itself. CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16, head dim a multiple
    of 8 up to 256)."""
    if qkv.device.type == "cpu":
        return mha_full_attention_packed_plain(qkv, num_heads, head_dim)
    check_packed("mha_full_attention_packed", qkv, num_heads, head_dim)
    qkv = qkv.contiguous()
    b, s, _ = qkv.shape
    out = torch.empty((b, s, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    code = lib.mha_packed_bf16(qkv.data_ptr(), out.data_ptr(), b, s, num_heads, head_dim,
                               torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, code, "mha_full_attention_packed")
    _build.count_launch(mha_full_attention_packed)
    return out


mha_full_attention_packed.launches = 0
