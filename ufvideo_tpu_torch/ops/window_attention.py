"""Multi-head attention inside each window of Hiera's window-major tokens:
hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``ufvideo_tpu/ops/window_attention.py``
``fused_window_attention`` (Pallas ``_kernel``): the qkv projection of
[NW, S, C] window-major tokens arrives in its packed layout [NW, S, 3·H·D]
(lanes [q heads | k heads | v heads]) and each window attends to itself;
the output is [NW, S, H·D]. The unfused ``MultiScaleAttention`` module runs
it on windows of up to 512 tokens. Heads are not padded: the JAX function's
``head_pad`` (lanes a head, a multiple of 128) is a TPU layout and here is
the head dim. The CUDA source is ``csrc/packed_attention.cu`` over
``csrc/attention_tile.cuh``; one window is one batch entry of the tile, so
no window reads another's keys.
"""

from __future__ import annotations

import torch

from .. import _build
from .vit_attention import _lib, check_packed, packed_attention_plain


def fused_window_attention_plain(qkv: torch.Tensor, num_heads: int,
                                 head_dim: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX ``_reference`` with
    ``head_pad`` = ``head_dim``)."""
    return packed_attention_plain(qkv, num_heads, head_dim)


def fused_window_attention(
    qkv: torch.Tensor,  # [NW, S, 3·H·D]
    num_heads: int,
    head_dim: int,
) -> torch.Tensor:  # [NW, S, H·D]
    """Unmasked attention of each window on itself. CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16, head dim a multiple
    of 8 up to 256)."""
    if qkv.device.type == "cpu":
        return fused_window_attention_plain(qkv, num_heads, head_dim)
    check_packed("fused_window_attention", qkv, num_heads, head_dim)
    qkv = qkv.contiguous()
    nw, s, _ = qkv.shape
    out = torch.empty((nw, s, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    lib = _lib()
    code = lib.window_attention_packed_bf16(
        qkv.data_ptr(), out.data_ptr(), nw, s, num_heads, head_dim,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(lib, code, "fused_window_attention")
    _build.count_launch(fused_window_attention)
    return out


fused_window_attention.launches = 0
