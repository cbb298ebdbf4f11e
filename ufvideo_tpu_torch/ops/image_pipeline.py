"""On-device frame preprocessing (mirrors ``ufvideo_tpu/ops/image_pipeline.py``):
uint8 frames → bicubic resize → round / clip to the uint8 range →
normalize.

The resize reproduces ``jax.image.resize(..., method="bicubic")``: the Keys
cubic kernel with a = -0.5, stretched by the inverse scale when shrinking
(antialias), weights normalised per output sample, applied separably as
two float32 matrix products. ``torch.nn.functional.interpolate`` uses
a = -0.75 and no antialias, so the weights are written out in
``ops/interp.py`` (``resize_weights``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .interp import resize_weights

SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)


def bicubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in_size, out_size] float32 bicubic resampling matrix of jax.image.resize."""
    return resize_weights(in_size, out_size, "bicubic", device)


def resize_bicubic(x: torch.Tensor, size: int) -> torch.Tensor:
    """[T, H, W, C] float32 → [T, size, size, C] (an unchanged axis is
    skipped, as jax.image.resize does)."""
    _, h, w, _ = x.shape
    if h != size:
        x = torch.einsum("thwc,hH->tHwc", x, bicubic_weights(h, size, x.device))
    if w != size:
        x = torch.einsum("thwc,wW->thWc", x, bicubic_weights(w, size, x.device))
    return x


def resize_normalize(
    frames_u8: torch.Tensor,  # [T, H, W, 3] uint8
    mean: Tuple[float, float, float],
    std: Tuple[float, float, float],
    *,
    size: int,
    rescale: bool,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    x = resize_bicubic(frames_u8.to(torch.float32), size)
    # bicubic overshoots at edges; quantize like the host PIL path
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    if rescale:
        x = x / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).to(out_dtype)


def siglip_preprocess_device(
    frames_u8: torch.Tensor, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """uint8 [T, H, W, 3] → [T, 384, 384, 3] SigLIP-normalized, on the
    frames' device."""
    return resize_normalize(
        frames_u8, SIGLIP_MEAN, SIGLIP_STD, size=384, rescale=True,
        out_dtype=out_dtype,
    )


def sam_preprocess_device(
    frames_u8: torch.Tensor, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """uint8 [T, H, W, 3] → [T, 1024, 1024, 3] SAM-normalized, on the
    frames' device."""
    return resize_normalize(
        frames_u8, SAM_MEAN, SAM_STD, size=1024, rescale=False, out_dtype=out_dtype,
    )
