"""Separable interpolation matrices (own copy of ``ufvideo_tpu/ops/interp.py``,
plus the resize weights of ``jax.image.resize`` that the JAX package calls
directly).

Two families, because the JAX package uses both:

- ``bilinear_matrix`` / ``bicubic_matrix``: what ``torch.nn.functional.
  interpolate`` computes along one axis (half-pixel source coordinates, no
  antialias, border-replicate taps; cubic with Keys a = -0.75). Hiera's
  background position embedding is resized with ``bicubic_matrix``.
- ``resize_weights``: what ``jax.image.resize`` computes along one axis
  (triangle kernel for "bilinear", Keys a = -0.5 for "bicubic"; the kernel
  is stretched by the inverse scale when shrinking, i.e. antialias, and the
  weights are normalised per output sample). Frame preprocessing and every
  mask upsampling go through it.
"""

from __future__ import annotations

import numpy as np
import torch


def bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] rows of ``F.interpolate(mode='bilinear',
    align_corners=False, antialias=False)``: two taps, edge-clamped."""
    i = np.arange(dst, dtype=np.float32)
    c = np.clip((i + 0.5) * (src / dst) - 0.5, 0.0, src - 1.0)
    i0 = np.floor(c).astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    w1 = (c - i0).astype(np.float32)
    m = np.zeros((dst, src), np.float32)
    m[np.arange(dst), i0] += 1.0 - w1
    m[np.arange(dst), i1] += w1
    return m


def bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] rows of ``F.interpolate(mode='bicubic',
    align_corners=False)``: Keys cubic convolution with a = -0.75, four taps
    from unclamped distances accumulated into border-clamped indices."""
    a = -0.75

    def kernel(t: float) -> float:
        t = abs(t)
        if t <= 1.0:
            return (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0
        if t < 2.0:
            return a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a
        return 0.0

    m = np.zeros((dst, src), np.float64)
    for i in range(dst):
        c = (i + 0.5) * (src / dst) - 0.5
        i0 = int(np.floor(c))
        for j in range(i0 - 1, i0 + 3):
            m[i, min(max(j, 0), src - 1)] += kernel(c - j)
    return m.astype(np.float32)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


def resize_weights(in_size: int, out_size: int, method: str, device=None) -> torch.Tensor:
    """[in_size, out_size] float32 resampling matrix of ``jax.image.resize``."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    w = _KERNELS[method](x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * float(torch.finfo(f32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_hw(x: torch.Tensor, height: int, width: int, method: str) -> torch.Tensor:
    """Resize the last two axes of a float32 tensor [..., h, w] as
    ``jax.image.resize`` does (an unchanged axis is skipped)."""
    h, w = x.shape[-2:]
    if h != height:
        x = torch.einsum("...hw,hH->...Hw", x, resize_weights(h, height, method, x.device))
    if w != width:
        x = torch.einsum("...hw,wW->...hW", x, resize_weights(w, width, method, x.device))
    return x
