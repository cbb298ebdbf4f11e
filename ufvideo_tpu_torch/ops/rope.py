"""Rotary position embeddings (mirrors ``ufvideo_tpu/ops/rope.py``): 1-D,
HF Qwen2 half-split layout, for the LLM; 2-D axial, interleaved pairs, for
SAM2's memory attention."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin tables for integer positions; each [..., head_dim // 2]."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., seq, heads, head_dim]; cos / sin [..., seq, head_dim // 2]."""
    dtype = x.dtype
    x = x.to(torch.float32)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def apply_rope_interleaved(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Interleaved (complex-pair) RoPE: adjacent pairs rotate together.
    x [..., seq, heads, head_dim]; cos / sin broadcastable to
    [..., seq, 1, head_dim // 2]."""
    dtype = x.dtype
    x = x.to(torch.float32)
    xr, xi = x[..., 0::2], x[..., 1::2]
    out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return out.reshape(x.shape).to(dtype)


def axial_rope_cos_sin(
    head_dim: int, h: int, w: int, theta: float = 10000.0, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D axial RoPE tables for an h*w row-major token grid: the first half
    of the pair dims encodes x, the second half y. Each [h*w, head_dim // 2]."""
    quarter = head_dim // 4
    f32 = torch.float32
    exponent = torch.arange(0, head_dim, 4, dtype=f32, device=device)[:quarter] / head_dim
    freqs = 1.0 / (theta ** exponent)
    t = torch.arange(h * w, dtype=f32, device=device)
    grid_x = t % w
    grid_y = torch.floor(t / w)
    ang = torch.cat([grid_x[:, None] * freqs, grid_y[:, None] * freqs], dim=-1)
    return torch.cos(ang), torch.sin(ang)
