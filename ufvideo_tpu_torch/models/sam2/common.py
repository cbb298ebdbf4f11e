"""Shared SAM2 building blocks (mirrors ``ufvideo_tpu/models/sam2/common.py``).

Spatial tensors are NHWC, as in the JAX package, so the two can be compared
array for array; convolutions permute to torch's NCHW inside. Parameter and
child names follow the flax tree (``weights.load_jax_params`` walks both by
name).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import attention

NO_OBJ_SCORE = -1024.0


class LayerNorm32(nn.Module):
    """LayerNorm over the last axis with float32 statistics, returned in the
    input's dtype: flax ``nn.LayerNorm(dtype=float32)`` followed by the cast
    back, and the channel LayerNorm of NHWC maps (``ChannelLayerNorm``)."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.layer_norm(
            x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(), self.eps
        )
        return out.to(x.dtype)


def ChannelLayerNorm(dim: int, dtype: torch.dtype, eps: float = 1e-6) -> LayerNorm32:
    return LayerNorm32(dim, eps, dtype)


class ConvNHWC(nn.Conv2d):
    """``nn.Conv2d`` on NHWC maps."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvTransposeNHWC(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on NHWC maps."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SamMLP(nn.Module):
    """MLP with ReLU (or GELU) between layers."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 dtype: torch.dtype, sigmoid_output: bool = False, activation: str = "relu"):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, dtype=dtype) for a, b in zip(dims[:-1], dims[1:])
        )
        self.act = {"relu": F.relu, "gelu": F.gelu}[activation]
        self.sigmoid_output = sigmoid_output
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class ProjAttention(nn.Module):
    """q / k / v / out projection attention with an optional internal
    downsample. Its attentions are small (8 heads of dim 32 or 16, a handful
    of tokens on one side); on the card they go to the flash kernel like
    every other attention, whose constraints (head dim and strides multiples
    of 8) they meet."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int,
                 dtype: torch.dtype, kv_in_dim: Optional[int] = None):
        super().__init__()
        internal = embedding_dim // downsample_rate
        kv_in = kv_in_dim or embedding_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal, dtype=dtype)
        self.k_proj = nn.Linear(kv_in, internal, dtype=dtype)
        self.v_proj = nn.Linear(kv_in, internal, dtype=dtype)
        self.out_proj = nn.Linear(internal, embedding_dim, dtype=dtype)
        self.use_kernels = True

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, nq, _ = q.shape
        nk = k.shape[1]
        h = self.num_heads
        qp = self.q_proj(q).reshape(b, nq, h, -1)
        kp = self.k_proj(k).reshape(b, nk, h, -1)
        vp = self.v_proj(v).reshape(b, nk, h, -1)
        o = attention(qp, kp, vp, use_kernel=self.use_kernels)
        return self.out_proj(o.reshape(b, nq, -1))


def position_embedding_sine(
    h: int, w: int, num_pos_feats: int = 256, temperature: float = 10000.0, device=None
) -> torch.Tensor:
    """Normalized 2-D sine embedding [h, w, num_pos_feats], float32."""
    half = num_pos_feats // 2
    scale = 2 * math.pi
    f32 = torch.float32
    y = torch.arange(1, h + 1, dtype=f32, device=device)[:, None] / (h + 1e-6) * scale
    x = torch.arange(1, w + 1, dtype=f32, device=device)[None, :] / (w + 1e-6) * scale
    y, x = y.expand(h, w), x.expand(h, w)
    dim_t = torch.arange(half, dtype=f32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / half)

    def enc(e):
        p = e[..., None] / dim_t  # [h, w, half]
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1).reshape(h, w, half)

    return torch.cat([enc(y), enc(x)], dim=-1)


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier point / grid embedding."""

    def __init__(self, num_pos_feats: int, dtype: torch.dtype):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.empty(2, num_pos_feats, dtype=dtype)
        )

    def reset_own_parameters(self, gen: torch.Generator) -> None:
        from .. import init

        init.normal_(self.positional_encoding_gaussian_matrix, 1.0, gen)  # flax normal(1.0)

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """coords normalized to [0, 1], [..., 2] → [..., 2·feats], float32."""
        c = 2.0 * coords.float() - 1.0
        c = 2 * math.pi * (c @ self.positional_encoding_gaussian_matrix.float())
        return torch.cat([c.sin(), c.cos()], dim=-1)

    def grid(self, h: int, w: int) -> torch.Tensor:
        """Dense grid embedding [h, w, 2·feats]."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1)
        return self(grid)


def get_1d_sine_pe(pos: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """1-D sine temporal embedding."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / pe_dim)
    pe = pos.float()[..., None] / dim_t
    return torch.cat([pe.sin(), pe.cos()], dim=-1)
