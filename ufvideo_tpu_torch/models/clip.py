"""CLIP vision tower, the reference's alternative to SigLIP (mirrors
``ufvideo_tpu/models/clip.py``): patchify as a reshape and one matmul (no
bias), the class token, learned positions, ``pre_layrnorm``, then the first
``num_encode_layers`` pre-LN layers with quick-GELU (the
``hidden_states[select_layer]`` tap), and the class token stripped for
``select_feature="patch"``. Each layer's attention goes through
``ops.attention.attention``: on the card the ``flash_attention`` kernel (577
tokens of 16 heads of 64 at CLIP-L/14-336), its plain version on the CPU or
with ``use_kernel=False``. ``UFVideoModel`` does not use this tower, as the
JAX composite does not; ``weights.convert_clip`` fills it from an HF
``CLIPVisionModel`` state dict.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.attention import attention
from ..ops.hiera_block import layer_norm_flax
from . import init


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-L/14 at 336² by default."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    select_layer: int = -2
    select_feature: str = "patch"

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_encode_layers(self) -> int:
        if self.select_layer >= 0:
            raise ValueError(f"select_layer {self.select_layer}: a negative tap is expected")
        return self.num_layers + 1 + self.select_layer


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _ln(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)``, then the working type."""
    return layer_norm_flax(x, ln.weight, ln.bias, ln.eps, torch.float32).to(dtype)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c, m = cfg.hidden_size, cfg.intermediate_size
        ln = lambda: nn.LayerNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
        lin = lambda i, o: nn.Linear(i, o, dtype=dtype)
        self.layer_norm1, self.layer_norm2 = ln(), ln()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (lin(c, c) for _ in range(4))
        self.fc1, self.fc2 = lin(c, m), lin(m, c)

    def forward(self, x: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        b, s, _ = x.shape
        h = _ln(self.layer_norm1, x, dt)
        heads = lambda t: t.reshape(b, s, cfg.num_heads, cfg.head_dim)
        o = attention(heads(self.q_proj(h)), heads(self.k_proj(h)), heads(self.v_proj(h)),
                      use_kernel=use_kernel)
        x = x + self.out_proj(o.reshape(b, s, cfg.hidden_size))
        h = _ln(self.layer_norm2, x, dt)
        return x + self.fc2(quick_gelu(self.fc1(h)))


class CLIPVisionTower(nn.Module):
    """[B, H, W, 3] NHWC pixels (resized, normalised) → [B, grid², hidden]
    patch features at the ``select_layer`` tap."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c, p = cfg.hidden_size, cfg.patch_size
        # features ordered (ph, pw, channel), as the JAX kernel [p, p, 3, C]
        self.patch_embedding = nn.Linear(p * p * 3, c, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(c, dtype=dtype))
        self.position_embedding = nn.Parameter(torch.empty(cfg.num_patches + 1, c, dtype=dtype))
        self.pre_layrnorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg, dtype) for _ in range(cfg.num_encode_layers))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The flax initialisers' distributions: lecun-normal kernels (the
        patch kernel's fan-in p·p·3), zero biases, normal(0.02) class and
        position embeddings, unit-scale LayerNorms."""
        init.reset_tree_(self, gen)
        init.normal_(self.class_embedding, 0.02, gen)
        init.normal_(self.position_embedding, 0.02, gen)

    def forward(self, pixels: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        b = pixels.shape[0]
        p, g = cfg.patch_size, cfg.grid_size
        px = pixels[:, : g * p, : g * p, :].to(dt)
        px = px.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embedding(px.reshape(b, cfg.num_patches, p * p * 3))
        cls = self.class_embedding.to(dt).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None].to(dt)
        x = _ln(self.pre_layrnorm, x, dt)
        for layer in self.layers:
            x = layer(x, use_kernel)
        return x[:, 1:] if cfg.select_feature == "patch" else x
