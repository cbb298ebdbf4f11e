"""SigLIP-SO400M vision tower (mirrors ``ufvideo_tpu/models/siglip.py``,
default fused branch): patchify matmul, learned position embeddings, and
the first ``num_encode_layers`` pre-LN encoder layers (the
``hidden_states[-2]`` tap — the last layer and the post-LN never run).

Each encoder layer is one ``ops.fused_hiera_block`` call with one
729-token window per frame. The GELU is fixed when the tower is built.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import SiglipVisionConfig
from ..ops.hiera_block import fused_hiera_block, fused_hiera_block_plain
from . import init


class SiglipEncoderLayer(nn.Module):
    """Weights in the kernel's [in, out] layout; qkv columns [q | k | v]."""

    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype, act: str):
        super().__init__()
        self.cfg = cfg
        self.act = act
        c, m = cfg.hidden_size, cfg.intermediate_size
        p = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=dtype))
        self.ln1_scale, self.ln1_bias = p(c), p(c)
        self.qkv_kernel, self.qkv_bias = p(c, 3 * c), p(3 * c)
        self.out_kernel, self.out_bias = p(c, c), p(c)
        self.ln2_scale, self.ln2_bias = p(c), p(c)
        self.fc1_kernel, self.fc1_bias = p(c, m), p(m)
        self.fc2_kernel, self.fc2_bias = p(m, c), p(c)
        self.use_kernels = True

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for s, b in ((self.ln1_scale, self.ln1_bias), (self.ln2_scale, self.ln2_bias)):
            s.fill_(1.0)
            b.zero_()
        for k, b in (
            (self.qkv_kernel, self.qkv_bias), (self.out_kernel, self.out_bias),
            (self.fc1_kernel, self.fc1_bias), (self.fc2_kernel, self.fc2_bias),
        ):
            init.lecun_normal_(k, k.shape[0], gen)
            b.zero_()

    def params(self) -> tuple:
        return (
            self.ln1_scale, self.ln1_bias, self.qkv_kernel, self.qkv_bias,
            self.out_kernel, self.out_bias, self.ln2_scale, self.ln2_bias,
            self.fc1_kernel, self.fc1_bias, self.fc2_kernel, self.fc2_bias,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, S, C]
        fn = fused_hiera_block if self.use_kernels else fused_hiera_block_plain
        return fn(
            x, self.params(), self.cfg.num_heads, self.cfg.head_dim,
            act=self.act, eps=self.cfg.layer_norm_eps,
        )


class SiglipVisionTower(nn.Module):
    """[B, H, W, 3] NHWC frames (resized + normalized) →
    [B, grid², hidden] penultimate-layer patch features."""

    def __init__(
        self,
        cfg: SiglipVisionConfig,
        dtype: torch.dtype = torch.bfloat16,
        act: str = "gelu_tanh",  # HF SigLIP gelu_pytorch_tanh
    ):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        p = cfg.patch_size
        # patchify as one matmul; input features ordered (ph, pw, channel)
        self.patch_embedding = nn.Linear(p * p * 3, cfg.hidden_size, dtype=dtype)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.num_patches, cfg.hidden_size, dtype=dtype)
        )
        self.layers = nn.ModuleList(
            SiglipEncoderLayer(cfg, dtype, act) for _ in range(cfg.num_encode_layers)
        )

    def reset_parameters(self, gen: torch.Generator) -> None:
        init.linear_(self.patch_embedding, gen)
        init.normal_(self.position_embedding, 0.02, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b = pixels.shape[0]
        p, g = cfg.patch_size, cfg.grid_size
        px = pixels[:, : g * p, : g * p, :].to(self.dtype)
        px = px.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        px = px.reshape(b, cfg.num_patches, p * p * 3)
        x = F.linear(px, self.patch_embedding.weight, self.patch_embedding.bias)
        x = x + self.position_embedding[None].to(self.dtype)
        for layer in self.layers:
            x = layer(x)
        return x
