"""SigLIP-SO400M vision tower (mirrors ``ufvideo_tpu/models/siglip.py``,
default fused branch): patchify matmul, learned position embeddings, and
the first ``num_encode_layers`` pre-LN encoder layers (the
``hidden_states[-2]`` tap — the last layer and the post-LN never run).

Each encoder layer is one ``ops.fused_hiera_block`` call with one
729-token window per frame. The GELU is fixed when the tower is built. With
``quant=True`` (the JAX ``SiglipVisionTower(quant=True)`` on its fused
route) the dense kernels are int8 with per-column scales and each layer is
one ``ops.fused_block_w8a8`` call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import SiglipVisionConfig
from ..ops.hiera_block import (
    fused_block_w8a8, fused_block_w8a8_plain, fused_hiera_block, fused_hiera_block_plain)
from ..quant import quantize_kernel
from . import init


class SiglipEncoderLayer(nn.Module):
    """Weights in the kernel's [in, out] layout; qkv columns [q | k | v].
    With ``quant`` each ``*_kernel`` is int8 beside a f32 ``*_scale`` [out]."""

    _DENSE = ("qkv", "out", "fc1", "fc2")

    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype, act: str,
                 quant: bool = False):
        super().__init__()
        self.cfg = cfg
        self.act = act
        self.quant = quant
        self.dtype = dtype
        c, m = cfg.hidden_size, cfg.intermediate_size
        p = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=dtype))
        self.ln1_scale, self.ln1_bias = p(c), p(c)
        self.ln2_scale, self.ln2_bias = p(c), p(c)
        for name, (i, o) in zip(self._DENSE, ((c, 3 * c), (c, c), (c, m), (m, c))):
            if quant:
                frozen = lambda shape, dt: nn.Parameter(
                    torch.empty(shape, dtype=dt), requires_grad=False)
                setattr(self, f"{name}_kernel", frozen((i, o), torch.int8))
                setattr(self, f"{name}_scale", frozen((o,), torch.float32))
            else:
                setattr(self, f"{name}_kernel", p(i, o))
            setattr(self, f"{name}_bias", p(o))
        self.use_kernels = True

    @torch.no_grad()
    def set_kernel(self, name: str, kernel: torch.Tensor) -> None:
        """Quantise a float [in, out] kernel into the dense layer ``name``."""
        qd = quantize_kernel(kernel)
        getattr(self, f"{name}_kernel").copy_(qd["q"])
        getattr(self, f"{name}_scale").copy_(qd["scale"])

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for s, b in ((self.ln1_scale, self.ln1_bias), (self.ln2_scale, self.ln2_bias)):
            s.fill_(1.0)
            b.zero_()
        for name in self._DENSE:
            k = getattr(self, f"{name}_kernel")
            if self.quant:  # the float layer's draw, rounded to dtype, quantised
                w = torch.empty(k.shape, dtype=self.dtype, device=k.device)
                self.set_kernel(name, init.lecun_normal_(w, k.shape[0], gen))
            else:
                init.lecun_normal_(k, k.shape[0], gen)
            getattr(self, f"{name}_bias").zero_()

    def params(self) -> tuple:
        dense = lambda n: tuple(
            getattr(self, f"{n}_{part}")
            for part in (("kernel", "scale", "bias") if self.quant else ("kernel", "bias")))
        return (
            self.ln1_scale, self.ln1_bias, *dense("qkv"), *dense("out"),
            self.ln2_scale, self.ln2_bias, *dense("fc1"), *dense("fc2"),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, S, C]
        if self.quant:
            fn = fused_block_w8a8 if self.use_kernels else fused_block_w8a8_plain
        else:
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
        quant: bool = False,  # W8A8 int8 encoder layers
    ):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.quant = quant
        p = cfg.patch_size
        # patchify as one matmul; input features ordered (ph, pw, channel)
        self.patch_embedding = nn.Linear(p * p * 3, cfg.hidden_size, dtype=dtype)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.num_patches, cfg.hidden_size, dtype=dtype)
        )
        self.layers = nn.ModuleList(
            SiglipEncoderLayer(cfg, dtype, act, quant) for _ in range(cfg.num_encode_layers)
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
