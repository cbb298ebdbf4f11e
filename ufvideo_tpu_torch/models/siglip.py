"""SigLIP-SO400M vision tower (mirrors ``ufvideo_tpu/models/siglip.py``):
patchify matmul, learned position embeddings, and the first
``num_encode_layers`` pre-LN encoder layers (the ``hidden_states[-2]`` tap —
the last layer and the post-LN never run).

Each layer takes one of four routes, fixed when the tower is built from a
``VisionRouting`` (the JAX tower picks them from ``ln_dtype`` and from
``UFVIDEO_SIGLIP_INT8_FUSED`` / the backend at trace time):

- float, ``siglip_ln_dtype="f32"`` (the default): one ``ops.fused_hiera_block``
  call with one 729-token window per frame and the routing's SigLIP GELU;
- float, ``"bf16"``: the unfused layer (JAX ``SiglipAttention`` /
  ``SiglipMLP``): LayerNorm rounded to bf16 (flax ``nn.LayerNorm(dtype=bf16)``),
  dense qkv, ``ops.mha_full_attention_packed`` on the packed buffer, dense out,
  dense fc1, tanh GELU, dense fc2;
- ``quant=True``, ``siglip_int8_fused`` (the default): one
  ``ops.fused_block_w8a8`` call, int8 kernels with per-column scales;
- ``quant=True``, not fused: the unfused W8A8 layer (JAX
  ``SiglipAttentionInt8`` / ``SiglipMLPInt8``): f32 LayerNorm, then each dense
  product a ``quant.w8a8_linear`` around the packed attention kernel.

All four read the same parameters, so one JAX tree loads into every route.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import SiglipVisionConfig, VisionRouting
from ..ops.hiera_block import (
    fused_block_w8a8, fused_hiera_block, fused_hiera_block_plain, layer_norm_flax)
from ..ops.vit_attention import mha_full_attention_packed, mha_full_attention_packed_plain
from ..quant import int8_kernel, quantize_kernel, w8a8_linear
from . import init


class SiglipEncoderLayer(nn.Module):
    """Weights in the kernel's [in, out] layout; qkv columns [q | k | v].
    With ``quant`` each ``*_kernel`` is int8 beside a f32 ``*_scale`` [out]."""

    _DENSE = ("qkv", "out", "fc1", "fc2")

    def __init__(self, cfg: SiglipVisionConfig, dtype: torch.dtype, act: str,
                 quant: bool = False, fused: bool = True,
                 ln_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.act = act  # the fused float layer's GELU
        self.quant = quant
        self.fused = fused
        self.ln_dtype = ln_dtype  # the unfused layer's LayerNorm output type
        self.dtype = dtype
        c, m = cfg.hidden_size, cfg.intermediate_size
        p = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=dtype))
        self.ln1_scale, self.ln1_bias = p(c), p(c)
        self.ln2_scale, self.ln2_bias = p(c), p(c)
        for name, (i, o) in zip(self._DENSE, ((c, 3 * c), (c, c), (c, m), (m, c))):
            if quant:
                frozen = lambda shape, dt: nn.Parameter(
                    torch.empty(shape, dtype=dt), requires_grad=False)
                # the unfused layer's products read their weights K-contiguous
                setattr(self, f"{name}_kernel",
                        frozen((i, o), torch.int8) if fused else int8_kernel(i, o))
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

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = getattr(self, f"{name}_kernel"), getattr(self, f"{name}_bias")
        if self.quant:
            return w8a8_linear(x, kernel, getattr(self, f"{name}_scale"), bias, self.dtype)
        return x @ kernel.to(self.dtype) + bias.to(self.dtype)

    def _unfused(self, x: torch.Tensor) -> torch.Tensor:
        cfg, eps = self.cfg, self.cfg.layer_norm_eps
        att = mha_full_attention_packed if self.use_kernels else mha_full_attention_packed_plain
        h = layer_norm_flax(x, self.ln1_scale, self.ln1_bias, eps, self.ln_dtype).to(self.dtype)
        o = att(self._dense("qkv", h), cfg.num_heads, cfg.head_dim)
        x = x + self._dense("out", o)
        h = layer_norm_flax(x, self.ln2_scale, self.ln2_bias, eps, self.ln_dtype).to(self.dtype)
        h = F.gelu(self._dense("fc1", h), approximate="tanh")
        return x + self._dense("fc2", h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, S, C]
        if not self.fused:
            return self._unfused(x)
        cfg = self.cfg
        if self.quant:  # the plain forward keeps the W8A8 block's backward
            return fused_block_w8a8(x, self.params(), cfg.num_heads, cfg.head_dim, act=self.act,
                                    eps=cfg.layer_norm_eps, use_kernel=self.use_kernels)
        fn = fused_hiera_block if self.use_kernels else fused_hiera_block_plain
        return fn(x, self.params(), cfg.num_heads, cfg.head_dim, act=self.act,
                  eps=cfg.layer_norm_eps)


class SiglipVisionTower(nn.Module):
    """[B, H, W, 3] NHWC frames (resized + normalized) →
    [B, grid², hidden] penultimate-layer patch features."""

    def __init__(
        self,
        cfg: SiglipVisionConfig,
        dtype: torch.dtype = torch.bfloat16,
        quant: bool = False,  # W8A8 int8 encoder layers
        routing: Optional[VisionRouting] = None,
    ):
        super().__init__()
        routing = routing or VisionRouting()
        self.cfg = cfg
        self.dtype = dtype
        self.quant = quant
        fused = routing.siglip_int8_fused if quant else routing.siglip_ln_dtype == "f32"
        # the W8A8 layer normalises in f32 whatever siglip_ln_dtype says
        ln_dtype = torch.bfloat16 if routing.siglip_ln_dtype == "bf16" and not quant \
            else torch.float32
        # the fused W8A8 layer takes the tanh GELU, as the JAX one does
        act = routing.siglip_act if not quant else "gelu_tanh"
        p = cfg.patch_size
        # patchify as one matmul; input features ordered (ph, pw, channel)
        self.patch_embedding = nn.Linear(p * p * 3, cfg.hidden_size, dtype=dtype)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.num_patches, cfg.hidden_size, dtype=dtype)
        )
        self.layers = nn.ModuleList(
            SiglipEncoderLayer(cfg, dtype, act, quant, fused, ln_dtype)
            for _ in range(cfg.num_encode_layers)
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
