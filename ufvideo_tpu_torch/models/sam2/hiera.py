"""Hiera image-encoder trunk + FPN neck (mirrors
``ufvideo_tpu/models/sam2/hiera.py``).

The trunk runs on 3-D token arrays in window-major order ([B·nW, ws², C]):
every block consumes that layout directly, and global attention, which does
not care about token order, rides it through a reshape to [B, T, C].
Spatial layout is materialised only at q-pooling boundaries and for the
per-stage FPN outputs.

Every block goes through hand-written kernels (``ops/hiera_block.py``),
chosen when the block is built:

- ``block``: a windowed block that keeps its width → ``fused_hiera_block``;
- ``qpool``: a q-pooling block that changes width → ``fused_qpool_block``;
- ``split``: a global block (or a q-pooling block that keeps its width) →
  ``fused_ln_matmul`` → attention (the flash kernel) → ``fused_block_tail``.

With ``quant=True`` (the JAX ``Hiera(quant=True)``) every block's dense
layers are W8A8: int8 kernels with per-column f32 scales (``kernel_q`` /
``kernel_scale`` / ``bias``, the tree of the JAX ``W8A8Dense``), rows
quantised before each product. The routes are the same three and call the
``_w8a8`` kernels: ``fused_block_w8a8``, ``fused_qpool_block_w8a8``,
``fused_ln_matmul_w8a8`` → attention (bf16, unchanged) →
``fused_block_tail_w8a8``. Patch embedding, position embeddings and norms
stay float.

The GELU is the exact (erf) one. The JAX package picks its GELU variant,
the fused q-pool routing and a multi-block stage fusion from environment
variables at trace time; this package reads no environment variable and
takes their defaults. Every window side must divide its stage's token grid
(true of every shipped configuration): the JAX package's padded path is
only approximate and is not carried over.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...configs import SAM2Config, SAM2HieraConfig
from ...ops import hiera_block as hb
from ...ops.attention import attention, window_dense_attention
from ...ops.interp import bicubic_matrix
from ...quant import quantize_kernel
from .common import ConvNHWC, position_embedding_sine

_ACT = "gelu_exact"
_EPS = 1e-6
# the wrapper of each part of a block in ``ops.hiera_block``; its plain
# version carries the suffix ``_plain``
_KERNELS = {"block": "fused_hiera_block", "qpool": "fused_qpool_block",
            "front": "fused_ln_matmul", "tail": "fused_block_tail"}
_W8A8_KERNELS = {"block": "fused_block_w8a8", "qpool": "fused_qpool_block_w8a8",
                 "front": "fused_ln_matmul_w8a8", "tail": "fused_block_tail_w8a8"}


def to_windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nW, ws·ws, C] window-major tokens."""
    b, h, w, c = x.shape
    if h % ws or w % ws:
        raise ValueError(f"window side {ws} does not divide the {h}x{w} token grid")
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def from_windows(tokens: torch.Tensor, ws: int, hw: Tuple[int, int]) -> torch.Tensor:
    """[B·nW, ws·ws, C] window-major tokens → [B, H, W, C]."""
    h, w = hw
    b = tokens.shape[0] // (h * w // ws // ws)
    x = tokens.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class DenseParams(nn.Module):
    """A dense layer's parameters in the kernels' [in, out] layout."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=dtype))


class QuantDenseParams(nn.Module):
    """A W8A8 dense layer's parameters: int8 ``kernel_q`` [in, out], f32
    ``kernel_scale`` [out], ``bias`` in the working type."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        frozen = lambda shape, dt: nn.Parameter(torch.empty(shape, dtype=dt), requires_grad=False)
        self.kernel_q = frozen((in_dim, out_dim), torch.int8)
        self.kernel_scale = frozen((out_dim,), torch.float32)
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=dtype))

    @torch.no_grad()
    def set_kernel(self, kernel: torch.Tensor) -> None:
        """Quantise a float [in, out] kernel into this layer."""
        qd = quantize_kernel(kernel)
        self.kernel_q.copy_(qd["q"])
        self.kernel_scale.copy_(qd["scale"])


class LayerNormParams(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(dim, dtype=dtype))


class AttnPairParams(nn.Module):
    def __init__(self, dim: int, qkv_out: int, proj_in: int, proj_out: int, dtype,
                 quant: bool = False):
        super().__init__()
        dense = QuantDenseParams if quant else DenseParams
        self.qkv = dense(dim, qkv_out, dtype)
        self.proj = dense(proj_in, proj_out, dtype)


class MultiScaleBlock(nn.Module):
    """Hiera block on window-major tokens: LN → (windowed) attention
    (+ q-pool) → residual → MLP."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, mlp_ratio: float,
                 q_stride: Optional[Tuple[int, int]], window_side: int, dtype: torch.dtype,
                 quant: bool = False):
        super().__init__()
        self.dim, self.dim_out, self.num_heads = dim, dim_out, num_heads
        self.quant = quant
        self.q_stride = tuple(q_stride) if q_stride is not None else None
        self.window_side = window_side  # 0 = global
        self.dtype = dtype
        self.head_dim = dim_out // num_heads
        hw = num_heads * self.head_dim
        hidden = int(dim_out * mlp_ratio)
        if q_stride is None and dim == dim_out and 0 < window_side ** 2 <= 512:
            self.route = "block"
        elif q_stride is not None and dim != dim_out:
            self.route = "qpool"
        elif q_stride is not None or window_side == 0:
            self.route = "split"
        else:
            raise NotImplementedError(
                f"windowed block of {window_side ** 2} tokens with dim {dim}->{dim_out}: "
                "the unfused MultiScaleAttention path (ROADMAP.md queue 2, "
                "fused_window_attention)"
            )
        dense = QuantDenseParams if quant else DenseParams
        self.norm1 = LayerNormParams(dim, dtype)
        self.attn = AttnPairParams(dim, 3 * hw, hw, dim_out, dtype, quant)
        self.norm2 = LayerNormParams(dim_out, dtype)
        self.mlp_layers_0 = dense(dim_out, hidden, dtype)
        self.mlp_layers_1 = dense(hidden, dim_out, dtype)
        if dim != dim_out:
            self.proj = dense(dim, dim_out, dtype)
        self.use_kernels = True
        self._prepared_key, self._prepared = None, None

    def _kernel_params(self) -> tuple:
        """The block's parameters as the kernels take them, built once for a
        set of weights, and again after a parameter was written or moved.
        LayerNorm, scale and bias vectors are f32, and the width-changing
        shortcut projection (it reads the same LN1 output) is folded into
        the qkv weights as further output columns. Float: (ln1_s, ln1_b,
        wfront, bfront, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2).
        Quantised: each weight is followed by its column scales, (ln1_s,
        ln1_b, wfront_q, sfront, bfront, wproj_q, sproj, bproj, ln2_s, ln2_b,
        w1_q, s1, b1, w2_q, s2, b2); the scales are per output column, so
        int8 columns, scales and biases concatenate exactly."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if key != self._prepared_key:
            f32 = lambda t: t.detach().float().contiguous()
            if self.quant:
                dense = lambda d: (d.kernel_q.detach(), f32(d.kernel_scale), f32(d.bias))
            else:
                dense = lambda d: (d.kernel.detach(), f32(d.bias))
            front = dense(self.attn.qkv)
            if self.dim != self.dim_out:
                front = tuple(
                    torch.cat([a, b], dim=-1) for a, b in zip(front, dense(self.proj)))
            self._prepared = (
                f32(self.norm1.scale), f32(self.norm1.bias), *front, *dense(self.attn.proj),
                f32(self.norm2.scale), f32(self.norm2.bias),
                *dense(self.mlp_layers_0), *dense(self.mlp_layers_1),
            )
            self._prepared_key = key
        return self._prepared

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, S, C]
        x = x.to(self.dtype)
        k = self.use_kernels
        heads, hd = self.num_heads, self.head_dim
        hw = heads * hd
        params = self._kernel_params()
        if self.route != "split" and x.shape[1] != self.window_side ** 2:
            raise ValueError(f"{x.shape[1]} tokens a window, built for {self.window_side ** 2}")
        names = _W8A8_KERNELS if self.quant else _KERNELS
        pick = lambda part: getattr(hb, names[part] + ("" if k else "_plain"))
        n_front = 5 if self.quant else 4  # (ln1_s, ln1_b, wfront, [sfront,] bfront)
        if self.route == "block":
            fn = pick("block")
            return fn(x, params, heads, hd, act=_ACT, eps=_EPS)
        if self.route == "qpool":
            fn = pick("qpool")
            return fn(x, params, heads, hd, self.q_stride, act=_ACT, eps=_EPS)

        ln_matmul = pick("front")
        front = ln_matmul(x, *params[:n_front], eps=_EPS)
        n, s, _ = front.shape
        shortcut = x if self.dim == self.dim_out else front[..., 3 * hw:]
        parts = front[..., :3 * hw].reshape(n, s, 3, heads, hd)
        q, kk, v = parts[:, :, 0], parts[:, :, 1], parts[:, :, 2]
        if self.q_stride is not None:
            ws = self.window_side
            shortcut = hb.pool_window_tokens(shortcut, ws, self.q_stride)
            q = hb.pool_window_tokens(q.reshape(n, s, hw), ws, self.q_stride)
            q = q.reshape(n, -1, heads, hd)
            o = window_dense_attention(q, kk, v, scale=hd ** -0.5)
        else:  # global block
            o = attention(q, kk, v, scale=hd ** -0.5, use_kernel=k)
        tail = pick("tail")
        return tail(shortcut, o.reshape(n, -1, hw), params[n_front:], act=_ACT, eps=_EPS)


@functools.lru_cache(maxsize=None)
def _bicubic(src: int, dst: int) -> np.ndarray:
    return bicubic_matrix(src, dst)


class Hiera(nn.Module):
    """Multi-stage trunk returning per-stage NHWC feature maps."""

    def __init__(self, cfg: SAM2HieraConfig, dtype: torch.dtype, quant: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.quant = quant  # W8A8 blocks
        self.patch_embed = ConvNHWC(
            3, cfg.embed_dim, cfg.patch_kernel, stride=cfg.patch_stride,
            padding=cfg.patch_padding, dtype=dtype,
        )
        self.pos_embed = nn.Parameter(torch.empty(
            *cfg.window_pos_embed_bkg_spatial_size, cfg.embed_dim, dtype=dtype))
        self.pos_embed_window = nn.Parameter(torch.empty(
            cfg.window_spec[0], cfg.window_spec[0], cfg.embed_dim, dtype=dtype))

        stages = cfg.stages
        self.stage_ends = [sum(stages[: i + 1]) - 1 for i in range(len(stages))]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]]
        grid = (cfg.image_size + 2 * cfg.patch_padding - cfg.patch_kernel) // cfg.patch_stride + 1
        blocks = []
        embed_dim, num_heads, cur_stage, side = cfg.embed_dim, cfg.num_heads, 1, 0
        for i in range(sum(stages)):
            dim_out = embed_dim
            window_size = 0 if i in cfg.global_att_blocks else cfg.window_spec[cur_stage - 1]
            if i - 1 in self.stage_ends:
                dim_out = int(embed_dim * cfg.dim_mul)
                num_heads = int(num_heads * cfg.head_mul)
                cur_stage += 1
            pool = cfg.q_stride if i in q_pool_blocks else None
            if window_size > 0:
                side = window_size
                if grid % side:
                    raise ValueError(
                        f"block {i}: window side {side} does not divide the {grid}x{grid} "
                        "token grid"
                    )
            elif side == 0:
                side = 1
            blocks.append(MultiScaleBlock(
                embed_dim, dim_out, num_heads, cfg.mlp_ratio, pool,
                side if window_size > 0 else 0, dtype, quant,
            ))
            if pool is not None:
                if side % pool[0] or side % pool[1] or grid % pool[0]:
                    raise ValueError(f"block {i}: q-stride {pool} does not divide window {side}")
                grid //= pool[0]
                side = max(side // pool[0], 1)
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    @torch.no_grad()
    def reset_own_parameters(self, gen: torch.Generator) -> None:
        self.pos_embed.zero_()
        self.pos_embed_window.zero_()

    def _pos(self, h: int, w: int) -> torch.Tensor:
        """Bicubic-resized background embedding + tiled window embedding."""
        bg, win = self.pos_embed.float(), self.pos_embed_window.float()
        mh = torch.from_numpy(_bicubic(bg.shape[0], h)).to(bg.device)
        mw = torch.from_numpy(_bicubic(bg.shape[1], w)).to(bg.device)
        bg_r = torch.einsum("hy,yxc,wx->hwc", mh, bg, mw)
        return bg_r + win.repeat(h // win.shape[0], w // win.shape[1], 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_embed(x.to(self.dtype))
        b, h, w, _ = x.shape
        x = x + self._pos(h, w)[None].to(x.dtype)

        outputs: List[torch.Tensor] = []
        tokens: Optional[torch.Tensor] = None
        side = 0
        for i, blk in enumerate(self.blocks):
            ws = blk.window_side
            if ws > 0 and side != ws:
                # relayout to this block's window side (stage entries and
                # rewindows after a pool; blocks of the same side are free)
                if tokens is not None:
                    x = from_windows(tokens, side, (h, w))
                tokens = to_windows(x, ws)
                side = ws
            elif ws == 0 and tokens is None:
                tokens, side = to_windows(x, 1), 1
            if ws == 0:
                out = blk(tokens.reshape(b, h * w, -1))
                tokens = out.reshape(tokens.shape[0], side * side, -1)
            else:
                tokens = blk(tokens)
            if blk.q_stride is not None:
                sy, sx = blk.q_stride
                h, w = h // sy, w // sx
                side = max(side // sy, 1)
            if i in self.stage_ends:
                x = from_windows(tokens, side, (h, w))
                outputs.append(x)
        return outputs  # finest → coarsest


class FpnNeck(nn.Module):
    """FPN neck: 1×1 lateral convs + nearest top-down on the configured
    levels; returns (features, sine position embeddings), finest first."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        # convs[k] handles level n - k: the coarsest level comes first
        self.convs = nn.ModuleList(
            nn.Linear(c, cfg.fpn_dim, dtype=dtype) for c in cfg.fpn_backbone_channels
        )

    def forward(self, xs: List[torch.Tensor]):
        cfg = self.cfg
        n = len(xs) - 1
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        pos: List[Optional[torch.Tensor]] = [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i](xs[i].to(self.dtype))
            if i in cfg.fpn_top_down_levels and prev is not None:
                th, tw = lateral.shape[1:3]
                ph, pw = prev.shape[1:3]
                dev = prev.device
                iy = ((torch.arange(th, device=dev) + 0.5) * (ph / th)).floor().long()
                ix = ((torch.arange(tw, device=dev) + 0.5) * (pw / tw)).floor().long()
                prev = lateral + prev[:, iy][:, :, ix]
            else:
                prev = lateral
            out[i] = prev
            h, w = prev.shape[1:3]
            sine = position_embedding_sine(h, w, cfg.fpn_dim, device=prev.device)
            pos[i] = sine.to(prev.dtype)[None].expand(prev.shape)
        return out, pos
