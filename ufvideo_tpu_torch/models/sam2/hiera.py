"""Hiera image-encoder trunk + FPN neck (mirrors
``ufvideo_tpu/models/sam2/hiera.py``).

The trunk runs on 3-D token arrays in window-major order ([B·nW, ws², C]):
every block consumes that layout directly, and global attention, which does
not care about token order, rides it through a reshape to [B, T, C].
Spatial layout is materialised only at q-pooling boundaries and for the
per-stage FPN outputs.

Each block takes one route, fixed when it is built from its shape, ``quant``
and a ``VisionRouting`` (the JAX package reads the same choices from
``UFVIDEO_QPOOL_FUSED``, ``UFVIDEO_SAM2_INT8_SPECIAL``, ``UFVIDEO_HIERA_GELU``
and ``UFVIDEO_HIERA_STAGE_NB`` at trace time; this package reads no
environment variable):

- ``block``: a windowed block that keeps its width → ``fused_hiera_block``;
  with ``hiera_stage_nb`` > 1, runs of up to that many consecutive identical
  such blocks go to one ``fused_hiera_stage`` call instead (float only, as in
  JAX; the JAX cap of ``96 // pairs`` blocks a run comes from a TPU compile
  budget and is not carried over: grouping changes launches, not math);
- ``qpool``: a q-pooling block that changes width, with ``qpool_fused`` →
  ``fused_qpool_block``;
- ``split``: a global block, or a q-pooling block off the fused route →
  ``fused_ln_matmul`` → pooling and ``window_dense_attention`` (q-pool) or
  the flash kernel (global) → ``fused_block_tail``;
- ``generic``: everything else: the unfused block (flax LayerNorm, dense
  layers, ``MultiScaleAttention``, exact GELU). No shipped float
  configuration takes it; the W8A8 trunk's q-pool and global blocks take it
  when ``sam2_int8_special`` is off.

``MultiScaleAttention`` has the JAX module's four branches: q-stride →
``window_dense_attention``; global → the flash kernel; windowed with at most
512 tokens → ``fused_window_attention``; larger windows →
``window_dense_attention``.

With ``quant=True`` (the JAX ``Hiera(quant=True)``) every block's dense
layers are W8A8: int8 kernels with per-column f32 scales (``kernel_q`` /
``kernel_scale`` / ``bias``, the tree of the JAX ``W8A8Dense``), rows
quantised before each product. The routes call the ``_w8a8`` kernels
(``fused_block_w8a8``, ``fused_qpool_block_w8a8``, ``fused_ln_matmul_w8a8``
→ attention (bf16) → ``fused_block_tail_w8a8``), and the generic route
``quant.W8A8Linear``. Patch embedding, position embeddings and norms stay
float. Every route reads the same parameters, under the JAX names, so one
JAX tree loads into every routing.

The kernels' GELU is the routing's (exact by default); the generic route's
is always the exact one, as in JAX. Not carried over, being TPU layout:
``head_pad`` / ``UFVIDEO_HIERA_ALIGN_QKV``, ``UFVIDEO_GLOBAL_PAD_HEADS`` and
``UFVIDEO_HIERA_GROUP_ROWS``. Every window side must divide its stage's
token grid (true of every shipped configuration): the JAX package's padded
path is only approximate and is not carried over.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...configs import SAM2Config, SAM2HieraConfig, VisionRouting
from ...ops import hiera_block as hb
from ...ops.attention import attention, window_dense_attention
from ...ops.interp import bicubic_matrix
from ...ops.window_attention import fused_window_attention, fused_window_attention_plain
from ...quant import W8A8Linear
from .common import ConvNHWC, position_embedding_sine

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
    """A dense layer in the kernels' [in, out] layout (flax ``nn.Dense``
    with ``dtype``: the product in that type, then the bias added)."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class LayerNormParams(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(dim, dtype=dtype))


class MultiScaleAttention(nn.Module):
    """Windowed / global attention with optional q max-pooling on
    window-major tokens [N, S, C] (the JAX ``MultiScaleAttention``):
    ``qkv`` → attention → ``proj``. ``window_side`` 0 is a global block
    ([B, T, C] in). With ``quant`` the dense layers are ``W8A8Linear``;
    ``unfused`` says they run their own products (else a fused block kernel
    reads their weights), which fixes the layout of their int8 weights."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, window_side: int,
                 q_stride: Optional[Tuple[int, int]], dtype: torch.dtype, quant: bool = False,
                 unfused: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim_out // num_heads
        self.window_side = window_side
        self.q_stride = tuple(q_stride) if q_stride is not None else None
        dense = functools.partial(W8A8Linear, unfused=unfused) if quant else DenseParams
        hw = num_heads * self.head_dim
        self.qkv = dense(dim, 3 * hw, dtype)
        self.proj = dense(hw, dim_out, dtype)
        self.use_kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, _ = x.shape
        heads, hd = self.num_heads, self.head_dim
        hw = heads * hd
        scale = hd ** -0.5
        qkv = self.qkv(x)  # [N, S, 3·H·hd], the window kernel's layout
        if self.q_stride is not None:
            ws = self.window_side
            if ws % self.q_stride[0] or ws % self.q_stride[1]:
                raise ValueError(f"q-stride {self.q_stride} does not divide window {ws}")
            q = hb.pool_window_tokens(qkv[..., :hw], ws, self.q_stride)
            q = q.reshape(n, -1, heads, hd)
            k = qkv[..., hw:2 * hw].reshape(n, s, heads, hd)
            v = qkv[..., 2 * hw:].reshape(n, s, heads, hd)
            o = window_dense_attention(q, k, v, scale=scale).reshape(n, -1, hw)
        elif self.window_side == 0:
            parts = qkv.reshape(n, s, 3, heads, hd)
            o = attention(parts[:, :, 0], parts[:, :, 1], parts[:, :, 2], scale=scale,
                          use_kernel=self.use_kernels).reshape(n, s, hw)
        elif s <= 512:
            fn = fused_window_attention if self.use_kernels else fused_window_attention_plain
            o = fn(qkv, heads, hd)
        else:
            parts = qkv.reshape(n, s, 3, heads, hd)
            o = window_dense_attention(parts[:, :, 0], parts[:, :, 1], parts[:, :, 2],
                                       scale=scale).reshape(n, s, hw)
        return self.proj(o)


class MultiScaleBlock(nn.Module):
    """Hiera block on window-major tokens: LN → (windowed) attention
    (+ q-pool) → residual → MLP."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, mlp_ratio: float,
                 q_stride: Optional[Tuple[int, int]], window_side: int, dtype: torch.dtype,
                 quant: bool = False, routing: Optional[VisionRouting] = None):
        super().__init__()
        routing = routing or VisionRouting()
        self.dim, self.dim_out, self.num_heads = dim, dim_out, num_heads
        self.quant = quant
        self.q_stride = tuple(q_stride) if q_stride is not None else None
        self.window_side = window_side  # 0 = global
        self.dtype = dtype
        self.act = routing.hiera_act
        self.head_dim = dim_out // num_heads
        hw = num_heads * self.head_dim
        hidden = int(dim_out * mlp_ratio)
        special = q_stride is not None or window_side == 0
        if q_stride is None and dim == dim_out and 0 < window_side ** 2 <= 512:
            self.route = "block"
        elif special and (not quant or routing.sam2_int8_special):
            fused = q_stride is not None and dim != dim_out and routing.qpool_fused
            self.route = "qpool" if fused else "split"
        else:
            self.route = "generic"
        unfused = self.route == "generic"
        dense = functools.partial(W8A8Linear, unfused=unfused) if quant else DenseParams
        self.norm1 = LayerNormParams(dim, dtype)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, window_side, q_stride, dtype,
                                        quant, unfused)
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

    def _generic(self, x: torch.Tensor) -> torch.Tensor:
        """The unfused block (the JAX ``MultiScaleBlock`` past its fused
        routes): flax LayerNorms in f32, dense layers, ``MultiScaleAttention``
        and the exact GELU."""
        ln = lambda norm, t: hb.layer_norm_flax(
            t, norm.scale, norm.bias, _EPS, torch.float32).to(self.dtype)
        shortcut = x
        xn = ln(self.norm1, x)
        if self.dim != self.dim_out:
            shortcut = self.proj(xn)
            if self.q_stride is not None:
                shortcut = hb.pool_window_tokens(shortcut, self.window_side, self.q_stride)
        x = shortcut + self.attn(xn)
        m = F.gelu(self.mlp_layers_0(ln(self.norm2, x)), approximate="none")
        return x + self.mlp_layers_1(m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, S, C]
        x = x.to(self.dtype)
        if self.route == "generic":
            return self._generic(x)
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
            return fn(x, params, heads, hd, act=self.act, eps=_EPS)
        if self.route == "qpool":
            fn = pick("qpool")
            return fn(x, params, heads, hd, self.q_stride, act=self.act, eps=_EPS)

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
        return tail(shortcut, o.reshape(n, -1, hw), params[n_front:], act=self.act, eps=_EPS)


@functools.lru_cache(maxsize=None)
def _bicubic(src: int, dst: int) -> np.ndarray:
    return bicubic_matrix(src, dst)


class Hiera(nn.Module):
    """Multi-stage trunk returning per-stage NHWC feature maps."""

    def __init__(self, cfg: SAM2HieraConfig, dtype: torch.dtype, quant: bool = False,
                 routing: Optional[VisionRouting] = None):
        super().__init__()
        routing = routing or VisionRouting()
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
                side if window_size > 0 else 0, dtype, quant, routing,
            ))
            if pool is not None:
                if side % pool[0] or side % pool[1] or grid % pool[0]:
                    raise ValueError(f"block {i}: q-stride {pool} does not divide window {side}")
                grid //= pool[0]
                side = max(side // pool[0], 1)
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)
        self.groups = self._stage_groups(routing.hiera_stage_nb)

    def _stage_groups(self, stage_nb: int) -> List[List[int]]:
        """The blocks of each call: a run of up to ``stage_nb`` consecutive
        float ``block``-route blocks of one shape (width, heads, window), or
        one block. A run never crosses a stage: the next stage opens with a
        q-pooling block, and a global block has no window."""
        shape = lambda b: (b.route, b.dim, b.dim_out, b.num_heads, b.window_side)
        groups, i = [], 0
        while i < len(self.blocks):
            run = [i]
            if not self.quant and self.blocks[i].route == "block":
                while (len(run) < stage_nb and run[-1] + 1 < len(self.blocks)
                       and shape(self.blocks[run[-1] + 1]) == shape(self.blocks[i])):
                    run.append(run[-1] + 1)
            groups.append(run)
            i = run[-1] + 1
        return groups

    def call_routes(self) -> List[str]:
        """What each call of a forward runs: ``stage`` for a run of blocks,
        else the block's route."""
        return ["stage" if len(g) > 1 else self.blocks[g[0]].route for g in self.groups]

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
        for group in self.groups:
            blk = self.blocks[group[0]]
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
            if len(group) > 1:
                fn = hb.fused_hiera_stage if blk.use_kernels else hb.fused_hiera_stage_plain
                tokens = fn(tokens.to(self.dtype),
                            [self.blocks[j]._kernel_params() for j in group],
                            blk.num_heads, blk.head_dim, act=blk.act, eps=_EPS)
            elif ws == 0:
                out = blk(tokens.reshape(b, h * w, -1))
                tokens = out.reshape(tokens.shape[0], side * side, -1)
            else:
                tokens = blk(tokens)
            if blk.q_stride is not None:
                sy, sx = blk.q_stride
                h, w = h // sy, w // sx
                side = max(side // sy, 1)
            if group[-1] in self.stage_ends:
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
