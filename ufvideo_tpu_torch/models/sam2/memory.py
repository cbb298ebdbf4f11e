"""SAM2 memory subsystem (mirrors ``ufvideo_tpu/models/sam2/memory.py``):
memory attention with 2-D axial RoPE, and the memory encoder (mask
downsampler, ConvNeXt fuser). Spatial tensors are NHWC; token streams are
[B, N, C]. The memory bank has a fixed number of slots; empty slots and
pointers are masked out of the cross-attention by a per-token ``kv_mask``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...configs import SAM2Config
from ...ops.attention import attention
from ...ops.rope import apply_rope_interleaved, axial_rope_cos_sin
from .common import ChannelLayerNorm, ConvNHWC, LayerNorm32


class RoPEAttention(nn.Module):
    """Projection attention with 2-D axial RoPE on the spatial tokens. The
    trailing ``num_k_exclude_rope`` k tokens (object pointers) skip the
    rotation; with ``rope_k_repeat`` the q-grid table is tiled across k's
    stacked memory frames."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype, rope_k_repeat: bool = False,
                 kv_in_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.rope_k_repeat = rope_k_repeat
        c = cfg.mem_attn_dim
        kv_in = kv_in_dim or c
        self.q_proj = nn.Linear(c, c, dtype=dtype)
        self.k_proj = nn.Linear(kv_in, c, dtype=dtype)
        self.v_proj = nn.Linear(kv_in, c, dtype=dtype)
        self.out_proj = nn.Linear(c, c, dtype=dtype)
        self.use_kernels = True

    def forward(self, q, k, v, num_k_exclude_rope: int = 0,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        c, heads = cfg.mem_attn_dim, cfg.mem_attn_num_heads
        hd = c // heads
        b, nq, _ = q.shape
        nk = k.shape[1]
        qp = self.q_proj(q).reshape(b, nq, heads, hd)
        kp = self.k_proj(k).reshape(b, nk, heads, hd)
        vp = self.v_proj(v).reshape(b, nk, heads, hd)

        side = int(round(nq ** 0.5))
        if side * side != nq:
            raise ValueError(f"{nq} query tokens are not a square grid")
        cos, sin = axial_rope_cos_sin(hd, side, side, cfg.mem_attn_rope_theta, q.device)
        qp = apply_rope_interleaved(qp, cos[None, :, None, :], sin[None, :, None, :])

        num_k_rope = nk - num_k_exclude_rope
        if num_k_rope > 0:
            if num_k_rope != nq:
                if not self.rope_k_repeat or num_k_rope % nq:
                    raise ValueError(f"{num_k_rope} rotated keys for {nq} queries")
                reps = num_k_rope // nq
                cos, sin = cos.repeat(reps, 1), sin.repeat(reps, 1)
            k_rot = apply_rope_interleaved(
                kp[:, :num_k_rope], cos[None, :, None, :], sin[None, :, None, :]
            )
            kp = torch.cat([k_rot, kp[:, num_k_rope:]], dim=1)

        o = attention(qp, kp, vp, kv_mask=kv_mask, use_kernel=self.use_kernels)
        return self.out_proj(o.reshape(b, nq, c))


class MemoryAttentionLayer(nn.Module):
    """Self-attention (RoPE) → cross-attention to the memory (RoPE, narrower
    k / v input) → FFN, pre-LN."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype):
        super().__init__()
        c = cfg.mem_attn_dim
        self.dtype = dtype
        self.norm1 = LayerNorm32(c, 1e-5, dtype)
        self.self_attn = RoPEAttention(cfg, dtype)
        self.norm2 = LayerNorm32(c, 1e-5, dtype)
        self.cross_attn_image = RoPEAttention(
            cfg, dtype, rope_k_repeat=True, kv_in_dim=cfg.mem_attn_kv_in_dim
        )
        self.norm3 = LayerNorm32(c, 1e-5, dtype)
        self.linear1 = nn.Linear(c, cfg.mem_attn_dff, dtype=dtype)
        self.linear2 = nn.Linear(cfg.mem_attn_dff, c, dtype=dtype)

    def forward(self, tgt, memory, pos, query_pos, num_k_exclude_rope: int = 0,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2)
        t2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(
            t2, (memory + pos).to(self.dtype), memory.to(self.dtype),
            num_k_exclude_rope=num_k_exclude_rope, kv_mask=kv_mask,
        )
        t2 = self.norm3(tgt)
        return tgt + self.linear2(F.relu(self.linear1(t2)))


class MemoryAttention(nn.Module):
    """Memory attention layers with the 0.1-scaled input position encoding."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(cfg, dtype) for _ in range(cfg.mem_attn_layers)
        )
        self.norm = LayerNorm32(cfg.mem_attn_dim, 1e-5, dtype)

    def forward(self, curr, curr_pos, memory, memory_pos, num_obj_ptr_tokens: int = 0,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = curr + 0.1 * curr_pos
        for layer in self.layers:
            out = layer(out, memory, memory_pos, curr_pos,
                        num_k_exclude_rope=num_obj_ptr_tokens, kv_mask=kv_mask)
        return self.norm(out)


class MaskDownSampler(nn.Module):
    """Mask at image resolution → image-embedding resolution × C: four
    stride-2 convs (kernel 3, padding 1) each with LN + GELU, then a 1×1
    projection."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        chans = 1
        for i in range(4):
            setattr(self, f"encoder_{3 * i}",
                    ConvNHWC(chans, chans * 4, 3, stride=2, padding=1, dtype=dtype))
            setattr(self, f"encoder_{3 * i + 1}", ChannelLayerNorm(chans * 4, dtype))
            chans *= 4
        self.encoder_12 = nn.Linear(chans, cfg.sam_embed_dim, dtype=dtype)  # 1x1 conv

    def forward(self, masks: torch.Tensor) -> torch.Tensor:  # [B, H, W, 1]
        x = masks.to(self.dtype)
        for i in range(4):
            x = getattr(self, f"encoder_{3 * i}")(x)
            x = F.gelu(getattr(self, f"encoder_{3 * i + 1}")(x))
        return self.encoder_12(x)


class CXBlock(nn.Module):
    """ConvNeXt block with layer scale."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.dwconv = ConvNHWC(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = ChannelLayerNorm(dim, dtype)
        self.pwconv1 = nn.Linear(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = nn.Linear(4 * dim, dim, dtype=dtype)
        self.g_weight = nn.Parameter(torch.empty(dim, dtype=dtype))

    @torch.no_grad()
    def reset_own_parameters(self, gen: torch.Generator) -> None:
        self.g_weight.fill_(1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.dwconv(x.to(self.dtype)))
        h = self.pwconv2(F.gelu(self.pwconv1(h)))
        return x + self.g_weight.to(h.dtype) * h


class MemoryEncoder(nn.Module):
    """Fuse pixel features with the downsampled predicted mask into a
    mem_dim memory map."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        c = cfg.sam_embed_dim
        self.mask_downsampler = MaskDownSampler(cfg, dtype)
        self.pix_feat_proj = nn.Linear(c, c, dtype=dtype)  # 1x1 conv
        self.fuser_layers = nn.ModuleList(CXBlock(c, dtype) for _ in range(2))
        self.out_proj = nn.Linear(c, cfg.mem_dim, dtype=dtype)  # 1x1 conv

    def forward(self, pix_feat: torch.Tensor, masks: torch.Tensor,
                skip_mask_sigmoid: bool = False) -> torch.Tensor:
        """pix_feat [B, H, W, C]; masks [B, 16H, 16W, 1] → [B, H, W, mem_dim]."""
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        x = self.pix_feat_proj(pix_feat.to(self.dtype)) + self.mask_downsampler(masks)
        for blk in self.fuser_layers:
            x = blk(x)
        return self.out_proj(x)
