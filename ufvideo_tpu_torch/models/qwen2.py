"""Qwen2 language model (mirrors ``ufvideo_tpu/models/qwen2.py``).

Layers are an ``nn.ModuleList`` walked by a Python loop; the KV cache is
one [L, B, Hkv, S, D] tensor per k and v, updated in place. Three modes:

  - ``prefill``: causal forward over the prompt that writes k/v into the
    cache (attention: ``ops.flash_attention``).
  - ``decode``: one token per sequence against the cache, written at
    ``cache_len`` (attention: ``ops.ragged_decode_attention``).

  - ``train``: one causal forward over the whole sequence with no cache
    (attention: ``ops.flash_attention`` with ``kv_lens``): the single
    forward behind ``[SEG]`` hidden states when ``[SEG]`` is in the input.

The ``verify`` mode, quantised layers, ring attention and LoRA come with
later slices (ROADMAP.md). The vocabulary is padded to a
multiple of 256; logits of padding ids are masked at sampling time.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Qwen2Config
from ..ops.attention import attention, decode_attention
from ..ops.rope import apply_rope, rope_cos_sin
from . import init


class RMSNorm(nn.Module):
    """HF-Qwen2-ordered RMSNorm: float32 normalize, cast, then scale."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return xf.to(self.dtype) * self.weight.to(self.dtype)


def make_kv_cache(
    cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.bfloat16, device=None
) -> Dict[str, torch.Tensor]:
    """KV cache in [L, B, Hkv, S, D] layout; layer l's [B, Hkv, S, D] slice
    is what the decode kernel reads."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2Config, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        nq = cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        lin = lambda i, o, bias: nn.Linear(i, o, bias=bias, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        # fused [q | k | v] projection (one weight stream per decode step)
        self.qkv_proj = lin(cfg.hidden_size, nq + 2 * nkv, True)
        self.o_proj = lin(nq, cfg.hidden_size, False)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.gate_proj = lin(cfg.hidden_size, cfg.intermediate_size, False)
        self.up_proj = lin(cfg.hidden_size, cfg.intermediate_size, False)
        self.down_proj = lin(cfg.intermediate_size, cfg.hidden_size, False)
        self.use_kernels = True

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in (self.qkv_proj, self.o_proj, self.gate_proj, self.up_proj, self.down_proj):
            init.linear_(m, gen)
        init.norm_(self.input_layernorm)
        init.norm_(self.post_attention_layernorm)

    def forward(
        self,
        x: torch.Tensor,  # [B, S, hidden]
        cos: torch.Tensor,
        sin: torch.Tensor,
        seq_lens: torch.Tensor,  # [B]
        cache_len: torch.Tensor,  # [B]
        k_cache: Optional[torch.Tensor],  # [B, Hkv, Smax, D], updated in place
        v_cache: Optional[torch.Tensor],
        mode: str,
    ) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        nq = cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        h = self.input_layernorm(x)
        qkv = self.qkv_proj(h)
        q = qkv[..., :nq].reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = qkv[..., nq:nq + nkv].reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = qkv[..., nq + nkv:].reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if mode in ("prefill", "train"):
            if mode == "prefill":
                k_cache[:, :, :s] = k.transpose(1, 2).to(k_cache.dtype)
                v_cache[:, :, :s] = v.transpose(1, 2).to(v_cache.dtype)
            o = attention(
                q, k, v, causal=True, kv_lens=seq_lens, use_kernel=self.use_kernels
            )
        elif mode == "decode":
            bidx = torch.arange(b, device=x.device)
            cache_len = cache_len.long()
            k_cache[bidx, :, cache_len] = k[:, 0].to(k_cache.dtype)
            v_cache[bidx, :, cache_len] = v[:, 0].to(v_cache.dtype)
            o = decode_attention(
                q, k_cache, v_cache, cache_len + 1, use_kernel=self.use_kernels
            )
        else:
            raise ValueError(f"unsupported mode {mode!r}")

        x = x + self.o_proj(o.reshape(b, s, nq))
        h = self.post_attention_layernorm(x)
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class Qwen2LM(nn.Module):
    """Backbone + lm_head. ``embed`` / ``backbone`` / ``logits`` are called
    separately so multimodal embeddings can be spliced between embed and
    backbone."""

    def __init__(self, cfg: Qwen2Config, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.padded_vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(
            Qwen2DecoderLayer(cfg, dtype) for _ in range(cfg.num_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.padded_vocab_size, bias=False, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # nn.Embed's default: normal with std 1/sqrt(features)
        init.normal_(self.embed_tokens.weight, self.cfg.hidden_size ** -0.5, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)
        init.norm_(self.norm)
        init.linear_(self.lm_head, gen)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids.clamp_min(0))

    def backbone(
        self,
        input_embeds: torch.Tensor,  # [B, S, hidden]
        positions: torch.Tensor,  # [B, S]
        seq_lens: Optional[torch.Tensor],  # [B] valid lengths
        cache: Optional[Dict[str, torch.Tensor]],  # None in train mode
        cache_len: Optional[torch.Tensor],  # [B] write position (decode)
        mode: str,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Final hidden states [B, S, hidden]; ``cache`` is updated in place
        and returned."""
        b, s, _ = input_embeds.shape
        dev = input_embeds.device
        if seq_lens is None:
            seq_lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        if cache_len is None:
            cache_len = torch.zeros((b,), dtype=torch.int64, device=dev)
        cos, sin = rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        x = input_embeds.to(self.dtype)
        for i, layer in enumerate(self.layers):
            kc, vc = (cache["k"][i], cache["v"][i]) if cache is not None else (None, None)
            x = layer(x, cos, sin, seq_lens, cache_len, kc, vc, mode)
        return self.norm(x), cache

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.lm_head(hidden)
