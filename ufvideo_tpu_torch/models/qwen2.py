"""Qwen2 language model (mirrors ``ufvideo_tpu/models/qwen2.py``).

Layers are an ``nn.ModuleList`` walked by a Python loop; the KV cache is
one [L, B, Hkv, S, D] tensor per k and v, updated in place (bf16, or int8
with f32 per-position scales [L, B, Hkv, S]). Four modes:

  - ``prefill``: causal forward over the prompt that writes k/v into the
    cache (attention: ``ops.flash_attention`` on the unquantised k/v).
  - ``decode``: one token per sequence against the cache, written at
    ``cache_len`` (attention: ``ops.ragged_decode_attention``, or
    ``ops.ragged_decode_attention_q8`` on an int8 cache).
  - ``verify``: a few drafted tokens per sequence written at ``cache_len +
    i`` and attended with a ragged causal mask over the whole cache (the
    plain masked attention, as in the JAX layer; an int8 cache is
    dequantised to the model dtype for it): speculative decoding.
  - ``train``: one causal forward over the whole sequence with no cache
    (attention: ``ops.flash_attention`` with ``kv_lens``): the single
    forward behind ``[SEG]`` hidden states when ``[SEG]`` is in the input.

With ``quant`` the projections and ``lm_head`` are ``QuantLinear``: int8
weight-only with per-column scales, or packed int4 with group scales. Up to
32 rows on the card go to the hand-written ``ops.int8_matvec`` /
``ops.int4_matmul``; more rows (prefill, ``train``) dequantise the kernel to
a transient and run one ``torch.matmul``. The route is fixed by the tensor's
device and row count, not read from the environment.

Ring attention and LoRA come with later slices (ROADMAP.md). The vocabulary
is padded to a multiple of 256; logits of padding ids are masked at sampling
time.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Qwen2Config
from ..ops.attention import attention, decode_attention, xla_attention
from ..ops.quant_matmul import (
    MAX_ROWS, dequantize_int4, int4_matmul, int4_matmul_plain, int8_matvec,
    int8_matvec_plain)
from ..ops.rope import apply_rope, rope_cos_sin
from ..quant import quant_bits, quantize_kernel, quantize_kernel4
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
    cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
    quant: bool = False,
) -> Dict[str, torch.Tensor]:
    """KV cache in [L, B, Hkv, S, D] layout; layer l's [B, Hkv, S, D] slice
    is what the decode kernel reads. ``quant=True`` stores int8 values with
    f32 per-(position, head) scales [L, B, Hkv, S]: half the bytes of bf16;
    the scales fold into the decode kernel's scores and probabilities, so
    no dequantised copy of the cache exists."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    zeros = lambda sh, dt: torch.zeros(sh, dtype=dt, device=device)
    if not quant:
        return {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}
    return {
        "k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
        "k_scale": zeros(shape[:-1], torch.float32),
        "v_scale": zeros(shape[:-1], torch.float32),
    }


def copy_cache_row(cache: Dict[str, torch.Tensor], scratch: Dict[str, torch.Tensor],
                   slot: int, src: int = 0) -> None:
    """Write row ``src`` of a scratch cache into row ``slot`` of ``cache``,
    in place, over the scratch's positions (a scratch may be shorter and
    hold several rows), on every leaf: ``k`` / ``v`` [L, B, Hkv, S, D] and,
    on the int8 cache, ``k_scale`` / ``v_scale`` [L, B, Hkv, S]."""
    for name, c in cache.items():
        p = scratch[name]
        c[:, slot, :, :p.shape[3]].copy_(p[:, src])


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position symmetric int8: x [..., D] → (int8 values, f32 scales
    [...]); the 1e-12 floor sits inside the division and nothing clips."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(xf / scale.clamp_min(1e-12)).to(torch.int8)
    return q, scale[..., 0]


def _dot_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[rows, in] @ [in, out] with f32 accumulation and an f32 result."""
    if x2.device.type == "cuda" and x2.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x2, w, out_dtype=torch.float32)
    return x2.float() @ w.float()


class QuantLinear(nn.Module):
    """Dense layer on weight-only quantised weights (mirrors the JAX
    ``QuantDense``), kept in the JAX [in, out] layout.

    ``bits=8``: ``kernel_q`` int8 [in, out], ``kernel_scale`` f32 [out]; the
    scale applies to the f32 product. ``bits=4``: ``kernel_q`` packed int8
    [in/2, out] (``quant.pack_int4``), ``kernel_scale`` f32 [in/group, out].
    Both routes take bf16 operands, accumulate in f32 and cast once."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype: torch.dtype, bits: int = 8, group: int = 64):
        super().__init__()
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        if bits == 4 and in_features % group:
            raise ValueError(f"in_features {in_features} is not a multiple of group {group}")
        self.in_features, self.out_features = in_features, out_features
        self.dtype, self.bits, self.group = dtype, bits, group
        frozen = lambda shape, dt: nn.Parameter(torch.empty(shape, dtype=dt), requires_grad=False)
        if bits == 8:
            self.kernel_q = frozen((in_features, out_features), torch.int8)
            self.kernel_scale = frozen((out_features,), torch.float32)
        else:
            self.kernel_q = frozen((in_features // 2, out_features), torch.int8)
            self.kernel_scale = frozen((in_features // group, out_features), torch.float32)
        self.bias = frozen((out_features,), dtype) if bias else None
        self.use_kernels = True

    @torch.no_grad()
    def set_kernel(self, kernel: torch.Tensor) -> None:
        """Quantise a float [in, out] kernel into this layer."""
        qd = quantize_kernel(kernel) if self.bits == 8 else quantize_kernel4(kernel, self.group)
        self.kernel_q.copy_(qd["q"])
        self.kernel_scale.copy_(qd["scale"])

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The float layer's draw (same generator use as ``init.linear_`` on
        an ``nn.Linear``), rounded to the model's dtype, then quantised; the
        float copy is freed on return."""
        dev = self.kernel_q.device
        w = torch.empty((self.out_features, self.in_features), dtype=self.dtype, device=dev)
        init.lecun_normal_(w, self.in_features, gen)
        self.set_kernel(w.t())
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        din, dout = self.in_features, self.out_features
        x2 = x.reshape(-1, din)
        q, s = self.kernel_q, self.kernel_scale
        if x.device.type == "cuda" and x2.shape[0] <= MAX_ROWS:
            # decode-shaped: the weights are streamed once, dequantised in
            # registers (the plain version only on request, for comparison)
            if self.bits == 8:
                y = (int8_matvec if self.use_kernels else int8_matvec_plain)(x2, q, s)
            else:
                y = (int4_matmul if self.use_kernels else int4_matmul_plain)(x2, q, s, self.group)
            y = y.to(self.dtype)
        elif self.bits == 8:
            y = (_dot_f32(x2.to(self.dtype), q.to(self.dtype)) * s).to(self.dtype)
        else:
            w = dequantize_int4(q, s, self.group, self.dtype)
            y = _dot_f32(x2.to(self.dtype), w).to(self.dtype)
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*x.shape[:-1], dout)


def _linear(i: int, o: int, bias: bool, dtype: torch.dtype, quant) -> nn.Module:
    if quant:
        return QuantLinear(i, o, bias, dtype, bits=quant_bits(quant))
    return nn.Linear(i, o, bias=bias, dtype=dtype)


def _reset_linear(m: nn.Module, gen: torch.Generator) -> None:
    if isinstance(m, QuantLinear):
        m.reset_parameters(gen)
    else:
        init.linear_(m, gen)


class Qwen2DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2Config, dtype: torch.dtype, quant=False):
        super().__init__()
        self.cfg = cfg
        nq = cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        lin = lambda i, o, bias: _linear(i, o, bias, dtype, quant)
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
            _reset_linear(m, gen)
        init.norm_(self.input_layernorm)
        init.norm_(self.post_attention_layernorm)

    def forward(
        self,
        x: torch.Tensor,  # [B, S, hidden]
        cos: torch.Tensor,
        sin: torch.Tensor,
        seq_lens: torch.Tensor,  # [B]
        cache_len: torch.Tensor,  # [B]
        cache: Optional[Dict[str, torch.Tensor]],  # this layer's k / v [B, Hkv, Smax, D]
        #   (+ k_scale / v_scale [B, Hkv, Smax] when int8), updated in place
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
            if mode == "prefill" and "k_scale" in cache:  # int8 KV cache
                for name, val in (("k", k), ("v", v)):
                    vq, vs = quantize_kv(val.transpose(1, 2))
                    cache[name][:, :, :s] = vq
                    cache[name + "_scale"][:, :, :s] = vs
            elif mode == "prefill":
                cache["k"][:, :, :s] = k.transpose(1, 2).to(cache["k"].dtype)
                cache["v"][:, :, :s] = v.transpose(1, 2).to(cache["v"].dtype)
            o = attention(
                q, k, v, causal=True, kv_lens=seq_lens, use_kernel=self.use_kernels
            )
        elif mode == "verify":
            # speculative verification (models/speculative.py): the s
            # drafted tokens' k/v go in place at cache_len + i, and query i
            # sees the cache up to cache_len + i, the context sequential
            # decode would give it. Rejected drafts leave entries past the
            # advanced cache_len, never attended and later overwritten. As in
            # the JAX layer (ufvideo_tpu/models/qwen2.py:357-364, impl="xla"),
            # this attention is the plain masked one, not a kernel: s <= ~9
            # queries over the cache cost little beside the weights the
            # step reads once for up to s tokens.
            cache_len = cache_len.long()
            pidx = cache_len[:, None] + torch.arange(s, device=x.device)  # [B, s]
            bidx = torch.arange(b, device=x.device)[:, None]
            if "k_scale" in cache:  # int8 KV cache
                deq = []
                for name, val in (("k", k), ("v", v)):
                    vq, vs = quantize_kv(val)  # [B, s, Hkv, D], [B, s, Hkv]
                    cache[name][bidx, :, pidx] = vq
                    cache[name + "_scale"][bidx, :, pidx] = vs
                    deq.append((cache[name].to(torch.float32)
                                * cache[name + "_scale"][..., None]).to(x.dtype))
                kc, vc = deq
            else:
                cache["k"][bidx, :, pidx] = k.to(cache["k"].dtype)
                cache["v"][bidx, :, pidx] = v.to(cache["v"].dtype)
                kc, vc = cache["k"], cache["v"]
            smax = kc.shape[2]
            vmask = torch.arange(smax, device=x.device)[None, None, :] <= pidx[..., None]
            o = xla_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), mask=vmask)
        elif mode == "decode":
            bidx = torch.arange(b, device=x.device)
            cache_len = cache_len.long()
            if "k_scale" in cache:  # int8 KV cache
                for name, val in (("k", k), ("v", v)):
                    vq, vs = quantize_kv(val[:, 0])  # [B, Hkv, D] step values
                    cache[name][bidx, :, cache_len] = vq
                    cache[name + "_scale"][bidx, :, cache_len] = vs
            else:
                cache["k"][bidx, :, cache_len] = k[:, 0].to(cache["k"].dtype)
                cache["v"][bidx, :, cache_len] = v[:, 0].to(cache["v"].dtype)
            o = decode_attention(
                q, cache["k"], cache["v"], cache_len + 1,
                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                use_kernel=self.use_kernels,
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

    def __init__(self, cfg: Qwen2Config, dtype: torch.dtype = torch.bfloat16, quant=False):
        """``quant``: False | True / 'int8' | 'int4' (weight-only)."""
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.quant = quant
        self.embed_tokens = nn.Embedding(cfg.padded_vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(
            Qwen2DecoderLayer(cfg, dtype, quant) for _ in range(cfg.num_layers)
        )
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.lm_head = _linear(cfg.hidden_size, cfg.padded_vocab_size, False, dtype, quant)

    def reset_parameters(self, gen: torch.Generator) -> None:
        # nn.Embed's default: normal with std 1/sqrt(features)
        init.normal_(self.embed_tokens.weight, self.cfg.hidden_size ** -0.5, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)
        init.norm_(self.norm)
        _reset_linear(self.lm_head, gen)

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
            cl = {n: t[i] for n, t in cache.items()} if cache is not None else None
            x = layer(x, cos, sin, seq_lens, cache_len, cl, mode)
        return self.norm(x), cache

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.lm_head(hidden)
