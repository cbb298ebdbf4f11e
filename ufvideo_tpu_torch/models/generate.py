"""Greedy autoregressive generation with per-step hidden-state capture
(mirrors ``ufvideo_tpu/models/generate.py`` greedy_generate).

Prefill writes the whole prompt into a static-size KV cache; then a Python
loop runs single-token decode steps until every sequence has produced a
stop id (or a multi-token stop sequence) or ``max_new_tokens`` is reached.
The hidden state that produced each token is kept for post-hoc ``[SEG]``
extraction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .qwen2 import Qwen2LM, make_kv_cache


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new] generated ids (pad after stop)
    gen_lens: torch.Tensor  # [B] generated tokens incl. the stop token
    hidden: torch.Tensor  # [B, max_new, hidden] hidden state behind each token


def _mask_vocab_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mask out physical padding ids beyond the logical vocab."""
    if logits.shape[-1] == vocab_size:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
    return logits.masked_fill(~keep, torch.finfo(logits.dtype).min)


def _sample_token(
    logits: torch.Tensor,  # [B, V] float32
    generator: Optional[torch.Generator],
    do_sample: bool,
    temperature: float,
    top_p: float,
) -> torch.Tensor:
    """Greedy, or temperature / top-p sampling from ``generator``."""
    if not do_sample:
        return logits.argmax(dim=-1)
    logits = logits / max(temperature, 1e-6)
    if top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        # smallest set whose cumulative probability exceeds top_p
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def prefill_cache(
    model: Qwen2LM,
    input_embeds: torch.Tensor,  # [B, S, hidden]
    seq_lens: torch.Tensor,  # [B] valid prompt lengths
    cache,
):
    """Prefill the KV cache; returns (cache, hidden [B, hidden] at each
    sequence's last valid position, which produces token 0)."""
    b, s, _ = input_embeds.shape
    positions = torch.arange(s, device=input_embeds.device).expand(b, s)
    hidden, cache = model.backbone(input_embeds, positions, seq_lens, cache, None, "prefill")
    return cache, hidden[torch.arange(b, device=hidden.device), seq_lens.long() - 1]


@torch.no_grad()
def greedy_generate(
    model: Qwen2LM,
    input_embeds: torch.Tensor,  # [B, S, hidden] (post multimodal splice)
    seq_lens: torch.Tensor,  # [B] valid prompt lengths
    *,
    max_new_tokens: int,
    stop_ids: Sequence[int],
    cache_max_len: int,
    vocab_size: Optional[int] = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    stop_sequences: Tuple[Tuple[int, ...], ...] = (),
    kv_quant: bool = False,
) -> GenerateResult:
    """Prefill + decode loop. ``stop_sequences``: multi-token keyword stops,
    matched against the trailing generated ids. ``kv_quant``: keep the KV
    cache as int8 with per-position scales (``make_kv_cache(quant=True)``)."""
    cfg = model.cfg
    b, s, hid = input_embeds.shape
    dev = input_embeds.device
    vocab_size = vocab_size or cfg.vocab_size
    if cache_max_len < s + max_new_tokens:
        raise ValueError(f"cache_max_len {cache_max_len} < {s} + {max_new_tokens}")
    # whole 128-position tiles (the decode kernel's chunk); the tail is
    # never attended (length masking)
    cache_max_len = -(-cache_max_len // 128) * 128
    stop_ids = tuple(stop_ids) + tuple(seq[0] for seq in stop_sequences if len(seq) == 1)
    stop_sequences = tuple(seq for seq in stop_sequences if len(seq) > 1)
    stop_arr = torch.tensor(list(stop_ids), dtype=torch.int64, device=dev)
    seq_lens = seq_lens.to(device=dev, dtype=torch.int32)

    cache = make_kv_cache(
        cfg, b, cache_max_len, dtype=model.dtype, device=dev, quant=kv_quant)
    cache, last_hidden = prefill_cache(model, input_embeds, seq_lens, cache)

    def sample(h):  # [B, hidden] -> [B] next token
        logits = model.logits(h[:, None])[:, 0].to(torch.float32)
        logits = _mask_vocab_logits(logits, vocab_size)
        return _sample_token(logits, generator, do_sample, temperature, top_p)

    t0 = sample(last_hidden)
    tokens = torch.zeros((b, max_new_tokens), dtype=torch.int64, device=dev)
    hiddens = torch.zeros((b, max_new_tokens, hid), dtype=model.dtype, device=dev)
    tokens[:, 0] = t0
    hiddens[:, 0] = last_hidden.to(model.dtype)
    done = torch.isin(t0, stop_arr)
    gen_lens = torch.ones((b,), dtype=torch.int64, device=dev)
    cache_len = seq_lens.to(torch.int64)  # next write position
    cur = t0
    step = 1
    while step < max_new_tokens and not bool(done.all()):
        emb = model.embed(cur[:, None])
        h, cache = model.backbone(emb, cache_len[:, None], None, cache, cache_len, "decode")
        h = h[:, 0]
        nxt = sample(h)
        # finished sequences keep emitting pad; their cache_len stops moving
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_token_id), nxt)
        tokens[:, step] = torch.where(done, tokens[:, step], nxt)
        hiddens[:, step] = torch.where(done[:, None], hiddens[:, step], h.to(model.dtype))
        now_done = done | torch.isin(nxt, stop_arr)
        for seq in stop_sequences:
            k = len(seq)
            if step + 1 >= k:
                window = tokens[:, step - k + 1:step + 1]
                match = (window == torch.tensor(seq, device=dev)[None]).all(dim=1)
                now_done = now_done | (match & ~done)
        gen_lens = torch.where(done, gen_lens, torch.full_like(gen_lens, step + 1))
        cache_len = torch.where(done, cache_len, cache_len + 1)
        cur = nxt
        done = now_done
        step += 1
    return GenerateResult(tokens=tokens, gen_lens=gen_lens, hidden=hiddens)


@torch.no_grad()
def forward_hidden(
    model: Qwen2LM, input_embeds: torch.Tensor, seq_lens: torch.Tensor
) -> torch.Tensor:
    """One full forward returning final-layer hidden states [B, S, hidden]
    (the path for a ``[SEG]`` that is already in the input)."""
    b, s, _ = input_embeds.shape
    positions = torch.arange(s, device=input_embeds.device).expand(b, s)
    seq_lens = seq_lens.to(device=input_embeds.device, dtype=torch.int32)
    hidden, _ = model.backbone(input_embeds, positions, seq_lens, None, None, "train")
    return hidden
