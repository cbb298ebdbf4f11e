"""Autoregressive generation with per-step hidden-state capture (mirrors
``ufvideo_tpu/models/generate.py``).

Prefill writes the whole prompt into a static-size KV cache (all sequences
at once, or ``prefill_chunk`` at a time); then a Python loop runs
single-token decode steps until every sequence has produced a stop id (or a
multi-token stop sequence) or ``max_new_tokens`` is reached. The hidden
state that produced each token is kept for post-hoc ``[SEG]`` extraction.

``greedy_generate`` runs the whole loop in one call; ``prefill_start`` +
``decode_chunk`` split it for streaming (``stream_generate`` surfaces the
tokens every ``chunk`` steps), token for token the same.
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
    *,
    prefill_chunk: int = 0,
):
    """Prefill the KV cache; returns (cache, hidden [B, hidden] at each
    sequence's last valid position, which produces token 0).

    ``prefill_chunk`` c with 0 < c < B runs c sequences at a time, so the
    prefill's transients (an MLP activation is [c·S, intermediate]) are
    those of c sequences, not B. Each chunk writes through a view of its
    rows of the cache. c need not divide B: the last chunk's start clamps to
    B - c, and its recomputed rows rewrite equal values (the JAX package's
    ``dynamic_slice`` semantics)."""
    b, s, hid = input_embeds.shape
    positions = torch.arange(s, device=input_embeds.device).expand(b, s)
    c = prefill_chunk if 0 < prefill_chunk < b else 0
    if not c:
        hidden, cache = model.backbone(input_embeds, positions, seq_lens, cache, None, "prefill")
        return cache, hidden[torch.arange(b, device=hidden.device), seq_lens.long() - 1]
    lasts = torch.zeros((b, hid), dtype=model.dtype, device=input_embeds.device)
    rows = torch.arange(c, device=input_embeds.device)
    for i in range(-(-b // c)):
        off = min(i * c, b - c)
        len_c = seq_lens[off:off + c]
        view = {name: t[:, off:off + c] for name, t in cache.items()}
        hid_c, _ = model.backbone(input_embeds[off:off + c], positions[:c], len_c, view, None,
                                  "prefill")
        lasts[off:off + c] = hid_c[rows, len_c.long() - 1].to(model.dtype)
    return cache, lasts


def _sampler(model: Qwen2LM, vocab_size: int, generator, do_sample: bool,
             temperature: float, top_p: float):
    """[B, hidden] → [B] next token, drawing from ``generator`` once a call
    when sampling."""
    def sample(h):
        logits = model.logits(h[:, None])[:, 0].to(torch.float32)
        logits = _mask_vocab_logits(logits, vocab_size)
        return _sample_token(logits, generator, do_sample, temperature, top_p)

    return sample


def _decode_step(model: Qwen2LM, cur: torch.Tensor, cache, cache_len: torch.Tensor):
    """One decode step: ``cur`` [B] written at ``cache_len`` → the hidden
    state [B, hidden] that produces the next token."""
    emb = model.embed(cur[:, None])
    h, cache = model.backbone(emb, cache_len[:, None], None, cache, cache_len, "decode")
    return h[:, 0]


@torch.no_grad()
def prefill_start(
    model: Qwen2LM,
    input_embeds: torch.Tensor,  # [B, S, hidden]
    seq_lens: torch.Tensor,  # [B]
    *,
    cache_max_len: int,
    vocab_size: Optional[int] = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    kv_quant: bool = False,
    prefill_chunk: int = 0,
):
    """Prefill and the first token: ``(cache, t0 [B], last_hidden [B,
    hidden])``. Feed ``decode_chunk`` with ``cache_len = seq_lens`` and ``cur =
    t0``. The cache holds whole 128-position tiles (the decode kernel's
    chunk); the tail is never attended."""
    cfg = model.cfg
    b = input_embeds.shape[0]
    dev = input_embeds.device
    vocab_size = vocab_size or cfg.vocab_size
    cache_max_len = -(-cache_max_len // 128) * 128
    seq_lens = seq_lens.to(device=dev, dtype=torch.int32)
    cache = make_kv_cache(cfg, b, cache_max_len, dtype=model.dtype, device=dev, quant=kv_quant)
    cache, last_hidden = prefill_cache(model, input_embeds, seq_lens, cache,
                                       prefill_chunk=prefill_chunk)
    sample = _sampler(model, vocab_size, generator, do_sample, temperature, top_p)
    return cache, sample(last_hidden), last_hidden


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
    prefill_chunk: int = 0,
) -> GenerateResult:
    """Prefill + decode loop. ``stop_sequences``: multi-token keyword stops,
    matched against the trailing generated ids. ``kv_quant``: keep the KV
    cache as int8 with per-position scales (``make_kv_cache(quant=True)``).
    ``prefill_chunk``: prefill that many sequences at a time
    (``prefill_cache``)."""
    cfg = model.cfg
    b, s, hid = input_embeds.shape
    dev = input_embeds.device
    vocab_size = vocab_size or cfg.vocab_size
    if cache_max_len < s + max_new_tokens:
        raise ValueError(f"cache_max_len {cache_max_len} < {s} + {max_new_tokens}")
    stop_ids = tuple(stop_ids) + tuple(seq[0] for seq in stop_sequences if len(seq) == 1)
    stop_sequences = tuple(seq for seq in stop_sequences if len(seq) > 1)
    stop_arr = torch.tensor(list(stop_ids), dtype=torch.int64, device=dev)
    seq_lens = seq_lens.to(device=dev, dtype=torch.int32)

    cache, t0, last_hidden = prefill_start(
        model, input_embeds, seq_lens, cache_max_len=cache_max_len, vocab_size=vocab_size,
        do_sample=do_sample, temperature=temperature, top_p=top_p, generator=generator,
        kv_quant=kv_quant, prefill_chunk=prefill_chunk)
    sample = _sampler(model, vocab_size, generator, do_sample, temperature, top_p)
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
        h = _decode_step(model, cur, cache, cache_len)
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
def decode_chunk(
    model: Qwen2LM,
    cache,
    cache_len: torch.Tensor,  # [B] next write position (cur's slot)
    cur: torch.Tensor,  # [B] last emitted token, its k/v not yet written
    done: torch.Tensor,  # [B] bool
    *,
    chunk: int,
    stop_ids: Sequence[int],
    vocab_size: Optional[int] = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
):
    """Up to ``chunk`` decode steps from any loop state, ending early when
    every row is done: ``(tokens [B, chunk], n [B], hiddens [B, chunk,
    hidden], cache, cache_len, cur, done)``; row b's new tokens are
    ``tokens[b, :n[b]]``. Rows already done do not move. Single-token
    ``stop_ids`` only: a multi-token stop is the streaming host's decision
    between chunks. Each step draws from ``generator`` as the fused loop's
    step does, so a stream equals ``greedy_generate`` under one seed."""
    cfg = model.cfg
    b = cur.shape[0]
    dev = cur.device
    sample = _sampler(model, vocab_size or cfg.vocab_size, generator, do_sample,
                      temperature, top_p)
    stop_arr = torch.tensor(list(stop_ids), dtype=torch.int64, device=dev)
    tokens = torch.zeros((b, chunk), dtype=torch.int64, device=dev)
    hiddens = torch.zeros((b, chunk, cfg.hidden_size), dtype=model.dtype, device=dev)
    n = torch.zeros((b,), dtype=torch.int64, device=dev)
    cache_len = cache_len.to(torch.int64)
    for step in range(chunk):
        if bool(done.all()):
            break
        h = _decode_step(model, cur, cache, cache_len)
        nxt = sample(h)
        tokens[:, step] = torch.where(done, tokens[:, step], nxt)
        hiddens[:, step] = torch.where(done[:, None], hiddens[:, step], h.to(model.dtype))
        now_done = done | torch.isin(nxt, stop_arr)
        n = torch.where(done, n, torch.full_like(n, step + 1))
        cache_len = torch.where(done, cache_len, cache_len + 1)
        cur = torch.where(done, cur, nxt)
        done = now_done
    return tokens, n, hiddens, cache, cache_len, cur, done


def stream_generate(
    model: Qwen2LM,
    input_embeds: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    max_new_tokens: int,
    stop_ids: Sequence[int],
    cache_max_len: int,
    chunk: int = 16,
    vocab_size: Optional[int] = None,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    kv_quant: bool = False,
    prefill_chunk: int = 0,
):
    """Host generator over ``prefill_start`` and ``decode_chunk``: yields
    ``(tokens [B, c], n [B], hiddens [B, c, hidden], done [B])``, row b's new
    tokens being ``tokens[b, :n[b]]`` (the first yield is the prefill's
    token). Token for token ``greedy_generate`` under the same generator
    (the steps draw in the same order); see ``decode_chunk`` for the stop
    contract."""
    stop_ids = tuple(stop_ids)
    b = input_embeds.shape[0]
    dev = input_embeds.device
    cache, t0, last_hidden = prefill_start(
        model, input_embeds, seq_lens, cache_max_len=cache_max_len, vocab_size=vocab_size,
        do_sample=do_sample, temperature=temperature, top_p=top_p, generator=generator,
        kv_quant=kv_quant, prefill_chunk=prefill_chunk)
    done = torch.isin(t0, torch.tensor(list(stop_ids), dtype=torch.int64, device=dev))
    yield (t0[:, None], torch.ones((b,), dtype=torch.int64, device=dev),
           last_hidden[:, None].to(model.dtype), done)
    cache_len = seq_lens.to(device=dev, dtype=torch.int64)
    cur = t0
    emitted = 1
    while emitted < max_new_tokens and not bool(done.all()):
        step = min(chunk, max_new_tokens - emitted)
        tokens, n, hiddens, cache, cache_len, cur, done = decode_chunk(
            model, cache, cache_len, cur, done, chunk=step, stop_ids=stop_ids,
            vocab_size=vocab_size, do_sample=do_sample, temperature=temperature,
            top_p=top_p, generator=generator)
        emitted += step
        yield tokens, n, hiddens, done


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
