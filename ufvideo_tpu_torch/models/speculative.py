"""Prompt-lookup speculative greedy decoding (mirrors
``ufvideo_tpu/models/speculative.py``).

A decode step at batch 1 reads every weight for one token. Verifying K
drafted tokens in one forward reads them once for up to K + 1 tokens. The
drafts come from prompt lookup: the most recent earlier occurrence of the
history's last trigram (else its last bigram) proposes the K tokens that
followed it. The history is the prompt's text ids at their spliced
positions (``splicing.plan_lookup_ids``) followed by the generated tokens.

Exactness: acceptance keeps the longest prefix of drafts equal to the
verify forward's own greedy argmax, and position i of that forward attends
exactly the context sequential decode would (``qwen2`` ``verify`` mode), so
the emitted tokens are plain greedy decoding's. Greedy only, as in the JAX
package.

Each iteration embeds [cur, draft_0 .. draft_{K-1}], runs one ``verify``
forward against the cache (k/v written at each row's own positions),
accepts the matching prefix plus the model's next token, truncates at a
stop id and advances the row's write position. ``spec_generate`` loops to
the end; ``spec_stream_generate`` yields after every iteration.
``spec_slot_admit`` and ``spec_set_done`` are the continuous-batching
engine's hooks (``engine.py``): they reset one row of a persistent state for
a new request and retire rows the host decided are finished.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..utils import tracing
from .generate import GenerateResult, _mask_vocab_logits, prefill_cache
from .qwen2 import Qwen2LM, copy_cache_row, make_kv_cache


class SpecResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new] generated ids (0 after the end)
    gen_lens: torch.Tensor  # [B] generated tokens incl. the stop token
    hidden: torch.Tensor  # [B, max_new, hidden] hidden state behind each token
    n_iters: int  # forwards: the prefill and one a verify step
    n_drafted: torch.Tensor  # [B] draft tokens proposed
    n_accepted: torch.Tensor  # [B] draft tokens accepted

    def as_generate_result(self) -> GenerateResult:
        return GenerateResult(tokens=self.tokens, gen_lens=self.gen_lens, hidden=self.hidden)


class SpecState(NamedTuple):
    """The loop state. ``tokens``, ``hiddens``, ``hist`` and ``cache`` are
    updated in place; a row's entries below its ``gen_lens`` never change
    again."""
    it: int
    tokens: torch.Tensor  # [B, max_new]
    hiddens: torch.Tensor  # [B, max_new, hidden]
    cache: Dict[str, torch.Tensor]
    cache_len: torch.Tensor  # [B] next write position (cur's slot)
    cur: torch.Tensor  # [B] last emitted token, its k/v not yet written
    done: torch.Tensor  # [B] bool
    gen_lens: torch.Tensor  # [B]
    hist: torch.Tensor  # [B, S + max_new] lookup history (-1: no token)
    n_drafted: torch.Tensor  # [B]
    n_accepted: torch.Tensor  # [B]


def _check_cache(s: int, max_new_tokens: int, k: int, cache_max_len: int) -> int:
    """A verify block may write ``k`` positions past the last accepted
    token: the cache must hold ``s + max_new_tokens + k``. Returns the length
    rounded up to whole 128-position tiles."""
    if k < 1:
        raise ValueError(f"draft_k must be at least 1, got {k}")
    if cache_max_len < s + max_new_tokens + k:
        raise ValueError(f"cache_max_len {cache_max_len} < {s} + {max_new_tokens} + {k}")
    return -(-cache_max_len // 128) * 128


@torch.no_grad()
def spec_generate(
    model: Qwen2LM,
    input_embeds: torch.Tensor,  # [B, S, hidden] (post multimodal splice)
    seq_lens: torch.Tensor,  # [B] valid prompt lengths
    prompt_ids: torch.Tensor,  # [B, S] text ids for lookup, -1 at non-text slots
    *,
    max_new_tokens: int,
    stop_ids: Sequence[int],
    cache_max_len: int,
    draft_k: int = 4,
    vocab_size: Optional[int] = None,
    kv_quant: bool = False,
    prefill_chunk: int = 0,
) -> SpecResult:
    """Greedy generation with prompt-lookup speculation: ``greedy_generate``'s
    contract restricted to greedy, plus the speculation counters."""
    k = int(draft_k)
    s = input_embeds.shape[1]
    vocab_size = vocab_size or model.cfg.vocab_size
    cache_max_len = _check_cache(s, max_new_tokens, k, cache_max_len)
    state = _spec_init(model, input_embeds, seq_lens, prompt_ids,
                       cache_max_len=cache_max_len, max_new_tokens=max_new_tokens,
                       stop_ids=stop_ids, vocab_size=vocab_size, kv_quant=kv_quant,
                       prefill_chunk=prefill_chunk)
    while state.it < max_new_tokens and not _all_done(state):
        state = _spec_body(model, state, k=k, stop_ids=stop_ids, vocab_size=vocab_size,
                           max_new_tokens=max_new_tokens, prompt_len=s)
    return SpecResult(tokens=state.tokens, gen_lens=state.gen_lens, hidden=state.hiddens,
                      n_iters=state.it, n_drafted=state.n_drafted,
                      n_accepted=state.n_accepted)


def _all_done(state: SpecState) -> bool:
    with tracing.wait():
        return bool(state.done.all())


def _argmax_tokens(model: Qwen2LM, h: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """[B, T, hidden] → [B, T] greedy tokens."""
    logits = _mask_vocab_logits(model.logits(h).to(torch.float32), vocab_size)
    return logits.argmax(dim=-1)


def _spec_init(model, input_embeds, seq_lens, prompt_ids, *, cache_max_len, max_new_tokens,
               stop_ids, vocab_size, kv_quant, prefill_chunk) -> SpecState:
    """Prefill, the first token and the loop state."""
    b, s, hid = input_embeds.shape
    dev = input_embeds.device
    seq_lens = seq_lens.to(device=dev, dtype=torch.int32)
    cache = make_kv_cache(model.cfg, b, cache_max_len, dtype=model.dtype, device=dev,
                          quant=kv_quant)
    cache, last_hidden = prefill_cache(model, input_embeds, seq_lens, cache,
                                       prefill_chunk=prefill_chunk)
    t0 = _argmax_tokens(model, last_hidden[:, None], vocab_size)[:, 0]
    # history: [prompt text ids | generated], the generated part at the fixed
    # offset S; the -1 slots between a short prompt and S never match
    hist = torch.full((b, s + max_new_tokens), -1, dtype=torch.int64, device=dev)
    in_prompt = torch.arange(s, device=dev)[None, :] < seq_lens[:, None]
    hist[:, :s] = torch.where(in_prompt, prompt_ids.to(device=dev, dtype=torch.int64), -1)
    hist[:, s] = t0
    tokens = torch.zeros((b, max_new_tokens), dtype=torch.int64, device=dev)
    hiddens = torch.zeros((b, max_new_tokens, hid), dtype=model.dtype, device=dev)
    tokens[:, 0] = t0
    hiddens[:, 0] = last_hidden.to(model.dtype)
    stop_arr = torch.tensor(list(stop_ids), dtype=torch.int64, device=dev)
    zeros = torch.zeros((b,), dtype=torch.int64, device=dev)
    return SpecState(
        it=1, tokens=tokens, hiddens=hiddens, cache=cache, cache_len=seq_lens.to(torch.int64),
        cur=t0, done=torch.isin(t0, stop_arr), gen_lens=torch.ones_like(zeros), hist=hist,
        n_drafted=zeros, n_accepted=zeros.clone())


def _draft_tokens(hist: torch.Tensor, end: torch.Tensor, k: int) -> torch.Tensor:
    """[B, K] drafts: after the latest earlier match of the history's last
    trigram, else of its last bigram, with the K-token window inside the
    real history; without a match the last token repeated (free to verify,
    and right for runs of one token). ``end`` [B]: one past the last real
    history entry."""
    b, lh = hist.shape
    dev = hist.device
    at = lambda i: hist.gather(1, i[:, None])  # [B, 1]
    t3, t2, t1 = at((end - 3).clamp_min(0)), at(end - 2), at(end - 1)

    def last_match(n, ts):
        m = lh - n + 1
        cand = torch.ones((b, m), dtype=torch.bool, device=dev)
        for i, t in enumerate(ts):
            cand &= hist[:, i:m + i] == t
        jpos = torch.arange(m, device=dev)[None, :]
        valid = (cand & (jpos + n + k <= end[:, None])
                 & (jpos != (end - n)[:, None])  # not the history's own tail
                 & (ts[0] >= 0)  # real tokens, not a run of -1
                 & (end >= n)[:, None])
        last = (lh - n) - valid.flip(1).to(torch.uint8).argmax(dim=1)
        return valid.any(dim=1), last + n

    any3, start3 = last_match(3, (t3, t2, t1))
    any2, start2 = last_match(2, (t2, t1))
    start = torch.where(any3, start3, torch.where(any2, start2, torch.zeros_like(start2)))
    d = hist.gather(1, start[:, None] + torch.arange(k, device=dev)[None, :])
    return torch.where((any3 | any2)[:, None], d, t1)


def _spec_body(model, st: SpecState, *, k, stop_ids, vocab_size, max_new_tokens,
               prompt_len) -> SpecState:
    """One draft → verify → accept iteration."""
    s = prompt_len
    dev = st.cur.device
    kidx = torch.arange(k + 1, device=dev)[None, :]
    stop_arr = torch.tensor(list(stop_ids), dtype=torch.int64, device=dev)

    draft = _draft_tokens(st.hist, s + st.gen_lens, k)  # [B, K]
    block = torch.cat([st.cur[:, None], draft], dim=1)  # [B, K+1]
    h, cache = model.backbone(model.embed(block), st.cache_len[:, None] + kidx, None,
                              st.cache, st.cache_len, "verify")
    preds = _argmax_tokens(model, h, vocab_size)  # preds[:, i] follows block[:, :i+1]

    # the longest accepted draft prefix, then the model's own next token:
    # the emitted tokens are preds, which equal the drafts where accepted
    a = torch.cumprod((preds[:, :k] == draft).to(torch.int64), dim=1).sum(dim=1)  # [B] 0..K
    count = a + 1
    hit = torch.isin(preds, stop_arr) & (kidx < count[:, None])
    any_hit = hit.any(dim=1)
    count = torch.where(any_hit, hit.to(torch.uint8).argmax(dim=1) + 1, count)
    count = torch.where(st.done, torch.zeros_like(count),
                        torch.minimum(count, max_new_tokens - st.gen_lens))

    with tracing.wait():  # ``nonzero`` reads its count back
        rows, cols = (kidx < count[:, None]).nonzero(as_tuple=True)
    wpos = st.gen_lens[rows] + cols
    st.tokens[rows, wpos] = preds[rows, cols]
    st.hiddens[rows, wpos] = h[rows, cols].to(st.hiddens.dtype)
    st.hist[rows, s + wpos] = preds[rows, cols]

    # the cache holds [cur | accepted drafts]; the bonus token is the next
    # iteration's cur and gets its k/v written then
    used = (count - 1).clamp_min(0)
    adv = torch.where(st.done, torch.zeros_like(a), 1 + torch.minimum(a, used))
    new_cur = torch.where(count > 0, preds.gather(1, used[:, None])[:, 0], st.cur)
    live = (~st.done).to(torch.int64)
    return SpecState(
        it=st.it + 1, tokens=st.tokens, hiddens=st.hiddens, cache=cache,
        cache_len=st.cache_len + adv, cur=new_cur,
        done=st.done | any_hit | (st.gen_lens + count >= max_new_tokens),
        gen_lens=st.gen_lens + count, hist=st.hist, n_drafted=st.n_drafted + live * k,
        n_accepted=st.n_accepted + live * used)


@torch.no_grad()
def spec_stream_generate(
    model: Qwen2LM,
    input_embeds: torch.Tensor,
    seq_lens: torch.Tensor,
    prompt_ids: torch.Tensor,
    *,
    max_new_tokens: int,
    stop_ids: Sequence[int],
    cache_max_len: int,
    draft_k: int = 4,
    vocab_size: Optional[int] = None,
    kv_quant: bool = False,
    prefill_chunk: int = 0,
):
    """``spec_generate`` one iteration at a time: yields ``(tokens [B,
    max_new], gen_lens [B], hiddens, done [B])`` after the prefill and after
    each verify step; the new tokens of row b are ``tokens[b, prev:gen_lens[b]]``.
    The same stream as ``spec_generate``, token for token, 1 to K + 1 tokens
    a weight pass."""
    k = int(draft_k)
    s = input_embeds.shape[1]
    vocab_size = vocab_size or model.cfg.vocab_size
    cache_max_len = _check_cache(s, max_new_tokens, k, cache_max_len)
    stop_ids = tuple(stop_ids)
    state = _spec_init(model, input_embeds, seq_lens, prompt_ids,
                       cache_max_len=cache_max_len, max_new_tokens=max_new_tokens,
                       stop_ids=stop_ids, vocab_size=vocab_size, kv_quant=kv_quant,
                       prefill_chunk=prefill_chunk)
    yield state.tokens, state.gen_lens, state.hiddens, state.done
    while state.it < max_new_tokens and not _all_done(state):
        state = _spec_body(model, state, k=k, stop_ids=stop_ids, vocab_size=vocab_size,
                           max_new_tokens=max_new_tokens, prompt_len=s)
        yield state.tokens, state.gen_lens, state.hiddens, state.done


@torch.no_grad()
def spec_slot_admit(state: SpecState, slot: int, scratch_cache: Dict[str, torch.Tensor],
                    t0: int, seq_len: int, hist_row: torch.Tensor, src: int = 0) -> SpecState:
    """Reset row ``slot`` of a persistent loop state, in place, for a newly
    admitted request: row ``src`` of its prefilled scratch cache (which may
    hold several requests' rows, and fewer positions than the state's cache)
    goes into the slot's first positions on every cache leaf; the slot's
    tokens and hidden states are zeroed, its first token is ``t0``, its
    history is ``hist_row`` [S + max_new] with ``t0`` at offset S, it is
    live with one generated token and no drafts. ``it`` and every other row
    are left as they are: each per-row operation of ``_spec_body`` is
    row-independent. Returns the state with ``cache_len`` / ``cur`` /
    ``done`` / ``gen_lens`` / counters updated in place too."""
    copy_cache_row(state.cache, scratch_cache, slot, src)
    s = state.hist.shape[1] - state.tokens.shape[1]  # the prompt part's width
    state.tokens[slot] = 0
    state.tokens[slot, 0] = t0
    state.hiddens[slot] = 0
    state.hist[slot] = hist_row.to(device=state.hist.device, dtype=state.hist.dtype)
    state.hist[slot, s] = t0
    state.cache_len[slot] = seq_len
    state.cur[slot] = t0
    state.done[slot] = False
    state.gen_lens[slot] = 1
    state.n_drafted[slot] = 0
    state.n_accepted[slot] = 0
    return state


@torch.no_grad()
def spec_set_done(state: SpecState, mask) -> SpecState:
    """OR a host mask [B] into ``done``, in place (rows retired between steps
    by the budget or a stop string)."""
    state.done.logical_or_(torch.as_tensor(mask, dtype=torch.bool, device=state.done.device))
    return state
