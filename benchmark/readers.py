"""What the metric readers share: the work of the window's requests and a
family's share of its roofline. A reader returns None where the window holds
nothing to read (no device time of the family, no token), and the
harness then leaves the metric out of the line."""

from __future__ import annotations

from typing import Optional

from .reference.checkpoint import encode_layers
from .work import decode_attention, model_flops, peaks, quant_matvec

PERCENT = 100.0


def per_event_ms(w, seconds_key: str, count_key: str) -> Optional[float]:
    """Host milliseconds of one event: an engine time sum over its count,
    both as they moved over the window."""
    n = w.delta(count_key)
    return 1e3 * w.delta(seconds_key) / n if n > 0 else None


def roofline(w, symbols: str, bound_s: float) -> Optional[float]:
    """Percent: the least time the work needs over the device time of the
    family's operations in the traced window."""
    t = w.trace.device_seconds(symbols)
    return PERCENT * bound_s / t if t > 0 and bound_s > 0 else None


def idle(w) -> float:
    return PERCENT * (1.0 - w.trace.busy_s() / w.trace.window_s)


def decode_tokens(w):
    """(record, context) of every decode-step token of the window: token j
    of a reply (j >= 1; token 0 comes from the prefill) attends its prompt
    and the j tokens before it."""
    for rec, first, count in w.window_tokens():
        for j in range(max(first, 1), first + count):
            yield rec, rec.prompt_len + j


def decode_attention_bound(w) -> float:
    llm = w.model["llm"]
    nbytes = flops = 0
    for _, ctx in decode_tokens(w):
        b, f = decode_attention.step([ctx], llm["num_heads"], llm["num_kv_heads"],
                                     llm["head_dim"], bool(w.model["quant_kv"]))
        nbytes += b
        flops += f
    return llm["num_layers"] * peaks.bound_s(nbytes, flops)


def quant_matvec_bound(w) -> float:
    llm = w.model["llm"]
    vocab = -(-llm["vocab_size"] // 256) * 256
    steps, admissions = w.delta("decode_steps"), w.delta("admissions")
    head = quant_matvec.product(llm["hidden_size"], vocab)[0]
    return peaks.bound_s(steps * quant_matvec.step(llm, vocab)[0] + admissions * head)


def mfu(w) -> Optional[float]:
    m = w.model
    vision, llm = m["vision"], m["llm"]
    frames = m["budget"]["num_frames"]
    flops = 0.0
    for rec in w.admitted():
        flops += (model_flops.frames(frames, vision, encode_layers(vision))
                  + model_flops.connector(frames, vision, m["projector"])
                  + model_flops.prefill(rec.prompt_len, llm))
    flops += sum(model_flops.decode(ctx, llm) for _, ctx in decode_tokens(w))
    if not flops:
        return None
    return PERCENT * flops / (w.trace.window_s * peaks.PEAK_BF16_FLOPS)

