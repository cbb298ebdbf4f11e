"""Host milliseconds of a decode step the worker spends emitting: the
engine's ``emit_s`` (the slots' text deltas, stop rules and retirements,
which wake the streaming clients) over its ``decode_steps``, both as they
moved over the window."""

from benchmark.engine_layers import ratio

LAYER = "engine decode loop"
MOVES = "gen_tok_s"


def read(w):
    return ratio(w, "emit_s", "decode_steps", 1e3)
