"""Host milliseconds of a decode step the worker spends waiting on the card:
the engine's ``wait_s`` (each ``bool(done.all())`` of ``decode_chunk`` and the
chunk's readbacks) over its ``decode_steps``, both as they moved over the
window."""

from benchmark.engine_layers import ratio

LAYER = "engine decode loop"
MOVES = "gen_tok_s"


def read(w):
    return ratio(w, "wait_s", "decode_steps", 1e3)
