"""Host milliseconds of a decode step the worker spends issuing work: the
engine's ``launch_s`` (each ``_step`` less its host syncs and its emit: the
layers' launches, the inputs' copies to the card, the chunk's Python) over
its ``decode_steps``, both as they moved over the window."""

from benchmark.engine_layers import ratio

LAYER = "engine decode loop"
MOVES = "gen_tok_s"


def read(w):
    return ratio(w, "launch_s", "decode_steps", 1e3)
