"""Percent of the decode batch's rows that made a token: the engine's
``decode_rows`` (each chunk's tokens, row by row) over ``max_slots`` times its
``decode_steps``, over the window. Slots free, reserved for an admission or
holding a request whose answer ended inside a chunk make no token."""

from benchmark.engine_layers import PERCENT, ratio

LAYER = "engine decode loop"
MOVES = "gen_tok_s"


def read(w):
    return ratio(w, "decode_rows", "decode_steps", PERCENT,
                 per=float(w.spec.cell["engine"]["max_slots"]))
