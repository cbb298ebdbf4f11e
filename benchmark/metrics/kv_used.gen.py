"""Percent of the engine's KV cache that holds live positions: the live
slots' cache lengths summed over the decode steps (``kv_live_pos_steps``)
over every slot's positions summed over them (``kv_reserved_pos_steps``),
over the window."""

from benchmark.engine_layers import PERCENT, ratio

LAYER = "engine decode loop"
MOVES = "gen_tok_s"


def read(w):
    return ratio(w, "kv_live_pos_steps", "kv_reserved_pos_steps", PERCENT)
