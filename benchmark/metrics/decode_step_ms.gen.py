"""Host milliseconds of one decode step of the engine's worker (the chunk
loop over every slot, its host syncs and the text deltas), its ``step_s``
over its ``decode_steps``, as both moved over the window."""

from benchmark.readers import per_event_ms

LAYER = "engine decode loop"
MOVES = "gen_tok_s"


def read(w):
    return per_event_ms(w, "step_s", "decode_steps")
