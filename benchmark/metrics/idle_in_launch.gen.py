"""Percent of the traced window in which no operation runs on the device
while the decode worker is inside a ``launch`` span: the card waiting for
the worker to issue work (the complement of the merged operation intervals,
intersected with the worker's launch spans)."""

from benchmark.engine_layers import idle_in_launch

LAYER = "device"
MOVES = "gen_tok_s"


def read(w):
    return idle_in_launch(w)
