"""Percent of the traced window in which no operation ran on the device:
one less the union of the operations' intervals over the window."""

from benchmark.readers import idle

LAYER = "device"
MOVES = "gen_tok_s"


def read(w):
    return idle(w)
