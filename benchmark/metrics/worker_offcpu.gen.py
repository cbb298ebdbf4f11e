"""Percent of its launch time the decode worker spends off a core: one less
its thread CPU seconds inside ``launch`` (``launch_cpu_s``) over the host
seconds of ``launch`` (``launch_s``), over the window. Time off a core while
issuing work is time waiting for the interpreter lock or the OS scheduler."""

from benchmark.engine_layers import PERCENT, deltas

LAYER = "engine decode loop"
MOVES = "gen_tok_s"


def read(w):
    d = deltas(w, "launch_cpu_s", "launch_s")
    if d is None or d[1] <= 0:
        return None
    return PERCENT * (1.0 - d[0] / d[1])
