"""Seconds from the process's start to the window's: loading, the weights
written into the program, warm-up and, in a closed loop, the ramp."""

MOVES = "setup_s"


def read(w):
    return w.setup_s
