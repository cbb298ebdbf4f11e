"""Every token the engine generated inside the window, for finished and
unfinished requests alike (a stream's deltas as they arrive), over the
window's seconds."""

MOVES = "gen_tok_s"


def read(w):
    return sum(n for _, _, n in w.window_tokens()) / w.seconds
