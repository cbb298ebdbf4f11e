"""Host milliseconds a prepared request waits for its slot copy: from the
admitter putting it in the engine's ``_ready`` to the worker's ``_install``
(``ready_wait_s``, the current chunk's remainder) over the ``admissions``,
over the window."""

from benchmark.engine_layers import ratio

LAYER = "engine admission"
MOVES = "gen_tok_s"


def read(w):
    return ratio(w, "ready_wait_s", "admissions", 1e3)
