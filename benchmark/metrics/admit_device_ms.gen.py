"""Device milliseconds of an admission: the transfer, encode, splice and
prefill stages' intervals on the admitters' streams, from timing events
read without a fence (``admit_device_s``), over the ``admissions``, over the
window."""

from benchmark.engine_layers import ratio

LAYER = "engine admission"
MOVES = "gen_tok_s"


def read(w):
    return ratio(w, "admit_device_s", "admissions", 1e3)
