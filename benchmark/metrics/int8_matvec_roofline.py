"""Percent of its roofline the int8 decode products reach: the int8 weights
and scales of every layer and of ``lm_head`` once a decode step (and
``lm_head`` once an admission, for the first token) over the device time of
``csrc/quant_matmul.cu``'s kernels."""

from benchmark.readers import quant_matvec_bound, roofline
from benchmark.work import quant_matvec

LAYER = "kernels"
MOVES = "gen_tok_s"


def read(w):
    return roofline(w, quant_matvec.SYMBOLS, quant_matvec_bound(w))
