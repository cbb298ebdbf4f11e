"""Percent of its roofline the decode attention reaches: the cache bytes each
token generated in the window reads at its context length, every layer,
over the device time of ``csrc/decode_attention.cu``'s kernels."""

from benchmark.readers import decode_attention_bound, roofline
from benchmark.work import decode_attention

LAYER = "kernels"
MOVES = "gen_tok_s"


def read(w):
    return roofline(w, decode_attention.SYMBOLS, decode_attention_bound(w))
