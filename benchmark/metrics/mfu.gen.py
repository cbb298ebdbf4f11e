"""Percent of the card's bf16 peak (989 TFLOP/s, H100 SXM dense) that the
window's model FLOPs fill: SigLIP's tap layers on every frame admitted, the
STC connector, the prefill of every admitted prompt with its causal
attention, and every generated token's decode step at its context."""

from benchmark.readers import mfu

LAYER = "whole step"
MOVES = "gen_tok_s"


def read(w):
    return mfu(w)
