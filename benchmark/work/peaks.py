"""Published peaks of one NVIDIA H100 SXM (dense rates, at its 700 W power
limit)."""

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The larger of bytes over the memory rate and bf16 operations over
    their peak rate."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS)
