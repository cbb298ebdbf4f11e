"""``ragged_decode_attention`` / ``_q8`` (``csrc/decode_attention.cu``): one
decode step's attention over each sequence's cache."""

SYMBOLS = r"\b(decode_partial_kernel|decode_combine_kernel)\b"


def step(lengths, q_heads: int, kv_heads: int, head_dim: int, int8_cache: bool):
    """(bytes, flops) of one step's attention for sequences attending
    ``lengths`` cached positions: each valid key and value row read once
    (an int8 row carries its f32 scale), q read and the output written
    once."""
    row = head_dim + 4 if int8_cache else head_dim * 2
    seen = sum(lengths)
    nbytes = 2 * seen * kv_heads * row + len(lengths) * 2 * q_heads * head_dim * 2
    return nbytes, 4 * seen * q_heads * head_dim
