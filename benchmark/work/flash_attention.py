"""``flash_attention`` (``csrc/flash_attention.cu``, the attention tile's
head-dim-128 instance) as the LLM's prefill runs it: causal GQA over each
prompt's valid keys."""

SYMBOLS = r"\bflash_fwd_kernel<128\b|\bflash_merge_kernel\b"


def causal(length: int, q_heads: int, kv_heads: int, head_dim: int, rows: int = 0):
    """(bytes, flops) of one sequence's causal attention: query rows
    ``rows`` (default ``length``: the valid rows alone) each see the keys up
    to it among the ``length`` valid ones; q read and the output written
    once, each valid key and value read once."""
    rows = rows or length
    if rows <= length:
        seen = rows * (rows + 1) // 2
    else:  # padding rows past the valid ones see every valid key
        seen = length * (length + 1) // 2 + (rows - length) * length
    flops = 4 * q_heads * head_dim * seen
    nbytes = 2 * rows * q_heads * head_dim * 2 + 2 * length * kv_heads * head_dim * 2
    return nbytes, flops
