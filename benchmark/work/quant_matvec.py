"""``int8_matvec`` (``csrc/quant_matmul.cu``): the int8 LLM's products at up to
32 rows, every decode step's projections and ``lm_head``."""

SYMBOLS = r"\b(matvec_row_kernel|rows_kernel|finish_kernel)\b"


def projections(llm: dict):
    """(in, out) of one layer's products (fused qkv, o, gate, up, down)."""
    h, hd = llm["hidden_size"], llm["head_dim"]
    nq, nkv = llm["num_heads"] * hd, llm["num_kv_heads"] * hd
    i = llm["intermediate_size"]
    return [(h, nq + 2 * nkv), (nq, h), (h, i), (h, i), (i, h)]


def product(din: int, dout: int, rows: int = 0):
    """(bytes, flops) of one product: the int8 weights and f32 column scales
    read once, and ``rows`` bf16 rows in and f32 rows out."""
    return din * dout + 4 * dout + rows * (2 * din + 4 * dout), 2 * rows * din * dout


def step(llm: dict, vocab_rows: int):
    """(bytes, flops) of the weights and scales one decode step reads: every
    layer's products and ``lm_head``."""
    per_layer = sum(product(i, o)[0] for i, o in projections(llm))
    return llm["num_layers"] * per_layer + product(llm["hidden_size"], vocab_rows)[0], 0
