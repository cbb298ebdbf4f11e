"""``fused_hiera_block`` (``csrc/hiera_block.cu``) as the SigLIP tower runs it:
one launch a layer over every frame of an admission, one 729-token window a
frame."""

# the kernels of csrc/hiera_block.cu and the attention tile's head-dim-80
# instance (SigLIP's 72 rounded up; the LLM's prefill takes the 128 one)
SYMBOLS = (r"\b(layernorm_kernel|gemm_kernel|gemm_pp_kernel|ln_gemm_kernel|pool_kernel|"
           r"gemm_s8_kernel|round_clip_s8_kernel|rowquant_kernel|transpose_s8_kernel)\b"
           r"|\bflash_fwd_kernel<80\b")


def block(frames: int, tokens: int, width: int, mlp: int, heads: int, head_dim: int):
    """(bytes, flops) of one layer over ``frames`` frames: the activations
    read and written once (the weights, read once a launch, are left out:
    the block is bound by its operations), the four products and the
    attention."""
    rows = frames * tokens
    flops = (2 * rows * (4 * width * width + 2 * width * mlp)
             + 4 * frames * heads * tokens * tokens * head_dim)
    return 2 * rows * width * 2, flops


def tower(frames: int, vision: dict, layers: int):
    """(bytes, flops) of ``layers`` layers over ``frames`` frames."""
    c, m, heads = vision["hidden_size"], vision["intermediate_size"], vision["num_heads"]
    n = (vision["image_size"] // vision["patch_size"]) ** 2
    b, f = block(frames, n, c, m, heads, c // heads)
    return layers * b, layers * f
