"""Model FLOPs of video QA (``mfu``): the work the model's mathematics needs,
whatever runs it (a quantised product counts as the product it stands for)."""

from . import flash_attention, siglip_block


def _llm_params(llm: dict) -> int:
    """Multiply-adds of one token through the layers (lm_head apart)."""
    h, hd = llm["hidden_size"], llm["head_dim"]
    nq, nkv = llm["num_heads"] * hd, llm["num_kv_heads"] * hd
    per_layer = h * (nq + 2 * nkv) + nq * h + 3 * h * llm["intermediate_size"]
    return llm["num_layers"] * per_layer


def frames(n: int, vision: dict, layers: int) -> float:
    """SigLIP over ``n`` frames: the patch embedding and ``layers`` layers."""
    p, c = vision["patch_size"], vision["hidden_size"]
    tokens = (vision["image_size"] // p) ** 2
    return 2 * n * tokens * 3 * p * p * c + siglip_block.tower(n, vision, layers)[1]


def connector(frames_: int, vision: dict, proj: dict) -> float:
    """The STC-v35 connector over one video of ``frames_`` frames."""
    g = vision["image_size"] // vision["patch_size"]
    enc, d, depth = proj["encoder_hidden_size"], proj["hidden_size"], proj["depth"]
    dt, dh, dw = proj["downsample"]

    def stage(positions: int, cin: int) -> float:
        total = 0.0
        for b in range(depth):
            i = cin if b == 0 else d
            rd = int(round(i * 0.25))
            macs = i * d + 9 * d + d * d + (i * d if i != d else 0)
            total += 2 * positions * macs + 4 * d * rd * (positions // (g * g) or 1)
        return total

    t2, g2 = frames_ // dt, g // dh
    out = t2 * g2 * (g // dw)
    return (stage(frames_ * g * g, enc) + 2 * out * d * d * dt * dh * dw
            + stage(out, d) + proj["mlp_depth"] * 2 * out * d * d)


def prefill(length: int, llm: dict) -> float:
    """One prompt: every position through the layers, causal attention over
    its valid keys, ``lm_head`` at the last position."""
    att = flash_attention.causal(length, llm["num_heads"], llm["num_kv_heads"],
                                 llm["head_dim"])[1]
    return (2 * length * _llm_params(llm) + llm["num_layers"] * att
            + 2 * llm["hidden_size"] * llm["vocab_size"])


def decode(context: int, llm: dict) -> float:
    """One generated token at ``context`` cached positions."""
    att = 4 * context * llm["num_heads"] * llm["head_dim"]
    return (2 * _llm_params(llm) + llm["num_layers"] * att
            + 2 * llm["hidden_size"] * llm["vocab_size"])
