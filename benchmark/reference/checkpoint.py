"""The weights both sides read: a state dict in the reference checkpoint's
names (HF Qwen2 at the top level, HF SigLIP under
``model.vision_tower.vision_tower.``, VideoLLaMA2's STC connector under
``model.mm_projector.``, the region encoder and the ``[SEG]`` head under
their ``model.`` paths), drawn on a device from a seed.

Every tensor is a view of one flat buffer filled by a few large ``randn``
calls from one generator, then scaled (and shifted, for norms) in place, so
the same seed on the same device gives the same weights, and a run makes
them again after its window for the plain reference. Only the SigLIP
layers the ``hidden_states[-2]`` tap runs are drawn. The configuration is a
plain dict (``configs/<name>.json``'s ``model``); nothing here imports the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, kind, argument): kind "dense" std = argument ** -0.5 (fan-in),
# "normal" std = argument, "norm" 1 + N(0, argument)
Entry = Tuple[str, Tuple[int, ...], str, float]

BIAS_STD = 0.02
NORM_STD = 0.02
EMBED_STD = 0.02
CHUNK = 1 << 30  # elements a randn call


def _dense(name: str, out: int, inp: int, bias: bool, shape=None) -> List[Entry]:
    entries = [(f"{name}.weight", tuple(shape or (out, inp)), "dense", float(inp))]
    if bias:
        entries.append((f"{name}.bias", (out,), "normal", BIAS_STD))
    return entries


def _layer_norm(name: str, width: int, bias: bool = True) -> List[Entry]:
    entries = [(f"{name}.weight", (width,), "norm", NORM_STD)]
    if bias:
        entries.append((f"{name}.bias", (width,), "normal", BIAS_STD))
    return entries


def qwen2_layout(llm: dict) -> List[Entry]:
    h, hd = llm["hidden_size"], llm["head_dim"]
    nq, nkv = llm["num_heads"] * hd, llm["num_kv_heads"] * hd
    inter, vocab = llm["intermediate_size"], llm["vocab_size"]
    out: List[Entry] = [("model.embed_tokens.weight", (vocab, h), "normal", EMBED_STD)]
    for i in range(llm["num_layers"]):
        p = f"model.layers.{i}"
        out += _layer_norm(f"{p}.input_layernorm", h, bias=False)
        out += _dense(f"{p}.self_attn.q_proj", nq, h, True)
        out += _dense(f"{p}.self_attn.k_proj", nkv, h, True)
        out += _dense(f"{p}.self_attn.v_proj", nkv, h, True)
        out += _dense(f"{p}.self_attn.o_proj", h, nq, False)
        out += _layer_norm(f"{p}.post_attention_layernorm", h, bias=False)
        out += _dense(f"{p}.mlp.gate_proj", inter, h, False)
        out += _dense(f"{p}.mlp.up_proj", inter, h, False)
        out += _dense(f"{p}.mlp.down_proj", h, inter, False)
    out += _layer_norm("model.norm", h, bias=False)
    out += _dense("lm_head", vocab, h, False)
    return out


def encode_layers(vision: dict) -> int:
    """SigLIP layers the ``select_layer`` tap runs (26 of 27 for -2)."""
    return vision["num_layers"] + 1 + vision["select_layer"]


def siglip_layout(vision: dict) -> List[Entry]:
    c, m, p = vision["hidden_size"], vision["intermediate_size"], vision["patch_size"]
    n = (vision["image_size"] // p) ** 2
    pre = "model.vision_tower.vision_tower.vision_model"
    out = _dense(f"{pre}.embeddings.patch_embedding", c, 3 * p * p, True, shape=(c, 3, p, p))
    out.append((f"{pre}.embeddings.position_embedding.weight", (n, c), "normal", EMBED_STD))
    for i in range(encode_layers(vision)):
        lp = f"{pre}.encoder.layers.{i}"
        out += _layer_norm(f"{lp}.layer_norm1", c)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _dense(f"{lp}.self_attn.{name}", c, c, True)
        out += _layer_norm(f"{lp}.layer_norm2", c)
        out += _dense(f"{lp}.mlp.fc1", m, c, True)
        out += _dense(f"{lp}.mlp.fc2", c, m, True)
    return out


def _reg_block(name: str, cin: int, cout: int) -> List[Entry]:
    """timm RegNet bottleneck as VideoLLaMA2's RegStage builds it (channel
    LayerNorm under the ``bn`` names, squeeze-excite of round(cin / 4))."""
    rd = int(round(cin * 0.25))
    out = _dense(f"{name}.conv1.conv", cout, cin, False, shape=(cout, cin, 1, 1))
    out += _layer_norm(f"{name}.conv1.bn", cout)
    out.append((f"{name}.conv2.conv.weight", (cout, 1, 3, 3), "dense", 9.0))
    out += _layer_norm(f"{name}.conv2.bn", cout)
    out += _dense(f"{name}.se.fc1", rd, cout, True, shape=(rd, cout, 1, 1))
    out += _dense(f"{name}.se.fc2", cout, rd, True, shape=(cout, rd, 1, 1))
    out += _dense(f"{name}.conv3.conv", cout, cout, False, shape=(cout, cout, 1, 1))
    out += _layer_norm(f"{name}.conv3.bn", cout)
    if cin != cout:
        out += _dense(f"{name}.downsample.conv", cout, cin, False, shape=(cout, cin, 1, 1))
        out += _layer_norm(f"{name}.downsample.bn", cout)
    return out


def stc_layout(proj: dict) -> List[Entry]:
    if proj["projector_type"] != "stc_connector_v35":
        raise ValueError(f"the reference builds stc_connector_v35, not {proj['projector_type']}")
    d, enc, depth = proj["hidden_size"], proj["encoder_hidden_size"], proj["depth"]
    dt, dh, dw = proj["downsample"]
    pre = "model.mm_projector"
    out: List[Entry] = []
    for stage, cin in (("s1", enc), ("s2", d)):
        for i in range(depth):
            out += _reg_block(f"{pre}.{stage}.b{i + 1}", cin if i == 0 else d, d)
        if stage == "s1":
            out += _dense(f"{pre}.sampler.0", d, d * dt * dh * dw, True, shape=(d, d, dt, dh, dw))
    for i in range(proj["mlp_depth"]):
        out += _dense(f"{pre}.readout.{2 * i}", d, d, True)
    return out


def heads_layout(model: dict) -> List[Entry]:
    """The region encoder and the ``[SEG]`` head: loaded, never run by QA."""
    reg, h = model["region"], model["llm"]["hidden_size"]
    out = _dense("model.region_encoder.feat_linear.0", reg["hidden_size"],
                 reg["encoder_hidden_size"], True)
    for i in range(1, reg["depth"]):
        out += _dense(f"model.region_encoder.feat_linear.{2 * i}", reg["hidden_size"],
                      reg["hidden_size"], True)
    out += _dense("model.text_hidden_fcs.0.0", h, h, True)
    out += _dense("model.text_hidden_fcs.0.2", model["sam_out_dim"], h, True)
    return out


def layout(model: dict) -> List[Entry]:
    return (qwen2_layout(model["llm"]) + siglip_layout(model["vision"])
            + stc_layout(model["projector"]) + heads_layout(model))


def state_dict_bytes(model: dict, dtype: torch.dtype = torch.bfloat16) -> int:
    return sum(math.prod(s) for _, s, _, _ in layout(model)) * torch.empty(
        (), dtype=dtype).element_size()


@torch.no_grad()
def make_state_dict(model: dict, seed: int, device, dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    """{name: tensor} on ``device`` in ``dtype``, every tensor a view of one
    flat buffer drawn from ``seed``."""
    entries = layout(model)
    total = sum(math.prod(s) for _, s, _, _ in entries)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    for start in range(0, total, CHUNK):
        part = flat[start:start + CHUNK]
        torch.randn(part.shape, generator=gen, dtype=dtype, device=device, out=part)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, kind, arg in entries:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "dense":
            t.mul_(arg ** -0.5)
        elif kind == "normal":
            t.mul_(arg)
        else:  # norm scale: 1 + N(0, arg)
            t.mul_(arg).add_(1.0)
        out[name] = t
    return out
