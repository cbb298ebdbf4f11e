"""Fill the port's modules from the JAX package's parameter tree.

``params`` is the output of
``jax.tree.map(np.asarray, UFVideoModel(cfg).init_params(key))`` — nested
dicts of numpy arrays — so this module needs no JAX. Layout changes:

- flax ``Dense`` kernels are [in, out]; ``nn.Linear.weight`` is [out, in].
- SigLIP and Qwen2 layers are scan-stacked on a leading layer axis.
- Qwen2's ``self_attn_qkv_proj`` is already the fused [q | k | v] matrix.
- SigLIP's encoder layers keep [in, out] (the kernel's layout).
- ``patch_embedding_kernel`` [p, p, 3, C] becomes a [C, p·p·3] matmul.
- Conv kernels [kh, kw, (kt,) in, out] become torch [out, in, (kt,) kh, kw].
- ``embed_tokens`` / ``lm_head`` keep their padded vocab rows.
- A quantised tree (``quant.quantize_qwen2_params`` /
  ``quantize_vision_params`` on either side) carries ``kernel_q`` /
  ``kernel_scale`` leaves in place of ``kernel``: scan-stacked [L, in, out]
  int8 and [L, out] f32, or for int4 [L, in/2, out] packed int8 and
  [L, in/64, out]. They go into ``QuantLinear`` / the quantised SigLIP layer
  unchanged: those keep the [in, out] layout.
- The ``sam``, ``text_fcs`` and ``region`` subtrees are walked by name (``load_tree``):
  the port's modules carry the flax names (``blocks_3`` is ``blocks[3]``).
  A transposed convolution's kernel is also flipped in space: flax applies
  it unflipped, torch flips. The Hiera blocks' parameter holders
  (``kernel`` / ``scale`` attributes) keep the flax [in, out] layout, which
  is the fused kernels' layout. A quantised SAM2 (``quant_vision``) takes
  the tree of ``quant.quantize_sam2_params`` (either side): under
  ``sam.image_encoder_trunk.blocks_*`` each dense layer carries ``kernel_q``
  int8 [in, out] and ``kernel_scale`` f32 [out] in place of ``kernel``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Set

import numpy as np
import torch

from .models.projector import RegBottleneck, STCConnector
from .models.qwen2 import QuantLinear, Qwen2LM
from .models.siglip import SiglipVisionTower
from .models.ufvideo import UFVideoModel


@torch.no_grad()
def _set(dst: torch.Tensor, src) -> None:
    src = torch.from_numpy(np.array(src))  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(src.to(dtype=dst.dtype))


def _dense(lin: torch.nn.Linear, p: Dict[str, Any]) -> None:
    _set(lin.weight, np.asarray(p["kernel"]).T)
    if lin.bias is not None:
        _set(lin.bias, p["bias"])


def _ln(ln, p: Dict[str, Any]) -> None:
    _set(ln.weight, p["scale"])
    if "bias" in p:
        _set(ln.bias, p["bias"])


def load_siglip(tower: SiglipVisionTower, p: Dict[str, Any]) -> None:
    k = np.asarray(p["patch_embedding_kernel"])  # [p, p, 3, C]
    _set(tower.patch_embedding.weight, k.reshape(-1, k.shape[-1]).T)
    _set(tower.patch_embedding.bias, p["patch_embedding_bias"])
    _set(tower.position_embedding, p["position_embedding"])
    lp = p["layers"]
    dense = {"qkv": ("self_attn", "qkv_proj"), "out": ("self_attn", "out_proj"),
             "fc1": ("mlp", "fc1"), "fc2": ("mlp", "fc2")}
    for i, layer in enumerate(tower.layers):
        pick = lambda *path: _pick(lp, path)[i]
        _set(layer.ln1_scale, pick("layer_norm1", "scale"))
        _set(layer.ln1_bias, pick("layer_norm1", "bias"))
        _set(layer.ln2_scale, pick("layer_norm2", "scale"))
        _set(layer.ln2_bias, pick("layer_norm2", "bias"))
        for name, path in dense.items():
            if layer.quant:
                _set(getattr(layer, f"{name}_kernel"), pick(*path, "kernel_q"))
                _set(getattr(layer, f"{name}_scale"), pick(*path, "kernel_scale"))
            else:
                _set(getattr(layer, f"{name}_kernel"), pick(*path, "kernel"))
            _set(getattr(layer, f"{name}_bias"), pick(*path, "bias"))


def _pick(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _conv1x1(lin: torch.nn.Linear, p) -> None:
    k = np.asarray(p["kernel"])  # [1, 1, in, out]
    _set(lin.weight, k[0, 0].T)
    if lin.bias is not None:
        _set(lin.bias, p["bias"])


def _bottleneck(blk: RegBottleneck, p) -> None:
    _conv1x1(blk.conv1, p["conv1"])
    _ln(blk.conv1_ln, p["conv1_ln"])
    _set(blk.conv2.weight, np.asarray(p["conv2"]["kernel"]).transpose(3, 2, 0, 1))
    _ln(blk.conv2_ln, p["conv2_ln"])
    _conv1x1(blk.se_fc1, p["se_fc1"])
    _conv1x1(blk.se_fc2, p["se_fc2"])
    _conv1x1(blk.conv3, p["conv3"])
    _ln(blk.conv3_ln, p["conv3_ln"])
    if blk.downsample is not None:
        _conv1x1(blk.downsample, p["downsample"])
        _ln(blk.downsample_ln, p["downsample_ln"])


def load_projector(proj: STCConnector, p: Dict[str, Any]) -> None:
    for stage, name in ((proj.s1, "s1"), (proj.s2, "s2")):
        for i, blk in enumerate(stage.blocks):
            _bottleneck(blk, p[name][f"b{i + 1}"])
    k = np.asarray(p["sampler"]["kernel"])  # [kt, kh, kw, in, out]
    _set(proj.sampler.weight, k.transpose(4, 3, 0, 1, 2))
    _set(proj.sampler.bias, p["sampler"]["bias"])
    for i, fc in enumerate(proj.readout):
        _dense(fc, p["readout"][f"fc{2 * i}"])


def _qwen2_dense(lin, p: Dict[str, Any], i=None) -> None:
    """One dense layer of the LM from its flax dict (layer ``i`` of a
    scan-stacked one): float ``kernel`` into an ``nn.Linear``, or
    ``kernel_q`` / ``kernel_scale`` into a ``QuantLinear``."""
    leaf = lambda k: np.asarray(p[k]) if i is None else np.asarray(p[k])[i]
    if isinstance(lin, QuantLinear):
        if "kernel_q" not in p:
            raise KeyError("a quantised LM needs a quantised tree (kernel_q / kernel_scale)")
        _set(lin.kernel_q, leaf("kernel_q"))
        _set(lin.kernel_scale, leaf("kernel_scale"))
    else:
        _set(lin.weight, leaf("kernel").T)
    if lin.bias is not None:
        _set(lin.bias, leaf("bias"))


def load_qwen2(lm: Qwen2LM, p: Dict[str, Any]) -> None:
    _set(lm.embed_tokens.weight, p["embed_tokens"]["embedding"])
    _ln(lm.norm, p["norm"])
    _qwen2_dense(lm.lm_head, p["lm_head"])
    lp = p["layers"]
    for i, layer in enumerate(lm.layers):
        pick = lambda *path: _pick(lp, path)[i]
        _set(layer.input_layernorm.weight, pick("input_layernorm", "scale"))
        _set(layer.post_attention_layernorm.weight, pick("post_attention_layernorm", "scale"))
        for lin, name in (
            (layer.qkv_proj, "self_attn_qkv_proj"), (layer.o_proj, "self_attn_o_proj"),
            (layer.gate_proj, "mlp_gate_proj"), (layer.up_proj, "mlp_up_proj"),
            (layer.down_proj, "mlp_down_proj"),
        ):
            _qwen2_dense(lin, lp[name], i)


def _child(mod: torch.nn.Module, name: str):
    """The attribute a flax name refers to: itself, or ``base_3`` → ``base[3]``."""
    if hasattr(mod, name):
        return getattr(mod, name)
    m = re.fullmatch(r"(.+)_(\d+)", name)
    if m and hasattr(mod, m.group(1)):
        return getattr(mod, m.group(1))[int(m.group(2))]
    raise KeyError(f"{type(mod).__name__} has nothing named {name!r}")


def _leaf(mod: torch.nn.Module, key: str, value, seen: Set[int]) -> None:
    """One flax leaf (kernel / scale / bias) into the layer ``mod``."""
    value = np.asarray(value)
    if isinstance(getattr(mod, key, None), torch.nn.Parameter):
        dst = getattr(mod, key)  # holder in the flax layout
    elif key == "scale":
        dst = mod.weight
    elif key != "kernel":
        raise KeyError(f"{type(mod).__name__} has no parameter {key!r}")
    else:
        dst = mod.weight
        if isinstance(mod, torch.nn.ConvTranspose2d):  # [kh, kw, in, out], unflipped
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        elif isinstance(mod, torch.nn.Conv2d):  # [kh, kw, in / groups, out]
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 4:  # 1x1 convolution held as a Linear
            value = value[0, 0].T
        else:
            value = value.T
    _set(dst, value)
    seen.add(id(dst))


def load_tree(mod: torch.nn.Module, tree: Dict[str, Any], seen: Set[int],
              path: str = "") -> None:
    """Copy a flax subtree into the module of the same shape, by name."""
    for name, sub in tree.items():
        if not isinstance(sub, dict):
            dst = _child(mod, name)
            _set(dst, sub)
            seen.add(id(dst))
            continue
        child = _child(mod, name)
        here = f"{path}{name}"
        if all(not isinstance(v, dict) for v in sub.values()) and (
            "kernel" in sub or "scale" in sub or "kernel_q" in sub
        ):
            if hasattr(child, "kernel_q") and "kernel_q" not in sub:
                raise KeyError(
                    f"a quantised SAM2 trunk needs a quantised tree: {here} has "
                    "kernel, not kernel_q / kernel_scale")
            for key, value in sub.items():
                _leaf(child, key, value, seen)
        else:
            load_tree(child, sub, seen, here + ".")


# flax creates a layer's parameters when it is first called, and the JAX
# package's init pass gives no mask prompt: a randomly initialised tree has
# no mask-prompt convolutions (a converted checkpoint has them)
_LAZY = ("sam_prompt_encoder.mask_downscaling_",)


def load_by_name(mod: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """``load_tree`` that also checks every parameter of ``mod`` was filled
    (but for the layers flax creates lazily, see ``_LAZY``)."""
    seen: Set[int] = set()
    load_tree(mod, tree, seen)
    missing = [
        n for n, p in mod.named_parameters()
        if id(p) not in seen and not n.startswith(_LAZY)
    ]
    if missing:
        raise KeyError(f"parameters not in the tree: {missing[:8]}")


def load_jax_params(model: UFVideoModel, params: Dict[str, Any]) -> UFVideoModel:
    """Copy the JAX param tree (numpy leaves) into ``model``; returns it.
    The ``sam`` subtree (the JAX runtime keeps it beside the composite's
    tree) is loaded when present."""
    load_siglip(model.vision, params["vision"])
    load_projector(model.projector, params["projector"])
    load_qwen2(model.llm, params["llm"])
    load_by_name(model.text_fcs, params["text_fcs"])
    load_by_name(model.region, params["region"])
    if "sam" in params:
        load_by_name(model.sam, params["sam"])
    return model
