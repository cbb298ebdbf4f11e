"""Fill the port's modules from the JAX package's parameter tree
(``load_jax_params``), or from the reference's torch state dicts (the
converters below ``TensorWriter``; ``checkpoints.convert_full_checkpoint``
joins them).

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

import functools
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from .models.projector import RegBottleneck, STCConnector
from .models.qwen2 import QuantLinear, Qwen2LM
from .models.region_encoder import RegionProjector
from .models.siglip import SiglipEncoderLayer, SiglipVisionTower
from .models.ufvideo import TextHiddenFC, UFVideoModel


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


def load_jax_lora_state(model: UFVideoModel, state: Dict[str, Any]
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA train state (``{"base": …, "trainable": {"lora": …,
    "non_lora": …}}``, numpy leaves) → its base and non-LoRA trainables
    written into ``model``, and its factors ``{"q" | "v": {"a": [L, hidden,
    r], "b": [L, r, out]}}`` as float32 tensors on the model's device."""
    load_jax_params(model, {**state["base"], **state["trainable"]["non_lora"]})
    dev = next(model.parameters()).device
    lora = state["trainable"]["lora"]
    return {m: {k: torch.tensor(np.asarray(lora[m][k]), dtype=torch.float32, device=dev)
                for k in ("a", "b")} for m in ("q", "v")}


# --------------------------------------------------------------------------
# the reference's state dicts (HF Qwen2 / SigLIP, timm RegStage, SAM2 names)
# --------------------------------------------------------------------------
#
# The converters write each tensor of a state dict into its parameter as
# they reach it: on the parameter's device, in its dtype (the JAX package
# casts the converted tree to the param dtype the same way), a quantised
# layer through its own ``set_kernel`` on the float kernel in that dtype.
# Layout changes: a Linear's [out, in] into an [in, out] holder (``kernel``,
# ``kernel_q``) is transposed; q / k / v rows go into the fused qkv;
# ``embed_tokens`` / ``lm_head`` get zero rows up to the padded vocabulary; a
# 1x1 convolution [out, in, 1, 1] held as a Linear drops its unit axes;
# SigLIP's patch convolution [C, 3, p, p] becomes the [C, p·p·3] matmul.
# Convolutions, transposed ones included, keep torch's layout: the port's
# modules are torch's. Hiera's qkv and proj stay unpadded (the TPU's
# ``head_pad`` is a layout of the JAX trunk only).
#
# A plan lists (reference key, target, form) for a module tree, so that the
# converter and the exporter (``export.py``) read one map in both
# directions: the target is a layer (weight or kernel, and bias, under
# ``key.weight`` / ``key.bias``) or a bare parameter (under ``key``); the
# form is None (the layouts above), ``"1x1"`` (a 1x1 convolution held as a
# Linear), ``"patch"`` (a [C, 3, p, p] convolution held as the [C, p·p·3]
# matmul over (ph, pw, channel) features), ``"row"`` (an
# ``nn.Embedding(1, C)`` weight [1, C] held as [C]) or ``"chw"`` ([1, C, H, W]
# held as [H, W, C]). A tuple of keys names the reference layers whose output
# rows one fused layer joins (q / k / v into a qkv); its form is their row
# counts.

Key = Union[str, Tuple[str, ...]]
Form = Union[None, str, Tuple[int, ...]]
Plan = List[Tuple[Key, Any, Form]]


def _get(sd: Mapping, key: str) -> torch.Tensor:
    try:
        return sd[key]
    except KeyError:
        raise KeyError(f"the checkpoint has no {key!r}") from None


class TensorWriter:
    """Copies state-dict tensors into a model's parameters, one at a time,
    and records which parameters it wrote."""

    def __init__(self):
        self.written: Set[int] = set()

    @torch.no_grad()
    def put(self, dst: torch.Tensor, src: torch.Tensor, key: str) -> None:
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
        dst.copy_(src)
        self.written.add(id(dst))

    @torch.no_grad()
    def quantise(self, set_kernel, weight: torch.Tensor, shape: Sequence[int],
                 dtype: torch.dtype, holders: Sequence[torch.Tensor], key: str) -> None:
        """``set_kernel`` quantises the float [in, out] kernel ``weight.t()``
        (``weight`` [out, in], the reference's layout) into ``holders``; the
        weight goes to their device in the model's dtype first, as the JAX
        package casts before it quantises."""
        if tuple(weight.shape[::-1]) != tuple(shape):
            raise ValueError(f"{key}: weight {tuple(weight.shape)} does not fit the "
                             f"[in, out] kernel {tuple(shape)}")
        set_kernel(weight.to(device=holders[0].device, dtype=dtype).t())
        self.written.update(id(h) for h in holders)

    def check_all_written(self, model: torch.nn.Module) -> None:
        missing = [n for n, t in (*model.named_parameters(), *model.named_buffers())
                   if id(t) not in self.written]
        if missing:
            raise KeyError(f"the checkpoint writes {len(missing)} parameters of the model "
                           f"nothing: {missing[:8]}")


def _write_layer(w: TensorWriter, mod: Any, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], key: str) -> None:
    """A layer's reference weight ([out, in] for a dense layer) and bias
    into ``mod``, whichever holder it keeps them in."""
    if hasattr(mod, "kernel_q"):  # QuantLinear / W8A8Linear, [in, out]
        shape = ((mod.in_features, mod.out_features) if hasattr(mod, "in_features")
                 else tuple(mod.kernel_q.shape))
        w.quantise(mod.set_kernel, weight, shape, mod.dtype,
                   (mod.kernel_q, mod.kernel_scale), key)
    elif isinstance(getattr(mod, "kernel", None), torch.nn.Parameter):  # [in, out] holder
        w.put(mod.kernel, weight.t(), key)
    elif isinstance(getattr(mod, "scale", None), torch.nn.Parameter):  # LayerNorm holder
        w.put(mod.scale, weight, key)
    else:
        w.put(mod.weight, weight, key)
    if getattr(mod, "bias", None) is not None:
        w.put(mod.bias, bias, key + " bias")


def _joined(sd: Mapping, keys: Tuple[str, ...], suffix: str) -> torch.Tensor:
    parts = [_get(sd, f"{k}.{suffix}") for k in keys]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def plan_from_sd(w: TensorWriter, plan: Plan, sd: Mapping) -> None:
    """Write every target of ``plan`` from the state dict ``sd``."""
    for key, target, form in plan:
        if isinstance(target, torch.Tensor):
            t = _get(sd, key)
            if form == "row":
                t = t[0]
            elif form == "chw":
                t = t[0].permute(1, 2, 0)
            w.put(target, t, key)
            continue
        keys = key if isinstance(key, tuple) else (key,)
        weight = _joined(sd, keys, "weight")
        if form == "1x1":
            weight = weight.reshape(weight.shape[:2])
        elif form == "patch":
            weight = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)
        bias = _joined(sd, keys, "bias") if getattr(target, "bias", None) is not None else None
        _write_layer(w, target, weight, bias, "+".join(keys))


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU tensor of its own holding ``t``."""
    return torch.empty(tuple(t.shape), dtype=t.dtype).copy_(t.detach())


def plan_to_sd(plan: Plan) -> Dict[str, torch.Tensor]:
    """The inverse of ``plan_from_sd``: the state dict the targets hold, each
    tensor in its parameter's dtype."""
    out: Dict[str, torch.Tensor] = {}
    for key, target, form in plan:
        if isinstance(target, torch.Tensor):
            t = target
            if form == "row":
                t = t[None]
            elif form == "chw":
                t = t.permute(2, 0, 1)[None]
            out[key] = to_host(t)
            continue
        if hasattr(target, "kernel_q"):
            raise ValueError(f"{key}: a quantised layer has no float weights to export")
        if isinstance(getattr(target, "kernel", None), torch.nn.Parameter):
            weight = target.kernel.t()
        elif isinstance(getattr(target, "scale", None), torch.nn.Parameter):
            weight = target.scale
        else:
            weight = target.weight
        if form == "1x1":
            weight = weight[:, :, None, None]
        elif form == "patch":
            p = math.isqrt(weight.shape[1] // 3)
            weight = weight.reshape(weight.shape[0], p, p, 3).permute(0, 3, 1, 2)
        bias = getattr(target, "bias", None)
        if isinstance(key, tuple):  # a fused layer: its rows back to each layer
            parts = zip(key, weight.split(form),
                        bias.split(form) if bias is not None else [None] * len(key))
        else:
            parts = [(key, weight, bias)]
        for k, wt, b in parts:
            out[f"{k}.weight"] = to_host(wt)
            if b is not None:
                out[f"{k}.bias"] = to_host(b)
    return out


def same_names(mod: torch.nn.Module, prefix: str) -> Plan:
    """Every layer under ``mod`` whose name under the port is its name in
    the reference (the layers that own parameters directly)."""
    return [(f"{prefix}.{name}" if name else prefix, m, None)
            for name, m in mod.named_modules()
            if next(m.parameters(recurse=False), None) is not None]


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero rows up to ``rows`` (the padded vocabulary)."""
    if x.shape[0] == rows:
        return x
    if x.shape[0] > rows:
        raise ValueError(f"{x.shape[0]} vocabulary rows do not fit the model's {rows}")
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


_QKV = ("q_proj", "k_proj", "v_proj")


def qwen2_plan(lm: Qwen2LM) -> Plan:
    """Every Qwen2 layer but the vocabulary's two (``convert_qwen2`` pads
    them, ``export.export_qwen2`` unpads them)."""
    cfg = lm.cfg
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    plan: Plan = [("model.norm", lm.norm, None)]
    for i, layer in enumerate(lm.layers):
        lp = f"model.layers.{i}"
        plan += [
            (tuple(f"{lp}.self_attn.{n}" for n in _QKV), layer.qkv_proj, (nq, nkv, nkv)),
            (f"{lp}.self_attn.o_proj", layer.o_proj, None),
            (f"{lp}.mlp.gate_proj", layer.gate_proj, None),
            (f"{lp}.mlp.up_proj", layer.up_proj, None),
            (f"{lp}.mlp.down_proj", layer.down_proj, None),
            (f"{lp}.input_layernorm", layer.input_layernorm, None),
            (f"{lp}.post_attention_layernorm", layer.post_attention_layernorm, None),
        ]
    return plan


def convert_qwen2(w: TensorWriter, lm: Qwen2LM, sd: Mapping) -> None:
    """HF Qwen2ForCausalLM state dict → ``lm``: q / k / v rows into the
    fused qkv, the vocabulary padded with zero rows; a checkpoint without
    ``lm_head.weight``, or a tied configuration, gets a copy of the
    embedding as its head."""
    rows = lm.cfg.padded_vocab_size
    embed = _get(sd, "model.embed_tokens.weight")
    w.put(lm.embed_tokens.weight, _pad_rows(embed, rows), "model.embed_tokens.weight")
    tied = lm.cfg.tie_word_embeddings or "lm_head.weight" not in sd
    head = embed if tied else sd["lm_head.weight"]
    _write_layer(w, lm.lm_head, _pad_rows(head, rows), None, "lm_head.weight")
    plan_from_sd(w, qwen2_plan(lm), sd)


class _SiglipDense:
    """A SigLIP layer's dense layer ``name`` (its ``{name}_kernel``,
    ``{name}_scale`` and ``{name}_bias`` holders) as a plan target."""

    def __init__(self, layer: SiglipEncoderLayer, name: str):
        kernel = getattr(layer, f"{name}_kernel")
        self.bias = getattr(layer, f"{name}_bias")
        if layer.quant:
            self.kernel_q, self.kernel_scale = kernel, getattr(layer, f"{name}_scale")
            self.set_kernel = functools.partial(layer.set_kernel, name)
            self.dtype = layer.dtype
        else:
            self.kernel = kernel


def siglip_plan(tower: SiglipVisionTower) -> Plan:
    """HF SiglipVisionModel keys of the ``num_encode_layers`` layers the
    port holds (the reference never runs the rest either)."""
    p, c = "vision_model", tower.cfg.hidden_size
    plan: Plan = [(f"{p}.embeddings.patch_embedding", tower.patch_embedding, "patch"),
                  (f"{p}.embeddings.position_embedding.weight", tower.position_embedding, None)]
    for i, layer in enumerate(tower.layers):
        lp = f"{p}.encoder.layers.{i}"
        plan += [
            (f"{lp}.layer_norm1.weight", layer.ln1_scale, None),
            (f"{lp}.layer_norm1.bias", layer.ln1_bias, None),
            (f"{lp}.layer_norm2.weight", layer.ln2_scale, None),
            (f"{lp}.layer_norm2.bias", layer.ln2_bias, None),
            (tuple(f"{lp}.self_attn.{n}" for n in _QKV), _SiglipDense(layer, "qkv"), (c, c, c)),
            (f"{lp}.self_attn.out_proj", _SiglipDense(layer, "out"), None),
            (f"{lp}.mlp.fc1", _SiglipDense(layer, "fc1"), None),
            (f"{lp}.mlp.fc2", _SiglipDense(layer, "fc2"), None),
        ]
    return plan


def convert_siglip(w: TensorWriter, tower: SiglipVisionTower, sd: Mapping) -> None:
    """HF SiglipVisionModel state dict → ``tower``."""
    plan_from_sd(w, siglip_plan(tower), sd)


def projector_plan(proj: STCConnector) -> Plan:
    """The STC projector's reference keys (timm RegStage naming); the other
    projector types raise when the port builds them."""
    plan: Plan = []
    for name, stage in (("s1", proj.s1), ("s2", proj.s2)):
        for i, blk in enumerate(stage.blocks):
            bp = f"{name}.b{i + 1}"
            plan += [(f"{bp}.conv1.conv", blk.conv1, "1x1"), (f"{bp}.conv1.bn", blk.conv1_ln, None),
                     (f"{bp}.conv2.conv", blk.conv2, None), (f"{bp}.conv2.bn", blk.conv2_ln, None),
                     (f"{bp}.se.fc1", blk.se_fc1, "1x1"), (f"{bp}.se.fc2", blk.se_fc2, "1x1"),
                     (f"{bp}.conv3.conv", blk.conv3, "1x1"), (f"{bp}.conv3.bn", blk.conv3_ln, None)]
            if blk.downsample is not None:
                plan += [(f"{bp}.downsample.conv", blk.downsample, "1x1"),
                         (f"{bp}.downsample.bn", blk.downsample_ln, None)]
    plan.append(("sampler.0", proj.sampler, None))
    plan += [(f"readout.{2 * i}", fc, None) for i, fc in enumerate(proj.readout)]
    return plan


def region_plan(region: RegionProjector) -> Plan:
    """``region_encoder.feat_linear`` Sequential(Linear, GELU, Linear, …)."""
    return [(f"feat_linear.{2 * i}", getattr(region, f"fc{2 * i}"), None)
            for i in range(region.cfg.depth)]


def text_fcs_plan(text_fcs: TextHiddenFC) -> Plan:
    """``text_hidden_fcs.0`` Sequential(Linear, ReLU, Linear, Dropout)."""
    return [("text_hidden_fcs.0.0", text_fcs.fc0, None), ("text_hidden_fcs.0.2", text_fcs.fc1, None)]


def convert_projector(w: TensorWriter, proj: STCConnector, sd: Mapping) -> None:
    """``mm_projector`` state dict (keys may keep the ``mm_projector.``
    prefix) → ``proj``."""
    plan_from_sd(w, projector_plan(proj), {k.removeprefix("mm_projector."): v for k, v in sd.items()})


def convert_region_encoder(w: TensorWriter, region: RegionProjector, sd: Mapping) -> None:
    plan_from_sd(w, region_plan(region), sd)


def convert_text_hidden_fcs(w: TensorWriter, text_fcs: TextHiddenFC, sd: Mapping) -> None:
    plan_from_sd(w, text_fcs_plan(text_fcs), sd)
