"""Parameter sharding rules and their placement on the port's modules
(mirrors ``ufvideo_tpu/parallel/partition.py``).

The rules, the specs and the arithmetic (``partition_specs``,
``shardings_for``, ``audit_shardings``, ``per_chip_state_bytes``) are stated
in the JAX package's terms: keyed by the '/'-joined JAX parameter path and
read against JAX's layout (dense kernels [in, out], scan-stacked layers on a
leading axis, right-aligned specs). ``jax_shapes`` gives that tree for a
port model, on any device (``meta`` included), so the arithmetic runs at
full width on any host.

``shard_params`` turns the rules into placements on the port's [out, in]
weights:

  - tensor parallelism over ``tensor`` (``parallelize_module``): the fused
    qkv projection and gate / up column-wise, o and down row-wise, the
    embedding and ``lm_head`` over the vocabulary. The fused qkv rows are
    reordered before the split so that rank r holds ``[q_r | k_r | v_r]``
    (its own heads); ``full_param`` undoes the order, so checkpoints and
    exports hold the unsharded one. A layer whose heads or MLP width do not
    divide ``tensor`` stays replicated over it, as ``shardings_for`` falls
    back to replication.
  - FSDP2 over (``data``, ``fsdp``): one ``fully_shard`` unit a decoder
    layer and a tower block, and a root unit around the rest. With
    ``data > 1`` the units are HSDP (replicated over ``data``, sharded over
    ``fsdp``), the JAX layout. Each unit shards dimension 0 of its [out, in]
    weights.

Gradients are summed over the data ranks (divide factor 1): the losses
divide by global counts (``train/losses.global_counts``), so the per-rank
parts add up to the one-process loss.
"""

from __future__ import annotations

import math
import re
import warnings
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import DATA_AXIS, FSDP_AXIS, PIPE_AXIS, TENSOR_AXIS, P, axis_sizes

Rules = Sequence[Tuple[str, P]]

# Qwen2: q / k / v and gate / up column-parallel (output over 'tensor'),
# o and down row-parallel (input over 'tensor'), embeddings and lm_head over
# the vocabulary; FSDP shards the other large dimension.
QWEN2_RULES: Rules = (
    (r".*embed_tokens/embedding$", P(TENSOR_AXIS, FSDP_AXIS)),
    (r".*(q_proj|k_proj|v_proj|qkv_proj)/kernel$", P(FSDP_AXIS, TENSOR_AXIS)),
    (r".*(q_proj|k_proj|v_proj|qkv_proj)/bias$", P(TENSOR_AXIS)),
    (r".*o_proj/kernel$", P(TENSOR_AXIS, FSDP_AXIS)),
    (r".*(gate_proj|up_proj)/kernel$", P(FSDP_AXIS, TENSOR_AXIS)),
    (r".*down_proj/kernel$", P(TENSOR_AXIS, FSDP_AXIS)),
    (r".*lm_head/kernel$", P(FSDP_AXIS, TENSOR_AXIS)),
    (r".*norm.*/scale$", P()),
)

# towers, projector, SAM2: FSDP-shard the big matmuls, replicate the rest
VISION_RULES: Rules = (
    (r".*(patch_embed|pos_emb).*", P()),
    (r".*kernel$", P(FSDP_AXIS)),
    (r".*", P()),
)

DEFAULT_RULES: Rules = QWEN2_RULES + VISION_RULES  # VISION_RULES ends in a catch-all


class LeadingSpec(P):
    """A spec that left-aligns against the parameter's dimensions: the
    stacked layer axis (dim 0 of every ``llm/layers`` leaf) over a pipeline
    axis."""


def pipeline_rules(pipe_axis: str = "pipe", rules: Rules = DEFAULT_RULES) -> Rules:
    """Every stacked LLM layer leaf over ``pipe_axis`` by its layer axis;
    the rest keeps ``rules``."""
    return ((r".*llm/layers/.*", LeadingSpec(pipe_axis)),) + tuple(rules)


class ShapeDtype(NamedTuple):
    """A leaf of an abstract tree: shape and dtype, no storage."""

    shape: Tuple[int, ...]
    dtype: Any


def _spec_for(path: str, rules: Rules, ndim: int) -> P:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            parts = tuple(spec)
            if not parts or len(parts) > ndim:
                return P()
            if isinstance(spec, LeadingSpec):
                return P(*(parts + (None,) * (ndim - len(parts))))
            # right-align: stacked layers carry a leading layer axis
            return P(*((None,) * (ndim - len(parts)) + parts))
    return P()


def _is_tree(x) -> bool:
    return isinstance(x, dict)


def _walk(tree, prefix=""):
    """(path, leaf) of a nested dict, depth first in insertion order."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if _is_tree(v):
            yield from _walk(v, path + "/")
        else:
            yield path, v


def _map(fn, tree, prefix=""):
    return {k: (_map(fn, v, f"{prefix}{k}/") if _is_tree(v) else fn(f"{prefix}{k}", v))
            for k, v in tree.items()}


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def partition_specs(params: dict, rules: Rules = DEFAULT_RULES) -> dict:
    """The spec tree mirroring ``params`` (a nested dict keyed like the JAX
    parameter tree; leaves carry ``shape``)."""
    return _map(lambda path, leaf: _spec_for(path, rules, _ndim(leaf)), params)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _divisible(shape, spec: P, sizes) -> bool:
    for dim, entry in zip(shape, tuple(spec)):
        n = math.prod(sizes[a] for a in _axes(entry))
        if dim % n != 0:
            return False
    return True


def _shard_factor(spec: P, sizes) -> int:
    return math.prod(sizes[a] for entry in tuple(spec) for a in _axes(entry))


AUDIT_MIN_BYTES = 100 * 2**20  # flag fully replicated parameters above this


def _itemsize(dtype) -> int:
    if dtype is None:
        return 4
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return int(getattr(dtype, "itemsize", 4))


def _leaf_nbytes(leaf) -> int:
    return int(math.prod(getattr(leaf, "shape", ()))) * _itemsize(getattr(leaf, "dtype", None))


def shardings_for(params: dict, mesh, rules: Rules = DEFAULT_RULES) -> dict:
    """The spec each leaf gets on ``mesh``: its rule's, or replication when
    a dimension does not divide the mesh axes (small adapters, odd head
    counts). A leaf of 100 MB or more that falls back warns."""
    sizes = axis_sizes(mesh)

    def effective(path, leaf):
        spec = _spec_for(path, rules, _ndim(leaf))
        shape = tuple(getattr(leaf, "shape", ()))
        if not _divisible(shape, spec, sizes):
            nbytes = _leaf_nbytes(leaf)
            if nbytes >= AUDIT_MIN_BYTES and _shard_factor(spec, sizes) > 1:
                warnings.warn(
                    f"partition rule {spec} for a {shape} param ({nbytes / 2**20:.0f} MB) "
                    f"does not divide mesh {sizes} — falling back to replication",
                    stacklevel=3)
            return P()
        return spec

    return _map(effective, params)


def audit_shardings(params: dict, mesh, rules: Rules = DEFAULT_RULES, *,
                    min_bytes: int = AUDIT_MIN_BYTES) -> List[Dict[str, Any]]:
    """Every leaf of ``min_bytes`` or more that ends up fully replicated on
    ``mesh``, by rule or by the divisibility fallback: ``path / shape /
    mbytes / requested / reason``. Empty is the deployment invariant."""
    sizes = axis_sizes(mesh)
    findings = []
    for path, leaf in _walk(params):
        nbytes = _leaf_nbytes(leaf)
        if nbytes < min_bytes:
            continue
        shape = tuple(getattr(leaf, "shape", ()))
        spec = _spec_for(path, rules, len(shape))
        divisible = _divisible(shape, spec, sizes)
        if _shard_factor(spec if divisible else P(), sizes) > 1:
            continue
        reason = ("divisibility fallback" if not divisible and _shard_factor(spec, sizes) > 1
                  else "rule requested replication")
        findings.append({"path": path, "shape": shape, "mbytes": round(nbytes / 2**20, 1),
                         "requested": str(spec), "reason": reason})
    return findings


def per_chip_state_bytes(params: dict, mesh, rules: Rules = DEFAULT_RULES) -> int:
    """Bytes of ``params`` (or a whole train state) each chip holds under
    the rule-derived shardings."""
    sizes = axis_sizes(mesh)
    total = 0
    for path, leaf in _walk(params):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = _spec_for(path, rules, len(shape))
        effective = spec if _divisible(shape, spec, sizes) else P()
        total += _leaf_nbytes(leaf) // _shard_factor(effective, sizes)
    return total


# ---------------------------------------------------------------------------
# the port's modules as the JAX tree
# ---------------------------------------------------------------------------

# the SigLIP layer's holders ([in, out], the kernel's layout) by JAX path
_SIGLIP = {"ln1_scale": "layer_norm1/scale", "ln1_bias": "layer_norm1/bias",
           "ln2_scale": "layer_norm2/scale", "ln2_bias": "layer_norm2/bias",
           "qkv_kernel": "self_attn/qkv_proj/kernel", "qkv_bias": "self_attn/qkv_proj/bias",
           "out_kernel": "self_attn/out_proj/kernel", "out_bias": "self_attn/out_proj/bias",
           "fc1_kernel": "mlp/fc1/kernel", "fc1_bias": "mlp/fc1/bias",
           "fc2_kernel": "mlp/fc2/kernel", "fc2_bias": "mlp/fc2/bias"}
_QWEN2 = {"input_layernorm.weight": "input_layernorm/scale",
          "post_attention_layernorm.weight": "post_attention_layernorm/scale",
          "qkv_proj.weight": "self_attn_qkv_proj/kernel",
          "qkv_proj.bias": "self_attn_qkv_proj/bias",
          "o_proj.weight": "self_attn_o_proj/kernel",
          "gate_proj.weight": "mlp_gate_proj/kernel", "up_proj.weight": "mlp_up_proj/kernel",
          "down_proj.weight": "mlp_down_proj/kernel"}
# flax builds the mask-prompt convolutions lazily: a random tree lacks them
_LAZY = ("sam_prompt_encoder.mask_downscaling_",)


def _jax_layout(mod: nn.Module, key: str, shape) -> Tuple[str, Tuple[int, ...]]:
    """(flax leaf name, flax shape) of parameter ``key`` of ``mod``."""
    shape = tuple(shape)
    if key != "weight":
        return key, shape
    if isinstance(mod, nn.ConvTranspose2d):  # [in, out, kh, kw]
        return "kernel", shape[2:] + shape[:2]
    if isinstance(mod, (nn.Conv2d, nn.Conv3d)):  # [out, in, *k]
        return "kernel", shape[2:] + (shape[1], shape[0])
    if len(shape) == 2:
        return "kernel", (shape[1], shape[0])
    return "scale", shape


def _by_name(mod: nn.Module, skip=()) -> dict:
    """A module whose names are the flax names (``blocks.3`` is
    ``blocks_3``) as its JAX tree."""
    out: dict = {}
    for name, sub in mod.named_modules():
        for key, p in sub.named_parameters(recurse=False):
            full = f"{name}.{key}" if name else key
            if full.startswith(skip):
                continue
            parts = re.sub(r"\.(\d+)(?=\.|$)", r"_\1", name).split(".") if name else []
            leaf_key = key
            if isinstance(sub, nn.ParameterList):  # ``embeds.0`` is the leaf ``embeds_0``
                leaf_key = f"{parts.pop()}_{key}"
            flax_key, shape = _jax_layout(sub, leaf_key, p.shape)
            node = out
            for part in parts:
                node = node.setdefault(part, {})
            node[flax_key] = ShapeDtype(shape, p.dtype)
    return out


def _put(tree: dict, path: str, leaf) -> None:
    *parents, last = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[last] = leaf


def _stacked(layers, names: Dict[str, str], transpose: bool) -> dict:
    """Layers as one stacked tree (leading layer axis); ``transpose`` turns
    [out, in] weights into [in, out] kernels."""
    out: dict = {}
    first = dict(layers[0].named_parameters())
    for key, path in names.items():
        p = first[key]
        shape = tuple(p.shape)
        if transpose and len(shape) == 2:
            shape = shape[::-1]
        _put(out, path, ShapeDtype((len(layers),) + shape, p.dtype))
    return out


def _projector_tree(proj) -> dict:
    from ..models.projector import LinearProjector

    def dense(lin):
        t = {"kernel": ShapeDtype(tuple(lin.weight.shape[::-1]), lin.weight.dtype)}
        if lin.bias is not None:
            t["bias"] = ShapeDtype(tuple(lin.bias.shape), lin.bias.dtype)
        return t

    def conv1x1(lin):
        t = dense(lin)
        t["kernel"] = ShapeDtype((1, 1) + t["kernel"].shape, t["kernel"].dtype)
        return t

    def ln(m):
        return {"scale": ShapeDtype(tuple(m.weight.shape), m.weight.dtype),
                "bias": ShapeDtype(tuple(m.bias.shape), m.bias.dtype)}

    if isinstance(proj, LinearProjector):
        return {f"fc{2 * i}": dense(fc) for i, fc in enumerate(proj.fcs)}
    out: dict = {}
    for stage, name in ((proj.s1, "s1"), (proj.s2, "s2")):
        if stage is None:
            continue
        for i, blk in enumerate(stage.blocks):
            t = {"conv1": conv1x1(blk.conv1), "conv1_ln": ln(blk.conv1_ln),
                 "conv2": {"kernel": ShapeDtype(_jax_layout(blk.conv2, "weight",
                                                            blk.conv2.weight.shape)[1],
                                                blk.conv2.weight.dtype)},
                 "conv2_ln": ln(blk.conv2_ln), "se_fc1": conv1x1(blk.se_fc1),
                 "se_fc2": conv1x1(blk.se_fc2), "conv3": conv1x1(blk.conv3),
                 "conv3_ln": ln(blk.conv3_ln)}
            if blk.downsample is not None:
                t["downsample"] = conv1x1(blk.downsample)
                t["downsample_ln"] = ln(blk.downsample_ln)
            out.setdefault(name, {})[f"b{i + 1}"] = t
    if proj.sampler is not None:
        w = proj.sampler.weight
        out["sampler"] = {"kernel": ShapeDtype(_jax_layout(proj.sampler, "weight", w.shape)[1],
                                               w.dtype),
                          "bias": ShapeDtype(tuple(proj.sampler.bias.shape), w.dtype)}
    out["readout"] = {f"fc{2 * i}": dense(fc) for i, fc in enumerate(proj.readout)}
    return out


def jax_shapes(model) -> dict:
    """The JAX package's parameter tree of ``model`` (a float
    ``UFVideoModel`` on any device, ``meta`` included) as ``ShapeDtype``
    leaves: the tree ``UFVideoModel.init_params`` makes, plus ``sam``."""
    if model.cfg.quant_llm or model.cfg.quant_vision:
        raise ValueError("jax_shapes covers the float model; a quantised runtime "
                         "is not trained or sharded")
    v = model.vision
    pe = v.patch_embedding.weight  # [C, p·p·3]
    patch = model.cfg.vision.patch_size
    vision = {"patch_embedding_kernel": ShapeDtype((patch, patch, 3, pe.shape[0]), pe.dtype),
              "patch_embedding_bias": ShapeDtype(tuple(v.patch_embedding.bias.shape), pe.dtype),
              "position_embedding": ShapeDtype(tuple(v.position_embedding.shape), pe.dtype),
              "layers": _stacked(v.layers, _SIGLIP, False)}
    lm = model.llm
    llm = {"embed_tokens": {"embedding": ShapeDtype(tuple(lm.embed_tokens.weight.shape),
                                                    lm.embed_tokens.weight.dtype)},
           "layers": _stacked(lm.layers, _QWEN2, True),
           "norm": {"scale": ShapeDtype(tuple(lm.norm.weight.shape), lm.norm.weight.dtype)},
           "lm_head": {"kernel": ShapeDtype(tuple(lm.lm_head.weight.shape[::-1]),
                                            lm.lm_head.weight.dtype)}}
    return {"vision": vision, "projector": _projector_tree(model.projector), "llm": llm,
            "text_fcs": _by_name(model.text_fcs), "region": _by_name(model.region),
            "sam": _by_name(model.sam, skip=_LAZY)}


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

class ShardedModel(nn.Module):
    """The root FSDP unit around a model: ``root(fn, *args)`` runs
    ``fn(model, *args)`` with the parameters outside the per-layer units
    gathered, and their gradients reduced in the backward."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(self.model, *args, **kwargs)


def qkv_rank_order(nq: int, nkv: int, tp: int) -> torch.Tensor:
    """Row order of the fused [q | k | v] weight that puts each rank's heads
    together: ``[q_0 | k_0 | v_0 | q_1 | k_1 | v_1 | ...]``."""
    q, k, v = torch.arange(nq), torch.arange(nq, nq + nkv), torch.arange(nq + nkv, nq + 2 * nkv)
    return torch.cat([torch.cat([q.chunk(tp)[r], k.chunk(tp)[r], v.chunk(tp)[r]])
                      for r in range(tp)])


def _tensor_parallel(model, mesh) -> None:
    """``QWEN2_RULES``' layout over ``mesh["tensor"]``: column-parallel where
    a kernel's output is over 'tensor', row-parallel where its input is."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (ColwiseParallel, RowwiseParallel,
                                                   parallelize_module)

    cfg = model.llm.cfg
    tp_mesh = mesh[TENSOR_AXIS]
    tp = tp_mesh.size()
    attn = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    mlp = cfg.intermediate_size % tp == 0
    vocab = cfg.padded_vocab_size % tp == 0
    perms = model.__dict__.setdefault("tp_row_order", {})
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    for i, layer in enumerate(model.llm.layers):
        plan = {}
        if attn:
            order = qkv_rank_order(nq, nkv, tp).to(layer.qkv_proj.weight.device)
            with torch.no_grad():
                for key in ("weight", "bias"):
                    t = getattr(layer.qkv_proj, key)
                    t.copy_(t[order])
                    perms[f"llm.layers.{i}.qkv_proj.{key}"] = order
            plan.update({"qkv_proj": ColwiseParallel(), "o_proj": RowwiseParallel()})
            layer.tp = tp
        if mlp:
            plan.update({"gate_proj": ColwiseParallel(), "up_proj": ColwiseParallel(),
                         "down_proj": RowwiseParallel()})
        if plan:
            parallelize_module(layer, tp_mesh, plan)
    if vocab:
        parallelize_module(model.llm, tp_mesh, {
            "embed_tokens": RowwiseParallel(input_layouts=Replicate(),
                                            output_layouts=Replicate()),
            "lm_head": ColwiseParallel(output_layouts=Replicate()),
        })
    skipped = [k for k, v in (("attention", attn), ("mlp", mlp), ("vocab", vocab)) if not v]
    if skipped:
        warnings.warn(f"tensor parallelism over {tp} ranks leaves {skipped} replicated "
                      "over 'tensor' (the widths do not divide it)", stacklevel=3)


def fsdp_units(model) -> List[nn.Module]:
    """The per-layer FSDP units: each Qwen2 decoder layer, each SigLIP
    layer, and each Hiera block when no routed stage reads several blocks'
    weights in one call."""
    units = list(model.llm.layers) + list(model.vision.layers)
    trunk = model.sam.image_encoder_trunk
    if all(len(g) == 1 for g in trunk.groups):
        units += list(trunk.blocks)
    return units


def _keep_stage_layers(model, mesh) -> None:
    """Under a pipeline, this stage's decoder layers keep their storage and
    the others move to the ``meta`` device (shapes and names only): a stage
    holds its L/p layers, as JAX's layer axis over ``pipe`` does."""
    from .pipeline import stage_range

    group = mesh.get_group(PIPE_AXIS)
    stages, layers = dist.get_world_size(group), model.llm.layers
    own = stage_range(len(layers), stages, dist.get_rank(group))
    device = next(layers[own[0]].parameters()).device
    for i, layer in enumerate(layers):
        if i not in own:
            layer.to_empty(device="meta")
    model.__dict__["pipe_stages"] = (group, len(layers) // stages, device)


def shard_params(model, mesh) -> ShardedModel:
    """Place ``model``'s parameters on ``mesh`` (tensor parallelism, a
    pipeline stage's layers, then FSDP2 / HSDP units) and return the root
    unit. Freeze before this (``requires_grad``): each unit reads its
    parameters' flags once."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

    sizes = axis_sizes(mesh)
    if sizes.get(TENSOR_AXIS, 1) > 1:
        _tensor_parallel(model, mesh)
    if sizes.get(PIPE_AXIS, 1) > 1 and model.llm.pipe is not None:
        _keep_stage_layers(model, mesh)
    dp_mesh = mesh[DATA_AXIS, FSDP_AXIS] if sizes[DATA_AXIS] > 1 else mesh[FSDP_AXIS]
    for unit in fsdp_units(model):
        if not next(unit.parameters()).is_meta:
            fully_shard(unit, mesh=dp_mesh)
    root = ShardedModel(model)
    other_stages = {p for p in model.parameters() if p.is_meta}
    fully_shard(root, mesh=dp_mesh, **({"ignored_params": other_stages} if other_stages else {}))
    for m in root.modules():
        if isinstance(m, FSDPModule):
            m.set_gradient_divide_factor(1.0)
            if hasattr(m, "set_force_sum_reduction_for_comms"):
                m.set_force_sum_reduction_for_comms(True)  # a plain SUM (gloo has no PREMUL_SUM)
    if "pipe_stages" in model.__dict__:
        for p in model.llm.layers.parameters():
            p.pipe_stages = sizes[PIPE_AXIS]  # held by one stage (``replication``)
    model.__dict__["sharded_root"] = root  # not a submodule: no cycle
    return root


def sharded_root(model):
    """The root unit ``shard_params`` made for ``model``, or None."""
    return model.__dict__.get("sharded_root")


# ---------------------------------------------------------------------------
# sharded tensors
# ---------------------------------------------------------------------------

def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a tensor (itself when not distributed)."""
    return t.to_local() if is_dtensor(t) else t


def replication(t: torch.Tensor) -> int:
    """On how many ranks of the world each element of parameter ``t`` lives
    (a pipeline stage's layer: on that stage's ranks only)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not is_dtensor(t):
        return world
    mesh = t.device_mesh
    rep = world // mesh.size() // getattr(t, "pipe_stages", 1)
    for dim, placement in enumerate(t.placements):
        if placement.is_replicate():
            rep *= mesh.size(dim)
    return rep


def _order(model, name: str):
    return getattr(model, "tp_row_order", {}).get(name)


def _stage_of(model, name: str):
    """(pipe group, owning stage) of a decoder layer's tensor under a
    pipeline that keeps each layer on one stage, else None."""
    info = model.__dict__.get("pipe_stages")
    m = re.match(r"llm\.layers\.(\d+)\.", name)
    if info is None or m is None:
        return None
    group, per, _ = info
    return group, int(m.group(1)) // per


def full_param(model, name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of parameter ``name`` (or of a moment of it) in the
    unsharded row order; a collective on every rank when ``t`` is
    distributed (a pipeline stage's layer comes from its stage)."""
    stage = _stage_of(model, name)
    if stage is not None:
        group, owner = stage
        if t.is_meta:
            full = torch.empty(t.shape, dtype=t.dtype, device=model.__dict__["pipe_stages"][2])
        else:
            full = (t.full_tensor() if is_dtensor(t) else t).contiguous()
        dist.broadcast(full, dist.get_global_rank(group, owner), group=group)
    else:
        full = t.full_tensor() if is_dtensor(t) else t
    order = _order(model, name)
    if order is not None:
        full = full[torch.argsort(order.to(full.device))]
    return full


@torch.no_grad()
def load_full(model, name: str, t: torch.Tensor, full: torch.Tensor) -> None:
    """Copy the whole tensor ``full`` (unsharded row order) into ``t``, this
    rank's part only when ``t`` is distributed (nothing into another
    stage's layer)."""
    from torch.distributed.tensor import distribute_tensor

    if t.is_meta:
        return
    full = full.to(device=local(t).device, dtype=t.dtype)
    order = _order(model, name)
    if order is not None:
        full = full[order.to(full.device)]
    if is_dtensor(t):
        part = distribute_tensor(full, t.device_mesh, t.placements).to_local()
        t.to_local().copy_(part)
    else:
        t.copy_(full)
