"""The train step (mirrors ``ufvideo_tpu/train/train_step.py``:
``make_optimizer`` / ``freeze_mask`` / ``Batch`` / ``language_model_loss_fn``
/ ``_build_step`` / ``make_train_step`` / ``abstract_train_state`` /
``lower_train_step``), on one device or over a mesh.

Over a mesh (``make_train_step(..., mesh=)``) each rank feeds its own rows
of the global batch (``trainer.shard_order_for_process``), the model is
placed by ``parallel.partition.shard_params`` (FSDP2 units, tensor
parallelism), the losses divide by counts summed over the data ranks and
the gradients are summed over them, so R ranks take exactly the step one
process takes on the same global batch; the metrics are the global ones.

The optimizer is optax's ``chain(clip_by_global_norm(c), adamw(schedule))``
written out in PyTorch, so that a step here and a step there move the same
parameters by the same amounts:

  - one global-norm clip over every trainable gradient, before the learning
    rate groups (``mm_projector_lr`` gives the projector a group of its
    own), scaling by ``max_norm / norm`` when the norm reaches ``max_norm``
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm; this does
    not);
  - Adam moments kept in each parameter's dtype (bf16 at full width), bias
    corrections at the incremented count, ``m̂ / (sqrt(v̂) + eps)``, decayed
    weights added, then the step scaled by ``-lr``;
  - linear warmup from 0 to the peak, then cosine decay to 0, read at the
    count BEFORE its increment: step 0 runs at learning rate 0.

Frozen parameters (``requires_grad`` False, set by ``apply_freeze``) are not
the optimizer's and keep their values; ``grad_norm`` is the norm of the
trainable gradients only. Over a mesh the norm sums each rank's squares of
the elements it holds (an element held by several ranks counted once) over
every rank before the root, so the clip is optax's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.qwen2 import LoRATerm
from ..models.ufvideo import UFVideoModel
from ..parallel.mesh import (BATCH_SPEC, PIPE_AXIS, TENSOR_AXIS, axis_coordinate, axis_sizes,
                             spec_axes)
from ..parallel.partition import (DEFAULT_RULES, ShapeDtype, is_dtensor, jax_shapes, load_full,
                                  local, replication, shard_params, shardings_for)
from .losses import causal_lm_loss, global_counts, lm_targets, token_ce

Params = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """``params``: the trainable tensors by name (the optimizer's view; the
    model holds them). ``lora``: the LoRA factors, for a LoRA finetune."""

    step: int
    params: Params
    opt_state: Dict[str, Any]
    lora: Optional[Dict[str, Dict[str, torch.Tensor]]] = None


def warmup_cosine(peak: float, warmup: int, total: int) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup, total, 0)``."""

    def schedule(count: int) -> float:
        if count < warmup:
            return -peak * (1.0 - min(count, warmup) / warmup) + peak
        t = min(count - warmup, total - warmup)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / (total - warmup)))

    return schedule


@dataclass
class AdamW:
    """optax ``chain(clip_by_global_norm, adamw)`` with an optional separate
    projector group (``make_optimizer``). The group of a parameter is read
    from its name's first component, as optax's label function reads the
    tree's top-level key."""

    lr: float
    warmup: int
    total_steps: int
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    mm_projector_lr: Optional[float] = None
    schedules: Dict[str, Callable[[int], float]] = field(init=False)

    def __post_init__(self):
        self.schedules = {"base": warmup_cosine(self.lr, self.warmup, self.total_steps)}
        if self.mm_projector_lr is not None:
            self.schedules["projector"] = warmup_cosine(
                self.mm_projector_lr, self.warmup, self.total_steps)

    def group(self, name: str) -> str:
        top = name.split(".", 1)[0]
        return "projector" if top == "projector" and "projector" in self.schedules else "base"

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Params, grads: Params, state: Dict[str, Any]) -> torch.Tensor:
        """One step, in place on ``params`` and ``state``; returns the global
        norm of ``grads`` (before the clip)."""
        gs = [grads[n] for n in params]
        # each rank's elements, those held by several ranks counted once
        # (another pipeline stage's layers are held there, not here)
        sq = sum((local(g).float() ** 2).sum() / replication(p)
                 for p, g in zip(params.values(), gs) if not p.is_meta)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.all_reduce(sq)
        norm = torch.sqrt(sq)
        clip = norm >= self.grad_clip
        count = state["count"]
        inc = count + 1
        b1c, b2c = 1.0 - self.b1 ** inc, 1.0 - self.b2 ** inc
        lrs = {k: s(count) for k, s in self.schedules.items()}
        for (name, p), g in zip(params.items(), gs):
            if p.is_meta:  # another pipeline stage's layer
                continue
            p, g = local(p), local(g)
            g = torch.where(clip, (g / norm.to(g.dtype)) * self.grad_clip, g)
            mu = local(state["mu"][name])
            nu = local(state["nu"][name])
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / b1c) / (torch.sqrt(nu / b2c) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * torch.tensor(-lrs[self.group(name)], dtype=u.dtype))
        state["count"] = inc
        return norm


def make_optimizer(
    lr: float = 2e-5,
    *,
    warmup_ratio: float = 0.03,
    total_steps: int = 10_000,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    grad_clip: float = 1.0,
    mm_projector_lr: Optional[float] = None,
) -> AdamW:
    """AdamW + linear-warmup cosine with a global clip (lr 2e-5, warmup
    0.03, clip 1.0: the reference's schedule); ``mm_projector_lr`` gives the
    projector its own learning rate."""
    return AdamW(lr, max(int(total_steps * warmup_ratio), 1), total_steps, weight_decay,
                 b1, b2, grad_clip=grad_clip, mm_projector_lr=mm_projector_lr)


def freeze_mask(
    model: UFVideoModel,
    frozen_top_keys=("vision", "sam"),
    train_sam_mask_decoder: bool = True,
) -> Dict[str, bool]:
    """Trainable flag of every parameter by name, the reference's policy:
    the vision tower and SAM2 frozen, but SAM2's ``sam_mask_decoder`` when
    ``train_sam_mask_decoder`` (the reference's default); the projector, the
    region encoder, ``text_fcs`` and the LLM trainable."""
    out = {}
    for name, p in model.named_parameters():
        top, _, rest = name.partition(".")
        if top not in frozen_top_keys:
            out[name] = True
        else:
            out[name] = (top == "sam" and train_sam_mask_decoder
                         and rest.split(".", 1)[0] == "sam_mask_decoder")
    return out


def apply_freeze(model: UFVideoModel, mask: Dict[str, bool]) -> Params:
    """Set ``requires_grad`` from ``mask``; returns the trainable parameters
    by name, in the model's order."""
    trainable = {}
    for name, p in model.named_parameters():
        p.requires_grad_(bool(mask[name]))
        if mask[name]:
            trainable[name] = p
    return trainable


class Batch(NamedTuple):
    """One spliced multimodal training batch (static shapes)."""

    pixels: torch.Tensor  # [B, T, H, W, 3]
    text_ids: torch.Tensor  # [B, Tt]
    src_kind: torch.Tensor  # [B, S]
    src_idx: torch.Tensor  # [B, S]
    seq_lens: torch.Tensor  # [B]
    labels: torch.Tensor  # [B, S]


def llm_forward(model: UFVideoModel, embeds: torch.Tensor, seq_lens: torch.Tensor,
                lora: Optional[LoRATerm] = None) -> torch.Tensor:
    """The train-mode backbone over spliced embeddings → final hidden (this
    rank's block of the sequence under ring attention)."""
    b, s, _ = embeds.shape
    positions = torch.arange(s, dtype=torch.int32, device=embeds.device).expand(b, s)
    hidden, _ = model.llm.backbone(embeds, positions, seq_lens, None, None, "train", lora)
    return hidden


def language_model_loss_fn(
    model: UFVideoModel, batch: Batch, lora: Optional[LoRATerm] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The CE part of the reference loss; ``lora`` adds the adapters."""
    cfg = model.cfg
    video_feats = model.encode_video_train(batch.pixels)
    embeds = model.splice_embeds_train(
        batch.text_ids, batch.src_kind, batch.src_idx, video_feats, None)
    hidden = llm_forward(model, embeds, batch.seq_lens, lora)
    if model.llm.ring is None:
        ce = causal_lm_loss(model.llm.logits(hidden), batch.labels, cfg.llm.vocab_size)
    else:  # this rank's block of the positions and of their targets
        ce = token_ce(model.llm.logits(hidden), model.llm.seq_block(lm_targets(batch.labels)),
                      cfg.llm.vocab_size)
    loss = cfg.ce_loss_weight * ce
    return loss, {"ce_loss": ce, "loss": loss}


def model_param_name(name: str) -> str:
    """The model's parameter behind a trainable's name (a LoRA state names
    the non-LoRA trainables ``non_lora.<name>``)."""
    return name.split(".", 1)[1] if name.startswith("non_lora.") else name


def grads_of(params: Params) -> Params:
    """Each trainable tensor's gradient (zeros where autograd left none)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()}


def run_step(state: TrainState, optimizer: AdamW, loss_of, grad_hook=None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Forward and backward of ``loss_of()`` → (loss, metrics), then the
    clipped update of ``state.params`` in place. Metrics come back as 0-d
    tensors on the device (``grad_norm`` included); ``grad_hook``, when
    given, sees the gradients by name before the update."""
    for p in state.params.values():
        p.grad = None
    loss, metrics = loss_of()
    loss.backward()
    grads = grads_of(state.params)
    if grad_hook is not None:
        grad_hook(grads)
    norm = optimizer.update(state.params, grads, state.opt_state)
    for p in state.params.values():
        p.grad = None
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = norm
    state.step += 1
    return state, metrics


class MeshStep:
    """The step's placement over a mesh: the model sharded once
    (``shard_state``), this rank's rows checked, counts and metrics summed
    over the data ranks (a tensor-parallel group and the pipeline stages
    hold the same rows, so world sums are divided by their size). Under a
    pipeline another stage's layers are ``meta`` tensors here: no gradient,
    no moment, no update."""

    def __init__(self, model: UFVideoModel, mesh, batch_spec=None):
        self.model, self.mesh = model, mesh
        self.spec = BATCH_SPEC if batch_spec is None else batch_spec
        sizes = axis_sizes(mesh)
        self.tp = sizes.get(TENSOR_AXIS, 1)
        # ranks holding the same rows: a tensor-parallel group, pipeline stages
        self.replicas = self.tp * sizes.get(PIPE_AXIS, 1)
        self.data_rank, self.data_size = axis_coordinate(mesh, spec_axes(self.spec))
        self.root = None

    def shard_state(self, state: TrainState) -> TrainState:
        """Shard the model (once) and move ``state`` onto its parameters:
        each trainable tensor becomes the sharded parameter of that name and
        each moment this rank's part of it (LoRA factors stay whole on
        every rank)."""
        if self.root is None:
            self.root = shard_params(self.model, self.mesh)
        named = dict(self.model.named_parameters())
        params, mu, nu = {}, {}, {}
        for n, old in state.params.items():
            key = model_param_name(n)
            params[n] = named.get(key, old)
            for dst, src in ((mu, state.opt_state["mu"]), (nu, state.opt_state["nu"])):
                dst[n] = torch.zeros_like(params[n])
                if params[n] is not old:
                    load_full(self.model, key, dst[n], src[n])
                else:
                    dst[n].copy_(src[n])
        state.params = params
        state.opt_state.update(mu=mu, nu=nu)
        return state

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        if dist.get_world_size() == 1:
            return x
        y = x.clone()
        dist.all_reduce(y)
        if self.replicas == 1:
            return y
        return y // self.replicas if not y.is_floating_point() else y / self.replicas

    def check_rows(self, batch) -> None:
        """Every row-leading leaf holds this rank's rows, the same count in
        each (their global count is that times the data ranks)."""
        rows = {t.shape[0] for t in batch if torch.is_tensor(t) and t.ndim >= 1}
        if len(rows) > 1:
            raise ValueError(f"this rank's batch leaves hold different row counts "
                             f"{sorted(rows)}; each must hold the rank's rows of the "
                             f"global batch ({self.data_size} data ranks)")

    def run(self, state: TrainState, optimizer: AdamW, loss_of, grad_hook=None):
        """``run_step`` with ``loss_of(root)`` under global counts, the
        replicated trainables' gradients summed, the metrics made global."""
        if self.root is None:
            raise RuntimeError("shard_state(state) first: the model is not placed on the mesh")
        for p in state.params.values():
            p.grad = None
        with global_counts(self.sum_over_data):
            loss, metrics = loss_of(self.root)
        loss.backward()
        grads = grads_of(state.params)
        for n, g in grads.items():
            if not is_dtensor(state.params[n]) and not g.is_meta:
                grads[n] = self.sum_over_data(g)
        if grad_hook is not None:
            grad_hook(grads)
        norm = optimizer.update(state.params, grads, state.opt_state)
        for p in state.params.values():
            p.grad = None
        metrics = {k: self.sum_over_data(v.detach()) for k, v in metrics.items()}
        metrics["grad_norm"] = norm
        state.step += 1
        return state, metrics


def make_train_step(
    model: UFVideoModel,
    optimizer: AdamW,
    loss_fn=language_model_loss_fn,
    *,
    mesh=None,
    batch_spec=None,
):
    """(init, step) on the model's device. ``init(params=None)`` takes the
    trainable tensors by name (default: the parameters with
    ``requires_grad``); ``step(state, batch, grad_hook=None)`` is
    ``run_step`` on ``loss_fn(model, batch)``.

    With ``mesh`` (a ``DeviceMesh`` from ``parallel.create_mesh``) it
    returns (init, step, shard_state), as the JAX package does: freeze,
    ``init``, then ``shard_state`` places the model and the state, and
    ``step`` takes this rank's rows. ``batch_spec`` names the axes that
    split the rows (default ``BATCH_SPEC``, over data and fsdp; ``P('data')``
    when fsdp splits the sequence for ring attention)."""

    def init(params: Optional[Params] = None) -> TrainState:
        if params is None:
            params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        return TrainState(0, params, optimizer.init(params))

    if mesh is None:
        def step(state: TrainState, batch, grad_hook=None):
            return run_step(state, optimizer, lambda: loss_fn(model, batch), grad_hook)

        return init, step

    placed = MeshStep(model, mesh, batch_spec)

    def sharded_step(state: TrainState, batch, grad_hook=None):
        placed.check_rows(batch)
        return placed.run(state, optimizer, lambda root: root(loss_fn, batch), grad_hook)

    return init, sharded_step, placed.shard_state


def abstract_train_state(model: UFVideoModel) -> dict:
    """The train state in the JAX package's tree and layout, as shapes:
    ``step``, ``params`` (``partition.jax_shapes``) and AdamW's two moments
    of every parameter. Build ``model`` on the ``meta`` device
    (``UFVideoModel.empty(cfg, "meta")``) and nothing is allocated, so this
    runs at 7B widths on any host."""
    params = jax_shapes(model)
    return {"step": ShapeDtype((), torch.int32), "params": params,
            "opt_state": {"mu": params, "nu": params}}


def lower_train_step(model: UFVideoModel, mesh, rules=DEFAULT_RULES) -> Tuple[dict, dict]:
    """The state's placement at the model's real widths over ``mesh`` (a
    ``DeviceMesh`` or a ``MeshShape``), without running it: (abstract
    state, spec of each leaf). A rule that does not divide a real width of
    100 MB or more warns here, before any card is asked for it."""
    state = abstract_train_state(model)
    return state, shardings_for(state, mesh, rules)
