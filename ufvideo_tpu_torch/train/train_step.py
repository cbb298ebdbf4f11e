"""The train step on one device (mirrors ``ufvideo_tpu/train/train_step.py``
``make_optimizer`` / ``freeze_mask`` / ``Batch`` / ``language_model_loss_fn``
/ ``_build_step``; the mesh placement of ``make_train_step`` and the
lowering helpers wait for the parallelism slice, ROADMAP.md).

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
trainable gradients only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.qwen2 import LoRATerm
from ..models.ufvideo import UFVideoModel
from .losses import causal_lm_loss

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
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in gs))
        clip = norm >= self.grad_clip
        count = state["count"]
        inc = count + 1
        b1c, b2c = 1.0 - self.b1 ** inc, 1.0 - self.b2 ** inc
        lrs = {k: s(count) for k, s in self.schedules.items()}
        for (name, p), g in zip(params.items(), gs):
            g = torch.where(clip, (g / norm.to(g.dtype)) * self.grad_clip, g)
            mu = state["mu"][name]
            nu = state["nu"][name]
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
    """The train-mode backbone over spliced embeddings → final hidden."""
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
    ce = causal_lm_loss(model.llm.logits(hidden), batch.labels, cfg.llm.vocab_size)
    loss = cfg.ce_loss_weight * ce
    return loss, {"ce_loss": ce, "loss": loss}


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


def make_train_step(
    model: UFVideoModel,
    optimizer: AdamW,
    loss_fn=language_model_loss_fn,
):
    """(init, step) on the model's device. ``init(params=None)`` takes the
    trainable tensors by name (default: the parameters with
    ``requires_grad``); ``step(state, batch, grad_hook=None)`` is
    ``run_step`` on ``loss_fn(model, batch)``."""

    def init(params: Optional[Params] = None) -> TrainState:
        if params is None:
            params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        return TrainState(0, params, optimizer.init(params))

    def step(state: TrainState, batch, grad_hook=None):
        return run_step(state, optimizer, lambda: loss_fn(model, batch), grad_hook)

    return init, step
