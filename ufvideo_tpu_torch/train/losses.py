"""Training losses (mirrors ``ufvideo_tpu/train/losses.py``).

Weighted next-token CE, the scaled dice loss (scale 1000) and the sigmoid
CE per-mask mean, aggregated over a flat masked batch of masks with the
bce 2.0 / dice 0.5 weights. Every reduction runs in float32; masks carry
validity, so padded objects and frames contribute exactly zero.

Each loss divides by a count over the whole global batch, as the JAX
package's global mean does: under ``global_counts`` (the sharded train
step) the counts of the valid tokens and of the valid masks are summed over
every data rank, so each rank's loss is its part of the one-process loss
and the parts add up to it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..constants import IGNORE_INDEX


_COUNT_REDUCE: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@contextlib.contextmanager
def global_counts(reduce: Callable[[torch.Tensor], torch.Tensor]):
    """Take every loss's normaliser through ``reduce`` (a sum over the data
    ranks) while the context is open."""
    global _COUNT_REDUCE
    prev, _COUNT_REDUCE = _COUNT_REDUCE, reduce
    try:
        yield
    finally:
        _COUNT_REDUCE = prev


def global_count(x: torch.Tensor) -> torch.Tensor:
    return x if _COUNT_REDUCE is None else _COUNT_REDUCE(x)


def lm_targets(labels: torch.Tensor) -> torch.Tensor:
    """The label each position's logits score: ``labels`` shifted left by
    one, ``IGNORE_INDEX`` at the end (a sequence block's targets are this
    tensor's block)."""
    pad = labels.new_full((labels.shape[0], 1), IGNORE_INDEX)
    return torch.cat([labels[:, 1:], pad], dim=1)


def token_ce(
    logits: torch.Tensor,  # [B, S, V]
    targets: torch.Tensor,  # [B, S] with IGNORE_INDEX
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """Mean CE of ``logits`` against ``targets`` over the non-ignored ones;
    padding ids of the vocabulary are masked out of the softmax."""
    logits = logits.float()
    targets = targets.long()
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, torch.finfo(torch.float32).min)
    valid = targets != IGNORE_INDEX
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, targets, 0)[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / global_count(valid.sum()).clamp_min(1)


def causal_lm_loss(
    logits: torch.Tensor,  # [B, S, V] (possibly padded vocabulary)
    labels: torch.Tensor,  # [B, S] with IGNORE_INDEX
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """Next-token CE with the HF-style internal shift (logits at t score the
    label at t + 1), a mean over non-ignored targets."""
    return token_ce(logits[:, :-1], labels[:, 1:], vocab_size)


def dice_loss(
    inputs: torch.Tensor,  # [N, H, W] mask logits
    targets: torch.Tensor,  # [N, H, W] binary
    num_masks,
    scale: float = 1000.0,
    eps: float = 1e-6,
    valid: Optional[torch.Tensor] = None,  # [N] bool
) -> torch.Tensor:
    probs = torch.sigmoid(inputs.float()).reshape(inputs.shape[0], -1)
    t = targets.float().reshape(targets.shape[0], -1)
    numerator = 2.0 * (probs / scale * t).sum(dim=-1)
    denominator = (probs / scale).sum(dim=-1) + (t / scale).sum(dim=-1)
    loss = 1.0 - (numerator + eps) / (denominator + eps)
    if valid is not None:
        loss = torch.where(valid, loss, 0.0)
    return loss.sum() / (num_masks + 1e-8)


def sigmoid_ce_loss(
    inputs: torch.Tensor,  # [N, H, W] mask logits
    targets: torch.Tensor,  # [N, H, W] binary
    num_masks,
    valid: Optional[torch.Tensor] = None,  # [N] bool
) -> torch.Tensor:
    x = inputs.float()
    t = targets.float()
    per_el = x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    per_mask = per_el.reshape(per_el.shape[0], -1).mean(dim=-1)
    if valid is not None:
        per_mask = torch.where(valid, per_mask, 0.0)
    return per_mask.sum() / (num_masks + 1e-8)


def combined_mask_loss(
    pred_masks: torch.Tensor,  # [N, H, W] logits
    gt_masks: torch.Tensor,  # [N, H, W]
    valid: torch.Tensor,  # [N] bool
    bce_weight: float = 2.0,
    dice_weight: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted bce, weighted dice): the per-sample scaling by ground-truth
    count and the final num_masks normalisation cancel into one masked
    mean over the flat batch."""
    num = global_count(valid.float().sum())
    bce = sigmoid_ce_loss(pred_masks, gt_masks, num, valid=valid)
    dce = dice_loss(pred_masks, gt_masks, num, valid=valid)
    return bce_weight * bce, dice_weight * dce
