"""The full multimodal + segmentation training loss (mirrors
``ufvideo_tpu/train/seg_step.py``): weighted CE over the spliced sequence,
plus sigmoid-CE + dice on SAM2 masks decoded from the ``[SEG]`` hidden
states. Object and frame slots are static with validity masks, so the
reference's per-sample loops become flat masked batches.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..models.qwen2 import LoRATerm
from ..models.sam2.video import sam_train_masks
from ..models.ufvideo import UFVideoModel, grad_unless_frozen
from ..ops.interp import resize_hw
from .losses import causal_lm_loss, combined_mask_loss
from .train_step import language_model_loss_fn, llm_forward


class SegBatch(NamedTuple):
    """Collator output for seg-enabled training (static shapes)."""

    pixels: torch.Tensor  # [B, T, H, W, 3]
    text_ids: torch.Tensor
    src_kind: torch.Tensor
    src_idx: torch.Tensor
    seq_lens: torch.Tensor
    labels: torch.Tensor  # [B, S]
    images_sam: torch.Tensor  # [B, Ts, S, S, 3]
    gt_masks: torch.Tensor  # [B, n_obj, Ts, Hg, Wg]
    obj_valid: torch.Tensor  # [B, n_obj] bool
    region_frames: Optional[torch.Tensor] = None
    region_masks: Optional[torch.Tensor] = None
    region_frame_valid: Optional[torch.Tensor] = None
    region_segments: Optional[torch.Tensor] = None


def select_seg_hidden(
    hidden: torch.Tensor,  # [B, S, D]
    labels: torch.Tensor,  # [B, S]
    seg_token_id: int,
    max_objects: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hidden states at the positions whose NEXT label is ``[SEG]`` (the
    left-shifted seg mask), first positions first, padded to
    ``max_objects`` a sample → ([B, n_obj, D], [B, n_obj] validity)."""
    b, s, d = hidden.shape
    seg_mask = torch.cat(
        [labels[:, 1:] == seg_token_id,
         torch.zeros((b, 1), dtype=torch.bool, device=labels.device)], dim=1)
    order = torch.argsort((~seg_mask).to(torch.int8), dim=1, stable=True)[:, :max_objects]
    picked = torch.gather(hidden, 1, order[..., None].expand(-1, -1, d))
    return picked, torch.gather(seg_mask, 1, order)


def segmentation_loss_fn(
    model: UFVideoModel,
    batch: SegBatch,
    lora: Optional[LoRATerm] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    cfg = model.cfg
    if model.llm.ring is not None:
        raise ValueError("the [SEG] loss reads hidden states across the whole sequence: "
                         "train it without ring attention")
    sam = model.sam
    b = batch.pixels.shape[0]
    n_obj = batch.obj_valid.shape[1]
    ts = batch.images_sam.shape[1]

    # ---- language side ----
    video_feats = model.encode_video_train(batch.pixels)
    region_feats = None
    if batch.region_frames is not None:
        region_feats, _ = model.encode_regions_train(
            batch.region_frames, batch.region_masks, batch.region_frame_valid,
            batch.region_segments)
    embeds = model.splice_embeds_train(
        batch.text_ids, batch.src_kind, batch.src_idx, video_feats, region_feats)
    hidden = llm_forward(model, embeds, batch.seq_lens, lora)
    ce = causal_lm_loss(model.llm.logits(hidden), batch.labels, cfg.llm.vocab_size)

    # ---- [SEG] → SAM2 decode ----
    seg_hidden, seg_valid = select_seg_hidden(hidden, batch.labels, cfg.seg_token_id, n_obj)
    seg_embed = model.seg_embeddings_train(seg_hidden)  # [B, n_obj, C]

    # SAM image encode of the flat (B·Ts) frames; a frozen encoder runs
    # without a graph
    ss = cfg.sam.hiera.image_size
    with grad_unless_frozen(sam.image_encoder_trunk, sam.image_encoder_neck, sam.conv_s0,
                            sam.conv_s1):
        enc = sam.forward_image(batch.images_sam.reshape(b * ts, ss, ss, 3))
    s0, s1, s2 = enc["backbone_fpn"]

    def tile_objs(x):
        # [B·Ts, ...] → [B, n_obj, Ts, ...] → flat rows
        shape = tuple(x.shape[1:])
        x = x.reshape((b, 1, ts) + shape).expand((b, n_obj, ts) + shape)
        return x.reshape((b * n_obj * ts,) + shape)

    lang_rows = seg_embed.reshape(b * n_obj, 1, -1).repeat_interleave(ts, dim=0)
    high_res = sam_train_masks(sam, tile_objs(s0), tile_objs(s1), tile_objs(s2), lang_rows)

    gh, gw = batch.gt_masks.shape[-2:]
    pred = resize_hw(high_res.float(), gh, gw, "bilinear")[:, 0]
    gt = batch.gt_masks.reshape(b * n_obj * ts, gh, gw)
    mask_valid = (batch.obj_valid & seg_valid).reshape(-1).repeat_interleave(ts)

    bce, dice = combined_mask_loss(
        pred, gt, mask_valid,
        bce_weight=cfg.bce_loss_weight, dice_weight=cfg.dice_loss_weight)
    mask_loss = bce + dice
    loss = cfg.ce_loss_weight * ce + mask_loss
    return loss, {
        "loss": loss,
        "ce_loss": ce,
        "mask_bce_loss": bce,
        "mask_dice_loss": dice,
        "mask_loss": mask_loss,
    }


def make_seg_loss_fn():
    """The step's loss for a mixed data stream: ``segmentation_loss_fn`` on
    a ``SegBatch``, the CE loss on a ``Batch`` (no SAM branch)."""

    def fn(model: UFVideoModel, batch, lora: Optional[LoRATerm] = None):
        if isinstance(batch, SegBatch):
            return segmentation_loss_fn(model, batch, lora)
        return language_model_loss_fn(model, batch, lora)

    return fn
