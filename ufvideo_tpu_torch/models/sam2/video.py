"""SAM2 video propagation (mirrors ``ufvideo_tpu/models/sam2/video.py``) for
the UFVideo usage pattern: one conditioning frame (frame 0, prompted by the
``[SEG]`` language embeddings), then forward propagation. The memory
selection collapses to

  - mask memory bank = conditioning frame 0 + a ring of the last 6 frames,
  - object pointers = conditioning frame 0 + a ring of the last 15 frames
    (past only, no temporal position encoding),

so the state has a fixed shape and the frames are walked by a Python loop.
All frames are encoded up front, in chunks.

The general predictor (several prompted frames, temporal stride, reverse
tracking), batched multi-video propagation and the training decode path are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ...ops.interp import resize_hw
from .model import SAM2


class VideoState(NamedTuple):
    """Propagation state. B = number of tracked objects."""

    cond_mem: torch.Tensor  # [B, HW, mem_dim] frame-0 memory
    cond_ptr: torch.Tensor  # [B, C] frame-0 object pointer
    mem_bank: torch.Tensor  # [6, B, HW, mem_dim] newest-first ring
    ptr_bank: torch.Tensor  # [15, B, C] newest-first ring


class FrameFeatures(NamedTuple):
    """Per-frame image-encoder outputs, stacked over time (NHWC)."""

    s0: torch.Tensor  # [T, 4H, 4W, C/8] (after conv_s0)
    s1: torch.Tensor  # [T, 2H, 2W, C/4] (after conv_s1)
    s2: torch.Tensor  # [T, H, W, C]
    pos2: torch.Tensor  # [H, W, C] sine embedding of the top level, same for every frame


@torch.no_grad()
def encode_video_frames(model: SAM2, images: torch.Tensor, chunk: int = 8) -> FrameFeatures:
    """Encode all T frames [T, S, S, 3] through Hiera + FPN, ``chunk`` frames
    at a time to bound activation memory."""
    outs, pos2 = [], None
    for start in range(0, images.shape[0], chunk):
        out = model.forward_image(images[start:start + chunk])
        outs.append(out["backbone_fpn"])
        pos2 = out["vision_pos_enc"][2][0]
    s0, s1, s2 = (torch.cat([o[i] for o in outs], dim=0) for i in range(3))
    return FrameFeatures(s0, s1, s2, pos2)


def _broadcast_obj(x: torch.Tensor, b: int) -> torch.Tensor:
    """Share one frame's features across the object batch."""
    return x[None].expand((b,) + tuple(x.shape))


@torch.no_grad()
def _condition_frame(
    model: SAM2,
    feats: FrameFeatures,
    frame_idx: int,
    language_embd: Optional[torch.Tensor] = None,  # [B, 1, C]
    point_coords: Optional[torch.Tensor] = None,  # [B, P, 2] abs pixels (model space)
    point_labels: Optional[torch.Tensor] = None,  # [B, P]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Condition one frame (no memory) on language embeddings or point / box
    prompts. Returns (memory [B, HW, mem], obj_ptr [B, C], low-res logits
    [B, 1, h4, w4])."""
    cfg = model.cfg
    b = language_embd.shape[0] if language_embd is not None else point_coords.shape[0]
    h = w = cfg.sam_image_embedding_size
    hw, c = h * w, cfg.sam_embed_dim

    s2 = _broadcast_obj(feats.s2[frame_idx], b)  # [B, H, W, C]
    pix = model.no_memory_features(s2.reshape(b, hw, c)).reshape(b, h, w, c)
    high_res = [_broadcast_obj(feats.s0[frame_idx], b), _broadcast_obj(feats.s1[frame_idx], b)]
    # multimask only for 0..1 points: a box (two corner points) selects the
    # single-mask head
    n_pts = 0 if point_labels is None else point_labels.shape[1]
    out = model.forward_sam_heads(
        pix, high_res, language_embd, point_coords, point_labels, None, 0 <= n_pts <= 1
    )
    # consolidated memory: the best low-res mask upsampled to image
    # resolution → memory encoder
    size = cfg.hiera.image_size
    hr = resize_hw(out.low_res_masks.float(), size, size, "bilinear")
    cond_mem = model.encode_memory(s2, hr.permute(0, 2, 3, 1)).reshape(b, hw, cfg.mem_dim)
    return cond_mem, out.obj_ptr, out.low_res_masks


def init_on_first_frame(
    model: SAM2, feats: FrameFeatures, language_embd: torch.Tensor  # [B, 1, C]
) -> Tuple[VideoState, torch.Tensor]:
    """Condition frame 0 on the language embeddings and build the initial
    memory state. Returns (state, frame-0 low-res mask logits)."""
    cfg = model.cfg
    b = language_embd.shape[0]
    hw = cfg.sam_image_embedding_size ** 2
    cond_mem, cond_ptr, low_res = _condition_frame(model, feats, 0, language_embd)
    state = VideoState(
        cond_mem=cond_mem,
        cond_ptr=cond_ptr,
        mem_bank=cond_mem.new_zeros((cfg.num_maskmem - 1, b, hw, cfg.mem_dim)),
        ptr_bank=cond_ptr.new_zeros((cfg.max_obj_ptrs_in_encoder - 1, b, cfg.sam_embed_dim)),
    )
    return state, low_res


@torch.no_grad()
def track_frame(
    model: SAM2,
    state: VideoState,
    frame_idx: int,  # >= 1
    s0: torch.Tensor,  # this frame's features
    s1: torch.Tensor,
    s2: torch.Tensor,
    pos2: torch.Tensor,
    num_frames: int,
) -> Tuple[VideoState, torch.Tensor]:
    """One propagation step."""
    cfg = model.cfg
    n_mem = cfg.num_maskmem - 1
    n_ptr = cfg.max_obj_ptrs_in_encoder - 1
    b = state.cond_mem.shape[0]
    h = w = cfg.sam_image_embedding_size
    hw, c = h * w, cfg.sam_embed_dim
    dev = s2.device

    curr = _broadcast_obj(s2, b).reshape(b, hw, c)
    curr_pos = _broadcast_obj(pos2, b).reshape(b, hw, c)

    # memory slots: [cond, newest..oldest]; bank slot j holds frame fi-1-j
    mem_feats = torch.cat([state.cond_mem[:, None], state.mem_bank.permute(1, 0, 2, 3)], dim=1)
    slot_j = torch.arange(n_mem, device=dev)
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    mem_valid = torch.cat([one, slot_j <= frame_idx - 2])[None].expand(b, -1)
    # temporal position index: cond → num_maskmem - 1; bank slot j → j
    mem_tpos_idx = torch.cat([torch.tensor([cfg.num_maskmem - 1], device=dev), slot_j])

    max_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
    ptrs = torch.cat([state.cond_ptr[:, None], state.ptr_bank.permute(1, 0, 2)], dim=1)
    pj = torch.arange(n_ptr, device=dev)
    ptr_bank_valid = (pj <= frame_idx - 2) & (pj < max_ptrs - 1)
    ptr_valid = torch.cat([one, ptr_bank_valid])[None].expand(b, -1)

    pix = model.condition_on_memory(
        curr, curr_pos, mem_feats, mem_valid, mem_tpos_idx, ptrs, ptr_valid, (h, w)
    ).reshape(b, h, w, c)
    out = model.forward_sam_heads(pix, [_broadcast_obj(s0, b), _broadcast_obj(s1, b)], None)
    new_mem = model.encode_memory(
        _broadcast_obj(s2, b), out.high_res_masks.permute(0, 2, 3, 1)
    ).reshape(b, hw, cfg.mem_dim)

    state = VideoState(
        cond_mem=state.cond_mem,
        cond_ptr=state.cond_ptr,
        mem_bank=torch.cat([new_mem[None].to(state.mem_bank.dtype), state.mem_bank[:-1]], dim=0),
        ptr_bank=torch.cat(
            [out.obj_ptr[None].to(state.ptr_bank.dtype), state.ptr_bank[:-1]], dim=0
        ),
    )
    return state, out.low_res_masks


@torch.no_grad()
def propagate_video(
    model: SAM2, feats: FrameFeatures, language_embd: torch.Tensor  # [B, 1, C]
) -> torch.Tensor:
    """Frame-0 conditioning + propagation over frames 1..T-1. Returns
    low-res mask logits [T, B, 1, h4, w4]; the caller upsamples and
    thresholds (``masks_to_video_res``)."""
    t = feats.s2.shape[0]
    state, mask0 = init_on_first_frame(model, feats, language_embd)
    masks = [mask0]
    for fi in range(1, t):
        state, low = track_frame(
            model, state, fi, feats.s0[fi], feats.s1[fi], feats.s2[fi], feats.pos2,
            num_frames=t,
        )
        masks.append(low)
    return torch.stack(masks, dim=0)


def masks_to_video_res(masks: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[T, B, 1, h, w] logits → [T, B, height, width] bool masks (bilinear,
    then sigmoid > 0.5, i.e. logit > 0)."""
    up = resize_hw(masks.float(), height, width, "bilinear")
    return up[:, :, 0] > 0.0
