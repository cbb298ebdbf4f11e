"""SAM2 video propagation (mirrors ``ufvideo_tpu/models/sam2/video.py``) for
the UFVideo usage pattern: one conditioning frame (frame 0, prompted by the
``[SEG]`` language embeddings), then forward propagation. The memory
selection collapses to

  - mask memory bank = conditioning frame 0 + a ring of the last 6 frames,
  - object pointers = conditioning frame 0 + a ring of the last 15 frames
    (past only, no temporal position encoding),

so the state has a fixed shape and the frames are walked by a Python loop.
All frames are encoded up front, in chunks.

``propagate_video_general`` is the general predictor: any number of prompted
frames (language embedding, clicks, box), a temporal stride of the memory
selection, and forward / reverse / bidirectional tracking.
``propagate_videos_batched`` tracks V videos at once, the videos riding the
object-batch dimension. The JAX package scans over a traced frame index;
here the frames are plain integers, and each direction's slot choices and
validity masks are tabulated on the host and uploaded once, so the loop
itself never waits for the device. ``sam_train_masks`` is the training
decode path (no memory, one prompted frame a row).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...configs import SAM2Config
from ...ops.interp import resize_hw
from .common import NO_OBJ_SCORE
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
    """Share one frame's features across the object batch, or pass through
    per-object features that already carry the batch dimension (batched
    multi-video propagation, where the videos ride the object dimension)."""
    if x.dim() == 4:
        if x.shape[0] != b:
            raise ValueError(f"features of {x.shape[0]} videos for a batch of {b}")
        return x
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


def _memory_step(model: SAM2, s0, s1, s2, pos2, b: int, mem_feats, mem_valid, mem_tpos_idx,
                 ptrs, ptr_valid):
    """The part every tracked frame shares: memory attention over the given
    slots and pointers, the SAM heads, and the frame's own memory. Returns
    (new memory [B, HW, mem_dim], the heads' output)."""
    cfg = model.cfg
    h = w = cfg.sam_image_embedding_size
    hw, c = h * w, cfg.sam_embed_dim
    curr = _broadcast_obj(s2, b).reshape(b, hw, c)
    curr_pos = _broadcast_obj(pos2, b).reshape(b, hw, c)
    pix = model.condition_on_memory(
        curr, curr_pos, mem_feats, mem_valid, mem_tpos_idx, ptrs, ptr_valid, (h, w)
    ).reshape(b, h, w, c)
    out = model.forward_sam_heads(pix, [_broadcast_obj(s0, b), _broadcast_obj(s1, b)], None)
    new_mem = model.encode_memory(
        _broadcast_obj(s2, b), out.high_res_masks.permute(0, 2, 3, 1)
    ).reshape(b, hw, cfg.mem_dim)
    return new_mem, out


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
    dev = s2.device

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

    new_mem, out = _memory_step(
        model, s0, s1, s2, pos2, b, mem_feats, mem_valid, mem_tpos_idx, ptrs, ptr_valid)

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


@torch.no_grad()
def propagate_videos_batched(
    model: SAM2,
    feats: FrameFeatures,  # tensors laid out [V, T, ...]; pos2 [H, W, C]
    language_embd: torch.Tensor,  # [V, 1, C], one object per video
) -> torch.Tensor:
    """Propagate V independent videos of equal length in one walk over the
    frames: the videos ride the memory machinery's object-batch dimension,
    so each per-frame module sees a batch of V rows. For several objects a
    video, repeat each video's features per object and flatten to V · B.
    Returns low-res mask logits [T, V, 1, h4, w4]."""
    by_frame = FrameFeatures(
        feats.s0.movedim(0, 1), feats.s1.movedim(0, 1), feats.s2.movedim(0, 1), feats.pos2)
    return propagate_video(model, by_frame, language_embd)


# ----------------------------------------------------------------------
# General video predictor: temporal stride, reverse / mid-video tracking,
# several prompted frames with language, point or box prompts. The state is
# a fixed ring of (num_maskmem - 2) · stride + 1 memories, whatever the
# video's length.
# ----------------------------------------------------------------------


class FrameCondition(NamedTuple):
    """One prompted frame: a language embedding, or points and / or a box
    (the box contributes two corner points labelled 2 / 3)."""

    frame_idx: int
    language_embd: Optional[torch.Tensor] = None  # [B, 1, C]
    point_coords: Optional[torch.Tensor] = None  # [B, P, 2] abs pixels (model space)
    point_labels: Optional[torch.Tensor] = None  # [B, P] in {0, 1}
    box: Optional[torch.Tensor] = None  # [B, 4] xyxy abs pixels (model space)


class GeneralVideoState(NamedTuple):
    """State of the general predictor. N = number of prompted frames."""

    cond_mem: torch.Tensor  # [N, B, HW, mem_dim]
    cond_ptr: torch.Tensor  # [N, B, C]
    mem_bank: torch.Tensor  # [L, B, HW, mem_dim] newest-first ring
    ptr_bank: torch.Tensor  # [P, B, C] newest-first ring


def _ring_len(cfg: SAM2Config, stride: int) -> int:
    """Length of the memory ring that covers the strided selection's oldest
    reach: with stride r the oldest selected memory can lie
    (num_maskmem - 2) · r frames back."""
    return (cfg.num_maskmem - 2) * max(stride, 1) + 1


def _select_mem_slots(cfg: SAM2Config, frame_idx: int, anchor_idx: int,
                      cond_idcs: Sequence[int], stride: int, reverse: bool):
    """Strided memory selection mapped onto the consecutive ring: slot j
    holds the frame tracked j + 1 steps ago, frame_idx ∓ (1 + j). The nearest
    memory is always the previous frame; the others lie on multiples of the
    stride. Returns three lists of num_maskmem - 1 entries: (ring slot,
    valid, index into ``maskmem_tpos_enc``). Prompted frames are kept
    beside the ring and are masked out of it."""
    r = max(stride, 1)
    ring = _ring_len(cfg, r)
    slots, valid, tpos = [], [], []
    for t_rel in range(1, cfg.num_maskmem):
        if reverse:
            near = -((-(frame_idx + 2)) // r) * r  # up to the next multiple of r
            p = frame_idx + 1 if t_rel == 1 else near + (t_rel - 2) * r
            slot = p - frame_idx - 1
            ok = frame_idx + 1 <= p <= anchor_idx - 1
        else:
            near = ((frame_idx - 2) // r) * r  # down to the previous multiple of r
            p = frame_idx - 1 if t_rel == 1 else near - (t_rel - 2) * r
            slot = frame_idx - 1 - p
            ok = anchor_idx + 1 <= p <= frame_idx - 1
        valid.append(ok and p not in cond_idcs and 0 <= slot < ring)
        slots.append(min(max(slot, 0), ring - 1))
        tpos.append(t_rel - 1)
    return slots, valid, tpos


def _direction_tables(cfg: SAM2Config, frames: Sequence[int], num_frames: int,
                      anchor_idx: int, cond_idcs: Sequence[int], stride: int, reverse: bool):
    """For the frames one direction walks, in order: the ring slots
    [n, num_maskmem - 1] (int64), the memory validity [n, N + num_maskmem - 1]
    and the pointer validity [n, N + max_obj_ptrs - 1] (bool), as numpy
    arrays, with the N prompted frames first in both."""
    n_ptr = cfg.max_obj_ptrs_in_encoder - 1
    max_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
    slots, mem_valid, ptr_valid = [], [], []
    for fi in frames:
        slot, sel_valid, _ = _select_mem_slots(cfg, fi, anchor_idx, cond_idcs, stride, reverse)
        slots.append(slot)
        mem_valid.append([True] * len(cond_idcs) + sel_valid)
        # prompted frames' pointers: those already passed in this direction;
        # then the ring of consecutive frames
        row = [(ci >= fi) if reverse else (ci <= fi) for ci in cond_idcs]
        for j in range(n_ptr):
            p = fi + 1 + j if reverse else fi - 1 - j
            ok = (fi + 1 <= p <= anchor_idx - 1) if reverse else (anchor_idx + 1 <= p <= fi - 1)
            row.append(ok and p not in cond_idcs and j < max_ptrs - 1)
        ptr_valid.append(row)
    return (np.asarray(slots, np.int64).reshape(len(frames), cfg.num_maskmem - 1),
            np.asarray(mem_valid, bool), np.asarray(ptr_valid, bool))


def _track_frame_general(
    model: SAM2,
    state: GeneralVideoState,
    slot: torch.Tensor,  # [num_maskmem - 1] ring slots of this frame's memories
    mem_valid: torch.Tensor,  # [N + num_maskmem - 1]
    ptr_valid: torch.Tensor,  # [N + max_obj_ptrs - 1]
    mem_tpos_idx: torch.Tensor,  # [N + num_maskmem - 1]
    s0: torch.Tensor,
    s1: torch.Tensor,
    s2: torch.Tensor,
    pos2: torch.Tensor,
) -> Tuple[GeneralVideoState, torch.Tensor]:
    """One step of the general predictor, its selection given as tensors on
    the device."""
    b = state.cond_mem.shape[1]
    sel = state.mem_bank.index_select(0, slot)
    mem_feats = torch.cat([state.cond_mem, sel], dim=0).permute(1, 0, 2, 3)
    ptrs = torch.cat([state.cond_ptr, state.ptr_bank], dim=0).permute(1, 0, 2)
    new_mem, out = _memory_step(
        model, s0, s1, s2, pos2, b, mem_feats, mem_valid[None].expand(b, -1), mem_tpos_idx,
        ptrs, ptr_valid[None].expand(b, -1))
    state = state._replace(
        mem_bank=torch.cat([new_mem[None].to(state.mem_bank.dtype), state.mem_bank[:-1]], dim=0),
        ptr_bank=torch.cat(
            [out.obj_ptr[None].to(state.ptr_bank.dtype), state.ptr_bank[:-1]], dim=0),
    )
    return state, out.low_res_masks


@torch.no_grad()
def propagate_video_general(
    model: SAM2,
    feats: FrameFeatures,
    conditions: Sequence[FrameCondition],  # the same B on every frame
    *,
    stride: int = 1,
    direction: str = "both",
) -> torch.Tensor:
    """General video propagation: any prompted frames (language embeddings,
    clicks or boxes), a temporal memory stride, and forward / reverse /
    bidirectional tracking. Propagation starts at the earliest prompted
    frame, and each direction runs on its own from the conditioning state
    (the directions do not see each other's memories). Returns low-res mask
    logits [T, B, 1, h4, w4]; prompted frames keep their conditioning
    output, and frames a one-directional call never reaches hold
    ``NO_OBJ_SCORE``."""
    if direction not in ("forward", "reverse", "both"):
        raise ValueError(f"direction must be forward/reverse/both: {direction}")
    if not conditions:
        raise ValueError("at least one prompted frame is required")
    cfg = model.cfg
    t = feats.s2.shape[0]
    dev = feats.s2.device
    hw = cfg.sam_image_embedding_size ** 2

    cond_idcs, cond_mems, cond_ptrs, cond_masks = [], [], [], []
    for cond in conditions:
        coords, labels = cond.point_coords, cond.point_labels
        if cond.box is not None:
            # box → two corner points labelled 2 / 3; clicks may follow
            bx = cond.box.float().reshape(-1, 2, 2)
            bl = torch.tensor([2, 3], dtype=torch.int32, device=bx.device).expand(bx.shape[0], 2)
            coords = bx if coords is None else torch.cat([bx, coords.float()], dim=1)
            labels = bl if labels is None else torch.cat([bl, labels.to(bl.dtype)], dim=1)
        if cond.language_embd is None and coords is None:
            raise ValueError(f"frame {cond.frame_idx}: needs language_embd, points or box")
        ci = int(cond.frame_idx)
        mem, ptr, low = _condition_frame(model, feats, ci, cond.language_embd, coords, labels)
        cond_idcs.append(ci)
        cond_mems.append(mem)
        cond_ptrs.append(ptr)
        cond_masks.append(low)
    b = cond_mems[0].shape[0]
    n_cond = len(cond_idcs)
    anchor = min(cond_idcs)

    state0 = GeneralVideoState(
        cond_mem=torch.stack(cond_mems),
        cond_ptr=torch.stack(cond_ptrs),
        mem_bank=cond_mems[0].new_zeros((_ring_len(cfg, stride), b, hw, cfg.mem_dim)),
        ptr_bank=cond_ptrs[0].new_zeros((cfg.max_obj_ptrs_in_encoder - 1, b, cfg.sam_embed_dim)),
    )
    h4 = cfg.sam_image_embedding_size * 4
    masks = torch.full((t, b, 1, h4, h4), NO_OBJ_SCORE, dtype=torch.float32, device=dev)
    # every prompted frame uses t_pos 0 → index num_maskmem - 1; the selected
    # memory of relative age t_rel → t_rel - 1
    mem_tpos_idx = torch.tensor(
        [cfg.num_maskmem - 1] * n_cond + list(range(cfg.num_maskmem - 1)), device=dev)

    def run(frames, reverse):
        tables = _direction_tables(cfg, frames, t, anchor, cond_idcs, stride, reverse)
        slots, mem_valid, ptr_valid = (torch.from_numpy(a).to(dev) for a in tables)
        state = state0
        for i, fi in enumerate(frames):
            state, low = _track_frame_general(
                model, state, slots[i], mem_valid[i], ptr_valid[i], mem_tpos_idx,
                feats.s0[fi], feats.s1[fi], feats.s2[fi], feats.pos2)
            masks[fi] = low.float()

    if direction in ("forward", "both") and anchor < t - 1:
        run(list(range(anchor + 1, t)), reverse=False)
    if direction in ("reverse", "both") and anchor > 0:
        run(list(range(anchor - 1, -1, -1)), reverse=True)
    for ci, low in zip(cond_idcs, cond_masks):
        masks[ci] = low.float()
    return masks


def sam_train_masks(
    model: SAM2,
    s0: torch.Tensor,  # [N, 4H, 4W, C/8] per-row frame features
    s1: torch.Tensor,  # [N, 2H, 2W, C/4]
    s2: torch.Tensor,  # [N, H, W, C]
    language_embd: torch.Tensor,  # [N, 1, C]
) -> torch.Tensor:
    """Training decode path (the JAX ``sam_train_masks``): no memory, the
    language-prompted SAM heads on a flat (sample × object × frame) batch →
    high-res mask logits [N, 1, 16H, 16W]. Records a graph: gradients reach
    ``language_embd`` through the mask decoder whether or not its own
    parameters train."""
    cfg = model.cfg
    n = s2.shape[0]
    h = w = cfg.sam_image_embedding_size
    c = cfg.sam_embed_dim
    pix = model.no_memory_features(s2.reshape(n, h * w, c)).reshape(n, h, w, c)
    return model.forward_sam_heads(pix, [s0, s1], language_embd).high_res_masks


def masks_to_video_res(masks: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[T, B, 1, h, w] logits → [T, B, height, width] bool masks (bilinear,
    then sigmoid > 0.5, i.e. logit > 0)."""
    up = resize_hw(masks.float(), height, width, "bilinear")
    return up[:, :, 0] > 0.0
