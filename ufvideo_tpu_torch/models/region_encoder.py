"""Region encoder: mask-pooled object tokens (mirrors
``ufvideo_tpu/models/region_encoder.py``), at static shapes.

- ``mask_pool``: average the tower's features over each binary mask
  resized to the patch grid.
- ``token_merge_static``: merge adjacent tokens of highest cosine similarity
  until ``out_tokens`` remain, as a fixed-shape segmented mean: the
  ``n_valid - out_tokens`` most similar boundaries are merged away, the rest
  split, tokens between splits are averaged. Ties go to the earlier boundary.
- ``RegionProjector``: the 2-layer MLP to the LLM's width.

Per-sample object and annotated-frame counts are static budgets with
validity masks. All of it is plain tensor code: the JAX module reaches no
Pallas kernel (the annotated frames go through the SigLIP tower's kernels).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import RegionEncoderConfig
from ..ops.interp import bilinear_matrix


def mask_pool(feats: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Masked average pool per (frame, mask) pair: feats [N, H, W, C], masks
    [N, H, W] → [N, C] f32 (mask > 0, normalised by area + 1e-8)."""
    m = (masks > 0).to(torch.float32)
    denom = m.sum(dim=(1, 2)) + 1e-8
    pooled = torch.einsum("nhwc,nhw->nc", feats.to(torch.float32), m)
    return pooled / denom[:, None]


def resize_mask_to_grid(masks: torch.Tensor, grid: int) -> torch.Tensor:
    """Bilinear-resize masks [N, H, W] to the patch grid with the weights of
    ``F.interpolate(mode='bilinear', align_corners=False)``; the identity
    when H == W == grid."""
    _, h, w = masks.shape
    if h == grid and w == grid:
        return masks.to(torch.float32)
    mh = torch.from_numpy(bilinear_matrix(h, grid)).to(masks.device)
    mw = torch.from_numpy(bilinear_matrix(w, grid)).to(masks.device)
    return torch.einsum("gh,nhw,kw->ngk", mh, masks.to(torch.float32), mw)


def resize_mask_to_grid_np(masks, grid: int) -> np.ndarray:
    """Host twin of ``resize_mask_to_grid`` (same weights; the > 0 support
    that ``mask_pool`` thresholds on is identical). Two matrix products, rows
    then columns: the three-operand einsum walks every (g, h, w, k) and takes
    0.2 s on a 480 x 640 mask."""
    masks = np.asarray(masks, np.float32)
    _, h, w = masks.shape
    if h == grid and w == grid:
        return masks
    return np.matmul(np.matmul(bilinear_matrix(h, grid), masks), bilinear_matrix(w, grid).T)


def token_merge_static(
    tokens: torch.Tensor,  # [n, d] pooled tokens of ONE object
    valid: torch.Tensor,  # [n] bool
    out_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge ``tokens`` down to at most ``out_tokens`` segments by averaging
    runs of adjacent high-similarity tokens → ([out_tokens, d] merged,
    [out_tokens] validity)."""
    n, _ = tokens.shape
    if n <= 1 or out_tokens >= n:
        pad = out_tokens - n
        if pad >= 0:
            return F.pad(tokens, (0, 0, 0, pad)), F.pad(valid, (0, pad))

    tf = tokens.to(torch.float32)
    norm = tf / torch.linalg.norm(tf, dim=-1, keepdim=True).clamp_min(1e-12)
    sim = (norm[:-1] * norm[1:]).sum(dim=-1)  # [n-1]
    # a boundary beside padding never merges
    pair_valid = valid[:-1] & valid[1:]
    sim = torch.where(pair_valid, sim, torch.full_like(sim, -torch.inf))

    n_valid = valid.to(torch.int32).sum()
    r_remove = (n_valid - out_tokens).clamp(0, n - 1)
    # rank boundaries by similarity, descending, earlier first among equals
    order = torch.argsort(-sim, stable=True)
    rank = torch.empty(n - 1, dtype=torch.int64, device=tokens.device)
    rank[order] = torch.arange(n - 1, device=tokens.device)
    merged_boundary = rank < r_remove

    split = ~merged_boundary & pair_valid
    seg_id = torch.cat([split.new_zeros(1, dtype=torch.int64), split.to(torch.int64).cumsum(0)])
    # segmented mean over out_tokens buckets (a segment id past the budget
    # falls out, as it does from the JAX one-hot)
    one_hot = (seg_id[:, None] == torch.arange(out_tokens, device=tokens.device)[None, :])
    one_hot = one_hot.to(torch.float32) * valid[:, None].to(torch.float32)
    counts = one_hot.sum(dim=0)
    sums = torch.einsum("nd,nr->rd", tf, one_hot)
    merged = sums / counts[:, None].clamp_min(1.0)
    return merged.to(tokens.dtype), counts > 0


class RegionProjector(nn.Module):
    """2-layer MLP: vision width → LLM width, exact (erf) GELU between."""

    def __init__(self, cfg: RegionEncoderConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.fc0 = nn.Linear(cfg.encoder_hidden_size, cfg.hidden_size, dtype=dtype)
        for i in range(1, cfg.depth):
            setattr(self, f"fc{2 * i}", nn.Linear(cfg.hidden_size, cfg.hidden_size, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc0(x.to(self.dtype))
        for i in range(1, self.cfg.depth):
            x = getattr(self, f"fc{2 * i}")(F.gelu(x, approximate="none"))
        return x


def extract_region_tokens(
    frame_feats: torch.Tensor,  # [F, P, C] features of the annotated frames
    masks: torch.Tensor,  # [F, Hm, Wm] binary masks, one per frame
    frame_valid: torch.Tensor,  # [F] bool: padding frames are False
    region_segments: torch.Tensor,  # [R, F] bool: frames of region r
    region_token_num: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per region (one ``<region>`` placeholder, owning a subset of the
    annotated frames): pool the mask's features per frame, then merge down
    to ``region_token_num`` tokens → ([R, region_token_num, C] tokens,
    [R, region_token_num] validity)."""
    f, p, c = frame_feats.shape
    grid = int(round(p ** 0.5))
    pooled = mask_pool(frame_feats.reshape(f, grid, grid, c), resize_mask_to_grid(masks, grid))
    tokens, valid = [], []
    for seg_mask in region_segments:
        # this region's frames to the front, order kept
        sel = seg_mask & frame_valid
        idx = torch.argsort((~sel).to(torch.int8), stable=True)
        t, v = token_merge_static(pooled[idx], sel[idx], region_token_num)
        tokens.append(t)
        valid.append(v)
    return torch.stack(tokens).to(frame_feats.dtype), torch.stack(valid)
