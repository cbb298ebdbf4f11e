"""Static-shape multimodal splicing.

``plan_splice`` and ``plan_lookup_ids`` are host numpy, copies of
``ufvideo_tpu/splicing.py``: every sample's spliced sequence is described by
``src_kind`` (0 text, 1 video, 2 region, 3 pad) and ``src_idx`` (position
within that source) over a fixed ``max_seq_len``. ``apply_splice`` gathers
from each source with torch and selects by kind.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .constants import IGNORE_INDEX, MODAL_INDEX_MAP

KIND_TEXT = 0
KIND_VIDEO = 1
KIND_REGION = 2
KIND_PAD = 3


@dataclass
class SplicePlan:
    src_kind: np.ndarray  # [B, S] int32
    src_idx: np.ndarray  # [B, S] int32 (index within the source stream)
    seq_lens: np.ndarray  # [B] int32 — valid spliced length
    text_ids: np.ndarray  # [B, T] int32 — original ids, sentinels → pad(0)
    labels: Optional[np.ndarray]  # [B, S] int32 or None
    # where each original text position landed in the spliced sequence;
    # -1 for sentinel positions
    text_pos_map: np.ndarray  # [B, T] int32


def plan_splice(
    input_ids: Sequence[Sequence[int]],
    *,
    num_video_tokens: int,
    region_token_counts: Sequence[Sequence[int]],
    region_token_id: int,
    max_seq_len: int,
    labels: Optional[Sequence[Sequence[int]]] = None,
    region_stride: int = 0,
) -> SplicePlan:
    """Build the static splice layout for a batch.

    ``region_token_counts[b]`` lists the merged-token count of each
    ``<region>`` placeholder in sample b; region r's tokens start at
    ``r * region_stride`` in the flattened region stream.
    """
    b = len(input_ids)
    t_max = max((len(x) for x in input_ids), default=1)
    src_kind = np.full((b, max_seq_len), KIND_PAD, np.int32)
    src_idx = np.zeros((b, max_seq_len), np.int32)
    seq_lens = np.zeros((b,), np.int32)
    text_ids = np.zeros((b, t_max), np.int32)
    text_pos_map = np.full((b, t_max), -1, np.int32)
    out_labels = (
        np.full((b, max_seq_len), IGNORE_INDEX, np.int32)
        if labels is not None
        else None
    )

    modal_ids = set(MODAL_INDEX_MAP.values())
    for bi, ids in enumerate(input_ids):
        rc = list(region_token_counts[bi]) if region_token_counts else []
        pos = 0
        ri = 0
        region_base = 0
        for ti, tok in enumerate(ids):
            if tok in modal_ids:
                if pos + num_video_tokens > max_seq_len:
                    raise ValueError(
                        f"sample {bi}: splice overflows budget {max_seq_len}"
                    )
                src_kind[bi, pos : pos + num_video_tokens] = KIND_VIDEO
                src_idx[bi, pos : pos + num_video_tokens] = np.arange(
                    num_video_tokens
                )
                pos += num_video_tokens
                text_ids[bi, ti] = 0
            elif tok == region_token_id and ri < len(rc):
                n = rc[ri]
                if pos + n > max_seq_len:
                    raise ValueError(
                        f"sample {bi}: splice overflows budget {max_seq_len}"
                    )
                src_kind[bi, pos : pos + n] = KIND_REGION
                src_idx[bi, pos : pos + n] = region_base + np.arange(n)
                pos += n
                region_base += region_stride if region_stride else n
                ri += 1
                text_ids[bi, ti] = 0
            else:
                if pos >= max_seq_len:
                    raise ValueError(
                        f"sample {bi}: splice overflows budget {max_seq_len}"
                    )
                src_kind[bi, pos] = KIND_TEXT
                src_idx[bi, pos] = ti
                text_pos_map[bi, ti] = pos
                if out_labels is not None:
                    out_labels[bi, pos] = labels[bi][ti]
                pos += 1
                text_ids[bi, ti] = tok
        seq_lens[bi] = pos

    return SplicePlan(
        src_kind=src_kind,
        src_idx=src_idx,
        seq_lens=seq_lens,
        text_ids=text_ids,
        labels=out_labels,
        text_pos_map=text_pos_map,
    )


def plan_lookup_ids(plan: SplicePlan) -> np.ndarray:
    """[B, S] token ids at the spliced positions: the text id at text
    positions, -1 at video, region and pad slots. The history that
    prompt-lookup drafting (``models/speculative.py``) matches n-grams in:
    generation positions are spliced positions."""
    ti = np.clip(plan.src_idx, 0, plan.text_ids.shape[1] - 1)
    ids = np.take_along_axis(plan.text_ids, ti, axis=1)
    return np.where(plan.src_kind == KIND_TEXT, ids, -1).astype(np.int32)


def apply_splice(
    text_embeds: torch.Tensor,  # [B, T, D]
    video_feats: Optional[torch.Tensor],  # [B, V, D]
    region_feats: Optional[torch.Tensor],  # [B, RT, D]
    src_kind: torch.Tensor,  # [B, S] int
    src_idx: torch.Tensor,  # [B, S] int
) -> torch.Tensor:
    """Gather from each source stream and select by kind → [B, S, D]."""
    d = text_embeds.shape[-1]

    def gather(src):
        idx = src_idx.long().clamp(0, src.shape[1] - 1)
        return torch.gather(src, 1, idx[..., None].expand(-1, -1, d))

    out = gather(text_embeds)
    if video_feats is not None:
        v = gather(video_feats.to(out.dtype))
        out = torch.where((src_kind == KIND_VIDEO)[..., None], v, out)
    if region_feats is not None:
        r = gather(region_feats.to(out.dtype))
        out = torch.where((src_kind == KIND_REGION)[..., None], r, out)
    return torch.where(
        (src_kind == KIND_PAD)[..., None], torch.zeros_like(out), out
    )
