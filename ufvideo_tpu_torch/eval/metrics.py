"""Evaluation metrics: DAVIS region / boundary quality, temporal IoU, MCQA
answer matching, and the span / box parsers of the reference's eval scripts; a copy
of ``ufvideo_tpu/eval/metrics.py`` whose boundary dilation is numpy (the
same pixels as ``cv2.dilate``), so nothing here needs cv2.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------
# DAVIS J (region similarity)
# --------------------------------------------------------------------------

def region_similarity(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Jaccard index; empty-union frames count as 1 (eval_video_Seg.py:
    db_eval_iou convention)."""
    gt = gt.astype(bool)
    pred = pred.astype(bool)
    inters = np.sum(gt & pred, axis=(-2, -1)).astype(np.float64)
    union = np.sum(gt | pred, axis=(-2, -1)).astype(np.float64)
    j = np.where(union > 0, inters / np.maximum(union, 1), 1.0)
    return j if j.ndim else float(j)


# --------------------------------------------------------------------------
# DAVIS F (boundary quality)
# --------------------------------------------------------------------------

def _seg_boundary(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide boundary map, offset half a pixel toward the origin
    (Martin's bmap convention used by DAVIS)."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _disk(radius: int) -> np.ndarray:
    """Disk structuring element (skimage.morphology.disk equivalent)."""
    r = int(radius)
    y, x = np.ogrid[-r : r + 1, -r : r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def dilate(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Binary dilation of a 2-D mask by a symmetric odd-sized structuring
    element, zero outside the mask (what ``cv2.dilate`` gives with its
    default border): the OR of the mask shifted by each offset the kernel
    holds."""
    r_y, r_x = kernel.shape[0] // 2, kernel.shape[1] // 2
    h, w = mask.shape
    padded = np.zeros((h + 2 * r_y, w + 2 * r_x), bool)
    padded[r_y:r_y + h, r_x:r_x + w] = mask > 0
    out = np.zeros((h, w), bool)
    for dy, dx in zip(*np.nonzero(kernel)):
        out |= padded[dy:dy + h, dx:dx + w]
    return out.astype(np.uint8)


def boundary_f_measure(
    gt: np.ndarray, pred: np.ndarray, bound_th: float = 0.008
) -> float:
    """Boundary F-measure via dilated-boundary matching."""
    bound_pix = (
        bound_th
        if bound_th >= 1
        else int(np.ceil(bound_th * np.linalg.norm(pred.shape)))
    )
    fg_b = _seg_boundary(pred)
    gt_b = _seg_boundary(gt)
    kernel = _disk(bound_pix)
    fg_dil = dilate(fg_b, kernel)
    gt_dil = dilate(gt_b, kernel)

    n_fg = fg_b.sum()
    n_gt = gt_b.sum()
    if n_fg == 0 and n_gt > 0:
        return 0.0  # precision 1, recall 0
    if n_fg > 0 and n_gt == 0:
        return 0.0  # precision 0, recall 1
    if n_fg == 0 and n_gt == 0:
        return 1.0
    precision = float((fg_b & (gt_dil > 0)).sum()) / n_fg
    recall = float((gt_b & (fg_dil > 0)).sum()) / n_gt
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def j_and_f(gt: np.ndarray, pred: np.ndarray) -> Tuple[float, float, float]:
    """Per-frame (J, F, J&F) for one frame pair."""
    j = float(region_similarity(gt, pred))
    f = boundary_f_measure(gt, pred)
    return j, f, (j + f) / 2.0


# --------------------------------------------------------------------------
# temporal grounding
# --------------------------------------------------------------------------

def temporal_iou(pred: Sequence[float], gt: Sequence[float]) -> float:
    """IoU of two [start, end] spans."""
    s1, e1 = min(pred), max(pred)
    s2, e2 = min(gt), max(gt)
    inter = max(0.0, min(e1, e2) - max(s1, s2))
    union = max(e1, e2) - min(s1, s2)
    return inter / union if union > 0 else 0.0


def recall_at_k(ious: Sequence[float], thresholds=(0.3, 0.5, 0.7)):
    """R@1 at the given tIoU thresholds, as percentages.

    STRICT ``>`` by design: the reference scorer counts ``_iou > t``
    (eval_video_TVG.py:70-74), not the >= some Charades-STA codebases use —
    exact-boundary ties must not be counted or numbers diverge from the
    reference's."""
    n = max(len(ious), 1)
    return {
        t: 100.0 * sum(1 for i in ious if i > t) / n for t in thresholds
    }


_NORM_TOKEN_RE = re.compile(r"(<WIDTH-(\d+)>|<HEIGHT-(\d+)>|<TEMP-(\d+)>)")
_SPAN_RE = re.compile(r"{\s*(\d+(?:\.\d+)?)\,\s*(\d+(?:\.\d+)?)\s*}")
_BOX2D_RE = re.compile(
    r"\[\s*(\d+(?:\.\d+)?),\s*(\d+(?:\.\d+)?),\s*(\d+(?:\.\d+)?),"
    r"\s*(\d+(?:\.\d+)?)\s*\]"
)


def replace_and_normalize(input_str: str, return_token: bool = False) -> str:
    """Normalize <WIDTH-n>/<HEIGHT-n>/<TEMP-n> tokens to 'v/99,' decimal
    strings (or raw 'n,' with return_token), cleaning trailing commas before
    ]/}  (reference: inference_PixTRQA.py:165-185)."""

    def normalize(match: re.Match) -> str:
        value = int(next(g for g in match.groups()[1:] if g is not None))
        if return_token:
            return "{:d},".format(value)
        return "{:.5f},".format(value / 99.0)

    result = _NORM_TOKEN_RE.sub(normalize, input_str)
    return result.replace(",]", "]").replace(",}", "}")


def parse_span_from_text(s: str) -> List[float]:
    """'{start, end}' brace span, [0, 0] when absent
    (reference: inference_PixTRQA.py:187-198)."""
    m = _SPAN_RE.search(s)
    if m:
        return [float(m.group(1)), float(m.group(2))]
    return [0, 0]


def format_1d_box(text: str) -> Optional[Tuple[float, float]]:
    """'{start, end}' brace span, None when absent
    (reference: inference_video_TVG.py:38-48)."""
    m = _SPAN_RE.search(text)
    if m:
        return float(m.group(1)), float(m.group(2))
    return None


def format_2d_box(text: str) -> Optional[List[float]]:
    """'[x0, y0, x1, y1]' bracket box, None when absent
    (reference: inference_video_TVG.py:49-62)."""
    m = _BOX2D_RE.search(text)
    if m:
        return [float(m.group(i)) for i in range(1, 5)]
    return None


def parse_temporal_span(text: str) -> Optional[Tuple[float, float]]:
    """Extract a (start, end) span from generated text, matching the
    reference pipeline: normalize <TEMP-/WIDTH-/HEIGHT-> tokens
    (inference_PixTRQA.py:165-185), then brace-parse '{x, y}'
    (inference_video_TVG.py:38-48); falls back to raw <TEMP> pairs and
    bare number pairs for robustness."""
    normalized = replace_and_normalize(text)
    span = format_1d_box(normalized)
    if span is not None:
        return span
    temps = [int(m) / 99.0 for m in re.findall(r"<TEMP-(\d+)>", text)]
    if len(temps) >= 2:
        return temps[0], temps[1]
    nums = re.findall(r"(\d+(?:\.\d+)?)", normalized)
    if len(nums) >= 2:
        return float(nums[0]), float(nums[1])
    return None


# --------------------------------------------------------------------------
# MCQA
# --------------------------------------------------------------------------

def match_mc_answer(pred: str, options: Sequence[str]) -> str:
    """Map free-form output to an option letter (A, B, ...), reproducing
    the reference's mvbench_dump EXACTLY
    (eval/inference_video_mcqa_mvbench.py:172-198): strip 'answer'/'Answer',
    find the FIRST letter-like token anywhere (quirks included — a bare
    capital 'A' article matches), else option-text containment, else
    default to option index 2."""
    letters = [chr(ord("A") + i) for i in range(len(options))]
    text = pred.replace("answer", "").replace("Answer", "")
    found = re.findall(
        rf"[\(,\ ]*[{letters[0]}-{letters[-1]}][\),\ ]*", text
    )
    if found:
        return found[0].strip().strip("()")
    for letter, opt in zip(letters, options):
        if opt.lower() in text.lower():
            return letter
    return letters[2] if len(letters) > 2 else letters[-1]


def accuracy(records: Sequence[dict], pred_key="pred", gt_key="gt") -> float:
    if not records:
        return 0.0
    return 100.0 * sum(1 for r in records if r[pred_key] == r[gt_key]) / len(records)
