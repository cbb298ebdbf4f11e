"""Offline segmentation scorer: DAVIS J&F over dumped mask PNGs (a copy of
``ufvideo_tpu/eval/score_seg.py`` on the port's PNG codec and nearest
resize: no cv2).

Reference counterparts: eval/eval_video_Seg.py (PNG ground truth),
eval/eval_video_MeVis.py (RLE ground truth), eval/eval_video_unibench_seg.py.
Reads every rank's outputs via glob (per-rank-file protocol) and prints
mean J, F, and J&F.

    python -m ufvideo_tpu_torch.eval.score_seg --pred-path out.json \
        --pred-mask-root out_masks --gt (png|rle) [--gt-mask-root DIR]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
from functools import partial
from typing import Dict, List

import numpy as np

from .. import rle
from .metrics import boundary_f_measure, region_similarity
from .util import load_mask_pngs, read_all_ranks, read_gray_png


def resize_nearest(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(mask, (width, height), interpolation=cv2.INTER_NEAREST)``:
    output pixel x takes source pixel floor(x * (1 / (width / src_width))),
    clamped to the last one (cv2's arithmetic, in float64), and so for y."""
    h, w = mask.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))).astype(np.int64), w - 1)
    return mask[ys[:, None], xs[None, :]]


def _gt_masks_png(record: Dict, gt_root: str) -> List[np.ndarray]:
    """The record's ground-truth PNGs read as cv2's ``IMREAD_GRAYSCALE``
    reads them (any colour type and depth), None for a file cv2 would not
    read: a missing, unreadable, corrupt or non-PNG one."""
    out = []
    for name in record.get("file_names", []):
        try:
            m = read_gray_png(os.path.join(gt_root, name))
        except (OSError, ValueError):
            m = None
        out.append((m > 127).astype(np.uint8) if m is not None else None)
    return out


def _gt_masks_rle(record: Dict) -> List[np.ndarray]:
    out = []
    for ann in record.get("annotation", []):
        if ann is None:
            out.append(None)
        else:
            out.append(rle.decode(ann))
    return out


def score_sample(record: Dict, pred_root: str, gt_root: str, gt_kind: str):
    preds = load_mask_pngs(pred_root, record["id"])
    if not preds:
        # samples with no prediction masks are DROPPED from the average,
        # matching the reference scorer (eval_video_Seg.py:215-227 returns
        # an empty "skip" result for a missing pred dir) — scoring them 0
        # would deflate numbers relative to the reference protocol
        return []
    gts = (
        _gt_masks_png(record, gt_root) if gt_kind == "png" else _gt_masks_rle(record)
    )
    rows = []
    for i, pred in enumerate(preds):
        if i >= len(gts) or gts[i] is None:
            continue
        gt = gts[i]
        if gt.shape != pred.shape:
            pred = resize_nearest(pred, *gt.shape)
        j = float(region_similarity(gt, pred))
        f = boundary_f_measure(gt, pred)
        rows.append((j, f))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred-path", required=True)
    p.add_argument("--pred-mask-root", required=True)
    p.add_argument("--gt", choices=["png", "rle"], default="rle")
    p.add_argument("--gt-mask-root", default="")
    p.add_argument("--gt-file", default="", help="annotation json keyed by id")
    p.add_argument("--workers", type=int, default=1)
    args = p.parse_args(argv)

    records = read_all_ranks(args.pred_path)
    if args.gt_file:
        gt = json.load(open(args.gt_file))
        gt_by_id = {str(g["id"]): g for g in gt}
        for r in records:
            r.update(gt_by_id.get(str(r["id"]), {}))

    fn = partial(
        score_sample, pred_root=args.pred_mask_root,
        gt_root=args.gt_mask_root, gt_kind=args.gt,
    )
    if args.workers > 1:
        with mp.Pool(args.workers) as pool:
            all_rows = pool.map(fn, records)
    else:
        all_rows = [fn(r) for r in records]

    flat = [row for rows in all_rows for row in rows]
    if not flat:
        print("no scorable frames")
        return
    js = np.array([r[0] for r in flat])
    fs = np.array([r[1] for r in flat])
    print(f"J (region): {js.mean() * 100:.2f}")
    print(f"F (boundary): {fs.mean() * 100:.2f}")
    print(f"J&F: {(js.mean() + fs.mean()) / 2 * 100:.2f}")


if __name__ == "__main__":
    main()
