"""Temporal video grounding scorer: mean tIoU + R@1{0.3,0.5,0.7} (a copy
of ``ufvideo_tpu/eval/score_tvg.py``).

    python -m ufvideo_tpu_torch.eval.score_tvg --pred-path out.json --durations d.json

``--durations`` needs no cv2; without it each duration is read from the
video file with cv2.

Reference: eval/eval_video_TVG.py:45-85 — predictions carry normalized
spans, ground truth is absolute seconds; normalized predictions scale by the
video duration (from a duration table or the video file itself).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from .metrics import parse_temporal_span, recall_at_k, temporal_iou
from .util import read_all_ranks


def video_duration(path: str) -> Optional[float]:
    """Frames / fps of a video file, read with cv2 (imported here)."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    n = cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return n / fps if fps else None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred-path", required=True)
    p.add_argument("--video-folder", default="")
    p.add_argument("--durations", default="", help="json {vid: seconds}")
    args = p.parse_args(argv)

    durations = json.load(open(args.durations)) if args.durations else {}
    records = read_all_ranks(args.pred_path)

    ious = []
    skipped = 0
    for r in records:
        span = r.get("span") or parse_temporal_span(r.get("pred", ""))
        if span is None:
            ious.append(0.0)
            skipped += 1
            continue
        dur = durations.get(r["vid"])
        if dur is None and args.video_folder:
            import os

            dur = video_duration(os.path.join(args.video_folder, r["vid"]))
        dur = dur or 1.0
        gt = r["gt"]
        # gt stored normalized → scale both to seconds (eval_video_TVG.py:60-64)
        gt_abs = [gt[0] * dur, gt[1] * dur] if max(gt) <= 1.0 else gt
        pred_abs = [span[0] * dur, span[1] * dur] if max(span) <= 1.0 else list(span)
        ious.append(temporal_iou(pred_abs, gt_abs))

    n = max(len(ious), 1)
    r_at = recall_at_k(ious)
    print(f"samples: {len(records)} (unparsed: {skipped})")
    print(f"mIoU: {sum(ious) / n * 100:.2f}")
    for t, v in r_at.items():
        print(f"R@1({t}): {v:.2f}")


if __name__ == "__main__":
    main()
