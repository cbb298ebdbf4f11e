"""MCQA scorer: overall + per-task accuracy (a copy of
``ufvideo_tpu/eval/score_mcqa.py``).

    python -m ufvideo_tpu_torch.eval.score_mcqa --pred-path out.json [--format qbench]

Reference: eval/eval_video_mcqa_mvbench.py:39-67 (``--format mvbench``,
records carry pre-extracted pred/gt letters) and
eval/eval_videorefer_bench_q.py:25-62 (``--format qbench``, records carry
the RAW pred text + Answer/type; letter extraction happens here, exactly
as the reference scorer does it).
"""

from __future__ import annotations

import argparse
import re
from collections import defaultdict

from .metrics import accuracy
from .util import read_all_ranks


def qbench_letter(text: str) -> str:
    """Reference letter extraction (eval_videorefer_bench_q.py:26-37):
    '(X)' anywhere, else 'X)', else the first character after dropping
    dots."""
    m = re.search(r"\(([A-Z])\)", text)
    if m:
        return m.group(1)
    m = re.search(r"([A-Z])\)", text)
    if m:
        return m.group(1)
    stripped = text.replace(".", "")
    return stripped[0] if stripped else ""


def score_qbench(records):
    """Per-type + pooled accuracy over Answer/pred/type records
    (eval_videorefer_bench_q.py:39-62)."""
    all_sum: dict = defaultdict(int)
    right: dict = defaultdict(int)
    for r in records:
        gt = r.get("Answer") or ""
        m = re.search(r"\(([A-Z])\)", gt)
        if m:
            gt = m.group(1)
        pred = qbench_letter(r.get("pred") or "")
        tp = r.get("type", "")
        all_sum[tp] += 1
        if pred.lower() == gt.lower():
            right[tp] += 1
    return {
        tp: (right[tp], all_sum[tp]) for tp in all_sum
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred-path", required=True)
    p.add_argument("--task-key", default="task_type")
    p.add_argument("--format", default="mvbench",
                   choices=("mvbench", "qbench"))
    args = p.parse_args(argv)

    records = read_all_ranks(args.pred_path)
    if args.format == "qbench":
        per_type = score_qbench(records)
        tot = sum(n for _, n in per_type.values())
        hit = sum(k for k, _ in per_type.values())
        for tp, (k, n) in sorted(per_type.items()):
            print(f"  {tp}: {100.0 * k / n:.1f} ({k}/{n})")
        print(f"overall accuracy: {100.0 * hit / max(tot, 1):.2f} ({tot} samples)")
        return

    print(f"overall accuracy: {accuracy(records):.2f} ({len(records)} samples)")

    by_task = defaultdict(list)
    for r in records:
        by_task[r.get(args.task_key, "")].append(r)
    for task, recs in sorted(by_task.items()):
        if task:
            print(f"  {task}: {accuracy(recs):.1f} ({len(recs)})")


if __name__ == "__main__":
    main()
