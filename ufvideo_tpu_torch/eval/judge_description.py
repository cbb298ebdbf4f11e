"""LLM-as-judge pipeline for description quality (VideoRefer-Bench-D).

Reference: eval/videorefer_bench_d/{1.eval_gpt_new.py, 2.extract_re.py,
3.analyze_score.py} — GPT judging with a 4-dimension rubric, regex score
extraction, per-dimension means. Collapsed into one module with three
subcommands (a copy of ``ufvideo_tpu/eval/judge_description.py``; ``openai``
is imported by ``judge`` alone):

    python -m ufvideo_tpu_torch.eval.judge_description judge   --pred-path ... --out scored.json
    python -m ufvideo_tpu_torch.eval.judge_description extract --in scored.json --out scores.json
    python -m ufvideo_tpu_torch.eval.judge_description analyze --in scores.json
"""

from __future__ import annotations

import argparse
import json
import re
import time
from typing import Dict, List, Optional

from .util import read_all_ranks

DIMENSIONS = ["Subject Correspondence", "Appearance Description",
              "Temporal Description", "Hallucination Detection"]

# the reference rubric VERBATIM (eval/videorefer_bench_d/system.txt) — the
# judge prompt is a byte-level behavioral spec: a paraphrased rubric yields
# scores that are not comparable with reference-judged results
SYSTEM_PROMPT = """You are an advanced intelligent chatbot specialized in evaluating the factual accuracy of generative outputs related to object-based video descriptions.
Your primary task is to meticulously compare the predicted answer with the correct answer and assess their factual consistency. To accomplish this, you will evaluate the descriptions across four key dimensions:
1. Subject Correspondence: Assess whether the subject of the input description accurately matches the subject indicated in the ground truth description.
2. Appearance Description: Evaluate the accuracy of the appearance details, including color, shape, size, texture, and any other relevant visual attributes.
3. Temporal Description: Analyze whether the depiction of the object's motion aligns with the actual movements described in the correct answer.
4. Hallucination Detection: Identify any discrepancies by determining if the description includes facts, actions, or elements that do not exist in reality, such as imaginative interpretations or incorrect inferences.
Please assign a score for each of these four dimensions, using an integer from 0 to 5, where 5 indicates a perfect match and 0 signifies no relevance at all. Accompany your assessments with brief explanations to clarify your scoring rationale.
### OUTPUT FORMAT(EXAMPLE)
1. Subject Correspondence: 5\\nExplanation: xxx
2. Appearance Description: 4\\nExplanation: xxx
3. Temporal Description: 5\\nExplanation: xxx
4. Hallucination Detection: 3\\nExplanation: xxx"""


def judge_one(client, model_name: str, gt: str, pred: str, retries: int = 5):
    """Score one (gt, pred) pair with retry (reference 1.eval_gpt_new.py:
    8-48: '##Correct answer:'/'##Predicted answer:' user format, default
    sampling temperature)."""
    user = f"##Correct answer: {gt}\n##Predicted answer: {pred}\n"
    for attempt in range(retries):
        try:
            resp = client.chat.completions.create(
                model=model_name,
                messages=[
                    {"role": "system", "content": SYSTEM_PROMPT},
                    {"role": "user", "content": user},
                ],
            )
            return resp.choices[0].message.content
        except Exception as e:  # pragma: no cover - network path
            if attempt == retries - 1:
                return f"JUDGE_ERROR: {e}"
            time.sleep(2 ** attempt)


def extract_scores(text: str) -> Optional[Dict[str, float]]:
    """Regex score extraction (reference 2.extract_re.py)."""
    out = {}
    for dim in DIMENSIONS:
        m = re.search(rf"{re.escape(dim)}\s*[:：]\s*([0-5](?:\.\d+)?)", text)
        if not m:
            return None
        out[dim] = float(m.group(1))
    return out


def cmd_judge(args):
    from openai import OpenAI  # gated: only needed for this subcommand

    client = OpenAI()
    records = read_all_ranks(args.pred_path)
    out: List[Dict] = []
    for r in records:
        verdict = judge_one(client, args.judge_model, r.get("caption", ""), r["pred"])
        out.append({**r, "judge": verdict})
    json.dump(out, open(args.out, "w"))


def cmd_extract(args):
    records = json.load(open(getattr(args, "in")))
    out = []
    for r in records:
        s = extract_scores(r.get("judge", ""))
        if s is not None:
            out.append({"id": r.get("id"), **s})
    json.dump(out, open(args.out, "w"))
    print(f"extracted {len(out)}/{len(records)}")


def cmd_analyze(args):
    records = json.load(open(getattr(args, "in")))
    if not records:
        print("no records")
        return
    for dim in DIMENSIONS:
        vals = [r[dim] for r in records if dim in r]
        print(f"{dim}: {sum(vals) / max(len(vals), 1):.2f}")
    all_means = [
        sum(r[d] for d in DIMENSIONS) / len(DIMENSIONS) for r in records
    ]
    print(f"Average: {sum(all_means) / len(all_means):.2f}")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    j = sub.add_parser("judge")
    j.add_argument("--pred-path", required=True)
    j.add_argument("--out", required=True)
    # pinned snapshot, as the reference judges with (1.eval_gpt_new.py:23)
    j.add_argument("--judge-model", default="gpt-4o-2024-08-06")
    e = sub.add_parser("extract")
    e.add_argument("--in", required=True)
    e.add_argument("--out", required=True)
    a = sub.add_parser("analyze")
    a.add_argument("--in", required=True)
    args = p.parse_args(argv)
    {"judge": cmd_judge, "extract": cmd_extract, "analyze": cmd_analyze}[args.cmd](args)


if __name__ == "__main__":
    main()
