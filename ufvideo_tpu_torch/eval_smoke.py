"""Eval-harness smoke: ``eval/run.py`` end to end on a tiny random model and
synthetic videos (directories of PNG frames written by ``eval/png.py``): one
QA benchmark (mvbench) and one segmentation benchmark (mevis, the
``[SEG]``-input path), then their per-rank outputs through the MCQA and
J&F scorers. It checks the plumbing (run_benchmark → JSONL / PNG files → scorers),
not the model's quality. A port of ``scripts/eval_smoke.py``.

    python -m ufvideo_tpu_torch.eval_smoke               # on the card
    python -m ufvideo_tpu_torch.eval_smoke --device cpu

The tiny model's float32 widths are not the kernels' shapes, so on the card
it runs the plain versions (``"kernels": false`` in its line), as
``python -m ufvideo_tpu_torch.serve --tiny`` does. Prints one JSON line
``{"eval_smoke": "ok", ...}`` and exits 0, or raises.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import tempfile

import numpy as np

N_VIDEOS = 2
N_RAW_FRAMES = 6
H = W = 64


def make_data(root: str) -> str:
    """Frame directories and the mvbench / mevis question files (and mevis's
    RLE ground truth) under ``root``; returns the video folder."""
    from .eval.png import write_png
    from . import rle

    vids = os.path.join(root, "videos")
    rng = np.random.default_rng(0)
    for v in range(N_VIDEOS):
        d = os.path.join(vids, f"vid{v}")
        os.makedirs(d)
        for f in range(N_RAW_FRAMES):
            write_png(os.path.join(d, f"{f:03d}.png"), rng.integers(0, 255, (H, W, 3), np.uint8))
    mcqa = [{"id": f"q{v}", "task_type": "action",
             "data": {"video": f"vid{v}", "question": "What color dominates?",
                      "candidates": ["red", "green"], "answer": "red"}}
            for v in range(N_VIDEOS)]
    mevis = [{"id": f"m{v}", "video": f"vid{v}",
              "conversations": [{"from": "human", "value": "<video>\nSegment the moving object."},
                                {"from": "gpt", "value": "Sure, it is [SEG]."}]}
             for v in range(N_VIDEOS)]
    m = np.zeros((H, W), np.uint8)
    m[16:40, 8:32] = 1
    gt = [{"id": f"m{v}", "annotation": [rle.encode(m)] * 2} for v in range(N_VIDEOS)]
    for name, obj in (("mcqa", mcqa), ("mevis", mevis), ("mevis_gt", gt)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return vids


def _score(main, argv) -> str:
    """A scorer's ``main`` on ``argv``; what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m ufvideo_tpu_torch.eval_smoke")
    p.add_argument("--device", default="cuda",
                   help="where the tiny model runs: the card unless 'cpu' is given")
    args = p.parse_args(argv)

    from .api import model_init
    from .configs import tiny_config
    from .eval import run as eval_run
    from .eval import score_mcqa, score_seg
    from .eval.util import read_all_ranks

    # the byte tokenizer spends about a token a character: mvbench's prompt
    # needs a longer text budget than tiny_config's
    cfg = tiny_config()
    cfg = cfg.replace(budget=dataclasses.replace(cfg.budget, max_seq_len=512, max_text_len=384))
    bundle = model_init(None, cfg=cfg, device=args.device)
    rt = bundle[0]
    on_card = rt.device.type == "cuda"
    if on_card:
        rt.model.set_use_kernels(False)
    failures_before = sum(eval_run.FAILURES.values())
    out = {}
    with tempfile.TemporaryDirectory() as root:
        vids = make_data(root)
        common = ["--video-folder", vids, "--num-frames", "4", "--max-new-tokens", "4"]

        mv_out = os.path.join(root, "mv_out.json")
        eval_run.run_benchmark(eval_run.build_parser().parse_args(
            ["--benchmark", "mvbench", "--question-file", os.path.join(root, "mcqa.json"),
             "--output", mv_out] + common), runtime=bundle)
        records = read_all_ranks(mv_out)
        if len(records) != N_VIDEOS or not all(
                {"id", "pred", "gt", "task_type"} <= set(r) for r in records):
            raise RuntimeError(f"mvbench records: {records}")
        printed = _score(score_mcqa.main, ["--pred-path", mv_out])
        if "overall accuracy:" not in printed:
            raise RuntimeError(f"score_mcqa printed {printed!r}")
        out["mvbench_records"] = len(records)

        me_out = os.path.join(root, "me_out.json")
        eval_run.run_benchmark(eval_run.build_parser().parse_args(
            ["--benchmark", "mevis", "--question-file", os.path.join(root, "mevis.json"),
             "--output", me_out, "--num-sam-frames", "2"] + common), runtime=bundle)
        records = read_all_ranks(me_out)
        mask_root = os.path.splitext(me_out)[0] + "_masks"
        if len(records) != N_VIDEOS or sorted(os.listdir(mask_root)) != [
                f"m{v}" for v in range(N_VIDEOS)]:
            raise RuntimeError(f"mevis records {records}, masks {os.listdir(mask_root)}")
        printed = _score(score_seg.main, [
            "--pred-path", me_out, "--pred-mask-root", mask_root, "--gt", "rle",
            "--gt-file", os.path.join(root, "mevis_gt.json")])
        if "J&F:" not in printed:
            raise RuntimeError(f"score_seg printed {printed!r}")
        out["mevis_records"] = len(records)
        out["j_and_f"] = float(printed.split("J&F:")[1].split()[0])
    failures = sum(eval_run.FAILURES.values()) - failures_before
    if failures:
        raise RuntimeError(f"run_benchmark fell back or failed {failures} times: "
                           f"{dict(eval_run.FAILURES)}")
    # plain versions either way: set so on the card, the only route on the CPU
    out.update(device=str(rt.device), kernels=False, failures=0)
    out["eval_smoke"] = "ok"
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
