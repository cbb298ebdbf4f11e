"""The benchmark runner: one loop for all eight benchmarks (the reference
has a near-identical torchrun script for each), a copy of
``ufvideo_tpu/eval/run.py`` on the port's ``mm_infer`` / ``mm_infer_batch``.

Each rank takes its chunk of the question file, runs ``mm_infer`` on each
sample (``--batch`` > 1: ``mm_infer_batch`` on groups, each sample of a
failed group retried alone, none emitted twice) and writes one JSONL row a
sample to ``{output}_rank{r}.json`` and each sample's masks as PNGs under
``{output}_masks/{id}/``, the masks before the row. The rank comes from
``RANK`` / ``WORLD_SIZE``; there are no collectives. ``FAILURES`` counts every
fallback and every sample that failed, beside the traceback each prints.

    python -m ufvideo_tpu_torch.eval.run --benchmark pixrqa \
        --model-path ... --video-folder ... --question-file ... --output ...

The model runs on the card (``cuda:$LOCAL_RANK`` when that is set) unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import traceback
from typing import Any, Dict

from ..api import mm_infer, mm_infer_batch, model_init
from .datasets import MCQABenchmark, SegReferBenchmark, TVGBenchmark
from .metrics import match_mc_answer, parse_temporal_span
from .util import JsonlWriter, get_chunk, get_rank_world, rank_output_path, save_mask_pngs

# "batch": a group whose mm_infer_batch failed (its samples then run alone);
# "sample": a sample whose own call or emit failed; "load": a sample that
# failed to load. A run that printed no traceback leaves all three at 0.
FAILURES: collections.Counter = collections.Counter()


def _failed(kind: str) -> None:
    traceback.print_exc()
    FAILURES[kind] += 1


def config_from_args(args):
    """The configuration ``--quant`` / ``--kv-quant`` / ``--prefill-chunk`` /
    ``--spec-decode`` ask for, or None for the default one."""
    from ..configs import UFVideoConfig

    quant = getattr(args, "quant", "")
    kvq = getattr(args, "kv_quant", False)
    pchunk = getattr(args, "prefill_chunk", 0)
    speck = getattr(args, "spec_decode", 0)
    if not (quant or kvq or pchunk or speck):
        return None
    return UFVideoConfig(
        quant_llm=quant or False, quant_kv=bool(kvq),
        prefill_chunk=int(pchunk), spec_decode=int(speck),
    )


def rank_device(device: str) -> str:
    """``cuda`` is this rank's card, ``cuda:$LOCAL_RANK`` when that is set;
    any other device as given."""
    if device == "cuda" and "LOCAL_RANK" in os.environ:
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return device


PIXRQA_QUESTION = (
    "There is 1 objects in the video: object_1: [<region>]. Please give a "
    "detailed description of what is the object_1 doing in the video. And "
    "please generate the mask in every frames?"
)

# D-bench always asks its fixed description question
# (reference: inference_videorefer_d_bench.py:90)
VIDEOREFER_D_QUESTION = (
    "Please give a detailed description of the highlighted object "
    "[<region>] in the video."
)


# per-benchmark mm_infer choice, matching the reference scripts exactly:
# choice=1 prepends '<video>\n' (the fixed pixrqa/d/q questions carry no
# modal token themselves — inference_PixRQA.py:248,
# inference_videorefer_d_bench.py:241, _q_bench.py:241), while the
# pixhqa/pixtrqa questions come from conversations that already embed it
# (inference_PixHQA.py:204, inference_PixTRQA.py:276, both choice=2)
SEG_REFER_CHOICE = {
    "pixrqa": 1,
    "videorefer_d": 1,
    "videorefer_q": 1,
    "pixhqa": 2,
    "pixtrqa": 2,
}


def _seg_refer_question(sample, args, question=None):
    line = sample["line"]
    if args.benchmark == "videorefer_q" and "Question" in line:
        # Q-bench builds an MC prompt: bracketed region + options + letter
        # instruction (inference_videorefer_q_bench.py:91-92)
        return (
            line["Question"].replace("<region>", "[<region>]")
            + " "
            + " ".join(line["options"])
            + ". Answer with the option's letter from the given choices "
            "directly."
        )
    q = question or line["conversations"][0][0]["value"]
    if args.benchmark == "videorefer_q":
        q = q.replace("<region>", "[<region>]")
    return q


def _seg_refer_step(model, tokenizer, sample, args, choice=None, question=None):
    if choice is None:
        choice = SEG_REFER_CHOICE.get(args.benchmark, 2)
    q = _seg_refer_question(sample, args, question)
    out = mm_infer(
        sample["video"],
        q,
        model,
        tokenizer,
        modal="video",
        masks=sample.get("masks"),
        ann_indices=sample.get("ann_indices"),
        frame=sample.get("frame"),
        choice=choice,
        images_sam=sample.get("images_sam"),
        label_size=(sample["height"], sample["width"]),
        max_new_tokens=args.max_new_tokens,
    )
    if isinstance(out, tuple):
        text, extra = out
    else:
        text, extra = "", out
    return text, extra


def run_benchmark(args, runtime=None) -> None:
    """Drive one benchmark. ``runtime`` is a (model, processor, tokenizer)
    triple built by the caller; without it the model loads from
    ``args.model_path`` (random weights when that is empty)."""
    rank, world = get_rank_world()
    if runtime is not None:
        model, _, tokenizer = runtime
    else:
        model, _, tokenizer = model_init(
            args.model_path or None,
            cfg=config_from_args(args),
            device=rank_device(getattr(args, "device", "cuda")),
            sam_path=args.sam_path or None,
            tokenizer_path=args.tokenizer_path or None,
        )
    # preprocessing follows the model's configured resolutions
    image_size = model.cfg.vision.image_size
    sam_image_size = model.cfg.sam.hiera.image_size

    with open(args.question_file) as f:
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks or world, rank)

    writer = JsonlWriter(rank_output_path(args.output, rank))
    mask_dir = os.path.splitext(args.output)[0] + "_masks"

    num_frames = getattr(args, "num_frames", 0) or None
    frames_kw = {"num_frames": num_frames} if num_frames else {}
    bench = args.benchmark
    if bench in ("pixrqa", "pixhqa", "pixtrqa", "videorefer_d", "videorefer_q"):
        ds = SegReferBenchmark(
            args.video_folder, questions,
            num_sam_frames=args.num_sam_frames or None,
            # the q-bench script shares --mode with d-bench
            # (inference_videorefer_q_bench.py:269, default 'single')
            mode=(
                args.mode
                if bench in ("videorefer_d", "videorefer_q")
                else None
            ),
            image_size=image_size, sam_image_size=sam_image_size,
            benchmark=bench,
            **frames_kw,
        )
        question = {
            "pixrqa": PIXRQA_QUESTION,
            "videorefer_d": VIDEOREFER_D_QUESTION,
        }.get(bench)

        def emit_seg(sample, text, extra):
            pred, caption = text, sample.get("caption")
            if bench in ("pixrqa", "pixhqa"):
                # the judged description stops before the seg boilerplate
                # (inference_PixRQA.py:260, inference_PixHQA.py:216)
                pred = text.split("The segmentation mask")[0]
            elif bench == "pixtrqa":
                # drop the leading temporal sentence from both sides + the
                # seg boilerplate (inference_PixTRQA.py:289-292); the span
                # itself is parsed from the FULL output below
                if "." in text:
                    pred = text.split(".", 1)[1]
                pred = pred.split("The segmentation mask")[0]
                if caption and "." in caption:
                    caption = caption.split(".", 1)[1]
            rec: Dict[str, Any] = {
                "id": sample["id"],
                "video": sample["video_name"],
                "pred": pred,
                "caption": caption,
            }
            if bench == "pixtrqa":
                rec["span"] = parse_temporal_span(text)
            if bench == "videorefer_q":
                # the q-bench scorer reads Answer/pred/type
                # (eval_videorefer_bench_q.py:25-40)
                rec["Answer"] = sample["line"].get("Answer")
                rec["type"] = sample["line"].get("type")
            # masks BEFORE the JSONL row: a mid-emit failure then leaves no
            # row behind, so the per-sample fallback can safely retry the
            # sample without double-counting it in the scorer
            if extra.get("pred_masks"):
                save_mask_pngs(mask_dir, sample["id"], extra["pred_masks"][0])
            writer.write(rec)

        _seg_refer_loop(ds, model, tokenizer, args, emit_seg, question=question)
    elif bench == "mvbench":
        ds = MCQABenchmark(args.video_folder, questions,
                           image_size=image_size, **frames_kw)
        def emit_mcqa(s, text):
            writer.write(
                {
                    "id": s["id"],
                    "pred": match_mc_answer(text, s["options"]),
                    "gt": s["gt"],
                    "task_type": s["task_type"],
                    "raw": text,
                }
            )
        _qa_loop(ds, model, tokenizer, args, emit_mcqa)
    elif bench == "tvg":
        ds = TVGBenchmark(args.video_folder, questions,
                          image_size=image_size, **frames_kw)
        def emit_tvg(s, text):
            writer.write(
                {"id": s["id"], "vid": s["vid"], "pred": text, "gt": s["gt"]}
            )
        _qa_loop(ds, model, tokenizer, args, emit_tvg)
    elif bench == "mevis":
        ds = SegReferBenchmark(args.video_folder, questions,
                               image_size=image_size,
                               sam_image_size=sam_image_size, **frames_kw)

        def emit_mevis(sample, out):
            # masks before the row (see emit_seg): keeps a mid-emit failure
            # retryable without a duplicate JSONL row
            if out.get("pred_masks"):
                save_mask_pngs(mask_dir, sample["id"], out["pred_masks"][0])
            writer.write({"id": sample["id"], "video": sample["video_name"]})

        def mevis_step(sample):
            conv = sample["line"]["conversations"]
            return mm_infer(
                sample["video"], conv, model, tokenizer, modal="video",
                choice=3, images_sam=sample.get("images_sam"),
                label_size=(sample["height"], sample["width"]), seg=True,
            )

        # input-[SEG] seg eval (reference inference_video_Seg_MeVis.py:
        # 258-271, path B) — batched through mm_infer_batch when --batch > 1
        bs = max(1, getattr(args, "batch", 1))
        idx = 0
        while idx < len(ds):
            group = []
            for i in range(idx, min(idx + bs, len(ds))):
                try:
                    group.append(ds[i])
                except Exception:
                    _failed("load")
            idx += bs
            if not group:
                continue
            if bs > 1 and len(group) > 1:
                emitted = 0
                try:
                    results = mm_infer_batch(
                        [
                            {
                                "video": s["video"],
                                "instruct": s["line"]["conversations"],
                                "images_sam": s.get("images_sam"),
                                "label_size": (s["height"], s["width"]),
                            }
                            for s in group
                        ],
                        model, tokenizer, modal="video", choice=3,
                    )
                    for s, (_, out) in zip(group, results):
                        emit_mevis(s, out)
                        emitted += 1
                    continue
                except Exception:
                    _failed("batch")  # fall through to per-sample
                    # never re-emit samples already written by the batch
                    group = group[emitted:]
            for s in group:
                try:
                    emit_mevis(s, mevis_step(s))
                except Exception:
                    _failed("sample")
    else:
        raise ValueError(f"unknown benchmark {bench}")
    writer.close()


def _seg_refer_loop(ds, model, tokenizer, args, emit, question=None):
    """Seg/refer benchmark loop with optional batching (--batch > 1):
    region-prompted QA + path-A [SEG] masks run through one batched
    dispatch + one batched SAM2 propagation per group (api.mm_infer_batch),
    with per-sample fallback on any batch failure."""
    bs = max(1, getattr(args, "batch", 1))
    idx = 0
    while idx < len(ds):
        group = []
        for i in range(idx, min(idx + bs, len(ds))):
            try:
                group.append(ds[i])
            except Exception:
                _failed("load")
        idx += bs
        if not group:
            continue
        if bs > 1 and len(group) > 1:
            emitted = 0
            try:
                results = mm_infer_batch(
                    [
                        {
                            "video": s["video"],
                            "instruct": _seg_refer_question(s, args, question),
                            "masks": s.get("masks"),
                            "ann_indices": s.get("ann_indices"),
                            "frame": s.get("frame"),
                            "images_sam": s.get("images_sam"),
                            "label_size": (s["height"], s["width"]),
                        }
                        for s in group
                    ],
                    model, tokenizer, modal="video",
                    choice=SEG_REFER_CHOICE.get(args.benchmark, 2),
                    max_new_tokens=args.max_new_tokens,
                )
                for s, (text, extra) in zip(group, results):
                    emit(s, text, extra)
                    emitted += 1
                continue
            except Exception:
                _failed("batch")  # fall through to per-sample
                # skip samples the batch path already emitted
                group = group[emitted:]
        for s in group:
            try:
                text, extra = _seg_refer_step(
                    model, tokenizer, s, args, question=question
                )
                emit(s, text, extra)
            except Exception:
                _failed("sample")


def _qa_loop(ds, model, tokenizer, args, emit):
    """QA-style benchmark loop: batched through one prefill/decode dispatch
    when --batch > 1 (beyond-reference serving path, api.mm_infer_batch —
    decode weight traffic amortizes across samples), with per-sample
    mm_infer fallback on any batch failure so one bad sample never drops
    its batchmates (the reference's per-sample try/except contract)."""
    bs = max(1, getattr(args, "batch", 1))
    idx = 0
    while idx < len(ds):
        group = []
        for i in range(idx, min(idx + bs, len(ds))):
            try:
                group.append(ds[i])
            except Exception:
                _failed("load")
        idx += bs
        if not group:
            continue
        if bs > 1 and len(group) > 1:
            emitted = 0
            try:
                results = mm_infer_batch(
                    [{"video": s["video"], "instruct": s["question"]}
                     for s in group],
                    model, tokenizer, modal="video",
                    max_new_tokens=args.max_new_tokens,
                )
                for s, (text, _) in zip(group, results):
                    emit(s, text)
                    emitted += 1
                continue
            except Exception:
                _failed("batch")  # fall through to per-sample
                # skip samples the batch path already emitted
                group = group[emitted:]
        for s in group:
            try:
                text, _ = mm_infer(
                    s["video"], s["question"], model, tokenizer,
                    modal="video", max_new_tokens=args.max_new_tokens,
                )
                emit(s, text)
            except Exception:
                _failed("sample")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m ufvideo_tpu_torch.eval.run",
                                description="UFVideo benchmark runner")
    p.add_argument("--benchmark", required=True,
                   choices=["pixrqa", "pixhqa", "pixtrqa", "tvg", "mevis",
                            "mvbench", "videorefer_d", "videorefer_q"])
    p.add_argument("--model-path", default="")
    p.add_argument("--sam-path", default="")
    p.add_argument("--tokenizer-path", default="")
    p.add_argument("--video-folder", required=True)
    p.add_argument("--question-file", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--num-chunks", type=int, default=0)
    p.add_argument("--mode", choices=["single", "multi"], default="single",
                   help="videorefer_d: single-frame vs all-frame regions "
                        "(inference_videorefer_d_bench.py:270)")
    p.add_argument("--num-sam-frames", type=int, default=0)
    p.add_argument("--num-frames", type=int, default=0,
                   help="override the video frame budget (default NUM_FRAMES)")
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--batch", type=int, default=1,
                   help="samples per batched dispatch for QA benchmarks "
                        "(mvbench/tvg and the seg/refer family); "
                        "1 = reference-style bs=1 loop")
    p.add_argument("--quant", default="", choices=["", "int8", "int4"],
                   help="weight-only LLM quantization (the bnb 8/4-bit "
                        "load analog)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache (capacity lever for large --batch)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="prefill this many sequences at a time (bounds "
                        "batched-prefill HBM transients; 0 = whole batch)")
    p.add_argument("--spec-decode", type=int, default=0,
                   help="prompt-lookup speculative decoding with this draft "
                        "length (greedy-exact; amortizes the per-token "
                        "weight reads that bound bs-1 decode; 0 = off)")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: this rank's card (cuda:$LOCAL_RANK when "
                        "set) unless 'cpu' is given")
    return p


if __name__ == "__main__":
    # rank identity only (RANK / WORLD_SIZE, LOCAL_RANK for the card): each
    # process evaluates its chunk and writes its own files
    run_benchmark(build_parser().parse_args())
