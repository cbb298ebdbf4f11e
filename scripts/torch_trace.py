"""Where the port's time goes on the card: one full-width video-QA request,
one full-width ``[SEG]`` segmentation request, one full-width quantised
region-referring request and one full-width quantised ``[SEG]`` request
under ``torch.profiler``.

    python3 scripts/torch_trace.py [--new-tokens 16] [--trace out.json] [--routing JSON]

Builds the full-width model (random bf16 weights, seed 0), warms it up with
one ``mm_infer``, then profiles the stages of a request on 32 uint8 frames
(480x640): preprocess + encode, prefill with the first token, and prefill
with ``--new-tokens`` tokens; then those of a ``[SEG]`` request (a ``[SEG]``
in the input, 4 uint8 frames for SAM2 Hiera-L, one object): the LLM's
forward with the ``[SEG]`` head, SAM preprocess + Hiera + FPN encode,
frame-0 conditioning, the tracked frames, and the mask upsampling. Then it
frees that model, builds the int8 runtime (``quant_llm="int8"``, int8 KV
cache, W8A8 SigLIP) and profiles a referring request's stages: video encode,
region encode, prefill with the first token, and prefill with
``--new-tokens`` tokens, from which the device time of one int8 decode step
follows; and, on that runtime (its SAM2 has a W8A8 Hiera trunk), the stages
of the ``[SEG]`` request again. Then the referring request's stages on an
int4 runtime (``quant_llm="int4"``, bf16 cache and towers), and one int4
decode step. With ``--routing``, it then builds the int8 runtime under that
``VisionRouting`` (its fields as JSON) and profiles its video encode and
``[SEG]`` stages too. For
each it prints the wall time, the device-busy time (union of kernel
intervals), the device's idle share, and the kernels with the most device
time. Needs one CUDA card.

    python3 scripts/torch_trace.py --routing \
        '{"siglip_int8_fused": false, "sam2_int8_special": false}'
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _busy_us(intervals):
    """Length of the union of [start, end) intervals, in microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--trace", default="", help="write a chrome trace here")
    ap.add_argument("--routing", default="", help="also trace the quantised runtime's encode "
                    "and [SEG] request under this VisionRouting, its fields as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: needs a CUDA card", flush=True)
        return 1

    from ufvideo_tpu_torch import mm_infer, model_init
    from ufvideo_tpu_torch.api import _assemble_input_ids
    from ufvideo_tpu_torch.configs import UFVideoConfig, VisionRouting
    from ufvideo_tpu_torch.ops.image_pipeline import siglip_preprocess_device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    rt, _, tok = model_init(cfg=UFVideoConfig(), device=dev, seed=0)
    frames = np.random.default_rng(0).integers(0, 256, (32, 480, 640, 3), dtype=np.uint8)
    question = "What happens in this video?"
    mm_infer(frames, question, rt, tok, max_new_tokens=4)  # build + warm up
    images_sam = np.random.default_rng(1).integers(0, 256, (4, 480, 640, 3), dtype=np.uint8)
    conv = [{"from": "human", "value": "<video>\nPlease segment the cat."},
            {"from": "gpt", "value": "It is [SEG]."}]
    mm_infer(frames, conv, rt, tok, choice=3, images_sam=images_sam, label_size=(480, 640),
             seg=True)
    torch.cuda.synchronize()

    ids = _assemble_input_ids(question, 1, "<video>", tok)
    seg_ids = _assemble_input_ids(conv, 3, "<video>", tok)
    sync = torch.cuda.synchronize
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("stage:encode"):
            pixels = siglip_preprocess_device(
                torch.from_numpy(frames).to(dev), rt.cfg.compute_dtype)
            feats = rt.encode_video(pixels[None])
            sync()
        with record_function("stage:prefill"):
            rt.generate(ids, feats, max_new_tokens=1)
            sync()
        with record_function("stage:prefill+decode"):
            toks, _, _ = rt.generate(ids, feats, max_new_tokens=args.new_tokens)
            sync()
        lows = _seg_stages(rt, seg_ids, feats, images_sam, "seg")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    out = {"card": smi, "generated": len(toks)}
    out.update(_summarise(prof))

    # the quantised referring requests, each on a runtime of its own: int8
    # (int8 KV cache, W8A8 SigLIP, and its [SEG] request), then int4
    del rt, feats, lows
    torch.cuda.empty_cache()
    qcfg = UFVideoConfig().replace(quant_llm="int8", quant_kv=True, quant_vision=True)
    rt, _, tok = model_init(cfg=qcfg, device=dev, seed=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as qprof:
        feats, qtoks = _referring_stages(rt, tok, frames, args.new_tokens, "int8")
        # the [SEG] request on the quantised runtime (W8A8 Hiera trunk)
        mm_infer(frames, conv, rt, tok, choice=3, images_sam=images_sam,
                 label_size=(480, 640), seg=True)  # warm up
        sync()
        _seg_stages(rt, seg_ids, feats, images_sam, "int8 seg")
    if args.trace:
        qprof.export_chrome_trace(args.trace.replace(".json", "") + ".int8.json")
    out["generated_int8"] = len(qtoks)
    out.update(_summarise(qprof))
    out["int8 decode step"] = _decode_step(out, "int8", len(qtoks))
    del rt, feats
    torch.cuda.empty_cache()
    rt4, _, tok = model_init(cfg=UFVideoConfig().replace(quant_llm="int4"), device=dev, seed=0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof4:
        _, toks4 = _referring_stages(rt4, tok, frames, args.new_tokens, "int4")
    out["generated_int4"] = len(toks4)
    out.update(_summarise(prof4))
    out["int4 decode step"] = _decode_step(out, "int4", len(toks4))
    del rt4
    torch.cuda.empty_cache()

    if args.routing:  # the same quantised runtime under another routing
        routing = VisionRouting(**json.loads(args.routing))
        out["routing"] = str(routing)
        rt, _, tok = model_init(cfg=qcfg, device=dev, seed=0, routing=routing)
        mm_infer(frames, conv, rt, tok, choice=3, images_sam=images_sam,
                 label_size=(480, 640), seg=True)  # warm up
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as rprof:
            with record_function("stage:routed int8 encode"):
                pixels = siglip_preprocess_device(
                    torch.from_numpy(frames).to(dev), rt.cfg.compute_dtype)
                feats = rt.encode_video(pixels[None])
                sync()
            _seg_stages(rt, seg_ids, feats, images_sam, "routed int8 seg")
        if args.trace:
            rprof.export_chrome_trace(args.trace.replace(".json", "") + ".routed.json")
        out.update(_summarise(rprof))
    print(json.dumps(out, indent=1), flush=True)
    return 0


def _referring_stages(rt, tok, frames, new_tokens: int, prefix: str):
    """A warmed-up referring request on ``rt`` (one annotated frame, one
    mask) under ``stage:<prefix> ...`` ranges of the running profile: video
    encode, region encode, prefill with the first token, and prefill with
    ``new_tokens`` tokens. Returns the video features and the tokens."""
    from ufvideo_tpu_torch import mm_infer
    from ufvideo_tpu_torch.api import _assemble_input_ids
    from ufvideo_tpu_torch.ops.image_pipeline import siglip_preprocess_device

    dev, sync = rt.device, torch.cuda.synchronize
    mask = np.zeros((1, 480, 640), np.float32)
    mask[0, 120:360, 213:426] = 1.0
    region = (frames[7:8], mask, [[0]])
    question = "What is <region> doing in this video?"
    mm_infer(frames, question, rt, tok, masks=mask, frame=region[0], ann_indices=[[0]],
             max_new_tokens=4)  # warm up
    sync()
    ids = _assemble_input_ids(question, 1, "<video>", tok)
    with record_function(f"stage:{prefix} encode"):
        pixels = siglip_preprocess_device(torch.from_numpy(frames).to(dev), rt.cfg.compute_dtype)
        feats = rt.encode_video(pixels[None])
        sync()
    with record_function(f"stage:{prefix} region encode"):
        rfeats, counts = rt.pack_and_encode_regions(*region)
        sync()
    with record_function(f"stage:{prefix} prefill"):
        rt.generate(ids, feats, rfeats, counts, max_new_tokens=1)
        sync()
    with record_function(f"stage:{prefix} prefill+decode"):
        toks, _, _ = rt.generate(ids, feats, rfeats, counts, max_new_tokens=new_tokens)
        sync()
    return feats, toks


def _decode_step(out: dict, prefix: str, generated: int) -> dict:
    """One decode step's wall, device-busy time and kernels: the prefill
    with ``generated`` tokens less the prefill with one, a step each."""
    a, b = out[f"stage:{prefix} prefill"], out[f"stage:{prefix} prefill+decode"]
    steps = max(generated - 1, 1)
    return {"wall_ms": (b["wall_ms"] - a["wall_ms"]) / steps,
            "device_busy_ms": (b["device_busy_ms"] - a["device_busy_ms"]) / steps,
            "kernels": (b["kernels"] - a["kernels"]) / steps}


def _seg_stages(rt, seg_ids, feats, images_sam, prefix: str):
    """The stages of a path-B ``[SEG]`` request on ``rt`` under
    ``stage:<prefix> ...`` ranges of the running profile; returns the
    per-frame low-res mask logits."""
    from ufvideo_tpu_torch.models.sam2.video import (
        encode_video_frames, init_on_first_frame, masks_to_video_res, track_frame)
    from ufvideo_tpu_torch.ops.image_pipeline import sam_preprocess_device

    sam, dev, sync = rt.model.sam, rt.device, torch.cuda.synchronize
    with record_function(f"stage:{prefix} llm forward + [SEG] head"):
        hidden, plan = rt.forward_hidden_states(seg_ids, feats)
        pos = [int(plan.text_pos_map[0][i]) - 1
               for i, t in enumerate(seg_ids) if t == rt.ids.seg]
        emb = rt.model.seg_embeddings(hidden[0, pos])[:, None, :]
        sync()
    with record_function(f"stage:{prefix} sam preprocess + hiera + fpn"):
        images = sam_preprocess_device(torch.from_numpy(images_sam).to(dev), rt.cfg.compute_dtype)
        sfeats = encode_video_frames(sam, images)
        sync()
    with record_function(f"stage:{prefix} frame-0 conditioning"):
        state, low = init_on_first_frame(sam, sfeats, emb)
        sync()
    lows = [low]
    with record_function(f"stage:{prefix} tracked frames"):
        for fi in range(1, images_sam.shape[0]):
            state, low = track_frame(sam, state, fi, sfeats.s0[fi], sfeats.s1[fi],
                                     sfeats.s2[fi], sfeats.pos2, num_frames=images_sam.shape[0])
            lows.append(low)
        sync()
    with record_function(f"stage:{prefix} upsample"):
        masks_to_video_res(torch.stack(lows), 480, 640).cpu()
        sync()
    return lows


def _family(name: str) -> str:
    """Who wrote a device operation: the port, PyTorch's own elementwise /
    reduction / copy kernels, a library (cuBLAS, CUTLASS, cuDNN), a copy."""
    if "ufv::" in name or ("(anonymous namespace)::" in name and "at::native" not in name):
        return "port kernels"
    if "at::native" in name:
        return "pytorch elementwise / reduce / copy"
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy / memset"
    return "library"


def _summarise(prof) -> dict:
    """Per ``stage:`` range: wall, device-busy time, idle share, device time
    by ``_family`` and the twelve kernels with the most device time (names
    cut to 70 characters, the times of names that then agree summed)."""
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in events if e.name.startswith("stage:") and e.device_type == cpu}
    kernels = [e for e in events
               if e.device_type == cuda and not e.name.startswith("stage:")]
    out = {}
    for stage, (s, e) in ranges.items():
        inside = [(k.time_range.start, k.time_range.end) for k in kernels
                  if s <= k.time_range.start < e]
        busy = _busy_us(inside)
        by_name, by_family = defaultdict(float), defaultdict(float)
        for k in kernels:
            if s <= k.time_range.start < e:
                by_name[k.name[:70]] += k.time_range.end - k.time_range.start
                by_family[_family(k.name)] += k.time_range.end - k.time_range.start
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        wall = e - s
        out[stage] = {
            "wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / wall if wall else None,
            "kernels": len(inside),
            "family_ms": {n: round(t / 1e3, 3) for n, t in sorted(by_family.items())},
            "top_ms": {n: round(t / 1e3, 3) for n, t in top},
        }
    return out


if __name__ == "__main__":
    sys.exit(main())
