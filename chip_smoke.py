"""Build the port's CUDA kernels and drive its video-QA, [SEG] segmentation,
streaming, speculative and batched serving, checkpoint export and loading,
quantised region-referring, quantised [SEG], HTTP serving and
continuous-batching engine paths, its launchers, its training, its eval
harness, its other projectors and the CLIP tower on one GPU.

    python3 chip_smoke.py                 # all phases (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # phases 0-2: build + kernel checks
    python3 chip_smoke.py --match w8a8    # phases 0-2 on the kernels so named
    python3 chip_smoke.py --train-only    # phases 0-1 and 8 (training)
    python3 chip_smoke.py --eval-only     # phases 0-1, 3 and 9 (eval)
    python3 chip_smoke.py --projectors-only  # phases 0-2 and 10
    python3 chip_smoke.py --parallel-only    # phases 0-1 and 11

Phases, each printed as it runs; any failure exits non-zero:
  0. device: nvidia-smi name / power limit, torch and CUDA versions; TF32 off.
  1. build: compile csrc/*.cu with nvcc (in parallel), print the seconds
     and each kernel instance's registers, stack and spill bytes (ptxas).
  2. kernels: each kernel against its plain PyTorch version at the shapes
     the full-width path gives it, bf16, held to a limit scaled to the
     output (see check_close); for the block also its attention part alone;
     kernel / plain / library ms (CUDA events, median of 20 after warm-up,
     L2 flushed before each launch) beside the bound, and the kernel /
     library ratio of each shape, both timed in this call; for the
     LN-matmul, the block tail and the block at C = 1152 (SigLIP, Hiera's
     stage 4) also each launch's device time (torch.profiler,
     Timer.launches), the block's beside its library yardstick's; the
     GEMM route each product of every block shape and the probe's takes
     (the C side's plan, held equal to ops/hiera_block.block_gemm_plan). The probe's bf16
     product (the block GEMM alone) goes first. The quantised kernels
     take int8 / packed-int4 weights, an int8 cache and int8 block weights
     at the same widths, each with its own stated tolerance (the quantised
     products at rows 1, 2, 5 (the verify block of speculative decoding,
     B = 1 and K = 4), 8, 17 and 32, each with the grid it launched, its
     rate on the weight bytes, its ratio to the bound and, at one row, the
     2-32-row kernel's time); both decode kernels also at the engine's
     step (8 slots of a 4608-position cache, ragged, three at length 1);
     the W8A8 block
     also at Hiera-L's four windowed shapes, and the W8A8 q-pool block,
     LN-matmul and block tail at the shapes the quantised trunk gives them.
  3. path: model_init at full width (SigLIP-SO400M + STC-v35 + Qwen2-7B,
     bf16, random weights from a seed) on the card; mm_infer on 32 uint8
     frames (480x640, bicubic resize) with max_new_tokens=32; launch counts
     read around that one call; timings of encode / prefill / decode; all
     outputs finite; the video tokens, the final prefill hidden state and
     the logits of the first decode steps through the kernels against the
     plain versions, and their greedy tokens.
  4. [SEG]: on the same model, mm_infer with a [SEG] in the input (a
     choice-3 conversation), 32 video frames and 4 uint8 frames for SAM2
     Hiera-L at full width, one object; launch counts read around that one
     call and held to what the code predicts; masks [4, 480, 640] boolean;
     stage timings; the SAM2 kernel path against the plain path on the same
     [SEG] embedding (FPN level-2 features, low-res mask logits, mask IoU).
 4b. serving, on the same model: mm_infer_stream of phase 3's request in
     chunks of 8 (its ids and joined text equal phase 3's exactly; time to
     the first ids and delta, ms a token); mm_infer with spec_decode=4 (tokens
     equal phase 3's but at a near tie; drafted / accepted tokens, verify
     steps, ms a verify step; generate_stream under speculation gives the
     same tokens); mm_infer_batch of two questions and a <region> request on
     phase 3's video and phase 4's [SEG] request (path A's tokens equal each
     sample's own but at a near tie; path B's masks agree with phase 4's on
     >= 99% of each frame); each counted and held to what the code predicts.
  9. eval, on the same model (after 3b; in --eval-only after phase 3): the
     benchmark runner (eval.run.run_benchmark, in this process) on synthetic
     files in a temporary directory: two directories of 32 PNG frames of
     480x640 written by the port's codec, question files for mvbench, tvg,
     pixrqa (one RLE region on one frame, its SAM frame) and mevis (a [SEG]
     conversation, which segments all 32 frames, as the JAX run_benchmark does), 32
     new tokens, --num-sam-frames 4. mvbench, tvg and pixrqa at --batch 1; mvbench, pixrqa and mevis
     at --batch 2; mvbench as RANK 0 and 1 of WORLD_SIZE 2. Each run_benchmark call
     counted and held to what its inputs and outputs predict; no fallback and
     no traceback; each batch-1 record's text and tokens equal to the port's
     own mm_infer on the sample, each batch-2 record equal to its batch-1
     record but at a near tie, mevis's masks against each sample's own
     mm_infer on >= 99% of each frame; the mask PNGs read back equal to the
     masks run_benchmark got, bit for bit; the two ranks' merged records equal
     to the one-rank records; score_mcqa, score_seg --gt rle and score_tvg
     --durations, and eval_smoke on the card, as processes, each exiting 0.
     Seconds a sample for each benchmark and batch, the mm_infer calls' and
     the host's share, peak memory. Then on phase 5's int8 runtime (int8
     LLM, int8 KV, W8A8), while it lives: mvbench at --batch 1 and 2, the
     same checks.
 3b. checkpoints, on the same model (after 4b): the runtime written by the
     port's exporter (save_hf_checkpoint: one pytorch_model.bin of bf16 and
     config.json; SAM2 again as a standalone .gamma .pt) into a temporary
     directory, after a check that the disk holds it; then loaded back by
     model_init(model_path=, sam_path=): every parameter equal to phase 3's
     runtime bit for bit, phase 3's ids and phase 4's masks exactly; and
     with the serving configuration (int8 LLM, int8 KV, W8A8 towers): every
     parameter equal to model_init(cfg=that, seed) bit for bit, and phase
     3's question through the quantised kernels. Bytes, seconds, GB/s, the
     host's peak RSS and the device's peak; the directory is removed.
  5. referring, quantised: a new runtime with quant_llm="int8", quant_kv and
     quant_vision at full width; mm_infer with one annotated uint8 frame, one
     480x640 mask and a <region> in the prompt, 32 new tokens; launch counts
     read around that one call and held to what the configuration predicts;
     stage timings and peak memory; kernel path against plain path (video
     tokens, region tokens, final prefill hidden state, the first decode
     steps' logits). Then the same request on a quant_llm="int4" runtime
     (bf16 cache and towers) with 8 new tokens.
 5b. batched decode, on each phase-5 runtime: the request's video with 8
     questions of different lengths through UFVideoRuntime.generate_batch,
     16 new tokens; launches held to the prediction (every quantised
     product at 8 rows), ms a step, tok/s over the batch, peak memory; the
     first 4 decode steps' logits through the kernels against the plain
     versions.
 5c. serving, on each phase-5 runtime: the referring request with
     spec_decode=4 as in 4b (every verify product on the quantised kernel at
     5 rows; the int8 runtime's verify writes and reads its int8 cache); 5b's
     batch with prefill_chunk=3 (three chunks, the last clamped; tokens equal
     5b's but at a near tie; prefill ms and peak memory beside 5b's); on the
     int8 runtime, mm_infer_stream of the request (ids equal phase 5's). Each
     counted and held to what the code predicts.
  6. [SEG], quantised: a runtime with quant_llm="int8", quant_kv and
     quant_vision (W8A8 SigLIP and W8A8 Hiera trunk); the request of phase 4
     on it, launch counts held to what the configuration predicts, stage
     timings and peak memory, kernel path against plain path (FPN level-2
     features, mask logits, IoU). Then, on the same model,
     propagate_video_general (a language prompt and a box on two frames,
     both directions, stride 2) and segment_videos_batched on two videos,
     each counted, timed and held against the plain path.
 6b. serving over HTTP, on the phase-6 runtime: BatchingScheduler
     (max_batch=8) behind serve_http on 127.0.0.1; nine concurrent requests
     with 32 uint8 frames of 480x640 as base64 .npy: 6 questions and a
     <region> request, 32 new tokens (one batch of 7; tokens equal each
     request's own mm_infer but at a near tie), phase 4's [SEG] request (its
     RLE masks agree with its mm_infer masks on >= 99% of each frame) and a
     streamed <region> request (its server-sent deltas join to its mm_infer
     text); the stats show one batch of 7 and no fallback or error; launches
     read around the requests and held to the prediction; requests/s, p50 /
     p95 latency, mean batch, ms from the first request to the last reply,
     peak memory. Then the first question through submit with its frames
     as a uint8 tensor on the card: the numpy request's tokens.
 6c. the continuous-batching engine, on the phase-6 runtime: StreamingEngine
     (8 slots, chunks of 8, a 512-token cap, 2 admitters) takes 6b's first
     question alone, its second after the first's first chunk, then six at
     once from six client threads, one streamed; then a spec_k=4 engine (6
     slots) two staggered questions; 32 new tokens each. Tokens equal each
     question's 6b mm_infer tokens but at a near tie; the stream's deltas
     join to its text; completed = admissions = requests, no error, an
     admission of several requests, fewer chunks than serialized requests
     need, spec drafts; launches read around each engine and held to the
     prediction from its stats; requests/s, p50 / p95, prep / install /
     step seconds, peak memory.
 6d. the launchers, each a process of its own on the card: python -m
     ufvideo_tpu_torch.loadtest at full width (int8 LLM, uint8 frames, 8
     clients, 16 requests, 32 tokens; its JSON line printed, labelled
     synthetic: 16 completed, no error), then python -m
     ufvideo_tpu_torch.serve --tiny --engine --port 0: one request and one
     stream over HTTP, then SIGINT and a clean exit.
 8. training, each on a model of its own (random weights from the seed,
    bf16, one sample built in memory: 32 frames, one <region>, one [SEG]
    object on 4 SAM frames at 1024², ground truth at 480x640, through the
    Collator, PrefetchLoader and device_prefetch), three Trainer steps at
    lr 1e-4 with gradient checkpointing: 8a a LoRA (r 8, alpha 16, dropout
    0.05) finetune at full width and depth: every trainable gradient finite
    at each backward, the B factors' in all 28 layers and the projector's,
    region encoder's and text head's non-zero; launches and the backward's
    plain attention recomputes against the prediction; the loss falling;
    the kernel route against the plain route (loss, gradient cosines); a
    fresh Trainer resumed from checkpoint-2 repeats step 3's loss; the
    PEFT adapter served through model_init(model_path=, adapter_path=)
    against merge_for_eval (first logits) and mm_infer. 8b the default
    policy (full LLM finetune, towers frozen but the mask decoder) with the
    LLM cut to 4 layers: launches, the frozen towers bit for bit, the LLM
    and mask decoder moved, keep-1 rotation, a resume at step 3. Each
    prints step 2's time, trained tokens/s, peak memory and
    its wall time.
10. the other projectors, CLIP and the W8A8 backward (after phase 8; with
    --projectors-only after phase 2), at full width from the seed: 10a
    phase 3's QA request on model_init runtimes with the stc_connector
    (3332 video tokens) and the mlp2x_gelu projector (729), under phase 3's
    checks, launches held to the prediction; 10b linear, stp_connector,
    spatial_conv and spatial_pool alone on phase 3's SigLIP features [1, 32,
    729, 1152]: output shapes equal token_grid's count and the tabled one,
    finite, ms; export_projector -> convert_projector bit for bit for all
    six types; 10c the CLIP-L/14-336 tower (23 of 24 layers) on 32 frames of
    336²: kernel path against use_kernel=False at cosine >= 0.999, 23
    flash launches, encode ms and peak, its features through an
    stc_connector of width 1024 to 2873 tokens; 10d a backward through each
    W8A8 kernel at SigLIP's and Hiera-L's windowed shapes, the kernel
    forward against the plain W8A8 forward, both with the straight-through
    backward: gradient cosine >= 0.99 together, >= 0.95 a tensor.
11. parallelism (after phase 10; with --parallel-only after phase 1), at
    world 1 over NCCL (the card's machine has one card; several ranks are
    held to the JAX package on the CPU over gloo): 11a phase 8b's setting
    through maybe_initialize_distributed -> create_mesh(1, 1, 1) ->
    shard_params (FSDP2 units) -> make_train_step(mesh=) -> Trainer(mesh=),
    three steps against an unsharded Trainer from the same seed (bit for bit
    expected; else losses within 1e-3 and each trained tensor's change at
    cosine >= 0.999), launches held to the prediction, step 2's ms, peak
    GiB and the NCCL calls of a step (profiler); 11b ring_attention at
    Qwen2-7B's train shape against the plain attention (output and
    gradient cosines >= 0.999); 11c python -m torch.distributed.run
    --nproc_per_node 1 -m ufvideo_tpu_torch.train --tiny for two steps on
    PNG frames (one rank of layout 1: the unsharded step), and the same with --fsdp 2 refused naming the world and the
    card; 11d per_chip_state_bytes of the 7B full finetune at (1, 4, 1),
    (1, 8, 1) and (1, 4, 2).
Then one JSON line with every kernel (launches = the sum over the counted
calls; launches_train_lora / _full the training runs', launches_eval /
_eval_int8 phase 9's, launches_parallel phase 11a's), the card line, and
the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
N_TIMED = 20
# kernel path vs plain path at full width; the run before this check read
# cosines of 0.9998 (video tokens, prefill hidden states) on an H100
PATH_COS = 0.999
# low-res mask logits of the [SEG] path, kernel path vs plain path: they sit
# behind 48 Hiera blocks, the memory attention and the mask decoder
SEG_COS = 0.99
# the same behind a W8A8 trunk: a block alone differs by up to 7.5e-3 in
# relative Frobenius norm (re-quantise flips), 48 of them stand in sequence
# before the FPN; limits stated before the first full-width run
SEG_QUANT_FEAT_COS, SEG_QUANT_COS = 0.99, 0.98


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAILED: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------- timing --

class Timer:
    """Device time of one call: a flush of L2 and a spin kernel go first,
    so the call is enqueued before its start event fires and finds its
    inputs in HBM, as each layer's call does on the real path."""

    def __init__(self, dev):
        self.flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def ms(self, fn, n=N_TIMED, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def launches(self, fn, n=N_TIMED):
        """Device ms of each launch one call of ``fn`` makes, in launch
        order: [(kernel name, median ms)], from torch.profiler over ``n``
        calls, L2 flushed before each; [] when the trace lost events."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        name = lambda e: (e.name.replace("(anonymous namespace)::", "")
                          .removeprefix("void ").split("(")[0])
        ks = sorted((e.time_range.start, name(e),
                     (e.time_range.end - e.time_range.start) / 1e3)
                    for e in prof.events() if e.device_type == cuda)
        ks = [k for k in ks if "FillFunctor" not in k[1]]  # the flushes
        if not ks or len(ks) % n:
            return []
        per = len(ks) // n
        return [(ks[i][1], statistics.median(k[2] for k in ks[i::per])) for i in range(per)]


def log_launches(label, launches):
    if not launches:
        log(f"  {label}: per-launch breakdown lost (the trace dropped events)")
    for i, (name, ms) in enumerate(launches):
        log(f"  {label} launch {i + 1}/{len(launches)}: {ms:.4f} ms {name}")


def breakdown(timer, label, e, kernel, library):
    """Each launch's device time in one call of the kernel and of its
    library yardstick, into e["launch_ms"] and e["library_launch_ms"]."""
    e["launch_ms"] = timer.launches(kernel)
    log_launches(label, e["launch_ms"])
    e["library_launch_ms"] = timer.launches(library)
    log_launches(f"{label} library", e["library_launch_ms"])
    return e


def gemm_routes(label, rows, c, hw, mlp):
    """The block GEMM's route for each product of a block of ``rows`` rows
    (qkv, proj, fc1 where LN2 -> fc1 is not one LayerNorm-band launch, fc2;
    or the probe's f32 product where ``hw`` is None): the C side's
    block_gemm_plan on this card, held equal to the Python one."""
    from ufvideo_tpu_torch.ops import hiera_block as hb

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    products = ({"product": (rows, mlp, c)} if hw is None else
                {"qkv": (rows, 3 * hw, c), "proj": (rows, c, hw), "fc1": (rows, mlp, c),
                 "fc2": (rows, c, mlp)})
    if hw is not None and c <= hb.LN_MAX_C:
        del products["fc1"]
    f32 = hw is None
    routes = {}
    for name, (m, n, k) in products.items():
        plan = hb.block_gemm_plan(m, n, k, sms, f32)
        if hb.block_gemm_plan_on_card(m, n, k, 0, f32) != plan.code:
            fail(f"{label} {name}: the C side's GEMM plan differs from {plan}")
        routes[name] = (f"{plan.route}: grid {plan.grid}, {plan.tiles} tiles, "
                        f"{plan.stages} stages, {plan.smem} B")
        log(f"  {label} {name} [M {m}, N {n}, K {k}]: GEMM route {routes[name]}")
    return routes


def bound_ms(nbytes: float, flops: float, int8_ops: float = 0.0):
    """The larger of bytes over the memory rate and operations over the peak
    rate of their type (bf16 and int8 products add up)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------- kernels --

# Both sides take bf16 operands with f32 accumulation and round the output
# to bf16 once, at other places in the sum: one bf16 step is 2^-8..2^-7 of a
# value. An element may differ by REL of its row's RMS (the row is the last
# axis: one head's output, one token's residual) plus RTOL (2.5 bf16 steps)
# of itself; the whole tensor by REL in relative Frobenius norm. A kernel
# that dropped a 128-key chunk or misplaced the length mask by one key moves
# typical elements by several percent of their row's RMS and fails. The
# block rounds four intermediates to bf16 (LN output, qkv, attention, MLP
# hidden), each of which may land one bf16 step apart on the two sides, so
# its elements get BLOCK_REL of the row's RMS: the unfused library block
# (cuBLAS, SDPA) needs 2.3e-2 against the same plain version, the kernel
# 2.4e-2, the attention part alone 3.9e-2 (H100 run of this script).
REL, RTOL, BLOCK_REL = 1e-2, 2e-2, 5e-2


# The quantised products give f32 sums of the same exact terms in another
# order (18944 terms at most): both sides within QREL of a row's RMS.
QREL = 1e-3


def tol_text(row_rel: float, rtol: float = RTOL, fro: float = REL) -> str:
    return f"|d| <= {row_rel}*rms(row) + {rtol}*|plain| and ||d||/||plain|| <= {fro}"


def check_close(name, got, want, row_rel=REL, fatal=True, rtol=RTOL, fro=REL):
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    max_abs = float(err.max())
    row_rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    excess = float((err - (row_rel * row_rms + rtol * want.abs() + 1e-6)).max())
    rel_fro = float((got - want).norm() / want.norm().clamp_min(1e-30))
    ok = excess <= 0 and rel_fro <= fro
    # the smallest row-RMS factor that would have passed, at rtol
    need = float(((err - rtol * want.abs()) / row_rms.clamp_min(1e-30)).max())
    log(f"  {name}: max_abs_err {max_abs:.3e}, rel_fro {rel_fro:.3e}, needs "
        f"{need:.2e}*rms(row) (tolerance {tol_text(row_rel, rtol, fro)}) "
        f"{'ok' if ok else 'EXCEEDED'}")
    if not ok and fatal:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def bench(timer, label, kernel, plain, library, nbytes_, flops, row_rel=REL, check=None,
          int8_ops=0.0):
    """One shape of one kernel: check against the plain version (``check``
    replaces ``check_close``), then time kernel / plain / library beside the
    bound."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (check or (lambda n, g, w: check_close(n, g, w, row_rel=row_rel)))(label, got, want)
    del got, want
    t_b, by = bound_ms(nbytes_, flops, int8_ops)
    return with_ratio(dict(
        shape=label, max_abs_err=err, ms=timer.ms(kernel), plain_ms=timer.ms(plain),
        library_ms=timer.ms(library) if library else None, bound_ms=t_b, bound_by=by))


def with_ratio(e):
    """kernel ms / library ms, both measured in this call on this card: the
    number that compares two designs across calls (cards differ)."""
    e["library_ratio"] = e["ms"] / e["library_ms"] if e.get("library_ms") else None
    return e


def ratio_text(e) -> str:
    r = e.get("library_ratio")
    return "" if r is None else f", kernel / library {r:.3f}"


def log_shapes(k):
    for e in k.get("shapes", ()):
        lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
        log(f"    {e['shape']}: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
            f"library {lib}, bound {e['bound_ms']:.4f} ms ({e['bound_by']}){ratio_text(e)}")


# tokens of the mask decoder at full width: 6 output tokens (object score,
# IoU, 4 masks) + the padded empty point prompt's 2, + the [SEG] embedding
# on the prompted frame 0 only
MASK_DECODER_TOKENS = (9, 8)


def mask_decoder_shapes(tokens=MASK_DECODER_TOKENS, image_tokens=4096):
    """(Sq, Skv, head dim) of the mask decoder's attentions, 8 heads each:
    the tokens on themselves at the full width of 256, tokens on the image
    and the image on the tokens at the halved width of 128."""
    return [s for t in tokens for s in ((t, t, 32), (t, image_tokens, 16), (image_tokens, t, 16))]


def flash_sam_shapes(dev, timer, gen):
    """flash_attention at the shapes SAM2 gives it at full width: a Hiera
    global block, memory self-attention, memory cross-attention on the
    first tracked frame (slot 0 valid, slots 1-6 and all but the first
    pointer's 4 tokens masked), and the mask decoder's small attentions on
    the prompted and on the tracked frames."""
    from ufvideo_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    import torch.nn.functional as F

    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
    out = []
    shapes = {
        "Hiera global block q=k=v [4,4096,8,72]": (4, 4096, 4096, 8, 72, None),
        "memory self-attention [1,4096,1,256]": (1, 4096, 4096, 1, 256, None),
        "memory cross-attention q [1,4096,1,256] k/v [1,28736,1,256] kv_mask 4100 valid":
            (1, 4096, 7 * 4096 + 64, 1, 256, 4100),
    }
    for sq, skv, d in mask_decoder_shapes():
        shapes[f"mask decoder q [1,{sq},8,{d}] k/v [1,{skv},8,{d}]"] = (1, sq, skv, 8, d, None)
    for label, (b, sq, skv, h, d, n_valid) in shapes.items():
        q, k, v = mk(b, sq, h, d), mk(b, skv, h, d), mk(b, skv, h, d)
        mask = None
        if n_valid is not None:
            mask = torch.zeros(b, skv, dtype=torch.bool, device=dev)
            mask[:, :4096] = True
            mask[:, 7 * 4096:7 * 4096 + (n_valid - 4096)] = True
        seen = skv if n_valid is None else n_valid
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        am = None if mask is None else mask[:, None, None, :]
        out.append(bench(
            timer, f"flash_attention [{label}]",
            lambda: flash_attention(q, k, v, kv_mask=mask),
            lambda: flash_attention_plain(q, k, v, kv_mask=mask),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am),
            nbytes(q, q) + 2 * b * seen * h * d * 2, 4 * b * h * sq * seen * d))
    return out


def kernel_flash(dev, timer, gen):
    from ufvideo_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    import torch.nn.functional as F

    def inputs(b, sq, skv, lens):
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
        return (mk(b, sq, 28, 128), mk(b, skv, 4, 128), mk(b, skv, 4, 128),
                torch.tensor(lens, dtype=torch.int32, device=dev))

    errs = []
    for label, (b, sq, skv, lens) in {
        "prefill B=1 S=2816 kv_lens 2770": (1, 2816, 2816, [2770]),
        "B=2 ragged kv_lens": (2, 700, 700, [700, 333]),
        "Sq<Skv buffer-end causal offset": (1, 200, 1000, [1000]),
    }.items():
        q, k, v, kl = inputs(b, sq, skv, lens)
        got = flash_attention(q, k, v, causal=True, kv_lens=kl)
        want = flash_attention_plain(q, k, v, causal=True, kv_lens=kl)
        torch.cuda.synchronize()
        errs.append(check_close(f"flash_attention [{label}]", got, want))

    q, k, v, kl = inputs(1, 2816, 2816, [2770])
    sq = skv = 2816
    rows = torch.arange(sq)
    visible = torch.clamp(torch.minimum(rows + 1, torch.tensor(2770)), min=0)
    flops = 4 * 28 * 128 * int(visible.sum())
    t_b, by = bound_ms(nbytes(q, q) + 2 * 2770 * 4 * 128 * 2, flops)
    ms = timer.ms(lambda: flash_attention(q, k, v, causal=True, kv_lens=kl))
    plain = timer.ms(lambda: flash_attention_plain(q, k, v, causal=True, kv_lens=kl))
    col = torch.arange(skv, device=dev)
    mask = ((col[None, :] <= torch.arange(sq, device=dev)[:, None]) & (col < 2770)[None])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None, None], enable_gqa=True))
    return dict(name="flash_attention", route="cuda",
                source="ufvideo_tpu_torch/csrc/flash_attention.cu",
                replaces="ufvideo_tpu/ops/flash_attention.py:274",
                max_abs_err=max(errs), tol=tol_text(REL), ms=ms, plain_ms=plain,
                bound_ms=t_b, bound_by=by, library_ms=lib,
                shape="q [1,2816,28,128] k/v [1,2816,4,128] causal kv_lens [2770]",
                shapes=flash_sam_shapes(dev, timer, gen) + [flash_clip_shape(dev, timer)])


def flash_clip_shape(dev, timer):
    """flash_attention at the CLIP-L/14-336 tower's shape (phase 10c): 32
    frames of 577 tokens, 16 heads of 64, no mask: head dim 64 takes the
    128-key tile, and 577 fills neither the query block nor the key tile,
    so both tails are masked. Its inputs come from a generator of their own,
    so the draws of the other kernels do not move."""
    from ufvideo_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(577)
    q, k, v = (torch.randn(CLIP_FRAMES, 577, 16, 64, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return bench(timer, f"flash_attention [CLIP-L/14-336 q=k=v [{CLIP_FRAMES},577,16,64]]",
                 lambda: flash_attention(q, k, v), lambda: flash_attention_plain(q, k, v),
                 lambda: F.scaled_dot_product_attention(qt, kt, vt),
                 nbytes(q, k, v, q), 4 * CLIP_FRAMES * 16 * 577 * 577 * 64)


# (label, B, S, lens) of the decode shapes phase 2 holds: Qwen2-7B's 4 kv
# heads of 7 query heads at the QA request's cache, batch 1 and a ragged 4;
# lens None takes the kind's batch-1 length. Then the engine's step (phase
# 6c): 8 slots of a 4608-position cache (max_seq_len 4096 + a 512-token
# cap), five live slots at 6b's prompt lengths a few tokens in, two never
# admitted and one retired (its length reset to 0) at length 1 over rows a
# former request left
DECODE_SHAPES = (("B=1 cache 2944 lens {}", 1, 2944, None),
                 ("B=4 ragged lens", 4, 2944, [2944, 1, 1500, 129]),
                 ("B=8 engine slots lens {}", 8, 4608, [2785, 1, 2794, 2819, 1, 2848, 1, 2851]))
DECODE_B1_LENS = {"bf16": [2771], "q8": [2800]}


def decode_inputs(kind, b, s, lens, gen, dev):
    """Random inputs of one decode shape for the bf16 ("bf16") or the int8
    ("q8") cache kernel, and the calls made on them: the public wrapper
    (``kernel``), the private launcher at a given chunk (``launch``), the
    plain version, SDPA on the (dequantised) cache, and the bytes of the
    valid cache (``seen``). Phase 2 and ``scripts/torch_decode_sweep.py``."""
    from ufvideo_tpu_torch.models.qwen2 import quantize_kv
    from ufvideo_tpu_torch.ops import decode_attention as da
    import torch.nn.functional as F

    mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = mk(b, 4, 7, 128), mk(b, 4, s, 128), mk(b, 4, s, 128)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
    qs = q.reshape(b, 28, 1, 128)
    if kind == "bf16":
        args, scales, kd, vd = (q, k, v, lens_t), (), k, v
        kernel, plain = da.ragged_decode_attention, da.ragged_decode_attention_plain
        row_bytes = 128 * 2
    else:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        args, scales = (q, k, v, ks, vs, lens_t), (ks, vs)
        kd = (k.float() * ks[..., None]).to(torch.bfloat16)
        vd = (v.float() * vs[..., None]).to(torch.bfloat16)
        kernel, plain = da.ragged_decode_attention_q8, da.ragged_decode_attention_q8_plain
        row_bytes = 128 + 4
    return dict(
        q=q, wrapper=kernel, kernel=lambda: kernel(*args), plain=lambda: plain(*args),
        launch=lambda chunk: da._launch(q, k, v, lens_t, chunk, None, *scales),
        library=lambda: F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask,
                                                        enable_gqa=True),
        seen=2 * sum(lens) * 4 * row_bytes)


def kernel_decode(dev, timer, gen, kind):
    """Both decode shapes of one kind: each held to its plain version and
    timed beside SDPA, with the split the wrapper launched (chunk, blocks,
    read back from the wrapper) and the rate on the valid cache's bytes."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for label, b, s, lens in DECODE_SHAPES:
        lens = lens or DECODE_B1_LENS[kind]
        t = decode_inputs(kind, b, s, lens, gen, dev)
        t["wrapper"].last_split = None
        cache = "cache" if kind == "bf16" else "int8 cache"
        e = bench(timer, f"q [{b},4,7,128] {cache} [{b},4,{s},128] {label.format(lens)}",
                  t["kernel"], t["plain"], t["library"], nbytes(t["q"], t["q"]) + t["seen"],
                  4 * sum(lens) * 28 * 128)
        chunk, blocks = t["wrapper"].last_split
        e["plan"] = dict(chunk=chunk, blocks=blocks, sms=sms)
        e["gb_per_s"] = t["seen"] / (e["ms"] * 1e-3) / 1e9
        log(f"    {e['shape']}: chunk {chunk}, {blocks} blocks on {sms} SMs, "
            f"{e['gb_per_s']:.0f} GB/s of the valid cache{ratio_text(e)}")
        shapes.append(e)
    name = "ragged_decode_attention" + ("" if kind == "bf16" else "_q8")
    return _kernel_entry(
        name, "ufvideo_tpu_torch/csrc/decode_attention.cu",
        "ufvideo_tpu/ops/decode_attention.py:" + ("200" if kind == "bf16" else "153"),
        tol_text(REL), shapes, shapes[0]["shape"])


def block_params(dev, gen, c, mlp, cin=None, front_extra=0):
    """Random parameters of one block: (ln1_s, ln1_b, wfront [cin, 3c +
    front_extra], bfront, wproj [c, c], bproj, ln2_s, ln2_b, w1, b1, w2, b2)."""
    bf = torch.bfloat16
    cin = cin or c
    rn = lambda *sh: torch.randn(*sh, generator=gen, device=dev)
    nf = 3 * c + front_extra
    return (
        (1 + 0.1 * rn(cin)).to(bf), (0.1 * rn(cin)).to(bf),
        (rn(cin, nf) * cin ** -0.5).to(bf), (0.1 * rn(nf)).to(bf),
        (rn(c, c) * c ** -0.5).to(bf), (0.1 * rn(c)).to(bf),
        (1 + 0.1 * rn(c)).to(bf), (0.1 * rn(c)).to(bf),
        (rn(c, mlp) * c ** -0.5).to(bf), (0.1 * rn(mlp)).to(bf),
        (rn(mlp, c) * mlp ** -0.5).to(bf), (0.1 * rn(c)).to(bf),
    )


def lib_tail(shortcut, att, params, approximate="none"):
    """Library yardstick of a block's tail: cuBLAS GEMMs, fused LN / GELU."""
    import torch.nn.functional as F

    wp, bp, l2s, l2b, w1, b1, w2, b2 = params
    n, s, c = shortcut.shape
    x1 = shortcut + torch.addmm(bp, att.reshape(n * s, -1), wp).reshape(n, s, c)
    h = F.layer_norm(x1, (c,), l2s, l2b, 1e-6).reshape(n * s, c)
    h = F.gelu(torch.addmm(b1, h, w1), approximate=approximate)
    return x1 + torch.addmm(b2, h, w2).reshape(n, s, c)


def hiera_shapes(dev, timer, gen):
    """fused_hiera_block at the four windowed-block shapes of Hiera-L on 4
    frames (gelu_exact, head dim 72, MLP 4C)."""
    from ufvideo_tpu_torch.ops.hiera_block import fused_hiera_block, fused_hiera_block_plain
    import torch.nn.functional as F

    out = []
    for n, s, c, heads in HIERA_BLOCK_SHAPES:
        hd, mlp = 72, 4 * c
        params = block_params(dev, gen, c, mlp)
        x = torch.randn(n, s, c, generator=gen, device=dev).to(torch.bfloat16)
        (l1s, l1b, wq, bq) = params[:4]

        def unfused():
            h = F.layer_norm(x, (c,), l1s, l1b, 1e-6)
            qkv = torch.addmm(bq, h.reshape(n * s, c), wq).reshape(n, s, 3, heads, hd)
            o = F.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4).unbind(0))
            return lib_tail(x, o.transpose(1, 2).reshape(n, s, c), params[4:])

        rows = n * s
        flops = 2 * rows * (3 * c * c + c * c + 2 * c * mlp) + 4 * n * heads * s * s * hd
        label = f"fused_hiera_block [Hiera x [{n},{s},{c}] {heads} heads, gelu_exact]"
        kernel = lambda: fused_hiera_block(x, params, heads, hd, act="gelu_exact")
        out.append(bench(
            timer, label, kernel,
            lambda: fused_hiera_block_plain(x, params, heads, hd, act="gelu_exact"),
            unfused, nbytes(x, x, *params), flops, row_rel=BLOCK_REL))
        if c == 1152:  # stage 4: the products of the SigLIP layer's width
            breakdown(timer, f"fused_hiera_block [{n},{s},{c}]", out[-1], kernel, unfused)
        out[-1]["gemm_routes"] = gemm_routes(f"[{n},{s},{c}]", rows, c, heads * hd, mlp)
    return out


def kernel_ln_matmul(dev, timer, gen):
    from ufvideo_tpu_torch.ops.hiera_block import fused_ln_matmul, fused_ln_matmul_plain
    import torch.nn.functional as F

    n, s, c, d = 4, 4096, 576, 1728
    l1s, l1b, w, b = block_params(dev, gen, c, 8)[:4]
    x = torch.randn(n, s, c, generator=gen, device=dev).to(torch.bfloat16)
    e = bench(
        timer, f"fused_ln_matmul [x [{n},{s},{c}] w [{c},{d}]]",
        lambda: fused_ln_matmul(x, l1s, l1b, w, b),
        lambda: fused_ln_matmul_plain(x, l1s, l1b, w, b),
        lambda: torch.addmm(b, F.layer_norm(x, (c,), l1s, l1b, 1e-6).reshape(n * s, c), w),
        nbytes(x, w, l1s, l1b, b) + n * s * d * 2, 2 * n * s * c * d)
    e["launch_ms"] = timer.launches(lambda: fused_ln_matmul(x, l1s, l1b, w, b))
    log_launches("fused_ln_matmul", e["launch_ms"])
    return dict(name="fused_ln_matmul", route="cuda",
                source="ufvideo_tpu_torch/csrc/hiera_block.cu",
                replaces="ufvideo_tpu/ops/hiera_block.py:695", tol=tol_text(REL), **e)


def kernel_block_tail(dev, timer, gen):
    from ufvideo_tpu_torch.ops.hiera_block import fused_block_tail, fused_block_tail_plain

    n, s, c, mlp = 4, 4096, 576, 2304
    params = block_params(dev, gen, c, mlp)[4:]
    mk = lambda: torch.randn(n, s, c, generator=gen, device=dev).to(torch.bfloat16)
    shortcut, att = mk(), mk()
    e = bench(
        timer, f"fused_block_tail [shortcut, att [{n},{s},{c}] MLP {mlp}, gelu_exact]",
        lambda: fused_block_tail(shortcut, att, params),
        lambda: fused_block_tail_plain(shortcut, att, params),
        lambda: lib_tail(shortcut, att, params),
        nbytes(shortcut, att, shortcut, *params), 2 * n * s * (c * c + 2 * c * mlp),
        row_rel=BLOCK_REL)
    e["launch_ms"] = timer.launches(lambda: fused_block_tail(shortcut, att, params))
    log_launches("fused_block_tail", e["launch_ms"])
    return dict(name="fused_block_tail", route="cuda",
                source="ufvideo_tpu_torch/csrc/hiera_block.cu",
                replaces="ufvideo_tpu/ops/hiera_block.py:819", tol=tol_text(BLOCK_REL), **e)


def kernel_qpool(dev, timer, gen):
    """fused_qpool_block at Hiera-L's three stage transitions on 4 frames."""
    from ufvideo_tpu_torch.ops.hiera_block import fused_qpool_block, fused_qpool_block_plain
    import torch.nn.functional as F

    shapes = []
    for n, s, cin, heads in HIERA_QPOOL_SHAPES:
        cout, hd, mlp = 2 * cin, 72, 8 * cin
        hw, ws, sq = heads * hd, int(s ** 0.5), s // 4
        params = block_params(dev, gen, cout, mlp, cin=cin, front_extra=cout)
        x = torch.randn(n, s, cin, generator=gen, device=dev).to(torch.bfloat16)
        (l1s, l1b, wf, bf_) = params[:4]

        def pool(v):
            v6 = v.reshape(n, ws // 2, 2, ws // 2, 2, v.shape[-1])
            return v6.amax(dim=4).amax(dim=2).reshape(n, sq, v.shape[-1])

        def unfused():
            h = F.layer_norm(x, (cin,), l1s, l1b, 1e-6)
            fr = torch.addmm(bf_, h.reshape(n * s, cin), wf).reshape(n, s, -1)
            q = pool(fr[..., :hw]).reshape(n, sq, heads, hd).transpose(1, 2)
            k = fr[..., hw:2 * hw].reshape(n, s, heads, hd).transpose(1, 2)
            v = fr[..., 2 * hw:3 * hw].reshape(n, s, heads, hd).transpose(1, 2)
            o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, sq, hw)
            return lib_tail(pool(fr[..., 3 * hw:]), o, params[4:])

        flops = (2 * n * s * cin * (3 * hw + cout) + 4 * n * heads * sq * s * hd
                 + 2 * n * sq * (hw * cout + 2 * cout * mlp))
        shapes.append(bench(
            timer, f"fused_qpool_block [x [{n},{s},{cin}] -> [{n},{sq},{cout}] {heads} heads]",
            lambda: fused_qpool_block(x, params, heads, hd, (2, 2)),
            lambda: fused_qpool_block_plain(x, params, heads, hd, (2, 2)),
            unfused, nbytes(x, *params) + n * sq * cout * 2, flops, row_rel=BLOCK_REL))
    first, rest = shapes[0], shapes[1:]
    first["max_abs_err"] = max(e["max_abs_err"] for e in shapes)
    return dict(name="fused_qpool_block", route="cuda",
                source="ufvideo_tpu_torch/csrc/hiera_block.cu",
                replaces="ufvideo_tpu/ops/hiera_block.py:1078", tol=tol_text(BLOCK_REL),
                shapes=rest, **first)


def kernel_hiera(dev, timer, gen):
    from ufvideo_tpu_torch.ops.hiera_block import fused_hiera_block, fused_hiera_block_plain
    import torch.nn.functional as F

    n, s, c, heads, hd, mlp = 32, 729, 1152, 16, 72, 4304
    bf = torch.bfloat16
    params = block_params(dev, gen, c, mlp)
    x = torch.randn(n, s, c, generator=gen, device=dev).to(bf)
    got = fused_hiera_block(x, params, heads, hd, act="gelu_tanh", eps=1e-6)
    want = fused_hiera_block_plain(x, params, heads, hd, act="gelu_tanh", eps=1e-6)
    torch.cuda.synchronize()
    err = check_close("fused_hiera_block [SigLIP layer, 32 x 729 x 1152]", got, want,
                      row_rel=BLOCK_REL)

    # the residual stream hides the attention part: with the MLP's output
    # zeroed and the projection the identity, block(x) - x is the window
    # attention's output (x small, so its bf16 rounding hides nothing)
    (l1s, l1b, wq, bq, wp, bp, l2s, l2b, w1, b1, w2, b2) = params
    eye, zc = torch.eye(c, device=dev, dtype=bf), torch.zeros(c, device=dev, dtype=bf)
    att_params = (l1s, l1b, wq, bq, eye, zc, l2s, l2b, w1, b1, torch.zeros_like(w2), zc)
    xs = (1e-2 * x.float()).to(bf)
    got = fused_hiera_block(xs, att_params, heads, hd, act="gelu_tanh", eps=1e-6)
    want = fused_hiera_block_plain(xs, att_params, heads, hd, act="gelu_tanh", eps=1e-6)
    torch.cuda.synchronize()
    err = max(err, check_close("fused_hiera_block [attention part alone]",
                               got.float() - xs.float(), want.float() - xs.float(),
                               row_rel=BLOCK_REL))

    rows = n * s
    flops = 2 * rows * (3 * c * c + c * c + 2 * c * mlp) + 4 * n * heads * s * s * hd
    t_b, by = bound_ms(nbytes(x, x, *params), flops)
    ms = timer.ms(lambda: fused_hiera_block(x, params, heads, hd, act="gelu_tanh"))
    plain = timer.ms(lambda: fused_hiera_block_plain(x, params, heads, hd, act="gelu_tanh"))

    def unfused():  # library yardstick: cuBLAS GEMMs, SDPA, fused LN / GELU
        h = F.layer_norm(x, (c,), l1s, l1b, 1e-6)
        qkv = torch.addmm(bq, h.reshape(rows, c), wq).reshape(n, s, 3, heads, hd)
        o = F.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4).unbind(0))
        return lib_tail(x, o.transpose(1, 2).reshape(n, s, c), params[4:], "tanh")

    lib = timer.ms(unfused)
    want = fused_hiera_block_plain(x, params, heads, hd, act="gelu_tanh", eps=1e-6)
    check_close("unfused library block (yardstick only)", unfused(), want,
                row_rel=BLOCK_REL, fatal=False)
    e = breakdown(timer, "fused_hiera_block [SigLIP]", {},
                  lambda: fused_hiera_block(x, params, heads, hd, act="gelu_tanh"), unfused)
    e["gemm_routes"] = gemm_routes("[SigLIP]", rows, c, heads * hd, mlp)
    return dict(name="fused_hiera_block", route="cuda",
                source="ufvideo_tpu_torch/csrc/hiera_block.cu",
                replaces="ufvideo_tpu/ops/hiera_block.py:435",
                max_abs_err=err, tol=tol_text(BLOCK_REL), ms=ms, plain_ms=plain,
                bound_ms=t_b, bound_by=by, library_ms=lib,
                shape="x [32,729,1152] 16 heads x 72, MLP 4304, gelu_tanh",
                shapes=hiera_shapes(dev, timer, gen), **e)



# ----------------------------------------------------- quantised kernels --

# (din, dout) of the five projections of one Qwen2-7B decode step: fused
# qkv, o, gate / up, down, lm_head on the padded vocabulary
def projection_shapes(cfg):
    l = cfg.llm
    nq, nkv = l.num_heads * l.head_dim, l.num_kv_heads * l.head_dim
    return {"qkv": (l.hidden_size, nq + 2 * nkv), "o": (nq, l.hidden_size),
            "gate/up": (l.hidden_size, l.intermediate_size),
            "down": (l.intermediate_size, l.hidden_size),
            "lm_head": (l.hidden_size, l.padded_vocab_size)}


def _kernel_entry(name, source, replaces, tol, shapes, headline):
    """One kernel's JSON entry from its benched shapes: ``headline`` names
    the shape whose numbers stand in the entry, the rest go to ``shapes``."""
    first = next(e for e in shapes if e["shape"] == headline)
    rest = [e for e in shapes if e is not first]
    first = dict(first, max_abs_err=max(e["max_abs_err"] for e in shapes))
    return dict(name=name, route="cuda", source=source, replaces=replaces, tol=tol,
                shapes=rest, **first)


# rows phase 2 holds the quantised products at: one decode row, the 2-32-row
# kernel's edges and its two tile counts, the verify block of speculative
# decoding (B = 1, K = SPEC_K drafts: 5 rows) and the serving batch of 8
SPEC_K = 4
QUANT_ROWS = (1, 2, SPEC_K + 1, 8, 17, 32)


def kernel_quant_matmul(dev, timer, gen, cfg, bits):
    """int8_matvec (bits 8) or int4_matmul (bits 4) at the five projection
    shapes and ``QUANT_ROWS``, weights quantised from a random float kernel.
    Library yardstick: one bf16 product on a dequantised copy made before
    the clock starts. Each shape also logs the grid the wrapper launched
    (its ``last_plan``) and the rate on the weight and scale bytes; at one
    row, the 2-32-row kernel on the same inputs is timed beside it."""
    from ufvideo_tpu_torch import quant
    from ufvideo_tpu_torch.ops import quant_matmul as qm

    qcheck = lambda n, g, w: check_close(n, g, w, row_rel=QREL, rtol=QREL, fro=QREL)
    wrapper = qm.int8_matvec if bits == 8 else qm.int4_matmul
    shapes = []
    for pname, (din, dout) in projection_shapes(cfg).items():
        w = torch.randn(din, dout, generator=gen, device=dev) * din ** -0.5
        if bits == 8:
            qd = quant.quantize_kernel(w)
            wb = (qd["q"].float() * qd["scale"]).to(torch.bfloat16)
            kern = lambda x, qd=qd: qm.int8_matvec(x, qd["q"], qd["scale"])
            plain = lambda x, qd=qd: qm.int8_matvec_plain(x, qd["q"], qd["scale"])
        else:
            qd = quant.quantize_kernel4(w, 64)
            wb = qm.dequantize_int4(qd["q"], qd["scale"], 64, torch.bfloat16)
            kern = lambda x, qd=qd: qm.int4_matmul(x, qd["q"], qd["scale"], 64)
            plain = lambda x, qd=qd: qm.int4_matmul_plain(x, qd["q"], qd["scale"], 64)
        del w
        for rows in QUANT_ROWS:
            x = torch.randn(rows, din, generator=gen, device=dev).to(torch.bfloat16)
            e = bench(
                timer, f"{pname}: x [{rows},{din}] q [{din},{dout}] int{bits}",
                lambda: kern(x), lambda: plain(x), lambda: torch.mm(x, wb),
                nbytes(x, qd["q"], qd["scale"]) + rows * dout * 4, 2 * rows * din * dout,
                check=qcheck)
            e["plan"] = str(wrapper.last_plan)
            e["gbps"] = nbytes(qd["q"], qd["scale"]) / e["ms"] / 1e6
            e["bound_ratio"] = e["ms"] / e["bound_ms"]
            old = ""
            if rows == 1:
                plan = qm._rows_plan(x, qd["q"], bits, 64)
                e["rows_kernel_ms"] = timer.ms(
                    lambda: qm._launch_rows(x, qd["q"], qd["scale"], bits, 64, plan))
                old = f", 2-32-row kernel {e['rows_kernel_ms']:.4f} ms"
            log(f"    {e['shape']}: plan {e['plan']}, {e['gbps']:.0f} GB/s{ratio_text(e)}, "
                f"kernel / bound {e['bound_ratio']:.2f}{old}")
            shapes.append(e)
        del qd, wb
        torch.cuda.empty_cache()
    name = "int8_matvec" if bits == 8 else "int4_matmul"
    din, dout = projection_shapes(cfg)["gate/up"]
    return _kernel_entry(
        name, "ufvideo_tpu_torch/csrc/quant_matmul.cu",
        "ufvideo_tpu/ops/quant_matmul.py:" + ("193" if bits == 8 else "122"),
        tol_text(QREL, QREL, QREL), shapes,
        f"gate/up: x [1,{din}] q [{din},{dout}] int{bits}")


# W8A8 block, kernel against plain version. The int32 sums are exact on both
# sides, so where both quantise the same f32 values (LN output, GELU output)
# they differ only where a value sits on a rounding boundary: the MLP half
# alone (projection zeroed, so both sides enter LN2 with the same rows) is
# held to the JAX package's own test of its kernel against its reference: at
# least W8A8_FRAC of the elements within 1e-3 absolute or 1e-2 relative,
# every element within atol 2.0 + rtol 5e-2 (one quantisation step). Through
# the whole block the kernel quantises the attention output from bf16 and
# the plain version from f32, and the residual stream rounds to bf16 twice:
# one bf16 step is 0.4-0.8% of a value, so a relative limit of 1e-2 an
# element is no longer the measure, and the whole block is held to the float
# block's limit (BLOCK_REL of a row's RMS an element, REL in Frobenius norm);
# the share within 1e-2 relative is reported beside it.
W8A8_FRAC = 0.999


def w8a8_frac(got, want) -> float:
    err = (got.float() - want.float()).abs()
    close = (err < 1e-3) | (err / (want.float().abs() + 1e-3) < 1e-2)
    return float(close.float().mean())


def check_w8a8_exact(name, got, want):
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    frac = w8a8_frac(got, want)
    worst = float((err - (2.0 + 5e-2 * want.abs())).max())
    ok = frac > W8A8_FRAC and worst <= 0
    log(f"  {name}: max_abs_err {float(err.max()):.3e}, {frac:.5f} of elements within "
        f"1e-3 abs or 1e-2 rel (tolerance > {W8A8_FRAC}), all within 2.0 + 5e-2*|plain|: "
        f"{worst <= 0} {'ok' if ok else 'EXCEEDED'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return float(err.max())


def check_w8a8(name, got, want, row_rel=BLOCK_REL):
    err = check_close(name, got, want, row_rel=row_rel)
    log(f"    {w8a8_frac(got, want):.5f} of elements within 1e-3 abs or 1e-2 rel (reported)")
    return err


def w8a8_params(dev, gen, c, mlp, cin=None, front_extra=0):
    """Random float block parameters (``block_params``), the four kernels
    quantised per column: (ln1_s, ln1_b, wfront_q, sfront, bfront, wproj_q,
    sproj, bproj, ln2_s, ln2_b, w1_q, s1, b1, w2_q, s2, b2)."""
    from ufvideo_tpu_torch.quant import quantize_kernel

    (l1s, l1b, wq, bq, wp, bp, l2s, l2b, w1, b1, w2, b2) = block_params(
        dev, gen, c, mlp, cin=cin, front_extra=front_extra)
    q = lambda w: tuple(quantize_kernel(w).values())
    return (l1s, l1b, *q(wq), bq, *q(wp), bp, l2s, l2b, *q(w1), b1, *q(w2), b2)


def lib_qdot(x32, w, ws, b):
    """Library yardstick of one W8A8 product: elementwise row quantise,
    ``torch._int_mm`` (K and N multiples of 8; the weights handed over
    K-contiguous, as its int8 kernels take them: row-major it runs at a fifth
    of that rate), rescale."""
    from ufvideo_tpu_torch.ops.hiera_block import quant_rows_f32

    q, xs = quant_rows_f32(x32)
    return torch._int_mm(q, w.t().contiguous().t()).float() * xs * ws + b.float()


def lib_w8a8_tail(shortcut, o, params, approximate):
    """Library yardstick of the W8A8 tail: ``lib_qdot`` products, fused LN /
    GELU. ``o`` [rows, A] is the attention output."""
    import torch.nn.functional as F

    wp, sp, bp, l2s, l2b, w1, s1, b1, w2, s2, b2 = params
    n, s, c = shortcut.shape
    x1 = shortcut + lib_qdot(o.float(), wp, sp, bp).reshape(n, s, c).to(shortcut.dtype)
    h = F.layer_norm(x1.float(), (c,), l2s.float(), l2b.float(), 1e-6).reshape(n * s, c)
    h = F.gelu(lib_qdot(h, w1, s1, b1), approximate=approximate)
    return x1 + lib_qdot(h, w2, s2, b2).reshape(n, s, c).to(shortcut.dtype)


def lib_w8a8_block(x, params, heads, hd, approximate):
    """Library yardstick of the whole W8A8 block: ``lib_qdot`` products,
    SDPA, fused LN / GELU."""
    import torch.nn.functional as F

    (l1s, l1b, wq, sq, bq) = params[:5]
    n, s, c = x.shape
    h = F.layer_norm(x.float(), (c,), l1s.float(), l1b.float(), 1e-6)
    qkv = lib_qdot(h.reshape(n * s, c), wq, sq, bq).to(x.dtype).reshape(n, s, 3, heads, hd)
    o = F.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4).unbind(0))
    return lib_w8a8_tail(x, o.transpose(1, 2).reshape(n * s, heads * hd), params[5:],
                         approximate)


# (windows, tokens a window, width, heads) of Hiera-L's four windowed-block
# shapes on 4 frames, and (windows, tokens, width in, heads out) of its three
# stage transitions
HIERA_BLOCK_SHAPES = ((4096, 64, 144, 2), (4096, 16, 288, 4), (64, 256, 576, 8),
                      (64, 64, 1152, 16))
HIERA_QPOOL_SHAPES = ((4096, 64, 144, 4), (4096, 16, 288, 8), (64, 256, 576, 16))


def w8a8_hiera_shapes(dev, timer, gen):
    """fused_block_w8a8 at the four windowed-block shapes of the quantised
    Hiera-L on 4 frames (gelu_exact, head dim 72, MLP 4C; K = 144 is padded
    to 160 inside the kernel)."""
    from ufvideo_tpu_torch.ops.hiera_block import fused_block_w8a8, fused_block_w8a8_plain

    out = []
    for n, s, c, heads in HIERA_BLOCK_SHAPES:
        hd, mlp = 72, 4 * c
        params = w8a8_params(dev, gen, c, mlp)
        x = torch.randn(n, s, c, generator=gen, device=dev).to(torch.bfloat16)
        rows = n * s
        out.append(bench(
            timer, f"Hiera x [{n},{s},{c}] {heads} heads x {hd}, MLP {mlp}, gelu_exact, W8A8",
            lambda: fused_block_w8a8(x, params, heads, hd, act="gelu_exact"),
            lambda: fused_block_w8a8_plain(x, params, heads, hd, act="gelu_exact"),
            lambda: lib_w8a8_block(x, params, heads, hd, "none"),
            nbytes(x, x, *params), 4 * n * heads * s * s * hd, check=check_w8a8,
            int8_ops=2 * rows * (3 * c * c + c * c + 2 * c * mlp)))
        del params, x
        torch.cuda.empty_cache()
    return out


def kernel_ln_matmul_w8a8(dev, timer, gen):
    """fused_ln_matmul_w8a8 at the front of a quantised global block. Both
    sides quantise the same f32 LN output: the float front's limit."""
    from ufvideo_tpu_torch.ops.hiera_block import (
        fused_ln_matmul_w8a8, fused_ln_matmul_w8a8_plain)
    import torch.nn.functional as F

    n, s, c, d = 4, 4096, 576, 1728
    l1s, l1b, w, ws, b = w8a8_params(dev, gen, c, 8)[:5]
    x = torch.randn(n, s, c, generator=gen, device=dev).to(torch.bfloat16)

    def library():
        h = F.layer_norm(x.float(), (c,), l1s.float(), l1b.float(), 1e-6)
        return lib_qdot(h.reshape(n * s, c), w, ws, b).to(x.dtype)

    e = bench(
        timer, f"fused_ln_matmul_w8a8 [x [{n},{s},{c}] int8 w [{c},{d}]]",
        lambda: fused_ln_matmul_w8a8(x, l1s, l1b, w, ws, b),
        lambda: fused_ln_matmul_w8a8_plain(x, l1s, l1b, w, ws, b),
        library, nbytes(x, w, ws, l1s, l1b, b) + n * s * d * 2, 0.0,
        check=lambda nm, g, wt: check_w8a8(nm, g, wt, row_rel=REL),
        int8_ops=2 * n * s * c * d)
    return dict(name="fused_ln_matmul_w8a8", route="cuda",
                source="ufvideo_tpu_torch/csrc/hiera_block.cu",
                replaces="ufvideo_tpu/ops/hiera_block.py:1753", tol=tol_text(REL), **e)


def kernel_block_tail_w8a8(dev, timer, gen):
    """fused_block_tail_w8a8 at the tail of a quantised global block."""
    from ufvideo_tpu_torch.ops.hiera_block import (
        fused_block_tail_w8a8, fused_block_tail_w8a8_plain)

    n, s, c, mlp = 4, 4096, 576, 2304
    params = w8a8_params(dev, gen, c, mlp)[5:]
    mk = lambda: torch.randn(n, s, c, generator=gen, device=dev).to(torch.bfloat16)
    shortcut, att = mk(), mk()
    e = bench(
        timer, f"fused_block_tail_w8a8 [shortcut, att [{n},{s},{c}] MLP {mlp}, gelu_exact]",
        lambda: fused_block_tail_w8a8(shortcut, att, params),
        lambda: fused_block_tail_w8a8_plain(shortcut, att, params),
        lambda: lib_w8a8_tail(shortcut, att.reshape(n * s, c), params, "none"),
        nbytes(shortcut, att, shortcut, *params), 0.0, check=check_w8a8,
        int8_ops=2 * n * s * (c * c + 2 * c * mlp))
    return dict(name="fused_block_tail_w8a8", route="cuda",
                source="ufvideo_tpu_torch/csrc/hiera_block.cu",
                replaces="ufvideo_tpu/ops/hiera_block.py:1862", tol=tol_text(BLOCK_REL), **e)


def kernel_qpool_w8a8(dev, timer, gen):
    """fused_qpool_block_w8a8 at Hiera-L's three stage transitions on 4
    frames. The kernel quantises the attention output from bf16 and the
    plain version from f32, as in the whole W8A8 block: the block's limit."""
    from ufvideo_tpu_torch.ops.hiera_block import (
        fused_qpool_block_w8a8, fused_qpool_block_w8a8_plain)
    import torch.nn.functional as F

    shapes = []
    for n, s, cin, heads in HIERA_QPOOL_SHAPES:
        cout, hd, mlp = 2 * cin, 72, 8 * cin
        hw, ws, sq = heads * hd, int(s ** 0.5), s // 4
        params = w8a8_params(dev, gen, cout, mlp, cin=cin, front_extra=cout)
        x = torch.randn(n, s, cin, generator=gen, device=dev).to(torch.bfloat16)
        (l1s, l1b, wf, sf, bf_) = params[:5]

        def pool(v):
            v6 = v.reshape(n, ws // 2, 2, ws // 2, 2, v.shape[-1])
            return v6.amax(dim=4).amax(dim=2).reshape(n, sq, v.shape[-1])

        def library():
            h = F.layer_norm(x.float(), (cin,), l1s.float(), l1b.float(), 1e-6)
            fr = lib_qdot(h.reshape(n * s, cin), wf, sf, bf_).to(x.dtype).reshape(n, s, -1)
            q = pool(fr[..., :hw]).reshape(n, sq, heads, hd).transpose(1, 2)
            k = fr[..., hw:2 * hw].reshape(n, s, heads, hd).transpose(1, 2)
            v = fr[..., 2 * hw:3 * hw].reshape(n, s, heads, hd).transpose(1, 2)
            o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n * sq, hw)
            return lib_w8a8_tail(pool(fr[..., 3 * hw:]), o, params[5:], "none")

        int8_ops = (2 * n * s * cin * (3 * hw + cout)
                    + 2 * n * sq * (hw * cout + 2 * cout * mlp))
        shapes.append(bench(
            timer, f"fused_qpool_block_w8a8 [x [{n},{s},{cin}] -> [{n},{sq},{cout}] "
                   f"{heads} heads]",
            lambda: fused_qpool_block_w8a8(x, params, heads, hd, (2, 2)),
            lambda: fused_qpool_block_w8a8_plain(x, params, heads, hd, (2, 2)),
            library, nbytes(x, *params) + n * sq * cout * 2, 4 * n * heads * sq * s * hd,
            check=check_w8a8, int8_ops=int8_ops))
        del params, x
        torch.cuda.empty_cache()
    return _kernel_entry(
        "fused_qpool_block_w8a8", "ufvideo_tpu_torch/csrc/hiera_block.cu",
        "ufvideo_tpu/ops/hiera_block.py:1629", tol_text(BLOCK_REL), shapes, shapes[0]["shape"])


def kernel_w8a8(dev, timer, gen):
    """fused_block_w8a8 at the SigLIP shapes (the 32 video frames and the
    annotated frames of a referring request, 1 or 2 after padding) and at
    the quantised Hiera trunk's four windowed shapes. Library yardstick:
    torch._int_mm products with elementwise quantise / rescale, SDPA, fused
    LN / GELU."""
    from ufvideo_tpu_torch.ops.hiera_block import fused_block_w8a8, fused_block_w8a8_plain

    s, c, heads, hd, mlp = 729, 1152, 16, 72, 4304
    params = w8a8_params(dev, gen, c, mlp)
    wp, w2 = params[5], params[13]

    # the halves alone, on 2 frames: the MLP half with the projection zeroed
    # (identical quantisation points), the attention half with the MLP's
    # second kernel zeroed (out - x is the projected attention output; x is
    # small there, so that its bf16 rounding hides nothing)
    x0 = torch.randn(2, s, c, generator=gen, device=dev)
    zero = lambda w: torch.zeros_like(w)
    for label, p, check in (
        ("MLP half alone", params[:5] + (zero(wp),) + params[6:], check_w8a8_exact),
        ("attention half alone", params[:13] + (zero(w2),) + params[14:], check_w8a8),
    ):
        x = (x0 * (1e-2 if check is check_w8a8 else 1.0)).to(torch.bfloat16)
        got = fused_block_w8a8(x, p, heads, hd, act="gelu_tanh")
        want = fused_block_w8a8_plain(x, p, heads, hd, act="gelu_tanh")
        torch.cuda.synchronize()
        if check is check_w8a8:  # the residual stream hides the attention part
            got, want = got.float() - x.float(), want.float() - x.float()
        check(f"fused_block_w8a8 [{label}]", got, want)

    shapes = []
    for n in (32, 2, 1):
        x = torch.randn(n, s, c, generator=gen, device=dev).to(torch.bfloat16)
        rows = n * s
        int8_ops = 2 * rows * (3 * c * c + c * c + 2 * c * mlp)
        shapes.append(bench(
            timer, f"x [{n},{s},{c}] {heads} heads x {hd}, MLP {mlp}, gelu_tanh, W8A8",
            lambda: fused_block_w8a8(x, params, heads, hd, act="gelu_tanh"),
            lambda: fused_block_w8a8_plain(x, params, heads, hd, act="gelu_tanh"),
            lambda: lib_w8a8_block(x, params, heads, hd, "tanh"),
            nbytes(x, x, *params), 4 * n * heads * s * s * hd, check=check_w8a8,
            int8_ops=int8_ops))
    del params, x
    torch.cuda.empty_cache()
    shapes += w8a8_hiera_shapes(dev, timer, gen)
    return _kernel_entry(
        "fused_block_w8a8", "ufvideo_tpu_torch/csrc/hiera_block.cu",
        "ufvideo_tpu/ops/hiera_block.py:1340",
        tol_text(BLOCK_REL), shapes, shapes[0]["shape"])

# ------------------------- packed attention, the stage, the int8-rate probe --

# Hiera-L's windowed attention on 4 frames: (windows, tokens, heads) at the
# four stages (head dim 72)
WINDOW_SHAPES = ((4096, 64, 2), (4096, 16, 4), (64, 256, 8), (64, 64, 16))


def _sdpa_packed(qkv, heads, hd):
    """Library yardstick of packed attention: SDPA on head-split views."""
    import torch.nn.functional as F

    b, s, _ = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, s, heads * hd)


def _head_rows(name, got, want, heads, hd):
    """check_close with one head's output as the row, at the block's limit:
    the kernel rounds the unnormalised probabilities to bf16 and divides at
    the end, the plain version rounds the normalised ones, and over 16-729
    keys a probability is large enough for its bf16 step to show (1.6e-2 of
    a row's RMS on an H100; the block's attention part alone needs 3.9e-2)."""
    b, s, _ = want.shape
    return check_close(name, got.reshape(b, s, heads, hd), want.reshape(b, s, heads, hd),
                       row_rel=BLOCK_REL)


def kernel_packed_mha(dev, timer, gen):
    """mha_full_attention_packed at the unfused SigLIP layer's shape: 32
    frames x 729 tokens, 16 heads x 72, packed [q | k | v]."""
    from ufvideo_tpu_torch.ops.vit_attention import (
        mha_full_attention_packed, mha_full_attention_packed_plain)

    b, s, heads, hd = 32, 729, 16, 72
    qkv = torch.randn(b, s, 3 * heads * hd, generator=gen, device=dev).to(torch.bfloat16)
    e = bench(
        timer, f"mha_full_attention_packed [qkv [{b},{s},{3 * heads * hd}] {heads} heads x {hd}]",
        lambda: mha_full_attention_packed(qkv, heads, hd),
        lambda: mha_full_attention_packed_plain(qkv, heads, hd),
        lambda: _sdpa_packed(qkv, heads, hd),
        nbytes(qkv) + b * s * heads * hd * 2, 4 * b * heads * s * s * hd,
        check=lambda n, g, w: _head_rows(n, g, w, heads, hd))
    return dict(name="mha_full_attention_packed", route="cuda",
                source="ufvideo_tpu_torch/csrc/packed_attention.cu",
                replaces="ufvideo_tpu/ops/vit_attention.py:110", tol=tol_text(BLOCK_REL), **e)


def kernel_window_attention(dev, timer, gen):
    """fused_window_attention at Hiera-L's four windowed stages on 4 frames
    (the MultiScaleAttention module's windowed branch)."""
    from ufvideo_tpu_torch.ops.window_attention import (
        fused_window_attention, fused_window_attention_plain)

    shapes = []
    for nw, s, heads in WINDOW_SHAPES:
        hd = 72
        qkv = torch.randn(nw, s, 3 * heads * hd, generator=gen, device=dev).to(torch.bfloat16)
        shapes.append(bench(
            timer, f"qkv [{nw},{s},{3 * heads * hd}] {heads} heads x {hd}",
            lambda: fused_window_attention(qkv, heads, hd),
            lambda: fused_window_attention_plain(qkv, heads, hd),
            lambda: _sdpa_packed(qkv, heads, hd),
            nbytes(qkv) + nw * s * heads * hd * 2, 4 * nw * heads * s * s * hd,
            check=lambda n, g, w, h=heads: _head_rows(n, g, w, h, 72)))
        del qkv
    return _kernel_entry(
        "fused_window_attention", "ufvideo_tpu_torch/csrc/packed_attention.cu",
        "ufvideo_tpu/ops/window_attention.py:141", tol_text(BLOCK_REL), shapes,
        shapes[0]["shape"])


def stage_runs(cfg, routing, n_frames: int) -> collections.Counter:
    """(blocks, windows, tokens, width, heads) of each ``fused_hiera_stage``
    call that Hiera's forward makes under ``routing`` on ``n_frames`` frames
    (one encode chunk), counted: the shapes phase 2 must hold the kernel at."""
    trunk = _trunk(cfg, routing)
    h = cfg.sam.hiera
    grid = (h.image_size + 2 * h.patch_padding - h.patch_kernel) // h.patch_stride + 1
    runs = collections.Counter()
    for group in trunk.groups:
        blk = trunk.blocks[group[0]]
        if len(group) > 1:
            ws = blk.window_side
            runs[(len(group), n_frames * (grid // ws) ** 2, ws * ws, blk.dim_out,
                  blk.num_heads)] += 1
        if blk.q_stride is not None:
            grid //= blk.q_stride[0]
    return runs


def kernel_stage(dev, timer, gen, cfg):
    """fused_hiera_stage at every run that phase 7a's stage fusion
    (``hiera_stage_nb=4``) makes in ``cfg``'s Hiera on the 4 SAM frames of a
    [SEG] request, gelu_poly as phase 7a runs it. The kernel is the block's
    launches carried through nb blocks, so it must equal nb calls of
    fused_hiera_block bit for bit; against the plain fold it is held to the
    block's limit (nb blocks read 3.6-3.8e-2 of a row's RMS on an H100).
    Library yardstick: nb cuBLAS + SDPA blocks. The headline is the shape of
    the most runs."""
    from ufvideo_tpu_torch.configs import VisionRouting
    from ufvideo_tpu_torch.ops.hiera_block import (
        fused_hiera_block, fused_hiera_stage, fused_hiera_stage_plain)
    import torch.nn.functional as F

    runs = stage_runs(cfg, VisionRouting(**ROUTING_7A), 4)
    if not runs:
        fail("phase 7a's routing makes no stage run")
    shapes, headline = [], None
    for (nb, n, s, c, heads), count in runs.items():
        hd, mlp = c // heads, int(c * cfg.sam.hiera.mlp_ratio)
        plist = [block_params(dev, gen, c, mlp) for _ in range(nb)]
        x = torch.randn(n, s, c, generator=gen, device=dev).to(torch.bfloat16)
        seq = x
        for p in plist:
            seq = fused_hiera_block(seq, p, heads, hd, act="gelu_poly")
        same = torch.equal(fused_hiera_stage(x, plist, heads, hd, act="gelu_poly"), seq)
        log(f"  fused_hiera_stage [{nb} blocks x [{n},{s},{c}]]: equal to {nb} fused_hiera_block "
            f"calls bit for bit: {same}")
        if not same:
            fail("fused_hiera_stage differs from its blocks' kernel")

        def library():
            y = x
            for p in plist:
                h = F.layer_norm(y, (c,), p[0], p[1], 1e-6)
                qkv = torch.addmm(p[3], h.reshape(n * s, c), p[2]).reshape(n, s, 3, heads, hd)
                o = F.scaled_dot_product_attention(*qkv.permute(2, 0, 3, 1, 4).unbind(0))
                y = lib_tail(y, o.transpose(1, 2).reshape(n, s, c), p[4:], "tanh")
            return y

        rows = n * s
        flops = nb * (2 * rows * (3 * c * c + c * c + 2 * c * mlp) + 4 * n * heads * s * s * hd)
        label = (f"{nb} blocks x [{n},{s},{c}] {heads} heads x {hd}, MLP {mlp}, gelu_poly "
                 f"({count} run{'s' if count > 1 else ''} a request)")
        if headline is None or count > runs[headline[0]]:
            headline = ((nb, n, s, c, heads), label)
        shapes.append(bench(
            timer, label,
            lambda: fused_hiera_stage(x, plist, heads, hd, act="gelu_poly"),
            lambda: fused_hiera_stage_plain(x, plist, heads, hd, act="gelu_poly"),
            library, nbytes(x, x, *[t for p in plist for t in p]), flops,
            row_rel=BLOCK_REL))
        del plist, x, seq
        torch.cuda.empty_cache()
    return _kernel_entry(
        "fused_hiera_stage", "ufvideo_tpu_torch/csrc/hiera_block.cu",
        "ufvideo_tpu/ops/hiera_block.py:568",
        "equal to nb fused_hiera_block calls; " + tol_text(BLOCK_REL), shapes, headline[1])


def kernel_probe(dev, timer, gen):
    """probe_step at the probe's shape (SigLIP fc1 rows of 64 frames):
    int8, whose int32 sums must equal the plain version's exactly, and
    bf16 -> f32, held to QREL in relative Frobenius norm (f32 sums of the
    same products in another order). Library: torch._int_mm / torch.mm."""
    from ufvideo_tpu_torch.probe_int8_rate import (
        DIN, DOUT, ROWS, probe_inputs, probe_step, probe_step_plain, round_clip_s8_plain)

    x, wf, wq = probe_inputs(dev, int(torch.randint(1 << 30, (1,), generator=gen, device=dev)))
    xq = round_clip_s8_plain(x, DIN)
    # cuBLASLt's int8 kernels take the weights K-contiguous; row-major it is
    # 5x slower (timed beside, reported)
    wq_cols = wq.t().contiguous().t()
    log(f"  torch._int_mm on row-major int8 weights: {timer.ms(lambda: torch._int_mm(xq, wq)):.4f} "
        f"ms; K-contiguous: {timer.ms(lambda: torch._int_mm(xq, wq_cols)):.4f} ms")

    def exact(name, got, want):
        same = torch.equal(got, want)
        log(f"  {name}: int32 sums equal to the plain version's: {same}")
        if not same:
            fail(f"{name} disagrees with its plain version")
        return 0.0

    ops = 2 * ROWS * DIN * DOUT
    shapes = [
        bench(timer, f"int8: x [{ROWS},{DIN}] bf16 rounded by a pass, w [{DIN},{DOUT}] int8",
              lambda: probe_step(x, wq, True), lambda: probe_step_plain(x, wq, True),
              lambda: torch._int_mm(xq, wq_cols), nbytes(x, wq) + ROWS * DOUT * 4, 0.0,
              check=exact, int8_ops=ops),
        bench(timer, f"bf16: x [{ROWS},{DIN}] w [{DIN},{DOUT}] bf16 -> f32",
              lambda: probe_step(x, wf, False), lambda: probe_step_plain(x, wf, False),
              lambda: torch.mm(x, wf), nbytes(x, wf) + ROWS * DOUT * 4, ops,
              check=lambda n, g, w: check_close(n, g, w, row_rel=QREL, rtol=QREL, fro=QREL)),
    ]
    shapes[1]["gemm_routes"] = gemm_routes("probe bf16", ROWS, DIN, None, DOUT)
    log(f"  int8 : bf16 rate through the kernels {shapes[1]['ms'] / shapes[0]['ms']:.3f}, "
        f"through the libraries {shapes[1]['library_ms'] / shapes[0]['library_ms']:.3f}")
    return _kernel_entry(
        "probe_step", "ufvideo_tpu_torch/csrc/hiera_block.cu", "scripts/probe_int8_rate.py:99",
        "int8: equal; bf16: " + tol_text(QREL, QREL, QREL), shapes, shapes[0]["shape"])


# ------------------------------------------------------------------ path --

def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-30))


N_STEPS = 8  # decode steps whose logits the two paths are compared on


def compare_paths(kernel_out, plain_out, limit, why):
    """Hold the kernel path's stages (``staged_path``) against the plain
    path's: cosines at least ``limit``; a step's greedy token may differ only
    where the plain path's top two logits lie closer than the two paths'
    largest logit difference there."""
    f_k, h_k, lg_k, toks_k, r_k = kernel_out
    f_p, h_p, lg_p, toks_p, r_p = plain_out
    named = [("video tokens", f_k), ("prefill hidden", h_k), ("logits", lg_k)]
    if r_k is not None:
        named.append(("region tokens", r_k))
    for name, t in named:
        if not torch.isfinite(t).all():
            fail(f"non-finite {name} on the kernel path")
    cos_f, cos_h = cosine(f_k, f_p), cosine(h_k, h_p)
    row_cos = torch.nn.functional.cosine_similarity(h_k.float(), h_p.float(), dim=-1)
    step_cos = [cosine(a, b) for a, b in zip(lg_k, lg_p)]
    flips = []
    for i, (a, b) in enumerate(zip(lg_k, lg_p)):
        gap = float(b.max() - b[toks_k[i]])
        if toks_k[i] != toks_p[i] and gap > float((a - b).abs().max()):
            flips.append(i)
    same = sum(x == y for x, y in zip(toks_k, toks_p))
    region = ""
    if r_k is not None:
        cos_r = cosine(r_k, r_p)
        region = f"region tokens cosine {cos_r:.5f}, "
        if cos_r < limit:
            fail("region tokens of the kernel path and the plain path disagree")
    log(f"  kernel vs plain path: video tokens cosine {cos_f:.5f}, {region}final prefill "
        f"hidden cosine {cos_h:.5f} (min per position {float(row_cos.min()):.5f}), "
        f"decode logits cosine min {min(step_cos):.5f} over {len(step_cos)} steps, greedy "
        f"tokens equal {same}/{len(step_cos)}; tolerance cosine >= {limit}: {why}")
    if min(cos_f, cos_h, *step_cos) < limit:
        fail("kernel path and plain path disagree at full width")
    if flips:
        fail(f"greedy tokens differ beyond a near tie at decode steps {flips}")


def staged_path(rt, ids, pixels, n_steps, use_kernels, forced=None, region=None):
    """The request in stages through the kernels or the plain versions:
    (video tokens, prefill hidden states [n, hidden], the logits of the first
    ``n_steps`` decode steps, their greedy tokens, region tokens or None).
    ``forced`` feeds given tokens instead of the greedy ones; ``region`` is
    (frame, masks, ann_indices)."""
    from ufvideo_tpu_torch.models.generate import _mask_vocab_logits
    from ufvideo_tpu_torch.models.qwen2 import make_kv_cache
    from ufvideo_tpu_torch.splicing import plan_splice

    cfg, dev, llm = rt.cfg, rt.device, rt.model.llm
    rt.model.set_use_kernels(use_kernels)
    f = rt.encode_video(pixels[None])
    r, counts = rt.pack_and_encode_regions(*region) if region else (None, [])
    p = plan_splice([ids], num_video_tokens=f.shape[1], region_token_counts=[counts],
                    region_token_id=rt.ids.region, max_seq_len=cfg.budget.max_seq_len,
                    region_stride=cfg.region.region_token_num)
    emb = rt.model.splice_embeds(*(torch.as_tensor(a, device=dev) for a in
                                   (p.text_ids, p.src_kind, p.src_idx)), f, r)
    n = int(p.seq_lens[0])
    lens = torch.as_tensor(p.seq_lens, device=dev)
    trim = min(-(-n // 256) * 256, cfg.budget.max_seq_len)
    cache = make_kv_cache(cfg.llm, 1, -(-(trim + n_steps) // 128) * 128,
                          dtype=cfg.compute_dtype, device=dev, quant=bool(cfg.quant_kv))
    pos = torch.arange(trim, device=dev)[None]
    h, cache = llm.backbone(emb[:, :trim], pos, lens, cache, None, "prefill")
    last, cur_len = h[:, n - 1], lens.long()
    logits, toks = [], []
    for i in range(n_steps):
        lg = _mask_vocab_logits(llm.logits(last[:, None])[:, 0].float(),
                                cfg.llm.vocab_size)[0]
        logits.append(lg)
        toks.append(int(lg.argmax()))
        e = llm.embed(torch.tensor([[toks[-1] if forced is None else forced[i]]], device=dev))
        hd, cache = llm.backbone(e, cur_len[:, None], None, cache, cur_len, "decode")
        last, cur_len = hd[:, 0], cur_len + 1
    rt.model.set_use_kernels(True)
    return f, h[0, :n], torch.stack(logits), toks, r


def run_path(dev, seed: int, cfg, frame_shape=(32, 480, 640, 3), max_new_tokens=32):
    from ufvideo_tpu_torch import mm_infer, model_init
    from ufvideo_tpu_torch.api import _assemble_input_ids
    from ufvideo_tpu_torch.ops.decode_attention import ragged_decode_attention
    from ufvideo_tpu_torch.ops.flash_attention import flash_attention
    from ufvideo_tpu_torch.ops.hiera_block import fused_hiera_block
    from ufvideo_tpu_torch.ops.image_pipeline import siglip_preprocess_device

    wrappers = all_wrappers()
    t0 = time.perf_counter()
    rt, _, tok = model_init(cfg=cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in rt.model.parameters())
    log(f"  model_init: {n_params / 1e9:.3f} B params bf16 in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cfg = rt.cfg
    frames = np.random.default_rng(seed).integers(0, 256, frame_shape, dtype=np.uint8)
    question = "What happens in this video?"

    # warm the kernel libraries and cuBLAS outside the counted run
    mm_infer(frames[::-1], question, rt, tok, max_new_tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    text, out = mm_infer(frames, question, rt, tok, max_new_tokens=max_new_tokens)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  mm_infer: {e2e * 1e3:.1f} ms end to end, {len(out['output'])} tokens, "
        f"peak {peak:.2f} GiB; launches {launches}")
    log(f"  text: {text[:80]!r}")
    for k in ("fused_hiera_block", "flash_attention", "ragged_decode_attention"):
        if launches[k] <= 0:
            fail(f"{k} was never launched on the QA path")

    # stage timings, outside the counted run
    ids = _assemble_input_ids(question, 1, "<video>", tok)
    sync_t = lambda: (torch.cuda.synchronize(), time.perf_counter())[1]
    t0 = sync_t()
    pixels = siglip_preprocess_device(torch.from_numpy(frames).to(dev), cfg.compute_dtype)
    t1 = sync_t()
    feats = rt.encode_video(pixels[None])
    t2 = sync_t()
    tok1, _, plan = rt.generate(ids, feats, max_new_tokens=1)
    t3 = sync_t()
    toks, hidden, _ = rt.generate(ids, feats, max_new_tokens=max_new_tokens)
    t4 = sync_t()
    n_gen = len(toks)
    decode_tps = (n_gen - 1) / max((t4 - t3) - (t3 - t2), 1e-9)
    prompt_len = int(plan.seq_lens[0])
    log(f"  prompt {prompt_len} tokens ({feats.shape[1]} video tokens), "
        f"{n_gen} generated; preprocess {(t1 - t0) * 1e3:.1f} ms, "
        f"encode {(t2 - t1) * 1e3:.1f} ms, prefill+first token {(t3 - t2) * 1e3:.1f} ms, "
        f"decode {decode_tps:.2f} tok/s")
    if feats.shape[1] != rt.cfg.num_video_tokens:
        fail(f"video tokens {feats.shape[1]}, expected {rt.cfg.num_video_tokens}")
    if not (torch.isfinite(feats).all() and torch.isfinite(hidden).all()):
        fail("non-finite video features or hidden states")
    if toks != out["output"]:
        log("  note: the repeated generate differs from the counted run")

    # kernel path against the plain path at full width: video tokens,
    # prefill hidden states and the logits of the first decode steps, the
    # plain path fed the kernel path's greedy tokens
    with torch.no_grad():
        for w in wrappers.values():
            w.launches = 0
        kernel_out = staged_path(rt, ids, pixels, N_STEPS, True)
        if ragged_decode_attention.launches == 0 or flash_attention.launches == 0:
            fail("the kernel path of the comparison did not launch the kernels")
        plain_out = staged_path(rt, ids, pixels, N_STEPS, False, forced=kernel_out[3])
    compare_paths(kernel_out, plain_out, PATH_COS,
                  "bf16 rounds at other places through 26 SigLIP and 28 Qwen2 layers of "
                  "random weights")
    request = dict(frames=frames, question=question, region={}, max_new=max_new_tokens,
                   text=text, ids=out["output"], decode_tps=decode_tps)
    return launches, rt, tok, request


def all_wrappers():
    from ufvideo_tpu_torch import probe_int8_rate
    from ufvideo_tpu_torch.ops import (
        decode_attention, flash_attention, hiera_block, quant_matmul, vit_attention,
        window_attention)

    return {
        "fused_hiera_block": hiera_block.fused_hiera_block,
        "flash_attention": flash_attention.flash_attention,
        "ragged_decode_attention": decode_attention.ragged_decode_attention,
        "fused_ln_matmul": hiera_block.fused_ln_matmul,
        "fused_block_tail": hiera_block.fused_block_tail,
        "fused_qpool_block": hiera_block.fused_qpool_block,
        "ragged_decode_attention_q8": decode_attention.ragged_decode_attention_q8,
        "int8_matvec": quant_matmul.int8_matvec,
        "int4_matmul": quant_matmul.int4_matmul,
        "fused_block_w8a8": hiera_block.fused_block_w8a8,
        "fused_qpool_block_w8a8": hiera_block.fused_qpool_block_w8a8,
        "fused_ln_matmul_w8a8": hiera_block.fused_ln_matmul_w8a8,
        "fused_block_tail_w8a8": hiera_block.fused_block_tail_w8a8,
        "fused_hiera_stage": hiera_block.fused_hiera_stage,
        "fused_window_attention": window_attention.fused_window_attention,
        "mha_full_attention_packed": vit_attention.mha_full_attention_packed,
        "probe_step": probe_int8_rate.probe_step,
    }


def _trunk(cfg, routing=None):
    """Hiera as ``model_init`` builds it for ``cfg`` and ``routing``, on the
    meta device (nothing allocated)."""
    from ufvideo_tpu_torch.models.sam2.hiera import Hiera

    with torch.device("meta"):
        return Hiera(cfg.sam.hiera, torch.bfloat16, quant=bool(cfg.quant_vision),
                     routing=routing)


def expected_sam_launches(cfg, n_frames: int, prompted: int, tracked: int,
                          chunk: int = 8, routing=None) -> dict:
    """Kernel launches of SAM2 on ``n_frames`` encoded frames, from the
    configuration and the routing: each call of Hiera's forward for each
    encode chunk (a run of blocks: the stage kernel; a block: its route's
    kernels, W8A8 on a ``quant_vision`` runtime; flash for a global block's
    attention, the window kernel for a generic windowed block of at most
    512 tokens); two attentions per memory-attention layer per tracked frame,
    and the mask decoder's seven on every prompted and every tracked frame."""
    trunk = _trunk(cfg, routing)
    chunks = -(-n_frames // chunk)
    q = "_w8a8" if cfg.quant_vision else ""
    want = dict.fromkeys(all_wrappers(), 0)
    flash = 0
    for group, route in zip(trunk.groups, trunk.call_routes()):
        blk = trunk.blocks[group[0]]
        if route == "stage":
            want["fused_hiera_stage"] += chunks
        elif route == "block":
            want["fused_block_w8a8" if cfg.quant_vision else "fused_hiera_block"] += chunks
        elif route == "qpool":
            want["fused_qpool_block" + q] += chunks
        elif route == "split":
            want["fused_ln_matmul" + q] += chunks
            want["fused_block_tail" + q] += chunks
        elif blk.q_stride is None and 0 < blk.window_side ** 2 <= 512:
            want["fused_window_attention"] += chunks
        flash += chunks if route in ("split", "generic") and blk.window_side == 0 else 0
    want["flash_attention"] = flash + tracked * cfg.sam.mem_attn_layers * 2 + (
        prompted + tracked) * 7
    return want


def expected_w8a8_products(cfg, n_sam_frames: int, routing=None, chunk: int = 8) -> int:
    """``quant.w8a8_linear`` products of one path-B [SEG] request: the
    unfused W8A8 SigLIP layer's four, and each generic W8A8 Hiera block's
    four (five with a width-changing shortcut) for each encode chunk."""
    from ufvideo_tpu_torch.configs import VisionRouting

    routing = routing or VisionRouting()
    if not cfg.quant_vision:
        return 0
    n = 0 if routing.siglip_int8_fused else 4 * cfg.vision.num_encode_layers
    trunk = _trunk(cfg, routing)
    generic = [b for b in trunk.blocks if b.route == "generic"]
    return n + -(-n_sam_frames // chunk) * sum(4 + (b.dim != b.dim_out) for b in generic)


def expected_seg_launches(cfg, n_sam_frames: int, routing=None) -> dict:
    """Kernel launches of one path-B [SEG] request: SAM2 on its frames (frame
    0 prompted, the rest tracked), the SigLIP tower's layers (the whole-block
    kernel, W8A8 on a ``quant_vision`` runtime, or the packed attention of
    the unfused layer) and flash for the LLM's layers. The LLM's forward has
    thousands of rows: its quantised products dequantise and launch no
    matvec."""
    from ufvideo_tpu_torch.configs import VisionRouting

    routing = routing or VisionRouting()
    want = expected_sam_launches(cfg, n_sam_frames, 1, n_sam_frames - 1, routing=routing)
    fused = routing.siglip_int8_fused if cfg.quant_vision else routing.siglip_ln_dtype == "f32"
    tower = ("fused_block_w8a8" if cfg.quant_vision else "fused_hiera_block") if fused \
        else "mha_full_attention_packed"
    want[tower] += cfg.vision.num_encode_layers
    want["flash_attention"] += cfg.llm.num_layers
    return want


def expected_referring_launches(cfg, n_generated: int, calls_to_tower: int = 2) -> dict:
    """Kernel launches of one referring QA request that generated
    ``n_generated`` tokens, from the configuration: the tower's layers once
    for the video and once for the annotated frames; flash for the LLM's
    layers in prefill; per decode step one decode attention a layer and one
    quantised product for each of a layer's five projections and for
    ``lm_head``, whose single prefill row adds one."""
    want = dict.fromkeys(all_wrappers(), 0)
    steps = n_generated - 1
    layers = cfg.llm.num_layers
    tower = "fused_block_w8a8" if cfg.quant_vision else "fused_hiera_block"
    want[tower] = calls_to_tower * cfg.vision.num_encode_layers
    want["flash_attention"] = layers
    want["ragged_decode_attention_q8" if cfg.quant_kv else "ragged_decode_attention"] = (
        layers * steps)
    if cfg.quant_llm:
        from ufvideo_tpu_torch.quant import quant_bits

        name = "int4_matmul" if quant_bits(cfg.quant_llm) == 4 else "int8_matvec"
        want[name] = steps * (5 * layers + 1) + 1
    return want


def expected_spec_launches(cfg, n_verify: int, calls_to_tower: int) -> dict:
    """Kernel launches of one speculative request (batch 1, ``n_verify``
    verify steps): the tower's layers per encode; flash for the LLM's layers
    in prefill; no decode attention (a verify step attends with the plain
    masked attention, as the JAX layer does); the quantised products: the
    first token's lm_head at one row, then each verify step's five
    projections a layer and lm_head at SPEC_K + 1 rows."""
    want = expected_referring_launches(cfg, 1, calls_to_tower)
    if cfg.quant_llm:
        from ufvideo_tpu_torch.quant import quant_bits

        name = "int4_matmul" if quant_bits(cfg.quant_llm) == 4 else "int8_matvec"
        want[name] = 1 + n_verify * (5 * cfg.llm.num_layers + 1)
    return want


def expected_batch_launches(cfg, n_generated: int, sam_frames: int) -> dict:
    """Kernel launches of phase 4b's ``mm_infer_batch``: the tower's layers
    once for the four videos and once for the annotated frame; flash for the
    LLM's layers in path A's prefill and in path B's forward; a decode
    attention a layer for each of path A's decode steps; SAM2 on the path-B
    sample's frames (one object: frame 0 prompted, the rest tracked)."""
    want = expected_sam_launches(cfg, sam_frames, 1, sam_frames - 1)
    want["fused_hiera_block"] += 2 * cfg.vision.num_encode_layers
    want["flash_attention"] += 2 * cfg.llm.num_layers
    want["ragged_decode_attention"] += cfg.llm.num_layers * (n_generated - 1)
    return want


def expected_chunked_prefill_launches(cfg, n_generated: int, batch: int, chunk: int) -> dict:
    """Phase 5b's launches with the prefill's flash once a layer for each of
    the ceil(batch / chunk) chunks."""
    want = expected_referring_launches(cfg, n_generated, calls_to_tower=0)
    want["flash_attention"] = cfg.llm.num_layers * -(-batch // chunk)
    return want


# W8A8 kernel path vs plain path: a block alone differs by 7.5e-3 in relative
# Frobenius norm (re-quantise flips, phase 2); 26 of them in sequence
QUANT_COS = 0.99


def run_referring(dev, seed: int, cfg, label: str, max_new_tokens: int,
                  frame_shape=(32, 480, 640, 3), during=None):
    """Phase 5: one region-referring QA request on a quantised runtime;
    ``during(rt, tok)``, when given, runs on that runtime before it is freed
    and its launches go into the serving counts as "eval"."""
    from ufvideo_tpu_torch import mm_infer, model_init
    from ufvideo_tpu_torch.api import _assemble_input_ids
    from ufvideo_tpu_torch.ops.image_pipeline import siglip_preprocess_device

    wrappers = all_wrappers()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt, _, tok = model_init(cfg=cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    log(f"  [{label}] model_init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (peak while building "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    cfg = rt.cfg
    rng = np.random.default_rng(seed + 2)
    frames = rng.integers(0, 256, frame_shape, dtype=np.uint8)
    h, w = frame_shape[1:3]
    mask = np.zeros((1, h, w), np.float32)
    mask[0, h // 4:3 * h // 4, w // 3:2 * w // 3] = 1.0
    region = (frames[7:8], mask, [[0]])
    question = "What is <region> doing in this video?"
    call = lambda f, n: mm_infer(f, question, rt, tok, masks=region[1], frame=region[0],
                                 ann_indices=region[2], max_new_tokens=n)
    call(frames[::-1], 2)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for wr in wrappers.values():
        wr.launches = 0
    t0 = time.perf_counter()
    text, out = call(frames, max_new_tokens)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = {k: wr.launches for k, wr in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_gen = len(out["output"])
    log(f"  [{label}] mm_infer with one <region>: {e2e * 1e3:.1f} ms end to end, {n_gen} "
        f"tokens, peak {peak:.2f} GiB; launches {launches}")
    want = expected_referring_launches(cfg, n_gen)
    log(f"  [{label}] launches predicted from the configuration: {want}")
    if launches != want:
        fail(f"launch counts of the {label} referring request differ from the prediction")

    # stage timings, outside the counted run
    ids = _assemble_input_ids(question, 1, "<video>", tok)
    sync_t = lambda: (torch.cuda.synchronize(), time.perf_counter())[1]
    t0 = sync_t()
    pixels = siglip_preprocess_device(torch.from_numpy(frames).to(dev), cfg.compute_dtype)
    t1 = sync_t()
    feats = rt.encode_video(pixels[None])
    t2 = sync_t()
    rfeats, counts = rt.pack_and_encode_regions(*region)
    t3 = sync_t()
    _, _, plan = rt.generate(ids, feats, rfeats, counts, max_new_tokens=1)
    t4 = sync_t()
    toks, hidden, _ = rt.generate(ids, feats, rfeats, counts, max_new_tokens=max_new_tokens)
    t5 = sync_t()
    step_ms = ((t5 - t4) - (t4 - t3)) / max(len(toks) - 1, 1) * 1e3
    log(f"  [{label}] prompt {int(plan.seq_lens[0])} tokens ({feats.shape[1]} video + "
        f"{sum(counts)} region tokens); preprocess {(t1 - t0) * 1e3:.1f} ms, video encode "
        f"{(t2 - t1) * 1e3:.1f} ms, region encode {(t3 - t2) * 1e3:.1f} ms, prefill + first "
        f"token {(t4 - t3) * 1e3:.1f} ms, decode {step_ms:.2f} ms a step "
        f"({1e3 / step_ms:.2f} tok/s)")
    if sum(counts) != 1 or tuple(rfeats.shape) != (1, cfg.region.region_token_num,
                                                   cfg.llm.hidden_size):
        fail(f"region tokens {tuple(rfeats.shape)}, counts {counts}")
    if not (torch.isfinite(feats).all() and torch.isfinite(rfeats).all()
            and torch.isfinite(hidden).all()):
        fail("non-finite video tokens, region tokens or hidden states")

    with torch.no_grad():
        for wr in wrappers.values():
            wr.launches = 0
        kernel_out = staged_path(rt, ids, pixels, N_STEPS, True, region=region)
        if any(wr.launches == 0 for k, wr in wrappers.items() if want[k]):
            fail("the kernel path of the comparison did not launch the kernels")
        plain_out = staged_path(rt, ids, pixels, N_STEPS, False, forced=kernel_out[3],
                                region=region)
    limit = QUANT_COS if cfg.quant_vision else PATH_COS
    compare_paths(kernel_out, plain_out, limit,
                  "the W8A8 tower re-quantises at other rounding boundaries through 26 blocks"
                  if cfg.quant_vision else "as the bf16 path")
    log(f" 5b [{label}]: batched decode, {BATCH} questions on the request's video")
    batch_launches, batch_ref = run_batched(dev, rt, tok, feats, label)
    request = dict(frames=frames, question=question, max_new=max_new_tokens, text=text,
                   ids=out["output"],
                   region=dict(masks=region[1], frame=region[0], ann_indices=region[2]))
    log(f" 5c [{label}]: speculative decoding, chunked prefill"
        + (", streaming" if cfg.quant_kv else ""))
    serving = {"spec": run_spec(dev, rt, tok, label, request),
               "chunked": run_chunked_prefill(dev, rt, tok, feats, label, batch_ref)}
    if cfg.quant_kv:
        serving["stream"] = run_stream(dev, rt, tok, label, request)
    if during is not None:
        serving["eval"] = during(rt, tok)
    del rt
    torch.cuda.empty_cache()
    return launches, batch_launches, serving


# Phase 5b: the JAX package's serving batch (scripts/serve.py --max-batch 8)
# through UFVideoRuntime.generate_batch: one encoded video, 8 questions of
# different lengths (ragged prompts, so ragged decode positions), 16 new
# tokens; every decode step hands each quantised projection 8 rows.
BATCH_NEW_TOKENS = 16
BATCH_STEPS = 4  # decode steps whose logits the kernel and plain paths are compared on
BATCH_QUESTIONS = (
    "What happens?",
    "What happens in this video?",
    "Describe the video.",
    "Who is in the video and what are they doing?",
    "What colour is the largest object in the scene, and where does it move?",
    "How many people appear?",
    "Summarise the video in one sentence, then list every object you can see in it.",
    "Is it day or night?",
)
BATCH = len(BATCH_QUESTIONS)


def staged_batch(rt, embeds, lens, n_steps, use_kernels, forced=None):
    """generate_batch's first ``n_steps`` steps in stages: (logits [n_steps,
    B, vocab], greedy tokens [n_steps, B]). The prefill runs through the
    kernels on both paths (the plain attention would hold eight prompts'
    [S, S] scores); ``use_kernels`` routes the decode steps and lm_head.
    ``forced`` feeds given tokens instead of the greedy ones."""
    from ufvideo_tpu_torch.models.generate import _mask_vocab_logits, prefill_cache
    from ufvideo_tpu_torch.models.qwen2 import make_kv_cache

    cfg, llm = rt.cfg, rt.model.llm
    b, s = embeds.shape[:2]
    cache = make_kv_cache(cfg.llm, b, -(-(s + n_steps) // 128) * 128, dtype=cfg.compute_dtype,
                          device=rt.device, quant=bool(cfg.quant_kv))
    cache, last = prefill_cache(llm, embeds, lens, cache)
    rt.model.set_use_kernels(use_kernels)
    cur_len = lens.long()
    logits, toks = [], []
    for i in range(n_steps):
        lg = _mask_vocab_logits(llm.logits(last[:, None])[:, 0].float(), cfg.llm.vocab_size)
        logits.append(lg)
        toks.append(lg.argmax(-1))
        nxt = toks[-1] if forced is None else forced[i]
        h, cache = llm.backbone(llm.embed(nxt[:, None]), cur_len[:, None], None, cache,
                                cur_len, "decode")
        last, cur_len = h[:, 0], cur_len + 1
    rt.model.set_use_kernels(True)
    return torch.stack(logits), torch.stack(toks)


def run_batched(dev, rt, tok, feats, label: str) -> dict:
    """Phase 5b on a phase-5 runtime: the batch's launches read around one
    generate_batch call and held to what the configuration predicts (every
    quantised product at 8 rows), ms a step, tok/s over the batch, peak
    memory; then the kernel path against the plain path over BATCH_STEPS
    decode steps (logits cosine, greedy tokens but at a near tie)."""
    from ufvideo_tpu_torch.api import _assemble_input_ids
    from ufvideo_tpu_torch.ops import quant_matmul as qm
    from ufvideo_tpu_torch.quant import quant_bits

    wrappers = all_wrappers()
    cfg = rt.cfg
    ids = [_assemble_input_ids(q, 1, "<video>", tok) for q in BATCH_QUESTIONS]
    vf = feats.expand(BATCH, -1, -1)
    run = lambda n: rt.generate_batch(ids, vf, max_new_tokens=n)
    run(2)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for wr in wrappers.values():
        wr.launches = 0
    out, plan = run(BATCH_NEW_TOKENS)
    torch.cuda.synchronize()
    launches = {k: wr.launches for k, wr in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen_lens = [len(t) for t, _ in out]
    want = expected_referring_launches(cfg, max(gen_lens), calls_to_tower=0)
    wrapper = qm.int4_matmul if quant_bits(cfg.quant_llm) == 4 else qm.int8_matvec
    log(f"  [{label}] generate_batch B={BATCH}: prompts {list(map(int, plan.seq_lens))}, "
        f"generated {gen_lens}, peak {peak:.2f} GiB; launches {launches}; last plan "
        f"{wrapper.last_plan}")
    log(f"  [{label}] launches predicted from the configuration: {want}")
    if launches != want:
        fail(f"launch counts of the {label} batched decode differ from the prediction")
    if not (isinstance(wrapper.last_plan, qm.RowsPlan) and wrapper.last_plan.rows == BATCH):
        fail(f"{wrapper.__name__} last ran at {wrapper.last_plan}, not {BATCH} rows")
    for t, h in out:
        if not torch.isfinite(h).all():
            fail("non-finite hidden states in the batched decode")

    sync_t = lambda: (torch.cuda.synchronize(), time.perf_counter())[1]
    t0 = sync_t()
    run(1)
    t1 = sync_t()
    run(BATCH_NEW_TOKENS)
    t2 = sync_t()
    steps = max(gen_lens) - 1
    step_ms = ((t2 - t1) - (t1 - t0)) / max(steps, 1) * 1e3
    log(f"  [{label}] batched decode: prefill + first token {(t1 - t0) * 1e3:.1f} ms, "
        f"{step_ms:.2f} ms a step over {steps} steps, {BATCH * 1e3 / step_ms:.1f} tok/s over "
        f"the batch")
    ref = dict(tokens=[t for t, _ in out], peak=peak, prefill_ms=(t1 - t0) * 1e3)

    plan, embeds = rt._splice_plan(ids, vf)
    lens = torch.as_tensor(plan.seq_lens, device=dev).to(torch.int32)
    with torch.no_grad():
        lg_k, toks_k = staged_batch(rt, embeds, lens, BATCH_STEPS, True)
        lg_p, _ = staged_batch(rt, embeds, lens, BATCH_STEPS, False, forced=toks_k)
    if not torch.isfinite(lg_k).all():
        fail("non-finite logits on the batched kernel path")
    step_cos = [cosine(a, b) for a, b in zip(lg_k, lg_p)]
    flips, same = [], 0
    for i in range(BATCH_STEPS):
        for r in range(BATCH):
            a, b, t = lg_k[i, r], lg_p[i, r], int(toks_k[i, r])
            same += int(b.argmax()) == t
            if int(b.argmax()) != t and float(b.max() - b[t]) > float((a - b).abs().max()):
                flips.append((i, r))
    log(f"  [{label}] batched kernel vs plain path: decode logits cosine min "
        f"{min(step_cos):.5f} over {BATCH_STEPS} steps x {BATCH} rows, greedy tokens equal "
        f"{same}/{BATCH_STEPS * BATCH}; tolerance cosine >= {PATH_COS}")
    if min(step_cos) < PATH_COS:
        fail("batched kernel path and plain path disagree")
    if flips:
        fail(f"batched greedy tokens differ beyond a near tie at (step, row) {flips}")
    return launches, ref


# ------------------------------------------- phases 4b and 5c: serving --

class LogitsRecorder:
    """While active, keeps what ``llm.logits`` returns, float32 with the
    padding ids masked: one [B, T, vocab] entry a call. Recording launches
    none of the counted kernels."""

    def __init__(self, rt):
        self.llm, self.vocab = rt.model.llm, rt.cfg.llm.vocab_size

    def __enter__(self):
        from ufvideo_tpu_torch.models.generate import _mask_vocab_logits

        real, self.calls = self.llm.logits, []

        def logits(h):
            out = real(h)
            self.calls.append(_mask_vocab_logits(out.float(), self.vocab))
            return out

        self.llm.logits = logits
        return self

    def __exit__(self, *exc):
        del self.llm.logits

    def steps(self, row: int = 0) -> list:
        """A decode loop's logits of ``row``, one a call (call j made token j)."""
        return [c[row, -1] for c in self.calls]


def first_near_tie(what, ref_toks, ref_logits, toks, logits):
    """Tokens against a reference run's: equal, or differing first at a near
    tie, where the reference's logit gap between its token and this run's
    lies below the two runs' largest logit difference at that position
    (``ref_logits[p]`` / ``logits[p]`` made token p). The comparison ends
    there: the contexts part. Returns (tokens equal before it, the tie
    position or None)."""
    for p, (a, b) in enumerate(zip(ref_toks, toks)):
        if a != b:
            lr, lg = ref_logits[p], logits[p]
            gap, diff = float(lr[a] - lr[b]), float((lr - lg).abs().max())
            log(f"  {what}: first difference at token {p}: logit gap {gap:.4f}, the runs' "
                f"largest logit difference there {diff:.4f}")
            if gap >= diff:
                fail(f"{what}: tokens differ beyond a near tie at token {p}")
            return p, p
    if len(ref_toks) != len(toks):
        fail(f"{what}: {len(toks)} tokens against {len(ref_toks)}, equal where both ran")
    return len(toks), None


def run_stream(dev, rt, tok, label, req) -> dict:
    """``mm_infer_stream`` of a request with chunks of 8: the joined deltas
    are the request's ``mm_infer`` text and its ids the same ids (the same
    kernels at the same shapes); launches held to the prediction; the time
    to the first ids and to the first delta (the streamer holds back
    invalid UTF-8, most of a random model's bytes), ms a token after the
    first."""
    from ufvideo_tpu_torch import mm_infer_stream

    ids, first_ids = [], []
    real = rt.generate_stream

    def recording(*a, **kw):  # the ids and when the first of them surfaced
        for chunk_ids, hid in real(*a, **kw):
            if not first_ids:
                first_ids.append(time.perf_counter())
            ids.extend(chunk_ids)
            yield chunk_ids, hid

    def run(frames, n):
        t0, first, deltas = time.perf_counter(), None, []
        for d in mm_infer_stream(frames, req["question"], rt, tok, chunk=8, max_new_tokens=n,
                                 **req["region"]):
            first = time.perf_counter() - t0 if first is None else first
            deltas.append(d)
        return t0, first, deltas

    rt.generate_stream = recording
    try:
        run(req["frames"][::-1], 2)  # warm-up, outside the counted run
        ids.clear()
        first_ids.clear()
        (t0, first, deltas), launches, ms = _count(all_wrappers(), lambda: run(
            req["frames"], req["max_new"]))
    finally:
        del rt.generate_stream
    want = expected_referring_launches(rt.cfg, len(ids), 1 + bool(req["region"]))
    tok_ms = (ms - (first_ids[0] - t0) * 1e3) / max(len(ids) - 1, 1)
    log(f"  [{label}] mm_infer_stream, chunk 8: {ms:.1f} ms end to end, {len(ids)} ids, "
        f"{len(deltas)} deltas; first ids after {(first_ids[0] - t0) * 1e3:.1f} ms, first "
        f"delta after {first * 1e3 if first is not None else float('nan'):.1f} ms, "
        f"{tok_ms:.2f} ms a token after the first; launches {launches}")
    log(f"  [{label}] launches predicted: {want}")
    if launches != want:
        fail(f"launch counts of the {label} stream differ from the prediction")
    if ids != req["ids"] or "".join(deltas).strip() != req["text"]:
        fail(f"[{label}] the stream's ids or text differ from mm_infer's")
    log(f"  [{label}] stream ids == mm_infer ids ({len(ids)}), joined deltas == its text")
    return launches


def run_spec(dev, rt, tok, label, req) -> dict:
    """``mm_infer`` of a request on a runtime sharing ``rt``'s model with
    ``spec_decode=SPEC_K``: tokens against the request's plain ones but at a
    near tie (the logits of a verify forward against a decode step's);
    launches held to the prediction (on a quantised model every verify
    product at SPEC_K + 1 rows); drafted / accepted tokens, verify steps and
    ms a verify step; then ``generate_stream`` under speculation gives the
    same tokens."""
    from ufvideo_tpu_torch import mm_infer
    from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids, _encode_video_input
    from ufvideo_tpu_torch.models.speculative import spec_generate
    from ufvideo_tpu_torch.ops import quant_matmul as qm
    from ufvideo_tpu_torch.quant import quant_bits
    from ufvideo_tpu_torch.splicing import plan_lookup_ids

    cfg = rt.cfg
    srt = UFVideoRuntime(cfg.replace(spec_decode=SPEC_K), rt.model, rt.ids, dev)
    call = lambda f, n: mm_infer(f, req["question"], srt, tok, max_new_tokens=n, **req["region"])
    call(req["frames"][::-1], 2)  # warm-up, outside the counted run
    (_, out), launches, ms = _count(all_wrappers(), lambda: call(req["frames"], req["max_new"]))
    toks = out["output"]

    # the same prompt staged: the loop's counters and times, the logits
    ids = _assemble_input_ids(req["question"], 1, "<video>", tok)
    feats = _encode_video_input(rt, req["frames"], "video")
    region = (srt.pack_and_encode_regions(req["region"]["frame"], req["region"]["masks"],
                                          req["region"]["ann_indices"])
              if req["region"] else (None, None))
    plan, embeds = srt._splice_plan([ids], feats, region[0], [region[1] or []])
    lookup = torch.as_tensor(plan_lookup_ids(plan)[:, :embeds.shape[1]], device=dev)
    kw = dict(stop_ids=(rt.ids.eos,), vocab_size=cfg.llm.vocab_size,
              cache_max_len=embeds.shape[1] + req["max_new"] + SPEC_K, draft_k=SPEC_K,
              kv_quant=bool(cfg.quant_kv))
    lens = torch.as_tensor(plan.seq_lens, device=dev)
    timed = lambda n: _count({}, lambda: spec_generate(rt.model.llm, embeds, lens, lookup,
                                                       max_new_tokens=n, **kw))
    _, _, ms_first = timed(1)
    res, _, ms_all = timed(req["max_new"])
    n_verify = res.n_iters - 1
    want = expected_spec_launches(cfg, n_verify, 1 + bool(req["region"]))
    wrapper = None
    if cfg.quant_llm:
        wrapper = qm.int4_matmul if quant_bits(cfg.quant_llm) == 4 else qm.int8_matvec
    log(f"  [{label}] mm_infer, spec_decode={SPEC_K}: {ms:.1f} ms end to end, {len(toks)} "
        f"tokens in {n_verify} verify steps, drafted {int(res.n_drafted[0])}, accepted "
        f"{int(res.n_accepted[0])}; spec_generate alone {ms_all:.1f} ms, prefill + first "
        f"token {ms_first:.1f} ms, {(ms_all - ms_first) / max(n_verify, 1):.2f} ms a verify "
        f"step; launches {launches}"
        + (f"; last plan {wrapper.last_plan}" if wrapper else ""))
    log(f"  [{label}] launches predicted: {want}")
    if launches != want:
        fail(f"launch counts of the {label} speculative request differ from the prediction")
    if wrapper and not (isinstance(wrapper.last_plan, qm.RowsPlan)
                        and wrapper.last_plan.rows == SPEC_K + 1):
        fail(f"{wrapper.__name__} last ran at {wrapper.last_plan}, not {SPEC_K + 1} rows")
    if res.tokens[0, :len(toks)].tolist() != toks:
        fail(f"[{label}] spec_generate differs from the speculative mm_infer")

    # the tokens against the plain run's, the logits of both recorded
    with LogitsRecorder(rt) as plain:
        ref, _, _ = rt.generate(ids, feats, *region, max_new_tokens=req["max_new"])
    if ref != req["ids"]:
        fail(f"[{label}] the plain request repeated gives other tokens")
    streamed, logits = [], []
    with LogitsRecorder(rt) as rec:
        for chunk_ids, _ in srt.generate_stream(ids, feats, *region,
                                                max_new_tokens=req["max_new"]):
            streamed.extend(chunk_ids)
            logits.extend(rec.calls[-1][0, :len(chunk_ids)])
    if streamed != toks:
        fail(f"[{label}] generate_stream under speculation differs from mm_infer's tokens")
    same, tie = first_near_tie(f"[{label}] speculative vs plain", req["ids"], plain.steps(),
                               toks, logits)
    log(f"  [{label}] speculative tokens equal the plain ones {same}/{len(req['ids'])}"
        + (f", then a near tie at token {tie}" if tie is not None else "")
        + f"; generate_stream under speculation == mm_infer's {len(toks)} tokens")
    return launches


def run_serving_batch(dev, rt, tok, qa, seg) -> dict:
    """``mm_infer_batch`` (choice 3) of four samples: two questions and a
    ``<region>`` request (the annotated frame and mask made as phase 5 makes
    them) on phase 3's video, and phase 4's ``[SEG]``-input request (path
    B). Path A's tokens against each sample's own ``mm_infer`` but at a near
    tie (a batch row's logits against the single request's); path B's masks
    against phase 4's on at least MASK_AGREE of each frame's pixels;
    launches held to the prediction; ms and peak memory."""
    from ufvideo_tpu_torch import mm_infer, mm_infer_batch

    frames = qa["frames"]
    h, w = frames.shape[1:3]
    mask = np.zeros((1, h, w), np.float32)
    mask[0, h // 4:3 * h // 4, w // 3:2 * w // 3] = 1.0
    human = lambda q: [{"from": "human", "value": "<video>\n" + q}]
    samples = [
        {"video": frames, "instruct": human(qa["question"])},
        {"video": frames, "instruct": human("Describe the video.")},
        {"video": frames, "instruct": human("What is <region> doing in this video?"),
         "frame": frames[7:8], "masks": mask, "ann_indices": [[0]]},
        {"video": seg["frames"], "instruct": seg["conv"], "images_sam": seg["images_sam"],
         "label_size": seg["label_size"]},
    ]
    n_new = qa["max_new"]
    singles = []
    for s in samples[:3]:  # each path-A sample alone, its logits recorded
        kw = {k: s[k] for k in ("frame", "masks", "ann_indices") if k in s}
        with LogitsRecorder(rt) as rec:
            _, out = mm_infer(s["video"], s["instruct"], rt, tok, choice=3,
                              max_new_tokens=n_new, **kw)
        singles.append((out["output"], rec.steps()))
    if singles[0][0] != qa["ids"]:
        fail("phase 3's request in choice-3 form gives other tokens")
    run = lambda n: mm_infer_batch(samples, rt, tok, choice=3, max_new_tokens=n)
    run(2)  # warm-up, outside the counted run
    torch.cuda.reset_peak_memory_stats()
    with LogitsRecorder(rt) as rec:
        got, launches, ms = _count(all_wrappers(), lambda: run(n_new))
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen = [len(o["output"]) for _, o in got[:3]]
    want = expected_batch_launches(rt.cfg, max(gen), len(seg["images_sam"]))
    log(f"  mm_infer_batch: {ms:.1f} ms end to end for 3 path-A samples ({gen} tokens) and "
        f"1 path-B sample, peak {peak:.2f} GiB; launches {launches}")
    log(f"  launches predicted: {want}")
    if launches != want:
        fail("launch counts of mm_infer_batch differ from the prediction")
    for r, ((toks, lg), (_, out)) in enumerate(zip(singles, got)):
        same, tie = first_near_tie(f"batch row {r} vs alone", toks, lg, out["output"],
                                   rec.steps(r))
        log(f"  batch row {r}: tokens equal its own mm_infer's {same}/{len(toks)}"
            + (f", then a near tie at token {tie}" if tie is not None else ""))
    text, out = got[3]
    masks = out["pred_masks"]
    if text is not None or len(masks) != 1 or masks[0].shape != seg["masks"].shape:
        fail(f"path B: text {text!r}, masks {[m.shape for m in masks]}")
    agree = [float((a == b).mean()) for a, b in zip(masks[0], seg["masks"])]
    log(f"  path B masks against phase 4's: agreement per frame {[round(a, 5) for a in agree]} "
        f"(tolerance >= {MASK_AGREE})")
    if min(agree) < MASK_AGREE:
        fail("path B's masks disagree with phase 4's")
    return launches


# path B's masks in a batch against the same request's alone: the JAX
# package's limit between batched and per-sample masks (tests/test_api.py)
MASK_AGREE = 0.99
PREFILL_CHUNK = 3


def run_chunked_prefill(dev, rt, tok, feats, label, ref) -> dict:
    """5b's batch through ``generate_batch`` on a runtime sharing ``rt``'s
    model with ``prefill_chunk=PREFILL_CHUNK``: three chunks, the last one's
    start clamped. Tokens against 5b's but at a near tie (each row's logits
    against the unchunked run's); launches held to the prediction; prefill
    ms and peak memory beside 5b's."""
    from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids

    crt = UFVideoRuntime(rt.cfg.replace(prefill_chunk=PREFILL_CHUNK), rt.model, rt.ids, dev)
    ids = [_assemble_input_ids(q, 1, "<video>", tok) for q in BATCH_QUESTIONS]
    vf = feats.expand(BATCH, -1, -1)
    crt.generate_batch(ids, vf, max_new_tokens=2)  # warm-up, outside the counted run
    torch.cuda.reset_peak_memory_stats()
    with LogitsRecorder(rt) as rec:
        (out, _), launches, _ = _count(all_wrappers(), lambda: crt.generate_batch(
            ids, vf, max_new_tokens=BATCH_NEW_TOKENS))
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, _, prefill_ms = _count({}, lambda: crt.generate_batch(ids, vf, max_new_tokens=1))
    gen = [len(t) for t, _ in out]
    want = expected_chunked_prefill_launches(rt.cfg, max(gen), BATCH, PREFILL_CHUNK)
    log(f"  [{label}] generate_batch B={BATCH}, prefill_chunk={PREFILL_CHUNK}: prefill + first "
        f"token {prefill_ms:.1f} ms (5b: {ref['prefill_ms']:.1f}), peak {peak:.2f} GiB (5b: "
        f"{ref['peak']:.2f}); launches {launches}")
    log(f"  [{label}] launches predicted: {want}")
    if launches != want:
        fail(f"launch counts of the {label} chunked prefill differ from the prediction")
    with LogitsRecorder(rt) as whole:
        again, _ = rt.generate_batch(ids, vf, max_new_tokens=BATCH_NEW_TOKENS)
    if [t for t, _ in again] != ref["tokens"]:
        fail(f"[{label}] 5b's batch repeated gives other tokens")
    equal = 0
    for r, (t_ref, (t, _)) in enumerate(zip(ref["tokens"], out)):
        same, _ = first_near_tie(f"[{label}] chunked row {r}", t_ref, whole.steps(r), t,
                                 rec.steps(r))
        equal += same == len(t_ref)
    log(f"  [{label}] chunked prefill: {equal}/{BATCH} rows' tokens equal 5b's whole")
    return launches


def iou(a: torch.Tensor, b: torch.Tensor) -> float:
    union = float((a | b).sum())
    return float((a & b).sum()) / union if union else 1.0


def run_seg(dev, seed: int, rt, tok, frame_shape=(32, 480, 640, 3), sam_frames=4,
            label_size=(480, 640), feat_cos=PATH_COS, low_cos=SEG_COS, vid_cos=PATH_COS,
            routing=None):
    """One path-B [SEG] request on ``rt`` (built with ``routing``);
    ``feat_cos`` / ``low_cos`` / ``vid_cos`` are the limits of the kernel path
    against the plain path on the FPN level-2 features, on each frame's
    low-res mask logits and on the video tokens. Returns (launches, the
    kernel path's video tokens, FPN level-2 features and low-res logits)."""
    from ufvideo_tpu_torch import mm_infer
    from ufvideo_tpu_torch.quant import w8a8_linear
    from ufvideo_tpu_torch.models.sam2.common import ProjAttention
    from ufvideo_tpu_torch.models.sam2.video import (
        encode_video_frames, init_on_first_frame, masks_to_video_res,
        propagate_video, track_frame)
    from ufvideo_tpu_torch.ops.image_pipeline import sam_preprocess_device

    cfg = rt.cfg
    wrappers = all_wrappers()
    rng = np.random.default_rng(seed + 1)
    frames = rng.integers(0, 256, frame_shape, dtype=np.uint8)
    images_sam = rng.integers(0, 256, (sam_frames,) + tuple(frame_shape[1:]), dtype=np.uint8)
    conv = [{"from": "human", "value": "<video>\nPlease segment the cat."},
            {"from": "gpt", "value": "It is [SEG]."}]
    call = lambda f, im: mm_infer(f, conv, rt, tok, modal="video", choice=3, images_sam=im,
                                  label_size=label_size, seg=True)
    # warm-up, outside the counted run; it also records the shapes the mask
    # decoder's attentions take, which phase 2 must have held
    seen, hooks = set(), []
    for m in rt.model.sam.sam_mask_decoder.modules():
        if isinstance(m, ProjAttention):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a: seen.add((a[0].shape[1], a[1].shape[1],
                                         mod.q_proj.out_features // mod.num_heads))))
    call(frames[::-1], images_sam[::-1])
    for h in hooks:
        h.remove()
    log(f"  mask decoder attention shapes (Sq, Skv, head dim): {sorted(seen)}")
    if seen != set(mask_decoder_shapes()):
        fail("the mask decoder's attention shapes are not the ones phase 2 held "
             f"({sorted(mask_decoder_shapes())})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for w in wrappers.values():
        w.launches = 0
    w8a8_linear.calls = 0
    t0 = time.perf_counter()
    out = call(frames, images_sam)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    products = w8a8_linear.calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  mm_infer [SEG]: {e2e * 1e3:.1f} ms end to end, peak {peak:.2f} GiB; "
        f"launches {launches}; W8A8 dense products {products}")
    want = expected_seg_launches(cfg, sam_frames, routing)
    want_products = expected_w8a8_products(cfg, sam_frames, routing)
    log(f"  launches predicted from the configuration and the routing: {want}; W8A8 dense "
        f"products {want_products}")
    if launches != want or products != want_products:
        fail("launch counts of the [SEG] request differ from the prediction")
    masks = out["pred_masks"]
    if len(masks) != 1 or masks[0].shape != (sam_frames,) + tuple(label_size) \
            or masks[0].dtype != np.bool_:
        fail(f"pred_masks: {[(m.shape, m.dtype) for m in masks]}")
    log(f"  masks {masks[0].shape} bool, foreground share per frame "
        f"{[round(float(m.mean()), 4) for m in masks[0]]}")

    # stage timings and the kernel path against the plain path, on the
    # [SEG] embedding of the kernel path's LLM forward
    from ufvideo_tpu_torch.api import _assemble_input_ids, _encode_video_input

    sam = rt.model.sam
    sync_t = lambda: (torch.cuda.synchronize(), time.perf_counter())[1]
    ids = _assemble_input_ids(conv, 3, "<video>", tok)
    t0 = sync_t()
    video = _encode_video_input(rt, frames, "video")
    hidden, plan = rt.forward_hidden_states(ids, video)
    pos = [int(plan.text_pos_map[0][i]) - 1 for i, t in enumerate(ids) if t == rt.ids.seg]
    emb = rt.model.seg_embeddings(hidden[0, pos])[:, None, :]
    t1 = sync_t()
    images = sam_preprocess_device(torch.from_numpy(images_sam).to(dev), cfg.compute_dtype)
    t2 = sync_t()
    feats = encode_video_frames(sam, images)
    t3 = sync_t()
    state, low0 = init_on_first_frame(sam, feats, emb)
    t4 = sync_t()
    lows, per_frame = [low0], []
    for fi in range(1, sam_frames):
        ta = sync_t()
        state, low = track_frame(sam, state, fi, feats.s0[fi], feats.s1[fi], feats.s2[fi],
                                 feats.pos2, num_frames=sam_frames)
        per_frame.append((sync_t() - ta) * 1e3)
        lows.append(low)
    t5 = sync_t()
    low_k = torch.stack(lows)
    masks_k = masks_to_video_res(low_k, *label_size)
    t6 = sync_t()
    log(f"  stages: video encode + LLM forward + [SEG] head {(t1 - t0) * 1e3:.1f} ms "
        f"(prompt {int(plan.seq_lens[0])} tokens), SAM preprocess {(t2 - t1) * 1e3:.1f} ms, "
        f"Hiera + FPN encode of {sam_frames} frames {(t3 - t2) * 1e3:.1f} ms, frame-0 "
        f"conditioning {(t4 - t3) * 1e3:.1f} ms, tracked frames "
        f"{[round(x, 1) for x in per_frame]} ms, upsample {(t6 - t5) * 1e3:.1f} ms")
    if not torch.isfinite(low_k).all():
        fail("non-finite low-res mask logits")
    # same inputs, weights and kernels: the staged run must reproduce the
    # entry point's masks bit for bit, so that the comparison with the plain
    # path below covers what mm_infer returned
    if not np.array_equal(masks_k[:, 0].cpu().numpy(), masks[0]):
        fail("the staged run's masks differ from those mm_infer returned")

    rt.model.set_use_kernels(False)
    video_p = _encode_video_input(rt, frames, "video")
    feats_p = encode_video_frames(sam, images)
    low_p = propagate_video(sam, feats_p, emb)
    # the memory path alone: plain propagation on the kernel path's features
    low_pk = propagate_video(sam, feats, emb)
    rt.model.set_use_kernels(True)
    torch.cuda.synchronize()
    cos_v = cosine(video, video_p)
    cos_f = cosine(feats.s2, feats_p.s2)
    cos_low = [cosine(a, b) for a, b in zip(low_k, low_p)]
    cos_mem = [cosine(a, b) for a, b in zip(low_k, low_pk)]
    masks_p = masks_to_video_res(low_p, *label_size)
    ious = [iou(a, b) for a, b in zip(masks_k[:, 0], masks_p[:, 0])]
    log(f"  kernel vs plain path: video tokens cosine {cos_v:.5f} (tolerance >= {vid_cos}); "
        f"FPN level-2 features cosine {cos_f:.5f} (tolerance >= "
        f"{feat_cos}); low-res mask logits cosine per frame "
        f"{[round(c, 5) for c in cos_low]} (tolerance >= {low_cos}; on the same features "
        f"{[round(c, 5) for c in cos_mem]}); mask IoU per frame "
        f"{[round(x, 4) for x in ious]} (reported, not gated: random weights leave "
        "logits near the threshold)")
    if cos_v < vid_cos or cos_f < feat_cos or min(cos_low) < low_cos:
        fail("SAM2 kernel path and plain path disagree at full width")
    return launches, dict(video=video, s2=feats.s2, low=low_k, conv=conv, frames=frames,
                          images_sam=images_sam, label_size=label_size, masks=masks[0],
                          weights=weights_fingerprint(rt.model))


def weights_fingerprint(model) -> list:
    """Sums of a few tensors that every routing holds: runtimes built from one
    seed under two routings must hold the same weights."""
    sam = model.sam.image_encoder_trunk
    picks = [model.vision.layers[0].qkv_kernel, model.vision.layers[-1].fc2_bias,
             model.llm.embed_tokens.weight, sam.blocks[0].mlp_layers_0.bias,
             sam.blocks[-1].attn.proj.bias]
    return [float(t.double().sum()) for t in picks]


def _count(wrappers, fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after: (result, launches, wall ms)."""
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {k: w.launches for k, w in wrappers.items()}, ms


def _rss_gib() -> float:
    """The process's peak resident set so far, GiB (Linux counts KiB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _differing(got, want) -> list:
    """Names of the parameters and buffers of two models that are not equal
    bit for bit (a name the other lacks included)."""
    g = dict([*got.named_parameters(), *got.named_buffers()])
    w = dict([*want.named_parameters(), *want.named_buffers()])
    return sorted(set(g) ^ set(w)) + [
        k for k in w if k in g and (g[k].dtype != w[k].dtype or not torch.equal(g[k], w[k]))]


CKPT_INT8_NEW_TOKENS = 8


def nonzero(launches: dict) -> dict:
    return {k: n for k, n in launches.items() if n}


def run_checkpoint(dev, seed: int, rt, tok, qa: dict, seg: dict) -> dict:
    """Phase 3b: phase 3's runtime written with the port's exporter (one
    pytorch_model.bin and config.json, and SAM2 again as a standalone
    .gamma .pt), loaded back by model_init(model_path=, sam_path=) in bf16
    and with the serving configuration. The bf16 load must equal phase 3's
    runtime bit for bit and give phase 3's ids and phase 4's masks; the int8
    load must equal the seeded int8 runtime bit for bit and launch the
    quantised kernels. Returns the launch counts of its three requests."""
    import os
    import shutil
    import tempfile

    from ufvideo_tpu_torch import mm_infer, model_init
    from ufvideo_tpu_torch.export import export_sam2, rename_g_weight_to_gamma, save_hf_checkpoint

    t_phase = time.perf_counter()
    wrappers = all_wrappers()
    cfg = rt.cfg
    sync_t = lambda: (torch.cuda.synchronize(), time.perf_counter())[1]
    tensors = [*rt.model.parameters(), *rt.model.buffers()]
    sam_bytes = sum(t.numel() * t.element_size() for t in rt.model.sam.parameters())
    need = sum(t.numel() * t.element_size() for t in tensors) + sam_bytes
    tmp = tempfile.mkdtemp(prefix="ufvideo_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"  {tmp}: {free / 1e9:.2f} GB free, the checkpoint and the SAM2 .pt need "
            f"{need / 1e9:.2f} GB")
        if free < need + 2**30:
            fail(f"phase 3b needs {need + 2**30} bytes free under {tmp} (the bf16 "
                 f"checkpoint, the SAM2 .pt and 1 GiB to spare); {free} are free")
        sam_pt = os.path.join(tmp, "sam2_hiera_large.pt")
        rss0, t0 = _rss_gib(), sync_t()
        save_hf_checkpoint(tmp, rt.model, cfg)
        t1 = time.perf_counter()
        torch.save({"model": rename_g_weight_to_gamma(export_sam2(rt.model.sam))},
                   sam_pt)
        t2 = time.perf_counter()
        files = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        written = sum(files.values())
        log(f"  export: pytorch_model.bin + config.json in {t1 - t0:.2f} s, the SAM2 .pt in "
            f"{t2 - t1:.2f} s; {written} bytes ({files}), "
            f"{written / (t2 - t0) / 1e9:.2f} GB/s; host peak RSS {rss0:.2f} -> "
            f"{_rss_gib():.2f} GiB")

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rss0, t0 = _rss_gib(), sync_t()
        rt2, _, tok2 = model_init(tmp, cfg=cfg, sam_path=sam_pt, device=dev)
        t1 = sync_t()
        log(f"  bf16 load: model_init(model_path=, sam_path=) in {t1 - t0:.2f} s, "
            f"{written / (t1 - t0) / 1e9:.2f} GB/s of files; device +"
            f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB at peak "
            f"({(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB held); host peak RSS "
            f"{rss0:.2f} -> {_rss_gib():.2f} GiB")
        diff = _differing(rt2.model, rt.model)
        if diff:
            fail(f"the bf16 load differs from phase 3's runtime in {len(diff)} tensors: "
                 f"{diff[:8]}")
        log(f"  bf16 load: all {len(tensors)} parameters equal phase 3's runtime bit for bit")
        (_, out), qa_launches, ms = _count(wrappers, lambda: mm_infer(
            qa["frames"], qa["question"], rt2, tok2, max_new_tokens=qa["max_new"]))
        log(f"  bf16 load, phase 3's request: {ms:.1f} ms, {len(out['output'])} tokens; "
            f"launches {nonzero(qa_launches)}")
        if out["output"] != qa["ids"]:
            fail(f"the bf16 load's ids {out['output']} differ from phase 3's {qa['ids']}")
        out, seg_launches, ms = _count(wrappers, lambda: mm_infer(
            seg["frames"], seg["conv"], rt2, tok2, modal="video", choice=3,
            images_sam=seg["images_sam"], label_size=seg["label_size"], seg=True))
        log(f"  bf16 load, phase 4's [SEG] request: {ms:.1f} ms; launches {nonzero(seg_launches)}")
        masks = out["pred_masks"]
        if len(masks) != 1 or not np.array_equal(masks[0], seg["masks"]):
            fail("the bf16 load's [SEG] masks differ from phase 4's")
        log("  bf16 load: phase 3's ids and phase 4's masks, exactly")
        del rt2, out
        torch.cuda.empty_cache()

        qcfg = cfg.replace(quant_llm="int8", quant_kv=True, quant_vision=True)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = sync_t()
        rt8, _, tok8 = model_init(tmp, cfg=qcfg, sam_path=sam_pt, device=dev)
        t1 = sync_t()
        log(f"  int8 load (quant_llm int8, quant_kv, quant_vision): {t1 - t0:.2f} s, "
            f"device +{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB at peak "
            f"({(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB held)")
        ref8, _, _ = model_init(cfg=qcfg, seed=seed, device=dev)
        diff = _differing(rt8.model, ref8.model)
        if diff:
            fail(f"the int8 load differs from model_init(cfg=int8, seed={seed}) in "
                 f"{len(diff)} tensors: {diff[:8]}")
        n8 = sum(1 for _ in rt8.model.parameters())
        log(f"  int8 load: all {n8} parameters equal the seeded int8 runtime's bit for bit")
        del ref8
        torch.cuda.empty_cache()
        (text, out), int8_launches, ms = _count(wrappers, lambda: mm_infer(
            qa["frames"], qa["question"], rt8, tok8, max_new_tokens=CKPT_INT8_NEW_TOKENS))
        log(f"  int8 load, phase 3's question: {ms:.1f} ms, {len(out['output'])} tokens; "
            f"launches {nonzero(int8_launches)}")
        for k in ("int8_matvec", "ragged_decode_attention_q8", "fused_block_w8a8"):
            if int8_launches[k] <= 0:
                fail(f"{k} was never launched on the int8 load")
        del rt8
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 3b: {time.perf_counter() - t_phase:.1f} s")
    return {"ckpt_bf16": qa_launches, "ckpt_bf16_seg": seg_launches, "ckpt_int8": int8_launches}


def run_predictors(dev, seed: int, rt, sam_frames=4, label_size=(480, 640)):
    """The rest of SAM2's predictors at full width on ``rt``'s SAM2:
    ``propagate_video_general`` on one video's features (a language prompt on
    frame 1 and a box on frame 3, both directions, stride 2) and the entry
    point ``segment_videos_batched`` on two videos. Each is counted, timed
    and held against the plain path. Returns the two launch dictionaries."""
    from ufvideo_tpu_torch.models.sam2.common import NO_OBJ_SCORE
    from ufvideo_tpu_torch.models.sam2.video import (
        FrameCondition, FrameFeatures, encode_video_frames, masks_to_video_res,
        propagate_video, propagate_video_general, propagate_videos_batched)
    from ufvideo_tpu_torch.ops.image_pipeline import sam_preprocess_device

    cfg, sam, wrappers = rt.cfg, rt.model.sam, all_wrappers()
    rng = np.random.default_rng(seed + 3)
    videos = rng.integers(0, 256, (2, sam_frames, 480, 640, 3), dtype=np.uint8)
    emb = torch.from_numpy(rng.standard_normal((2, cfg.sam_out_dim)).astype(np.float32))
    emb = emb.to(dev, cfg.compute_dtype)
    size = cfg.sam.hiera.image_size
    low_size = (sam_frames, 1, 1, size // 4, size // 4)

    # general predictor, on the features of the first video
    images = sam_preprocess_device(torch.from_numpy(videos[0]).to(dev), cfg.compute_dtype)
    feats = encode_video_frames(sam, images)
    box = torch.tensor([[200.0, 250.0, 700.0, 800.0]], device=dev)
    conds = [FrameCondition(1, language_embd=emb[:1, None]), FrameCondition(3, box=box)]
    general = lambda: propagate_video_general(sam, feats, conds, stride=2, direction="both")
    general()  # warm-up
    low_k, launches_g, ms = _count(wrappers, general)
    tracked = sam_frames - 1  # forward 2 .. T-1 from the anchor frame 1, reverse 0
    want = expected_sam_launches(cfg, 0, len(conds), tracked)
    log(f"  propagate_video_general: {ms:.1f} ms for {len(conds)} prompted + {tracked} tracked "
        f"frames; launches {launches_g}")
    if launches_g != want:
        fail(f"launch counts of the general predictor differ from the prediction {want}")
    if tuple(low_k.shape) != low_size or not torch.isfinite(low_k).all() \
            or bool((low_k == NO_OBJ_SCORE).any()):
        fail(f"general predictor: logits {tuple(low_k.shape)}, not finite or a frame unreached")
    rt.model.set_use_kernels(False)
    low_p = general()
    rt.model.set_use_kernels(True)
    cos_g = [cosine(a, b) for a, b in zip(low_k, low_p)]
    log(f"  general predictor, kernel vs plain path on the same features: mask logits cosine "
        f"per frame {[round(c, 5) for c in cos_g]} (tolerance >= {SEG_COS})")
    if min(cos_g) < SEG_COS:
        fail("the general predictor's kernel path and plain path disagree")

    # batched videos through the entry point
    batched = lambda: rt.segment_videos_batched(videos, emb, *label_size)
    batched()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    masks, launches_b, ms = _count(wrappers, batched)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = expected_sam_launches(cfg, 2 * sam_frames, 1, sam_frames - 1)
    log(f"  segment_videos_batched: {ms:.1f} ms for 2 videos x {sam_frames} frames, peak "
        f"{peak:.2f} GiB; launches {launches_b}")
    if launches_b != want:
        fail(f"launch counts of segment_videos_batched differ from the prediction {want}")
    if masks.shape != (2, sam_frames) + tuple(label_size) or masks.dtype != np.bool_:
        fail(f"segment_videos_batched: masks {masks.shape} {masks.dtype}")

    def staged(use_kernels):
        rt.model.set_use_kernels(use_kernels)
        flat = torch.from_numpy(videos.reshape((-1,) + videos.shape[2:])).to(dev)
        f = encode_video_frames(sam, sam_preprocess_device(flat, cfg.compute_dtype))
        per_video = lambda a: a.reshape((2, sam_frames) + tuple(a.shape[1:]))
        vf = FrameFeatures(per_video(f.s0), per_video(f.s1), per_video(f.s2), f.pos2)
        low = propagate_videos_batched(sam, vf, emb[:, None])
        rt.model.set_use_kernels(True)
        return vf, low

    vfeats, low_b = staged(True)
    if not np.array_equal(masks_to_video_res(low_b, *label_size).permute(1, 0, 2, 3).cpu().numpy(),
                          masks):
        fail("the staged batched run's masks differ from those the entry point returned")
    _, low_bp = staged(False)
    alone = torch.cat([
        propagate_video(sam, FrameFeatures(vfeats.s0[i], vfeats.s1[i], vfeats.s2[i],
                                           vfeats.pos2), emb[i:i + 1, None])
        for i in range(2)], dim=1)
    cos_b = [cosine(low_b[:, i], low_bp[:, i]) for i in range(2)]
    cos_a = [cosine(low_b[:, i], alone[:, i]) for i in range(2)]
    ious = [iou(a, b) for a, b in zip(masks_to_video_res(low_b, *label_size).permute(1, 0, 2, 3),
                                     masks_to_video_res(low_bp, *label_size).permute(1, 0, 2, 3))]
    low_limit = SEG_QUANT_COS if cfg.quant_vision else SEG_COS
    log(f"  batched, kernel vs plain path: mask logits cosine per video "
        f"{[round(c, 5) for c in cos_b]} (tolerance >= {low_limit}), mask IoU per video "
        f"{[round(x, 4) for x in ious]} (reported); batched vs each video alone: cosine "
        f"{[round(c, 5) for c in cos_a]} (tolerance >= {PATH_COS})")
    if min(cos_b) < low_limit or min(cos_a) < PATH_COS:
        fail("segment_videos_batched disagrees with the plain path or with per-video calls")
    return launches_g, launches_b


def run_quant_seg(dev, seed: int, full, smi: str):
    """Phase 6: the serving configuration (int8 LM, int8 KV cache, W8A8
    SigLIP and W8A8 Hiera trunk) on a runtime of its own; phase 6b serves
    requests over HTTP on it before it is freed."""
    from ufvideo_tpu_torch import model_init

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = full.replace(quant_llm="int8", quant_kv=True, quant_vision=True)
    rt, _, tok = model_init(cfg=cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    log(f"  model_init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (peak while building "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    if not rt.model.sam.quant:
        fail("the quant_vision runtime built a float SAM2")
    seg, ref = run_seg(dev, seed, rt, tok, feat_cos=SEG_QUANT_FEAT_COS, low_cos=SEG_QUANT_COS,
                       vid_cos=QUANT_COS)
    general, batched = run_predictors(dev, seed, rt)
    log(" 6b: serving over HTTP on the same runtime")
    serve, served = run_http_serving(dev, seed, rt, tok, ref, smi)
    log(" 6c: the continuous-batching engine on the same runtime")
    engine = run_engine(dev, rt, tok, served, smi)
    del rt, served
    torch.cuda.empty_cache()
    log(" 6d: the launchers, each in a process of its own")
    run_launchers(smi)
    return seg, general, batched, ref, serve, engine


# Phase 6b: the JAX package's serving configuration (scripts/serve.py
# --max-batch 8) in the port: BatchingScheduler behind serve_http on the
# phase-6 runtime. Six questions of different lengths and a <region> request
# on one video form one path-A batch of 7; phase 4's [SEG] request (path B)
# and a streamed <region> request ride beside it.
SERVE_QUESTIONS = (
    "What happens?",
    "Describe the video.",
    "Who is in the video and what are they doing?",
    "How many people appear?",
    "What colour is the largest object in the scene, and where does it move?",
    "Summarise the video in one sentence, then list every object you can see in it.",
)
SERVE_REGION_QUESTION = "What is <region> doing in this video?"
# The window must hold all nine requests' arrival: each handler parses a
# 39 MB JSON body (base64 .npy of 32 frames) under the GIL, about half a
# second apiece, so nine arrive over ~4-5 s, and a stream dispatched first
# shares the GIL with them; twice that, so that the 7 coalesce.
SERVE_MAX_WAIT_MS = 8000.0


def run_http_serving(dev, seed: int, rt, tok, seg, smi: str,
                     frame_shape=(32, 480, 640, 3), max_new_tokens=32) -> dict:
    """Phase 6b: concurrent HTTP requests to ``serve_http`` over a
    ``BatchingScheduler(max_batch=8)`` on ``rt``: the path-A group of 7
    (tokens against each request's own ``mm_infer`` but at a near tie), the
    ``[SEG]`` request of ``seg`` (its RLE masks against that request's
    ``mm_infer`` masks on at least MASK_AGREE of each frame) and a stream
    (its joined deltas equal the request's ``mm_infer`` text). The stats
    show one batch of 7 and no fallback or error; launches are counted
    around the HTTP requests and held to the prediction. Then, through
    ``submit``, the first question with its frames as a tensor on the card
    against the same frames as numpy: the same tokens. Returns the launch
    counts."""
    import threading
    import urllib.request

    from ufvideo_tpu_torch import mm_infer, rle
    from ufvideo_tpu_torch import serve as serve_mod

    cfg = rt.cfg
    rng = np.random.default_rng(seed + 2)
    frames = rng.integers(0, 256, frame_shape, dtype=np.uint8)
    h, w = frame_shape[1:3]
    mask = np.zeros((1, h, w), np.float32)
    mask[0, h // 4:3 * h // 4, w // 3:2 * w // 3] = 1.0
    region = dict(masks=mask, frame=frames[7:8], ann_indices=[[0]])
    asks = [(q, {}) for q in SERVE_QUESTIONS] + [(SERVE_REGION_QUESTION, region)]

    # each request alone through mm_infer, its logits recorded
    refs = {}
    for q, kw in asks:
        with LogitsRecorder(rt) as rec:
            text, out = mm_infer(frames, q, rt, tok, max_new_tokens=max_new_tokens, **kw)
        refs[q] = (text, out["output"], rec.steps())

    video_b64 = serve_mod.np_to_b64(frames)
    region_body = dict(masks_rle=[rle.encode(mask[0] > 0)],
                       frame_b64=serve_mod.np_to_b64(region["frame"]), ann_indices=[[0]])
    bodies = [dict(instruct=q, video_b64=video_b64, max_new_tokens=max_new_tokens,
                   **(region_body if kw else {})) for q, kw in asks]
    bodies.append(dict(instruct=seg["conv"], choice=3, video_b64=serve_mod.np_to_b64(seg["frames"]),
                       images_sam_b64=serve_mod.np_to_b64(seg["images_sam"]),
                       label_size=list(seg["label_size"])))
    bodies.append(dict(instruct=SERVE_REGION_QUESTION, video_b64=video_b64,
                       max_new_tokens=max_new_tokens, stream=True, chunk=8, **region_body))
    data = [json.dumps(b).encode() for b in bodies]
    n_a = len(asks)

    batches = []  # the instructs of each mm_infer_batch call, in row order
    real_batch = serve_mod.mm_infer_batch

    def recording_batch(samples, *a, **kw):
        batches.append([s["instruct"] for s in samples])
        return real_batch(samples, *a, **kw)

    serve_mod.mm_infer_batch = recording_batch
    scheduler = serve_mod.BatchingScheduler(rt, tok, max_batch=8, max_wait_ms=SERVE_MAX_WAIT_MS)
    server = serve_mod.serve_http(scheduler, host="127.0.0.1", port=0)
    port = server.server_address[1]
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{port}"
    replies, done_at, errors = [None] * len(data), [0.0] * len(data), []

    def send(i):
        try:
            req = urllib.request.Request(url + "/v1/generate", data=data[i],
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                replies[i] = r.read()
            done_at[i] = time.perf_counter()
        except Exception as e:  # noqa: BLE001 — reported below, the phase fails
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wrappers = all_wrappers()
        for wr in wrappers.values():
            wr.launches = 0
        clients = [threading.Thread(target=send, args=(i,)) for i in range(len(data))]
        with LogitsRecorder(rt) as rec:
            t0 = time.perf_counter()
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=900)
            torch.cuda.synchronize()
        launches = {k: wr.launches for k, wr in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if errors or any(c.is_alive() for c in clients):
            fail(f"phase 6b: requests failed or hung: {errors}")
        with urllib.request.urlopen(url + "/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
        wave = list(batches)

        # the first question alone, its frames as numpy and as a tensor on
        # the card, through the Python API (max_batch 1: no window)
        with serve_mod.BatchingScheduler(rt, tok, max_batch=1) as solo:
            q0 = SERVE_QUESTIONS[0]
            t_np = time.perf_counter()
            on_host = solo.submit({"video": frames, "instruct": q0},
                                  max_new_tokens=max_new_tokens).result(timeout=600)
            t_card = time.perf_counter()
            on_card = solo.submit({"video": torch.from_numpy(frames).to(dev), "instruct": q0},
                                  max_new_tokens=max_new_tokens).result(timeout=600)
            t_end = time.perf_counter()
            solo_stats = solo.stats()
    finally:
        serve_mod.mm_infer_batch = real_batch
        server.shutdown()
        server.server_close()
        scheduler.close()

    wall = max(done_at) - t0
    lat = stats.get("latency_s", {})
    log(f"  served {len(data)} HTTP requests ({n_a} path A, 1 [SEG], 1 stream) in "
        f"{wall * 1e3:.1f} ms from the first sent to the last reply: "
        f"{len(data) / wall:.3f} requests/s; latency p50 {lat.get('p50')} s, p95 "
        f"{lat.get('p95')} s (scheduler stats, max_wait {SERVE_MAX_WAIT_MS:.0f} ms); mean batch "
        f"{stats['mean_batch_size']:.2f}; peak {peak:.2f} GiB; {smi}")
    log(f"  stats {stats}; batch sizes {[len(b) for b in wave]}; launches {launches}")
    if (stats["batches"], stats["batched_samples"], stats["streamed"], stats["requests"]) \
            != (2, n_a + 1, 1, len(data)) or stats["fallback_samples"] or stats["errors"]:
        fail("phase 6b: the stats do not show one batch of 7, one [SEG] request and one "
             "stream without fallback or error")
    rows = next((b for b in wave if len(b) == n_a), None)
    if rows is None or sorted(len(b) for b in wave) != [1, n_a] \
            or sorted(rows) != sorted(q for q, _ in asks):
        fail(f"phase 6b: the path-A requests did not ride one batch: {wave}")

    # path A: each reply against its request alone
    batch_steps = [c for c in rec.calls if c.shape[0] == n_a]
    n_gen = []
    for i, (q, _) in enumerate(asks):
        got = json.loads(replies[i])
        text, ids, ref_logits = refs[q]
        r = rows.index(q)
        same, tie = first_near_tie(f"served row {r} vs alone", ids, ref_logits, got["tokens"],
                                   [c[r, -1] for c in batch_steps])
        n_gen.append(len(got["tokens"]))
        log(f"  served row {r} ({q[:32]!r}): tokens equal its own mm_infer's {same}/{len(ids)}"
            + (f", then a near tie at token {tie}" if tie is not None else ""))
        if got["pred_masks_rle"]:
            fail(f"phase 6b: path-A request {i} returned masks")

    # path B: the [SEG] reply's masks against the request's mm_infer masks
    got = json.loads(replies[n_a])
    masks = [np.stack([rle.decode(f) for f in obj]).astype(bool) for obj in got["pred_masks_rle"]]
    if got["text"] is not None or len(masks) != 1 or masks[0].shape != seg["masks"].shape:
        fail(f"phase 6b [SEG]: text {got['text']!r}, masks {[m.shape for m in masks]}")
    agree = [float((a == b).mean()) for a, b in zip(masks[0], seg["masks"])]
    log(f"  served [SEG] masks against its mm_infer's: agreement per frame "
        f"{[round(a, 5) for a in agree]} (tolerance >= {MASK_AGREE})")
    if min(agree) < MASK_AGREE:
        fail("phase 6b: the served [SEG] masks disagree with mm_infer's")

    # the stream: server-sent events ending in done, joined to the text
    events = [json.loads(line[len(b"data: "):]) for line in replies[-1].split(b"\n\n")
              if line.startswith(b"data: ")]
    if not events or events[-1] != {"done": True} or not all("delta" in e for e in events[:-1]):
        fail(f"phase 6b: the stream's events do not end in done: {events[-3:]}")
    streamed = "".join(e["delta"] for e in events[:-1]).strip()
    if streamed != refs[SERVE_REGION_QUESTION][0]:
        fail("phase 6b: the stream's joined deltas differ from mm_infer's text")
    log(f"  stream: {len(events) - 1} deltas joined == mm_infer's text "
        f"({len(streamed)} characters)")

    # the card tensor against numpy
    if on_card[1]["output"] != on_host[1]["output"] or on_card[0] != on_host[0] \
            or solo_stats["errors"] or solo_stats["fallback_samples"]:
        fail("phase 6b: frames as a tensor on the card give other tokens than as numpy")
    log(f"  submit with the frames on the card: {len(on_card[1]['output'])} tokens == the "
        f"numpy request's ({(t_card - t_np) * 1e3:.1f} ms numpy, {(t_end - t_card) * 1e3:.1f} "
        f"ms card tensor)")

    want = expected_referring_launches(cfg, max(n_gen), calls_to_tower=2)
    for extra in (expected_seg_launches(cfg, len(seg["images_sam"])),
                  expected_referring_launches(cfg, len(refs[SERVE_REGION_QUESTION][1]), 2)):
        want = {k: want[k] + extra[k] for k in want}
    log(f"  launches predicted (the batch of {n_a}, the [SEG] request, the stream): {want}")
    if launches != want:
        fail("phase 6b: launch counts of the served requests differ from the prediction")
    return launches, dict(frames=frames, refs=refs)


# Phase 6c: the JAX package's continuous-batching engine (scripts/serve.py
# --engine) in the port, on the phase-6 runtime, with phase 6b's frames and
# questions: 8 slots, chunks of 8, a 512-token cap (a 4608-position int8
# cache), 2 admitters, 32 new tokens. The speculative engine takes 6 slots:
# a verify step's products then have 6 x (SPEC_K + 1) = 30 rows, inside the
# quantised kernels' 32 (at 8 slots, 40 rows would dequantise every weight).
ENGINE_NEW_TOKENS = 32
ENGINE_SPEC_SLOTS = 6
# the most an engine request's logits may differ, at any of its positions,
# from the one-row mm_infer path's fed the same tokens: sound runs read
# 0.056-0.07 at a first difference (8-row against 1-row quantised
# products); a slot reading another request's cache, or a scratch before its
# prefill ended, moves the logits by O(1)
ENGINE_LOGIT_BOUND = 0.2


class EngineLogits:
    """While active, keeps each engine request's logits by token position,
    keyed by its future: for token 0 the one-row call an admitter made for
    the prefill row ``_Prepared.src`` names; then the decode worker's calls,
    through the slot the request holds at that call (a plain step makes the
    next token; a verify step's K + 1 rows make the tokens from the slot's
    generated length on). It also keeps each request's tokens as it
    retires. Recording launches none of the counted kernels."""

    def __init__(self, rt, engine_mod):
        self.llm, self.vocab, self.mod = rt.model.llm, rt.cfg.llm.vocab_size, engine_mod
        self.eng = None

    def attach(self, eng):
        self.eng = eng
        real_retire = eng._retire

        def retire(slot):
            st = eng._slots[slot]
            self.tokens[id(st.req.future)] = st.streamer.ids
            real_retire(slot)

        eng._retire = retire

    def __enter__(self):
        import threading

        from ufvideo_tpu_torch.models.generate import _mask_vocab_logits

        self.pos, self.tokens, last = collections.defaultdict(dict), {}, {}
        real = self.llm.logits
        real_prep = self._real_prep = self.mod._Prepared

        def logits(h):
            out = real(h)
            lg = _mask_vocab_logits(out.float(), self.vocab)
            name = threading.current_thread().name
            if name.startswith("ufvideo-admit"):  # first tokens, one row a call
                rows = last.setdefault(threading.get_ident(), [])
                rows[:] = rows[-31:] + list(lg[:, -1])
            elif name == "ufvideo-engine":
                eng = self.eng
                gen = eng._spec_state.gen_lens.tolist() if eng.spec_k else None
                for r, sl in enumerate(eng._slots):
                    if sl is not None:
                        d = self.pos[id(sl.req.future)]
                        if gen is None:
                            d[len(d)] = lg[r, -1]
                        else:
                            d.update({gen[r] + i: lg[r, i] for i in range(lg.shape[1])})
            return out

        def prepared(req, scratch, src, *rest):
            g = scratch["k"].shape[1]  # the prefill's rows, their first tokens the last g
            self.pos[id(req.future)][0] = last[threading.get_ident()][-g:][src]
            return real_prep(req, scratch, src, *rest)

        self.llm.logits, self.mod._Prepared = logits, prepared
        return self

    def __exit__(self, *exc):
        del self.llm.logits
        self.mod._Prepared = self._real_prep

    def steps(self, fut) -> list:
        """The request's logits by position (position p made token p)."""
        d = self.pos[id(fut)]
        return [d[p] for p in range(len(d))]


def forced_logits(rt, tok, frames, q, toks) -> list:
    """The one-row ``mm_infer`` path fed ``toks`` in place of its own
    choices (teacher forcing): its logits by position, each made in the
    context of the tokens before it, as the engine's were."""
    from ufvideo_tpu_torch import mm_infer
    from ufvideo_tpu_torch.models import generate as generate_mod

    real, nth = generate_mod._sample_token, iter(toks)

    def forced(logits, *_):
        return torch.full((logits.shape[0],), next(nth), dtype=torch.int64,
                          device=logits.device)

    generate_mod._sample_token = forced
    try:
        with LogitsRecorder(rt) as rec:
            _, out = mm_infer(frames, q, rt, tok, max_new_tokens=len(toks))
    finally:
        generate_mod._sample_token = real
    if out["output"] != toks:
        fail("phase 6c: the forced mm_infer did not take the engine's tokens")
    return rec.steps()


def _wait_until(cond, what, timeout=120.0):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            fail(f"phase 6c: {what} did not happen within {timeout:.0f} s")
        time.sleep(0.002)


def expected_engine_launches(cfg, stats) -> dict:
    """Kernel launches of an engine run on the int8 serving runtime, from
    its stats (thread timing decides how many requests an admission takes):
    the W8A8 tower's layers once an admission dispatch; flash for the LLM's
    layers once a prefill (one a length bucket); each request's first token's
    lm_head at one row; a plain step's q8 decode attention a layer and its
    five products a layer and lm_head at the slot count; a verify step's
    five products a layer and lm_head at slots x (K + 1) rows and no decode
    attention (the verify attends with the plain masked attention)."""
    want = dict.fromkeys(all_wrappers(), 0)
    layers = cfg.llm.num_layers
    want["fused_block_w8a8"] = cfg.vision.num_encode_layers * stats["admit_batches"]
    want["flash_attention"] = layers * stats["prefills"]
    steps = stats["chunks"] if "spec" in stats else stats["decode_steps"]
    if "spec" not in stats:
        want["ragged_decode_attention_q8"] = layers * steps
    want["int8_matvec"] = stats["admissions"] + steps * (5 * layers + 1)
    return want


def run_engine(dev, rt, tok, served, smi) -> dict:
    """Phase 6c: ``StreamingEngine`` on the phase-6 runtime with phase 6b's
    frames (32 uint8 480x640) and questions, 32 new tokens each. The plain
    engine (8 slots, chunks of 8, 2 admitters) takes one question alone, a
    second after the first's first chunk, then, once the second is in its
    slot, six at once from six client threads, one streamed; the six arrive
    while the harness holds the engine's admission lock, so the two
    admitters each hold one and the next admission takes the other four
    (the admission chain is what batches them, not the arrival race).
    Then a speculative engine (K = SPEC_K, 6 slots) takes two staggered
    questions. Each request's tokens equal its
    6b ``mm_infer`` tokens but at a near tie (``first_near_tie`` on the
    engine's own logits), and at every position its logits lie within
    ``ENGINE_LOGIT_BOUND`` of the one-row ``mm_infer`` path's fed the same
    tokens (``forced_logits``); the stream's deltas join to its tokens' text;
    ``completed`` / ``admissions`` = requests, ``errors`` and
    ``admit_fallback_requests`` 0, an admission carried several requests,
    fewer chunks than serialized requests need;
    spec drafts > 0; launches counted around each engine (wrapper counts
    from 0 before it is built, read after ``close``) and held to
    ``expected_engine_launches``. Returns {"plain": ..., "spec": ...}."""
    import threading

    from ufvideo_tpu_torch import engine as engine_mod

    cfg = rt.cfg
    frames, refs = served["frames"], served["refs"]
    qs = SERVE_QUESTIONS
    wrappers = all_wrappers()
    sample = lambda q: {"video": frames, "instruct": q}
    n = ENGINE_NEW_TOKENS

    def counted(label, traffic, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for wr in wrappers.values():
            wr.launches = 0
        with EngineLogits(rt, engine_mod) as rec:
            eng = engine_mod.StreamingEngine(rt, tok, chunk=8, max_new_cap=512, admitters=2,
                                             **kw)
            rec.attach(eng)
            t0 = time.perf_counter()
            try:
                asked = traffic(eng)
            finally:
                eng.close(timeout=600)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        launches = {k: wr.launches for k, wr in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        st = eng.stats()
        lat = st.get("latency_s", {})
        log(f"  [{label}] {len(asked)} requests in {wall * 1e3:.1f} ms from the first submit "
            f"to close: {len(asked) / wall:.3f} requests/s; latency p50 {lat.get('p50')} s, "
            f"p95 {lat.get('p95')} s; prep_s {st['prep_s']}, install_s {st['install_s']}, "
            f"step_s {st['step_s']}; cache {eng.cache_positions} positions; peak {peak:.2f} "
            f"GiB; {smi}")
        log(f"  [{label}] stats {st}")
        for i, (q, fut, reply) in enumerate(asked):
            toks = rec.tokens.get(id(fut))
            if toks is None:
                fail(f"phase 6c [{label}]: request {i} never retired")
            text, ref_ids, ref_logits = refs[q]
            same, tie = first_near_tie(f"[{label}] request {i} vs its mm_infer", ref_ids,
                                       ref_logits, toks, rec.steps(fut))
            engine_logits = rec.steps(fut)
            if len(engine_logits) < len(toks):
                fail(f"phase 6c [{label}]: request {i}'s logits were not all recorded")
            diffs = [float((a - b).abs().max()) for a, b in
                     zip(engine_logits, forced_logits(rt, tok, frames, q, toks))]
            worst = max(range(len(diffs)), key=diffs.__getitem__)
            log(f"  [{label}] request {i} vs the one-row path fed its {len(toks)} tokens: "
                f"largest logit difference {diffs[worst]:.4f} at token {worst} (bound "
                f"{ENGINE_LOGIT_BOUND})")
            if diffs[worst] > ENGINE_LOGIT_BOUND:
                fail(f"phase 6c [{label}]: request {i}'s logits at token {worst} differ by "
                     f"{diffs[worst]:.4f} from the one-row path's on the same tokens")
            if isinstance(reply, list):  # the stream's deltas
                joined = "".join(reply).strip()
                if joined != tok.decode(toks, skip_special_tokens=True).strip():
                    fail(f"phase 6c [{label}]: the stream's deltas differ from its tokens' text")
                kind = f"stream, {len(reply)} deltas joined == its text"
            else:
                if reply[1]["output"] != toks or reply[1]["pred_masks"]:
                    fail(f"phase 6c [{label}]: request {i}'s reply differs from its tokens")
                kind = "reply"
            log(f"  [{label}] request {i} ({q[:32]!r}, {kind}): tokens equal its mm_infer's "
                f"{same}/{len(ref_ids)}" + (f", then a near tie at token {tie}"
                                            if tie is not None else ""))
        if (st["completed"], st["admissions"], st["errors"], st["admit_fallback_requests"]) \
                != (len(asked), len(asked), 0, 0):
            fail(f"phase 6c [{label}]: completed / admissions / errors / fallbacks "
                 f"{st['completed']} / {st['admissions']} / {st['errors']} / "
                 f"{st['admit_fallback_requests']} for {len(asked)} requests")
        want = expected_engine_launches(cfg, st)
        log(f"  [{label}] launches {launches}; predicted from the stats {want}")
        if launches != want:
            fail(f"phase 6c [{label}]: launch counts differ from the prediction")
        return launches, st

    def plain_traffic(eng):
        asked = []
        f0 = eng.submit(sample(qs[0]), max_new_tokens=n)
        asked.append([qs[0], f0, None])
        _wait_until(lambda: eng.stats()["chunks"] >= 1, "the first request's first chunk")
        asked.append([qs[1], eng.submit(sample(qs[1]), max_new_tokens=n), None])
        _wait_until(lambda: eng.stats()["admissions"] >= 2, "the second request's admission")
        six = [[q, None, None] for q in qs]
        submitted, errors = threading.Barrier(len(six) + 1), []

        def client(i):
            try:
                if i == 2:
                    six[i][1] = eng.submit_stream(sample(qs[i]), max_new_tokens=n)
                    submitted.wait(120)
                    six[i][2] = list(six[i][1])
                else:
                    six[i][1] = eng.submit(sample(qs[i]), max_new_tokens=n)
                    submitted.wait(120)
                    six[i][2] = six[i][1].result(timeout=600)
            except Exception as e:  # noqa: BLE001 — reported below, the phase fails
                errors.append(f"client {i}: {type(e).__name__}: {e}")

        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(six))]
        with eng._admit_lock:
            for c in clients:
                c.start()
            submitted.wait(120)
            _wait_until(lambda: eng._queue.qsize() <= len(six) - eng.n_admitters,
                        "both admitters taking a request", timeout=10)
        for c in clients:
            c.join(timeout=900)
        if errors or any(c.is_alive() for c in clients):
            fail(f"phase 6c: client requests failed or hung: {errors}")
        for a in asked:
            a[2] = a[1].result(timeout=600)
        return asked + six

    def spec_traffic(eng):
        f0 = eng.submit(sample(qs[0]), max_new_tokens=n)
        _wait_until(lambda: eng.stats()["chunks"] >= 1, "the first request's first step")
        f1 = eng.submit(sample(qs[1]), max_new_tokens=n)
        return [[qs[0], f0, f0.result(timeout=600)], [qs[1], f1, f1.result(timeout=600)]]

    plain, st = counted("engine int8", plain_traffic, max_slots=8)
    serial = 8 * -(-(n - 1) // 8)
    if st["admit_batched_requests"] <= st["admit_batches"]:
        fail("phase 6c: no admission carried more than one request")
    if st["chunks"] >= serial:
        fail(f"phase 6c: {st['chunks']} chunks, no fewer than {serial} serialized requests need")
    log(f"  [engine int8] {st['admit_batched_requests']} requests in {st['admit_batches']} "
        f"admission dispatches; {st['chunks']} chunks against {serial} serialized")
    spec, st = counted(f"engine spec_k={SPEC_K}", spec_traffic, max_slots=ENGINE_SPEC_SLOTS,
                       spec_k=SPEC_K)
    if st["spec"]["drafted"] <= 0:
        fail("phase 6c: the speculative engine drafted nothing")
    log(f"  [engine spec_k={SPEC_K}] drafted {st['spec']['drafted']}, accepted "
        f"{st['spec']['accepted']} in {st['chunks']} verify steps")
    return {"plain": plain, "spec": spec}


# Phase 6d: the launchers through their entry points, each a process of its
# own on the card: the loadtest at the launchers' default serving
# configuration (int8 LLM, bf16 cache, bf16 SigLIP), full width, random
# weights, as a user starts it and again with the engine's two switches
# turned the other way (the admitters move the frames; a fence after each
# admission stage splits prep_s); the HTTP server on the tiny model (its
# float32 widths run the plain versions on the card), one request and one
# stream, then SIGINT.
LOADTEST_ARGS = ("--mode", "engine", "--quant", "int8", "--pixel-dtype", "uint8",
                 "--clients", "8", "--requests", "16", "--max-new", "32")
LOADTEST_SWITCHED = {"UFVIDEO_ENGINE_PRESTAGE": "0", "UFVIDEO_ENGINE_STAGE_SYNC": "1"}


def run_launchers(smi: str) -> None:
    import os
    import signal
    import urllib.request

    from ufvideo_tpu_torch.serve import np_to_b64

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "ufvideo_tpu_torch.loadtest", *LOADTEST_ARGS]
    stages = [f"stage_{s}_s" for s in ("transfer", "encode", "splice", "prefill")]
    for switched in ({}, LOADTEST_SWITCHED):
        env = {k: v for k, v in os.environ.items() if k not in LOADTEST_SWITCHED}
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=root,
                           env=dict(env, **switched))
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"phase 6d: the loadtest {switched} exited {r.returncode}: "
                 f"{r.stderr[-3000:]}")
        line = r.stdout.strip().splitlines()[-1]
        rec = json.loads(line)
        bs = rec["backend_stats"]
        log(f"  loadtest {switched or '(defaults)'} (synthetic: random weights, "
            f"{' '.join(LOADTEST_ARGS)}; {smi}; {wall:.1f} s with the process's start and "
            f"model_init): {line}")
        log(f"  loadtest {switched or '(defaults)'}: {bs['step_s'] / bs['decode_steps'] * 1e3:.1f}"
            f" ms a decode step (step_s / decode_steps, no recorder); prep_s {bs['prep_s']}"
            + "".join(f", {k} {bs[k]}" for k in stages if k in bs))
        if rec["completed"] != 16 or rec["errors"] != 0 or rec["zero_llm"] \
                or rec["name"] != "serve_loadtest" or bs["admit_fallback_requests"] != 0:
            fail(f"phase 6d: the loadtest {switched} did not complete 16 requests without "
                 "error or retry")
        if switched and not all(k in bs for k in stages):
            fail("phase 6d: UFVIDEO_ENGINE_STAGE_SYNC=1 did not split prep_s")

    cmd = [sys.executable, "-m", "ufvideo_tpu_torch.serve", "--tiny", "--engine", "--port", "0"]
    server = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=root)
    try:
        first = server.stdout.readline()
        if not first.startswith("serving on http://127.0.0.1:") or "device=cuda" not in first:
            fail(f"phase 6d: the server did not start on the card: {first!r} "
                 f"{server.stderr.read()[-3000:] if server.poll() is not None else ''}")
        url = "http://127.0.0.1:" + first.split()[2].rsplit(":", 1)[1]
        frames = np.random.default_rng(1).standard_normal((4, 56, 56, 3)).astype(np.float32)
        post = lambda body: urllib.request.urlopen(urllib.request.Request(
            url + "/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}), timeout=300)
        body = dict(instruct="What happens?", video_b64=np_to_b64(frames), max_new_tokens=8)
        with post(body) as resp:
            reply = json.loads(resp.read())
        with post(dict(body, stream=True)) as resp:
            events = [json.loads(e[len("data: "):]) for e in resp.read().decode().split("\n\n")
                      if e.startswith("data: ")]
        with urllib.request.urlopen(url + "/v1/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
        server.send_signal(signal.SIGINT)
        out, err = server.communicate(timeout=120)
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
    streamed = "".join(e.get("delta", "") for e in events[:-1]).strip()
    log(f"  serve --tiny --engine on the card: reply {len(reply['tokens'])} tokens, stream "
        f"{len(events) - 1} deltas; stats {stats}; exit {server.returncode}, "
        f"{out.strip().splitlines()[-1]!r}")
    if not events or events[-1] != {"done": True} or streamed != reply["text"] \
            or (stats["completed"], stats["errors"]) != (2, 0):
        fail("phase 6d: the server's reply and stream disagree, or it counted an error")
    if server.returncode != 0 or not out.strip().endswith("server stopped"):
        fail(f"phase 6d: the server did not stop cleanly: {err[-3000:]}")


# Phase 7: the request of phases 4 and 6 under the vision towers' other
# routings, each runtime built from the same seed as the default one.
# 7a, bf16: the unfused SigLIP layer with a bf16 LayerNorm (packed attention
# kernel), Hiera's runs of up to 4 windowed blocks in one stage call, the
# q-pool blocks split into front, pooling, attention and tail, the
# polynomial GELU. 7b, the int8 serving configuration: the unfused W8A8
# SigLIP layer and the trunk's q-pool and global blocks on the generic W8A8
# block. Neither sets siglip_gelu: only the fused float SigLIP layer reads it,
# as in the JAX package.
ROUTING_7A = dict(siglip_ln_dtype="bf16", qpool_fused=False, hiera_stage_nb=4,
                  hiera_gelu="poly")
ROUTING_7B = dict(siglip_int8_fused=False, sam2_int8_special=False)
# a routing whose math differs from the default one (bf16 LayerNorm, a
# polynomial GELU, W8A8 rows quantised at other points) against the default
# routing on the same weights: the 0.99 that tests/test_hiera_block.py holds
# the JAX package's two W8A8 routings to
ROUTING_COS = 0.99


def run_routed_seg(dev, seed: int, cfg, routing, label: str, ref: dict, limits) -> dict:
    """One phase-7 request: a runtime under ``routing``, the [SEG] request
    counted and held against the plain path at ``limits`` (video tokens,
    FPN level 2, mask logits), then against the default routing's outputs
    ``ref`` on the same weights."""
    from ufvideo_tpu_torch import model_init

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt, _, tok = model_init(cfg=cfg, device=dev, seed=seed, routing=routing)
    torch.cuda.synchronize()
    log(f"  [{label}] {routing}")
    log(f"  [{label}] model_init: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if weights_fingerprint(rt.model) != ref["weights"]:
        fail(f"[{label}] the routed runtime holds other weights than the default one")
    vid_cos, feat_cos, low_cos = limits
    launches, out = run_seg(dev, seed, rt, tok, feat_cos=feat_cos, low_cos=low_cos,
                            vid_cos=vid_cos, routing=routing)
    cos_v = cosine(out["video"], ref["video"])
    cos_f = cosine(out["s2"], ref["s2"])
    cos_low = [cosine(a, b) for a, b in zip(out["low"], ref["low"])]
    log(f"  [{label}] against the default routing on the same weights: video tokens cosine "
        f"{cos_v:.5f}, FPN level-2 {cos_f:.5f}, mask logits per frame "
        f"{[round(c, 5) for c in cos_low]} (tolerance >= {ROUTING_COS}: bf16 LayerNorm, "
        f"polynomial GELU or W8A8 rows quantised at other points)")
    if min(cos_v, cos_f, *cos_low) < ROUTING_COS:
        fail(f"[{label}] the routing disagrees with the default routing")
    del rt, out
    torch.cuda.empty_cache()
    return launches


def run_window_msa(dev, seed: int) -> dict:
    """Phase 7c: the ``MultiScaleAttention`` module's windowed branch (no
    shipped Hiera routing reaches it through a block, as in the JAX package)
    at Hiera-L's four windowed stages on 4 frames, random weights from the
    seed; counted, and held against its plain path (cosine >= PATH_COS)."""
    from ufvideo_tpu_torch.models import init
    from ufvideo_tpu_torch.models.sam2.hiera import MultiScaleAttention

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 4)
    mods, xs = [], []
    for nw, s, heads in WINDOW_SHAPES:
        c = heads * 72
        msa = MultiScaleAttention(c, c, heads, int(round(s ** 0.5)), None,
                                  torch.bfloat16).to(dev).eval()
        init.reset_tree_(msa, gen)
        mods.append(msa)
        xs.append(torch.randn(nw, s, c, generator=gen, device=dev).to(torch.bfloat16))
    run = lambda: [m(x) for m, x in zip(mods, xs)]
    with torch.no_grad():
        run()  # warm-up
        outs, launches, ms = _count(all_wrappers(), run)
        for m in mods:
            m.use_kernels = False
        plain = run()
    cos = [cosine(a, b) for a, b in zip(outs, plain)]
    want = dict.fromkeys(all_wrappers(), 0)
    want["fused_window_attention"] = len(WINDOW_SHAPES)
    log(f"  MultiScaleAttention, windowed branch at {[tuple(x.shape) for x in xs]}: "
        f"{ms:.1f} ms; launches {launches}; kernel vs plain path cosine "
        f"{[round(c, 5) for c in cos]} (tolerance >= {PATH_COS})")
    if launches != want:
        fail(f"launch counts of the windowed MultiScaleAttention differ from {want}")
    if min(cos) < PATH_COS or not all(torch.isfinite(o).all() for o in outs):
        fail("the windowed MultiScaleAttention's kernel path disagrees with its plain path")
    return launches


def run_probe(dev, smi: str, iters: int = 50) -> dict:
    """Phase 7d: the int8-rate probe (python -m ufvideo_tpu_torch.probe_int8_rate),
    counted; its four lines after the card's."""
    from ufvideo_tpu_torch import probe_int8_rate

    recs, launches, _ = _count(all_wrappers(), lambda: probe_int8_rate.run(dev, iters))
    log(f"  {smi}")
    for r in recs:
        log(f"  {json.dumps(r)}")
    rate = {r["variant"]: r["tops"] for r in recs}
    log(f"  int8 : bf16 rate, library {rate['int8_torch'] / rate['bf16_torch']:.3f}, kernels "
        f"{rate['int8_kernel'] / rate['bf16_kernel']:.3f}; launches {launches}")
    want = dict.fromkeys(all_wrappers(), 0)
    want["probe_step"] = 2 * (iters + 3)
    if launches != want or not all(r["ms"] > 0 for r in recs):
        fail(f"the probe's launches {launches} differ from {want}")
    return launches


# ------------------------------------------------------------- phase 8 --
# training at full width: 8a a LoRA [SEG] + <region> finetune of the whole
# model, 8b the reference's policy (full LLM finetune) with the LLM cut to 4
# layers. Limits stated before the first card run:
TRAIN_LR = 1e-4
TRAIN_STEPS = 3
TRAIN_LABEL = (480, 640)  # the ground-truth masks' grid, the loss's
TRAIN_CONV = [
    {"from": "human", "value": "<video>\nWhat is <region> doing? Please segment it."},
    {"from": "gpt", "value": "It is [SEG]."},
]
# kernel route against plain route on one batch and one set of parameters:
# the loss in bf16 through 26 + 28 layers either way (phase 3's paths agree
# to cosine 0.9995) within 1% of itself; the gradients, taken back through
# 28 layers, by cosine: all of them together >= 0.99, each tensor >= 0.95
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_COS, TRAIN_TENSOR_COS = 0.99, 0.95
# a resumed step 3 against the unbroken one: the same bf16 computation on the
# same values, the dropout drawn from (seed, step) alone
TRAIN_RESUME_REL = 1e-3
# the served adapter (PEFT merge: W + s·B·A in f32, one rounding) against
# merge_for_eval (the delta rounded to bf16, then the sum): first logits
ADAPTER_LOGIT_COS = 0.999


def expected_train_launches(cfg, n_sam_frames: int, steps: int) -> dict:
    """Kernel launches of ``steps`` [SEG] + <region> train steps: the frozen
    tower's layers on the video and on the annotated frame, the frozen Hiera
    trunk once on the SAM frames, the mask decoder's seven attentions once
    on the flat (object × frame) batch, and flash for each LLM layer in the
    forward and again in its recompute (``cfg.llm.remat``). The backward
    launches nothing: it recomputes the plain versions."""
    want = expected_sam_launches(cfg, n_sam_frames, 1, 0)
    want["fused_hiera_block"] += 2 * cfg.vision.num_encode_layers
    want["flash_attention"] += (2 if cfg.llm.remat else 1) * cfg.llm.num_layers
    return {k: steps * n for k, n in want.items()}


def train_request(dev, seed: int, cfg, tok, frame_shape=(32, 480, 640, 3), sam_frames=4,
                  label=TRAIN_LABEL):
    """One training sample built in memory (the card's machine decodes no
    files): uint8 frames preprocessed on the card for SigLIP and SAM2, one
    annotated frame with a box mask as the <region>, the same box as the
    [SEG] object's ground truth on the SAM frames."""
    from ufvideo_tpu_torch.ops.image_pipeline import sam_preprocess_device, \
        siglip_preprocess_device
    from ufvideo_tpu_torch.train.data import TrainSample, normalize_modal_token, \
        preprocess_conversation

    frames = np.random.default_rng(seed + 8).integers(0, 256, frame_shape, dtype=np.uint8)
    on_card = torch.from_numpy(frames).to(dev)
    pixels = siglip_preprocess_device(on_card, torch.float32)
    sam = sam_preprocess_device(on_card[:sam_frames], torch.float32)
    mask = np.zeros(label, np.float32)
    mask[label[0] // 4:label[0] // 2, label[1] // 3:2 * label[1] // 3] = 1.0
    ids, labels = preprocess_conversation(
        normalize_modal_token(TRAIN_CONV, "<video>"), tok, "<video>")
    sample = TrainSample(
        ids, labels, pixels.cpu().numpy(), region_frames=pixels[:1].cpu().numpy(),
        region_masks=mask[None], ann_indices=[[0]], images_sam=sam.cpu().numpy(),
        gt_masks=np.stack([np.stack([mask] * sam_frames)]))
    return frames, pixels, sample


def _batches(sample, collator, dev, n: int):
    """``n`` copies of the sample through PrefetchLoader and device_prefetch
    (pinned host memory, non-blocking copies)."""
    from ufvideo_tpu_torch.train.prefetch import PrefetchLoader, device_prefetch, to_device

    loader = PrefetchLoader([0] * n, lambda i: sample, collator, batch_size=1, num_workers=1)
    return device_prefetch(loader, lambda b: to_device(b, dev))


def _log_records(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _step_ms(recs) -> float:
    """Step 2's wall time from the log's cumulative seconds (step 1 warms
    cuBLAS and the kernel libraries; step 3's time holds the checkpoint
    written after step 2)."""
    return (recs[1]["time"] - recs[0]["time"]) * 1e3


def _free_space(tmp, need, what):
    import shutil

    free = shutil.disk_usage(tmp).free
    log(f"  {tmp}: {free / 1e9:.2f} GB free; {what}: {need / 1e9:.2f} GB")
    if free < need + 2**30:
        fail(f"phase 8 needs {need + 2**30} bytes free under {tmp} for {what}; {free} are free")


def _plain_flash_counter():
    """Count the plain attention's calls (the backward's recomputes) by
    wrapping the name the flash wrapper looks up at each call."""
    from ufvideo_tpu_torch.ops import flash_attention as fa

    orig = fa.flash_attention_plain

    def counted(*a, **k):
        counted.calls += 1
        return orig(*a, **k)

    counted.calls = 0
    fa.flash_attention_plain = counted
    return counted, lambda: setattr(fa, "flash_attention_plain", orig)


def _union_ms(intervals) -> float:
    """Length of the union of [start, end) intervals (profiler µs), in ms."""
    total, start, end = 0.0, None, None
    for s_, e_ in sorted(intervals):
        if end is not None and s_ <= end:
            end = max(end, e_)
            continue
        if end is not None:
            total += end - start
        start, end = s_, e_
    if end is not None:
        total += end - start
    return total / 1e3


def train_step_breakdown(state, optimizer, loss_of) -> dict:
    """One more train step under ``torch.profiler``, outside every counted
    run, fenced after the forward, the backward and the update: the device
    ms of each (the union of the kernels that start inside it), of each
    kernel family (the port's kernels, libraries, PyTorch's own) and of the
    backward's plain recomputes (the union of the device spans of the
    ``plain recompute`` annotations of ``ops/autograd.py``, and their
    number); the step's wall, device-busy time and idle share. Unions, not
    sums: a kernel the profiler lists twice counts once."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ufvideo_tpu_torch.train.train_step import grads_of

    for p in state.params.values():
        p.grad = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("train:forward"):
            loss, _ = loss_of()
            torch.cuda.synchronize()
        with record_function("train:backward"):
            loss.backward()
            torch.cuda.synchronize()
        with record_function("train:update"):
            optimizer.update(state.params, grads_of(state.params), state.opt_state)
            torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for p in state.params.values():
        p.grad = None
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in events
              if e.device_type == cpu and e.name.startswith("train:")}
    # annotations may also stand on the device's timeline, as spans over
    # their kernels: they are read apart, not as kernels
    marks = set(ranges) | {"plain recompute"}
    recompute = [(e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == cuda and e.name == "plain recompute"]
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == cuda and e.name not in marks]
    family = lambda name: ("port kernels" if "ufv::" in name or (
        "(anonymous namespace)::" in name and "at::native" not in name)
        else "pytorch elementwise / reduce / copy" if "at::native" in name else "library")
    fams = {family(n) for _, _, n in kernels}
    busy = _union_ms((s_, e_) for s_, e_, _ in kernels)
    return {"wall_ms": round(wall, 1), "device_busy_ms": round(busy, 1),
            "idle_share": round(1 - busy / wall, 3), "kernels": len(kernels),
            "device_ms": {n: round(_union_ms((s_, e_) for s_, e_, _ in kernels
                                             if lo <= s_ < hi), 1)
                          for n, (lo, hi) in ranges.items()},
            "family_ms": {f: round(_union_ms((s_, e_) for s_, e_, n in kernels
                                             if family(n) == f), 1) for f in sorted(fams)},
            "plain_recompute_ms": round(_union_ms(recompute), 1),
            "plain_recompute_spans": len(recompute)}


def run_train_lora(dev, seed: int, cfg, frame_shape=(32, 480, 640, 3), sam_frames=4,
                   label=TRAIN_LABEL) -> dict:
    """Phase 8a: a LoRA (r 8, alpha 16, dropout 0.05) [SEG] + <region>
    finetune at full width and depth with gradient checkpointing: three
    Trainer steps; every trainable gradient checked at each backward;
    launches and the backward's plain recomputes against the prediction;
    the loss falling; kernel route against plain route; a resume from step
    2; the saved adapter served through model_init(model_path=,
    adapter_path=) against merge_for_eval."""
    import dataclasses
    import shutil
    import tempfile

    from ufvideo_tpu_torch import mm_infer, model_init
    from ufvideo_tpu_torch.api import _assemble_input_ids
    from ufvideo_tpu_torch.export import save_hf_checkpoint
    from ufvideo_tpu_torch.models.qwen2 import LoRATerm, fold_in
    from ufvideo_tpu_torch.train.data import Collator
    from ufvideo_tpu_torch.train.lora import LoRAConfig, merge_for_eval
    from ufvideo_tpu_torch.train.seg_step import segmentation_loss_fn
    from ufvideo_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    wrappers = all_wrappers()
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, remat=True))
    rt, _, tok = model_init(cfg=cfg, device=dev, seed=seed)
    cfg = rt.cfg
    frames, pixels, sample = train_request(dev, seed, cfg, tok, frame_shape, sam_frames, label)
    collator = Collator(cfg, rt.ids.region, rt.ids.seg)
    lcfg = LoRAConfig(r=8, alpha=16.0, dropout=0.05)
    tmp = tempfile.mkdtemp(prefix="ufvideo_train_")
    try:
        base_dir, out_dir = os.path.join(tmp, "base"), os.path.join(tmp, "run")
        need = sum(p.numel() * p.element_size() for p in rt.model.parameters())
        _free_space(tmp, need, "the base checkpoint")
        t0 = time.perf_counter()
        save_hf_checkpoint(base_dir, rt.model)
        log(f"  the base written (save_hf_checkpoint) in {time.perf_counter() - t0:.1f} s")

        tc = TrainConfig(output_dir=out_dir, learning_rate=TRAIN_LR, total_steps=10,
                         global_batch_size=1, save_steps=2, save_total_limit=2, lora=lcfg,
                         seed=seed)
        trainer = Trainer(rt.model, cfg, tc, loss_fn=segmentation_loss_fn)
        state = trainer.init_state()
        n_train = sum(p.numel() for p in state.params.values())
        layers = cfg.llm.num_layers
        seen = []

        def check_grads(grads):
            flat = torch.stack([torch.isfinite(g).all() for g in grads.values()])
            per_layer = lambda n: int((grads[n].flatten(1).abs().amax(1) > 0).sum())
            mods = {m: max(float(g.abs().max()) for n, g in grads.items()
                           if n.startswith(f"non_lora.{m}."))
                    for m in ("projector", "region", "text_fcs")}
            seen.append(dict(finite=bool(flat.all()),
                             **{n: per_layer(f"lora.{n[0]}.{n[1]}") for n in
                                ("qa", "qb", "va", "vb")}, **mods))

        trainer.grad_hook = check_grads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter, restore = _plain_flash_counter()
        try:
            state, launches, ms = _count(wrappers, lambda: trainer.train(
                state, _batches(sample, collator, dev, TRAIN_STEPS), max_steps=TRAIN_STEPS))
        finally:
            restore()
        peak = torch.cuda.max_memory_allocated() / 2**30
        recs = _log_records(os.path.join(out_dir, "train_log.jsonl"))
        n_tok = int(collator([sample])["seq_lens"][0])
        step_ms = _step_ms(recs)
        log(f"  LoRA on q / v (r 8, alpha 16, dropout 0.05), {n_train / 1e6:.2f} M trainable "
            f"(adapters + projector + region encoder + text head); {TRAIN_STEPS} steps of "
            f"{n_tok} tokens in {ms:.1f} ms, step 2 {step_ms:.1f} ms, "
            f"{n_tok / step_ms * 1e3:.1f} trained tokens/s, peak {peak:.2f} GiB")
        log(f"  losses {[round(r['loss'], 5) for r in recs]}, grad norms "
            f"{[round(r['grad_norm'], 5) for r in recs]}")
        log(f"  gradients at each backward: {seen}")
        want = expected_train_launches(cfg, sam_frames, TRAIN_STEPS)
        plain_want = TRAIN_STEPS * (layers + 7)
        log(f"  launches {nonzero(launches)} (predicted {nonzero(want)}); plain attention "
            f"calls {counter.calls}, all in the backward (predicted {plain_want}: each LLM "
            f"layer's and the mask decoder's seven recomputed once a step)")
        if launches != want or counter.calls != plain_want:
            fail("phase 8a: launch counts differ from the prediction")
        for i, s in enumerate(seen):
            if not s["finite"]:
                fail(f"phase 8a: a non-finite gradient at step {i + 1}")
            if s["qb"] != layers or s["vb"] != layers:
                fail(f"phase 8a: the LoRA B factors got no gradient in some layer at step "
                     f"{i + 1}: q {s['qb']}, v {s['vb']} of {layers}")
            if min(s["projector"], s["region"], s["text_fcs"]) <= 0:
                fail(f"phase 8a: a non-LoRA trainable got no gradient at step {i + 1}")
        if seen[-1]["qa"] != layers or seen[-1]["va"] != layers:
            fail("phase 8a: the LoRA A factors got no gradient at step 3 (B is non-zero)")
        if not all(np.isfinite(v) for r in recs for v in r.values()):
            fail("phase 8a: non-finite metrics in the log")
        if not recs[-1]["loss"] < recs[0]["loss"]:
            fail(f"phase 8a: the loss did not fall from step 1 to step {TRAIN_STEPS}")

        # where a step's time goes: one more step, profiled (the state moves on
        # to step 4; the resume below restores checkpoint-2)
        batch = next(iter(_batches(sample, collator, dev, 1)))
        term = LoRATerm(state.lora, lcfg.scale, lcfg.dropout, seed=fold_in(seed, state.step))
        prof = train_step_breakdown(
            state, trainer.optimizer, lambda: segmentation_loss_fn(rt.model, batch, lora=term))
        log(f"  a profiled step: {prof}")
        del batch, term

        # a fresh Trainer from checkpoint-2 takes step 3 again
        trainer2 = Trainer(rt.model, cfg, tc, loss_fn=segmentation_loss_fn)
        state2 = trainer2.maybe_resume(trainer2.init_state())
        if state2.step != 2:
            fail(f"phase 8a: resumed at step {state2.step}, not 2")
        del state

        # kernel route against plain route at the resumed parameters
        batch = next(iter(_batches(sample, collator, dev, 1)))
        names = list(state2.params)

        def loss_and_grads(use_kernels):
            rt.model.set_use_kernels(use_kernels)
            term = LoRATerm(state2.lora, lcfg.scale, lcfg.dropout,
                            seed=fold_in(seed, state2.step))
            loss, _ = segmentation_loss_fn(rt.model, batch, lora=term)
            grads = torch.autograd.grad(loss, [state2.params[n] for n in names])
            rt.model.set_use_kernels(True)
            return float(loss.detach()), grads

        (lk, gk), (lp, gp) = loss_and_grads(True), loss_and_grads(False)
        flat = lambda gs: torch.cat([g.float().flatten() for g in gs])
        cos_all = cosine(flat(gk), flat(gp))
        cos_each = {n: cosine(a, b) for n, a, b in zip(names, gk, gp) if float(b.norm()) > 0}
        worst = min(cos_each, key=cos_each.get)
        log(f"  kernel vs plain route: loss {lk:.5f} / {lp:.5f}; gradient cosine "
            f"{cos_all:.5f} over all {len(names)} trainables, lowest {cos_each[worst]:.5f} "
            f"({worst}) of {len(cos_each)} with a gradient; tolerance loss within "
            f"{TRAIN_LOSS_REL} of itself, cosine >= {TRAIN_GRAD_COS} together and >= "
            f"{TRAIN_TENSOR_COS} each")
        if abs(lk - lp) > TRAIN_LOSS_REL * abs(lp):
            fail("phase 8a: the kernel route's loss differs from the plain route's")
        if cos_all < TRAIN_GRAD_COS or cos_each[worst] < TRAIN_TENSOR_COS:
            fail("phase 8a: the kernel route's gradients differ from the plain route's")
        del gk, gp, batch

        state2 = trainer2.train(state2, _batches(sample, collator, dev, 1),
                                max_steps=TRAIN_STEPS)
        resumed = float(trainer2.last_metrics["loss"])
        log(f"  resumed from checkpoint-2: step 3 loss {resumed:.6f} against the unbroken "
            f"run's {recs[-1]['loss']:.6f} (tolerance {TRAIN_RESUME_REL} of itself)")
        if abs(resumed - recs[-1]["loss"]) > TRAIN_RESUME_REL * abs(recs[-1]["loss"]):
            fail("phase 8a: the resumed step differs from the unbroken run's")

        # the adapter written at step 3, served
        trainer2.save(state2)
        ckpt = os.path.join(out_dir, f"checkpoint-{TRAIN_STEPS}")
        kept = sorted(d for d in os.listdir(out_dir) if d.startswith("checkpoint-"))
        files = sorted(os.listdir(ckpt))
        log(f"  checkpoints {kept}; {ckpt}: {files}")
        for f in ("adapter_config.json", "adapter_model.bin", "non_lora_trainables.bin"):
            if f not in files:
                fail(f"phase 8a: {f} missing from the adapter checkpoint")
        t0 = time.perf_counter()
        rt2, _, tok2 = model_init(base_dir, cfg=cfg, device=dev, adapter_path=ckpt)
        log(f"  model_init(model_path=base, adapter_path=checkpoint-3) in "
            f"{time.perf_counter() - t0:.1f} s")
        merge_for_eval(rt.model, state2, lcfg)
        question = "What is happening in this video?"
        ids = _assemble_input_ids(question, 1, "<video>", tok)
        with torch.no_grad():
            bf16_pixels = pixels.to(cfg.compute_dtype)
            ref = staged_path(rt, ids, bf16_pixels, 1, True)
            got = staged_path(rt2, ids, bf16_pixels, 1, True)
        cos_lg = cosine(got[2], ref[2])
        text, out = mm_infer(frames, question, rt2, tok2, max_new_tokens=8)
        log(f"  the served adapter's first logits against merge_for_eval's: cosine "
            f"{cos_lg:.6f} (tolerance >= {ADAPTER_LOGIT_COS}), greedy {got[3]} / {ref[3]}; "
            f"mm_infer: {len(out['output'])} tokens {text[:60]!r}")
        if cos_lg < ADAPTER_LOGIT_COS or not torch.isfinite(got[2]).all():
            fail("phase 8a: the served adapter disagrees with merge_for_eval")
        if not out["output"]:
            fail("phase 8a: the served adapter generated nothing")
        del rt2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del rt, trainer, trainer2, state2
    torch.cuda.empty_cache()
    log(f"  phase 8a: {time.perf_counter() - t_phase:.1f} s")
    return launches


def run_train_full(dev, seed: int, cfg, frame_shape=(32, 480, 640, 3), sam_frames=4,
                   label=TRAIN_LABEL) -> dict:
    """Phase 8b: the Trainer's default policy (full LLM finetune; SigLIP and
    SAM2 frozen but the mask decoder) at full width with the LLM cut to 4 of
    its 28 layers (weights, gradients and two moments of all 28 need ~61 GB
    before activations): three steps, checkpoints at steps 2 and 3 with a
    keep-1 rotation, a resume; the frozen towers bit for bit, the LLM and
    the mask decoder moved, the log finite."""
    import dataclasses
    import shutil
    import tempfile

    from ufvideo_tpu_torch import model_init
    from ufvideo_tpu_torch.train.data import Collator
    from ufvideo_tpu_torch.train.seg_step import segmentation_loss_fn
    from ufvideo_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    wrappers = all_wrappers()
    cut, depth = 4, cfg.llm.num_layers
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, num_layers=cut, remat=True))
    rt, _, tok = model_init(cfg=cfg, device=dev, seed=seed)
    cfg = rt.cfg
    _, _, sample = train_request(dev, seed, cfg, tok, frame_shape, sam_frames, label)
    collator = Collator(cfg, rt.ids.region, rt.ids.seg)
    model = rt.model
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(("vision.", "sam.image_encoder"))}
    movers = ("llm.layers.0.qkv_proj.weight", "llm.lm_head.weight",
              "sam.sam_mask_decoder.output_upscaling_0.weight")
    before = {n: dict(model.named_parameters())[n].detach().clone() for n in movers}
    tmp = tempfile.mkdtemp(prefix="ufvideo_train_full_")
    try:
        tc = TrainConfig(output_dir=tmp, learning_rate=TRAIN_LR, total_steps=10,
                         global_batch_size=1, save_steps=2, save_total_limit=1, seed=seed)
        trainer = Trainer(model, cfg, tc, loss_fn=segmentation_loss_fn)
        state = trainer.init_state()
        n_train = sum(p.numel() for p in state.params.values())
        state_bytes = 3 * sum(p.numel() * p.element_size() for p in state.params.values())
        _free_space(tmp, 2 * state_bytes, "two checkpoints")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, launches, ms = _count(wrappers, lambda: trainer.train(
            state, _batches(sample, collator, dev, TRAIN_STEPS), max_steps=TRAIN_STEPS))
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        trainer.save(state)
        log(f"  checkpoint-{TRAIN_STEPS} ({state_bytes / 1e9:.2f} GB of parameters and "
            f"moments) written in {time.perf_counter() - t0:.1f} s")
        recs = _log_records(os.path.join(tmp, "train_log.jsonl"))
        n_tok = int(collator([sample])["seq_lens"][0])
        step_ms = _step_ms(recs)
        log(f"  default policy, LLM cut to {cut} of {depth} layers (full width): "
            f"{n_train / 1e9:.3f} B trainable; {TRAIN_STEPS} steps in {ms:.1f} ms (the "
            f"step-2 checkpoint included), step 2 {step_ms:.1f} ms, "
            f"{n_tok / step_ms * 1e3:.1f} trained tokens/s, peak {peak:.2f} GiB; losses "
            f"{[round(r['loss'], 5) for r in recs]}")
        want = expected_train_launches(cfg, sam_frames, TRAIN_STEPS)
        log(f"  launches {nonzero(launches)} (predicted {nonzero(want)})")
        if launches != want:
            fail("phase 8b: launch counts differ from the prediction")
        if not all(np.isfinite(v) for r in recs for v in r.values()):
            fail("phase 8b: non-finite metrics in the log")
        params = dict(model.named_parameters())
        moved = [n for n in frozen if not torch.equal(params[n], frozen[n])]
        if moved:
            fail(f"phase 8b: frozen parameters moved: {moved[:5]}")
        still = [n for n in movers if torch.equal(params[n], before[n])]
        if still:
            fail(f"phase 8b: trained parameters did not move: {still}")
        kept = sorted(d for d in os.listdir(tmp) if d.startswith("checkpoint-"))
        log(f"  {len(frozen)} SigLIP / Hiera tensors bit for bit, {movers} moved; "
            f"checkpoints {kept}")
        if kept != [f"checkpoint-{TRAIN_STEPS}"]:
            fail(f"phase 8b: keep-1 rotation left {kept}")
        del state
        torch.cuda.empty_cache()
        trainer2 = Trainer(model, cfg, tc, loss_fn=segmentation_loss_fn)
        t0 = time.perf_counter()
        state2 = trainer2.maybe_resume(trainer2.init_state())
        log(f"  maybe_resume: step {state2.step} in {time.perf_counter() - t0:.1f} s")
        if state2.step != TRAIN_STEPS:
            fail(f"phase 8b: resumed at step {state2.step}")
        batch = next(iter(_batches(sample, collator, dev, 1)))
        prof = train_step_breakdown(state2, trainer2.optimizer,
                                    lambda: segmentation_loss_fn(model, batch))
        log(f"  a profiled step after the resume: {prof}")
        del state2, trainer2, batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del rt, model, trainer, frozen
    torch.cuda.empty_cache()
    log(f"  phase 8b: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------ phase 9: eval --

# Phase 9: the eval harness (ufvideo_tpu_torch.eval.run.run_benchmark) on
# synthetic benchmark files: two directories of 32 PNG frames of 480x640
# written by the port's codec, 32 new tokens, --num-sam-frames 4. As in the
# JAX run_benchmark that flag reaches only samples without annotations: pixrqa's
# SAM frame is its one annotated frame, and mevis segments every frame.
# Each run is (benchmark, --batch).
EVAL_NEW_TOKENS = 32
EVAL_SAM_FRAMES = 4
EVAL_RUNS_BF16 = (("mvbench", 1), ("tvg", 1), ("pixrqa", 1), ("mvbench", 2), ("pixrqa", 2),
                  ("mevis", 2))
EVAL_RUNS_INT8 = (("mvbench", 1), ("mvbench", 2))
EVAL_QUESTIONS = ("What is the person doing?", "Which color covers most of the frame?")


def write_eval_data(root: str, seed: int, frame_shape) -> dict:
    """Two frame directories (random uint8 frames as PNGs, filter 0) and the
    question files of mvbench, tvg, pixrqa (one RLE region on frame 5) and
    mevis (a [SEG] conversation), mevis's RLE ground truth on every frame and
    tvg's durations, under ``root``. Returns their paths."""
    from ufvideo_tpu_torch import rle
    from ufvideo_tpu_torch.eval.png import write_png

    rng = np.random.default_rng(seed + 9)
    vids = os.path.join(root, "videos")
    t, h, w, _ = frame_shape
    for v in range(2):
        d = os.path.join(vids, f"vid{v}")
        os.makedirs(d)
        for f in range(t):
            write_png(os.path.join(d, f"{f:03d}.png"),
                      rng.integers(0, 256, frame_shape[1:], dtype=np.uint8), level=1)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4:3 * h // 4, w // 3:2 * w // 3] = 1
    seg = rle.encode(mask)
    files = {
        "mvbench": [{"id": f"q{v}", "task_type": "action",
                     "data": {"video": f"vid{v}", "question": EVAL_QUESTIONS[v],
                              "candidates": ["running", "sitting", "red", "blue"],
                              "answer": "sitting"}} for v in range(2)],
        "tvg": [{"id": f"t{v}", "video": f"vid{v}", "query": "A person opens the door.",
                 "timestamps": [0.2, 0.6]} for v in range(2)],
        "pixrqa": [{"id": f"s{v}", "video": f"vid{v}", "annotation": [{"5": {"segmentation": seg}}],
                    "caption": f"object in video {v}"} for v in range(2)],
        "mevis": [{"id": f"m{v}", "video": f"vid{v}", "conversations": [
            {"from": "human", "value": "<video>\nPlease segment the moving object."},
            {"from": "gpt", "value": "Sure, it is [SEG]."}]} for v in range(2)],
        "mevis_gt": [{"id": f"m{v}", "annotation": [seg] * t} for v in range(2)],
        "durations": {f"vid{v}": 10.0 for v in range(2)},
    }
    paths = {"videos": vids}
    for name, obj in files.items():
        paths[name] = os.path.join(root, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    return paths


class BenchmarkCalls:
    """While active, ``mm_infer`` / ``mm_infer_batch`` (the names
    ``eval.run`` calls) are wrapped: each call's arguments, result, launches
    (counted from 0 around the call), device-synchronised ms and logits
    (LogitsRecorder), in call order."""

    def __init__(self, rt):
        from ufvideo_tpu_torch.eval import run as eval_run

        self.rt, self.mod, self.calls = rt, eval_run, []

    def _wrap(self, kind, real):
        def call(*args, **kw):
            with LogitsRecorder(self.rt) as rec:
                out, launches, ms = _count(all_wrappers(), lambda: real(*args, **kw))
            self.calls.append(dict(kind=kind, args=args, kw=kw, out=out, launches=launches,
                                   ms=ms, logits=rec))
            return out
        return call

    def __enter__(self):
        self.real = (self.mod.mm_infer, self.mod.mm_infer_batch)
        self.mod.mm_infer = self._wrap("single", self.real[0])
        self.mod.mm_infer_batch = self._wrap("batch", self.real[1])
        return self

    def __exit__(self, *exc):
        self.mod.mm_infer, self.mod.mm_infer_batch = self.real

    def rows(self):
        """Per sample in run_benchmark's order: (tokens or None, logits by step,
        masks list, the call's index)."""
        out = []
        for i, c in enumerate(self.calls):
            if c["kind"] == "single":
                res = c["out"]
                text, extra = res if isinstance(res, tuple) else (None, res)
                out.append((extra["output"], c["logits"].steps(0), extra["pred_masks"], i))
            else:
                for r, (text, extra) in enumerate(c["out"]):
                    out.append((extra["output"], c["logits"].steps(r), extra["pred_masks"], i))
        return out


def predicted_call_launches(cfg, call) -> dict:
    """Kernel launches of one run_benchmark call, from its arguments and outputs:
    path A (generation): the tower once for the video(s) and once for each
    sample's annotated frames, flash for the LLM's layers, a decode
    attention a layer and step (steps: the longest row's tokens - 1), SAM2
    for each generated [SEG] (one object a sample, frame 0 prompted); path B
    ([SEG] in the input): the tower once, flash once a layer, SAM2 on each
    sample's frames (a batch of one-object samples in one propagation)."""
    from ufvideo_tpu_torch.api import _frames

    if call["kind"] == "single":
        samples = [dict(video=call["args"][0], instruct=call["args"][1], **call["kw"])]
        results = [call["out"] if isinstance(call["out"], tuple) else (None, call["out"])]
    else:
        samples, results = call["args"][0], call["out"]
    path_b = [r[1]["output"] is None for r in results]
    if any(path_b) and not all(path_b):
        fail("phase 9 predicts launches of calls on one path only")
    n_regions = sum(s.get("frame") is not None and s.get("masks") is not None for s in samples)
    segs = [i for i, (s, (_, extra)) in enumerate(zip(samples, results))
            if s.get("images_sam") is not None and (
                path_b[i] or cfg.seg_token_id in extra["output"])]
    if all(path_b):  # one forward: the tower once, flash once a layer
        want = dict.fromkeys(all_wrappers(), 0)
        want["fused_block_w8a8" if cfg.quant_vision else "fused_hiera_block"] = \
            cfg.vision.num_encode_layers
        want["flash_attention"] = cfg.llm.num_layers
    else:
        want = expected_referring_launches(cfg, max(len(r[1]["output"]) for r in results),
                                           calls_to_tower=1 + n_regions)
    if segs:
        t = len(_frames(samples[segs[0]]["images_sam"]))
        sam = expected_sam_launches(cfg, t * len(segs), 1, t - 1)
        want = {k: want[k] + sam[k] for k in want}
    return want


def eval_dataset(bench, paths, rt, sam_frames, num_frames):
    """The dataset ``run_benchmark`` builds for ``bench`` on these files."""
    from ufvideo_tpu_torch.eval.datasets import MCQABenchmark, SegReferBenchmark, TVGBenchmark

    with open(paths[bench]) as f:
        questions = json.load(f)
    kw = dict(image_size=rt.cfg.vision.image_size, **(
        {"num_frames": num_frames} if num_frames else {}))
    sam_size = rt.cfg.sam.hiera.image_size
    if bench == "mvbench":
        return MCQABenchmark(paths["videos"], questions, **kw)
    if bench == "tvg":
        return TVGBenchmark(paths["videos"], questions, **kw)
    if bench == "pixrqa":
        return SegReferBenchmark(paths["videos"], questions, num_sam_frames=sam_frames,
                                 sam_image_size=sam_size, benchmark="pixrqa", **kw)
    return SegReferBenchmark(paths["videos"], questions, sam_image_size=sam_size, **kw)


def direct_infer(bench, sample, rt, tok, max_new):
    """The port's own ``mm_infer`` on a dataset sample, as the reference
    script of ``bench`` calls it: (text, output dict)."""
    from ufvideo_tpu_torch import mm_infer
    from ufvideo_tpu_torch.eval.run import PIXRQA_QUESTION

    if bench in ("mvbench", "tvg"):
        return mm_infer(sample["video"], sample["question"], rt, tok, modal="video",
                        max_new_tokens=max_new)
    if bench == "pixrqa":
        return mm_infer(sample["video"], PIXRQA_QUESTION, rt, tok, modal="video",
                        masks=sample["masks"], ann_indices=sample["ann_indices"],
                        frame=sample["frame"], choice=1, images_sam=sample["images_sam"],
                        label_size=(sample["height"], sample["width"]), max_new_tokens=max_new)
    out = mm_infer(sample["video"], sample["line"]["conversations"], rt, tok, modal="video",
                   choice=3, images_sam=sample["images_sam"],
                   label_size=(sample["height"], sample["width"]), seg=True)
    return None, out


def record_text(bench, rec):
    """The generated text a record holds (None where it holds none)."""
    return {"mvbench": rec.get("raw"), "tvg": rec.get("pred"),
            "pixrqa": rec.get("pred")}.get(bench)


def drive_benchmark(rt, tok, paths, bench, batch, out, sam_frames, max_new, num_frames=0):
    """``run_benchmark`` on one benchmark in this process: (records,
    BenchmarkCalls, wall s). Fails if run_benchmark fell back or printed a
    traceback."""
    import contextlib
    import io

    from ufvideo_tpu_torch.eval import run as eval_run
    from ufvideo_tpu_torch.eval.util import read_all_ranks

    args = eval_run.build_parser().parse_args([
        "--benchmark", bench, "--video-folder", paths["videos"], "--question-file",
        paths[bench], "--output", out, "--max-new-tokens", str(max_new),
        "--num-sam-frames", str(sam_frames), "--batch", str(batch)]
        + (["--num-frames", str(num_frames)] if num_frames else []))
    before = dict(eval_run.FAILURES)
    err = io.StringIO()
    with BenchmarkCalls(rt) as calls, contextlib.redirect_stderr(err):
        t0 = time.perf_counter()
        eval_run.run_benchmark(args, runtime=(rt, None, tok))
        wall = time.perf_counter() - t0
    if dict(eval_run.FAILURES) != before or "Traceback" in err.getvalue():
        log(err.getvalue()[-3000:])
        fail(f"phase 9 {bench} --batch {batch}: run_benchmark fell back or failed "
             f"({dict(eval_run.FAILURES)})")
    for i, c in enumerate(calls.calls):
        want = predicted_call_launches(rt.cfg, c)
        if c["launches"] != want:
            log(f"  launches {nonzero(c['launches'])}, predicted {nonzero(want)}")
            fail(f"phase 9 {bench} --batch {batch}: launches of call {i} differ from the "
                 "prediction")
    return read_all_ranks(out), calls, wall


def summed_launches(calls) -> dict:
    return {k: sum(c["launches"][k] for c in calls.calls) for k in all_wrappers()}


def run_eval(dev, rt, tok, smi, label, runs, frame_shape=(32, 480, 640, 3),
             sam_frames=EVAL_SAM_FRAMES, max_new=EVAL_NEW_TOKENS, processes=True,
             seed: int = 0, num_frames: int = 0) -> dict:
    """Phase 9 on ``rt``: each (benchmark, batch) of ``runs`` through
    ``run_benchmark``; launches of each of its calls held to the prediction;
    batch-1 records' text equal to the port's own ``mm_infer`` on the same
    sample, batch-2 records equal to batch 1's but at a near tie (mevis: the
    masks against each sample's own ``mm_infer`` on MASK_AGREE of each
    frame); the mask PNGs read back equal to the masks run_benchmark got; with
    ``processes``, mvbench as two ranks, the scorers and eval_smoke as
    processes. Returns the launches summed over run_benchmark's calls."""
    import shutil
    import tempfile

    from ufvideo_tpu_torch.eval.util import load_mask_pngs, read_all_ranks

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="ufvideo_eval_")
    total = dict.fromkeys(all_wrappers(), 0)
    try:
        t0 = time.perf_counter()
        paths = write_eval_data(tmp, seed, frame_shape)
        log(f"  [{label}] data: 2 directories of {frame_shape[0]} PNG frames "
            f"{frame_shape[1]}x{frame_shape[2]}, written in {time.perf_counter() - t0:.1f} s")
        results = {}
        for bench, batch in runs:
            out = os.path.join(tmp, f"{bench}_b{batch}.json")
            records, calls, wall = drive_benchmark(rt, tok, paths, bench, batch, out,
                                                   sam_frames, max_new, num_frames)
            if len(records) != 2:
                fail(f"phase 9 {bench} --batch {batch}: {len(records)} records")
            launches = summed_launches(calls)
            total = {k: total[k] + launches[k] for k in total}
            device_s = sum(c["ms"] for c in calls.calls) / 1e3
            log(f"  [{label}] {bench} --batch {batch}: {len(records)} records in "
                f"{len(calls.calls)} calls, {wall:.2f} s, {wall / len(records):.2f} s a sample "
                f"(mm_infer calls {device_s:.2f} s, the host's load / preprocess / write "
                f"{wall - device_s:.2f} s; {smi}); launches as predicted {nonzero(launches)}")
            results[bench, batch] = (records, calls, out)

        # batch 1: each record's text is the port's own mm_infer's on the sample
        for (bench, batch), (records, calls, out) in results.items():
            if batch != 1 and (bench, 1) in results:
                continue
            ds = eval_dataset(bench, paths, rt, sam_frames, num_frames)
            for i, (rec, row) in enumerate(zip(records, calls.rows())):
                text, extra = direct_infer(bench, ds[i], rt, tok, max_new)
                if batch == 1:
                    got = record_text(bench, rec)
                    want = text.split("The segmentation mask")[0] if bench == "pixrqa" else text
                    if got != want or row[0] != extra["output"]:
                        fail(f"phase 9 [{label}] {bench} record {rec['id']}: {got!r} is not "
                             f"mm_infer's {want!r}, or run_benchmark's tokens are not its")
                else:  # a batch without a batch-1 run: the masks against mm_infer's
                    mine = calls.rows()[i][2]
                    agree = [float((a == b).mean()) for a, b in zip(mine[0], extra["pred_masks"][0])]
                    log(f"  [{label}] {bench} --batch {batch} {rec['id']}: masks against its own "
                        f"mm_infer's, agreement per frame min {min(agree):.5f} (tolerance >= "
                        f"{MASK_AGREE})")
                    if len(mine) != len(extra["pred_masks"]) or min(agree) < MASK_AGREE:
                        fail(f"phase 9 {bench} --batch {batch}: masks disagree with mm_infer's")
            if batch == 1:
                log(f"  [{label}] {bench} --batch 1: every record's text and the tokens behind "
                    "it == the port's own mm_infer's on the sample")

        # batch 2 against batch 1: equal records, or tokens that part at a near tie
        for (bench, batch), (records, calls, out) in results.items():
            if batch == 1 or (bench, 1) not in results:
                continue
            ref_records, ref_calls, _ = results[bench, 1]
            for rec, ref, (toks, lg, _, _), (rtoks, rlg, _, _) in zip(
                    records, ref_records, calls.rows(), ref_calls.rows()):
                same, tie = first_near_tie(f"phase 9 [{label}] {bench} {rec['id']} batch 2 vs 1",
                                           rtoks, rlg, toks, lg)
                if tie is None and rec != ref:
                    fail(f"phase 9 {bench} {rec['id']}: equal tokens, different records")
                log(f"  [{label}] {bench} --batch {batch} {rec['id']}: tokens equal batch 1's "
                    f"{same}/{len(rtoks)}" + (f", then a near tie at token {tie}"
                                              if tie is not None else ", record equal"))

        # masks: the PNGs read back are the masks run_benchmark got, bit for bit
        for (bench, batch), (records, calls, out) in results.items():
            mask_dir = os.path.splitext(out)[0] + "_masks"
            for rec, (_, _, masks, _) in zip(records, calls.rows()):
                png = load_mask_pngs(mask_dir, rec["id"])
                want = np.asarray(masks[0]) if masks else np.zeros((0,))
                if (len(png) > 0) != bool(masks) or (masks and not np.array_equal(
                        np.stack(png).astype(bool), want.astype(bool))):
                    fail(f"phase 9 {bench} --batch {batch} {rec['id']}: mask PNGs differ from "
                         "run_benchmark's masks")
            n = sum(bool(r[2]) for r in calls.rows())
            if n:
                log(f"  [{label}] {bench} --batch {batch}: {n} samples' mask PNGs read back == "
                    "their masks bit for bit")
        if ("mevis", 2) in results and not all(
                r[2] for r in results["mevis", 2][1].rows()):
            fail("phase 9: a mevis sample has no masks")

        if processes:
            # mvbench as two ranks: the ranks' files merged are the one-rank records
            out = os.path.join(tmp, "mvbench_ranks.json")
            for rank in (0, 1):
                os.environ.update(RANK=str(rank), WORLD_SIZE="2")
                try:
                    _, calls, _ = drive_benchmark(rt, tok, paths, "mvbench", 1, out,
                                                  sam_frames, max_new, num_frames)
                finally:
                    del os.environ["RANK"], os.environ["WORLD_SIZE"]
                launches = summed_launches(calls)
                total = {k: total[k] + launches[k] for k in total}
            if read_all_ranks(out) != results["mvbench", 1][0]:
                fail("phase 9: mvbench as two ranks differs from one rank")
            log(f"  [{label}] mvbench as RANK 0 / 1 of WORLD_SIZE 2: the ranks' records == the "
                "one-rank records")
            root = os.path.dirname(os.path.abspath(__file__))
            m = "ufvideo_tpu_torch.eval."
            scorers = [
                ([m + "score_mcqa", "--pred-path", results["mvbench", 1][2]], "overall accuracy:"),
                ([m + "score_seg", "--pred-path", results["mevis", 2][2], "--pred-mask-root",
                  os.path.splitext(results["mevis", 2][2])[0] + "_masks", "--gt", "rle",
                  "--gt-file", paths["mevis_gt"], "--workers", "2"], "J&F:"),
                ([m + "score_tvg", "--pred-path", results["tvg", 1][2], "--durations",
                  paths["durations"]], "mIoU:"),
                (["ufvideo_tpu_torch.eval_smoke"], '"eval_smoke": "ok"'),
            ]
            for cmd, want in scorers:
                t0 = time.perf_counter()
                r = subprocess.run([sys.executable, "-m", *cmd], capture_output=True, text=True,
                                   timeout=600, cwd=root)
                lines = r.stdout.strip().splitlines()
                log(f"  python -m {cmd[0]}: exit {r.returncode} in "
                    f"{time.perf_counter() - t0:.1f} s: {' | '.join(lines[-4:])}")
                if r.returncode != 0 or want not in r.stdout:
                    fail(f"phase 9: python -m {cmd[0]} failed: {r.stderr[-3000:]}")
        log(f"  [{label}] phase 9: {time.perf_counter() - t_phase:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on the card; {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


# ------------------------------------- phase 10: projectors, CLIP, W8A8 --
# video tokens of each projector type for 32 frames of SigLIP's 27 x 27 grid
# (the JAX token_grid's formula; every mlpNx_gelu emits one frame's grid)
PROJECTOR_TOKENS = {"linear": 729, "mlp2x_gelu": 729, "stc_connector": 3332,
                    "stc_connector_v35": 2704, "stp_connector": 2704, "spatial_conv": 6664,
                    "spatial_pool": 5408}
PROJECTORS_10A = ("stc_connector", "mlp2x_gelu")  # VideoLLaMA2's and LLaVA's connector
PROJECTORS_10B = ("linear", "stp_connector", "spatial_conv", "spatial_pool")
CLIP_FRAMES = 32
CLIP_STC_TOKENS = 2873  # (17, 13, 13) from CLIP-L/14-336's 24 x 24 grid
# training limits (section 2 of PERF.md): gradient cosine over all tensors
# together, and of each tensor
GRAD_COS, GRAD_COS_TENSOR = 0.99, 0.95


def run_projector_paths(dev, seed: int, full) -> tuple:
    """10a: phase 3's QA request on a model_init runtime with the
    stc_connector and with the mlp2x_gelu projector, under phase 3's checks
    (run_path) and with the launches held to the prediction. Returns
    ({path: launches}, the SigLIP features of phase 3's frames [1, 32, 729,
    1152], read on the first runtime)."""
    from ufvideo_tpu_torch.ops.image_pipeline import siglip_preprocess_device

    counts, feats = {}, None
    for t in PROJECTORS_10A:
        log(f" 10a: projector {t}")
        cfg = full.replace(projector=dataclasses.replace(full.projector, projector_type=t))
        launches, rt, tok, req = run_path(dev, seed, cfg)
        want = expected_referring_launches(rt.cfg, len(req["ids"]), calls_to_tower=1)
        if launches != want:
            fail(f"projector {t}: launches {nonzero(launches)}, predicted {nonzero(want)}")
        log(f"  [{t}] {rt.cfg.num_video_tokens} video tokens; launches as predicted "
            f"{nonzero(want)}")
        if feats is None:
            with torch.no_grad():
                px = siglip_preprocess_device(torch.from_numpy(req["frames"]).to(dev),
                                              rt.cfg.compute_dtype)
                feats = rt.model.vision(px)[None]
        counts[f"proj_{t}"] = launches
        del rt
        torch.cuda.empty_cache()
    return counts, feats


def _projector(cfg, dev, seed: int):
    from ufvideo_tpu_torch.models.projector import build_projector

    with torch.device("meta"):
        proj = build_projector(cfg, torch.bfloat16)
    proj = proj.to_empty(device=dev).eval().requires_grad_(False)
    proj.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return proj


def run_projector_types(dev, seed: int, feats, timer) -> None:
    """10b: each other projector type alone at full width on the SigLIP
    features: output shape = token_grid's count = the tabled count, finite;
    ms; then the export → convert round trip of all six types bit for bit."""
    from ufvideo_tpu_torch.configs import ProjectorConfig
    from ufvideo_tpu_torch.export import export_projector
    from ufvideo_tpu_torch.weights import TensorWriter, convert_projector

    t_frames, grid = feats.shape[1], int(round(feats.shape[2] ** 0.5))
    for t in PROJECTORS_10B:
        cfg = ProjectorConfig(projector_type=t)
        proj = _projector(cfg, dev, seed)
        with torch.no_grad():
            out = proj(feats)
            ms = timer.ms(lambda: proj(feats), n=5)
        n = cfg.num_video_tokens(t_frames, grid)
        log(f"  10b {t}: {tuple(out.shape)} ({cfg.token_grid(t_frames, grid)}), {ms:.3f} ms, "
            f"{sum(p.numel() for p in proj.parameters()) / 1e6:.1f} M params")
        if tuple(out.shape) != (1, n, cfg.hidden_size) or n != PROJECTOR_TOKENS[t]:
            fail(f"projector {t}: output {tuple(out.shape)}, token_grid {n}, tabled "
                 f"{PROJECTOR_TOKENS[t]}")
        if not torch.isfinite(out).all():
            fail(f"projector {t}: non-finite output")
        del proj, out
    for t in PROJECTORS_10A + PROJECTORS_10B:
        cfg = ProjectorConfig(projector_type=t)
        proj = _projector(cfg, dev, seed)
        sd = export_projector(proj)
        back = _projector(cfg, dev, seed + 1)
        w = TensorWriter()
        convert_projector(w, back, sd)
        w.check_all_written(back)
        same = all(torch.equal(a, b) for a, b in zip(proj.state_dict().values(),
                                                     back.state_dict().values()))
        log(f"  10b {t}: export_projector -> convert_projector, {len(sd)} tensors, "
            f"bit for bit {same}")
        if not same:
            fail(f"projector {t}: the export / convert round trip is not bit for bit")
        del proj, back, sd
    torch.cuda.empty_cache()


def run_clip(dev, seed: int, timer) -> dict:
    """10c: the CLIP-L/14-336 tower (24 layers, the -2 tap: 23 computed) on
    32 frames at 336² (normalised pixels from the seed): the kernel path
    against use_kernel=False; flash launches counted; encode ms and peak;
    its features through an stc_connector of encoder width 1024."""
    from ufvideo_tpu_torch.configs import ProjectorConfig
    from ufvideo_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower

    ccfg = CLIPVisionConfig()
    with torch.device("meta"):
        tower = CLIPVisionTower(ccfg, torch.bfloat16)
    tower = tower.to_empty(device=dev).eval().requires_grad_(False)
    tower.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed)
    px = torch.randn(CLIP_FRAMES, ccfg.image_size, ccfg.image_size, 3, generator=gen,
                     device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        got, launches, wall = _count(all_wrappers(), lambda: tower(px))
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = tower(px, use_kernel=False)
        ms = timer.ms(lambda: tower(px), n=5)
        plain_ms = timer.ms(lambda: tower(px, use_kernel=False), n=3)
    cos = cosine(got, want)
    log(f"  10c CLIP-L/14-336, {len(tower.layers)} layers on [{CLIP_FRAMES},577,1024]: encode "
        f"{ms:.2f} ms (plain {plain_ms:.2f} ms; first call {wall:.1f} ms), peak {peak:.2f} GiB; "
        f"kernel vs plain cosine {cos:.6f} (limit {PATH_COS}); launches {nonzero(launches)}")
    if tuple(got.shape) != (CLIP_FRAMES, ccfg.num_patches, ccfg.hidden_size) or \
            not torch.isfinite(got).all():
        fail(f"CLIP tower: output {tuple(got.shape)} or non-finite")
    if cos < PATH_COS:
        fail("CLIP tower: kernel path and plain path disagree")
    split = collections.Counter()
    for name, t in timer.launches(lambda: tower(px), n=3):
        low = name.lower()
        split["flash_attention" if "flash" in low else
              "products (cuBLAS)" if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass"))
              else "the rest (LayerNorm, GELU, adds, copies)"] += t
    parts = ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
    log(f"  10c device time by family, one encode: {parts or 'lost (trace dropped events)'}")
    if launches != dict(dict.fromkeys(launches, 0), flash_attention=ccfg.num_encode_layers):
        fail(f"CLIP tower: launches {nonzero(launches)}, predicted "
             f"{{'flash_attention': {ccfg.num_encode_layers}}}")
    pcfg = ProjectorConfig(projector_type="stc_connector", encoder_hidden_size=ccfg.hidden_size)
    proj = _projector(pcfg, dev, seed)
    with torch.no_grad():
        tokens = proj(got[None])
    n = pcfg.num_video_tokens(CLIP_FRAMES, ccfg.grid_size)
    log(f"  10c CLIP features -> stc_connector: {tuple(tokens.shape)} "
        f"({pcfg.token_grid(CLIP_FRAMES, ccfg.grid_size)})")
    if tuple(tokens.shape) != (1, CLIP_STC_TOKENS, pcfg.hidden_size) or n != CLIP_STC_TOKENS \
            or not torch.isfinite(tokens).all():
        fail(f"CLIP -> stc_connector: {tuple(tokens.shape)}, expected {CLIP_STC_TOKENS} tokens")
    del tower, proj, got, want, tokens
    torch.cuda.empty_cache()
    return launches


def _w8a8_grad_cases(dev, gen):
    """(label, wrapper, args, kwargs) of each W8A8 kernel at SigLIP's shape
    and Hiera-L's windowed shapes; float leaves require gradients."""
    from ufvideo_tpu_torch.ops import hiera_block as hb

    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
    cases = [("fused_block_w8a8 SigLIP [32,729,1152]", hb.fused_block_w8a8,
              (mk(32, 729, 1152), w8a8_params(dev, gen, 1152, 4304), 16, 72),
              dict(act="gelu_tanh"))]
    for n, s, c, heads in HIERA_BLOCK_SHAPES:
        cases.append((f"fused_block_w8a8 Hiera [{n},{s},{c}]", hb.fused_block_w8a8,
                      (mk(n, s, c), w8a8_params(dev, gen, c, 4 * c), heads, c // heads),
                      dict(act="gelu_exact")))
    for n, s, cin, heads in HIERA_QPOOL_SHAPES:
        cout = 2 * cin
        p = w8a8_params(dev, gen, cout, 4 * cout, cin=cin, front_extra=cout)
        cases.append((f"fused_qpool_block_w8a8 [{n},{s},{cin}]->{cout}",
                      hb.fused_qpool_block_w8a8, (mk(n, s, cin), p, heads, cout // heads,
                                                  (2, 2)), {}))
    p = w8a8_params(dev, gen, 576, 2304)
    cases.append(("fused_ln_matmul_w8a8 [4,4096,576] x [576,1728]", hb.fused_ln_matmul_w8a8,
                  (mk(4, 4096, 576), *p[:5]), {}))
    cases.append(("fused_block_tail_w8a8 [4,4096,576] MLP 2304", hb.fused_block_tail_w8a8,
                  (mk(4, 4096, 576), mk(4, 4096, 576), p[5:]), {}))
    return cases


def _grad_leaves(args):
    """Fresh copies of ``args`` whose float tensors require gradients, and
    those tensors."""
    leaves = []

    def copy(t):
        if isinstance(t, (tuple, list)):
            return type(t)(copy(x) for x in t)
        if torch.is_tensor(t) and t.is_floating_point():
            t = t.detach().clone().requires_grad_(True)
            leaves.append(t)
        return t

    return copy(args), leaves


def run_w8a8_backward(dev, seed: int) -> None:
    """10d: a backward through each W8A8 kernel on the card (the kernel's
    forward, the straight-through backward) against the same backward taken
    with the plain W8A8 forward (use_kernel=False): the gradient of every
    float input, cosine over all together and over each tensor."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for label, fn, args, kw in _w8a8_grad_cases(dev, gen):
        g, grads = None, {}
        for use_kernel in (True, False):
            a, leaves = _grad_leaves(args)
            before = fn.launches
            out = fn(*a, **kw, use_kernel=use_kernel)
            if out.grad_fn is None:
                fail(f"{label}: no graph through the W8A8 wrapper")
            if g is None:
                g = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
            grads[use_kernel] = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            if fn.launches - before != int(use_kernel):
                fail(f"{label}: {fn.launches - before} launches with use_kernel={use_kernel}")
        k, p = grads[True], grads[False]
        whole = cosine(torch.cat([t.float().flatten() for t in k]),
                       torch.cat([t.float().flatten() for t in p]))
        each = [cosine(a, b) for a, b in zip(k, p)]
        finite = all(torch.isfinite(t).all() for t in k)
        log(f"  10d {label}: {len(k)} gradients, cosine {whole:.5f} together, min "
            f"{min(each):.5f} a tensor (limits {GRAD_COS} / {GRAD_COS_TENSOR})")
        if not finite or whole < GRAD_COS or min(each) < GRAD_COS_TENSOR:
            fail(f"{label}: the kernel route's gradients disagree with the plain route's")
        del grads, k, p
    torch.cuda.empty_cache()


def run_phase10(dev, seed: int, full) -> dict:
    """Phase 10 (10a-10d); returns the counted paths' launches."""
    counts, feats = run_projector_paths(dev, seed, full)
    timer = Timer(dev)
    log(" 10b: the other projector types alone at full width")
    run_projector_types(dev, seed, feats, timer)
    del feats
    log(" 10c: the CLIP-L/14-336 tower")
    counts["clip"] = run_clip(dev, seed, timer)
    del timer
    log(" 10d: the W8A8 kernels' straight-through backward on the card")
    run_w8a8_backward(dev, seed)
    return counts


# ------------------------------------------------------ phase 11: parallelism --

# Phase 11: the parallelism layer on the one card, world 1 over NCCL (NCCL puts
# no two ranks on one card; several ranks are held to the JAX package on the
# CPU over gloo, tests/test_torch_parallel.py). 11a: phase 8b's setting
# through maybe_initialize_distributed -> create_mesh(1, 1, 1) -> shard_params
# (FSDP2 units) -> make_train_step(mesh=) -> Trainer(mesh=), three steps, held
# against an unsharded Trainer from the same seed: bit for bit is expected at
# world 1 (the same arithmetic on gathered copies); else each loss within
# PAR_LOSS_REL and each trained tensor's change within PAR_COS of cosine.
PAR_LOSS_REL, PAR_COS = 1e-3, 0.999
# 11b: ring attention at Qwen2-7B's train shape of phase 8b's sample (2807
# positions, 28 query heads, 4 kv heads of 128), causal, padded keys, one rank:
# the ring's f32 online softmax against the plain f32 masked softmax
RING_SHAPE = (1, 2807, 28, 4, 128)
RING_COS = 0.999
# 11c: the training launcher under torch.distributed.run on PNG frames
PAR_LAUNCH_FRAMES = (6, 40, 56, 3)


def _cos_change(a, b, start) -> float:
    return cosine((a - start).float(), (b - start).float())


def _nccl_calls(prof) -> dict:
    """c10d's collective calls of a profiled run by name (its ``nccl:``
    ranges; ``gloo:`` on the CPU)."""
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith(("nccl:", "gloo:"))}


def run_parallel_train(dev, seed: int, cfg, frame_shape=(32, 480, 640, 3), sam_frames=4,
                       label=TRAIN_LABEL) -> dict:
    """11a (see above); returns the sharded run's launches."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from ufvideo_tpu_torch import model_init
    from ufvideo_tpu_torch.parallel.mesh import create_mesh, maybe_initialize_distributed
    from ufvideo_tpu_torch.parallel.partition import full_param
    from ufvideo_tpu_torch.train.data import Collator
    from ufvideo_tpu_torch.train.seg_step import segmentation_loss_fn
    from ufvideo_tpu_torch.train.trainer import TrainConfig, Trainer

    wrappers = all_wrappers()
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, num_layers=4, remat=True))
    tmp = tempfile.mkdtemp(prefix="ufvideo_parallel_")
    runs = {}
    try:
        for name in ("unsharded", "sharded"):
            rt, _, tok = model_init(cfg=cfg, device=dev, seed=seed)
            _, _, sample = train_request(dev, seed, rt.cfg, tok, frame_shape, sam_frames, label)
            collator = Collator(rt.cfg, rt.ids.region, rt.ids.seg)
            tc = TrainConfig(output_dir=os.path.join(tmp, name), learning_rate=TRAIN_LR,
                             total_steps=10, global_batch_size=1, save_steps=100, seed=seed)
            mesh = None
            if name == "sharded":
                t0 = time.perf_counter()
                multi = maybe_initialize_distributed()
                mesh = create_mesh(1, 1, 1)
                log(f"  maybe_initialize_distributed() -> {multi}; create_mesh(1, 1, 1) -> "
                    f"{mesh} over {torch.distributed.get_backend()} in "
                    f"{time.perf_counter() - t0:.2f} s")
            trainer = Trainer(rt.model, rt.cfg, tc, loss_fn=segmentation_loss_fn, mesh=mesh)
            state = trainer.init_state()
            start = {n: full_param(rt.model, n, p).detach().clone()
                     for n, p in state.params.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, launches, ms = _count(wrappers, lambda: trainer.train(
                state, _batches(sample, collator, dev, TRAIN_STEPS), max_steps=TRAIN_STEPS))
            peak = torch.cuda.max_memory_allocated() / 2**30
            recs = _log_records(os.path.join(tc.output_dir, "train_log.jsonl"))
            after = {n: full_param(rt.model, n, p).detach().clone()
                     for n, p in state.params.items()}
            nccl = None
            if mesh is not None:
                batch = next(iter(_batches(sample, collator, dev, 1)))
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    trainer.step_fn(state, batch)
                    torch.cuda.synchronize()
                nccl = _nccl_calls(prof)
            runs[name] = dict(losses=[r["loss"] for r in recs],
                              norms=[r["grad_norm"] for r in recs],
                              step_ms=_step_ms(recs), peak=peak, launches=launches, ms=ms,
                              start=start, after=after, nccl=nccl)
            log(f"  {name}: {TRAIN_STEPS} steps in {ms:.1f} ms, step 2 {_step_ms(recs):.1f} ms, "
                f"peak {peak:.2f} GiB, losses {runs[name]['losses']}, grad norms "
                f"{runs[name]['norms']}" + ("" if nccl is None else
                                           f", collective calls in a (fourth) step: "
                                           f"{sum(nccl.values())} {nccl}"))
            del rt, trainer, state
            gc.collect()  # the sharded root and its model hold each other
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = runs["unsharded"], runs["sharded"]
    want = expected_train_launches(cfg, sam_frames, TRAIN_STEPS)
    log(f"  sharded launches {nonzero(b['launches'])} (predicted {nonzero(want)})")
    if b["launches"] != want:
        fail("phase 11a: the sharded steps' launches differ from the prediction")
    same = (a["losses"] == b["losses"] and a["norms"] == b["norms"]
            and all(torch.equal(a["after"][n], b["after"][n]) for n in a["after"]))
    if same:
        log(f"  bit for bit: every loss, grad norm and all {len(a['after'])} trained tensors "
            "after step 3 equal the unsharded Trainer's")
    else:
        rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"], a["losses"]))
        cos = min(_cos_change(b["after"][n], a["after"][n], a["start"][n]) for n in a["after"])
        log(f"  not bit for bit: losses within {rel:.2e} relative (limit {PAR_LOSS_REL}), "
            f"least cosine of a trained tensor's change {cos:.6f} (limit {PAR_COS})")
        if rel > PAR_LOSS_REL or cos < PAR_COS:
            fail("phase 11a: the sharded steps differ from the unsharded ones")
    return b["launches"]


def run_ring(dev, seed: int) -> None:
    """11b (see above), over the mesh of 11a's process group."""
    from ufvideo_tpu_torch.ops.ring_attention import ring_attention, ring_attention_plain
    from ufvideo_tpu_torch.parallel.mesh import create_mesh

    b, s, hq, hkv, d = RING_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    mk = lambda h: torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = mk(hq), mk(hkv), mk(hkv)
    lens = torch.tensor([s - s // 26], device=dev)  # 2700 of 2807 valid keys
    mesh = create_mesh(1, 1, 1)
    outs = {}
    for name, fn in (("ring", lambda *x: ring_attention(*x, mesh, "fsdp", causal=True,
                                                        kv_lens=lens)),
                     ("plain", lambda *x: ring_attention_plain(*x, causal=True, kv_lens=lens))):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(*ins)
        (o.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        outs[name] = (o.detach(), [t.grad for t in ins], (time.perf_counter() - t0) * 1e3)
    (o1, g1, ms1), (o2, g2, ms2) = outs["ring"], outs["plain"]
    cos = [cosine(o1, o2)] + [cosine(x, y) for x, y in zip(g1, g2)]
    log(f"  ring_attention q {tuple(q.shape)} k / v {tuple(k.shape)} causal, kv_lens "
        f"{lens.tolist()}, one rank: output cosine {cos[0]:.6f}, dq / dk / dv "
        f"{', '.join(f'{c:.6f}' for c in cos[1:])} (limit {RING_COS}); forward + backward "
        f"{ms1:.1f} ms, plain {ms2:.1f} ms (first calls)")
    if min(cos) < RING_COS:
        fail("phase 11b: ring attention differs from the plain attention")


def run_parallel_launcher(seed: int) -> None:
    """11c: ``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    ufvideo_tpu_torch.train --tiny --dp 1 --fsdp 1 --tp 1`` for two steps on
    PNG frame directories ([SEG] + <region> records with RLE masks): one
    rank of layout 1 trains the unsharded step; then the same with
    ``--fsdp 2``, which must be refused naming the world and the card."""
    import shutil
    import tempfile

    from ufvideo_tpu_torch import rle
    from ufvideo_tpu_torch.eval.png import write_png

    tmp = tempfile.mkdtemp(prefix="ufvideo_launch_")
    try:
        rng = np.random.default_rng(seed + 12)
        t, h, w, _ = PAR_LAUNCH_FRAMES
        records = []
        for v in range(2):
            d = os.path.join(tmp, f"vid{v}")
            os.makedirs(d)
            for f in range(t):
                write_png(os.path.join(d, f"{f:03d}.png"),
                          rng.integers(0, 256, PAR_LAUNCH_FRAMES[1:], dtype=np.uint8), level=1)
            mask = np.zeros((h, w), np.uint8)
            mask[8 + v:24, 10:30 + v] = 1
            records.append({"id": v, "video": f"vid{v}",
                            "annotation": [{"1": {"segmentation": rle.encode(mask)}}],
                            "conversations": [
                                {"from": "human", "value": "<video>\n<region>: segment."},
                                {"from": "gpt", "value": "Sure, [SEG]."}]})
        data = os.path.join(tmp, "data.json")
        with open(data, "w") as f:
            json.dump(records * 2, f)
        base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "-m", "ufvideo_tpu_torch.train", "--tiny",
                "--data-paths", data, "--video-root", tmp, "--global-batch-size", "2",
                "--total-steps", "2", "--num-workers", "1", "--dp", "1", "--tp", "1"]
        for fsdp, ok in (("1", True), ("2", False)):
            t0 = time.perf_counter()
            res = subprocess.run(base + ["--fsdp", fsdp, "--output-dir",
                                         os.path.join(tmp, f"out{fsdp}")],
                                 cwd=os.path.dirname(os.path.abspath(__file__)),
                                 capture_output=True, text=True, timeout=300)
            secs = time.perf_counter() - t0
            lines = [ln for ln in res.stdout.splitlines() if ln.startswith(("rank ", "done"))]
            refusal = [ln for ln in res.stderr.splitlines() if "needs 2 ranks" in ln]
            log(f"  --fsdp {fsdp}: rc {res.returncode} in {secs:.1f} s; "
                f"{lines + refusal[:1]}")
            if ok and (res.returncode != 0 or "rank 0 of 1 on cuda:0, unsharded" not in res.stdout
                       or not any(ln.startswith("done at step 2") for ln in lines)):
                fail(f"phase 11c: the launcher failed under torch.distributed.run:\n"
                     f"{res.stderr[-3000:]}")
            if not ok and (res.returncode == 0 or not any(
                    "world of 1 over 1 visible card" in ln for ln in refusal)):
                fail(f"phase 11c: --fsdp 2 on one card was not refused as it should be:\n"
                     f"{res.stderr[-3000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_deployment_bytes(cfg) -> None:
    """11d: the 7B full finetune's parameters and two moments a chip."""
    from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
    from ufvideo_tpu_torch.parallel.mesh import MeshShape
    from ufvideo_tpu_torch.parallel.partition import audit_shardings, per_chip_state_bytes
    from ufvideo_tpu_torch.train.train_step import abstract_train_state

    state = abstract_train_state(UFVideoModel.empty(cfg, "meta"))
    total = per_chip_state_bytes(state, MeshShape())
    parts = [f"(1, 1, 1) {total / 2**30:.2f} GiB"]
    for layout in ((1, 4, 1), (1, 8, 1), (1, 4, 2)):
        m = MeshShape(*layout)
        n = per_chip_state_bytes(state, m)
        parts.append(f"{layout} {n / 2**30:.2f} GiB ({n} B; {len(audit_shardings(state, m))} "
                     "replicated >= 100 MB)")
    log(f"  per_chip_state_bytes, 7B full finetune (bf16 parameters + Adam mu / nu): "
        f"{'; '.join(parts)}")


def run_phase11(dev, seed: int, full) -> dict:
    import torch.distributed as dist

    t0 = time.perf_counter()
    log(" 11a: phase 8b's setting through the sharded path, world 1 over NCCL")
    launches = run_parallel_train(dev, seed, full)
    log(" 11b: ring attention at Qwen2-7B's train shape")
    run_ring(dev, seed)
    log(" 11c: the training launcher under torch.distributed.run")
    run_parallel_launcher(seed)
    log(" 11d: deployment arithmetic")
    run_deployment_bytes(full)
    if dist.is_initialized():
        dist.destroy_process_group()
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")
    return launches


def sass_counts(lib, opcode: str) -> dict:
    """Instructions of ``opcode`` in each kernel of a built library, from
    ``cuobjdump -sass`` (the toolkit's, beside nvcc); kernels without one
    are left out."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, fn = collections.Counter(), None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and f" {opcode}" in line:
            counts[fn] += 1
    return dict(counts)


# ------------------------------------------------------------------ main --

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true", help="stop after phase 2")
    ap.add_argument("--match", default="", help="phase 2 on the kernels whose name holds "
                    "one of these comma-separated words, then stop (a new kernel's first "
                    "call on a card)")
    ap.add_argument("--train-only", action="store_true",
                    help="phases 0-1 and 8 (training), then stop: no result")
    ap.add_argument("--eval-only", action="store_true",
                    help="phases 0-1, 3 and 9 (eval), then stop: no result")
    ap.add_argument("--projectors-only", action="store_true",
                    help="phases 0-2 and 10 (the other projectors, CLIP, the W8A8 "
                         "backward), then stop: no result")
    ap.add_argument("--parallel-only", action="store_true",
                    help="phases 0-1 and 11 (parallelism), then stop: no result")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    import ufvideo_tpu_torch  # noqa: F401  (fails outside the repo)
    from ufvideo_tpu_torch import _build

    log("phase 0: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"  {smi}")
    log(f"  torch {torch.__version__} CUDA {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    log("phase 1: build")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s wall "
        f"(per source: {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())})")
    for name in sorted(secs):
        log_file = _build._lib_path(name).with_suffix(".log")
        for line in log_file.read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"    {name}: {line.strip()}")
    for fn, n in sass_counts(_build._lib_path("quant_matmul"), "HMMA").items():
        log(f"    quant_matmul SASS: {n} HMMA in {fn}")

    from ufvideo_tpu_torch.configs import UFVideoConfig

    full = UFVideoConfig()
    if args.parallel_only:
        log("phase 11: parallelism on the card")
        par = run_phase11(dev, args.seed, full)
        print(json.dumps({"launches_parallel": nonzero(par)}), flush=True)
        log("stopped after phase 11 (--parallel-only): no result")
        return 0
    if args.train_only:
        log(" 8a: a LoRA [SEG] + <region> finetune at full width and depth")
        lora = run_train_lora(dev, args.seed, full)
        log(" 8b: the reference's freezing policy (full LLM finetune), LLM cut to 4 layers")
        full_policy = run_train_full(dev, args.seed, full)
        print(json.dumps({"launches_train_lora": nonzero(lora),
                          "launches_train_full": nonzero(full_policy)}), flush=True)
        log("stopped after phase 8 (--train-only): no result")
        return 0

    int8_cfg = full.replace(quant_llm="int8", quant_kv=True, quant_vision=True)
    eval_int8 = lambda rt, tok: run_eval(dev, rt, tok, smi, "int8", EVAL_RUNS_INT8,
                                         processes=False, seed=args.seed)
    if args.eval_only:
        from ufvideo_tpu_torch import model_init

        log("phase 3: full-width mm_infer on the card")
        _, rt, tok, _ = run_path(dev, args.seed, full)
        log("phase 9: the eval harness on the bf16 runtime")
        ev = run_eval(dev, rt, tok, smi, "bf16", EVAL_RUNS_BF16, seed=args.seed)
        del rt
        torch.cuda.empty_cache()
        log("phase 9: the eval harness on the int8 serving runtime (int8 LLM, int8 KV, W8A8)")
        rt, _, tok = model_init(cfg=int8_cfg, device=dev, seed=args.seed)
        ev8 = eval_int8(rt, tok)
        print(json.dumps({"launches_eval": nonzero(ev), "launches_eval_int8": nonzero(ev8)}),
              flush=True)
        log("stopped after phase 9 (--eval-only): no result")
        return 0

    log("phase 2: kernels vs plain (bf16, main-path shapes)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    timer = Timer(dev)
    # the int8-rate probe's bf16 product is the block GEMM alone: it goes
    # first, before the blocks built on it
    checks = {
        "probe_step": kernel_probe,
        "fused_hiera_block": kernel_hiera, "flash_attention": kernel_flash,
        "ragged_decode_attention": lambda *a: kernel_decode(*a, "bf16"),
        "fused_ln_matmul": kernel_ln_matmul,
        "fused_block_tail": kernel_block_tail, "fused_qpool_block": kernel_qpool,
        "ragged_decode_attention_q8": lambda *a: kernel_decode(*a, "q8"),
        "int8_matvec": lambda *a: kernel_quant_matmul(*a, full, 8),
        "int4_matmul": lambda *a: kernel_quant_matmul(*a, full, 4),
        "fused_block_w8a8": kernel_w8a8, "fused_qpool_block_w8a8": kernel_qpool_w8a8,
        "fused_ln_matmul_w8a8": kernel_ln_matmul_w8a8,
        "fused_block_tail_w8a8": kernel_block_tail_w8a8,
        "fused_hiera_stage": lambda *a: kernel_stage(*a, full),
        "fused_window_attention": kernel_window_attention,
        "mha_full_attention_packed": kernel_packed_mha,
    }
    if set(checks) != set(all_wrappers()):
        fail("phase 2 does not hold every counted kernel")
    # the W8A8 family draws its inputs from a generator of its own, so that
    # --match w8a8 holds these kernels on the inputs the whole run gives them
    gen_q = torch.Generator(device=dev)
    gen_q.manual_seed(args.seed)
    matches = args.match.split(",")
    kernels = [fn(dev, timer, gen_q if "w8a8" in name else gen)
               for name, fn in checks.items() if any(m in name for m in matches)]
    for k in kernels:
        with_ratio(k)
        log(f"  {k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}){ratio_text(k)} at {k['shape']}")
        log_shapes(k)
    del timer
    torch.cuda.empty_cache()

    if args.kernels_only or args.match:
        print(json.dumps({"kernels": kernels}), flush=True)
        log("stopped after phase 2 (--kernels-only / --match): no result")
        return 0
    if args.projectors_only:
        log("phase 10: the other projectors, the CLIP tower, the W8A8 backward")
        proj = run_phase10(dev, args.seed, full)
        print(json.dumps({"kernels": kernels,
                          **{f"launches_{k}": nonzero(v) for k, v in proj.items()}}),
              flush=True)
        log("stopped after phase 10 (--projectors-only): no result")
        return 0
    log("phase 3: full-width mm_infer on the card")
    launches, rt, tok, qa_request = run_path(dev, args.seed, full)
    log("phase 4: full-width [SEG] segmentation on the card")
    seg_launches, ref_bf16 = run_seg(dev, args.seed, rt, tok)
    log("phase 4b: streaming, speculative and batched serving on the same model")
    serving_bf16 = {"stream": run_stream(dev, rt, tok, "bf16", qa_request),
                    "spec": run_spec(dev, rt, tok, "bf16", qa_request),
                    "batch": run_serving_batch(dev, rt, tok, qa_request, ref_bf16)}
    log("phase 3b: the runtime exported and loaded back through model_init(model_path=)")
    ckpt = run_checkpoint(dev, args.seed, rt, tok, qa_request, ref_bf16)
    log("phase 9: the eval harness on the same model")
    eval_bf16 = run_eval(dev, rt, tok, smi, "bf16", EVAL_RUNS_BF16, seed=args.seed)
    del rt
    torch.cuda.empty_cache()
    log("phase 5: full-width quantised region referring on the card")
    int8_launches, batch_int8, serving_int8 = run_referring(
        dev, args.seed, int8_cfg, "int8 + int8 KV + W8A8 SigLIP", 32, during=eval_int8)
    int4_launches, batch_int4, serving_int4 = run_referring(
        dev, args.seed, full.replace(quant_llm="int4"), "int4", 8)
    log("phase 6: full-width quantised [SEG] segmentation and SAM2's other predictors")
    (qseg_launches, general_launches, batched_launches, ref_int8, serve_launches,
     engine_launches) = run_quant_seg(dev, args.seed, full, smi)
    log("phase 7: the vision towers' other routings, the windowed MultiScaleAttention, "
        "the int8-rate probe")
    from ufvideo_tpu_torch.configs import VisionRouting

    log(" 7a: [SEG] on the bf16 runtime, routing " + str(ROUTING_7A))
    seg_7a = run_routed_seg(dev, args.seed, full, VisionRouting(**ROUTING_7A), "7a bf16",
                            ref_bf16, (PATH_COS, PATH_COS, SEG_COS))
    log(" 7b: [SEG] on the int8 serving runtime, routing " + str(ROUTING_7B))
    seg_7b = run_routed_seg(
        dev, args.seed, full.replace(quant_llm="int8", quant_kv=True, quant_vision=True),
        VisionRouting(**ROUTING_7B), "7b int8", ref_int8,
        (QUANT_COS, SEG_QUANT_FEAT_COS, SEG_QUANT_COS))
    log(" 7c: the windowed MultiScaleAttention module")
    msa_launches = run_window_msa(dev, args.seed)
    log(" 7d: the int8-rate probe")
    probe_launches = run_probe(dev, smi)
    torch.cuda.empty_cache()
    log("phase 8: training on the card")
    log(" 8a: a LoRA [SEG] + <region> finetune at full width and depth")
    train_lora = run_train_lora(dev, args.seed, full)
    log(" 8b: the reference's freezing policy (full LLM finetune), LLM cut to 4 layers")
    train_full = run_train_full(dev, args.seed, full)
    torch.cuda.empty_cache()
    log("phase 10: the other projectors, the CLIP tower, the W8A8 backward")
    proj = run_phase10(dev, args.seed, full)
    torch.cuda.empty_cache()
    log("phase 11: parallelism on the card")
    parallel = run_phase11(dev, args.seed, full)
    for k in kernels:
        # each path's counts were read around its own call, from zero;
        # "launches" is derived: their sum over the counted runs
        by_path = {"qa": launches, "seg": seg_launches, "ref_int8": int8_launches,
                   "ref_int4": int4_launches, "batch_int8": batch_int8,
                   "batch_int4": batch_int4, "seg_int8": qseg_launches,
                   "general_int8": general_launches, "batched_int8": batched_launches,
                   "serve_int8": serve_launches, "engine_int8": engine_launches["plain"],
                   "engine_spec_int8": engine_launches["spec"],
                   "seg_7a": seg_7a, "seg_7b": seg_7b, "window_msa": msa_launches,
                   "probe": probe_launches, "train_lora": train_lora,
                   "train_full": train_full, "eval": eval_bf16, "parallel": parallel,
                   **ckpt, **proj}
        for label, serving in (("bf16", serving_bf16), ("int8", serving_int8),
                               ("int4", serving_int4)):
            by_path.update({f"{path}_{label}": counts for path, counts in serving.items()})
        for path, counts in by_path.items():
            k[f"launches_{path}"] = counts[k["name"]]
        k["launches"] = sum(counts[k["name"]] for counts in by_path.values())
        if k["launches"] <= 0:
            fail(f"{k['name']} was launched on no path")
        k["check"] = "ok"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
