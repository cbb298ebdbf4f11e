"""Build the port's CUDA kernels and drive its video-QA path on one GPU.

    python3 chip_smoke.py                 # all phases (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # phases 0-2: build + kernel checks

Phases, each printed as it runs; any failure exits non-zero:
  0. device: nvidia-smi name / power limit, torch and CUDA versions; TF32 off.
  1. build: compile csrc/*.cu with nvcc (in parallel), print the seconds.
  2. kernels: each kernel against its plain PyTorch version at the shapes
     the full-width path gives it, bf16, held to a limit scaled to the
     output (see check_close); for the block also its attention part alone;
     kernel / plain / library ms (CUDA events, median of 20 after warm-up,
     L2 flushed before each launch) beside the bound.
  3. path: model_init at full width (SigLIP-SO400M + STC-v35 + Qwen2-7B,
     bf16, random weights from a seed) on the card; mm_infer on 32 uint8
     frames (480x640, bicubic resize) with max_new_tokens=32; launch counts
     read around that one call; timings of encode / prefill / decode; all
     outputs finite; the video tokens, the final prefill hidden state and
     the logits of the first decode steps through the kernels against the
     plain versions, and their greedy tokens.
Then one JSON line per kernel, the card line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
N_TIMED = 20
# kernel path vs plain path at full width; the run before this check read
# cosines of 0.9998 (video tokens, prefill hidden states) on an H100
PATH_COS = 0.999


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


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
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


def tol_text(row_rel: float) -> str:
    return f"|d| <= {row_rel}*rms(row) + {RTOL}*|plain| and ||d||/||plain|| <= {REL}"


def check_close(name, got, want, row_rel=REL, fatal=True):
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    max_abs = float(err.max())
    row_rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    excess = float((err - (row_rel * row_rms + RTOL * want.abs() + 1e-6)).max())
    rel_fro = float((got - want).norm() / want.norm().clamp_min(1e-30))
    ok = excess <= 0 and rel_fro <= REL
    # the smallest row-RMS factor that would have passed, at RTOL
    need = float(((err - RTOL * want.abs()) / row_rms.clamp_min(1e-30)).max())
    log(f"  {name}: max_abs_err {max_abs:.3e}, rel_fro {rel_fro:.3e}, needs "
        f"{need:.2e}*rms(row) (tolerance {tol_text(row_rel)}) "
        f"{'ok' if ok else 'EXCEEDED'}")
    if not ok and fatal:
        fail(f"{name} disagrees with its plain version")
    return max_abs


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
                shape="q [1,2816,28,128] k/v [1,2816,4,128] causal kv_lens [2770]")


def kernel_decode(dev, timer, gen):
    from ufvideo_tpu_torch.ops.decode_attention import (
        ragged_decode_attention, ragged_decode_attention_plain)
    import torch.nn.functional as F

    def inputs(b, s, lens):
        mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)
        return (mk(b, 4, 7, 128), mk(b, 4, s, 128), mk(b, 4, s, 128),
                torch.tensor(lens, dtype=torch.int32, device=dev))

    errs = []
    for label, (b, s, lens) in {
        "B=1 cache 2944 lens 2771": (1, 2944, [2771]),
        "B=4 ragged lens": (4, 2944, [2944, 1, 1500, 129]),
    }.items():
        q, k, v, lens_t = inputs(b, s, lens)
        got = ragged_decode_attention(q, k, v, lens_t)
        want = ragged_decode_attention_plain(q, k, v, lens_t)
        torch.cuda.synchronize()
        errs.append(check_close(f"ragged_decode_attention [{label}]", got, want))

    q, k, v, lens_t = inputs(1, 2944, [2771])
    t_b, by = bound_ms(nbytes(q, q) + 2 * 2771 * 4 * 128 * 2, 4 * 2771 * 28 * 128)
    ms = timer.ms(lambda: ragged_decode_attention(q, k, v, lens_t))
    plain = timer.ms(lambda: ragged_decode_attention_plain(q, k, v, lens_t))
    mask = (torch.arange(2944, device=dev) < 2771)[None, None, None, :]
    qs = q.reshape(1, 28, 1, 128)
    lib = timer.ms(lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, enable_gqa=True))
    return dict(name="ragged_decode_attention", route="cuda",
                source="ufvideo_tpu_torch/csrc/decode_attention.cu",
                replaces="ufvideo_tpu/ops/decode_attention.py:200",
                max_abs_err=max(errs), tol=tol_text(REL), ms=ms, plain_ms=plain,
                bound_ms=t_b, bound_by=by, library_ms=lib,
                shape="q [1,4,7,128] cache [1,4,2944,128] lens [2771]")


def kernel_hiera(dev, timer, gen):
    from ufvideo_tpu_torch.ops.hiera_block import fused_hiera_block, fused_hiera_block_plain
    import torch.nn.functional as F

    n, s, c, heads, hd, mlp = 32, 729, 1152, 16, 72, 4304
    bf = torch.bfloat16
    rn = lambda *sh: torch.randn(*sh, generator=gen, device=dev)
    params = (
        (1 + 0.1 * rn(c)).to(bf), (0.1 * rn(c)).to(bf),
        (rn(c, 3 * c) * c ** -0.5).to(bf), (0.1 * rn(3 * c)).to(bf),
        (rn(c, c) * c ** -0.5).to(bf), (0.1 * rn(c)).to(bf),
        (1 + 0.1 * rn(c)).to(bf), (0.1 * rn(c)).to(bf),
        (rn(c, mlp) * c ** -0.5).to(bf), (0.1 * rn(mlp)).to(bf),
        (rn(mlp, c) * mlp ** -0.5).to(bf), (0.1 * rn(c)).to(bf),
    )
    x = rn(n, s, c).to(bf)
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
        x1 = x + torch.addmm(bp, o.transpose(1, 2).reshape(rows, c), wp).reshape(n, s, c)
        h = F.layer_norm(x1, (c,), l2s, l2b, 1e-6).reshape(rows, c)
        h = F.gelu(torch.addmm(b1, h, w1), approximate="tanh")
        return x1 + torch.addmm(b2, h, w2).reshape(n, s, c)

    lib = timer.ms(unfused)
    want = fused_hiera_block_plain(x, params, heads, hd, act="gelu_tanh", eps=1e-6)
    check_close("unfused library block (yardstick only)", unfused(), want,
                row_rel=BLOCK_REL, fatal=False)
    return dict(name="fused_hiera_block", route="cuda",
                source="ufvideo_tpu_torch/csrc/hiera_block.cu",
                replaces="ufvideo_tpu/ops/hiera_block.py:435",
                max_abs_err=err, tol=tol_text(BLOCK_REL), ms=ms, plain_ms=plain,
                bound_ms=t_b, bound_by=by, library_ms=lib,
                shape="x [32,729,1152] 16 heads x 72, MLP 4304, gelu_tanh")


# ------------------------------------------------------------------ path --

def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-30))


def run_path(dev, seed: int, cfg, frame_shape=(32, 480, 640, 3), max_new_tokens=32):
    from ufvideo_tpu_torch import mm_infer, model_init
    from ufvideo_tpu_torch.api import _assemble_input_ids
    from ufvideo_tpu_torch.ops.decode_attention import ragged_decode_attention
    from ufvideo_tpu_torch.ops.flash_attention import flash_attention
    from ufvideo_tpu_torch.ops.hiera_block import fused_hiera_block
    from ufvideo_tpu_torch.ops.image_pipeline import siglip_preprocess_device
    from ufvideo_tpu_torch.models.qwen2 import make_kv_cache
    from ufvideo_tpu_torch.splicing import plan_splice

    wrappers = {"fused_hiera_block": fused_hiera_block, "flash_attention": flash_attention,
                "ragged_decode_attention": ragged_decode_attention}
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
    for k, n in launches.items():
        if n <= 0:
            fail(f"{k} was never launched on the main path")

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
    from ufvideo_tpu_torch.models.generate import _mask_vocab_logits

    llm = rt.model.llm
    n_steps = 8

    def path(use_kernels: bool, forced=None):
        rt.model.set_use_kernels(use_kernels)
        f = rt.encode_video(pixels[None])
        p = plan_splice([ids], num_video_tokens=f.shape[1], region_token_counts=[[]],
                        region_token_id=rt.ids.region, max_seq_len=cfg.budget.max_seq_len)
        emb = rt.model.splice_embeds(*(torch.as_tensor(a, device=dev) for a in
                                       (p.text_ids, p.src_kind, p.src_idx)), f)
        n = int(p.seq_lens[0])
        lens = torch.as_tensor(p.seq_lens, device=dev)
        trim = min(-(-n // 256) * 256, cfg.budget.max_seq_len)
        cache = make_kv_cache(cfg.llm, 1, -(-(trim + n_steps) // 128) * 128,
                              dtype=cfg.compute_dtype, device=dev)
        pos = torch.arange(trim, device=dev)[None]
        h, cache = llm.backbone(emb[:, :trim], pos, lens, cache, None, "prefill")
        last, cur_len = h[:, n - 1], lens.long()
        logits, toks = [], []
        for i in range(n_steps):
            lg = _mask_vocab_logits(llm.logits(last[:, None])[:, 0].float(),
                                    cfg.llm.vocab_size)[0]
            logits.append(lg)
            toks.append(int(lg.argmax()) if forced is None else forced[i])
            e = llm.embed(torch.tensor([[toks[-1]]], device=dev))
            hd, cache = llm.backbone(e, cur_len[:, None], None, cache, cur_len, "decode")
            last, cur_len = hd[:, 0], cur_len + 1
        return f, h[0, :n], torch.stack(logits), toks

    with torch.no_grad():
        for w in wrappers.values():
            w.launches = 0
        f_k, h_k, lg_k, toks_k = path(True)
        if ragged_decode_attention.launches == 0 or flash_attention.launches == 0:
            fail("the kernel path of the comparison did not launch the kernels")
        f_p, h_p, lg_p, toks_p = path(False, forced=toks_k)
    rt.model.set_use_kernels(True)
    for name, t in (("video tokens", f_k), ("prefill hidden", h_k), ("logits", lg_k)):
        if not torch.isfinite(t).all():
            fail(f"non-finite {name} on the kernel path")
    cos_f, cos_h = cosine(f_k, f_p), cosine(h_k, h_p)
    row_cos = torch.nn.functional.cosine_similarity(h_k.float(), h_p.float(), dim=-1)
    step_cos = [cosine(a, b) for a, b in zip(lg_k, lg_p)]
    # a step's greedy token may differ only where the plain path's top two
    # logits lie closer than the two paths' largest logit difference there
    flips = []
    for i, (a, b) in enumerate(zip(lg_k, lg_p)):
        gap = float(b.max() - b[toks_k[i]])
        if toks_k[i] != toks_p[i] and gap > float((a - b).abs().max()):
            flips.append(i)
    same = sum(x == y for x, y in zip(toks_k, toks_p))
    log(f"  kernel vs plain path: video tokens cosine {cos_f:.5f}, final prefill "
        f"hidden cosine {cos_h:.5f} (min per position {float(row_cos.min()):.5f}), "
        f"decode logits cosine min {min(step_cos):.5f} over {n_steps} steps, greedy "
        f"tokens equal {same}/{n_steps}; tolerance cosine >= {PATH_COS}: bf16 rounds "
        "at other places through 26 SigLIP and 28 Qwen2 layers of random weights")
    if min(cos_f, cos_h, *step_cos) < PATH_COS:
        fail("kernel path and plain path disagree at full width")
    if flips:
        fail(f"greedy tokens differ beyond a near tie at decode steps {flips}")
    return launches


# ------------------------------------------------------------------ main --

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true", help="stop after phase 2")
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
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    log("phase 2: kernels vs plain (bf16, main-path shapes)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    timer = Timer(dev)
    kernels = [kernel_hiera(dev, timer, gen), kernel_flash(dev, timer, gen),
               kernel_decode(dev, timer, gen)]
    for k in kernels:
        log(f"  {k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}) at {k['shape']}")
    del timer
    torch.cuda.empty_cache()

    if args.kernels_only:
        print(json.dumps({"kernels": kernels}), flush=True)
        log("stopped after phase 2 (--kernels-only): no result")
        return 0
    log("phase 3: full-width mm_infer on the card")
    from ufvideo_tpu_torch.configs import UFVideoConfig

    launches = run_path(dev, args.seed, UFVideoConfig())
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["check"] = "ok"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
