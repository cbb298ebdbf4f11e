"""Flash attention forward: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``ufvideo_tpu/ops/flash_attention.py``
``flash_attention`` (Pallas ``_kernel``). The CUDA source is
``csrc/flash_attention.cu`` over ``csrc/attention_tile.cuh``; its header
comment gives what bounds it on an H100 (tensor-core operations at the
Qwen2-7B prefill shape) and how the design meets that. Callers: Qwen2
prefill and full forward (head dim 128, causal), Hiera global blocks (head
dim 72), SAM2 memory attention (one head of dim 256, ``kv_mask`` over the
memory slots) and the mask decoder's small attentions (head dim 16 / 32).

Causal alignment contract (as in the TPU kernel): query row r sits at
position r + (Skv - Sq), a static offset from the buffer end; ``kv_lens``
only masks tail padding and does not shift the diagonal.

When the query tiles of a call cannot fill the card (the mask decoder's 9
queries, SAM2's one-head memory attention), ``split_plan`` cuts the keys
into chunks of whole key tiles; the kernel runs one block per (query tile,
head, batch, chunk) and a second pass merges the chunks' partial sums in a
fixed order (``merge_splits_plain`` is that merge in plain PyTorch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .attention import xla_attention
from .autograd import kernel_with_plain_backward


# The kernel's tiles: 64 query rows a consumer warpgroup, two warpgroups a
# block when Sq > 64; keys a step by head dim (csrc/attention_tile.cuh
# AttnCfg, whose library reports its own through flash_attention_block_kv)
BLOCK_Q_ROWS = 64
MAX_SPLITS = 16


def block_q(sq: int) -> int:
    return 2 * BLOCK_Q_ROWS if sq > BLOCK_Q_ROWS else BLOCK_Q_ROWS


def block_kv(d: int) -> int:
    return 64 if d > 128 else 128


def split_plan(b: int, hq: int, sq: int, skv: int, d: int, sm_count: int):
    """(splits, chunk) for a call: split s takes keys [s·chunk, (s+1)·chunk),
    whole key tiles each. A grid of query tiles that fills the card (one
    block an SM) is not split; otherwise the keys are cut into as many
    chunks as keep the grid within one wave, at most ``MAX_SPLITS``."""
    bn = block_kv(d)
    tiles = -(-sq // block_q(sq)) * hq * b
    n_kv = -(-skv // bn)
    splits = min(sm_count // max(tiles, 1), n_kv, MAX_SPLITS)
    if tiles >= sm_count or splits < 2:
        return 1, n_kv * bn
    per = -(-n_kv // splits)
    return -(-n_kv // per), per * bn


def flash_attention_partials_plain(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    splits: int,
    chunk: int,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """The kernel's first pass with the keys split, in plain PyTorch: for
    split s, over keys [s·chunk, (s+1)·chunk), the unnormalised output
    Σ exp(score − m)·v, its running max m and sum Σ exp(score − m), with
    scores in f32 masked to finfo(f32).min, m clamped at min/2 before the
    exponent, and the probabilities rounded to v's type for the product, as
    the kernel does. → (part_o [splits, B, Hq, Sq, D], part_m, part_l
    [splits, B, Hq, Sq])."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    neg = torch.finfo(torch.float32).min
    kr = k.repeat_interleave(hq // hkv, dim=2).float()
    vr = v.repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    col = torch.arange(skv, device=q.device)
    valid = torch.ones(b, 1, sq, skv, dtype=torch.bool, device=q.device)
    if kv_lens is not None:
        valid = valid & (col < kv_lens.to(q.device)[:, None])[:, None, None, :]
    if kv_mask is not None:
        valid = valid & kv_mask.to(torch.bool)[:, None, None, :]
    if causal:
        valid = valid & ((col[None, :] - (skv - sq)) <= torch.arange(sq, device=q.device)[:, None])
    logits = logits.masked_fill(~valid, neg)
    part_o = torch.zeros(splits, b, hq, sq, d, device=q.device)
    part_m = torch.full((splits, b, hq, sq), neg, device=q.device)
    part_l = torch.zeros(splits, b, hq, sq, device=q.device)
    for i in range(splits):
        lo, hi = i * chunk, min((i + 1) * chunk, skv)
        if lo >= hi:
            continue
        m = logits[..., lo:hi].amax(dim=-1)
        p = torch.exp(logits[..., lo:hi] - m.clamp_min(neg / 2)[..., None])
        part_m[i], part_l[i] = m, p.sum(dim=-1)
        part_o[i] = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vr[:, lo:hi].float())
    return part_o, part_m, part_l


def merge_splits_plain(part_o: torch.Tensor, part_m: torch.Tensor,
                       part_l: torch.Tensor) -> torch.Tensor:
    """The kernel's merge of split partial sums: ``part_o`` [splits, ..., D]
    unnormalised outputs, ``part_m`` / ``part_l`` [splits, ...] running max
    and sum. Each max is clamped at finfo(f32).min / 2, so a split that saw
    no visible key (sum 0) gets weight 0 and the row stays finite."""
    floor = torch.finfo(torch.float32).min / 2
    mc = part_m.clamp_min(floor)
    w = torch.exp(mc - mc.amax(dim=0, keepdim=True))
    l = (w * part_l).sum(dim=0)
    return (w[..., None] * part_o).sum(dim=0) / l.clamp_min(1e-30)[..., None]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_attention_bf16.argtypes = (
        [p] * 8 + [i] * 6 + [ll] * 12 + [f, i, i, i, p]
    )
    lib.flash_attention_bf16.restype = ctypes.c_int
    lib.flash_attention_block_kv.argtypes = [i]
    lib.flash_attention_block_kv.restype = i
    for d in (16, 32, 64, 80, 128, 256):
        if lib.flash_attention_block_kv(d) != block_kv(d):
            raise RuntimeError("csrc/attention_tile.cuh and split_plan disagree on the key tile")
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (float32 softmax)."""
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.bool)[:, None, :].expand(-1, q.shape[1], -1)
    return xla_attention(
        q, k, v, causal=causal, kv_lens=kv_lens, mask=mask, scale=scale
    )


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Skv, Hkv, D]
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens: Optional[torch.Tensor] = None,  # [B] int
    kv_mask: Optional[torch.Tensor] = None,  # [B, Skv] bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention forward. CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16, head dim a multiple of
    8 up to 256), whose gradient is the plain version's, recomputed
    (``ops.autograd``)."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, kv_lens=kv_lens, kv_mask=kv_mask, scale=scale
        )
    return kernel_with_plain_backward(
        _flash_attention_cuda, flash_attention_plain, q, k, v,
        causal=causal, kv_lens=kv_lens, kv_mask=kv_mask, scale=scale)


def _flash_attention_cuda(q, k, v, *, causal, kv_lens, kv_mask, scale):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash_attention kernel takes bf16 q / k / v")
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {q.shape} k {k.shape} v {v.shape}")
    if hq % hkv or d > 256 or min(b, sq, skv) == 0:
        raise ValueError(f"unsupported shape q {q.shape} k {k.shape}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a unit stride along head dim")
    if d % 8 or not all(
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
        for t in (q, k, v)
    ):
        raise ValueError(
            "flash_attention reads rows as 16-byte vectors: head dim and strides "
            "must be multiples of 8 and q / k / v 16-byte aligned"
        )
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lens = (
        kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_lens is not None else None
    )
    mask = (
        kv_mask.to(device=q.device, dtype=torch.uint8).contiguous()
        if kv_mask is not None else None
    )
    scale = float(d ** -0.5) if scale is None else float(scale)
    lib = _lib()
    splits, chunk = split_plan(b, hq, sq, skv, d, _sm_count(q.device.index or 0))
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((splits, b, hq, sq, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((splits, b, hq, sq, 2), dtype=torch.float32, device=q.device)
    code = lib.flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lens.data_ptr() if lens is not None else None,
        mask.data_ptr() if mask is not None else None,
        part_o.data_ptr() if part_o is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        b, sq, skv, hq, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        scale, int(causal), splits, chunk, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, code, "flash_attention")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
