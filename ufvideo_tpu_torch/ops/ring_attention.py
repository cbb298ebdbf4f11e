"""Ring attention: sequence parallelism over one mesh axis (mirrors
``ufvideo_tpu/ops/ring_attention.py``).

Each rank holds one contiguous block of the sequence: its queries and its
keys / values. The K/V blocks travel around the ring (point-to-point sends
to the next rank, receives from the previous one) while each rank runs the
online-softmax step of ``_ring_attention_local`` in float32 against the
block it holds: global column indices ``src · Skv + arange`` for the causal
and ``kv_lens`` masks, ``m_safe = max(m, NEG_INF / 2)``, n − 1 rotations
with the last block peeled, ``l`` clamped at 1e-30.

Point-to-point ops carry no gradient, so the op is one autograd function.
The forward saves the output and each row's log-sum-exp; the backward sends
K/V around the ring again, each block with its dK / dV accumulators, and a
last rotation hands the accumulators back to the rank that owns the block.
A row with no valid key reads 0 forward and passes no gradient, as JAX's
gradient of the same arithmetic does.

Plain PyTorch, as the JAX version is XLA: there is no Pallas kernel here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

_NEG_INF = float(torch.finfo(torch.float32).min)


def _rotate(group, *ts):
    """Send each tensor to the next rank of ``group`` and return what the
    previous rank sent."""
    if group is None or dist.get_world_size(group) == 1:
        return ts
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    out = [torch.empty_like(t) for t in ts]
    ops = []
    for t, o in zip(ts, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(out)


def _scores(qf, kb, my, src, sq, skv, causal, kv_lens):
    """Masked scores [B, Hkv, G, Sq, Skv] of the local queries against the
    block that came from rank ``src``."""
    dev = qf.device
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb.float())
    col = src * skv + torch.arange(skv, device=dev)
    if causal:
        row = my * sq + torch.arange(sq, device=dev)
        s = torch.where((col[None, :] <= row[:, None])[None, None, None], s, _NEG_INF)
    if kv_lens is not None:
        valid = col[None, :] < kv_lens[:, None].to(dev)
        s = torch.where(valid[:, None, None, None], s, _NEG_INF)
    return s


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens, group, causal, scale):
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        g = hq // hkv
        n = dist.get_world_size(group) if group is not None else 1
        my = dist.get_rank(group) if group is not None else 0
        qf = (q.float() * scale).reshape(b, sq, hkv, g, d)
        m = torch.full((b, hkv, g, sq), _NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, g, sq), device=q.device)
        acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
        kb, vb = k, v
        for i in range(n):
            src = (my - i) % n
            s = _scores(qf, kb, my, src, sq, skv, causal, kv_lens)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = m_new.clamp_min(_NEG_INF / 2)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(m.clamp_min(_NEG_INF / 2) - m_safe)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb.float())
            m = m_new
            if i < n - 1:
                kb, vb = _rotate(group, kb, vb)
        l_safe = l.clamp_min(1e-30)
        out = acc / l_safe[..., None]  # [B, Hkv, G, Sq, D]
        lse = m.clamp_min(_NEG_INF / 2) + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        g = hq // hkv
        n = dist.get_world_size(group) if group is not None else 1
        my = dist.get_rank(group) if group is not None else 0
        qf = (q.float() * scale).reshape(b, sq, hkv, g, d)
        do = dout.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)  # [B,Hkv,G,Sq,D]
        delta = (do * out).sum(-1)  # [B, Hkv, G, Sq]
        dq = torch.zeros_like(qf)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros_like(dkb)
        for i in range(n):
            src = (my - i) % n
            s = _scores(qf, kb, my, src, sq, skv, causal, kv_lens)
            p = torch.exp(s - lse[..., None])
            dvb = dvb + torch.einsum("bhgqk,bhgqd->bkhd", p, do)
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do, vb.float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kb.float())
            dkb = dkb + torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
            if i < n - 1:
                kb, vb, dkb, dvb = _rotate(group, kb, vb, dkb, dvb)
        # the accumulators hold block (my + 1)'s gradients: hand them home
        dkb, dvb = _rotate(group, dkb, dvb)
        dq = (dq * scale).reshape(b, sq, hq, d)
        return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None, None, None


def ring_attention(
    q: torch.Tensor,  # [B, Sq_local, Hq, D]: this rank's block of the sequence
    k: torch.Tensor,  # [B, Skv_local, Hkv, D]
    v: torch.Tensor,
    mesh,
    axis: str = "fsdp",
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,  # [B] valid keys of the whole sequence
) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh[axis]`` (``mesh`` a
    ``DeviceMesh``, or None for one rank). Each rank passes its own block:
    rank r of the axis holds positions ``[r·S_local, (r+1)·S_local)``. Where
    another axis splits the batch (JAX's ``batch_axis``), each rank passes
    its own rows and their ``kv_lens``. Returns this rank's block of the
    output, in ``q``'s dtype."""
    d = q.shape[-1]
    scale = float(d ** -0.5) if scale is None else float(scale)
    group = mesh.get_group(axis) if mesh is not None else None
    return _RingAttention.apply(q, k, v, kv_lens, group, causal, scale)


def ring_attention_plain(q, k, v, *, causal=False, scale=None, kv_lens=None):
    """The same attention over the whole sequence on one rank, masked
    softmax in float32: the plain version the ring is held against."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    scale = float(d ** -0.5) if scale is None else float(scale)
    kr = k.float().repeat_interleave(hq // hkv, dim=2)
    vr = v.float().repeat_interleave(hq // hkv, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kr)
    col = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((b, 1, s, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (col[None, :] <= torch.arange(s, device=q.device)[:, None])
    if kv_lens is not None:
        mask = mask & (col[None, None, None, :] < kv_lens[:, None, None, None])
    sc = torch.where(mask, sc, _NEG_INF)
    p = torch.softmax(sc, dim=-1) * mask.any(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)
