"""Pipeline parallelism over the decoder layers (mirrors
``ufvideo_tpu/parallel/pipeline.py``): a GPipe fill-drain schedule over the
``pipe`` mesh axis.

Stage s of p runs the L/p contiguous layers ``[s·L/p, (s+1)·L/p)``. The
rows are split into M microbatches; at tick t (M + p − 1 ticks) stage s runs
microbatch t − s and hands its output to stage s + 1 (point-to-point over
the pipe group), and the last stage's outputs go to every stage, as JAX's
final ``psum`` does, so the code after the backbone runs alike on every
stage. The input is taken alike on every stage too; stage 0 feeds it in.

Point-to-point ops carry no gradient, so the schedule is one autograd
function with a backward fixed up front: the reverse fill-drain, the last
stage seeding each microbatch with the output's gradient, each stage
running its saved graphs and handing the input gradient to stage s − 1,
stage 0's input gradients going to every stage. The layers' gradients are
the dense stack's, summed over microbatches, on the stage that holds them:
``partition.shard_params`` keeps a stage's layers and moves the others to
the ``meta`` device, and FSDP shards the kept ones over data / fsdp.
``remat`` checkpoints each layer as the dense backbone does
(``cfg.remat``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint


def stage_range(num_layers: int, stages: int, stage: int) -> range:
    """The layers stage ``stage`` of ``stages`` runs."""
    if num_layers % stages != 0:
        raise ValueError(f"{num_layers} layers not divisible by pipe={stages}")
    per = num_layers // stages
    return range(stage * per, (stage + 1) * per)


def _exchange(group, send: Optional[torch.Tensor], to: int, recv_like: Optional[torch.Tensor],
              frm: int) -> Optional[torch.Tensor]:
    """Send ``send`` to pipe rank ``to`` and receive a tensor like
    ``recv_like`` from ``frm``, in one batch (either may be None)."""
    ops, out = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), dist.get_global_rank(group, to),
                              group))
    if recv_like is not None:
        out = torch.empty_like(recv_like)
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, run, group, n_mb, grad):
        p, s = dist.get_world_size(group), dist.get_rank(group)
        xs = x.chunk(n_mb)
        saved_in: List = [None] * n_mb
        saved_out: List = [None] * n_mb
        outs: List = [None] * n_mb
        recv = None
        for t in range(n_mb + p - 1):
            mb = t - s
            out = None
            if 0 <= mb < n_mb:
                inp = (xs[mb] if s == 0 else recv).detach().requires_grad_(grad)
                with torch.set_grad_enabled(grad):
                    out = run(inp, mb)
                saved_in[mb], saved_out[mb] = inp, out
                if s == p - 1:
                    outs[mb] = out.detach()
            prev_mb = t - (s - 1)  # what stage s - 1 ran at this tick
            recv = _exchange(group, out.detach() if out is not None and s < p - 1 else None,
                             s + 1, xs[0] if s > 0 and 0 <= prev_mb < n_mb else None, s - 1)
        full = torch.cat(outs) if s == p - 1 else torch.empty_like(x)
        dist.broadcast(full, dist.get_global_rank(group, p - 1), group=group)
        ctx.state = (saved_in, saved_out, group, n_mb)
        return full

    @staticmethod
    def backward(ctx, grad_full):
        saved_in, saved_out, group, n_mb = ctx.state
        p, s = dist.get_world_size(group), dist.get_rank(group)
        gs = grad_full.contiguous().chunk(n_mb)
        in_grads: List = [None] * n_mb
        recv = None
        for t in range(n_mb + p - 1):
            mb = t - (p - 1 - s)
            ig = None
            if 0 <= mb < n_mb:
                g = gs[mb] if s == p - 1 else recv
                torch.autograd.backward(saved_out[mb], g)
                ig = saved_in[mb].grad
                if ig is None:
                    ig = torch.zeros_like(saved_in[mb])
                if s == 0:
                    in_grads[mb] = ig
                saved_in[mb] = saved_out[mb] = None
            next_mb = t - (p - 2 - s)  # what stage s + 1 ran at this tick
            recv = _exchange(group, ig if ig is not None and s > 0 else None, s - 1,
                             gs[0] if s < p - 1 and 0 <= next_mb < n_mb else None, s + 1)
        grad_x = torch.cat(in_grads) if s == 0 else torch.empty_like(grad_full)
        dist.broadcast(grad_x, dist.get_global_rank(group, 0), group=group)
        ctx.state = None
        return grad_x, None, None, None, None


def pipeline_apply(layer_fn: Callable[[int, torch.Tensor, int], torch.Tensor], num_layers: int,
                   x: torch.Tensor, mesh, *, pipe_axis: str = "pipe",
                   num_microbatches: int, remat: bool = False) -> torch.Tensor:
    """Run ``x`` [B, ...] through all ``num_layers`` layers, pipelined over
    ``mesh[pipe_axis]``: ``layer_fn(i, h, mb)`` applies layer i to
    microbatch mb's rows (the B / M rows ``mb·B/M``…). Every stage passes the
    same ``x`` and gets the same result."""
    group = mesh.get_group(pipe_axis)
    p, s = dist.get_world_size(group), dist.get_rank(group)
    layers = stage_range(num_layers, p, s)
    if x.shape[0] % num_microbatches != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by microbatches {num_microbatches}")

    def run(h, mb):
        for i in layers:
            if remat and torch.is_grad_enabled():
                h = checkpoint(layer_fn, i, h, mb, use_reentrant=False)
            else:
                h = layer_fn(i, h, mb)
        return h

    grad = torch.is_grad_enabled()
    if grad and not x.requires_grad:  # the layers' gradients come from this node's backward
        x = x.detach().requires_grad_(True)
    return _GPipe.apply(x, run, group, num_microbatches, grad)


def pipeline_backbone(lm, input_embeds: torch.Tensor, positions: torch.Tensor,
                      seq_lens: Optional[torch.Tensor], mesh, *, pipe_axis: str = "pipe",
                      num_microbatches: int, remat: bool = False) -> torch.Tensor:
    """The Qwen2 train-mode backbone of ``lm`` (a ``Qwen2LM``) pipelined:
    final hidden states [B, S, hidden] after the output RMSNorm, the
    pipelined ``lm.backbone(..., mode="train")[0]``."""
    from ..ops.rope import rope_cos_sin

    b, s, _ = input_embeds.shape
    m = num_microbatches
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    if seq_lens is None:
        seq_lens = torch.full((b,), s, dtype=torch.int32, device=input_embeds.device)
    cos, sin = rope_cos_sin(positions, lm.cfg.head_dim, lm.cfg.rope_theta)
    cache_len = torch.zeros((b,), dtype=torch.int64, device=input_embeds.device)
    rows = b // m
    pick = lambda t, mb: t[mb * rows:(mb + 1) * rows]

    def layer_fn(i, h, mb):
        return lm.layers[i](h, pick(cos, mb), pick(sin, mb), pick(seq_lens, mb),
                            pick(cache_len, mb), None, "train", None, i)

    x = pipeline_apply(layer_fn, len(lm.layers), input_embeds.to(lm.dtype), mesh,
                       pipe_axis=pipe_axis, num_microbatches=m, remat=remat)
    return lm.norm(x)
