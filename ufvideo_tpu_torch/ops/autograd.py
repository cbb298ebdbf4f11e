"""Gradients through the hand-written kernels.

The CUDA kernels compute forwards only, and their wrappers fill fresh
tensors through ctypes, so their outputs carry no autograd graph. The JAX
package gives each float kernel a ``custom_vjp`` whose backward recomputes
the function through XLA (``ufvideo_tpu/ops/attention.py`` and the blocks of
``ops/hiera_block.py``, ``window_attention.py``, ``vit_attention.py``);
``kernel_with_plain_backward`` is the same rule here: the forward launches
the kernel, the backward recomputes the wrapper's plain PyTorch version
under ``torch.enable_grad()`` and differentiates that. No backward kernel
exists, as none exists in the JAX package.

The wrappers that have no such rule in the JAX package (the decode pair,
the quantised products, the probe, the W8A8 blocks) call
``refuse_grad``: on a CUDA input that requires a gradient they raise,
rather than return a tensor cut off from the graph.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _flatten(tree: Any, leaves: List[Any]):
    """Leaves of nested tuples / lists / dicts in order, and a function that
    rebuilds the nesting from a new list of leaves."""
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t, leaves) for t in tree]
        kind = type(tree)
        return lambda it: kind(p(it) for p in parts)
    if isinstance(tree, dict):
        parts = {k: _flatten(v, leaves) for k, v in tree.items()}
        return lambda it: {k: p(it) for k, p in parts.items()}
    leaves.append(tree)
    return lambda it: next(it)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a graph through any of ``tensors``."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class _PlainBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, rebuild, others, slots, *tensors):
        ctx.plain, ctx.rebuild, ctx.others, ctx.slots = plain, rebuild, others, slots
        ctx.save_for_backward(*tensors)
        args, kwargs = _rebuild(rebuild, others, slots, tensors)
        return kernel(*args, **kwargs)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in saved]
        args, kwargs = _rebuild(ctx.rebuild, ctx.others, ctx.slots, inputs)
        # a named span, so a profile can tell the recompute's device time
        with torch.profiler.record_function("plain recompute"), torch.enable_grad():
            out = ctx.plain(*args, **kwargs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True))
        return (None,) * 5 + tuple(next(grads) if t.requires_grad else None for t in inputs)


def _rebuild(rebuild, others, slots, tensors):
    """The call's (args, kwargs): the non-tensor leaves ``others`` with the
    tensors put back at their ``slots``."""
    leaves = list(others)
    for i, t in zip(slots, tensors):
        leaves[i] = t
    return rebuild(iter(leaves))


def kernel_with_plain_backward(kernel: Callable, plain: Callable, *args, **kwargs):
    """``kernel(*args, **kwargs)``; when autograd records a graph through any
    tensor in the arguments (nested tuples and lists of tensors included),
    the call becomes one node whose backward is that of ``plain`` (same
    arguments, same function) recomputed from the saved inputs."""
    if not torch.is_grad_enabled():  # inference: no tree walk on the hot path
        return kernel(*args, **kwargs)
    leaves: List[Any] = []
    rebuild = _flatten((args, kwargs), leaves)
    slots: Tuple[int, ...] = tuple(
        i for i, t in enumerate(leaves) if isinstance(t, torch.Tensor))
    tensors = [leaves[i] for i in slots]
    if not needs_grad(*tensors):
        return kernel(*args, **kwargs)
    others = tuple(None if i in slots else t for i, t in enumerate(leaves))
    return _PlainBackward.apply(kernel, plain, rebuild, others, slots, *tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel with no backward would be asked for one."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward: its kernel computes a forward only, and the JAX "
            "package defines no gradient for it here; call it under torch.no_grad()")
