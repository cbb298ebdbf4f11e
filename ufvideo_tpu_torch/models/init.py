"""Random initialisation with the distributions of the flax initialisers
the JAX package uses (the values differ: the generators differ)."""

from __future__ import annotations

import math

import torch

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal (±2σ) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return t.copy_(tmp)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    """flax ``normal(std)`` (and ``nn.Embed``'s default, std 1/sqrt(features))."""
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    tmp.normal_(0.0, std, generator=gen)
    return t.copy_(tmp)


@torch.no_grad()
def linear_(layer: torch.nn.Linear, gen: torch.Generator) -> None:
    """nn.Dense defaults: lecun_normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.weight.shape[1], gen)
    if layer.bias is not None:
        layer.bias.zero_()


@torch.no_grad()
def norm_(layer, gen: torch.Generator = None) -> None:
    """LayerNorm / RMSNorm defaults: unit scale, zero bias."""
    layer.weight.fill_(1.0)
    if getattr(layer, "bias", None) is not None:
        layer.bias.zero_()


@torch.no_grad()
def reset_tree_(root: torch.nn.Module, gen: torch.Generator) -> None:
    """Walk a module tree and give every layer its flax default: dense and
    convolution kernels lecun_normal with zero bias (a transposed
    convolution's fan-in is kh·kw·in, as flax counts it), norms unit scale
    and zero bias; a module's own bare parameters come from its
    ``reset_own_parameters``. A W8A8 holder (``kernel_q``) draws the float
    layer's kernel in the working type, quantises it where it lies and lets
    the float copy go."""
    nn = torch.nn
    for m in root.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.ConvTranspose2d):
            lecun_normal_(m.weight, m.weight.numel() // m.weight.shape[1], gen)
        elif isinstance(getattr(m, "kernel", None), nn.Parameter):  # [in, out] holder
            lecun_normal_(m.kernel, m.kernel.shape[0], gen)
        elif isinstance(getattr(m, "kernel_q", None), nn.Parameter):  # W8A8 [in, out] holder
            w = torch.empty(m.kernel_q.shape, dtype=m.bias.dtype, device=m.kernel_q.device)
            m.set_kernel(lecun_normal_(w, w.shape[0], gen))
        elif isinstance(getattr(m, "scale", None), nn.Parameter):
            m.scale.fill_(1.0)
        elif isinstance(getattr(m, "weight", None), nn.Parameter) and m.weight.dim() == 1:
            m.weight.fill_(1.0)  # LayerNorm
        if isinstance(getattr(m, "bias", None), nn.Parameter):
            m.bias.zero_()
        if hasattr(m, "reset_own_parameters"):
            m.reset_own_parameters(gen)
