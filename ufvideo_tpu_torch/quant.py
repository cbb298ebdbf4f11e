"""Int8 / int4 quantisation on tensors (mirrors ``ufvideo_tpu/quant.py``).

Weight-only for the LLM (symmetric per-output-column int8, or packed int4
with per-(input-group, column) scales), weight + activation (W8A8) for the
SigLIP tower and SAM2's Hiera trunk. Every function runs on the device its input lies on.

The three row quantisers of the JAX package differ on purpose and are kept
apart here, each with the formula as written there:

- ``quantize_rows``: scale = max(amax / 127, 1e-8), no clip
  (``ufvideo_tpu/quant.py``, the unfused ``W8A8Dense``, here
  ``W8A8Linear``);
- ``ops.hiera_block.quant_rows_f32``: scale = max(amax · (1 / 127), 1e-8)
  (the fused W8A8 block);
- ``models.qwen2.quantize_kv``: scale = amax / 127, the 1e-12 floor inside
  the division (the int8 KV cache).

All round half to even (``torch.round``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def quant_bits(quant) -> int:
    """Bits of a ``quant_llm`` value: 4 for 4 / 'int4' / '4bit', else 8."""
    return 4 if quant in (4, "int4", "4bit") else 8


# 0-d divisors, one per (device, value), made once: see ``div_exact``
_DIVISORS: Dict[Tuple[torch.device, float], torch.Tensor] = {}


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a division on every device: with a Python number as the
    divisor, the card computes a product with its reciprocal, at times one
    ulp off the division on the CPU and in JAX (a quantised weight's scale,
    and so its int8 steps, would differ between a load on the card and one
    on the CPU). A 0-d tensor on ``x``'s device is divided by as any tensor
    is; it is kept, so that a call launches nothing but the division (the
    copy that makes it waits for the card, so every stream may read it)."""
    d = _DIVISORS.get((x.device, c))
    if d is None:
        d = _DIVISORS.setdefault(
            (x.device, c), torch.tensor(c, dtype=torch.float32, device=x.device))
    return x / d


def quantize_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] float kernel → {'q': int8, 'scale': f32 [..., out]};
    the reduction runs over the contraction (in) axis."""
    wf = w.to(torch.float32)
    scale = div_exact(wf.abs().amax(dim=-2), 127.0)
    scale = scale.clamp_min(1e-8)
    q = torch.round(wf / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Values in [-8, 7], [..., in, out] → packed int8 [..., in/2, out]:
    row 2i biased by +8 in the low nibble, row 2i+1 signed in the high."""
    qi = q.to(torch.int8)
    lo = (qi[..., 0::2, :] + 8) & 0xF
    hi = qi[..., 1::2, :] << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(q8: torch.Tensor) -> torch.Tensor:
    """Packed int8 [..., in/2, out] → int8 values in [-8, 7] [..., in, out]
    (low nibble de-biased by 8, high nibble sign-extended)."""
    lo = (q8 & 0xF) - 8
    hi = q8 >> 4  # arithmetic on int8
    *lead, d2, dout = q8.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, d2 * 2, dout)


def quantize_kernel4(w: torch.Tensor, group: int = 64) -> Dict[str, torch.Tensor]:
    """[..., in, out] float kernel → {'q': packed int8 [..., in/2, out],
    'scale': f32 [..., in/group, out]}, symmetric, clipped to ±7."""
    wf = w.to(torch.float32)
    *lead, din, dout = wf.shape
    if din % group or din % 2:
        raise ValueError(f"in dim {din} is not a multiple of group {group} and 2")
    g = din // group
    wg = wf.reshape(*lead, g, group, dout)
    scale = div_exact(wg.abs().amax(dim=-2), 7.0)
    scale = scale.clamp_min(1e-8)
    q = torch.round(wg / scale[..., None, :]).clamp(-7, 7)
    return {"q": pack_int4(q.reshape(*lead, din, dout)), "scale": scale}


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of activations: [..., d] float → (int8
    [..., d], f32 scales [..., 1])."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = div_exact(amax, 127.0).clamp_min(1e-8)
    return torch.round(xf / scale).to(torch.int8), scale


def int8_kernel(in_dim: int, out_dim: int) -> nn.Parameter:
    """A frozen int8 [in, out] weight of ``w8a8_linear``, stored K-contiguous
    (strides (1, in)), the layout ``torch._int_mm`` takes its second operand
    in: the product reads it as it lies. Values, shape and tree name are the
    JAX ``kernel_q``'s; ``copy_``, ``to`` and ``to_empty`` keep the strides."""
    w = torch.empty(out_dim, in_dim, dtype=torch.int8).t()
    return nn.Parameter(w, requires_grad=False)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] · int8 [K, N] → the exact integer sums as f32. On the
    card ``torch._int_mm`` (s8 × s8 → s32; the JAX package leaves this product
    to XLA, outside any Pallas kernel), with the rows padded past 16 and K and
    N to multiples of 8 as it requires (no shipped width needs it), and b
    K-contiguous (``int8_kernel``; another layout is copied first: row-major,
    cuBLASLt ran this product at a sixth of the bf16 rate on an H100);
    elsewhere in float64, which holds every such sum exactly."""
    if a.device.type != "cuda":
        return (a.double() @ b.double()).float()
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp, np_) != (m, k, n):
        a = F.pad(a, (0, kp - k, 0, mp - m))
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    if not b.t().is_contiguous():
        b = b.t().contiguous().t()
    return torch._int_mm(a.contiguous(), b)[:m, :n].float()


def w8a8_linear(x: torch.Tensor, kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX ``W8A8Dense`` on [..., in] rows: rows quantised per token
    (``quantize_rows``), s8 × s8 → s32, rescaled ``acc · xs · ws`` in f32,
    rounded to ``dtype``, then the bias added in ``dtype``."""
    q, xs = quantize_rows(x)
    lead = x.shape[:-1]
    acc = _int8_matmul(q.reshape(-1, x.shape[-1]), kernel_q)
    y = (acc * xs.reshape(-1, 1) * kernel_scale.float()).to(dtype)
    w8a8_linear.calls += 1
    return y.reshape(*lead, -1) + bias.to(dtype)


w8a8_linear.calls = 0  # products computed, read by chip_smoke.py


class W8A8Linear(nn.Module):
    """Dense layer with int8 weights and activations quantised per row
    (the JAX ``W8A8Dense``, same tree): ``kernel_q`` int8 [in, out],
    ``kernel_scale`` f32 [out], ``bias`` [out] in the layer's type.
    ``unfused``: the layer runs its own product (``forward``), and
    ``kernel_q`` is stored K-contiguous for it (``int8_kernel``); else a
    fused kernel reads it, row-major."""

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype, unfused: bool = True):
        super().__init__()
        self.dtype = dtype
        frozen = lambda shape, dt: nn.Parameter(torch.empty(shape, dtype=dt), requires_grad=False)
        self.kernel_q = int8_kernel(in_dim, out_dim) if unfused \
            else frozen((in_dim, out_dim), torch.int8)
        self.kernel_scale = frozen((out_dim,), torch.float32)
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=dtype))

    @torch.no_grad()
    def set_kernel(self, kernel: torch.Tensor) -> None:
        """Quantise a float [in, out] kernel into this layer."""
        qd = quantize_kernel(kernel)
        self.kernel_q.copy_(qd["q"])
        self.kernel_scale.copy_(qd["scale"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return w8a8_linear(x, self.kernel_q, self.kernel_scale, self.bias, self.dtype)


def _quantize_dense_tree(tree: Dict[str, Any], qfn: Callable) -> Dict[str, Any]:
    """Replace every {'kernel': [..., in, out], ...} dict of the tree with
    {'kernel_q', 'kernel_scale'} (bias kept); the rest is unchanged."""
    out = {}
    for k, v in tree.items():
        if not isinstance(v, dict):
            out[k] = v
        elif "kernel" in v and getattr(v["kernel"], "ndim", 0) >= 2:
            qd = qfn(torch.as_tensor(v["kernel"]))
            nv = {"kernel_q": qd["q"], "kernel_scale": qd["scale"]}
            if "bias" in v:
                nv["bias"] = v["bias"]
            out[k] = nv
        else:
            out[k] = _quantize_dense_tree(v, qfn)
    return out


def quantize_qwen2_params(
    params: Dict[str, Any], bits: int = 8, group: int = 64
) -> Dict[str, Any]:
    """A Qwen2LM parameter tree (flax names, tensor leaves) → the quantised
    layout: every dense kernel of the layers and ``lm_head`` becomes
    ``kernel_q`` / ``kernel_scale``; embeddings and norms stay."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qfn = quantize_kernel if bits == 8 else (lambda w: quantize_kernel4(w, group))
    out = dict(params)
    out["layers"] = _quantize_dense_tree(params["layers"], qfn)
    out["lm_head"] = _quantize_dense_tree({"_": params["lm_head"]}, qfn)["_"]
    return out


def quantize_vision_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """A SigLIP tower's parameter tree → the W8A8 layout: every encoder
    dense kernel becomes ``kernel_q`` / ``kernel_scale``; patch embedding,
    position embedding and norms stay float."""
    return _quantize_dense_tree(params, quantize_kernel)


def quantize_sam2_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """A SAM2 parameter tree → the layout ``SAM2(quant=True)`` takes: only
    the dense kernels of the Hiera trunk's blocks become ``kernel_q`` /
    ``kernel_scale``; patch embedding, FPN neck and the prompt, mask and
    memory heads stay float."""
    out = dict(params)
    trunk = dict(params["image_encoder_trunk"])
    for k, v in trunk.items():
        if k.startswith("blocks_"):
            trunk[k] = _quantize_dense_tree(v, quantize_kernel)
    out["image_encoder_trunk"] = trunk
    return out
