"""Int8 / int4 quantisation on tensors (mirrors ``ufvideo_tpu/quant.py``).

Weight-only for the LLM (symmetric per-output-column int8, or packed int4
with per-(input-group, column) scales), weight + activation (W8A8) for the
SigLIP tower and SAM2's Hiera trunk. Every function runs on the device its input lies on.

The three row quantisers of the JAX package differ on purpose and are kept
apart here, each with the formula as written there:

- ``quantize_rows``: scale = max(amax / 127, 1e-8), no clip
  (``ufvideo_tpu/quant.py``, the unfused ``W8A8Dense``);
- ``ops.hiera_block.quant_rows_f32``: scale = max(amax · (1 / 127), 1e-8)
  (the fused W8A8 block);
- ``models.qwen2.quantize_kv``: scale = amax / 127, the 1e-12 floor inside
  the division (the int8 KV cache).

All round half to even (``torch.round``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch


def quant_bits(quant) -> int:
    """Bits of a ``quant_llm`` value: 4 for 4 / 'int4' / '4bit', else 8."""
    return 4 if quant in (4, "int4", "4bit") else 8


def quantize_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] float kernel → {'q': int8, 'scale': f32 [..., out]};
    the reduction runs over the contraction (in) axis."""
    wf = w.to(torch.float32)
    scale = wf.abs().amax(dim=-2) / 127.0
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
    scale = wg.abs().amax(dim=-2) / 7.0
    scale = scale.clamp_min(1e-8)
    q = torch.round(wg / scale[..., None, :]).clamp(-7, 7)
    return {"q": pack_int4(q.reshape(*lead, din, dout)), "scale": scale}


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of activations: [..., d] float → (int8
    [..., d], f32 scales [..., 1])."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (amax / 127.0).clamp_min(1e-8)
    return torch.round(xf / scale).to(torch.int8), scale


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
