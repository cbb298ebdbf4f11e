"""One whole pre-LN transformer block: hand-written CUDA kernels + the
plain version.

Replaces the TPU kernel ``ufvideo_tpu/ops/hiera_block.py``
``fused_hiera_block`` (Pallas ``_forward`` / ``_kernel`` / ``_block_body``):
LN1 (f32) → qkv → multi-head attention inside each window → proj +
residual → LN2 (f32) → fc1 → GELU → fc2 + residual. SigLIP runs it with one
729-token window per frame and ``gelu_tanh``; Hiera will use ``gelu_exact``.
The CUDA source is ``csrc/hiera_block.cu`` (LayerNorm, a tiled bf16 GEMM
with fused bias / GELU / residual epilogue, and the attention of
``csrc/attention_tile.cuh``); its header comment gives the bound on an H100
(tensor-core operations) and the design. The math is that of the JAX
``_reference``; the TPU kernel's 128-lane head padding and bf16 ``exp2``
softmax are not carried over.

``params`` = (ln1_s, ln1_b, wqkv [C, 3·H·hd], bqkv, wproj [H·hd, C], bproj,
ln2_s, ln2_b, w1 [C, mlp], b1, w2 [mlp, C], b2), weights in [in, out]
layout, qkv columns ordered [q heads | k heads | v heads].
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build

_ACT_CODES = {"gelu_tanh": 1, "gelu_exact": 2}


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    # erf GELU; the JAX kernel's A-S 7.1.26 erf differs by at most 1.5e-7
    return F.gelu(x, approximate="none")


_ACTS = {"gelu_tanh": _gelu_tanh, "gelu_exact": _gelu_exact}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("hiera_block")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hiera_block_bf16.argtypes = [p] * 19 + [i] * 7 + [f, p]
    lib.hiera_block_bf16.restype = ctypes.c_int
    return lib


def _layernorm(x32, scale, bias, eps):
    mean = x32.mean(dim=-1, keepdim=True)
    c = x32 - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * scale.float() + bias.float()


def fused_hiera_block_plain(
    x: torch.Tensor,  # [N, S, C] window-major tokens
    params: tuple,
    num_heads: int,
    head_dim: int,
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX ``_reference``)."""
    (ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2,
     b2) = params
    n, s, _ = x.shape
    dtype = x.dtype
    hw = num_heads * head_dim
    xn = _layernorm(x.float(), ln1_s, ln1_b, eps).to(dtype)
    qkv = (xn @ wqkv.to(dtype) + bqkv.to(dtype)).to(dtype)
    qh, kh, vh = (
        qkv[..., i * hw:(i + 1) * hw].reshape(n, s, num_heads, head_dim).float()
        for i in range(3)
    )
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh) * head_dim ** -0.5
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("nhqk,nkhd->nqhd", probs.to(dtype).float(), vh).to(dtype)
    att = (o.reshape(n, s, hw) @ wproj.to(dtype) + bproj.to(dtype)).to(dtype)
    x1 = x + att
    xm = _layernorm(x1.float(), ln2_s, ln2_b, eps).to(dtype)
    h = _ACTS[act]((xm @ w1.to(dtype) + b1.to(dtype)).float()).to(dtype)
    return x1 + (h @ w2.to(dtype) + b2.to(dtype)).to(dtype)


def fused_hiera_block(
    x: torch.Tensor,
    params: tuple,
    num_heads: int,
    head_dim: int,
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernels
    (bf16 activations and weights; C, head dim and mlp multiples of 8)."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return fused_hiera_block_plain(x, params, num_heads, head_dim, act, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_hiera_block: unsupported device {x.device}")
    (ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2,
     b2) = params
    n, s, c = x.shape
    hw = num_heads * head_dim
    mlp = w1.shape[1]
    mats = (x, wqkv, wproj, w1, w2)
    if not all(t.dtype == torch.bfloat16 for t in mats):
        raise TypeError("fused_hiera_block kernel takes bf16 activations and weights")
    expect = ((c, 3 * hw), (hw, c), (c, mlp), (mlp, c))
    if tuple(tuple(t.shape) for t in (wqkv, wproj, w1, w2)) != expect:
        raise ValueError(f"weight shapes do not match x {x.shape}, {num_heads} heads")
    if c % 8 or head_dim % 8 or mlp % 8 or head_dim > 128:
        raise ValueError(f"unsupported dims C={c} head dim={head_dim} mlp={mlp}")
    x = x.contiguous()
    mats = [t.contiguous() for t in (wqkv, wproj, w1, w2)]
    vecs = [t.float().contiguous() for t in (ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b1, b2)]
    rows = n * s
    empty = functools.partial(torch.empty, dtype=x.dtype, device=x.device)
    out = empty((n, s, c))
    xn, qkv, att, x1, hmid = (
        empty((rows, c)), empty((rows, 3 * hw)), empty((rows, hw)),
        empty((rows, c)), empty((rows, mlp)),
    )
    lib = _lib()
    code = lib.hiera_block_bf16(
        x.data_ptr(), out.data_ptr(),
        vecs[0].data_ptr(), vecs[1].data_ptr(), mats[0].data_ptr(), vecs[2].data_ptr(),
        mats[1].data_ptr(), vecs[3].data_ptr(), vecs[4].data_ptr(), vecs[5].data_ptr(),
        mats[2].data_ptr(), vecs[6].data_ptr(), mats[3].data_ptr(), vecs[7].data_ptr(),
        xn.data_ptr(), qkv.data_ptr(), att.data_ptr(), x1.data_ptr(), hmid.data_ptr(),
        n, s, c, num_heads, head_dim, mlp, _ACT_CODES[act], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "fused_hiera_block")
    fused_hiera_block.launches += 1
    return out


fused_hiera_block.launches = 0

