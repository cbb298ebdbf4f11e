"""Decode-shaped products on quantised weights: hand-written CUDA kernels,
each beside its plain version.

Each wrapper replaces one TPU kernel of ``ufvideo_tpu/ops/quant_matmul.py``:

- ``int8_matvec`` (Pallas ``_int8_kernel``): ``(x_bf16 @ q_int8, f32
  accumulation) · scale[column]`` → f32, a few rows against an int8 kernel
  [din, dout] with per-column scales.
- ``int4_matmul`` (Pallas ``_int4_kernel``): ``x_bf16 @ bf16(w · s_group)``
  → f32 straight from the packed nibbles of ``quant.pack_int4`` with
  per-(input-group, column) scales. The numbers are those of the JAX
  ``int4_matmul_reference``; the TPU kernel's ``+8`` bias fold is a device of
  that chip and is not carried over.

The CUDA source is ``csrc/quant_matmul.cu``; its header comment gives the
bound on an H100 (the bytes of the weights) and the design (128-column
tiles, the contraction split over blocks, a fixed-order second pass).

Both take at most ``MAX_ROWS`` rows, the JAX package's own limit; a caller
with more rows dequantises and runs one ``torch.matmul`` (``QuantLinear``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..quant import unpack_int4

MAX_ROWS = 32
_ROW_STEP = 32  # weight rows per block step (csrc/quant_matmul.cu kRowStep)
_COLS = 128  # output columns per block
_TARGET_BLOCKS = 528  # 4 blocks on each of the 132 SMs
_MIN_CHUNK = 256  # weight rows per slice of the contraction, at least


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("quant_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_matvec_bf16.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.int4_matmul_bf16.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.int8_matvec_bf16.restype = ctypes.c_int
    lib.int4_matmul_bf16.restype = ctypes.c_int
    return lib


def split_k(rows: int, depth: int, dout: int) -> tuple:
    """(ksplit, kchunk): cut a contraction of ``depth`` weight rows into
    slices so that the grid has about ``_TARGET_BLOCKS`` blocks; a slice is
    a multiple of 32 rows and at least ``_MIN_CHUNK``."""
    tiles = -(-dout // _COLS) * -(-rows // 8)
    want = max(1, min(-(-_TARGET_BLOCKS // tiles), depth // _MIN_CHUNK))
    kchunk = -(-(-(-depth // want)) // _ROW_STEP) * _ROW_STEP
    return -(-depth // kchunk), kchunk


def _rows2d(x: torch.Tensor):
    *lead, din = x.shape
    x2 = x.reshape(-1, din)
    return lead, x2


def int8_matvec_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: bf16 operands, f32 sums."""
    lead, x2 = _rows2d(x)
    acc = x2.to(torch.bfloat16).float() @ q.float()
    return (acc * scale.float()).reshape(*lead, q.shape[1])


def _check(name: str, x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2.device}")
    if q.device != x2.device or s.device != x2.device:
        raise ValueError(f"{name}: weights are not on {x2.device}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes int8 weights and f32 scales")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{name} needs contiguous weights and scales")
    if x2.shape[0] > MAX_ROWS:
        raise ValueError(f"{name} takes at most {MAX_ROWS} rows, got {x2.shape[0]}")


def int8_matvec(
    x: torch.Tensor,  # [..., din]
    q: torch.Tensor,  # [din, dout] int8
    scale: torch.Tensor,  # [dout] f32
) -> torch.Tensor:
    """→ [..., dout] f32. CPU tensors take the plain version; CUDA tensors
    launch the kernel (at most 32 rows; din and dout multiples of 4)."""
    if x.device.type == "cpu":
        return int8_matvec_plain(x, q, scale)
    lead, x2 = _rows2d(x)
    _check("int8_matvec", x2, q, scale)
    rows, din = x2.shape
    dout = q.shape[1]
    if q.shape[0] != din or scale.shape != (dout,) or din % 4 or dout % 4:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)} q {tuple(q.shape)}")
    x2 = x2.to(torch.bfloat16).contiguous()
    ksplit, kchunk = split_k(rows, din, dout)
    out = torch.empty((rows, dout), dtype=torch.float32, device=x.device)
    part = out if ksplit == 1 else torch.empty(
        (ksplit, rows, dout), dtype=torch.float32, device=x.device)
    lib = _lib()
    code = lib.int8_matvec_bf16(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), part.data_ptr(),
        rows, din, dout, ksplit, kchunk, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "int8_matvec")
    int8_matvec.launches += 1
    return out.reshape(*lead, dout)


int8_matvec.launches = 0


def dequantize_int4(q8: torch.Tensor, scales: torch.Tensor, group: int, dtype) -> torch.Tensor:
    """Packed nibbles + group scales → the [din, dout] kernel in ``dtype``
    (``(w · s)`` in f32, then the cast), the values both int4 routes use."""
    dh, dout = q8.shape
    g = 2 * dh // group
    w = unpack_int4(q8).float().reshape(g, group, dout) * scales.float()[:, None, :]
    return w.reshape(2 * dh, dout).to(dtype)


def int4_matmul_plain(
    x: torch.Tensor, q8: torch.Tensor, scales: torch.Tensor, group: int
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX
    ``int4_matmul_reference``): bf16 dequantised weights, f32 sums."""
    lead, x2 = _rows2d(x)
    w = dequantize_int4(q8, scales, group, torch.bfloat16)
    return (x2.to(torch.bfloat16).float() @ w.float()).reshape(*lead, q8.shape[1])


def int4_matmul(
    x: torch.Tensor,  # [..., din]
    q8: torch.Tensor,  # [din/2, dout] packed int8 (quant.pack_int4 layout)
    scales: torch.Tensor,  # [din/group, dout] f32
    group: int,
) -> torch.Tensor:
    """→ [..., dout] f32. CPU tensors take the plain version; CUDA tensors
    launch the kernel (at most 32 rows; din and group multiples of 8, dout
    a multiple of 4)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q8, scales, group)
    lead, x2 = _rows2d(x)
    _check("int4_matmul", x2, q8, scales)
    rows, din = x2.shape
    dh, dout = q8.shape
    if 2 * dh != din or group % 8 or din % group or scales.shape != (din // group, dout) \
            or din % 8 or dout % 4:
        raise ValueError(
            f"unsupported shapes x {tuple(x.shape)} q {tuple(q8.shape)} "
            f"scales {tuple(scales.shape)} group {group}")
    x2 = x2.to(torch.bfloat16).contiguous()
    ksplit, kchunk = split_k(rows, dh, dout)
    out = torch.empty((rows, dout), dtype=torch.float32, device=x.device)
    part = out if ksplit == 1 else torch.empty(
        (ksplit, rows, dout), dtype=torch.float32, device=x.device)
    lib = _lib()
    code = lib.int4_matmul_bf16(
        x2.data_ptr(), q8.data_ptr(), scales.data_ptr(), out.data_ptr(), part.data_ptr(),
        rows, din, dout, group, ksplit, kchunk,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "int4_matmul")
    int4_matmul.launches += 1
    return out.reshape(*lead, dout)


int4_matmul.launches = 0
