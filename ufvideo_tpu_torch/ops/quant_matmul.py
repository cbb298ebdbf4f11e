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

The CUDA source is ``csrc/quant_matmul.cu`` (written and verified on the
card); its header comment gives the bound on an H100 (the bytes of the
weights and scales) and both designs. Both stream each weight byte from
device memory once, split the contraction so the grid fills the card and
add the slices in a fixed order, in the same launch by a thread-block
cluster or by a second pass. One row, the count a decode step at batch 1
launches, takes the CUDA-core template whose grid ``matvec_plan`` sizes;
2 to 32 rows (a batched decode step) take the tensor-core template whose
grid ``rows_plan`` sizes. ``matvec_slices_plain`` / ``rows_slices_plain``
are their splits in plain PyTorch. Each wrapper keeps what it launched in
``last_plan``: a ``MatvecPlan`` for one row, a ``RowsPlan`` otherwise.

Both take at most ``MAX_ROWS`` rows, the JAX package's own limit; a caller
with more rows dequantises and runs one ``torch.matmul`` (``QuantLinear``).

On the card, these kernels alone (phase 2 of the smoke script, then the
card tests)::

    python3 chip_smoke.py --match int8_matvec,int4_matmul && \
        python -m pytest tests/test_torch_cuda.py -q --noconftest -k quant
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..quant import unpack_int4

MAX_ROWS = 32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("quant_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quant_matmul_rows.argtypes = [p] * 5 + [i] * 12 + [p]
    lib.quant_matvec_row.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.quant_matmul_rows.restype = ctypes.c_int
    lib.quant_matvec_row.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the one-row kernel (csrc/quant_matmul.cu, namespace row): 8 warps, 8 lanes
# across a weight row, so a warp loads 4 rows at once, 4 rows a lane: a block
# step is 128 weight rows
_MV_STEP = 128
_MV_LANES = 8
# A grid of clusters ran as one wave on an H100 up to 0.85 of two blocks an
# SM (224 blocks in 28 clusters of 8, 216 in 36 of 6), and not at 252 blocks
# in 36 clusters of 7 (scripts/torch_matvec_sweep.py)
_MV_WAVE = 0.85 * 2
_MV_MANY = 4  # blocks an SM where a split over several waves pays
_MV_MAX_CHUNK = 4096  # weight rows of a slice: its x (8 bytes a packed int4 row) in 32 KB
_MV_MAX_CLUSTER = 8  # the portable thread-block cluster size


class MatvecPlan(NamedTuple):
    """The one-row kernel's grid. ``vec``: bytes a lane loads from a weight
    row (16, or 4 where the rows are not 16-byte aligned); ``cols``: output
    columns a block; ``ksplit`` slices of ``kchunk`` weight rows (packed
    rows for int4) each; ``cluster``: ``ksplit`` where the slices of a
    column tile form one thread-block cluster that adds them in the same
    launch, else 1 (a second pass adds them); ``blocks``: the grid."""

    vec: int
    cols: int
    ksplit: int
    kchunk: int
    cluster: int
    blocks: int


@functools.cache
def matvec_plan(din: int, dout: int, bits: int, sm_count: int, aligned: bool = True
                ) -> MatvecPlan:
    """The one-row kernel's grid for a [din, dout] weight of ``bits`` bits
    on a card of ``sm_count`` SMs (a lane's 4 packed int4 rows lie in one
    scale group for every group the wrapper takes), from shapes alone, so
    a shape always launches the same grid and sums in the same order.
    ``aligned``: the weight starts on 16 bytes.

    16-byte loads where every weight row starts on 16 bytes (``dout % 16 ==
    0``), else 4-byte ones. Where one wave of clusters holds two or more
    slices of every column tile (qkv, o, down of Qwen2-7B), as many as fit,
    added in one launch; else, where the tiles alone give under
    ``_MV_MANY`` blocks an SM (gate / up), slices to that many blocks,
    added by a second pass; else (lm_head) one slice."""
    depth = din if bits == 8 else din // 2
    vec = 16 if aligned and dout % 16 == 0 else 4
    tiles = -(-dout // (_MV_LANES * vec))
    wave = int(_MV_WAVE * sm_count)
    if 2 * tiles <= wave:
        return split_rows(depth, dout, vec, min(wave // tiles, _MV_MAX_CLUSTER))
    want = -(-_MV_MANY * sm_count // tiles)
    return split_rows(depth, dout, vec, want, one_launch=False)


def split_rows(depth: int, dout: int, vec: int, want: int, one_launch: bool = True
               ) -> MatvecPlan:
    """A one-row plan that cuts ``depth`` weight rows (packed rows for
    int4) into about ``want`` slices of whole block steps (``_MV_STEP``
    rows), none longer than ``_MV_MAX_CHUNK`` (its x fits in shared
    memory); with ``one_launch``, the slices a cluster where there are 2 to
    ``_MV_MAX_CLUSTER`` of them."""
    cols = _MV_LANES * vec
    steps = -(-depth // _MV_STEP)
    want = max(want, -(-depth // _MV_MAX_CHUNK))
    per_slice = max(1, min(-(-steps // want), _MV_MAX_CHUNK // _MV_STEP))
    ksplit = -(-steps // per_slice)
    cluster = ksplit if one_launch and 1 < ksplit <= _MV_MAX_CLUSTER else 1
    return MatvecPlan(vec, cols, ksplit, per_slice * _MV_STEP, cluster,
                      -(-dout // cols) * ksplit)


def _slices_plain(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor, ksplit: int,
                  kchunk: int, bits: int, group: int) -> torch.Tensor:
    """x2 [rows, din] through a split of the contraction into ``ksplit``
    slices of ``kchunk`` weight rows (packed rows for int4). → [rows, dout]."""
    x2 = x2.to(torch.bfloat16).float()
    if bits == 8:
        w, per_row = q.float(), 1
    else:
        w, per_row = dequantize_int4(q, s, group, torch.bfloat16).float(), 2
    total = torch.zeros((x2.shape[0], q.shape[1]), dtype=torch.float32, device=x2.device)
    for i in range(ksplit):
        lo = i * kchunk * per_row
        hi = min(w.shape[0], (i + 1) * kchunk * per_row)
        total = total + x2[:, lo:hi] @ w[lo:hi]
    return total * s.float() if bits == 8 else total


def matvec_slices_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, plan: MatvecPlan,
                        bits: int, group: int = 64) -> torch.Tensor:
    """One row through the plan's split in plain PyTorch: each slice's f32
    sum over its weight rows, the slices added in order, then (int8) the
    column scale, as the kernel's second pass does. → [dout] f32."""
    return _slices_plain(x.reshape(1, -1), q, s, plan.ksplit, plan.kchunk, bits, group)[0]


# the 2-32-row kernel (csrc/quant_matmul.cu, namespace rows): 8 warps in
# wc column groups, each warp walking its own run of the slice 16 weight
# rows (packed rows for int4) a step, so a block step is 128 rows; 8 lanes
# across a weight row, so a group takes 8 * vec columns
_RW_STEP = 128
# dynamic shared memory a block: two blocks an SM (at most 128 registers a
# thread)
_RW_SMEM = 113 * 1024


class RowsPlan(NamedTuple):
    """The 2-32-row kernel's grid. ``rows`` of x in ``tiles`` n-tiles of 8
    (1, 2 or 4); ``vec``: bytes a lane loads from a weight row (16; 8 at 4
    n-tiles and for int4 at 2; 4 where the rows are not so aligned);
    ``wc``: column groups of warps; ``cols``: output columns a block; ``ksplit`` slices of ``kchunk`` weight rows (packed
    rows for int4) each; ``cluster``: ``ksplit`` where the slices of a column tile
    form one thread-block cluster that adds them in the same launch, else 1
    (a second pass adds them); ``blocks``: the grid; ``smem``: bytes of
    dynamic shared memory a block (x's slice, int4's scales, the sums)."""

    rows: int
    tiles: int
    vec: int
    wc: int
    cols: int
    ksplit: int
    kchunk: int
    cluster: int
    blocks: int
    smem: int


def rows_smem(bits: int, tiles: int, vec: int, wc: int, kchunk: int, group: int = 64) -> int:
    """Dynamic shared memory of one block (csrc/quant_matmul.cu
    rows::smem_bytes): the slice of x as bf16 (8 * tiles rows of the x
    values of kchunk weight rows, each row padded by 32 bytes, int4 64),
    int4's scales of the groups the slice touches, or, where larger, the
    warps' sums (four warps' in the reduction's first round, then the
    block's own [8 * tiles, cols] f32)."""
    xw, cols = (1 if bits == 8 else 2), wc * 8 * vec
    x = 8 * tiles * (2 * kchunk * xw + 32 * xw)
    scales = 0 if bits == 8 else (-(-kchunk // (group // 2)) + 1) * 4 * cols
    return max(x + scales, 4 * tiles * vec * 2 * 32 * 4 + 8 * tiles * cols * 4)


@functools.cache
def rows_plan(rows: int, din: int, dout: int, bits: int, sm_count: int, aligned: bool = True,
              group: int = 64) -> RowsPlan:
    """The 2-32-row kernel's grid for ``rows`` of x against a [din, dout]
    weight of ``bits`` bits (int4: ``group`` logical rows a scale) on a
    card of ``sm_count`` SMs, from shapes alone, so a shape always launches
    the same grid and sums in the same order. ``aligned``: the weight
    starts on 16 bytes.

    16-byte loads, or 8 at 4 n-tiles and for int4 at 2 (``wide_vec`` in
    csrc/quant_matmul.cu). Where one wave of blocks holds two or more
    slices of every column tile (qkv, o, down of Qwen2-7B), as many as fit,
    one column group of warps (two with 8-byte loads); else (gate / up, lm_head) twice those column
    groups, so x is staged once for twice the columns, and as many slices
    as fill one wave, at least two. Slices longer than shared memory holds
    are cut further, all to one length. Below 4 n-tiles the slices are
    added in the same launch where the grid is one wave of clusters; else,
    and always at 4 n-tiles, by a second pass. Each choice is the faster
    one in ``scripts/torch_matvec_sweep.py --rows`` on an H100: clusters
    over several waves, and the cluster's rank 0 adding 32 rows' sums, ran
    slower than the second pass."""
    depth = din if bits == 8 else din // 2
    tiles = 1 if rows <= 8 else 2 if rows <= 16 else 4
    wide = 8 if tiles == 4 or (tiles == 2 and bits == 4) else 16
    vec = wide if aligned and dout % wide == 0 else 4
    wc = 2 if wide == 8 else 1
    col_tiles = -(-dout // (wc * 8 * vec))
    wave = int(_MV_WAVE * sm_count)
    if 2 * col_tiles <= wave:
        want = min(wave // col_tiles, _MV_MAX_CLUSTER)
    else:
        if vec > 4:  # twice the column groups: x staged once for twice the columns
            wc *= 2
            col_tiles = -(-dout // (wc * 8 * vec))
        want = max(2, wave // col_tiles)
    cols = wc * 8 * vec
    steps = -(-depth // _RW_STEP)
    max_steps = steps
    while max_steps > 1 and rows_smem(bits, tiles, vec, wc, max_steps * _RW_STEP, group) \
            > _RW_SMEM:
        max_steps -= 1
    # slices of equal length, as many as wanted and shared memory needs
    per_slice = -(-steps // max(want, -(-steps // max_steps)))
    ksplit = -(-steps // per_slice)
    kchunk = per_slice * _RW_STEP
    one_wave = ksplit * col_tiles <= wave
    cluster = ksplit if tiles < 4 and 1 < ksplit <= _MV_MAX_CLUSTER and one_wave else 1
    return RowsPlan(rows, tiles, vec, wc, cols, ksplit, kchunk, cluster, col_tiles * ksplit,
                    rows_smem(bits, tiles, vec, wc, kchunk, group))


def rows_slices_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, plan: RowsPlan,
                      bits: int, group: int = 64) -> torch.Tensor:
    """Rows of x through the 2-32-row plan's split in plain PyTorch: each
    slice's f32 sums over its weight rows, the slices added in order, then
    (int8) the column scale. → [rows, dout] f32."""
    return _slices_plain(x.reshape(-1, x.shape[-1]), q, s, plan.ksplit, plan.kchunk, bits,
                         group)


_scratch: dict = {}


def _part(device: torch.device, n: int) -> torch.Tensor:
    """Scratch for the slices' partial sums, cached per device and stream
    (calls on one stream run in order, so one buffer serves them all)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < n:
        buf = _scratch[key] = torch.empty(n, dtype=torch.float32, device=device)
    return buf


def _launch_row(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor, bits: int, group: int,
                plan: MatvecPlan) -> torch.Tensor:
    """The one-row kernel at a given plan, after the wrappers' checks; adds
    one to the public wrapper's count and keeps the plan in its
    ``last_plan``. → [1, dout] f32."""
    din, dout = x2.shape[1], q.shape[1]
    out = torch.empty((1, dout), dtype=torch.float32, device=x2.device)
    two_pass = plan.ksplit > 1 and plan.cluster == 1
    part = _part(x2.device, plan.ksplit * dout) if two_pass else out
    lib = _lib()
    code = lib.quant_matvec_row(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), part.data_ptr(), bits, din,
        dout, group, plan.vec, plan.ksplit, plan.kchunk, plan.cluster,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    wrapper = int8_matvec if bits == 8 else int4_matmul
    _build.check(lib, code, wrapper.__name__)
    _build.count_launch(wrapper)
    wrapper.last_plan = plan
    return out


def _launch_rows(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor, bits: int, group: int,
                 plan: RowsPlan) -> torch.Tensor:
    """The 2-32-row kernel at a given plan, after the wrappers' checks
    (``plan.rows`` rows of x, bf16, contiguous); adds one to the public
    wrapper's count and keeps the plan in its ``last_plan``. → [rows, dout]
    f32."""
    rows, din = x2.shape
    dout = q.shape[1]
    if x2.data_ptr() % 16:  # the kernel stages x in 8- (int4: 16-) byte units
        x2 = x2.clone()
    out = torch.empty((rows, dout), dtype=torch.float32, device=x2.device)
    two_pass = plan.ksplit > 1 and plan.cluster == 1
    part = _part(x2.device, plan.ksplit * rows * dout) if two_pass else out
    lib = _lib()
    code = lib.quant_matmul_rows(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), part.data_ptr(), bits, rows,
        din, dout, group, plan.tiles, plan.vec, plan.wc, plan.ksplit, plan.kchunk, plan.cluster,
        plan.smem, torch.cuda.current_stream(x2.device).cuda_stream,
    )
    wrapper = int8_matvec if bits == 8 else int4_matmul
    _build.check(lib, code, wrapper.__name__)
    _build.count_launch(wrapper)
    wrapper.last_plan = plan
    return out


def _row_plan(x2: torch.Tensor, q: torch.Tensor, bits: int) -> MatvecPlan:
    return matvec_plan(x2.shape[1], q.shape[1], bits, _sm_count(x2.device.index or 0),
                       q.data_ptr() % 16 == 0)


def _rows_plan(x2: torch.Tensor, q: torch.Tensor, bits: int, group: int = 64) -> RowsPlan:
    return rows_plan(x2.shape[0], x2.shape[1], q.shape[1], bits,
                     _sm_count(x2.device.index or 0), q.data_ptr() % 16 == 0, group)


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
    if rows == 1:
        out = _launch_row(x2, q, scale, 8, 0, _row_plan(x2, q, 8))
    else:
        out = _launch_rows(x2, q, scale, 8, 0, _rows_plan(x2, q, 8))
    return out.reshape(*lead, dout)


int8_matvec.launches = 0
int8_matvec.last_plan = None


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
    if rows == 1:
        out = _launch_row(x2, q8, scales, 4, group, _row_plan(x2, q8, 4))
    else:
        out = _launch_rows(x2, q8, scales, 4, group, _rows_plan(x2, q8, 4, group))
    return out.reshape(*lead, dout)


int4_matmul.launches = 0
int4_matmul.last_plan = None
