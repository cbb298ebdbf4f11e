"""The fused pre-LN transformer blocks of SigLIP and Hiera: hand-written
CUDA kernels, each beside its plain version.

Each wrapper replaces one TPU kernel of ``ufvideo_tpu/ops/hiera_block.py``:

- ``fused_hiera_block`` (Pallas ``_forward`` / ``_kernel`` / ``_block_body``):
  LN1 (f32) → qkv → multi-head attention inside each window → proj +
  residual → LN2 (f32) → fc1 → GELU → fc2 + residual. SigLIP runs it with
  one 729-token window per frame and ``gelu_tanh``; Hiera's windowed blocks
  with 16 / 64 / 256-token windows and ``gelu_exact``.
- ``fused_hiera_stage`` (``_stage_forward`` / ``_stage_kernel``): a run of
  consecutive identical windowed blocks in one call, the math of folding
  ``fused_hiera_block`` over them (Hiera with a stage fusion of nb > 1).
- ``fused_ln_matmul`` (``_ln_matmul_forward``): LN (f32) → matmul + bias,
  the LN1 → qkv front of a Hiera global block.
- ``fused_block_tail`` (``_tail_forward``): proj + residual → LN2 → fc1 →
  GELU → fc2 + residual, the tail of a global block after attention.
- ``fused_qpool_block`` (``_qpool_forward``): a whole stage-transition
  block: LN1 → [qkv ‖ shortcut projection] → 2×2 max-pool of q and of the
  shortcut inside each window → attention of the pooled queries on the
  window's unpooled keys → the tail.
- ``fused_block_w8a8`` (``_w8a8_kernel`` / ``_w8a8_body``): the whole block
  with int8 weights (per-column f32 scales) and activations quantised per row
  before each product, so the four products run s8 × s8 → s32; the attention
  stays bf16. The quantised SigLIP tower runs it, and the quantised Hiera
  trunk at its four windowed shapes with ``gelu_exact``.
- ``fused_ln_matmul_w8a8`` (``_ln_matmul_w8a8_kernel``),
  ``fused_block_tail_w8a8`` (``_tail_w8a8_kernel``) and
  ``fused_qpool_block_w8a8`` (``_qpool_w8a8_kernel``): the front and the tail
  of a global block and the whole stage-transition block with int8 weights
  and rows quantised before each product. In the q-pool block the shortcut
  and q are pooled from the bf16 front, after its rescale, and the rows that
  enter the projection are the pooled ones.

The CUDA source is ``csrc/hiera_block.cu`` (LayerNorm, a tiled bf16 GEMM
with fused bias / GELU / residual epilogue, the pooling pass, and the
attention of ``csrc/attention_tile.cuh``); its header comment gives the
bound on an H100 (tensor-core operations) and the design. The math is that
of the JAX ``_reference`` / ``_ln_matmul_reference`` / ``_tail_reference`` /
``_qpool_reference`` / ``w8a8_reference`` / ``_ln_matmul_w8a8_reference`` /
``_tail_w8a8_reference`` / ``_qpool_w8a8_reference``; the TPU kernels'
128-lane head padding, window grouping with a block-diagonal score mask and
bf16 ``exp2`` softmax are not carried over.

Weights are in [in, out] layout, qkv columns ordered [q heads | k heads |
v heads]. ``fused_hiera_block`` takes ``params`` = (ln1_s, ln1_b, wqkv
[C, 3·H·hd], bqkv, wproj [H·hd, C], bproj, ln2_s, ln2_b, w1 [C, mlp], b1,
w2 [mlp, C], b2); ``fused_hiera_stage`` one such tuple a block.

Activations (``act``): the tanh and the exact (erf) GELU, and the JAX
package's four minimax polynomials (``gelu_poly`` and ``gelu_tanh_poly`` in
f32, their ``_bf16`` twins evaluated on bf16 values); every kernel with an
``act`` takes all six.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import _build
from .autograd import kernel_with_plain_backward, refuse_grad

_ACT_CODES = {"gelu_tanh": 1, "gelu_exact": 2, "gelu_poly": 3, "gelu_poly_bf16": 4,
              "gelu_tanh_poly": 5, "gelu_tanh_poly_bf16": 6}


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    # erf GELU; the JAX kernel's A-S 7.1.26 erf differs by at most 1.5e-7
    return F.gelu(x, approximate="none")


# The JAX package's minimax polynomial GELUs (FMA only): gelu(x) = x·(0.5 +
# xc·Q(t)), xc = clip(x, ±B), t = 2·xc²/B² − 1, Q of degree 9 in t (of
# degree 10 for the fit of the tanh form); the same constants
_GELU_POLY_B = 4.5
_GELU_POLY_CT = (
    0.1569060442880844, -0.07718588485083337, 0.054637490167050023,
    -0.04023694830724554, 0.02885765287056899, -0.018484084923067773,
    0.009653220256290044, -0.006070030404158596, 0.004962705354373479,
    -0.0019306118341346908,
)
_GELU_TANH_POLY_CT = (
    0.15693845830119607, -0.077295380617666, 0.054784027802834236,
    -0.04004952801103731, 0.02807726149055056, -0.018491884341240026,
    0.010685858987061678, -0.005250474306093966, 0.003522283558394471,
    -0.0028267368523108055, 0.0010171322565724434,
)


def _poly_gelu(x: torch.Tensor, ct) -> torch.Tensor:
    b = _GELU_POLY_B
    xc = x.clamp(-b, b)
    t = xc * xc * (2.0 / (b * b)) - 1.0
    q = torch.full_like(t, ct[-1])
    for ck in ct[-2::-1]:
        q = q * t + ck
    return x * (0.5 + xc * q)


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _bf16_const(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.bfloat16))


def _poly_gelu_bf16(x: torch.Tensor, ct) -> torch.Tensor:
    """The polynomial on bf16 values (the JAX ``_gelu_poly_bf16``): the
    input, every constant and every intermediate rounded to bf16, as the
    kernels' epilogue computes it; returned as f32 values."""
    r, c = _round_bf16, _bf16_const
    b = _GELU_POLY_B
    xb = r(x.float())
    xc = xb.clamp(-b, b)
    t = r(r(r(xc * xc) * c(2.0 / (b * b))) - 1.0)
    q = torch.full_like(t, c(ct[-1]))
    for ck in ct[-2::-1]:
        q = r(r(q * t) + c(ck))
    return r(xb * r(0.5 + r(xc * q)))


# Every activation returns f32 values. The two bf16 polynomials return bf16
# values in the JAX package, so the W8A8 blocks quantise their output with
# the row quantiser's amax, scale and division in bf16 (quant_rows_bf16)
_ACTS = {
    "gelu_tanh": _gelu_tanh,
    "gelu_exact": _gelu_exact,
    "gelu_poly": lambda x: _poly_gelu(x, _GELU_POLY_CT),
    "gelu_poly_bf16": lambda x: _poly_gelu_bf16(x, _GELU_POLY_CT),
    "gelu_tanh_poly": lambda x: _poly_gelu(x, _GELU_TANH_POLY_CT),
    "gelu_tanh_poly_bf16": lambda x: _poly_gelu_bf16(x, _GELU_TANH_POLY_CT),
}


_BF16_ACTS = ("gelu_poly_bf16", "gelu_tanh_poly_bf16")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("hiera_block")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hiera_block_bf16.argtypes = [p] * 19 + [i] * 7 + [f, p]
    lib.ln_matmul_bf16.argtypes = [p] * 6 + [i] * 7 + [f, p]
    lib.ln_matmul_pair_bf16.argtypes = [p] * 7 + [i] * 3 + [f, p]
    lib.block_tail_bf16.argtypes = [p] * 14 + [i] * 9 + [f, p]
    lib.qpool_block_bf16.argtypes = [p] * 22 + [i] * 10 + [f, p]
    lib.block_w8a8_bf16.argtypes = [p] * 29 + [i] * 7 + [f, p]
    lib.ln_matmul_w8a8_bf16.argtypes = [p] * 10 + [i] * 3 + [f, p]
    lib.block_tail_w8a8_bf16.argtypes = [p] * 22 + [i] * 5 + [f, p]
    lib.qpool_block_w8a8_bf16.argtypes = [p] * 31 + [i] * 10 + [f, p]
    lib.hiera_stage_bf16.argtypes = [p] * 4 + [i] + [p] * 5 + [i] * 7 + [f, p]
    lib.probe_gemm_bf16.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.probe_gemm_s8.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.gemm_s8_s32.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.block_gemm_plan_query.argtypes = [i] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.block_gemm_bf16.argtypes = [p] * 5 + [i] * 6 + [p]
    for fn in (lib.hiera_block_bf16, lib.ln_matmul_bf16, lib.ln_matmul_pair_bf16,
               lib.block_tail_bf16,
               lib.qpool_block_bf16, lib.block_w8a8_bf16, lib.ln_matmul_w8a8_bf16,
               lib.block_tail_w8a8_bf16, lib.qpool_block_w8a8_bf16, lib.hiera_stage_bf16,
               lib.probe_gemm_bf16, lib.probe_gemm_s8, lib.gemm_s8_s32,
               lib.block_gemm_plan_query, lib.block_gemm_bf16):
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, x: torch.Tensor, mats) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not all(t.dtype == torch.bfloat16 for t in (x, *mats)):
        raise TypeError(f"{name} kernel takes bf16 activations and weights")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _f32(*vecs):
    return [t.float().contiguous() for t in vecs]


def _layernorm(x32, scale, bias, eps):
    mean = x32.mean(dim=-1, keepdim=True)
    c = x32 - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * scale.float() + bias.float()


def layer_norm_flax(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)`` as the unfused modules call it:
    mean and variance in f32 (variance as E[x²] − E[x]², floored at 0),
    (x − mean) · (rsqrt(var + eps) · scale) + bias in f32, one rounding to
    ``dtype`` at the end."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((x32 - mean) * mul + bias.float()).to(dtype)


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
    return fused_block_tail_plain(
        x, o.reshape(n, s, hw), (wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2), act, eps
    )


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
    return kernel_with_plain_backward(
        _hiera_block_cuda, fused_hiera_block_plain, x, params, num_heads, head_dim, act, eps)


def _hiera_block_cuda(x, params, num_heads, head_dim, act, eps):
    (ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2,
     b2) = params
    _check_cuda("fused_hiera_block", x, (wqkv, wproj, w1, w2))
    n, s, c = x.shape
    hw = num_heads * head_dim
    mlp = w1.shape[1]
    expect = ((c, 3 * hw), (hw, c), (c, mlp), (mlp, c))
    if tuple(tuple(t.shape) for t in (wqkv, wproj, w1, w2)) != expect:
        raise ValueError(f"weight shapes do not match x {x.shape}, {num_heads} heads")
    if c % 8 or head_dim % 8 or mlp % 8 or head_dim > 128:
        raise ValueError(f"unsupported dims C={c} head dim={head_dim} mlp={mlp}")
    x, wqkv, wproj, w1, w2 = (t.contiguous() for t in (x, wqkv, wproj, w1, w2))
    vecs = _f32(ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b1, b2)
    rows = n * s
    empty = functools.partial(torch.empty, dtype=x.dtype, device=x.device)
    out = empty((n, s, c))
    xn, qkv, att, x1, hmid = (
        empty((rows, c)), empty((rows, 3 * hw)), empty((rows, hw)),
        empty((rows, c)), empty((rows, mlp)),
    )
    lib = _lib()
    code = lib.hiera_block_bf16(
        *_ptrs(x, out, vecs[0], vecs[1], wqkv, vecs[2], wproj, vecs[3], vecs[4], vecs[5],
               w1, vecs[6], w2, vecs[7], xn, qkv, att, x1, hmid),
        n, s, c, num_heads, head_dim, mlp, _ACT_CODES[act], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "fused_hiera_block")
    _build.count_launch(fused_hiera_block)
    return out


fused_hiera_block.launches = 0


def fused_hiera_stage_plain(
    x: torch.Tensor,  # [N, S, C] window-major tokens
    params_list,  # one 12-tuple a block, in fused_hiera_block's order
    num_heads: int,
    head_dim: int,
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``fused_hiera_block_plain``
    folded over the blocks (the JAX ``_stage_forward`` off the TPU)."""
    for params in params_list:
        x = fused_hiera_block_plain(x, params, num_heads, head_dim, act, eps)
    return x


def fused_hiera_stage(
    x: torch.Tensor,
    params_list,
    num_heads: int,
    head_dim: int,
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """A run of consecutive identical windowed blocks → [N, S, C]. CPU
    tensors take the plain version; CUDA tensors make one call that carries
    the rows through every block (bf16; the dims of ``fused_hiera_block``)."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    params_list = tuple(params_list)
    if not params_list:
        raise ValueError("fused_hiera_stage needs at least one block")
    if x.device.type == "cpu":
        return fused_hiera_stage_plain(x, params_list, num_heads, head_dim, act, eps)
    return kernel_with_plain_backward(
        _hiera_stage_cuda, fused_hiera_stage_plain, x, params_list, num_heads, head_dim,
        act, eps)


def _hiera_stage_cuda(x, params_list, num_heads, head_dim, act, eps):
    n, s, c = x.shape
    hw = num_heads * head_dim
    mlp = params_list[0][8].shape[1]
    expect = ((c, 3 * hw), (hw, c), (c, mlp), (mlp, c))
    flat = []
    for params in params_list:
        (ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2) = params
        _check_cuda("fused_hiera_stage", x, (wqkv, wproj, w1, w2))
        if tuple(tuple(t.shape) for t in (wqkv, wproj, w1, w2)) != expect:
            raise ValueError(f"weight shapes do not match x {x.shape}, {num_heads} heads")
        mats = [t.contiguous() for t in (wqkv, wproj, w1, w2)]
        vecs = _f32(ln1_s, ln1_b, bqkv, bproj, ln2_s, ln2_b, b1, b2)
        flat += [vecs[0], vecs[1], mats[0], vecs[2], mats[1], vecs[3], vecs[4], vecs[5],
                 mats[2], vecs[6], mats[3], vecs[7]]
    if c % 8 or head_dim % 8 or mlp % 8 or head_dim > 128:
        raise ValueError(f"unsupported dims C={c} head dim={head_dim} mlp={mlp}")
    x = x.contiguous()
    rows, nb = n * s, len(params_list)
    empty = functools.partial(torch.empty, dtype=x.dtype, device=x.device)
    out = empty((n, s, c))
    tmp = empty((n, s, c)) if nb > 1 else out
    xn, qkv, att, x1, hmid = (
        empty((rows, c)), empty((rows, 3 * hw)), empty((rows, hw)),
        empty((rows, c)), empty((rows, mlp)),
    )
    table = (ctypes.c_void_p * len(flat))(*_ptrs(*flat))  # read by the host code only
    lib = _lib()
    code = lib.hiera_stage_bf16(
        *_ptrs(x, out, tmp), table, nb, *_ptrs(xn, qkv, att, x1, hmid),
        n, s, c, num_heads, head_dim, mlp, _ACT_CODES[act], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "fused_hiera_stage")
    _build.count_launch(fused_hiera_stage)
    return out


fused_hiera_stage.launches = 0


# The LayerNorm-band GEMM of csrc/hiera_block.cu (ln_gemm_kernel): a block
# normalises a band of LN_BM rows of x in shared memory and streams W past
# it. It takes C <= LN_MAX_C; wider rows take the pair of launches (a
# LayerNorm pass into a scratch, then the GEMM).
LN_BM, LN_MAX_C, LN_BN, LN_MAX_STAGES = 128, 576, 128, 8
SMEM_MAX = 232448  # dynamic shared memory an H100 block may have (227 KB)


class LnGemmPlan(NamedTuple):
    """How ``fused_ln_matmul`` and the LN2 -> fc1 step of ``fused_block_tail``
    run at a shape: ``route`` "ln_gemm" (one launch) or "pair"; for
    "ln_gemm", the band's rows ``bm``, the column tile ``bn``, the W ring's
    ``stages``, the dynamic shared memory ``smem`` (bytes), the cluster size
    and the grid's ``bands``; 0 for "pair". A block tail's proj and fc2
    take the route ``block_gemm_plan`` gives them."""
    route: str
    bm: int
    bn: int
    stages: int
    smem: int
    cluster: int
    bands: int

    @property
    def args(self):
        """(bm, bn, stages, cluster) as the C entry points take and check them."""
        return self.bm, self.bn, self.stages, self.cluster


@functools.cache
def ln_gemm_plan(rows: int, c: int, n: int) -> LnGemmPlan:
    """The plan at ``rows`` rows of width ``c`` into ``n`` columns, from shapes
    alone (csrc/hiera_block.cu ``ln_gemm_plan`` computes the same and refuses
    any other). The band of 128 rows is loaded once (``ceil(c / 64)`` chunks
    of 64 columns, 16 KB each); the ring of W tiles (64 K rows x 128 columns,
    16 KB) gets as many stages as the rest of 227 KB holds, at most 8: 5 at
    C = 576, 8 at C <= 288. One band a block, one block an SM. A cluster of
    two bands sharing each W tile by TMA multicast ran slower in a trial on
    an H100 (PERF.md): the cluster is 1."""
    if rows <= 0 or n <= 0 or n % 8 or c <= 0 or c % 8:
        raise ValueError(f"no plan for rows={rows} C={c} N={n}: C and N multiples of 8")
    if c > LN_MAX_C:
        return LnGemmPlan("pair", 0, 0, 0, 0, 0, 0)
    band = -(-c // 64) * LN_BM * 128
    stage = 64 * LN_BN * 2
    stages = min(LN_MAX_STAGES, (SMEM_MAX - 1024 - band - 64 - 8 * LN_BN) // (stage + 24))
    smem = 1024 + band + stages * stage + (8 + 3 * stages) * 8 + 8 * LN_BN
    return LnGemmPlan("ln_gemm", LN_BM, LN_BN, stages, smem, 1, -(-rows // LN_BM))


# The block GEMM of csrc/hiera_block.cu: every product of a bf16 block (and
# the probe's bf16 product) runs on the route ``block_gemm_plan`` gives its
# shape, the C side's ``block_gemm_plan`` computing the same.
GEMM_BM, GEMM_BK = 128, 64
PP_STAGES = 6
PP_STAGE = GEMM_BM * GEMM_BK * 2 + GEMM_BK * 128 * 2  # A 128 x 64 + W 64 x 128, bf16
PP_TILE_R = GEMM_BM * 128 * 2  # a residual tile, loaded for the epilogue
# the alignment pad, the residual tile and its three barriers, both
# warpgroups' bias rows, then the ring's stages and their three barriers each
PP_SMEM = 1024 + PP_TILE_R + 3 * 8 + 2 * 128 * 4 + PP_STAGES * (PP_STAGE + 24)
# gemm_kernel's tiles: width -> the ring's stages (two blocks an SM at 128, one at 256)
TILE_STAGES = {128: 3, 256: 4}
H100_SMS = 132


class BlockGemmPlan(NamedTuple):
    """How the block GEMM runs one product: ``route`` "pp" (the persistent
    ping-pong kernel, two consumer warpgroups on alternate 128 x 128 tiles)
    or "128", "256" (``gemm_kernel``'s 128 x 128 or 128 x 256 tile, one block
    a tile); the ring's ``stages``, the dynamic shared memory ``smem`` (bytes),
    the blocks launched (``grid``) and the output ``tiles``."""
    route: str
    stages: int
    smem: int
    grid: int
    tiles: int

    @property
    def code(self):
        """(route, stages, smem, grid, tiles) as the C query gives them
        (route 0 for "pp", else the tile's width)."""
        return (self.route_code, self.stages, self.smem, self.grid, self.tiles)

    @property
    def route_code(self):
        """The route as ``block_gemm_bf16`` takes it: 0 for "pp", else the
        tile's width."""
        return 0 if self.route == "pp" else int(self.route)


def gemm_route_plan(route: str, m: int, n: int, k: int, sms: int = H100_SMS,
                    f32: bool = False) -> BlockGemmPlan:
    """The plan of an [m, k] x [k, n] product on ``route`` (``f32``: the f32
    sum, which alone may take "256"): the ping-pong kernel's grid is at most
    one block an SM, its ring the 6 stages of 32 KB that fit beside a 32 KB
    residual tile, the barriers and the two warpgroups' bias rows; a tile of
    ``gemm_kernel`` is a block a tile, with its ring (``TILE_STAGES``), two
    barriers a stage and its bias row."""
    if min(m, n, k, sms) <= 0 or n % 8 or k % 8:
        raise ValueError(f"no plan for M={m} N={n} K={k} on {sms} SMs: "
                         "K and N multiples of 8")
    bn = 128 if route == "pp" else int(route)
    if bn not in TILE_STAGES or (bn == 256 and not f32):
        raise ValueError(f"no route {route!r} for {'the f32 sum' if f32 else 'a bf16 output'}")
    tiles = -(-m // GEMM_BM) * -(-n // bn)
    if route == "pp":
        return BlockGemmPlan("pp", PP_STAGES, PP_SMEM, min(sms, tiles), tiles)
    stages = TILE_STAGES[bn]
    smem = stages * (GEMM_BM * GEMM_BK * 2 + GEMM_BK * bn * 2 + 16) + bn * 4 + 1024
    return BlockGemmPlan(route, stages, smem, tiles, tiles)


@functools.cache
def block_gemm_plan(m: int, n: int, k: int, sms: int = H100_SMS,
                    f32: bool = False) -> BlockGemmPlan:
    """The plan of an [m, k] x [k, n] product on a card of ``sms`` SMs, from
    shapes alone (``f32``: the f32 sum), each route where it measured the
    fastest on an H100 (scripts/torch_gemm_routes.py, PERF.md): the f32 sum
    on the 128 x 256 tile; the 128 x 128 tile at N <= 144 and at K <= 144
    with N < 1024 (Hiera stage 1's proj, fc2 and qkv); every other product
    (SigLIP's four, Hiera's from stage 2 on, the q-pool fronts) on the
    ping-pong kernel."""
    route = "256" if f32 else "128" if n <= 144 or (k <= 144 and n < 1024) else "pp"
    return gemm_route_plan(route, m, n, k, sms, f32)


def block_gemm_plan_on_card(m: int, n: int, k: int, sms: int = 0, f32: bool = False) -> tuple:
    """The C side's plan (``block_gemm_plan_query``) as
    ``BlockGemmPlan.code``: on ``sms`` SMs, or the current card's where
    ``sms`` is 0. Builds the kernels' library; needs no card where sms > 0."""
    lib = _lib()
    out = (ctypes.c_int * 5)()
    _build.check(lib, lib.block_gemm_plan_query(m, n, k, int(f32), sms, out),
                 "block_gemm_plan_query")
    return tuple(out)


def block_gemm_epilogue(y: torch.Tensor, residual=None, act=None) -> torch.Tensor:
    """The block GEMM's epilogue on f32 sums ``y`` (bias added): act and one
    rounding to bf16, or that rounding plus ``residual`` rounded again."""
    if act is not None:
        y = _ACTS[act](y)
    y = y.to(torch.bfloat16)
    if residual is not None:
        y = (y.float() + residual.float()).to(torch.bfloat16)
    return y


def block_gemm_plain(a, w, bias=None, residual=None, act=None, f32=False) -> torch.Tensor:
    """The block GEMM's function in plain PyTorch: a [M, K] . w [K, N] + bias
    in f32, then the f32 sum (``f32``) or ``block_gemm_epilogue``."""
    y = a.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    return y if f32 else block_gemm_epilogue(y, residual, act)


def block_gemm_alone(a, w, bias=None, residual=None, act=None, f32=False,
                     route=None) -> torch.Tensor:
    """The block GEMM alone on the card, on the route ``block_gemm_plan``
    gives its shape or on ``route`` ("pp", "128"; "256" for the f32 sum):
    ``block_gemm_plain``'s function for bf16 a [M, K] and w [K, N] (K and N
    multiples of 8), with an activation or a residual or the f32 sum. A
    measuring instrument: no model path calls it, so it counts nothing."""
    if a.device.type != "cuda":
        raise ValueError(f"block_gemm_alone: unsupported device {a.device}")
    _check_cuda("block_gemm_alone", a, (w,) + ((residual,) if residual is not None else ()))
    (m, k), n = a.shape, w.shape[1]
    if (w.shape[0] != k or k % 8 or n % 8
            or (residual is not None and (f32 or act is not None
                                          or tuple(residual.shape) != (m, n)))
            or (act is not None and f32)):
        raise ValueError(f"unsupported block GEMM: a {tuple(a.shape)} w {tuple(w.shape)}, "
                         f"one of act / residual / f32")
    forced = -1 if route is None else gemm_route_plan(route, m, n, k, f32=f32).route_code
    a, w = a.contiguous(), w.contiguous()
    b = None if bias is None else bias.float().contiguous()
    r = None if residual is None else residual.contiguous()
    y = torch.empty((m, n), dtype=torch.float32 if f32 else a.dtype, device=a.device)
    lib = _lib()
    code = lib.block_gemm_bf16(
        a.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        None if r is None else r.data_ptr(), y.data_ptr(), m, n, k,
        _ACT_CODES[act] if act else 0, 2 if f32 else int(r is not None), forced,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, code, "block_gemm_alone")
    return y


def fused_block_tail_plain(
    shortcut: torch.Tensor, att: torch.Tensor, params: tuple,
    act: str = "gelu_exact", eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX ``_tail_reference``)."""
    wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2 = params
    dtype = shortcut.dtype
    x1 = shortcut + (att @ wproj.to(dtype) + bproj.to(dtype)).to(dtype)
    xm = _layernorm(x1.float(), ln2_s, ln2_b, eps).to(dtype)
    h = _ACTS[act]((xm @ w1.to(dtype) + b1.to(dtype)).float()).to(dtype)
    return x1 + (h @ w2.to(dtype) + b2.to(dtype)).to(dtype)


def fused_ln_matmul_plain(x, ln_s, ln_b, w, b, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX ``_ln_matmul_reference``)."""
    xn = _layernorm(x.float(), ln_s, ln_b, eps).to(x.dtype)
    return (xn @ w.to(x.dtype) + b.to(x.dtype)).to(x.dtype)


def fused_ln_matmul(
    x: torch.Tensor,  # [N, S, C]
    ln_s: torch.Tensor,
    ln_b: torch.Tensor,
    w: torch.Tensor,  # [C, D]
    b: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm + matmul + bias → [N, S, D]. CPU tensors take the plain
    version; CUDA tensors launch the kernel (bf16; C and D multiples of 8):
    one launch of the LayerNorm-band GEMM for C <= 576, else the pair of
    launches (``ln_gemm_plan``)."""
    if x.device.type == "cpu":
        return fused_ln_matmul_plain(x, ln_s, ln_b, w, b, eps)
    return kernel_with_plain_backward(
        _ln_matmul_cuda, fused_ln_matmul_plain, x, ln_s, ln_b, w, b, eps)


def _ln_matmul_cuda(x, ln_s, ln_b, w, b, eps):
    _check_cuda("fused_ln_matmul", x, (w,))
    n, s, c = x.shape
    d = w.shape[1]
    if w.shape[0] != c or c % 8 or d % 8:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    x, w = x.contiguous(), w.contiguous()
    vecs = _f32(ln_s, ln_b, b)
    out = torch.empty((n, s, d), dtype=x.dtype, device=x.device)
    plan = ln_gemm_plan(n * s, c, d)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.route == "ln_gemm":
        code = lib.ln_matmul_bf16(
            *_ptrs(x, vecs[0], vecs[1], w, vecs[2], out), n * s, c, d, *plan.args,
            float(eps), stream)
    else:
        code = lib.ln_matmul_pair_bf16(
            *_ptrs(x, vecs[0], vecs[1], w, vecs[2], torch.empty_like(x), out), n * s, c, d,
            float(eps), stream)
    _build.check(lib, code, "fused_ln_matmul")
    _build.count_launch(fused_ln_matmul)
    return out


fused_ln_matmul.launches = 0


def fused_block_tail(
    shortcut: torch.Tensor,  # [N, S, C] residual input
    att: torch.Tensor,  # [N, S, A] attention output before its projection
    params: tuple,  # (wproj [A, C], bproj, ln2_s, ln2_b, w1 [C, mlp], b1, w2 [mlp, C], b2)
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """proj + residual → LN2 → MLP + residual → [N, S, C]. CPU tensors take
    the plain version; CUDA tensors launch the kernels (bf16; C, A and mlp
    multiples of 8): three launches where ``ln_gemm_plan`` takes C (LN2
    inside fc1's), else four."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if shortcut.device.type == "cpu":
        return fused_block_tail_plain(shortcut, att, params, act, eps)
    return kernel_with_plain_backward(
        _block_tail_cuda, fused_block_tail_plain, shortcut, att, params, act, eps)


def _block_tail_cuda(shortcut, att, params, act, eps):
    wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2 = params
    _check_cuda("fused_block_tail", shortcut, (att, wproj, w1, w2))
    n, s, c = shortcut.shape
    a, mlp = att.shape[-1], w1.shape[1]
    expect = ((n, s, a), (a, c), (c, mlp), (mlp, c))
    if tuple(tuple(t.shape) for t in (att, wproj, w1, w2)) != expect:
        raise ValueError(f"shapes do not match shortcut {tuple(shortcut.shape)}")
    if c % 8 or a % 8 or mlp % 8:
        raise ValueError(f"unsupported dims C={c} A={a} mlp={mlp}")
    shortcut, att, wproj, w1, w2 = (t.contiguous() for t in (shortcut, att, wproj, w1, w2))
    vecs = _f32(bproj, ln2_s, ln2_b, b1, b2)
    rows = n * s
    empty = functools.partial(torch.empty, dtype=shortcut.dtype, device=shortcut.device)
    out, x1, hmid = empty((n, s, c)), empty((rows, c)), empty((rows, mlp))
    plan = ln_gemm_plan(rows, c, mlp)
    xn = empty((rows, c)).data_ptr() if plan.route == "pair" else None
    lib = _lib()
    code = lib.block_tail_bf16(
        *_ptrs(shortcut, att, out, wproj, vecs[0], vecs[1], vecs[2], w1, vecs[3], w2,
               vecs[4], x1), xn, hmid.data_ptr(),
        rows, c, a, mlp, _ACT_CODES[act], *plan.args, float(eps),
        torch.cuda.current_stream(shortcut.device).cuda_stream,
    )
    _build.check(lib, code, "fused_block_tail")
    _build.count_launch(fused_block_tail)
    return out


fused_block_tail.launches = 0


def pool_window_tokens(v: torch.Tensor, ws: int, stride: tuple) -> torch.Tensor:
    """Max-pool [N, ws², D] window tokens (row-major inside a window) by
    ``stride`` = (sy, sx) → [N, (ws/sy)·(ws/sx), D]."""
    n, _, d = v.shape
    sy, sx = stride
    v6 = v.reshape(n, ws // sy, sy, ws // sx, sx, d)
    return v6.amax(dim=4).amax(dim=2).reshape(n, (ws // sy) * (ws // sx), d)


def _window_side(s: int) -> int:
    ws = int(round(s ** 0.5))
    if ws * ws != s:
        raise ValueError(f"{s} tokens are not a square window")
    return ws


def fused_qpool_block_plain(
    x: torch.Tensor,  # [N, S, Cin] window-major tokens, S = ws²
    params: tuple,
    num_heads: int,
    head_dim: int,
    q_stride: tuple = (2, 2),
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX ``_qpool_reference``)."""
    (ln1_s, ln1_b, wf, bf, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2) = params
    n, s, _ = x.shape
    ws = _window_side(s)
    sy, sx = q_stride
    sq = (ws // sy) * (ws // sx)
    hw = num_heads * head_dim
    dtype = x.dtype
    xn = _layernorm(x.float(), ln1_s, ln1_b, eps).to(dtype)
    front = (xn @ wf.to(dtype) + bf.to(dtype)).to(dtype)
    qp = pool_window_tokens(front[..., :hw], ws, q_stride)
    qp = qp.reshape(n, sq, num_heads, head_dim).float()
    sc = pool_window_tokens(front[..., 3 * hw:], ws, q_stride)
    kh = front[..., hw:2 * hw].reshape(n, s, num_heads, head_dim).float()
    vh = front[..., 2 * hw:3 * hw].reshape(n, s, num_heads, head_dim).float()
    logits = torch.einsum("nqhd,nkhd->nhqk", qp, kh) * head_dim ** -0.5
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("nhqk,nkhd->nqhd", probs.to(dtype).float(), vh).to(dtype)
    return fused_block_tail_plain(
        sc, o.reshape(n, sq, hw), (wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2), act, eps
    )


def fused_qpool_block(
    x: torch.Tensor,  # [N, S, Cin]
    params: tuple,  # (ln1_s, ln1_b, wfront [Cin, 3·H·hd + Cout], bfront, wproj
    #                 [H·hd, Cout], bproj, ln2_s, ln2_b, w1 [Cout, mlp], b1, w2, b2)
    num_heads: int,
    head_dim: int,
    q_stride: tuple = (2, 2),
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """One q-pooling stage-transition block → [N, S/(sy·sx), Cout]. CPU
    tensors take the plain version; CUDA tensors launch the kernels (bf16;
    Cin, Cout, head dim and mlp multiples of 8, head dim up to 128)."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return fused_qpool_block_plain(x, params, num_heads, head_dim, q_stride, act, eps)
    return kernel_with_plain_backward(
        _qpool_block_cuda, fused_qpool_block_plain, x, params, num_heads, head_dim,
        q_stride, act, eps)


def _qpool_block_cuda(x, params, num_heads, head_dim, q_stride, act, eps):
    (ln1_s, ln1_b, wf, bf, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2) = params
    _check_cuda("fused_qpool_block", x, (wf, wproj, w1, w2))
    n, s, cin = x.shape
    ws = _window_side(s)
    sy, sx = q_stride
    hw = num_heads * head_dim
    cout, mlp = wproj.shape[1], w1.shape[1]
    expect = ((cin, 3 * hw + cout), (hw, cout), (cout, mlp), (mlp, cout))
    if tuple(tuple(t.shape) for t in (wf, wproj, w1, w2)) != expect:
        raise ValueError(f"weight shapes do not match x {tuple(x.shape)}, {num_heads} heads")
    if ws % sy or ws % sx or cin % 8 or cout % 8 or head_dim % 8 or mlp % 8 or head_dim > 128:
        raise ValueError(
            f"unsupported dims window {ws} stride {q_stride} Cin={cin} Cout={cout} "
            f"head dim={head_dim} mlp={mlp}"
        )
    sq = (ws // sy) * (ws // sx)
    x, wf, wproj, w1, w2 = (t.contiguous() for t in (x, wf, wproj, w1, w2))
    vecs = _f32(ln1_s, ln1_b, bf, bproj, ln2_s, ln2_b, b1, b2)
    rows, qrows = n * s, n * sq
    empty = functools.partial(torch.empty, dtype=x.dtype, device=x.device)
    out = empty((n, sq, cout))
    xn, front = empty((rows, cin)), empty((rows, 3 * hw + cout))
    qp, sc, att = empty((qrows, hw)), empty((qrows, cout)), empty((qrows, hw))
    x1, xm, hmid = empty((qrows, cout)), empty((qrows, cout)), empty((qrows, mlp))
    lib = _lib()
    code = lib.qpool_block_bf16(
        *_ptrs(x, out, vecs[0], vecs[1], wf, vecs[2], wproj, vecs[3], vecs[4], vecs[5],
               w1, vecs[6], w2, vecs[7], xn, front, qp, sc, att, x1, xm, hmid),
        n, ws, sy, sx, cin, cout, num_heads, head_dim, mlp, _ACT_CODES[act], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "fused_qpool_block")
    _build.count_launch(fused_qpool_block)
    return out


fused_qpool_block.launches = 0


def quant_rows_f32(x32: torch.Tensor):
    """f32 [rows, d] → (int8 [rows, d], f32 scales [rows, 1]), the fused
    block's row quantiser: scale = max(amax · (1 / 127), 1e-8)."""
    amax = x32.abs().amax(dim=-1, keepdim=True)
    s = (amax * (1.0 / 127.0)).clamp_min(1e-8)
    return torch.round(x32 / s).to(torch.int8), s


def quant_rows_bf16(x: torch.Tensor):
    """The JAX ``_quant_rows_f32`` given a bf16 array: amax, ``amax · bf16(1 /
    127)``, the floor ``bf16(1e-8)`` and the division each rounded to bf16;
    a quotient that rounds to 128 saturates to 127, as XLA's conversion
    does → (int8, f32 scales [rows, 1])."""
    xb = x.to(torch.bfloat16)
    bf = lambda v: torch.tensor(v, dtype=torch.bfloat16)
    s = torch.maximum(xb.abs().amax(dim=-1, keepdim=True) * bf(1.0 / 127.0), bf(1e-8))
    return torch.round(xb / s).clamp(-128, 127).to(torch.int8), s.float()


def _qdot(x32: torch.Tensor, w: torch.Tensor, ws: torch.Tensor, b: torch.Tensor,
          bf16_rows: bool = False) -> torch.Tensor:
    """Rows quantised (by ``quant_rows_bf16`` with ``bf16_rows``), s8 × s8 →
    exact integer sums (float64 holds them), rescaled ``acc · xs · ws + b``
    in f32."""
    q, xs = (quant_rows_bf16 if bf16_rows else quant_rows_f32)(x32)
    acc = (q.double() @ w.double()).float()
    return acc * xs * ws.float()[None, :] + b.float()[None, :]


def _tail_w8a8(shortcut, att32, params, act, eps):
    """proj + residual → LN2 → MLP + residual with the rows quantised from the
    f32 attention output, the f32 LN2 output and the GELU output: f32, or
    bf16 after a bf16 polynomial (the JAX W8A8 kernels' bodies quantise
    that bf16 output in bf16)."""
    wproj, sproj, bproj, ln2_s, ln2_b, w1, s1, b1, w2, s2, b2 = params
    n, s, c = shortcut.shape
    dtype = shortcut.dtype
    rows = lambda t: t.reshape(n * s, t.shape[-1])
    x1 = shortcut + _qdot(rows(att32), wproj, sproj, bproj).reshape(n, s, c).to(dtype)
    xm = _layernorm(x1.float(), ln2_s, ln2_b, eps)
    h = _ACTS[act](_qdot(rows(xm), w1, s1, b1))
    mlp = _qdot(h, w2, s2, b2, bf16_rows=act in _BF16_ACTS)
    return x1 + mlp.reshape(n, s, c).to(dtype)


def fused_block_w8a8_plain(
    x: torch.Tensor,  # [N, S, C]
    params: tuple,
    num_heads: int,
    head_dim: int,
    act: str = "gelu_tanh",
    eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX ``w8a8_reference``):
    rows are quantised from the f32 LN outputs, the f32 attention output and
    the GELU output (in bf16 after a bf16 polynomial, see ``_tail_w8a8``)."""
    (ln1_s, ln1_b, wqkv, sqkv, bqkv, wproj, sproj, bproj, ln2_s, ln2_b,
     w1, s1, b1, w2, s2, b2) = params
    n, s, c = x.shape
    dtype = x.dtype
    hw = num_heads * head_dim
    xn = _layernorm(x.float(), ln1_s, ln1_b, eps)
    qkv = _qdot(xn.reshape(n * s, c), wqkv, sqkv, bqkv).reshape(n, s, -1).to(dtype)
    qh, kh, vh = (
        qkv[..., i * hw:(i + 1) * hw].reshape(n, s, num_heads, head_dim).float()
        for i in range(3)
    )
    logits = torch.einsum("nqhd,nkhd->nhqk", qh, kh) * head_dim ** -0.5
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("nhqk,nkhd->nqhd", probs.to(dtype).float(), vh).reshape(n, s, hw)
    return _tail_w8a8(x, o, params[5:], act, eps)


def _check_w8a8(name: str, x: torch.Tensor, acts, weights) -> None:
    refuse_grad(name, x, *acts, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not all(t.dtype == torch.bfloat16 for t in (x, *acts)) or not all(
            t.dtype == torch.int8 for t in weights):
        raise TypeError(f"{name} kernel takes bf16 activations and int8 weights")


def _pad32(k: int) -> int:
    return -(-k // 32) * 32


def _tail_w8a8_scratch(rows: int, c: int, a: int, mlp: int, dev, qa_bytes: int = 0):
    """The int8 scratch of the CUDA W8A8 tail, in the order the entry points
    take it: wproj_t, w1_t, w2_t, qa, qh; ``qa_bytes`` is what a caller's own
    use of ``qa`` needs."""
    kc, ka, km = _pad32(c), _pad32(a), _pad32(mlp)
    i8 = lambda *shape: torch.empty(shape, dtype=torch.int8, device=dev)
    return (i8(c, ka), i8(mlp, kc), i8(c, km), i8(max(rows * max(kc, ka), qa_bytes)),
            i8(rows, km))


def fused_block_w8a8(
    x: torch.Tensor,  # [N, S, C] window-major tokens (SigLIP: one window a frame)
    params: tuple,  # (ln1_s, ln1_b, wqkv_q [C, 3·H·hd] int8, sqkv, bqkv, wproj_q
    #                 [H·hd, C], sproj, bproj, ln2_s, ln2_b, w1_q [C, mlp], s1, b1,
    #                 w2_q [mlp, C], s2, b2)
    num_heads: int,
    head_dim: int,
    act: str = "gelu_tanh",
    eps: float = 1e-6,
) -> torch.Tensor:
    """The whole block in W8A8 → [N, S, C]. CPU tensors take the plain
    version; CUDA tensors launch the kernels (bf16 activations, int8 weights,
    f32 scales; C and head dim multiples of 8, mlp even)."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return fused_block_w8a8_plain(x, params, num_heads, head_dim, act, eps)
    (ln1_s, ln1_b, wqkv, sqkv, bqkv, wproj, sproj, bproj, ln2_s, ln2_b,
     w1, s1, b1, w2, s2, b2) = params
    _check_w8a8("fused_block_w8a8", x, (), (wqkv, wproj, w1, w2))
    n, s, c = x.shape
    hw = num_heads * head_dim
    mlp = w1.shape[1]
    expect = ((c, 3 * hw), (hw, c), (c, mlp), (mlp, c))
    if tuple(tuple(t.shape) for t in (wqkv, wproj, w1, w2)) != expect:
        raise ValueError(f"weight shapes do not match x {tuple(x.shape)}, {num_heads} heads")
    if c % 8 or head_dim % 8 or mlp % 2 or head_dim > 128:
        raise ValueError(f"unsupported dims C={c} head dim={head_dim} mlp={mlp}")
    x, wqkv, wproj, w1, w2 = (t.contiguous() for t in (x, wqkv, wproj, w1, w2))
    vecs = _f32(ln1_s, ln1_b, sqkv, bqkv, sproj, bproj, ln2_s, ln2_b, s1, b1, s2, b2)
    rows, kc = n * s, _pad32(c)
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=x.device)
    bf = x.dtype
    out = empty((n, s, c), bf)
    scratch = (
        empty((3 * hw, kc), torch.int8), *_tail_w8a8_scratch(rows, c, hw, mlp, x.device),
        empty((rows,), torch.float32), empty((rows, 3 * hw), bf), empty((rows, hw), bf),
        empty((rows, c), bf), empty((rows, mlp), torch.float32),
    )
    lib = _lib()
    code = lib.block_w8a8_bf16(
        *_ptrs(x, out, vecs[0], vecs[1], wqkv, vecs[2], vecs[3], wproj, vecs[4], vecs[5],
               vecs[6], vecs[7], w1, vecs[8], vecs[9], w2, vecs[10], vecs[11], *scratch),
        n, s, c, num_heads, head_dim, mlp, _ACT_CODES[act], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "fused_block_w8a8")
    _build.count_launch(fused_block_w8a8)
    return out


fused_block_w8a8.launches = 0


def fused_ln_matmul_w8a8_plain(x, ln_s, ln_b, w, s, b, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX
    ``_ln_matmul_w8a8_reference``): rows quantised from the f32 LN output."""
    n, sl, c = x.shape
    xn = _layernorm(x.float(), ln_s, ln_b, eps)
    return _qdot(xn.reshape(n * sl, c), w, s, b).reshape(n, sl, -1).to(x.dtype)


def fused_ln_matmul_w8a8(
    x: torch.Tensor,  # [N, S, C]
    ln_s: torch.Tensor,
    ln_b: torch.Tensor,
    w: torch.Tensor,  # int8 [C, D]
    s: torch.Tensor,  # f32 [D] column scales
    b: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm → rows to int8 → s8 × s8 → ``acc · xs · ws + b`` → [N, S, D].
    CPU tensors take the plain version; CUDA tensors launch the kernels (bf16
    activations, int8 weights; D even)."""
    if x.device.type == "cpu":
        return fused_ln_matmul_w8a8_plain(x, ln_s, ln_b, w, s, b, eps)
    _check_w8a8("fused_ln_matmul_w8a8", x, (), (w,))
    n, sl, c = x.shape
    d = w.shape[1]
    if w.shape[0] != c or d % 2:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    x, w = x.contiguous(), w.contiguous()
    vecs = _f32(ln_s, ln_b, s, b)
    rows, kc = n * sl, _pad32(c)
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=x.device)
    out = empty((n, sl, d), x.dtype)
    scratch = (empty((d, kc), torch.int8), empty((rows, kc), torch.int8),
               empty((rows,), torch.float32))
    lib = _lib()
    code = lib.ln_matmul_w8a8_bf16(
        *_ptrs(x, vecs[0], vecs[1], w, vecs[2], vecs[3], *scratch, out), rows, c, d,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "fused_ln_matmul_w8a8")
    _build.count_launch(fused_ln_matmul_w8a8)
    return out


fused_ln_matmul_w8a8.launches = 0


def fused_block_tail_w8a8_plain(
    shortcut: torch.Tensor, att: torch.Tensor, params: tuple,
    act: str = "gelu_exact", eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX ``_tail_w8a8_reference``).
    After a bf16 polynomial the GELU output is quantised in bf16, as the JAX
    kernel's body (``_tail_w8a8_kernel``) does; the JAX reference casts it to
    f32 first (``_qdot_ref``) and so differs from its own kernel there."""
    return _tail_w8a8(shortcut, att.float(), params, act, eps)


def fused_block_tail_w8a8(
    shortcut: torch.Tensor,  # [N, S, C] residual input
    att: torch.Tensor,  # [N, S, A] attention output before its projection
    params: tuple,  # (wproj_q [A, C], sproj, bproj, ln2_s, ln2_b, w1_q [C, mlp], s1, b1,
    #                 w2_q [mlp, C], s2, b2)
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """Rows of ``att`` to int8 → proj + residual → LN2 → int8 → fc1 → GELU →
    int8 → fc2 + residual → [N, S, C]. CPU tensors take the plain version;
    CUDA tensors launch the kernels (bf16 activations, int8 weights, f32
    scales; C and mlp even)."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if shortcut.device.type == "cpu":
        return fused_block_tail_w8a8_plain(shortcut, att, params, act, eps)
    wproj, sproj, bproj, ln2_s, ln2_b, w1, s1, b1, w2, s2, b2 = params
    _check_w8a8("fused_block_tail_w8a8", shortcut, (att,), (wproj, w1, w2))
    n, s, c = shortcut.shape
    a, mlp = att.shape[-1], w1.shape[1]
    expect = ((n, s, a), (a, c), (c, mlp), (mlp, c))
    if tuple(tuple(t.shape) for t in (att, wproj, w1, w2)) != expect:
        raise ValueError(f"shapes do not match shortcut {tuple(shortcut.shape)}")
    if c % 2 or mlp % 2:
        raise ValueError(f"unsupported dims C={c} mlp={mlp}")
    shortcut, att, wproj, w1, w2 = (t.contiguous() for t in (shortcut, att, wproj, w1, w2))
    vecs = _f32(sproj, bproj, ln2_s, ln2_b, s1, b1, s2, b2)
    rows, dev = n * s, shortcut.device
    out = torch.empty_like(shortcut)
    scratch = (
        *_tail_w8a8_scratch(rows, c, a, mlp, dev),
        torch.empty((rows,), dtype=torch.float32, device=dev),
        torch.empty((rows, c), dtype=shortcut.dtype, device=dev),
        torch.empty((rows, mlp), dtype=torch.float32, device=dev),
    )
    lib = _lib()
    code = lib.block_tail_w8a8_bf16(
        *_ptrs(shortcut, att, out, wproj, vecs[0], vecs[1], vecs[2], vecs[3], w1, vecs[4],
               vecs[5], w2, vecs[6], vecs[7], *scratch),
        rows, c, a, mlp, _ACT_CODES[act], float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "fused_block_tail_w8a8")
    _build.count_launch(fused_block_tail_w8a8)
    return out


fused_block_tail_w8a8.launches = 0


def fused_qpool_block_w8a8_plain(
    x: torch.Tensor,  # [N, S, Cin] window-major tokens, S = ws²
    params: tuple,
    num_heads: int,
    head_dim: int,
    q_stride: tuple = (2, 2),
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX
    ``_qpool_w8a8_reference``): q and the shortcut are pooled from the front
    after its rescale and its rounding to the working type. After a bf16
    polynomial the GELU output is quantised in bf16, as the JAX kernel's body
    does (its reference quantises it in f32, see the tail)."""
    (ln1_s, ln1_b, wf, sf, bf) = params[:5]
    n, s, cin = x.shape
    ws = _window_side(s)
    sy, sx = q_stride
    sq = (ws // sy) * (ws // sx)
    hw = num_heads * head_dim
    dtype = x.dtype
    xn = _layernorm(x.float(), ln1_s, ln1_b, eps)
    front = _qdot(xn.reshape(n * s, cin), wf, sf, bf).reshape(n, s, -1).to(dtype)
    qp = pool_window_tokens(front[..., :hw], ws, q_stride)
    qp = qp.reshape(n, sq, num_heads, head_dim).float()
    sc = pool_window_tokens(front[..., 3 * hw:], ws, q_stride)
    kh = front[..., hw:2 * hw].reshape(n, s, num_heads, head_dim).float()
    vh = front[..., 2 * hw:3 * hw].reshape(n, s, num_heads, head_dim).float()
    logits = torch.einsum("nqhd,nkhd->nhqk", qp, kh) * head_dim ** -0.5
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("nhqk,nkhd->nqhd", probs.to(dtype).float(), vh).reshape(n, sq, hw)
    return _tail_w8a8(sc, o, params[5:], act, eps)


def fused_qpool_block_w8a8(
    x: torch.Tensor,  # [N, S, Cin]
    params: tuple,  # (ln1_s, ln1_b, wfront_q [Cin, 3·H·hd + Cout] int8, sfront, bfront,
    #                 wproj_q [H·hd, Cout], sproj, bproj, ln2_s, ln2_b, w1_q [Cout, mlp],
    #                 s1, b1, w2_q [mlp, Cout], s2, b2)
    num_heads: int,
    head_dim: int,
    q_stride: tuple = (2, 2),
    act: str = "gelu_exact",
    eps: float = 1e-6,
) -> torch.Tensor:
    """One q-pooling stage-transition block in W8A8 → [N, S/(sy·sx), Cout].
    CPU tensors take the plain version; CUDA tensors launch the kernels (bf16
    activations, int8 weights, f32 scales; Cout and head dim multiples of 8,
    head dim up to 128, mlp even)."""
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return fused_qpool_block_w8a8_plain(x, params, num_heads, head_dim, q_stride, act, eps)
    (ln1_s, ln1_b, wf, sf, bf, wproj, sproj, bproj, ln2_s, ln2_b,
     w1, s1, b1, w2, s2, b2) = params
    _check_w8a8("fused_qpool_block_w8a8", x, (), (wf, wproj, w1, w2))
    n, s, cin = x.shape
    ws = _window_side(s)
    sy, sx = q_stride
    hw = num_heads * head_dim
    cout, mlp = wproj.shape[1], w1.shape[1]
    nf = 3 * hw + cout
    expect = ((cin, nf), (hw, cout), (cout, mlp), (mlp, cout))
    if tuple(tuple(t.shape) for t in (wf, wproj, w1, w2)) != expect:
        raise ValueError(f"weight shapes do not match x {tuple(x.shape)}, {num_heads} heads")
    if ws % sy or ws % sx or cout % 8 or head_dim % 8 or mlp % 2 or head_dim > 128:
        raise ValueError(
            f"unsupported dims window {ws} stride {q_stride} Cout={cout} "
            f"head dim={head_dim} mlp={mlp}"
        )
    sq = (ws // sy) * (ws // sx)
    x, wf, wproj, w1, w2 = (t.contiguous() for t in (x, wf, wproj, w1, w2))
    vecs = _f32(ln1_s, ln1_b, sf, bf, sproj, bproj, ln2_s, ln2_b, s1, b1, s2, b2)
    rows, qrows, kin, dev = n * s, n * sq, _pad32(cin), x.device
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    i8, bf16 = torch.int8, x.dtype
    out = empty((n, sq, cout), bf16)
    scratch = (
        empty((nf, kin), i8), *_tail_w8a8_scratch(qrows, cout, hw, mlp, dev, rows * kin),
        empty((rows,), torch.float32), empty((rows, nf), bf16), empty((qrows, hw), bf16),
        empty((qrows, cout), bf16), empty((qrows, hw), bf16), empty((qrows, cout), bf16),
        empty((qrows, mlp), torch.float32),
    )
    lib = _lib()
    code = lib.qpool_block_w8a8_bf16(
        *_ptrs(x, out, vecs[0], vecs[1], wf, vecs[2], vecs[3], wproj, vecs[4], vecs[5],
               vecs[6], vecs[7], w1, vecs[8], vecs[9], w2, vecs[10], vecs[11], *scratch),
        n, ws, sy, sx, cin, cout, num_heads, head_dim, mlp, _ACT_CODES[act], float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "fused_qpool_block_w8a8")
    _build.count_launch(fused_qpool_block_w8a8)
    return out


fused_qpool_block_w8a8.launches = 0
