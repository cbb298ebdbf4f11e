// Decode-shaped products on quantised weights, with a plain C interface for
// ctypes. Each product replaces one TPU kernel of
// ufvideo_tpu/ops/quant_matmul.py:
//
//   int8_matvec (_int8_kernel): out[r, c] = (sum_k x[r, k] * q[k, c]) *
//     scale[c], x bf16, q int8 [din, dout], f32 accumulation, f32 output;
//   int4_matmul (_int4_kernel), with the numbers of int4_matmul_reference:
//     out[r, c] = sum_k x[r, k] * bf16(w[k, c] * s[k / group, c]), w the
//     4-bit values of quant.pack_int4 (packed row i holds logical row 2i in
//     the low nibble biased by +8 and row 2i+1 signed in the high nibble), s
//     f32 [din / group, dout].
//
// The TPU int4 kernel folds the +8 bias into a second small product because
// Mosaic has no int8 vector shifts; here the nibbles are de-biased in
// registers and that fold is not carried over.
//
// Bound on an H100: every weight is used once a row, so both are bound by
// the bytes of the weights and their scales at 3.35 TB/s. Qwen2-7B's one
// decode row in int8: 4.9 / 3.8 / 20.3 / 20.3 / 163 us for qkv / o / gate
// and up / down / lm_head; int4 reads 0.56 of those bytes.
//
// Two designs, picked by the wrapper from the number of rows:
//
// One row (quant_matvec_row, the only count a decode step launches): one
// template for both weight formats. A lane owns 16 columns (or 4 where the
// rows are not 16-byte aligned) and reads them with one streaming 16-byte
// load a weight row; 8 lanes cover a 128-byte line, a warp 4 rows at once,
// a block of 8 warps a 128-column tile and a slice of the contraction (from
// ops/quant_matmul.matvec_plan, sized so the grid fills the card). A lane
// takes 4 rows at a time and issues the next 4 loads before it converts the
// current ones (a register double buffer: up to 128 bytes a lane, 64 KB an
// SM in flight); the first two batches go out before the block stages its
// slice of x in shared memory, as f32. Each weight becomes f32 exactly with
// integer operations: the byte (or nibble), biased to be unsigned, is
// placed in the mantissa of 2^23 (prmt) and one FADD removes the bias, so no
// I2F runs; int4 then multiplies by its scale and rounds to bf16
// (cvt.rn.bf16x2, two weights at once), as the reference does. Sums are
// f32 FMAs, reduced in a fixed order: across a warp's 4 rows by shuffles,
// across warps through shared memory, across slices in slice order, either
// in the same launch (the slices of a column tile are one thread-block
// cluster and rank 0 reads the others' sums through distributed shared
// memory) or by a second pass (finish_kernel) where the grid is too large
// for one wave of clusters. Both give the same bits, and two calls on one
// shape give the same bits. int8 issues ~3 instructions a weight byte and
// streams at the memory rate; int4 issues ~12 a packed byte (de-bias,
// scale, bf16 round, two FMAs), which bounds it by instruction issue, not
// bytes, at the large shapes.
//
// 2 to 32 rows (int8_matvec_bf16 / int4_matmul_bf16): a block owns 128
// output columns (four a lane, 4-byte loads) and a slice of the
// contraction from split_k; its 8 warps take weight rows four at a time and
// accumulate rows x 4 f32 sums a lane, rows taken 1, 2, 4 or 8 at a time;
// more than 8 rows re-read the weights from L2 per group of 8. The same
// fixed-order second pass adds the slices.
//
// Not used: tensor cores (at one row a product does 2 operations a weight
// byte, far below the card's ridge), TMA.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;              // output columns per block (4 per lane)
constexpr int kRowStep = 4 * kWarps;    // weight rows per block step

__device__ __forceinline__ void load_x4(const bf16* p, float (&x)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);  // 4 bf16, 8-byte aligned
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// Sum the warps' accumulators and write this block's [ROWS, 128] tile: to
// out (times scale, when the contraction is not split) or to its slice of
// the scratch.
template <int ROWS>
__device__ __forceinline__ void reduce_store(float (&acc)[ROWS][4], float* red,
                                             const float* scale, float* out, float* part,
                                             int rows, int dout, int r0, int c0) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(warp * ROWS + r) * kCols + lane * 4 + j] = acc[r][j];
  __syncthreads();
  for (int i = tid; i < ROWS * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    if (r0 + r >= rows || c0 + c >= dout) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * ROWS + r) * kCols + c];
    const long long o = (long long)(r0 + r) * dout + c0 + c;
    if (gridDim.y == 1)
      out[o] = scale ? s * scale[c0 + c] : s;
    else
      part[(long long)blockIdx.y * rows * dout + o] = s;
  }
}

// grid (ceil(dout / 128), ksplit, ceil(rows / ROWS)); kchunk % 32 == 0.
template <int ROWS>
__global__ void __launch_bounds__(kThreads) int8_matvec_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
    float* __restrict__ out, float* __restrict__ part, int rows, int din, int dout,
    int kchunk) {
  __shared__ float red[kWarps * ROWS * kCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kCols, col = c0 + lane * 4;
  const int r0 = blockIdx.z * ROWS;
  const int kbeg = blockIdx.y * kchunk, kend = min(din, kbeg + kchunk);
  const bool col_ok = col < dout;  // dout % 4 == 0: the lane's 4 columns together
  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int k = kbeg + warp * 4; k < kend; k += kRowStep) {  // k % 4 == 0, din % 4 == 0
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = col_ok ? *reinterpret_cast<const uint32_t*>(q + (long long)(k + j) * dout + col)
                    : 0u;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float xv[4] = {0.f, 0.f, 0.f, 0.f};
      if (r0 + r < rows) load_x4(x + (long long)(r0 + r) * din + k, xv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const char4 b = *reinterpret_cast<const char4*>(&w[j]);
        acc[r][0] += xv[j] * float(b.x);
        acc[r][1] += xv[j] * float(b.y);
        acc[r][2] += xv[j] * float(b.z);
        acc[r][3] += xv[j] * float(b.w);
      }
    }
  }
  reduce_store<ROWS>(acc, red, scale, out, part, rows, dout, r0, c0);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The same tiling on packed nibbles: k counts PACKED rows (two logical rows
// each); kchunk % 32 == 0 and group % 8 == 0, so the 4 packed rows of one
// warp's step lie in one scale group.
template <int ROWS>
__global__ void __launch_bounds__(kThreads) int4_matmul_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ out, float* __restrict__ part, int rows, int din, int dout,
    int kchunk, int group_half) {
  __shared__ float red[kWarps * ROWS * kCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kCols, col = c0 + lane * 4;
  const int r0 = blockIdx.z * ROWS;
  const int dh = din / 2;
  const int kbeg = blockIdx.y * kchunk, kend = min(dh, kbeg + kchunk);
  const bool col_ok = col < dout;
  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int k = kbeg + warp * 4; k < kend; k += kRowStep) {  // k % 4 == 0, dh % 4 == 0
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = col_ok ? *reinterpret_cast<const uint32_t*>(q + (long long)(k + j) * dout + col)
                    : 0u;
    float4 sc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col_ok)
      sc = *reinterpret_cast<const float4*>(s + (long long)(k / group_half) * dout + col);
    const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
    // dequantised weights of this step: [packed row j][column c][low, high]
    float wl[4][4], wh[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int byte = int((w[j] >> (8 * c)) & 0xffu);
        const int lo = (byte & 15) - 8;
        const int hi = (byte >> 4) - ((byte & 0x80) ? 16 : 0);
        wl[j][c] = bf16_round(float(lo) * scv[c]);
        wh[j][c] = bf16_round(float(hi) * scv[c]);
      }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float xa[4] = {0.f, 0.f, 0.f, 0.f}, xb[4] = {0.f, 0.f, 0.f, 0.f};
      if (r0 + r < rows) {  // logical rows 2k .. 2k+7
        load_x4(x + (long long)(r0 + r) * din + 2 * k, xa);
        load_x4(x + (long long)(r0 + r) * din + 2 * k + 4, xb);
      }
      const float xe[4] = {xa[0], xa[2], xb[0], xb[2]};  // even logical rows: low nibbles
      const float xo[4] = {xa[1], xa[3], xb[1], xb[3]};  // odd logical rows: high nibbles
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += xe[j] * wl[j][c] + xo[j] * wh[j][c];
    }
  }
  reduce_store<ROWS>(acc, red, nullptr, out, part, rows, dout, r0, c0);
}

// out[i] = (sum over the ksplit slices of part[s, i]) * scale[column]
__global__ void __launch_bounds__(256) finish_kernel(const float* __restrict__ part,
                                                     const float* __restrict__ scale,
                                                     float* __restrict__ out, long long n,
                                                     int dout, int ksplit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += part[k * n + i];
  out[i] = scale ? s * scale[i % dout] : s;
}

cudaError_t finish(const float* part, const float* scale, float* out, int rows, int dout,
                   int ksplit, cudaStream_t st) {
  if (ksplit == 1) return cudaSuccess;
  const long long n = (long long)rows * dout;
  finish_kernel<<<unsigned((n + 255) / 256), 256, 0, st>>>(part, scale, out, n, dout, ksplit);
  return cudaGetLastError();
}

// ------------------------------------------------------------- one row --

namespace row {

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 8;                  // lanes across one weight row
constexpr int kLaneRows = 32 / kLanesPerRow;     // weight rows a warp loads at once
constexpr int kMaxSmem = 48 * 1024;              // x slice + reduction, static limit
constexpr int U = 4;                             // weight rows a lane loads at once

// VEC bytes of one weight row, read once: no L1 allocation. Volatile, so
// the compiler issues each load where it is written (a batch ahead of its
// use) instead of sinking it to the first use.
template <int VEC>
__device__ __forceinline__ void load_stream(uint32_t (&w)[VEC / 4], const int8_t* p) {
  if constexpr (VEC == 16)
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
  else
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(w[0]) : "l"(p));
}

// VEC f32 scales of one group (int4), kept in L1: a warp's four rows share them.
template <int VEC>
__device__ __forceinline__ void load_scales(float (&sc)[VEC], const float* p) {
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    float4 v;
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p + 4 * i));
    sc[4 * i] = v.x; sc[4 * i + 1] = v.y; sc[4 * i + 2] = v.z; sc[4 * i + 3] = v.w;
  }
}

// 16 bytes that convert to 0: int8 zeros; int4 bytes 0x08 (a low nibble of
// 8 is 0 after its +8 bias, a high nibble of 0 is 0).
__device__ __align__(16) const uint32_t kNeutral[2][4] = {
    {0u, 0u, 0u, 0u}, {0x08080808u, 0x08080808u, 0x08080808u, 0x08080808u}};

// Byte i of t placed in the mantissa of 2^23: the float 2^23 + byte, exact.
__device__ __forceinline__ float magic(uint32_t t, int i) {
  return __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7440u + i));
}

// One row: out[c] = sum over the block's slice of the contraction, for a
// tile of 8 * VEC columns. BITS 8: q [depth, dout] int8; BITS 4: q packed
// [depth, dout] (depth = din / 2), s [depth / group_half, dout]. grid
// (ceil(dout / (8 * VEC)), ksplit); kchunk % (kWarps * kLaneRows * U) == 0;
// for BITS 4, group_half % U == 0 (group % 8 == 0: a lane's U rows share
// one scale group).
template <int BITS, int VEC>
__global__ void __launch_bounds__(kThreads, 2) matvec_row_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ out, float* __restrict__ part, int depth, int dout, int kchunk,
    int group_half, int one_launch) {
  constexpr int kCols = kLanesPerRow * VEC;
  constexpr int kWords = VEC / 4;
  constexpr int kStep = kLaneRows * U;           // weight rows of one warp iteration
  constexpr int XW = BITS == 8 ? 1 : 2;          // x values a weight row
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // the slice of x as f32
  __shared__ __align__(16) float red[kWarps][kCols];
  __shared__ float slice_sum[kCols];             // one launch: read by cluster rank 0

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int lr = lane / kLanesPerRow, lc = lane % kLanesPerRow;
  const int col = blockIdx.x * kCols + lc * VEC;
  const bool col_ok = col < dout;                // dout % VEC == 0
  const int kbeg = blockIdx.y * kchunk, kend = min(depth, kbeg + kchunk);

  // each warp walks its own run of the slice, U rows a lane an iteration
  const int per_warp = kchunk / kWarps;
  const int wbeg = kbeg + warp * per_warp, wend = min(kend, wbeg + per_warp);
  const int n_it = wend > wbeg ? (wend - wbeg + kStep - 1) / kStep : 0;
  const int r0 = wbeg + lr * U;

  float acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.f;
  uint32_t buf0[U][kWords], buf1[U][kWords];
  // int4: the scales of each buffer's group, loaded with its weights
  float sc0[BITS == 4 ? VEC : 1], sc1[BITS == 4 ? VEC : 1];

  // Every load is issued: a masked row (past the slice, or columns past
  // dout) reads kNeutral, whose words convert to 0, so no branch and no
  // select on a loaded value stands between the loads of a batch.
  const int8_t* neutral = reinterpret_cast<const int8_t*>(kNeutral[BITS == 8 ? 0 : 1]);
  auto load = [&](uint32_t (&b)[U][kWords], float (&sc)[BITS == 4 ? VEC : 1], int it) {
    const int r = r0 + it * kStep;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const bool ok = col_ok && r + j < kend;
      load_stream<VEC>(b[j], ok ? q + (long long)(r + j) * dout + col : neutral);
    }
    if constexpr (BITS == 4) {
      const bool ok = col_ok && r < kend;
      load_scales<VEC>(sc, ok ? s + (long long)(r / group_half) * dout + col : s);
    }
  };

  auto compute = [&](const uint32_t (&b)[U][kWords], const float (&sc)[BITS == 4 ? VEC : 1],
                     int it) {
    const int r = r0 + it * kStep;
    float xv[U * XW];
    const float4* xp = reinterpret_cast<const float4*>(xs + (r - kbeg) * XW);
#pragma unroll
    for (int i = 0; i < U * XW / 4; ++i) {
      const float4 v = xp[i];
      xv[4 * i] = v.x; xv[4 * i + 1] = v.y; xv[4 * i + 2] = v.z; xv[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < U; ++j)
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const uint32_t t = b[j][w] ^ 0x80808080u;  // each byte (int4: nibble) + 128 (+ 8)
        if constexpr (BITS == 8) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[4 * w + i] = fmaf(xv[j], magic(t, i) - 8388736.f, acc[4 * w + i]);
        } else {
          const uint32_t lo = t & 0x0F0F0F0Fu, hi = (t >> 4) & 0x0F0F0F0Fu;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 4 * w + i;
            const float wl = (magic(lo, i) - 8388616.f) * sc[c];
            const float wh = (magic(hi, i) - 8388616.f) * sc[c];
            uint32_t pk;  // bf16(wh) : bf16(wl), round to nearest even
            asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(pk) : "f"(wh), "f"(wl));
            acc[c] = fmaf(xv[2 * j], __uint_as_float(pk << 16), acc[c]);
            acc[c] = fmaf(xv[2 * j + 1], __uint_as_float(pk & 0xFFFF0000u), acc[c]);
          }
        }
      }
  };

  // the first two batches go out before x is staged: their latency covers it
  if (n_it > 0) load(buf0, sc0, 0);
  if (n_it > 1) load(buf1, sc1, 1);
  for (int i = tid; i < kchunk * XW; i += kThreads) {
    const int k = kbeg * XW + i;
    xs[i] = k < kend * XW ? __bfloat162float(x[k]) : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < n_it; it += 2) {
    compute(buf0, sc0, it);
    if (it + 2 < n_it) load(buf0, sc0, it + 2);
    if (it + 1 >= n_it) break;
    compute(buf1, sc1, it + 1);
    if (it + 3 < n_it) load(buf1, sc1, it + 3);
  }

  // a warp's 4 rows by shuffles (a butterfly: every lane ends with the same
  // bits), then the 8 warps in order
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 8);
    acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 16);
  }
  if (lr == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(&red[warp][lc * VEC])[i] =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  for (int c = tid; c < kCols; c += kThreads) {
    const int oc = blockIdx.x * kCols + c;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][c];
    if (one_launch)
      slice_sum[c] = v;
    else if (oc >= dout)
      continue;
    else if (gridDim.y > 1)
      part[(long long)blockIdx.y * dout + oc] = v;
    else
      out[oc] = BITS == 8 ? v * s[oc] : v;
  }
  if (one_launch) {
    // the launch made the ksplit slices of a column tile one cluster: rank
    // 0 adds their sums in slice order, as finish_kernel does, through
    // distributed shared memory; the second sync keeps every block's
    // shared memory alive until rank 0 has read it
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      for (int c = tid; c < kCols; c += kThreads) {
        const int oc = blockIdx.x * kCols + c;
        if (oc >= dout) continue;
        float v = 0.f;
        for (int r = 0; r < int(gridDim.y); ++r) v += cluster.map_shared_rank(slice_sum, r)[c];
        out[oc] = BITS == 8 ? v * s[oc] : v;
      }
    }
    cluster.sync();
  }
}

template <int BITS, int VEC>
cudaError_t launch(const bf16* x, const int8_t* q, const float* s, float* out, float* part,
                   int depth, int dout, int kchunk, int ksplit, int group_half, bool one_launch,
                   cudaStream_t st) {
  constexpr int kCols = kLanesPerRow * VEC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((dout + kCols - 1) / kCols, ksplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(kchunk) * (BITS == 8 ? 1 : 2) * sizeof(float);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = ksplit;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = one_launch ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, matvec_row_kernel<BITS, VEC>, x, q, s, out, part, depth,
                            dout, kchunk, group_half, int(one_launch));
}

}  // namespace row

int rows_per_block(int rows) { return rows >= 8 ? 8 : rows >= 4 ? 4 : rows >= 2 ? 2 : 1; }

bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0; }

}  // namespace

extern "C" const char* ufv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [rows, din] bf16, q [din, dout] int8, scale [dout] f32 -> out [rows,
// dout] f32. The contraction is cut into ksplit slices of kchunk rows
// (kchunk % 32 == 0, ksplit * kchunk >= din); part holds ksplit * rows *
// dout floats (unused when ksplit == 1). din % 4 == 0, dout % 4 == 0.
extern "C" int int8_matvec_bf16(const void* x, const void* q, const void* scale, void* out,
                                void* part, int rows, int din, int dout, int ksplit,
                                int kchunk, void* stream) {
  if (rows <= 0 || din <= 0 || dout <= 0 || din % 4 || dout % 4 || ksplit <= 0 ||
      kchunk <= 0 || kchunk % kRowStep || (long long)ksplit * kchunk < din || ksplit > 65535)
    return int(cudaErrorInvalidValue);
  if (!aligned(x, 8) || !aligned(q, 4)) return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rb = rows_per_block(rows);
  dim3 grid((dout + kCols - 1) / kCols, ksplit, (rows + rb - 1) / rb);
  if (grid.z > 65535) return int(cudaErrorInvalidValue);
  const bf16* X = static_cast<const bf16*>(x);
  const int8_t* Q = static_cast<const int8_t*>(q);
  const float* S = static_cast<const float*>(scale);
  float* O = static_cast<float*>(out);
  float* P = static_cast<float*>(part);
  switch (rb) {
    case 1: int8_matvec_kernel<1><<<grid, kThreads, 0, st>>>(X, Q, S, O, P, rows, din, dout, kchunk); break;
    case 2: int8_matvec_kernel<2><<<grid, kThreads, 0, st>>>(X, Q, S, O, P, rows, din, dout, kchunk); break;
    case 4: int8_matvec_kernel<4><<<grid, kThreads, 0, st>>>(X, Q, S, O, P, rows, din, dout, kchunk); break;
    default: int8_matvec_kernel<8><<<grid, kThreads, 0, st>>>(X, Q, S, O, P, rows, din, dout, kchunk); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(finish(P, S, O, rows, dout, ksplit, st));
}

// x [rows, din] bf16, q [din / 2, dout] packed int8, s [din / group, dout]
// f32 -> out [rows, dout] f32. kchunk counts packed rows: kchunk % 32 == 0,
// ksplit * kchunk >= din / 2. din % 8 == 0, dout % 4 == 0, group % 8 == 0.
extern "C" int int4_matmul_bf16(const void* x, const void* q, const void* s, void* out,
                                void* part, int rows, int din, int dout, int group,
                                int ksplit, int kchunk, void* stream) {
  if (rows <= 0 || din <= 0 || dout <= 0 || din % 8 || dout % 4 || group <= 0 || group % 8 ||
      din % group || ksplit <= 0 || kchunk <= 0 || kchunk % kRowStep ||
      (long long)ksplit * kchunk < din / 2 || ksplit > 65535)
    return int(cudaErrorInvalidValue);
  if (!aligned(x, 8) || !aligned(q, 4) || !aligned(s, 16)) return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rb = rows_per_block(rows);
  dim3 grid((dout + kCols - 1) / kCols, ksplit, (rows + rb - 1) / rb);
  if (grid.z > 65535) return int(cudaErrorInvalidValue);
  const bf16* X = static_cast<const bf16*>(x);
  const int8_t* Q = static_cast<const int8_t*>(q);
  const float* S = static_cast<const float*>(s);
  float* O = static_cast<float*>(out);
  float* P = static_cast<float*>(part);
  const int gh = group / 2;
  switch (rb) {
    case 1: int4_matmul_kernel<1><<<grid, kThreads, 0, st>>>(X, Q, S, O, P, rows, din, dout, kchunk, gh); break;
    case 2: int4_matmul_kernel<2><<<grid, kThreads, 0, st>>>(X, Q, S, O, P, rows, din, dout, kchunk, gh); break;
    case 4: int4_matmul_kernel<4><<<grid, kThreads, 0, st>>>(X, Q, S, O, P, rows, din, dout, kchunk, gh); break;
    default: int4_matmul_kernel<8><<<grid, kThreads, 0, st>>>(X, Q, S, O, P, rows, din, dout, kchunk, gh); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return int(finish(P, nullptr, O, rows, dout, ksplit, st));
}

// One row: x [din] bf16; bits 8: q [din, dout] int8, s [dout] f32; bits 4:
// q [din / 2, dout] packed, s [din / group, dout] f32 -> out [dout] f32.
// The plan (ops/quant_matmul.matvec_plan): vec bytes a lane loads a weight
// row (16 or 4), and ksplit slices of kchunk weight rows (packed rows for
// int4), kchunk a multiple of 128, ksplit * kchunk >= depth > (ksplit - 1)
// * kchunk. cluster 1: the slices' sums go to part (ksplit * dout floats,
// unused when ksplit == 1) and a second pass adds them; cluster == ksplit
// (2..8): one launch, the slices of a column tile one thread-block
// cluster. Both add the slices in slice order: the same bits.
extern "C" int quant_matvec_row(const void* x, const void* q, const void* s, void* out,
                                void* part, int bits, int din, int dout, int group, int vec,
                                int ksplit, int kchunk, int cluster, void* stream) {
  const int depth = bits == 8 ? din : din / 2;
  const int xw = bits == 8 ? 1 : 2;
  if ((bits != 8 && bits != 4) || (vec != 16 && vec != 4) || din <= 0 || dout <= 0 ||
      depth % 4 || dout % vec || ksplit <= 0 || ksplit > 65535 || kchunk <= 0 ||
      kchunk % (row::kWarps * row::kLaneRows * row::U) ||
      (long long)ksplit * kchunk < depth || (long long)(ksplit - 1) * kchunk >= depth ||
      size_t(kchunk) * xw * sizeof(float) + row::kWarps * 8 * vec * sizeof(float) >
          size_t(row::kMaxSmem))
    return int(cudaErrorInvalidValue);
  if (bits == 4 && (group <= 0 || group % 8 || din % group)) return int(cudaErrorInvalidValue);
  const bool one_launch = cluster > 1;
  if (cluster < 1 || (one_launch && (cluster != ksplit || cluster > 8)))
    return int(cudaErrorInvalidValue);
  if (!aligned(q, vec) || (bits == 4 && !aligned(s, 16))) return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* X = static_cast<const bf16*>(x);
  const int8_t* Q = static_cast<const int8_t*>(q);
  const float* S = static_cast<const float*>(s);
  float* O = static_cast<float*>(out);
  float* P = static_cast<float*>(part);
  const int gh = bits == 4 ? group / 2 : 0;
  cudaError_t err;
  if (bits == 8)
    err = vec == 16 ? row::launch<8, 16>(X, Q, S, O, P, depth, dout, kchunk, ksplit, gh,
                                         one_launch, st)
                    : row::launch<8, 4>(X, Q, S, O, P, depth, dout, kchunk, ksplit, gh,
                                        one_launch, st);
  else
    err = vec == 16 ? row::launch<4, 16>(X, Q, S, O, P, depth, dout, kchunk, ksplit, gh,
                                         one_launch, st)
                    : row::launch<4, 4>(X, Q, S, O, P, depth, dout, kchunk, ksplit, gh,
                                        one_launch, st);
  if (err != cudaSuccess || one_launch) return int(err);
  return int(finish(P, bits == 8 ? S : nullptr, O, 1, dout, ksplit, st));
}
