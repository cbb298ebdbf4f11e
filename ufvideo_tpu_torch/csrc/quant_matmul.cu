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
// Bound on an H100: every weight is used once a row, so at 1 to 32 rows
// both are bound by the bytes of the weights and their scales at 3.35 TB/s.
// Qwen2-7B's decode in int8: 4.9 / 3.8 / 20.3 / 20.3 / 163 us for qkv / o /
// gate and up / down / lm_head; int4 reads 0.56 of those bytes. At 32 rows
// the products are 2 * 32 * din * dout operations, 35 GFLOP at lm_head,
// 0.035 ms of bf16 tensor-core time against 0.163 ms of bytes.
//
// Two designs, picked by the wrapper from the number of rows. Both read
// each weight byte from device memory once, with streaming 16-byte loads
// (4 where the weight rows are not 16-byte aligned): 8 lanes cover a
// 128-byte line of a weight row, a warp four rows at once, and each lane
// keeps the next batches of loads in flight while it converts the current
// one (a register ring). Each weight becomes f32 exactly with integer
// operations: the byte (or nibble), biased to be unsigned, is placed in the
// mantissa of 2^23 (prmt) and one FADD removes the bias, so no I2F runs;
// int4 then multiplies by its scale. A block of 8 warps owns a column tile
// and a slice of the contraction (the plans in ops/quant_matmul.py size
// the grid to fill the card); each warp walks its own run of the slice.
// Sums are added in a fixed order: across warps through shared memory,
// across slices in slice order, either in the same launch (the slices of a
// column tile are one thread-block cluster and rank 0 reads the others'
// sums through distributed shared memory) or by a second pass
// (finish_kernel). Both give the same bits, and two calls on one shape
// give the same bits.
//
// One row (quant_matvec_row, the count a decode step at batch 1 launches):
// f32 FMAs on the CUDA cores, a lane's 16 columns times 4 rows at a time;
// the slice of x staged in shared memory as f32. int8 issues ~3
// instructions a weight byte and streams at the memory rate; int4 issues
// ~12 a packed byte (de-bias, scale, bf16 round, two FMAs), which bounds it
// by instruction issue, not bytes, at the large shapes.
//
// 2 to 32 rows (quant_matmul_rows): the products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 sums) with the weights as the A
// operand (16 output columns of a tile) and x as B (8 rows of an n-tile):
// 1-8 rows take one n-tile, 9-16 two, 17-32 four, so the serving batch of
// 8 pads nothing. Lane (g = lane / 4, t = lane % 4) loads columns
// VEC*g .. VEC*g+VEC-1 of weight rows 4t .. 4t+3 of each 16-row step. The
// contraction order is free, so the mma's k values {2t, 2t+1, 2t+8, 2t+9}
// stand for those physical rows: the A fragment of m-tile m is bytes 2m
// and 2m+1 of the lane's own four loads (converted to f32, rounded to
// bf16 by cvt.rn.bf16x2, exact for int8), and the B fragment is x[n][4t ..
// 4t+3], one 8-byte read of the slice of x that the block stages in shared
// memory as bf16. After a step, lane (g, t) holds rows 2t, 2t+1 of each
// n-tile at its own VEC columns. int4: a packed byte holds two logical
// rows, so a lane's four packed rows feed two k16 steps, the low nibbles
// (logical rows 8t, 8t+2, 8t+4, 8t+6) and the high ones; x is staged with
// each 8 logical rows reordered even ones first, so one 16-byte read gives
// both B fragments; the scale multiplies each weight before the bf16 round
// (the group's scales staged in shared memory beside x), as the reference
// does. The 8 warps form WC column groups, each walking the slice in runs:
// one group of 16-byte loads (128 columns a block), or two (256) where the
// column tiles alone fill the card, so x is staged once for more columns;
// at four n-tiles, and at two for int4, 8-byte loads in two or four groups,
// so a lane's sums stay at most 64 floats and two blocks fit an SM (128
// registers, no spills). The warps of a column group add their sums through shared
// memory in rounds, halving the warps each time, in the x slice's space.
// A weight costs the conversion it costs at one row; an mma adds one
// instruction per 64 weights converted at one n-tile, so int4 stays bound
// by instruction issue where one row is.
//
// Not used: wgmma (its 64-row minimum wastes two thirds or more of the
// product at 32 rows or fewer, and the bytes bound it anyway), TMA, CUDA
// graphs, programmatic dependent launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// VEC bytes of one weight row, read once: no L1 allocation. Volatile, so
// the compiler issues each load where it is written (a batch ahead of its
// use) instead of sinking it to the first use.
template <int VEC>
__device__ __forceinline__ void load_stream(uint32_t (&w)[VEC / 4], const int8_t* p) {
  if constexpr (VEC == 16)
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
  else if constexpr (VEC == 8)
    asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                 : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  else
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(w[0]) : "l"(p));
}

// 16 bytes that convert to 0: int8 zeros; int4 bytes 0x08 (a low nibble of
// 8 is 0 after its +8 bias, a high nibble of 0 is 0).
__device__ __align__(16) const uint32_t kNeutral[2][4] = {
    {0u, 0u, 0u, 0u}, {0x08080808u, 0x08080808u, 0x08080808u, 0x08080808u}};

// Byte i of t placed in the mantissa of 2^23: the float 2^23 + byte, exact.
__device__ __forceinline__ float magic(uint32_t t, int i) {
  return __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7440u + i));
}

// bf16(hi) : bf16(lo), round to nearest even
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t pk;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(pk) : "f"(hi), "f"(lo));
  return pk;
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

// ------------------------------------------------------------ 2-32 rows --

namespace rows {

constexpr int kThreads = 256;                    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 16;                        // weight rows of one warp step (one k16)
constexpr int kBlockStep = kWarps * kStep;       // kchunk is a multiple of this

// d += a * b: a 16x16 bf16 tile (weights: 16 columns x 16 k), b 16x8 (x:
// 16 k x 8 rows), f32 sums
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Bytes of dynamic shared memory the kernel takes: the slice of x (NT * 8
// rows of kchunk * XW bf16 values, each row padded by 32 * XW bytes so a
// warp's reads of 4 (int4: 2) rows fall in distinct banks) and, for int4,
// the slice's scales (one row of cols floats a group it touches); after
// the loop the same space holds the warps' sums (4 warps' sums in the
// reduction's first round, then the block's own [NT * 8, cols]).
__host__ __device__ inline long long smem_bytes(int bits, int nt, int vec, int wc, int kchunk,
                                                int group_half) {
  const int xw = bits == 8 ? 1 : 2, cols = wc * 8 * vec;
  const long long x = 8LL * nt * (2LL * kchunk * xw + 32 * xw);
  const long long s = bits == 8 ? 0 : ((kchunk + group_half - 1) / group_half + 1) * 4LL * cols;
  const long long red = 4LL * nt * vec * 2 * 32 * 4 + 8LL * nt * cols * 4;
  return x + s > red ? x + s : red;
}

// rows <= 8 * NT of x against a tile of WC * 8 * VEC columns and the
// block's slice of the contraction; warp w takes the columns of w % WC and
// the run w / WC of the slice. BITS 8: q [depth, dout] int8, s [dout];
// BITS 4: q packed [depth, dout] (depth = din / 2), s [din / group, dout].
// grid (ceil(dout / (WC * 8 * VEC)), ksplit); kchunk % kBlockStep == 0;
// for BITS 4 group_half % 4 == 0 (a lane's four packed rows share one
// scale group).
template <int BITS, int NT, int VEC, int WC, int STAGES>
__global__ void __launch_bounds__(kThreads, 2) rows_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ out, float* __restrict__ part, int rows, int din, int depth, int dout,
    int kchunk, int group_half, int one_launch) {
  constexpr int WK = kWarps / WC;
  constexpr int kCols = WC * 8 * VEC;            // the block's output columns
  constexpr int kWords = VEC / 4;
  constexpr int kM = VEC / 2;                    // m-tiles: 2 of a lane's columns each
  constexpr int XW = BITS == 8 ? 1 : 2;          // x values a weight row
  constexpr int kRowsX = 8 * NT;
  constexpr int kAcc = NT * kM * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xstride = 2 * kchunk * XW + 32 * XW; // bytes a row of the x slice
  unsigned char* xs = smem;
  float* ss = reinterpret_cast<float*>(smem + kRowsX * xstride);  // int4: [groups][kCols]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wc = warp % WC, wk = warp / WC;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kCols, lc = wc * 8 * VEC + g * VEC, col = c0 + lc;
  const bool col_ok = col < dout;                // dout % VEC == 0
  const int kbeg = blockIdx.y * kchunk, kend = min(depth, kbeg + kchunk);
  const int per_warp = kchunk / WK;
  const int wbeg = kbeg + wk * per_warp, wend = min(kend, wbeg + per_warp);
  const int n_it = wend > wbeg ? (wend - wbeg + kStep - 1) / kStep : 0;
  const int r0 = wbeg + 4 * t;                   // the lane's first weight row
  const int grp0 = BITS == 4 ? kbeg / group_half : 0;

  float acc[NT][kM][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int m = 0; m < kM; ++m) acc[n][m][0] = acc[n][m][1] = acc[n][m][2] = acc[n][m][3] = 0.f;
  uint32_t buf[STAGES][4][kWords];

  // Every load is issued: a masked row (past the warp's run, or columns
  // past dout) reads kNeutral, whose words convert to 0.
  const int8_t* neutral = reinterpret_cast<const int8_t*>(kNeutral[BITS == 8 ? 0 : 1]);
  auto load = [&](uint32_t (&b)[4][kWords], int it) {
    const int r = r0 + it * kStep;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = col_ok && r + j < wend;
      load_stream<VEC>(b[j], ok ? q + (long long)(r + j) * dout + col : neutral);
    }
  };

  auto compute = [&](const uint32_t (&b)[4][kWords], int it) {
    const int r = r0 + it * kStep;
    // B fragments: x[n][4t .. 4t+3] of each n-tile (int4: logical rows 8t
    // .. 8t+7, even ones first)
    uint32_t bx[NT][2 * XW];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const unsigned char* p = xs + (n * 8 + g) * xstride + (r - kbeg) * 2 * XW;
      if constexpr (BITS == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        bx[n][0] = v.x; bx[n][1] = v.y;
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        bx[n][0] = v.x; bx[n][1] = v.y; bx[n][2] = v.z; bx[n][3] = v.w;
      }
    }
    const float* sc = ss + (r / group_half - grp0) * kCols + lc;  // int4 only
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      uint32_t tw[4];  // each byte + 128 (int4: each nibble + 8)
#pragma unroll
      for (int j = 0; j < 4; ++j) tw[j] = b[j][w] ^ 0x80808080u;
      if constexpr (BITS == 8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // m-tile 2w + h: bytes 2h, 2h + 1 of word w
          const int i0 = 2 * h, i1 = 2 * h + 1;
          auto f = [&](int j, int i) { return magic(tw[j], i) - 8388736.f; };
          const uint32_t a0 = bf16x2(f(0, i0), f(1, i0)), a1 = bf16x2(f(0, i1), f(1, i1));
          const uint32_t a2 = bf16x2(f(2, i0), f(3, i0)), a3 = bf16x2(f(2, i1), f(3, i1));
#pragma unroll
          for (int n = 0; n < NT; ++n) mma(acc[n][2 * w + h], a0, a1, a2, a3, bx[n][0], bx[n][1]);
        }
      } else {
        const float4 s4 = *reinterpret_cast<const float4*>(sc + 4 * w);
        const float scw[4] = {s4.x, s4.y, s4.z, s4.w};
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = tw[j] & 0x0F0F0F0Fu;
          hi[j] = (tw[j] >> 4) & 0x0F0F0F0Fu;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i0 = 2 * h, i1 = 2 * h + 1;
          const float s0 = scw[i0], s1 = scw[i1];
          auto f = [&](const uint32_t (&v)[4], int j, int i, float sv) {
            return (magic(v[j], i) - 8388616.f) * sv;
          };
          // low nibbles: even logical rows; high nibbles: odd ones
          const uint32_t l0 = bf16x2(f(lo, 0, i0, s0), f(lo, 1, i0, s0));
          const uint32_t l1 = bf16x2(f(lo, 0, i1, s1), f(lo, 1, i1, s1));
          const uint32_t l2 = bf16x2(f(lo, 2, i0, s0), f(lo, 3, i0, s0));
          const uint32_t l3 = bf16x2(f(lo, 2, i1, s1), f(lo, 3, i1, s1));
          const uint32_t h0 = bf16x2(f(hi, 0, i0, s0), f(hi, 1, i0, s0));
          const uint32_t h1 = bf16x2(f(hi, 0, i1, s1), f(hi, 1, i1, s1));
          const uint32_t h2 = bf16x2(f(hi, 2, i0, s0), f(hi, 3, i0, s0));
          const uint32_t h3 = bf16x2(f(hi, 2, i1, s1), f(hi, 3, i1, s1));
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            mma(acc[n][2 * w + h], l0, l1, l2, l3, bx[n][0], bx[n][1]);
            mma(acc[n][2 * w + h], h0, h1, h2, h3, bx[n][2], bx[n][3]);
          }
        }
      }
    }
  };

  // the first batches go out before x is staged: their latency covers it
#pragma unroll
  for (int st = 0; st < STAGES; ++st)
    if (st < n_it) load(buf[st], st);
  {
    // the slice of x as bf16, zeros past rows and past the slice; int4:
    // each 8 logical rows reordered x0 x2 x4 x6 x1 x3 x5 x7
    constexpr int UX = 4 * XW;                   // x values a unit (8 or 16 bytes)
    const int per_row = kchunk * XW / UX, kl0 = kbeg * XW, kl1 = kend * XW;
    for (int i = tid; i < kRowsX * per_row; i += kThreads) {
      const int n = i / per_row, u = i % per_row, k = kl0 + u * UX;
      const bool in = n < rows && k < kl1;       // kl1 % UX == 0
      unsigned char* dst = xs + n * xstride + u * UX * 2;
      if constexpr (BITS == 8) {
        uint2 v = make_uint2(0u, 0u);
        if (in) v = *reinterpret_cast<const uint2*>(x + (long long)n * din + k);
        *reinterpret_cast<uint2*>(dst) = v;
      } else {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (in) v = *reinterpret_cast<const uint4*>(x + (long long)n * din + k);
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(__byte_perm(v.x, v.y, 0x5410), __byte_perm(v.z, v.w, 0x5410),
                       __byte_perm(v.x, v.y, 0x7632), __byte_perm(v.z, v.w, 0x7632));
      }
    }
    if constexpr (BITS == 4) {
      const int n_grp = (kend - 1) / group_half - grp0 + 1;
      for (int i = tid; i < n_grp * (kCols / 4); i += kThreads) {
        const int gi = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + c < dout)                       // dout % 4 == 0
          v = *reinterpret_cast<const float4*>(s + (long long)(grp0 + gi) * dout + c0 + c);
        *reinterpret_cast<float4*>(ss + gi * kCols + c) = v;
      }
    }
  }
  __syncthreads();
  for (int it = 0; it < n_it; it += STAGES) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      if (it + st >= n_it) break;
      compute(buf[st], it + st);
      if (it + st + STAGES < n_it) load(buf[st], it + st + STAGES);
    }
  }

  // the sums of the WK warps of a column group in rounds, each through
  // shared memory in lane order: run k += run k + half, for half WK / 2 .. 1
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();                               // the x slice is read no more
#pragma unroll
  for (int half = WK / 2; half >= 1; half /= 2) {
    if (wk >= half && wk < 2 * half) {
      float* dst = red + ((wk - half) * WC + wc) * kAcc * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int m = 0; m < kM; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) dst[((n * kM + m) * 4 + c) * 32] = acc[n][m][c];
    }
    __syncthreads();
    if (wk < half) {
      const float* src = red + (wk * WC + wc) * kAcc * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int m = 0; m < kM; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[n][m][c] += src[((n * kM + m) * 4 + c) * 32];
    }
    __syncthreads();
  }
  // the block's sums [kRowsX][kCols]: acc[n][m] holds rows 8n + 2t, 8n +
  // 2t + 1 at the lane's columns 2m, 2m + 1
  float* slice = red + 4 * kAcc * 32;
  if (wk == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int rr = n * 8 + 2 * t, cc = lc + 2 * m;
        *reinterpret_cast<float2*>(slice + rr * kCols + cc) =
            make_float2(acc[n][m][0], acc[n][m][2]);
        *reinterpret_cast<float2*>(slice + (rr + 1) * kCols + cc) =
            make_float2(acc[n][m][1], acc[n][m][3]);
      }
  }
  __syncthreads();
  if (one_launch) {
    // the launch made the ksplit slices of a column tile one cluster: rank
    // 0 adds their sums in slice order, as finish_kernel does, through
    // distributed shared memory; the second sync keeps every block's
    // shared memory alive until rank 0 has read it
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      for (int i = tid; i < rows * kCols; i += kThreads) {
        const int n = i / kCols, oc = c0 + i % kCols;
        if (oc >= dout) continue;
        float v = 0.f;
        for (int r = 0; r < int(gridDim.y); ++r) v += cluster.map_shared_rank(slice, r)[i];
        out[(long long)n * dout + oc] = BITS == 8 ? v * s[oc] : v;
      }
    }
    cluster.sync();
  } else {
    for (int i = tid; i < rows * kCols; i += kThreads) {
      const int n = i / kCols, oc = c0 + i % kCols;
      if (oc >= dout) continue;
      const long long o = (long long)n * dout + oc;
      if (gridDim.y > 1)
        part[(long long)blockIdx.y * rows * dout + o] = slice[i];
      else
        out[o] = BITS == 8 ? slice[i] * s[oc] : slice[i];
    }
  }
}

template <int BITS, int NT, int VEC, int WC>
cudaError_t launch(const bf16* x, const int8_t* q, const float* s, float* out, float* part,
                   int rows, int din, int depth, int dout, int kchunk, int ksplit,
                   int group_half, bool one_launch, int smem, cudaStream_t st) {
  // a lane keeps STAGES batches of 4 loads in flight: three where the sums
  // (NT * VEC * 2 floats) and the conversion leave the registers for them
  constexpr int STAGES = NT * VEC * 2 >= 64 && (BITS == 4 || VEC == 16) ? 2 : 3;
  auto kernel = rows_kernel<BITS, NT, VEC, WC, STAGES>;
  static int smem_set = 48 * 1024;               // the default limit
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  constexpr int kCols = WC * 8 * VEC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((dout + kCols - 1) / kCols, ksplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = ksplit;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = one_launch ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, q, s, out, part, rows, din, depth, dout, kchunk,
                            group_half, int(one_launch));
}

// The wide load of each instance: 16 bytes, or 8 where a lane's sums at
// 16 (NT * 32 floats) would leave too few registers: at four n-tiles, and
// at two for int4 (its conversion needs more registers than int8's).
constexpr int wide_vec(int bits, int nt) { return nt == 4 || (nt == 2 && bits == 4) ? 8 : 16; }

// The instances: the wide load with the narrow count of column groups (1
// for 16 bytes, 2 for 8) or twice it, or 4-byte loads with the narrow one.
bool instance(int bits, int nt, int vec, int wc) {
  if (nt != 1 && nt != 2 && nt != 4) return false;
  const int wide = wide_vec(bits, nt), narrow = wide == 8 ? 2 : 1;
  return (vec == wide && (wc == narrow || wc == 2 * narrow)) || (vec == 4 && wc == narrow);
}

template <int BITS>
cudaError_t launch_tiles(int nt, int vec, int wc, const bf16* x, const int8_t* q,
                         const float* s, float* out, float* part, int rows, int din, int depth,
                         int dout, int kchunk, int ksplit, int group_half, bool one_launch,
                         int smem, cudaStream_t st) {
#define UFV_ROWS_LAUNCH(NT, VEC, WC)                                                      \
  launch<BITS, NT, VEC, WC>(x, q, s, out, part, rows, din, depth, dout, kchunk, ksplit,  \
                            group_half, one_launch, smem, st)
  if (nt == 4) {
    if (vec == 4) return UFV_ROWS_LAUNCH(4, 4, 2);
    return wc == 4 ? UFV_ROWS_LAUNCH(4, 8, 4) : UFV_ROWS_LAUNCH(4, 8, 2);
  }
  if (nt == 2) {
    if constexpr (wide_vec(BITS, 2) == 8) {
      if (vec == 4) return UFV_ROWS_LAUNCH(2, 4, 2);
      return wc == 4 ? UFV_ROWS_LAUNCH(2, 8, 4) : UFV_ROWS_LAUNCH(2, 8, 2);
    } else {
      if (vec == 4) return UFV_ROWS_LAUNCH(2, 4, 1);
      return wc == 2 ? UFV_ROWS_LAUNCH(2, 16, 2) : UFV_ROWS_LAUNCH(2, 16, 1);
    }
  }
  if (vec == 4) return UFV_ROWS_LAUNCH(1, 4, 1);
  return wc == 2 ? UFV_ROWS_LAUNCH(1, 16, 2) : UFV_ROWS_LAUNCH(1, 16, 1);
#undef UFV_ROWS_LAUNCH
}

}  // namespace rows

bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0; }

}  // namespace

extern "C" const char* ufv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 2 to 32 rows (1 is taken too): x [rows, din] bf16; bits 8: q [din, dout]
// int8, s [dout] f32; bits 4: q [din / 2, dout] packed, s [din / group,
// dout] f32 -> out [rows, dout] f32. The plan (ops/quant_matmul.rows_plan):
// tiles n-tiles of 8 rows (1, 2 or 4; rows <= 8 * tiles), vec bytes a lane
// loads a weight row (rows::wide_vec, or 4), ksplit slices of
// kchunk weight rows (packed rows for int4), kchunk a multiple of 128,
// wc column groups of warps (rows::instance), ksplit * kchunk >= depth >
// (ksplit - 1) * kchunk, smem bytes of dynamic
// shared memory (at least rows::smem_bytes, at most 113 KB: two blocks an
// SM). cluster 1: the slices' sums go to part (ksplit * rows * dout
// floats, unused when ksplit == 1) and a second pass adds them; cluster ==
// ksplit (2..8): one launch. x is 8-byte aligned (int4: 16), din % 4 == 0
// (int4: din % 8 == 0, group % 8 == 0).
extern "C" int quant_matmul_rows(const void* x, const void* q, const void* s, void* out,
                                 void* part, int bits, int rows, int din, int dout, int group,
                                 int tiles, int vec, int wc, int ksplit, int kchunk, int cluster,
                                 int smem, void* stream) {
  const int depth = bits == 8 ? din : din / 2;
  if ((bits != 8 && bits != 4) || !rows::instance(bits, tiles, vec, wc) || rows <= 0 ||
      rows > 8 * tiles || din <= 0 ||
      dout <= 0 || depth % 4 || dout % vec || ksplit <= 0 || ksplit > 65535 || kchunk <= 0 ||
      kchunk % rows::kBlockStep || (long long)ksplit * kchunk < depth ||
      (long long)(ksplit - 1) * kchunk >= depth)
    return int(cudaErrorInvalidValue);
  if (bits == 4 && (group <= 0 || group % 8 || din % group)) return int(cudaErrorInvalidValue);
  const int gh = bits == 4 ? group / 2 : 1;
  if (smem < rows::smem_bytes(bits, tiles, vec, wc, kchunk, gh) || smem > 113 * 1024)
    return int(cudaErrorInvalidValue);
  const bool one_launch = cluster > 1;
  if (cluster < 1 || (one_launch && (cluster != ksplit || cluster > 8)))
    return int(cudaErrorInvalidValue);
  if (!aligned(q, vec) || !aligned(x, bits == 8 ? 8 : 16) || (bits == 4 && !aligned(s, 16)))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* X = static_cast<const bf16*>(x);
  const int8_t* Q = static_cast<const int8_t*>(q);
  const float* S = static_cast<const float*>(s);
  float* O = static_cast<float*>(out);
  float* P = static_cast<float*>(part);
  const cudaError_t err =
      bits == 8 ? rows::launch_tiles<8>(tiles, vec, wc, X, Q, S, O, P, rows, din, depth, dout,
                                        kchunk, ksplit, gh, one_launch, smem, st)
                : rows::launch_tiles<4>(tiles, vec, wc, X, Q, S, O, P, rows, din, depth, dout,
                                        kchunk, ksplit, gh, one_launch, smem, st);
  if (err != cudaSuccess || one_launch) return int(err);
  return int(finish(P, bits == 8 ? S : nullptr, O, rows, dout, ksplit, st));
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
