// Decode-shaped products on quantised weights, with a plain C interface for
// ctypes. Two entry points, each replacing one TPU kernel of
// ufvideo_tpu/ops/quant_matmul.py:
//
//   int8_matvec_bf16  int8_matvec (_int8_kernel): out[r, c] =
//                     (sum_k x[r, k] * q[k, c]) * scale[c], x bf16, q int8
//                     [din, dout], f32 accumulation, f32 output;
//   int4_matmul_bf16  int4_matmul (_int4_kernel), with the numbers of
//                     int4_matmul_reference: out[r, c] = sum_k x[r, k] *
//                     bf16(w[k, c] * s[k / group, c]), w the 4-bit values of
//                     quant.pack_int4 (packed row i holds logical row 2i in
//                     the low nibble biased by +8 and row 2i+1 signed in the
//                     high nibble), s f32 [din / group, dout].
//
// The TPU int4 kernel folds the +8 bias into a second small product because
// Mosaic has no int8 vector shifts; here the nibbles are de-biased and
// sign-extended in registers and that fold is not carried over.
//
// Bound on an H100: with 1..32 rows every weight is used once or a few
// times, so both are bound by the bytes of the weights (Qwen2-7B: 4.6 to
// 545 MB a product in int8, 0.56 of that in int4 with its scales). Design: a
// block owns 128 output columns (a warp reads one 128-byte line of int8, or
// of packed nibbles, per weight row: four columns a lane) and a slice of the
// contraction; its 8 warps take weight rows four at a time with independent
// loads, accumulate rows x 4 f32 sums a lane, and are summed through shared
// memory. 3584 columns are only 28 such tiles, so the contraction is split
// over gridDim.y blocks until the grid fills the card; the slices' partial
// sums go to scratch and a second pass adds them in a fixed order (no
// atomics: the result does not depend on the schedule). Rows are taken 1, 2,
// 4 or 8 at a time; more than 8 rows re-read the weights from L2 per group
// of 8. Not used: tensor cores (nothing for a 64-row tile to do), TMA.
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
