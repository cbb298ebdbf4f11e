// Ragged single-token decode attention on a bf16 or an int8 cache, with a
// plain C interface for ctypes.
//
// decode_attention_bf16 replaces ufvideo_tpu/ops/decode_attention.py
// ragged_decode_attention (_kernel): the G query heads that share one kv
// head attend to that head's cache row [S, D], masked at lens[b], with an
// f32 softmax. decode_attention_q8 replaces ragged_decode_attention_q8
// (_kernel_q8): the same on int8 k / v with f32 per-position scales, which
// are constant along the contracted axis and so fold into the scores
// (s = (q . k) * scale * k_scale[pos]) and the probabilities (p *
// v_scale[pos]); no dequantised copy of the cache exists. A position is one
// 128-byte row of int8; its two scales are read by the thread that owns the
// position (neighbouring threads, neighbouring addresses).
//
// Bound on an H100: it reads the whole valid cache once per step
// (Qwen2-7B: 4 kv heads x 2.8k positions x 128 x 2 bytes x 2 = ~5.8 MB) and
// does ~2 FLOP per byte, so it is bound by memory bytes. One block per
// (b, kv head), as on the TPU, would put 4 blocks on 132 SMs at batch 1, so
// the design splits the cache row into 128-position chunks (flash-decoding):
// pass 1 reads each chunk once for all G heads (one thread per position for
// the scores, a chunk-local softmax, one thread per column for the
// unnormalised P.V in f32) and writes (max, sum, acc) per chunk; pass 2
// merges the chunks of each query head with the usual rescale. Chunks past
// lens[b] return at once. The P.V product keeps f32 probabilities (the TPU
// kernel rounds them to bf16), which is closer to the f32 reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kChunk = 128;   // cache positions per block
constexpr int kThreads = 128; // 4 warps
constexpr int kMaxG = 8;      // query heads per kv head
constexpr int kMaxD = 128;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 (bf16) or 16 (int8) consecutive cache values of one position as floats
__device__ __forceinline__ void load16(const bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(h[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__device__ __forceinline__ void load16(const int8_t* p, float (&f)[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const signed char* b = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = float(b[j]);
}

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return float(v); }

// grid (n_chunks, Hkv, B). part_m / part_l [B, Hkv, n_chunks, G],
// part_acc [B, Hkv, n_chunks, G, D]. T is the cache's type: bf16 (ks / vs
// null) or int8 with the scales ks / vs [B, Hkv, S].
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_partial_kernel(
    const bf16* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ lens,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int Hkv, int G, int S, int D, float scale) {
  constexpr int kVec = 16 / int(sizeof(T));  // cache values per 16-byte load
  __shared__ float qs[kMaxG][kMaxD];
  __shared__ float ps[kMaxG][kChunk];
  const int chunk = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nchunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = (long long)b * Hkv + hk;
  const long long pidx = bh * nchunks + chunk;
  float* acc_out = part_acc + pidx * G * D;
  const int len = min(lens[b], S);
  const int s0 = chunk * kChunk;
  const int n = min(kChunk, len - s0);
  if (n <= 0) {
    if (tid < G) {
      part_m[pidx * G + tid] = -INFINITY;
      part_l[pidx * G + tid] = 0.f;
    }
    for (int i = tid; i < G * D; i += kThreads) acc_out[i] = 0.f;
    return;
  }

  const bf16* qb = q + bh * G * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i / D][i % D] = __bfloat162float(qb[i]);
  __syncthreads();

  const T* kb = kc + (bh * S + s0) * D;
  const T* vb = vc + (bh * S + s0) * D;
  // scores: thread t owns cache position s0 + t (kChunk == kThreads) and
  // reads its key row with independent 16-byte loads
  if (tid < n) {
    float part[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
    const T* krow = kb + (long long)tid * D;
    for (int d0 = 0; d0 < D; d0 += kVec) {
      float kf[kVec];
      load16(krow + d0, kf);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) part[g] += qs[g][d0 + j] * kf[j];
    }
    const float kscale = ks ? ks[bh * S + s0 + tid] : 1.f;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) ps[g][tid] = ks ? part[g] * scale * kscale : part[g] * scale;
  }
  __syncthreads();

  for (int g = warp; g < G; g += kThreads / 32) {
    float mx = -INFINITY;
    for (int p = lane; p < n; p += 32) mx = fmaxf(mx, ps[g][p]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float e = expf(ps[g][p] - mx);
      ps[g][p] = vs ? e * vs[bh * S + s0 + p] : e;  // v's scale folds into p
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_m[pidx * G + g] = mx;
      part_l[pidx * G + g] = sum;
    }
  }
  __syncthreads();

  for (int d = tid; d < D; d += kThreads) {
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int p = 0; p < n; ++p) {
      const float vv = to_float(vb[(long long)p * D + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] += ps[g][p] * vv;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc_out[g * D + d] = acc[g];
  }
}

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// grid (B * Hkv * G): merge the chunks of one query head → out [B, Hkv, G, D].
// Chunk weights exp(m_i - M) go to shared memory, then each thread sums its
// output column over the chunks with independent loads.
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, bf16* __restrict__ out, int G, int D,
    int nchunks) {
  extern __shared__ float w[];  // [nchunks]
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;  // (b * Hkv + hk) * G + g
  const long long bh = row / G;
  const int g = int(row % G);
  const int tid = threadIdx.x;
  auto at = [&](int i) { return (bh * nchunks + i) * G + g; };
  float m = -INFINITY;
  for (int i = tid; i < nchunks; i += kThreads) m = fmaxf(m, part_m[at(i)]);
  const float M = block_reduce(m, true, red);
  float l = 0.f;
  for (int i = tid; i < nchunks; i += kThreads) {
    const float mi = part_m[at(i)];
    const float wi = mi == -INFINITY ? 0.f : expf(mi - M);
    w[i] = wi;
    l += part_l[at(i)] * wi;
  }
  const float L = fmaxf(block_reduce(l, false, red), 1e-30f);  // syncs w too
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll 4
    for (int i = 0; i < nchunks; ++i) o += part_acc[at(i) * D + d] * w[i];
    out[row * D + d] = __float2bfloat16(o / L);
  }
}

}  // namespace

extern "C" const char* ufv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, Hkv, G, D], k / v cache [B, Hkv, S, D] (contiguous, 16-byte
// aligned, D a multiple of 8), lens [B] int32,
// out [B, Hkv, G, D]; part_m / part_l hold B*Hkv*n_chunks*G floats and
// part_acc B*Hkv*n_chunks*G*D floats, n_chunks = ceil(S / 128).
template <typename T>
int decode_attention(const void* q, const void* k, const void* v, const void* ks,
                     const void* vs, const void* lens, void* out, void* part_m,
                     void* part_l, void* part_acc, int B, int Hkv, int G, int S, int D,
                     float scale, void* stream) {
  constexpr int kVec = 16 / int(sizeof(T));
  if (B <= 0 || Hkv <= 0 || S <= 0 || G <= 0 || G > kMaxG || D <= 0 || D > kMaxD || D % kVec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (S + kChunk - 1) / kChunk;
  dim3 grid(nchunks, Hkv, B);
  decode_partial_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lens), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), Hkv, G, S, D, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<B * Hkv * G, kThreads, nchunks * sizeof(float), st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<bf16*>(out), G, D, nchunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lens, void* out, void* part_m,
                                     void* part_l, void* part_acc, int B, int Hkv,
                                     int G, int S, int D, float scale, void* stream) {
  return decode_attention<bf16>(q, k, v, nullptr, nullptr, lens, out, part_m, part_l,
                                part_acc, B, Hkv, G, S, D, scale, stream);
}

// The same on an int8 cache: k / v [B, Hkv, S, D] int8 (D a multiple of 16),
// k_scale / v_scale [B, Hkv, S] f32.
extern "C" int decode_attention_q8(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* lens, void* out, void* part_m,
                                   void* part_l, void* part_acc, int B, int Hkv, int G,
                                   int S, int D, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return decode_attention<int8_t>(q, k, v, k_scale, v_scale, lens, out, part_m, part_l,
                                  part_acc, B, Hkv, G, S, D, scale, stream);
}
