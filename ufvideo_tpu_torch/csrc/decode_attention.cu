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
// v_scale[pos]); no dequantised copy of the cache exists.
//
// Bound on an H100: bytes. A step reads the valid cache once (Qwen2-7B: 4 kv
// heads x 2.8k positions x 128 x 2 bytes x 2 = 5.7 MB bf16, 2.9 MB int8 plus
// 4 bytes of scales a position and tensor), 1.7 us and 0.9 us at 3.35 TB/s,
// and does ~2 operations a byte, far below the card's ridge, so no tensor
// cores. The design keeps enough coalesced bytes in flight to reach that:
// - split-KV: the row is cut into chunks of 32 or 64 positions
//   (ops/decode_attention.py decode_split_plan, from the shape alone: 64 at
//   batch 1, 184 blocks), and 168 registers a thread keep three blocks an SM
//   resident, so the grid runs in one wave;
// - each block issues every 16-byte cp.async copy of its chunk's K and V
//   (and scales) before its first use, committed in groups of 32 positions,
//   neighbouring threads on neighbouring addresses: 32 KB (bf16) or 17 KB
//   (int8) a 64-position block in flight;
// - compute from shared memory: a lane owns 8 head-dim columns of a
//   position (D / 8 lanes, rounded up to a power of two and a template
//   argument, share a position, so a warp reads whole rows), dots its slice
//   with q (f32 in shared memory, scale * log2(e) folded in, zero rows up to
//   8 heads so no loop branches on G) and sums the slices with
//   __shfl_xor_sync; each lane group keeps an online softmax in ex2
//   (running max and sum per head) and the unnormalised P.V of its 8
//   columns in f32 registers;
// - the lane groups of a block merge in shared memory in a fixed order and
//   write (max, sum, acc) per head and chunk (max in log2 units); a second
//   launch merges the chunks of each head with all its loads in flight and
//   a fixed order. Both passes are deterministic for a given shape, and a
//   chunk wholly past lens[b] reads nothing and weighs 0.
// What holds it back: instruction issue, not bytes. By count of this
// source, eight positions cost a warp ~1100 instructions, 512 of them the
// FMAs of the two products and the rest shuffles, softmax and conversions.
// And on an H100 (scripts/torch_decode_sweep.py) the pair with a cold L2
// takes ~7 us more than its two kernels warm: the gap between the
// launches, the length read that gates the copies, HBM latency.
// The P.V product keeps f32 probabilities (the TPU kernel rounds them to
// bf16), which is closer to the f32 reference. An empty row gives 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxG = 8;       // query heads per kv head
constexpr int kMaxD = 128;
constexpr int kCols = 8;        // head-dim columns a lane owns
constexpr int kGroup = 32;      // positions a cp.async commit group
constexpr int kMaxChunk = 64;   // positions a block (decode_split_plan's largest)
constexpr int kNB = 4;          // positions a lane group scores at once
constexpr int kMinBlocks = 3;   // resident blocks an SM (caps registers at 168)
constexpr int kCombineThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// 2^x, the special-function unit's approximation (2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wait until at most n (0 or 1: a chunk is at most two groups) are pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n) asm volatile("cp.async.wait_group 1;\n" ::);
  else asm volatile("cp.async.wait_group 0;\n" ::);
}

// the 8 cache values of a lane's columns, from shared memory, as floats
__device__ __forceinline__ void load_cols(const bf16* p, float (&f)[kCols]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// int8 -> float exactly without I2F: the byte with its sign bit flipped is
// x + 128, placed in the mantissa of 2^23
__device__ __forceinline__ void load_cols(const int8_t* p, float (&f)[kCols]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const unsigned w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * h + j] = __uint_as_float(__byte_perm(w[h], 0x4B000000u, 0x7650 + j)) - 8388736.f;
}

// grid (n_chunks, Hkv, B), kThreads threads, dynamic shared memory as
// decode_smem_bytes gives. part_m / part_l [B, Hkv, n_chunks, G] (max in
// log2 units), part_acc [B, Hkv, n_chunks, G, D]. T is the cache's type:
// bf16 (ks / vs null) or int8 with the scales ks / vs [B, Hkv, S]. LP lanes
// share a position (the power of two with LP * 8 >= D), so every loop over
// lanes, positions and lane groups has a bound known to the compiler.
template <typename T, int LP>
__global__ void __launch_bounds__(kThreads, kMinBlocks) decode_partial_kernel(
    const bf16* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ lens, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int Hkv, int G, int S, int D, int chunk, float qscale) {
  constexpr int kPW = 32 / LP;                  // positions a warp instruction
  constexpr int kR = (kThreads / 32) * kPW;     // lane groups a block
  constexpr int kQPer = kMaxG * kMaxD / kThreads;  // q values a thread loads
  constexpr bool kScaled = sizeof(T) == 1;          // int8: per-position scales
  extern __shared__ __align__(16) unsigned char smem[];
  const int ci = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nchunks = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = (long long)b * Hkv + hk;
  const long long pidx = bh * nchunks + ci;
  float* acc_out = part_acc + pidx * G * D;
  const int s0 = ci * chunk;

  // q's loads go out beside lens[b]'s; rows G..kMaxG-1 are zeros, so the
  // loops below run over kMaxG heads with no branch
  const bf16* qb = q + bh * G * D;
  bf16 qv[kQPer];
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int i = tid + k * kThreads;
    qv[k] = i < G * D ? qb[i] : __float2bfloat16(0.f);
  }
  const int n = min(chunk, min(lens[b], S) - s0);  // valid positions of the chunk
  if (n <= 0) {  // wholly past lens[b]: read nothing, weigh 0
    if (tid < G) {
      part_m[pidx * G + tid] = -INFINITY;
      part_l[pidx * G + tid] = 0.f;
    }
    for (int i = tid; i < G * D; i += kThreads) acc_out[i] = 0.f;
    return;
  }

  // shared memory: qs [kMaxG, D] f32 | then either the chunk (kbuf, vbuf
  // [chunk, D] of T, ksc, vsc [chunk] f32) or, after the loop, the merge
  // (racc [kR, G, D], rm, rl [kR, G] f32)
  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* region = smem + kMaxG * D * sizeof(float);
  T* kbuf = reinterpret_cast<T*>(region);
  T* vbuf = kbuf + chunk * D;
  float* ksc = reinterpret_cast<float*>(vbuf + chunk * D);
  float* vsc = ksc + chunk;

  // 1. every copy of the chunk in flight, a commit group per kGroup positions
  const T* kg = kc + (bh * S + s0) * D;
  const T* vg = vc + (bh * S + s0) * D;
  constexpr int kVec = 16 / int(sizeof(T));  // cache values a 16-byte copy
  const int row_vecs = D / kVec;
  const int ngroups = (n + kGroup - 1) / kGroup;
  for (int gi = 0; gi < ngroups; ++gi) {
    const int p0 = gi * kGroup, np = min(kGroup, n - p0);
    const int first = p0 * row_vecs, pieces = np * row_vecs;
    for (int i = tid; i < pieces; i += kThreads) {
      const int off = (first + i) * kVec;
      cp_async16(kbuf + off, kg + off);
      cp_async16(vbuf + off, vg + off);
    }
    if (kScaled && tid < np) {
      cp_async4(ksc + p0 + tid, ks + bh * S + s0 + p0 + tid);
      cp_async4(vsc + p0 + tid, vs + bh * S + s0 + p0 + tid);
    }
    cp_async_commit();
  }
  // q with scale * log2(e) folded in, while the copies fly
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int i = tid + k * kThreads;
    if (i < kMaxG * D) qs[i] = __bfloat162float(qv[k]) * qscale;
  }

  // 2. lane groups: LP lanes a position, 8 columns a lane
  const int slot = warp * kPW + lane / LP;
  const int col0 = (lane % LP) * kCols;
  const bool active = col0 < D;  // D < LP * 8: the last lanes hold no column
  const int col0c = active ? col0 : 0;  // where they read q (their k is 0)

  float m[kMaxG], l[kMaxG], acc[kMaxG][kCols];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  }

  for (int gi = 0; gi < ngroups; ++gi) {
    cp_async_wait(ngroups - 1 - gi);
    __syncthreads();
    const int p0 = gi * kGroup;
    // positions p0 + slot + j * kR of the group; the bound is uniform in a warp
#pragma unroll
    for (int j0 = 0; j0 * kR < kGroup; j0 += kNB) {
      if (warp * kPW + j0 * kR >= kGroup) break;
      float kf[kNB][kCols];
      bool vld[kNB];
#pragma unroll
      for (int u = 0; u < kNB; ++u) {
        const int pl = slot + (j0 + u) * kR;
        vld[u] = (kNB * kR <= kGroup || pl < kGroup) && p0 + pl < n;
#pragma unroll
        for (int c = 0; c < kCols; ++c) kf[u][c] = 0.f;
        if (vld[u] && active) load_cols(kbuf + (p0 + pl) * D + col0, kf[u]);
      }
      // each head's q slice is read once for the kNB positions
      float sc[kNB][kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + g * D + col0c);
        const float4 qb4 = *reinterpret_cast<const float4*>(qs + g * D + col0c + 4);
#pragma unroll
        for (int u = 0; u < kNB; ++u)
          sc[u][g] = qa.x * kf[u][0] + qa.y * kf[u][1] + qa.z * kf[u][2] + qa.w * kf[u][3] +
                     qb4.x * kf[u][4] + qb4.y * kf[u][5] + qb4.z * kf[u][6] + qb4.w * kf[u][7];
      }
      // sum the slices of each position over its LP lanes: one level of the
      // butterfly for every (position, head) before the next level
#pragma unroll
      for (int o = LP / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kNB; ++u)
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
      float kscale[kNB], vscale[kNB];
#pragma unroll
      for (int u = 0; u < kNB; ++u) {
        const int pc = p0 + slot + (j0 + u) * kR;
        kscale[u] = kScaled && vld[u] ? ksc[pc] : 1.f;
        vscale[u] = kScaled && vld[u] ? vsc[pc] : 1.f;
      }
      // online softmax: new max, rescale, probabilities (p stays in sc);
      // a lane group that has seen no position yet keeps m = -inf, p = 0
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kNB; ++u) {
          sc[u][g] = vld[u] ? (kScaled ? sc[u][g] * kscale[u] : sc[u][g]) : -INFINITY;
          mx = fmaxf(mx, sc[u][g]);
        }
        const bool seen = mx != -INFINITY;
        const float corr = seen ? ex2(m[g] - mx) : 1.f;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kNB; ++u) {
          const float p = vld[u] ? ex2(sc[u][g] - mx) : 0.f;
          sum += p;
          sc[u][g] = kScaled ? p * vscale[u] : p;  // v's scale folds into p
        }
        l[g] = l[g] * corr + sum;
        m[g] = mx;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[g][c] *= corr;
      }
      // unnormalised P.V on the lane's columns (p = 0 where no position)
#pragma unroll
      for (int u = 0; u < kNB; ++u) {
        float vf[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vf[c] = 0.f;
        if (vld[u] && active) load_cols(vbuf + (p0 + slot + (j0 + u) * kR) * D + col0, vf);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[g][c] += sc[u][g] * vf[c];
      }
    }
  }
  __syncthreads();  // the chunk is no longer read: its space takes the merge

  // 3. merge the kR lane groups in a fixed order
  float* racc = reinterpret_cast<float*>(region);  // [kR, G, D]
  float* rm = racc + kR * G * D;                   // [kR, G]
  float* rl = rm + kR * G;
  if (active) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) {
        float4* dst = reinterpret_cast<float4*>(racc + (slot * G + g) * D + col0);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
  }
  if (lane % LP == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) {
        rm[slot * G + g] = m[g];
        rl[slot * G + g] = l[g];
      }
  }
  __syncthreads();
  // each thread merges the outputs it writes; a head's maximum and weights
  // are read by every thread of that head (shared-memory broadcasts)
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kR; ++r) M = fmaxf(M, rm[r * G + g]);
    float o = 0.f, L = 0.f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float mr = rm[r * G + g];
      const float w = mr == -INFINITY ? 0.f : ex2(mr - M);
      o += w * racc[(r * G + g) * D + d];
      L += w * rl[r * G + g];
    }
    acc_out[i] = o;
    if (d == 0) {
      part_m[pidx * G + g] = M;
      part_l[pidx * G + g] = L;
    }
  }
}

// grid (B * Hkv * G), kCombineThreads threads: merge the chunks of one
// query head → out [B, Hkv, G, D]. Warp r takes chunks r, r + kRows, ...,
// kLoads of them at a time with every load issued before the first use;
// each thread keeps an online (max, sum, float4 of columns) over them, and
// the kRows warps merge in shared memory in a fixed order.
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, bf16* __restrict__ out, int G, int D,
    int nchunks) {
  constexpr int kRows = kCombineThreads / 32;
  constexpr int kLoads = 8;
  __shared__ float4 rows_o[kRows][32];
  __shared__ float rows_m[kRows], rows_l[kRows];
  const long long row = blockIdx.x;  // (b * Hkv + hk) * G + g
  const long long bh = row / G;
  const int g = int(row % G);
  const int tid = threadIdx.x, r = tid >> 5, cq = tid & 31;
  const bool has_col = cq * 4 < D;
  auto at = [&](int i) { return (bh * nchunks + i) * G + g; };
  float M = -INFINITY, L = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = r; i0 < nchunks; i0 += kRows * kLoads) {
    float mi[kLoads], li[kLoads];
    float4 ai[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = i0 + k * kRows;
      const bool ok = i < nchunks;
      mi[k] = ok ? part_m[at(i)] : -INFINITY;
      li[k] = ok ? part_l[at(i)] : 0.f;
      ai[k] = ok && has_col ? *reinterpret_cast<const float4*>(part_acc + at(i) * D + cq * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float mx = M;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) mx = fmaxf(mx, mi[k]);
    if (mx == -INFINITY) continue;  // only chunks past lens so far
    const float corr = ex2(M - mx);
    L *= corr;
    o.x *= corr;
    o.y *= corr;
    o.z *= corr;
    o.w *= corr;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const float w = mi[k] == -INFINITY ? 0.f : ex2(mi[k] - mx);
      L += w * li[k];
      o.x += w * ai[k].x;
      o.y += w * ai[k].y;
      o.z += w * ai[k].z;
      o.w += w * ai[k].w;
    }
    M = mx;
  }
  if (cq == 0) {
    rows_m[r] = M;
    rows_l[r] = L;
  }
  rows_o[r][cq] = o;
  __syncthreads();
  if (tid < 32 && has_col) {
    float Mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kRows; ++k) Mx = fmaxf(Mx, rows_m[k]);
    float Lt = 0.f;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const float w = rows_m[k] == -INFINITY ? 0.f : ex2(rows_m[k] - Mx);
      const float4 a = rows_o[k][tid];
      Lt += w * rows_l[k];
      s.x += w * a.x;
      s.y += w * a.y;
      s.z += w * a.z;
      s.w += w * a.w;
    }
    const float inv = 1.f / fmaxf(Lt, 1e-30f);  // an empty row: 0 / 1e-30 = 0
    bf16* dst = out + row * D + tid * 4;
    dst[0] = __float2bfloat16(s.x * inv);
    dst[1] = __float2bfloat16(s.y * inv);
    dst[2] = __float2bfloat16(s.z * inv);
    dst[3] = __float2bfloat16(s.w * inv);
  }
}

// lanes a position: the power of two with lp * 8 >= D
inline int lanes_per_position(int D) {
  int lp = 1;
  while (lp * kCols < D) lp <<= 1;
  return lp;
}

// dynamic shared memory of decode_partial_kernel: q, then the larger of the
// chunk and the merge
template <typename T>
size_t decode_smem_bytes(int G, int D, int chunk) {
  const size_t R = size_t(kThreads / 32) * (32 / lanes_per_position(D));
  const size_t kv = 2 * size_t(chunk) * D * sizeof(T) + 2 * size_t(chunk) * sizeof(float);
  const size_t merge = (R * G * D + 2 * R * G) * sizeof(float);
  return size_t(kMaxG) * D * sizeof(float) + (kv > merge ? kv : merge);
}
// Every shape fits the 48 KB a launch gets without opting in: the chunk
// holds at most kMaxChunk rows of kMaxD bf16 values (and their scales), and
// the merge's R = kThreads / LP lane groups hold R * D <= kThreads * kCols
// floats a head.
constexpr int kMaxChunkBytes = 2 * kMaxChunk * kMaxD * 2 + 2 * kMaxChunk * 4;
constexpr int kMaxMergeBytes = (kMaxG * kThreads * kCols + 2 * kThreads * kMaxG) * 4;
static_assert(kMaxG * kMaxD * 4 + (kMaxChunkBytes > kMaxMergeBytes ? kMaxChunkBytes
                                                                   : kMaxMergeBytes) <=
                  48 * 1024,
              "decode_partial_kernel's shared memory exceeds the default 48 KB");

template <typename T, int LP>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t st, const void* q,
                           const void* k, const void* v, const void* ks, const void* vs,
                           const void* lens, void* part_m, void* part_l, void* part_acc,
                           int Hkv, int G, int S, int D, int chunk, float qscale) {
  decode_partial_kernel<T, LP><<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lens), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), Hkv, G, S, D, chunk,
      qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* ufv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [B, Hkv, G, D], k / v cache [B, Hkv, S, D] (contiguous, 16-byte
// aligned, D a multiple of 8), lens [B] int32, out [B, Hkv, G, D]; chunk 32
// or 64 (ops/decode_attention.py decode_split_plan);
// part_m / part_l hold B*Hkv*n_chunks*G floats and part_acc
// B*Hkv*n_chunks*G*D floats, n_chunks = ceil(S / chunk).
template <typename T>
int decode_attention(const void* q, const void* k, const void* v, const void* ks,
                     const void* vs, const void* lens, void* out, void* part_m,
                     void* part_l, void* part_acc, int B, int Hkv, int G, int S, int D,
                     int chunk, float scale, void* stream) {
  constexpr int kVec = 16 / int(sizeof(T));
  if (B <= 0 || Hkv <= 0 || S <= 0 || G <= 0 || G > kMaxG || D <= 0 || D > kMaxD ||
      D % kVec || D % kCols || chunk <= 0 || chunk > kMaxChunk || chunk % kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = (S + chunk - 1) / chunk;
  const dim3 grid(nchunks, Hkv, B);
  const size_t smem = decode_smem_bytes<T>(G, D, chunk);
  const float qscale = scale * kLog2e;
  cudaError_t err;
  switch (lanes_per_position(D)) {
#define UFV_PARTIAL(LP)                                                                   \
  case LP:                                                                                \
    err = launch_partial<T, LP>(grid, smem, st, q, k, v, ks, vs, lens, part_m, part_l,   \
                                part_acc, Hkv, G, S, D, chunk, qscale);                  \
    break;
    UFV_PARTIAL(1)
    UFV_PARTIAL(2)
    UFV_PARTIAL(4)
    UFV_PARTIAL(8)
    UFV_PARTIAL(16)
#undef UFV_PARTIAL
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<B * Hkv * G, kCombineThreads, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<bf16*>(out), G, D, nchunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lens, void* out, void* part_m,
                                     void* part_l, void* part_acc, int B, int Hkv,
                                     int G, int S, int D, int chunk, float scale,
                                     void* stream) {
  return decode_attention<bf16>(q, k, v, nullptr, nullptr, lens, out, part_m, part_l,
                                part_acc, B, Hkv, G, S, D, chunk, scale, stream);
}

// The same on an int8 cache: k / v [B, Hkv, S, D] int8 (D a multiple of 16),
// k_scale / v_scale [B, Hkv, S] f32.
extern "C" int decode_attention_q8(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* lens, void* out, void* part_m,
                                   void* part_l, void* part_acc, int B, int Hkv, int G,
                                   int S, int D, int chunk, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return decode_attention<int8_t>(q, k, v, k_scale, v_scale, lens, out, part_m, part_l,
                                  part_acc, B, Hkv, G, S, D, chunk, scale, stream);
}
