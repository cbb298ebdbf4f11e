// Online-softmax attention forward for one (batch, head, 64-row query tile),
// shared by csrc/flash_attention.cu (Qwen2 prefill, Hiera global blocks,
// SAM2 memory attention) and csrc/hiera_block.cu (SigLIP / Hiera window
// attention, pooled queries against a whole window).
//
// Replaces the TPU kernel ufvideo_tpu/ops/flash_attention.py flash_attention
// (_kernel). Same math: scores = (q . k) * scale in f32, masked to
// finfo(f32).min past kv_lens[b], where kv_mask is 0, and (causal) above the
// diagonal aligned to the buffer end (query row r sits at position
// r + Skv - Sq); running max clamped at min/2 so fully masked rows give 0;
// probabilities cast to bf16 for the P.V product with f32 accumulation;
// output = acc / max(l, 1e-30).
//
// Bound on an H100: at the Qwen2-7B prefill shape (2.8k tokens, head dim
// 128) the work is ~57 GFLOP of tensor-core products against ~50 MB of
// traffic, so it is bound by operations. Design (FlashAttention-2 style):
// each of the 4 warps owns 16 query rows; its Q fragments, score tile,
// running max / sum and output accumulator stay in registers across the
// whole kv loop. Products are mma.sync m16n8k16 bf16 -> f32 with operands
// fetched from shared memory by ldmatrix (V transposed on the fly); the
// score accumulators are re-packed in registers as the A operand of P.V.
// Only the K/V tile loads need block-wide barriers. Whole K/V tiles past
// kv_lens[b] or above the causal diagonal are never loaded, and a tile
// whose keys are all zero in kv_mask (an empty SAM2 memory slot is 4096 such
// keys) is skipped after one block-wide vote. Head dims 64 / 80 / 128 / 256
// are template instances; a head dim below the instance (72 for SigLIP and
// Hiera) is zero-padded in shared memory. At head dim 256 (SAM2 memory
// attention) the output accumulator alone is 128 registers a thread, so the
// tile is narrowed: 32 keys a step instead of 64 (16 score registers
// instead of 32) and the Q fragments are re-read from shared memory at each
// k-step instead of living in 64 registers. Not yet used: wgmma, TMA, a
// cp.async pipeline for the K/V tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ufv {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

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

// reductions over the 4 lanes of a quad (the lanes holding one mma row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* kv_lens;      // [B] or nullptr (all Skv)
  const uint8_t* kv_mask;  // [B, Skv] or nullptr
  int B, Sq, Skv, Hq, Hkv, D;
  // element strides: batch, sequence row, head
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

constexpr int kAttBQ = 64;
constexpr int kAttThreads = 128;  // 4 warps x 16 query rows

template <int DP>
struct AttnSmem {
  static constexpr int LDH = DP + 8;  // bf16 row stride: 16-byte aligned, odd in 16 B
  static constexpr int BK = DP > 128 ? 32 : 64;  // keys per step
  static constexpr bool QREG = DP <= 128;        // Q fragments live in registers
  static constexpr size_t bytes = size_t(kAttBQ + 2 * BK) * LDH * 2;  // Q, K, V
};

// Copy a ROWS-row tile (row stride `rs` elements) into shared memory with
// row stride DP + 8, zero-filling rows >= rows_valid and columns >= D. Rows
// are read as 16-byte vectors: attention_forward requires D and every
// stride to be multiples of 8 and the base pointers 16-byte aligned.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long rs,
                                          int rows_valid, int D) {
  constexpr int LDH = DP + 8;
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += kAttThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid && c < D)
      val = *reinterpret_cast<const uint4*>(src + r * rs + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kAttThreads) flash_fwd_kernel(AttnArgs a) {
  constexpr int LDH = AttnSmem<DP>::LDH;
  constexpr int BK = AttnSmem<DP>::BK;
  constexpr bool QREG = AttnSmem<DP>::QREG;
  constexpr int KQ = DP / 16;      // k-steps of Q.K^T
  constexpr int ND = DP / 8;       // 8-column blocks of the output
  constexpr int NS = BK / 8;       // 8-column blocks of the score tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kAttBQ * LDH;
  bf16* Vs = Ks + BK * LDH;

  const int q0 = blockIdx.x * kAttBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma row group, column pair
  const int hk = h / (a.Hq / a.Hkv);        // shared kv head (GQA), no KV repeat
  int kv_len = a.kv_lens ? a.kv_lens[b] : a.Skv;
  kv_len = min(max(kv_len, 0), a.Skv);
  const int offset = a.Skv - a.Sq;
  int kv_end = kv_len;
  if (a.causal) {
    const int q_last = min(q0 + kAttBQ, a.Sq) - 1;
    kv_end = min(kv_end, q_last + offset + 1);
  }

  load_tile<DP, kAttBQ>(Qs, a.q + b * a.q_sb + (long long)q0 * a.q_ss + h * a.q_sh,
                        a.q_ss, min(kAttBQ, a.Sq - q0), a.D);
  __syncthreads();

  const int r0 = warp * 16;  // this warp's query-row band
  const int row_lo = q0 + r0 + g, row_hi = row_lo + 8;
  const bf16* qfrag = Qs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + (lane >> 4) * 8;
  uint32_t qf[QREG ? KQ : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) ldmatrix_x4(qf[kk], qfrag + kk * 16);
  }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;  // l: this lane's columns

  const bf16* kbase = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vbase = a.v + b * a.v_sb + hk * a.v_sh;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    // one vote of the block: does kv_mask keep any key of this tile? The
    // vote is also the barrier after which the previous K/V tile is free.
    int live = 1;
    if (a.kv_mask) {
      live = 0;
      if (tid < BK && kv0 + tid < kv_len)
        live = a.kv_mask[(long long)b * a.Skv + kv0 + tid] != 0;
    }
    if (!__syncthreads_or(live)) continue;  // fully masked: m, l, o untouched
    const int rows = min(BK, a.Skv - kv0);
    load_tile<DP, BK>(Ks, kbase + (long long)kv0 * a.k_ss, a.k_ss, rows, a.D);
    load_tile<DP, BK>(Vs, vbase + (long long)kv0 * a.v_ss, a.v_ss, rows, a.D);
    __syncthreads();

    // S[16, BK] = Q[16, DP] . K[BK, DP]^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
        qa[0] = qf[kk][0]; qa[1] = qf[kk][1]; qa[2] = qf[kk][2]; qa[3] = qf[kk][3];
      } else {
        ldmatrix_x4(qa, qfrag + kk * 16);
      }
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDH + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], qa, kf[0], kf[1]);
        mma_bf16(s[2 * j2 + 1], qa, kf[2], kf[3]);
      }
    }

    // scale + mask; element e of block j is row (e < 2 ? lo : hi),
    // column kv0 + 8 j + 2 tig + (e & 1)
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 8 * j + 2 * tig + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        bool valid = col < kv_len;
        if (valid && a.kv_mask) valid = a.kv_mask[(long long)b * a.Skv + col] != 0;
        if (valid && a.causal) valid = (col - offset) <= row;
        s[j][e] = valid ? s[j][e] * a.scale : kNegInf;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float ms_lo = fmaxf(mn_lo, kNegInf * 0.5f);
    const float ms_hi = fmaxf(mn_hi, kNegInf * 0.5f);
    const float corr_lo = expf(fmaxf(m_lo, kNegInf * 0.5f) - ms_lo);
    const float corr_hi = expf(fmaxf(m_hi, kNegInf * 0.5f) - ms_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = expf(s[j][0] - ms_lo);
      s[j][1] = expf(s[j][1] - ms_lo);
      s[j][2] = expf(s[j][2] - ms_hi);
      s[j][3] = expf(s[j][3] - ms_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * corr_lo + sum_lo;
    l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= corr_lo;
      o[j][1] *= corr_lo;
      o[j][2] *= corr_hi;
      o[j][3] *= corr_hi;
    }

    // O[16, DP] += P[16, BK] . V[BK, DP]; P re-packed from the score registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j2 = 0; j2 < ND / 2; ++j2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH +
                                  j2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * j2], pa, vf[0], vf[1]);
        mma_bf16(o[2 * j2 + 1], pa, vf[2], vf[3]);
      }
    }
  }

  const float inv_lo = 1.f / fmaxf(quad_sum(l_lo), 1e-30f);
  const float inv_hi = 1.f / fmaxf(quad_sum(l_hi), 1e-30f);
  bf16* obase = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = 8 * j + 2 * tig;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_lo : row_hi;
      const int col = c + (e & 1);
      if (row < a.Sq && col < a.D)
        obase[(long long)row * a.o_ss + col] =
            __float2bfloat16(o[j][e] * (e < 2 ? inv_lo : inv_hi));
    }
  }
}

template <int DP>
inline cudaError_t launch_flash(const AttnArgs& a, cudaStream_t stream) {
  const size_t bytes = AttnSmem<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kAttBQ - 1) / kAttBQ, a.Hq, a.B);
  flash_fwd_kernel<DP><<<grid, kAttThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Dispatch on head dim: 64, 80 (SigLIP's and Hiera's 72 padded), 128 or 256.
inline cudaError_t attention_forward(const AttnArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Hq <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0)
    return cudaErrorInvalidValue;
  const long long strides = a.q_sb | a.q_ss | a.q_sh | a.k_sb | a.k_ss | a.k_sh |
                            a.v_sb | a.v_ss | a.v_sh;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  if (a.D % 8 != 0 || strides % 8 != 0 || (ptrs & 15) != 0)
    return cudaErrorMisalignedAddress;
  if (a.D <= 64) return launch_flash<64>(a, stream);
  if (a.D <= 80) return launch_flash<80>(a, stream);
  if (a.D <= 128) return launch_flash<128>(a, stream);
  if (a.D <= 256) return launch_flash<256>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace ufv
