// Online-softmax attention forward for one (batch, head, query tile, key
// split), shared by csrc/flash_attention.cu (Qwen2 prefill, Hiera global
// blocks, SAM2 memory attention and mask decoder), csrc/packed_attention.cu
// and csrc/hiera_block.cu (SigLIP / Hiera window attention, pooled queries
// against a whole window).
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
// traffic, so it is bound by operations; at head dim 72 the exponentials
// (one MUFU op a score against 320 flops of products) come close to it.
// Hopper design (FlashAttention-3 style):
// - A block is one producer warpgroup and NWG consumer warpgroups of 64
//   query rows each (NWG = 2, or 1 when Sq <= 64). The producer's first warp
//   loads each work item's Q tile (double-buffered) and streams its K and V
//   tiles by TMA into a ring of 2-3 stages of swizzled shared memory, each
//   stage guarded by a full and an empty mbarrier; it also votes on kv_mask
//   and skips a tile whose keys are all masked (an empty SAM2 memory slot is
//   4096 such keys), and copies the tile's mask bytes beside it.
// - Both products are wgmma.mma_async: S = Q . K^T (m64 x BN x k16, Q and K
//   K-major from shared memory) and O += P . V (P from registers: the score
//   accumulators packed to bf16 pairs are exactly wgmma's register A
//   fragments; V MN-major through the descriptor's transpose bit). Within a
//   warpgroup, the P . V of tile j runs while the softmax of tile j + 1 does
//   (its Q . K^T issued beside it); the running max / sum and O stay in
//   registers across the key loop. The softmax is 2^(s c - m c): one fused
//   multiply-add and one ex2 a score.
// - Head dims have instances of their own: 16 and 32 (one 32- or 64-byte-
//   swizzled column block), 64, 80, 128 and 256. A row of 80 is a 128-byte
//   block of 64 columns plus a 32-byte block of 16; TMA zero-fills columns
//   72-79 of SigLIP's and Hiera's head dim 72. Keys a step: 128, or 64 at
//   head dim 256 (where O alone is 128 registers a thread) and for calls of
//   at most 64 keys (Hiera's windows: two such blocks fit an SM).
// - Work items (a query tile of a head of a batch entry, over one split of
//   the keys) are walked by a persistent grid when they are short, so the
//   next item's loads overlap this one's products; long items take a block
//   each, the causal ones heaviest first.
// - Whole K/V tiles past kv_lens[b] or above the causal diagonal are never
//   loaded. When the query tiles cannot fill the card (the split plan comes
//   from the caller: ops/flash_attention.py split_plan), the keys are cut
//   into `splits` chunks of whole tiles; each split writes its unnormalised
//   f32 output, running max and sum to scratch, and flash_merge_kernel
//   combines them in split order (deterministic; a split with no visible
//   key has sum 0 and weight 0).
#pragma once

#include "hopper.cuh"

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

// reductions over the 4 lanes of a quad (the lanes holding one accumulator row)
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

// 2^x (MUFU.EX2; flushes denormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
  // split of the keys: split s takes keys [s * chunk, (s + 1) * chunk);
  // with splits > 1 the partial sums go to part_o [splits, B, Hq, Sq, D] and
  // part_ml [splits, B, Hq, Sq, 2] (running max, sum), f32
  int splits = 1;
  int chunk = 0;
  float* part_o = nullptr;
  float* part_ml = nullptr;
};

// keys a step of the instance that takes head dim d (the split plan's unit);
// calls with at most 64 keys take a 64-key tile (launch_flash_d)
__host__ __device__ constexpr int attention_block_kv(int d) { return d > 128 ? 64 : 128; }

// The shape of an instance: head dim D in NB64 128-byte column blocks of 64
// and a TAIL block of 0, 16 or 32 columns; BN keys a step; STAGES K/V tiles
// in flight; NWG consumer warpgroups of 64 query rows. An instance with one
// consumer warpgroup and 64-key tiles at head dim <= 80 (Hiera's 16- and
// 64-token windows) fits two blocks an SM.
template <int D, int NWG, int BN_>
struct AttnCfg {
  static constexpr int NB64 = D / 64;
  static constexpr int TAIL = D % 64;
  static constexpr int BN = BN_;
  static constexpr int BQ = 64 * NWG;
  static constexpr int STAGES = D >= 128 ? 2 : 3;
  static constexpr int QBUF = D > 128 ? 1 : 2;  // Q tiles: the next item's loads early
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int PER_SM = NWG == 1 && BN == 64 && D <= 80 ? 2 : 1;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one K or one V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t SMEM = size_t(QBUF) * Q_BYTES + size_t(STAGES) * STAGE_BYTES +
                                 STAGES * BN + STAGES * 8 + (2 * STAGES + 2 * QBUF) * 8 + 1024;
  static_assert(TAIL == 0 || TAIL == 16 || TAIL == 32, "head dim instance");
};

// byte offset of column block `blk` in a tile of `rows` rows (blocks of 64
// columns first, then the tail)
__device__ __forceinline__ constexpr int block_offset(int blk, int rows) {
  return blk * rows * 128;
}

// The tensor maps of one call: for q, k and v one map with boxes of 64
// columns (128-byte swizzle) and one with boxes of the tail's columns. Dims
// (innermost first): head dim, head, sequence row, batch.
struct AttnMaps {
  CUtensorMap q64, qt, k64, kt, v64, vt;
};

// K-major descriptor of k-step kk (16 columns) of a tile of `rows` rows whose
// first used row is `row0`
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, int rows, int row0,
                                                int kk) {
  constexpr int NB64 = D / 64, TAIL = D % 64;
  if (kk < 4 * NB64)
    return hop::make_desc(tile + block_offset(kk / 4, rows) + row0 * 128 + (kk % 4) * 32, 16,
                          1024, 1);
  constexpr int RB = TAIL > 0 ? TAIL * 2 : 32;  // tail row bytes
  return hop::make_desc(tile + block_offset(NB64, rows) + row0 * RB + (kk - 4 * NB64) * 32,
                        16, 8 * RB, hop::desc_swizzle(RB));
}

// One work item: a query tile of one head of one batch entry, over the keys
// of one split. Producer and consumers walk the same items in the same
// order, so each derives what it needs on its own.
struct AttnItem {
  int q0, hq, hk, b, split, kv_len, kv_lo, kv_hi;
};

template <int BQ>
__device__ __forceinline__ AttnItem attn_item(const AttnArgs& a, int item) {
  const int nqt = (a.Sq + BQ - 1) / BQ;
  AttnItem t;
  // causal: the last query tiles, which see the most keys, go first
  t.q0 = (a.causal ? nqt - 1 - item % nqt : item % nqt) * BQ;
  const int rest = item / nqt;
  t.hq = rest % a.Hq;
  const int bz = rest / a.Hq;
  t.b = bz / a.splits;
  t.split = bz % a.splits;
  t.hk = t.hq / (a.Hq / a.Hkv);  // shared kv head (GQA), no KV repeat
  t.kv_len = min(max(a.kv_lens ? a.kv_lens[t.b] : a.Skv, 0), a.Skv);
  int kv_end = t.kv_len;
  if (a.causal) kv_end = min(kv_end, min(t.q0 + BQ, a.Sq) - 1 + (a.Skv - a.Sq) + 1);
  t.kv_lo = a.splits > 1 ? t.split * a.chunk : 0;
  t.kv_hi = a.splits > 1 ? min(t.kv_lo + a.chunk, kv_end) : kv_end;
  return t;
}

// Block i takes items i, i + gridDim.x, ... (launch_flash: one item a block
// when an item walks at least four key tiles, else a persistent grid of as
// many blocks as fit on the card). The producer runs ahead into the next
// item (its Q tile into the other Q buffer, its first K/V tiles into the
// ring) while the consumers finish the current one: Hiera's windows of 16-64
// keys are 4096-16384 such items. A stage whose tile start is -1 ends an
// item.
template <int D, int NWG, int BN_>
__global__ void __launch_bounds__(AttnCfg<D, NWG, BN_>::THREADS, AttnCfg<D, NWG, BN_>::PER_SM)
    flash_fwd_kernel(__grid_constant__ const AttnMaps maps, const AttnArgs a, int items) {
  namespace h = hop;
  using C = AttnCfg<D, NWG, BN_>;
  constexpr int BN = C::BN, BQ = C::BQ, ST = C::STAGES, NB64 = C::NB64, TAIL = C::TAIL;
  constexpr int QB = C::QBUF;
  constexpr int TRB = TAIL > 0 ? TAIL * 2 : 32;  // tail row bytes
  extern __shared__ __align__(1024) unsigned char att_smem_raw[];
  unsigned char* smem = att_smem_raw + ((1024 - (h::smem_u32(att_smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;                     // QB buffers of Q_BYTES
  unsigned char* KVs = smem + QB * C::Q_BYTES;  // stage s: K at s * STAGE_BYTES, V after it
  uint8_t* tmask = KVs + ST * C::STAGE_BYTES;
  int* tkv0 = reinterpret_cast<int*>(tmask + ST * BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(tkv0 + 2 * ST);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;
  uint64_t* qempty = qfull + QB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], 4 * NWG);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < QB; ++s) {
      h::mbar_init(&qfull[s], 1);
      h::mbar_init(&qempty[s], 4 * NWG);
    }
    h::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; its first warp loads
    if constexpr (NWG == 2) h::setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    constexpr int PER_LANE = BN / 32;  // mask bytes a lane reads
    int it = 0, qi = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++qi) {
      const AttnItem t = attn_item<BQ>(a, item);
      const int qb = qi % QB;
      h::mbar_wait(&qempty[qb], ((qi / QB) & 1) ^ 1);
      if (lane == 0) {
        unsigned char* q = Qs + qb * C::Q_BYTES;
        h::mbar_expect_tx(&qfull[qb], C::Q_BYTES);
#pragma unroll
        for (int blk = 0; blk < NB64; ++blk)
          h::tma_load_4d(q + block_offset(blk, BQ), &maps.q64, &qfull[qb], 64 * blk, t.hq,
                         t.q0, t.b);
        if constexpr (TAIL > 0)
          h::tma_load_4d(q + block_offset(NB64, BQ), &maps.qt, &qfull[qb], 64 * NB64, t.hq,
                         t.q0, t.b);
      }
      for (int kv0 = t.kv_lo; kv0 < t.kv_hi; kv0 += BN) {
        uint8_t mk[PER_LANE];
        bool live = true;
        if (a.kv_mask) {
          const uint8_t* mrow = a.kv_mask + (long long)t.b * a.Skv;
          bool any = false;
#pragma unroll
          for (int i = 0; i < PER_LANE; ++i) {
            const int col = kv0 + lane * PER_LANE + i;
            mk[i] = col < t.kv_len ? mrow[col] : uint8_t(0);
            any |= mk[i] != 0;
          }
          live = __any_sync(0xffffffffu, any);
        }
        if (!live) continue;  // fully masked tile: m, l and o untouched
        const int s = it % ST;
        h::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        if (a.kv_mask) {
#pragma unroll
          for (int i = 0; i < PER_LANE; ++i) tmask[s * BN + lane * PER_LANE + i] = mk[i];
        }
        __syncwarp();
        if (lane == 0) {
          tkv0[s] = kv0;
          unsigned char* kt = KVs + s * C::STAGE_BYTES;
          unsigned char* vt = kt + C::KV_BYTES;
          h::mbar_expect_tx(&full[s], C::STAGE_BYTES);
#pragma unroll
          for (int blk = 0; blk < NB64; ++blk) {
            h::tma_load_4d(kt + block_offset(blk, BN), &maps.k64, &full[s], 64 * blk, t.hk,
                           kv0, t.b);
            h::tma_load_4d(vt + block_offset(blk, BN), &maps.v64, &full[s], 64 * blk, t.hk,
                           kv0, t.b);
          }
          if constexpr (TAIL > 0) {
            h::tma_load_4d(kt + block_offset(NB64, BN), &maps.kt, &full[s], 64 * NB64, t.hk,
                           kv0, t.b);
            h::tma_load_4d(vt + block_offset(NB64, BN), &maps.vt, &full[s], 64 * NB64, t.hk,
                           kv0, t.b);
          }
        }
        ++it;
      }
      // end of the item's keys: a stage whose tile start is -1
      const int s = it % ST;
      h::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      if (lane == 0) {
        tkv0[s] = -1;
        h::mbar_arrive(&full[s]);
      }
      ++it;
    }
    return;
  }

  // consumer warpgroup cw: query rows q0 + 64 cw .. + 63 of each item
  if constexpr (NWG == 2) h::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x & 127) >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const float c2 = a.scale * 1.4426950408889634f;  // scale * log2(e)
  float o[D / 2];
  float s[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  int it = 0, qi = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++qi) {
    const AttnItem t = attn_item<BQ>(a, item);
    const int offset = a.Skv - a.Sq;
    const int row_lo = t.q0 + 64 * cw + 16 * wq + g, row_hi = row_lo + 8;
    const int wg_row0 = t.q0 + 64 * cw;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;  // l: this lane's columns
    const int qb = qi % QB;
    const unsigned char* Qt = Qs + qb * C::Q_BYTES;
    h::mbar_wait(&qfull[qb], (qi / QB) & 1);

    // S[64, BN] = Q[64, D] . K[BN, D]^T, issued (not waited for)
    auto issue_qk = [&](const unsigned char* kt) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t dq = kmajor_desc<D>(Qt, BQ, 64 * cw, kk);
        const uint64_t dk = kmajor_desc<D>(kt, BN, 0, kk);
        if constexpr (BN == 128)
          h::wgmma_ss_n128<0>(s, dq, dk, kk > 0);
        else
          h::wgmma_ss_n64<0>(s, dq, dk, kk > 0);
      }
      h::wgmma_commit();
    };
    // O[64, D] += P[64, BN] . V[BN, D], P from registers, issued
    auto issue_pv = [&](const unsigned char* vt, const uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int blk = 0; blk < NB64; ++blk)
          h::wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&o[32 * blk]), pa[kk],
                          h::make_desc(vt + block_offset(blk, BN) + kk * 16 * 128, BN * 128,
                                       1024, 1),
                          1);
        if constexpr (TAIL > 0) {
          const uint64_t dv = h::make_desc(vt + block_offset(NB64, BN) + kk * 16 * TRB,
                                           BN * TRB, 8 * TRB, h::desc_swizzle(TRB));
          if constexpr (TAIL == 16)
            h::wgmma_rs_n16(*reinterpret_cast<float(*)[8]>(&o[32 * NB64]), pa[kk], dv, 1);
          else
            h::wgmma_rs_n32(*reinterpret_cast<float(*)[16]>(&o[32 * NB64]), pa[kk], dv, 1);
        }
      }
      h::wgmma_commit();
    };
    // mask the scores of the tile at kv0 in place, turn them into
    // probabilities, fold them into the running max and sums; returns the
    // factors by which O must be rescaled. s[4 j + e] is row (e < 2 ? lo :
    // hi), column kv0 + 8 j + 2 tig + (e & 1). The running max m is kept on
    // the raw scores (scale > 0), and exp(scale (s - m)) is evaluated as
    // 2^(s c2 - m c2), c2 = scale log2 e: one fused multiply-add and one ex2
    // a score.
    auto softmax = [&](int kv0, int st, float& corr_lo, float& corr_hi) {
      const bool need_mask = kv0 + BN > t.kv_len || a.kv_mask != nullptr ||
                             (a.causal && kv0 + BN - 1 - offset > wg_row0);
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (need_mask) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * tig + (e & 1), col = kv0 + c;
            const int row = e < 2 ? row_lo : row_hi;
            bool valid = col < t.kv_len;
            if (valid && a.kv_mask) valid = tmask[st * BN + c] != 0;
            if (valid && a.causal) valid = (col - offset) <= row;
            if (!valid) s[4 * j + e] = kNegInf;
          }
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float msc_lo = fmaxf(mn_lo, kNegInf * 0.5f) * c2;
      const float msc_hi = fmaxf(mn_hi, kNegInf * 0.5f) * c2;
      corr_lo = ex2(fmaxf(m_lo, kNegInf * 0.5f) * c2 - msc_lo);
      corr_hi = ex2(fmaxf(m_hi, kNegInf * 0.5f) * c2 - msc_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], c2, -msc_lo));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c2, -msc_lo));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c2, -msc_hi));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c2, -msc_hi));
        sum_lo += s[4 * j] + s[4 * j + 1];
        sum_hi += s[4 * j + 2] + s[4 * j + 3];
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) h::mbar_arrive(bar);
    };

    // Tile j's P.V runs on the tensor cores while the scores of tile j + 1
    // (already multiplied) go through the softmax: per step, issue Q.K of
    // the next tile and P.V of this one, wait for Q.K, softmax, wait for
    // P.V, rescale O and pack the next P.
    uint32_t pa[BN / 16][4];
    int st = it % ST;
    h::mbar_wait(&full[st], (it / ST) & 1);
    int kv0 = tkv0[st];
    if (kv0 >= 0) {
      h::fence_regs(s);
      h::wgmma_fence();
      issue_qk(KVs + st * C::STAGE_BYTES);
      h::wgmma_wait<0>();
      h::fence_regs(s);
      float corr_lo, corr_hi;  // O is 0: nothing to rescale
      softmax(kv0, st, corr_lo, corr_hi);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      // (every wgmma of the loop body is unconditional, so that ptxas can
      // match each wait to its group and keeps them asynchronous)
      int nst = (it + 1) % ST;
      h::mbar_wait(&full[nst], ((it + 1) / ST) & 1);
      int nkv0 = tkv0[nst];
      while (nkv0 >= 0) {
        h::fence_regs(o);
        h::fence_regs(s);
        h::wgmma_fence();
        issue_qk(KVs + nst * C::STAGE_BYTES);
        issue_pv(KVs + st * C::STAGE_BYTES + C::KV_BYTES, pa);
        h::wgmma_wait<1>();  // Q.K of the next tile is done; P.V may run on
        h::fence_regs(s);
        float corr_lo, corr_hi;
        softmax(nkv0, nst, corr_lo, corr_hi);
        h::wgmma_wait<0>();
        h::fence_regs(o);
        release(&empty[st]);  // this tile's K and V are consumed
        ++it;
        st = nst;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr_lo;
          o[4 * j + 1] *= corr_lo;
          o[4 * j + 2] *= corr_hi;
          o[4 * j + 3] *= corr_hi;
        }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        nst = (it + 1) % ST;
        h::mbar_wait(&full[nst], ((it + 1) / ST) & 1);
        nkv0 = tkv0[nst];
      }
      // the last tile's P.V; the next stage is the item's end marker
      h::fence_regs(o);
      h::wgmma_fence();
      issue_pv(KVs + st * C::STAGE_BYTES + C::KV_BYTES, pa);
      h::wgmma_wait<0>();
      h::fence_regs(o);
      release(&empty[st]);
      ++it;
      st = nst;
    }
    // `it` is the item's end marker: release it and the Q tile (every Q.K
    // product of the item is done)
    release(&empty[st]);
    release(&qempty[qb]);
    ++it;

    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    if (a.splits > 1) {
      // unnormalised partial output, running max and sum of this split
      const long long base = (((long long)t.split * a.B + t.b) * a.Hq + t.hq) * a.Sq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row_hi : row_lo;
        if (row >= a.Sq) continue;
        float* po = a.part_o + (base + row) * a.D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = 8 * j + 2 * tig;
          if (col < a.D)
            *reinterpret_cast<float2*>(po + col) =
                make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
        }
        if (tig == 0)  // the max on the scaled scores, as the merge takes it
          *reinterpret_cast<float2*>(a.part_ml + (base + row) * 2) = make_float2(
              fmaxf(half ? m_hi : m_lo, kNegInf * 0.5f) * a.scale, half ? l_hi : l_lo);
      }
      continue;
    }
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
    const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    bf16* obase = a.o + t.b * a.o_sb + t.hq * a.o_sh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      if (col >= a.D) continue;  // D % 8 == 0: col + 1 < D too
      if (row_lo < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)row_lo * a.o_ss + col) =
            __floats2bfloat162_rn(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
      if (row_hi < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)row_hi * a.o_ss + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
    }
  }
}

// One warp a query row: the splits' partial outputs weighted by exp(m_s -
// max_s m_s) (each m clamped at min/2), summed in split order, divided by
// the weighted sums. A split that saw no visible key has sum 0 and output 0.
__global__ void __launch_bounds__(256) flash_merge_kernel(const AttnArgs a) {
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int q = int(r % a.Sq);
  const int hq = int((r / a.Sq) % a.Hq);
  const int b = int(r / ((long long)a.Sq * a.Hq));
  float mmax = kNegInf * 0.5f;
  for (int s = 0; s < a.splits; ++s)
    mmax = fmaxf(mmax, fmaxf(a.part_ml[(s * rows + r) * 2], kNegInf * 0.5f));
  float l = 0.f;
  for (int s = 0; s < a.splits; ++s)
    l += __expf(fmaxf(a.part_ml[(s * rows + r) * 2], kNegInf * 0.5f) - mmax) *
         a.part_ml[(s * rows + r) * 2 + 1];
  const float inv = 1.f / fmaxf(l, 1e-30f);
  bf16* orow = a.o + b * a.o_sb + (long long)q * a.o_ss + hq * a.o_sh;
  for (int d = lane; d < a.D; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < a.splits; ++s)
      acc += __expf(fmaxf(a.part_ml[(s * rows + r) * 2], kNegInf * 0.5f) - mmax) *
             a.part_o[(s * rows + r) * a.D + d];
    orow[d] = __float2bfloat16(acc * inv);
  }
}

// the six maps of a call, boxes of BQ query rows / BN key rows
template <int D, int NWG, int BN>
inline cudaError_t make_attn_maps(const AttnArgs& a, AttnMaps* m) {
  using C = AttnCfg<D, NWG, BN>;
  struct Src {
    const bf16* p;
    int H, S;
    long long sb, ss, sh;
    int rows;
    CUtensorMap *m64, *mt;
  } srcs[3] = {{a.q, a.Hq, a.Sq, a.q_sb, a.q_ss, a.q_sh, C::BQ, &m->q64, &m->qt},
               {a.k, a.Hkv, a.Skv, a.k_sb, a.k_ss, a.k_sh, C::BN, &m->k64, &m->kt},
               {a.v, a.Hkv, a.Skv, a.v_sb, a.v_ss, a.v_sh, C::BN, &m->v64, &m->vt}};
  for (const Src& t : srcs) {
    const cuuint64_t dims[4] = {cuuint64_t(a.D), cuuint64_t(t.H), cuuint64_t(t.S),
                                cuuint64_t(a.B)};
    const cuuint64_t strides[3] = {cuuint64_t(t.sh) * 2, cuuint64_t(t.ss) * 2,
                                   cuuint64_t(t.sb) * 2};
    if (C::NB64 > 0) {
      const cuuint32_t box[4] = {64, 1, cuuint32_t(t.rows), 1};
      const cudaError_t e = hop::make_map(t.m64, t.p, 4, dims, strides, box);
      if (e != cudaSuccess) return e;
    }
    if (C::TAIL > 0) {
      const cuuint32_t box[4] = {cuuint32_t(C::TAIL), 1, cuuint32_t(t.rows), 1};
      const cudaError_t e = hop::make_map(t.mt, t.p, 4, dims, strides, box);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

template <int D, int NWG, int BN>
inline cudaError_t launch_flash(const AttnArgs& a, cudaStream_t stream) {
  using C = AttnCfg<D, NWG, BN>;
  AttnMaps maps;
  cudaError_t err = make_attn_maps<D, NWG, BN>(a, &maps);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D, NWG, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::SMEM));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_fwd_kernel<D, NWG, BN>,
                                                        C::THREADS, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((a.Sq + C::BQ - 1) / C::BQ) * a.Hq * a.B * a.splits;
  if (items > 0x7fffffffLL || per_sm < 1) return cudaErrorInvalidValue;
  // long items: one a block, so the hardware balances the causal triangle;
  // short ones: a persistent grid that prefetches across items
  const int keys = a.splits > 1 ? a.chunk : a.Skv;
  const long long resident = (long long)sms * per_sm;
  const int grid = int(keys >= 4 * C::BN || items < resident ? items : resident);
  flash_fwd_kernel<D, NWG, BN><<<grid, C::THREADS, C::SMEM, stream>>>(maps, a, int(items));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long rows = (long long)a.B * a.Hq * a.Sq;
  flash_merge_kernel<<<unsigned((rows + 7) / 8), 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// two consumer warpgroups when Sq > 64; 64-key tiles when the call has at
// most 64 keys (Hiera's windows, the mask decoder's tokens), so a 16- or
// 64-key window does not pay for a 128-key tile
template <int D>
inline cudaError_t launch_flash_d(const AttnArgs& a, cudaStream_t stream) {
  constexpr int BN = attention_block_kv(D);
  if constexpr (BN != 64) {
    if (a.Skv <= 64 && a.splits == 1)
      return a.Sq > 64 ? launch_flash<D, 2, 64>(a, stream) : launch_flash<D, 1, 64>(a, stream);
  }
  return a.Sq > 64 ? launch_flash<D, 2, BN>(a, stream) : launch_flash<D, 1, BN>(a, stream);
}

// Dispatch on head dim: 16, 32, 64, 80 (SigLIP's and Hiera's 72), 128 or
// 256; a head dim below its instance is zero-filled by TMA. TMA needs
// 16-byte aligned bases and strides: D and every stride a multiple of 8.
inline cudaError_t attention_forward(const AttnArgs& a, cudaStream_t stream) {
  if (a.B <= 0 || a.Sq <= 0 || a.Hq <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.D <= 0 ||
      a.splits < 1)
    return cudaErrorInvalidValue;
  if (a.splits > 1 && (!a.part_o || !a.part_ml || a.chunk <= 0 ||
                       a.chunk % attention_block_kv(a.D) != 0))
    return cudaErrorInvalidValue;
  const long long strides = a.q_sb | a.q_ss | a.q_sh | a.k_sb | a.k_ss | a.k_sh |
                            a.v_sb | a.v_ss | a.v_sh;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  if (a.D % 8 != 0 || strides % 8 != 0 || (ptrs & 15) != 0)
    return cudaErrorMisalignedAddress;
  if (a.D <= 16) return launch_flash_d<16>(a, stream);
  if (a.D <= 32) return launch_flash_d<32>(a, stream);
  if (a.D <= 64) return launch_flash_d<64>(a, stream);
  if (a.D <= 80) return launch_flash_d<80>(a, stream);
  if (a.D <= 128) return launch_flash_d<128>(a, stream);
  if (a.D <= 256) return launch_flash_d<256>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace ufv
