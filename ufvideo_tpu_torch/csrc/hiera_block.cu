// The pre-LN transformer blocks of SigLIP and Hiera as short sequences of
// hand-written launches, with a plain C interface for ctypes. Fifteen entry
// points; the first nine replace one TPU kernel of
// ufvideo_tpu/ops/hiera_block.py each:
//
//   hiera_block_bf16  fused_hiera_block (_forward / _kernel / _block_body):
//                     LN1 (f32) -> qkv -> multi-head attention inside each
//                     window -> proj + residual -> LN2 (f32) -> fc1 -> GELU
//                     -> fc2 + residual (math of _reference);
//   hiera_stage_bf16  fused_hiera_stage (_stage_forward / _stage_kernel): nb
//                     such blocks in one call (see the entry point);
//   ln_matmul_bf16    fused_ln_matmul (_ln_matmul_forward): LN (f32) ->
//                     matmul + bias, the front of a global block, in one
//                     launch of the LayerNorm-band GEMM (C <= 576; wider
//                     rows: ln_matmul_pair_bf16, a LayerNorm pass and the
//                     GEMM);
//   block_tail_bf16   fused_block_tail (_tail_forward): proj + residual ->
//                     LN2 -> fc1 -> GELU -> fc2 + residual, the tail of a
//                     global block after the flash kernel;
//   qpool_block_bf16  fused_qpool_block (_qpool_forward): LN1 -> [qkv |
//                     shortcut projection] -> 2x2 max-pool of q and of the
//                     shortcut inside each window -> attention of the pooled
//                     queries on the window's unpooled keys -> the tail;
//   block_w8a8_bf16   fused_block_w8a8 (_w8a8_kernel / _w8a8_body): the whole
//                     block with int8 weights and per-row int8 activations
//                     (see the W8A8 section below);
//   ln_matmul_w8a8_bf16, block_tail_w8a8_bf16, qpool_block_w8a8_bf16
//                     fused_ln_matmul_w8a8 (_ln_matmul_w8a8_kernel),
//                     fused_block_tail_w8a8 (_tail_w8a8_kernel) and
//                     fused_qpool_block_w8a8 (_qpool_w8a8_kernel): the three
//                     above with int8 weights and per-row int8 activations,
//                     the blocks of a quantised Hiera trunk that the whole
//                     W8A8 block does not cover;
//   probe_gemm_bf16, probe_gemm_s8
//                     scripts/probe_int8_rate.py pallas_step
//                     (_pallas_dot_kernel): the bare bf16 x bf16 -> f32 and
//                     s8 x s8 -> s32 products of the int8-rate probe, on the
//                     two GEMMs below;
//   gemm_s8_s32       the int8 GEMM alone, for timing it apart from the
//                     probe's preparation passes;
//   block_gemm_bf16, block_gemm_plan_query
//                     the bf16 block GEMM alone on the route its plan gives
//                     or on another, and that plan, for testing and timing
//                     the routes.
//
// GELU: every entry point with an act takes 1 = tanh, 2 = exact (erf), and
// the JAX package's minimax polynomials 3 = gelu_poly, 4 = gelu_poly_bf16,
// 5 = gelu_tanh_poly, 6 = gelu_tanh_poly_bf16 (act_apply).
//
// Common math: f32 LayerNorm statistics, bf16 operands with f32
// accumulation, f32 softmax, probabilities cast to bf16 before P.V, each
// product rounded to bf16 before its residual add. The TPU kernels' window
// grouping, block-diagonal score mask, bf16 exp2 softmax and lane padding
// are layout devices of that chip and are not carried over.
//
// Bound on an H100: at the SigLIP shape (32 frames x 729 tokens, C 1152,
// MLP 4304) one block is ~711 GFLOP of matrix products plus ~78 GFLOP of
// attention against ~0.5 GB of activations and weights, so it is bound by
// operations (~0.8 ms at 989 TFLOP/s). Design: the four products run in
// one bf16 GEMM for Hopper (128x256 or 128x128 output tiles, TMA loads into
// a ring of 128-byte-swizzled shared memory, one producer warp, two consumer
// warpgroups on wgmma.mma_async; see "bf16 GEMM" below) whose
// epilogue fuses the bias, the GELU and the residual add from registers, so
// each intermediate makes one trip through memory; the attention shares
// attention_tile.cuh with the flash kernel (head dim 72 in its 80 instance,
// TMA zero-filling columns 72-79; one window per batch entry). Hiera's
// windowed blocks (16 / 64 / 256 tokens a window, C 144..1152) have the same
// ratio of operations to bytes per token and are bound by operations too;
// their 16- and 64-token windows run the tile's 64-key instance, a 16-token
// window filling a quarter of its 64-row query tile (the rest is masked).
// The q-pool block adds one elementwise pass (pool_kernel) and runs the
// attention with Sq = S/4 queries against S keys per window. Every block's
// tail at C <= 576 (Hiera's stages 1-3) runs LN2 inside its fc1 launch, on
// the LayerNorm-band GEMM below (a band of rows normalised once in shared
// memory, W streamed past it, consumer warpgroups on different column tiles
// so one's epilogue overlaps the other's products). Not yet: LN1 -> qkv of
// the windowed and q-pool blocks on that GEMM; fc1 and fc2 in one kernel
// (hmid kept on the chip); a 64-row band for C = 1152.
#include "attention_tile.cuh"
#include "hopper.cuh"

#include <climits>
#include <initializer_list>

namespace {

using ufv::bf16;

enum Act {
  ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_EXACT = 2, ACT_GELU_POLY = 3, ACT_GELU_POLY_BF16 = 4,
  ACT_GELU_TANH_POLY = 5, ACT_GELU_TANH_POLY_BF16 = 6
};

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// The JAX package's minimax polynomial GELUs (ufvideo_tpu/ops/hiera_block.py
// _poly_gelu_eval): gelu(x) = x * (0.5 + xc * Q(t)), xc = clip(x, +-4.5), t =
// 2 xc^2 / 4.5^2 - 1, Q a polynomial in t with these coefficients (lowest
// first): a fit of the erf GELU and a fit of the tanh form.
__constant__ float kGeluPolyCt[10] = {
    0.1569060442880844f, -0.07718588485083337f, 0.054637490167050023f,
    -0.04023694830724554f, 0.02885765287056899f, -0.018484084923067773f,
    0.009653220256290044f, -0.006070030404158596f, 0.004962705354373479f,
    -0.0019306118341346908f};
__constant__ float kGeluTanhPolyCt[11] = {
    0.15693845830119607f, -0.077295380617666f, 0.054784027802834236f,
    -0.04004952801103731f, 0.02807726149055056f, -0.018491884341240026f,
    0.010685858987061678f, -0.005250474306093966f, 0.003522283558394471f,
    -0.0028267368523108055f, 0.0010171322565724434f};
constexpr float kPolyB = 4.5f;

template <int N>
__device__ __forceinline__ float gelu_poly(float x, const float* ct) {
  const float xc = fminf(fmaxf(x, -kPolyB), kPolyB);
  const float t = xc * xc * (2.f / (kPolyB * kPolyB)) - 1.f;
  float q = ct[N - 1];
#pragma unroll
  for (int k = N - 2; k >= 0; --k) q = q * t + ct[k];
  return x * (0.5f + xc * q);
}

__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

// the same polynomial on bf16 values (_gelu_poly_bf16): the input, each
// constant and each intermediate rounded to bf16; _rn intrinsics keep the
// compiler from fusing a product and a sum past a rounding
template <int N>
__device__ __forceinline__ float gelu_poly_bf16(float x, const float* ct) {
  const float xb = rbf(x);
  const float xc = fminf(fmaxf(xb, -kPolyB), kPolyB);
  const float t = rbf(__fsub_rn(rbf(__fmul_rn(rbf(__fmul_rn(xc, xc)),
                                              rbf(2.f / (kPolyB * kPolyB)))), 1.f));
  float q = rbf(ct[N - 1]);
#pragma unroll
  for (int k = N - 2; k >= 0; --k) q = rbf(__fadd_rn(rbf(__fmul_rn(q, t)), rbf(ct[k])));
  return rbf(__fmul_rn(xb, rbf(__fadd_rn(0.5f, rbf(__fmul_rn(xc, q))))));
}

template <int ACT>
__device__ __forceinline__ float act_apply(float v) {
  if (ACT == ACT_GELU_TANH) return gelu_tanh(v);
  if (ACT == ACT_GELU_EXACT) return gelu_exact(v);
  if (ACT == ACT_GELU_POLY) return gelu_poly<10>(v, kGeluPolyCt);
  if (ACT == ACT_GELU_POLY_BF16) return gelu_poly_bf16<10>(v, kGeluPolyCt);
  if (ACT == ACT_GELU_TANH_POLY) return gelu_poly<11>(v, kGeluTanhPolyCt);
  if (ACT == ACT_GELU_TANH_POLY_BF16) return gelu_poly_bf16<11>(v, kGeluTanhPolyCt);
  return v;
}

// y[r] = (x[r] - mean) * rsqrt(var + eps) * gamma + beta, f32 statistics,
// one warp per row, rows read as 16-byte vectors (C % 8 == 0).
__global__ void __launch_bounds__(256) layernorm_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ y, int rows, int C, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (long long)row * C;
  auto load8 = [&](int c, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
  };
  float sum = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    float v[8];
    load8(c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
  }
  const float mean = ufv::warp_sum(sum) / C;
  float var = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    float v[8];
    load8(c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) var += (v[e] - mean) * (v[e] - mean);
  }
  var = ufv::warp_sum(var) / C;
  const float rstd = rsqrtf(var + eps);
  bf16* yr = y + (long long)row * C;
  for (int c = lane * 8; c < C; c += 256) {
    float v[8];
    load8(c, v);
    uint4 u;
    bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      h[e] = __float2bfloat16((v[e] - mean) * rstd * gamma[c + e] + beta[c + e]);
    *reinterpret_cast<uint4*>(yr + c) = u;
  }
}

// ------------------------------------------------------------ bf16 GEMM --
// Y[M, N] = epilogue(A[M, K] . W[K, N] + bias[N]); all row-major, K and N
// multiples of 8, A and W 16-byte aligned. Epilogue: an optional activation;
// with a residual R, Y = bf16(bf16(acc + bias) + R); with F32OUT the f32 sum
// (bias may be null). Every product takes the route block_gemm_plan gives
// its shape (gemm below): this kernel's 128 x 128 tile for Hiera stage 1's
// products, the ping-pong kernel of the next section for every other bf16
// output, this kernel's 128 x 256 tile for the f32 sum.
//
// Hopper design: a 128 x BN output tile a block, K in steps of 64. One
// producer warp streams the A tile (128 rows x 64 K, one TMA box) and the W
// tile (64 K rows x BN, boxes of 64 N columns) into a ring of 128-byte-
// swizzled shared memory guarded by mbarriers (full: the TMA bytes have
// landed; empty: both consumers are done with the stage). Two consumer
// warpgroups each own 64 rows and issue wgmma.mma_async m64nBNk16 (bf16 ->
// f32) straight from shared memory: A K-major, W MN-major through the
// descriptor's transpose bit, so no copy transposes it. One group of wgmmas
// stays in flight while the previous stage is released. A block is the two
// consumer warpgroups and one producer warp (288 threads), one output tile:
// BN = 128, two blocks an SM (3 stages of 32 KB), so one block's epilogue
// overlaps the other's products (Hiera's short K: 144 is three steps); BN =
// 256 for the f32 sum (the probe). A 144-column tile that divided N = 144
// and 288 ran every product slower than this one or the ping-pong kernel
// once their epilogues were fixed (PERF.md) and is gone. The bf16 epilogue
// stages the tile's bias in shared memory and stores 16 bytes a lane
// (store_rows16). A persistent grid of this kernel, whose ring ran on across tiles with both
// warpgroups on one tile, measured 5-28% slower on an H100: its epilogues
// stayed serial. The ping-pong kernel is persistent with
// its warpgroups on alternate tiles instead, and took K >= 1024 from a 128 x
// 256 tile of this kernel that ran SigLIP's four products 1.5-1.8x slower
// than cuBLAS (PERF.md).
// TMA zero-fills what lies past M, N or K; the epilogue masks its stores.
// Every output element is summed by one thread in a fixed order:
// deterministic.
constexpr int kGBM = 128, kGBK = 64, kGThreads = 288;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have

template <int BN>
struct GemmCfg {
  // the 256-wide tile (the f32 sum here, every int8 product in
  // gemm_s8_kernel): one block an SM, 4 stages
  static constexpr int STAGES = BN == 256 ? 4 : 3;
  static constexpr int PER_SM = BN == 128 ? 2 : 1;
  static constexpr int BA = 64;  // W's boxes: 64 columns in 128-byte-swizzled rows
  static constexpr int TILE_A = kGBM * kGBK * 2;  // bytes: 128 rows x 128 B
  static constexpr int TILE_B = kGBK * BN * 2;    // bytes: BN / BA boxes of 64 x BA
  static constexpr int STAGE = TILE_A + TILE_B;
  static constexpr int BIAS = BN * 4;  // the tile's bias, staged for the epilogue
  static constexpr size_t SMEM =
      size_t(STAGES) * STAGE + 2 * STAGES * sizeof(uint64_t) + BIAS + 1024;
};

template <int BN>
__device__ __forceinline__ void wgmma_gemm(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 128 || BN == 256, "a tile width the GEMM has");
  if constexpr (BN == 256)
    ufv::hop::wgmma_ss_n256<1>(acc, da, db, 1);
  else
    ufv::hop::wgmma_ss_n128<1>(acc, da, db, 1);
}

// The f32 epilogue of one warpgroup's m64 x BN accumulator (the probe's
// product): accumulator 4 j + e is row `row0` + 8 (e >= 2), column n0 + 8 j +
// 2 tig + (e & 1), with row0 the warp's first row + lane / 4; the sum plus
// the bias (which may be null); rows >= M and columns >= N are not stored (N
// % 8 == 0: a pair is all in or all out).
template <int BN>
__device__ __forceinline__ void store_f32(const float (&acc)[BN / 2], int row0, int n0,
                                          const float* __restrict__ bias,
                                          float* __restrict__ Y, int M, int N) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * tig;
    if (col >= N) continue;
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= M) continue;
      *reinterpret_cast<float2*>(Y + (long long)row * N + col) =
          make_float2(acc[4 * j + 2 * half] + b0, acc[4 * j + 2 * half + 1] + b1);
    }
  }
}

// ((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7))
__device__ __forceinline__ float tree8(const float (&v)[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return (i & 2) ? ((i & 1) ? w[3] : w[2]) : ((i & 1) ? w[1] : w[0]);
}

// One group of the 16-byte epilogue: accumulators v[0..15] are blocks 4 q ..
// 4 q + 3 (8 columns each) of rows `row` and row + 8 of the tile at (m0,
// n0); bias from shared memory (bs: the tile's values; a global load here
// would wait behind the stores before it), activation, then bf16(v), or with
// a residual bf16(bf16(v) + R). The lanes of a quad trade their bf16 pairs
// (a 4 x 4 transpose in three shuffles), after which lane tig holds the 8
// contiguous columns of block 4 q + tig, so a warp writes 64 contiguous bytes
// of each of its 8 rows at once (R read 16 bytes at a time at the same
// place). Rows >= M and blocks past N (N % 8 == 0) are not stored.
template <int ACT, bool RES, bool RS>
__device__ __forceinline__ void store_group16(const float (&v)[16], const float* bs, int q,
                                              int row, int m0, int n0,
                                              const bf16* __restrict__ R,
                                              const unsigned char* rs, bf16* __restrict__ Y,
                                              int M, int N) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t w[4], o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 b = *reinterpret_cast<const float2*>(bs + 8 * (4 * q + k) + 2 * tig);
      w[k] = pack_bf16x2(act_apply<ACT>(v[4 * k + 2 * half] + b.x),
                         act_apply<ACT>(v[4 * k + 2 * half + 1] + b.y));
    }
    // o[k] = lane k's pair of block 4 q + tig: o[tig] is this lane's own
    // w[tig]; at step s, lane tig ^ s sends its w[tig] for o[tig ^ s]
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = w[k];
#pragma unroll
    for (int s = 1; s < 4; ++s) {
      const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(w, tig ^ s), s);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k == (tig ^ s)) o[k] = got;
    }
    const int r = row + 8 * half, col = n0 + (4 * q + tig) * 8;
    if (r >= M || col >= N) continue;
    const long long off = (long long)r * N + col;
    uint4 out = make_uint4(o[0], o[1], o[2], o[3]);
    if (RES) {
      // RS: the tile's residual in shared memory (two 128-byte-swizzled boxes
      // of 64 columns, as TMA lands them), else R in device memory
      const int lr = r - m0, lu = (col - n0) / 8;
      const uint4 rv =
          RS ? *reinterpret_cast<const uint4*>(rs + (lu >> 3) * (kGBM * 128) + lr * 128 +
                                               (((lu & 7) ^ (lr & 7)) << 4))
             : *reinterpret_cast<const uint4*>(R + off);
      const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&rv);
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = __bfloat1622float2(oh[k]), y = __bfloat1622float2(rh[k]);
        oh[k] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
      }
    }
    *reinterpret_cast<uint4*>(Y + off) = out;
  }
}

// The epilogue of NA m64 x BN accumulators (the layout store_f32 reads;
// array a holds rows row0 + 64 a) with 16-byte stores, group by group (four
// 8-column blocks). Without an activation every group is unrolled. With a
// GELU, two groups a step of a loop that is not unrolled: the arrays shift
// down 32 values a step, so a step reads fixed registers and the code (the
// GELU inlined 32 times, not NA * BN / 2 times) stays in the instruction
// cache, while a step's 32 independent GELUs keep the one warp a scheduler
// that runs the epilogue issuing. Fully unrolled, the GELU epilogue outgrew
// the instruction cache; one group a step ran the ping-pong GEMM's fc1 2-4%
// slower (both on an H100, PERF.md). RS: the residual comes from the tile
// in shared memory at rs (store_group16).
template <int BN, int ACT, bool RES, int NA, bool RS = false>
__device__ __forceinline__ void store_rows16(float (&acc)[NA][BN / 2], const float* bs, int row0,
                                             int m0, int n0, const bf16* __restrict__ R,
                                             const unsigned char* rs, bf16* __restrict__ Y,
                                             int M, int N) {
  static_assert(BN % 32 == 0, "whole groups of four 8-column blocks");
  constexpr int GQ = BN / 32, FLAT = 16 * GQ;  // groups an array, values they hold
  constexpr int NG = NA * GQ, GPI = ACT == ACT_NONE ? NG : 2;  // groups, groups a step
  static_assert(NG % GPI == 0, "whole steps");
  static_assert(!RS || (RES && BN == 128), "a residual tile in shared memory is 128 wide");
#pragma unroll 1
  for (int it = 0; it < NG / GPI; ++it) {
#pragma unroll
    for (int gi = 0; gi < GPI; ++gi) {
      float v[16];  // values 16 gi .. 16 gi + 15 of the arrays taken in order
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = acc[(16 * gi + i) / FLAT][(16 * gi + i) % FLAT];
      const int g = it * GPI + gi;
      store_group16<ACT, RES, RS>(v, bs, g % GQ, row0 + 64 * (g / GQ), m0, n0, R, rs, Y, M,
                                  N);
    }
    if constexpr (GPI < NG) {  // the next step's groups to the front
#pragma unroll
      for (int i = 0; i + 16 * GPI < NA * FLAT; ++i) {
        const int s = i + 16 * GPI;
        acc[i / FLAT][i % FLAT] = acc[s / FLAT][s % FLAT];
      }
    }
  }
}

template <int BN, int ACT, bool RES, bool F32OUT>
__global__ void __launch_bounds__(kGThreads, GemmCfg<BN>::PER_SM) gemm_kernel(
    __grid_constant__ const CUtensorMap mapA, __grid_constant__ const CUtensorMap mapW,
    const float* __restrict__ bias, const bf16* __restrict__ R, void* __restrict__ Yv, int M,
    int N, int K) {
  namespace h = ufv::hop;
  using C = GemmCfg<BN>;
  constexpr int ST = C::STAGES, BA = C::BA;
  static_assert(!F32OUT || (ACT == ACT_NONE && !RES), "the f32 epilogue is the sum + bias");
  extern __shared__ __align__(1024) unsigned char gsmem_raw[];
  unsigned char* smem = gsmem_raw + ((1024 - (h::smem_u32(gsmem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * C::STAGE);
  uint64_t* empty = full + ST;
  float* bs = reinterpret_cast<float*>(empty + ST);  // [BN]: the tile's bias
  const int nk = (K + kGBK - 1) / kGBK;
  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      h::mbar_init(&full[st], 1);
      h::mbar_init(&empty[st], 8);  // lane 0 of each consumer warp
    }
    h::fence_barrier_init();
  }
  __syncthreads();

  const int m0 = blockIdx.y * kGBM, n0 = blockIdx.x * BN;
  if (threadIdx.x >= 256) {  // producer warp: one thread issues every load
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST;
        h::mbar_wait(&empty[st], ((kt / ST) & 1) ^ 1);
        unsigned char* stage = smem + st * C::STAGE;
        h::mbar_expect_tx(&full[st], C::STAGE);
        h::tma_load_2d(stage, &mapA, &full[st], kt * kGBK, m0);
#pragma unroll
        for (int nb = 0; nb < BN / BA; ++nb)
          h::tma_load_2d(stage + C::TILE_A + nb * kGBK * BA * 2, &mapW, &full[st], n0 + BA * nb,
                         kt * kGBK);
      }
    }
    return;
  }
  // consumer warpgroups 0 and 1: rows 64 cw .. +63 of the tile
  const int cw = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if constexpr (!F32OUT)
    for (int i = threadIdx.x; i < BN; i += 256) bs[i] = bias && n0 + i < N ? bias[n0 + i] : 0.f;
  {
    float accs[1][BN / 2];
    float (&acc)[BN / 2] = accs[0];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % ST;
      h::mbar_wait(&full[st], (kt / ST) & 1);
      const unsigned char* a = smem + st * C::STAGE + cw * 64 * 128;
      const unsigned char* b = smem + st * C::STAGE + C::TILE_A;
      h::fence_regs(acc);
      h::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGBK / 16; ++kk)
        wgmma_gemm<BN>(acc, h::make_desc(a + kk * 32, 16, 1024, 1),
                       h::make_desc(b + kk * 16 * BA * 2, kGBK * BA * 2, 8 * BA * 2,
                                    h::desc_swizzle(BA * 2)));
      h::wgmma_commit();
      h::wgmma_wait<1>();  // the previous stage's products are done: release it
      h::fence_regs(acc);
      if (kt > 0 && lane == 0) h::mbar_arrive(&empty[(kt - 1) % ST]);
    }
    h::wgmma_wait<0>();
    h::fence_regs(acc);
    const int row0 = m0 + cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    if constexpr (F32OUT) {
      store_f32<BN>(acc, row0, n0, bias, static_cast<float*>(Yv), M, N);
    } else {
      h::named_bar_sync(1, 256);  // bs is in place
      store_rows16<BN, ACT, RES, 1>(accs, bs, row0, m0, n0, R, nullptr, static_cast<bf16*>(Yv),
                                    M, N);
    }
  }
}

template <int BN, int ACT, bool RES, bool F32OUT>
cudaError_t gemm_launch(const CUtensorMap& mapA, const CUtensorMap& mapW, const float* bias,
                        const bf16* R, void* Y, int M, int N, int K, cudaStream_t st) {
  using C = GemmCfg<BN>;
  const cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BN, ACT, RES, F32OUT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               int(C::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + kGBM - 1) / kGBM);
  gemm_kernel<BN, ACT, RES, F32OUT><<<grid, kGThreads, C::SMEM, st>>>(mapA, mapW, bias, R, Y, M,
                                                                       N, K);
  return cudaGetLastError();
}

// A [M, K]: boxes of 64 K x 128 rows; W [K, N]: boxes of BA N x 64 K rows
template <int BN, int ACT, bool RES, bool F32OUT = false>
cudaError_t gemm_tile(const bf16* A, const bf16* W, const float* bias, const bf16* R, void* Y,
                      int M, int N, int K, cudaStream_t st) {
  CUtensorMap mapA, mapW;
  const cuuint64_t dimsA[2] = {cuuint64_t(K), cuuint64_t(M)}, strideA[1] = {cuuint64_t(K) * 2};
  const cuuint64_t dimsW[2] = {cuuint64_t(N), cuuint64_t(K)}, strideW[1] = {cuuint64_t(N) * 2};
  const cuuint32_t boxA[2] = {kGBK, kGBM}, boxW[2] = {GemmCfg<BN>::BA, kGBK};
  cudaError_t err = ufv::hop::make_map(&mapA, A, 2, dimsA, strideA, boxA);
  if (err == cudaSuccess) err = ufv::hop::make_map(&mapW, W, 2, dimsW, strideW, boxW);
  if (err != cudaSuccess) return err;
  return gemm_launch<BN, ACT, RES, F32OUT>(mapA, mapW, bias, R, Y, M, N, K, st);
}

// ------------------------------------------------ ping-pong bf16 GEMM --
// The same product and epilogues for every bf16 product but Hiera stage
// 1's (block_gemm_plan), first for K >= 1024 (SigLIP's four products),
// where a 128 x 256 tile with both consumer warpgroups on it left the tensor
// cores idle through every epilogue (one block an SM; PERF.md). Hopper design: a persistent grid (at
// most one block an SM) walks the 128 x 128 output tiles in a fixed order,
// row bands with column tiles fastest, so the blocks in flight share a few
// A bands and W in L2; block b takes tiles b, b + G, .... Its two consumer
// warpgroups take alternate tiles of the block, each a whole 128 x 128 tile
// (two m64n128k16 wgmmas a k16 step on one W descriptor), so one
// warpgroup's epilogue (bias staged in shared memory, GELU, 16-byte stores
// through store_rows16) runs under the other's products. One producer
// thread loads the stages (A 128 x 64 in one TMA box, W 64 x 128 in two, 32
// KB) in the order the consumers take them, tile by tile, into a ring of
// kPpStages, as many as fit beside the residual tile; full barriers are per
// warpgroup (a barrier shared by both
// would let a warpgroup waiting for its next tile see the phase of the
// other's last use of that stage as its own), empty barriers count the four
// warps of the warpgroup that used the stage. A residual tile (proj, fc2)
// comes by TMA too, into a 32 KB buffer the two warpgroups' epilogues take
// in turn: the producer loads tile j's after its last stage, once tile j -
// 1's epilogue has released the buffer. A residual read from device memory
// in the epilogue waited behind the ring's TMA traffic for most of a tile's
// time (clock64 stamps, scripts/torch_gemm_stamps.py, PERF.md). 384 threads:
// the producer warpgroup at 40 registers (setmaxnreg), the consumers at 232
// for their 128 accumulators. The f32 epilogue stores 8 bytes a lane
// (store_f32); the plan gives the f32 sum the 128 x 256 tile, which ran the
// probe's product faster on an H100 (PERF.md). Every output is summed by
// one thread in k order, then bias, activation and one rounding: the result
// repeats bit for bit.
constexpr int kPpThreads = 384, kPpStages = 6;
constexpr int kPpTileA = kGBM * kGBK * 2;        // bytes: 128 rows x 64 K
constexpr int kPpStage = kPpTileA + kGBK * 128 * 2;  // + W: 64 K x 128 columns
constexpr int kPpTileR = kGBM * 128 * 2;             // a residual tile, 128 x 128
// the alignment pad, the residual tile and its three barriers, both
// warpgroups' bias rows, then the ring's stages and their three barriers each
constexpr int kPpSmem = 1024 + kPpTileR + 3 * 8 + 2 * 128 * 4 + kPpStages * (kPpStage + 24);
static_assert(kPpSmem <= kSmemMax && kPpSmem + kPpStage + 24 > kSmemMax,
              "the ring is as deep as fits");

// How gemm runs a product: route 0 is the ping-pong kernel, else gemm_kernel's
// tile of width `route`; the ring's stages, the dynamic shared memory, the
// blocks launched and the output tiles. ops/hiera_block.block_gemm_plan
// computes the same (block_gemm_plan_query below reads this one).
struct GemmPlan {
  int route, stages, smem, grid, tiles;
};

template <int BN>
void tile_plan(long long tiles, GemmPlan* p) {
  p->stages = GemmCfg<BN>::STAGES;
  p->smem = int(GemmCfg<BN>::SMEM);
  p->grid = int(tiles);
}

// The rest of a plan on route `route` at M x K into N (f32: the f32 sum) on
// a card of `sms` SMs; false where that route cannot take the product (the
// 256-wide tile takes the f32 sum only).
bool gemm_route_plan(int route, int M, int N, int K, bool f32, int sms, GemmPlan* p) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || sms <= 0) return false;
  const int bn = route == 0 ? 128 : route;
  if (bn != 128 && !(bn == 256 && f32)) return false;
  const long long tiles = (M + kGBM - 1LL) / kGBM * ((N + bn - 1) / bn);
  if (tiles > INT_MAX) return false;
  p->route = route;
  p->tiles = int(tiles);
  if (route == 0) {
    p->stages = kPpStages;
    p->smem = kPpSmem;
    p->grid = p->tiles < sms ? p->tiles : sms;
  } else if (bn == 128) {
    tile_plan<128>(tiles, p);
  } else {
    tile_plan<256>(tiles, p);
  }
  return true;
}

// The plan from the shapes alone (f32: the f32 sum), each route where it
// measured the fastest on an H100 (scripts/torch_gemm_routes.py, PERF.md):
// the f32 sum on the 128 x 256 tile; the 128 x 128 tile at N <= 144 and at
// K <= 144 with N < 1024 (Hiera stage 1's proj, fc2 and qkv, 3-22% faster
// there at two blocks an SM); every other product on the ping-pong kernel.
bool block_gemm_plan(int M, int N, int K, bool f32, int sms, GemmPlan* p) {
  const int route = f32 ? 256 : N <= 144 || (K <= 144 && N < 1024) ? 128 : 0;
  return gemm_route_plan(route, M, N, K, f32, sms, p);
}

// The plan on `sms` SMs, or on the current device's where sms <= 0; route <
// 0 takes block_gemm_plan's route, else that one.
cudaError_t gemm_plan_on(int M, int N, int K, bool f32, int sms, int route, GemmPlan* p) {
  cudaError_t err = cudaSuccess;
  if (sms <= 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const bool ok = route < 0 ? block_gemm_plan(M, N, K, f32, sms, p)
                            : gemm_route_plan(route, M, N, K, f32, sms, p);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

#ifdef UFV_STAMPS
// clock64 stamps of gemm_pp_kernel's tiles: [grid][2 warpgroups][tiles a
// warpgroup takes at most][4], in a buffer sized for the launch by
// scripts/torch_gemm_stamps.py (ufv_stamps_set)
__device__ long long* ufv_stamps;
#endif

template <int ACT, bool RES, bool F32OUT>
__global__ void __launch_bounds__(kPpThreads, 1) gemm_pp_kernel(
    __grid_constant__ const CUtensorMap mapA, __grid_constant__ const CUtensorMap mapW,
    __grid_constant__ const CUtensorMap mapR, const float* __restrict__ bias,
    void* __restrict__ Yv, int M, int N, int K) {
  namespace h = ufv::hop;
  constexpr int ST = kPpStages;
  static_assert(!F32OUT || (ACT == ACT_NONE && !RES), "the f32 epilogue is the sum + bias");
  extern __shared__ __align__(1024) unsigned char psmem_raw[];
  unsigned char* ring = psmem_raw + ((1024 - (h::smem_u32(psmem_raw) & 1023)) & 1023);
  unsigned char* rtile = ring + ST * kPpStage;  // the residual tile, two boxes of 64 columns
  uint64_t* full = reinterpret_cast<uint64_t*>(rtile + kPpTileR);  // [2][ST]
  uint64_t* empty = full + 2 * ST;
  uint64_t* r_full = empty + ST;  // [2]: the residual tile has landed for warpgroup w
  uint64_t* r_empty = r_full + 2;  // the last epilogue is done with it
  float* bias_s = reinterpret_cast<float*>(r_empty + 1);  // [2][128]: each warpgroup's tile
  const int nk = (K + kGBK - 1) / kGBK;
  const int ntn = (N + 127) / 128, tiles = (M + kGBM - 1) / kGBM * ntn;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&full[ST + s], 1);
      h::mbar_init(&empty[s], 4);  // lane 0 of each warp of the consuming warpgroup
    }
    h::mbar_init(&r_full[0], 1);
    h::mbar_init(&r_full[1], 1);
    h::mbar_init(r_empty, 4);
    h::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; one thread issues every load
    h::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;  // stages in the order the consumers take them: tile, then k
      for (int t = blockIdx.x, j = 0; t < tiles; t += gridDim.x, ++j) {
        const int m0 = t / ntn * kGBM, n0 = t % ntn * 128;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % ST;
          uint64_t* f = &full[(j & 1) * ST + st];
          h::mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
          unsigned char* stage = ring + st * kPpStage;
          h::mbar_expect_tx(f, kPpStage);
          h::tma_load_2d(stage, &mapA, f, kt * kGBK, m0);
          h::tma_load_2d(stage + kPpTileA, &mapW, f, n0, kt * kGBK);
          h::tma_load_2d(stage + kPpTileA + kGBK * 128, &mapW, f, n0 + 64, kt * kGBK);
        }
        if constexpr (RES) {  // tile j's residual, once tile j - 1's epilogue is done with it
          uint64_t* f = &r_full[j & 1];
          h::mbar_wait(r_empty, (j & 1) ^ 1);
          h::mbar_expect_tx(f, kPpTileR);
          h::tma_load_2d(rtile, &mapR, f, n0, m0);
          h::tma_load_2d(rtile + kPpTileR / 2, &mapR, f, n0 + 64, m0);
        }
      }
    }
    return;
  }
  h::setmaxnreg_inc<232>();
  // consumer warpgroup cw: the block's tiles j = cw, cw + 2, ...; each warp
  // owns rows 16 (warp % 4) .. + 15 of both 64-row halves. phase bit s: the
  // parity of this warpgroup's next wait on stage s.
  const int cw = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x - 128) >> 5;
  const int lane = threadIdx.x & 31;
  float* bs = bias_s + cw * 128;
  uint32_t phase = 0;
  for (int j = cw, t = blockIdx.x + cw * gridDim.x; t < tiles; j += 2, t += 2 * gridDim.x) {
    const int m0 = t / ntn * kGBM, n0 = t % ntn * 128;
#ifdef UFV_STAMPS
    long long ts[4];
    ts[0] = clock64();
#endif
    if constexpr (!F32OUT) {
      const int i = threadIdx.x & 127;
      h::named_bar_sync(2 + cw, 128);  // the previous tile's epilogue is done with bs
      bs[i] = bias && n0 + i < N ? bias[n0 + i] : 0.f;
    }
    float acc[2][64];  // rows 0-63 and 64-127 of the tile
    float (&acc0)[64] = acc[0];
    float (&acc1)[64] = acc[1];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int it = j * nk + kt;
      const int st = it % ST;
      h::mbar_wait(&full[cw * ST + st], (phase >> st) & 1);
      phase ^= 1u << st;
#ifdef UFV_STAMPS
      if (kt == 0) ts[1] = clock64();
#endif
      const unsigned char* a = ring + st * kPpStage;
      const unsigned char* b = a + kPpTileA;
      h::fence_regs(acc0);
      h::fence_regs(acc1);
      h::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGBK / 16; ++kk) {
        const uint64_t db = h::make_desc(b + kk * 16 * 128, kGBK * 128, 1024, 1);
        wgmma_gemm<128>(acc0, h::make_desc(a + kk * 32, 16, 1024, 1), db);
        wgmma_gemm<128>(acc1, h::make_desc(a + 64 * 128 + kk * 32, 16, 1024, 1), db);
      }
      h::wgmma_commit();
      h::wgmma_wait<1>();  // the previous stage's products are done: release it
      h::fence_regs(acc0);
      h::fence_regs(acc1);
      if (kt > 0 && lane == 0) h::mbar_arrive(&empty[(it - 1) % ST]);
    }
    h::wgmma_wait<0>();
    h::fence_regs(acc0);
    h::fence_regs(acc1);
    if (lane == 0) h::mbar_arrive(&empty[(j * nk + nk - 1) % ST]);
#ifdef UFV_STAMPS
    ts[2] = clock64();
#endif
    const int row0 = m0 + (warp & 3) * 16 + (lane >> 2);
    if constexpr (F32OUT) {
      store_f32<128>(acc0, row0, n0, bias, static_cast<float*>(Yv), M, N);
      store_f32<128>(acc1, row0 + 64, n0, bias, static_cast<float*>(Yv), M, N);
    } else {
      h::named_bar_sync(2 + cw, 128);  // bs holds this tile's bias
      if constexpr (RES) h::mbar_wait(&r_full[cw], (j >> 1) & 1);
      store_rows16<128, ACT, RES, 2, RES>(acc, bs, row0, m0, n0, nullptr, rtile,
                                          static_cast<bf16*>(Yv), M, N);
      if constexpr (RES) {
        __syncwarp();
        if (lane == 0) h::mbar_arrive(r_empty);
      }
    }
#ifdef UFV_STAMPS
    ts[3] = clock64();
    const int per = (tiles + 2 * gridDim.x - 1) / (2 * gridDim.x);
    if ((threadIdx.x & 127) == 0 && ufv_stamps)
      for (int e = 0; e < 4; ++e) ufv_stamps[((blockIdx.x * 2 + cw) * per + j / 2) * 4 + e] = ts[e];
#endif
  }
}

template <int ACT, bool RES, bool F32OUT>
cudaError_t gemm_pp(const bf16* A, const bf16* W, const float* bias, const bf16* R, void* Y,
                    int M, int N, int K, const GemmPlan& p, cudaStream_t st) {
  CUtensorMap mapA, mapW, mapR;
  const cuuint64_t dimsA[2] = {cuuint64_t(K), cuuint64_t(M)}, strideA[1] = {cuuint64_t(K) * 2};
  const cuuint64_t dimsW[2] = {cuuint64_t(N), cuuint64_t(K)}, strideW[1] = {cuuint64_t(N) * 2};
  const cuuint64_t dimsR[2] = {cuuint64_t(N), cuuint64_t(M)};
  const cuuint32_t boxA[2] = {kGBK, kGBM}, boxW[2] = {64, kGBK}, boxR[2] = {64, kGBM};
  cudaError_t err = ufv::hop::make_map(&mapA, A, 2, dimsA, strideA, boxA);
  if (err == cudaSuccess) err = ufv::hop::make_map(&mapW, W, 2, dimsW, strideW, boxW);
  mapR = mapA;  // unused without a residual
  if (err == cudaSuccess && RES) err = ufv::hop::make_map(&mapR, R, 2, dimsR, strideW, boxR);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_pp_kernel<ACT, RES, F32OUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kPpSmem);
  if (err != cudaSuccess) return err;
  gemm_pp_kernel<ACT, RES, F32OUT><<<p.grid, kPpThreads, kPpSmem, st>>>(mapA, mapW, mapR, bias,
                                                                        Y, M, N, K);
  return cudaGetLastError();
}

// A product on the route of plan p
template <int ACT, bool RES, bool F32OUT>
cudaError_t gemm_on(const GemmPlan& p, const bf16* A, const bf16* W, const float* bias,
                    const bf16* R, void* Y, int M, int N, int K, cudaStream_t st) {
  switch (p.route) {
    case 0: return gemm_pp<ACT, RES, F32OUT>(A, W, bias, R, Y, M, N, K, p, st);
    case 128: return gemm_tile<128, ACT, RES, F32OUT>(A, W, bias, R, Y, M, N, K, st);
    case 256:
      if constexpr (F32OUT) return gemm_tile<256, ACT, RES, true>(A, W, bias, R, Y, M, N, K, st);
  }
  return cudaErrorInvalidValue;
}

// Every block product, on the route block_gemm_plan gives its shape (route
// < 0), or on `route` (block_gemm_bf16, to test and time each route)
template <int ACT, bool RES, bool F32OUT = false>
cudaError_t gemm(const bf16* A, const bf16* W, const float* bias, const bf16* R, void* Y,
                 int M, int N, int K, cudaStream_t st, int route = -1) {
  GemmPlan p;
  const cudaError_t err = gemm_plan_on(M, N, K, F32OUT, 0, route, &p);
  if (err != cudaSuccess) return err;
  return gemm_on<ACT, RES, F32OUT>(p, A, W, bias, R, Y, M, N, K, st);
}

// Y = act(A . W + bias) for an activation chosen at run time
cudaError_t gemm_act(int act, const bf16* A, const bf16* W, const float* bias, bf16* Y, int M,
                     int N, int K, cudaStream_t st, int route = -1) {
  switch (act) {
    case ACT_GELU_TANH:
      return gemm<ACT_GELU_TANH, false>(A, W, bias, nullptr, Y, M, N, K, st, route);
    case ACT_GELU_EXACT:
      return gemm<ACT_GELU_EXACT, false>(A, W, bias, nullptr, Y, M, N, K, st, route);
    case ACT_GELU_POLY:
      return gemm<ACT_GELU_POLY, false>(A, W, bias, nullptr, Y, M, N, K, st, route);
    case ACT_GELU_POLY_BF16:
      return gemm<ACT_GELU_POLY_BF16, false>(A, W, bias, nullptr, Y, M, N, K, st, route);
    case ACT_GELU_TANH_POLY:
      return gemm<ACT_GELU_TANH_POLY, false>(A, W, bias, nullptr, Y, M, N, K, st, route);
    case ACT_GELU_TANH_POLY_BF16:
      return gemm<ACT_GELU_TANH_POLY_BF16, false>(A, W, bias, nullptr, Y, M, N, K, st, route);
  }
  return cudaErrorInvalidValue;
}

cudaError_t layernorm(const bf16* x, const float* g, const float* b, bf16* y, int rows,
                      int C, float eps, cudaStream_t st) {
  layernorm_kernel<<<(rows + 7) / 8, 256, 0, st>>>(x, g, b, y, rows, C, eps);
  return cudaGetLastError();
}

// ------------------------------------------------- LayerNorm-band GEMM --
// Y[M, N] = act(bf16(LN(X[M, C])) . W[C, N] + bias[N]) for C <= 576 (Hiera's
// widths 144, 288, 576), C and N multiples of 8: the math of layernorm_kernel
// followed by gemm_kernel (f32 statistics, the normalised row rounded to
// bf16, f32 accumulation in k order), in one launch, with nothing of LN(X)
// in device memory.
//
// Bound on an H100: at row 6's shape (16384 x 576 into 1728) 32.6 GFLOP,
// 0.033 ms at 989 TFLOP/s, against 76 MB of rows, W and output (0.023 ms):
// operations. Hopper design: a block owns a band of 128 rows. One producer
// thread loads the band by TMA in 16-row groups (boxes of 64 columns,
// 128-byte swizzle, the K-major layout wgmma reads; 147 KB at C = 576) and
// then streams W tiles (64 K rows x BN columns) through a ring of
// mbarrier-guarded stages; the ring runs on from one column tile to the
// next, so it never drains. The consumer warps normalise each group as it
// lands (ln_band), in place, then the two consumer warpgroups take
// alternate column tiles (ping-pong): each computes a 128 x BN tile (two
// m64 wgmmas a k16 step on one W descriptor), so one warpgroup's epilogue
// (bias from shared memory, GELU, 16-byte stores) overlaps the other's
// products. Each band reads all of W once: 128 bands x 1.99 MB at row 6's
// shape against the 128 x 128-tile GEMM's ~528 MB of A and W tiles. One
// block an SM (setmaxnreg: 40 registers for the producer warpgroup, 232 for
// the consumers' 128 accumulators); ln_gemm_plan sizes the ring from what
// the band leaves of 227 KB (5 stages at C = 576, 8 at C <= 288). Rows past
// M are zero-filled by TMA and not stored; K past C is zero in both
// operands. A tile's products are near what shared memory feeds (two
// m64n128 operand reads and the W tile's TMA write a k16 step); a 2-CTA
// cluster sharing each W tile by TMA multicast ran slower in a trial on an
// H100 and was dropped (PERF.md).
constexpr int kLnBM = 128, kLnMaxC = 576, kLnMaxStages = 8, kLnThreads = 384;
constexpr int kLnChunk = kLnBM * 128;  // bytes of one 64-column chunk of the band

struct LnPlan {
  int bm, bn, stages, cluster;
  int smem;
};

// The one configuration this file is built for at width C, from C alone (the
// Python ln_gemm_plan computes the same); false where C takes the pair of
// launches (layernorm_kernel, then gemm) instead.
bool ln_gemm_plan(int C, LnPlan* p) {
  if (C <= 0 || C > kLnMaxC || C % 8) return false;
  const int band = (C + 63) / 64 * kLnChunk;
  p->bm = kLnBM;
  p->bn = 128;
  p->cluster = 1;
  const int stage = 64 * p->bn * 2;
  const int fit = (kSmemMax - 1024 - band - 64 - 8 * p->bn) / (stage + 24);
  p->stages = fit < kLnMaxStages ? fit : kLnMaxStages;
  p->smem = 1024 + band + p->stages * stage + (8 + 3 * p->stages) * 8 + 8 * p->bn;
  return true;
}

// The LayerNorm of a band in place, by the 8 consumer warps: the band lands
// in 16-row groups (band_full[g]: rows 16 g .. 16 g + 15), and warp w
// normalises rows 16 g + 2 w and 16 g + 2 w + 1 of each group, so every warp
// starts on the first group and the last group leaves little behind. LPR
// lanes a row (32 at C = 576, 16 at 288, 8 at 144); lane l holds units sub,
// sub + LPR, sub + 2 LPR of its row (columns 8 u .. 8 u + 7), sub = l % LPR.
// A pass holds 2 * 32 / LPR rows, two interleaved sets of 32 / LPR, from
// G = 32 / LPR groups. f32 statistics (two passes over the row held in
// registers), written back as bf16 in the same 128-byte-swizzled layout.
template <int LPR>
__device__ __forceinline__ void ln_band(unsigned char* band, uint64_t* band_full,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta, int C, int M, int m0,
                                        int warp, int lane, float eps) {
  constexpr int U = kLnMaxC / 8 / 32 + 1;   // units a lane holds at most (3)
  constexpr int RPI = 32 / LPR;             // rows of a set
  constexpr int NK = 2;                     // interleaved sets a pass
  constexpr int G = RPI;                    // groups a pass (two rows of each)
  const int units = C / 8, sub = lane % LPR;
  float gv[U][8], bv[U][8];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = sub + LPR * i;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gv[i][e] = u < units ? gamma[u * 8 + e] : 0.f;
      bv[i][e] = u < units ? beta[u * 8 + e] : 0.f;
    }
  }
  // unit u of row r: chunk u / 8, 16-byte slot (u % 8) ^ (r % 8) of the
  // row's 128 bytes (the 128-byte swizzle)
  auto at = [&](int r, int u) {
    return reinterpret_cast<uint4*>(band + (u >> 3) * kLnChunk + r * 128 +
                                    (((u & 7) ^ (r & 7)) << 4));
  };
  for (int g0 = 0; g0 < 8; g0 += G) {
    for (int g = g0; g < g0 + G && g < 8; ++g) ufv::hop::mbar_wait(&band_full[g], 0);
    float v[NK][U][8], sum[NK], var[NK], mean[NK], rstd[NK];
    bool live[NK];
    int row[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int q = k * RPI + lane / LPR;  // q / 2: the group, q % 2: the row of two
      row[k] = 16 * (g0 + q / 2) + 2 * warp + q % 2;
      live[k] = g0 + q / 2 < 8 && m0 + row[k] < M;
      sum[k] = var[k] = 0.f;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = sub + LPR * i;
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (live[k] && u < units) q = *at(row[k], u);
        const bf16* hq = reinterpret_cast<const bf16*>(&q);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][i][e] = __bfloat162float(hq[e]);
        sum[k] += tree8(v[k][i]);
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
      for (int k = 0; k < NK; ++k) sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], off);
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      mean[k] = sum[k] / C;
#pragma unroll
      for (int i = 0; i < U; ++i)
        if (sub + LPR * i < units) {
          float d[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) d[e] = (v[k][i][e] - mean[k]) * (v[k][i][e] - mean[k]);
          var[k] += tree8(d);
        }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
      for (int k = 0; k < NK; ++k) var[k] += __shfl_xor_sync(0xffffffffu, var[k], off);
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      rstd[k] = rsqrtf(var[k] / C + eps);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = sub + LPR * i;
        if (live[k] && u < units) {
          uint32_t q[4];
#pragma unroll
          for (int e = 0; e < 8; e += 2)
            q[e / 2] = pack_bf16x2((v[k][i][e] - mean[k]) * rstd[k] * gv[i][e] + bv[i][e],
                                   (v[k][i][e + 1] - mean[k]) * rstd[k] * gv[i][e + 1] +
                                       bv[i][e + 1]);
          *at(row[k], u) = make_uint4(q[0], q[1], q[2], q[3]);
        }
      }
    }
  }
}

// The consumer warpgroups of ln_gemm_kernel: the LayerNorm of the band, then
// the products and epilogues of their column tiles.
template <int BN, int ACT>
__device__ __forceinline__ void ln_gemm_consume(
    unsigned char* band, unsigned char* ring, uint64_t* band_full, uint64_t* full,
    uint64_t* empty, float* bias_s, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ bias, bf16* __restrict__ Y,
    int M, int N, int C, int ST, float eps, int ntiles, int nkc, int m0) {
  namespace h = ufv::hop;
  constexpr int STAGE = 64 * BN * 2;
  h::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;        // consumer warpgroup 0 or 1
  const int warp = (threadIdx.x - 128) >> 5;   // 0..7 over both
  const int lane = threadIdx.x & 31;

  // LayerNorm in place, by the fewest lanes a row that hold it in three
  // 16-byte units each
  {
    const int units = C / 8;
    if (units > 48)
      ln_band<32>(band, band_full, gamma, beta, C, M, m0, warp, lane, eps);
    else if (units > 24)
      ln_band<16>(band, band_full, gamma, beta, C, M, m0, warp, lane, eps);
    else if (units > 12)
      ln_band<8>(band, band_full, gamma, beta, C, M, m0, warp, lane, eps);
    else if (units > 6)
      ln_band<4>(band, band_full, gamma, beta, C, M, m0, warp, lane, eps);
    else
      ln_band<2>(band, band_full, gamma, beta, C, M, m0, warp, lane, eps);
    h::fence_proxy_async();  // the band's new values, before wgmma reads them
    h::named_bar_sync(1, 256);
  }

  // consumer warpgroup cw: the band's column tiles cw, cw + 2, ...;
  // each warp owns rows 16 (warp % 4) .. + 15 of both 64-row halves. phase
  // bit s: the parity of this warpgroup's next wait on stage s.
  const int row0 = m0 + (warp & 3) * 16 + (lane >> 2);
  uint32_t phase = 0;
  for (int p = cw; p < ntiles; p += 2) {
    const int n0 = p * BN;
    float* bs = bias_s + cw * BN;
    h::named_bar_sync(2 + cw, 128);  // the previous tile's epilogue is done with bs
    for (int i = threadIdx.x & 127; i < BN; i += 128) bs[i] = bias && n0 + i < N ? bias[n0 + i] : 0.f;
    float acc[2][BN / 2];  // rows 0-63 and 64-127 of the band
    float (&acc0)[BN / 2] = acc[0];
    float (&acc1)[BN / 2] = acc[1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.f;
    for (int kt = 0; kt < nkc; ++kt) {
      const int it = p * nkc + kt;
      const int st = it % ST;
      h::mbar_wait(&full[cw * ST + st], (phase >> st) & 1);
      phase ^= 1u << st;
      const unsigned char* a = band + kt * kLnChunk;
      const unsigned char* b = ring + st * STAGE;
      h::fence_regs(acc0);
      h::fence_regs(acc1);
      h::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = h::make_desc(b + kk * 16 * 128, 8192, 1024, 1);
        wgmma_gemm<BN>(acc0, h::make_desc(a + kk * 32, 16, 1024, 1), db);
        wgmma_gemm<BN>(acc1, h::make_desc(a + 64 * 128 + kk * 32, 16, 1024, 1), db);
      }
      h::wgmma_commit();
      h::wgmma_wait<1>();  // the previous stage's products are done: release it
      h::fence_regs(acc0);
      h::fence_regs(acc1);
      if (kt > 0 && lane == 0) h::mbar_arrive(&empty[(it - 1) % ST]);
    }
    h::wgmma_wait<0>();
    h::fence_regs(acc0);
    h::fence_regs(acc1);
    if (lane == 0) h::mbar_arrive(&empty[(p * nkc + nkc - 1) % ST]);
    h::named_bar_sync(2 + cw, 128);  // bs holds this tile's bias
    store_rows16<BN, ACT, false, 2>(acc, bs, row0, m0, n0, nullptr, nullptr, Y, M, N);
  }
}

template <int BN, int ACT>
__global__ void __launch_bounds__(kLnThreads, 1) ln_gemm_kernel(
    __grid_constant__ const CUtensorMap mapX, __grid_constant__ const CUtensorMap mapW,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ bias, bf16* __restrict__ Y, int M, int N, int C, int ST,
    float eps) {
  namespace h = ufv::hop;
  constexpr int STAGE = 64 * BN * 2;
  extern __shared__ __align__(1024) unsigned char lsmem_raw[];
  unsigned char* band = lsmem_raw + ((1024 - (h::smem_u32(lsmem_raw) & 1023)) & 1023);
  const int nkc = (C + 63) / 64;
  unsigned char* ring = band + nkc * kLnChunk;
  // full[w * ST + s]: stage s holds a tile for consumer warpgroup w. One
  // barrier a stage for both would let a warpgroup that waits for its next
  // tile see the phase of the other's last use of that stage as its own.
  // band_full[g]: rows 16 g .. 16 g + 15 of the band have landed
  uint64_t* band_full = reinterpret_cast<uint64_t*>(ring + ST * STAGE);
  uint64_t* full = band_full + 8;
  uint64_t* empty = full + 2 * ST;
  float* bias_s = reinterpret_cast<float*>(empty + ST);  // [2][BN]: each warpgroup's tile
  const int ntiles = (N + BN - 1) / BN;
  const int m0 = blockIdx.x * kLnBM;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 8; ++w) h::mbar_init(&band_full[w], 1);
    for (int s = 0; s < ST; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&full[ST + s], 1);
      h::mbar_init(&empty[s], 4);  // lane 0 of each warp of the consuming warpgroup
    }
    h::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup; one thread issues every load
    h::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // the band in 16-row groups, so the warps normalise while the rest of
      // the band is in flight
      for (int g = 0; g < 8; ++g) {
        h::mbar_expect_tx(&band_full[g], nkc * 16 * 128);
        for (int kc = 0; kc < nkc; ++kc)
          h::tma_load_2d(band + kc * kLnChunk + g * 16 * 128, &mapX, &band_full[g], kc * 64,
                         m0 + 16 * g);
      }
      int it = 0;  // stages in the order the consumers take them: tile, then k
      for (int p = 0; p < ntiles; ++p) {
        const int n0 = p * BN;
        for (int kt = 0; kt < nkc; ++kt, ++it) {
          const int st = it % ST;
          uint64_t* f = &full[(p & 1) * ST + st];
          h::mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
          unsigned char* stage = ring + st * STAGE;
          h::mbar_expect_tx(f, STAGE);
#pragma unroll
          for (int nb = 0; nb < BN / 64; ++nb)
            h::tma_load_2d(stage + nb * 8192, &mapW, f, n0 + 64 * nb, kt * 64);
        }
      }
    }
    return;
  }
  ln_gemm_consume<BN, ACT>(band, ring, band_full, full, empty, bias_s, gamma, beta, bias, Y, M,
                           N, C, ST, eps, ntiles, nkc, m0);
}

template <int ACT>
cudaError_t ln_gemm_launch(const CUtensorMap& mapX, const CUtensorMap& mapW, const float* g,
                           const float* b, const float* bias, bf16* Y, int M, int N, int C,
                           float eps, const LnPlan& p, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      ln_gemm_kernel<128, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  ln_gemm_kernel<128, ACT><<<(M + kLnBM - 1) / kLnBM, kLnThreads, p.smem, st>>>(
      mapX, mapW, g, b, bias, Y, M, N, C, p.stages, eps);
  return cudaGetLastError();
}

// Y = act(bf16(LN(X)) . W + bias) in one launch, on the plan ln_gemm_plan
// gave for C; act 0 is none, 1-6 the GELUs
cudaError_t ln_gemm(int act, const bf16* X, const float* g, const float* b, const bf16* W,
                    const float* bias, bf16* Y, int M, int N, int C, float eps,
                    const LnPlan& p, cudaStream_t st) {
  CUtensorMap mapX, mapW;
  const cuuint64_t dimsX[2] = {cuuint64_t(C), cuuint64_t(M)}, strideX[1] = {cuuint64_t(C) * 2};
  const cuuint64_t dimsW[2] = {cuuint64_t(N), cuuint64_t(C)}, strideW[1] = {cuuint64_t(N) * 2};
  const cuuint32_t boxX[2] = {64, 16}, boxW[2] = {64, 64};
  cudaError_t err = ufv::hop::make_map(&mapX, X, 2, dimsX, strideX, boxX);
  if (err == cudaSuccess) err = ufv::hop::make_map(&mapW, W, 2, dimsW, strideW, boxW);
  if (err != cudaSuccess) return err;
  switch (act) {
#define UFV_LN_ACT(a) \
    case a: return ln_gemm_launch<a>(mapX, mapW, g, b, bias, Y, M, N, C, eps, p, st);
    UFV_LN_ACT(ACT_NONE)
    UFV_LN_ACT(ACT_GELU_TANH)
    UFV_LN_ACT(ACT_GELU_EXACT)
    UFV_LN_ACT(ACT_GELU_POLY)
    UFV_LN_ACT(ACT_GELU_POLY_BF16)
    UFV_LN_ACT(ACT_GELU_TANH_POLY)
    UFV_LN_ACT(ACT_GELU_TANH_POLY_BF16)
#undef UFV_LN_ACT
  }
  return cudaErrorInvalidValue;
}

// dst[(n*Sq + oy*(ws/sx) + ox), c] = max over the sy x sx patch of
// src[(n*ws*ws + (oy*sy+dy)*ws + ox*sx+dx) * ld + col0 + c]: the window-
// interior max-pool (tokens are row-major inside a window). One thread per
// 8-column vector of one output row; D % 8 == 0.
__global__ void __launch_bounds__(256) pool_kernel(
    const bf16* __restrict__ src, bf16* __restrict__ dst, long long out_rows, int ws, int sy,
    int sx, long long ld, int col0, int D) {
  const int vecs = D / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= out_rows * vecs) return;
  const long long r = i / vecs;
  const int c = int(i % vecs) * 8;
  const int qw = ws / sx, sq = (ws / sy) * qw;
  const long long n = r / sq;
  const int oy = int(r % sq) / qw, ox = int(r % sq) % qw;
  float m[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) m[e] = -INFINITY;
  for (int dy = 0; dy < sy; ++dy)
    for (int dx = 0; dx < sx; ++dx) {
      const long long row = n * ws * ws + (long long)(oy * sy + dy) * ws + ox * sx + dx;
      const uint4 v = *reinterpret_cast<const uint4*>(src + row * ld + col0 + c);
      const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = fmaxf(m[e], __bfloat162float(h[e]));
    }
  uint4 o;
  bf16* oh = reinterpret_cast<bf16*>(&o);
#pragma unroll
  for (int e = 0; e < 8; ++e) oh[e] = __float2bfloat16(m[e]);  // exact: a max of bf16 values
  *reinterpret_cast<uint4*>(dst + r * D + c) = o;
}

cudaError_t pool(const bf16* src, bf16* dst, long long out_rows, int ws, int sy, int sx,
                 long long ld, int col0, int D, cudaStream_t st) {
  const long long total = out_rows * (D / 8);
  pool_kernel<<<unsigned((total + 255) / 256), 256, 0, st>>>(src, dst, out_rows, ws, sy, sx,
                                                             ld, col0, D);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The shared tail of every block: x1 = R + bf16(A . wproj + bproj);
// hmid = GELU(bf16(LN2(x1)) . w1 + b1); out = x1 + bf16(hmid . w2 + b2).
// A [rows, a_dim], R / x1 / out [rows, C], hmid [rows, mlp]. Three launches
// where ln_gemm_plan takes C (LN2 inside the fc1 launch; xn unused, may be
// null), else four through the scratch xn [rows, C]; proj and fc2 on the
// route block_gemm_plan gives them.
cudaError_t block_tail(const bf16* A, const bf16* R, const bf16* wproj, const float* bproj,
                       const float* ln2_s, const float* ln2_b, const bf16* w1,
                       const float* b1, const bf16* w2, const float* b2, bf16* x1, bf16* xn,
                       bf16* hmid, bf16* out, int rows, int C, int a_dim, int mlp, int act,
                       float eps, cudaStream_t st) {
  LnPlan p;
  const bool banded = ln_gemm_plan(C, &p);
  cudaError_t e;
  if ((e = gemm<ACT_NONE, true>(A, wproj, bproj, R, x1, rows, C, a_dim, st))) return e;
  if (banded) {
    if ((e = ln_gemm(act, x1, ln2_s, ln2_b, w1, b1, hmid, rows, mlp, C, eps, p, st))) return e;
  } else {
    if (!xn) return cudaErrorInvalidValue;
    if ((e = layernorm(x1, ln2_s, ln2_b, xn, rows, C, eps, st))) return e;
    if ((e = gemm_act(act, xn, w1, b1, hmid, rows, mlp, C, st))) return e;
  }
  return gemm<ACT_NONE, true>(hmid, w2, b2, x1, out, rows, C, mlp, st);
}

// the plan a caller passed (bm, bn, stages, cluster; all 0 for the pair of
// launches) is the one this file is built for at width C
bool plan_is(int C, int bm, int bn, int stages, int cluster) {
  LnPlan p;
  if (!ln_gemm_plan(C, &p)) return bm == 0 && bn == 0 && stages == 0 && cluster == 0;
  return bm == p.bm && bn == p.bn && stages == p.stages && cluster == p.cluster;
}

// Non-causal attention of Sq queries on Skv keys in each of N windows, q /
// k / v given by base pointer and row stride (elements), heads packed along
// a row; o [N * Sq, heads * head_dim] contiguous.
cudaError_t window_attention(const bf16* q, long long q_ld, const bf16* k, const bf16* v,
                             long long kv_ld, bf16* o, int N, int Sq, int Skv, int heads,
                             int head_dim, cudaStream_t st) {
  const int hw = heads * head_dim;
  ufv::AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.kv_lens = nullptr;
  a.kv_mask = nullptr;
  a.B = N; a.Sq = Sq; a.Skv = Skv; a.Hq = heads; a.Hkv = heads; a.D = head_dim;
  a.q_sb = (long long)Sq * q_ld; a.q_ss = q_ld; a.q_sh = head_dim;
  a.k_sb = a.v_sb = (long long)Skv * kv_ld;
  a.k_ss = a.v_ss = kv_ld;
  a.k_sh = a.v_sh = head_dim;
  a.o_sb = (long long)Sq * hw; a.o_ss = hw; a.o_sh = head_dim;
  a.scale = 1.0f / sqrtf(float(head_dim));
  a.causal = 0;
  return ufv::attention_forward(a, st);
}

bool all_aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

bool act_ok(int act) { return act >= ACT_GELU_TANH && act <= ACT_GELU_TANH_POLY_BF16; }

const float* f32(const void* p) { return static_cast<const float*>(p); }
const bf16* b16(const void* p) { return static_cast<const bf16*>(p); }
bf16* b16(void* p) { return static_cast<bf16*>(p); }


// ---------------------------------------------------------------- W8A8 --
// The whole block with int8 weights [in, out] (per-column f32 scales) and
// activations quantised per row just before each product: LN1 (f32) ->
// rows to int8 -> s8 x s8 -> s32 qkv, rescaled acc * xs[row] * ws[col] + b
// -> bf16 attention (the kernel above) -> rows of the attention output to
// int8 -> proj + residual -> LN2 -> int8 -> fc1 -> GELU kept in f32 -> rows
// to int8 -> fc2 + residual. Math of the JAX w8a8_reference; a row's scale
// is max(amax * (1/127), 1e-8) and values round half to even.
//
// Bound on an H100: at the SigLIP shape the four products are 711 G
// multiply-adds' worth of int8 operations (0.36 ms at 1979 TOP/s) plus 78
// GFLOP of bf16 attention (0.08 ms): bound by operations. Design: the int32
// sums are exact, so the products are one int8 GEMM for Hopper (below) whose
// epilogue applies the two scales, the bias, and the GELU or the residual.
// Both operands are K-contiguous, as 8-bit wgmma wants them: the weights are
// transposed to [out, in] (K zero-padded to a multiple of 32: 4304 -> 4320)
// by a small pass at each call, 13 MB a block against its milliseconds. A
// row's amax spans every column tile, so quantising is a pass of its own (one
// warp a row) and not a GEMM epilogue; after fc1 it reads the f32 GELU
// output, as the reference does. The attention output is quantised from its
// bf16 form, as the TPU kernel's scratch is.

enum QEpi { Q_BF16 = 0, Q_RES = 1, Q_ACT_F32 = 2, Q_S32 = 3 };

// ------------------------------------------------------------ int8 GEMM --
// Y[M, N] = epilogue(float(A[M, Kp] . Bt[N, Kp]^T) * xs[m] * ws[n] + bias[n]);
// A and Bt int8, rows of Kp bytes (Kp % 16 == 0, zero beyond the true K), N
// even. Epilogues: bf16; bf16(bf16(v) + R); act(v) as f32; the raw int32
// sums (xs, ws and bias unused).
//
// Hopper design: the bf16 GEMM's ring (one producer warp issuing TMA, two
// consumer warpgroups, full / empty mbarriers, one group of wgmmas in
// flight) with an int8 element. A stage is 128 bytes of K: the A tile (128
// rows) and the B tile (BN rows of Bt), one TMA box each, both K-major in
// 128-byte-swizzled rows, so a stage holds as many bytes as the bf16 GEMM's
// and GemmCfg<BN> sizes the ring. Each consumer warpgroup owns 64 rows and
// issues wgmma.mma_async m64nBNk32 (s8 x s8 -> s32) four times a stage, each
// step 32 bytes along both operands' rows. Two tiles: BN = 128, two blocks
// an SM, so that one block's epilogue overlaps the other's products; and BN
// = 256, one block an SM, which halves the A tile's shared-memory reads a
// product needs but leaves its epilogue exposed. Only the raw int32
// epilogue takes the wide tile (at Kp >= 1024 and N >= 2048: the probe): on
// an H100 it ran the probe 5% faster, while SigLIP's W8A8 block ran 9%
// slower with its qkv and fc1 products (bf16 and GELU epilogues) on it
// (PERF.md). TMA zero-fills past M, N and Kp; the epilogue masks its
// stores. int32 sums are exact and each output is summed and rescaled by one
// thread in a fixed order: the result repeats bit for bit. Not yet: a
// 64-byte-swizzle stage for Hiera's short K (Kp 160 fills 160 of two
// stages' 256 bytes of K), stores staged through shared memory (a warp
// writes 16 or 32 bytes of a row at a time), a persistent grid.
constexpr int kSBK = 128;  // bytes of K a stage

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    ufv::hop::wgmma_s8_n256(acc, da, db, 1);
  else
    ufv::hop::wgmma_s8_n128(acc, da, db, 1);
}

template <int BN, int EPI, int ACT>
__global__ void __launch_bounds__(kGThreads, GemmCfg<BN>::PER_SM) gemm_s8_kernel(
    __grid_constant__ const CUtensorMap mapA, __grid_constant__ const CUtensorMap mapB,
    const float* __restrict__ xs, const float* __restrict__ ws,
    const float* __restrict__ bias, const bf16* __restrict__ R, void* __restrict__ Yv, int M,
    int N, int Kp) {
  namespace h = ufv::hop;
  using C = GemmCfg<BN>;
  constexpr int ST = C::STAGES;
  extern __shared__ __align__(1024) unsigned char gsmem_raw[];
  unsigned char* smem = gsmem_raw + ((1024 - (h::smem_u32(gsmem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * C::STAGE);
  uint64_t* empty = full + ST;
  const int nk = (Kp + kSBK - 1) / kSBK;
  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      h::mbar_init(&full[st], 1);
      h::mbar_init(&empty[st], 8);  // lane 0 of each consumer warp
    }
    h::fence_barrier_init();
  }
  __syncthreads();

  const int m0 = blockIdx.y * kGBM, n0 = blockIdx.x * BN;
  if (threadIdx.x >= 256) {  // producer warp: one thread issues every load
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST;
        h::mbar_wait(&empty[st], ((kt / ST) & 1) ^ 1);
        unsigned char* stage = smem + st * C::STAGE;
        h::mbar_expect_tx(&full[st], C::STAGE);
        h::tma_load_2d(stage, &mapA, &full[st], kt * kSBK, m0);
        h::tma_load_2d(stage + C::TILE_A, &mapB, &full[st], kt * kSBK, n0);
      }
    }
    return;
  }
  // consumer warpgroups 0 and 1: rows 64 cw .. +63 of the tile
  const int cw = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % ST;
    h::mbar_wait(&full[st], (kt / ST) & 1);
    const unsigned char* a = smem + st * C::STAGE + cw * 64 * kSBK;
    const unsigned char* b = smem + st * C::STAGE + C::TILE_A;
    h::fence_regs(acc);
    h::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSBK / 32; ++kk)
      wgmma_s8<BN>(acc, h::make_desc(a + kk * 32, 16, 1024, 1),
                   h::make_desc(b + kk * 32, 16, 1024, 1));
    h::wgmma_commit();
    h::wgmma_wait<1>();  // the previous stage's products are done: release it
    h::fence_regs(acc);
    if (kt > 0 && lane == 0) h::mbar_arrive(&empty[(kt - 1) % ST]);
  }
  h::wgmma_wait<0>();
  h::fence_regs(acc);

  // accumulator 4 j + e: row m0 + 64 cw + 16 warp + g + 8 (e >= 2), column
  // n0 + 8 j + 2 tig + (e & 1)
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = m0 + cw * 64 + ((threadIdx.x & 127) >> 5) * 16 + g;
  float xr[2] = {0.f, 0.f};
  if constexpr (EPI != Q_S32) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (row0 + 8 * half < M) xr[half] = xs[row0 + 8 * half];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * tig;
    if (col >= N) continue;  // N even: col + 1 < N too
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= M) continue;
      const int s0 = acc[4 * j + 2 * half], s1 = acc[4 * j + 2 * half + 1];
      const long long off = (long long)row * N + col;
      if constexpr (EPI == Q_S32) {
        *reinterpret_cast<int2*>(static_cast<int*>(Yv) + off) = make_int2(s0, s1);
      } else {
        float v0 = float(s0) * xr[half] * ws[col] + bias[col];
        float v1 = float(s1) * xr[half] * ws[col + 1] + bias[col + 1];
        if constexpr (EPI == Q_ACT_F32) {
          v0 = act_apply<ACT>(v0);
          v1 = act_apply<ACT>(v1);
          *reinterpret_cast<float2*>(static_cast<float*>(Yv) + off) = make_float2(v0, v1);
        } else {
          if constexpr (EPI == Q_RES) {
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(R + off));
            v0 = __bfloat162float(__float2bfloat16(v0)) + r.x;
            v1 = __bfloat162float(__float2bfloat16(v1)) + r.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(Yv) + off) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int BN, int EPI, int ACT>
cudaError_t gemm_s8_launch(const CUtensorMap& mapA, const CUtensorMap& mapB, const float* xs,
                           const float* ws, const float* bias, const bf16* R, void* Y, int M,
                           int N, int Kp, cudaStream_t st) {
  using C = GemmCfg<BN>;
  const cudaError_t err = cudaFuncSetAttribute(gemm_s8_kernel<BN, EPI, ACT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               int(C::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + kGBM - 1) / kGBM);
  gemm_s8_kernel<BN, EPI, ACT><<<grid, kGThreads, C::SMEM, st>>>(mapA, mapB, xs, ws, bias, R, Y,
                                                                  M, N, Kp);
  return cudaGetLastError();
}

// The tensor maps are built at each call from that call's Kp, which is both
// the K extent and the row stride (tail_w8a8 reuses qa with two strides).
template <int EPI, int ACT = ACT_NONE>
cudaError_t gemm_s8(const int8_t* A, const int8_t* Bt, const float* xs, const float* ws,
                    const float* bias, const bf16* R, void* Y, int M, int N, int Kp,
                    cudaStream_t st) {
  namespace h = ufv::hop;
  constexpr bool kWideTile = EPI == Q_S32;
  const bool wide = kWideTile && Kp >= 1024 && N >= 2048;
  CUtensorMap mapA, mapB;
  const cuuint64_t dimsA[2] = {cuuint64_t(Kp), cuuint64_t(M)};
  const cuuint64_t dimsB[2] = {cuuint64_t(Kp), cuuint64_t(N)}, stride[1] = {cuuint64_t(Kp)};
  const cuuint32_t boxA[2] = {kSBK, kGBM}, boxB[2] = {kSBK, wide ? 256u : 128u};
  cudaError_t err = h::make_map(&mapA, A, 2, dimsA, stride, boxA, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err == cudaSuccess)
    err = h::make_map(&mapB, Bt, 2, dimsB, stride, boxB, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (err != cudaSuccess) return err;
  if constexpr (kWideTile)
    if (wide) return gemm_s8_launch<256, EPI, ACT>(mapA, mapB, xs, ws, bias, R, Y, M, N, Kp, st);
  return gemm_s8_launch<128, EPI, ACT>(mapA, mapB, xs, ws, bias, R, Y, M, N, Kp, st);
}

// hmid = act(rescaled A . Bt) as f32, for an activation chosen at run time
cudaError_t gemm_s8_act(int act, const int8_t* A, const int8_t* Bt, const float* xs,
                        const float* ws, const float* bias, float* Y, int M, int N, int Kp,
                        cudaStream_t st) {
  switch (act) {
#define UFV_S8_ACT(a) \
    case a: return gemm_s8<Q_ACT_F32, a>(A, Bt, xs, ws, bias, nullptr, Y, M, N, Kp, st);
    UFV_S8_ACT(ACT_GELU_TANH)
    UFV_S8_ACT(ACT_GELU_EXACT)
    UFV_S8_ACT(ACT_GELU_POLY)
    UFV_S8_ACT(ACT_GELU_POLY_BF16)
    UFV_S8_ACT(ACT_GELU_TANH_POLY)
    UFV_S8_ACT(ACT_GELU_TANH_POLY_BF16)
#undef UFV_S8_ACT
  }
  return cudaErrorInvalidValue;
}

// q[r, c] = clip(rint(x[r, c]), -127, 127) for c < K (half to even), 0 for K
// <= c < Kp: bf16 x [M, K] -> int8 q [M, Kp], K and Kp multiples of 8; the
// probe's x on its way to the int8 GEMM (TMA copies bytes and converts
// nothing). One thread per 8 bytes of q.
__global__ void __launch_bounds__(256) round_clip_s8_kernel(const bf16* __restrict__ x,
                                                            int8_t* __restrict__ q, int M,
                                                            int K, int Kp) {
  const int vecs = Kp / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * vecs) return;
  const long long r = i / vecs;
  const int c = int(i % vecs) * 8;
  uint32_t w[2] = {0u, 0u};
  if (c < K) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + r * K + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = __float2int_rn(fminf(fmaxf(__bfloat162float(e[j]), -127.f), 127.f));
      w[j / 4] |= (uint32_t(t) & 0xffu) << (8 * (j % 4));
    }
  }
  *reinterpret_cast<uint2*>(q + r * Kp + c) = make_uint2(w[0], w[1]);
}

cudaError_t round_clip_s8(const bf16* x, int8_t* q, int M, int K, int Kp, cudaStream_t st) {
  const long long total = (long long)M * (Kp / 8);
  round_clip_s8_kernel<<<unsigned((total + 255) / 256), 256, 0, st>>>(x, q, M, K, Kp);
  return cudaGetLastError();
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

// One warp per row: v = LN ? (x - mean) * rstd * gamma + beta : x, in f32;
// s = max(amax|v| * (1/127), 1e-8); q[row, c] = rint(v / s) for c < C and 0
// for C <= c < Kp; xs[row] = s. With BF16 (the output of a bf16 polynomial
// GELU: f32 values that bf16 holds exactly) the JAX _quant_rows_f32 on a
// bf16 array: amax * bf16(1/127), the floor bf16(1e-8) and the quotient each
// rounded to bf16, a quotient of 128 saturated to 127 as XLA converts it.
template <typename T, bool LN, bool BF16 = false>
__global__ void __launch_bounds__(256) rowquant_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    int8_t* __restrict__ q, float* __restrict__ xs, int rows, int C, int Kp, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (long long)row * C;
  float mean = 0.f, rstd = 1.f;
  if (LN) {
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += as_float(xr[c]);
    mean = ufv::warp_sum(sum) / C;
    float var = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = as_float(xr[c]) - mean;
      var += d * d;
    }
    rstd = rsqrtf(ufv::warp_sum(var) / C + eps);
  }
  auto value = [&](int c) {
    const float v = as_float(xr[c]);
    return LN ? (v - mean) * rstd * gamma[c] + beta[c] : v;
  };
  float amax = 0.f;
  for (int c = lane; c < C; c += 32) amax = fmaxf(amax, fabsf(value(c)));
  amax = ufv::warp_max(amax);
  const float s = BF16 ? fmaxf(rbf(__fmul_rn(amax, rbf(1.f / 127.f))), rbf(1e-8f))
                      : fmaxf(amax * 0.007874015748031496f, 1e-8f);
  int8_t* qr = q + (long long)row * Kp;
  for (int c = lane; c < Kp; c += 32) {
    int v = 0;
    if (c < C)
      v = BF16 ? min(__float2int_rn(rbf(__fdiv_rn(value(c), s))), 127)
               : __float2int_rn(value(c) / s);
    qr[c] = static_cast<int8_t>(v);
  }
  if (lane == 0) xs[row] = s;
}

template <typename T, bool LN, bool BF16 = false>
cudaError_t rowquant(const T* x, const float* g, const float* b, int8_t* q, float* xs, int rows,
                     int C, int Kp, float eps, cudaStream_t st) {
  rowquant_kernel<T, LN, BF16><<<(rows + 7) / 8, 256, 0, st>>>(x, g, b, q, xs, rows, C, Kp, eps);
  return cudaGetLastError();
}

// wt[n, k] = w[k, n] for k < K, 0 for K <= k < Kp (Kp % 32 == 0): int8
// [K, N] -> [N, Kp]. Block (32, 8), one 32 x 32 tile through shared memory.
__global__ void __launch_bounds__(256) transpose_s8_kernel(const int8_t* __restrict__ w,
                                                           int8_t* __restrict__ wt, int K,
                                                           int N, int Kp) {
  __shared__ int8_t tile[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int k = k0 + j, n = n0 + threadIdx.x;
    tile[j][threadIdx.x] = (k < K && n < N) ? w[(long long)k * N + n] : int8_t(0);
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int n = n0 + j;
    if (n < N) wt[(long long)n * Kp + k0 + threadIdx.x] = tile[threadIdx.x][j];
  }
}

cudaError_t transpose_s8(const int8_t* w, int8_t* wt, int K, int N, int Kp, cudaStream_t st) {
  dim3 grid((N + 31) / 32, Kp / 32), block(32, 8);
  transpose_s8_kernel<<<grid, block, 0, st>>>(w, wt, K, N, Kp);
  return cudaGetLastError();
}

const int8_t* s8(const void* p) { return static_cast<const int8_t*>(p); }
int8_t* s8(void* p) { return static_cast<int8_t*>(p); }

int pad32(int k) { return (k + 31) / 32 * 32; }

// The shared tail of every W8A8 block: rows of A (bf16 attention output) to
// int8 -> x1 = R + bf16(proj); LN2 (f32) -> int8 -> hmid = GELU(fc1) kept in
// f32 -> rows to int8 (in bf16 steps after a bf16 polynomial) -> out = x1 +
// bf16(fc2). A [rows, a_dim], R / x1 / out
// [rows, C]. Scratch: wproj_t [C, pad32(a_dim)], w1_t [mlp, pad32(C)], w2_t
// [C, pad32(mlp)], qa [rows, max(pad32(C), pad32(a_dim))], qh [rows,
// pad32(mlp)] (int8); xs [rows] (f32); hmid [rows, mlp] (f32).
cudaError_t tail_w8a8(const bf16* A, const bf16* R, const int8_t* wproj, const float* sproj,
                      const float* bproj, const float* ln2_s, const float* ln2_b,
                      const int8_t* w1, const float* s1, const float* b1, const int8_t* w2,
                      const float* s2, const float* b2, int8_t* wproj_t, int8_t* w1_t,
                      int8_t* w2_t, int8_t* qa, int8_t* qh, float* xs, bf16* x1, float* hmid,
                      bf16* out, int rows, int C, int a_dim, int mlp, int act, float eps,
                      cudaStream_t st) {
  const int Kc = pad32(C), Ka = pad32(a_dim), Km = pad32(mlp);
  cudaError_t e;
  if ((e = transpose_s8(wproj, wproj_t, a_dim, C, Ka, st))) return e;
  if ((e = transpose_s8(w1, w1_t, C, mlp, Kc, st))) return e;
  if ((e = transpose_s8(w2, w2_t, mlp, C, Km, st))) return e;
  if ((e = rowquant<bf16, false>(A, nullptr, nullptr, qa, xs, rows, a_dim, Ka, eps, st))) return e;
  if ((e = gemm_s8<Q_RES>(qa, wproj_t, xs, sproj, bproj, R, x1, rows, C, Ka, st))) return e;
  if ((e = rowquant<bf16, true>(x1, ln2_s, ln2_b, qa, xs, rows, C, Kc, eps, st))) return e;
  if ((e = gemm_s8_act(act, qa, w1_t, xs, s1, b1, hmid, rows, mlp, Kc, st))) return e;
  // a bf16 polynomial's output is quantised in bf16, as the JAX kernels' bodies do
  const bool bf16_rows = act == ACT_GELU_POLY_BF16 || act == ACT_GELU_TANH_POLY_BF16;
  if ((e = bf16_rows
               ? rowquant<float, false, true>(hmid, nullptr, nullptr, qh, xs, rows, mlp, Km, eps, st)
               : rowquant<float, false>(hmid, nullptr, nullptr, qh, xs, rows, mlp, Km, eps, st)))
    return e;
  return gemm_s8<Q_RES>(qh, w2_t, xs, s2, b2, x1, out, rows, C, Km, st);
}

// One whole bf16 block: x -> out (distinct buffers). Scratch as
// hiera_block_bf16 lists it.
cudaError_t block_bf16(const bf16* x, bf16* out, const float* ln1_s, const float* ln1_b,
                       const bf16* wqkv, const float* bqkv, const bf16* wproj,
                       const float* bproj, const float* ln2_s, const float* ln2_b,
                       const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                       bf16* xn, bf16* qkv, bf16* att, bf16* x1, bf16* hmid, int N, int S,
                       int C, int heads, int head_dim, int mlp, int act, float eps,
                       cudaStream_t st) {
  const int rows = N * S;
  const int hw = heads * head_dim;
  cudaError_t e;
  if ((e = layernorm(x, ln1_s, ln1_b, xn, rows, C, eps, st))) return e;
  if ((e = gemm<ACT_NONE, false>(xn, wqkv, bqkv, nullptr, qkv, rows, 3 * hw, C, st))) return e;
  if ((e = window_attention(qkv, 3LL * hw, qkv + hw, qkv + 2 * hw, 3LL * hw, att, N, S, S,
                            heads, head_dim, st)))
    return e;
  return block_tail(att, x, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2, x1, xn, hmid, out,
                    rows, C, hw, mlp, act, eps, st);
}

bool block_dims_ok(int rows, int C, int head_dim, int mlp, int act) {
  return rows > 0 && C % 8 == 0 && head_dim % 8 == 0 && mlp % 8 == 0 && head_dim <= 128 &&
         act_ok(act);
}

}  // namespace

extern "C" const char* ufv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#define UFV_TRY(expr)                         \
  do {                                        \
    cudaError_t e_ = (expr);                  \
    if (e_ != cudaSuccess) return int(e_);    \
  } while (0)

// x, out [N, S, C] bf16; weights bf16 in [in, out] layout: wqkv [C, 3*H*hd]
// (q heads | k heads | v heads), wproj [H*hd, C], w1 [C, mlp], w2 [mlp, C];
// LayerNorm vectors and biases f32. Scratch (bf16, row-major): xn [N*S, C],
// qkv [N*S, 3*H*hd], att [N*S, H*hd], x1 [N*S, C], hmid [N*S, mlp].
// act: 1 = gelu_tanh, 2 = gelu_exact. Returns the first CUDA error or 0.
extern "C" int hiera_block_bf16(
    const void* x, void* out, const void* ln1_s, const void* ln1_b, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* ln2_s,
    const void* ln2_b, const void* w1, const void* b1, const void* w2, const void* b2,
    void* xn, void* qkv, void* att, void* x1, void* hmid, int N, int S, int C, int heads,
    int head_dim, int mlp, int act, float eps, void* stream) {
  if (!block_dims_ok(N * S, C, head_dim, mlp, act)) return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, out, wqkv, wproj, w1, w2, xn, qkv, att, x1, hmid}))
    return int(cudaErrorMisalignedAddress);
  UFV_TRY(block_bf16(b16(x), b16(out), f32(ln1_s), f32(ln1_b), b16(wqkv), f32(bqkv),
                     b16(wproj), f32(bproj), f32(ln2_s), f32(ln2_b), b16(w1), f32(b1), b16(w2),
                     f32(b2), b16(xn), b16(qkv), b16(att), b16(x1), b16(hmid), N, S, C, heads,
                     head_dim, mlp, act, eps, static_cast<cudaStream_t>(stream)));
  return 0;
}

// fused_hiera_stage (_stage_forward / _stage_kernel): nb consecutive whole
// blocks of the same shape, x -> out. params is a host array of 12 * nb
// pointers, block after block in hiera_block_bf16's order (ln1_s, ln1_b,
// wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2). The rows are
// carried through the blocks in two device buffers, out and tmp [N, S, C]
// (tmp unused when nb == 1), so no block reads the buffer it writes: block
// b writes out when nb - 1 - b is even, else tmp, and reads what block b - 1
// wrote. Every launch goes to one stream, so block b + 1 starts after block
// b's residual epilogue has finished; the scratch (xn, qkv, att, x1, hmid as
// in hiera_block_bf16) is shared by all blocks. Not yet: keeping a window's
// rows in shared memory across blocks (stage 1: 64 x 144 bf16 = 18 KB).
extern "C" int hiera_stage_bf16(
    const void* x, void* out, void* tmp, const void* const* params, int nb, void* xn,
    void* qkv, void* att, void* x1, void* hmid, int N, int S, int C, int heads, int head_dim,
    int mlp, int act, float eps, void* stream) {
  if (nb <= 0 || !params || !block_dims_ok(N * S, C, head_dim, mlp, act) ||
      (nb > 1 && (tmp == out || tmp == x)) || out == x)
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, out, tmp, xn, qkv, att, x1, hmid}))
    return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* src = x;
  for (int b = 0; b < nb; ++b) {
    const void* const* p = params + 12 * b;
    if (!all_aligned16({p[2], p[4], p[8], p[10]})) return int(cudaErrorMisalignedAddress);
    void* dst = (nb - 1 - b) % 2 == 0 ? out : tmp;
    UFV_TRY(block_bf16(b16(src), b16(dst), f32(p[0]), f32(p[1]), b16(p[2]), f32(p[3]),
                       b16(p[4]), f32(p[5]), f32(p[6]), f32(p[7]), b16(p[8]), f32(p[9]),
                       b16(p[10]), f32(p[11]), b16(xn), b16(qkv), b16(att), b16(x1),
                       b16(hmid), N, S, C, heads, head_dim, mlp, act, eps, st));
    src = dst;
  }
  return 0;
}

// scripts/probe_int8_rate.py pallas_step (_pallas_dot_kernel), quant=False:
// y [M, N] f32 = x [M, K] bf16 . w [K, N] bf16, f32 accumulation (the bf16
// GEMM above with an f32 epilogue and no bias). K and N multiples of 8.
extern "C" int probe_gemm_bf16(const void* x, const void* w, void* y, int M, int K, int N,
                               void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8) return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, w, y})) return int(cudaErrorMisalignedAddress);
  UFV_TRY((gemm<ACT_NONE, false, true>(b16(x), b16(w), nullptr, nullptr, y, M, N, K,
                                       static_cast<cudaStream_t>(stream))));
  return 0;
}

// The same probe, quant=True: y [M, N] int32 = q(x) . w, x [M, K] bf16
// rounded half to even and clipped to +-127 into the int8 scratch xq [M,
// pad32(K)], w [K, N] int8 transposed into the int8 scratch wt [N, pad32(K)]
// (8-bit wgmma takes K-major operands), then s8 x s8 -> s32 (the int8 GEMM
// above with a raw int32 epilogue). K a multiple of 8, N even.
extern "C" int probe_gemm_s8(const void* x, const void* w, void* wt, void* xq, void* y, int M,
                             int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 2) return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, wt, xq, y})) return int(cudaErrorMisalignedAddress);
  const int Kp = pad32(K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  UFV_TRY(transpose_s8(s8(w), s8(wt), K, N, Kp, st));
  UFV_TRY(round_clip_s8(b16(x), s8(xq), M, K, Kp, st));
  UFV_TRY((gemm_s8<Q_S32>(s8(xq), s8(wt), nullptr, nullptr, nullptr, nullptr, y, M, N, Kp, st)));
  return 0;
}

// The int8 GEMM alone, raw int32 epilogue: y [M, N] = qa [M, Kp] . bt [N,
// Kp]^T, Kp a multiple of 16, N even; the probe's product without its two
// preparation passes, for timing it (scripts/torch_s8_sweep.py).
extern "C" int gemm_s8_s32(const void* qa, const void* bt, void* y, int M, int Kp, int N,
                           void* stream) {
  if (M <= 0 || Kp <= 0 || N <= 0 || Kp % 16 || N % 2) return int(cudaErrorInvalidValue);
  if (!all_aligned16({qa, bt, y})) return int(cudaErrorMisalignedAddress);
  UFV_TRY((gemm_s8<Q_S32>(s8(qa), s8(bt), nullptr, nullptr, nullptr, nullptr, y, M, N, Kp,
                          static_cast<cudaStream_t>(stream))));
  return 0;
}

// The block GEMM alone: y [M, N] = act(a [M, K] . w [K, N] + bias) in bf16
// (epi 0; act 0 none, 1-6 the GELUs), bf16(bf16(a . w + bias) + r) (epi 1),
// or the f32 sum + bias (epi 2); bias may be null. K and N multiples of 8.
// On the route block_gemm_plan gives the shape (route < 0), or on `route`
// (0 the ping-pong kernel, 128 the 128 x 128 tile, 256 the 128 x 256 tile
// for epi 2 only). For testing and timing each route apart from the blocks that run
// it.
extern "C" int block_gemm_bf16(const void* a, const void* w, const void* bias, const void* r,
                               void* y, int M, int N, int K, int act, int epi, int route,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || epi < 0 || epi > 2 ||
      (act != ACT_NONE && (epi != 0 || !act_ok(act))) || (epi == 1 && !r))
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({a, w, y}) || (r && !aligned16(r))) return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *A = b16(a), *W = b16(w);
  if (epi == 1) UFV_TRY((gemm<ACT_NONE, true>(A, W, f32(bias), b16(r), y, M, N, K, st, route)));
  else if (epi == 2)
    UFV_TRY((gemm<ACT_NONE, false, true>(A, W, f32(bias), nullptr, y, M, N, K, st, route)));
  else if (act == ACT_NONE)
    UFV_TRY((gemm<ACT_NONE, false>(A, W, f32(bias), nullptr, y, M, N, K, st, route)));
  else
    UFV_TRY(gemm_act(act, A, W, f32(bias), b16(y), M, N, K, st, route));
  return 0;
}

#ifdef UFV_STAMPS
// The stamps' buffer (device memory, sized by the caller for the launch)
extern "C" int ufv_stamps_set(long long* buf) {
  return int(cudaMemcpyToSymbol(ufv_stamps, &buf, sizeof(buf)));
}
#endif

// block_gemm_plan at M x K into N (f32: the f32 sum) on a card of `sms` SMs
// (sms <= 0: the current device's), as out[5] = (route, stages, smem, grid,
// tiles): what the Python ops/hiera_block.block_gemm_plan must give
// (tests/test_torch_cuda.py).
extern "C" int block_gemm_plan_query(int M, int N, int K, int f32, int sms, int* out) {
  GemmPlan p;
  if (!out) return int(cudaErrorInvalidValue);
  UFV_TRY(gemm_plan_on(M, N, K, f32 != 0, sms, -1, &p));
  const int v[5] = {p.route, p.stages, p.smem, p.grid, p.tiles};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// out [rows, D] = bf16(bf16(LN(x [rows, C])) . w [C, D] + b) in one launch of
// the LayerNorm-band GEMM, for C <= 576; (bm, bn, stages, cluster) the plan
// ops/hiera_block.ln_gemm_plan gave, refused unless it is this file's.
extern "C" int ln_matmul_bf16(const void* x, const void* ln_s, const void* ln_b,
                              const void* w, const void* b, void* out, int rows, int C, int D,
                              int bm, int bn, int stages, int cluster, float eps,
                              void* stream) {
  LnPlan p;
  if (rows <= 0 || D % 8 || !ln_gemm_plan(C, &p) || !plan_is(C, bm, bn, stages, cluster))
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, w, out})) return int(cudaErrorMisalignedAddress);
  UFV_TRY(ln_gemm(ACT_NONE, b16(x), f32(ln_s), f32(ln_b), b16(w), f32(b), b16(out), rows, D, C,
                  eps, p, static_cast<cudaStream_t>(stream)));
  return 0;
}

// The same for the widths the plan gives no band to (C > 576): a LayerNorm
// pass into the scratch xn [rows, C], then the GEMM.
extern "C" int ln_matmul_pair_bf16(const void* x, const void* ln_s, const void* ln_b,
                                   const void* w, const void* b, void* xn, void* out, int rows,
                                   int C, int D, float eps, void* stream) {
  if (rows <= 0 || C % 8 || D % 8 || !plan_is(C, 0, 0, 0, 0))
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, w, xn, out})) return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  UFV_TRY(layernorm(b16(x), f32(ln_s), f32(ln_b), b16(xn), rows, C, eps, st));
  UFV_TRY((gemm<ACT_NONE, false>(b16(xn), b16(w), f32(b), nullptr, b16(out), rows, D, C, st)));
  return 0;
}

// shortcut, out [rows, C]; att [rows, A]; wproj [A, C], w1 [C, mlp], w2
// [mlp, C]. Scratch x1 [rows, C], hmid [rows, mlp], and xn [rows, C] where
// the plan (bm, bn, stages, cluster) is the pair's (all 0); xn may be null
// otherwise.
extern "C" int block_tail_bf16(
    const void* shortcut, const void* att, void* out, const void* wproj, const void* bproj,
    const void* ln2_s, const void* ln2_b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* x1, void* xn, void* hmid, int rows, int C, int A, int mlp, int act,
    int bm, int bn, int stages, int cluster, float eps, void* stream) {
  if (rows <= 0 || C % 8 || A % 8 || mlp % 8 || !act_ok(act) ||
      !plan_is(C, bm, bn, stages, cluster) || (bn == 0 && !xn))
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({shortcut, att, out, wproj, w1, w2, x1, hmid}) ||
      (xn && !aligned16(xn)))
    return int(cudaErrorMisalignedAddress);
  UFV_TRY(block_tail(b16(att), b16(shortcut), b16(wproj), f32(bproj), f32(ln2_s),
                     f32(ln2_b), b16(w1), f32(b1), b16(w2), f32(b2), b16(x1), b16(xn),
                     b16(hmid), b16(out), rows, C, A, mlp, act, eps,
                     static_cast<cudaStream_t>(stream)));
  return 0;
}

// x [N, ws*ws, Cin] -> out [N, Sq, Cout], Sq = (ws/sy) * (ws/sx). wfront
// [Cin, 3*H*hd + Cout] = [q heads | k heads | v heads | shortcut proj],
// wproj [H*hd, Cout], w1 [Cout, mlp], w2 [mlp, Cout]. Scratch (bf16): xn
// [N*S, Cin], front [N*S, 3*H*hd + Cout], qp [N*Sq, H*hd], sc [N*Sq, Cout],
// att [N*Sq, H*hd], x1, xm [N*Sq, Cout], hmid [N*Sq, mlp].
extern "C" int qpool_block_bf16(
    const void* x, void* out, const void* ln1_s, const void* ln1_b, const void* wfront,
    const void* bfront, const void* wproj, const void* bproj, const void* ln2_s,
    const void* ln2_b, const void* w1, const void* b1, const void* w2, const void* b2,
    void* xn, void* front, void* qp, void* sc, void* att, void* x1, void* xm, void* hmid,
    int N, int ws, int sy, int sx, int Cin, int Cout, int heads, int head_dim, int mlp,
    int act, float eps, void* stream) {
  if (N <= 0 || ws <= 0 || sy <= 0 || sx <= 0 || ws % sy || ws % sx || Cin % 8 || Cout % 8 ||
      head_dim % 8 || mlp % 8 || head_dim > 128 || !act_ok(act))
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, out, wfront, wproj, w1, w2, xn, front, qp, sc, att, x1, xm, hmid}))
    return int(cudaErrorMisalignedAddress);
  const int S = ws * ws, Sq = (ws / sy) * (ws / sx);
  const int rows = N * S, qrows = N * Sq;
  const int hw = heads * head_dim;
  const int F = 3 * hw + Cout;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* FR = b16(front);

  UFV_TRY(layernorm(b16(x), f32(ln1_s), f32(ln1_b), b16(xn), rows, Cin, eps, st));
  UFV_TRY((gemm<ACT_NONE, false>(b16(xn), b16(wfront), f32(bfront), nullptr, FR, rows, F,
                                 Cin, st)));
  UFV_TRY(pool(FR, b16(qp), qrows, ws, sy, sx, F, 0, hw, st));
  UFV_TRY(pool(FR, b16(sc), qrows, ws, sy, sx, F, 3 * hw, Cout, st));
  UFV_TRY(window_attention(b16(qp), hw, FR + hw, FR + 2 * hw, F, b16(att), N, Sq, S, heads,
                           head_dim, st));
  UFV_TRY(block_tail(b16(att), b16(sc), b16(wproj), f32(bproj), f32(ln2_s), f32(ln2_b),
                     b16(w1), f32(b1), b16(w2), f32(b2), b16(x1), b16(xm), b16(hmid),
                     b16(out), qrows, Cout, hw, mlp, act, eps, st));
  return 0;
}

// x, out [N, S, C] bf16; int8 weights in [in, out] layout with f32 column
// scales: wqkv [C, 3*H*hd] (q heads | k heads | v heads), wproj [H*hd, C], w1
// [C, mlp], w2 [mlp, C]; LayerNorm vectors and biases f32. Kc / Ka / Km are
// C / H*hd / mlp rounded up to 32. Scratch: the transposed weights wqkv_t
// [3*H*hd, Kc], wproj_t [C, Ka], w1_t [mlp, Kc], w2_t [C, Km] (int8); qa
// [N*S, max(Kc, Ka)], qh [N*S, Km] (int8); xs [N*S] (f32); qkv [N*S,
// 3*H*hd], att [N*S, H*hd], x1 [N*S, C] (bf16); hmid [N*S, mlp] (f32).
// act: 1 = gelu_tanh, 2 = gelu_exact. Returns the first CUDA error or 0.
extern "C" int block_w8a8_bf16(
    const void* x, void* out, const void* ln1_s, const void* ln1_b, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* ln2_s, const void* ln2_b, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, void* wqkv_t,
    void* wproj_t, void* w1_t, void* w2_t, void* qa, void* qh, void* xs, void* qkv, void* att,
    void* x1, void* hmid, int N, int S, int C, int heads, int head_dim, int mlp, int act,
    float eps, void* stream) {
  const int rows = N * S;
  const int hw = heads * head_dim;
  if (rows <= 0 || C % 8 || head_dim % 8 || mlp % 2 || head_dim > 128 || !act_ok(act))
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, out, wqkv_t, wproj_t, w1_t, w2_t, qa, qh, qkv, att, x1, hmid}))
    return int(cudaErrorMisalignedAddress);
  const int Kc = pad32(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* QKV = b16(qkv);
  float* XS = static_cast<float*>(xs);

  UFV_TRY(transpose_s8(s8(wqkv), s8(wqkv_t), C, 3 * hw, Kc, st));
  UFV_TRY((rowquant<bf16, true>(b16(x), f32(ln1_s), f32(ln1_b), s8(qa), XS, rows, C, Kc, eps,
                                st)));
  UFV_TRY((gemm_s8<Q_BF16>(s8(qa), s8(wqkv_t), XS, f32(sqkv), f32(bqkv), nullptr, QKV, rows,
                           3 * hw, Kc, st)));
  UFV_TRY(window_attention(QKV, 3LL * hw, QKV + hw, QKV + 2 * hw, 3LL * hw, b16(att), N, S,
                           S, heads, head_dim, st));
  UFV_TRY(tail_w8a8(b16(att), b16(x), s8(wproj), f32(sproj), f32(bproj), f32(ln2_s),
                    f32(ln2_b), s8(w1), f32(s1), f32(b1), s8(w2), f32(s2), f32(b2),
                    s8(wproj_t), s8(w1_t), s8(w2_t), s8(qa), s8(qh), XS, b16(x1),
                    static_cast<float*>(hmid), b16(out), rows, C, hw, mlp, act, eps, st));
  return 0;
}

// out [rows, D] = bf16(float(q(LN(x)) . w) * xs[row] * ws[col] + b): the W8A8
// front of a global block. x [rows, C] bf16, w [C, D] int8 with f32 column
// scales ws. Scratch: w_t [D, pad32(C)], qa [rows, pad32(C)] (int8), xs
// [rows] (f32).
extern "C" int ln_matmul_w8a8_bf16(const void* x, const void* ln_s, const void* ln_b,
                                   const void* w, const void* ws, const void* b, void* w_t,
                                   void* qa, void* xs, void* out, int rows, int C, int D,
                                   float eps, void* stream) {
  if (rows <= 0 || C <= 0 || D % 2) return int(cudaErrorInvalidValue);
  if (!all_aligned16({w_t, qa, out})) return int(cudaErrorMisalignedAddress);
  const int Kc = pad32(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* XS = static_cast<float*>(xs);
  UFV_TRY(transpose_s8(s8(w), s8(w_t), C, D, Kc, st));
  UFV_TRY((rowquant<bf16, true>(b16(x), f32(ln_s), f32(ln_b), s8(qa), XS, rows, C, Kc, eps,
                                st)));
  UFV_TRY((gemm_s8<Q_BF16>(s8(qa), s8(w_t), XS, f32(ws), f32(b), nullptr, out, rows, D, Kc,
                           st)));
  return 0;
}

// shortcut, out [rows, C]; att [rows, A] bf16; int8 wproj [A, C], w1 [C, mlp],
// w2 [mlp, C] with f32 column scales. Scratch as tail_w8a8 lists it.
extern "C" int block_tail_w8a8_bf16(
    const void* shortcut, const void* att, void* out, const void* wproj, const void* sproj,
    const void* bproj, const void* ln2_s, const void* ln2_b, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, void* wproj_t, void* w1_t,
    void* w2_t, void* qa, void* qh, void* xs, void* x1, void* hmid, int rows, int C, int A,
    int mlp, int act, float eps, void* stream) {
  if (rows <= 0 || C % 2 || A <= 0 || mlp % 2 || !act_ok(act))
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({shortcut, out, wproj_t, w1_t, w2_t, qa, qh, x1, hmid}))
    return int(cudaErrorMisalignedAddress);
  UFV_TRY(tail_w8a8(b16(att), b16(shortcut), s8(wproj), f32(sproj), f32(bproj), f32(ln2_s),
                    f32(ln2_b), s8(w1), f32(s1), f32(b1), s8(w2), f32(s2), f32(b2),
                    s8(wproj_t), s8(w1_t), s8(w2_t), s8(qa), s8(qh), static_cast<float*>(xs),
                    b16(x1), static_cast<float*>(hmid), b16(out), rows, C, A, mlp, act, eps,
                    static_cast<cudaStream_t>(stream)));
  return 0;
}

// The W8A8 stage-transition block. x [N, ws*ws, Cin] -> out [N, Sq, Cout], Sq
// = (ws/sy) * (ws/sx). int8 wfront [Cin, 3*H*hd + Cout] = [q heads | k heads |
// v heads | shortcut proj], wproj [H*hd, Cout], w1 [Cout, mlp], w2 [mlp,
// Cout], each with f32 column scales. LN1 (f32) -> rows to int8 -> s8 x s8
// front, rescaled to bf16 -> max-pool of q and of the shortcut columns from
// that bf16 front -> bf16 attention of the Sq pooled queries on the window's
// S unpooled keys -> the W8A8 tail on the N*Sq pooled rows. Scratch: wf_t
// [3*H*hd + Cout, pad32(Cin)] and the tail's transposed weights; qa [N*S,
// pad32(Cin)] or [N*Sq, max(pad32(Cout), pad32(H*hd))], whichever is larger;
// qh [N*Sq, pad32(mlp)] (int8); xs [N*S] (f32); front [N*S, 3*H*hd + Cout],
// qp, att [N*Sq, H*hd], sc, x1 [N*Sq, Cout] (bf16); hmid [N*Sq, mlp] (f32).
extern "C" int qpool_block_w8a8_bf16(
    const void* x, void* out, const void* ln1_s, const void* ln1_b, const void* wfront,
    const void* sfront, const void* bfront, const void* wproj, const void* sproj,
    const void* bproj, const void* ln2_s, const void* ln2_b, const void* w1, const void* s1,
    const void* b1, const void* w2, const void* s2, const void* b2, void* wf_t, void* wproj_t,
    void* w1_t, void* w2_t, void* qa, void* qh, void* xs, void* front, void* qp, void* sc,
    void* att, void* x1, void* hmid, int N, int ws, int sy, int sx, int Cin, int Cout,
    int heads, int head_dim, int mlp, int act, float eps, void* stream) {
  if (N <= 0 || ws <= 0 || sy <= 0 || sx <= 0 || ws % sy || ws % sx || Cin <= 0 || Cout % 8 ||
      head_dim % 8 || mlp % 2 || head_dim > 128 || !act_ok(act))
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({out, wf_t, wproj_t, w1_t, w2_t, qa, qh, front, qp, sc, att, x1, hmid}))
    return int(cudaErrorMisalignedAddress);
  const int S = ws * ws, Sq = (ws / sy) * (ws / sx);
  const int rows = N * S, qrows = N * Sq;
  const int hw = heads * head_dim;
  const int F = 3 * hw + Cout;
  const int Kin = pad32(Cin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* FR = b16(front);
  float* XS = static_cast<float*>(xs);

  UFV_TRY(transpose_s8(s8(wfront), s8(wf_t), Cin, F, Kin, st));
  UFV_TRY((rowquant<bf16, true>(b16(x), f32(ln1_s), f32(ln1_b), s8(qa), XS, rows, Cin, Kin,
                                eps, st)));
  UFV_TRY((gemm_s8<Q_BF16>(s8(qa), s8(wf_t), XS, f32(sfront), f32(bfront), nullptr, FR, rows, F,
                           Kin, st)));
  UFV_TRY(pool(FR, b16(qp), qrows, ws, sy, sx, F, 0, hw, st));
  UFV_TRY(pool(FR, b16(sc), qrows, ws, sy, sx, F, 3 * hw, Cout, st));
  UFV_TRY(window_attention(b16(qp), hw, FR + hw, FR + 2 * hw, F, b16(att), N, Sq, S, heads,
                           head_dim, st));
  UFV_TRY(tail_w8a8(b16(att), b16(sc), s8(wproj), f32(sproj), f32(bproj), f32(ln2_s),
                    f32(ln2_b), s8(w1), f32(s1), f32(b1), s8(w2), f32(s2), f32(b2),
                    s8(wproj_t), s8(w1_t), s8(w2_t), s8(qa), s8(qh), XS, b16(x1),
                    static_cast<float*>(hmid), b16(out), qrows, Cout, hw, mlp, act, eps, st));
  return 0;
}
