// The pre-LN transformer blocks of SigLIP and Hiera as short sequences of
// hand-written launches, with a plain C interface for ctypes. Eleven entry
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
//                     matmul + bias, the front of a global block;
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
//                     two GEMMs below.
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
// attention with Sq = S/4 queries against S keys per window. Not yet used:
// fusing LN into the GEMM prologue; consumer warpgroups on different tiles
// (ping-pong), so that one's epilogue overlaps the other's products.
#include "attention_tile.cuh"
#include "hopper.cuh"

#include <initializer_list>

namespace {

using ufv::bf16;

// the int8 GEMM's tile (a 3-stage cp.async ring, 8 warps of mma.sync)
constexpr int kBM = 128, kBN = 128, kStages = 3, kGemmThreads = 256;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // 16-byte global -> shared copy; zero-filled when !valid (src is not read)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(ufv::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ bf16 GEMM --
// Y[M, N] = epilogue(A[M, K] . W[K, N] + bias[N]); all row-major, K and N
// multiples of 8, A and W 16-byte aligned. Epilogue: an optional activation;
// with a residual R, Y = bf16(bf16(acc + bias) + R); with F32OUT the f32 sum
// (bias may be null).
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
// consumer warpgroups and one producer warp (288 threads), one output tile.
// (A persistent grid whose ring runs on across tiles measured 5-28% slower
// on an H100; PERF.md.) Two tile shapes, chosen by the product's shape
// (gemm below):
// - BN = 256, one block an SM (224 registers a thread for the 128
//   accumulators, a 4-stage ring of 48 KB stages): for K >= 1024 and N >=
//   2048 (SigLIP's qkv and fc1, the probe), where the mainloop dominates and
//   the wider tile halves the shared-memory reads a product needs, and a
//   ragged last column tile wastes little;
// - BN = 128, two blocks an SM (112 registers, 3 stages of 32 KB), so one
//   block's epilogue overlaps the other's products: Hiera's short K (144 is
//   three steps).
// TMA zero-fills what lies past M, N or K; the epilogue masks its stores.
// Every output element is summed by one thread in a fixed order:
// deterministic.
constexpr int kGBM = 128, kGBK = 64, kGThreads = 288;

template <int BN>
struct GemmCfg {
  static constexpr int STAGES = BN == 256 ? 4 : 3;
  static constexpr int PER_SM = BN == 256 ? 1 : 2;
  static constexpr int TILE_A = kGBM * kGBK * 2;  // bytes: 128 rows x 128 B
  static constexpr int TILE_B = kGBK * BN * 2;    // bytes: BN / 64 boxes of 64 x 64
  static constexpr int STAGE = TILE_A + TILE_B;
  static constexpr size_t SMEM = size_t(STAGES) * STAGE + 2 * STAGES * sizeof(uint64_t) + 1024;
};

template <int BN>
__device__ __forceinline__ void wgmma_gemm(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    ufv::hop::wgmma_ss_n256<1>(acc, da, db, 1);
  else
    ufv::hop::wgmma_ss_n128<1>(acc, da, db, 1);
}

template <int BN, int ACT, bool RES, bool F32OUT>
__global__ void __launch_bounds__(kGThreads, GemmCfg<BN>::PER_SM) gemm_kernel(
    __grid_constant__ const CUtensorMap mapA, __grid_constant__ const CUtensorMap mapW,
    const float* __restrict__ bias, const bf16* __restrict__ R, void* __restrict__ Yv, int M,
    int N, int K) {
  namespace h = ufv::hop;
  using C = GemmCfg<BN>;
  constexpr int ST = C::STAGES;
  extern __shared__ __align__(1024) unsigned char gsmem_raw[];
  unsigned char* smem = gsmem_raw + ((1024 - (h::smem_u32(gsmem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * C::STAGE);
  uint64_t* empty = full + ST;
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
        for (int nb = 0; nb < BN / 64; ++nb)
          h::tma_load_2d(stage + C::TILE_A + nb * 8192, &mapW, &full[st], n0 + 64 * nb,
                         kt * kGBK);
      }
    }
    return;
  }
  // consumer warpgroups 0 and 1: rows 64 cw .. +63 of the tile
  const int cw = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  {
    float acc[BN / 2];
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
                       h::make_desc(b + kk * 16 * 128, 8192, 1024, 1));
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
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * tig;
      if (col >= N) continue;  // N % 8 == 0: col + 1 < N too
      const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= M) continue;
        float v0 = act_apply<ACT>(acc[4 * j + 2 * half] + b0);
        float v1 = act_apply<ACT>(acc[4 * j + 2 * half + 1] + b1);
        const long long off = (long long)row * N + col;
        if (F32OUT) {
          *reinterpret_cast<float2*>(static_cast<float*>(Yv) + off) = make_float2(v0, v1);
          continue;
        }
        if (RES) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(R + off));
          v0 = __bfloat162float(__float2bfloat16(v0)) + r.x;
          v1 = __bfloat162float(__float2bfloat16(v1)) + r.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(Yv) + off) =
            __floats2bfloat162_rn(v0, v1);
      }
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

template <int ACT, bool RES, bool F32OUT = false>
cudaError_t gemm(const bf16* A, const bf16* W, const float* bias, const bf16* R, void* Y,
                 int M, int N, int K, cudaStream_t st) {
  // A [M, K]: boxes of 64 K x 128 rows; W [K, N]: boxes of 64 N x 64 K rows
  CUtensorMap mapA, mapW;
  const cuuint64_t dimsA[2] = {cuuint64_t(K), cuuint64_t(M)}, strideA[1] = {cuuint64_t(K) * 2};
  const cuuint64_t dimsW[2] = {cuuint64_t(N), cuuint64_t(K)}, strideW[1] = {cuuint64_t(N) * 2};
  const cuuint32_t boxA[2] = {kGBK, kGBM}, boxW[2] = {64, kGBK};
  cudaError_t err = ufv::hop::make_map(&mapA, A, 2, dimsA, strideA, boxA);
  if (err == cudaSuccess) err = ufv::hop::make_map(&mapW, W, 2, dimsW, strideW, boxW);
  if (err != cudaSuccess) return err;
  if (K >= 1024 && N >= 2048)
    return gemm_launch<256, ACT, RES, F32OUT>(mapA, mapW, bias, R, Y, M, N, K, st);
  return gemm_launch<128, ACT, RES, F32OUT>(mapA, mapW, bias, R, Y, M, N, K, st);
}

// Y = act(A . W + bias) for an activation chosen at run time
cudaError_t gemm_act(int act, const bf16* A, const bf16* W, const float* bias, bf16* Y, int M,
                     int N, int K, cudaStream_t st) {
  switch (act) {
    case ACT_GELU_TANH: return gemm<ACT_GELU_TANH, false>(A, W, bias, nullptr, Y, M, N, K, st);
    case ACT_GELU_EXACT: return gemm<ACT_GELU_EXACT, false>(A, W, bias, nullptr, Y, M, N, K, st);
    case ACT_GELU_POLY: return gemm<ACT_GELU_POLY, false>(A, W, bias, nullptr, Y, M, N, K, st);
    case ACT_GELU_POLY_BF16:
      return gemm<ACT_GELU_POLY_BF16, false>(A, W, bias, nullptr, Y, M, N, K, st);
    case ACT_GELU_TANH_POLY:
      return gemm<ACT_GELU_TANH_POLY, false>(A, W, bias, nullptr, Y, M, N, K, st);
    case ACT_GELU_TANH_POLY_BF16:
      return gemm<ACT_GELU_TANH_POLY_BF16, false>(A, W, bias, nullptr, Y, M, N, K, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t layernorm(const bf16* x, const float* g, const float* b, bf16* y, int rows,
                      int C, float eps, cudaStream_t st) {
  layernorm_kernel<<<(rows + 7) / 8, 256, 0, st>>>(x, g, b, y, rows, C, eps);
  return cudaGetLastError();
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
// xn = LN2(x1); hmid = GELU(xn . w1 + b1); out = x1 + bf16(hmid . w2 + b2).
// A [rows, a_dim], R / x1 / xn / out [rows, C], hmid [rows, mlp].
cudaError_t block_tail(const bf16* A, const bf16* R, const bf16* wproj, const float* bproj,
                       const float* ln2_s, const float* ln2_b, const bf16* w1,
                       const float* b1, const bf16* w2, const float* b2, bf16* x1, bf16* xn,
                       bf16* hmid, bf16* out, int rows, int C, int a_dim, int mlp, int act,
                       float eps, cudaStream_t st) {
  cudaError_t e;
  if ((e = gemm<ACT_NONE, true>(A, wproj, bproj, R, x1, rows, C, a_dim, st))) return e;
  if ((e = layernorm(x1, ln2_s, ln2_b, xn, rows, C, eps, st))) return e;
  if ((e = gemm_act(act, xn, w1, b1, hmid, rows, mlp, C, st))) return e;
  return gemm<ACT_NONE, true>(hmid, w2, b2, x1, out, rows, C, mlp, st);
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
// sums are exact, so the products are one tiled int8 GEMM (128x128 tile, 64
// bytes of K a step through the 3-stage cp.async ring, 8 warps of 64x32 from
// mma.sync m16n8k32 s8 -> s32) whose epilogue applies the two scales, the
// bias, and the GELU or the residual. Both operands are K-contiguous: the
// weights are transposed to [out, in] (K zero-padded to a multiple of 32:
// 4304 -> 4320) by a small pass at each call, 13 MB a block against its
// milliseconds. A row's amax spans every column tile, so quantising is a
// pass of its own (one warp a row) and not a GEMM epilogue; after fc1 it
// reads the f32 GELU output, as the reference does. The attention output
// is quantised from its bf16 form, as the TPU kernel's scratch is.

constexpr int kQBK = 64;            // bytes of K per tile
constexpr int kQLD = kQBK + 16;     // row stride of an int8 tile: fragment loads hit 32 banks
constexpr int kQStageA = kBM * kQLD, kQStageB = kBN * kQLD;
constexpr size_t kQSmem = size_t(kStages) * (kQStageA + kQStageB);

enum QEpi { Q_BF16 = 0, Q_RES = 1, Q_ACT_F32 = 2, Q_S32 = 3 };

// d[16x8] += a[16x32] . b[32x8], int8 operands, int32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Y[M, N] = epilogue(float(A[M, Kp] . Bt[N, Kp]^T) * xs[m] * ws[n] + bias[n]);
// A and Bt int8, rows of Kp bytes (Kp % 16 == 0, zero beyond the true K), N
// even. Epilogues: bf16; bf16(bf16(v) + R); act(v) as f32; the raw int32
// sums (xs, ws and bias unused). With AQ, A is bf16 [M, lda] (lda % 8 == 0,
// lda <= Kp) and the prologue rounds each value half to even and clips it to
// +-127 on its way into shared memory (columns past lda are zero).
template <int EPI, int ACT, bool AQ>
__global__ void __launch_bounds__(kGemmThreads) gemm_s8_kernel(
    const void* __restrict__ Av, const int8_t* __restrict__ Bt,
    const float* __restrict__ xs, const float* __restrict__ ws,
    const float* __restrict__ bias, const bf16* __restrict__ R, void* __restrict__ Yv, int M,
    int N, int Kp, int lda) {
  const int8_t* A = static_cast<const int8_t*>(Av);
  extern __shared__ __align__(128) unsigned char gsmem[];
  int8_t* As = reinterpret_cast<int8_t*>(gsmem);
  int8_t* Bs = As + kStages * kQStageA;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = warp >> 2, wn = warp & 3;
  const int nk = (Kp + kQBK - 1) / kQBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kQBK;
    int8_t* as = As + stage * kQStageA;
    int8_t* bs = Bs + stage * kQStageB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kGemmThreads;
      const int r = idx >> 2, c = (idx & 3) * 16;
      const bool kv = k0 + c < Kp;
      if constexpr (AQ) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        const bf16* Ab = static_cast<const bf16*>(Av);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = k0 + c + 8 * h;
          if (m0 + r >= M || kk >= lda) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(Ab + (long long)(m0 + r) * lda + kk);
          const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int q = __float2int_rn(fminf(fmaxf(__bfloat162float(e[j]), -127.f), 127.f));
            w[2 * h + j / 4] |= (uint32_t(q) & 0xffu) << (8 * (j % 4));
          }
        }
        *reinterpret_cast<uint4*>(as + r * kQLD + c) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        const bool va = kv && m0 + r < M;
        cp_async16(as + r * kQLD + c, va ? A + (long long)(m0 + r) * Kp + k0 + c : A, va);
      }
      const bool vb = kv && n0 + r < N;
      cp_async16(bs + r * kQLD + c, vb ? Bt + (long long)(n0 + r) * Kp + k0 + c : Bt, vb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = kt + kStages - 1;
    if (nt < nk) load_stage(nt % kStages, nt);
    cp_async_commit();
    const int8_t* as = As + (kt % kStages) * kQStageA;
    const int8_t* bs = Bs + (kt % kStages) * kQStageB;
#pragma unroll
    for (int kk = 0; kk < kQBK; kk += 32) {
      // fragment word (row, k): lane (g, tig) holds k = 4 tig .. 4 tig + 3 of
      // row g (and g + 8), and the same 16 bytes further on
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = as + (wm * 64 + i * 16 + g) * kQLD + kk + tig * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kQLD);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kQLD + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = bs + (wn * 32 + j * 8 + g) * kQLD + kk + tig * 4;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + i * 16 + g + 8 * half;
      if (row >= M) continue;
      const float xr = EPI == Q_S32 ? 0.f : xs[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * tig;
        if (col >= N) continue;  // N even: col + 1 < N too
        const long long off = (long long)row * N + col;
        if (EPI == Q_S32) {
          *reinterpret_cast<int2*>(static_cast<int*>(Yv) + off) =
              make_int2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
          continue;
        }
        float v0 = float(acc[i][j][2 * half]) * xr * ws[col] + bias[col];
        float v1 = float(acc[i][j][2 * half + 1]) * xr * ws[col + 1] + bias[col + 1];
        if (EPI == Q_ACT_F32) {
          v0 = act_apply<ACT>(v0);
          v1 = act_apply<ACT>(v1);
          *reinterpret_cast<float2*>(static_cast<float*>(Yv) + off) = make_float2(v0, v1);
        } else {
          if (EPI == Q_RES) {
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(R + off));
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

template <int EPI, int ACT = ACT_NONE, bool AQ = false>
cudaError_t gemm_s8(const void* A, const int8_t* Bt, const float* xs, const float* ws,
                    const float* bias, const bf16* R, void* Y, int M, int N, int Kp,
                    cudaStream_t st, int lda = 0) {
  cudaError_t err = cudaFuncSetAttribute(gemm_s8_kernel<EPI, ACT, AQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(kQSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_s8_kernel<EPI, ACT, AQ><<<grid, kGemmThreads, kQSmem, st>>>(
      A, Bt, xs, ws, bias, R, Y, M, N, Kp, lda ? lda : Kp);
  return cudaGetLastError();
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
// rounded half to even and clipped to +-127 in the GEMM's prologue, w [K, N]
// int8, s8 x s8 -> s32 (the int8 GEMM above with that prologue and a raw
// int32 epilogue). The weights are first transposed into wt [N, pad32(K)]
// (int8 scratch), as the mma.sync s8 operands want K innermost. K a multiple
// of 8, N even.
extern "C" int probe_gemm_s8(const void* x, const void* w, void* wt, void* y, int M, int K,
                             int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 2) return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, wt, y})) return int(cudaErrorMisalignedAddress);
  const int Kp = pad32(K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  UFV_TRY(transpose_s8(s8(w), s8(wt), K, N, Kp, st));
  UFV_TRY((gemm_s8<Q_S32, ACT_NONE, true>(x, s8(wt), nullptr, nullptr, nullptr, nullptr, y, M,
                                          N, Kp, st, K)));
  return 0;
}

// out [rows, D] = bf16(LN(x [rows, C]) . w [C, D] + b). Scratch xn [rows, C].
extern "C" int ln_matmul_bf16(const void* x, const void* ln_s, const void* ln_b,
                              const void* w, const void* b, void* xn, void* out, int rows,
                              int C, int D, float eps, void* stream) {
  if (rows <= 0 || C % 8 || D % 8) return int(cudaErrorInvalidValue);
  if (!all_aligned16({x, w, xn, out})) return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  UFV_TRY(layernorm(b16(x), f32(ln_s), f32(ln_b), b16(xn), rows, C, eps, st));
  UFV_TRY((gemm<ACT_NONE, false>(b16(xn), b16(w), f32(b), nullptr, b16(out), rows, D, C, st)));
  return 0;
}

// shortcut, out [rows, C]; att [rows, A]; wproj [A, C], w1 [C, mlp], w2
// [mlp, C]. Scratch x1, xn [rows, C], hmid [rows, mlp].
extern "C" int block_tail_bf16(
    const void* shortcut, const void* att, void* out, const void* wproj, const void* bproj,
    const void* ln2_s, const void* ln2_b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* x1, void* xn, void* hmid, int rows, int C, int A, int mlp, int act,
    float eps, void* stream) {
  if (rows <= 0 || C % 8 || A % 8 || mlp % 8 || !act_ok(act))
    return int(cudaErrorInvalidValue);
  if (!all_aligned16({shortcut, att, out, wproj, w1, w2, x1, xn, hmid}))
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
