// One whole pre-LN transformer block (SigLIP encoder layer; Hiera windowed
// block) as a short sequence of hand-written launches, with a plain C
// interface for ctypes.
//
// Replaces ufvideo_tpu/ops/hiera_block.py fused_hiera_block (_forward /
// _kernel / _block_body): LN1 (f32) -> qkv -> multi-head attention inside
// each window -> proj + residual -> LN2 (f32) -> fc1 -> GELU -> fc2 +
// residual, with the math of hiera_block._reference: f32 statistics, bf16
// operands with f32 accumulation, f32 softmax, probabilities cast to bf16
// before P.V, each product rounded to bf16 before its residual add.
//
// Bound on an H100: at the SigLIP shape (32 frames x 729 tokens, C 1152,
// MLP 4304) one block is ~711 GFLOP of matrix products plus ~78 GFLOP of
// attention against ~0.5 GB of activations and weights, so it is bound by
// operations (~0.8 ms at 989 TFLOP/s). Design: the four products run in
// one tiled bf16 GEMM (128x128x32 block tile, 8 warps of 64x32 built from
// mma.sync m16n8k16 with ldmatrix operand loads, K tiles streamed through
// a 3-stage cp.async ring) whose epilogue fuses the bias, the GELU and the
// residual add from registers, so each intermediate makes one trip through
// memory; the attention shares
// attention_tile.cuh with the flash kernel (head dim 72 zero-padded to 80
// in shared memory, one window per batch entry). Not yet used: wgmma, TMA,
// fusing LN into the GEMM prologue.
#include "attention_tile.cuh"

namespace {

using ufv::bf16;

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kGemmThreads = 256;
constexpr int kLDA = kBK + 8;  // bf16 row stride of an A tile (80 B: ldmatrix conflict-free)
constexpr int kLDB = kBN + 8;  // bf16 row stride of a B tile (272 B)
constexpr int kStageA = kBM * kLDA, kStageB = kBK * kLDB;  // elements per stage
constexpr size_t kGemmSmem = size_t(kStages) * (kStageA + kStageB) * sizeof(bf16);

enum Act { ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_EXACT = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// y[r] = (x[r] - mean) * rsqrt(var + eps) * gamma + beta, f32 statistics,
// one warp per row.
__global__ void __launch_bounds__(256) layernorm_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, bf16* __restrict__ y, int rows, int C, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (long long)row * C;
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += __bfloat162float(xr[c]);
  const float mean = ufv::warp_sum(sum) / C;
  float var = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = __bfloat162float(xr[c]) - mean;
    var += d * d;
  }
  var = ufv::warp_sum(var) / C;
  const float rstd = rsqrtf(var + eps);
  bf16* yr = y + (long long)row * C;
  for (int c = lane; c < C; c += 32)
    yr[c] = __float2bfloat16((__bfloat162float(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
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

// Y[M, N] = epilogue(A[M, K] . W[K, N] + bias[N]); all row-major, K and N
// multiples of 8, A and W 16-byte aligned. Epilogue: optional GELU; with a
// residual R, Y = bf16(bf16(acc + bias) + R). 8 warps, each a 64x32 tile of
// mma.sync m16n8k16 accumulators; K tiles stream through a 3-stage
// cp.async ring in shared memory.
template <int ACT, bool RES>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ W,
    const float* __restrict__ bias, const bf16* __restrict__ R, bf16* __restrict__ Y,
    int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char gsmem[];
  bf16* As = reinterpret_cast<bf16*>(gsmem);
  bf16* Bs = As + kStages * kStageA;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = warp >> 2;  // 0..1: 64-row half
  const int wn = warp & 3;   // 0..3: 32-column quarter
  const int nk = (K + kBK - 1) / kBK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    bf16* as = As + stage * kStageA;
    bf16* bs = Bs + stage * kStageB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kGemmThreads;
      const int ar = idx >> 2, ac = (idx & 3) * 8;
      const int gr = m0 + ar, gk = k0 + ac;
      const bool va = gr < M && gk < K;
      cp_async16(as + ar * kLDA + ac, va ? A + (long long)gr * K + gk : A, va);
      const int br = idx >> 4, bc = (idx & 15) * 8;
      const int gkb = k0 + br, gn = n0 + bc;
      const bool vb = gkb < K && gn < N;
      cp_async16(bs + br * kLDB + bc, vb ? W + (long long)gkb * N + gn : W, vb);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // for every thread; stage (kt-1) % S is free
    const int nt = kt + kStages - 1;
    if (nt < nk) load_stage(nt % kStages, nt);
    cp_async_commit();
    const bf16* as = As + (kt % kStages) * kStageA;
    const bf16* bs = Bs + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ufv::ldmatrix_x4(af[i], as + (wm * 64 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                         kLDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2)
        ufv::ldmatrix_x4_trans(bfr[j2], bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLDB +
                                            wn * 32 + j2 * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          ufv::mma_bf16(acc[i][2 * j2], af[i], bfr[j2][0], bfr[j2][1]);
          ufv::mma_bf16(acc[i][2 * j2 + 1], af[i], bfr[j2][2], bfr[j2][3]);
        }
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j, e): row m0 + 64 wm + 16 i + g + 8 (e >= 2),
  // columns n0 + 32 wn + 8 j + 2 tig + {0, 1}
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * tig;
      if (col >= N) continue;  // N % 8 == 0: col + 1 < N too
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + i * 16 + g + 8 * half;
        if (row >= M) continue;
        float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
        if (ACT == ACT_GELU_TANH) { v0 = gelu_tanh(v0); v1 = gelu_tanh(v1); }
        if (ACT == ACT_GELU_EXACT) { v0 = gelu_exact(v0); v1 = gelu_exact(v1); }
        const long long off = (long long)row * N + col;
        if (RES) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(R + off));
          v0 = __bfloat162float(__float2bfloat16(v0)) + r.x;
          v1 = __bfloat162float(__float2bfloat16(v1)) + r.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(Y + off) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int ACT, bool RES>
cudaError_t gemm(const bf16* A, const bf16* W, const float* bias, const bf16* R, bf16* Y,
                 int M, int N, int K, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<ACT, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kGemmSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<ACT, RES><<<grid, kGemmThreads, kGemmSmem, st>>>(A, W, bias, R, Y, M, N, K);
  return cudaGetLastError();
}

cudaError_t layernorm(const bf16* x, const float* g, const float* b, bf16* y, int rows,
                      int C, float eps, cudaStream_t st) {
  layernorm_kernel<<<(rows + 7) / 8, 256, 0, st>>>(x, g, b, y, rows, C, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
  const int rows = N * S;
  const int hw = heads * head_dim;
  if (rows <= 0 || C % 8 || head_dim % 8 || mlp % 8 || head_dim > 128 ||
      (act != ACT_GELU_TANH && act != ACT_GELU_EXACT))
    return int(cudaErrorInvalidValue);
  const void* mats[] = {x, wqkv, wproj, w1, w2, xn, qkv, att, x1, hmid};
  for (const void* p : mats)
    if (!aligned16(p)) return int(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* X = static_cast<const bf16*>(x);
  bf16* XN = static_cast<bf16*>(xn);
  bf16* QKV = static_cast<bf16*>(qkv);
  bf16* ATT = static_cast<bf16*>(att);
  bf16* X1 = static_cast<bf16*>(x1);
  bf16* HM = static_cast<bf16*>(hmid);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };

  UFV_TRY(layernorm(X, f(ln1_s), f(ln1_b), XN, rows, C, eps, st));
  UFV_TRY((gemm<ACT_NONE, false>(XN, w(wqkv), f(bqkv), nullptr, QKV, rows, 3 * hw, C, st)));

  ufv::AttnArgs a;
  a.q = QKV;
  a.k = QKV + hw;
  a.v = QKV + 2 * hw;
  a.o = ATT;
  a.kv_lens = nullptr;
  a.kv_mask = nullptr;
  a.B = N; a.Sq = S; a.Skv = S; a.Hq = heads; a.Hkv = heads; a.D = head_dim;
  a.q_sb = a.k_sb = a.v_sb = (long long)S * 3 * hw;
  a.q_ss = a.k_ss = a.v_ss = 3LL * hw;
  a.q_sh = a.k_sh = a.v_sh = head_dim;
  a.o_sb = (long long)S * hw;
  a.o_ss = hw;
  a.o_sh = head_dim;
  a.scale = 1.0f / sqrtf(float(head_dim));
  a.causal = 0;
  UFV_TRY(ufv::attention_forward(a, st));

  UFV_TRY((gemm<ACT_NONE, true>(ATT, w(wproj), f(bproj), X, X1, rows, C, hw, st)));
  UFV_TRY(layernorm(X1, f(ln2_s), f(ln2_b), XN, rows, C, eps, st));
  if (act == ACT_GELU_TANH)
    UFV_TRY((gemm<ACT_GELU_TANH, false>(XN, w(w1), f(b1), nullptr, HM, rows, mlp, C, st)));
  else
    UFV_TRY((gemm<ACT_GELU_EXACT, false>(XN, w(w1), f(b1), nullptr, HM, rows, mlp, C, st)));
  UFV_TRY((gemm<ACT_NONE, true>(HM, w(w2), f(b2), X1, static_cast<bf16*>(out), rows, C,
                                mlp, st)));
  return 0;
}
