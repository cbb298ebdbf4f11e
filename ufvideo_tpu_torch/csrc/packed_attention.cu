// Unmasked multi-head attention over a packed [q heads | k heads | v heads]
// projection buffer, with a plain C interface for ctypes. Two entry points,
// each replacing one TPU kernel:
//
//   mha_packed_bf16               ufvideo_tpu/ops/vit_attention.py
//                                 mha_full_attention_packed (_kernel): one
//                                 image a batch entry, [B, S, 3*H*D] ->
//                                 [B, S, H*D] (the unfused SigLIP layers,
//                                 S = 729, 16 heads of 72);
//   window_attention_packed_bf16  ufvideo_tpu/ops/window_attention.py
//                                 fused_window_attention (_kernel): one
//                                 window a batch entry, [NW, S, 3*H*D] ->
//                                 [NW, S, H*D] (Hiera's windowed
//                                 MultiScaleAttention, S = 16 / 64 / 256).
//
// Math: scores = q . k * D^-0.5 in f32 and an online f32 softmax (the flash
// tile's): each key tile's exp(s - running max), not yet divided by the row
// sum, is rounded to bf16 for P.V with f32 accumulation, and the row is
// divided by its f32 sum once, at the end; output rounded to bf16. The JAX
// _reference_packed / _reference (and the plain versions) round the
// normalised probabilities instead. Over 16-729 keys a probability is large
// enough for that bf16 step to show in the output (1.6e-2 of a head row's
// RMS on an H100), so the kernels are held to the fused block's limit,
// 5e-2 * rms(row), not the flash kernel's 1e-2. The TPU kernels' bf16 exp2
// softmax, 128-lane head padding and block-diagonal grouping of several
// windows under one score mask are layout devices of that chip and are not
// carried over.
//
// Bound on an H100: at SigLIP's shape [32, 729, 16 x 72] the work is 4 * 32
// * 16 * 729^2 * 72 = 78.4 GFLOP of products against 215 MB of traffic, so
// it is bound by operations (0.08 ms at 989 TFLOP/s); at Hiera's stage-1
// windows [4096, 64, 2 x 72] it is 9.7 GFLOP against 302 MB, bound by bytes
// (0.09 ms at 3.35 TB/s). Design: both run the online-softmax tile of
// attention_tile.cuh (the flash kernel's: TMA loads, wgmma for both
// products), whose tensor maps read q / k / v straight out of the packed
// buffer through row and head strides (no split in HBM); head dim 72 runs
// in the 80 instance, TMA zero-filling columns 72-79 and the ragged last
// query / key tile (729 = 5 * 128 + 89). A batch entry is one image or one
// window, so no block ever reads another window's keys: windows stay
// isolated by construction. A 16-token window fills a quarter of the
// 64-row query tile; packing four windows into a tile under a block-
// diagonal mask is left for a later change.
#include "attention_tile.cuh"

namespace {

using ufv::bf16;

cudaError_t packed_attention(const bf16* qkv, bf16* o, int B, int S, int H, int D,
                             cudaStream_t st) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0) return cudaErrorInvalidValue;
  const long long hd = (long long)H * D, row = 3 * hd;
  ufv::AttnArgs a;
  a.q = qkv;
  a.k = qkv + hd;
  a.v = qkv + 2 * hd;
  a.o = o;
  a.kv_lens = nullptr;
  a.kv_mask = nullptr;
  a.B = B;
  a.Sq = a.Skv = S;
  a.Hq = a.Hkv = H;
  a.D = D;
  a.q_sb = a.k_sb = a.v_sb = (long long)S * row;
  a.q_ss = a.k_ss = a.v_ss = row;
  a.q_sh = a.k_sh = a.v_sh = D;
  a.o_sb = (long long)S * hd;
  a.o_ss = hd;
  a.o_sh = D;
  a.scale = 1.0f / sqrtf(float(D));
  a.causal = 0;
  return ufv::attention_forward(a, st);
}

}  // namespace

extern "C" const char* ufv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// qkv [B, S, 3*H*D] bf16, lanes [q heads | k heads | v heads], 16-byte
// aligned, D a multiple of 8 up to 256; o [B, S, H*D] bf16. Returns the
// first CUDA error or 0.
extern "C" int mha_packed_bf16(const void* qkv, void* o, int B, int S, int H, int D,
                               void* stream) {
  return int(packed_attention(static_cast<const bf16*>(qkv), static_cast<bf16*>(o), B, S, H,
                              D, static_cast<cudaStream_t>(stream)));
}

// qkv [NW, S, 3*H*D] bf16 window-major tokens, o [NW, S, H*D]; as above.
extern "C" int window_attention_packed_bf16(const void* qkv, void* o, int NW, int S, int H,
                                            int D, void* stream) {
  return int(packed_attention(static_cast<const bf16*>(qkv), static_cast<bf16*>(o), NW, S, H,
                              D, static_cast<cudaStream_t>(stream)));
}
