// Flash attention forward (bf16) with a plain C interface for ctypes.
// Replaces ufvideo_tpu/ops/flash_attention.py flash_attention (_kernel);
// the device code, its bound and its design are described in
// attention_tile.cuh.
#include "attention_tile.cuh"

extern "C" const char* ufv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// keys a step of the instance that takes head dim d: the split plan's unit
extern "C" int flash_attention_block_kv(int d) { return ufv::attention_block_kv(d); }

// q [B, Sq, Hq, D], k / v [B, Skv, Hkv, D], o [B, Sq, Hq, D], any element
// strides (multiples of 8) with a unit stride along D, 16-byte aligned
// bases and D a multiple of 8. kv_lens [B] int32 and kv_mask
// [B, Skv] uint8 may be null. With splits > 1 the keys are cut into chunks
// of `chunk` (a multiple of the instance's key tile) and part_o [splits, B,
// Hq, Sq, D] / part_ml [splits, B, Hq, Sq, 2] (f32 scratch) take the partial
// sums before the merge. Returns cudaGetLastError() after the launches.
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* kv_lens,
    const void* kv_mask, void* part_o, void* part_ml, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int splits, int chunk,
    void* stream) {
  ufv::AttnArgs a;
  a.q = static_cast<const ufv::bf16*>(q);
  a.k = static_cast<const ufv::bf16*>(k);
  a.v = static_cast<const ufv::bf16*>(v);
  a.o = static_cast<ufv::bf16*>(o);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.kv_mask = static_cast<const uint8_t*>(kv_mask);
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.scale = scale;
  a.causal = causal;
  a.splits = splits;
  a.chunk = chunk;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  return static_cast<int>(
      ufv::attention_forward(a, static_cast<cudaStream_t>(stream)));
}
