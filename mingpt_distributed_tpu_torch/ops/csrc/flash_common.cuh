// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, the softmax's base (2 or, for the prototype, e), bf16 packing
// and the float32 kernels' staging of 64-row tiles into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInvLog2e = 0.6931471805599453f;

// The softmax's base, fixed at compile time: base 2 with log2(e) folded into
// the scores and the lse (the TPU kernels' choice, exp2f), or with kNat the
// natural base (the per-head-grid prototype's jnp.exp), exponentiated by the
// accurate expf. __expf would be ex2.approx of a product: base 2 again.
template <bool kNat>
__device__ __forceinline__ float exp_base(float x) {
  return kNat ? expf(x) : exp2f(x);
}

// exp_base with base 2 taken by the special-function unit alone
// (ex2.approx.ftz: results below 2^-126 flush to 0, where exp2f spends four
// more instructions to keep them); the natural base keeps expf.
template <bool kNat>
__device__ __forceinline__ float exp_fast(float x) {
  if (kNat) return expf(x);
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A natural-domain value (a score scale, an lse) in the softmax's base.
template <bool kNat>
__device__ __forceinline__ float to_base(float x) {
  return kNat ? x : x * kLog2e;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + 64) of one head into shared memory (row stride
// HD + 4 floats); rows at or past T are zero.
template <int HD, int kThreads>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base,
                                              long long st, int row0,
                                              int t_len) {
  constexpr int kLd = HD + 4;
  for (int e = threadIdx.x; e < kBK * HD; e += kThreads) {
    const int r = e / HD;
    const int c = e % HD;
    const int row = row0 + r;
    dst[r * kLd + c] = row < t_len ? base[row * st + c] : 0.f;
  }
}

}  // namespace flash
