// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, the softmax's base (2 or, for the prototype, e), 16-bit
// packing (bf16, fp16) and the float32 kernels' staging of 64-row tiles into
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInvLog2e = 0.6931471805599453f;

// The columns of one TMA box of a 16-bit head of HD columns, which fix its
// rows' swizzle (32, 64 or 128 bytes): 64 where HD is a multiple of 64, else
// 32 or 16, so hd 80 is five boxes of 16 and hd 96 three of 32. One width
// for every box of a tile keeps one swizzle, and lets one wgmma of N = HD
// read every box of a transposed operand at a fixed stride (the
// descriptor's leading byte offset); a 64-column box beside a 16- or
// 32-column one would need two swizzles and two products per step.
__host__ __device__ constexpr int box_cols(int hd) {
  return hd % 64 == 0 ? 64 : hd % 32 == 0 ? 32 : 16;
}

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

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats rounded to nearest (even) in the 16-bit element type E
// (__nv_bfloat16 or __half), packed low half first: P and dS before their
// products, as the TPU kernels round them to the input dtype, and the
// kernels' 16-bit outputs.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    return pack_f16(lo, hi);
  } else {
    static_assert(std::is_same<E, __nv_bfloat16>::value, "pack2: bf16 or fp16");
    return pack_bf16(lo, hi);
  }
}

// Stage rows [row0, row0 + kRows) of one head into shared memory (row
// stride HD + 4 floats); rows at or past T are zero.
template <int HD, int kRows, int kThreads>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* base,
                                              long long st, int row0,
                                              int t_len) {
  constexpr int kLd = HD + 4;
  for (int e = threadIdx.x; e < kRows * HD; e += kThreads) {
    const int r = e / HD;
    const int c = e % HD;
    const int row = row0 + r;
    dst[r * kLd + c] = row < t_len ? base[row * st + c] : 0.f;
  }
}

}  // namespace flash
