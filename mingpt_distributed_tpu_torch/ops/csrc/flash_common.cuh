// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, the softmax's base (2 or, for the prototype, e), the bf16
// tensor-core product and the staging of 64-row tiles into shared memory.
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

// d += a b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 fp32. Fragment ownership, with g = lane / 4 and t = lane % 4:
// a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]}; ".." = the pair packed in one 32-bit register, low half
// first.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment of an m16n8k16 product whose B[k][n] = M[k][n] for a tile M
// stored row-major in shared memory (row stride ld): k runs down the rows.
// m points at M[k0][n0]; the fragment covers rows k0..k0+15, columns
// n0..n0+7.
__device__ __forceinline__ void b_frag_rows(const __nv_bfloat16* m, int ld,
                                            int g, int t4, uint32_t* b0,
                                            uint32_t* b1) {
  const unsigned short* c =
      reinterpret_cast<const unsigned short*>(m) + 2 * t4 * ld + g;
  *b0 = c[0] | (static_cast<uint32_t>(c[ld]) << 16);
  *b1 = c[8 * ld] | (static_cast<uint32_t>(c[9 * ld]) << 16);
}

// Stage rows [row0, row0 + 64) of one head into shared memory (row stride
// HD + 8 bf16) with 16-byte loads; rows at or past T are zero. The wrapper
// guarantees 16-byte aligned rows.
template <int HD, int kThreads>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* base,
                                               long long st, int row0,
                                               int t_len) {
  constexpr int kLd = HD + 8;
  constexpr int kVecs = HD / 8;
  for (int e = threadIdx.x; e < kBK * kVecs; e += kThreads) {
    const int r = e / kVecs;
    const int c = (e % kVecs) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < t_len) val = *reinterpret_cast<const uint4*>(base + row * st + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
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
