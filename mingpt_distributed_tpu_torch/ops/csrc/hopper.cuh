// Hopper (sm_90a) building blocks of the 16-bit (bf16 and fp16) flash
// kernels: mbarriers, TMA tile loads, shared-memory matrix descriptors and
// warpgroup products (wgmma), each a thin wrapper over its PTX instruction.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and announce the bytes that TMA loads will complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Spins this many times on an incomplete phase before trapping: a wait
// that can never complete (a broken pipeline) ends the kernel with an
// error instead of hanging the card. A healthy wait takes microseconds.
constexpr uint32_t kSpinLimit = 1u << 26;

// Wait until the phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
    if (done) return;
    if (spins == kSpinLimit) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 4-D tensor map into shared memory at `dst`, completing
// on `bar`. Coordinates are innermost first; out-of-range elements read 0.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// shared memory written by threads, read by wgmma
// ---------------------------------------------------------------------------

// Make this thread's shared-memory stores (generic proxy) visible to the
// async proxy (wgmma, TMA) before a barrier hands the tile over.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads,
// a multiple of 32.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The shared-memory layouts TMA writes and wgmma reads, by the row's bytes
// (the descriptor's layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32).
template <int kRowBytes>
struct Swizzle;
template <>
struct Swizzle<128> {
  static constexpr int kLayout = 1;
  static constexpr CUtensorMapSwizzle kMap = CU_TENSOR_MAP_SWIZZLE_128B;
};
template <>
struct Swizzle<64> {
  static constexpr int kLayout = 2;
  static constexpr CUtensorMapSwizzle kMap = CU_TENSOR_MAP_SWIZZLE_64B;
};
template <>
struct Swizzle<32> {
  static constexpr int kLayout = 3;
  static constexpr CUtensorMapSwizzle kMap = CU_TENSOR_MAP_SWIZZLE_32B;
};

// Matrix descriptor of a swizzled tile at shared address `addr`: lbo and
// sbo in bytes (leading and stride byte offsets), layout as above.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  uint64_t d = (addr & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(layout) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous product owns across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}


// The products' operand type, .bf16 or .f16, is a word of the instruction:
// each product below is a macro over it (AB, a string literal), and each
// function picks its instance for the element type E (__nv_bfloat16 or
// __half) at compile time. Accumulators are fp32 for both.
template <typename E>
constexpr bool kIsHalf = std::is_same<E, __half>::value;

template <typename E>
__device__ __forceinline__ void check_elem() {
  static_assert(std::is_same<E, __half>::value || std::is_same<E, __nv_bfloat16>::value,
                "the wgmma products take bf16 or fp16 operands");
}

// Eight "+f" operands d[i] .. d[i + 7] of an accumulator array d.
#define HOPPER_D8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),   \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define HOPPER_WGMMA_SS_N32(AB)                                                 \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %18, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"                                        \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8)                                                            \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_SS_N64(AB)                                                 \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %34, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"                         \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8),                                                           \
        HOPPER_D8(16),                                                          \
        HOPPER_D8(24)                                                           \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_SS_N128(AB)                                                \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %66, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "       \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "       \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, "        \
      "1, 1, 0, 0;\n"                                                           \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8),                                                           \
        HOPPER_D8(16),                                                          \
        HOPPER_D8(24),                                                          \
        HOPPER_D8(32),                                                          \
        HOPPER_D8(40),                                                          \
        HOPPER_D8(48),                                                          \
        HOPPER_D8(56)                                                           \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_RS_TB_N16(AB)                                              \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %13, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "       \
      "1, 1;\n"                                                                 \
      "}\n"                                                                     \
      : HOPPER_D8(0)                                                            \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

#define HOPPER_WGMMA_RS_TB_N32(AB)                                              \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %21, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"                          \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8)                                                            \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

#define HOPPER_WGMMA_RS_TB_N64(AB)                                              \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %37, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"           \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8),                                                           \
        HOPPER_D8(16),                                                          \
        HOPPER_D8(24)                                                           \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

#define HOPPER_WGMMA_RS_TB_N80(AB)                                              \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %45, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "           \
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"                                \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8),                                                           \
        HOPPER_D8(16),                                                          \
        HOPPER_D8(24),                                                          \
        HOPPER_D8(32)                                                           \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

#define HOPPER_WGMMA_RS_TB_N96(AB)                                              \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %53, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "       \
      "%41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, "      \
      "1, 1, 1;\n"                                                              \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8),                                                           \
        HOPPER_D8(16),                                                          \
        HOPPER_D8(24),                                                          \
        HOPPER_D8(32),                                                          \
        HOPPER_D8(40)                                                           \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

#define HOPPER_WGMMA_RS_TB_N128(AB)                                             \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %69, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "       \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "       \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, "          \
      "%66, %67}, %68, p, 1, 1, 1;\n"                                           \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8),                                                           \
        HOPPER_D8(16),                                                          \
        HOPPER_D8(24),                                                          \
        HOPPER_D8(32),                                                          \
        HOPPER_D8(40),                                                          \
        HOPPER_D8(48),                                                          \
        HOPPER_D8(56)                                                           \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

#define HOPPER_WGMMA_RS_TB_N256(AB)                                             \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %133, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "       \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "       \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "       \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "       \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "       \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "       \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "      \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "      \
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"                    \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8),                                                           \
        HOPPER_D8(16),                                                          \
        HOPPER_D8(24),                                                          \
        HOPPER_D8(32),                                                          \
        HOPPER_D8(40),                                                          \
        HOPPER_D8(48),                                                          \
        HOPPER_D8(56),                                                          \
        HOPPER_D8(64),                                                          \
        HOPPER_D8(72),                                                          \
        HOPPER_D8(80),                                                          \
        HOPPER_D8(88),                                                          \
        HOPPER_D8(96),                                                          \
        HOPPER_D8(104),                                                         \
        HOPPER_D8(112),                                                         \
        HOPPER_D8(120)                                                          \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

#define HOPPER_WGMMA_SS_TT_N16(AB)                                              \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %10, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n"              \
      "}\n"                                                                     \
      : HOPPER_D8(0)                                                            \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_SS_TT_N32(AB)                                              \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %18, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15}, %16, %17, p, 1, 1, 1, 1;\n"                                        \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8)                                                            \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_SS_TT_N64(AB)                                              \
  asm volatile(                                                                 \
      "{\n"                                                                     \
      ".reg .pred p;\n"                                                         \
      "setp.ne.b32 p, %34, 0;\n"                                                \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n"                         \
      "}\n"                                                                     \
      : HOPPER_D8(0),                                                           \
        HOPPER_D8(8),                                                           \
        HOPPER_D8(16),                                                          \
        HOPPER_D8(24)                                                           \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

// d (64 x N, fp32) = (scale_d ? d : 0) + A B for A 64 x 16 and B 16 x N
// (N = 32, 64 or 128 keys), both E in shared memory, K-major (the 16-deep
// axis contiguous). Accumulator ownership per warp w of the warpgroup,
// g = lane / 4, t = lane % 4: d[4j + e] is row 16w + g + 8 (e / 2), column
// 8j + 2t + e % 2.
template <typename E, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N is 32, 64 or 128");
  check_elem<E>();
  if constexpr (N == 32) {
    if constexpr (kIsHalf<E>) HOPPER_WGMMA_SS_N32("f16"); else HOPPER_WGMMA_SS_N32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (kIsHalf<E>) HOPPER_WGMMA_SS_N64("f16"); else HOPPER_WGMMA_SS_N64("bf16");
  } else {
    if constexpr (kIsHalf<E>) HOPPER_WGMMA_SS_N128("f16"); else HOPPER_WGMMA_SS_N128("bf16");
  }
}

// d (64 x N, fp32) += A B for A 64 x 16 E in registers and B 16 x N E in
// shared memory, N-major (transposed: the N axis contiguous); N = 16, 32,
// 64, 80, 96, 128 or 256. A's fragment per warp w: a = {A[g][2t..],
// A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]} (rows 16w + ..., ".." the pair
// packed low half first); d as in wgmma_ss.
template <typename E, int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t desc_b) {
  check_elem<E>();
  constexpr bool h = kIsHalf<E>;
  if constexpr (N == 16) {
    if constexpr (h) HOPPER_WGMMA_RS_TB_N16("f16"); else HOPPER_WGMMA_RS_TB_N16("bf16");
  } else if constexpr (N == 32) {
    if constexpr (h) HOPPER_WGMMA_RS_TB_N32("f16"); else HOPPER_WGMMA_RS_TB_N32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (h) HOPPER_WGMMA_RS_TB_N64("f16"); else HOPPER_WGMMA_RS_TB_N64("bf16");
  } else if constexpr (N == 80) {
    if constexpr (h) HOPPER_WGMMA_RS_TB_N80("f16"); else HOPPER_WGMMA_RS_TB_N80("bf16");
  } else if constexpr (N == 96) {
    if constexpr (h) HOPPER_WGMMA_RS_TB_N96("f16"); else HOPPER_WGMMA_RS_TB_N96("bf16");
  } else if constexpr (N == 128) {
    if constexpr (h) HOPPER_WGMMA_RS_TB_N128("f16"); else HOPPER_WGMMA_RS_TB_N128("bf16");
  } else {
    static_assert(N == 256, "wgmma_rs_tb: N is 16, 32, 64, 80, 96, 128 or 256");
    if constexpr (h) HOPPER_WGMMA_RS_TB_N256("f16"); else HOPPER_WGMMA_RS_TB_N256("bf16");
  }
}

// d (64 x N, fp32) = (scale_d ? d : 0) + A B for A 64 x 16 and B 16 x N
// (N = 16, 32 or 64), both E in shared memory and both M/N-major
// (transposed: the 64 rows of A, the N columns of B contiguous); d as in
// wgmma_ss.
template <typename E, int N>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[N / 2], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  check_elem<E>();
  constexpr bool h = kIsHalf<E>;
  if constexpr (N == 16) {
    if constexpr (h) HOPPER_WGMMA_SS_TT_N16("f16"); else HOPPER_WGMMA_SS_TT_N16("bf16");
  } else if constexpr (N == 32) {
    if constexpr (h) HOPPER_WGMMA_SS_TT_N32("f16"); else HOPPER_WGMMA_SS_TT_N32("bf16");
  } else {
    static_assert(N == 64, "wgmma_ss_tt: N is 16, 32 or 64");
    if constexpr (h) HOPPER_WGMMA_SS_TT_N64("f16"); else HOPPER_WGMMA_SS_TT_N64("bf16");
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime,
// so the library needs no link against libcuda. Null if the driver has none.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) f = nullptr;
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// A 16-bit tensor (hd, heads, T, B) of element type `type` (bf16 or fp16),
// innermost first, with the caller's strides in elements, loaded in boxes
// of (box_cols, 1, box_rows, 1). A stride of a dimension of size 1 is never
// used to address; it is replaced by a legal one. Returns false when the
// driver refuses the map.
inline bool make_map_16(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                        int hd, int heads, int t, int b, long long s_head,
                        long long s_t, long long s_b, int box_cols, int box_rows,
                        CUtensorMapSwizzle swizzle) {
  if (type != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 && type != CU_TENSOR_MAP_DATA_TYPE_FLOAT16) {
    return false;
  }
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long el = 2;
  const long long fill = static_cast<long long>(hd) * el;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(b)};
  cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(heads > 1 ? s_head * el : fill),
      static_cast<cuuint64_t>(t > 1 ? s_t * el : fill),
      static_cast<cuuint64_t>(b > 1 ? s_b * el : fill)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1u,
                       static_cast<cuuint32_t>(box_rows), 1u};
  cuuint32_t elem_strides[4] = {1u, 1u, 1u, 1u};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor-map data type of a 16-bit element type E.
template <typename E>
constexpr CUtensorMapDataType map_type() {
  return kIsHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

}  // namespace hopper
