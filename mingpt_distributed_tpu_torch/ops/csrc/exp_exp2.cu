// The exp-vs-exp2 microbenchmark (K6), replacing `_kernel` of
// tools/exp_exp2.py. For every element of a float32 array: y = x, then
// `reps` times y = op(-|y| - 0.01), out = y. The ops are the flash kernels'
// own exponentials from flash_common.cuh, so the tool times what K1-K5
// execute: expf (K5's natural base), exp2f (K1-K4's base 2) and exp2f of a
// product by log2(e).
//
// Bound: the exponentials. On Hopper each one issues a MUFU.EX2 on the
// special-function unit, 16 results per clock per SM where the FMA pipes give
// 128; expf adds its range reduction on the FMA pipes. The bytes (one read
// and one write per element) take about a sixth of the SFU's time at 64
// reps. Each rep waits on the last, so every thread carries the four
// independent chains of one float4: four exponentials in flight per thread
// beside those of the other resident warps. The grid is one wave of
// resident blocks walking the array with a grid-stride loop; a scalar tail
// takes the n % 4 last elements, or every element when a pointer is not
// 16-byte aligned. The TPU kernel's (nblocks, 512, 512) VMEM blocks have no
// counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 8 x 256 threads: an SM's 2048

// kOp: 0 = exp, 1 = exp2, 2 = exp2 of y * log2(e)
template <int kOp>
__device__ __forceinline__ float apply(float y) {
  if (kOp == 0) return flash::exp_base<true>(y);
  if (kOp == 1) return flash::exp_base<false>(y);
  return flash::exp_base<false>(y * flash::kLog2e);
}

// `reps` steps of y = op(-|y| - 0.01) on kN independent elements; the run-time
// trip count is unrolled by 4 (the rest in a remainder loop).
template <int kOp, int kN>
__device__ __forceinline__ void chain(float (&y)[kN], int reps) {
#pragma unroll 4
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < kN; ++j) y[j] = apply<kOp>(-fabsf(y[j]) - 0.01f);
  }
}

// n4 float4 groups from the start, then elements [4 n4, n) one by one.
template <int kOp>
__global__ void __launch_bounds__(kThreads)
    exp_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                     long long n, long long n4, int reps) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long i = first; i < n4; i += stride) {
    const float4 v = x4[i];
    float y[4] = {v.x, v.y, v.z, v.w};
    chain<kOp>(y, reps);
    out4[i] = make_float4(y[0], y[1], y[2], y[3]);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float y[1] = {x[i]};
    chain<kOp>(y, reps);
    out[i] = y[0];
  }
}

template <int kOp>
cudaError_t launch(const float* x, float* out, long long n, int reps,
                   cudaStream_t stream) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long tail = n - 4 * n4;
  const long long work = n4 > tail ? n4 : tail;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(kBlocksPerSm) * sms) {
    blocks = static_cast<long long>(kBlocksPerSm) * sms;
  }
  if (blocks < 1) blocks = 1;
  exp_chain_kernel<kOp><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, out, n, n4, reps);
  return cudaGetLastError();
}

}  // namespace

// x, out: n float32 each (any alignment, not overlapping); reps >= 0; op: 0 =
// exp, 1 = exp2, 2 = exp2*log2e. Returns a cudaError_t (0 = success).
extern "C" int exp_chain(const void* x, void* out, long long n, int reps,
                         int op, void* stream) {
  if (n < 0 || reps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return static_cast<int>(launch<0>(xf, of, n, reps, s));
    case 1: return static_cast<int>(launch<1>(xf, of, n, reps, s));
    case 2: return static_cast<int>(launch<2>(xf, of, n, reps, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
