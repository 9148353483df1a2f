// Flash-attention backward for Hopper (sm_90a), plain C interface: eight
// entry points, each a launch of its own.
//
//   flash_bwd_prep    computes delta = rowsum(out * dO) (minus the lse
// cotangent where there is one) and zeroes K2c's float32 dq in one pass
// over out and dO; it replaces no TPU kernel (the JAX package sums delta
// with jnp.sum outside its kernels, mingpt_distributed_tpu/ops/
// flash_attention.py:1101 and :491), and every backward below takes its
// delta;
//   flash_bwd_dq      replaces the TPU kernel `_dq_kernel_btd` (K2a),
//   flash_bwd_dkv     replaces the TPU kernel `_dkv_kernel_btd` (K2b),
// reached through `_flash_bwd_btd` and the custom VJP of `_flash_btd`
// (causal);
//   flash_bwd_fused   replaces the TPU kernel `_dqkv_kernel_btd` (K2c),
// reached through `_flash_bwd_btd_fused` when FLASH_FUSED_BWD=1: dq, dk and
// dv in one pass (below);
//   flash_lse_bwd_dq  replaces the TPU kernel `_dq_kernel` (K4a),
//   flash_lse_bwd_dkv replaces the TPU kernel `_dkv_kernel` (K4b),
// reached through `_flash_bwd` and the custom VJP of `flash_with_lse` (the
// ring-attention hop), which add a `causal` flag and a `q_offset` placing
// query row i at key position q_offset + i; all in
// mingpt_distributed_tpu/ops/flash_attention.py; and
//   nh_bwd_dq         replaces the TPU kernel `_dq_kernel4`,
//   nh_bwd_dkv        replaces the TPU kernel `_dkv_kernel4`,
// of the per-head-grid prototype (tools/proto_nh_kernel.py,
// `flash_bwd_btd`, K5): flash_bwd_dq/_dkv with the softmax in the natural
// base. The lse cotangent of `flash_with_lse` reaches them folded into delta
// by flash_bwd_prep (delta' = delta - dlse, as `_flash_bwd` folds it). Dead
// rows (no key inside the offset band) get p = 0 structurally,
// so dq = 0 there and they add nothing to dk/dv, whatever their lse. The
// entry points run the same kernels, specialised at compile time (kLse,
// kNat, kFused): flash_bwd_*'s instantiations test the plain causal band,
// with no flag or offset in their inner loops, flash_lse_bwd_*'s the general
// one, nh_bwd_*'s the plain band in the natural base. Like the TPU kernels,
// they recompute the probabilities from the forward's log-sum-exp instead
// of storing the attention matrix, in base 2 with log2(e) folded into the
// score scale (nh_bwd_*: base e, expf):
//   p  = exp2(s * scale * log2e - lse * log2e) on allowed pairs, exactly 0
//        on masked ones;
//   dp = dO V^T;  ds = p (dp - delta) * scale, times (1 - t^2) under
//        soft-capping, with t the unmasked tanh(s * scale / cap);
//   dq = ds K;  dk = ds^T Q;  dv = p^T dO.
// delta = rowsum(out * dO) comes from flash_bwd_prep. As the TPU kernels
// do, the bf16 paths round P to bf16 before P^T dO and dS before dS K and
// dS^T Q, and accumulate in float32. Tail tiles are masked (rows and keys at or past T
// read as zeros, are never allowed, and are not stored), so any T >= 1
// works.
//
// Layout: q (B, T, H, hd), k/v (B, T, KV, hd), addressed through the batch,
// time and head strides the caller passes (the last dim dense); dO, dq a
// dense (B, T, H, hd), dk/dv a dense (B, T, KV, hd); lse and delta dense
// (B, H, T) float32. Grouped-query attention reads kv head h / (H / KV); the
// dk/dv kernels sum the GQA group inside the block, with no atomics, so the
// result does not depend on scheduling.
//
// bfloat16 dq and dk/dv (K2a, K2b, K4a, K4b, K5's backward) and K2c: TMA +
// wgmma, warp-specialised, in the shape of the forward (flash_fwd.cu): persistent
// blocks of 384 threads, one per SM, walking work items in a static round
// robin, heaviest first; one producer warpgroup (its registers given to the
// consumers by setmaxnreg) whose first thread issues every TMA load into a
// ring of two stages guarded by full and empty mbarriers; two consumer
// warpgroups of 64 rows each.
//   dq: an item is 128 query rows of one head. Q and dO are loaded once per
//     item; K and V come in tiles of 64 keys. S = Q K^T and dP = dO V^T by
//     wgmma m64n64k16 from shared memory (both K-major); dS is formed in
//     registers and is the A operand of dq += dS K (K read through the
//     transpose bit), as P is of O += P V in the forward.
//   dk/dv: an item is 128 keys of one KV head (the first, heaviest, k tiles
//     first). K and V are loaded once per item; the ring carries (query head
//     of the GQA group, q tile) pairs of 64-row Q and dO tiles, with their
//     lse and delta, which the producer's second warp stores beside them.
//     S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16; P^T and dS^T are
//     formed in registers (lse and delta broadcast along columns) and are
//     the A operands of dV += P^T dO and dK += dS^T Q (Q and dO read N-major
//     through the transpose bit). A stage is released only after both of
//     those products have retired.
//   Both: masks are applied only on tiles that need them (the diagonal, the
//   window's edge, the tail, an offset band), decided per tile and
//   warpgroup; a tile with no allowed pair for a warpgroup skips its
//   products. The softcap is tested once per tile. P is exponentiated by
//   ex2.approx.ftz alone (exp_fast: a probability below 2^-126 flushes to
//   0, where exp2f spends four more instructions on every score to keep
//   it; nh_bwd_*: expf).
//
// K2c (flash_bwd_fused) is the dk/dv kernel with kFused: after a Q/dO
// tile's dV and dK products are issued, each consumer warpgroup stores its
// dS^T (64 keys x 64 queries, bf16, 128-byte swizzled rows of queries) to
// shared memory and computes its cell's dq = dS K (64 queries x hd over its
// 64 keys) by wgmma, dS read transposed and K N-major, in column chunks of
// at most 64. The two warpgroups hold the same 64 queries, so where both
// have live keys they sum their partials through shared memory (each hands
// the other half of the chunk's columns, one named barrier over both) and
// each adds its half to a float32 dq buffer in device memory by float2
// atomic adds (red.global): every element once per (Q/dO tile, item) cell.
// The TPU kernel keeps the whole head's dq in VMEM across its k-tile sweep
// (`dq_all_scr`); T * hd * 4 bytes (256 KB at T=1024, hd=64) does not fit
// in shared memory, and the items of one q tile's keys run on other SMs in
// no order. K and V are released after the last tile's dq product, not
// after its S and dP as in dk/dv: dq reads K. flash_bwd_prep zeroes the
// buffer and the caller casts it to q's dtype. The order of the atomic
// sums is not fixed, so a float32 dq is reproducible only to a few ulps.
//
// float32 inputs take float32 FMAs from shared memory (four threads per
// row; one block per tile), because TF32 would not hold the float32
// tolerance.
//
// What bounds it on the H100: the products. At the training shape (B=16,
// T=1024, H=12, hd=64, causal) dq does 3 products of 2 * hd operations per
// allowed pair (S, dP, dS K: 38.7 GFLOP, 0.039 ms at 989 TFLOP/s) and dk/dv
// 4 (S, dP, P^T dO, dS^T Q: 51.6 GFLOP, 0.052 ms), against ~130-150 MB
// moved (0.04-0.045 ms at 3.35 TB/s) and one exponential per allowed pair.
// What the design attacks is latency: loads run a stage ahead of the
// products, the two consumer warpgroups overlap one's elementwise work with
// the other's products, persistent blocks hide an item's start-up and
// epilogue under the next item's loads (Q and dO, or K and V, are released
// as soon as the item's last products have read them), and interior tiles
// run no mask. K2c does 5 products per pair (0.065 ms at the card's bf16
// peak: its bound, the function writing dq once in bf16). Its design adds
// a float32 dq buffer, read and written back once (~100 MB), and atomics
// that add 4 * hd bytes per query per 128-key item of its band (~226 MB
// there), resolved in L2: they, not the products, are what K2c spends
// beyond K2b. flash_bwd_prep is bound by its bytes
// (out and dO read, delta written: ~51 MB, 0.015 ms; with K2c's 50 MB
// zero-fill ~0.030 ms).

#include <math.h>

#include <algorithm>
#include <numeric>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // dense (B, T, H, hd)
  const float* lse;    // (B, H, T), natural domain
  const float* delta;  // (B, H, T)
  void* dq;            // dense (B, T, H, hd); float32, added to (kFused)
  void* dk;            // dense (B, T, KV, hd)
  void* dv;
  int B, T, H, KV;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  float scale;
  int window;     // <= 0: no window (causal only)
  float softcap;  // <= 0: off
  int causal;     // 0: every key of the chunk is visible
  int q_offset;   // causal: query row i sits at key position q_offset + i
};

// Score of a raw q.k product in the softmax's base (base 2, or e with
// kNat), and d(score)/d(raw) in the natural domain: scale, or
// scale * (1 - t^2) under soft-capping.
template <bool kNat>
__device__ __forceinline__ float score(const Params& p, float s,
                                       float* dfac) {
  if (p.softcap > 0.f) {
    const float t = tanhf(s * (p.scale / p.softcap));
    *dfac = p.scale * (1.f - t * t);
    return to_base<kNat>(p.softcap) * t;
  }
  *dfac = p.scale;
  return s * to_base<kNat>(p.scale);
}

template <bool kLse>
__device__ __forceinline__ bool visible(const Params& p, int q_pos,
                                        int k_pos) {
  if (!kLse) {
    return k_pos <= q_pos && q_pos < p.T &&
           (p.window <= 0 || q_pos - k_pos < p.window);
  }
  if (q_pos >= p.T || k_pos >= p.T) return false;
  if (!p.causal) return true;
  const int qg = p.q_offset + q_pos;
  return k_pos <= qg && (p.window <= 0 || qg - k_pos < p.window);
}

// The k/v tiles of BK keys that a q tile of BQ rows starting at q0 attends;
// lo > hi when the band misses the chunk.
template <bool kLse, int BQ, int BK>
__device__ __forceinline__ void kv_tile_range(const Params& p, int q0,
                                              int* lo, int* hi) {
  if (kLse && !p.causal) {
    *lo = 0;
    *hi = (p.T - 1) / BK;
    return;
  }
  const int qg = kLse ? p.q_offset + q0 : q0;  // the tile's first row on the key axis
  const int k_first = p.window > 0 ? max(0, qg - (p.window - 1)) : 0;
  *lo = k_first / BK;
  *hi = min(qg + BQ - 1, p.T - 1) / BK;
}

// The q tiles of BQ rows that attend a k tile of BK keys starting at k0; lo
// > hi when none does.
template <bool kLse, int BK, int BQ>
__device__ __forceinline__ void q_tile_range(const Params& p, int k0,
                                             int* lo, int* hi) {
  if (!kLse) {
    const int q_last =
        p.window > 0 ? min(p.T - 1, k0 + BK - 1 + p.window - 1) : p.T - 1;
    *lo = k0 / BQ;
    *hi = q_last / BQ;
    return;
  }
  if (!p.causal) {
    *lo = 0;
    *hi = (p.T - 1) / BQ;
    return;
  }
  const int q_last =
      p.window > 0 ? min(p.T - 1, k0 + BK - 1 + p.window - 1 - p.q_offset)
                   : p.T - 1;
  *lo = max(0, k0 - p.q_offset) / BQ;
  *hi = q_last < 0 ? -1 : q_last / BQ;
}

__device__ __forceinline__ long long row_index(const Params& p, int b,
                                               int t, int heads, int h) {
  return (static_cast<long long>(b) * p.T + t) * heads + h;
}

// ---------------------------------------------------------------------------
// float32: FMA path
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;  // four threads per row

template <int HD, bool kLse, bool kNat>
__global__ void __launch_bounds__(kFmaThreads) flash_dq_f32_kernel(Params p) {
  constexpr int kLd = HD + 4;
  constexpr int kLdp = kBK + 4;
  constexpr int kGroups = HD / 16;  // float4 column groups per thread
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;
  float* dos = qs + kBQ * kLd;
  float* ks = dos + kBQ * kLd;
  float* vs = ks + kBK * kLd;
  float* dss = vs + kBK * kLd;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int row = threadIdx.x >> 2;
  const int sub = threadIdx.x & 3;
  const int q_pos = q0 + row;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + row_index(p, b, 0, p.H, h) * HD;
  load_tile_f32<HD, kFmaThreads>(qs, q, p.q_st, q0, p.T);
  load_tile_f32<HD, kFmaThreads>(dos, dout, static_cast<long long>(p.H) * HD,
                                 q0, p.T);
  const long long vec = (static_cast<long long>(b) * p.H + h) * p.T + q_pos;
  const float lse2 = q_pos < p.T ? to_base<kNat>(p.lse[vec]) : 0.f;
  const float delta = q_pos < p.T ? p.delta[vec] : 0.f;

  float acc[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }

  int kt_lo, kt_hi;
  kv_tile_range<kLse, kBQ, kBK>(p, q0, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's k/v reads are done
    load_tile_f32<HD, kFmaThreads>(ks, k, p.k_st, k0, p.T);
    load_tile_f32<HD, kFmaThreads>(vs, v, p.v_st, k0, p.T);
    __syncthreads();

    // scores and dO.V of keys k0 + sub + 4j, j = 0..15
    float s[16], dp[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[row * kLd + d]);
      const float4 ov = *reinterpret_cast<const float4*>(&dos[row * kLd + d]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = (sub + 4 * j) * kLd + d;
        const float4 kv = *reinterpret_cast<const float4*>(&ks[r]);
        const float4 vv = *reinterpret_cast<const float4*>(&vs[r]);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
        dp[j] = fmaf(ov.x, vv.x, dp[j]);
        dp[j] = fmaf(ov.y, vv.y, dp[j]);
        dp[j] = fmaf(ov.z, vv.z, dp[j]);
        dp[j] = fmaf(ov.w, vv.w, dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float dfac;
      const float s2 = score<kNat>(p, s[j], &dfac);
      dss[row * kLdp + sub + 4 * j] =
          visible<kLse>(p, q_pos, k0 + sub + 4 * j)
              ? exp_base<kNat>(s2 - lse2) * (dp[j] - delta) * dfac
              : 0.f;
    }
    // a row's dS is written and read by its own four threads, one warp
    __syncwarp();

    // dq += dS K over this tile; this thread owns column groups sub + 4g
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dss[row * kLdp + c]);
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* krow = &ks[(c + cc) * kLd];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 k4 =
              *reinterpret_cast<const float4*>(&krow[4 * (sub + 4 * g)]);
          acc[g][0] = fmaf(dr[cc], k4.x, acc[g][0]);
          acc[g][1] = fmaf(dr[cc], k4.y, acc[g][1]);
          acc[g][2] = fmaf(dr[cc], k4.z, acc[g][2]);
          acc[g][3] = fmaf(dr[cc], k4.w, acc[g][3]);
        }
      }
    }
    __syncwarp();  // reads of dss done before the next tile overwrites it
  }

  if (q_pos < p.T) {
    float* o = static_cast<float*>(p.dq) + row_index(p, b, q_pos, p.H, h) * HD;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      *reinterpret_cast<float4*>(&o[4 * (sub + 4 * g)]) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
  }
}

template <int HD, bool kLse, bool kNat, bool kFused>
__global__ void __launch_bounds__(kFmaThreads) flash_dkv_f32_kernel(Params p) {
  constexpr int kLd = HD + 4;
  constexpr int kLdp = kBQ + 4;
  constexpr int kGroups = HD / 16;
  extern __shared__ __align__(16) float smem_f32[];
  float* ks = smem_f32;
  float* vs = ks + kBK * kLd;
  float* qs = vs + kBK * kLd;
  float* dos = qs + kBQ * kLd;
  float* ps = dos + kBQ * kLd;
  float* dss = ps + kBK * kLdp;
  float* lse_s = dss + kBK * kLdp;
  float* delta_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;  // the first k tiles have the most work
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.H / p.KV;
  const int row = threadIdx.x >> 2;  // this thread's key: k0 + row
  const int sub = threadIdx.x & 3;
  const int k_pos = k0 + row;

  load_tile_f32<HD, kFmaThreads>(
      ks, static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_st,
      k0, p.T);
  load_tile_f32<HD, kFmaThreads>(
      vs, static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_st,
      k0, p.T);

  float dk[kGroups][4], dv[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    dk[g][0] = dk[g][1] = dk[g][2] = dk[g][3] = 0.f;
    dv[g][0] = dv[g][1] = dv[g][2] = dv[g][3] = 0.f;
  }

  int qt_lo, qt_hi;
  q_tile_range<kLse, kBK, kBQ>(p, k0, &qt_lo, &qt_hi);
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dout =
        static_cast<const float*>(p.dout) + row_index(p, b, 0, p.H, h) * HD;
    const long long vec0 = (static_cast<long long>(b) * p.H + h) * p.T;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's q/dO reads are done
      load_tile_f32<HD, kFmaThreads>(qs, q, p.q_st, q0, p.T);
      load_tile_f32<HD, kFmaThreads>(dos, dout,
                                     static_cast<long long>(p.H) * HD, q0, p.T);
      for (int i = threadIdx.x; i < kBQ; i += kFmaThreads) {
        const bool in = q0 + i < p.T;
        lse_s[i] = in ? to_base<kNat>(p.lse[vec0 + q0 + i]) : 0.f;
        delta_s[i] = in ? p.delta[vec0 + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T and (dO V^T)^T of queries q0 + sub + 4j, j = 0..15
      float s[16], dp[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&ks[row * kLd + d]);
        const float4 vv = *reinterpret_cast<const float4*>(&vs[row * kLd + d]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int r = (sub + 4 * j) * kLd + d;
          const float4 qv = *reinterpret_cast<const float4*>(&qs[r]);
          const float4 ov = *reinterpret_cast<const float4*>(&dos[r]);
          s[j] = fmaf(kv.x, qv.x, s[j]);
          s[j] = fmaf(kv.y, qv.y, s[j]);
          s[j] = fmaf(kv.z, qv.z, s[j]);
          s[j] = fmaf(kv.w, qv.w, s[j]);
          dp[j] = fmaf(vv.x, ov.x, dp[j]);
          dp[j] = fmaf(vv.y, ov.y, dp[j]);
          dp[j] = fmaf(vv.z, ov.z, dp[j]);
          dp[j] = fmaf(vv.w, ov.w, dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int qc = sub + 4 * j;
        float dfac;
        const float s2 = score<kNat>(p, s[j], &dfac);
        const bool live = visible<kLse>(p, q0 + qc, k_pos);
        const float pv = live ? exp_base<kNat>(s2 - lse_s[qc]) : 0.f;
        ps[row * kLdp + qc] = pv;
        dss[row * kLdp + qc] = live ? pv * (dp[j] - delta_s[qc]) * dfac : 0.f;
      }
      __syncwarp();  // a key row's P and dS belong to its own four threads

      // dv += P^T dO, dk += dS^T Q over this q tile
#pragma unroll 2
      for (int c = 0; c < kBQ; c += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&ps[row * kLdp + c]);
        const float4 d4 =
            *reinterpret_cast<const float4*>(&dss[row * kLdp + c]);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* orow = &dos[(c + cc) * kLd];
          const float* qrow = &qs[(c + cc) * kLd];
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const int col = 4 * (sub + 4 * g);
            const float4 o4 = *reinterpret_cast<const float4*>(&orow[col]);
            const float4 q4 = *reinterpret_cast<const float4*>(&qrow[col]);
            dv[g][0] = fmaf(pr[cc], o4.x, dv[g][0]);
            dv[g][1] = fmaf(pr[cc], o4.y, dv[g][1]);
            dv[g][2] = fmaf(pr[cc], o4.z, dv[g][2]);
            dv[g][3] = fmaf(pr[cc], o4.w, dv[g][3]);
            dk[g][0] = fmaf(dr[cc], q4.x, dk[g][0]);
            dk[g][1] = fmaf(dr[cc], q4.y, dk[g][1]);
            dk[g][2] = fmaf(dr[cc], q4.z, dk[g][2]);
            dk[g][3] = fmaf(dr[cc], q4.w, dk[g][3]);
          }
        }
      }
      __syncwarp();  // reads of ps/dss done before the next tile

      if (kFused) {
        // dq += dS K over this cell: this thread's query q0 + row, column
        // groups sub + 4g, added to the float32 dq in device memory
        __syncthreads();  // every key row's dS is written
        float dqa[kGroups][4];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          dqa[g][0] = dqa[g][1] = dqa[g][2] = dqa[g][3] = 0.f;
        }
#pragma unroll 4
        for (int c = 0; c < kBK; ++c) {
          const float d = dss[c * kLdp + row];
          const float* krow = &ks[c * kLd];
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const float4 k4 =
                *reinterpret_cast<const float4*>(&krow[4 * (sub + 4 * g)]);
            dqa[g][0] = fmaf(d, k4.x, dqa[g][0]);
            dqa[g][1] = fmaf(d, k4.y, dqa[g][1]);
            dqa[g][2] = fmaf(d, k4.z, dqa[g][2]);
            dqa[g][3] = fmaf(d, k4.w, dqa[g][3]);
          }
        }
        if (q0 + row < p.T) {
          float* o = static_cast<float*>(p.dq) +
                     row_index(p, b, q0 + row, p.H, h) * HD;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              atomicAdd(&o[4 * (sub + 4 * g) + e], dqa[g][e]);
            }
          }
        }
      }
    }
  }

  if (k_pos < p.T) {
    const long long r = row_index(p, b, k_pos, p.KV, kvh) * HD;
    float* dko = static_cast<float*>(p.dk) + r;
    float* dvo = static_cast<float*>(p.dv) + r;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int col = 4 * (sub + 4 * g);
      *reinterpret_cast<float4*>(&dko[col]) =
          make_float4(dk[g][0], dk[g][1], dk[g][2], dk[g][3]);
      *reinterpret_cast<float4*>(&dvo[col]) =
          make_float4(dv[g][0], dv[g][1], dv[g][2], dv[g][3]);
    }
  }
}


// ---------------------------------------------------------------------------
// bfloat16, K2a/K2b (K4a/K4b, K5): TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;  // the producer warpgroup, two consumers
constexpr int kConsumers = 256;  // consumer threads: each releases a stage
constexpr int kWgRows = 64;      // rows of one consumer warpgroup's products
constexpr int kStages = 2;       // tiles in a ring
constexpr int kDqRows = 128;     // dq: query rows per work item
constexpr int kDqKeys = 64;      // dq: keys per K/V tile
constexpr int kDkvKeys = 128;    // dk/dv: keys per work item
constexpr int kDkvRows = 64;     // dk/dv: query rows per Q/dO tile
static_assert(kDqKeys == 64 && kDkvRows == 64,
              "S and dP (or their transposes) are wgmma m64n64k16 products");

// A head's rows in shared memory: HD columns as boxes of at most 64 (128
// bytes), each a (rows x kRowBytes) tile of its own, swizzled to the row's
// bytes as TMA writes and wgmma reads them.
template <int HD>
struct HeadRows {
  static constexpr int kBoxCols = HD < 64 ? HD : 64;
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kLayout = hopper::Swizzle<kRowBytes>::kLayout;
  static constexpr uint32_t kSbo = 8 * kRowBytes;  // between 8-row groups
};

// Shared-memory layouts (byte offsets; every tile 1024-aligned, as the
// 128-byte swizzle repeats every 1024 bytes). dq: Q and dO of the item, two
// stages of K and V, then the barriers (Q full and empty, full[] and
// empty[] of the ring).
template <int HD>
struct DqTiles : HeadRows<HD> {
  using R = HeadRows<HD>;
  static constexpr int kQBox = kDqRows * R::kRowBytes;  // a box of Q (or dO)
  static constexpr int kKBox = kDqKeys * R::kRowBytes;  // a box of K (or V)
  static constexpr int kQTile = kQBox * R::kBoxes;
  static constexpr int kKTile = kKBox * R::kBoxes;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQTile;
  static constexpr int kK = kDO + kQTile;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBars = kV + kStages * kKTile;
  static constexpr int kSmem = kBars + 8 * (2 + 2 * kStages) + 1024;  // + align
};

// dk/dv: K and V of the item, two stages of Q, dO and (lse, delta), with
// kFused each consumer warpgroup's dS^T tile (64 keys x 64 queries, bf16,
// rows of 128 bytes, 128-byte swizzled) and the dq exchange (per
// warpgroup and parity, a float4 per thread for each of its half chunk's
// 8-column groups), then the barriers (K/V full and empty, full[] and
// empty[] of the ring).
template <int HD, bool kFused>
struct DkvTiles : HeadRows<HD> {
  using R = HeadRows<HD>;
  static constexpr int kKBox = kDkvKeys * R::kRowBytes;
  static constexpr int kQBox = kDkvRows * R::kRowBytes;
  static constexpr int kKTile = kKBox * R::kBoxes;
  static constexpr int kQTile = kQBox * R::kBoxes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKTile;
  static constexpr int kQ = kV + kKTile;
  static constexpr int kDO = kQ + kStages * kQTile;
  static constexpr int kVec = kDO + kStages * kQTile;  // lse then delta, per stage
  static constexpr int kDsTile = kWgRows * kDkvRows * 2;
  static constexpr int kDs = kVec + kStages * 2 * kDkvRows * 4;
  static constexpr int kDqN = HD < 64 ? HD : 64;  // dq's column chunk
  static constexpr int kX = kDs + (kFused ? 2 * kDsTile : 0);
  // warpgroups x parities x half chunk's column groups x threads x float4
  static constexpr int kXBytes = 2 * 2 * (kDqN / 16) * 128 * 16;
  static constexpr int kBars = kX + (kFused ? kXBytes : 0);
  static constexpr int kSmem = kBars + 8 * (2 + 2 * kStages) + 1024;
};

// Which of a tile's (row, key) pairs are visible, for rows [q0, q0 + nq)
// and keys [k0, k0 + nk): none, some (the tile needs a mask), or all.
constexpr int kNone = 0, kSome = 1, kAll = 2;

template <bool kLse>
__device__ __forceinline__ int tile_class(const Params& p, int q0, int nq,
                                          int k0, int nk) {
  if (q0 >= p.T || k0 >= p.T) return kNone;
  const bool tail = q0 + nq > p.T || k0 + nk > p.T;
  if (kLse && !p.causal) return tail ? kSome : kAll;
  const int lo = kLse ? p.q_offset + q0 : q0;  // the first row on the key axis
  const int hi = lo + nq - 1;
  if (k0 > hi) return kNone;  // every key after every row
  if (p.window > 0 && lo - (k0 + nk - 1) >= p.window) return kNone;
  if (tail || k0 + nk - 1 > lo || (p.window > 0 && hi - k0 >= p.window)) {
    return kSome;
  }
  return kAll;
}

template <int HD, bool kLse, bool kNat>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const Params p) {
  using L = DqTiles<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sbase = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = sbase + L::kBars;
  const uint32_t bar_q_empty = bar_q + 8;
  const uint32_t bar_full = bar_q + 16;               // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 s

  // Work items (q tile, head, batch), the q tile fastest and reversed so
  // each (head, batch)'s heaviest tiles come first; block i takes items i,
  // i + G, i + 2G, ... (G = gridDim.x, coprime with the q tiles per head).
  const int n_q = (p.T + kDqRows - 1) / kDqRows;
  const int n_items = n_q * p.H * p.B;
  auto item = [&](int w, int* q0, int* h, int* b, int* kt_lo) {
    *q0 = (n_q - 1 - w % n_q) * kDqRows;
    *h = (w / n_q) % p.H;
    *b = w / (n_q * p.H);
    int kt_hi;
    kv_tile_range<kLse, kDqRows, kDqKeys>(p, *q0, kt_lo, &kt_hi);
    return max(0, kt_hi - *kt_lo + 1);  // k/v tiles
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    hopper::mbar_init(bar_q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 1);
      hopper::mbar_init(bar_empty + 8 * s, kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every load. The ring runs on across work
    // items; its phase flips at each wrap, and a stage is refilled only once
    // its empty barrier has completed (every consumer thread released it).
    // An item's Q and dO are loaded once the consumers have released the
    // last ones.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      hopper::tma_prefetch_map(&tdo);
      int stage = 0, phase = 0, q_phase = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        int q0, h, b, kt_lo;
        const int n_tiles = item(w, &q0, &h, &b, &kt_lo);
        if (n_tiles == 0) continue;
        const int kvh = h / (p.H / p.KV);
        hopper::mbar_wait(bar_q_empty, q_phase ^ 1);
        hopper::mbar_expect_tx(bar_q, 2 * L::kQTile);
        for (int c = 0; c < L::kBoxes; ++c) {
          hopper::tma_load_4d(sbase + L::kQ + c * L::kQBox, &tq, bar_q,
                              c * L::kBoxCols, h, q0, b);
          hopper::tma_load_4d(sbase + L::kDO + c * L::kQBox, &tdo, bar_q,
                              c * L::kBoxCols, h, q0, b);
        }
        q_phase ^= 1;
        for (int i = 0; i < n_tiles; ++i) {
          const int k0 = (kt_lo + i) * kDqKeys;
          hopper::mbar_wait(bar_empty + 8 * stage, phase ^ 1);
          hopper::mbar_expect_tx(bar_full + 8 * stage, 2 * L::kKTile);
          for (int c = 0; c < L::kBoxes; ++c) {
            hopper::tma_load_4d(sbase + L::kK + stage * L::kKTile + c * L::kKBox,
                                &tk, bar_full + 8 * stage, c * L::kBoxCols, kvh,
                                k0, b);
            hopper::tma_load_4d(sbase + L::kV + stage * L::kKTile + c * L::kKBox,
                                &tv, bar_full + 8 * stage, c * L::kBoxCols, kvh,
                                k0, b);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;  // this consumer warpgroup
    const int warp = (threadIdx.x / 32) & 3;
    const int g = (threadIdx.x & 31) >> 2;
    const int t4 = threadIdx.x & 3;
    const uint32_t q_tile = sbase + L::kQ + cw * kWgRows * L::kRowBytes;
    const uint32_t do_tile = sbase + L::kDO + cw * kWgRows * L::kRowBytes;
    int stage = 0, phase = 0, q_phase = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      int q0, h, b, kt_lo;
      const int n_tiles = item(w, &q0, &h, &b, &kt_lo);
      const int r0 = q0 + kWgRows * cw;  // the warpgroup's first row
      const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
      float lse2[2], delta[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long vec = (static_cast<long long>(b) * p.H + h) * p.T + row[i];
        lse2[i] = row[i] < p.T ? to_base<kNat>(p.lse[vec]) : 0.f;
        delta[i] = row[i] < p.T ? p.delta[vec] : 0.f;
      }
      float dq[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) dq[j] = 0.f;

      if (n_tiles > 0) hopper::mbar_wait(bar_q, q_phase);
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (kt_lo + i) * kDqKeys;
        const uint32_t k_tile = sbase + L::kK + stage * L::kKTile;
        const uint32_t v_tile = sbase + L::kV + stage * L::kKTile;
        hopper::mbar_wait(bar_full + 8 * stage, phase);
        const int cls = tile_class<kLse>(p, r0, kWgRows, k0, kDqKeys);
        if (cls != kNone) {
          // S = Q K^T and dP = dO V^T over the head dim, 16 columns a step;
          // s[4j + e] is row row[e / 2], key k0 + 8j + 2 t4 + e % 2
          float s[kDqKeys / 2], dp[kDqKeys / 2];
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const uint32_t at = (kk * 16 / L::kBoxCols) * L::kQBox + (kk * 16 % L::kBoxCols) * 2;
            const uint32_t bt = (kk * 16 / L::kBoxCols) * L::kKBox + (kk * 16 % L::kBoxCols) * 2;
            hopper::wgmma_m64n64k16_ss(
                s, hopper::smem_desc(q_tile + at, 16, L::kSbo, L::kLayout),
                hopper::smem_desc(k_tile + bt, 16, L::kSbo, L::kLayout), kk > 0);
            hopper::wgmma_m64n64k16_ss(
                dp, hopper::smem_desc(do_tile + at, 16, L::kSbo, L::kLayout),
                hopper::smem_desc(v_tile + bt, 16, L::kSbo, L::kLayout), kk > 0);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(s);
          hopper::fence_regs(dp);
          if (i == n_tiles - 1) hopper::mbar_arrive(bar_q_empty);  // Q and dO are read

          // dS = P (dP - delta) d(score)/d(raw), in dp
          if (p.softcap > 0.f) {
            const float cap = to_base<kNat>(p.softcap);
            const float inv = p.scale / p.softcap;
#pragma unroll
            for (int j = 0; j < kDqKeys / 2; ++j) {
              const int r = (j >> 1) & 1;
              const float t = tanhf(s[j] * inv);
              dp[j] = exp_fast<kNat>(cap * t - lse2[r]) * (dp[j] - delta[r]) *
                      (p.scale * (1.f - t * t));
            }
          } else {
            const float c = to_base<kNat>(p.scale);
#pragma unroll
            for (int j = 0; j < kDqKeys / 2; ++j) {
              const int r = (j >> 1) & 1;
              dp[j] = exp_fast<kNat>(s[j] * c - lse2[r]) * (dp[j] - delta[r]) * p.scale;
            }
          }
          if (cls == kSome) {  // masked pairs are exactly 0
#pragma unroll
            for (int j = 0; j < kDqKeys / 2; ++j) {
              const int key = k0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
              if (!visible<kLse>(p, row[(j >> 1) & 1], key)) dp[j] = 0.f;
            }
          }

          // dq += dS K, 16 keys a step: dS's A fragment for keys 16c.. is
          // the accumulators 8c..8c+7, rounded to bf16; K read N-major
          uint32_t da[kDqKeys / 4];
#pragma unroll
          for (int j = 0; j < kDqKeys / 4; ++j) da[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
          hopper::wgmma_fence();
#pragma unroll
          for (int c = 0; c < kDqKeys / 16; ++c) {
            hopper::wgmma_rs_tb<HD>(
                dq, da[4 * c], da[4 * c + 1], da[4 * c + 2], da[4 * c + 3],
                hopper::smem_desc(k_tile + c * 16 * L::kRowBytes, L::kKBox, L::kSbo,
                                  L::kLayout));
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dq);
          hopper::fence_regs(da);
        } else if (i == n_tiles - 1) {
          hopper::mbar_arrive(bar_q_empty);
        }
        hopper::mbar_arrive(bar_empty + 8 * stage);  // K and V of this stage are read
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (n_tiles > 0) q_phase ^= 1;

      // every row of the tile is written; a row with no allowed key as 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= p.T) continue;
        __nv_bfloat16* orow =
            static_cast<__nv_bfloat16*>(p.dq) + row_index(p, b, row[r], p.H, h) * HD;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * t4) =
              pack_bf16(dq[4 * c + 2 * r], dq[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

template <int HD, bool kLse, bool kNat, bool kFused>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const Params p) {
  using L = DkvTiles<HD, kFused>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* const vecs = reinterpret_cast<float*>(smem_raw + (sbase - raw) + L::kVec);
  const uint32_t bar_kv = sbase + L::kBars;
  const uint32_t bar_kv_empty = bar_kv + 8;
  const uint32_t bar_full = bar_kv + 16;              // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 s

  // Work items (k tile, KV head, batch), the k tile fastest: the first k
  // tiles have the most work. Each walks, for every query head of its GQA
  // group, the q tiles of its band.
  const int rep = p.H / p.KV;
  const int n_k = (p.T + kDkvKeys - 1) / kDkvKeys;
  const int n_items = n_k * p.KV * p.B;
  auto item = [&](int w, int* k0, int* kvh, int* b, int* qt_lo) {
    *k0 = (w % n_k) * kDkvKeys;
    *kvh = (w / n_k) % p.KV;
    *b = w / (n_k * p.KV);
    int qt_hi;
    q_tile_range<kLse, kDkvKeys, kDkvRows>(p, *k0, qt_lo, &qt_hi);
    return max(0, qt_hi - *qt_lo + 1);  // q tiles per query head
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_kv, 1);
    hopper::mbar_init(bar_kv_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 1 + 32);  // the TMA thread, the lse warp
      hopper::mbar_init(bar_empty + 8 * s, kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: its first thread issues every TMA load (an item's K and V
    // once the consumers have released the last ones, then the Q and dO
    // tiles into the ring); its second warp stores each tile's lse (in the
    // softmax's base) and delta into the same stage. Both wait on the
    // stage's empty barrier and arrive on its full one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      hopper::tma_prefetch_map(&tdo);
      int stage = 0, phase = 0, kv_phase = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        int k0, kvh, b, qt_lo;
        const int n_tiles = item(w, &k0, &kvh, &b, &qt_lo);
        if (n_tiles == 0) continue;
        hopper::mbar_wait(bar_kv_empty, kv_phase ^ 1);
        hopper::mbar_expect_tx(bar_kv, 2 * L::kKTile);
        for (int c = 0; c < L::kBoxes; ++c) {
          hopper::tma_load_4d(sbase + L::kK + c * L::kKBox, &tk, bar_kv,
                              c * L::kBoxCols, kvh, k0, b);
          hopper::tma_load_4d(sbase + L::kV + c * L::kKBox, &tv, bar_kv,
                              c * L::kBoxCols, kvh, k0, b);
        }
        kv_phase ^= 1;
        for (int hh = 0; hh < rep; ++hh) {
          const int h = kvh * rep + hh;
          for (int i = 0; i < n_tiles; ++i) {
            const int q0 = (qt_lo + i) * kDkvRows;
            hopper::mbar_wait(bar_empty + 8 * stage, phase ^ 1);
            hopper::mbar_expect_tx(bar_full + 8 * stage, 2 * L::kQTile);
            for (int c = 0; c < L::kBoxes; ++c) {
              hopper::tma_load_4d(sbase + L::kQ + stage * L::kQTile + c * L::kQBox,
                                  &tq, bar_full + 8 * stage, c * L::kBoxCols, h,
                                  q0, b);
              hopper::tma_load_4d(sbase + L::kDO + stage * L::kQTile + c * L::kQBox,
                                  &tdo, bar_full + 8 * stage, c * L::kBoxCols, h,
                                  q0, b);
            }
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      const int lane = threadIdx.x - 32;
      int stage = 0, phase = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        int k0, kvh, b, qt_lo;
        const int n_tiles = item(w, &k0, &kvh, &b, &qt_lo);
        for (int hh = 0; hh < rep; ++hh) {
          const long long vec0 = (static_cast<long long>(b) * p.H + kvh * rep + hh) * p.T;
          for (int i = 0; i < n_tiles; ++i) {
            const int q0 = (qt_lo + i) * kDkvRows;
            float* lse_s = vecs + stage * 2 * kDkvRows;
            hopper::mbar_wait(bar_empty + 8 * stage, phase ^ 1);
            for (int r = lane; r < kDkvRows; r += 32) {
              const bool in = q0 + r < p.T;
              lse_s[r] = in ? to_base<kNat>(p.lse[vec0 + q0 + r]) : 0.f;
              lse_s[kDkvRows + r] = in ? p.delta[vec0 + q0 + r] : 0.f;
            }
            hopper::mbar_arrive(bar_full + 8 * stage);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;  // this consumer warpgroup
    const int warp = (threadIdx.x / 32) & 3;
    const int g = (threadIdx.x & 31) >> 2;
    const int t4 = threadIdx.x & 3;
    const uint32_t k_tile = sbase + L::kK + cw * kWgRows * L::kRowBytes;
    const uint32_t v_tile = sbase + L::kV + cw * kWgRows * L::kRowBytes;
    // kFused: this warpgroup's dS^T tile, its 32-bit words as stored; the
    // dq exchange and its parity (flipped at every exchange, alike in both
    // warpgroups)
    const uint32_t ds_tile = sbase + L::kDs + cw * L::kDsTile;
    uint32_t* const ds_words =
        reinterpret_cast<uint32_t*>(smem_raw + (ds_tile - raw));
    float4* const xbuf = reinterpret_cast<float4*>(smem_raw + (sbase - raw) + L::kX);
    int xpar = 0;
    int stage = 0, phase = 0, kv_phase = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      int k0, kvh, b, qt_lo;
      const int n_tiles = item(w, &k0, &kvh, &b, &qt_lo);
      const int kc0 = k0 + kWgRows * cw;  // the warpgroup's first key
      const int key[2] = {kc0 + 16 * warp + g, kc0 + 16 * warp + g + 8};
      float dk[HD / 2], dv[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) dk[j] = dv[j] = 0.f;

      if (n_tiles > 0) hopper::mbar_wait(bar_kv, kv_phase);
      for (int hh = 0; hh < rep; ++hh) {
        for (int i = 0; i < n_tiles; ++i) {
          const int q0 = (qt_lo + i) * kDkvRows;
          const bool last = hh == rep - 1 && i == n_tiles - 1;
          const uint32_t q_st = sbase + L::kQ + stage * L::kQTile;
          const uint32_t do_st = sbase + L::kDO + stage * L::kQTile;
          const float* lse_s = vecs + stage * 2 * kDkvRows;
          const float* delta_s = lse_s + kDkvRows;
          hopper::mbar_wait(bar_full + 8 * stage, phase);
          const int cls = tile_class<kLse>(p, q0, kDkvRows, kc0, kWgRows);
          if (cls != kNone) {
            // S^T = K Q^T and dP^T = V dO^T; s[4j + e] is key key[e / 2],
            // query q0 + 8j + 2 t4 + e % 2
            float s[kDkvRows / 2], dp[kDkvRows / 2];
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
              const uint32_t at = (kk * 16 / L::kBoxCols) * L::kKBox + (kk * 16 % L::kBoxCols) * 2;
              const uint32_t bt = (kk * 16 / L::kBoxCols) * L::kQBox + (kk * 16 % L::kBoxCols) * 2;
              hopper::wgmma_m64n64k16_ss(
                  s, hopper::smem_desc(k_tile + at, 16, L::kSbo, L::kLayout),
                  hopper::smem_desc(q_st + bt, 16, L::kSbo, L::kLayout), kk > 0);
              hopper::wgmma_m64n64k16_ss(
                  dp, hopper::smem_desc(v_tile + at, 16, L::kSbo, L::kLayout),
                  hopper::smem_desc(do_st + bt, 16, L::kSbo, L::kLayout), kk > 0);
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(s);
            hopper::fence_regs(dp);
            if (last && !kFused) hopper::mbar_arrive(bar_kv_empty);  // K and V are read

            // P^T in s, dS^T in dp; lse and delta by column (query)
            if (p.softcap > 0.f) {
              const float cap = to_base<kNat>(p.softcap);
              const float inv = p.scale / p.softcap;
#pragma unroll
              for (int j = 0; j < kDkvRows / 2; ++j) {
                const int col = 8 * (j >> 2) + 2 * t4 + (j & 1);
                const float t = tanhf(s[j] * inv);
                s[j] = exp_fast<kNat>(cap * t - lse_s[col]);
                dp[j] = s[j] * (dp[j] - delta_s[col]) * (p.scale * (1.f - t * t));
              }
            } else {
              const float c = to_base<kNat>(p.scale);
#pragma unroll
              for (int j = 0; j < kDkvRows / 2; ++j) {
                const int col = 8 * (j >> 2) + 2 * t4 + (j & 1);
                s[j] = exp_fast<kNat>(s[j] * c - lse_s[col]);
                dp[j] = s[j] * (dp[j] - delta_s[col]) * p.scale;
              }
            }
            if (cls == kSome) {  // masked pairs are exactly 0
#pragma unroll
              for (int j = 0; j < kDkvRows / 2; ++j) {
                const int q_pos = q0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
                if (!visible<kLse>(p, q_pos, key[(j >> 1) & 1])) s[j] = dp[j] = 0.f;
              }
            }

            // dV += P^T dO and dK += dS^T Q, 16 queries a step, P^T and dS^T
            // rounded to bf16; dO and Q read N-major
            uint32_t pa[kDkvRows / 4], da[kDkvRows / 4];
#pragma unroll
            for (int j = 0; j < kDkvRows / 4; ++j) {
              pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
              da[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
            }
            if constexpr (kFused) {
              // dS^T to shared memory for dq: key row 16 warp + g (+ 8),
              // queries 8j + 2 t4.. in 16-byte chunk j, swizzled to chunk
              // j ^ (row % 8) = j ^ g
              const int r = 16 * warp + g;
#pragma unroll
              for (int j = 0; j < kDkvRows / 8; ++j) {
                ds_words[r * 32 + (j ^ g) * 4 + t4] = da[2 * j];
                ds_words[(r + 8) * 32 + (j ^ g) * 4 + t4] = da[2 * j + 1];
              }
              hopper::fence_proxy_async_smem();
            }
            hopper::wgmma_fence();
#pragma unroll
            for (int c = 0; c < kDkvRows / 16; ++c) {
              hopper::wgmma_rs_tb<HD>(
                  dv, pa[4 * c], pa[4 * c + 1], pa[4 * c + 2], pa[4 * c + 3],
                  hopper::smem_desc(do_st + c * 16 * L::kRowBytes, L::kQBox, L::kSbo,
                                    L::kLayout));
              hopper::wgmma_rs_tb<HD>(
                  dk, da[4 * c], da[4 * c + 1], da[4 * c + 2], da[4 * c + 3],
                  hopper::smem_desc(q_st + c * 16 * L::kRowBytes, L::kQBox, L::kSbo,
                                    L::kLayout));
            }
            hopper::wgmma_commit();
            if constexpr (kFused) {
              // dq += dS K over this cell's 64 keys (this warpgroup's), in
              // column chunks of kDqN: A = dS (queries as rows) read
              // transposed from the dS^T tile, B = K read N-major. Every
              // thread of the warpgroup has stored and fenced its dS^T
              // words before any issues the product. Both warpgroups hold
              // the same 64 queries: where both have live keys, each hands
              // the other the half of the chunk's columns that the other
              // adds to the float32 dq in device memory, so each element
              // is added once per cell; else the live one adds them all.
              constexpr int kDqN = L::kDqN;
              constexpr int kHalf = kDqN / 16;  // 8-column groups per half chunk
              hopper::named_bar_sync(1 + cw, 128);
              const bool pair =
                  tile_class<kLse>(p, q0, kDkvRows, k0 + kWgRows * (1 - cw), kWgRows) != kNone;
              const int dq_row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
              float* const dq_head = static_cast<float*>(p.dq) + (kvh * rep + hh) * HD;
#pragma unroll
              for (int n = 0; n < HD / kDqN; ++n) {
                float dq[kDqN / 2];
                hopper::wgmma_fence();
#pragma unroll
                for (int c = 0; c < kWgRows / 16; ++c) {
                  hopper::wgmma_ss_tt<kDqN>(
                      dq, hopper::smem_desc(ds_tile + c * 16 * 128, L::kDsTile, 1024, 1),
                      hopper::smem_desc(k_tile + n * L::kKBox + c * 16 * L::kRowBytes,
                                        L::kKBox, L::kSbo, L::kLayout),
                      c > 0);
                }
                hopper::wgmma_commit();
                hopper::wgmma_wait<0>();
                hopper::fence_regs(dq);
                if (pair) {  // column group j goes to warpgroup j / kHalf
                  const int wt = threadIdx.x & 127;
                  float4* const give = xbuf + ((cw * 2 + xpar) * kHalf) * 128 + wt;
                  const float4* const take = xbuf + (((1 - cw) * 2 + xpar) * kHalf) * 128 + wt;
#pragma unroll
                  for (int j = 0; j < kDqN / 8; ++j) {
                    if (j / kHalf != cw) {
                      give[(j % kHalf) * 128] =
                          make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
                    }
                  }
                  hopper::named_bar_sync(3, 2 * 128);
#pragma unroll
                  for (int j = 0; j < kDqN / 8; ++j) {
                    if (j / kHalf == cw) {
                      const float4 o = take[(j % kHalf) * 128];
                      dq[4 * j] += o.x;
                      dq[4 * j + 1] += o.y;
                      dq[4 * j + 2] += o.z;
                      dq[4 * j + 3] += o.w;
                    }
                  }
                  xpar ^= 1;
                }
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  if (dq_row[r] >= p.T) continue;
                  float* const o = dq_head +
                                   (static_cast<long long>(b) * p.T + dq_row[r]) * p.H * HD +
                                   n * kDqN;
#pragma unroll
                  for (int j = 0; j < kDqN / 8; ++j) {
                    if (!pair || j / kHalf == cw) {
                      atomicAdd(reinterpret_cast<float2*>(o + 8 * j + 2 * t4),
                                make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]));
                    }
                  }
                }
              }
              if (last) hopper::mbar_arrive(bar_kv_empty);  // K is read by dS K too
            }
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dv);
            hopper::fence_regs(dk);
            hopper::fence_regs(pa);
            hopper::fence_regs(da);
          } else if (last) {
            hopper::mbar_arrive(bar_kv_empty);
          }
          hopper::mbar_arrive(bar_empty + 8 * stage);  // Q, dO, lse and delta of this stage are read
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if (n_tiles > 0) kv_phase ^= 1;

      // every key of the tile is written; a key no query attends as 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (key[r] >= p.T) continue;
        const long long o = row_index(p, b, key[r], p.KV, kvh) * HD;
        __nv_bfloat16* dko = static_cast<__nv_bfloat16*>(p.dk) + o;
        __nv_bfloat16* dvo = static_cast<__nv_bfloat16*>(p.dv) + o;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          *reinterpret_cast<uint32_t*>(dko + 8 * c + 2 * t4) =
              pack_bf16(dk[4 * c + 2 * r], dk[4 * c + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvo + 8 * c + 2 * t4) =
              pack_bf16(dv[4 * c + 2 * r], dv[4 * c + 2 * r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_prep: delta (and K2c's zeroed dq) in one pass
// ---------------------------------------------------------------------------

struct PrepParams {
  const void* out;    // dense (B, T, H, hd), float32 or bf16
  const void* dout;   // the same
  const float* dlse;  // (B, H, T) or null
  float* delta;       // (B, H, T)
  float* dq;          // dense (B, T, H, hd) float32 to zero, or null
  int B, T, H;
};

constexpr int kPrepThreads = 256;

__device__ __forceinline__ void load8(const float* x, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(x)[0];
  const float4 b = reinterpret_cast<const float4*>(x)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(x);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Each row (b, t, h) of hd = 8 kG elements is read by kG neighbouring
// threads, 8 elements (16 or 32 bytes) each, summed in float32 and across
// the group by shuffles; the group's first thread writes delta[b, h, t]
// (minus dlse). With dq, each thread zeroes the dq elements it read.
template <typename Elem, int kG>
__global__ void __launch_bounds__(kPrepThreads) flash_bwd_prep_kernel(PrepParams p) {
  const long long total = static_cast<long long>(p.B) * p.T * p.H * kG;
  const int sub = threadIdx.x % kG;
  for (long long base = static_cast<long long>(blockIdx.x) * kPrepThreads; base < total;
       base += static_cast<long long>(gridDim.x) * kPrepThreads) {
    const long long v = base + threadIdx.x;  // element offset 8 v
    float acc = 0.f;
    if (v < total) {
      float o[8], d[8];
      load8(static_cast<const Elem*>(p.out) + 8 * v, o);
      load8(static_cast<const Elem*>(p.dout) + 8 * v, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(o[e], d[e], acc);
      if (p.dq != nullptr) {
        float4* z = reinterpret_cast<float4*>(p.dq + 8 * v);
        z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int s = kG / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (v < total && sub == 0) {
      const long long row = v / kG;  // (b * T + t) * H + h
      const long long h = row % p.H;
      const long long bt = row / p.H;
      const long long o = (bt / p.T * p.H + h) * p.T + bt % p.T;
      p.delta[o] = p.dlse != nullptr ? acc - p.dlse[o] : acc;
    }
  }
}

template <typename Elem>
cudaError_t launch_prep(const PrepParams& p, int hd, cudaStream_t stream) {
  const long long total = static_cast<long long>(p.B) * p.T * p.H * (hd / 8);
  const int blocks = static_cast<int>(
      std::min<long long>((total + kPrepThreads - 1) / kPrepThreads, 1 << 16));
  switch (hd) {
    case 16: flash_bwd_prep_kernel<Elem, 2><<<blocks, kPrepThreads, 0, stream>>>(p); break;
    case 32: flash_bwd_prep_kernel<Elem, 4><<<blocks, kPrepThreads, 0, stream>>>(p); break;
    case 64: flash_bwd_prep_kernel<Elem, 8><<<blocks, kPrepThreads, 0, stream>>>(p); break;
    case 128: flash_bwd_prep_kernel<Elem, 16><<<blocks, kPrepThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int heads, int threads,
                   int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kBQ - 1) / kBQ, heads, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tensor maps of q, k, v (the caller's strides) and dO (dense), each loaded
// in boxes of `q_rows` (q, dO) or `k_rows` (k, v) rows, then one persistent
// block per SM, the count made coprime with `period` (the tiles per head of
// the kernel's work items), at most one per item. A map that
// cuTensorMapEncodeTiled refuses (a stride TMA cannot take) fails the
// launch with cudaErrorInvalidValue.
template <int HD, typename Kernel>
cudaError_t launch_wg(Kernel kernel, const Params& p, int q_rows, int k_rows,
                      int smem, int period, int n_items, cudaStream_t stream) {
  using R = HeadRows<HD>;
  constexpr CUtensorMapSwizzle kSwizzle = hopper::Swizzle<R::kRowBytes>::kMap;
  const long long hd = HD;
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::make_map_bf16(&tq, p.q, HD, p.H, p.T, p.B, p.q_sh, p.q_st,
                             p.q_sb, R::kBoxCols, q_rows, kSwizzle) ||
      !hopper::make_map_bf16(&tk, p.k, HD, p.KV, p.T, p.B, p.k_sh, p.k_st,
                             p.k_sb, R::kBoxCols, k_rows, kSwizzle) ||
      !hopper::make_map_bf16(&tv, p.v, HD, p.KV, p.T, p.B, p.v_sh, p.v_st,
                             p.v_sb, R::kBoxCols, k_rows, kSwizzle) ||
      !hopper::make_map_bf16(&tdo, p.dout, HD, p.H, p.T, p.B, hd, p.H * hd,
                             static_cast<long long>(p.T) * p.H * hd, R::kBoxCols,
                             q_rows, kSwizzle)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  int blocks = sms;
  while (blocks > sms / 2 && std::gcd(blocks, period) != 1) --blocks;
  blocks = std::min(blocks, n_items);
  kernel<<<blocks, kWgThreads, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

template <int HD, bool kLse, bool kNat>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    const int smem = static_cast<int>(
        (2 * kBQ * (HD + 4) + 2 * kBK * (HD + 4) + kBQ * (kBK + 4)) *
        sizeof(float));
    return launch(flash_dq_f32_kernel<HD, kLse, kNat>, p, p.H, kFmaThreads,
                  smem, stream);
  }
  const int n_q = (p.T + kDqRows - 1) / kDqRows;
  return launch_wg<HD>(flash_dq_bf16_kernel<HD, kLse, kNat>, p, kDqRows, kDqKeys,
                       DqTiles<HD>::kSmem, n_q, n_q * p.H * p.B, stream);
}

template <int HD, bool kLse, bool kNat, bool kFused>
cudaError_t launch_dkv(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    const int smem = static_cast<int>(
        (2 * kBK * (HD + 4) + 2 * kBQ * (HD + 4) + 2 * kBK * (kBQ + 4) +
         2 * kBQ) *
        sizeof(float));
    return launch(flash_dkv_f32_kernel<HD, kLse, kNat, kFused>, p, p.KV,
                  kFmaThreads, smem, stream);
  }
  static_assert(!kFused || (!kLse && !kNat), "K2c runs the plain causal band in base 2");
  const int n_k = (p.T + kDkvKeys - 1) / kDkvKeys;
  return launch_wg<HD>(flash_dkv_bf16_kernel<HD, kLse, kNat, kFused>, p, kDkvRows,
                       kDkvKeys, DkvTiles<HD, kFused>::kSmem, n_k, n_k * p.KV * p.B,
                       stream);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int B, int T, int H, int KV, long long q_sb,
                   long long q_st, long long q_sh, long long k_sb,
                   long long k_st, long long k_sh, long long v_sb,
                   long long v_st, long long v_sh, float scale, int window,
                   float softcap, int causal, int q_offset) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.B = B;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.scale = scale;
  p.window = window;
  p.softcap = softcap;
  p.causal = causal;
  p.q_offset = q_offset;
  return p;
}

template <bool kLse, bool kNat>
int run_dq(Params p, void* dq, int hd, int dtype, void* stream) {
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return static_cast<int>(launch_dq<16, kLse, kNat>(p, dtype, s));
    case 32: return static_cast<int>(launch_dq<32, kLse, kNat>(p, dtype, s));
    case 64: return static_cast<int>(launch_dq<64, kLse, kNat>(p, dtype, s));
    case 128: return static_cast<int>(launch_dq<128, kLse, kNat>(p, dtype, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// kFused: dq is a zeroed float32 buffer the kernel adds dS K to.
template <bool kLse, bool kNat, bool kFused>
int run_dkv(Params p, void* dq, void* dk, void* dv, int hd, int dtype,
            void* stream) {
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16:
      return static_cast<int>(launch_dkv<16, kLse, kNat, kFused>(p, dtype, s));
    case 32:
      return static_cast<int>(launch_dkv<32, kLse, kNat, kFused>(p, dtype, s));
    case 64:
      return static_cast<int>(launch_dkv<64, kLse, kNat, kFused>(p, dtype, s));
    case 128:
      return static_cast<int>(launch_dkv<128, kLse, kNat, kFused>(p, dtype, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (rows 16-byte aligned). hd: 16, 32, 64
// or 128. Each returns a cudaError_t (0 = success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int T, int H,
                            int KV, int hd, long long q_sb, long long q_st,
                            long long q_sh, long long k_sb, long long k_st,
                            long long k_sh, long long v_sb, long long v_st,
                            long long v_sh, float scale, int window,
                            float softcap, int dtype, void* stream) {
  return run_dq<false, false>(
      make_params(q, k, v, dout, lse, delta, B, T, H, KV, q_sb, q_st, q_sh,
                  k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window, softcap,
                  1, 0),
      dq, hd, dtype, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int T, int H, int KV, int hd, long long q_sb,
                             long long q_st, long long q_sh, long long k_sb,
                             long long k_st, long long k_sh, long long v_sb,
                             long long v_st, long long v_sh, float scale,
                             int window, float softcap, int dtype,
                             void* stream) {
  return run_dkv<false, false, false>(
      make_params(q, k, v, dout, lse, delta, B, T, H, KV, q_sb, q_st, q_sh,
                  k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window, softcap,
                  1, 0),
      nullptr, dk, dv, hd, dtype, stream);
}

// dq: a zeroed float32 (B, T, H, hd) buffer; the kernel adds dq to it.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, int B, int T, int H, int KV, int hd,
                               long long q_sb, long long q_st, long long q_sh,
                               long long k_sb, long long k_st, long long k_sh,
                               long long v_sb, long long v_st, long long v_sh,
                               float scale, int window, float softcap,
                               int dtype, void* stream) {
  return run_dkv<false, false, true>(
      make_params(q, k, v, dout, lse, delta, B, T, H, KV, q_sb, q_st, q_sh,
                  k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window, softcap,
                  1, 0),
      dq, dk, dv, hd, dtype, stream);
}

// delta = rowsum(out * dout) - dlse (dlse may be null), dense (B, H, T)
// float32; dq, when not null, a dense float32 (B, T, H, hd) buffer zeroed in
// the same pass. out and dout dense (B, T, H, hd) in the dtype (0 =
// float32, 1 = bfloat16), 16-byte aligned.
extern "C" int flash_bwd_prep(const void* out, const void* dout,
                              const void* dlse, void* delta, void* dq, int B,
                              int T, int H, int hd, int dtype, void* stream) {
  PrepParams p;
  p.out = out;
  p.dout = dout;
  p.dlse = static_cast<const float*>(dlse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.B = B;
  p.T = T;
  p.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(launch_prep<float>(p, hd, s));
  if (dtype == 1) return static_cast<int>(launch_prep<__nv_bfloat16>(p, hd, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// causal: 0 or 1; q_offset >= 0 (read only when causal). delta already
// holds delta - dlse.
extern "C" int flash_lse_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int T,
                                int H, int KV, int hd, long long q_sb,
                                long long q_st, long long q_sh,
                                long long k_sb, long long k_st,
                                long long k_sh, long long v_sb,
                                long long v_st, long long v_sh, float scale,
                                int window, float softcap, int causal,
                                int q_offset, int dtype, void* stream) {
  return run_dq<true, false>(
      make_params(q, k, v, dout, lse, delta, B, T, H, KV, q_sb, q_st, q_sh,
                  k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window, softcap,
                  causal, q_offset),
      dq, hd, dtype, stream);
}

extern "C" int flash_lse_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int T, int H, int KV, int hd, long long q_sb,
                                 long long q_st, long long q_sh,
                                 long long k_sb, long long k_st,
                                 long long k_sh, long long v_sb,
                                 long long v_st, long long v_sh, float scale,
                                 int window, float softcap, int causal,
                                 int q_offset, int dtype, void* stream) {
  return run_dkv<true, false, false>(
      make_params(q, k, v, dout, lse, delta, B, T, H, KV, q_sb, q_st, q_sh,
                  k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window, softcap,
                  causal, q_offset),
      nullptr, dk, dv, hd, dtype, stream);
}

// flash_bwd_dq and flash_bwd_dkv in the natural base (the per-head-grid
// prototype's kernels): lse is the natural-domain lse all the same.
extern "C" int nh_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int B, int T, int H, int KV, int hd,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh,
                         float scale, int window, float softcap, int dtype,
                         void* stream) {
  return run_dq<false, true>(
      make_params(q, k, v, dout, lse, delta, B, T, H, KV, q_sb, q_st, q_sh,
                  k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window, softcap,
                  1, 0),
      dq, hd, dtype, stream);
}

extern "C" int nh_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B, int T,
                          int H, int KV, int hd, long long q_sb,
                          long long q_st, long long q_sh, long long k_sb,
                          long long k_st, long long k_sh, long long v_sb,
                          long long v_st, long long v_sh, float scale,
                          int window, float softcap, int dtype,
                          void* stream) {
  return run_dkv<false, true, false>(
      make_params(q, k, v, dout, lse, delta, B, T, H, KV, q_sb, q_st, q_sh,
                  k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, window, softcap,
                  1, 0),
      nullptr, dk, dv, hd, dtype, stream);
}
