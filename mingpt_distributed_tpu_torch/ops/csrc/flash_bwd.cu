// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, reached through seven entry points, each a launch of its own.
//
//   flash_bwd_dq      replaces the TPU kernel `_dq_kernel_btd`,
//   flash_bwd_dkv     replaces the TPU kernel `_dkv_kernel_btd`,
// reached through `_flash_bwd_btd` and the custom VJP of `_flash_btd`
// (causal);
//   flash_bwd_fused   replaces the TPU kernel `_dqkv_kernel_btd` (K2c),
// reached through `_flash_bwd_btd_fused` when FLASH_FUSED_BWD=1: dq, dk and
// dv in one pass (below);
//   flash_lse_bwd_dq  replaces the TPU kernel `_dq_kernel`,
//   flash_lse_bwd_dkv replaces the TPU kernel `_dkv_kernel`,
// reached through `_flash_bwd` and the custom VJP of `flash_with_lse` (the
// ring-attention hop), which add a `causal` flag and a `q_offset` placing
// query row i at key position q_offset + i; all in
// mingpt_distributed_tpu/ops/flash_attention.py; and
//   nh_bwd_dq         replaces the TPU kernel `_dq_kernel4`,
//   nh_bwd_dkv        replaces the TPU kernel `_dkv_kernel4`,
// of the per-head-grid prototype (tools/proto_nh_kernel.py,
// `flash_bwd_btd`): flash_bwd_dq/_dkv with the softmax in the natural base.
// The lse cotangent of `flash_with_lse` reaches them folded into delta by
// the caller (delta' = delta - dlse, a plain tensor op, as `_flash_bwd`
// does). Dead rows (no key inside the offset band) get p = 0 structurally,
// so dq = 0 there and they add nothing to dk/dv, whatever their lse. The
// entry points run the same kernels, specialised at compile time (kLse,
// kNat, kFused): flash_bwd_*'s instantiations test the plain causal band,
// with no flag or offset in their inner loops, flash_lse_bwd_*'s the general
// one, nh_bwd_*'s the plain band in the natural base. Like the TPU kernels,
// they recompute the probabilities from the forward's log-sum-exp instead
// of storing the attention matrix, in base 2 with log2(e) folded into the
// score scale (nh_bwd_*: base e, expf):
//   p  = exp2(s * scale * log2e - lse * log2e) on allowed pairs, exactly 0
//        on masked ones (never exponentiated);
//   dp = dO V^T;  ds = p (dp - delta) * scale, times (1 - t^2) under
//        soft-capping, with t the unmasked tanh(s * scale / cap);
//   dq = ds K;  dk = ds^T Q;  dv = p^T dO.
// delta = rowsum(out * dO) is computed by the caller (a plain tensor op, as
// the JAX package does outside its kernels).
//
// Layout: q (B, T, H, hd), k/v (B, T, KV, hd), addressed through the batch,
// time and head strides the caller passes (the last dim dense); dO, dq a
// dense (B, T, H, hd), dk/dv a dense (B, T, KV, hd); lse and delta dense
// (B, H, T) float32. Grouped-query attention reads kv head h / (H / KV).
//
// flash_bwd_dq: one block per (q tile of 64 rows, head, batch), heaviest
// (last) tiles first. It stages its Q and dO tile once and walks the k/v
// tiles of the band, accumulating dq in float32.
//
// flash_bwd_dkv: one block per (k tile of 64 keys, KV head, batch). It stages
// its K and V tile once, then loops over the query heads of the GQA group
// and, for each, over the q tiles of the band (rows i with q_offset + i in
// [k0, k0 + 64 + window - 1), or every row when not causal), accumulating
// dk and dv in float32. The group sum stays inside the block: no atomics,
// and the result does not depend on scheduling.
//
// flash_bwd_fused: flash_bwd_dkv's blocks (kFused), which also turn each
// cell's dS into dq: after a q tile's dk/dv products the block holds that
// tile's dS (64 queries x 64 keys) in shared memory and adds dS K to a
// float32 dq buffer in device memory with atomic adds (red.global.add.f32).
// The TPU kernel keeps the whole head's dq in VMEM across its k-tile sweep
// (`dq_all_scr`); T * hd * 4 bytes (256 KB at T=1024, hd=64) does not fit
// in shared memory, and the blocks of one q tile's k tiles run on other SMs
// in no order. The caller zeroes the buffer and casts it to q's dtype. S,
// P and dP are computed once per cell, where flash_bwd_dq and
// flash_bwd_dkv each compute them: 5 products of 2 * hd operations per
// allowed pair in place of 7. The order of the atomic sums is not fixed, so
// a float32 dq is reproducible only to a few ulps.
//
// Tail tiles are masked (rows at or past T read as zeros, are never
// allowed, and are not stored), so any T >= 1 works.
//
// bfloat16 inputs take the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate; four warps of 16 rows each). As the TPU kernels do, P is
// rounded to bf16 before P^T dO and dS before dS K and dS^T Q. float32 inputs
// take float32 FMAs from shared memory (four threads per row), because TF32
// would not hold the float32 tolerance.
//
// What bounds it on the H100: at GPT-2 shapes in bf16 the work is 3 (dq) and
// 4 (dk/dv) products of 2 * hd operations per allowed pair, against ~130-150
// MB moved: about 0.04-0.05 ms either way at the card's peak rates. What
// limits this first version is latency: tile loads are not pipelined (every
// block waits for each tile), each kernel recomputes S and dP on its own, and
// the fp32 path is bound by FMA and shared-memory issue rates. TMA loads into
// a ring of tiles and wgmma are the next steps. flash_bwd_fused does 5
// products per pair (0.065 ms at the card's bf16 peak at B=16, T=1024,
// H=12, hd=64) but adds one float32 atomic per dq element per cell: 4 * hd
// bytes per query per k tile of its band (~430 MB there), resolved in L2.

#include "flash_common.cuh"

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

// The k/v tiles a q tile starting at q0 attends; lo > hi when the band
// misses the chunk.
template <bool kLse>
__device__ __forceinline__ void kv_tile_range(const Params& p, int q0,
                                              int* lo, int* hi) {
  if (kLse && !p.causal) {
    *lo = 0;
    *hi = (p.T - 1) / kBK;
    return;
  }
  const int qg = kLse ? p.q_offset + q0 : q0;  // the tile's first row on the key axis
  const int k_first = p.window > 0 ? max(0, qg - (p.window - 1)) : 0;
  *lo = k_first / kBK;
  *hi = min(qg + kBQ - 1, p.T - 1) / kBK;
}

// The q tiles that attend a k tile starting at k0; lo > hi when none does.
template <bool kLse>
__device__ __forceinline__ void q_tile_range(const Params& p, int k0,
                                             int* lo, int* hi) {
  if (!kLse) {
    const int q_last =
        p.window > 0 ? min(p.T - 1, k0 + kBK - 1 + p.window - 1) : p.T - 1;
    *lo = k0 / kBQ;
    *hi = q_last / kBQ;
    return;
  }
  if (!p.causal) {
    *lo = 0;
    *hi = (p.T - 1) / kBQ;
    return;
  }
  const int q_last =
      p.window > 0 ? min(p.T - 1, k0 + kBK - 1 + p.window - 1 - p.q_offset)
                   : p.T - 1;
  *lo = max(0, k0 - p.q_offset) / kBQ;
  *hi = q_last < 0 ? -1 : q_last / kBQ;
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
  kv_tile_range<kLse>(p, q0, &kt_lo, &kt_hi);
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
  q_tile_range<kLse>(p, k0, &qt_lo, &qt_hi);
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
// bfloat16: tensor-core path (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps, 16 rows each

// A fragment of rows r_lo, r_lo + 8 and k-columns 16kk.. of a row-major
// bf16 tile in shared memory.
__device__ __forceinline__ void a_frag(const __nv_bfloat16* m, int ld,
                                       int r_lo, int kk, int t4,
                                       uint32_t (&a)[4]) {
  const __nv_bfloat16* lo = m + r_lo * ld + 16 * kk + 2 * t4;
  a[0] = ld32(lo);
  a[1] = ld32(lo + 8 * ld);
  a[2] = ld32(lo + 8);
  a[3] = ld32(lo + 8 * ld + 8);
}

template <int HD, bool kLse, bool kNat>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_bf16_kernel(Params p) {
  constexpr int kLd = HD + 8;       // +16 bytes: conflict-free fragment loads
  constexpr int kKSteps = HD / 16;  // k-steps over the head dim
  constexpr int kDTiles = HD / 8;   // 8-wide column tiles of dq
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* dos = qs + kBQ * kLd;
  __nv_bfloat16* ks = dos + kBQ * kLd;
  __nv_bfloat16* vs = ks + kBK * kLd;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const int r_lo = 16 * warp + g;  // this thread's rows: r_lo and r_lo + 8
  const int q_pos[2] = {q0 + r_lo, q0 + r_lo + 8};

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                              row_index(p, b, 0, p.H, h) * HD;
  load_tile_bf16<HD, kMmaThreads>(qs, q, p.q_st, q0, p.T);
  load_tile_bf16<HD, kMmaThreads>(dos, dout, static_cast<long long>(p.H) * HD,
                                  q0, p.T);
  __syncthreads();
  uint32_t qf[kKSteps][4], of[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    a_frag(qs, kLd, r_lo, kk, t4, qf[kk]);
    a_frag(dos, kLd, r_lo, kk, t4, of[kk]);
  }
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long vec = (static_cast<long long>(b) * p.H + h) * p.T + q_pos[i];
    lse2[i] = q_pos[i] < p.T ? to_base<kNat>(p.lse[vec]) : 0.f;
    delta[i] = q_pos[i] < p.T ? p.delta[vec] : 0.f;
  }

  float dq[kDTiles][4];
#pragma unroll
  for (int d = 0; d < kDTiles; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  int kt_lo, kt_hi;
  kv_tile_range<kLse>(p, q0, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's k/v reads are done
    load_tile_bf16<HD, kMmaThreads>(ks, k, p.k_st, k0, p.T);
    load_tile_bf16<HD, kMmaThreads>(vs, v, p.v_st, k0, p.T);
    __syncthreads();

    // 16 keys at a time: S and dP for two 8-key column tiles, then dS as
    // the A operand of dS K
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kc + jj;
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          const int off = (8 * j + g) * kLd + 16 * kk + 2 * t4;
          mma_bf16(s[jj], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                   ld32(ks + off), ld32(ks + off + 8));
          mma_bf16(dp[jj], of[kk][0], of[kk][1], of[kk][2], of[kk][3],
                   ld32(vs + off), ld32(vs + off + 8));
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = k0 + 8 * (2 * kc + jj) + 2 * t4 + (e & 1);
          float dfac;
          const float s2 = score<kNat>(p, s[jj][e], &dfac);
          s[jj][e] = visible<kLse>(p, q_pos[i], key)
                         ? exp_base<kNat>(s2 - lse2[i]) * (dp[jj][e] - delta[i]) * dfac
                         : 0.f;
        }
      }
      const uint32_t a0 = pack_bf16(s[0][0], s[0][1]);
      const uint32_t a1 = pack_bf16(s[0][2], s[0][3]);
      const uint32_t a2 = pack_bf16(s[1][0], s[1][1]);
      const uint32_t a3 = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        uint32_t b0, b1;
        b_frag_rows(ks + 16 * kc * kLd + 8 * d, kLd, g, t4, &b0, &b1);
        mma_bf16(dq[d], a0, a1, a2, a3, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (q_pos[i] >= p.T) continue;
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.dq) +
                          row_index(p, b, q_pos[i], p.H, h) * HD;
#pragma unroll
    for (int d = 0; d < kDTiles; ++d) {
      *reinterpret_cast<uint32_t*>(orow + 8 * d + 2 * t4) =
          pack_bf16(dq[d][2 * i], dq[d][2 * i + 1]);
    }
  }
}

template <int HD, bool kLse, bool kNat, bool kFused>
__global__ void __launch_bounds__(kMmaThreads) flash_dkv_bf16_kernel(Params p) {
  constexpr int kLd = HD + 8;
  constexpr int kKSteps = HD / 16;
  constexpr int kDTiles = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* vs = ks + kBK * kLd;
  __nv_bfloat16* qs = vs + kBK * kLd;
  __nv_bfloat16* dos = qs + kBQ * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kBQ * kLd);
  float* delta_s = lse_s + kBQ;
  // kFused: the cell's dS, queries x keys (row stride kBK + 8)
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(delta_s + kBQ);
  constexpr int kLdS = kBK + 8;

  const int k0 = blockIdx.x * kBK;  // the first k tiles have the most work
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.H / p.KV;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const int r_lo = 16 * warp + g;  // this thread's keys: r_lo and r_lo + 8
  const int k_pos[2] = {k0 + r_lo, k0 + r_lo + 8};

  load_tile_bf16<HD, kMmaThreads>(
      ks, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh,
      p.k_st, k0, p.T);
  load_tile_bf16<HD, kMmaThreads>(
      vs, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh,
      p.v_st, k0, p.T);

  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int d = 0; d < kDTiles; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }

  int qt_lo, qt_hi;
  q_tile_range<kLse>(p, k0, &qt_lo, &qt_hi);
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    const __nv_bfloat16* q =
        static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout) +
                                row_index(p, b, 0, p.H, h) * HD;
    const long long vec0 = (static_cast<long long>(b) * p.H + h) * p.T;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's q/dO reads are done
      load_tile_bf16<HD, kMmaThreads>(qs, q, p.q_st, q0, p.T);
      load_tile_bf16<HD, kMmaThreads>(dos, dout,
                                      static_cast<long long>(p.H) * HD, q0,
                                      p.T);
      for (int i = threadIdx.x; i < kBQ; i += kMmaThreads) {
        const bool in = q0 + i < p.T;
        lse_s[i] = in ? to_base<kNat>(p.lse[vec0 + q0 + i]) : 0.f;
        delta_s[i] = in ? p.delta[vec0 + q0 + i] : 0.f;
      }
      __syncthreads();

      // 16 queries at a time: S^T = K Q^T and dP^T = V dO^T for two 8-query
      // column tiles, then P^T and dS^T as the A operands of P^T dO and
      // dS^T Q
#pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) {
        float s[2][4], dp[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kc + jj;
          s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
          dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kKSteps; ++kk) {
            uint32_t ka[4], va[4];
            a_frag(ks, kLd, r_lo, kk, t4, ka);
            a_frag(vs, kLd, r_lo, kk, t4, va);
            const int off = (8 * j + g) * kLd + 16 * kk + 2 * t4;
            mma_bf16(s[jj], ka[0], ka[1], ka[2], ka[3], ld32(qs + off),
                     ld32(qs + off + 8));
            mma_bf16(dp[jj], va[0], va[1], va[2], va[3], ld32(dos + off),
                     ld32(dos + off + 8));
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int qc = 8 * (2 * kc + jj) + 2 * t4 + (e & 1);
            float dfac;
            const float s2 = score<kNat>(p, s[jj][e], &dfac);
            const bool live = visible<kLse>(p, q0 + qc, k_pos[i]);
            const float pv = live ? exp_base<kNat>(s2 - lse_s[qc]) : 0.f;
            dp[jj][e] = live ? pv * (dp[jj][e] - delta_s[qc]) * dfac : 0.f;
            s[jj][e] = pv;
            if (kFused) {
              // rounded to bf16 for dS K, as it is for dS^T Q
              dss[qc * kLdS + r_lo + 8 * i] = __float2bfloat16(dp[jj][e]);
            }
          }
        }
        const uint32_t pa0 = pack_bf16(s[0][0], s[0][1]);
        const uint32_t pa1 = pack_bf16(s[0][2], s[0][3]);
        const uint32_t pa2 = pack_bf16(s[1][0], s[1][1]);
        const uint32_t pa3 = pack_bf16(s[1][2], s[1][3]);
        const uint32_t da0 = pack_bf16(dp[0][0], dp[0][1]);
        const uint32_t da1 = pack_bf16(dp[0][2], dp[0][3]);
        const uint32_t da2 = pack_bf16(dp[1][0], dp[1][1]);
        const uint32_t da3 = pack_bf16(dp[1][2], dp[1][3]);
#pragma unroll
        for (int d = 0; d < kDTiles; ++d) {
          uint32_t b0, b1;
          b_frag_rows(dos + 16 * kc * kLd + 8 * d, kLd, g, t4, &b0, &b1);
          mma_bf16(dv[d], pa0, pa1, pa2, pa3, b0, b1);
          b_frag_rows(qs + 16 * kc * kLd + 8 * d, kLd, g, t4, &b0, &b1);
          mma_bf16(dk[d], da0, da1, da2, da3, b0, b1);
        }
      }

      if (kFused) {
        // dq += dS K over this cell: warp w's queries q0 + 16w + g (+ 8),
        // every column, added to the float32 dq in device memory
        __syncthreads();  // every warp's dS is written
        uint32_t da[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) a_frag(dss, kLdS, r_lo, kk, t4, da[kk]);
        float* o[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[i] = q0 + r_lo + 8 * i < p.T
                     ? static_cast<float*>(p.dq) +
                           row_index(p, b, q0 + r_lo + 8 * i, p.H, h) * HD
                     : nullptr;
        }
#pragma unroll
        for (int d = 0; d < kDTiles; ++d) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            uint32_t b0, b1;
            b_frag_rows(ks + 16 * kk * kLd + 8 * d, kLd, g, t4, &b0, &b1);
            mma_bf16(acc, da[kk][0], da[kk][1], da[kk][2], da[kk][3], b0, b1);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (o[i] == nullptr) continue;
            atomicAdd(o[i] + 8 * d + 2 * t4, acc[2 * i]);
            atomicAdd(o[i] + 8 * d + 2 * t4 + 1, acc[2 * i + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (k_pos[i] >= p.T) continue;
    const long long r = row_index(p, b, k_pos[i], p.KV, kvh) * HD;
    __nv_bfloat16* dko = static_cast<__nv_bfloat16*>(p.dk) + r;
    __nv_bfloat16* dvo = static_cast<__nv_bfloat16*>(p.dv) + r;
#pragma unroll
    for (int d = 0; d < kDTiles; ++d) {
      *reinterpret_cast<uint32_t*>(dko + 8 * d + 2 * t4) =
          pack_bf16(dk[d][2 * i], dk[d][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvo + 8 * d + 2 * t4) =
          pack_bf16(dv[d][2 * i], dv[d][2 * i + 1]);
    }
  }
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

template <int HD, bool kLse, bool kNat>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    const int smem = static_cast<int>(
        (2 * kBQ * (HD + 4) + 2 * kBK * (HD + 4) + kBQ * (kBK + 4)) *
        sizeof(float));
    return launch(flash_dq_f32_kernel<HD, kLse, kNat>, p, p.H, kFmaThreads,
                  smem, stream);
  }
  const int smem =
      static_cast<int>((2 * kBQ + 2 * kBK) * (HD + 8) * sizeof(__nv_bfloat16));
  return launch(flash_dq_bf16_kernel<HD, kLse, kNat>, p, p.H, kMmaThreads,
                smem, stream);
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
  const int smem = static_cast<int>(
      (2 * kBK + 2 * kBQ) * (HD + 8) * sizeof(__nv_bfloat16) +
      2 * kBQ * sizeof(float) +
      (kFused ? kBQ * (kBK + 8) * sizeof(__nv_bfloat16) : 0));
  return launch(flash_dkv_bf16_kernel<HD, kLse, kNat, kFused>, p, p.KV,
                kMmaThreads, smem, stream);
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
