// Flash-attention forward for Hopper (sm_90a), plain C interface: three
// entry points, each a launch of its own, over the same kernels.
//
//   flash_fwd      replaces the TPU kernel `_fwd_kernel_btd` (reached
//                  through `_flash_fwd_btd` and `_flash_btd`): causal;
//   flash_lse_fwd  replaces the TPU kernel `_fwd_kernel` (reached through
//                  `_flash_fwd` and `flash_with_lse`, the ring-attention
//                  hop): a `causal` flag and a `q_offset` that places query
//                  row i at position q_offset + i of the key axis, so the
//                  causal band (and a window) shifts with it;
// both in mingpt_distributed_tpu/ops/flash_attention.py; and
//   nh_fwd         replaces the TPU kernel `_fwd_kernel4` of the per-head-grid
//                  prototype (tools/proto_nh_kernel.py, `flash_fwd_btd`):
//                  flash_fwd's function with the softmax in the natural base.
// FlashAttention-2 online softmax in base 2 with log2(e) folded into the
// score scale (nh_fwd: base e, expf), optional sliding window (causal only,
// as in the TPU kernels) and logit soft-capping, emitting the output and the
// natural-domain log-sum-exp of every query row.
//
// The entry points run the same kernels, specialised at compile time (kLse,
// kNat): flash_fwd's instantiations test the plain causal band, with no flag
// or offset in their inner loops, flash_lse_fwd's the general one, and
// nh_fwd's the plain band in the natural base.
//
// Dead rows (q_offset > 0: no key of the chunk inside a row's band) keep
// m = -1e30 and l = 0, so they are written as out = 0 and lse = -1e30 *
// ln 2 + ln(1e-30) ~ -6.9e29: finite, and weighted exactly 0 by an lse
// merge. A q tile whose rows are all dead walks no k tile and is written
// the same way (never skipped: the output buffers are uninitialised).
//
// Layout: q (B, T, H, hd), k/v (B, T, KV, hd), addressed through the batch,
// time and head strides the caller passes (the last dim must be dense).
// Grouped-query attention reads kv head h / (H / KV) directly. out is a
// dense (B, T, H, hd) tensor in q's dtype, lse a dense (B, H, T) float32.
//
// Shared by both paths below:
//   * one thread block per (q tile of 64 rows, head, batch); the heaviest
//     (last) q tiles are launched first;
//   * the block walks the k/v tiles of 64 keys from the first tile of the
//     band to the (offset) diagonal, or every tile when not causal, staging
//     each through shared memory; tiles outside the band are never loaded;
//   * a masked score contributes exactly 0 (it is never exponentiated), so
//     a tile that is fully masked for some row (a window narrower than the
//     tile) leaves that row's m, l and acc untouched. The TPU kernel instead
//     relies on exp(NEG_INF - m) underflowing to wipe such garbage later;
//     here there is no garbage to wipe;
//   * the tail tile is masked (keys >= T read as zeros and are masked out;
//     rows >= T are computed and not stored), so any T >= 1 works;
//   * finalize: l_safe = max(l, 1e-30), out = acc / l_safe,
//     lse = m / log2(e) + log(l_safe) (natural base: m + log(l_safe)).
//
// bfloat16 inputs take the tensor cores: mma.sync m16n8k16 (bf16 in, fp32
// accumulate), four warps of 16 query rows each, the warp's Q fragments
// kept in registers, and the score accumulators reused as the A operand of
// P V after rounding P to bf16 (as the TPU kernel does; l sums the fp32 P).
// float32 inputs take float32 FMAs from shared memory (four threads per
// query row), because TF32 would not hold the float32 tolerance.
//
// What bounds it on the H100: the work is memory-bound at the card's rates
// (GPT-2 shapes in bf16: ~25 MB moved against ~6.4 GFLOP, 7.6 us at
// 3.35 TB/s). Each staged k/v tile is reused across 64 query rows, so
// device-memory traffic stays small; what limits this version is latency:
// tile loads are not pipelined (the block waits for every tile), and the
// fp32 path is bound by FMA and shared-memory issue rates. TMA loads into a
// ring of tiles with wgmma consumers are the next step.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
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

// The first and last k/v tile a q tile starting at q0 attends; lo > hi when
// the band misses the chunk. kLse: read the causal flag and the offset.
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

// Score of a raw q.k product in the softmax's base: s * scale * log2(e), or
// cap * log2(e) * tanh(s * scale / cap) under soft-capping; kNat: the same
// without log2(e).
template <bool kNat>
__device__ __forceinline__ float score(const Params& p, float s) {
  if (kNat) {
    return p.softcap > 0.f ? p.softcap * tanhf(s * (p.scale / p.softcap))
                           : s * p.scale;
  }
  return p.softcap > 0.f ? p.softcap * kLog2e * tanhf(s * (p.scale / p.softcap))
                         : s * (p.scale * kLog2e);
}

// The natural-domain lse of a row from its running max m (in the softmax's
// base) and its safe sum l.
template <bool kNat>
__device__ __forceinline__ float lse_of(float m, float l_safe) {
  return (kNat ? m : m * kInvLog2e) + logf(l_safe);
}

template <bool kLse>
__device__ __forceinline__ bool visible(const Params& p, int q_pos,
                                        int k_pos) {
  if (!kLse) {
    return k_pos <= q_pos && k_pos < p.T &&
           (p.window <= 0 || q_pos - k_pos < p.window);
  }
  if (k_pos >= p.T) return false;
  if (!p.causal) return true;
  const int qg = p.q_offset + q_pos;
  return k_pos <= qg && (p.window <= 0 || qg - k_pos < p.window);
}

// ---------------------------------------------------------------------------
// float32: FMA path
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;  // four threads per query row

template <int HD, bool kLse, bool kNat>
__global__ void __launch_bounds__(kFmaThreads) flash_fwd_f32_kernel(Params p) {
  constexpr int kLd = HD + 4;    // +4 floats: float4-aligned, conflict-free
  constexpr int kLdp = kBK + 4;
  constexpr int kGroups = HD / 16;  // float4 column groups per thread
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;
  float* ks = qs + kBQ * kLd;
  float* vs = ks + kBK * kLd;
  float* ps = vs + kBK * kLd;

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
  load_tile_f32<HD, kFmaThreads>(qs, q, p.q_st, q0, p.T);

  float m = kNegInf;
  float l = 0.f;
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

    // scores of keys k0 + sub + 4j, j = 0..15
    float s[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[row * kLd + d]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&ks[(sub + 4 * j) * kLd + d]);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    unsigned live = 0u;
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[j] = score<kNat>(p, s[j]);
      if (visible<kLse>(p, q_pos, k0 + sub + 4 * j)) {
        live |= 1u << j;
        m_tile = fmaxf(m_tile, s[j]);
      }
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);
    // 1 when both are still kNegInf
    const float alpha = exp_base<kNat>(m - m_new);

    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float pj = (live >> j) & 1u ? exp_base<kNat>(s[j] - m_new) : 0.f;
      ps[row * kLdp + sub + 4 * j] = pj;
      l_tile += pj;
    }
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 1);
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 2);
    l = l * alpha + l_tile;
    m = m_new;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      acc[g][0] *= alpha;
      acc[g][1] *= alpha;
      acc[g][2] *= alpha;
      acc[g][3] *= alpha;
    }
    // a row's probabilities are written and read by its own four threads,
    // which share a warp
    __syncwarp();

    // acc += P V over this tile; this thread owns column groups sub + 4g
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(&ps[row * kLdp + c]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = &vs[(c + cc) * kLd];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(&vrow[4 * (sub + 4 * g)]);
          acc[g][0] = fmaf(pr[cc], v4.x, acc[g][0]);
          acc[g][1] = fmaf(pr[cc], v4.y, acc[g][1]);
          acc[g][2] = fmaf(pr[cc], v4.z, acc[g][2]);
          acc[g][3] = fmaf(pr[cc], v4.w, acc[g][3]);
        }
      }
    }
    __syncwarp();  // reads of ps done before the next tile overwrites it
  }

  if (q_pos < p.T) {
    const float l_safe = fmaxf(l, 1e-30f);
    float* o = static_cast<float*>(p.out) +
               ((static_cast<long long>(b) * p.T + q_pos) * p.H + h) * HD;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 r = make_float4(acc[g][0] / l_safe, acc[g][1] / l_safe,
                                   acc[g][2] / l_safe, acc[g][3] / l_safe);
      *reinterpret_cast<float4*>(&o[4 * (sub + 4 * g)]) = r;
    }
    if (sub == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.T + q_pos] =
          lse_of<kNat>(m, l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core path (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps, 16 query rows each

template <int HD, bool kLse, bool kNat>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_bf16_kernel(Params p) {
  constexpr int kLd = HD + 8;     // +16 bytes: conflict-free fragment loads
  constexpr int kKSteps = HD / 16;  // k-steps of Q K^T over the head dim
  constexpr int kDTiles = HD / 8;   // 8-wide column tiles of the output
  constexpr int kNTiles = kBK / 8;  // 8-key column tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* ks = qs + kBQ * kLd;
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
  load_tile_bf16<HD, kMmaThreads>(qs, q, p.q_st, q0, p.T);
  __syncthreads();
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const __nv_bfloat16* lo = qs + r_lo * kLd + 16 * kk + 2 * t4;
    qf[kk][0] = ld32(lo);
    qf[kk][1] = ld32(lo + 8 * kLd);
    qf[kk][2] = ld32(lo + 8);
    qf[kk][3] = ld32(lo + 8 * kLd + 8);
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float o[kDTiles][4];
#pragma unroll
  for (int d = 0; d < kDTiles; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  int kt_lo, kt_hi;
  kv_tile_range<kLse>(p, q0, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's k/v reads are done
    load_tile_bf16<HD, kMmaThreads>(ks, k, p.k_st, k0, p.T);
    load_tile_bf16<HD, kMmaThreads>(vs, v, p.v_st, k0, p.T);
    __syncthreads();

    // S = Q K^T: s[j] holds keys 8j + 2t4 (+1) of rows r_lo, r_lo + 8
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const __nv_bfloat16* kp = ks + (8 * j + g) * kLd + 16 * kk + 2 * t4;
        mma_bf16(s[j], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], ld32(kp),
                 ld32(kp + 8));
      }
    }

    float m_tile[2] = {kNegInf, kNegInf};
    unsigned live[2] = {0u, 0u};  // bit 2j + e: element (j, e) of that row
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[j][e] = score<kNat>(p, s[j][e]);
        if (visible<kLse>(p, q_pos[i], k0 + 8 * j + 2 * t4 + (e & 1))) {
          live[i] |= 1u << (2 * j + (e & 1));
          m_tile[i] = fmaxf(m_tile[i], s[j][e]);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 1));
      m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 2));
      const float m_new = fmaxf(m[i], m_tile[i]);
      alpha[i] = exp_base<kNat>(m[i] - m_new);  // 1 when both are still kNegInf
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float pj = (live[i] >> (2 * j + (e & 1))) & 1u
                             ? exp_base<kNat>(s[j][e] - m[i]) : 0.f;
        s[j][e] = pj;
        l[i] += pj;
      }
    }
#pragma unroll
    for (int d = 0; d < kDTiles; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P V, 16 keys per step: P's A fragment is two score tiles
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        uint32_t b0, b1;
        b_frag_rows(vs + 16 * kc * kLd + 8 * d, kLd, g, t4, &b0, &b1);
        mma_bf16(o[d], a0, a1, a2, a3, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (q_pos[i] >= p.T) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow =
        static_cast<__nv_bfloat16*>(p.out) +
        ((static_cast<long long>(b) * p.T + q_pos[i]) * p.H + h) * HD;
#pragma unroll
    for (int d = 0; d < kDTiles; ++d) {
      *reinterpret_cast<uint32_t*>(orow + 8 * d + 2 * t4) =
          pack_bf16(o[d][2 * i] / l_safe, o[d][2 * i + 1] / l_safe);
    }
    if (t4 == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.T + q_pos[i]] =
          lse_of<kNat>(m[i], l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int threads, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kBQ - 1) / kBQ, p.H, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, bool kLse, bool kNat>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(
      (kBQ * (HD + 4) + 2 * kBK * (HD + 4) + kBQ * (kBK + 4)) * sizeof(float));
  return launch(flash_fwd_f32_kernel<HD, kLse, kNat>, p, kFmaThreads, smem,
                stream);
}

template <int HD, bool kLse, bool kNat>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>((kBQ + 2 * kBK) * (HD + 8) *
                                    sizeof(__nv_bfloat16));
  return launch(flash_fwd_bf16_kernel<HD, kLse, kNat>, p, kMmaThreads, smem,
                stream);
}

template <bool kLse, bool kNat>
cudaError_t dispatch(const Params& p, int hd, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    switch (hd) {
      case 16: return launch_f32<16, kLse, kNat>(p, s);
      case 32: return launch_f32<32, kLse, kNat>(p, s);
      case 64: return launch_f32<64, kLse, kNat>(p, s);
      case 128: return launch_f32<128, kLse, kNat>(p, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: return launch_bf16<16, kLse, kNat>(p, s);
      case 32: return launch_bf16<32, kLse, kNat>(p, s);
      case 64: return launch_bf16<64, kLse, kNat>(p, s);
      case 128: return launch_bf16<128, kLse, kNat>(p, s);
    }
  }
  return cudaErrorInvalidValue;
}

template <bool kLse, bool kNat>
int run(const void* q, const void* k, const void* v, void* out, void* lse,
        int B, int T, int H, int KV, int hd, long long q_sb, long long q_st,
        long long q_sh, long long k_sb, long long k_st, long long k_sh,
        long long v_sb, long long v_st, long long v_sh, float scale,
        int window, float softcap, int causal, int q_offset, int dtype,
        void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
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
  return static_cast<int>(
      dispatch<kLse, kNat>(p, hd, dtype, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (rows 16-byte aligned). hd: 16, 32, 64
// or 128. Each returns a cudaError_t (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int T, int H, int KV,
                         int hd, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, float scale, int window,
                         float softcap, int dtype, void* stream) {
  return run<false, false>(q, k, v, out, lse, B, T, H, KV, hd, q_sb, q_st,
                           q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale,
                           window, softcap, 1, 0, dtype, stream);
}

// causal: 0 or 1; q_offset >= 0 (read only when causal).
extern "C" int flash_lse_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int T, int H,
                             int KV, int hd, long long q_sb, long long q_st,
                             long long q_sh, long long k_sb, long long k_st,
                             long long k_sh, long long v_sb, long long v_st,
                             long long v_sh, float scale, int window,
                             float softcap, int causal, int q_offset,
                             int dtype, void* stream) {
  return run<true, false>(q, k, v, out, lse, B, T, H, KV, hd, q_sb, q_st,
                          q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale,
                          window, softcap, causal, q_offset, dtype, stream);
}

// flash_fwd in the natural base (the per-head-grid prototype's kernel).
extern "C" int nh_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int B, int T, int H, int KV, int hd,
                      long long q_sb, long long q_st, long long q_sh,
                      long long k_sb, long long k_st, long long k_sh,
                      long long v_sb, long long v_st, long long v_sh,
                      float scale, int window, float softcap, int dtype,
                      void* stream) {
  return run<false, true>(q, k, v, out, lse, B, T, H, KV, hd, q_sb, q_st,
                          q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale,
                          window, softcap, 1, 0, dtype, stream);
}
