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
// This file builds the library of the float32 and bfloat16 instances.
// flash_fwd_f16.cu includes it with FLASH_F16 defined and builds the
// float16 instances of the tensor-core kernel alone (flash_fwd and
// flash_lse_fwd; the prototype's nh_fwd keeps float32 and bfloat16, as its
// JAX tool does): the same source and arithmetic, float16 tensor maps and
// wgmma operands (.f16), P rounded to float16 before P V as the TPU kernel
// rounds it to the input dtype, out stored in float16; lse stays float32.
// Each library takes its own dtype codes (see launch_hd) and refuses any
// other.
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
//   * the work is (q tile, head, batch) items, the heaviest (last) q tiles
//     first: one thread block each in the fp32 path, persistent blocks in
//     the 16-bit (bf16, fp16) path;
//   * the block walks the k/v tiles from the first tile of the band to the
//     (offset) diagonal, or every tile when not causal, staging each
//     through shared memory; tiles outside the band are never loaded;
//   * a masked score contributes exactly 0 (it is never exponentiated, or
//     is -inf, whose exponential is 0), so a tile that is fully masked for
//     some row (a window narrower than the tile) leaves that row's m, l and
//     acc untouched. The TPU kernel instead relies on exp(NEG_INF - m)
//     underflowing to wipe such garbage later; here there is no garbage to
//     wipe;
//   * the tail tile is masked (keys >= T read as zeros and are masked out;
//     rows >= T are computed and not stored), so any T >= 1 works;
//   * finalize: l_safe = max(l, 1e-30), out = acc / l_safe,
//     lse = m / log2(e) + log(l_safe) (natural base: m + log(l_safe)).
//
// bfloat16 and float16 inputs take Hopper's tensor cores, warp-specialised
// (FA3's shape; one kernel body over the 16-bit element type E):
// persistent blocks of 384 threads, one per SM, each walking work
// items of 128 query rows (a block's start-up, Q load and epilogue cost
// about as much as a light item's products, so blocks stay resident and
// the next item's loads run under this item's epilogue). One producer
// warpgroup (its registers given to the consumers by setmaxnreg) has one
// thread issue TMA loads: an item's Q tile once, then each 128-key K and V
// tile (64 keys at hd 256) into a ring of two stages guarded by full and
// empty mbarriers. Two consumer warpgroups of 64 query rows each compute
// S = Q K^T by wgmma m64n128k16 (m64n64k16 at hd 256) from shared memory
// (both K-major), the online softmax in registers, and O += P V by wgmma
// with P from registers (rounded to E, as the TPU kernel rounds it to the
// input dtype; l sums the fp32 P) and V from shared memory through the
// transpose bit; then release the stage. Two warpgroups, not three: with
// 128 keys per tile a consumer holds S (64 floats), O (up to 64 at hd 128)
// and P (32 registers); three would leave 160 registers a thread and spill
// at hd 128. While one warpgroup runs its softmax the other's products keep
// the tensor cores busy. Masks are applied only to tiles that need them
// (the diagonal, the window's edge, the tail, an offset band), decided per
// tile and warpgroup; the interior tiles run no mask. Tensor maps describe
// q, k and v as (hd, heads, T, B) with the caller's strides, in boxes of
// box_cols(hd) columns swizzled to their bytes (32 B at hd 16, 64 at 32,
// 128 at 64; two 64-column boxes at 128, four at 256; five 16-column boxes
// at 80, three of 32 at 96); TMA fills keys and rows past T with zeros. At
// hd 256 a consumer holds O (128 floats), S and P of a 64-key tile (32 and
// 16 registers). Other widths from 8 to 256 reach these kernels zero-padded
// to the next instance by the wrapper (ops/flash_attention.py).
// float32 inputs take float32 FMAs from shared memory (four threads per
// query row; 217 KB of tiles at hd 256), because TF32 would not hold the
// float32 tolerance.
//
// What bounds it on the H100: the bf16 (and fp16) work is memory-bound at
// the card's rates (GPT-2 shapes: ~25 MB moved against ~6.4 GFLOP, 7.6 us at
// 3.35 TB/s), with the exponentials (one per allowed pair, 16 per clock
// per SM) close behind at hd 64. Each K/V tile is loaded once per 128
// query rows, so device-memory traffic stays small; what the design
// attacks is latency: loads run a tile ahead of the products, and two
// warpgroups overlap one's softmax with the other's products. The fp32
// path is bound by FMA and shared-memory issue rates.

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

// The first and last k/v tile (of BK keys) a q tile of BQ rows starting at
// q0 attends; lo > hi when the band misses the chunk. kLse: read the causal
// flag and the offset.
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

// score() over a tile of raw products, the soft-capping test hoisted out
// of the loop (a select inside it would evaluate tanhf on every score).
template <bool kNat, int N>
__device__ __forceinline__ void scores(const Params& p, float (&s)[N]) {
  if (p.softcap > 0.f) {
    const float cap = kNat ? p.softcap : p.softcap * kLog2e;
    const float inv = p.scale / p.softcap;
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = cap * tanhf(s[j] * inv);
  } else {
    const float c = kNat ? p.scale : p.scale * kLog2e;
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] *= c;
  }
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
  load_tile_f32<HD, kBQ, kFmaThreads>(qs, q, p.q_st, q0, p.T);

  float m = kNegInf;
  float l = 0.f;
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
    load_tile_f32<HD, kBK, kFmaThreads>(ks, k, p.k_st, k0, p.T);
    load_tile_f32<HD, kBK, kFmaThreads>(vs, v, p.v_st, k0, p.T);
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
// bfloat16 and float16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

// The dtype code of this library's 16-bit instances and their element type:
// bfloat16 (1) beside float32 (0), or with FLASH_F16 (flash_fwd_f16.cu)
// float16 (2) alone.
#ifdef FLASH_F16
using Elem16 = __half;
constexpr int kCode16 = 2;
constexpr bool kWithF32 = false;
#else
using Elem16 = __nv_bfloat16;
constexpr int kCode16 = 1;
constexpr bool kWithF32 = true;
#endif

constexpr int kWgQ = 128;        // query rows per work item: two warpgroups
constexpr int kWgRows = 64;      // query rows per consumer warpgroup
constexpr int kWgThreads = 384;  // the producer warpgroup, two consumers
constexpr int kConsumers = 256;  // consumer threads: each releases a stage

// Shared-memory layout of one block (byte offsets; every tile 1024-aligned,
// as the 128-byte swizzle repeats every 1024 bytes). A head is boxes of
// box_cols(HD) columns, each a (rows x kRowBytes) tile of its own: hd 128
// two boxes of 64, hd 80 five of 16. K/V tiles hold 128 keys, 64 at hd 256:
// there Q (64 KB) and two stages of 128-key K and V (256 KB) would exceed
// the 227 KB a block may use, and the 64-key plan takes 192 KB.
template <int HD>
struct Tiles {
  static constexpr int kStages = 2;  // k/v tiles in the ring
  static constexpr int kKeys = HD > 128 ? 64 : 128;  // keys per k/v tile
  static constexpr int kBoxCols = box_cols(HD);
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr int kLayout = hopper::Swizzle<kRowBytes>::kLayout;
  static constexpr int kQBox = kWgQ * kRowBytes;
  static constexpr int kKBox = kKeys * kRowBytes;
  static constexpr int kKVBytes = kKBox * kBoxes;  // one K (or V) tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBox * kBoxes;
  static constexpr int kV = kK + kStages * kKVBytes;
  // the barriers: q full and empty, then full[] and empty[] of the ring
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kSmem = kBars + 8 * (2 + 2 * kStages) + 1024;  // + align
};

// Whether every (row, key) pair of a warpgroup's rows from r0 and the
// k tile of kKeys keys from k0 is visible: then the tile needs no mask.
template <bool kLse, int kKeys>
__device__ __forceinline__ bool tile_unmasked(const Params& p, int r0, int k0) {
  if (k0 + kKeys > p.T) return false;  // the tail
  if (kLse && !p.causal) return true;
  const int qg = kLse ? p.q_offset + r0 : r0;  // the first row on the key axis
  return k0 + kKeys - 1 <= qg &&               // below the diagonal
         (p.window <= 0 || qg + kWgRows - 1 - k0 < p.window);  // the window
}

// The kernel's body over the 16-bit element type E; the kernels below
// (one name per type) run it.
template <typename E, int HD, bool kLse, bool kNat>
__device__ __forceinline__ void fwd_wg(const CUtensorMap& tq, const CUtensorMap& tk,
                                       const CUtensorMap& tv, const Params p) {
  using L = Tiles<HD>;
  constexpr int kKeys = L::kKeys;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const uint32_t bar_q = sbase + L::kBars;
  const uint32_t bar_q_empty = bar_q + 8;
  const uint32_t bar_full = bar_q + 16;                  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * L::kStages;  // + 8 s

  // Work items (q tile, head, batch), the q tile fastest and reversed so
  // each (head, batch)'s heaviest tiles come first; block i takes items i,
  // i + G, i + 2G, ... (G = gridDim.x, coprime with the q tiles per head,
  // so every block walks tiles of every weight).
  const int n_q = (p.T + kWgQ - 1) / kWgQ;
  const int n_items = n_q * p.H * p.B;
  auto item = [&](int w, int* q0, int* h, int* b, int* kt_lo) {
    *q0 = (n_q - 1 - w % n_q) * kWgQ;
    *h = (w / n_q) % p.H;
    *b = w / (n_q * p.H);
    int kt_hi;
    kv_tile_range<kLse, kWgQ, kKeys>(p, *q0, kt_lo, &kt_hi);
    return max(0, kt_hi - *kt_lo + 1);  // k/v tiles
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    hopper::mbar_init(bar_q_empty, kConsumers);
    for (int s = 0; s < L::kStages; ++s) {
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
    // An item's Q is loaded once the consumers have released the last one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tq);
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      int stage = 0, phase = 0, q_phase = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        int q0, h, b, kt_lo;
        const int n_tiles = item(w, &q0, &h, &b, &kt_lo);
        if (n_tiles == 0) continue;
        const int kvh = h / (p.H / p.KV);
        hopper::mbar_wait(bar_q_empty, q_phase ^ 1);
        hopper::mbar_expect_tx(bar_q, L::kQBox * L::kBoxes);
        for (int c = 0; c < L::kBoxes; ++c) {
          hopper::tma_load_4d(sbase + L::kQ + c * L::kQBox, &tq, bar_q,
                              c * L::kBoxCols, h, q0, b);
        }
        q_phase ^= 1;
        for (int i = 0; i < n_tiles; ++i) {
          const int k0 = (kt_lo + i) * kKeys;
          hopper::mbar_wait(bar_empty + 8 * stage, phase ^ 1);
          hopper::mbar_expect_tx(bar_full + 8 * stage, 2 * L::kKVBytes);
          for (int c = 0; c < L::kBoxes; ++c) {
            hopper::tma_load_4d(sbase + L::kK + stage * L::kKVBytes + c * L::kKBox,
                                &tk, bar_full + 8 * stage, c * L::kBoxCols, kvh,
                                k0, b);
            hopper::tma_load_4d(sbase + L::kV + stage * L::kKVBytes + c * L::kKBox,
                                &tv, bar_full + 8 * stage, c * L::kBoxCols, kvh,
                                k0, b);
          }
          if (++stage == L::kStages) {
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
    constexpr uint32_t kSbo = 8 * L::kRowBytes;  // between 8-row groups
    int stage = 0, phase = 0, q_phase = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      int q0, h, b, kt_lo;
      const int n_tiles = item(w, &q0, &h, &b, &kt_lo);
      const int r0 = q0 + kWgRows * cw;  // the warpgroup's first row
      const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};

      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums
      float o[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;

      if (n_tiles > 0) hopper::mbar_wait(bar_q, q_phase);
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (kt_lo + i) * kKeys;
        const uint32_t k_tile = sbase + L::kK + stage * L::kKVBytes;
        const uint32_t v_tile = sbase + L::kV + stage * L::kKVBytes;
        hopper::mbar_wait(bar_full + 8 * stage, phase);

        // S = Q K^T over the head dim, 16 columns a step; s[4j + e] is row
        // row[e / 2], key k0 + 8j + 2 t4 + e % 2
        float s[kKeys / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t box = kk * 16 / L::kBoxCols;        // which box
          const uint32_t col = (kk * 16 % L::kBoxCols) * 2;  // bytes into its rows
          hopper::wgmma_ss<E, kKeys>(
              s,
              hopper::smem_desc(q_tile + box * L::kQBox + col, 16, kSbo, L::kLayout),
              hopper::smem_desc(k_tile + box * L::kKBox + col, 16, kSbo, L::kLayout),
              kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        if (i == n_tiles - 1) hopper::mbar_arrive(bar_q_empty);  // Q is read

        scores<kNat>(p, s);
        if (!tile_unmasked<kLse, kKeys>(p, r0, k0)) {
#pragma unroll
          for (int j = 0; j < kKeys / 2; ++j) {
            const int key = k0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
            if (!visible<kLse>(p, row[(j >> 1) & 1], key)) s[j] = -INFINITY;
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m_tile = kNegInf;
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j) {
            m_tile = fmaxf(m_tile, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
          }
          m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
          m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
          const float m_new = fmaxf(m[r], m_tile);
          alpha[r] = exp_base<kNat>(m[r] - m_new);  // 1 when both are still kNegInf
          m[r] = m_new;
          l[r] *= alpha[r];
        }
        // P = exp(s - m): exactly 0 where masked (exp of -inf)
#pragma unroll
        for (int j = 0; j < kKeys / 2; ++j) {
          const int r = (j >> 1) & 1;
          s[j] = exp_base<kNat>(s[j] - m[r]);
          l[r] += s[j];
        }
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

        // O += P V, 16 keys a step: P's A fragment for keys 16c.. is the
        // score accumulators 8c..8c+7, rounded to E
        uint32_t pa[kKeys / 4];
#pragma unroll
        for (int j = 0; j < kKeys / 4; ++j) pa[j] = pack2<E>(s[2 * j], s[2 * j + 1]);
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < kKeys / 16; ++c) {
          hopper::wgmma_rs_tb<E, HD>(
              o, pa[4 * c], pa[4 * c + 1], pa[4 * c + 2], pa[4 * c + 3],
              hopper::smem_desc(v_tile + c * 16 * L::kRowBytes, L::kKBox, kSbo,
                                L::kLayout));
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        hopper::fence_regs(pa);
        hopper::mbar_arrive(bar_empty + 8 * stage);  // K and V of this stage are read
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (n_tiles > 0) q_phase ^= 1;

      // every row of the tile is written, dead rows as out = 0 and lse ~ -6.9e29
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        if (row[r] >= p.T) continue;
        const float l_safe = fmaxf(l[r], 1e-30f);
        E* orow = static_cast<E*>(p.out) +
                  ((static_cast<long long>(b) * p.T + row[r]) * p.H + h) * HD;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * t4) =
              pack2<E>(o[4 * c + 2 * r] / l_safe, o[4 * c + 2 * r + 1] / l_safe);
        }
        if (t4 == 0) {
          p.lse[(static_cast<long long>(b) * p.H + h) * p.T + row[r]] =
              lse_of<kNat>(m[r], l_safe);
        }
      }
    }
  }
}

template <int HD, bool kLse, bool kNat>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params p) {
  fwd_wg<__nv_bfloat16, HD, kLse, kNat>(tq, tk, tv, p);
}

template <int HD, bool kLse, bool kNat>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_f16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const Params p) {
  fwd_wg<__half, HD, kLse, kNat>(tq, tk, tv, p);
}

// The kernel of element type E.
template <typename E, int HD, bool kLse, bool kNat>
auto fwd_kernel() {
  if constexpr (hopper::kIsHalf<E>) {
    return flash_fwd_f16_kernel<HD, kLse, kNat>;
  } else {
    return flash_fwd_bf16_kernel<HD, kLse, kNat>;
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

// Tensor maps of q, k and v in E, then the launch. A map the driver
// refuses (a stride TMA cannot take) fails the launch with
// cudaErrorInvalidValue.
template <typename E, int HD, bool kLse, bool kNat>
cudaError_t launch_wg(const Params& p, cudaStream_t stream) {
  using L = Tiles<HD>;
  constexpr CUtensorMapSwizzle kSwizzle = hopper::Swizzle<L::kRowBytes>::kMap;
  constexpr CUtensorMapDataType kType = hopper::map_type<E>();
  CUtensorMap tq, tk, tv;
  if (!hopper::make_map_16(&tq, kType, p.q, HD, p.H, p.T, p.B, p.q_sh, p.q_st,
                           p.q_sb, L::kBoxCols, kWgQ, kSwizzle) ||
      !hopper::make_map_16(&tk, kType, p.k, HD, p.KV, p.T, p.B, p.k_sh, p.k_st,
                           p.k_sb, L::kBoxCols, L::kKeys, kSwizzle) ||
      !hopper::make_map_16(&tv, kType, p.v, HD, p.KV, p.T, p.B, p.v_sh, p.v_st,
                           p.v_sb, L::kBoxCols, L::kKeys, kSwizzle)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = fwd_kernel<E, HD, kLse, kNat>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  // one persistent block per SM, the count made coprime with the q tiles
  // per head (see the kernel's work items)
  const int n_q = (p.T + kWgQ - 1) / kWgQ;
  int blocks = sms;
  while (blocks > sms / 2 && std::gcd(blocks, n_q) != 1) --blocks;
  blocks = std::min(blocks, n_q * p.H * p.B);
  kernel<<<blocks, kWgThreads, L::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// This library's dtype codes (kCode16, and 0 beside bfloat16); any other
// code is refused, never run on another type's kernel.
template <int HD, bool kLse, bool kNat>
cudaError_t launch_hd(const Params& p, int dtype, cudaStream_t s) {
  if constexpr (kWithF32) {
    if (dtype == 0) return launch_f32<HD, kLse, kNat>(p, s);
  }
  if (dtype == kCode16) return launch_wg<Elem16, HD, kLse, kNat>(p, s);
  return cudaErrorInvalidValue;
}

// hd 16, 32, 64, 80, 96, 128 or 256; the per-head-grid prototype (kNat)
// keeps its tool's widths, 16 to 128.
template <bool kLse, bool kNat>
cudaError_t dispatch(const Params& p, int hd, int dtype, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<16, kLse, kNat>(p, dtype, s);
    case 32: return launch_hd<32, kLse, kNat>(p, dtype, s);
    case 64: return launch_hd<64, kLse, kNat>(p, dtype, s);
    case 128: return launch_hd<128, kLse, kNat>(p, dtype, s);
  }
  if constexpr (!kNat) {
    switch (hd) {
      case 80: return launch_hd<80, kLse, kNat>(p, dtype, s);
      case 96: return launch_hd<96, kLse, kNat>(p, dtype, s);
      case 256: return launch_hd<256, kLse, kNat>(p, dtype, s);
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

// dtype: 0 = float32, 1 = bfloat16 (rows 16-byte aligned) in this library;
// 2 = float16 (rows 16-byte aligned) in flash_fwd_f16.cu's, which has no
// nh_fwd. hd: 16, 32, 64, 80, 96, 128 or 256 (nh_fwd: 16 to 128). Each
// returns a cudaError_t (0 = success; cudaErrorInvalidValue for a dtype code
// the library does not hold).
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

#ifndef FLASH_F16
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
#endif  // FLASH_F16
