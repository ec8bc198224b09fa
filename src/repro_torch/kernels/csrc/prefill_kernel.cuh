// Chunked-prefill flash attention for Hopper (sm_90a), shared by the
// paged kernel (paged_prefill.cu: per-row chunk geometry over a block
// pool) and the dense one (chunked_prefill.cu: one chunk offset for the
// batch over a [B, S, Hkv, D] cache).
//
// Row b's chunk starts at absolute position start[b * start_stride] and
// holds valid[b] real tokens (Tq when `valid` is null).  Query token t sees
// key kpos iff kpos <= start + t and kpos < start + valid.  `start` may be
// negative or lie past the cache's end: the dense kernel run on one piece
// of a cache split along its slot axis (slots off .. off + S_r) takes the
// chunk's offset less off.  A query row with no live key comes out zero.
// The log-sum-exp form (kLse, an instantiation of its own, so that the
// serving form keeps its registers) also writes lse [B, Tq, Hq] in f32:
// m + log(l) over the row's live keys, -1e30 for a row with none.
//
// What differs from the Pallas kernels.  Their grid (B, Hkv, q block, KV
// block) has a sequential innermost KV axis with m / l / acc carried in
// scratch; here one thread block owns one (row, KV head, query tile) and
// walks the KV axis in a loop, up to the tile's causal frontier and no
// further.  Query tiles that lie wholly past `valid` write zeros and
// leave, so a decode row inside a mixed batch costs one pass over its
// keys, not Tq of them.  The Pallas wrappers fold GQA into g-major query
// rows and transpose the whole cache on every call; this kernel indexes q
// as [B, Tq, Hq, D] and reads the cache in place through the view.  A
// query tile's rows are token-major: row = token * G + head, the G query
// heads of one KV head, so the group shares every K/V tile.
//
// Bound: operations, for long chunks (4 * Hq * D FLOPs a query-key pair);
// KV bytes for short ones.  Two bodies, chosen at compile time on the
// query and cache types (uses_tensor_cores, as the decode body chooses):
//
//  - bf16 query over a bf16 or int8 cache: the tensor-core body
//    (prefill_mma_kernel), FlashAttention-2 on mma.sync.  kMmaWarps warps
//    of 16 query rows each (the m16n8k16 product's M); a warp's Q is
//    loaded once into A fragments that stay in registers for the whole
//    walk (past D 128 into shared memory, whence each k-step's fragments
//    come by ldmatrix: QRows).  64-key K/V tiles, shared by the block's
//    warps, lie in a ring of two stages in shared memory in the storage
//    type (int8 per-key scales beside them), brought in by 16-byte
//    cp.async: the next tile's loads are in flight while one is
//    computed, with one block barrier a tile.
//    An int8 tile is widened exactly to bf16 by the whole block into one
//    of two bf16 stages, one iteration before its products (per-warp
//    widening of every fragment cost twice the bf16 time).  S = Q K^T by
//    mma.sync with K fragments by ldmatrix (an int8 K's scale multiplied
//    into the score column); an online softmax in registers over each
//    row's quad of lanes, exp2 of pre-scaled scores; O += P V with P
//    taken straight from S's accumulators as the A operand (an int8 V's
//    scale multiplied into P first) and V by ldmatrix.trans.  P goes in
//    as a bf16 pair hi + lo (16 bits; one bf16 put a bf16-pool case above
//    half the 2e-2 tolerance on the H100, PERF.md).  The
//    causal and frontier mask is computed only on the tiles that straddle
//    a warp's first query; thread blocks are numbered so that the last
//    query tiles of every head, whose walks are longest, start first.
//  - an f32 query or an f32 cache: the FMA body (prefill_fma_kernel), both
//    products as f32 FMA loops over shared memory (a 4 x 4 patch of the
//    score tile a thread, 32-key tiles), so f32 inputs keep full f32
//    precision: bf16 operands would miss what the f32 tolerance holds.
#pragma once

#include <math.h>

#include <type_traits>

#include "mma_common.cuh"
#include "paged_common.cuh"

namespace paged {

// ---- the f32 FMA body (an f32 query or an f32 cache) ----------------------
constexpr int kPrefillThreads = 128;
constexpr int kPrefillRows = 64;    // query rows a thread block owns
constexpr int kPrefillTile = 32;    // keys per tile

template <int D>
constexpr size_t prefill_fma_smem_bytes() {
  return sizeof(float) * (kPrefillRows * (D + 4) +
                          2 * kPrefillTile * (D + 4) +
                          kPrefillRows * (kPrefillTile + 4));
}

template <typename QT, typename KT, int D, bool kLse, typename View>
__global__ void __launch_bounds__(kPrefillThreads) prefill_fma_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ start,
    int start_stride, const int* __restrict__ valid, QT* __restrict__ out,
    float* __restrict__ lse, View view, int Tq, int Hq, int G, int TQ,
    float sm_scale) {
  constexpr int NT = kPrefillThreads;
  constexpr int M = kPrefillRows;
  constexpr int TK = kPrefillTile;
  constexpr int DP = D + 4;         // 4 * odd words: conflict-free float4
  constexpr int SP = TK + 4;
  constexpr int DC = D / 4;         // 4-column chunks of a row
  constexpr int NC = (DC + 7) / 8;  // of them a thread (the last may be
                                    // partial: D = 112 has 28 chunks)
  static_assert(NT == 128 && M == 64 && TK == 32 && D % 4 == 0, "tiling");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [M][DP]
  float* Ks = Qs + M * DP;          // [TK][DP]
  float* Vs = Ks + TK * DP;         // [TK][DP]
  float* Ps = Vs + TK * DP;         // [M][SP]

  const int t0 = blockIdx.x * TQ;   // first token of this query tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 8;           // rows ty*4 .. ty*4+3
  const int tx = tid % 8;           // keys tx + 8*jj, columns (tx + 8*c)*4

  const int st = start[b * start_stride];
  const int vl = valid != nullptr ? valid[b] : Tq;
  const int end = st + vl;          // write frontier (exclusive)
  const int n_tok = min(TQ, Tq - t0);
  const int rows_used = n_tok * G;

  if (t0 >= vl) {
    // nothing valid in this tile (padding row, or the tail of a short
    // chunk): the caller drops these tokens; leave zeros, not garbage
    for (int c = tid; c < rows_used * D; c += NT) {
      const int r = c / D;
      const int t = t0 + r / G;
      store1(out + ((static_cast<long>(b) * Tq + t) * Hq + h * G + r % G) * D +
                 c % D,
             0.f);
    }
    if constexpr (kLse) {
      for (int r = tid; r < rows_used; r += NT)
        lse[(static_cast<long>(b) * Tq + t0 + r / G) * Hq + h * G + r % G] =
            kNegInf;
    }
    return;
  }

  for (int c = tid; c < M * DC; c += NT) {
    const int r = c / DC;
    const int d = (c % DC) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows_used) {
      const int t = t0 + r / G;
      load4(q + ((static_cast<long>(b) * Tq + t) * Hq + h * G + r % G) * D + d,
            x);
    }
    *reinterpret_cast<float4*>(Qs + r * DP + d) =
        make_float4(x[0], x[1], x[2], x[3]);
  }

  int qpos[4];                      // -1: row unused, every key masked
  float m[4], l[4];
  float acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    qpos[i] = r < rows_used ? st + t0 + r / G : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  // the tile's last query sees keys up to its own position, and no key
  // lies past what the storage holds
  const int kv_hi = view.limit(min(end, st + t0 + n_tok));
  __syncthreads();

  for (int kv0 = 0; kv0 < kv_hi; kv0 += TK) {
    load_kv_tile<KT, D, DP, TK, NT>(Ks, k, k_scale, view, b, h, kv0, kv_hi,
                                    tid);
    load_kv_tile<KT, D, DP, TK, NT>(Vs, v, v_scale, view, b, h, kv0, kv_hi,
                                    tid);
    __syncthreads();

    // S = Q K^T on this thread's 4 x 4 patch
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * DP + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * jj) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[i][jj] += qv[i].x * kv[jj].x + qv[i].y * kv[jj].y +
                      qv[i].z * kv[jj].z + qv[i].w * kv[jj].w;
    }

    // mask, online softmax; a row's 32 keys live in 8 neighbouring lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = kv0 + tx + 8 * jj;
        ok[jj] = kpos <= qpos[i] && kpos < kv_hi;
        s[i][jj] = ok[jj] ? s[i][jj] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        sum += p;
        Ps[(ty * 4 + i) * SP + tx + 8 * jj] = p;
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }
    // a row of Ps is written and read by the same 8 lanes of one warp
    __syncwarp();

    // acc += P V on this thread's 4 x (NC * 4) patch
#pragma unroll 2
    for (int j = 0; j < TK; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * SP + j);
        pr[i][0] = p4.x; pr[i][1] = p4.y; pr[i][2] = p4.z; pr[i][3] = p4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (tx + 8 * c >= DC) continue;
          const float4 x = *reinterpret_cast<const float4*>(
              Vs + (j + jj) * DP + (tx + 8 * c) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c * 4 + 0] += pr[i][jj] * x.x;
            acc[i][c * 4 + 1] += pr[i][jj] * x.y;
            acc[i][c * 4 + 2] += pr[i][jj] * x.z;
            acc[i][c * 4 + 3] += pr[i][jj] * x.w;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rows_used) {
      const int t = t0 + r / G;
      QT* o = out + ((static_cast<long>(b) * Tq + t) * Hq + h * G + r % G) * D;
      const float l_i = fmaxf(l[i], kMinDenominator);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (tx + 8 * c >= DC) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store1(o + (tx + 8 * c) * 4 + e, acc[i][c * 4 + e] / l_i);
      }
      if constexpr (kLse) {   // l is the row's whole sum in all 8 lanes
        if (tx == 0)
          lse[(static_cast<long>(b) * Tq + t) * Hq + h * G + r % G] =
              l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
      }
    }
  }
}

template <typename QT, typename KT, int D, bool kLse, typename View>
int launch_prefill_fma(const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale,
                       const int* start, int start_stride, const int* valid,
                       void* out, float* lse, const View& view, int B, int Tq,
                       int Hq, int Hkv, cudaStream_t stream) {
  auto kernel = prefill_fma_kernel<QT, KT, D, kLse, View>;
  constexpr size_t smem = prefill_fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = Hq / Hkv;
  const int TQ = kPrefillRows / G;
  const dim3 grid((Tq + TQ - 1) / TQ, Hkv, B);
  kernel<<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), k_scale, v_scale, start, start_stride, valid,
      static_cast<QT*>(out), lse, view, Tq, Hq, G, TQ,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 tensor-core body ---------------------------------------------
constexpr int kMmaWarps = 4;          // of 16 query rows each (8 warps,
                                      // 128 rows, measured slower, PERF.md)
constexpr int kMmaKeys = 64;          // keys of a K/V tile
constexpr int kMmaStages = 2;         // of a bf16 cache's ring (a third
                                      // measured no faster on the H100)

// How a 64-key tile of K and V of type KT (and, with kScales, an int8
// pool's per-key K and V scales) lies in one stage of a ring.
template <typename KT, int D, bool kScales>
struct PrefillStage {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KT));
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte chunks a key
  static constexpr int kElems = 16 / static_cast<int>(sizeof(KT));
  // 16 bytes past the row, an odd number of 16-byte units: the 8 rows of
  // one ldmatrix 8 x 8 hit 32 distinct banks
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kTileBytes = kMmaKeys * kPitch;
  static constexpr int kBytes =
      2 * kTileBytes + (kScales ? 2 * kMmaKeys * 4 : 0);
  static_assert(kRowBytes % 16 == 0 && (kPitch / 16) % 2 == 1, "layout");
};

// The rings of a thread block.  A bf16 cache: kMmaStages stages filled by
// cp.async and computed in place.  An int8 pool: two stages of int8 tiles
// filled by cp.async, each tile widened (exactly) by the whole block into
// one of two bf16 stages one iteration before it is computed.
template <typename KT, int D>
struct PrefillRings {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  using Store = PrefillStage<KT, D, kQuant>;
  using Compute = PrefillStage<__nv_bfloat16, D, kQuant>;
  static constexpr int kStoreStages = kQuant ? 2 : kMmaStages;
  static constexpr int kStoreBytes = kStoreStages * Store::kBytes;
  // past the rings: the warps' Q rows past D 128 (QRows)
  static constexpr int kQOffset =
      kStoreBytes + (kQuant ? 2 * Compute::kBytes : 0);
  static constexpr int kSmemBytes = kQOffset + kMmaWarps * QRows<D>::kBytes;
  static_assert(kStoreStages >= 2, "ring");
  static_assert(kSmemBytes <= 227 * 1024, "shared memory");
};

// A warp's share of the walk: 16 query rows against each 64-key bf16 tile.
// Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8: S at keys
// 8 n + 2t, +1 of each of the 8 n-tiles, O at columns 8 n + 2t, +1 of
// each of the D / 8 n-tiles.
template <int D, bool kScales>
struct PrefillMmaTile {
  using L = PrefillStage<__nv_bfloat16, D, kScales>;
  static constexpr int KS = D / 16;   // k-steps of Q K^T (7 for D 112)
  static constexpr int ND = D / 8;    // n-tiles of P V (14 for D 112)
  static constexpr int NK = kMmaKeys / 8;
  static_assert(D % 16 == 0 && ND % 2 == 0, "tiling");
  using QR = QRows<D>;
  // Q as the A operand: all k-steps in registers, or this warp's rows in
  // shared memory (QR::kInSmem)
  uint32_t qa[QR::kInSmem ? 1 : KS][4];
  unsigned char* qs;
  float m[2], l[2], acc[ND][4];       // l: this lane's keys only

  // row: q's rows g and g + 8 of the warp (null where a row is unused);
  // qsm: this warp's QR::kBytes of shared memory
  __device__ __forceinline__ void init(const __nv_bfloat16* const row[2],
                                       int lane, unsigned char* qsm) {
    const int t = lane & 3;
    qs = qsm;
    if constexpr (QR::kInSmem) {
      QR::fill(qsm, row, lane);
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {   // rows g, g + 8; columns +0, +8
          const __nv_bfloat16* p = row[r & 1];
          qa[ks][r] = p != nullptr ? *reinterpret_cast<const uint32_t*>(
                                         p + ks * 16 + 2 * t + (r >> 1) * 8)
                                   : 0u;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }

  // k-step ks's A fragments
  __device__ __forceinline__ void qfrag(uint32_t a[4], int ks,
                                        int lane) const {
    if constexpr (QR::kInSmem) {
      QR::frag(a, qs, ks, lane);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qa[ks][r];
    }
  }

  // s = Q K^T over the stage's 64 keys
  __device__ __forceinline__ void scores(const unsigned char* Kt,
                                         float s[NK][4], int lane) const {
    const int r8 = lane & 7;          // ldmatrix: the row this lane points
    const int mi = lane >> 3;         // at, of matrix mi
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks + 1 < KS; ks += 2) {
      uint32_t a0[4], a1[4];
      qfrag(a0, ks, lane);
      qfrag(a1, ks + 1, lane);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b[4];
        ldsm_x4(b, Kt + (n * 8 + r8) * L::kPitch +
                       ((ks + (mi >> 1)) * 16 + (mi & 1) * 8) * 2);
        mma_bf16(s[n], a0, b[0], b[1]);
        mma_bf16(s[n], a1, b[2], b[3]);
      }
    }
    if constexpr (KS % 2 == 1) {
      uint32_t a[4];
      qfrag(a, KS - 1, lane);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t b[2];
        ldsm_x2(b, Kt + (n * 8 + r8) * L::kPitch +
                       ((KS - 1) * 16 + (mi & 1) * 8) * 2);
        mma_bf16(s[n], a, b[0], b[1]);
      }
    }
  }

  // online softmax over the tile: scores to the log2 domain (times an
  // int8 K's per-key scale), the rows' max over the quad, p = 2^(x - m),
  // then s holds p times an int8 V's per-key scale.  Masked: key kv0 + j
  // counts for row i iff kv0 + j <= qpos[i] and kv0 + j < hi.
  template <bool kMasked>
  __device__ __forceinline__ void softmax(float s[NK][4], const float* scl,
                                          int kv0, int hi,
                                          const int qpos[2],
                                          float scale_log2, int lane) {
    const int t = lane & 3;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = n * 8 + 2 * t + e;
        const float f = scale_log2 * (kScales ? scl[key] : 1.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[n][2 * i + e];
          x *= f;
          if constexpr (kMasked) {
            const int kpos = kv0 + key;
            if (!(kpos <= qpos[i] && kpos < hi)) x = kNegInf;
          }
          mx[i] = fmaxf(mx[i], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = n * 8 + 2 * t + e;
        const float v_sc = kScales ? scl[kMmaKeys + key] : 1.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[n][2 * i + e];
          // a masked key weighs 0, also in a row with no live key yet
          // (m still -1e30, where 2^(x - m) would be 1)
          const float p = (!kMasked || x > kNegInf) ? exp2f(x - m[i]) : 0.f;
          l[i] += p;
          x = p * v_sc;
        }
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
  }

  // O += P V, P as the A operand straight from S's accumulators, as a
  // bf16 pair hi + lo
  __device__ __forceinline__ void accumulate(const unsigned char* Vt,
                                             const float s[NK][4],
                                             int lane) {
    const int r8 = lane & 7;
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {   // rows g, g + 8; keys +0, +8
        const float x0 = s[2 * kk + (r >> 1)][2 * (r & 1)];
        const float x1 = s[2 * kk + (r >> 1)][2 * (r & 1) + 1];
        split_bf16(x0, x1, hi[r], lo[r]);
      }
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vt + (kk * 16 + (mi & 1) * 8 + r8) * L::kPitch +
                             (n + (mi >> 1)) * 16);
        mma_bf16(acc[n], hi, b[0], b[1]);
        mma_bf16(acc[n + 1], hi, b[2], b[3]);
        mma_bf16(acc[n], lo, b[0], b[1]);
        mma_bf16(acc[n + 1], lo, b[2], b[3]);
      }
    }
  }

  // rows g and g + 8's log-sum-exp, natural log, into at[i] (null: unused)
  __device__ __forceinline__ void store_lse(float* const at[2],
                                            int lane) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lq = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      if (at[i] != nullptr && (lane & 3) == 0)
        *at[i] = lq > 0.f ? (m[i] + log2f(lq)) * 0.6931471805599453f
                          : kNegInf;
    }
  }

  // rows g and g + 8 normalised into their output rows (null: unused)
  __device__ __forceinline__ void store(__nv_bfloat16* const row[2],
                                        int lane) const {
    const int t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lq = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      if (row[i] == nullptr) continue;
      const float inv = 1.f / fmaxf(lq, kMinDenominator);
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(row[i] + n * 8 + 2 * t) =
            pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
};

// An int8 stage widened into a bf16 one by the NT threads of the block:
// every value exactly (8-bit integers fit bf16's mantissa), the scales
// copied beside.
template <int D, int NT>
__device__ __forceinline__ void widen_int8_stage(const unsigned char* src,
                                                 unsigned char* dst,
                                                 int tid) {
  using S = PrefillStage<int8_t, D, true>;
  using C = PrefillStage<__nv_bfloat16, D, true>;
  constexpr int kPerTile = kMmaKeys * S::kChunks;
  for (int c = tid; c < 2 * kPerTile; c += NT) {
    const int tile = c / kPerTile;
    const int j = (c % kPerTile) / S::kChunks;
    const int ch = c % S::kChunks;
    const int4 raw = *reinterpret_cast<const int4*>(
        src + tile * S::kTileBytes + j * S::kPitch + ch * 16);
    const int w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)     // bytes 0, 1 and 2, 3 of each word
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[2 * i + e] =
            pack_bf16(static_cast<float>((w[i] << (24 - 16 * e)) >> 24),
                      static_cast<float>((w[i] << (16 - 16 * e)) >> 24));
    uint4* out = reinterpret_cast<uint4*>(dst + tile * C::kTileBytes +
                                          j * C::kPitch + ch * 32);
    out[0] = make_uint4(o[0], o[1], o[2], o[3]);
    out[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
  const float* ss = reinterpret_cast<const float*>(src + 2 * S::kTileBytes);
  float* ds = reinterpret_cast<float*>(dst + 2 * C::kTileBytes);
  for (int c = tid; c < 2 * kMmaKeys; c += NT) ds[c] = ss[c];
}

// Grid (Hkv, query tiles, B), 32 * kMmaWarps threads; a query tile is TQ
// tokens of G heads (TQ * G <= 16 * kMmaWarps rows).  Thread blocks start in the order
// of their linear index, so the KV heads vary fastest and the query tiles
// count down: every head's last tiles (the longest walks) go first, and
// the shortest fill the tail.
template <typename KT, int D, bool kLse, typename View>
__global__ void __launch_bounds__(32 * kMmaWarps) prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ start,
    int start_stride, const int* __restrict__ valid,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, View view,
    int Tq, int Hq, int G, int TQ, float scale_log2) {
  using R = PrefillRings<KT, D>;
  using L = typename R::Store;
  using C = typename R::Compute;
  using Tile = PrefillMmaTile<D, R::kQuant>;
  constexpr int NW = kMmaWarps;
  constexpr int NT = 32 * NW;
  constexpr int TK = kMmaKeys;
  constexpr int NS = R::kStoreStages;
  constexpr int KPW = TK / NW;        // keys of a tile whose copies a warp
                                      // issues (a lane resolves one each)
  static_assert(TK % NW == 0 && KPW <= 32, "tiling");

  const int h = blockIdx.x;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int st = start[b * start_stride];
  const int vl = valid != nullptr ? valid[b] : Tq;
  const int end = st + vl;            // write frontier (exclusive)
  const int n_tok = min(TQ, Tq - t0);
  const int rows_used = n_tok * G;
  auto row_offset = [&](int r) {      // element offset of q / out row r
    return ((static_cast<long>(b) * Tq + t0 + r / G) * Hq + h * G + r % G) *
           D;
  };

  if (t0 >= vl) {
    // nothing valid in this tile (padding row, or the tail of a short
    // chunk): the caller drops these tokens; leave zeros, not garbage
    for (int c = tid; c < rows_used * (D / 2); c += NT) {
      const int r = c / (D / 2);
      *reinterpret_cast<uint32_t*>(out + row_offset(r) + 2 * (c % (D / 2))) =
          0u;
    }
    if constexpr (kLse) {
      for (int r = tid; r < rows_used; r += NT) lse[row_offset(r) / D] = kNegInf;
    }
    return;
  }

  // this lane's rows g and g + 8 of the warp's 16
  int qpos[2];                        // -1: row unused, every key masked
  long roff[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    qpos[i] = r < rows_used ? st + t0 + r / G : -1;
    roff[i] = r < rows_used ? row_offset(r) : -1;
  }
  // (named apart from the FMA body's float array: one extern array a type)
  extern __shared__ __align__(16) unsigned char ring[];
  unsigned char* wide = ring + R::kStoreBytes;   // int8: the bf16 stages
  Tile prod;
  {
    const __nv_bfloat16* qrow[2] = {roff[0] >= 0 ? q + roff[0] : nullptr,
                                    roff[1] >= 0 ? q + roff[1] : nullptr};
    prod.init(qrow, lane, ring + R::kQOffset + warp * QRows<D>::kBytes);
  }
  const bool warp_live = warp * 16 < rows_used;
  // tiles whose last key is at or below the warp's first query, and below
  // the frontier, need no mask
  const int warp_q0 = st + t0 + (warp * 16) / G;

  // the tile's last query sees keys up to its own position, and no key
  // lies past what the storage holds
  const int kv_hi = view.limit(min(end, st + t0 + n_tok));
  const int ntiles = (kv_hi + TK - 1) / TK;

  // the token handle of this lane's key of tile i (-1: none); read one
  // iteration before its copies are issued, so that a table entry's load
  // is hidden behind a tile
  auto resolve = [&](int i) -> long {
    const int pos = i * TK + warp * KPW + lane;
    return lane < KPW && pos < kv_hi ? view.token(b, pos) : -1;
  };
  // the cp.async loads of the warp's keys of tile i: the chunk loop takes
  // each key's offset from the lane that resolved it
  auto issue = [&](int i, long tok) {
    unsigned char* stg = ring + (i % NS) * L::kBytes;
    const long off = tok >= 0 ? view.kv_offset(tok, h) : 0;
    constexpr int kCopies = KPW * L::kChunks;
#pragma unroll 4
    for (int c0 = 0; c0 < kCopies; c0 += 32) {
      const int c = c0 + lane;
      const int j = min(c / L::kChunks, KPW - 1);
      const long oj = __shfl_sync(0xffffffffu, off, j) +
                      (c % L::kChunks) * L::kElems;
      if (c < kCopies) {
        const bool ok = i * TK + warp * KPW + j < kv_hi;
        const int at = (warp * KPW + j) * L::kPitch + (c % L::kChunks) * 16;
        cp_async16(stg + at, k + oj, ok);
        cp_async16(stg + L::kTileBytes + at, v + oj, ok);
      }
    }
    if constexpr (R::kQuant) {
      if (lane < KPW) {
        float* sc = reinterpret_cast<float*>(stg + 2 * L::kTileBytes);
        const long so = tok >= 0 ? view.scale_offset(tok, h) : 0;
        cp_async4(sc + warp * KPW + lane, k_scale + so, tok >= 0);
        cp_async4(sc + TK + warp * KPW + lane, v_scale + so, tok >= 0);
      }
    }
  };
  // tile i, from its bf16 stage
  auto compute = [&](const unsigned char* stg, int i) {
    if (!warp_live) return;
    const float* scl = reinterpret_cast<const float*>(stg + 2 * C::kTileBytes);
    const int kv0 = i * TK;
    float s[Tile::NK][4];
    prod.scores(stg, s, lane);
    if (kv0 + TK <= kv_hi && kv0 + TK - 1 <= warp_q0)
      prod.template softmax<false>(s, scl, kv0, kv_hi, qpos, scale_log2,
                                   lane);
    else
      prod.template softmax<true>(s, scl, kv0, kv_hi, qpos, scale_log2,
                                  lane);
    prod.accumulate(stg + C::kTileBytes, s, lane);
  };

  if constexpr (!R::kQuant) {
    long tok = 0;
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      tok = resolve(i);
      if (i < ntiles) issue(i, tok);
      cp_async_commit();
    }
    tok = resolve(NS - 1);
    for (int i = 0; i < ntiles; ++i) {
      cp_async_wait<NS - 2>();
      // tile i is in (every warp's copies); every warp is done with tile
      // i - 1, whose stage the next issue refills
      __syncthreads();
      if (i + NS - 1 < ntiles) issue(i + NS - 1, tok);
      cp_async_commit();
      tok = resolve(i + NS);
      compute(ring + (i % NS) * L::kBytes, i);
    }
  } else {
    // the int8 tiles run one ahead: tile i + 1 is widened while tile i is
    // computed, and tile i + 2 loads meanwhile
    issue(0, resolve(0));
    cp_async_commit();
    long tok = resolve(1);
    cp_async_wait<0>();
    __syncthreads();
    if (1 < ntiles) issue(1, tok);
    cp_async_commit();
    tok = resolve(2);
    if (ntiles > 0) widen_int8_stage<D, NT>(ring, wide, tid);
    for (int i = 0; i < ntiles; ++i) {
      cp_async_wait<0>();
      // tile i + 1 is in; tile i is widened; every warp is done with tile
      // i - 1's bf16 stage, which tile i + 1 takes, and tile i's int8
      // stage was widened before, so tile i + 2 refills it
      __syncthreads();
      if (i + 2 < ntiles) issue(i + 2, tok);
      cp_async_commit();
      tok = resolve(i + 3);
      if (i + 1 < ntiles)
        widen_int8_stage<D, NT>(ring + ((i + 1) % 2) * L::kBytes,
                                wide + ((i + 1) % 2) * C::kBytes, tid);
      compute(wide + (i % 2) * C::kBytes, i);
    }
  }

  __nv_bfloat16* orow[2] = {roff[0] >= 0 ? out + roff[0] : nullptr,
                            roff[1] >= 0 ? out + roff[1] : nullptr};
  prod.store(orow, lane);
  if constexpr (kLse) {
    float* lrow[2] = {roff[0] >= 0 ? lse + roff[0] / D : nullptr,
                      roff[1] >= 0 ? lse + roff[1] / D : nullptr};
    prod.store_lse(lrow, lane);
  }
}

template <typename KT, int D, bool kLse, typename View>
int launch_prefill_mma(const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale,
                       const int* start, int start_stride, const int* valid,
                       void* out, float* lse, const View& view, int B, int Tq,
                       int Hq, int Hkv, cudaStream_t stream) {
  constexpr int NW = kMmaWarps;
  auto kernel = prefill_mma_kernel<KT, D, kLse, View>;
  constexpr int smem = PrefillRings<KT, D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = Hq / Hkv;
  const int TQ = 16 * NW / G;
  const dim3 grid(Hkv, (Tq + TQ - 1) / TQ, B);
  kernel<<<grid, 32 * NW, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), k_scale, v_scale, start, start_stride, valid,
      static_cast<__nv_bfloat16*>(out), lse, view, Tq, Hq, G, TQ,
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

// Launch on `stream`; returns the CUDA error of the launch (0 = launched).
// The body is chosen at compile time on the types: no launch falls back to
// the other.  kLse: the form that writes `lse` [B, Tq, Hq].
template <typename QT, typename KT, int D, bool kLse = false, typename View>
int launch_prefill(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* start, int start_stride, const int* valid,
                   void* out, const View& view, int B, int Tq, int Hq,
                   int Hkv, cudaStream_t stream, float* lse = nullptr) {
  if constexpr (uses_tensor_cores<QT, KT>()) {
    return launch_prefill_mma<KT, D, kLse>(q, k, v, k_scale, v_scale, start,
                                           start_stride, valid, out, lse,
                                           view, B, Tq, Hq, Hkv, stream);
  } else {
    return launch_prefill_fma<QT, KT, D, kLse>(
        q, k, v, k_scale, v_scale, start, start_stride, valid, out, lse, view,
        B, Tq, Hq, Hkv, stream);
  }
}

}  // namespace paged
