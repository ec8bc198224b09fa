// Split-KV GQA flash-decode for Hopper (sm_90a), shared by the paged
// kernel (paged_decode.cu) and the dense one (decode.cu): the two differ
// only in the view that turns (row, position) into a KV address.
//
// One query token a row attends over the row's first lengths[b] keys with
// an online softmax in f32: keys at or past the length masked, -1e30 for
// a masked score, the denominator floored at 1e-30, and, for an int8 pool,
// the per-token f32 scales multiplied in after the load (the K scale into
// the score, the V scale into the probability).  A row with no key comes
// out zero.
//
// What differs from the Pallas kernels.  Their grid (B, Hkv, KV blocks)
// walks the keys in order and carries m / l / acc in scratch from one grid
// step to the next; thread blocks on this card run in no order, so the KV
// axis is cut into splits of keys_per_split keys (flash-decoding) and
// reduced in a second pass.  The cache is read in place through the view:
// the paged pool through the row's block table, the dense cache through its
// [B, S, Hkv, D] strides (the Pallas wrappers transpose the whole cache on
// every call).
//
// Bound: the KV bytes read (every key and value of every row once); the
// arithmetic is about 2 G FLOPs a KV byte, far below the card's ridge of
// ~295.  What has to be kept short is the chain of latencies in each thread
// block, and the design is about that:
//  - pass 1, grid (splits, Hkv, B): a thread block takes one (row, KV head,
//    range of keys_per_split keys) and leaves at once when the range lies
//    past the row's length.  The wrapper picks keys_per_split from the
//    shapes so that the grid holds a few thread blocks an SM.
//  - the table entries of the split's pages are read once into shared
//    memory; lane j of a warp then resolves key j's address with no
//    dependent load, and the copy loop takes it by shuffle.
//  - each warp takes the split's 32-key tiles w, w + warps, ... on its own:
//    a ring of two tiles in shared memory filled by 16-byte cp.async in the
//    storage type (the next tile's loads in flight while one is computed),
//    its own m / l / acc, no block barrier between tiles.  The warps' states
//    are merged once, at the end of the split.
//  - the products: with a bf16 query and a bf16 or int8 cache, Q K^T and
//    P V are m16n8k16 bf16 tensor-core products (mma.sync) with f32 sums,
//    the group's query heads as the 16 rows (the rows past G zero), K and V
//    fragments by ldmatrix (int8 widened exactly to bf16); Q's fragments in
//    registers, or past D 128 read from shared memory a k-step at a time
//    (QRows).  Q, K and V are
//    exact in bf16, so Q K^T is as exact as f32 FMAs; P goes into P V as a
//    pair of bf16 products (hi + lo, 16 bits).  With an f32 query or cache,
//    where bf16 would lose what the f32 tolerance holds, they are f32 FMA
//    loops: lane j takes key j for every head, Q broadcast from shared
//    memory, and lane c columns 4c .. 4c + 3 of P V (8c .. 8c + 7 past
//    D 128).
//  - a thread block has 4 warps, or 2 or 1 where 4 rings would not fit:
//    at D 256 a warp's stage is 34 KB in bf16 and 67 KB in f32.
//  - pass 1 writes the split's unnormalised acc [G, D], m and l in f32 to
//    a workspace; pass 2, one thread block per (row, query head), rescales
//    the row's live splits (ceil(length / keys_per_split) of them) by
//    exp(m_s - m_max) and divides by the summed l.  A launch with one split
//    writes the output from pass 1 and has no pass 2.
#pragma once

#include <math.h>
#include <type_traits>

#include "mma_common.cuh"
#include "paged_common.cuh"

namespace paged {

constexpr int kWarpKeys = 32;           // keys of a warp's tile: one a lane
constexpr int kMaxGroup = 16;           // query heads per KV head, at most
constexpr int kMaxSplitPages = 257;     // table entries one split may span
constexpr int kCombineThreads = 128;
constexpr int kDecodeSmemLimit = 200 * 1024;

// ---- one 16-byte chunk of a tile row -> floats ----------------------------
__device__ __forceinline__ void load_chunk(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_chunk(const int8_t* p, float out[16]) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)    // sign-extend byte e of the word
      out[4 * i + e] = static_cast<float>((w[i] << (24 - 8 * e)) >> 24);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// query heads the FMA product computes for: the group rounded up to 1, 4, 8
// or 16 (the padding heads have zero queries and are never written); the
// tensor-core product always has 16 rows
constexpr int pad_group(int g) {
  return g <= 1 ? 1 : (g <= 4 ? 4 : (g <= 8 ? 8 : 16));
}

// How a 32-key tile of K or V lies in shared memory.
template <typename KT, int D>
struct DecodeLayout {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KT));
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte chunks a key
  static constexpr int kElems = 16 / static_cast<int>(sizeof(KT));
  // row pitch: 16 bytes past the row, an odd number of 16-byte units, so
  // 8 rows read 16 bytes each (a quarter warp's LDS.128, one ldmatrix
  // 8 x 8) hit 32 distinct banks
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kTileBytes = kWarpKeys * kPitch;
  static constexpr int kStageBytes =          // a warp's K, V and scales
      2 * kTileBytes + 2 * kWarpKeys * static_cast<int>(sizeof(float));
  static_assert(kRowBytes % 32 == 0, "row must be an even number of chunks");
};

// shared memory besides the ring: for the tensor-core product each warp's
// Q rows past D 128 (QRows), for the FMA product Q [GM][D] and each warp's
// P [32][GM]; each warp's m / l [GM]; the split's page entries
template <int D>
constexpr int decode_fixed_bytes(bool tensor, int GM, int warps) {
  return (tensor ? warps * QRows<D>::kBytes : 0) +
         4 * ((tensor ? 0 : GM * D + warps * kWarpKeys * GM) +
              2 * warps * GM) +
         4 * kMaxSplitPages;
}

template <typename QT, typename KT, int D, int GM>
struct DecodeTiling {
  using L = DecodeLayout<KT, D>;
  static constexpr bool kTensor = uses_tensor_cores<QT, KT>();
  // tiles in a warp's ring: one in flight while one is computed (a third
  // or fourth measured no faster on the H100)
  static constexpr int kStages = 2;
  static constexpr bool fits(int warps) {
    return warps * kStages * L::kStageBytes +
               decode_fixed_bytes<D>(kTensor, GM, warps) <=
           kDecodeSmemLimit;
  }
  static constexpr int kWarps = fits(4) ? 4 : (fits(2) ? 2 : 1);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRingBytes = kWarps * kStages * L::kStageBytes;
  static constexpr int kSmemBytes =
      kRingBytes + decode_fixed_bytes<D>(kTensor, GM, kWarps);
  static_assert(kSmemBytes <= 227 * 1024, "shared memory");
  // the ring is reused for the warps' [GM][D] f32 sums at the end
  static_assert(kRingBytes >= kWarps * GM * D * 4, "merge buffer");
  static_assert(!kTensor || GM == 16, "the tensor-core product has 16 rows");
};

// ---- a warp's tile product, f32 FMA ----------------------------------------
// Lane j: key j of the tile for all GM heads (Q broadcast from shared
// memory); then lane c: columns CPL c .. CPL c + CPL - 1 of P V for all
// heads.
template <typename KT, int D, int GM>
struct FmaTile {
  using L = DecodeLayout<KT, D>;
  static constexpr int CPL = D > 128 ? 8 : 4;   // output columns a lane
  static constexpr int NCG = D / CPL;           // lanes owning columns
  static_assert(NCG <= 32 && D % CPL == 0, "tiling");
  float m[GM], l[GM], acc[GM][CPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;
    }
  }

  // st: the tile's stage; live: key `lane` is below the split's end;
  // k_sc / v_sc: its int8 scales (1 otherwise); P: this warp's [32][GM]
  __device__ __forceinline__ void tile(const unsigned char* st,
                                       const float* Qs, float* P, bool live,
                                       float k_sc, float v_sc,
                                       float sm_scale, int lane) {
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    const KT* krow = reinterpret_cast<const KT*>(st + lane * L::kPitch);
#pragma unroll 2
    for (int c = 0; c < L::kChunks; ++c) {
      float kx[L::kElems];
      load_chunk(krow + c * L::kElems, kx);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float* qp = Qs + g * D + c * L::kElems;
#pragma unroll
        for (int e = 0; e < L::kElems; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qp + e);
          s[g] += qv.x * kx[e] + qv.y * kx[e + 1] + qv.z * kx[e + 2] +
                  qv.w * kx[e + 3];
        }
      }
    }
    // online softmax over the tile's 32 keys (a lane each)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float sv = live ? s[g] * k_sc * sm_scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(sv));
      const float p = live ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[g] - m_new);
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[g][c] *= alpha;
      s[g] = p * v_sc;
    }
    if constexpr (GM % 4 == 0) {
#pragma unroll
      for (int g = 0; g < GM; g += 4)
        *reinterpret_cast<float4*>(P + lane * GM + g) =
            make_float4(s[g], s[g + 1], s[g + 2], s[g + 3]);
    } else {
#pragma unroll
      for (int g = 0; g < GM; ++g) P[lane * GM + g] = s[g];
    }
    __syncwarp();
    if (lane < NCG) {
      const unsigned char* vcol =
          st + L::kTileBytes + lane * CPL * static_cast<int>(sizeof(KT));
#pragma unroll 4
      for (int j = 0; j < kWarpKeys; ++j) {
        float vx[CPL];
#pragma unroll
        for (int u = 0; u < CPL; u += 4)
          load4(reinterpret_cast<const KT*>(vcol + j * L::kPitch) + u,
                vx + u);
        const float* pj = P + j * GM;
        if constexpr (GM % 4 == 0) {
#pragma unroll
          for (int g = 0; g < GM; g += 4) {
            const float4 pv = *reinterpret_cast<const float4*>(pj + g);
            const float pg[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int c = 0; c < CPL; ++c) acc[g + u][c] += pg[u] * vx[c];
          }
        } else {
#pragma unroll
          for (int g = 0; g < GM; ++g)
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[g][c] += pj[g] * vx[c];
        }
      }
    }
  }

  // this warp's sums into red [warp][GM][D], m / l into Mw / Lw [warp][GM]
  __device__ __forceinline__ void store(float* red, float* Mw, float* Lw,
                                        int warp, int lane, int G) const {
    if (lane < NCG) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G)
#pragma unroll
          for (int u = 0; u < CPL; u += 4)
            *reinterpret_cast<float4*>(red + (warp * GM + g) * D +
                                       lane * CPL + u) =
                make_float4(acc[g][u], acc[g][u + 1], acc[g][u + 2],
                            acc[g][u + 3]);
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        Mw[warp * GM + g] = m[g];
        Lw[warp * GM + g] = l[g];
      }
    }
  }
};

// ---- a warp's tile product, bf16 tensor cores ------------------------------
// S [16 heads][32 keys] = Q K^T as 4 n-tiles of 8 keys over D / 16 k-steps;
// O [16 heads][D] += P V as D / 8 n-tiles over 2 k-steps of 16 keys, P taken
// from S's accumulators.  Lane (g, t) = (lane / 4, lane % 4) holds heads g
// and g + 8: S at keys 8 n + 2t, +1 of each n-tile, O at columns 8 n + 2t, +1.
template <typename KT, int D>
struct MmaTile {
  using L = DecodeLayout<KT, D>;
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr int KS = D / 16;   // k-steps of Q K^T
  static constexpr int ND = D / 8;    // n-tiles of P V
  static_assert(D % 16 == 0 && ND % 2 == 0, "tiling");
  using QR = QRows<D>;
  // Q as the A operand: all k-steps in registers, or this warp's rows in
  // shared memory (QR::kInSmem)
  uint32_t qa[QR::kInSmem ? 1 : KS][4];
  unsigned char* qs;
  float m[2], l[2], acc[ND][4];       // l: this lane's keys only

  // qsm: this warp's QR::kBytes of shared memory
  __device__ __forceinline__ void init(const __nv_bfloat16* q, long q_row,
                                       int G, int lane, unsigned char* qsm) {
    const int g = lane >> 2;
    const int t = lane & 3;
    qs = qsm;
    if constexpr (QR::kInSmem) {
      const __nv_bfloat16* row[2] = {
          g < G ? q + (q_row + g) * D : nullptr,
          g + 8 < G ? q + (q_row + g + 8) * D : nullptr};
      QR::fill(qsm, row, lane);
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {   // rows g, g + 8; columns +0, +8
          const int head = g + (r & 1) * 8;
          const int col = ks * 16 + 2 * t + (r >> 1) * 8;
          qa[ks][r] = head < G ? *reinterpret_cast<const uint32_t*>(
                                     q + (q_row + head) * D + col)
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

  // st: the tile's stage; keys kv0 + j below hi are live
  __device__ __forceinline__ void tile(const unsigned char* st, int kv0,
                                       int hi, float sm_scale, int lane) {
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r8 = lane & 7;          // ldmatrix: the row this lane points
    const int mi = lane >> 3;         // at, of matrix mi
    const unsigned char* Kt = st;
    const unsigned char* Vt = st + L::kTileBytes;
    const float* scl = reinterpret_cast<const float*>(st + 2 * L::kTileBytes);

    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
    if constexpr (kQuant) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        qfrag(a, ks, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int8_t* row = reinterpret_cast<const int8_t*>(
              Kt + (n * 8 + g) * L::kPitch) + ks * 16 + 2 * t;
          mma_bf16(s[n], a, pack_i8(row[0], row[1]),
                   pack_i8(row[8], row[9]));
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks + 1 < KS; ks += 2) {
        uint32_t a0[4], a1[4];
        qfrag(a0, ks, lane);
        qfrag(a1, ks + 1, lane);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
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
        for (int n = 0; n < 4; ++n) {
          uint32_t b[2];
          ldsm_x2(b, Kt + (n * 8 + r8) * L::kPitch +
                         ((KS - 1) * 16 + (mi & 1) * 8) * 2);
          mma_bf16(s[n], a, b[0], b[1]);
        }
      }
    }

    // online softmax: a head's 32 keys lie in the 4 lanes of a quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = n * 8 + 2 * t + e;
        const bool live = kv0 + key < hi;
        const float f = sm_scale * (kQuant ? scl[key] : 1.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[n][2 * i + e];
          x = live ? x * f : kNegInf;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = n * 8 + 2 * t + e;
        const bool live = kv0 + key < hi;
        const float v_sc = kQuant ? scl[kWarpKeys + key] : 1.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[n][2 * i + e];
          const float p = live ? expf(x - m[i]) : 0.f;
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

    // O += P V, P as the A operand straight from S's accumulators, split
    // into a bf16 pair hi + lo (P keeps 16 bits; V is exact in bf16)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)     // rows g, g + 8; keys +0, +8
        split_bf16(s[2 * kk + (r >> 1)][2 * (r & 1)],
                   s[2 * kk + (r >> 1)][2 * (r & 1) + 1], hi[r], lo[r]);
      if constexpr (kQuant) {
        const int8_t* v0 = reinterpret_cast<const int8_t*>(
            Vt + (kk * 16 + 2 * t) * L::kPitch) + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int8_t* p = v0 + n * 8;
          const uint32_t b0 = pack_i8(p[0], p[L::kPitch]);
          const uint32_t b1 = pack_i8(p[8 * L::kPitch], p[9 * L::kPitch]);
          mma_bf16(acc[n], hi, b0, b1);
          mma_bf16(acc[n], lo, b0, b1);
        }
      } else {
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, Vt + (kk * 16 + (mi & 1) * 8 + r8) * L::kPitch +
                               (n + (mi >> 1)) * 16);
          mma_bf16(acc[n], hi, b[0], b[1]);
          mma_bf16(acc[n], lo, b[0], b[1]);
          mma_bf16(acc[n + 1], hi, b[2], b[3]);
          mma_bf16(acc[n + 1], lo, b[2], b[3]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* red, float* Mw, float* Lw,
                                        int warp, int lane, int G) const {
    const int g = lane >> 2;
    const int t = lane & 3;
    float lq[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {     // the quad's keys
      lq[i] = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
      lq[i] += __shfl_xor_sync(0xffffffffu, lq[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int head = g + 8 * i;
      if (head >= G) continue;
      float* o = red + (warp * 16 + head) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      if (t == 0) {
        Mw[warp * 16 + head] = m[i];
        Lw[warp * 16 + head] = lq[i];
      }
    }
  }
};

struct DecodeArgs {
  const void* q;           // [B, Hq, D]
  const void* k;           // through the view
  const void* v;
  const float* k_scale;    // int8 pools only
  const float* v_scale;
  const int* lengths;      // [B]
  void* out;               // [B, Hq, D], q's type
  float* ws_acc;           // [B, Hq, splits, D]   (splits > 1 only)
  float* ws_m;             // [B, Hq, splits]
  float* ws_l;             // [B, Hq, splits]
  int B, Hq, Hkv;
  int keys_per_split;      // a multiple of kWarpKeys
  int splits;              // ceil(view.span() / keys_per_split)
};

// Pass 1: grid (splits, Hkv, B), DecodeTiling::kThreads threads.
template <typename QT, typename KT, int D, int GM, typename View>
__global__ void __launch_bounds__(DecodeTiling<QT, KT, D, GM>::kThreads)
    decode_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ lengths, QT* __restrict__ out,
                        float* __restrict__ ws_acc, float* __restrict__ ws_m,
                        float* __restrict__ ws_l, View view, int Hq, int G,
                        int kps, float sm_scale) {
  using T = DecodeTiling<QT, KT, D, GM>;
  using L = DecodeLayout<KT, D>;
  constexpr int NW = T::kWarps;
  constexpr int NT = T::kThreads;
  constexpr int WK = kWarpKeys;
  constexpr int S = T::kStages;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int length = lengths[b];
  length = length < 0 ? 0 : (length < view.span() ? length : view.span());
  const int lo = split * kps;
  if (splits > 1 && lo >= length) return;      // pass 2 skips this split
  const int hi = lo + kps < length ? lo + kps : length;
  const int ntiles = hi > lo ? (hi - lo + WK - 1) / WK : 0;

  extern __shared__ __align__(16) unsigned char smem[];
  // past the ring: the tensor-core product's Q rows [NW] past D 128, the
  // FMA product's Q [GM][D] and P [NW][WK][GM] (16-byte aligned for
  // float4), then m / l [NW][GM] and the page entries
  constexpr int QB = T::kTensor ? QRows<D>::kBytes : 0;
  unsigned char* qrows = smem + T::kRingBytes;
  float* Qs = reinterpret_cast<float*>(qrows + NW * QB);
  float* Ps = Qs + (T::kTensor ? 0 : GM * D);
  float* Mw = Ps + (T::kTensor ? 0 : NW * WK * GM);
  float* Lw = Mw + NW * GM;
  int* pages = reinterpret_cast<int*>(Lw + NW * GM);
  float* P = Ps + warp * WK * GM;               // this warp's [WK][GM]
  const long q_row = static_cast<long>(b) * Hq + static_cast<long>(h) * G;

  std::conditional_t<T::kTensor, MmaTile<KT, D>, FmaTile<KT, D, GM>> prod;
  if constexpr (T::kTensor) {
    prod.init(q, q_row, G, lane, qrows + warp * QB);
  } else {
    prod.init();
    for (int c = tid; c < GM * (D / 4); c += NT) {
      const int g = c / (D / 4);
      const int d = (c % (D / 4)) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (g < G) load4(q + (q_row + g) * D + d, x);
      *reinterpret_cast<float4*>(Qs + g * D + d) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
  view.stage_pages(b, lo, hi, pages, tid, NT);
  const int p0 = view.first_page(lo);
  __syncthreads();

  unsigned char* ring = smem + warp * S * L::kStageBytes;
  // this warp's tiles: warp, warp + NW, ...
  const int n_mine = ntiles > warp ? (ntiles - warp + NW - 1) / NW : 0;

  // issue the cp.async loads of this warp's i-th tile: lane j resolves key
  // j's address once, the chunk loop takes it by shuffle
  auto issue = [&](int i) {
    unsigned char* st = ring + (i % S) * L::kStageBytes;
    const int kv0 = lo + (warp + i * NW) * WK;
    const bool ok = kv0 + lane < hi;
    const long tok = ok ? view.token_at(pages, p0, b, kv0 + lane) : 0;
    const long off = ok ? view.kv_offset(tok, h) : 0;
#pragma unroll 4
    for (int c = lane; c < WK * L::kChunks; c += 32) {
      const int j = c / L::kChunks;
      const int ch = c % L::kChunks;
      const long oj = __shfl_sync(0xffffffffu, off, j) + ch * L::kElems;
      const bool okj = kv0 + j < hi;
      const int at = j * L::kPitch + ch * 16;
      cp_async16(st + at, k + oj, okj);
      cp_async16(st + L::kTileBytes + at, v + oj, okj);
    }
    if (kQuant) {
      float* sc = reinterpret_cast<float*>(st + 2 * L::kTileBytes);
      const long so = ok ? view.scale_offset(tok, h) : 0;
      cp_async4(sc + lane, k_scale + so, ok);
      cp_async4(sc + WK + lane, v_scale + so, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_mine) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<S - 2>();
    // tile i is in (every lane's copies); every lane is done with tile
    // i - 1, whose slot the next issue refills
    __syncwarp();
    if (i + S - 1 < n_mine) issue(i + S - 1);
    cp_async_commit();
    const unsigned char* st = ring + (i % S) * L::kStageBytes;
    const int kv0 = lo + (warp + i * NW) * WK;
    if constexpr (T::kTensor) {
      prod.tile(st, kv0, hi, sm_scale, lane);
    } else {
      const float* sc =
          reinterpret_cast<const float*>(st + 2 * L::kTileBytes);
      prod.tile(st, Qs, P, kv0 + lane < hi, kQuant ? sc[lane] : 1.f,
                kQuant ? sc[WK + lane] : 1.f, sm_scale, lane);
    }
  }

  // merge the warps: the ring is free once every copy has landed and every
  // warp is past its last tile; it holds the warps' [GM][D] sums
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  prod.store(red, Mw, Lw, warp, lane, G);
  __syncthreads();
  for (int c = tid; c < G * D; c += NT) {
    const int g = c / D;
    const int d = c % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, Mw[w * GM + g]);
    float a = 0.f;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {   // a warp without a tile weighs 0
      const float wt = expf(Mw[w * GM + g] - m);
      a += wt * red[(w * GM + g) * D + d];
      l += wt * Lw[w * GM + g];
    }
    const long row = q_row + g;
    if (splits == 1) {
      store1(out + row * D + d, a / fmaxf(l, kMinDenominator));
    } else {
      ws_acc[(row * splits + split) * D + d] = a;
      if (d == 0) {
        ws_m[row * splits + split] = m;
        ws_l[row * splits + split] = l;
      }
    }
  }
}

// Pass 2: grid (Hq, B), kCombineThreads threads; thread d the output
// columns d, d + kCombineThreads, ...
template <typename QT>
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_m,
    const float* __restrict__ ws_l, const int* __restrict__ lengths,
    QT* __restrict__ out, int Hq, int D, int splits, int kps, int span) {
  const int b = blockIdx.y;
  const long row = static_cast<long>(b) * Hq + blockIdx.x;
  int length = lengths[b];
  length = length < 0 ? 0 : (length < span ? length : span);
  const int live = (length + kps - 1) / kps;   // splits pass 1 wrote
  const float* m = ws_m + row * splits;
  const float* l = ws_l + row * splits;
  float m_max = kNegInf;
  for (int s = 0; s < live; ++s) m_max = fmaxf(m_max, m[s]);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float a = 0.f;
    float den = 0.f;
    for (int s = 0; s < live; ++s) {
      const float w = expf(m[s] - m_max);
      den += w * l[s];
      a += w * ws_acc[(row * splits + s) * D + d];
    }
    store1(out + row * D + d, a / fmaxf(den, kMinDenominator));
  }
}

template <typename QT, typename KT, int D, int GM, typename View>
int launch_decode_group(const DecodeArgs& a, const View& view,
                        cudaStream_t stream) {
  using T = DecodeTiling<QT, KT, D, GM>;
  auto kernel = decode_split_kernel<QT, KT, D, GM, View>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.splits, a.Hkv, a.B);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.k_scale, a.v_scale, a.lengths,
      static_cast<QT*>(a.out), a.ws_acc, a.ws_m, a.ws_l, view, a.Hq,
      a.Hq / a.Hkv, a.keys_per_split,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  decode_combine_kernel<QT><<<dim3(a.Hq, a.B), kCombineThreads, 0, stream>>>(
      a.ws_acc, a.ws_m, a.ws_l, a.lengths, static_cast<QT*>(a.out), a.Hq, D,
      a.splits, a.keys_per_split, view.span());
  return static_cast<int>(cudaGetLastError());
}

// Launch both passes on `stream`; returns the CUDA error of the launches
// (0 = launched).
template <typename QT, typename KT, int D, typename View>
int launch_decode(const DecodeArgs& a, const View& view,
                  cudaStream_t stream) {
  if constexpr (uses_tensor_cores<QT, KT>()) {
    return launch_decode_group<QT, KT, D, 16>(a, view, stream);
  } else {
    switch (pad_group(a.Hq / a.Hkv)) {
      case 1: return launch_decode_group<QT, KT, D, 1>(a, view, stream);
      case 4: return launch_decode_group<QT, KT, D, 4>(a, view, stream);
      case 8: return launch_decode_group<QT, KT, D, 8>(a, view, stream);
      default: return launch_decode_group<QT, KT, D, 16>(a, view, stream);
    }
  }
}

// What both C entry points check of the split arguments: -1 if refused.
inline int check_split_args(const DecodeArgs& a, int span) {
  if (a.B <= 0 || a.B > 65535 || a.Hkv <= 0 || a.Hkv > 65535 ||
      a.Hq % a.Hkv != 0 || a.Hq / a.Hkv > kMaxGroup || span <= 0 ||
      a.keys_per_split <= 0 || a.keys_per_split % kWarpKeys != 0 ||
      a.splits != (span + a.keys_per_split - 1) / a.keys_per_split)
    return -1;
  if (a.splits > 1 &&
      (a.ws_acc == nullptr || a.ws_m == nullptr || a.ws_l == nullptr))
    return -1;
  return 0;
}

}  // namespace paged
