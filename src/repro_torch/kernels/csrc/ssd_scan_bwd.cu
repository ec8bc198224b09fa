// Backward of the Mamba2 SSD scan (csrc/ssd_scan.cu), for Hopper
// (sm_90a): the reverse tile walk, with every product on tensor cores.
//
// Has no Pallas counterpart: the reference takes jax.grad of its plain
// ssd_chunked (src/repro/models/mamba2.py).  The wrapper is
// ssd_scan/ops.py::ssd_scan_bwd, its plain version ssd_scan_bwd_ref (whose
// docstring lists the sums below), and the autograd Function SSDScanFn
// runs it after the forward kernel, which wrote the float32 state entering
// each 64-token tile ([b, H, ceil(T / 64), P, N]).
//
// One thread block a (head, batch row) walks that head's tiles from the
// last to the first, carrying dS, the gradient of the state leaving the
// tile (from the final state's cotangent, or 0), in float32 registers.
// With cum the float64 inclusive sum of float32 dt * A in a tile (each
// difference rounded once, the decay masked inside the exponent, as the
// forward), seg its last entry, e_i = exp(cum_i), w_j = exp(seg - cum_j),
// L_ij = exp(cum_i - cum_j) for j <= i, S the entering state, a tile forms
//
//   M_ij = (C_i . B_j) L_ij,   D_ij = (dy_i . x_j) dt_j,   P = D L
//
// and then
//
//   d(xdt)_j = sum_i M_ij dy_i + w_j dS B_j    -> dx_j, ddt_j (direct)
//   dC_i     = e_i S^T dy_i + sum_j P_ij B_j
//   dB_j     = sum_i P_ij C_i + w_j dt_j dS^T x_j
//   dS_in    = exp(seg) dS + sum_i (e_i dy_i)^T C_i
//
// and the gradient of cum: the row sums less the column sums of M * D,
// e_i C_i . S^T dy_i, less R_j = w_j dt_j x_j . dS B_j, and at the last
// entry exp(seg) <dS, S> + sum_j R_j; its reverse cumulative sum
// (float64, in a fixed order) is d(dt A), which adds d(dt A) A to ddt and
// d(dt A) dt to dA.
//
// dB, dC and dA are written for each head (float32); the wrapper sums
// them over the heads of a group (the batch for dA) in a fixed order.  No
// atomics: every sum here runs in a fixed order, so a call is bit-for-bit
// repeatable.  One launch walks every tile: a tile's scalars are formed
// at the tile before, so no slice limit applies.
//
// Products: mma.sync m16n8k16, bf16 operands with float32 sums, every
// operand from shared memory by ldmatrix (row pitches 16 bytes past the
// row, as the forward's pitch()).  An operand held in bf16 enters as it is
// (x, B, C and dy of a bf16 call).  A float32 operand enters as a bf16
// pair hi + lo, and a product runs the pieces (i, j) with i + j < 2: M
// and P (split when they are stored), the entering state S, dS, e dy
// (split in registers, as the forward splits its weighted x) and, in a
// float32 call, x, B, C and dy themselves.  ssd_scan_bwd_ref's p_round
// repeats this rounding; its BWD_P_ROUND says why pairs suffice.  The
// causal products (M, P, M^T dy, P B, P^T C) run only the 16 x 16 blocks
// on or below the diagonal.  Eight warps: in the first pass warp w owns
// rows 16 (w % 4).. of M and P and their column blocks w / 4 and w / 4 + 2
// on or below the diagonal; in the second, rows 16 (w % 4).. and half the
// columns of d(xdt), dC and dB (the causal k-ranges of dC's and dB's
// intra products, r + 1 and 4 - r blocks, even out), and for dS_in the
// forward's state layout.  The warp with no block in the first pass
// finishes the tile before's scalar gradients meanwhile.
//
// Copies: bf16 tiles (x, dy, B, C) come in by 16-byte cp.async one tile
// ahead, in two stages; the next tile's entering state and dt are loaded
// into registers at the top of a tile and split into shared memory at its
// end.  float32 tiles are loaded and split at the end of the tile before,
// into one stage (a second stage of their pairs does not fit beside the
// rest at N 128).
//
// Bound: the bytes at the model's shapes (the gradient's own, PERF.md),
// and beyond them the tile states read and the per-head partials written;
// a walk is a chain of dependent tile steps, each three block barriers
// long.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace ssd_bwd {

using paged::cp_async16;
using paged::cp_async_commit;
using paged::cp_async_wait;
using paged::ldsm_x4;
using paged::ldsm_x4_trans;
using paged::mma_bf16;
using paged::split_bf16;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // tokens of a tile (the forward's kTile)
constexpr int kP = 64;         // head dim
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

static_assert(kTile == kP, "the [64][pitch] planes serve tokens and head dim");

template <typename XT>
struct BwdArgs {
  const XT* x;
  const XT* dt;
  const float* A;
  const XT* B;
  const XT* C;
  const XT* dy;          // [b, T, H, P] contiguous
  const float* dsfin;    // [b, H, P, N] or null (0)
  const float* states;   // [b, H, nt, P, N]
  XT* dx;                // [b, T, H, P]
  float* ddt;            // [b, T, H]
  float* dA;             // [b, H]
  float* dB;             // [b, T, H, N] (per head)
  float* dC;
  float* ds0;            // [b, H, P, N] or null
  int T, H, G;
  long x_sb, x_st, dt_sb, dt_st, bc_sb, bc_st;
};

// bf16 elements of a plane row: 16 bytes past the row, an odd number of
// 16-byte units, so the 8 rows of an ldmatrix 8 x 8 hit 32 distinct banks
__host__ __device__ constexpr int pitch(int width) { return width + 8; }

// Shared memory of a walk block, planes of bf16 pieces first: kStages
// stages of a tile's x, dy, B and C (kIn pieces each), then the pairs of
// the entering state S and of dS ([kP][NP]) and of M and P ([kTile][PP]);
// then two tiles' scalars (cum in float64; e, w, dt) and two tiles'
// partial sums (by tile parity: the tile before's are still being read).
template <int N, typename XT>
struct BwdSmem {
  static constexpr bool kF32In = std::is_same<XT, float>::value;
  static constexpr int kIn = kF32In ? 2 : 1;
  static constexpr int kStages = kF32In ? 1 : 2;
  static constexpr int PP = pitch(kP);
  static constexpr int NP = pitch(N);
  static constexpr int kXPlane = kTile * PP;     // elements
  static constexpr int kNPlane = kTile * NP;     // also S, dS: kP == kTile
  static constexpr int oDY = kIn * kXPlane;      // offsets in a stage
  static constexpr int oB = 2 * kIn * kXPlane;
  static constexpr int oC = oB + kIn * kNPlane;
  static constexpr int kStage = 2 * kIn * (kXPlane + kNPlane);
  static constexpr size_t kPlanes =
      sizeof(bf16) * (kStages * kStage + 4 * kNPlane + 4 * kXPlane);
  static constexpr size_t kScal = kTile * (sizeof(double) + 3 * sizeof(float));
  static constexpr size_t kBytes =
      kPlanes + 2 * kScal + 2 * sizeof(float) * (12 * kTile + kWarps);
  static_assert(kPlanes % 16 == 0 && kScal % 16 == 0, "alignment");
};

// A tile's scalars
struct Scal {
  double* cum;
  float* e;
  float* w;
  float* dt;
};
template <int N, typename XT>
__device__ __forceinline__ Scal scal_at(unsigned char* smem, int par) {
  using L = BwdSmem<N, XT>;
  unsigned char* p = smem + L::kPlanes + par * L::kScal;
  Scal s;
  s.cum = reinterpret_cast<double*>(p);
  s.e = reinterpret_cast<float*>(p + kTile * sizeof(double));
  s.w = s.e + kTile;
  s.dt = s.w + kTile;
  return s;
}

// A tile's partial sums, rows of kTile floats: M * D over the row (two
// halves of the columns) and over each 16-row block of a column, then
// C_i . S^T dy_i, d(xdt)_j . x_j and x_j . dS B_j (two halves each), and
// each warp's part of <dS, S>.
constexpr int kRowQ = 0;
constexpr int kColQ = 2 * kTile;
constexpr int kInts = 6 * kTile;
constexpr int kDir = 8 * kTile;
constexpr int kRsum = 10 * kTile;
constexpr int kRed = 12 * kTile;
constexpr int kPartFloats = 12 * kTile + kWarps;
template <int N, typename XT>
__device__ __forceinline__ float* parts_at(unsigned char* smem, int par) {
  using L = BwdSmem<N, XT>;
  return reinterpret_cast<float*>(smem + L::kPlanes + 2 * L::kScal) +
         par * kPartFloats;
}

// ---- fragments (lane-dependent addresses of one ldmatrix x4) ------------
// A (16 x 16) of rows m0.., columns k0.. of a [m][k] plane
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* p, int pt,
                                       int m0, int k0, int lane) {
  ldsm_x4(a, p + (m0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * pt + k0 +
                 (lane >> 4) * 8);
}
// A of rows m0.., columns k0.. of the transpose of a [k][m] plane
__device__ __forceinline__ void frag_at(uint32_t a[4], const bf16* p, int pt,
                                        int m0, int k0, int lane) {
  ldsm_x4_trans(a, p + (k0 + (lane >> 4) * 8 + (lane & 7)) * pt + m0 +
                       ((lane >> 3) & 1) * 8);
}
// B of the n-tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]), k-rows k0..,
// from a [n][k] plane
__device__ __forceinline__ void frag_b(uint32_t b[4], const bf16* p, int pt,
                                       int n0, int k0, int lane) {
  ldsm_x4(b, p + (n0 + (lane >> 4) * 8 + (lane & 7)) * pt + k0 +
                 ((lane >> 3) & 1) * 8);
}
// the same from a [k][n] plane
__device__ __forceinline__ void frag_bt(uint32_t b[4], const bf16* p, int pt,
                                        int n0, int k0, int lane) {
  ldsm_x4_trans(b, p + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * pt + n0 +
                       (lane >> 4) * 8);
}

// acc[0], acc[1] (the n-tiles of b) += the products of the pieces a[i]
// (KA of them) and b[j] (KB) with i + j < 2
template <int KA, int KB>
__device__ __forceinline__ void mma_pieces(float (*acc)[4], uint32_t (*a)[4],
                                           uint32_t (*b)[4]) {
#pragma unroll
  for (int i = 0; i < KA; ++i)
#pragma unroll
    for (int j = 0; j < KB && i + j < 2; ++j) {
      mma_bf16(acc[0], a[i], b[j][0], b[j][1]);
      mma_bf16(acc[1], a[i], b[j][2], b[j][3]);
    }
}

// (v0, v1) of a bf16x2 word, summed over K pieces planes apart
template <int K>
__device__ __forceinline__ float2 piece_sum(const bf16* p, int plane) {
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p + k * plane));
    v.x += u.x;
    v.y += u.y;
  }
  return v;
}

// (v0, v1) as a pair into two planes
__device__ __forceinline__ void store_pair(bf16* p, int plane, float v0,
                                           float v1) {
  uint32_t hi, lo;
  split_bf16(v0, v1, hi, lo);
  *reinterpret_cast<uint32_t*>(p) = hi;
  *reinterpret_cast<uint32_t*>(p + plane) = lo;
}

// four values as a pair into two planes
__device__ __forceinline__ void store_pair4(bf16* p, int plane, float4 v) {
  uint32_t h01, l01, h23, l23;
  split_bf16(v.x, v.y, h01, l01);
  split_bf16(v.z, v.w, h23, l23);
  *reinterpret_cast<uint2*>(p) = make_uint2(h01, h23);
  *reinterpret_cast<uint2*>(p + plane) = make_uint2(l01, l23);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// sum over a warp, in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// sum over the four lanes of a row (lane & 3), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// sum over the eight rows of a column (lane >> 2), in a fixed order
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// ---- copies ---------------------------------------------------------------
// Rows [0, kTile) of a bf16 [T][W] operand (row r at src + r * stride)
// into a [kTile][pitch(W)] plane by 16-byte cp.async, zero past n_rows;
// the caller commits and waits.
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long stride, int n_rows) {
  constexpr int WP = pitch(W);
  constexpr int CH = W / 8;       // 16-byte chunks a row
  constexpr int kChunks = kTile * CH;
#pragma unroll
  for (int k = 0; k < (kChunks + kThreads - 1) / kThreads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (kChunks % kThreads != 0 && e >= kChunks) break;
    const int r = e / CH;
    const int c = (e % CH) * 8;
    const bool ok = r < n_rows;
    cp_async16(dst + r * WP + c, src + (ok ? r : 0) * stride + c, ok);
  }
}

// The same for a float32 operand, loaded into registers and split into a
// pair of planes `plane` elements apart.
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const float* src,
                                          long stride, int n_rows,
                                          int plane) {
  constexpr int WP = pitch(W);
  constexpr int W4 = W / 4;
  constexpr int kItems = kTile * W4 / kThreads;
  static_assert(kTile * W4 % kThreads == 0, "items");
  float4 v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int r = e / W4;
    v[k] = r < n_rows ? *reinterpret_cast<const float4*>(src + r * stride +
                                                         (e % W4) * 4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int e = threadIdx.x + k * kThreads;
    store_pair4(dst + (e / W4) * WP + (e % W4) * 4, plane, v[k]);
  }
}

// Tile c's x, dy, B and C into a stage (x's planes, dy's, B's, C's).
template <int N, typename XT>
__device__ __forceinline__ void load_stage(const BwdArgs<XT>& a, bf16* stage,
                                           int c, int h, int bb, int grp) {
  using L = BwdSmem<N, XT>;
  const int t0 = c * kTile;
  const int n_rows = min(kTile, a.T - t0);
  const XT* x = a.x + bb * a.x_sb + static_cast<long>(t0) * a.x_st + h * kP;
  const XT* dy = a.dy + ((static_cast<long>(bb) * a.T + t0) * a.H + h) * kP;
  const long bc = bb * a.bc_sb + static_cast<long>(t0) * a.bc_st + grp * N;
  const long dy_st = static_cast<long>(a.H) * kP;
  if constexpr (L::kF32In) {
    load_tile<kP>(stage, x, a.x_st, n_rows, L::kXPlane);
    load_tile<kP>(stage + L::oDY, dy, dy_st, n_rows, L::kXPlane);
    load_tile<N>(stage + L::oB, a.B + bc, a.bc_st, n_rows, L::kNPlane);
    load_tile<N>(stage + L::oC, a.C + bc, a.bc_st, n_rows, L::kNPlane);
  } else {
    load_tile<kP>(stage, x, a.x_st, n_rows);
    load_tile<kP>(stage + L::oDY, dy, dy_st, n_rows);
    load_tile<N>(stage + L::oB, a.B + bc, a.bc_st, n_rows);
    load_tile<N>(stage + L::oC, a.C + bc, a.bc_st, n_rows);
  }
}

// A tile's entering state [kP][N] (float32, contiguous) into registers:
// kItems float4 a thread, item e the four values at 4 e.
template <int N>
struct StateLoad {
  static constexpr int kItems = kP * N / 4 / kThreads;
  static_assert(kP * N / 4 % kThreads == 0, "items");
  float4 v[kItems];

  __device__ __forceinline__ void fetch(const float* src) {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      v[k] = *reinterpret_cast<const float4*>(
          src + 4 * (threadIdx.x + k * kThreads));
  }
  // as a pair into [kP][pitch(N)] planes
  __device__ __forceinline__ void store(bf16* Ss) const {
    constexpr int N4 = N / 4;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int e = threadIdx.x + k * kThreads;
      store_pair4(Ss + (e / N4) * pitch(N) + (e % N4) * 4, kP * pitch(N),
                  v[k]);
    }
  }
};

// A warp: a tile's step sizes, lanes j and j + 32 (0 past n_rows).
template <typename XT>
__device__ __forceinline__ float2 fetch_dt(const XT* dt, long stride,
                                           int n_rows, int lane) {
  float d[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = lane + 32 * e;
    d[e] = j < n_rows ? to_float(dt[j * stride]) : 0.f;
  }
  return make_float2(d[0], d[1]);
}

// A warp: a tile's cum (the float64 inclusive sum of float32 dt * A; the
// padding adds 0, so cum[kTile - 1] is seg), e = exp(cum), w = exp(seg -
// cum) and dt.
__device__ __forceinline__ void tile_scalars(float2 d, float A_h, Scal s,
                                             int lane) {
  double carry = 0.0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = lane + 32 * e;
    const float dv = e == 0 ? d.x : d.y;
    s.dt[j] = dv;
    double v = static_cast<double>(dv * A_h);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    s.cum[j] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = lane + 32 * e;
    s.e[j] = expf(static_cast<float>(s.cum[j]));
    s.w[j] = expf(static_cast<float>(carry - s.cum[j]));
  }
}

// ---- the carried dS, in the forward's state layout ----------------------
// warp w owns rows p0 = 16 (w % 4) (lanes' rows p0 + lane / 4 and + 8) and
// the pairs of 8-column n-tiles from pair w / 4 on, every other one.
template <int N>
struct StateTiles {
  static constexpr int kPairs = N / 16;
  static constexpr int kMine = (kPairs + 1) / 2;
  // first n-tile of this warp's pair q, or -1
  __device__ __forceinline__ static int tile(int warp, int q) {
    const int n = 2 * (warp / 4 + 2 * q);
    return n < N / 8 ? n : -1;
  }
};

// Each element pair (row, column, +1) of the carried dS, as f(row, col,
// v0&, v1&).
template <int N, typename F>
__device__ __forceinline__ void for_state(float s[][2][4], int warp, int lane,
                                          F f) {
  using St = StateTiles<N>;
  const int row = (warp % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int q = 0; q < St::kMine; ++q) {
    const int n = St::tile(warp, q);
    if (n < 0) break;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        f(row + 8 * rh, (n + u) * 8 + col, s[q][u][2 * rh],
          s[q][u][2 * rh + 1]);
  }
}

// ---- the passes -----------------------------------------------------------
// Pass 1 of a tile: warp w's rows i0 = 16 (w % 4).. of M and P, at its
// column blocks w / 4 and w / 4 + 2 on or below the diagonal, into their
// pair planes; the sums of M * D over its columns (rowQ) and over each of
// its blocks' 16 rows (colQ).
template <int N, typename XT>
__device__ __forceinline__ void pass_scores(const bf16* st, bf16* Ms,
                                            bf16* Ps, Scal sc, float* pt,
                                            int warp, int lane) {
  using L = BwdSmem<N, XT>;
  constexpr int kIn = L::kIn;
  constexpr int PP = L::PP;
  constexpr int NP = L::NP;
  const bf16* Xs = st;
  const bf16* DYs = st + L::oDY;
  const bf16* Bs = st + L::oB;
  const bf16* Cs = st + L::oC;
  const int I = warp % 4;
  const int part = warp / 4;
  const int tq = lane & 3;
  const int ia = 16 * I + (lane >> 2);
  const int ib = ia + 8;
  const double cum_a = sc.cum[ia];
  const double cum_b = sc.cum[ib];
  float row_a = 0.f, row_b = 0.f;
#pragma unroll
  for (int gi = 0; gi < 2; ++gi) {
    const int J = part + 2 * gi;
    if (J > I) break;
    const int j0 = 16 * J;
    float m[2][4] = {}, d[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t ca[kIn][4], bf[kIn][4];
#pragma unroll
      for (int i = 0; i < kIn; ++i) {
        frag_a(ca[i], Cs + i * L::kNPlane, NP, 16 * I, 16 * ks, lane);
        frag_b(bf[i], Bs + i * L::kNPlane, NP, j0, 16 * ks, lane);
      }
      mma_pieces<kIn, kIn>(m, ca, bf);
    }
#pragma unroll
    for (int ks = 0; ks < kP / 16; ++ks) {
      uint32_t da[kIn][4], xb[kIn][4];
#pragma unroll
      for (int i = 0; i < kIn; ++i) {
        frag_a(da[i], DYs + i * L::kXPlane, PP, 16 * I, 16 * ks, lane);
        frag_b(xb[i], Xs + i * L::kXPlane, PP, j0, 16 * ks, lane);
      }
      mma_pieces<kIn, kIn>(d, da, xb);
    }
    // M = (C B^T) L and P = D L, D = (dy x^T) dt_j; Q = M D
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float col[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 8 * q + 2 * tq + e;
        const double cj = sc.cum[j];
        const float dj = sc.dt[j];
        const float la =
            expf(ia >= j ? static_cast<float>(cum_a - cj) : kNegInf);
        const float lb =
            expf(ib >= j ? static_cast<float>(cum_b - cj) : kNegInf);
        const float ma = m[q][e] * la, mb = m[q][2 + e] * lb;
        const float da = d[q][e] * dj, db = d[q][2 + e] * dj;
        const float qa = ma * da, qb = mb * db;
        row_a += qa;
        row_b += qb;
        col[e] = column_sum(qa + qb);
        m[q][e] = ma;
        m[q][2 + e] = mb;
        d[q][e] = da * la;
        d[q][2 + e] = db * lb;
      }
      const int cc = j0 + 8 * q + 2 * tq;
      store_pair(Ms + ia * PP + cc, L::kXPlane, m[q][0], m[q][1]);
      store_pair(Ms + ib * PP + cc, L::kXPlane, m[q][2], m[q][3]);
      store_pair(Ps + ia * PP + cc, L::kXPlane, d[q][0], d[q][1]);
      store_pair(Ps + ib * PP + cc, L::kXPlane, d[q][2], d[q][3]);
      if (lane < 4) {
        pt[kColQ + I * kTile + cc] = col[0];
        pt[kColQ + I * kTile + cc + 1] = col[1];
      }
    }
  }
  row_a = quad_sum(row_a);
  row_b = quad_sum(row_b);
  if (tq == 0) {
    pt[kRowQ + part * kTile + ia] = row_a;
    pt[kRowQ + part * kTile + ib] = row_b;
  }
}

// d(xdt)_j = sum_{i >= j} M_ij dy_i + w_j dS B_j for warp w's rows j0 =
// 16 (w % 4).. and columns p0 = 32 (w / 4)..: dx = d(xdt) dt_j written;
// the partials d(xdt)_j . x_j and x_j . dS B_j over its columns.
template <int N, typename XT>
__device__ __forceinline__ void pass_dxdt(const BwdArgs<XT>& a,
                                          const bf16* st, const bf16* dSs,
                                          const bf16* Ms, Scal sc, float* pt,
                                          int t0, int n_rows, int h, int bb,
                                          int warp, int lane) {
  using L = BwdSmem<N, XT>;
  constexpr int kIn = L::kIn;
  constexpr int PP = L::PP;
  constexpr int NP = L::NP;
  const bf16* Xs = st;
  const bf16* DYs = st + L::oDY;
  const bf16* Bs = st + L::oB;
  const int r = warp % 4;
  const int half = warp / 4;
  const int j0 = 16 * r;
  const int p0 = 32 * half;
  const int tq = lane & 3;
  const int ja = j0 + (lane >> 2);
  const int jb = ja + 8;
  float acc[4][4] = {};
  // dS B_j: B's rows as A, dS^T from dS's [p][n] pair planes
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t ba[kIn][4];
#pragma unroll
    for (int i = 0; i < kIn; ++i)
      frag_a(ba[i], Bs + i * L::kNPlane, NP, j0, 16 * ks, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t db[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        frag_b(db[k], dSs + k * L::kNPlane, NP, p0 + 16 * u, 16 * ks, lane);
      mma_pieces<kIn, 2>(acc + 2 * u, ba, db);
    }
  }
  // x at the accumulators' places; x_j . dS B_j, then w_j dS B_j
  float xv[4][4];
  float rs_a = 0.f, rs_b = 0.f;
  const float wa = sc.w[ja], wb = sc.w[jb];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int cc = p0 + 8 * v + 2 * tq;
    const float2 xa = piece_sum<kIn>(Xs + ja * PP + cc, L::kXPlane);
    const float2 xb = piece_sum<kIn>(Xs + jb * PP + cc, L::kXPlane);
    xv[v][0] = xa.x;
    xv[v][1] = xa.y;
    xv[v][2] = xb.x;
    xv[v][3] = xb.y;
    rs_a += xa.x * acc[v][0] + xa.y * acc[v][1];
    rs_b += xb.x * acc[v][2] + xb.y * acc[v][3];
    acc[v][0] *= wa;
    acc[v][1] *= wa;
    acc[v][2] *= wb;
    acc[v][3] *= wb;
  }
  // + M^T dy over the row blocks I >= r: M^T from M's [i][j] planes
  for (int I = r; I < 4; ++I) {
    uint32_t ma[2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      frag_at(ma[k], Ms + k * L::kXPlane, PP, j0, 16 * I, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t yb[kIn][4];
#pragma unroll
      for (int i = 0; i < kIn; ++i)
        frag_bt(yb[i], DYs + i * L::kXPlane, PP, p0 + 16 * u, 16 * I, lane);
      mma_pieces<2, kIn>(acc + 2 * u, ma, yb);
    }
  }
  float dir_a = 0.f, dir_b = 0.f;
  const float dta = sc.dt[ja], dtb = sc.dt[jb];
  XT* dxa = a.dx + ((static_cast<long>(bb) * a.T + t0 + ja) * a.H + h) * kP;
  XT* dxb = a.dx + ((static_cast<long>(bb) * a.T + t0 + jb) * a.H + h) * kP;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int cc = p0 + 8 * v + 2 * tq;
    dir_a += acc[v][0] * xv[v][0] + acc[v][1] * xv[v][1];
    dir_b += acc[v][2] * xv[v][2] + acc[v][3] * xv[v][3];
    if (ja < n_rows) store2(dxa + cc, acc[v][0] * dta, acc[v][1] * dta);
    if (jb < n_rows) store2(dxb + cc, acc[v][2] * dtb, acc[v][3] * dtb);
  }
  dir_a = quad_sum(dir_a);
  dir_b = quad_sum(dir_b);
  rs_a = quad_sum(rs_a);
  rs_b = quad_sum(rs_b);
  if (tq == 0) {
    pt[kDir + half * kTile + ja] = dir_a;
    pt[kDir + half * kTile + jb] = dir_b;
    pt[kRsum + half * kTile + ja] = rs_a;
    pt[kRsum + half * kTile + jb] = rs_b;
  }
}

// The N-wide outputs dC and dB: warp w's rows 16 (w % 4).. and its half
// of the pairs of n-tiles (at N 16, one pair: the warps w < 4 take it).
template <int N>
struct HalfCols {
  static constexpr int kPairs = N / 16;
  static constexpr int kMine = kPairs >= 2 ? kPairs / 2 : 1;
  static constexpr int kChunk = kMine < 2 ? kMine : 2;   // pairs at a time
  __device__ __forceinline__ static bool active(int warp) {
    return kPairs >= 2 || warp < 4;
  }
  __device__ __forceinline__ static int n0(int warp) {
    return (warp / 4) * kMine * 16;
  }
};

// dC_i = e_i S^T dy_i + sum_{j <= i} P_ij B_j; the partial C_i . S^T dy_i
// over the warp's columns.  The columns go kChunk pairs of n-tiles at a
// time (fewer sums in registers beside the carried dS).
template <int N, typename XT>
__device__ __forceinline__ void pass_dC(const BwdArgs<XT>& a, const bf16* st,
                                        const bf16* Ss, const bf16* Ps,
                                        Scal sc, float* pt, int t0,
                                        int n_rows, int h, int bb, int warp,
                                        int lane) {
  using L = BwdSmem<N, XT>;
  using Hc = HalfCols<N>;
  constexpr int kIn = L::kIn;
  constexpr int PP = L::PP;
  constexpr int NP = L::NP;
  const bf16* DYs = st + L::oDY;
  const bf16* Bs = st + L::oB;
  const bf16* Cs = st + L::oC;
  const int r = warp % 4;
  const int i0 = 16 * r;
  const int tq = lane & 3;
  const int ia = i0 + (lane >> 2);
  const int ib = ia + 8;
  const float ea = sc.e[ia], eb = sc.e[ib];
  float* dca = a.dC + ((static_cast<long>(bb) * a.T + t0 + ia) * a.H + h) * N;
  float* dcb = a.dC + ((static_cast<long>(bb) * a.T + t0 + ib) * a.H + h) * N;
  float it_a = 0.f, it_b = 0.f;
  if (Hc::active(warp)) {
#pragma unroll 1
    for (int u0 = 0; u0 < Hc::kMine; u0 += Hc::kChunk) {
      const int n0 = Hc::n0(warp) + 16 * u0;
      float acc[2 * Hc::kChunk][4] = {};
      // S^T dy_i: dy's rows as A, S from its [p][n] pair planes
#pragma unroll
      for (int ks = 0; ks < kP / 16; ++ks) {
        uint32_t da[kIn][4];
#pragma unroll
        for (int i = 0; i < kIn; ++i)
          frag_a(da[i], DYs + i * L::kXPlane, PP, i0, 16 * ks, lane);
#pragma unroll
        for (int u = 0; u < Hc::kChunk; ++u) {
          uint32_t sb[2][4];
#pragma unroll
          for (int k = 0; k < 2; ++k)
            frag_bt(sb[k], Ss + k * L::kNPlane, NP, n0 + 16 * u, 16 * ks,
                    lane);
          mma_pieces<kIn, 2>(acc + 2 * u, da, sb);
        }
      }
#pragma unroll
      for (int v = 0; v < 2 * Hc::kChunk; ++v) {
        const int cc = n0 + 8 * v + 2 * tq;
        const float2 ca = piece_sum<kIn>(Cs + ia * NP + cc, L::kNPlane);
        const float2 cb = piece_sum<kIn>(Cs + ib * NP + cc, L::kNPlane);
        it_a += ca.x * acc[v][0] + ca.y * acc[v][1];
        it_b += cb.x * acc[v][2] + cb.y * acc[v][3];
        acc[v][0] *= ea;
        acc[v][1] *= ea;
        acc[v][2] *= eb;
        acc[v][3] *= eb;
      }
      // + P B over the column blocks J <= r
      for (int J = 0; J <= r; ++J) {
        uint32_t pa[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k)
          frag_a(pa[k], Ps + k * L::kXPlane, PP, i0, 16 * J, lane);
#pragma unroll
        for (int u = 0; u < Hc::kChunk; ++u) {
          uint32_t bbf[kIn][4];
#pragma unroll
          for (int i = 0; i < kIn; ++i)
            frag_bt(bbf[i], Bs + i * L::kNPlane, NP, n0 + 16 * u, 16 * J,
                    lane);
          mma_pieces<2, kIn>(acc + 2 * u, pa, bbf);
        }
      }
#pragma unroll
      for (int v = 0; v < 2 * Hc::kChunk; ++v) {
        const int cc = n0 + 8 * v + 2 * tq;
        if (ia < n_rows) store2(dca + cc, acc[v][0], acc[v][1]);
        if (ib < n_rows) store2(dcb + cc, acc[v][2], acc[v][3]);
      }
    }
  }
  it_a = quad_sum(it_a);
  it_b = quad_sum(it_b);
  if (tq == 0) {
    pt[kInts + (warp / 4) * kTile + ia] = it_a;
    pt[kInts + (warp / 4) * kTile + ib] = it_b;
  }
}

// dB_j = sum_{i >= j} P_ij C_i + w_j dt_j dS^T x_j, kChunk pairs of
// n-tiles at a time.
template <int N, typename XT>
__device__ __forceinline__ void pass_dB(const BwdArgs<XT>& a, const bf16* st,
                                        const bf16* dSs, const bf16* Ps,
                                        Scal sc, int t0, int n_rows, int h,
                                        int bb, int warp, int lane) {
  using L = BwdSmem<N, XT>;
  using Hc = HalfCols<N>;
  constexpr int kIn = L::kIn;
  constexpr int PP = L::PP;
  constexpr int NP = L::NP;
  if (!Hc::active(warp)) return;
  const bf16* Xs = st;
  const bf16* Cs = st + L::oC;
  const int r = warp % 4;
  const int j0 = 16 * r;
  const int tq = lane & 3;
  const int ja = j0 + (lane >> 2);
  const int jb = ja + 8;
  const float wa = sc.w[ja] * sc.dt[ja], wb = sc.w[jb] * sc.dt[jb];
  float* dba = a.dB + ((static_cast<long>(bb) * a.T + t0 + ja) * a.H + h) * N;
  float* dbb = a.dB + ((static_cast<long>(bb) * a.T + t0 + jb) * a.H + h) * N;
#pragma unroll 1
  for (int u0 = 0; u0 < Hc::kMine; u0 += Hc::kChunk) {
    const int n0 = Hc::n0(warp) + 16 * u0;
    float acc[2 * Hc::kChunk][4] = {};
    // dS^T x_j: x's rows as A, dS from its [p][n] pair planes
#pragma unroll
    for (int ks = 0; ks < kP / 16; ++ks) {
      uint32_t xa[kIn][4];
#pragma unroll
      for (int i = 0; i < kIn; ++i)
        frag_a(xa[i], Xs + i * L::kXPlane, PP, j0, 16 * ks, lane);
#pragma unroll
      for (int u = 0; u < Hc::kChunk; ++u) {
        uint32_t db[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k)
          frag_bt(db[k], dSs + k * L::kNPlane, NP, n0 + 16 * u, 16 * ks,
                  lane);
        mma_pieces<kIn, 2>(acc + 2 * u, xa, db);
      }
    }
#pragma unroll
    for (int v = 0; v < 2 * Hc::kChunk; ++v) {
      acc[v][0] *= wa;
      acc[v][1] *= wa;
      acc[v][2] *= wb;
      acc[v][3] *= wb;
    }
    // + P^T C over the row blocks I >= r: P^T from P's [i][j] planes
    for (int I = r; I < 4; ++I) {
      uint32_t pa[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        frag_at(pa[k], Ps + k * L::kXPlane, PP, j0, 16 * I, lane);
#pragma unroll
      for (int u = 0; u < Hc::kChunk; ++u) {
        uint32_t cbf[kIn][4];
#pragma unroll
        for (int i = 0; i < kIn; ++i)
          frag_bt(cbf[i], Cs + i * L::kNPlane, NP, n0 + 16 * u, 16 * I,
                  lane);
        mma_pieces<2, kIn>(acc + 2 * u, pa, cbf);
      }
    }
#pragma unroll
    for (int v = 0; v < 2 * Hc::kChunk; ++v) {
      const int cc = n0 + 8 * v + 2 * tq;
      if (ja < n_rows) store2(dba + cc, acc[v][0], acc[v][1]);
      if (jb < n_rows) store2(dbb + cc, acc[v][2], acc[v][3]);
    }
  }
}

// dS = exp(seg) dS + (e dy)^T C over the tile, in the registers: A = dy^T
// from dy's [i][p] planes by ldmatrix.trans, each value (its pieces
// summed) times e_i and cut into a pair; C from its [i][n] planes.
template <int N, typename XT>
__device__ __forceinline__ void pass_ds(float ds[][2][4], float E,
                                        const bf16* st, Scal sc, int warp,
                                        int lane) {
  using L = BwdSmem<N, XT>;
  using St = StateTiles<N>;
  constexpr int kIn = L::kIn;
  const bf16* DYs = st + L::oDY;
  const bf16* Cs = st + L::oC;
  const int tq = lane & 3;
  const int p0 = (warp % 4) * 16;
#pragma unroll
  for (int q = 0; q < St::kMine; ++q)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[q][u][e] *= E;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t yr[kIn][4];
#pragma unroll
    for (int i = 0; i < kIn; ++i)
      frag_at(yr[i], DYs + i * L::kXPlane, L::PP, p0, 16 * kk, lane);
    uint32_t af[2][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {   // rows p0 + g (+8); tokens 2 tq, +1 (+8)
      const int j = kk * 16 + (r >> 1) * 8 + 2 * tq;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int i = 0; i < kIn; ++i) {
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&yr[i][r]));
        v0 += y.x;
        v1 += y.y;
      }
      split_bf16(v0 * sc.e[j], v1 * sc.e[j + 1], af[0][r], af[1][r]);
    }
#pragma unroll
    for (int q = 0; q < St::kMine; ++q) {
      const int n = St::tile(warp, q);
      if (n < 0) break;
      uint32_t cb[kIn][4];
#pragma unroll
      for (int i = 0; i < kIn; ++i)
        frag_bt(cb[i], Cs + i * L::kNPlane, L::NP, 8 * n, 16 * kk, lane);
      mma_pieces<2, kIn>(ds[q], af, cb);
    }
  }
}

// A warp: tile cf's gradient of cum from its partials, its reverse
// cumulative sum (float64), ddt written and dA's share added.
template <typename XT>
__device__ __forceinline__ void finish_tile(const BwdArgs<XT>& a, Scal sc,
                                            const float* pt, int cf, int bb,
                                            int h, float A_h, int lane,
                                            double& dA_acc) {
  const int t0 = cf * kTile;
  const int n_rows = min(kTile, a.T - t0);
  const float E = expf(static_cast<float>(sc.cum[kTile - 1]));
  float dcum[2], dir[2], rj[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = lane + 32 * e;
    const float rq = pt[kRowQ + j] + pt[kRowQ + kTile + j];
    float cq = 0.f;
    for (int I = j / 16; I < 4; ++I) cq += pt[kColQ + I * kTile + j];
    const float it = pt[kInts + j] + pt[kInts + kTile + j];
    dir[e] = pt[kDir + j] + pt[kDir + kTile + j];
    rj[e] = sc.w[j] * sc.dt[j] * (pt[kRsum + j] + pt[kRsum + kTile + j]);
    dcum[e] = rq - cq + sc.e[j] * it - rj[e];
  }
  float sds = 0.f;
  for (int w = 0; w < kWarps; ++w) sds += pt[kRed + w];
  const float dseg = E * sds + warp_sum(rj[0] + rj[1]);
  if (lane == 31) dcum[1] += dseg;
  // da_k = sum_{i >= k} dcum_i: the upper half, then the lower
  double hi = dcum[1], lo = dcum[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, hi, o);
    const double v = __shfl_down_sync(0xffffffffu, lo, o);
    if (lane + o < 32) {
      hi += u;
      lo += v;
    }
  }
  lo += __shfl_sync(0xffffffffu, hi, 0);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = lane + 32 * e;
    const double da = e == 0 ? lo : hi;
    if (j < n_rows)
      a.ddt[(static_cast<long>(bb) * a.T + t0 + j) * a.H + h] =
          dir[e] + static_cast<float>(da) * A_h;
    dA_acc += da * sc.dt[j];
  }
}

// One (head, batch row): its tiles from the last to the first.  Each tile
// takes three block barriers: its inputs are in; M, P and their sums are
// in; every pass has read the tile's planes.
template <int N, typename XT>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(BwdArgs<XT> a) {
  using L = BwdSmem<N, XT>;
  constexpr int kFin = 4;           // the warp with no block in pass 1
  static_assert(N % 16 == 0 && N >= 16, "tiling");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  bf16* Ss = stages + L::kStages * L::kStage;   // [2][kP][NP]
  bf16* dSs = Ss + 2 * L::kNPlane;              // [2][kP][NP]
  bf16* Ms = dSs + 2 * L::kNPlane;              // [2][kTile][PP]
  bf16* Ps = Ms + 2 * L::kXPlane;               // [2][kTile][PP]

  const int h = blockIdx.x;
  const int bb = blockIdx.y;
  const int grp = h / (a.H / a.G);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nt = (a.T + kTile - 1) / kTile;
  const long head = static_cast<long>(bb) * a.H + h;
  const float A_h = a.A[h];
  const float* states = a.states + head * nt * (kP * N);
  auto dt_of = [&](int c) {
    const long t0 = static_cast<long>(c) * kTile;
    return fetch_dt(a.dt + bb * a.dt_sb + t0 * a.dt_st + h, a.dt_st,
                    min(kTile, a.T - c * kTile), lane);
  };
  auto publish = [&](float s[][2][4]) {   // dS's pair planes
    for_state<N>(s, warp, lane, [&](int r, int col, float& v0, float& v1) {
      store_pair(dSs + r * L::NP + col, L::kNPlane, v0, v1);
    });
  };

  // dS of the last tile: the final state's cotangent
  float ds[StateTiles<N>::kMine][2][4];
  const float* dsf = a.dsfin != nullptr ? a.dsfin + head * (kP * N) : nullptr;
  for_state<N>(ds, warp, lane, [&](int r, int col, float& v0, float& v1) {
    const float2 v = dsf != nullptr
                         ? *reinterpret_cast<const float2*>(dsf + r * N + col)
                         : make_float2(0.f, 0.f);
    v0 = v.x;
    v1 = v.y;
  });
  publish(ds);
  // the last tiles' inputs, the last tile's state and scalars
  if constexpr (L::kF32In) {
    load_stage<N>(a, stages, nt - 1, h, bb, grp);
  } else {
    load_stage<N>(a, stages + ((nt - 1) & 1) * L::kStage, nt - 1, h, bb, grp);
    cp_async_commit();
    if (nt >= 2)
      load_stage<N>(a, stages + (nt & 1) * L::kStage, nt - 2, h, bb, grp);
    cp_async_commit();
  }
  {
    StateLoad<N> s;
    s.fetch(states + (nt - 1) * (kP * N));
    s.store(Ss);
  }
  if (warp == 1) tile_scalars(dt_of(nt - 1), A_h,
                              scal_at<N, XT>(smem, (nt - 1) & 1), lane);
  double dA_acc = 0.0;              // warp kFin's lanes' shares

  for (int c = nt - 1; c >= 0; --c) {
    const int par = c & 1;
    const int t0 = c * kTile;
    const int n_rows = min(kTile, a.T - t0);
    const bf16* st = stages + (L::kF32In ? 0 : par * L::kStage);
    const Scal sc = scal_at<N, XT>(smem, par);
    float* pt = parts_at<N, XT>(smem, par);
    if constexpr (!L::kF32In) cp_async_wait<1>();
    __syncthreads();                // tile c, its S and scalars, dS are in
    // the tile before's step sizes and entering state, into registers
    float2 dt_next = make_float2(0.f, 0.f);
    if (warp == 1 && c > 0) dt_next = dt_of(c - 1);
    StateLoad<N> s_next;
    if (c > 0) s_next.fetch(states + (c - 1) * (kP * N));

    // pass 1: M and P; meanwhile the free warp finishes tile c + 1
    if (warp == kFin && c + 1 < nt)
      finish_tile(a, scal_at<N, XT>(smem, par ^ 1),
                  parts_at<N, XT>(smem, par ^ 1), c + 1, bb, h, A_h, lane,
                  dA_acc);
    pass_scores<N, XT>(st, Ms, Ps, sc, pt, warp, lane);
    __syncthreads();                // M, P and their sums are in

    // pass 2: <dS, S> (before dS moves on), d(xdt), dC, dB, dS_in
    {
      float sds = 0.f;
      for_state<N>(ds, warp, lane, [&](int r, int col, float& v0, float& v1) {
        const float2 sv = piece_sum<2>(Ss + r * L::NP + col, L::kNPlane);
        sds += v0 * sv.x + v1 * sv.y;
      });
      sds = warp_sum(sds);
      if (lane == 0) pt[kRed + warp] = sds;
    }
    pass_ds<N, XT>(ds, expf(static_cast<float>(sc.cum[kTile - 1])), st, sc,
                   warp, lane);
    pass_dxdt<N, XT>(a, st, dSs, Ms, sc, pt, t0, n_rows, h, bb, warp, lane);
    pass_dC<N, XT>(a, st, Ss, Ps, sc, pt, t0, n_rows, h, bb, warp, lane);
    pass_dB<N, XT>(a, st, dSs, Ps, sc, t0, n_rows, h, bb, warp, lane);
    __syncthreads();                // every pass has read the tile's planes

    if (c > 0) {
      publish(ds);
      s_next.store(Ss);
      if (warp == 1)
        tile_scalars(dt_next, A_h, scal_at<N, XT>(smem, par ^ 1), lane);
      if constexpr (L::kF32In) {
        load_stage<N>(a, stages, c - 1, h, bb, grp);
      } else {
        if (c >= 2)
          load_stage<N>(a, stages + par * L::kStage, c - 2, h, bb, grp);
        cp_async_commit();
      }
    }
  }

  if (warp == kFin) {
    finish_tile(a, scal_at<N, XT>(smem, 0), parts_at<N, XT>(smem, 0), 0, bb,
                h, A_h, lane, dA_acc);
    double v = dA_acc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) a.dA[head] = static_cast<float>(v);
  }
  if (a.ds0 != nullptr) {
    float* out = a.ds0 + head * (kP * N);
    for_state<N>(ds, warp, lane, [&](int r, int col, float& v0, float& v1) {
      store2(out + r * N + col, v0, v1);
    });
  }
}

template <int N, typename XT>
int launch(const BwdArgs<XT>& a, int b, cudaStream_t stream) {
  auto kernel = ssd_bwd_kernel<N, XT>;
  constexpr size_t smem = BwdSmem<N, XT>::kBytes;
  static_assert(smem <= 227 * 1024, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.H, b), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int run(const BwdArgs<XT>& a, int b, int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<16, XT>(a, b, stream);
    case 32:
      return launch<32, XT>(a, b, stream);
    case 64:
      return launch<64, XT>(a, b, stream);
    case 128:
      return launch<128, XT>(a, b, stream);
    default:
      return -1;
  }
}

template <typename XT>
BwdArgs<XT> make_args(const void* x, const void* dt, const float* A,
                      const void* B, const void* C, const void* dy,
                      const float* dsfin, const float* states, void* dx,
                      float* ddt, float* dA, float* dB, float* dC,
                      float* ds0, int T, int H, int G, long x_sb, long x_st,
                      long dt_sb, long dt_st, long bc_sb, long bc_st) {
  BwdArgs<XT> a;
  a.x = static_cast<const XT*>(x);
  a.dt = static_cast<const XT*>(dt);
  a.A = A;
  a.B = static_cast<const XT*>(B);
  a.C = static_cast<const XT*>(C);
  a.dy = static_cast<const XT*>(dy);
  a.dsfin = dsfin;
  a.states = states;
  a.dx = static_cast<XT*>(dx);
  a.ddt = ddt;
  a.dA = dA;
  a.dB = dB;
  a.dC = dC;
  a.ds0 = ds0;
  a.T = T;
  a.H = H;
  a.G = G;
  a.x_sb = x_sb;
  a.x_st = x_st;
  a.dt_sb = dt_sb;
  a.dt_st = dt_st;
  a.bc_sb = bc_sb;
  a.bc_st = bc_st;
  return a;
}

}  // namespace ssd_bwd

// Returns the CUDA error of the launch (0 = launched), or -1 for a shape
// or type this kernel does not take.  One launch on `stream`; does not
// synchronise, allocates nothing.  x [b, T, H, P] and B, C [b, T, G, N]
// with element strides 1 and the batch and token strides given (B and C
// share theirs), their pointers and strides 16-byte aligned, dt [b, T, H]
// with head stride 1, all in x's type; dy and dx [b, T, H, P] contiguous
// in x's type; A [H], dsfin (or null) and ds0 (or null) [b, H, P, N],
// states [b, H, ceil(T / 64), P, N], ddt [b, T, H], dA [b, H], dB and dC
// [b, T, H, N], all float32 contiguous.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const float* A,
                            const void* B, const void* C, const void* dy,
                            const float* dsfin, const float* states,
                            void* dx, float* ddt, float* dA, float* dB,
                            float* dC, float* ds0, int b, int T, int H,
                            int G, int P, int N, int64_t x_sb, int64_t x_st,
                            int64_t dt_sb, int64_t dt_st, int64_t bc_sb,
                            int64_t bc_st, int x_dtype, void* stream) {
  using namespace ssd_bwd;
  if (b <= 0 || H <= 0 || G <= 0 || H % G != 0 || P != kP || T <= 0 ||
      b > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return run<float>(make_args<float>(x, dt, A, B, C, dy, dsfin, states, dx,
                                       ddt, dA, dB, dC, ds0, T, H, G, x_sb,
                                       x_st, dt_sb, dt_st, bc_sb, bc_st),
                      b, N, s);
  if (x_dtype == kBF16)
    return run<bf16>(make_args<bf16>(x, dt, A, B, C, dy, dsfin, states, dx,
                                     ddt, dA, dB, dC, ds0, T, H, G, x_sb,
                                     x_st, dt_sb, dt_st, bc_sb, bc_st),
                     b, N, s);
  return -1;
}
