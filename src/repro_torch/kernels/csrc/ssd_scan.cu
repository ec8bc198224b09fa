// Mamba2 SSD scan with a carried state, for Hopper (sm_90a): the state
// walks tiles of the kernel's own on chip, with every product on tensor
// cores.
//
// Replaces the Pallas kernel ssd_scan_kernel
// (src/repro/kernels/ssd_scan/ssd_kernel.py, wrapper ssd_scan/ops.py).
// Inputs: x [b, T, H, P] and B, C [b, T, G, N] in x's type (float32 or
// bf16), read in place through their batch and token strides (a head reads
// its group's row of B and C, where the Pallas wrapper repeats and
// transposes them); dt [b, T, H] in x's type; A [H] and the
// initial state s0 [b, H, P, N] in float32.  y is written in x's type, the
// final state in float32.
//
// The scan is one function whatever chunk the caller names: chunking only
// regroups its sums.  So this kernel cuts the tokens into tiles of its own
// (kTile = 64; the last one zero-filled past T, its rows past T not
// written).  With cum the float64 inclusive sum of float32 dt * A inside a
// tile and seg its last entry, a tile entered with state S gives
//
//   y_i = exp(cum_i) C_i S^T
//         + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   S'  = exp(seg) S + sum_j (x_j * dt_j * exp(seg - cum_j))^T B_j
//
// One thread block walks the tiles of one (batch row, head) in order, its
// state in registers, and writes each tile's y as it goes: one launch, no
// scratch, for a prefill of up to kSliceTiles tiles (1024 tokens).  A
// longer one is walked a slice of kSliceTiles tiles a launch, each entered
// with the final state the launch before wrote.  Given a states pointer
// (training: the backward's input) the walk also writes the state
// entering each tile, from the registers it holds.  That is a second
// instantiation of the walk (kStates): a run-time branch on the pointer
// costs registers in the walk (ptxas: 128 -> 159-222 a thread in bf16, a
// spill at N 128 in f32), so serving, which passes null, runs an
// instantiation that holds no store at all.  Splitting a head's tiles
// over several blocks (a pass for the tiles' increments, one carrying the
// state across them, one for y) was slower on the H100 at 1024 tokens
// (PERF.md).  Every sum runs in a fixed order (no atomics), so a call is
// bit-for-bit repeatable.
//
// The decay is masked inside the exponent (exp(-1e30) = 0 for j > i), so
// no anti-causal exp can overflow.  cum is summed in float64 and each
// difference is formed in float64 and rounded once: the sums reach ~1e3
// at the model's step sizes, where a float32 difference would carry their
// rounding.  Every tile's cum, dt and weights are formed before the walk,
// a tile a warp.
//
// Products: mma.sync m16n8k16, bf16 operands with float32 sums.  An
// operand held in bf16 enters as it is (x, B, C of a bf16 call: C B^T is
// then one exact product).  A float32 operand enters in bf16 pieces, each
// the rounding of what the ones before leave, and a product runs the
// products of pieces i and j with i + j < K.  The weighted x of the state
// update and the entering state are pairs (K = 2) in every call; so are
// the decayed scores of a bf16 call, whose output rounds to bf16 anyway.
// In a float32 call x, B and C enter as three pieces (exact), and C B^T
// and the decayed scores' product with x run with K = 3 (six products):
// the plain walk put those two products past half the 2e-3 tolerance with
// pairs (PERF.md).  The plain version of this walk is
// ssd_scan/ops.py::ssd_scan_tiled_ref, whose P_ROUND names these choices.
//
// Bound: bytes at the model's shapes (x, B, C read once, y written), but
// a walk is a chain of dependent tile steps, so the kernel is held back by
// each step's latency (PERF.md).  Eight warps a block: warps w and w + 4
// own query rows 16 (w % 4).. of a tile and split its inter k-steps and
// causal column groups, adding their sums through shared memory; for the
// state, warp w owns rows 16 (w % 4).. and every other pair of column
// tiles.  bf16 tiles come in by 16-byte cp.async two tiles ahead; float32
// tiles by 16-byte loads into registers one tile ahead (after, at N 128),
// split into pieces in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace ssd {

using paged::cp_async16;
using paged::cp_async_commit;
using paged::cp_async_wait;
using paged::ldsm_x4;
using paged::ldsm_x4_trans;
using paged::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;         // tokens of a tile
constexpr int kP = 64;            // head dim
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSliceTiles = 16;   // tiles a launch walks, at most
constexpr float kNegInf = -1e30f;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// bf16 pieces of each operand, and of each product the pairs of pieces
// (i, j) with i + j < K that it runs
template <typename XT>
struct Pieces {
  static constexpr bool kF32In = std::is_same<XT, float>::value;
  static constexpr int kIn = kF32In ? 3 : 1;       // x, B and C
  static constexpr int kScore = kF32In ? 3 : 1;    // C B^T
  static constexpr int kDecayed = kF32In ? 3 : 2;  // the decayed scores,
                                                   // and their product
                                                   // with x
  static constexpr int kPair = 2;  // the weighted x of the update and the
                                   // entering state, and their products
                                   // with B and C
};

// bf16 elements of a tile row: 16 bytes past the row, an odd number of
// 16-byte units for every width here, so the 8 rows of an ldmatrix 8 x 8
// hit 32 distinct banks
__host__ __device__ constexpr int pitch(int width) { return width + 8; }

template <typename XT>
struct ScanArgs {
  const XT* x;
  const XT* dt;
  const float* A;
  const XT* B;
  const XT* C;
  const float* s0;                // null: the state starts at zero; may
                                  // be sfin (a slice after the first)
  XT* y;
  float* sfin;
  float* states;                  // null, or the state entering each tile
                                  // [b, H, ceil(T / kTile), P, N] (for the
                                  // backward, csrc/ssd_scan_bwd.cu)
  int T, H, G;
  int c0, c1;                     // the tiles this launch walks
  long x_sb, x_st, dt_sb, dt_st, bc_sb, bc_st, s0_sb;
};

// K bf16 pieces of (v0, v1) as bf16x2 words: each the rounding of what the
// pieces before leave (the differences are exact in float32)
template <int K>
__device__ __forceinline__ void split(float v0, float v1, uint32_t out[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    out[k] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= __low2float(h);
    v1 -= __high2float(h);
  }
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float4 as_float4(const float v[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Four values (x0 * w .. x3 * w) as K bf16 pieces into K planes at dst.
template <int K>
__device__ __forceinline__ void store_pieces(bf16* dst, int plane, float4 v,
                                             float w = 1.f) {
  uint32_t p01[K], p23[K];
  split<K>(v.x * w, v.y * w, p01);
  split<K>(v.z * w, v.w * w, p23);
#pragma unroll
  for (int k = 0; k < K; ++k)
    *reinterpret_cast<uint2*>(dst + k * plane) = make_uint2(p01[k], p23[k]);
}

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

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

// A warp: a tile's cum[j], the float64 inclusive sum over its tokens <= j
// of float32 dt * a (so cum[kTile - 1] is its seg: padding adds 0), dts[j]
// = dt_j and coef[j] = dt_j exp(seg - cum_j), the weight of token j in the
// tile's state increment.
__device__ __forceinline__ void scan_dt(float2 d, float a, double* cum,
                                        float* dts, float* coef, int lane) {
  double carry = 0.0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = lane + 32 * e;
    const float dv = e == 0 ? d.x : d.y;
    dts[j] = dv;
    const float da = dv * a;
    double v = static_cast<double>(da);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    cum[j] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = lane + 32 * e;
    coef[j] = dts[j] * expf(static_cast<float>(carry - cum[j]));
  }
}

// Shared memory of a walk block: every tile's cum, dt and coefficients
// (formed for the whole slice before the walk), and the sums one warp of a
// row block hands the other; kStages stages of a tile's B, x and C planes,
// and the pieces of the state entering the tile.  bf16 tiles arrive by
// cp.async kStages - 1 tiles ahead; a float32 tile is fetched into
// registers and split into its one stage after the tile before is done.
template <int N, typename XT>
struct WalkSmem {
  using Pc = Pieces<XT>;
  static constexpr int kStages = Pc::kF32In ? 1 : 3;
  static constexpr int NP = pitch(N);
  static constexpr int PP = pitch(kP);
  static constexpr int kNPlane = kTile * NP;  // elements
  static constexpr int kXPlane = kTile * PP;
  static constexpr int kSPlane = kP * NP;
  static constexpr int kStage = Pc::kIn * (2 * kNPlane + kXPlane);
  static constexpr size_t kScalars =
      kSliceTiles * kTile * (sizeof(double) + 2 * sizeof(float));
  static constexpr int kRedPitch = kP + 8;  // floats
  static constexpr size_t kRed = sizeof(float) * kTile * kRedPitch;
  static constexpr size_t kBytes =
      kScalars + kRed + sizeof(bf16) * (kStages * kStage + Pc::kPair * kSPlane);
};

// A bf16 tile c's B, x and C rows into a stage: B's plane, then x's,
// then C's.
template <int N>
__device__ __forceinline__ void load_stage(const ScanArgs<bf16>& a,
                                           bf16* stage, int c, int h, int bb,
                                           int g) {
  using L = WalkSmem<N, bf16>;
  const int t0 = c * kTile;
  const int n_rows = min(kTile, a.T - t0);
  const long bc = bb * a.bc_sb + static_cast<long>(t0) * a.bc_st + g * N;
  load_tile<N>(stage, a.B + bc, a.bc_st, n_rows);
  load_tile<kP>(stage + L::kNPlane,
                a.x + bb * a.x_sb + static_cast<long>(t0) * a.x_st + h * kP,
                a.x_st, n_rows);
  load_tile<N>(stage + L::kNPlane + L::kXPlane, a.C + bc, a.bc_st, n_rows);
}

// A float32 tile's B, x and C rows as 16-byte items, kItems a thread:
// item e of operand o is row e / (W / 4), columns 4 (e % (W / 4)).., so
// each of a thread's items belongs to one operand known at compile time.
template <int N>
struct F32Tile {
  static constexpr int kB = kTile * N / 4;
  static constexpr int kX = kTile * kP / 4;
  static constexpr int kItems = (2 * kB + kX) / kThreads;
  static_assert(kB % kThreads == 0 && kX % kThreads == 0, "items");
  // operand of the thread's k-th item (0 B, 1 x, 2 C), its index in it
  __device__ __forceinline__ static int operand(int k) {
    const int e = k * kThreads;
    return e < kB ? 0 : e < kB + kX ? 1 : 2;
  }
  __device__ __forceinline__ static int index(int k) {
    const int e = k * kThreads + threadIdx.x;
    return e < kB ? e : e < kB + kX ? e - kB : e - kB - kX;
  }
};

template <int N>
__device__ __forceinline__ void fetch_f32_tile(const ScanArgs<float>& a,
                                               float4* v, int c, int h,
                                               int bb, int g) {
  using F = F32Tile<N>;
  const int t0 = c * kTile;
  const int n_rows = min(kTile, a.T - t0);
  const long bc = bb * a.bc_sb + static_cast<long>(t0) * a.bc_st + g * N;
  const float* src[3] = {
      a.B + bc, a.x + bb * a.x_sb + static_cast<long>(t0) * a.x_st + h * kP,
      a.C + bc};
#pragma unroll
  for (int k = 0; k < F::kItems; ++k) {
    const int o = F::operand(k);
    const int W4 = (o == 1 ? kP : N) / 4;
    const int e = F::index(k);
    const int r = e / W4;
    float w[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n_rows)
      load4(src[o] + r * (o == 1 ? a.x_st : a.bc_st) + (e % W4) * 4, w);
    v[k] = as_float4(w);
  }
}

template <int N, typename XT>
__device__ __forceinline__ void store_f32_tile(bf16* stage, const float4* v) {
  using F = F32Tile<N>;
  using L = WalkSmem<N, XT>;
  using Pc = Pieces<XT>;
#pragma unroll
  for (int k = 0; k < F::kItems; ++k) {
    const int o = F::operand(k);
    const int W4 = (o == 1 ? kP : N) / 4;
    const int WP = o == 1 ? L::PP : L::NP;
    const int plane = o == 1 ? L::kXPlane : L::kNPlane;
    const int base = o == 0 ? 0
                     : o == 1 ? Pc::kIn * L::kNPlane
                              : Pc::kIn * (L::kNPlane + L::kXPlane);
    const int e = F::index(k);
    store_pieces<Pc::kIn>(stage + base + (e / W4) * WP + (e % W4) * 4, plane,
                          v[k]);
  }
}

// The state a walk block carries lies in registers, in the layout of the
// update product's accumulators: warp w owns rows p0 = 16 (w % 4) (lanes'
// rows p0 + lane / 4 and + 8) and the pairs of 8-column n-tiles from pair
// w / 4 on, every other one.
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

// Each element (row, column) of the carried state, as f(row, col, value&).
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

// s = eseg s + (x coef)^T B over the tile: A = x^T from x's [j][p] planes
// by ldmatrix.trans, each value (its pieces summed: exact) times coef_j and
// cut into a pair; B from B's [j][n] planes by ldmatrix.trans.
template <int N, typename XT>
__device__ __forceinline__ void update_state(float s[][2][4], float eseg,
                                             const bf16* Bs, const bf16* Xs,
                                             const float* coef, int warp,
                                             int lane) {
  using Pc = Pieces<XT>;
  using St = StateTiles<N>;
  constexpr int NP = pitch(N);
  constexpr int PP = pitch(kP);
  constexpr int kNPlane = kTile * NP;
  constexpr int kXPlane = kTile * PP;
  const int r8 = lane & 7;
  const int mi = lane >> 3;
  const int tq = lane & 3;
  const int p0 = (warp % 4) * 16;
#pragma unroll
  for (int q = 0; q < St::kMine; ++q)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[q][u][e] *= eseg;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t xr[Pc::kIn][4];
#pragma unroll
    for (int i = 0; i < Pc::kIn; ++i)
      ldsm_x4_trans(xr[i], Xs + i * kXPlane +
                               (kk * 16 + (mi >> 1) * 8 + r8) * PP + p0 +
                               (mi & 1) * 8);
    uint32_t af[Pc::kPair][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {   // rows p0 + g (+8); tokens 2 tq, +1 (+8)
      const int j = kk * 16 + (r >> 1) * 8 + 2 * tq;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int i = 0; i < Pc::kIn; ++i) {
        const __nv_bfloat162 x2 =
            *reinterpret_cast<const __nv_bfloat162*>(&xr[i][r]);
        v0 += __low2float(x2);
        v1 += __high2float(x2);
      }
      uint32_t pc[Pc::kPair];
      split<Pc::kPair>(v0 * coef[j], v1 * coef[j + 1], pc);
#pragma unroll
      for (int k = 0; k < Pc::kPair; ++k) af[k][r] = pc[k];
    }
#pragma unroll
    for (int q = 0; q < St::kMine; ++q) {
      const int n = St::tile(warp, q);
      if (n < 0) break;
#pragma unroll
      for (int i = 0; i < Pc::kIn; ++i) {
        uint32_t b[4];
        ldsm_x4_trans(b, Bs + i * kNPlane +
                             (kk * 16 + (mi & 1) * 8 + r8) * NP +
                             (n + (mi >> 1)) * 8);
#pragma unroll
        for (int k = 0; k + i < Pc::kPair; ++k) {
          mma_bf16(s[q][0], af[k], b[0], b[1]);
          mma_bf16(s[q][1], af[k], b[2], b[3]);
        }
      }
    }
  }
}

// y of one tile, rows < n_rows.  Warps w and w + 4 own query rows 16 (w %
// 4).. of the tile and share its work: part w / 4 takes the k-steps ks of
// the inter term C S_enter^T (C's [i][n] planes as the A operand, S from
// its [p][n] pieces) with ks % 2 == part, scaled by exp(cum_i), and the
// column groups of 16 numbered part and part + 2 (zero weights past the
// diagonal): the scores C B^T (B from its [j][n] planes) of both, decayed
// and weighted in registers and cut into pieces, as the A operand of the
// product with x ([j][p] planes, ldmatrix.trans).  Part 1 leaves its sums
// in `red`; after a block barrier part 0 adds them to its own and writes y.
template <int N, typename XT>
struct TileOutputs {
  static constexpr int kCols = kP / 8;   // output n-tiles
  float acc[kCols][4];

  __device__ __forceinline__ void compute(
      const bf16* Cs, const bf16* Bs, const bf16* Xs, const bf16* Ss,
      float* red, const double* cum, const float* dts, int n_rows, int warp,
      int lane) {
    using Pc = Pieces<XT>;
    constexpr int NP = pitch(N);
    constexpr int PP = pitch(kP);
    constexpr int RP = kP + 8;
    constexpr int kNPlane = kTile * NP;
    constexpr int kXPlane = kTile * PP;
    constexpr int kSPlane = kP * NP;
    constexpr int KS = N / 16;
    const int rb = warp % 4;        // row block
    const int part = warp / 4;
    const int i0 = rb * 16;
    const bool live = i0 < n_rows;
    const int r8 = lane & 7;
    const int mi = lane >> 3;
    const int tq = lane & 3;
    const int ia = i0 + (lane >> 2);  // this lane's rows ia and ib = ia + 8
    const int ib = ia + 8;

#pragma unroll
    for (int n = 0; n < kCols; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if (live) {
      // C rows i0.. as the A operand, k-step ks
      auto c_frag = [&](uint32_t ca[Pc::kIn][4], int ks) {
#pragma unroll
        for (int i = 0; i < Pc::kIn; ++i)
          ldsm_x4(ca[i], Cs + i * kNPlane + (i0 + (mi & 1) * 8 + r8) * NP +
                             ks * 16 + (mi >> 1) * 8);
      };
#pragma unroll
      for (int ks = part; ks < KS; ks += 2) {
        uint32_t ca[Pc::kIn][4];
        c_frag(ca, ks);
#pragma unroll
        for (int n = 0; n < kCols; n += 2)
#pragma unroll
          for (int k = 0; k < Pc::kPair; ++k) {
            uint32_t b[4];
            ldsm_x4(b, Ss + k * kSPlane + ((n + (mi >> 1)) * 8 + r8) * NP +
                           ks * 16 + (mi & 1) * 8);
#pragma unroll
            for (int i = 0; i < Pc::kIn && i + k < Pc::kPair; ++i) {
              mma_bf16(acc[n], ca[i], b[0], b[1]);
              mma_bf16(acc[n + 1], ca[i], b[2], b[3]);
            }
          }
      }
      const double cum_a = cum[ia];
      const double cum_b = cum[ib];
      const float ea = expf(static_cast<float>(cum_a));
      const float eb = expf(static_cast<float>(cum_b));
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        acc[n][0] *= ea;
        acc[n][1] *= ea;
        acc[n][2] *= eb;
        acc[n][3] *= eb;
      }

      // the scores of both column groups
      float s[2][2][4];
#pragma unroll
      for (int gi = 0; gi < 2; ++gi)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[gi][q][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ca[Pc::kIn][4];
        c_frag(ca, ks);
#pragma unroll
        for (int gi = 0; gi < 2; ++gi) {
          const int j0 = (part + 2 * gi) * 16;
#pragma unroll
          for (int i2 = 0; i2 < Pc::kIn; ++i2) {
            uint32_t b[4];
            ldsm_x4(b, Bs + i2 * kNPlane + (j0 + (mi >> 1) * 8 + r8) * NP +
                           ks * 16 + (mi & 1) * 8);
#pragma unroll
            for (int i = 0; i < Pc::kIn && i + i2 < Pc::kScore; ++i) {
              mma_bf16(s[gi][0], ca[i], b[0], b[1]);
              mma_bf16(s[gi][1], ca[i], b[2], b[3]);
            }
          }
        }
      }
      // weights (C_i . B_j) exp(cum_i - cum_j) dt_j, masked to j <= i, cut
      // into the A operand's pieces: rows ia, ib; columns 2 tq, +1 (+8)
      uint32_t mp[2][Pc::kDecayed][4];
#pragma unroll
      for (int gi = 0; gi < 2; ++gi)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float w[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = (part + 2 * gi) * 16 + q * 8 + 2 * tq + e;
            const double cj = cum[j];
            const float dj = dts[j];
            w[e] = s[gi][q][e] *
                   expf(ia >= j ? static_cast<float>(cum_a - cj) : kNegInf) *
                   dj;
            w[2 + e] = s[gi][q][2 + e] *
                       expf(ib >= j ? static_cast<float>(cum_b - cj)
                                    : kNegInf) *
                       dj;
          }
          uint32_t pa[Pc::kDecayed], pb[Pc::kDecayed];
          split<Pc::kDecayed>(w[0], w[1], pa);
          split<Pc::kDecayed>(w[2], w[3], pb);
#pragma unroll
          for (int k = 0; k < Pc::kDecayed; ++k) {
            mp[gi][k][2 * q] = pa[k];
            mp[gi][k][2 * q + 1] = pb[k];
          }
        }
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        const int j0 = (part + 2 * gi) * 16;
#pragma unroll
        for (int n = 0; n < kCols; n += 2)
#pragma unroll
          for (int i = 0; i < Pc::kIn; ++i) {
            uint32_t b[4];
            ldsm_x4_trans(b, Xs + i * kXPlane +
                                 (j0 + (mi & 1) * 8 + r8) * PP +
                                 (n + (mi >> 1)) * 8);
#pragma unroll
            for (int k = 0; k + i < Pc::kDecayed; ++k) {
              mma_bf16(acc[n], mp[gi][k], b[0], b[1]);
              mma_bf16(acc[n + 1], mp[gi][k], b[2], b[3]);
            }
          }
      }
    }

    // part 1's sums, for part 0
    if (part == 1 && live)
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        const int cc = n * 8 + 2 * tq;
        *reinterpret_cast<float2*>(red + ia * RP + cc) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(red + ib * RP + cc) =
            make_float2(acc[n][2], acc[n][3]);
      }
  }

  // after a block barrier: part 0 adds part 1's sums and writes its rows
  // below n_rows
  __device__ __forceinline__ void write(const ScanArgs<XT>& a,
                                        const float* red, int t0, int n_rows,
                                        int h, int bb, int warp,
                                        int lane) const {
    constexpr int RP = kP + 8;
    const int ia = (warp % 4) * 16 + (lane >> 2);
    const int ib = ia + 8;
    const int tq = lane & 3;
    if (warp / 4 != 0 || (warp % 4) * 16 >= n_rows) return;
    XT* ya = a.y + ((static_cast<long>(bb) * a.T + t0 + ia) * a.H + h) * kP;
    XT* yb = a.y + ((static_cast<long>(bb) * a.T + t0 + ib) * a.H + h) * kP;
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      const int cc = n * 8 + 2 * tq;
      const float2 u = *reinterpret_cast<const float2*>(red + ia * RP + cc);
      const float2 v = *reinterpret_cast<const float2*>(red + ib * RP + cc);
      if (ia < n_rows) store2(ya + cc, acc[n][0] + u.x, acc[n][1] + u.y);
      if (ib < n_rows) store2(yb + cc, acc[n][2] + v.x, acc[n][3] + v.y);
    }
  }
};

// One (head, batch row): walks tiles [c0, c1) in order from the state s0
// (zero where null), the state in registers, writes each tile's y and the
// final state.  Every tile's cum, dt and coefficients are formed first, a
// tile a warp, so the walk waits only for its tiles' loads.  kStates: also
// write the state entering each tile to a.states.
template <int N, typename XT, bool kStates>
__global__ void __launch_bounds__(kThreads) ssd_walk_kernel(ScanArgs<XT> a) {
  using Pc = Pieces<XT>;
  using L = WalkSmem<N, XT>;
  using St = StateTiles<N>;
  constexpr int S = L::kStages;
  // a float32 tile is fetched into registers while the tile before is
  // computed, except at N 128, where those registers would spill: there it
  // is fetched after
  constexpr bool kEarly = Pc::kF32In && N != 128;
  static_assert(N % 16 == 0 && N >= 16 && kWarps == 8, "tiling");
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);  // [kSliceTiles][kTile]
  float* dts = reinterpret_cast<float*>(cum + kSliceTiles * kTile);
  float* coef = dts + kSliceTiles * kTile;        // [kSliceTiles][kTile]
  float* red = reinterpret_cast<float*>(smem + L::kScalars);
  bf16* stages = reinterpret_cast<bf16*>(smem + L::kScalars + L::kRed);
  bf16* Ss = stages + S * L::kStage;  // [kPair][kP][NP]

  const int h = blockIdx.x;
  const int bb = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int c0 = a.c0;
  const int c1 = a.c1;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long head = static_cast<long>(bb) * a.H + h;

  // the first tiles' loads, then every tile's scalars
  float4 pre[Pc::kF32In ? F32Tile<N>::kItems : 1];
  if constexpr (Pc::kF32In) {
    fetch_f32_tile<N>(a, pre, c0, h, bb, g);
  } else {
#pragma unroll
    for (int k = 0; k + 1 < S; ++k) {
      if (c0 + k < c1)
        load_stage<N>(a, stages + k * L::kStage, c0 + k, h, bb, g);
      cp_async_commit();
    }
  }
  for (int k = warp; k < c1 - c0; k += kWarps) {
    const int t0 = (c0 + k) * kTile;
    scan_dt(fetch_dt(a.dt + bb * a.dt_sb + h + t0 * a.dt_st, a.dt_st,
                     min(kTile, a.T - t0), lane),
            a.A[h], cum + k * kTile, dts + k * kTile, coef + k * kTile, lane);
  }

  // the state: each thread reads the elements it writes at the end, so s0
  // may be sfin
  float s[St::kMine][2][4];
  const float* s_in = a.s0 != nullptr
                          ? a.s0 + bb * a.s0_sb + static_cast<long>(h) * (kP * N)
                          : nullptr;
  for_state<N>(s, warp, lane, [&](int r, int col, float& v0, float& v1) {
    const float2 v = s_in != nullptr
                         ? *reinterpret_cast<const float2*>(s_in + r * N + col)
                         : make_float2(0.f, 0.f);
    v0 = v.x;
    v1 = v.y;
  });
  // the carried state's pieces, the B operand of the next tile's inter term
  auto publish = [&]() {
    for_state<N>(s, warp, lane, [&](int r, int col, float& v0, float& v1) {
      uint32_t pc[Pc::kPair];
      split<Pc::kPair>(v0, v1, pc);
#pragma unroll
      for (int k = 0; k < Pc::kPair; ++k)
        *reinterpret_cast<uint32_t*>(Ss + k * L::kSPlane + r * L::NP + col) =
            pc[k];
    });
  };
  publish();
  if constexpr (Pc::kF32In) store_f32_tile<N, XT>(stages, pre);

  for (int c = c0; c < c1; ++c) {
    const int k = c - c0;
    const bf16* Bs = stages + (k % S) * L::kStage;
    const bf16* Xs = Bs + Pc::kIn * L::kNPlane;
    const bool more = c + 1 < c1;
    if constexpr (!Pc::kF32In) cp_async_wait<S - 2>();
    __syncthreads();              // tile c, the scalars and Ss are in
    if constexpr (kEarly) {
      if (more) fetch_f32_tile<N>(a, pre, c + 1, h, bb, g);
    } else if constexpr (!Pc::kF32In) {
      // the stage of tile c - 1, which every warp is done with
      if (c + S - 1 < c1)
        load_stage<N>(a, stages + ((k + S - 1) % S) * L::kStage, c + S - 1,
                      h, bb, g);
      cp_async_commit();
    }
    const double* cm = cum + k * kTile;
    const int t0 = c * kTile;
    const int n_rows = min(kTile, a.T - t0);
    if constexpr (kStates) {
      float* st = a.states +
                  (head * ((a.T + kTile - 1) / kTile) + c) * (kP * N);
      for_state<N>(s, warp, lane, [&](int r, int col, float& v0, float& v1) {
        store2(st + r * N + col, v0, v1);
      });
    }
    TileOutputs<N, XT> y;
    y.compute(Xs + Pc::kIn * L::kXPlane, Bs, Xs, Ss, red, cm, dts + k * kTile,
              n_rows, warp, lane);
    update_state<N, XT>(s, expf(static_cast<float>(cm[kTile - 1])), Bs, Xs,
                        coef + k * kTile, warp, lane);
    __syncthreads();              // red is in; every warp has read Ss
    y.write(a, red, t0, n_rows, h, bb, warp, lane);
    if (more) publish();
    if constexpr (Pc::kF32In) {
      if (more) {
        if constexpr (!kEarly) fetch_f32_tile<N>(a, pre, c + 1, h, bb, g);
        __syncthreads();          // every warp is done with the stage
        store_f32_tile<N, XT>(stages, pre);
      }
    }
  }

  float* out = a.sfin + head * (kP * N);
  for_state<N>(s, warp, lane, [&](int r, int col, float& v0, float& v1) {
    store2(out + r * N + col, v0, v1);
  });
}

template <int N, typename XT>
int launch(ScanArgs<XT> a, int b, cudaStream_t stream) {
  auto walk = a.states != nullptr ? ssd_walk_kernel<N, XT, true>
                                  : ssd_walk_kernel<N, XT, false>;
  constexpr size_t smem = WalkSmem<N, XT>::kBytes;
  static_assert(smem <= 227 * 1024, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (a.T + kTile - 1) / kTile;
  // a slice of kSliceTiles tiles a launch, each after the first entered
  // with the final state the one before wrote
  for (a.c0 = 0; a.c0 < n_tiles; a.c0 += kSliceTiles) {
    a.c1 = min(a.c0 + kSliceTiles, n_tiles);
    walk<<<dim3(a.H, b), kThreads, smem, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    a.s0 = a.sfin;
    a.s0_sb = static_cast<long>(a.H) * kP * N;
  }
  return 0;
}

template <typename XT>
int dispatch_n(int N, const ScanArgs<XT>& a, int b, cudaStream_t stream) {
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
int run(const void* x, const void* dt, const float* A, const void* B,
        const void* C, const float* s0, void* y, float* sfin, float* states,
        int b, int T, int H, int G, int N, long x_sb, long x_st, long dt_sb,
        long dt_st, long bc_sb, long bc_st, long s0_sb,
        cudaStream_t stream) {
  ScanArgs<XT> a;
  a.x = static_cast<const XT*>(x);
  a.dt = static_cast<const XT*>(dt);
  a.A = A;
  a.B = static_cast<const XT*>(B);
  a.C = static_cast<const XT*>(C);
  a.s0 = s0;
  a.y = static_cast<XT*>(y);
  a.sfin = sfin;
  a.states = states;
  a.T = T;
  a.H = H;
  a.G = G;
  a.x_sb = x_sb;
  a.x_st = x_st;
  a.dt_sb = dt_sb;
  a.dt_st = dt_st;
  a.bc_sb = bc_sb;
  a.bc_st = bc_st;
  a.s0_sb = s0_sb;
  return dispatch_n<XT>(N, a, b, stream);
}

}  // namespace ssd

// Returns the CUDA error of the launches (0 = launched), or -1 for a shape
// or type this kernel does not take.  Launches one kernel a slice of 1024
// tokens on `stream`, does not synchronise, allocates nothing.  x is
// [b, T, H, P] with head and element strides P and 1 (batch and token
// strides given), B and C [b, T, G, N] with group and element strides N
// and 1 and the same strides; their pointers and strides 16-byte aligned.
// dt is [b, T, H] in x's type with head stride 1; s0 (or null)
// [b, H, P, N] with the batch stride given; y [b, T, H, P] and sfin
// [b, H, P, N] contiguous; states (or null) [b, H, ceil(T / 64), P, N]
// float32 contiguous, where the state entering each tile is written (y and
// sfin are the same bits either way).
extern "C" int ssd_scan(const void* x, const void* dt, const float* A,
                        const void* B, const void* C, const float* s0,
                        void* y, float* sfin, float* states, int b, int T,
                        int H, int G,
                        int P, int N, int64_t x_sb, int64_t x_st,
                        int64_t dt_sb, int64_t dt_st, int64_t bc_sb,
                        int64_t bc_st, int64_t s0_sb, int x_dtype,
                        void* stream) {
  using namespace ssd;
  if (b <= 0 || H <= 0 || G <= 0 || H % G != 0 || P != kP || T <= 0 ||
      b > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return run<float>(x, dt, A, B, C, s0, y, sfin, states, b, T, H, G, N,
                      x_sb, x_st, dt_sb, dt_st, bc_sb, bc_st, s0_sb, s);
  if (x_dtype == kBF16)
    return run<bf16>(x, dt, A, B, C, s0, y, sfin, states, b, T, H, G, N,
                     x_sb, x_st, dt_sb, dt_st, bc_sb, bc_st, s0_sb, s);
  return -1;
}
