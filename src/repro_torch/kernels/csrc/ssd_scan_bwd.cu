// Backward of the Mamba2 SSD scan (csrc/ssd_scan.cu), for Hopper
// (sm_90a): the reverse tile walk.
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
// tile (from the final state's cotangent, or 0).  With cum the float64
// inclusive sum of float32 dt * A in a tile (each difference rounded
// once, the decay masked inside the exponent, as the forward), seg its
// last entry, e_i = exp(cum_i), w_j = exp(seg - cum_j), L_ij = exp(cum_i -
// cum_j) for j <= i, S the entering state and xdt_j = x_j dt_j, a tile
// forms in shared memory
//
//   M_ij = (C_i . B_j) L_ij,   P_ij = (dy_i . xdt_j) L_ij
//
// and then, each product a pass over the block:
//
//   d(xdt)_j = sum_i M_ij dy_i + w_j dS B_j    -> dx_j, ddt_j (direct)
//   dC_i     = e_i S^T dy_i + sum_j P_ij B_j
//   dB_j     = sum_i P_ij C_i + w_j dS^T xdt_j
//   dS_in    = exp(seg) dS + sum_i e_i dy_i C_i^T
//
// and the gradient of cum: the row sums less the column sums of M * D,
// e_i C_i . S^T dy_i, less R_j = w_j xdt_j . dS B_j, and at the last entry
// exp(seg) <dS, S> + sum_j R_j; its reverse cumulative sum (float64) is
// d(dt A), which adds d(dt A) A to ddt and d(dt A) dt to dA.
//
// dB, dC and dA are written for each head (float32); the wrapper sums
// them over the heads of a group (the batch for dA) in a fixed order.  No
// atomics: every sum here runs in a fixed order, so a call is bit-for-bit
// repeatable.  One launch walks every tile: the tile's scalars are formed
// at its turn, so no slice limit applies.
//
// Arithmetic: float32 FMA, 256 threads a block, each output of a pass a
// 4 x (W / 16) micro-tile of a thread (rows tr + 16 a, columns tc + 16 b),
// operands from shared memory with row pitches of width + 1 floats, so a
// warp's row and column reads both hit distinct banks.  Bound: the
// operations (about 10 P N a token and head, twice the forward's; this
// body runs 16 P N, the masked half of each tile's squares included) at
// the float32 rate it runs at take about twice the bytes' time (x, dt, B,
// C, dy and the tile states read; dx, ddt and the per-head partials
// written: 0.15 ms at mamba2-1.3b's 8 x 512 batch); on tensor cores the
// bytes would bind.  Each pass is bound by its shared-memory loads (one a
// thread for every two or three FMAs).  A simple body first: tensor-core
// products are later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd_bwd {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // tokens of a tile (the forward's kTile)
constexpr int kP = 64;         // head dim
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGrid = 16;      // a thread's rows and columns step by 16
constexpr float kNegInf = -1e30f;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

static_assert(kTile == kP, "the [64][65] planes serve tokens and head dim");

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

// Shared memory, in floats after the tile's float64 cum: x, dy, M and P
// as [64][65]; B, C, the entering state S and dS as [64][N + 1]; five
// [16][64] planes of partial sums over a thread's columns or rows; e, w,
// dt of the tile and the warps' <dS, S> partials.
template <int N>
struct BwdSmem {
  static constexpr int XP = kP + 1;
  static constexpr int NP = N + 1;
  static constexpr int kSq = kTile * XP;
  static constexpr int kNm = kTile * NP;
  static constexpr int kPart = kGrid * kTile;
  static constexpr int kParts = 5;
  static constexpr size_t kFloats =
      4 * kSq + 4 * kNm + kParts * kPart + 3 * kTile + kWarps;
  static constexpr size_t kBytes =
      sizeof(double) * kTile + sizeof(float) * kFloats;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_float(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc[a][b] = sum over k = 0.. K - 1, in order, of fa(r_a, k) fb(k, c_b),
// rows r_a = tr + 16 a, columns c_b = tc + 16 b
template <int RA, int RB, int K, typename FA, typename FB>
__device__ __forceinline__ void product(float (&acc)[RA][RB], int tr, int tc,
                                        FA fa, FB fb) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float va[RA], vb[RB];
#pragma unroll
    for (int a = 0; a < RA; ++a) va[a] = fa(tr + kGrid * a, k);
#pragma unroll
    for (int b = 0; b < RB; ++b) vb[b] = fb(k, tc + kGrid * b);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) acc[a][b] = fmaf(va[a], vb[b], acc[a][b]);
  }
}

// rows [0, n_rows) of a [T][W] operand (row r at src + r * stride) into a
// [kTile][W + 1] float plane, zero past n_rows
template <int W, typename XT>
__device__ __forceinline__ void load_plane(float* dst, const XT* src,
                                           long stride, int n_rows) {
  for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
    const int r = e / W;
    const int c = e % W;
    dst[r * (W + 1) + c] = r < n_rows ? to_float(src[r * stride + c]) : 0.f;
  }
}

// sum over a warp, in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One (head, batch row): its tiles from the last to the first.
template <int N, typename XT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel(BwdArgs<XT> a) {
  using L = BwdSmem<N>;
  constexpr int XP = L::XP;
  constexpr int NP = L::NP;
  constexpr int RN = N / kGrid;     // a thread's columns of an N-wide pass
  static_assert(N % kGrid == 0, "tiling");
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);
  float* Xs = reinterpret_cast<float*>(cum + kTile);
  float* DYs = Xs + L::kSq;
  float* Ms = DYs + L::kSq;
  float* Ps = Ms + L::kSq;
  float* Bs = Ps + L::kSq;
  float* Cs = Bs + L::kNm;
  float* Ss = Cs + L::kNm;
  float* dSs = Ss + L::kNm;
  float* part = dSs + L::kNm;       // [kParts][16][64]
  float* rowQ = part;               // sum_j M_ij D_ij over a thread's j
  float* colQ = rowQ + L::kPart;    // sum_i M_ij D_ij over a thread's i
  float* dirs = colQ + L::kPart;    // d(xdt)_j . x_j over a thread's p
  float* rsum = dirs + L::kPart;    // x_j . dS B_j over a thread's p
  float* ints = rsum + L::kPart;    // C_i . S^T dy_i over a thread's n
  float* ev = part + L::kParts * L::kPart;
  float* wv = ev + kTile;
  float* dts = wv + kTile;
  float* red = dts + kTile;         // [kWarps]

  const int h = blockIdx.x;
  const int bb = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tr = tid / kGrid;
  const int tc = tid % kGrid;
  const int nt = (a.T + kTile - 1) / kTile;
  const long head = static_cast<long>(bb) * a.H + h;
  const float A_h = a.A[h];

  // dS of the last tile: the final state's cotangent
  for (int e = tid; e < kP * N; e += kThreads)
    dSs[(e / N) * NP + e % N] =
        a.dsfin != nullptr ? a.dsfin[head * (kP * N) + e] : 0.f;
  double dA_acc = 0.0;              // lane's share, warp 0

  for (int c = nt - 1; c >= 0; --c) {
    const int t0 = c * kTile;
    const int n_rows = min(kTile, a.T - t0);
    // the tile's operands and scalars
    load_plane<kP>(Xs, a.x + bb * a.x_sb + static_cast<long>(t0) * a.x_st +
                           h * kP,
                   a.x_st, n_rows);
    load_plane<kP>(DYs,
                   a.dy + ((static_cast<long>(bb) * a.T + t0) * a.H + h) * kP,
                   static_cast<long>(a.H) * kP, n_rows);
    const long bc = bb * a.bc_sb + static_cast<long>(t0) * a.bc_st + g * N;
    load_plane<N>(Bs, a.B + bc, a.bc_st, n_rows);
    load_plane<N>(Cs, a.C + bc, a.bc_st, n_rows);
    load_plane<N>(Ss, a.states + (head * nt + c) * (kP * N), N, kP);
    if (warp == 0) {
      // float64 inclusive sum of float32 dt * A, lanes j and j + 32
      double carry = 0.0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        const float dv =
            j < n_rows ? to_float(a.dt[bb * a.dt_sb + (t0 + j) * a.dt_st + h])
                       : 0.f;
        dts[j] = dv;
        double v = static_cast<double>(dv * A_h);
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
        ev[j] = expf(static_cast<float>(cum[j]));
        wv[j] = expf(static_cast<float>(carry - cum[j]));
      }
    }
    __syncthreads();
    const double seg = cum[kTile - 1];
    const float E = expf(static_cast<float>(seg));
    auto decay = [&](int i, int j) {
      return expf(i >= j ? static_cast<float>(cum[i] - cum[j]) : kNegInf);
    };

    // M_ij = (C_i . B_j) L_ij
    {
      float acc[4][4];
      product<4, 4, N>(
          acc, tr, tc, [&](int i, int k) { return Cs[i * NP + k]; },
          [&](int k, int j) { return Bs[j * NP + k]; });
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = tr + kGrid * u, j = tc + kGrid * v;
          Ms[i * XP + j] = acc[u][v] * decay(i, j);
        }
    }
    __syncthreads();

    // D_ij = dy_i . xdt_j; P = D L, and the sums of M D
    {
      float acc[4][4];
      product<4, 4, kP>(
          acc, tr, tc, [&](int i, int k) { return DYs[i * XP + k]; },
          [&](int k, int j) { return Xs[j * XP + k]; });
      float col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tr + kGrid * u;
        float row = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = tc + kGrid * v;
          const float d = acc[u][v] * dts[j];
          Ps[i * XP + j] = d * decay(i, j);
          const float q = Ms[i * XP + j] * d;
          row += q;
          col[v] += q;
        }
        rowQ[tc * kTile + i] = row;
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) colQ[tr * kTile + tc + kGrid * v] = col[v];
    }
    __syncthreads();

    // d(xdt)_j = sum_i M_ij dy_i + w_j dS B_j: dx, and ddt's direct part
    {
      float intra[4][4], st[4][4];
      product<4, 4, kTile>(
          intra, tr, tc, [&](int j, int k) { return Ms[k * XP + j]; },
          [&](int k, int p) { return DYs[k * XP + p]; });
      product<4, 4, N>(
          st, tr, tc, [&](int j, int k) { return Bs[j * NP + k]; },
          [&](int k, int p) { return dSs[p * NP + k]; });
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = tr + kGrid * u;
        float dir = 0.f, r = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = tc + kGrid * v;
          const float xv = Xs[j * XP + p];
          const float dxdt = intra[u][v] + wv[j] * st[u][v];
          dir += dxdt * xv;
          r += xv * st[u][v];
          if (j < n_rows)
            from_float(a.dx + ((static_cast<long>(bb) * a.T + t0 + j) * a.H +
                               h) * kP + p,
                       dxdt * dts[j]);
        }
        dirs[tc * kTile + j] = dir;
        rsum[tc * kTile + j] = r;
      }
    }

    // dC_i = e_i S^T dy_i + sum_j P_ij B_j
    {
      float inter[4][RN], intra[4][RN];
      product<4, RN, kP>(
          inter, tr, tc, [&](int i, int k) { return DYs[i * XP + k]; },
          [&](int k, int n) { return Ss[k * NP + n]; });
      product<4, RN, kTile>(
          intra, tr, tc, [&](int i, int k) { return Ps[i * XP + k]; },
          [&](int k, int n) { return Bs[k * NP + n]; });
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = tr + kGrid * u;
        float it = 0.f;
#pragma unroll
        for (int v = 0; v < RN; ++v) {
          const int n = tc + kGrid * v;
          it += Cs[i * NP + n] * inter[u][v];
          if (i < n_rows)
            a.dC[((static_cast<long>(bb) * a.T + t0 + i) * a.H + h) * N + n] =
                ev[i] * inter[u][v] + intra[u][v];
        }
        ints[tc * kTile + i] = it;
      }
    }

    // dB_j = sum_i P_ij C_i + w_j dt_j dS^T x_j
    {
      float intra[4][RN], st[4][RN];
      product<4, RN, kTile>(
          intra, tr, tc, [&](int j, int k) { return Ps[k * XP + j]; },
          [&](int k, int n) { return Cs[k * NP + n]; });
      product<4, RN, kP>(
          st, tr, tc, [&](int j, int k) { return Xs[j * XP + k]; },
          [&](int k, int n) { return dSs[k * NP + n]; });
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = tr + kGrid * u;
        if (j >= n_rows) continue;
        const float wd = wv[j] * dts[j];
#pragma unroll
        for (int v = 0; v < RN; ++v) {
          const int n = tc + kGrid * v;
          a.dB[((static_cast<long>(bb) * a.T + t0 + j) * a.H + h) * N + n] =
              intra[u][v] + wd * st[u][v];
        }
      }
    }

    // dS entering the tile = exp(seg) dS + sum_i e_i dy_i C_i^T, and
    // <dS, S>
    float dsn[4][RN];
    {
      product<4, RN, kTile>(
          dsn, tr, tc, [&](int p, int k) { return ev[k] * DYs[k * XP + p]; },
          [&](int k, int n) { return Cs[k * NP + n]; });
      float sds = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < RN; ++v) {
          const int p = tr + kGrid * u, n = tc + kGrid * v;
          const float d = dSs[p * NP + n];
          sds += d * Ss[p * NP + n];
          dsn[u][v] += E * d;
        }
      sds = warp_sum(sds);
      if (lane == 0) red[warp] = sds;
    }
    __syncthreads();              // every pass has read dS; parts are in
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < RN; ++v)
        dSs[(tr + kGrid * u) * NP + tc + kGrid * v] = dsn[u][v];

    // the gradient of cum, its reverse cumulative sum, ddt and dA
    if (warp == 0) {
      float dcum[2], dir[2], rj[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        float rq = 0.f, cq = 0.f, d = 0.f, r = 0.f, it = 0.f;
        for (int k = 0; k < kGrid; ++k) {
          rq += rowQ[k * kTile + j];
          cq += colQ[k * kTile + j];
          d += dirs[k * kTile + j];
          r += rsum[k * kTile + j];
          it += ints[k * kTile + j];
        }
        rj[e] = wv[j] * dts[j] * r;
        dir[e] = d;
        dcum[e] = rq - cq + ev[j] * it - rj[e];
      }
      float sds = 0.f;
      for (int w = 0; w < kWarps; ++w) sds += red[w];
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
        dA_acc += da * dts[j];
      }
    }
    __syncthreads();              // dS is in; the tile's planes are free
  }

  if (warp == 0) {
    double v = dA_acc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) a.dA[head] = static_cast<float>(v);
  }
  if (a.ds0 != nullptr)
    for (int e = tid; e < kP * N; e += kThreads)
      a.ds0[head * (kP * N) + e] = dSs[(e / N) * NP + e % N];
}

template <int N, typename XT>
int launch(const BwdArgs<XT>& a, int b, cudaStream_t stream) {
  auto kernel = ssd_bwd_kernel<N, XT>;
  constexpr size_t smem = BwdSmem<N>::kBytes;
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
// share theirs), dt [b, T, H] with head stride 1, all in x's type; dy and
// dx [b, T, H, P] contiguous in x's type; A [H], dsfin (or null) and ds0
// (or null) [b, H, P, N], states [b, H, ceil(T / 64), P, N], ddt
// [b, T, H], dA [b, H], dB and dC [b, T, H, N], all float32 contiguous.
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
