// Mamba2 SSD chunked scan with a carried state, for Hopper (sm_90a).
//
// Replaces the Pallas kernel ssd_scan_kernel
// (src/repro/kernels/ssd_scan/ssd_kernel.py, wrapper ssd_scan/ops.py).
// Inputs come pre-fused from the wrapper as the reference's do: xdt = x*dt
// [b, t, h, P] and dA = dt*A [b, t, h], with B and C [b, t, g, N] (a head
// reads its group's row in place, where the Pallas wrapper repeats and
// transposes them), the state s0 [b, h, P, N], all f32.  For every chunk of
// L tokens, with cum the inclusive cumsum of dA inside the chunk and
// seg = cum[L-1]:
//
//   intra:  y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
//   inter:  y_i += exp(cum_i) C_i S^T
//   state:  S    = exp(seg) S + sum_j exp(seg - cum_j) xdt_j^T B_j
//
// The decay is masked inside the exponent (exp(-1e30) = 0 for j > i), as
// in ssd_kernel.py, so no anti-causal exp can overflow.  cum is summed and
// kept in f64, and each difference cum_i - cum_j is formed in f64 and
// rounded once: the sums reach ~1e3 at the model's step sizes, where an
// f32 difference would carry their rounding (~1e-4 absolute, hence a
// relative error of ~1e-4 in every decay, which the model's later layers
// amplify).  The plain version (ssd_scan/ops.py::ssd_scan_ref) rounds the
// same f64 differences.  y is written in the caller's type, the final
// state in f32.
//
// What differs from the Pallas kernel.  Its grid (b, h, chunk) carries the
// [P, N] state in scratch from one chunk to the next; here one thread
// block owns one (batch row, head), walks the chunks in order in a loop,
// and keeps the state in shared memory (16 KB at N = 64, 32 KB at
// N = 128), transposed to [N][P] so both products that touch it read it in
// 16-byte pieces.  Its L x L score tile (256 KB in f32 at L = 256) does not
// fit in a thread block's 227 KB of shared memory, so the intra product is
// tiled: 64 rows of the chunk at a time against 64-column blocks at or
// below the diagonal.  The state update rides on the last row block's walk
// over all column blocks, in registers, and lands after every row of the
// chunk has read the old state.  L is any length up to 256 (215 as well as
// 256): rows and columns past L are zero-filled and masked.
//
// Bound: operations.  All products are f32 FMA loops over shared memory
// (no TF32, as the reference's f32 scan), on 256 threads with a 4 x 4
// register patch each.  One thread block per (row, head) fills 112 of the
// 132 SMs at zamba2-7b's 112 heads and batch 1.  The Mamba2 paper's
// three-pass layout (chunk-local states in parallel, a short state-passing
// scan, outputs in parallel) and tensor-core products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {

constexpr int kThreads = 256;
constexpr int kBlk = 64;          // rows (and columns) of an intra tile
constexpr int kP = 64;            // head dim
constexpr int kMaxChunk = 256;
constexpr float kNegInf = -1e30f;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int N>
constexpr size_t smem_bytes() {
  return sizeof(double) * kMaxChunk +                // cum
         sizeof(float) * (kMaxChunk +                // sd
                          2 * kBlk * (N + 4) +       // Cs, Bs
                          kBlk * (kP + 4) +          // Xs
                          kBlk * (kBlk + 4) +        // Ms
                          N * (kP + 4));             // St
}

// Row i of a tile as a float4 at column c (pitches are multiples of 4).
__device__ __forceinline__ float4 ld4(const float* base, int pitch, int i,
                                      int c) {
  return *reinterpret_cast<const float4*>(base + i * pitch + c);
}

template <int N, typename YT>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const float* __restrict__ xdt, const float* __restrict__ dA,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ s0, YT* __restrict__ y,
    float* __restrict__ sfin, int T, int H, int G, int L) {
  constexpr int P = kP;
  constexpr int NP = N + 4;       // pitches of 4 * odd words: 8 lanes
  constexpr int PP = P + 4;       // reading 8 rows hit 32 banks
  constexpr int MP = kBlk + 4;
  constexpr int NR = N / 16;      // state rows a thread owns
  static_assert(N % 16 == 0 && N >= 16, "tiling");
  extern __shared__ __align__(16) float smem[];
  double* cum = reinterpret_cast<double*>(smem);  // [kMaxChunk] inclusive
                                                  // cumsum of dA
  float* sd = smem + 2 * kMaxChunk;  // [kMaxChunk] exp(seg - cum)
  float* Cs = sd + kMaxChunk;     // [kBlk][NP] C rows of the row block
  float* Bs = Cs + kBlk * NP;     // [kBlk][NP] B rows of the column block
  float* Xs = Bs + kBlk * NP;     // [kBlk][PP] xdt rows of the column block
  float* Ms = Xs + kBlk * PP;     // [kBlk][MP] (C B^T) o decay
  float* St = Ms + kBlk * MP;     // [N][PP] the state, transposed

  const int h = blockIdx.x;
  const int bb = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid / 16;        // rows ty*4 .. ty*4+3; state rows ty+16r
  const int tx = tid % 16;        // columns tx*4 .. tx*4+3; Ms cols tx+16jj
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long head_state = (static_cast<long>(bb) * H + h) * P * N;

  for (int c = tid; c < P * N; c += kThreads)
    St[(c % N) * PP + c / N] = s0[head_state + c];

  // global row offsets of token t of this (batch row, head)
  auto x_row = [&](int t) {
    return ((static_cast<long>(bb) * T + t) * H + h) * P;
  };
  auto bc_row = [&](int t) {
    return ((static_cast<long>(bb) * T + t) * G + g) * N;
  };
  // rows [r0, r0 + kBlk) of a [T][W] operand into dst[kBlk][W + 4], zero
  // past the chunk's L rows
  auto load_rows = [&](float* dst, const float* src, int W, int t_first,
                       int n_rows, bool is_x) {
    const int w4 = W / 4;
    for (int e = tid; e < kBlk * w4; e += kThreads) {
      const int r = e / w4;
      const int c4 = (e % w4) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n_rows) {
        const long off = (is_x ? x_row(t_first + r) : bc_row(t_first + r));
        val = *reinterpret_cast<const float4*>(src + off + c4);
      }
      *reinterpret_cast<float4*>(dst + r * (W + 4) + c4) = val;
    }
  };

  const int n_chunks = T / L;
  const int n_blk = (L + kBlk - 1) / kBlk;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int tc = ch * L;
    for (int i = tid; i < kMaxChunk; i += kThreads)
      cum[i] = i < L ? dA[(static_cast<long>(bb) * T + tc + i) * H + h] : 0.0;
    __syncthreads();
    // inclusive scan in f64, 32 entries at a time
    if (warp == 0) {
      double carry = 0.0;
      for (int base = 0; base < L; base += 32) {
        double v = cum[base + lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        cum[base + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float seg = static_cast<float>(cum[L - 1]);
    for (int i = tid; i < L; i += kThreads)
      sd[i] = expf(static_cast<float>(cum[L - 1] - cum[i]));

    float supd[NR][4];            // this chunk's state increment
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) supd[r][c] = 0.f;

    for (int I = 0; I < n_blk; ++I) {
      const int i0 = I * kBlk;
      load_rows(Cs, Cm, N, tc + i0, min(kBlk, L - i0), false);
      __syncthreads();

      // inter: acc = exp(cum_i) C_i S^T
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4(Cs, NP, ty * 4 + i, n);
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[e] = ld4(St, PP, n + e, tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] += cv[i].x * sv[0].x + cv[i].y * sv[1].x +
                       cv[i].z * sv[2].x + cv[i].w * sv[3].x;
          acc[i][1] += cv[i].x * sv[0].y + cv[i].y * sv[1].y +
                       cv[i].z * sv[2].y + cv[i].w * sv[3].y;
          acc[i][2] += cv[i].x * sv[0].z + cv[i].y * sv[1].z +
                       cv[i].z * sv[2].z + cv[i].w * sv[3].z;
          acc[i][3] += cv[i].x * sv[0].w + cv[i].y * sv[1].w +
                       cv[i].z * sv[2].w + cv[i].w * sv[3].w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(static_cast<float>(cum[i0 + ty * 4 + i]));
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= e;
      }

      // intra: column blocks at or below the diagonal
      for (int J = 0; J <= I; ++J) {
        const int j0 = J * kBlk;
        const int j_rows = min(kBlk, L - j0);
        load_rows(Bs, Bm, N, tc + j0, j_rows, false);
        load_rows(Xs, xdt, P, tc + j0, j_rows, true);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ld4(Cs, NP, ty * 4 + i, n);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) bv[jj] = ld4(Bs, NP, tx + 16 * jj, n);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              s[i][jj] += cv[i].x * bv[jj].x + cv[i].y * bv[jj].y +
                          cv[i].z * bv[jj].z + cv[i].w * bv[jj].w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ig = i0 + ty * 4 + i;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int jg = j0 + tx + 16 * jj;
            const bool causal = ig >= jg && jg < L;
            Ms[(ty * 4 + i) * MP + tx + 16 * jj] =
                s[i][jj] * expf(causal ? static_cast<float>(cum[ig] - cum[jg])
                                       : kNegInf);
          }
        }
        __syncthreads();

        // acc += M xdt
#pragma unroll 2
        for (int j = 0; j < kBlk; j += 4) {
          float4 mv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = ld4(Ms, MP, ty * 4 + i, j);
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[e] = ld4(Xs, PP, j + e, tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] += mv[i].x * xv[0].x + mv[i].y * xv[1].x +
                         mv[i].z * xv[2].x + mv[i].w * xv[3].x;
            acc[i][1] += mv[i].x * xv[0].y + mv[i].y * xv[1].y +
                         mv[i].z * xv[2].y + mv[i].w * xv[3].y;
            acc[i][2] += mv[i].x * xv[0].z + mv[i].y * xv[1].z +
                         mv[i].z * xv[2].z + mv[i].w * xv[3].z;
            acc[i][3] += mv[i].x * xv[0].w + mv[i].y * xv[1].w +
                         mv[i].z * xv[2].w + mv[i].w * xv[3].w;
          }
        }

        // the last row block walks every column block: accumulate the
        // state increment sum_j sd_j B_j^T xdt_j on the way
        if (I == n_blk - 1) {
          for (int j = 0; j < j_rows; ++j) {
            const float w = sd[j0 + j];
            const float4 xv = ld4(Xs, PP, j, tx * 4);
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              const float bw = Bs[j * NP + ty + 16 * r] * w;
              supd[r][0] += bw * xv.x;
              supd[r][1] += bw * xv.y;
              supd[r][2] += bw * xv.z;
              supd[r][3] += bw * xv.w;
            }
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ig = i0 + ty * 4 + i;
        if (ig < L) {
          YT* o = y + x_row(tc + ig) + tx * 4;
#pragma unroll
          for (int c = 0; c < 4; ++c) store1(o + c, acc[i][c]);
        }
      }
    }

    // every row of the chunk has read the old state (the last column
    // block ended in a barrier): S = exp(seg) S + increment
    const float eseg = expf(seg);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float* row = St + (ty + 16 * r) * PP + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) row[c] = row[c] * eseg + supd[r][c];
    }
  }
  __syncthreads();
  for (int c = tid; c < P * N; c += kThreads)
    sfin[head_state + c] = St[(c % N) * PP + c / N];
}

template <int N, typename YT>
int launch(const float* xdt, const float* dA, const float* B, const float* C,
           const float* s0, void* y, float* sfin, int b, int T, int H, int G,
           int L, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<N, YT>;
  constexpr size_t smem = smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, b);
  kernel<<<grid, kThreads, smem, stream>>>(xdt, dA, B, C, s0,
                                           static_cast<YT*>(y), sfin, T, H, G,
                                           L);
  return static_cast<int>(cudaGetLastError());
}

template <typename YT>
int dispatch_n(int N, const float* xdt, const float* dA, const float* B,
               const float* C, const float* s0, void* y, float* sfin, int b,
               int T, int H, int G, int L, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<16, YT>(xdt, dA, B, C, s0, y, sfin, b, T, H, G, L, stream);
    case 32:
      return launch<32, YT>(xdt, dA, B, C, s0, y, sfin, b, T, H, G, L, stream);
    case 64:
      return launch<64, YT>(xdt, dA, B, C, s0, y, sfin, b, T, H, G, L, stream);
    case 128:
      return launch<128, YT>(xdt, dA, B, C, s0, y, sfin, b, T, H, G, L,
                             stream);
    default:
      return -1;
  }
}

}  // namespace ssd

// Returns the CUDA error of the launch (0 = launched), or -1 for a shape
// or type this kernel does not take.  Launches on `stream`, does not
// synchronise, allocates nothing.  All inputs are contiguous f32; y is
// [b, T, H, P] of y_dtype, sfin [b, H, P, N] f32.
extern "C" int ssd_scan(const float* xdt, const float* dA, const float* B,
                        const float* C, const float* s0, void* y, float* sfin,
                        int b, int T, int H, int G, int P, int N, int L,
                        int y_dtype, void* stream) {
  using namespace ssd;
  if (b <= 0 || b > 65535 || H <= 0 || G <= 0 || H % G != 0 || P != kP ||
      L <= 0 || L > kMaxChunk || T <= 0 || T % L != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_dtype == kF32)
    return dispatch_n<float>(N, xdt, dA, B, C, s0, y, sfin, b, T, H, G, L, s);
  if (y_dtype == kBF16)
    return dispatch_n<__nv_bfloat16>(N, xdt, dA, B, C, s0, y, sfin, b, T, H,
                                     G, L, s);
  return -1;
}
