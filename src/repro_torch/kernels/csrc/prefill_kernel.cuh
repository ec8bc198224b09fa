// Chunked-prefill flash attention for Hopper (sm_90a), shared by the
// paged kernel (paged_prefill.cu: per-row chunk geometry over a block
// pool) and the dense one (chunked_prefill.cu: one chunk offset for the
// batch over a [B, S, Hkv, D] cache).
//
// Row b's chunk starts at absolute position start[b * start_stride] and
// holds valid[b] real tokens (Tq when `valid` is null).  Query token t sees
// key kpos iff kpos <= start + t and kpos < start + valid.
//
// What differs from the Pallas kernels.  Their grid (B, Hkv, q block, KV
// block) has a sequential innermost KV axis with m / l / acc carried in
// scratch; here one thread block owns one (row, KV head, query tile) and
// walks the KV axis in a loop, up to the tile's causal frontier and no
// further.  Query tiles that lie wholly past `valid` write zeros and
// leave, so a decode row inside a mixed batch costs one pass over its
// keys, not Tq of them.  The Pallas wrappers fold GQA into g-major query
// rows and transpose the whole cache on every call; this kernel indexes q
// as [B, Tq, Hq, D] and reads the cache in place through the view.
//
// Tiling: 64 query rows = (64 / G) tokens x G query heads of one KV head,
// so the group shares every K/V tile; 32 keys a tile; 128 threads, each
// with a 4 x 4 patch of the score tile and a 4 x (D / 8) patch of the
// output, both products as f32 FMA loops over shared memory read in
// 16-byte pieces.  f32 inputs therefore keep full f32 precision.
//
// Bound: operations, for long chunks (4 * Hq * D FLOPs a query-key pair);
// KV bytes for short ones.  FMA loops cannot reach the tensor-core rate:
// moving the two products to mma.sync / wgmma on bf16 tiles, and K/V
// loads to cp.async or TMA, is the work of a later change.
#pragma once

#include <math.h>

#include "paged_common.cuh"

namespace paged {

constexpr int kPrefillThreads = 128;
constexpr int kPrefillRows = 64;    // query rows a thread block owns
constexpr int kPrefillTile = 32;    // keys per tile

template <int D>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * (kPrefillRows * (D + 4) +
                          2 * kPrefillTile * (D + 4) +
                          kPrefillRows * (kPrefillTile + 4));
}

template <typename QT, typename KT, int D, typename View>
__global__ void __launch_bounds__(kPrefillThreads) prefill_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ start,
    int start_stride, const int* __restrict__ valid, QT* __restrict__ out,
    View view, int Tq, int Hq, int G, int TQ, float sm_scale) {
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
    }
  }
}

// Launch on `stream`; returns the CUDA error of the launch (0 = launched).
template <typename QT, typename KT, int D, typename View>
int launch_prefill(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* start, int start_stride, const int* valid,
                   void* out, const View& view, int B, int Tq, int Hq,
                   int Hkv, cudaStream_t stream) {
  auto kernel = prefill_kernel<QT, KT, D, View>;
  constexpr size_t smem = prefill_smem_bytes<D>();
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
      static_cast<QT*>(out), view, Tq, Hq, G, TQ,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paged
