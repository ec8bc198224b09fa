// GQA flash-decode for Hopper (sm_90a), shared by the paged kernel
// (paged_decode.cu) and the dense one (decode.cu): the two differ only in
// the view that turns (row, position) into a KV address.
//
// One query token a row attends over the row's keys with an online
// softmax: keys at or past `length` masked, the denominator floored at
// 1e-30, and, for an int8 pool, per-token f32 scales multiplied in after
// the load.
//
// What differs from the Pallas kernels.  Their grid (B, Hkv, KV blocks)
// walks the keys in order and carries m / l / acc in scratch from one grid
// step to the next; thread blocks on this card run in no order, so the KV
// walk is a loop inside one thread block per (row, KV head).  The cache is
// read in place through the view: the paged pool through the row's block
// table, the dense cache through its [B, S, Hkv, D] strides (the Pallas
// wrappers transpose the whole cache on every call).
//
// Bound: the KV bytes read (every key and value of every row once); the
// arithmetic is a few FLOPs a byte.  One thread block per (row, KV head)
// leaves most of the 132 SMs idle when B * Hkv is a few dozen; the first
// step for a later change is flash-decoding's split of the KV axis over
// thread blocks with a second pass that combines the partial (m, l, acc).
//
// Products are FMA loops over shared-memory tiles in f32, so f32 inputs
// keep full f32 precision (no TF32).
#pragma once

#include <math.h>

#include "paged_common.cuh"

namespace paged {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeTile = 64;     // keys per tile
constexpr int kMaxGroup = 16;       // query heads per KV head, at most

template <int D>
constexpr size_t decode_smem_bytes() {
  return sizeof(float) * (2 * kDecodeTile * (D + 4) + kMaxGroup * (D + 4) +
                          kMaxGroup * kDecodeTile + 3 * kMaxGroup);
}

template <typename QT, typename KT, int D, typename View>
__global__ void __launch_bounds__(kDecodeThreads) decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ lengths,
    QT* __restrict__ out, View view, int Hq, int G, float sm_scale) {
  constexpr int NT = kDecodeThreads;
  constexpr int TK = kDecodeTile;
  constexpr int DP = D + 4;         // row pitch: 4 * odd words, so that 8
                                    // lanes reading 8 rows hit 32 banks
  static_assert(TK == 64 && NT % TK == 0 && D % 4 == 0 && D <= NT,
                "tiling");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                          // [TK][DP]
  float* Vs = Ks + TK * DP;                  // [TK][DP]
  float* Qs = Vs + TK * DP;                  // [kMaxGroup][DP]
  float* Ss = Qs + kMaxGroup * DP;           // [kMaxGroup][TK]
  float* m_s = Ss + kMaxGroup * TK;          // running max
  float* l_s = m_s + kMaxGroup;              // running denominator
  float* a_s = l_s + kMaxGroup;              // this tile's rescale factor

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int length = view.limit(lengths[b]);

  for (int c = tid; c < G * (D / 4); c += NT) {
    const int g = c / (D / 4);
    const int d = (c % (D / 4)) * 4;
    float x[4];
    load4(q + (static_cast<long>(b) * Hq + h * G + g) * D + d, x);
    *reinterpret_cast<float4*>(Qs + g * DP + d) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // output ownership: column d of every DG-th query head of the group
  // (DG = 2 for D = 64, 1 for D = 112 and 128); threads past DG * D own
  // nothing
  constexpr int DG = NT / D;
  constexpr int NACC = kMaxGroup / DG;
  const bool owner = tid < DG * D;
  const int d_own = tid % D;
  const int g_first = tid / D;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int kv0 = 0; kv0 < length; kv0 += TK) {
    load_kv_tile<KT, D, DP, TK, NT>(Ks, k, k_scale, view, b, h, kv0, length,
                                    tid);
    load_kv_tile<KT, D, DP, TK, NT>(Vs, v, v_scale, view, b, h, kv0, length,
                                    tid);
    __syncthreads();

    // scores: thread = (key j, half of the group)
    {
      const int j = tid % TK;
      const bool live = kv0 + j < length;
      for (int g = tid / TK; g < G; g += NT / TK) {
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + j * DP + d);
          const float4 qv = *reinterpret_cast<const float4*>(Qs + g * DP + d);
          s += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
        Ss[g * TK + j] = live ? s * sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp a query head, two keys a lane
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int g = warp; g < G; g += NT / 32) {
        const float s0 = Ss[g * TK + lane];
        const float s1 = Ss[g * TK + lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        const float p0 = kv0 + lane < length ? expf(s0 - m_new) : 0.f;
        const float p1 = kv0 + lane + 32 < length ? expf(s1 - m_new) : 0.f;
        float sum = p0 + p1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        Ss[g * TK + lane] = p0;
        Ss[g * TK + lane + 32] = p1;
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + sum;
          m_s[g] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
    if (owner) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int g = g_first + i * DG;
        if (g < G) acc[i] *= a_s[g];
      }
      for (int j = 0; j < TK; ++j) {
        const float x = Vs[j * DP + d_own];
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          const int g = g_first + i * DG;
          if (g < G) acc[i] += Ss[g * TK + j] * x;
        }
      }
    }
    __syncthreads();
  }

  if (!owner) return;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int g = g_first + i * DG;
    if (g < G) {
      const float l = fmaxf(l_s[g], kMinDenominator);
      store1(out + (static_cast<long>(b) * Hq + h * G + g) * D + d_own,
             acc[i] / l);
    }
  }
}

// Launch on `stream`; returns the CUDA error of the launch (0 = launched).
template <typename QT, typename KT, int D, typename View>
int launch_decode(const void* q, const void* k, const void* v,
                  const float* k_scale, const float* v_scale,
                  const int* lengths, void* out, const View& view, int B,
                  int Hq, int Hkv, cudaStream_t stream) {
  auto kernel = decode_kernel<QT, KT, D, View>;
  constexpr size_t smem = decode_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Hkv);
  kernel<<<grid, kDecodeThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), k_scale, v_scale, lengths,
      static_cast<QT*>(out), view, Hq, Hq / Hkv,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace paged
