// Paged GQA flash-decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel paged_decode_attention_kernel
// (src/repro/kernels/decode_attention/paged_decode.py): one query token a
// row attends over KV held in a physical block pool through the row's
// block table, with an online softmax over the row's keys, keys at or
// past `length` masked, the denominator floored at 1e-30, and an optional
// int8 pool whose per-token f32 scales are multiplied in after the load.
//
// What differs from the Pallas kernel.  Its grid (B, Hkv, NB) walks the
// logical blocks in order and carries m / l / acc in scratch from one
// grid step to the next; thread blocks on this card run in no order, so
// the KV walk is a loop inside one thread block per (row, KV head).  The
// scalar-prefetched table becomes a load inside the block: the table
// entry is clamped and turned into an offset into the flat [P, Hkv, D]
// pool exactly as the model holds it (strides are arguments, the pool is
// never transposed).  A KV tile is 64 keys, so it spans several 16-token
// pages, each with its own table entry.
//
// Bound: the KV bytes read (every key and value of every row once); the
// arithmetic is a few FLOPs a byte.  This first version keeps one thread
// block per (row, KV head), which at B * Hkv of a few dozen leaves most
// of the 132 SMs idle.  The first step for a later change is
// flash-decoding's split of the KV axis over thread blocks with a second
// pass that combines the partial (m, l, acc).
//
// Products are FMA loops over shared-memory tiles in f32, so f32 inputs
// keep full f32 precision (no TF32).

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

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ lengths,
    QT* __restrict__ out, PoolView pv, int Hq, int G, float sm_scale) {
  constexpr int NT = kDecodeThreads;
  constexpr int TK = kDecodeTile;
  constexpr int DP = D + 4;         // row pitch: 4 * odd words, so that 8
                                    // lanes reading 8 rows hit 32 banks
  static_assert(TK == 64 && NT % TK == 0 && NT % D == 0, "tiling");
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
  const int length = lengths[b];

  for (int c = tid; c < G * (D / 4); c += NT) {
    const int g = c / (D / 4);
    const int d = (c % (D / 4)) * 4;
    float v[4];
    load4(q + (static_cast<long>(b) * Hq + h * G + g) * D + d, v);
    *reinterpret_cast<float4*>(Qs + g * DP + d) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // output ownership: one column d, every (D=128) or every other (D=64)
  // query head of the group
  constexpr int DG = NT / D;
  constexpr int NACC = kMaxGroup / DG;
  const int d_own = tid % D;
  const int g_first = tid / D;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int kv0 = 0; kv0 < length; kv0 += TK) {
    load_kv_tile<KT, D, DP, TK, NT>(Ks, k_pool, k_scale, pv, b, h, kv0,
                                    length, tid);
    load_kv_tile<KT, D, DP, TK, NT>(Vs, v_pool, v_scale, pv, b, h, kv0,
                                    length, tid);
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
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int g = g_first + i * DG;
      if (g < G) acc[i] *= a_s[g];
    }
    for (int j = 0; j < TK; ++j) {
      const float v = Vs[j * DP + d_own];
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int g = g_first + i * DG;
        if (g < G) acc[i] += Ss[g * TK + j] * v;
      }
    }
    __syncthreads();
  }

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

template <typename QT, typename KT, int D>
int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                  const float* k_scale, const float* v_scale,
                  const int* lengths, void* out, const PoolView& pv, int B,
                  int Hq, int Hkv, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<QT, KT, D>;
  constexpr size_t smem = decode_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Hkv);
  kernel<<<grid, kDecodeThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), k_scale, v_scale, lengths,
      static_cast<QT*>(out), pv, Hq, Hq / Hkv, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch_decode_d(int D, const void* q, const void* k_pool,
                      const void* v_pool, const float* k_scale,
                      const float* v_scale, const int* lengths, void* out,
                      const PoolView& pv, int B, int Hq, int Hkv,
                      cudaStream_t stream) {
  if (D == 64)
    return launch_decode<QT, KT, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                     lengths, out, pv, B, Hq, Hkv, stream);
  if (D == 128)
    return launch_decode<QT, KT, 128>(q, k_pool, v_pool, k_scale, v_scale,
                                      lengths, out, pv, B, Hq, Hkv, stream);
  return -1;
}

template <typename QT>
int dispatch_decode_kv(int kv_dtype, int D, const void* q, const void* k_pool,
                       const void* v_pool, const float* k_scale,
                       const float* v_scale, const int* lengths, void* out,
                       const PoolView& pv, int B, int Hq, int Hkv,
                       cudaStream_t stream) {
  if (kv_dtype == kF32)
    return dispatch_decode_d<QT, float>(D, q, k_pool, v_pool, k_scale,
                                        v_scale, lengths, out, pv, B, Hq, Hkv,
                                        stream);
  if (kv_dtype == kBF16)
    return dispatch_decode_d<QT, __nv_bfloat16>(D, q, k_pool, v_pool, k_scale,
                                                v_scale, lengths, out, pv, B,
                                                Hq, Hkv, stream);
  if (kv_dtype == kI8)
    return dispatch_decode_d<QT, int8_t>(D, q, k_pool, v_pool, k_scale,
                                         v_scale, lengths, out, pv, B, Hq,
                                         Hkv, stream);
  return -1;
}

}  // namespace paged

// Returns the CUDA error of the launch (0 = launched), or -1 for a shape
// or type this kernel does not take.  Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* lengths, const float* k_scale, const float* v_scale, void* out,
    int B, int Hq, int Hkv, int D, int NB, int block_size, int n_blk,
    int64_t kv_stride_tok, int64_t kv_stride_head, int64_t sc_stride_tok,
    int q_dtype, int kv_dtype, void* stream) {
  using namespace paged;
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup ||
      NB <= 0 || block_size <= 0 || n_blk <= 0)
    return -1;
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return -1;
  const PoolView pv{tables, NB, block_size, n_blk, kv_stride_tok,
                    kv_stride_head, sc_stride_tok};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_decode_kv<float>(kv_dtype, D, q, k_pool, v_pool, k_scale,
                                     v_scale, lengths, out, pv, B, Hq, Hkv, s);
  if (q_dtype == kBF16)
    return dispatch_decode_kv<__nv_bfloat16>(kv_dtype, D, q, k_pool, v_pool,
                                             k_scale, v_scale, lengths, out,
                                             pv, B, Hq, Hkv, s);
  return -1;
}
