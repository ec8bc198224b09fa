// Paged chunked-prefill flash attention with per-row chunk geometry, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel paged_prefill_attention_kernel
// (src/repro/kernels/chunked_prefill_attention/paged_prefill.py): every
// batch row brings its own `start` (absolute offset of its chunk) and
// `valid` (tokens really present in the padded chunk), so one launch runs
// a whole mixed batch: prefill chunks of unequal length, decode rows
// (valid == 1) and padding rows (valid == 0).  Query token t of a row sees
// key kpos iff kpos <= start + t and kpos < start + valid.
//
// What differs from the Pallas kernel.  Its grid (B, Hkv, q block, NB) has
// a sequential innermost KV axis with m / l / acc carried in scratch; here
// one thread block owns one (row, KV head, query tile) and walks the KV
// axis in a loop, up to the tile's causal frontier and no further.  Query
// tiles that lie wholly past `valid` write zeros and leave, so a decode
// row inside a mixed batch costs one pass over its keys, not Tq of them.
// The Pallas wrapper folds GQA into g-major query rows and transposes the
// whole pool on every call; this kernel indexes q as [B, Tq, Hq, D] and
// the pool as the flat [P, Hkv, D] the model holds, through strides, and
// dereferences the block table itself (clamped; a 32-key tile spans
// several 16-token pages).
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

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kPrefillThreads) paged_prefill_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ start,
    const int* __restrict__ valid, QT* __restrict__ out, PoolView pv, int Tq,
    int Hq, int G, int TQ, float sm_scale) {
  constexpr int NT = kPrefillThreads;
  constexpr int M = kPrefillRows;
  constexpr int TK = kPrefillTile;
  constexpr int DP = D + 4;         // 4 * odd words: conflict-free float4
  constexpr int SP = TK + 4;
  constexpr int NC = D / 32;        // 4-column chunks of the output a thread
  static_assert(NT == 128 && M == 64 && TK == 32, "tiling");
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

  const int st = start[b];
  const int vl = valid[b];
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

  for (int c = tid; c < M * (D / 4); c += NT) {
    const int r = c / (D / 4);
    const int d = (c % (D / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows_used) {
      const int t = t0 + r / G;
      load4(q + ((static_cast<long>(b) * Tq + t) * Hq + h * G + r % G) * D + d,
            v);
    }
    *reinterpret_cast<float4*>(Qs + r * DP + d) =
        make_float4(v[0], v[1], v[2], v[3]);
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

  // the tile's last query sees keys up to its own position
  const int kv_hi = min(end, st + t0 + n_tok);
  __syncthreads();

  for (int kv0 = 0; kv0 < kv_hi; kv0 += TK) {
    load_kv_tile<KT, D, DP, TK, NT>(Ks, k_pool, k_scale, pv, b, h, kv0, kv_hi,
                                    tid);
    load_kv_tile<KT, D, DP, TK, NT>(Vs, v_pool, v_scale, pv, b, h, kv0, kv_hi,
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
        ok[jj] = kpos <= qpos[i] && kpos < end;
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
          const float4 v = *reinterpret_cast<const float4*>(
              Vs + (j + jj) * DP + (tx + 8 * c) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c * 4 + 0] += pr[i][jj] * v.x;
            acc[i][c * 4 + 1] += pr[i][jj] * v.y;
            acc[i][c * 4 + 2] += pr[i][jj] * v.z;
            acc[i][c * 4 + 3] += pr[i][jj] * v.w;
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
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store1(o + (tx + 8 * c) * 4 + e, acc[i][c * 4 + e] / l_i);
    }
  }
}

template <typename QT, typename KT, int D>
int launch_prefill(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* start, const int* valid, void* out,
                   const PoolView& pv, int B, int Tq, int Hq, int Hkv,
                   cudaStream_t stream) {
  auto kernel = paged_prefill_kernel<QT, KT, D>;
  constexpr size_t smem = prefill_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = Hq / Hkv;
  const int TQ = kPrefillRows / G;
  const dim3 grid((Tq + TQ - 1) / TQ, Hkv, B);
  kernel<<<grid, kPrefillThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), k_scale, v_scale, start, valid,
      static_cast<QT*>(out), pv, Tq, Hq, G, TQ,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch_prefill_d(int D, const void* q, const void* k_pool,
                       const void* v_pool, const float* k_scale,
                       const float* v_scale, const int* start,
                       const int* valid, void* out, const PoolView& pv, int B,
                       int Tq, int Hq, int Hkv, cudaStream_t stream) {
  if (D == 64)
    return launch_prefill<QT, KT, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                      start, valid, out, pv, B, Tq, Hq, Hkv,
                                      stream);
  if (D == 128)
    return launch_prefill<QT, KT, 128>(q, k_pool, v_pool, k_scale, v_scale,
                                       start, valid, out, pv, B, Tq, Hq, Hkv,
                                       stream);
  return -1;
}

template <typename QT>
int dispatch_prefill_kv(int kv_dtype, int D, const void* q,
                        const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale,
                        const int* start, const int* valid, void* out,
                        const PoolView& pv, int B, int Tq, int Hq, int Hkv,
                        cudaStream_t stream) {
  if (kv_dtype == kF32)
    return dispatch_prefill_d<QT, float>(D, q, k_pool, v_pool, k_scale,
                                         v_scale, start, valid, out, pv, B,
                                         Tq, Hq, Hkv, stream);
  if (kv_dtype == kBF16)
    return dispatch_prefill_d<QT, __nv_bfloat16>(D, q, k_pool, v_pool,
                                                 k_scale, v_scale, start,
                                                 valid, out, pv, B, Tq, Hq,
                                                 Hkv, stream);
  if (kv_dtype == kI8)
    return dispatch_prefill_d<QT, int8_t>(D, q, k_pool, v_pool, k_scale,
                                          v_scale, start, valid, out, pv, B,
                                          Tq, Hq, Hkv, stream);
  return -1;
}

}  // namespace paged

// Returns the CUDA error of the launch (0 = launched), or -1 for a shape
// or type this kernel does not take.  Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int paged_chunked_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* start, const int* valid, const float* k_scale,
    const float* v_scale, void* out, int B, int Tq, int Hq, int Hkv, int D,
    int NB, int block_size, int n_blk, int64_t kv_stride_tok,
    int64_t kv_stride_head, int64_t sc_stride_tok, int q_dtype, int kv_dtype,
    void* stream) {
  using namespace paged;
  if (B <= 0 || Tq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > kPrefillRows || NB <= 0 || block_size <= 0 || n_blk <= 0 ||
      B > 65535 || Hkv > 65535)
    return -1;
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return -1;
  const PoolView pv{tables, NB, block_size, n_blk, kv_stride_tok,
                    kv_stride_head, sc_stride_tok};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_prefill_kv<float>(kv_dtype, D, q, k_pool, v_pool, k_scale,
                                      v_scale, start, valid, out, pv, B, Tq,
                                      Hq, Hkv, s);
  if (q_dtype == kBF16)
    return dispatch_prefill_kv<__nv_bfloat16>(kv_dtype, D, q, k_pool, v_pool,
                                              k_scale, v_scale, start, valid,
                                              out, pv, B, Tq, Hq, Hkv, s);
  return -1;
}
