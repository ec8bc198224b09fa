// Paged GQA flash-decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel paged_decode_attention_kernel
// (src/repro/kernels/decode_attention/paged_decode.py): one query token a
// row attends over KV held in a physical block pool through the row's
// block table.  The kernel body is decode_kernel.cuh's, read through a
// PoolView: the table entry is clamped and turned into an offset into the
// flat [P, Hkv, D] pool exactly as the model holds it (strides are
// arguments, the pool is never transposed).  A KV tile is 64 keys, so it
// spans several 16-token pages, each with its own table entry.  Bound and
// design notes: decode_kernel.cuh.

#include "decode_kernel.cuh"

namespace paged {

template <typename QT, typename KT>
int dispatch_paged_decode_d(int D, const void* q, const void* k_pool,
                            const void* v_pool, const float* k_scale,
                            const float* v_scale, const int* lengths,
                            void* out, const PoolView& pv, int B, int Hq,
                            int Hkv, cudaStream_t stream) {
  if (D == 64)
    return launch_decode<QT, KT, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                     lengths, out, pv, B, Hq, Hkv, stream);
  if (D == 128)
    return launch_decode<QT, KT, 128>(q, k_pool, v_pool, k_scale, v_scale,
                                      lengths, out, pv, B, Hq, Hkv, stream);
  return -1;
}

template <typename QT>
int dispatch_paged_decode_kv(int kv_dtype, int D, const void* q,
                             const void* k_pool, const void* v_pool,
                             const float* k_scale, const float* v_scale,
                             const int* lengths, void* out,
                             const PoolView& pv, int B, int Hq, int Hkv,
                             cudaStream_t stream) {
  if (kv_dtype == kF32)
    return dispatch_paged_decode_d<QT, float>(D, q, k_pool, v_pool, k_scale,
                                              v_scale, lengths, out, pv, B,
                                              Hq, Hkv, stream);
  if (kv_dtype == kBF16)
    return dispatch_paged_decode_d<QT, __nv_bfloat16>(
        D, q, k_pool, v_pool, k_scale, v_scale, lengths, out, pv, B, Hq, Hkv,
        stream);
  if (kv_dtype == kI8)
    return dispatch_paged_decode_d<QT, int8_t>(D, q, k_pool, v_pool, k_scale,
                                               v_scale, lengths, out, pv, B,
                                               Hq, Hkv, stream);
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
    return dispatch_paged_decode_kv<float>(kv_dtype, D, q, k_pool, v_pool,
                                           k_scale, v_scale, lengths, out, pv,
                                           B, Hq, Hkv, s);
  if (q_dtype == kBF16)
    return dispatch_paged_decode_kv<__nv_bfloat16>(
        kv_dtype, D, q, k_pool, v_pool, k_scale, v_scale, lengths, out, pv, B,
        Hq, Hkv, s);
  return -1;
}
