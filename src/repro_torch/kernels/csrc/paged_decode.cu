// Paged GQA flash-decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel paged_decode_attention_kernel
// (src/repro/kernels/decode_attention/paged_decode.py): one query token a
// row attends over KV held in a physical block pool through the row's
// block table.  The kernel body is decode_kernel.cuh's, read through a
// PoolView: the table entry is clamped and turned into an offset into the
// flat [P, Hkv, D] pool exactly as the model holds it (strides are
// arguments, the pool is never transposed).  A thread block reads the
// table entries of its split's pages once; a 32-key tile spans two 16-token
// pages.  Bound and design notes: decode_kernel.cuh.

#include "decode_kernel.cuh"

namespace paged {

template <typename QT, typename KT>
int dispatch_paged_decode_d(int D, const DecodeArgs& a, const PoolView& pv,
                            cudaStream_t stream) {
  if (D == 64) return launch_decode<QT, KT, 64>(a, pv, stream);
  if (D == 128) return launch_decode<QT, KT, 128>(a, pv, stream);
  return -1;
}

template <typename QT>
int dispatch_paged_decode_kv(int kv_dtype, int D, const DecodeArgs& a,
                             const PoolView& pv, cudaStream_t stream) {
  if (kv_dtype == kF32)
    return dispatch_paged_decode_d<QT, float>(D, a, pv, stream);
  if (kv_dtype == kBF16)
    return dispatch_paged_decode_d<QT, __nv_bfloat16>(D, a, pv, stream);
  if (kv_dtype == kI8)
    return dispatch_paged_decode_d<QT, int8_t>(D, a, pv, stream);
  return -1;
}

}  // namespace paged

// Returns the CUDA error of the launches (0 = launched), or -1 for a shape
// or type this kernel does not take.  Launches on `stream`, does not
// synchronise, allocates nothing: the workspace (f32 [B, Hq, splits, D]
// partial sums, [B, Hq, splits] m and l) is the caller's, and may be null
// when splits == ceil(NB * block_size / keys_per_split) is 1.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* tables,
    const int* lengths, const float* k_scale, const float* v_scale, void* out,
    float* ws_acc, float* ws_m, float* ws_l, int B, int Hq, int Hkv, int D,
    int NB, int block_size, int n_blk, int keys_per_split, int splits,
    int64_t kv_stride_tok, int64_t kv_stride_head, int64_t sc_stride_tok,
    int q_dtype, int kv_dtype, void* stream) {
  using namespace paged;
  if (NB <= 0 || block_size <= 0 || n_blk <= 0 ||
      static_cast<int64_t>(NB) * block_size > (1 << 30))
    return -1;
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return -1;
  const PoolView pv{tables, NB, block_size, n_blk, kv_stride_tok,
                    kv_stride_head, sc_stride_tok};
  const DecodeArgs a{q, k_pool, v_pool, k_scale, v_scale, lengths, out,
                     ws_acc, ws_m, ws_l, nullptr, B, Hq, Hkv,
                     keys_per_split, splits};
  // the pages of one split must fit the kernel's table of them
  if (check_split_args(a, pv.span()) != 0 ||
      (keys_per_split + block_size - 1) / block_size + 1 > kMaxSplitPages)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_paged_decode_kv<float>(kv_dtype, D, a, pv, s);
  if (q_dtype == kBF16)
    return dispatch_paged_decode_kv<__nv_bfloat16>(kv_dtype, D, a, pv, s);
  return -1;
}
