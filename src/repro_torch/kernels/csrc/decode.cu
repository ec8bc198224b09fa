// Dense GQA flash-decode for Hopper (sm_90a).
//
// Replaces the Pallas kernel decode_attention_kernel
// (src/repro/kernels/decode_attention/decode_attn.py, wrapper
// decode_attention/ops.py::decode_attention): one query token a row
// attends over the first lengths[b] keys of its row of a dense
// [B, S, Hkv, D] cache.  The kernel body is decode_kernel.cuh's, read
// through a DenseView: the cache is addressed in place through its
// strides, where the Pallas wrapper transposes it to [B, Hkv, S, D] on
// every call (381 MB a slot a layer at zamba2-7b's shape).  Lengths past S
// are capped at S.  Head dims 64, 112, 128 and 256 (gemma3-1b's global
// layers).  Bound and design notes: decode_kernel.cuh.

#include "decode_kernel.cuh"

namespace paged {

template <typename QT, typename KT>
int dispatch_dense_decode_d(int D, const DecodeArgs& a, const DenseView& view,
                            cudaStream_t stream) {
  if (D == 64) return launch_decode<QT, KT, 64>(a, view, stream);
  if (D == 112) return launch_decode<QT, KT, 112>(a, view, stream);
  if (D == 128) return launch_decode<QT, KT, 128>(a, view, stream);
  if (D == 256) return launch_decode<QT, KT, 256>(a, view, stream);
  return -1;
}

template <typename QT>
int dispatch_dense_decode_kv(int kv_dtype, int D, const DecodeArgs& a,
                             const DenseView& view, cudaStream_t stream) {
  if (kv_dtype == kF32)
    return dispatch_dense_decode_d<QT, float>(D, a, view, stream);
  if (kv_dtype == kBF16)
    return dispatch_dense_decode_d<QT, __nv_bfloat16>(D, a, view, stream);
  return -1;
}

}  // namespace paged

// Returns the CUDA error of the launches (0 = launched), or -1 for a shape
// or type this kernel does not take.  Launches on `stream`, does not
// synchronise, allocates nothing: the workspace (f32 [B, Hq, splits, D]
// partial sums, [B, Hq, splits] m and l) is the caller's, and may be null
// when splits == ceil(S / keys_per_split) is 1.
extern "C" int dense_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, float* ws_acc, float* ws_m, float* ws_l, int B, int Hq,
    int Hkv, int D, int S, int keys_per_split, int splits, int64_t stride_b,
    int64_t stride_tok, int64_t stride_head, int q_dtype, int kv_dtype,
    void* stream) {
  using namespace paged;
  const DenseView view{stride_b, stride_tok, stride_head, S};
  const DecodeArgs a{q, k, v, nullptr, nullptr, lengths, out, ws_acc, ws_m,
                     ws_l, B, Hq, Hkv, keys_per_split, splits};
  if (check_split_args(a, S) != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_dense_decode_kv<float>(kv_dtype, D, a, view, s);
  if (q_dtype == kBF16)
    return dispatch_dense_decode_kv<__nv_bfloat16>(kv_dtype, D, a, view, s);
  return -1;
}
