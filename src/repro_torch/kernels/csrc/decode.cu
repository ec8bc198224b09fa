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
// are capped at S.  Bound and design notes: decode_kernel.cuh.

#include "decode_kernel.cuh"

namespace paged {

template <typename QT, typename KT>
int dispatch_dense_decode_d(int D, const void* q, const void* k,
                            const void* v, const int* lengths, void* out,
                            const DenseView& view, int B, int Hq, int Hkv,
                            cudaStream_t stream) {
  if (D == 64)
    return launch_decode<QT, KT, 64>(q, k, v, nullptr, nullptr, lengths, out,
                                     view, B, Hq, Hkv, stream);
  if (D == 112)
    return launch_decode<QT, KT, 112>(q, k, v, nullptr, nullptr, lengths,
                                      out, view, B, Hq, Hkv, stream);
  if (D == 128)
    return launch_decode<QT, KT, 128>(q, k, v, nullptr, nullptr, lengths,
                                      out, view, B, Hq, Hkv, stream);
  return -1;
}

template <typename QT>
int dispatch_dense_decode_kv(int kv_dtype, int D, const void* q,
                             const void* k, const void* v, const int* lengths,
                             void* out, const DenseView& view, int B, int Hq,
                             int Hkv, cudaStream_t stream) {
  if (kv_dtype == kF32)
    return dispatch_dense_decode_d<QT, float>(D, q, k, v, lengths, out, view,
                                              B, Hq, Hkv, stream);
  if (kv_dtype == kBF16)
    return dispatch_dense_decode_d<QT, __nv_bfloat16>(
        D, q, k, v, lengths, out, view, B, Hq, Hkv, stream);
  return -1;
}

}  // namespace paged

// Returns the CUDA error of the launch (0 = launched), or -1 for a shape
// or type this kernel does not take.  Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int dense_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, int B, int Hq, int Hkv, int D, int S, int64_t stride_b,
    int64_t stride_tok, int64_t stride_head, int q_dtype, int kv_dtype,
    void* stream) {
  using namespace paged;
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 ||
      Hq / Hkv > kMaxGroup || S <= 0)
    return -1;
  const DenseView view{stride_b, stride_tok, stride_head, S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_dense_decode_kv<float>(kv_dtype, D, q, k, v, lengths, out,
                                           view, B, Hq, Hkv, s);
  if (q_dtype == kBF16)
    return dispatch_dense_decode_kv<__nv_bfloat16>(kv_dtype, D, q, k, v,
                                                   lengths, out, view, B, Hq,
                                                   Hkv, s);
  return -1;
}
