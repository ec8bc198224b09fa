// Dense chunked-prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel chunked_prefill_attention_kernel
// (src/repro/kernels/chunked_prefill_attention/chunked_attn.py, wrapper
// chunked_prefill_attention/ops.py::chunked_prefill_attention): every row
// of the batch holds a chunk of Tq tokens at the one offset `prefix`, and
// query token t sees key kpos of its row of the dense [B, S, Hkv, D] cache
// iff kpos <= prefix + t and kpos < prefix + Tq (the mask of
// chunked_attn.py).  The kernel body is prefill_kernel.cuh's, read through
// a DenseView: the cache is addressed in place through its strides (the
// Pallas wrapper transposes and pads it on every call), the KV walk stops
// at each query tile's causal frontier, and keys past S are never read.
// A bf16 query over a bf16 cache takes the tensor-core body (mma.sync,
// cp.async tile ring), float32 on either side the f32 FMA body.  `prefix`
// is read on the device, so the caller need not synchronise to learn it.
// Head dims 64, 112, 128 and 256 (gemma3-1b).  Given an `lse` pointer it
// also writes each query row's log-sum-exp, for a query and cache of one
// type: the form a rank of a slot-split cache runs on its piece, at the
// chunk's offset less the piece's first slot, before the ranks' partial
// results are combined by it.  Bound and design notes: prefill_kernel.cuh.

#include "prefill_kernel.cuh"

namespace paged {

template <typename QT, typename KT, bool kLse>
int dispatch_dense_prefill_d(int D, const void* q, const void* k,
                             const void* v, const int* prefix, void* out,
                             float* lse, const DenseView& view, int B, int Tq,
                             int Hq, int Hkv, cudaStream_t stream) {
  if (D == 64)
    return launch_prefill<QT, KT, 64, kLse>(q, k, v, nullptr, nullptr, prefix,
                                            0, nullptr, out, view, B, Tq, Hq,
                                            Hkv, stream, lse);
  if (D == 112)
    return launch_prefill<QT, KT, 112, kLse>(q, k, v, nullptr, nullptr,
                                             prefix, 0, nullptr, out, view, B,
                                             Tq, Hq, Hkv, stream, lse);
  if (D == 128)
    return launch_prefill<QT, KT, 128, kLse>(q, k, v, nullptr, nullptr,
                                             prefix, 0, nullptr, out, view, B,
                                             Tq, Hq, Hkv, stream, lse);
  if (D == 256)
    return launch_prefill<QT, KT, 256, kLse>(q, k, v, nullptr, nullptr,
                                             prefix, 0, nullptr, out, view, B,
                                             Tq, Hq, Hkv, stream, lse);
  return -1;
}

template <typename QT, typename KT>
int dispatch_dense_prefill_lse(int D, const void* q, const void* k,
                               const void* v, const int* prefix, void* out,
                               float* lse, const DenseView& view, int B,
                               int Tq, int Hq, int Hkv, cudaStream_t stream) {
  if (lse == nullptr)
    return dispatch_dense_prefill_d<QT, KT, false>(
        D, q, k, v, prefix, out, nullptr, view, B, Tq, Hq, Hkv, stream);
  // the log-sum-exp form is built for one type on both sides only
  if constexpr (std::is_same<QT, KT>::value)
    return dispatch_dense_prefill_d<QT, KT, true>(
        D, q, k, v, prefix, out, lse, view, B, Tq, Hq, Hkv, stream);
  return -1;
}

template <typename QT>
int dispatch_dense_prefill_kv(int kv_dtype, int D, const void* q,
                              const void* k, const void* v, const int* prefix,
                              void* out, float* lse, const DenseView& view,
                              int B, int Tq, int Hq, int Hkv,
                              cudaStream_t stream) {
  if (kv_dtype == kF32)
    return dispatch_dense_prefill_lse<QT, float>(D, q, k, v, prefix, out, lse,
                                                 view, B, Tq, Hq, Hkv, stream);
  if (kv_dtype == kBF16)
    return dispatch_dense_prefill_lse<QT, __nv_bfloat16>(
        D, q, k, v, prefix, out, lse, view, B, Tq, Hq, Hkv, stream);
  return -1;
}

}  // namespace paged

// Returns the CUDA error of the launch (0 = launched), or -1 for a shape
// or type this kernel does not take.  Launches on `stream`, does not
// synchronise, allocates nothing.  `prefix` points at one int32 on the
// device (negative, or past S, on a piece of a slot-split cache).  `lse`
// (f32 [B, Tq, Hq]) may be null: the serving form.
extern "C" int dense_chunked_prefill_attention(
    const void* q, const void* k, const void* v, const int* prefix, void* out,
    float* lse, int B, int Tq, int Hq, int Hkv, int D, int S, int64_t stride_b,
    int64_t stride_tok, int64_t stride_head, int q_dtype, int kv_dtype,
    void* stream) {
  using namespace paged;
  if (B <= 0 || B > 65535 || Tq <= 0 || Hkv <= 0 || Hkv > 65535 ||
      Hq % Hkv != 0 || Hq / Hkv > kPrefillRows || S <= 0)
    return -1;
  const DenseView view{stride_b, stride_tok, stride_head, S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_dense_prefill_kv<float>(kv_dtype, D, q, k, v, prefix, out,
                                            lse, view, B, Tq, Hq, Hkv, s);
  if (q_dtype == kBF16)
    return dispatch_dense_prefill_kv<__nv_bfloat16>(kv_dtype, D, q, k, v,
                                                    prefix, out, lse, view, B,
                                                    Tq, Hq, Hkv, s);
  return -1;
}
