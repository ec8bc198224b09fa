// Paged chunked-prefill flash attention with per-row chunk geometry, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel paged_prefill_attention_kernel
// (src/repro/kernels/chunked_prefill_attention/paged_prefill.py): every
// batch row brings its own `start` (absolute offset of its chunk) and
// `valid` (tokens really present in the padded chunk), so one launch runs
// a whole mixed batch: prefill chunks of unequal length, decode rows
// (valid == 1) and padding rows (valid == 0).  The kernel body is
// prefill_kernel.cuh's, read through a PoolView that dereferences the
// block table (clamped; a 64-key tile spans four 16-token pages, each
// key's entry read once a tile) into the flat [P, Hkv, D] pool the model
// holds.  A bf16 query over a bf16 or int8 pool takes the tensor-core body
// (mma.sync, cp.async tile ring in the storage type, int8 widened exactly
// to bf16 with its scales applied to the score and to P), float32 on
// either side the f32 FMA body.  Bound and design notes:
// prefill_kernel.cuh.

#include "prefill_kernel.cuh"

namespace paged {

template <typename QT, typename KT>
int dispatch_paged_prefill_d(int D, const void* q, const void* k_pool,
                             const void* v_pool, const float* k_scale,
                             const float* v_scale, const int* start,
                             const int* valid, void* out, const PoolView& pv,
                             int B, int Tq, int Hq, int Hkv,
                             cudaStream_t stream) {
  if (D == 64)
    return launch_prefill<QT, KT, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                      start, 1, valid, out, pv, B, Tq, Hq,
                                      Hkv, stream);
  if (D == 128)
    return launch_prefill<QT, KT, 128>(q, k_pool, v_pool, k_scale, v_scale,
                                       start, 1, valid, out, pv, B, Tq, Hq,
                                       Hkv, stream);
  return -1;
}

template <typename QT>
int dispatch_paged_prefill_kv(int kv_dtype, int D, const void* q,
                              const void* k_pool, const void* v_pool,
                              const float* k_scale, const float* v_scale,
                              const int* start, const int* valid, void* out,
                              const PoolView& pv, int B, int Tq, int Hq,
                              int Hkv, cudaStream_t stream) {
  if (kv_dtype == kF32)
    return dispatch_paged_prefill_d<QT, float>(D, q, k_pool, v_pool, k_scale,
                                               v_scale, start, valid, out, pv,
                                               B, Tq, Hq, Hkv, stream);
  if (kv_dtype == kBF16)
    return dispatch_paged_prefill_d<QT, __nv_bfloat16>(
        D, q, k_pool, v_pool, k_scale, v_scale, start, valid, out, pv, B, Tq,
        Hq, Hkv, stream);
  if (kv_dtype == kI8)
    return dispatch_paged_prefill_d<QT, int8_t>(D, q, k_pool, v_pool, k_scale,
                                                v_scale, start, valid, out, pv,
                                                B, Tq, Hq, Hkv, stream);
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
    return dispatch_paged_prefill_kv<float>(kv_dtype, D, q, k_pool, v_pool,
                                            k_scale, v_scale, start, valid,
                                            out, pv, B, Tq, Hq, Hkv, s);
  if (q_dtype == kBF16)
    return dispatch_paged_prefill_kv<__nv_bfloat16>(
        kv_dtype, D, q, k_pool, v_pool, k_scale, v_scale, start, valid, out,
        pv, B, Tq, Hq, Hkv, s);
  return -1;
}
