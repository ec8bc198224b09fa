// Tensor-core and copy helpers shared by the attention bodies
// (decode_kernel.cuh, prefill_kernel.cuh): 16- and 4-byte cp.async with
// its commit / wait pair, ldmatrix, the m16n8k16 bf16 mma.sync with f32
// sums, and the packing of f32 pairs and int8 pairs into bf16x2 operands.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

// ---- cp.async (sm_80+): 16 bytes, or 4 for a scale; zero-filled when
// `valid` is false (nothing is read then) -----------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- tensor-core pieces (sm_80+ mma.sync, ldmatrix) -------------------------
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// x = hi + lo to 16 bits: hi the bf16 rounding of x, lo of the remainder
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}
// two int8 values -> bf16x2, exactly (8-bit integers fit bf16's mantissa)
__device__ __forceinline__ uint32_t pack_i8(int8_t lo, int8_t hi) {
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

// ---- a warp's 16 query rows as the A operand -------------------------------
// Up to D 128 the tensor-core bodies keep Q's A fragments of every k-step in
// registers (D / 4 of them a lane) for the whole walk.  Past D 128 those 64
// registers would sit beside the output accumulators (D / 2 a lane) and the
// scores, over what a thread holds, so a warp keeps its [16][D] bf16 rows in
// shared memory instead and reads one k-step's fragments at a time by
// ldmatrix (as FlashAttention-2 does at this width).
template <int D>
struct QRows {
  static constexpr bool kInSmem = D > 128;
  // 16 bytes past the row, an odd number of 16-byte units: the 8 rows of
  // one ldmatrix 8 x 8 hit 32 distinct banks
  static constexpr int kPitch = 2 * D + 16;
  static constexpr int kBytes = kInSmem ? 16 * kPitch : 0;   // a warp's
  static_assert(D % 16 == 0, "tiling");

  // lane (g, t) copies its rows g and g + 8 (row[i] null: zeros) into dst
  __device__ __forceinline__ static void fill(
      unsigned char* dst, const __nv_bfloat16* const row[2], int lane) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      for (int c = t; c < D / 8; c += 4)
        *reinterpret_cast<uint4*>(dst + (g + 8 * i) * kPitch + c * 16) =
            row[i] != nullptr
                ? *reinterpret_cast<const uint4*>(row[i] + c * 8)
                : make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }
  // k-step ks's fragments: rows g, g + 8 at columns 16 ks + 2t (+8)
  __device__ __forceinline__ static void frag(uint32_t a[4],
                                              const unsigned char* src, int ks,
                                              int lane) {
    const int mi = lane >> 3;
    ldsm_x4(a, src + ((lane & 7) + (mi & 1) * 8) * kPitch +
                   (ks * 16 + (mi >> 1) * 8) * 2);
  }
};

// The tensor-core product takes a bf16 query over a bf16 or int8 cache.
template <typename QT, typename KT>
constexpr bool uses_tensor_cores() {
  return std::is_same<QT, __nv_bfloat16>::value &&
         !std::is_same<KT, float>::value;
}

}  // namespace paged
