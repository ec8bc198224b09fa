// Shared pieces of the attention kernels: element loads that widen to
// float, the two ways keys are addressed (a paged pool through block
// tables, a dense per-row cache through strides), and the tile loader that
// brings KV rows into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

// Finite stand-in for -inf: exp(m_prev - m_new) on a fully masked first
// tile is then exp(0) = 1 times a zero sum, never NaN.
constexpr float kNegInf = -1e30f;
constexpr float kMinDenominator = 1e-30f;

// dtype codes of the C interface
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

// ---- 4 consecutive elements -> 4 floats (16 / 8 / 4 byte loads) --------
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  // a bf16 is the high half of an f32
  out[0] = __uint_as_float(raw.x << 16);
  out[1] = __uint_as_float(raw.x & 0xffff0000u);
  out[2] = __uint_as_float(raw.y << 16);
  out[3] = __uint_as_float(raw.y & 0xffff0000u);
}

__device__ __forceinline__ void load4(const int8_t* p, float out[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  out[0] = static_cast<float>(v.x); out[1] = static_cast<float>(v.y);
  out[2] = static_cast<float>(v.z); out[3] = static_cast<float>(v.w);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A view turns (batch row b, logical position pos) into a token handle,
// and a (token, KV head) into element offsets of the KV and scale tensors.
// limit() caps a row's key count at what the storage holds.

// Paged pool [P, Hkv, D] addressed through [B, NB] block tables.
struct PoolView {
  const int* tables;     // [B, NB] logical block -> physical block (-1 none)
  int NB;                // table width
  int block_size;        // tokens per page
  int n_blk;             // physical pages in the pool
  long stride_tok;       // elements between tokens of the KV pool
  long stride_head;      // elements between KV heads of one token
  long sc_stride_tok;    // elements between tokens of the scale pool

  __device__ __forceinline__ int limit(int len) const { return len; }

  // Physical token row of logical position `pos` of batch row `b`.
  // Entries below 0 (unallocated) and past the pool are clamped into
  // range: every such key is masked by the caller before it contributes.
  __device__ __forceinline__ long token(int b, int pos) const {
    int page = pos / block_size;
    page = page < NB ? page : NB - 1;
    int blk = tables[static_cast<long>(b) * NB + page];
    blk = blk < 0 ? 0 : (blk >= n_blk ? n_blk - 1 : blk);
    return static_cast<long>(blk) * block_size + pos % block_size;
  }
  __device__ __forceinline__ long kv_offset(long tok, int h) const {
    return tok * stride_tok + h * stride_head;
  }
  __device__ __forceinline__ long scale_offset(long tok, int h) const {
    return tok * sc_stride_tok + h;
  }

  // The decode kernel's split-wise addressing: the table entries of the
  // pages that keys [lo, hi) span are read once, clamped as token() clamps
  // them, into pages[] (shared memory); token_at() then needs no global
  // load.  Positions past the table (NB * block_size) are never attended.
  __host__ __device__ __forceinline__ int span() const {
    return NB * block_size;
  }
  __device__ __forceinline__ int first_page(int lo) const {
    return lo / block_size;
  }
  __device__ __forceinline__ void stage_pages(int b, int lo, int hi,
                                              int* pages, int tid,
                                              int nt) const {
    if (hi <= lo) return;
    const int p0 = lo / block_size;
    const int p1 = (hi - 1) / block_size + 1;
    for (int p = p0 + tid; p < p1; p += nt) {
      int blk = tables[static_cast<long>(b) * NB + (p < NB ? p : NB - 1)];
      pages[p - p0] = blk < 0 ? 0 : (blk >= n_blk ? n_blk - 1 : blk);
    }
  }
  __device__ __forceinline__ long token_at(const int* pages, int p0, int,
                                           int pos) const {
    return static_cast<long>(pages[pos / block_size - p0]) * block_size +
           pos % block_size;
  }
};

// Dense per-row cache [B, S, Hkv, D], read in place through its strides
// (a layer's view of the model's cache, or one slot of it).
struct DenseView {
  long stride_b;         // elements between batch rows
  long stride_tok;       // elements between positions of a row
  long stride_head;      // elements between KV heads of one position
  int S;                 // positions a row holds

  __device__ __forceinline__ int limit(int len) const {
    return len < S ? len : S;
  }
  __device__ __forceinline__ long token(int b, int pos) const {
    return static_cast<long>(b) * stride_b + static_cast<long>(pos) * stride_tok;
  }
  __device__ __forceinline__ long kv_offset(long tok, int h) const {
    return tok + h * stride_head;
  }
  __device__ __forceinline__ long scale_offset(long, int) const { return 0; }

  // the decode kernel's split-wise addressing (PoolView's): no pages
  __host__ __device__ __forceinline__ int span() const { return S; }
  __device__ __forceinline__ int first_page(int) const { return 0; }
  __device__ __forceinline__ void stage_pages(int, int, int, int*, int,
                                              int) const {}
  __device__ __forceinline__ long token_at(const int*, int, int b,
                                           int pos) const {
    return token(b, pos);
  }
};

// Load keys [kv0, kv0 + TK) of (row b, KV head h) into dst[TK][DP] as
// floats, dequantised where a scale tensor is given.  Keys at or past
// kv_hi are zero-filled so that a masked probability of 0 never meets a
// NaN.
template <typename KT, int D, int DP, int TK, int NT, typename View>
__device__ __forceinline__ void load_kv_tile(
    float* dst, const KT* kv, const float* scale, const View& view, int b,
    int h, int kv0, int kv_hi, int tid) {
  constexpr int kChunks = D / 4;               // 4-element chunks per key
  for (int c = tid; c < TK * kChunks; c += NT) {
    const int j = c / kChunks;
    const int d = (c % kChunks) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    const int pos = kv0 + j;
    if (pos < kv_hi) {
      const long tok = view.token(b, pos);
      load4(kv + view.kv_offset(tok, h) + d, v);
      if (scale != nullptr) {
        const float s = scale[view.scale_offset(tok, h)];
        v[0] *= s; v[1] *= s; v[2] *= s; v[3] *= s;
      }
    }
    *reinterpret_cast<float4*>(dst + j * DP + d) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace paged
