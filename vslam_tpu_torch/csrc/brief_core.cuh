// The BRIEF-256 compare core and the tile staging shared by K1
// (fast_brief_frontend.cu) and the dense BRIEF kernel behind K2/K3/K4
// (dense_brief.cu), so the two cannot drift apart.
//
// brief_words<T, SW>(q, w) computes the 8 words of one pixel under
// pattern table T from a shared-memory tile of row stride SW, q pointing
// at the pixel.  The table and the stride are template parameters and the
// 256 compares are unrolled through a fold expression, so every tap is
// one shared load at an immediate offset from q: no pattern loads and no
// address arithmetic.  The compares run in the header's kBriefOrder, in
// which compares sharing a tap follow each other; the compiler loads
// each distinct tap once (281-291 loads per pixel instead of 512) and
// holds at most 11 at a time.  Nothing is stored between the compares
// of a pixel, so nothing stops the loads from being merged; the caller
// stores the 8 words after.
//
// The work is exact f32 compares, so tensor cores do not apply: a TF32
// or bf16 product would change bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include <utility>

#include "brief_patterns.cuh"

namespace brief {

__host__ __device__ constexpr int tap_offset(int table, int bit, int point, int stride) {
  return kBriefPattern[table][bit][2 * point] * stride + kBriefPattern[table][bit][2 * point + 1];
}

__host__ __device__ constexpr int order_at(int table, int k) { return kBriefOrder[table][k]; }

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The k-th compare of table T: bit b = kBriefOrder[T][k] of word b / 32.
template <int T, int SW, int K, typename V>
__device__ __forceinline__ void compare(const V* q, unsigned (&w)[8]) {
  constexpr int b = order_at(T, K);
  constexpr int o1 = tap_offset(T, b, 0, SW);
  constexpr int o2 = tap_offset(T, b, 1, SW);
  w[b >> 5] |= static_cast<unsigned>(as_f32(q[o1]) < as_f32(q[o2])) << (b & 31);
}

template <int T, int SW, typename V, int... K>
__device__ __forceinline__ void compares(const V* q, unsigned (&w)[8],
                                         std::integer_sequence<int, K...>) {
  (compare<T, SW, K>(q, w), ...);
}

// The 8 BRIEF words of the pixel at q under table T (tile row stride SW).
template <int T, int SW, typename V>
__device__ __forceinline__ void brief_words(const V* q, unsigned (&w)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = 0u;
  compares<T, SW>(q, w, std::make_integer_sequence<int, 256>{});
}

// Stages the ROWS x COLS window of an (H, W) image whose top-left pixel
// is (r0, c0) into `tile` (row stride COLS), reading 0 outside the image,
// and commits the copies as one group.  4-byte values go by cp.async
// (__pipeline_memcpy_async) with the out-of-image elements zero-filled
// (source size 0: nothing is read); rows of the image are not 16-byte
// aligned (a 1241-float row is 4,964 bytes), so the copies are 4-byte.
// 2-byte values (bf16) are copied through registers, as cp.async has no
// 2-byte form.
template <int ROWS, int COLS, int THREADS, typename V>
__device__ __forceinline__ void stage_tile(V* tile, const V* im, int H, int W, int r0, int c0) {
  for (int k = threadIdx.x; k < ROWS * COLS; k += THREADS) {
    const int i = k / COLS, j = k - i * COLS;
    const int r = r0 + i, c = c0 + j;
    const bool inside = r >= 0 && r < H && c >= 0 && c < W;
    const V* src = inside ? im + static_cast<size_t>(r) * W + c : im;
    if constexpr (sizeof(V) == 4) {
      __pipeline_memcpy_async(tile + k, src, 4, inside ? 0 : 4);
    } else {
      tile[k] = inside ? *src : V(0.0f);
    }
  }
  __pipeline_commit();
}

}  // namespace brief
