// The FAST-9/16 (or FAST-12) segment test and score shared by K1
// (fast_brief_frontend.cu) and the staged detector's kernel
// (fast_cells.cu), so the two cannot drift apart.
//
// corner_score<STRIDE>(p, t, arc_len) scores the pixel at p in a
// shared-memory tile of row stride STRIDE: the 16 taps of the radius-3
// Bresenham ring (clockwise from 12 o'clock, detect.CIRCLE) are loads at
// immediate offsets from p; a tap is brighter than p + t or darker than
// p - t; a pixel is a corner where a cyclic run of >= arc_len taps is
// brighter or one is darker, and its score is the larger of the summed
// excesses max(v - (p + t), 0) and max((p - t) - v, 0), each summed in
// ring order from 0.0f (the plain versions' order); 0 elsewhere.  The
// masks are 16-bit, in registers.  Every operation is an explicitly
// rounded f32 add or subtract, so no build flag can contract them.

#pragma once

#include <utility>

namespace fast {

// Bresenham circle of radius 3, clockwise from 12 o'clock: {row, col}.
constexpr int kRing[16][2] = {{-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}, {0, 3}, {1, 3},
                              {2, 2}, {3, 1}, {3, 0}, {3, -1}, {2, -2}, {1, -3},
                              {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}};

template <int STRIDE>
__host__ __device__ constexpr int ring_offset(int k) {
  return kRing[k][0] * STRIDE + kRing[k][1];
}

template <int STRIDE, int K>
__device__ __forceinline__ float ring_tap(const float* p) {
  constexpr int o = ring_offset<STRIDE>(K);
  return p[o];
}

template <int STRIDE, int... K>
__device__ __forceinline__ void load_ring(const float* p, float (&v)[16],
                                          std::integer_sequence<int, K...>) {
  ((v[K] = ring_tap<STRIDE, K>(p)), ...);
}

// A cyclic run of >= arc_len set bits in the 16-bit ring mask m.
__device__ __forceinline__ bool has_arc(unsigned m, int arc_len) {
  const unsigned M = m | (m << 16);
  unsigned a = M & (M >> 1);
  a &= a >> 2;
  a &= a >> 4;  // runs >= 8 starting at each bit
  if (arc_len == 9) {
    a &= M >> 8;
  } else {  // FAST-12: bits i..i+7 and a run of 4 at i+8
    unsigned a4 = M & (M >> 1);
    a4 &= a4 >> 2;
    a &= a4 >> 8;
  }
  return (a & 0xFFFFu) != 0u;
}

// The FAST score of the pixel at p (tile row stride STRIDE) at threshold t.
template <int STRIDE>
__device__ __forceinline__ float corner_score(const float* p, float t, int arc_len) {
  float v[16];
  load_ring<STRIDE>(p, v, std::make_integer_sequence<int, 16>{});
  const float center = p[0];
  const float hi = __fadd_rn(center, t);
  const float lo = __fsub_rn(center, t);
  unsigned mb = 0u, md = 0u;
  float be = 0.0f, de = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    mb |= static_cast<unsigned>(v[kk] > hi) << kk;
    md |= static_cast<unsigned>(v[kk] < lo) << kk;
    be = __fadd_rn(be, fmaxf(__fsub_rn(v[kk], hi), 0.0f));
    de = __fadd_rn(de, fmaxf(__fsub_rn(lo, v[kk]), 0.0f));
  }
  const bool corner = has_arc(mb, arc_len) || has_arc(md, arc_len);
  return corner ? fmaxf(be, de) : 0.0f;
}

}  // namespace fast
