// Fused stereo front-end kernel K1 for Hopper (sm_90a): 5x5 box blur +
// dense BRIEF-256 bit planes + FAST-9/16 (or FAST-12) corner score +
// 3x3 non-maximum suppression + the per-column band reduction that feeds
// the keypoint binning tail, in one pass over the image.
//
// Replaces the TPU kernel
//   vslam_tpu/frontend/pallas_frontend.py::fast_brief_frontend_pair
// (kernel body _make_kernel).  Its plain-torch version, with the same
// zero-halo semantics and the same order of every float sum, is
// vslam_tpu_torch/frontend/fast_brief.py::fast_brief_frontend_pair_reference;
// the two agree bit for bit over the whole image.
//
// What bounds it on the card: per stereo pair ~2 x 376 x 1280 pixels x
// (512 BRIEF taps + 16 FAST ring taps + 25 blur adds) ~ 0.5 G shared-memory
// reads and ~20 MB of output — tiny against the card's rate, so the kernel
// is bound by launch latency and by its own occupancy, not by bytes or
// FLOPs.  The design therefore stages one band-plus-halo tile in shared
// memory once and does every tap from there (a block per image x 16-row
// band x 128-column tile); it does not yet pipeline loads or pack several
// bands per block.
//
// Bit-exactness: the file is built with -fmad=false, so the compiler
// contracts nothing; the one fused multiply-add chain is explicit.  The
// blur's rows are summed in ascending order; its columns follow the JAX
// reference as XLA computes it, which contracts "sum of (0.2f * A),
// ascending" into fma(A0, .2f, A1 * .2f) and then fma(Ad, .2f, s) — a
// sequential-f32 blur differs from that reference in about 13% of the
// blurred pixels of a uint8 image, the chain in none.  The constant is
// 0.2f (never a division by 5), the FAST excess is max(v - hi, 0) summed
// in ring order, and NMS keeps mid >= 3x3 max.

#include <cuda_runtime.h>

namespace {

constexpr int BAND = 16;                // output rows per block (= bin size)
constexpr int TILE = 128;               // output columns per block
constexpr int R = 13;                   // BRIEF pattern radius
constexpr int PAD = 16;                 // halo: R + blur radius + 1 (NMS)
constexpr int RAW_H = BAND + 2 * PAD;   // raw rows [-16, 32) of the band
constexpr int RAW_W = TILE + 2 * PAD;   // raw cols [-16, 144) of the tile
constexpr int SM_H = BAND + 2 * R;      // blurred rows [-13, 29)
constexpr int SM_W = TILE + 2 * R;      // blurred cols [-13, 141)
constexpr int RS_W = SM_W + 4;          // row-summed cols [-15, 143)
constexpr int SC_H = BAND + 2;          // FAST score rows [-1, 17)
constexpr int SC_W = TILE + 2;          // FAST score cols [-1, 129)
constexpr int PAT_INTS = 256 * 4;       // [bit][dr1, dc1, dr2, dc2]
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES =
    sizeof(int) * PAT_INTS +
    sizeof(float) * (RAW_H * RAW_W + SM_H * RS_W + SM_H * SM_W + SC_H * SC_W);

static_assert(BAND * TILE <= SM_H * RS_W, "band buffer aliases the row sums");

// Bresenham circle of radius 3, clockwise from 12 o'clock (detect.CIRCLE).
__constant__ int kCircleR[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleC[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                 0, -1, -2, -3, -3, -3, -2, -1};

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

__global__ void __launch_bounds__(THREADS)
fast_brief_band_kernel(const float* __restrict__ img,   // (B, H, W)
                       const float* __restrict__ thr,   // scalar
                       const int* __restrict__ pat,     // (256, 4)
                       int H, int W, int Wo, int arc_len, int border,
                       int bin_size,
                       int* __restrict__ planes,        // (B, 8, H, W)
                       float* __restrict__ score,       // (B, H, W)
                       float* __restrict__ rowmax,      // (B, n_bands, Wo)
                       int* __restrict__ rowarg) {      // (B, n_bands, Wo)
  extern __shared__ float smem[];
  int* s_pat = reinterpret_cast<int*>(smem);
  float* raw = smem + PAT_INTS;
  float* rs = raw + RAW_H * RAW_W;
  float* sm = rs + SM_H * RS_W;
  float* sc = sm + SM_H * SM_W;
  float* band_nms = rs;  // reused once the blur no longer needs it

  const int b = blockIdx.z;
  const int band = blockIdx.y;
  const int n_bands = gridDim.y;
  const int r0 = band * BAND;
  const int c0 = blockIdx.x * TILE;
  const float* im = img + static_cast<size_t>(b) * H * W;
  const float t = *thr;
  const int tid = threadIdx.x;

  for (int k = tid; k < PAT_INTS; k += THREADS) s_pat[k] = pat[k];
  // Raw tile with its halo; zero outside the image.
  for (int k = tid; k < RAW_H * RAW_W; k += THREADS) {
    const int i = k / RAW_W, j = k - i * RAW_W;
    const int r = r0 - PAD + i, c = c0 - PAD + j;
    raw[k] = (r >= 0 && r < H && c >= 0 && c < W)
                 ? im[static_cast<size_t>(r) * W + c] : 0.0f;
  }
  __syncthreads();

  // Box blur, rows: rs[i][j] = sum_{d=0..4} raw(r-2+d, c), ascending.
  for (int k = tid; k < SM_H * RS_W; k += THREADS) {
    const int i = k / RS_W, j = k - i * RS_W;
    const float* p = raw + (i + 1) * RAW_W + (j + 1);
    float a = p[0];
#pragma unroll
    for (int d = 1; d < 5; ++d) a = __fadd_rn(a, p[d * RAW_W]);
    rs[k] = a;
  }
  // FAST segment test + score on the raw image, rows -1..16, cols -1..128.
  for (int k = tid; k < SC_H * SC_W; k += THREADS) {
    const int i = k / SC_W, j = k - i * SC_W;
    const float* p = raw + (i + PAD - 1) * RAW_W + (j + PAD - 1);
    const float center = p[0];
    const float hi = __fadd_rn(center, t);
    const float lo = __fsub_rn(center, t);
    unsigned mb = 0u, md = 0u;
    float be = 0.0f, de = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const float v = p[kCircleR[kk] * RAW_W + kCircleC[kk]];
      mb |= static_cast<unsigned>(v > hi) << kk;
      md |= static_cast<unsigned>(v < lo) << kk;
      be = __fadd_rn(be, fmaxf(__fsub_rn(v, hi), 0.0f));
      de = __fadd_rn(de, fmaxf(__fsub_rn(lo, v), 0.0f));
    }
    const bool corner = has_arc(mb, arc_len) || has_arc(md, arc_len);
    sc[k] = corner ? fmaxf(be, de) : 0.0f;
  }
  __syncthreads();

  // Box blur, columns: 0.2f * sum_{d=0..4} (0.2f * rs[i][j+d]), ascending,
  // in the contracted form the JAX reference computes:
  // s = fma(A0, .2f, A1 * .2f), then s = fma(Ad, .2f, s) for d = 2..4.
  for (int k = tid; k < SM_H * SM_W; k += THREADS) {
    const int i = k / SM_W, j = k - i * SM_W;
    const float* p = rs + i * RS_W + j;
    float s = __fmaf_rn(p[0], 0.2f, __fmul_rn(p[1], 0.2f));
#pragma unroll
    for (int d = 2; d < 5; ++d) s = __fmaf_rn(p[d], 0.2f, s);
    sm[k] = __fmul_rn(s, 0.2f);
  }
  __syncthreads();

  const int Hc = (H / bin_size) * bin_size;
  const int Wc = (W / bin_size) * bin_size;
  const int r_end = min(H - border, Hc);
  const int c_end = min(W - border, Wc);
  for (int p = tid; p < BAND * TILE; p += THREADS) {
    const int i = p / TILE, j = p - i * TILE;
    const int r = r0 + i, c = c0 + j;
    // 3x3 NMS: keep the score where it is >= its neighbourhood max.
    const float* s = sc + i * SC_W + j;
    float neigh = s[0];
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) neigh = fmaxf(neigh, s[di * SC_W + dj]);
    const float mid = s[SC_W + 1];
    const float nms = mid >= neigh ? mid : 0.0f;
    const bool inside = r >= border && r < r_end && c >= border && c < c_end;
    band_nms[p] = inside ? nms : 0.0f;
    if (r < H && c < W) {
      score[(static_cast<size_t>(b) * H + r) * W + c] = nms;
      const float* q = sm + (i + R) * SM_W + (j + R);
      for (int w = 0; w < 8; ++w) {
        unsigned acc = 0u;
#pragma unroll
        for (int jj = 0; jj < 32; ++jj) {
          const int* o = s_pat + 4 * (w * 32 + jj);
          const float a = q[o[0] * SM_W + o[1]];
          const float cmp = q[o[2] * SM_W + o[3]];
          acc |= static_cast<unsigned>(a < cmp) << jj;
        }
        planes[((static_cast<size_t>(b) * 8 + w) * H + r) * W + c] =
            static_cast<int>(acc);
      }
    }
  }
  __syncthreads();

  // Per-column (max, first row reaching it) over the band.
  if (tid < TILE) {
    float m = band_nms[tid];
    for (int i = 1; i < BAND; ++i) m = fmaxf(m, band_nms[i * TILE + tid]);
    int arg = BAND;
    for (int i = 0; i < BAND; ++i) {
      if (band_nms[i * TILE + tid] >= m) {
        arg = i;
        break;
      }
    }
    const size_t o = (static_cast<size_t>(b) * n_bands + band) * Wo + c0 + tid;
    rowmax[o] = m;
    rowarg[o] = arg;
  }
}

}  // namespace

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers; the kernel allocates nothing.
extern "C" int fast_brief_frontend_launch(
    const float* img, const float* thr, const int* pat, int B, int H, int W,
    int arc_len, int border, int bin_size, int* planes, float* score,
    float* rowmax, int* rowarg, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fast_brief_band_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Wo = (W + TILE - 1) / TILE * TILE;
  const int n_bands = (H + BAND - 1) / BAND;
  const dim3 grid(Wo / TILE, n_bands, B);
  fast_brief_band_kernel<<<grid, THREADS, SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      img, thr, pat, H, W, Wo, arc_len, border, bin_size, planes, score,
      rowmax, rowarg);
  return static_cast<int>(cudaGetLastError());
}
