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
// What bounds it on the card.  Per stereo pair at 376 x 1241 the kernel
// must move 37.8 MB (3.7 MB in, 34.1 MB out: 11.3 us at 3.35 TB/s), but
// its BRIEF core reads 281 distinct taps per pixel from shared memory:
// 933,232 px x 281 loads at one 32-lane load per SM and clock is ~31 us,
// so the shared-load rate, not HBM, sets its floor.  The design works
// toward that floor:
//  * Taps as immediates: the 256 compares come from brief_core.cuh with
//    the pattern as compile-time constants, each distinct tap loaded once
//    per pixel; the FAST ring's offsets are constants too (fast_core.cuh,
//    shared with the staged detector's kernel, fast_cells.cu).
//  * Occupancy: a block makes 32 x 64 output pixels (two 16-row bins) from
//    a 64 x 96 raw tile.  The blurred tile aliases the raw tile (dead once
//    FAST and the row sums are done) and the band scores alias the row
//    sums, so a block holds 55.4 KB of shared memory, and 4 blocks of 256
//    threads (32 warps) fit on an SM at <= 64 registers a thread.  The
//    2 x 12 x 20 = 480 blocks of a pair then run in one wave on 132 SMs.
//  * Staging by cp.async, 4-byte copies with src-size 0 for the zero halo
//    (a TMA tensor map needs 16-byte row strides; a 1241-float row is
//    4,964 bytes).  The blocks of the one wave all stage at once, so a
//    persistent, double-buffered walk would hide only that first load
//    (~2 us of a ~60 us kernel) at the cost of a second raw tile and a
//    block per SM: it is not done.
//  * A warp writes 32 consecutive columns of one word plane: coalesced.
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

#include "brief_core.cuh"
#include "fast_core.cuh"

namespace {

constexpr int BAND = 16;                // rows of one bin band
constexpr int ROWS = 2 * BAND;          // output rows per block
constexpr int TILE = 64;                // output columns per block
constexpr int R = 13;                   // BRIEF pattern radius
constexpr int PAD = 16;                 // halo: R + blur radius + 1 (NMS)
constexpr int RAW_H = ROWS + 2 * PAD;   // raw rows [-16, 48) of the block
constexpr int RAW_W = TILE + 2 * PAD;   // raw cols [-16, 80)
constexpr int SM_H = ROWS + 2 * R;      // blurred rows [-13, 45)
constexpr int SM_W = TILE + 2 * R;      // blurred cols [-13, 77)
constexpr int RS_W = SM_W + 4;          // row-summed cols [-15, 79)
constexpr int SC_H = ROWS + 2;          // FAST score rows [-1, 33)
constexpr int SC_W = TILE + 2;          // FAST score cols [-1, 65)
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;           // per SM: 32 warps
constexpr size_t SMEM_BYTES = sizeof(float) * (RAW_H * RAW_W + SM_H * RS_W + SC_H * SC_W);

static_assert(SM_H * SM_W <= RAW_H * RAW_W, "the blurred tile aliases the raw tile");
static_assert(ROWS * TILE <= SM_H * RS_W, "the band scores alias the row sums");
static_assert(ROWS * TILE % THREADS == 0 && TILE % 32 == 0, "whole warps per row");

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fast_brief_tile_kernel(const float* __restrict__ img,   // (B, H, W)
                       const float* __restrict__ thr,   // scalar
                       int H, int W, int Wo, int n_bands, int arc_len,
                       int border, int bin_size,
                       int* __restrict__ planes,        // (B, 8, H, W)
                       float* __restrict__ score,       // (B, H, W)
                       float* __restrict__ rowmax,      // (B, n_bands, Wo)
                       int* __restrict__ rowarg) {      // (B, n_bands, Wo)
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                     // (RAW_H, RAW_W) raw tile, then
  float* sm = smem;                      // (SM_H, SM_W) the blurred tile
  float* rs = smem + RAW_H * RAW_W;      // (SM_H, RS_W) row sums, then
  float* band_nms = rs;                  // (ROWS, TILE) masked NMS scores
  float* sc = rs + SM_H * RS_W;          // (SC_H, SC_W) FAST scores

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * ROWS;
  const int c0 = blockIdx.x * TILE;
  const float* im = img + static_cast<size_t>(b) * H * W;
  const int tid = threadIdx.x;

  brief::stage_tile<RAW_H, RAW_W, THREADS>(raw, im, H, W, r0 - PAD, c0 - PAD);
  const float t = *thr;
  __pipeline_wait_prior(0);
  __syncthreads();

  // FAST segment test + score on the raw image, rows -1..32, cols -1..64.
  for (int k = tid; k < SC_H * SC_W; k += THREADS) {
    const int i = k / SC_W, j = k - i * SC_W;
    sc[k] = fast::corner_score<RAW_W>(raw + (i + PAD - 1) * RAW_W + (j + PAD - 1), t, arc_len);
  }
  // Box blur, rows: rs[i][j] = sum_{d=0..4} raw(r-2+d, c), ascending.
  for (int k = tid; k < SM_H * RS_W; k += THREADS) {
    const int i = k / RS_W, j = k - i * RS_W;
    const float* p = raw + (i + 1) * RAW_W + (j + 1);
    float a = p[0];
#pragma unroll
    for (int d = 1; d < 5; ++d) a = __fadd_rn(a, p[d * RAW_W]);
    rs[k] = a;
  }
  __syncthreads();

  // Box blur, columns: 0.2f * sum_{d=0..4} (0.2f * rs[i][j+d]), ascending,
  // in the contracted form the JAX reference computes:
  // s = fma(A0, .2f, A1 * .2f), then s = fma(Ad, .2f, s) for d = 2..4.
  // Written over the raw tile, which nothing reads any more.
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
#pragma unroll 1  // one pixel's loads per iteration (counted from SASS)
  for (int p = tid; p < ROWS * TILE; p += THREADS) {
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
      unsigned w[8];
      brief::brief_words<0, SM_W>(sm + (i + R) * SM_W + (j + R), w);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        planes[((static_cast<size_t>(b) * 8 + k) * H + r) * W + c] = static_cast<int>(w[k]);
    }
  }
  __syncthreads();

  // Per-column (max, first row reaching it) over each of the two bands.
  if (tid < (ROWS / BAND) * TILE) {
    const int half = tid / TILE, j = tid - half * TILE;
    const int band = blockIdx.y * (ROWS / BAND) + half;
    if (band < n_bands) {
      const float* col = band_nms + half * BAND * TILE + j;
      float m = col[0];
      for (int i = 1; i < BAND; ++i) m = fmaxf(m, col[i * TILE]);
      int arg = BAND;
      for (int i = 0; i < BAND; ++i) {
        if (col[i * TILE] >= m) {
          arg = i;
          break;
        }
      }
      const size_t o = (static_cast<size_t>(b) * n_bands + band) * Wo + c0 + j;
      rowmax[o] = m;
      rowarg[o] = arg;
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Selects `device` and sets the kernel's shared-memory attributes, once
// per device.
cudaError_t configure(int device) {
  static bool done[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || done[device]) return err;
  err = cudaFuncSetAttribute(fast_brief_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fast_brief_tile_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  done[device] = err == cudaSuccess;
  return err;
}

}  // namespace

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers; the kernel allocates nothing.
extern "C" int fast_brief_frontend_launch(
    const float* img, const float* thr, int B, int H, int W, int arc_len,
    int border, int bin_size, int* planes, float* score, float* rowmax,
    int* rowarg, void* stream, int device) {
  cudaError_t err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Wo = (W + 127) / 128 * 128;  // the band reduction's width
  const int n_bands = (H + BAND - 1) / BAND;
  const dim3 grid(Wo / TILE, (H + ROWS - 1) / ROWS, B);
  fast_brief_tile_kernel<<<grid, THREADS, SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(
      img, thr, H, W, Wo, n_bands, arc_len, border, bin_size, planes, score,
      rowmax, rowarg);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K1 resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// into *blocks; returns the cudaError_t (0 = ok).
extern "C" int fast_brief_frontend_occupancy(int* blocks, int device) {
  cudaError_t err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fast_brief_tile_kernel, THREADS, SMEM_BYTES));
}
