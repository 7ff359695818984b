// The staged front end's FAST detector for Hopper (sm_90a): for every
// image of a (B, H, W) f32 stack at one pyramid level, the FAST-9/16 (or
// FAST-12) score, 3x3 non-maximum suppression, the border mask and the
// per-cell (max, first index) over a bin_size grid, in one launch.
//
// It replaces no TPU kernel: the JAX package computes this detector in
// XLA (vslam_tpu/frontend/detect.py: fast_score_map, nms3 and the binning
// half of keypoints_from_score).  Its plain-torch version, which that
// JAX code is held to bit for bit on the CPU, is
// vslam_tpu_torch/frontend/detect.py::fast_cells_reference; the two agree
// bit for bit on every cell.  What it gives, per image b and cell
// (cy, cx) of the (H / bin) x (W / bin) grid, row-major:
//   cell_score = the largest masked score in the cell,
//   cell_best  = the first index (row-major in the cell: lowest row, then
//                lowest column) holding it,
// where a pixel's masked score is its FAST score where that is >= every
// score of its 3x3 window clipped to the image (max_pool2d's -inf
// padding; scores are >= 0, so a score of 0 outside the image is the
// same), else 0, and 0 within `border` pixels of the image's edge.  The
// FAST taps read 0 outside the image.  This is not K1's zero-halo FAST:
// pixels outside the image have no score here.
//
// What bounds it on the card: the f32 operations, 136 a pixel (16 taps x
// 8 and NMS's 8 compares), 1.9 us for a 2 x 376 x 1241 stack at 67
// TFLOP/s; the bytes are 4 a pixel read and 8 a cell written (1.1 us).
// Design:
//  * A block owns a strip of whole cells of one cell row of one image, up
//    to STRIP columns wide (8 cells at bin 16).  It stages the strip and
//    a HALO-pixel frame (3 for the ring, 1 for NMS) by 4-byte cp.async
//    with zero-fill (as brief_core.cuh's stage_tile, at run-time sizes: a
//    1241-float row is not 16-byte aligned), computes FAST over the strip
//    plus a 1-pixel ring into shared memory, and reduces each cell in one
//    warp: NMS, the mask and the lane's (max, first index) on the fly,
//    then warp shuffles.  One lane writes the cell's 8 bytes; no (H, W)
//    map reaches device memory, and no atomics are used, so the result is
//    the same on every run.
//  * The tiles' row strides are compile-time constants, so the 16 ring
//    taps and the 9 NMS reads are immediate offsets; the score rows are
//    SC_W = 144 floats apart (16 banks), so the two 16-column rows of a
//    16-pixel cell that a warp reads at once hit distinct banks.
//  * The FAST arithmetic is fast_core.cuh, shared with K1.
// Built with -fmad=false like K1; every f32 operation is explicitly
// rounded anyway.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "fast_core.cuh"

namespace {

constexpr int HALO = 4;                   // ring radius 3 + 1 for NMS
constexpr int STRIP = 128;                // widest strip of cells a block owns
constexpr int RAW_W = STRIP + 2 * HALO;   // staged columns [-4, 132)
constexpr int SC_W = 144;                 // FAST score row stride (>= STRIP + 2)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 4;             // per SM: <= 64 registers a thread
constexpr int MAX_BIN = 128;

static_assert(SC_W >= STRIP + 2, "a score row holds the strip and its 1-pixel ring");

__host__ __device__ constexpr size_t smem_bytes(int bin) {
  return sizeof(float) * (static_cast<size_t>(bin + 2 * HALO) * RAW_W
                          + static_cast<size_t>(bin + 2) * SC_W);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fast_cells_kernel(const float* __restrict__ img,   // (B, H, W)
                  const float* __restrict__ thr,   // scalar
                  int H, int W, int nr, int nc, int cells_x, int bin,
                  int arc_len, int border,
                  float* __restrict__ cell_score,  // (B, nr * nc)
                  int* __restrict__ cell_best) {   // (B, nr * nc)
  extern __shared__ __align__(16) float smem[];
  const int raw_h = bin + 2 * HALO;
  float* raw = smem;                 // (raw_h, RAW_W) rows r0-4.., cols c0-4..
  float* sc = smem + raw_h * RAW_W;  // (bin + 2, SC_W) rows r0-1.., cols c0-1..

  const int b = blockIdx.z;
  const int cy = blockIdx.y;
  const int cx0 = blockIdx.x * cells_x;
  const int ncells = min(cells_x, nc - cx0);
  const int r0 = cy * bin, c0 = cx0 * bin;
  const int width = ncells * bin;
  const float* im = img + static_cast<size_t>(b) * H * W;
  const int tid = threadIdx.x;

  // Stage rows [r0 - 4, r0 + bin + 4), columns [c0 - 4, c0 + width + 4).
  const int sw = width + 2 * HALO;
  for (int k = tid; k < raw_h * sw; k += THREADS) {
    const int i = k / sw, j = k - i * sw;
    const int r = r0 - HALO + i, c = c0 - HALO + j;
    const bool inside = r >= 0 && r < H && c >= 0 && c < W;
    const float* src = inside ? im + static_cast<size_t>(r) * W + c : im;
    __pipeline_memcpy_async(raw + i * RAW_W + j, src, 4, inside ? 0 : 4);
  }
  __pipeline_commit();
  const float t = *thr;
  __pipeline_wait_prior(0);
  __syncthreads();

  // FAST over rows r0-1 .. r0+bin, columns c0-1 .. c0+width; 0 outside
  // the image.
  const int fw = width + 2;
  for (int k = tid; k < (bin + 2) * fw; k += THREADS) {
    const int i = k / fw, j = k - i * fw;
    const int r = r0 - 1 + i, c = c0 - 1 + j;
    float s = 0.0f;
    if (r >= 0 && r < H && c >= 0 && c < W)
      s = fast::corner_score<RAW_W>(raw + (i + HALO - 1) * RAW_W + (j + HALO - 1), t, arc_len);
    sc[i * SC_W + j] = s;
  }
  __syncthreads();

  // One warp a cell: NMS, the border mask, (max, first index).
  const int warp = tid >> 5, lane = tid & 31;
  const int n = bin * bin;
  const int r_lo = border, r_hi = H - border, c_lo = border, c_hi = W - border;
  for (int q = warp; q < ncells; q += WARPS) {
    float best = -1.0f;  // below every score: a lane's first pixel replaces it
    int arg = n;
    for (int idx = lane; idx < n; idx += 32) {
      const int i = idx / bin, j = idx - i * bin;
      const int x = q * bin + j;
      const float* s = sc + i * SC_W + x;  // the window's top-left
      float neigh = s[0];
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) neigh = fmaxf(neigh, s[di * SC_W + dj]);
      const float mid = s[SC_W + 1];
      const int r = r0 + i, c = c0 + x;
      const bool inside = r >= r_lo && r < r_hi && c >= c_lo && c < c_hi;
      const float v = inside && mid >= neigh ? mid : 0.0f;
      if (v > best) {  // ascending idx: the first of equals stays
        best = v;
        arg = idx;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oa = __shfl_down_sync(0xffffffffu, arg, off);
      if (ov > best || (ov == best && oa < arg)) {
        best = ov;
        arg = oa;
      }
    }
    if (lane == 0) {
      const size_t o = (static_cast<size_t>(b) * nr + cy) * nc + cx0 + q;
      cell_score[o] = best;
      cell_best[o] = arg;
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Selects `device` and lets the kernel take the shared memory of the
// largest bin, once per device.
cudaError_t configure(int device) {
  static bool done[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || done[device]) return err;
  err = cudaFuncSetAttribute(fast_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(MAX_BIN)));
  done[device] = err == cudaSuccess;
  return err;
}

int cells_per_block(int bin) { return bin < STRIP ? STRIP / bin : 1; }

}  // namespace

// Launches the kernel on `stream` over a (B, H, W) stack with bin sizes
// 1..128; returns the cudaError_t of the launch (0 = ok).  All pointers
// are device pointers; the kernel allocates nothing.  With no cell
// (H < bin or W < bin) nothing is launched.
extern "C" int fast_cells_launch(const float* img, const float* thr, int B, int H, int W,
                                 int arc_len, int border, int bin, float* cell_score,
                                 int* cell_best, void* stream, int device) {
  if (bin < 1 || bin > MAX_BIN || (arc_len != 9 && arc_len != 12))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nr = H / bin, nc = W / bin;
  if (B == 0 || nr == 0 || nc == 0) return 0;
  const int cells_x = cells_per_block(bin);
  const dim3 grid((nc + cells_x - 1) / cells_x, nr, B);
  fast_cells_kernel<<<grid, THREADS, smem_bytes(bin), static_cast<cudaStream_t>(stream)>>>(
      img, thr, H, W, nr, nc, cells_x, bin, arc_len, border, cell_score, cell_best);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel resident on one SM at bin size `bin`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks; returns
// the cudaError_t (0 = ok).
extern "C" int fast_cells_occupancy(int bin, int* blocks, int device) {
  if (bin < 1 || bin > MAX_BIN) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fast_cells_kernel, THREADS, smem_bytes(bin)));
}
