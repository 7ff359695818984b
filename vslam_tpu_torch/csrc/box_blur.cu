// The separable (2r+1)^2 box blur for Hopper (sm_90a): every image of a
// (B, H, W) f32 stack, edge-replicated and normalized, in one launch.
//
// It replaces no TPU kernel: the JAX package blurs in XLA
// (vslam_tpu/frontend/orb.py::box_blur, shifted-slice sums divided by
// k = 2r + 1).  Its plain-torch version, held bit for bit to that JAX
// code under jit on the CPU, is vslam_tpu_torch/frontend/orb.py::
// box_blur_reference; the two agree bit for bit on every pixel.  XLA on
// the CPU turns each division into a multiply by f32(1/k) and contracts
// the column pass into a chain of fused multiply-adds, so for each image
// and output pixel (y, x), with S(i, j) the image at the clamped
// (min(max(i, 0), H - 1), min(max(j, 0), W - 1)):
//   R_j = ((S(y - r, x - r + j) + S(y - r + 1, x - r + j)) + ...)
//         + S(y + r, x - r + j)                  (k rows, ascending, f32)
//   s = fma(R_0, inv, R_1 * inv); s = fma(R_j, inv, s) for j = 2 .. k - 1
//   out = s * inv,                               inv = f32(1 / k).
// Every operation is an explicitly rounded intrinsic (__fadd_rn,
// __fmul_rn, __fmaf_rn), so neither nvcc's contraction nor a
// reassociation can move a bit; a sliding-window sum would round
// differently and is not used.
//
// What bounds it on the card: the bytes, 8 a pixel (each input read
// once, each output written once), 1.72 us for a 2 x 480 x 752 stack at
// 3.35 TB/s; its f32 operations are 3k a pixel (k - 1 adds, k FMAs of
// two, one multiply), 0.48 us there at r = 7.
// Design:
//  * A block owns a TILE_H x TILE_W tile of one image (blockIdx.z).  It
//    stages the tile with an r-pixel halo on every side by 4-byte
//    cp.async from the clamped source pixel (a row of 1241 floats is not
//    16-byte aligned), so the halo replicates the edge.
//  * The vertical pass writes the k-row sums of the halo-wide tile to
//    shared memory; the horizontal pass runs each output's FMA chain out
//    of it and writes the f32 result once.  A warp reads 32 consecutive
//    columns of one row in both passes: no bank conflicts.
//  * It takes the two radii the port blurs at: 2 (BRIEF, ORB, Harris /
//    GFTT) and 7 (BRIEF256R's orientation map), each compiled with the
//    radius fixed, so the row strides and loop bounds are constants and
//    both passes unroll.  One instantiation for any radius at run time
//    was measured 2.0-3.6 us slower a launch on an H100 (8-13 us), and
//    no caller needs another radius, so other radii are refused.
// Built with -fmad=false like the other kernels of the port.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;

// Staged tile (TILE_H + 2r) x (TILE_W + 2r) and the vertical sums
// TILE_H x (TILE_W + 2r).
__host__ __device__ constexpr size_t smem_bytes(int r) {
  return sizeof(float) * static_cast<size_t>(2 * TILE_H + 2 * r) * (TILE_W + 2 * r);
}

template <int R>
__global__ void __launch_bounds__(THREADS)
box_blur_kernel(const float* __restrict__ img,  // (B, H, W)
                int H, int W, float inv,
                float* __restrict__ out) {      // (B, H, W)
  extern __shared__ __align__(16) float smem[];
  constexpr int r = R;
  constexpr int k = 2 * r + 1;
  constexpr int sw = TILE_W + 2 * r;  // the row stride of both buffers
  constexpr int sh = TILE_H + 2 * r;
  float* raw = smem;              // (sh, sw): rows r0 - r .., columns c0 - r ..
  float* rows = smem + sh * sw;   // (TILE_H, sw): the vertical sums

  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = img + blockIdx.z * plane;
  const int r0 = blockIdx.y * TILE_H, c0 = blockIdx.x * TILE_W;
  const int tid = threadIdx.x;

  for (int q = tid; q < sh * sw; q += THREADS) {
    const int i = q / sw, j = q - i * sw;
    const int y = min(max(r0 - r + i, 0), H - 1);
    const int x = min(max(c0 - r + j, 0), W - 1);
    __pipeline_memcpy_async(raw + q, im + static_cast<size_t>(y) * W + x, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // Rows past the image's last row sum clamped rows too; they are never
  // written out.
  for (int q = tid; q < TILE_H * sw; q += THREADS) {
    const float* p = raw + q;  // row q / sw of raw, the first of its k
    float s = __fadd_rn(p[0], p[sw]);
#pragma unroll
    for (int t = 2; t < k; ++t) s = __fadd_rn(s, p[t * sw]);
    rows[q] = s;
  }
  __syncthreads();

  float* o = out + blockIdx.z * plane;
  for (int q = tid; q < TILE_H * TILE_W; q += THREADS) {
    const int i = q / TILE_W, j = q - i * TILE_W;
    const int y = r0 + i, x = c0 + j;
    if (y >= H || x >= W) continue;
    const float* p = rows + i * sw + j;
    float s = __fmaf_rn(p[0], inv, __fmul_rn(p[1], inv));
#pragma unroll
    for (int t = 2; t < k; ++t) s = __fmaf_rn(p[t], inv, s);
    o[static_cast<size_t>(y) * W + x] = __fmul_rn(s, inv);
  }
}

using Kernel = void (*)(const float*, int, int, float, float*);

// The instantiation that takes `radius`, or nullptr.
Kernel kernel_for(int radius) {
  if (radius == 2) return box_blur_kernel<2>;
  if (radius == 7) return box_blur_kernel<7>;
  return nullptr;
}

constexpr int MAX_DEVICES = 64;

// Selects `device` and lets each instantiation take the shared memory of
// its radius, once per device.
cudaError_t configure(int device) {
  static bool done[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || done[device]) return err;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  err = cudaFuncSetAttribute(kernel_for(2), attr, static_cast<int>(smem_bytes(2)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel_for(7), attr, static_cast<int>(smem_bytes(7)));
  done[device] = err == cudaSuccess;
  return err;
}

}  // namespace

// Launches the kernel on `stream` over a (B, H, W) stack at radius 2 or
// 7; returns the cudaError_t of the launch (0 = ok).  Both pointers are
// device pointers; the kernel allocates nothing.
extern "C" int box_blur_launch(const float* img, int B, int H, int W, int radius, float* out,
                               void* stream, int device) {
  const Kernel kernel = kernel_for(radius);
  if (kernel == nullptr || B < 1 || B > 65535 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float inv = static_cast<float>(1.0 / (2 * radius + 1));
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  kernel<<<grid, THREADS, smem_bytes(radius), static_cast<cudaStream_t>(stream)>>>(
      img, H, W, inv, out);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the instantiation that takes `radius` (2 or 7) resident on
// one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks;
// returns the cudaError_t (0 = ok).
extern "C" int box_blur_occupancy(int radius, int* blocks, int device) {
  const Kernel kernel = kernel_for(radius);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, THREADS, smem_bytes(radius)));
}
