// Dense BRIEF-256 bit planes for Hopper (sm_90a): one kernel behind the
// three TPU kernels of vslam_tpu/frontend/pallas_brief.py
//   K2 dense_bit_planes_pallas_batch   (B, H, W) stack, upright pattern
//   K3 dense_bit_planes_pallas         one image,       upright pattern
//   K4 dense_bit_planes_pallas_pattern one image,       rotated bank k
// and behind K2's band-size / input-type probe in scripts/kernel_lab.py.
// Its plain-torch version is
// vslam_tpu_torch/frontend/dense_brief.py::dense_bit_planes_reference;
// the two agree bit for bit over the whole image.
//
// What it computes, for every pixel x of an already smoothed image S:
//   bit j of word w = [ S(x + o1_b) < S(x + o2_b) ],  b = 32 w + j,
// with S read as 0.0 outside the image (the TPU kernels' zero padding),
// written as int32 words (the bits of the TPU kernels' uint32 words) in
// layout (B, 8, H, W).  The 256 offset pairs come from pattern table
// `table`: 0 is the upright pattern (brief._PAT), 1 + k the rotated bank
// k (brief._ROT_PATS[k]).  All 17 tables live in __constant__ memory as
// int8 (dr1, dc1, dr2, dc2), uploaded once per device by
// dense_brief_set_patterns; the table index is a kernel argument, so one
// binary serves all three TPU kernels.
//
// What bounds it on the card: 512 shared-memory reads per pixel (2 x 376 x
// 1241 x 512 ~ 0.48 G reads per stereo pair) and the 8-word write per
// pixel (30 MB per pair); there is no arithmetic to speak of.  Design:
// one block per (image, BAND-row band, 128-column tile) stages its
// smoothed tile plus a 13-px halo in shared memory once; each thread
// computes one pixel's 8 words at a time from there, with the offsets of
// bit j read by the whole warp from one constant-cache address
// (broadcast) and the 32 lanes reading 32 neighbouring columns (no bank
// conflicts).  Writes run along the columns, coalesced.  BAND is a
// template parameter (8, 16, 32, 64) and so is the input type (float, or
// bf16 for the probe); nothing is pipelined yet.
//
// Built with -fmad=false like K1, although there is nothing to contract:
// the kernel only compares.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int R = 13;              // BRIEF pattern radius
constexpr int TILE = 128;          // output columns per block
constexpr int SW = TILE + 2 * R;   // staged columns [-13, 141)
constexpr int THREADS = 256;
constexpr int N_TABLES = 17;       // upright pattern + 16 rotated banks

// [table][bit][dr1, dc1, dr2, dc2]
__constant__ signed char kPat[N_TABLES][256][4];

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

template <int BAND, typename T>
__global__ void __launch_bounds__(THREADS)
dense_brief_kernel(const T* __restrict__ smooth,  // (B, H, W)
                   int H, int W, int table,
                   int* __restrict__ planes) {    // (B, 8, H, W)
  extern __shared__ unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  constexpr int SH = BAND + 2 * R;  // staged rows [-13, BAND + 13)

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * BAND;
  const int c0 = blockIdx.x * TILE;
  const T* im = smooth + static_cast<size_t>(b) * H * W;

  // Smoothed tile with its halo; zero outside the image.
  for (int k = threadIdx.x; k < SH * SW; k += THREADS) {
    const int i = k / SW, j = k - i * SW;
    const int r = r0 - R + i, c = c0 - R + j;
    tile[k] = (r >= 0 && r < H && c >= 0 && c < W)
                  ? im[static_cast<size_t>(r) * W + c] : zero<T>();
  }
  __syncthreads();

  int* out = planes + static_cast<size_t>(b) * 8 * H * W;
  for (int p = threadIdx.x; p < BAND * TILE; p += THREADS) {
    const int i = p / TILE, j = p - i * TILE;
    const int r = r0 + i, c = c0 + j;
    if (r >= H || c >= W) continue;
    const T* q = tile + (i + R) * SW + (j + R);
    for (int w = 0; w < 8; ++w) {
      unsigned acc = 0u;
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        const signed char* o = kPat[table][w * 32 + jj];
        const float a = to_f32(q[o[0] * SW + o[1]]);
        const float cmp = to_f32(q[o[2] * SW + o[3]]);
        acc |= static_cast<unsigned>(a < cmp) << jj;
      }
      out[(static_cast<size_t>(w) * H + r) * W + c] = static_cast<int>(acc);
    }
  }
}

template <int BAND, typename T>
cudaError_t launch(const void* smooth, int B, int H, int W, int table,
                   int* planes, cudaStream_t stream) {
  constexpr size_t smem = sizeof(T) * (BAND + 2 * R) * SW;
  cudaError_t err = cudaFuncSetAttribute(
      dense_brief_kernel<BAND, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TILE - 1) / TILE, (H + BAND - 1) / BAND, B);
  dense_brief_kernel<BAND, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(smooth), H, W, table, planes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_band(int band, const void* smooth, int B, int H, int W,
                        int table, int* planes, cudaStream_t stream) {
  switch (band) {
    case 8: return launch<8, T>(smooth, B, H, W, table, planes, stream);
    case 16: return launch<16, T>(smooth, B, H, W, table, planes, stream);
    case 32: return launch<32, T>(smooth, B, H, W, table, planes, stream);
    case 64: return launch<64, T>(smooth, B, H, W, table, planes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Copies the 17 pattern tables (17 x 256 x 4 int8, host memory) into the
// kernel's constant memory on `device`; returns the cudaError_t (0 = ok).
extern "C" int dense_brief_set_patterns(const signed char* tables, int n_tables,
                                        int device) {
  if (n_tables != N_TABLES) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyToSymbol(kPat, tables, sizeof(kPat)));
}

// Launches the kernel on `stream` over a (B, H, W) stack of float32
// (bf16 = 0) or bfloat16 (bf16 = 1) values, with pattern table `table`
// and `band` rows per block (8, 16, 32 or 64); returns the cudaError_t of
// the launch (0 = ok).  Pointers are device pointers; the kernel
// allocates nothing.
extern "C" int dense_brief_launch(const void* smooth, int bf16, int B, int H,
                                  int W, int table, int band, int* planes,
                                  void* stream, int device) {
  if (table < 0 || table >= N_TABLES || B <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch_band<__nv_bfloat16>(band, smooth, B, H, W, table, planes, s)
             : launch_band<float>(band, smooth, B, H, W, table, planes, s);
  return static_cast<int>(err);
}
