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
// layout (B, 8, H, W).  The offset pairs come from pattern table `table`
// of brief_patterns.cuh: 0 is the upright pattern (brief._PAT), 1 + k the
// rotated bank k (brief._ROT_PATS[k]).
//
// What bounds it on the card: the bytes it must move (4 B in and 32 B out
// a pixel: 33.6 MB, 10.0 us at 3.35 TB/s for a 2 x 376 x 1241 stack) lie
// under its shared-memory reads, 281-291 distinct taps a pixel (31 us for
// that stack at one 32-lane load per SM and clock).  Design:
//  * The compare core is brief_core.cuh, shared with K1: the table is a
//    template parameter (a switch in the launcher picks one of 17
//    instantiations), every tap an immediate offset, each distinct tap
//    loaded once a pixel.
//  * A persistent grid: as many blocks as fit on the card at once
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, 4 blocks of 256
//    threads an SM at the main band) walk the (image, BAND-row band,
//    128-column tile) tiles; each stages its next tile by cp.async into
//    the second of two shared buffers while it computes the current one,
//    so the staging of every tile after the first is hidden.  Splitting a
//    tile's pixels over several blocks, so that a small image (K3's
//    188 x 620 level: 120 tiles) fills every SM, was measured slower on
//    an H100: a block's 4 pixels a thread beat 1 pixel on 4 times the
//    warps.
//  * One thread makes one pixel's 8 words at a time, 32 lanes on 32
//    neighbouring columns (no bank conflicts); the words are stored after
//    the 256 compares, coalesced along the columns.
// BAND is a template parameter (8 on the main path; 16, 32, 64 for the
// probe) and so is the input type (float, or bf16 for the probe, staged
// through registers); the probe's bands and bf16 are built for table 0.
//
// Built with -fmad=false like K1, although there is nothing to contract:
// the kernel only compares.  The compares are exact f32, so tensor cores
// do not apply.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "brief_core.cuh"

namespace {

constexpr int R = 13;              // BRIEF pattern radius
constexpr int TILE = 128;          // output columns per tile
constexpr int SW = TILE + 2 * R;   // staged columns [-13, 141)
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;      // per SM at the main band: 32 warps
constexpr int MAIN_BAND = 8;       // the band every table is built for

template <int BAND, typename T>
constexpr size_t smem_bytes() { return 2 * sizeof(T) * (BAND + 2 * R) * SW; }

template <int BAND, typename T, int TABLE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_brief_kernel(const T* __restrict__ smooth,  // (B, H, W)
                   int H, int W, int tiles_x, int tiles_per_image, int n_tiles,
                   int* __restrict__ planes) {    // (B, 8, H, W)
  constexpr int SH = BAND + 2 * R;  // staged rows [-13, BAND + 13)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buffers = reinterpret_cast<T*>(smem_raw);  // 2 x (SH, SW)

  auto origin = [&](int tile, int& b, int& r0, int& c0) {
    b = tile / tiles_per_image;
    const int rem = tile - b * tiles_per_image;
    r0 = (rem / tiles_x) * BAND;
    c0 = (rem % tiles_x) * TILE;
  };
  auto stage = [&](int tile, T* dst) {
    int b, r0, c0;
    origin(tile, b, r0, c0);
    brief::stage_tile<SH, SW, THREADS>(dst, smooth + static_cast<size_t>(b) * H * W,
                                       H, W, r0 - R, c0 - R);
  };

  int tile = blockIdx.x;
  if (tile >= n_tiles) return;
  stage(tile, buffers);
  for (int step = 0; tile < n_tiles; ++step) {
    const int next = tile + gridDim.x;
    T* const cur = buffers + (step & 1) * SH * SW;
    if (next < n_tiles) {
      stage(next, buffers + ((step + 1) & 1) * SH * SW);
      __pipeline_wait_prior(1);  // the current tile's group has landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    int b, r0, c0;
    origin(tile, b, r0, c0);
    int* out = planes + static_cast<size_t>(b) * 8 * H * W;
#pragma unroll 1  // one pixel's loads per iteration (counted from SASS)
    for (int p = threadIdx.x; p < BAND * TILE; p += THREADS) {
      const int i = p / TILE, j = p - i * TILE;
      const int r = r0 + i, c = c0 + j;
      if (r >= H || c >= W) continue;
      unsigned w[8];
      brief::brief_words<TABLE, SW>(cur + (i + R) * SW + (j + R), w);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        out[(static_cast<size_t>(k) * H + r) * W + c] = static_cast<int>(w[k]);
    }
    __syncthreads();  // the next step restages into `cur`
    tile = next;
  }
}

struct Launch {
  const void* smooth;
  int B, H, W;
  int* planes;
  cudaStream_t stream;
  int device;
  int* blocks_per_sm;  // out: resident blocks per SM
  bool run;            // false: only report blocks_per_sm
};

constexpr int MAX_DEVICES = 64;

template <int BAND, typename T, int TABLE>
cudaError_t run(const Launch& a) {
  const auto kernel = dense_brief_kernel<BAND, T, TABLE>;
  constexpr size_t smem = smem_bytes<BAND, T>();
  // Attributes, occupancy and SM count, once per device.
  static int per_sm[MAX_DEVICES] = {}, sms[MAX_DEVICES] = {};
  if (a.device < 0 || a.device >= MAX_DEVICES) return cudaErrorInvalidValue;
  if (per_sm[a.device] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[a.device], cudaDevAttrMultiProcessorCount, a.device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[a.device], kernel,
                                                          THREADS, smem);
    if (err != cudaSuccess) {
      per_sm[a.device] = 0;
      return err;
    }
  }
  if (a.blocks_per_sm) *a.blocks_per_sm = per_sm[a.device];
  if (!a.run) return cudaSuccess;
  const int slots = per_sm[a.device] * sms[a.device];
  const int tiles_x = (a.W + TILE - 1) / TILE;
  const int tiles_per_image = tiles_x * ((a.H + BAND - 1) / BAND);
  const int n_tiles = a.B * tiles_per_image;
  const int grid = slots < n_tiles ? slots : n_tiles;
  kernel<<<grid, THREADS, smem, a.stream>>>(static_cast<const T*>(a.smooth), a.H, a.W,
                                            tiles_x, tiles_per_image, n_tiles, a.planes);
  return cudaGetLastError();
}

// One of the tables TB... (the one equal to `table`), or an invalid value.
template <int BAND, typename T, int... TB>
cudaError_t by_table(int table, const Launch& a, std::integer_sequence<int, TB...>) {
  cudaError_t err = cudaErrorInvalidValue;
  ((table == TB ? (err = run<BAND, T, TB>(a), true) : false) || ...);
  return err;
}

template <int BAND, typename T>
cudaError_t by_band_table(int table, const Launch& a) {
  if constexpr (BAND == MAIN_BAND && std::is_same_v<T, float>) {
    return by_table<BAND, T>(table, a, std::make_integer_sequence<int, brief::kTables>{});
  } else {
    return by_table<BAND, T>(table, a, std::integer_sequence<int, 0>{});
  }
}

template <typename T>
cudaError_t by_band(int band, int table, const Launch& a) {
  switch (band) {
    case 8: return by_band_table<8, T>(table, a);
    case 16: return by_band_table<16, T>(table, a);
    case 32: return by_band_table<32, T>(table, a);
    case 64: return by_band_table<64, T>(table, a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int bf16, int band, int table, const Launch& a) {
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return err;
  return bf16 ? by_band<__nv_bfloat16>(band, table, a) : by_band<float>(band, table, a);
}

}  // namespace

// Launches the kernel on `stream` over a (B, H, W) stack of float32
// (bf16 = 0) or bfloat16 (bf16 = 1) values, with pattern table `table`
// and `band` rows per tile (8 for every table; 16, 32 or 64 for table 0);
// returns the cudaError_t of the launch (0 = ok).  Pointers are device
// pointers; the kernel allocates nothing.
extern "C" int dense_brief_launch(const void* smooth, int bf16, int B, int H,
                                  int W, int table, int band, int* planes,
                                  void* stream, int device) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{smooth, B, H, W, planes, static_cast<cudaStream_t>(stream), device,
                 nullptr, true};
  return static_cast<int>(dispatch(bf16, band, table, a));
}

// Blocks of the (bf16, band, table) instantiation resident on one SM
// into *blocks; returns the cudaError_t (0 = ok).
extern "C" int dense_brief_occupancy(int bf16, int band, int table, int* blocks,
                                     int device) {
  const Launch a{nullptr, 0, 0, 0, nullptr, nullptr, device, blocks, false};
  return static_cast<int>(dispatch(bf16, band, table, a));
}
