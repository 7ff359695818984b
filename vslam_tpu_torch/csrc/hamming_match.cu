// Mutual-best descriptor matching under a geometric gate for Hopper
// (sm_90a): one call of frontend/matching.py's match_stereo or
// match_projective on the card, in two launches.
//
// It replaces no TPU kernel: the JAX package matches in XLA
// (vslam_tpu/frontend/matching.py: a (Q, D) Hamming matrix, the gate
// masks, hamming.mutual_best_match).  Its plain-torch version, held bit
// for bit to that JAX code on the CPU, is the same functions' torch route
// (ops/hamming.py::hamming_matrix + mutual_best_match); the two agree on
// all three outputs of every row, valid or not.  For each problem a of
// the A the caller stacks (projective: its leading dims; stereo: A = 1),
// query row q and database column d:
//   dist     = sum over the 8 words of popc(qdesc[q] ^ ddesc[d])
//   gate     stereo:     qmask[q] & dmask[d] & |qv - dv| <= g0
//                        & qu - du >= g1 & qu - du <= g2
//            projective: qmask[a, q] & dmask[d] & |qu - du| <= g0[a]
//                        & |qv - dv| <= g0[a]
//   masked   = gate ? min(dist, 512) : 512
//   best_j   = the first argmin over d of masked (row q),
//   best_i   = the first argmin over q of masked (column d),
//   out      idx = best_j, best = masked[q, best_j],
//            valid = best_i[best_j] == q & best <= max_distance[a].
// The f32 differences, |.| and compares are exact IEEE operations (no
// multiply to contract), so they give torch's bits; a NaN compares false.
// A gate is a device pointer read at each launch (so a captured graph
// reads the value at replay) or, with a null pointer, a value argument.
//
// What bounds it: the data is small (at Q = D = 1,024 two 32 KB
// descriptor sets, the uv sets and masks: ~90 KB, 0.03 us at 3.35 TB/s);
// the work is 8 popcounts a pair (8 M at Q = D = 1,024: 1.9 us at 16 a
// clock on each of 132 SMs at 1.98 GHz), plus the gate and two minima.
// Design:
//  * Launch 1 (hamming_match_tiles_kernel) tiles the pairs 64 x 64 a
//    block, 256 threads: a thread holds one database column's words in
//    registers and reads 16 query rows' words from shared memory (a warp
//    reads one row at a time: a broadcast).  The 16 distances stay in
//    registers while the problems' gates run over them, so the popcounts
//    are computed once for every a.
//  * Minima are packed 32-bit keys (masked << 21) | index, so the least
//    key is the least distance at its first index, in any order of
//    reduction: a row's key over the warp's 32 columns by
//    __reduce_min_sync, then over the block by a shared atomicMin; a
//    column's over its thread's 16 rows, then the block's 4 row groups.
//    Each block writes its tile's row and column minima to a partial
//    buffer (A x tiles x rows); nothing of size Q x D leaves the block.
//  * Launch 2 (hamming_match_resolve_kernel) takes each row's minimum
//    over its column tiles, then the column minimum of that one best
//    column over its row tiles: the mutual check without a pass over
//    every column.
// Built with -fmad=false like the other kernels of the port.

#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;   // query rows a block
constexpr int TD = 64;   // database columns a block
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / TD;  // row groups of a block
constexpr int ROWS = TQ / GROUPS;     // query rows a thread
constexpr int WORDS = 8;              // 256-bit descriptors
constexpr int INDEX_BITS = 21;
constexpr unsigned INDEX_MASK = (1u << INDEX_BITS) - 1;
constexpr unsigned NONE = 0xFFFFFFFFu;
constexpr int SENT = 512;  // the masked distance of a gated-out pair
constexpr int RESOLVE_THREADS = 256;

enum Form { STEREO = 0, PROJECTIVE = 1 };

// A gate of problem a: p[a * stride] when p is given, else v.
struct Gate {
  const float* p;
  int stride;
  float v;
  __device__ float at(int a) const { return p != nullptr ? p[a * stride] : v; }
};

struct Rows {  // the query side: (Q, 8) words, (A, Q) uv and masks
  const int* desc;
  int desc_q, desc_w;  // strides in words
  const float* uv;
  int uv_a, uv_q;  // strides in floats; u at +0, v at +1
  const unsigned char* mask;
  int mask_a;
};

struct Cols {  // the database side: (D, 8) words, (D, 2) uv, (D,) mask
  const int* desc;
  int desc_d, desc_w;  // strides in words
  const float* uv;
  int uv_d;
  const unsigned char* mask;
};

template <int FORM>
__device__ __forceinline__ bool gate_passes(float qu, float qv, float du, float dv, float g0,
                                            float g1, float g2) {
  if (FORM == STEREO) {
    const float disp = __fsub_rn(qu, du);
    return fabsf(__fsub_rn(qv, dv)) <= g0 && disp >= g1 && disp <= g2;
  }
  return fabsf(__fsub_rn(qu, du)) <= g0 && fabsf(__fsub_rn(qv, dv)) <= g0;
}

template <int FORM>
__global__ void __launch_bounds__(THREADS)
hamming_match_tiles_kernel(int A, int Q, int D, Rows rows, Cols cols, Gate g0, Gate g1,
                           Gate g2, unsigned* __restrict__ row_part,  // (A, nD, Q)
                           unsigned* __restrict__ col_part) {         // (A, nQ, D)
  __shared__ int4 s_desc[TQ][2];
  __shared__ float s_u[TQ], s_v[TQ];
  __shared__ unsigned char s_mask[TQ];
  __shared__ unsigned s_row[TQ], s_col[TD];

  const int tid = threadIdx.x;
  const int c = tid % TD, g = tid / TD;
  const int q0 = blockIdx.y * TQ, d0 = blockIdx.x * TD;
  const int d = d0 + c;
  const bool d_in = d < D;

  for (int i = tid; i < TQ * WORDS; i += THREADS) {
    const int q = q0 + i / WORDS;
    reinterpret_cast<int*>(s_desc)[i] =
        q < Q ? rows.desc[static_cast<size_t>(q) * rows.desc_q +
                          static_cast<size_t>(i % WORDS) * rows.desc_w]
              : 0;
  }
  int words[WORDS];
  float du = 0.f, dv = 0.f;
  bool dm = false;
  if (d_in) {
#pragma unroll
    for (int w = 0; w < WORDS; ++w)
      words[w] = cols.desc[static_cast<size_t>(d) * cols.desc_d +
                           static_cast<size_t>(w) * cols.desc_w];
    du = cols.uv[static_cast<size_t>(d) * cols.uv_d];
    dv = cols.uv[static_cast<size_t>(d) * cols.uv_d + 1];
    dm = cols.mask[d] != 0;
  } else {
#pragma unroll
    for (int w = 0; w < WORDS; ++w) words[w] = 0;
  }
  __syncthreads();

  int dist[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = g * ROWS + k;
    const int4 lo = s_desc[r][0], hi = s_desc[r][1];
    dist[k] = __popc(lo.x ^ words[0]) + __popc(lo.y ^ words[1]) + __popc(lo.z ^ words[2]) +
              __popc(lo.w ^ words[3]) + __popc(hi.x ^ words[4]) + __popc(hi.y ^ words[5]) +
              __popc(hi.z ^ words[6]) + __popc(hi.w ^ words[7]);
  }

  const int nD = gridDim.x, nQ = gridDim.y;
  for (int a = 0; a < A; ++a) {
    __syncthreads();  // the previous problem's minima are written out
    if (tid < TQ) {
      const int q = q0 + tid;
      const bool in = q < Q;
      const size_t at = static_cast<size_t>(a) * rows.uv_a + static_cast<size_t>(q) * rows.uv_q;
      s_u[tid] = in ? rows.uv[at] : 0.f;
      s_v[tid] = in ? rows.uv[at + 1] : 0.f;
      s_mask[tid] = in ? rows.mask[static_cast<size_t>(a) * rows.mask_a + q] : 0;
      s_row[tid] = NONE;
    }
    if (tid < TD) s_col[tid] = NONE;
    const float a0 = g0.at(a), a1 = g1.at(a), a2 = g2.at(a);
    __syncthreads();

    unsigned col_min = NONE;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int r = g * ROWS + k;
      const int q = q0 + r;
      const bool in = d_in && q < Q;
      const bool pass = s_mask[r] && dm && gate_passes<FORM>(s_u[r], s_v[r], du, dv, a0, a1, a2);
      const unsigned m = static_cast<unsigned>(pass ? min(dist[k], SENT) : SENT) << INDEX_BITS;
      col_min = min(col_min, in ? m | static_cast<unsigned>(q) : NONE);
      const unsigned row_min = __reduce_min_sync(0xFFFFFFFFu, in ? m | static_cast<unsigned>(d)
                                                                 : NONE);
      if ((tid & 31) == 0) atomicMin(&s_row[r], row_min);
    }
    atomicMin(&s_col[c], col_min);
    __syncthreads();
    if (tid < TQ && q0 + tid < Q)
      row_part[(static_cast<size_t>(a) * nD + blockIdx.x) * Q + q0 + tid] = s_row[tid];
    if (tid < TD && d0 + tid < D)
      col_part[(static_cast<size_t>(a) * nQ + blockIdx.y) * D + d0 + tid] = s_col[tid];
  }
}

__global__ void __launch_bounds__(RESOLVE_THREADS)
hamming_match_resolve_kernel(int A, int Q, int D, int nD, int nQ,
                             const unsigned* __restrict__ row_part,
                             const unsigned* __restrict__ col_part, const int* max_p,
                             int max_stride, float max_v, int* __restrict__ idx,
                             unsigned char* __restrict__ valid, int* __restrict__ best) {
  const int i = blockIdx.x * RESOLVE_THREADS + threadIdx.x;
  if (i >= A * Q) return;
  const int a = i / Q, q = i - a * Q;
  unsigned key = NONE;
  for (int t = 0; t < nD; ++t)
    key = min(key, row_part[(static_cast<size_t>(a) * nD + t) * Q + q]);
  const int j = static_cast<int>(key & INDEX_MASK);
  const int b = static_cast<int>(key >> INDEX_BITS);
  unsigned col = NONE;
  for (int t = 0; t < nQ; ++t)
    col = min(col, col_part[(static_cast<size_t>(a) * nQ + t) * D + j]);
  // torch compares an int32 distance with an int32 tensor as integers and
  // with a Python number as f32 (exact here: the distance is <= 512).
  const bool near = max_p != nullptr ? b <= max_p[a * max_stride]
                                     : static_cast<float>(b) <= max_v;
  idx[i] = j;
  best[i] = b;
  valid[i] = static_cast<int>(col & INDEX_MASK) == q && near;
}

using TilesKernel = void (*)(int, int, int, Rows, Cols, Gate, Gate, Gate, unsigned*,
                             unsigned*);

TilesKernel tiles_for(int form) {
  if (form == STEREO) return hamming_match_tiles_kernel<STEREO>;
  if (form == PROJECTIVE) return hamming_match_tiles_kernel<PROJECTIVE>;
  return nullptr;
}

constexpr int MAX_DEVICES = 64;

cudaError_t select(int device) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

}  // namespace

// Launches one match on `stream`: the tiles kernel, then the resolve
// kernel.  form 0 stereo, 1 projective; A problems of Q query rows and D
// database columns (1 <= Q, D <= 2^21); strides in elements (a
// descriptor's words at any row and word stride, a uv pair's at stride
// 1).  Every pointer is a device pointer; a gate pointer may be null, and
// then the value after it holds.  `partial` holds `partial_words` 32-bit
// words, at least A * (ceil(D / 64) * Q + ceil(Q / 64) * D).  Returns the
// cudaError_t of the launches (0 = ok).
extern "C" int hamming_match_launch(int form, int A, int Q, int D, const int* q_desc,
                                    int q_desc_q, int q_desc_w, const float* q_uv, int q_uv_a,
                                    int q_uv_q, const unsigned char* q_mask, int q_mask_a,
                                    const int* d_desc, int d_desc_d, int d_desc_w,
                                    const float* d_uv, int d_uv_d, const unsigned char* d_mask,
                                    const float* g0_p, int g0_s, float g0, const float* g1_p,
                                    int g1_s, float g1,
                                    const float* g2_p, int g2_s, float g2, const int* max_p,
                                    int max_s, float max_v, unsigned* partial,
                                    int partial_words, int* idx, unsigned char* valid,
                                    int* best, void* stream, int device) {
  const TilesKernel tiles = tiles_for(form);
  if (tiles == nullptr || A < 1 || Q < 1 || D < 1 || Q > (1 << INDEX_BITS) ||
      D > (1 << INDEX_BITS))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nD = (D + TD - 1) / TD, nQ = (Q + TQ - 1) / TQ;
  const long long need = static_cast<long long>(A) * (static_cast<long long>(nD) * Q +
                                                      static_cast<long long>(nQ) * D);
  if (partial_words < need || static_cast<long long>(A) * Q > (1LL << 31) - RESOLVE_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = select(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  unsigned* row_part = partial;
  unsigned* col_part = partial + static_cast<size_t>(A) * nD * Q;
  tiles<<<dim3(nD, nQ), THREADS, 0, st>>>(
      A, Q, D, Rows{q_desc, q_desc_q, q_desc_w, q_uv, q_uv_a, q_uv_q, q_mask, q_mask_a},
      Cols{d_desc, d_desc_d, d_desc_w, d_uv, d_uv_d, d_mask}, Gate{g0_p, g0_s, g0},
      Gate{g1_p, g1_s, g1}, Gate{g2_p, g2_s, g2}, row_part, col_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = A * Q;
  hamming_match_resolve_kernel<<<(n + RESOLVE_THREADS - 1) / RESOLVE_THREADS, RESOLVE_THREADS,
                                 0, st>>>(A, Q, D, nD, nQ, row_part, col_part, max_p, max_s,
                                          max_v, idx, valid, best);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the tiles kernel of `form` resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks; returns
// the cudaError_t (0 = ok).
extern "C" int hamming_match_occupancy(int form, int* blocks, int device) {
  const TilesKernel tiles = tiles_for(form);
  if (tiles == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = select(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, tiles, THREADS, 0));
}
