// Grouped tile scoring for the query-grouped rerank: kernel 1.
//
// Replaces the Pallas TPU kernel grouped_score_tiles (f32 and bf16
// blocks; rptree_tpu/ops/grouped_kernel.py:63).  A tile is up to tile_m
// (query, probe) pairs that probe the SAME leaf block; for every tile t
// and slot row i of it the kernel writes
//
//   out[t * m + i, j] = max(sq_leaf[tb[t], j] - 2 * <qt[t * m + i], x_leaf[tb[t], j]> + |q|^2, 0)
//
// (square-rooted for "l2") for j < lens_t[t], and +inf for the slots past
// the block's occupancy.  f32 and bf16 blocks share one scoring device
// function with kernel 4 (score_tile, csrc/grouped_tile.cuh), which says
// how bf16 rounds.  int8 blocks are kernel 2's (csrc/grouped_score_i8.cu).
//
// What bounds it on an H100: by its arithmetic intensity, bytes.  Each
// tile reads one block (lmax * D * 4 = 64 KB for f32 at lmax 128, D 128;
// 32 KB for bf16) and its m query rows, and does 2 * m * lmax * D
// operations on them: 4 per block byte at m = 8 in f32 (8 in bf16), far
// below the card's operations-per-byte balance, so the block read from
// device memory is the floor.  Results are staged in shared memory so the
// output rows are written coalesced.  Rows past a tile's occupancy are
// not computed at all.
//
// score_tile (csrc/grouped_tile.cuh): the block's occupied rows stream
// through shared memory by cp.async, and no dot ends in a cross-lane sum.
// f32 blocks take register-blocked fp32 FMAs, never TF32: the JAX package
// measured a recall loss with single-pass bf16 products of f32 blocks
// (0.9249 -> 0.860 at the clustered 1M cell).  bf16 blocks take mma.sync
// on the tensor cores (exact bf16 products, fp32 sums).
//
// One thread block per tile, eight warps.

#include "grouped_tile.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(kThreads == rpt::kTileThreads, "score_tile's block size");

template <int MT, typename T>
__global__ void __launch_bounds__(kThreads)
grouped_score_kernel(const T* __restrict__ x, const float* __restrict__ sq,
                     const int* __restrict__ tb, const int* __restrict__ lens,
                     const float* __restrict__ qt, float* __restrict__ out, int g, int m,
                     int lmax, int d, int l2, int vec) {
  extern __shared__ __align__(16) float smem[];  // score_tile's stages, queries, distances
  const float* dist = rpt::tile_dist<MT, T>(smem, d);
  const int t = blockIdx.x;
  const long blk = min(max(tb[t], 0), g - 1);
  const int len = min(max(lens[t], 0), lmax);
  rpt::score_tile<MT>(x, sq, qt, t, blk, len, m, lmax, d, l2, vec, smem);
  float* ob = out + (size_t)t * m * lmax;
  for (int idx = threadIdx.x; idx < m * lmax; idx += blockDim.x) ob[idx] = dist[idx];
}

template <int MT, typename T>
cudaError_t launch_tiles(const T* x, const float* sq, const int* tb, const int* lens,
                         const float* qt, float* out, int nt, int g, int m, int lmax, int d,
                         int l2, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * rpt::score_tile_floats<MT, T>(m, lmax, d);
  cudaError_t e = rpt::allow_smem(grouped_score_kernel<MT, T>, smem);
  if (e != cudaSuccess) return e;
  grouped_score_kernel<MT, T><<<nt, kThreads, smem, stream>>>(x, sq, tb, lens, qt, out, g, m,
                                                              lmax, d, l2, vec);
  return cudaGetLastError();
}

template <typename T>
int launch_tiles_m(const T* x, const float* sq, const int* tb, const int* lens,
                   const float* qt, float* out, int nt, int g, int tile_m, int lmax, int d,
                   int l2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = rpt::vec_rows(x, d);
  if (nt <= 0) return 0;
  if (tile_m < 1) return (int)cudaErrorInvalidValue;
  if (tile_m <= 8)
    return launch_tiles<8>(x, sq, tb, lens, qt, out, nt, g, tile_m, lmax, d, l2, vec, s);
  if (tile_m <= 16)
    return launch_tiles<16>(x, sq, tb, lens, qt, out, nt, g, tile_m, lmax, d, l2, vec, s);
  if (tile_m <= 32)
    return launch_tiles<32>(x, sq, tb, lens, qt, out, nt, g, tile_m, lmax, d, l2, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on a good launch; cudaErrorInvalidValue
// for a tile_m outside [1, 32].
int rpt_grouped_score_f32(const float* x, const float* sq, const int* tb, const int* lens,
                          const float* qt, float* out, int nt, int g, int tile_m, int lmax,
                          int d, int l2, void* stream) {
  return launch_tiles_m(x, sq, tb, lens, qt, out, nt, g, tile_m, lmax, d, l2, stream);
}

int rpt_grouped_score_bf16(const __nv_bfloat16* x, const float* sq, const int* tb,
                           const int* lens, const float* qt, float* out, int nt, int g,
                           int tile_m, int lmax, int d, int l2, void* stream) {
  return launch_tiles_m(x, sq, tb, lens, qt, out, nt, g, tile_m, lmax, d, l2, stream);
}

const char* rpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
