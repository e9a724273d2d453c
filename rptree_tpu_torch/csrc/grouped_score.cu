// Grouped tile scoring for the query-grouped rerank: kernels 1 and 2.
//
// Replaces the Pallas TPU kernels grouped_score_tiles (f32 and bf16
// blocks) and grouped_score_tiles_int8 (rptree_tpu/ops/grouped_kernel.py:63
// and :145).  A tile is up to tile_m (query, probe) pairs that probe the
// SAME leaf block; for every tile t and slot row i of it the kernel writes
//
//   out[t * m + i, j] = max(sq_leaf[tb[t], j] - 2 * <qt[t * m + i], x_leaf[tb[t], j]> + |q|^2, 0)
//
// (square-rooted for "l2") for j < lens_t[t], and +inf for the slots past
// the block's occupancy.  f32 and bf16 blocks share one scoring device
// function with kernel 4 (score_tile, csrc/grouped_tile.cuh), which says
// how bf16 rounds.  int8 blocks take int8 query rows (quantized per row
// outside the kernel) and dequantize the exact integer dots with
// dots * (block scale * row scale), the Pallas kernel's float order.
//
// What bounds it on an H100: by its arithmetic intensity, bytes.  Each
// tile reads one block (lmax * D * 4 = 64 KB for f32 at lmax 128, D 128;
// 32 KB for bf16; 8 KB for int8 at lmax 64) and its m query rows, and does
// 2 * m * lmax * D operations on them: 4 per block byte at m = 8 in f32
// (8 in bf16, 16 in int8), far below the card's operations-per-byte
// balance, so the block read from device memory is the floor.  Results
// are staged in shared memory so the output rows are written coalesced.
// Rows past a tile's occupancy are not computed at all.
//
// f32 and bf16 (score_tile, csrc/grouped_tile.cuh): the block's occupied
// rows stream through shared memory by cp.async, and no dot ends in a
// cross-lane sum.  f32 blocks take register-blocked fp32 FMAs, never TF32:
// the JAX package measured a recall loss with single-pass bf16 products
// of f32 blocks (0.9249 -> 0.860 at the clustered 1M cell).  bf16 blocks
// take mma.sync on the tensor cores (exact bf16 products, fp32 sums).
//
// int8: one warp sweeps a slot row across D coalesced and reuses it from
// registers for all m query rows, which sit in shared memory; __dp4a on
// 4-byte words, whose integer sums are exact, then one warp-shuffle sum a
// dot.
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

template <int MT>
__global__ void __launch_bounds__(kThreads)
grouped_score_i8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sq,
                        const float* __restrict__ scale_t, const int* __restrict__ tb,
                        const int* __restrict__ lens, const int8_t* __restrict__ q,
                        const float* __restrict__ qscale, const float* __restrict__ qq,
                        float* __restrict__ out, int g, int m, int lmax, int d, int l2,
                        int words) {
  extern __shared__ int ismem[];
  int* qs = ismem;                // [m][ceil(d / 4)] query rows, int8 packed in words
  int* dots = qs + m * ((d + 3) / 4);  // [m][lmax] staged integer dots
  const int dw = (d + 3) / 4;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long blk = min(max(tb[t], 0), g - 1);
  const int len = min(max(lens[t], 0), lmax);

  // query rows -> shared words, zero-padded past d
  const int8_t* qsrc = q + (size_t)t * m * d;
  for (int idx = threadIdx.x; idx < m * dw; idx += blockDim.x) {
    const int i = idx / dw;
    const int c = (idx - i * dw) * 4;
    unsigned w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const unsigned v = c + b < d ? (unsigned)(uint8_t)qsrc[i * d + c + b] : 0u;
      w |= v << (8 * b);
    }
    qs[idx] = (int)w;
  }
  __syncthreads();

  const int8_t* xb = x + (size_t)blk * lmax * d;
  for (int j = warp; j < len; j += nw) {
    const int8_t* xr = xb + (size_t)j * d;
    int acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = 0;
    if (words) {  // d % 4 == 0 and 4-byte aligned rows
      const int* xw = reinterpret_cast<const int*>(xr);
      for (int c = lane; c < dw; c += 32) {
        const int xv = __ldg(xw + c);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (i < m) acc[i] = __dp4a(qs[i * dw + c], xv, acc[i]);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const int xv = (int)xr[c];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < m) {
            const int qv = (int)(int8_t)((qs[i * dw + c / 4] >> (8 * (c & 3))) & 0xff);
            acc[i] += qv * xv;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < m) {
        const int s = rpt::warp_sum(acc[i]);
        if (lane == 0) dots[i * lmax + j] = s;
      }
    }
  }
  __syncthreads();

  const float sc = scale_t[t];
  const float* sqb = sq + (size_t)blk * lmax;
  float* ob = out + (size_t)t * m * lmax;
  for (int idx = threadIdx.x; idx < m * lmax; idx += blockDim.x) {
    const int i = idx / lmax;
    const int j = idx - i * lmax;
    float r = INFINITY;
    if (j < len) {
      const size_t row = (size_t)t * m + i;
      const float dotf = __fmul_rn((float)dots[idx], __fmul_rn(sc, qscale[row]));
      r = rpt::factored_l2(sqb[j], dotf, qq[row], l2);
    }
    ob[idx] = r;
  }
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

template <int MT>
cudaError_t launch_i8(const int8_t* x, const float* sq, const float* scale_t, const int* tb,
                      const int* lens, const int8_t* q, const float* qscale, const float* qq,
                      float* out, int nt, int g, int m, int lmax, int d, int l2, int words,
                      cudaStream_t stream) {
  const size_t smem = sizeof(int) * ((size_t)m * ((d + 3) / 4) + (size_t)m * lmax);
  cudaError_t e = rpt::allow_smem(grouped_score_i8_kernel<MT>, smem);
  if (e != cudaSuccess) return e;
  grouped_score_i8_kernel<MT><<<nt, kThreads, smem, stream>>>(
      x, sq, scale_t, tb, lens, q, qscale, qq, out, g, m, lmax, d, l2, words);
  return cudaGetLastError();
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

int rpt_grouped_score_i8(const int8_t* x, const float* sq, const float* scale_t, const int* tb,
                         const int* lens, const int8_t* q, const float* qscale,
                         const float* qq, float* out, int nt, int g, int tile_m, int lmax,
                         int d, int l2, int words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt <= 0) return 0;
  if (tile_m <= 8)
    return launch_i8<8>(x, sq, scale_t, tb, lens, q, qscale, qq, out, nt, g, tile_m, lmax, d,
                        l2, words, s);
  if (tile_m <= 16)
    return launch_i8<16>(x, sq, scale_t, tb, lens, q, qscale, qq, out, nt, g, tile_m, lmax, d,
                         l2, words, s);
  if (tile_m <= 32)
    return launch_i8<32>(x, sq, scale_t, tb, lens, q, qscale, qq, out, nt, g, tile_m, lmax, d,
                         l2, words, s);
  return (int)cudaErrorInvalidValue;
}

const char* rpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
