// ELL tile scoring for sparse (padded ELL) leaf blocks: kernel 10.
//
// Replaces the ELL scoring steps that the JAX package leaves to XLA (ELL
// blocks fail its tile kernels' gate): the is_ell branch of the grouped
// scorer (rptree_tpu/ops/grouped.py:170-192) and the per-pair ELL step
// (rptree_tpu/models/forest.py:612-627).  Both gather the DENSE query at
// each stored column and contract over the K slots.  A tile is up to m
// (query, probe) pairs that probe the same block; for tile t, row i and
// slot j the kernel writes
//
//   dot = sum_k vals[tb[t], j, k] * q[tp[t, i] / p, cols[tb[t], j, k]]
//   out[t * m + i, j] = dist(dot, sq_leaf[tb[t], j], qq[tp[t, i] / p])
//
// with dist the JAX package's distances_from_dots (l2, sql2, cosine,
// dot), and +inf where tp[t, i] < 0 or j >= lens[t].  The per-pair path
// calls it with m = 1 and the pairs in their own order.
//
// What bounds it on an H100: bytes, and their latency.  Each tile reads
// its block's occupied slots (8 bytes a slot entry: lmax * K * 8 = 32 KB
// at lmax 128, K 32) once, coalesced, into shared memory, and then every
// (row, slot, k) is one 4-byte gather from a query row: 2 operations for
// each 4 bytes fetched, far below the card's balance.  The XLA form
// materialises [tiles, m, lmax, K] gathers and [tiles, m, D] query tiles;
// here the query rows are read in place through tp and nothing of that
// size exists.  Each thread owns one slot at a time and keeps the m rows'
// sums in registers, so a staged (col, val) entry is read from shared
// memory once for all m rows.  The staged rows are padded to K + 1 words
// so that a warp's 32 slots hit 32 banks.  Sums run over k in order, one
// fmaf a step.  Where a tile's staged slots would pass the shared-memory
// budget, they stream through it in chunks of slots.
//
// One thread block per tile, 128 threads.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
// staged (col, val) slots a block keeps below the 48 KB default
constexpr int kStageBytes = 44 * 1024;
constexpr int kMaxStageBytes = 227 * 1024;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The JAX package's distances_from_dots, each step rounded on its own.
__device__ __forceinline__ float ell_dist(float dot, float sq, float qq, int metric) {
  if (metric <= 1) return rpt::factored_l2(sq, dot, qq, metric);  // 0 sql2, 1 l2
  if (metric == 2) {                                               // cosine
    const float den = fmaxf(__fmul_rn(sqrtf(sq), sqrtf(qq)), 1e-30f);
    return __fsub_rn(1.0f, __fdiv_rn(dot, den));
  }
  return -dot;                                                     // 3 dot
}

template <int MT, typename T>
__global__ void __launch_bounds__(kThreads)
ell_score_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                 const float* __restrict__ sq, const int* __restrict__ tb,
                 const int* __restrict__ tp, const int* __restrict__ lens,
                 const float* __restrict__ q, const float* __restrict__ qq,
                 float* __restrict__ out, int g, int m, int lmax, int k, int v, int b,
                 int p, int metric, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = k + 1;  // padded row stride of the staged slots
  int* s_col = reinterpret_cast<int*>(smem_raw);
  float* s_val = reinterpret_cast<float*>(s_col + (size_t)chunk * ks);
  const int t = blockIdx.x;
  const long blk = min(max(tb[t], 0), g - 1);
  const int len = min(max(lens[t], 0), lmax);
  int qr[MT];
  float qn[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int pr = r < m ? tp[(size_t)t * m + r] : -1;
    qr[r] = pr >= 0 ? min(pr / p, b - 1) : -1;
    qn[r] = qr[r] >= 0 ? qq[qr[r]] : 0.0f;
  }
  const int* cb = cols + (size_t)blk * lmax * k;
  const T* vb = vals + (size_t)blk * lmax * k;
  const float* sb = sq + (size_t)blk * lmax;
  float* ob = out + (size_t)t * m * lmax;
  const float inf = __int_as_float(0x7f800000);
  for (int j0 = 0; j0 < lmax; j0 += chunk) {
    const int staged = max(0, min(chunk, len - j0));
    for (int idx = threadIdx.x; idx < staged * k; idx += kThreads) {
      const int s = idx / k, kk = idx - s * k;
      const size_t at = (size_t)(j0 + s) * k + kk;
      s_col[s * ks + kk] = min(max(cb[at], 0), v - 1);
      s_val[s * ks + kk] = as_float(vb[at]);
    }
    __syncthreads();
    for (int jj = threadIdx.x; jj < chunk && j0 + jj < lmax; jj += kThreads) {
      const int j = j0 + jj;
      float acc[MT];
#pragma unroll
      for (int r = 0; r < MT; ++r) acc[r] = 0.0f;
      if (jj < staged) {
        // unrolled so that several slots' gathers are in flight at once;
        // each row's sum still runs over k in order
#pragma unroll 4
        for (int kk = 0; kk < k; ++kk) {
          const int c = s_col[jj * ks + kk];
          const float w = s_val[jj * ks + kk];
#pragma unroll
          for (int r = 0; r < MT; ++r)
            if (qr[r] >= 0) acc[r] = fmaf(w, q[(size_t)qr[r] * v + c], acc[r]);
        }
      }
      const float sqj = jj < staged ? sb[j] : 0.0f;
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (r >= m) break;
        ob[(size_t)r * lmax + j] =
            (qr[r] < 0 || jj >= staged) ? inf : ell_dist(acc[r], sqj, qn[r], metric);
      }
    }
    __syncthreads();
  }
}

template <int MT, typename T>
cudaError_t launch_m(const int* cols, const T* vals, const float* sq, const int* tb,
                     const int* tp, const int* lens, const float* q, const float* qq,
                     float* out, int nt, int g, int m, int lmax, int k, int v, int b, int p,
                     int metric, cudaStream_t stream) {
  const size_t slot_bytes = (size_t)(k + 1) * 8;
  const size_t fit = kStageBytes / slot_bytes;
  const int chunk = fit < 1 ? 1 : (fit < (size_t)lmax ? (int)fit : lmax);
  const size_t smem = (size_t)chunk * slot_bytes;
  if (smem > kMaxStageBytes) return cudaErrorInvalidValue;
  cudaError_t e = rpt::allow_smem(ell_score_kernel<MT, T>, smem);
  if (e != cudaSuccess) return e;
  ell_score_kernel<MT, T><<<nt, kThreads, smem, stream>>>(cols, vals, sq, tb, tp, lens, q, qq,
                                                          out, g, m, lmax, k, v, b, p, metric,
                                                          chunk);
  return cudaGetLastError();
}

template <typename T>
int launch(const int* cols, const T* vals, const float* sq, const int* tb, const int* tp,
           const int* lens, const float* q, const float* qq, float* out, int nt, int g,
           int tile_m, int lmax, int k, int v, int b, int p, int metric, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt <= 0 || lmax <= 0) return 0;
  if (tile_m < 1 || k < 1 || v < 1 || b < 1 || p < 1 || g < 1 || metric < 0 || metric > 3)
    return (int)cudaErrorInvalidValue;
  if (tile_m == 1)
    return launch_m<1>(cols, vals, sq, tb, tp, lens, q, qq, out, nt, g, 1, lmax, k, v, b, p,
                       metric, s);
  if (tile_m <= 8)
    return launch_m<8>(cols, vals, sq, tb, tp, lens, q, qq, out, nt, g, tile_m, lmax, k, v, b,
                       p, metric, s);
  if (tile_m <= 16)
    return launch_m<16>(cols, vals, sq, tb, tp, lens, q, qq, out, nt, g, tile_m, lmax, k, v, b,
                        p, metric, s);
  if (tile_m <= 32)
    return launch_m<32>(cols, vals, sq, tb, tp, lens, q, qq, out, nt, g, tile_m, lmax, k, v, b,
                        p, metric, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on a good launch; cudaErrorInvalidValue
// for a tile_m outside [1, 32], a metric code outside [0, 3] (sql2, l2,
// cosine, dot) or a K whose one staged slot passes the shared memory.
int rpt_ell_score_f32(const int* cols, const float* vals, const float* sq, const int* tb,
                      const int* tp, const int* lens, const float* q, const float* qq,
                      float* out, int nt, int g, int tile_m, int lmax, int k, int v, int b,
                      int p, int metric, void* stream) {
  return launch(cols, vals, sq, tb, tp, lens, q, qq, out, nt, g, tile_m, lmax, k, v, b, p,
                metric, stream);
}

int rpt_ell_score_bf16(const int* cols, const __nv_bfloat16* vals, const float* sq,
                       const int* tb, const int* tp, const int* lens, const float* q,
                       const float* qq, float* out, int nt, int g, int tile_m, int lmax,
                       int k, int v, int b, int p, int metric, void* stream) {
  return launch(cols, vals, sq, tb, tp, lens, q, qq, out, nt, g, tile_m, lmax, k, v, b, p,
                metric, stream);
}

}  // extern "C"
