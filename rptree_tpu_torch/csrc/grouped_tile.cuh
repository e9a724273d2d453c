// The tile scoring shared by the tile kernels of the grouped rerank:
// grouped_score (kernel 1, csrc/grouped_score.cu) and grouped_topk
// (kernel 4, csrc/grouped_topk.cu).  Both stage a tile's distances with
// score_tile below, so kernel 4's distances are bit-equal to kernel 1's.
//
// A tile is up to m (query, probe) pairs that probe the SAME leaf block
// tb[t]; score_tile leaves in shared memory
//
//   dist[i * lmax + j] = max(sq[tb[t], j] - 2 * <q_i, x[tb[t], j]> + |q_i|^2, 0)
//
// (square-rooted for "l2") for j < lens[t], and +inf past the block's
// occupancy.  Block elements are f32 or bf16.  With bf16 blocks the query
// rows are rounded to bf16 (round to nearest even) before the dot, as the
// Pallas kernel's qm.astype(bf16) does, so every product of two bf16
// values is exact in fp32; |q|^2 comes from the unrounded f32 row.  Sums
// are fp32 FMAs, never TF32.
//
// Mapping: the tile's query rows sit in shared memory; warps take the
// block's slot rows in turn, and one warp sweeps a slot row across D
// coalesced (bf16 rows as __nv_bfloat162 pairs when D is even and the rows
// are 4-byte aligned), once, reusing it from registers for all m query
// rows.  Each dot is one warp's shuffle sum, so its value does not depend
// on the block size or on which warp computed it.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace rpt {

// Query-row rounding to the block's element type.
__device__ __forceinline__ float round_to(const float*, float v) { return v; }
__device__ __forceinline__ float round_to(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One warp's partial dots of slot row xr against the m query rows in qs:
// lane-strided across D, accumulated into acc[i] in fp32.
template <int MT>
__device__ __forceinline__ void row_dots(const float* __restrict__ xr, const float* qs, int m,
                                         int d, int, int lane, float (&acc)[MT]) {
  for (int c = lane; c < d; c += 32) {
    const float xv = __ldg(xr + c);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < m) acc[i] = fmaf(qs[i * d + c], xv, acc[i]);
  }
}

template <int MT>
__device__ __forceinline__ void row_dots(const __nv_bfloat16* __restrict__ xr, const float* qs,
                                         int m, int d, int pairs, int lane, float (&acc)[MT]) {
  if (pairs) {  // d even, 4-byte aligned rows: one bf16 pair per lane and step
    const __nv_bfloat162* xr2 = reinterpret_cast<const __nv_bfloat162*>(xr);
    for (int c = lane; c < d / 2; c += 32) {
      const float2 xv = __bfloat1622float2(__ldg(xr2 + c));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < m) {
          const float2 qv = reinterpret_cast<const float2*>(qs + i * d)[c];
          acc[i] = fmaf(qv.y, xv.y, fmaf(qv.x, xv.x, acc[i]));
        }
      }
    }
    return;
  }
  for (int c = lane; c < d; c += 32) {
    const float xv = __bfloat162float(__ldg(xr + c));
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < m) acc[i] = fmaf(qs[i * d + c], xv, acc[i]);
  }
}

// Whether score_tile may read the rows of blocks x as bf16 pairs: d even
// and the rows 4-byte aligned.  f32 blocks ignore it.
template <typename T>
inline int pair_rows(const T* x, int d) {
  return d % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
}

// Shared memory score_tile needs, in floats: query rows, their norms, and
// the [m][lmax] distances.
template <int MT>
inline size_t score_tile_floats(int m, int lmax, int d) {
  return (size_t)m * d + MT + (size_t)m * lmax;
}

// Scores tile t into dist (shared, [m][lmax]); qs ([m][d]) and qq ([MT])
// are shared scratch.  pairs != 0 (bf16 only) reads block rows as bf16
// pairs; it needs d even and 4-byte aligned rows.  Ends with a block
// barrier, after which dist holds the tile's distances.
template <int MT, typename T>
__device__ void score_tile(const T* __restrict__ x, const float* __restrict__ sq,
                           const float* __restrict__ qt, int t, long blk, int len, int m,
                           int lmax, int d, int l2, int pairs, float* qs, float* qq,
                           float* dist) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  const float* qsrc = qt + (size_t)t * m * d;
  for (int i = threadIdx.x; i < m * d; i += blockDim.x) qs[i] = round_to(x, qsrc[i]);
  for (int i = warp; i < m; i += nw) {
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s = fmaf(qsrc[i * d + c], qsrc[i * d + c], s);
    s = warp_sum(s);
    if (lane == 0) qq[i] = s;
  }
  __syncthreads();

  const T* xb = x + (size_t)blk * lmax * d;
  for (int j = warp; j < len; j += nw) {
    float acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[i] = 0.0f;
    row_dots<MT>(xb + (size_t)j * d, qs, m, d, pairs, lane, acc);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < m) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) dist[i * lmax + j] = s;
      }
    }
  }
  __syncthreads();

  const float* sqb = sq + (size_t)blk * lmax;
  for (int idx = threadIdx.x; idx < m * lmax; idx += blockDim.x) {
    const int i = idx / lmax;
    const int j = idx - i * lmax;
    dist[idx] = j < len ? factored_l2(sqb[j], dist[idx], qq[i], l2) : INFINITY;
  }
  __syncthreads();
}

}  // namespace rpt
