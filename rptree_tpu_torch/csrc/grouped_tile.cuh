// The tile scoring shared by the tile kernels of the grouped rerank:
// grouped_score (kernel 1, csrc/grouped_score.cu) and grouped_topk
// (kernel 4, csrc/grouped_topk.cu).  Both stage a tile's distances with
// score_tile below, so kernel 4's distances are bit-equal to kernel 1's.
// Kernel 2 (int8 blocks, csrc/grouped_score_i8.cu) stages its block rows
// with the same stage_rows and TileShape<int8_t>.
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
// values is exact; |q|^2 comes from the unrounded f32 row.  f32 blocks
// take fp32 FMAs, never TF32: one-pass low-precision products cost the
// clustered cell recall in the JAX package (0.9249 -> 0.860).
//
// What bounds it on an H100: bytes.  A tile reads its block's occupied
// rows once and does 2 * m * len * D operations on them, 4 per f32 byte
// at m = 8, far below the card's balance.  So the work has to stay off
// the issue slots and the shared-memory port.  The design:
//
// - the block's occupied rows stream through shared memory in stages of
//   128 slots x 128 bytes of columns, two stages deep, by 16-byte
//   cp.async copies (plain loads where D * sizeof(T) is not a multiple of
//   16 or the blocks are not 16-byte aligned); a staged row's stride is
//   144 bytes (36 words), so 16-byte reads of eight neighbouring slots,
//   and the mma fragments' 4-byte reads of eight slots x four columns,
//   hit distinct banks;
// - the m query rows sit in shared memory beside them, zero past D;
// - no dot ends in a cross-lane sum: f32 blocks give each thread one slot
//   against half the query rows in registers (a 16-byte shared load feeds
//   4 FMAs a query row); bf16 blocks run mma.sync on the tensor cores, a
//   warp's 16 slots against every query row per 16 x 8 x 16 product;
// - the epilogue (factored L2, the square root, +inf past len) runs on
//   the mma's registers and writes the distances to shared memory once.
//
// Blocks of 256 threads; rows past 128 slots take further stages.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace rpt {

constexpr int kTileThreads = 256;  // score_tile's block: two halves of kSlotTile
constexpr int kSlotTile = 128;     // slots per stage, one per thread of a half
constexpr int kChunkBytes = 128;   // a staged row's bytes per column chunk

template <typename T>
struct TileShape {
  static constexpr int V = 16 / sizeof(T);            // elements per 16 bytes
  static constexpr int DC = kChunkBytes / sizeof(T);  // columns per chunk
  static constexpr int XS = DC + V;                   // staged row stride: 144 bytes
  static constexpr int kStageFloats = kSlotTile * XS * (int)sizeof(T) / 4;
  static constexpr int kStages = 2;  // ring depth (deeper rings cost blocks per SM)
};

__device__ __forceinline__ void tile_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void tile_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void tile_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether score_tile may copy the rows of blocks x in 16-byte pieces: rows
// of a whole number of 16 bytes, blocks 16-byte aligned.
template <typename T>
inline int vec_rows(const T* x, int d) {
  return (d * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// D rounded up to whole column chunks: the query rows' stride.
template <typename T>
__host__ __device__ inline int padded_d(int d) {
  constexpr int dc = TileShape<T>::DC;
  return (d + dc - 1) / dc * dc;
}

// A query row's stride in shared memory, in 4-byte words: f32 columns
// (read as broadcasts), or bf16 column pairs 4 past a multiple of 32, so
// that the mma fragments' reads of eight rows hit distinct banks.
template <typename T>
__host__ __device__ inline int q_stride(int d) {
  return sizeof(T) == 4 ? padded_d<T>(d) : padded_d<T>(d) / 2 + 4;
}

template <int MT, typename T>
__host__ __device__ inline int q_words(int d) {
  return MT * q_stride<T>(d);
}

// Shared memory score_tile needs, in floats: the stages, the query rows,
// their norms, then the [m][lmax] distances (tile_dist).
template <int MT, typename T>
__host__ __device__ inline size_t score_tile_floats(int m, int lmax, int d) {
  using S = TileShape<T>;
  return (size_t)S::kStages * S::kStageFloats + q_words<MT, T>(d) + MT + (size_t)m * lmax;
}

// Where score_tile leaves the distances in its shared memory.
template <int MT, typename T>
__device__ __forceinline__ float* tile_dist(float* smem, int d) {
  using S = TileShape<T>;
  return smem + S::kStages * S::kStageFloats + q_words<MT, T>(d) + MT;
}

// Stages columns [c0, c0 + DC) of slot rows [j0, j0 + rows) of block xb
// (vec: 16-byte cp.async copies; else plain loads), zeros from d to the
// end of its 32-byte mma column step.  NT threads share the copies.
template <typename T, int NT = kTileThreads>
__device__ __forceinline__ void stage_rows(T* xs, const T* __restrict__ xb, int rows, int j0,
                                           int d, int c0, int vec) {
  using S = TileShape<T>;
  constexpr int KS = 32 / sizeof(T);  // columns per mma k-step
  const int w = min(S::DC, d - c0);
  const int wk = (w + KS - 1) / KS * KS;
  if (vec) {  // w is whole 16-byte pieces; at most one more piece is zero
    const int ppr = wk / S::V;
    for (int i = threadIdx.x; i < rows * ppr; i += NT) {
      const int r = i / ppr;
      const int c = (i - r * ppr) * S::V;
      if (c < w)
        tile_cp_async16(xs + r * S::XS + c, xb + (size_t)(j0 + r) * d + c0 + c);
      else
        *reinterpret_cast<uint4*>(xs + r * S::XS + c) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * wk; i += NT) {
      const int r = i / wk;
      const int c = i - r * wk;
      xs[r * S::XS + c] = c < w ? xb[(size_t)(j0 + r) * d + c0 + c] : T(0.0f);
    }
  }
}

// c += a * b on the tensor cores, one 16 x 8 x 16 bf16 tile, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Scores tile t into its shared distances (tile_dist(smem, d), [m][lmax]);
// smem holds score_tile_floats<MT, T>(m, lmax, d) floats.  vec as
// vec_rows(x, d).  Needs blockDim.x == kTileThreads.  Ends with a block
// barrier, after which the distances are complete.
//
// f32 blocks: fp32 FMAs.  Thread t owns slot t % 128 of a stage and half
// of the MT query rows; per 16 bytes of its slot row it makes one shared
// load, MT / 2 broadcast loads of the query rows' matching columns and 4
// FMAs a query row, into four chains a dot (column % 4) added as a tree
// at the end (one chain a dot loses ~1e-4 relative against other orders).
// The tensor cores' tf32 products, even as 3xTF32, measured no faster and
// 7x further from the plain version on the clustered chunk: their fp32
// sums truncate.
//
// bf16 blocks: mma.sync m16n8k16, products exact, fp32 sums.  Warp w owns
// slots [16 w, 16 w + 16) of a stage (the mma's M) against every query row
// (N, MT / 8 tiles of 8); 32 bytes of columns are one k-step.
template <int MT, typename T>
__device__ void score_tile(const T* __restrict__ x, const float* __restrict__ sq,
                           const float* __restrict__ qt, int t, long blk, int len, int m,
                           int lmax, int d, int l2, int vec, float* smem) {
  using S = TileShape<T>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int R = S::kStages;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = padded_d<T>(d);
  const int qs = q_stride<T>(d);
  uint32_t* qw = reinterpret_cast<uint32_t*>(smem + R * S::kStageFloats);  // query rows
  const float* qf = reinterpret_cast<const float*>(qw);
  float* qq = smem + R * S::kStageFloats + q_words<MT, T>(d);  // [MT] squared norms
  float* dist = qq + MT;                                         // [m][lmax]

  // stage s holds columns [kc * DC, kc * DC + DC) of slot tile st, s = st * nk + kc,
  // in ring buffer s % R
  const T* xb = x + (size_t)blk * lmax * d;
  const int nk = dp / S::DC;
  const int nstages = (len + kSlotTile - 1) / kSlotTile * nk;
  auto issue = [&](int s) {
    if (s < nstages) {
      const int st = s / nk;
      stage_rows(reinterpret_cast<T*>(smem + (s % R) * S::kStageFloats), xb,
                 min(kSlotTile, len - st * kSlotTile), st * kSlotTile, d, (s - st * nk) * S::DC,
                 vec);
    }
    tile_cp_commit();  // an empty group past the last stage keeps the count
  };
#pragma unroll
  for (int s = 0; s < R - 1; ++s) issue(s);

  // query rows, zero past d and m: f32 as they are, bf16 rounded to
  // nearest even in column pairs
  const float* qsrc = qt + (size_t)t * m * d;
  for (int i = tid; i < MT * qs; i += kTileThreads) {
    const int r = i / qs;
    if constexpr (F32) {
      const int c = i - r * qs;
      qw[i] = __float_as_uint(r < m && c < d ? qsrc[r * d + c] : 0.0f);
    } else {
      const int c = 2 * (i - r * qs);
      const float v0 = r < m && c < d ? qsrc[r * d + c] : 0.0f;
      const float v1 = r < m && c + 1 < d ? qsrc[r * d + c + 1] : 0.0f;
      const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
      qw[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  for (int i = warp; i < m; i += kTileThreads / 32) {
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s = fmaf(qsrc[i * d + c], qsrc[i * d + c], s);
    s = warp_sum(s);
    if (lane == 0) qq[i] = s;
  }

  const float* sqb = sq + (size_t)blk * lmax;
  // f32: this thread's slot and query rows; bf16: this warp's 16 slots
  constexpr int H = F32 ? MT / 2 : MT / 8;
  const int jj = F32 ? tid % kSlotTile : warp * 16;
  const int q0 = F32 ? tid / kSlotTile * H : 0;
  const int g = lane >> 2;  // the mma fragments' row group
  const int t4 = lane & 3;  // and column pair
  float acc[H][4];
  for (int s = 0; s < nstages; ++s) {
    const int st = s / nk;
    const int kc = s - st * nk;
    issue(s + R - 1);
    tile_cp_wait<R - 1>();  // stage s has landed
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.0f;
    }
    const int j = st * kSlotTile + jj;
    const T* xs = reinterpret_cast<const T*>(smem + (s % R) * S::kStageFloats);
    const int c0 = kc * S::DC;  // the stage's first column
    if constexpr (F32) {
      if (j < len && q0 < m) {
        const float* xr = xs + jj * S::XS;
        const int steps = (min(S::DC, d - c0) + 3) / 4;
#pragma unroll
        for (int u = 0; u < S::DC / 4; ++u) {
          if (u < steps) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * u);
#pragma unroll
            for (int h = 0; h < H; ++h) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qf + (q0 + h) * qs + c0 + 4 * u);
              acc[h][0] = fmaf(qv.x, xv.x, acc[h][0]);
              acc[h][1] = fmaf(qv.y, xv.y, acc[h][1]);
              acc[h][2] = fmaf(qv.z, xv.z, acc[h][2]);
              acc[h][3] = fmaf(qv.w, xv.w, acc[h][3]);
            }
          }
        }
        if (kc == nk - 1) {
          const float sqj = sqb[j];
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int i = q0 + h;
            if (i < m) {
              const float dot = (acc[h][0] + acc[h][1]) + (acc[h][2] + acc[h][3]);
              dist[i * lmax + j] = factored_l2(sqj, dot, qq[i], l2);
            }
          }
        }
      }
    } else if (j < len) {
      constexpr int XW = S::XS / 2;  // staged row stride in words: 36
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs) + (jj + g) * XW + t4;
      const int steps = (min(S::DC, d - c0) + 15) / 16;
#pragma unroll
      for (int u = 0; u < S::DC / 16; ++u) {
        if (u < steps) {
          const uint32_t a[4] = {xw[8 * u], xw[8 * u + 8 * XW], xw[8 * u + 4],
                                 xw[8 * u + 8 * XW + 4]};
#pragma unroll
          for (int n = 0; n < H; ++n) {
            if (n * 8 < m) {
              const uint32_t* qb = qw + (n * 8 + g) * qs + c0 / 2 + 8 * u + t4;
              mma_bf16(acc[n], a, qb[0], qb[4]);
            }
          }
        }
      }
      if (kc == nk - 1) {
        const int ja = j + g;
        const int jb = ja + 8;
        const float sqa = ja < len ? sqb[ja] : 0.0f;
        const float sqc = jb < len ? sqb[jb] : 0.0f;
#pragma unroll
        for (int n = 0; n < H; ++n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = n * 8 + 2 * t4 + h;
            if (i < m) {
              if (ja < len) dist[i * lmax + ja] = factored_l2(sqa, acc[n][h], qq[i], l2);
              if (jb < len) dist[i * lmax + jb] = factored_l2(sqc, acc[n][2 + h], qq[i], l2);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < m * lmax; idx += kTileThreads) {
    if (idx % lmax >= len) dist[idx] = INFINITY;
  }
  __syncthreads();
}

}  // namespace rpt
