// Tile scoring fused with a per-slot top-kp: kernel 4 of the grouped
// rerank (impl="kernel_topk").
//
// Replaces the Pallas TPU kernel grouped_score_topk
// (rptree_tpu/ops/grouped_kernel.py:233).  For every tile t (up to tile_m
// (query, probe) pairs probing the same leaf block tb[t]) and slot row i
// it computes kernel 1's distances to the block's slots, then returns the
// row's kp smallest in ascending order, ties to the lowest slot, with the
// point id of each from id_leaf[tb[t]]:
//
//   od[t * m + i, p], oi[t * m + i, p]    p < kp
//
// Slots are taken by INDEX, not by id, so both copies of a duplicated row
// come out.  Where fewer than kp slots are occupied the row pads with
// (+inf, -1).  Exact for the caller's final top-k whenever kp >= k: a
// query's k-th nearest candidate is beaten by fewer than k candidates
// overall, hence within any block that holds it.
//
// What bounds it on an H100: bytes at best, as kernel 1
// (csrc/grouped_score.cu): one block read per tile (64 KB f32, 32 KB bf16
// at lmax 128, D 128) plus its lmax ids, while the output shrinks from
// lmax to kp floats and ids per row (at kp 16: 1 KB per tile instead of
// 4 KB, and no per-element id gather afterwards).  The design stages the
// tile's [m][lmax] distances in shared memory with kernel 1's own scoring
// function (score_tile, csrc/grouped_tile.cuh), so the distances are
// bit-equal to kernel 1's, and loads the block's id row into shared
// memory once per tile.  Then one warp per slot row runs kp passes; a
// pass is a sweep of the row (one slot per lane per step) and a
// warp-shuffle argmin on (distance, slot), the tie rule of kernel 3
// (csrc/topk_dedup.cu); the winner's slot is set to +inf.  The winners are
// staged in shared memory and each tile's [m][kp] outputs are written
// coalesced.  Like kernel 1 it is bound by instruction issue as written;
// the kp serial passes add ~25% to kernel 1's time at the clustered 1M
// cell (PERF.md).
//
// One thread block per tile, eight warps.

#include <climits>

#include "grouped_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKp = 128;

// Shared memory in 4-byte words: score_tile's, the winners, the id row.
template <int MT>
size_t topk_words(int m, int lmax, int d, int kp) {
  return rpt::score_tile_floats<MT>(m, lmax, d) + 2 * (size_t)m * kp + lmax;
}

template <int MT, typename T>
__global__ void __launch_bounds__(kThreads)
grouped_topk_kernel(const T* __restrict__ x, const float* __restrict__ sq,
                    const int* __restrict__ ids, const int* __restrict__ tb,
                    const int* __restrict__ lens, const float* __restrict__ qt,
                    float* __restrict__ od, int* __restrict__ oi, int g, int m, int lmax, int d,
                    int l2, int pairs, int kp) {
  extern __shared__ float smem[];
  float* qs = smem;                                  // [m][d] query rows
  float* qq = qs + m * d;                            // [MT] query squared norms
  float* dist = qq + MT;                             // [m][lmax] distances
  float* wd = dist + m * lmax;                       // [m][kp] winners' distances
  int* wi = reinterpret_cast<int*>(wd + m * kp);     // [m][kp] winners' ids
  int* ids_s = wi + m * kp;                          // [lmax] the block's ids
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long blk = min(max(tb[t], 0), g - 1);
  const int len = min(max(lens[t], 0), lmax);

  const int* ib = ids + (size_t)blk * lmax;
  for (int j = threadIdx.x; j < len; j += blockDim.x) ids_s[j] = ib[j];
  rpt::score_tile<MT>(x, sq, qt, t, blk, len, m, lmax, d, l2, pairs, qs, qq, dist);

  for (int i = warp; i < m; i += nw) {
    float* row = dist + i * lmax;
    for (int p = 0; p < kp; ++p) {
      float best = INFINITY;
      int bpos = INT_MAX;
      for (int c = lane; c < len; c += 32) {  // slots rise per lane: first minimum wins
        const float v = row[c];
        if (v < best) {
          best = v;
          bpos = c;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int op = __shfl_xor_sync(0xffffffffu, bpos, off);
        if (ov < best || (ov == best && op < bpos)) {
          best = ov;
          bpos = op;
        }
      }
      if (isinf(best)) {  // the row is exhausted (the same in every lane)
        for (int r = p + lane; r < kp; r += 32) {
          wd[i * kp + r] = INFINITY;
          wi[i * kp + r] = -1;
        }
        break;
      }
      if (lane == 0) {
        wd[i * kp + p] = best;
        wi[i * kp + p] = ids_s[bpos];
      }
      if ((bpos & 31) == lane) row[bpos] = INFINITY;
      __syncwarp();
    }
  }
  __syncthreads();

  float* odt = od + (size_t)t * m * kp;
  int* oit = oi + (size_t)t * m * kp;
  for (int idx = threadIdx.x; idx < m * kp; idx += blockDim.x) {
    odt[idx] = wd[idx];
    oit[idx] = wi[idx];
  }
}

template <int MT, typename T>
cudaError_t launch_topk(const T* x, const float* sq, const int* ids, const int* tb,
                        const int* lens, const float* qt, float* od, int* oi, int nt, int g,
                        int m, int lmax, int d, int l2, int pairs, int kp,
                        cudaStream_t stream) {
  const size_t smem = 4 * topk_words<MT>(m, lmax, d, kp);
  cudaError_t e = rpt::allow_smem(grouped_topk_kernel<MT, T>, smem);
  if (e != cudaSuccess) return e;
  grouped_topk_kernel<MT, T><<<nt, kThreads, smem, stream>>>(x, sq, ids, tb, lens, qt, od, oi,
                                                             g, m, lmax, d, l2, pairs, kp);
  return cudaGetLastError();
}

template <typename T>
int launch_topk_m(const T* x, const float* sq, const int* ids, const int* tb, const int* lens,
                  const float* qt, float* od, int* oi, int nt, int g, int tile_m, int lmax,
                  int d, int l2, int kp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pairs = rpt::pair_rows(x, d);
  if (tile_m < 1 || tile_m > 32 || kp < 1 || kp > kMaxKp || kp > lmax)
    return (int)cudaErrorInvalidValue;
  if (nt <= 0) return 0;
  if (tile_m <= 8)
    return launch_topk<8>(x, sq, ids, tb, lens, qt, od, oi, nt, g, tile_m, lmax, d, l2, pairs,
                          kp, s);
  if (tile_m <= 16)
    return launch_topk<16>(x, sq, ids, tb, lens, qt, od, oi, nt, g, tile_m, lmax, d, l2, pairs,
                           kp, s);
  return launch_topk<32>(x, sq, ids, tb, lens, qt, od, oi, nt, g, tile_m, lmax, d, l2, pairs,
                         kp, s);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on a good launch; cudaErrorInvalidValue
// for a tile_m outside [1, 32] or a kp outside [1, min(128, lmax)].
int rpt_grouped_topk_f32(const float* x, const float* sq, const int* ids, const int* tb,
                         const int* lens, const float* qt, float* od, int* oi, int nt, int g,
                         int tile_m, int lmax, int d, int l2, int kp, void* stream) {
  return launch_topk_m(x, sq, ids, tb, lens, qt, od, oi, nt, g, tile_m, lmax, d, l2, kp, stream);
}

int rpt_grouped_topk_bf16(const __nv_bfloat16* x, const float* sq, const int* ids,
                          const int* tb, const int* lens, const float* qt, float* od, int* oi,
                          int nt, int g, int tile_m, int lmax, int d, int l2, int kp,
                          void* stream) {
  return launch_topk_m(x, sq, ids, tb, lens, qt, od, oi, nt, g, tile_m, lmax, d, l2, kp, stream);
}

}  // extern "C"
