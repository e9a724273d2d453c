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
// What bounds it on an H100: bytes, as kernel 1 (csrc/grouped_score.cu):
// one read of the block's occupied rows per tile (64 KB f32, 32 KB bf16
// at lmax 128, D 128) plus its ids, while the output shrinks from lmax to
// kp floats and ids per row.  The design stages the tile's [m][lmax]
// distances in shared memory with kernel 1's own scoring function
// (score_tile, csrc/grouped_tile.cuh: fp32 FMAs for f32 blocks,
// mma.sync for bf16, no cross-lane sum per dot), so the distances are bit-equal to kernel 1's,
// and loads the block's id row into shared memory once per tile.  The
// selection reads each distance row once, into registers of the warp
// that owns the row (E slots a lane, as orderable distance bits, -0 as
// +0), and never sweeps it again:
//
// - kp <= 32 on rows of up to 256 slots (the serving path: kp 16, lmax
//   128) takes passes over the lanes' cached minima, as kernel 3 does: a
//   winner costs two redux.sync (the least distance, then the lowest slot
//   holding it) and a rescan of E registers in the one lane that owned it;
// - wider kp or rows sort 64-bit (distance, slot) keys with a bitonic
//   network (compare-exchanges in registers, shuffles across lanes; 36
//   stages for 256 slots, whatever kp); rows past 256 slots sort 128 new
//   slots at a time into the upper half behind the 128 best so far.
//
// Winners carry the distances' own bits; ties go to the lowest slot.
//
// One thread block per tile, eight warps.

#include "grouped_tile.cuh"

namespace {

constexpr int kThreads = rpt::kTileThreads;
constexpr int kMaxKp = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

// Shared memory in 4-byte words: score_tile's, then the block's id row.
template <int MT, typename T>
size_t topk_words(int m, int lmax, int d) {
  return rpt::score_tile_floats<MT, T>(m, lmax, d) + lmax;
}

// The (distance, slot) key: orderable distance bits above the slot.
__device__ __forceinline__ unsigned long long slot_key(float v, int slot) {
  return ((unsigned long long)rpt::orderable(v) << 32) | (unsigned)slot;
}

// The passes route (kp <= 32, len <= 32 * E): lane l holds slots l * E + e
// as orderable keys and caches its least (ties: its lowest slot).  Pass p
// takes the least key of the warp and the lowest slot holding it by two
// redux.sync; lane p keeps that slot's distance and id, and the lane that
// owns the slot drops it and rescans its E keys.  The row is never swept
// again.  Returns the winners in ascending order, (+inf, -1) past the
// finite distances.
template <int E>
__device__ __forceinline__ void select_passes(const float* row, const int* ids_s, int len,
                                              int kp, int lane, float* odr, int* oir) {
  constexpr unsigned kGone = 0xffffffffu;
  unsigned key[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = lane * E + e;
    key[e] = r < len ? rpt::orderable(row[r]) : kGone;
  }
  unsigned bk = kGone;
  int be = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (key[e] < bk) bk = key[e], be = e;
  }
  const unsigned inf_key = rpt::orderable(INFINITY);
  float wv = INFINITY;
  int wi = -1;
  for (int p = 0; p < kp; ++p) {
    const unsigned mk = __reduce_min_sync(kFull, bk);
    if (mk >= inf_key) break;  // the rest are +inf or past len: (+inf, -1)
    const unsigned ms =
        __reduce_min_sync(kFull, bk == mk ? (unsigned)(lane * E + be) : kGone);
    if (lane == p) wv = row[ms], wi = ids_s[ms];
    if (lane == (int)(ms / E)) {
      bk = kGone;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e == be) key[e] = kGone;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (key[e] < bk) bk = key[e], be = e;
      }
    }
  }
  if (lane < kp) odr[lane] = wv, oir[lane] = wi;
}

// One compare-exchange stage of a bitonic sort of the warp's 32 * E keys
// (key r = lane * E + e): blocks of SIZE, partners STRIDE apart; then the
// stages after it.  Start with bitonic<E, 2, 1> to sort ascending.
template <int E, int SIZE, int STRIDE>
__device__ __forceinline__ void bitonic(unsigned long long (&k)[E], int lane) {
  if constexpr (STRIDE >= E) {  // partner in lane ^ (STRIDE / E), same register
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int r = lane * E + e;
      const unsigned long long o = __shfl_xor_sync(kFull, k[e], STRIDE / E);
      const bool up = (r & SIZE) == 0;
      const bool low = (r & STRIDE) == 0;
      k[e] = (low == up) ? min(k[e], o) : max(k[e], o);
    }
  } else {  // partner in this lane
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e & STRIDE) == 0) {
        const bool up = ((lane * E + e) & SIZE) == 0;
        const unsigned long long a = k[e], b = k[e | STRIDE];
        const bool swap = up ? (a > b) : (a < b);
        k[e] = swap ? b : a;
        k[e | STRIDE] = swap ? a : b;
      }
    }
  }
  if constexpr (STRIDE > 1)
    bitonic<E, SIZE, STRIDE / 2>(k, lane);
  else if constexpr (SIZE < 32 * E)
    bitonic<E, SIZE * 2, SIZE>(k, lane);
}

// The sort route: the row's (distance, slot) keys sorted by a warp
// bitonic network, 32 * E at a time; the first kp written out.
template <int E>
__device__ __forceinline__ void select_sort(const float* row, const int* ids_s, int len, int kp,
                                            int lane, float* odr, int* oir) {
  constexpr int N = 32 * E;
  unsigned long long k[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = lane * E + e;
    k[e] = r < len ? slot_key(row[r], r) : kNoKey;
  }
  bitonic<E, 2, 1>(k, lane);
  for (int base = N; base < len; base += N / 2) {  // kp <= N / 2 here
    if (lane >= 16) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = base + (lane - 16) * E + e;
        k[e] = r < len ? slot_key(row[r], r) : kNoKey;
      }
    }
    bitonic<E, 2, 1>(k, lane);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = lane * E + e;
    if (r < kp) {
      float v = INFINITY;
      int id = -1;
      if (k[e] != kNoKey) {
        const int slot = (int)(unsigned)k[e];
        v = row[slot];
        if (!isinf(v)) id = ids_s[slot];
      }
      odr[r] = v;
      oir[r] = id;
    }
  }
}

template <int MT, int E, bool SORT, typename T>
__global__ void __launch_bounds__(kThreads)
grouped_topk_kernel(const T* __restrict__ x, const float* __restrict__ sq,
                    const int* __restrict__ ids, const int* __restrict__ tb,
                    const int* __restrict__ lens, const float* __restrict__ qt,
                    float* __restrict__ od, int* __restrict__ oi, int g, int m, int lmax, int d,
                    int l2, int vec, int kp) {
  extern __shared__ __align__(16) float smem[];  // score_tile's, then the id row
  const float* dist = rpt::tile_dist<MT, T>(smem, d);
  int* ids_s = reinterpret_cast<int*>(smem + rpt::score_tile_floats<MT, T>(m, lmax, d));
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long blk = min(max(tb[t], 0), g - 1);
  const int len = min(max(lens[t], 0), lmax);

  const int* ib = ids + (size_t)blk * lmax;
  for (int j = threadIdx.x; j < len; j += kThreads) ids_s[j] = ib[j];
  rpt::score_tile<MT>(x, sq, qt, t, blk, len, m, lmax, d, l2, vec, smem);

  for (int i = warp; i < m; i += kThreads / 32) {
    const float* row = dist + (size_t)i * lmax;
    float* odr = od + ((size_t)t * m + i) * kp;
    int* oir = oi + ((size_t)t * m + i) * kp;
    if constexpr (SORT)
      select_sort<E>(row, ids_s, len, kp, lane, odr, oir);
    else
      select_passes<E>(row, ids_s, len, kp, lane, odr, oir);
  }
}

template <int MT, int E, bool SORT, typename T>
cudaError_t launch_topk(const T* x, const float* sq, const int* ids, const int* tb,
                        const int* lens, const float* qt, float* od, int* oi, int nt, int g,
                        int m, int lmax, int d, int l2, int vec, int kp, cudaStream_t stream) {
  const size_t smem = 4 * topk_words<MT, T>(m, lmax, d);
  cudaError_t e = rpt::allow_smem(grouped_topk_kernel<MT, E, SORT, T>, smem);
  if (e != cudaSuccess) return e;
  grouped_topk_kernel<MT, E, SORT, T><<<nt, kThreads, smem, stream>>>(
      x, sq, ids, tb, lens, qt, od, oi, g, m, lmax, d, l2, vec, kp);
  return cudaGetLastError();
}

// The selection route: passes for kp <= 32 on rows of up to 256 slots
// (4 keys a lane up to 128 slots, else 8), else the sort (8 keys a lane).
template <int MT, typename T>
cudaError_t launch_topk_e(const T* x, const float* sq, const int* ids, const int* tb,
                          const int* lens, const float* qt, float* od, int* oi, int nt, int g,
                          int m, int lmax, int d, int l2, int vec, int kp, cudaStream_t s) {
#define RPT_TOPK(E, SORT)                                                                  \
  return launch_topk<MT, E, SORT>(x, sq, ids, tb, lens, qt, od, oi, nt, g, m, lmax, d, l2, \
                                  vec, kp, s)
  if (kp <= 32 && lmax <= 256) {
    if (lmax <= 128) RPT_TOPK(4, false);
    RPT_TOPK(8, false);
  }
  RPT_TOPK(8, true);
#undef RPT_TOPK
}

template <typename T>
int launch_topk_m(const T* x, const float* sq, const int* ids, const int* tb, const int* lens,
                  const float* qt, float* od, int* oi, int nt, int g, int tile_m, int lmax,
                  int d, int l2, int kp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = rpt::vec_rows(x, d);
  if (tile_m < 1 || tile_m > 32 || kp < 1 || kp > kMaxKp || kp > lmax)
    return (int)cudaErrorInvalidValue;
  if (nt <= 0) return 0;
  if (tile_m <= 8)
    return launch_topk_e<8>(x, sq, ids, tb, lens, qt, od, oi, nt, g, tile_m, lmax, d, l2, vec,
                            kp, s);
  if (tile_m <= 16)
    return launch_topk_e<16>(x, sq, ids, tb, lens, qt, od, oi, nt, g, tile_m, lmax, d, l2, vec,
                             kp, s);
  return launch_topk_e<32>(x, sq, ids, tb, lens, qt, od, oi, nt, g, tile_m, lmax, d, l2, vec,
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
