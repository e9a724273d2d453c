// Exact k-nearest scan over dense rows with bf16 products: kernel 5.
//
// Replaces the Pallas TPU kernel scan_topk (rptree_tpu/ops/scan.py:102).
// For every query row q[b] it returns the k smallest partial distances
//
//   part[b, n] = sq[n] - 2 * <bf16(x[n]), bf16(q[b])>        (sq = 0 for "dot")
//
// over all n < N, in ascending order, ties to the lower data index, with
// their indices.  Queries and rows are rounded to bf16 (nearest even); each
// product of two bf16 values is exact and the sums are fp32.  |q|^2, the
// clamp and the square root are added outside the kernel (ops/scan.py), as
// the Pallas kernel leaves them to XLA.
//
// What bounds it on an H100: operations.  A scan of N rows for B queries is
// 2 * B * N * D bf16 operations on 2 * N * D bytes of bf16 rows: at serving
// batch (B in the thousands) that is over a thousand operations per byte,
// far above the card's balance (~295), so the tensor cores are the floor
// (100k x 4,096 x 128: 0.105 TFLOP, 0.106 ms at 989 TFLOP/s).  The
// selection and the copies must hide behind the products.  The design:
//
// - The rows arrive as one bf16 copy made per call by the wrapper
//   (ops/scan.py scan_rows, as the JAX package casts x once): D padded with
//   zeros to a multiple of 64 (one 128-byte swizzle atom), N to a multiple
//   of the 128-row tile, padded rows with sq = +inf (kept +inf under "dot",
//   as the JAX kernel keeps its padding mask).  The queries arrive as bf16
//   rows padded the same way.
// - Warp specialisation.  One producer warp keeps a ring of 2-4 stages of
//   [128 rows x 64 D] tiles (16 KB each) in flight with TMA loads
//   (128-byte swizzle) completing on mbarriers.  One or two consumer
//   warpgroups each own 64 queries of the block's query tile, which is
//   resident in shared memory (or, where D is too wide to keep it there,
//   streamed through the ring beside the rows), and multiply each arrived
//   chunk with wgmma m64n128k16 bf16 -> fp32, the sums in registers.  A
//   stage is released as soon as the next chunk's products are issued.
// - Selection where the sums are.  Each thread of a consumer holds 64 sums:
//   two queries by 32 rows.  It forms sq - 2 * sum in registers and keeps
//   the least of each query's 32 (two instructions a sum); one warp vote
//   compares those against the queries' thresholds, the k-th kept partial,
//   cached in registers.  After the first tiles almost no tile passes.  The
//   four threads that share a query (a quad of the accumulator layout) are
//   the only ones that touch its sorted k-list, so the quad inserts the
//   sums at or below the threshold itself, one at a time, its four lanes
//   sharing the rank count and the shift, with no block-wide barrier and no
//   buffer; the insertion applies the exact (value, index) order, so
//   candidates may arrive in any order.  For k <= 16 (every main-path call
//   has k = 10) the list lives in the quad's registers, four entries a
//   lane, and an insertion is a few shuffles; larger k keep it in shared
//   memory.  The thresholds are then reread.  That path is one compact loop
//   over the passing sums, not unrolled per sum, so that its code stays
//   small.  The first tile of a range, where the lists
//   are still empty, takes a bound from its own sums instead of +inf, so
//   it inserts a few sums per query and not all 128.
// - The grid is one wave: query tiles times row ranges, sized to the SMs,
//   with the query tile varying fastest.  The blocks that run at one time
//   are the query tiles of a few row ranges and stream those ranges in
//   step, so each row tile is read from device memory once and from L2 by
//   the other query tiles; the ranges are long (hundreds of tiles at 1M
//   rows), so few pay the warm-up of an empty k-list.
// - Each range writes its sorted list; a second small kernel merges the
//   ranges' lists per query by k passes that each take the smallest
//   (partial, index) pair above the previous winner, which is the
//   lower-index tie rule.
//
// k up to 128 and any D: large k or D take one consumer warpgroup and fewer
// stages, so that the k-lists and the query tile fit in shared memory.

#include <climits>

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BN = 128;                  // rows per tile: the wgmma N
constexpr int DC = 64;                   // D chunk: one 128-byte swizzle atom
constexpr int kRowChunk = BN * DC * 2;   // bytes of one row chunk
constexpr int kMaxK = 128;
constexpr int kMergeWarps = 8;

// Shared-memory layout, the same on the host and the card.  Every tile
// region starts at a multiple of 1024 bytes (the swizzle's period).
struct Layout {
  int nc;        // consumer warpgroups: 64 queries each
  int stages;    // ring depth
  int qstream;   // 1: query chunks travel in the ring beside the rows
  size_t q_off, stage_off, stage_bytes, list_off, bar_off, total;
};

__host__ __device__ inline Layout layout(int nc, int stages, int qstream, int dp, int k) {
  Layout L;
  L.nc = nc;
  L.stages = stages;
  L.qstream = qstream;
  const size_t qchunk = (size_t)64 * nc * DC * 2;
  L.q_off = 0;
  L.stage_off = qstream ? 0 : qchunk * (dp / DC);
  L.stage_bytes = kRowChunk + (qstream ? qchunk : 0);
  L.list_off = L.stage_off + L.stage_bytes * stages;
  L.bar_off = L.list_off + (size_t)64 * nc * k * 8;
  L.total = L.bar_off + 8 * (2 * stages + 1) + 1024;  // + slack to align the base
  return L;
}

// The first layout that fits: two consumer warpgroups before one, deeper
// rings before shallower, a resident query tile before a streamed one.
bool pick_layout(int dp, int k, size_t max_smem, Layout* out) {
  for (int qstream = 0; qstream < 2; ++qstream)
    for (int nc = 2; nc >= 1; --nc)
      for (int stages = 4; stages >= 2; --stages) {
        const Layout L = layout(nc, stages, qstream, dp, k);
        if (L.total <= max_smem) {
          *out = L;
          return true;
        }
      }
  return false;
}

// -- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of the box at (col, row) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile of 64 bf16 per row, 128-byte swizzle:
// 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving register reads and writes of the sums
// across the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= a[64 x 16] * b[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// -- selection -------------------------------------------------------------

// (v, id) before (w, jd) in the (value, index) order.
__device__ __forceinline__ bool before(float v, int id, float w, int jd) {
  return v < w || (v == w && id < jd);
}

// A query's sorted k-list, kept by the four lanes of a quad (qmask) of the
// accumulator layout, lane tq holding entries tq, tq + 4, ...  Both kinds
// take the same calls: every lane of the quad calls insert() with the same
// candidate, every lane of the warp calls kth().

// k <= 16: four entries a lane, in registers; an insertion is a rank count
// and a shift by shuffles inside the quad.
struct RegList {
  static constexpr int kMax = 16;
  float v[4];
  int i[4];

  __device__ __forceinline__ void init(float*, int*, int, int) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      v[s] = INFINITY;
      i[s] = -1;
    }
  }
  // the k-th entry's value
  __device__ __forceinline__ float kth(int k) const {
    const int s = (k - 1) >> 2;
    float kv = v[0];
#pragma unroll
    for (int u = 1; u < 4; ++u) kv = s == u ? v[u] : kv;
    return __shfl_sync(0xffffffffu, kv, (k - 1) & 3, 4);
  }
  __device__ __forceinline__ void insert(int k, float cv, int cid, int tq, unsigned qmask) {
    const int s = (k - 1) >> 2;  // the k-th entry, for the admission test
    float kv = v[0];
    int ki = i[0];
#pragma unroll
    for (int u = 1; u < 4; ++u) {
      kv = s == u ? v[u] : kv;
      ki = s == u ? i[u] : ki;
    }
    kv = __shfl_sync(qmask, kv, (k - 1) & 3, 4);
    ki = __shfl_sync(qmask, ki, (k - 1) & 3, 4);
    if (!before(cv, cid, kv, ki)) return;
    int pos = 0;  // the entries before the candidate
#pragma unroll
    for (int u = 0; u < 4; ++u) pos += (tq + 4 * u < k - 1) && before(v[u], i[u], cv, cid);
    pos += __shfl_xor_sync(qmask, pos, 1, 4);
    pos += __shfl_xor_sync(qmask, pos, 2, 4);
    float pv[4];  // the previous lane's entries: entry e - 1 for this lane's e
    int pi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      pv[u] = __shfl_sync(qmask, v[u], (tq + 3) & 3, 4);
      pi[u] = __shfl_sync(qmask, i[u], (tq + 3) & 3, 4);
    }
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const int e = tq + 4 * u;
      // lane 0's entry e - 1 is lane 3's slot u - 1
      const float prev_v = tq == 0 ? (u > 0 ? pv[u - 1] : 0.f) : pv[u];
      const int prev_i = tq == 0 ? (u > 0 ? pi[u - 1] : 0) : pi[u];
      if (e < k && e > pos) {
        v[u] = prev_v;
        i[u] = prev_i;
      } else if (e == pos) {
        v[u] = cv;
        i[u] = cid;
      }
    }
  }
  __device__ __forceinline__ void store(float* pd, int* pi, int k, int tq) const {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (tq + 4 * u < k) {
        pd[tq + 4 * u] = v[u];
        pi[tq + 4 * u] = i[u];
      }
  }
};

// k up to 128: in shared memory; an insertion counts the rank four entries
// a lane and shifts four entries a round.
struct SmemList {
  static constexpr int kMax = kMaxK;
  float* v;
  int* i;

  __device__ __forceinline__ void init(float* lv, int* li, int k, int tq) {
    v = lv;
    i = li;
    for (int e = tq; e < k; e += 4) {
      v[e] = INFINITY;
      i[e] = -1;
    }
  }
  __device__ __forceinline__ float kth(int k) const { return v[k - 1]; }
  __device__ __forceinline__ void insert(int k, float cv, int cid, int tq, unsigned qmask) {
    if (!before(cv, cid, v[k - 1], i[k - 1])) return;
    int pos = 0;  // the entries before the candidate
    for (int e = tq; e < k - 1; e += 4) pos += before(v[e], i[e], cv, cid);
    pos += __shfl_xor_sync(qmask, pos, 1);
    pos += __shfl_xor_sync(qmask, pos, 2);
    // shift [pos, k - 1) up by one, four entries a round from the top
    for (int top = k - 1; top > pos; top -= 4) {
      const int e = top - tq;
      float tv = 0.f;
      int ti = 0;
      if (e > pos) {
        tv = v[e - 1];
        ti = i[e - 1];
      }
      __syncwarp(qmask);
      if (e > pos) {
        v[e] = tv;
        i[e] = ti;
      }
      __syncwarp(qmask);
    }
    if (tq == 0) {
      v[pos] = cv;
      i[pos] = cid;
    }
    __syncwarp(qmask);
  }
  __device__ __forceinline__ void store(float* pd, int* pi, int k, int tq) const {
    for (int e = tq; e < k; e += 4) {
      pd[e] = v[e];
      pi[e] = i[e];
    }
  }
};

// Block: query tile blockIdx.x % qtiles, row tiles [split * tps, split * tps
// + tps) of the ntiles, split = blockIdx.x / qtiles.  Writes the range's
// sorted k best to pd / pi [splits][b][k] ((+inf, -1) where it has none).
template <int NC, class List>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
scan_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
            const float* __restrict__ sq, float* __restrict__ pd, int* __restrict__ pi, int b,
            int k, int dot, int qtiles, int tps, int ntiles, int dp, int stages, int qstream) {
  constexpr int BQ = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout(NC, stages, qstream, dp, k);
  const int nchunk = dp / DC;
  __nv_bfloat16* qres = reinterpret_cast<__nv_bfloat16*>(smem + L.q_off);
  unsigned char* ring = smem + L.stage_off;
  float* lv = reinterpret_cast<float*>(smem + L.list_off);
  int* li = reinterpret_cast<int*>(lv + BQ * k);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;

  const int qtile = blockIdx.x % qtiles;
  const int split = blockIdx.x / qtiles;
  const int t_begin = split * tps;
  const int t_end = min(ntiles, t_begin + tps);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NC * 4);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NC * 4) {  // the producer warp
    if (lane == 0 && t_end > t_begin) {
      if (!qstream) {
        mbar_expect_tx(qbar, (uint32_t)(nchunk * BQ * DC * 2));
        for (int c = 0; c < nchunk; ++c)
          tma_load(qres + c * BQ * DC, &qmap, c * DC, qtile * BQ, qbar);
      }
      int it = 0;
      for (int t = t_begin; t < t_end; ++t)
        for (int c = 0; c < nchunk; ++c, ++it) {
          const int s = it % stages;
          mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
          unsigned char* st = ring + s * L.stage_bytes;
          mbar_expect_tx(full + s, (uint32_t)L.stage_bytes);
          tma_load(st, &xmap, c * DC, t * BN, full + s);
          if (qstream) tma_load(st + kRowChunk, &qmap, c * DC, qtile * BQ, full + s);
        }
    }
    return;
  }

  // consumers: warpgroup wg, warp wq of it; this thread holds the sums of
  // local queries r0 and r0 + 8 with rows 8 j + 2 tg + {0, 1}, j < 16
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  List l0, l1;  // the k-lists of queries r0 and r0 + 8
  l0.init(lv + r0 * k, li + r0 * k, k, tg);
  l1.init(lv + (r0 + 8) * k, li + (r0 + 8) * k, k, tg);
  __syncwarp();
  float th0 = INFINITY, th1 = INFINITY;
  if (!qstream && t_end > t_begin) mbar_wait(qbar, 0);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int row0 = t * BN;
    float2 sqv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sqv[j] = __ldg(reinterpret_cast<const float2*>(sq + row0 + 8 * j + 2 * tg));
      if (dot) {  // keep the padding's +inf, zero the rest
        sqv[j].x = sqv[j].x == INFINITY ? INFINITY : 0.f;
        sqv[j].y = sqv[j].y == INFINITY ? INFINITY : 0.f;
      }
    }
    for (int c = 0; c < nchunk; ++c, ++it) {
      const int s = it % stages;
      mbar_wait(full + s, (it / stages) & 1);
      const unsigned char* st = ring + s * L.stage_bytes;
      const __nv_bfloat16* a =
          qstream ? reinterpret_cast<const __nv_bfloat16*>(st + kRowChunk) : qres + c * BQ * DC;
      const uint64_t da = smem_desc(a + wg * 64 * DC);
      const uint64_t db = smem_desc(st);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DC / 16; ++kk) wgmma_128(acc, da + 2 * kk, db + 2 * kk, c | kk);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + (it - 1) % stages);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + (it - 1) % stages);

    // acc[i]: query r0 + 8 * ((i >> 1) & 1), row row0 + 8 * (i >> 2) + 2 tg
    // + (i & 1).  The partial distances, in place, and the least of each
    // query's 32:
    // two instructions a sum.  fma(-2, a, s) rounds s - 2 a once, as
    // s - (2 a) does, since 2 a is exact.
    float mn0 = INFINITY, mn1 = INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = fmaf(-2.0f, acc[i], (i & 1) ? sqv[i >> 2].y : sqv[i >> 2].x);
      if ((i >> 1) & 1)
        mn1 = fminf(mn1, acc[i]);
      else
        mn0 = fminf(mn0, acc[i]);
    }
    if (__any_sync(0xffffffffu, mn0 <= th0 || mn1 <= th1)) {
      // While a k-list is not full (its first tile), a bound from this tile
      // stands in for its threshold: each lane's ceil(k / 4)-th smallest
      // distinct sum of the query, the largest over the quad, has k sums of
      // the tile at or below it, so no sum above it can be kept.  It spares
      // the insertion of the tile's other sums.
      float b0 = th0, b1 = th1;
      if (__any_sync(0xffffffffu, th0 == INFINITY || th1 == INFINITY)) {
        float p0 = -INFINITY, p1 = -INFINITY;
        for (int t = 0; t < (k + 3) / 4; ++t) {
          float n0 = INFINITY, n1 = INFINITY;
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            if ((i >> 1) & 1)
              n1 = acc[i] > p1 ? fminf(n1, acc[i]) : n1;
            else
              n0 = acc[i] > p0 ? fminf(n0, acc[i]) : n0;
          }
          p0 = n0;
          p1 = n1;
        }
        p0 = fmaxf(p0, __shfl_xor_sync(0xffffffffu, p0, 1));
        p0 = fmaxf(p0, __shfl_xor_sync(0xffffffffu, p0, 2));
        p1 = fmaxf(p1, __shfl_xor_sync(0xffffffffu, p1, 1));
        p1 = fmaxf(p1, __shfl_xor_sync(0xffffffffu, p1, 2));
        b0 = fminf(b0, p0);
        b1 = fminf(b1, p1);
      }
      // the sums at or below their query's threshold; the insertion
      // applies the exact (value, index) rule
      unsigned long long m = 0;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (acc[i] <= (((i >> 1) & 1) ? b1 : b0)) m |= 1ull << i;
      // each quad inserts its sums one at a time, its four lanes together;
      // a sum leaves the registers by a compile-time select chain (a
      // runtime index would move them to local memory)
      const int qbase = lane & ~3;
      const unsigned qmask = 0xfu << qbase;
      while (__any_sync(0xffffffffu, m != 0)) {
        const unsigned has = (__ballot_sync(0xffffffffu, m != 0) >> qbase) & 0xfu;
        const int src = has ? qbase + __ffs(has) - 1 : lane;
        float v = 0.f;
        unsigned tag = 0;  // the row, and bit 31 for the quad's second query
        if (lane == src && m) {
          const int i = __ffsll((long long)m) - 1;
          m &= m - 1;
#pragma unroll
          for (int j = 0; j < 64; ++j) v = j == i ? acc[j] : v;
          tag = ((unsigned)(i >> 1) & 1u) << 31 |
                (unsigned)(row0 + 8 * (i >> 2) + 2 * tg + (i & 1));
        }
        v = __shfl_sync(0xffffffffu, v, src);
        tag = __shfl_sync(0xffffffffu, tag, src);
        if (has) {
          if (tag >> 31)
            l1.insert(k, v, (int)(tag & 0x7fffffffu), tg, qmask);
          else
            l0.insert(k, v, (int)(tag & 0x7fffffffu), tg, qmask);
        }
      }
      th0 = l0.kth(k);
      th1 = l1.kth(k);
    }
  }

  const int q0 = qtile * BQ + r0;
  const size_t out0 = ((size_t)split * b + q0) * k;
  if (q0 < b) l0.store(pd + out0, pi + out0, k, tg);
  if (q0 + 8 < b) l1.store(pd + out0 + 8 * k, pi + out0 + 8 * k, k, tg);
}

// One warp per query: k passes over the splits' lists, each taking the
// smallest (partial, index) pair above the previous winner.
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const float* __restrict__ pd, const int* __restrict__ pi, float* __restrict__ od,
             int* __restrict__ oi, int b, int k, int splits) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (row >= b) return;  // whole warp leaves together
  float pv = -INFINITY;
  int pid = INT_MIN;
  const int m = splits * k;
  for (int j = 0; j < k; ++j) {
    float best = INFINITY;
    int bid = INT_MAX;
    for (int c = lane; c < m; c += 32) {
      const int s = c / k;
      const size_t off = ((size_t)s * b + row) * k + (c - s * k);
      const int id = pi[off];
      if (id < 0) continue;
      const float v = pd[off];
      const bool after = v > pv || (v == pv && id > pid);
      if (after && (v < best || (v == best && id < bid))) {
        best = v;
        bid = id;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oid = __shfl_xor_sync(0xffffffffu, bid, off);
      if (ov < best || (ov == best && oid < bid)) {
        best = ov;
        bid = oid;
      }
    }
    if (lane == 0) {
      od[row * k + j] = best;
      oi[row * k + j] = bid == INT_MAX ? -1 : bid;
    }
    pv = best;
    pid = bid;
  }
}

// -- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// Tensor map of a row-major bf16 [rows, cols] matrix read in [box_rows, 64]
// boxes with the 128-byte swizzle (rows a multiple of box_rows).
cudaError_t tile_map(CUtensorMap* map, const void* base, long rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)DC, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch's shape: the layout, query tiles, row ranges and tiles per range.
cudaError_t plan(long np, int dp, int b, int k, Layout* L, int* qtiles, int* splits, int* tps) {
  if (k < 1 || k > kMaxK || dp < DC || dp % DC != 0 || np < BN || np % BN != 0 ||
      np > 0x7fffffffL || b < 1)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (!pick_layout(dp, k, (size_t)max_smem, L)) return cudaErrorInvalidValue;
  const int ntiles = (int)(np / BN);
  *qtiles = (b + 64 * L->nc - 1) / (64 * L->nc);
  int s = sms / *qtiles;
  s = s < 1 ? 1 : (s > ntiles ? ntiles : s);
  *tps = (ntiles + s - 1) / s;
  *splits = (ntiles + *tps - 1) / *tps;
  return cudaSuccess;
}

template <int NC, class List>
cudaError_t launch_as(const CUtensorMap& xmap, const CUtensorMap& qmap, const float* sq,
                      float* pd, int* pi, int b, int k, int dot, int qtiles, int splits, int tps,
                      int ntiles, int dp, const Layout& L, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<NC, List>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  scan_kernel<NC, List><<<qtiles * splits, NC * 128 + 32, L.total, s>>>(
      xmap, qmap, sq, pd, pi, b, k, dot, qtiles, tps, ntiles, dp, L.stages, L.qstream);
  return cudaGetLastError();
}

// k-lists in registers where k allows it
template <int NC>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& qmap, const float* sq, float* pd,
                   int* pi, int b, int k, int dot, int qtiles, int splits, int tps, int ntiles,
                   int dp, const Layout& L, cudaStream_t s) {
  if (k <= RegList::kMax)
    return launch_as<NC, RegList>(xmap, qmap, sq, pd, pi, b, k, dot, qtiles, splits, tps,
                                  ntiles, dp, L, s);
  return launch_as<NC, SmemList>(xmap, qmap, sq, pd, pi, b, k, dot, qtiles, splits, tps,
                                 ntiles, dp, L, s);
}

}  // namespace

extern "C" {

// out[0] = queries per block (64 or 128), out[1] = row ranges (the scratch
// lists' first axis), out[2] = row tiles per range.  np rows (a multiple
// of 128), dp columns (a multiple of 64), b queries.  Returns a cudaError_t
// code: cudaErrorInvalidValue for k outside [1, 128] or a shape off its
// multiple.
int rpt_scan_plan(long np, int dp, int b, int k, int* out) {
  Layout L;
  int qtiles, splits, tps;
  const cudaError_t e = plan(np, dp, b, k, &L, &qtiles, &splits, &tps);
  if (e != cudaSuccess) return (int)e;
  out[0] = 64 * L.nc;
  out[1] = splits;
  out[2] = tps;
  return 0;
}

// Scan then merge.  xb: bf16 [np, dp] rows, sq: f32 [np] (+inf past the
// live rows), qb: bf16 [b', dp] queries (b' = b rounded up to the plan's
// queries per block, zeros past b), all contiguous and 16-byte aligned;
// pd / pi: scratch [splits][b][k]; od / oi: [b][k].  splits and tps are
// rpt_scan_plan's.  Returns a cudaError_t code.
int rpt_scan_topk(const __nv_bfloat16* xb, const float* sq, const __nv_bfloat16* qb, float* pd,
                  int* pi, float* od, int* oi, long np, int dp, int b, int k, int dot,
                  int splits, int tps, void* stream) {
  if (b <= 0) return 0;
  Layout L;
  int qtiles, want_splits, want_tps;
  cudaError_t e = plan(np, dp, b, k, &L, &qtiles, &want_splits, &want_tps);
  if (e != cudaSuccess) return (int)e;
  if (splits != want_splits || tps != want_tps) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xb) | reinterpret_cast<uintptr_t>(qb) |
       reinterpret_cast<uintptr_t>(sq)) & 15)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, qmap;
  e = tile_map(&xmap, xb, np, dp, BN);
  if (e == cudaSuccess) e = tile_map(&qmap, qb, (long)qtiles * 64 * L.nc, dp, 64 * L.nc);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (int)(np / BN);
  e = L.nc == 2
          ? launch<2>(xmap, qmap, sq, pd, pi, b, k, dot, qtiles, splits, tps, ntiles, dp, L, s)
          : launch<1>(xmap, qmap, sq, pd, pi, b, k, dot, qtiles, splits, tps, ntiles, dp, L, s);
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<(b + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, s>>>(pd, pi, od, oi,
                                                                               b, k, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
