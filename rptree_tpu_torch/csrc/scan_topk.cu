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
// What bounds it on an H100: operations.  A scan of N rows for B queries
// is 2 * B * N * D bf16 operations on 4 * N * D bytes of rows: at serving
// batch (B in the thousands) that is hundreds of operations per byte, above
// the card's balance, so the tensor cores are the floor (1M x 4,096 x 128:
// 1.07 TFLOP, ~1.1 ms at 989 TFLOP/s).  The selection must not cost more
// than the products.  The design:
//
// - The Pallas grid walks data tiles in order on one core; here the query
//   axis and the data axis are both split over thread blocks (128 queries
//   by a range of rows each, enough ranges to fill the 132 SMs twice over).
//   A block streams its range through shared memory 64 rows at a time,
//   rounding the f32 rows to bf16 as it stores them (no bf16 copy of x is
//   ever made), and multiplies with mma.sync m16n8k16 bf16 -> f32: eight
//   warps, each a 32-query by 32-row tile.
// - Each query keeps its k best (partial, index) in shared memory, sorted.
//   The k-th best is a threshold: a warp scans a query's 64 new partials
//   against it with one ballot, and only those below it are inserted (one
//   warp-wide rank count and shift each).  After the first tiles almost
//   every candidate is rejected by the ballot alone.  A candidate that ties
//   the threshold is rejected: rows arrive in index order, so the kept one
//   has the lower index.
// - Each range writes its sorted list; a second small kernel merges the
//   ranges' lists per query by k passes that each take the smallest
//   (partial, index) pair above the previous winner, which is the
//   lower-index tie rule.
//
// As written it uses no asynchronous copies and no wgmma: loads, products
// and selection take turns inside a block, and two blocks per SM overlap
// them.  That is the next step if the scan's time matters.

#include <climits>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 128;        // queries per block
constexpr int BN = 64;         // rows per tile
constexpr int DC = 128;        // D chunk staged in shared memory (elements)
constexpr int SK = DC + 8;     // bf16 row stride in shared memory: conflict-free fragments
constexpr int DS = BN + 4;     // float row stride of the products tile
constexpr int kThreads = 256;  // 8 warps: 4 along queries x 2 along rows
constexpr int kMaxK = 128;
constexpr int kMergeWarps = 8;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo (lower half)
  return *reinterpret_cast<const unsigned*>(&h);
}

// Rows [row0, row0 + nrows) of src ([*, d] f32), columns [dc, dc + kw), to
// dst ([height][SK] bf16); zeros past nrows and past d.  vec: d % 4 == 0
// and src 16-byte aligned.
__device__ void stage_rows(__nv_bfloat16* dst, const float* __restrict__ src, long row0,
                           int nrows, int height, int d, int dc, int kw, int vec) {
  if (vec) {
    const int c4n = kw / 4;
    for (int idx = threadIdx.x; idx < height * c4n; idx += blockDim.x) {
      const int r = idx / c4n;
      const int c = (idx - r * c4n) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nrows && dc + c < d)
        v = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * d + dc + c));
      uint2 w;
      w.x = pack_bf16(v.x, v.y);
      w.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(dst + r * SK + c) = w;
    }
    return;
  }
  const int c2n = kw / 2;
  for (int idx = threadIdx.x; idx < height * c2n; idx += blockDim.x) {
    const int r = idx / c2n;
    const int c = (idx - r * c2n) * 2;
    float lo = 0.f, hi = 0.f;
    if (r < nrows) {
      const float* s = src + (row0 + r) * d + dc + c;
      if (dc + c < d) lo = __ldg(s);
      if (dc + c + 1 < d) hi = __ldg(s + 1);
    }
    *reinterpret_cast<unsigned*>(dst + r * SK + c) = pack_bf16(lo, hi);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Inserts (v, id) into the sorted list (lv, li)[k] of one query if it beats
// the k-th entry; all 32 lanes of the warp call it with the same values.
// The rank is the count of entries before (v, id) in (value, index) order.
__device__ __forceinline__ void insert(float* lv, int* li, int k, float v, int id, int lane) {
  if (!(v < lv[k - 1])) return;
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += (lv[j] < v || (lv[j] == v && li[j] < id));
  const int pos = rpt::warp_sum(cnt);  // < k, since v < lv[k - 1]
  float tv[kMaxK / 32];
  int ti[kMaxK / 32];
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r) {
    const int j = lane + 32 * r;
    if (j > pos && j < k) {
      tv[r] = lv[j - 1];
      ti[r] = li[j - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r) {
    const int j = lane + 32 * r;
    if (j > pos && j < k) {
      lv[j] = tv[r];
      li[j] = ti[r];
    }
  }
  if (lane == 0) {
    lv[pos] = v;
    li[pos] = id;
  }
  __syncwarp();
}

// Block (blockIdx.x, blockIdx.y): queries [128 x, 128 x + 128), rows
// [y * rows_per_split, (y + 1) * rows_per_split) of N.  Writes the range's
// sorted k best to pd / pi [splits][b][k] (+inf, -1 where it has fewer).
__global__ void __launch_bounds__(kThreads, 2)
scan_kernel(const float* __restrict__ x, const float* __restrict__ sq,
            const float* __restrict__ q, float* __restrict__ pd, int* __restrict__ pi, long n,
            int b, int d, int k, int dot, long rows_per_split, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][SK]
  __nv_bfloat16* xs = qs + BQ * SK;                             // [BN][SK]
  float* dt = reinterpret_cast<float*>(xs + BN * SK);           // [BQ][DS] products
  float* sqs = dt + BQ * DS;                                    // [BN] the tile's sq
  float* lv = sqs + BN;                                         // [BQ][k] kept partials
  int* li = reinterpret_cast<int*>(lv + BQ * k);                // [BQ][k] kept indices

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // mma group
  const int tg = lane & 3;   // thread in group
  const int wq = warp >> 1;  // 32-query slab
  const int wn = warp & 1;   // 32-row slab
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, b - q0);
  const long r_begin = (long)blockIdx.y * rows_per_split;
  const long r_end = min(n, r_begin + rows_per_split);

  for (int i = threadIdx.x; i < BQ * k; i += blockDim.x) {
    lv[i] = INFINITY;
    li[i] = -1;
  }
  const int nchunks = (d + DC - 1) / DC;
  if (nchunks == 1) stage_rows(qs, q, q0, nq, BQ, d, 0, (d + 15) / 16 * 16, vec);

  for (long t0 = r_begin; t0 < r_end; t0 += BN) {
    const int rows = (int)min((long)BN, r_end - t0);
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int dc = 0; dc < d; dc += DC) {
      const int kw = (min(d - dc, DC) + 15) / 16 * 16;
      __syncthreads();  // the last tile's readers of xs, qs, dt and sqs are done
      stage_rows(xs, x, t0, rows, BN, d, dc, kw, vec);
      if (nchunks > 1) stage_rows(qs, q, q0, nq, BQ, d, dc, kw, vec);
      if (dc == 0)
        for (int i = threadIdx.x; i < BN; i += blockDim.x)
          sqs[i] = (i < rows && !dot) ? sq[t0 + i] : 0.f;
      __syncthreads();
      for (int k0 = 0; k0 < kw; k0 += 16) {
        unsigned a[2][4], bb[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const __nv_bfloat16* p = qs + (wq * 32 + mi * 16 + g) * SK + k0 + tg * 2;
          a[mi][0] = *reinterpret_cast<const unsigned*>(p);
          a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * SK);
          a[mi][2] = *reinterpret_cast<const unsigned*>(p + 8);
          a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * SK + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* p = xs + (wn * 32 + ni * 8 + g) * SK + k0 + tg * 2;
          bb[ni][0] = *reinterpret_cast<const unsigned*>(p);
          bb[ni][1] = *reinterpret_cast<const unsigned*>(p + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], bb[ni]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int r = wq * 32 + mi * 16 + g;
        const int c = wn * 32 + ni * 8 + tg * 2;
        *reinterpret_cast<float2*>(dt + r * DS + c) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<float2*>(dt + (r + 8) * DS + c) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
    __syncthreads();

    // selection: one warp per query row; lane takes rows lane and lane + 32
    const float s0 = sqs[lane], s1 = sqs[lane + 32];
    for (int qi = warp; qi < nq; qi += kThreads / 32) {
      float* lvq = lv + qi * k;
      int* liq = li + qi * k;
      const float* drow = dt + qi * DS;
      const float thr = lvq[k - 1];
      const float v0 = lane < rows ? __fsub_rn(s0, __fmul_rn(2.0f, drow[lane])) : INFINITY;
      const float v1 =
          lane + 32 < rows ? __fsub_rn(s1, __fmul_rn(2.0f, drow[lane + 32])) : INFINITY;
      unsigned m0 = __ballot_sync(0xffffffffu, v0 < thr);
      unsigned m1 = __ballot_sync(0xffffffffu, v1 < thr);
      while (m0) {
        const int src = __ffs(m0) - 1;
        m0 &= m0 - 1;
        const float v = __shfl_sync(0xffffffffu, v0, src);
        insert(lvq, liq, k, v, (int)(t0 + src), lane);
      }
      while (m1) {
        const int src = __ffs(m1) - 1;
        m1 &= m1 - 1;
        const float v = __shfl_sync(0xffffffffu, v1, src);
        insert(lvq, liq, k, v, (int)(t0 + 32 + src), lane);
      }
    }
  }
  __syncthreads();
  const size_t out0 = ((size_t)blockIdx.y * b + q0) * k;
  for (int i = threadIdx.x; i < nq * k; i += blockDim.x) {
    pd[out0 + i] = lv[i];
    pi[out0 + i] = li[i];
  }
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

}  // namespace

extern "C" {

// Scan then merge.  pd / pi: scratch [splits][b][k]; od / oi: [b][k].
// Returns a cudaError_t code: 0 on good launches; cudaErrorInvalidValue for
// k outside [1, 128], splits < 1, rows_per_split not a positive multiple of
// 64, or N past 2^31 - 1 rows.
int rpt_scan_topk(const float* x, const float* sq, const float* q, float* pd, int* pi,
                  float* od, int* oi, long n, int b, int d, int k, int dot, int splits,
                  long rows_per_split, void* stream) {
  if (k < 1 || k > kMaxK || splits < 1 || d < 1 || rows_per_split < 1 ||
      rows_per_split % BN != 0 || n > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const size_t smem = sizeof(__nv_bfloat16) * (BQ + BN) * SK +
                      sizeof(float) * (BQ * DS + BN) + (sizeof(float) + sizeof(int)) * BQ * k;
  cudaError_t e = rpt::allow_smem(scan_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((b + BQ - 1) / BQ, splits);
  scan_kernel<<<grid, kThreads, smem, s>>>(x, sq, q, pd, pi, n, b, d, k, dot, rows_per_split,
                                           vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<(b + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, s>>>(pd, pi, od, oi,
                                                                               b, k, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
