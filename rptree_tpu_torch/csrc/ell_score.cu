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
// What bounds it on an H100: bytes.  A tile reads its block's occupied
// slots (8 bytes a slot entry: lmax * K * 8 = 32 KB at lmax 128, K 32)
// and, for each of its rows, the query values at the block's columns:
// 2 operations for each 4 bytes, far below the card's balance.  Read one
// 4-byte gather at a time from query rows of 256 KB (V 65,536), those
// values cost a 32-byte sector each from memory that L2 cannot hold where
// a block's documents spread over the vocabulary (~145M gathers on a
// grouped chunk of the bag-of-words cell, whose leaves mix topics: their
// columns span the vocabulary, so the rows over a block's window of
// columns do not fit shared memory).  But the query rows are sparse rows
// made dense: 32 of 65,536 values are not zero, and fmaf(w, +0.0f, acc)
// needs no read.  So a first pass (ell_support_kernel, one read of q)
// writes each row's support, one bit a column for each value whose bits
// are not +0.0, and a tile stages its rows' support in shared memory,
// four rows at a time, by cp.async while it stages its slots: a product
// whose bit is clear takes fmaf(w, 0.0f, acc), the plain step's bits, and
// only a set bit reads q (route 0, "support").  Where a quad of rows'
// support passes the shared memory (V past 81,920 columns, 131,072 at
// m = 1) every product reads q through L2, as a gather (route 1, "l2"),
// and a block keeps only its slots in shared memory.  Each row's sum runs
// over k in order, one fmaf a step, so the bits do not depend on the
// route.  Each thread owns one slot at a time and keeps the rows' sums in
// registers; the staged slots are padded to K + 1 words so that a warp's
// 32 slots hit 32 banks.  Where a tile's staged slots would pass the
// shared-memory budget, they stream through it in chunks of slots.  A
// tile with no row or no occupied slot writes +inf (route 2, "empty").
//
// One thread block per tile, 128 threads.  routes (may be null) counts
// the tiles on each route.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
// staged (col, val) slots a block keeps below the 48 KB default
constexpr int kStageBytes = 44 * 1024;
// a quad of rows' support (m = 1: one row's)
constexpr int kSupportBytes = 40 * 1024;
constexpr int kSupportBytesOne = 16 * 1024;
constexpr int kMaxStageBytes = 227 * 1024;
enum Route { kSupport = 0, kL2 = 1, kEmpty = 2 };

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

// Entries [0, e1) of a block's slots from cb / vb (entry e = slot * k +
// kk): each col clamped into [0, v), and it and its value as a float into
// the staged rows (ks words a slot).  No division in the loop, and
// unrolled so that several loads are in flight.
template <typename T>
__device__ __forceinline__ void stage_slots(const int* cb, const T* vb, int e1, int k, int ks,
                                            int v, int* s_col, float* s_val) {
  const int ds = kThreads / k, dk = kThreads - ds * k;
  int s = threadIdx.x / k, kk = threadIdx.x - s * k;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < e1; idx += kThreads) {
    s_col[s * ks + kk] = min(max(cb[idx], 0), v - 1);
    s_val[s * ks + kk] = as_float(vb[idx]);
    kk += dk, s += ds;
    if (kk >= k) kk -= k, ++s;
  }
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The support of KQ rows (-1: none, zeros) into shared memory, words a row,
// by cp.async (16-byte copies where a row is a whole number of them).
template <int KQ>
__device__ __forceinline__ void stage_support(unsigned* s_bits, const unsigned* bits,
                                              const int (&rows)[KQ], int words) {
#pragma unroll
  for (int rr = 0; rr < KQ; ++rr) {
    const unsigned* src = bits + (size_t)max(rows[rr], 0) * words;
    unsigned* dst = s_bits + rr * words;
    if (words % 4 == 0) {
      for (int w = threadIdx.x * 4; w < words; w += kThreads * 4)
        cp16(dst + w, src + w, rows[rr] >= 0 ? 16 : 0);
    } else {
      for (int w = threadIdx.x; w < words; w += kThreads)
        cp4(dst + w, src + w, rows[rr] >= 0 ? 4 : 0);
    }
  }
}

// bits[row, w] bit i: q[row, 32 w + i] is not +0.0.  One warp a word; where
// v % 32 == 0 (and q is 16-byte aligned), 16-byte loads instead, eight
// lanes a word, several in flight a thread.
__global__ void ell_support_kernel(const float* __restrict__ q, long b, int v, int words,
                                   unsigned* __restrict__ bits) {
  const long w = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= b * words) return;
  const long row = w / words;
  const int c = (int)(w - row * words) * 32 + (threadIdx.x & 31);
  const bool set = c < v && __float_as_uint(q[row * v + c]) != 0u;
  const unsigned word = __ballot_sync(0xffffffffu, set);
  if ((threadIdx.x & 31) == 0) bits[w] = word;
}

__global__ void ell_support_vec_kernel(const float4* __restrict__ q4, long chunks,
                                       unsigned* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * blockDim.x;
#pragma unroll 4
  for (long base = (long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < chunks;
       base += stride) {  // warp-uniform
    const long c = base + lane;
    const bool ok = c < chunks;  // chunks % 8 == 0: a word's lanes agree
    const float4 e = ok ? q4[c] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    unsigned nib = (__float_as_uint(e.x) != 0u) | (__float_as_uint(e.y) != 0u) << 1 |
                   (__float_as_uint(e.z) != 0u) << 2 | (__float_as_uint(e.w) != 0u) << 3;
    nib <<= 4 * (lane & 7);
    nib |= __shfl_xor_sync(0xffffffffu, nib, 1);
    nib |= __shfl_xor_sync(0xffffffffu, nib, 2);
    nib |= __shfl_xor_sync(0xffffffffu, nib, 4);
    if (ok && (lane & 7) == 0) bits[c >> 3] = nib;
  }
}

cudaError_t launch_support(const float* q, long b, int v, unsigned* bits, cudaStream_t stream) {
  const int words = (v + 31) / 32;
  if (v % 32 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    const long chunks = b * (v / 4);
    const long blocks = (chunks + 255) / 256;  // a grid-stride loop: 2,112 fill an H100
    ell_support_vec_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                             stream>>>(reinterpret_cast<const float4*>(q), chunks, bits);
  } else {
    const long warps = b * words;
    ell_support_kernel<<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(q, b, v, words, bits);
  }
  return cudaGetLastError();
}

template <int MT, typename T>
__global__ void __launch_bounds__(kThreads)
ell_score_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                 const float* __restrict__ sq, const int* __restrict__ tb,
                 const int* __restrict__ tp, const int* __restrict__ lens,
                 const float* __restrict__ q, const float* __restrict__ qq,
                 const unsigned* __restrict__ bits, float* __restrict__ out, int g, int m,
                 int lmax, int k, int v, int b, int p, int metric, int chunk,
                 int* __restrict__ routes) {
  // the support first (16-byte aligned; none on the l2 route), then the
  // staged slots
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kQuads = MT == 1 ? 1 : MT / 4;
  constexpr int kQ = MT == 1 ? 1 : 4;  // rows a support pass
  const int ks = k + 1;                // padded row stride of the staged slots
  const int words = (v + 31) / 32;
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem_raw);
  int* s_col = reinterpret_cast<int*>(
      smem_raw + (bits ? (MT == 1 ? kSupportBytesOne : kSupportBytes) : 0));
  float* s_val = reinterpret_cast<float*>(s_col + (size_t)chunk * ks);
  const int t = blockIdx.x;
  const long blk = min(max(tb[t], 0), g - 1);
  const int len = min(max(lens[t], 0), lmax);
  int qr[MT];
  float qn[MT];
  int nq = 0;  // quads of rows up to the last live row
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int pr = r < m ? tp[(size_t)t * m + r] : -1;
    qr[r] = pr >= 0 ? min(pr / p, b - 1) : -1;
    qn[r] = qr[r] >= 0 ? qq[qr[r]] : 0.0f;
    if (qr[r] >= 0) nq = MT == 1 ? 1 : r / 4 + 1;
  }
  float* ob = out + (size_t)t * m * lmax;
  const float inf = __int_as_float(0x7f800000);
  const int route = nq == 0 || len == 0 ? kEmpty : bits ? kSupport : kL2;
  if (routes && threadIdx.x == 0) atomicAdd(routes + route, 1);
  if (route == kEmpty) {
    for (int idx = threadIdx.x; idx < m * lmax; idx += kThreads) ob[idx] = inf;
    return;
  }
  const int* cb = cols + (size_t)blk * lmax * k;
  const T* vb = vals + (size_t)blk * lmax * k;
  const float* sb = sq + (size_t)blk * lmax;
  // the support route makes one pass over the slots for each quad of rows
  // (the first quad's support in flight while the slots are staged); rows
  // past the last live quad are +inf
  const int passes = route == kSupport ? nq : 1;
  if (route == kSupport) {
    int first[kQ];
#pragma unroll
    for (int rr = 0; rr < kQ; ++rr) first[rr] = qr[rr];
    stage_support(s_bits, bits, first, words);
    for (int idx = kQ * nq * lmax + threadIdx.x; idx < m * lmax; idx += kThreads) ob[idx] = inf;
  }
  for (int pass = 0; pass < passes; ++pass) {
    int pq[kQ];  // this pass's rows (the support route)
    float pn[kQ];
#pragma unroll
    for (int rr = 0; rr < kQ; ++rr) pq[rr] = -1, pn[rr] = 0.0f;
    if (route == kSupport) {
#pragma unroll
      for (int r4 = 0; r4 < kQuads; ++r4)
        if (r4 == pass)
#pragma unroll
          for (int rr = 0; rr < kQ; ++rr) pq[rr] = qr[kQ * r4 + rr], pn[rr] = qn[kQ * r4 + rr];
      if (pass > 0) {
        __syncthreads();  // every thread is done with the last support
        stage_support(s_bits, bits, pq, words);
      }
    }
    for (int j0 = 0; j0 < lmax; j0 += chunk) {
      const int staged = max(0, min(chunk, len - j0));
      // chunk 0 stays staged across passes where it holds every slot
      if (pass == 0 || j0 > 0 || len > chunk) {
        if (pass > 0 || j0 > 0) __syncthreads();  // every thread is done with the last chunk
        stage_slots(cb + (size_t)j0 * k, vb + (size_t)j0 * k, staged * k, k, ks, v, s_col,
                    s_val);
      }
      cp_wait_all();
      __syncthreads();
      for (int jj = threadIdx.x; jj < chunk && j0 + jj < lmax; jj += kThreads) {
        const int j = j0 + jj;
        const float sqj = jj < staged ? sb[j] : 0.0f;
        const int* sc = s_col + jj * ks;
        const float* sv = s_val + jj * ks;
        if (route == kSupport) {
          float acc[kQ];
#pragma unroll
          for (int rr = 0; rr < kQ; ++rr) acc[rr] = 0.0f;
          if (jj < staged) {
#pragma unroll 4
            for (int kk = 0; kk < k; ++kk) {
              const int c = sc[kk];
              const float w = sv[kk];
              const unsigned bit = 1u << (c & 31);
#pragma unroll
              for (int rr = 0; rr < kQ; ++rr) {
                const float qv = s_bits[rr * words + (c >> 5)] & bit
                                     ? q[(size_t)pq[rr] * v + c]
                                     : 0.0f;
                acc[rr] = fmaf(w, qv, acc[rr]);
              }
            }
          }
#pragma unroll
          for (int rr = 0; rr < kQ; ++rr) {
            const int r = pass * kQ + rr;
            if (r >= m) break;
            ob[(size_t)r * lmax + j] =
                (pq[rr] < 0 || jj >= staged) ? inf : ell_dist(acc[rr], sqj, pn[rr], metric);
          }
          continue;
        }
        float acc[MT];
#pragma unroll
        for (int r = 0; r < MT; ++r) acc[r] = 0.0f;
        if (jj < staged) {
          // unrolled so that several slots' gathers are in flight at once
#pragma unroll 4
          for (int kk = 0; kk < k; ++kk) {
            const int c = sc[kk];
            const float w = sv[kk];
#pragma unroll
            for (int r = 0; r < MT; ++r)
              if (qr[r] >= 0) acc[r] = fmaf(w, q[(size_t)qr[r] * v + c], acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          if (r >= m) break;
          ob[(size_t)r * lmax + j] =
              (qr[r] < 0 || jj >= staged) ? inf : ell_dist(acc[r], sqj, qn[r], metric);
        }
      }
    }
  }
}

template <int MT, typename T>
cudaError_t launch_m(const int* cols, const T* vals, const float* sq, const int* tb,
                     const int* tp, const int* lens, const float* q, const float* qq,
                     unsigned* bits, float* out, int nt, int g, int m, int lmax, int k, int v,
                     int b, int p, int metric, int* routes, cudaStream_t stream) {
  const size_t slot_bytes = (size_t)(k + 1) * 8;
  const size_t fit = kStageBytes / slot_bytes;
  const int chunk = fit < 1 ? 1 : (fit < (size_t)lmax ? (int)fit : lmax);
  // the rows' support, where a quad of rows' support fits its region
  const size_t region = MT == 1 ? kSupportBytesOne : kSupportBytes;
  const int words = (v + 31) / 32;
  if ((size_t)(MT == 1 ? 1 : 4) * words * sizeof(unsigned) > region) bits = nullptr;
  const size_t smem = (bits ? region : 0) + (size_t)chunk * slot_bytes;
  if (smem > kMaxStageBytes) return cudaErrorInvalidValue;
  cudaError_t e = rpt::allow_smem(ell_score_kernel<MT, T>, smem);
  if (e != cudaSuccess) return e;
  if (bits) {
    e = launch_support(q, b, v, bits, stream);
    if (e != cudaSuccess) return e;
  }
  ell_score_kernel<MT, T><<<nt, kThreads, smem, stream>>>(cols, vals, sq, tb, tp, lens, q, qq,
                                                          bits, out, g, m, lmax, k, v, b, p,
                                                          metric, chunk, routes);
  return cudaGetLastError();
}

template <typename T>
int launch(const int* cols, const T* vals, const float* sq, const int* tb, const int* tp,
           const int* lens, const float* q, const float* qq, unsigned* bits, float* out, int nt,
           int g, int tile_m, int lmax, int k, int v, int b, int p, int metric, int* routes,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt <= 0 || lmax <= 0) return 0;
  if (tile_m < 1 || k < 1 || v < 1 || b < 1 || p < 1 || g < 1 || metric < 0 || metric > 3)
    return (int)cudaErrorInvalidValue;
  if (tile_m == 1)
    return launch_m<1>(cols, vals, sq, tb, tp, lens, q, qq, bits, out, nt, g, 1, lmax, k, v, b,
                       p, metric, routes, s);
  if (tile_m <= 8)
    return launch_m<8>(cols, vals, sq, tb, tp, lens, q, qq, bits, out, nt, g, tile_m, lmax, k,
                       v, b, p, metric, routes, s);
  if (tile_m <= 16)
    return launch_m<16>(cols, vals, sq, tb, tp, lens, q, qq, bits, out, nt, g, tile_m, lmax, k,
                        v, b, p, metric, routes, s);
  if (tile_m <= 32)
    return launch_m<32>(cols, vals, sq, tb, tp, lens, q, qq, bits, out, nt, g, tile_m, lmax, k,
                        v, b, p, metric, routes, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on a good launch; cudaErrorInvalidValue
// for a tile_m outside [1, 32], a metric code outside [0, 3] (sql2, l2,
// cosine, dot) or a K whose one staged slot passes the shared memory.
// bits: scratch of b * ceil(v / 32) words for the rows' support (null: no
// support route).  routes: null, or int32[3] to which each tile adds one
// on its route (0 support, 1 l2, 2 empty).
int rpt_ell_score_f32(const int* cols, const float* vals, const float* sq, const int* tb,
                      const int* tp, const int* lens, const float* q, const float* qq,
                      unsigned* bits, float* out, int nt, int g, int tile_m, int lmax, int k,
                      int v, int b, int p, int metric, int* routes, void* stream) {
  return launch(cols, vals, sq, tb, tp, lens, q, qq, bits, out, nt, g, tile_m, lmax, k, v, b,
                p, metric, routes, stream);
}

// The support alone (as rpt_ell_score_* make it first): bits [b, ceil(v /
// 32)] words, bit i of word w set where q[row, 32 w + i] is not +0.0.
int rpt_ell_support(const float* q, long b, int v, unsigned* bits, void* stream) {
  if (b <= 0) return 0;
  if (v < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_support(q, b, v, bits, static_cast<cudaStream_t>(stream));
}

int rpt_ell_score_bf16(const int* cols, const __nv_bfloat16* vals, const float* sq,
                       const int* tb, const int* tp, const int* lens, const float* q,
                       const float* qq, unsigned* bits, float* out, int nt, int g, int tile_m,
                       int lmax, int k, int v, int b, int p, int metric, int* routes,
                       void* stream) {
  return launch(cols, vals, sq, tb, tp, lens, q, qq, bits, out, nt, g, tile_m, lmax, k, v, b,
                p, metric, routes, stream);
}

}  // extern "C"
