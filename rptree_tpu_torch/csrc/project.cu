// Row projections in one fixed order: kernel 11.
//
// Replaces the projection products that the JAX package leaves to XLA at
// HIGHEST precision: the build's (rptree_tpu/ops/build.py:58
// project_dataset, x @ r_l.T) and the query traversal's
// (rptree_tpu/models/forest.py:378, the einsum of the queries with the
// forest's projections).  For rows x[n, D] (row stride ldx) and
// projections r[L, D] it writes, level-major,
//
//   out[l, i] = sum_d x[i, d] * r[l, d].
//
// Why a kernel: the leaves depend on these bits, and a query at a folded
// point's place must reach the leaves the fold placed it in, so the build,
// the fold and every query must sum each projection in the same order.
// cuBLAS picks its kernel by shape, and at some of the served shapes
// (iid 100k, 32,768 queries; the bracket's 32) its build and query
// products differ in the last bits.  Here the order depends on D alone:
// one fmaf a step over d ascending within segments of kSeg columns, and
// the segments' partial sums added in order (a second pass, only where D
// passes kSeg).  Nothing depends on n, L, the tile or the grid, so the
// tile is picked by shape (ops/build.py project_plan) without moving a
// bit.
//
// What bounds it on an H100: operations, at the served widths (2 * L per
// 4 bytes of x; fp32 FMAs on the CUDA cores: tensor cores' TF32 would
// change the bits), bytes for the build's 13 levels.  The design is a
// register-tiled FFMA product: each thread keeps TM rows x TN projections
// of sums in registers, and 4 columns at a time reads TM + TN 16-byte
// words of shared memory (a row's or a projection's 4 columns) for
// 4 * TM * TN FMAs.  Shared memory, beside the FMA pipe, is what such a
// loop runs out of on an H100: an SM serves 128 bytes of it a clock, one
// float to each of 32 threads, against 128 FMAs a clock, so a thread's
// tile needs TM * TN / (TM + TN) near 4 or above (8 x 8 is 4).  At the
// served query widths (L = 80, 88, 104, 128: T 8 x 10, 11, 13, 16 levels)
// a thread keeps 8 rows x L / 8 projections (4.95 at L 104) and a block of
// 128 threads covers 128 rows and all of L, so x is read once; the thread
// counts are compile-time, so a thread's shared-memory offsets are
// immediates.  32-column stages of x and r come in row-major through a
// ring of 16-byte cp.async copies (3 deep; 2 for the build's tile, which
// then fits 5 blocks an SM), rows 36 words apart, so a warp's copies and
// reads hit each bank evenly.  A thread's rows and projections are
// interleaved (ty + i * RT, tx + j * lt), so a warp reads neighbouring
// rows.  Other tiles (ops/build.py project_plan): 8 x 8 for L of 17 to
// 64, 4 x 4 where the row tiles do not fill the card (a per-pair chunk,
// the bracket's 32 queries), 4 x 8 with 32 threads along the rows for at
// most 16 projections (a tree's build, which is bound by bytes).
//
// Grid (row tiles, projection tiles, segments); lt * RT threads a block.

#include "common.cuh"

namespace {

constexpr int kSeg = 1024;         // columns a segment (partial sum)
constexpr int kMaxThreads = 256;

__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) of src (row stride ld), columns [d0, d0 + dn),
// into dst (BK + 4 floats a row); zeros past dn and for rows past nrows.
// vec: 16-byte copies (ld and the base 16-byte aligned), else 4-byte ones.
template <int BK>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long ld, long row0,
                                           int rows, long nrows, int d0, int dn, bool vec,
                                           int tid, int nthr) {
  constexpr int kLd = BK + 4;
  if (vec) {
    for (int idx = tid; idx < rows * (BK / 4); idx += nthr) {
      const int rr = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
      const long row = row0 + rr;
      const int bytes = row < nrows ? 4 * max(0, min(4, dn - c)) : 0;
      cp16(dst + rr * kLd + c, bytes ? src + row * ld + d0 + c : src, bytes);
    }
  } else {
    for (int idx = tid; idx < rows * BK; idx += nthr) {
      const int rr = idx / BK, c = idx - rr * BK;
      const long row = row0 + rr;
      const int bytes = (row < nrows && c < dn) ? 4 : 0;
      cp4(dst + rr * kLd + c, bytes ? src + row * ld + d0 + c : src, bytes);
    }
  }
}

// dn columns of a stage into the sums: sx is the thread's first row (its
// rows xs floats apart), sr its first projection (rs apart).  Each sum
// takes one fmaf a column, in column order.
template <int TM, int TN>
__device__ __forceinline__ void mac(const float* sx, int xs, const float* sr, int rs, int dn,
                                    float (&acc)[TM][TN]) {
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= dn; k += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(sx + i * xs + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(sr + j * rs + k);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
  for (; k < dn; ++k)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(sx[i * xs + k], sr[j * rs + k], acc[i][j]);
}

// RT threads along the rows; LT along the projections, or 0 for lt_arg
// (compile-time counts turn a thread's smem offsets into immediates);
// a ring of S stages of BK columns.
template <int TM, int TN, int BK, int RT, int LT, int S>
__global__ void __launch_bounds__(RT*(LT > 0 ? LT : kMaxThreads / RT))
project_kernel(const float* __restrict__ x, long ldx, const float* __restrict__ r,
               float* __restrict__ out, long n, int l, int d, int lt_arg, int vec_x,
               int vec_r) {
  constexpr int kLd = BK + 4, rt = RT;
  extern __shared__ __align__(16) float smem[];
  const int lt = LT > 0 ? LT : lt_arg;
  const int bm = TM * rt, bl = TN * lt;
  const int nthr = rt * lt, tid = threadIdx.x;
  const int ty = tid % rt, tx = tid / rt;
  const long row0 = (long)blockIdx.x * bm;
  const int l0 = blockIdx.y * bl;
  const int seg = blockIdx.z;
  const int d_lo = seg * kSeg, d_hi = min(d, d_lo + kSeg);
  const int nch = (d_hi - d_lo + BK - 1) / BK;
  const int stage = (bm + bl) * kLd;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  auto load = [&](int c) {
    if (c >= nch) return;
    float* s = smem + (c % S) * stage;
    const int d0 = d_lo + c * BK;
    const int dn = min(BK, d_hi - d0);
    stage_rows<BK>(s, x, ldx, row0, bm, n, d0, dn, vec_x, tid, nthr);
    stage_rows<BK>(s + bm * kLd, r, d, l0, bl, l, d0, dn, vec_r, tid, nthr);
  };
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    load(c);
    cp_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_wait<S - 2>();
    __syncthreads();  // stage c landed; every thread is done with stage c - 1
    load(c + S - 1);
    cp_commit();
    const float* s = smem + (c % S) * stage;
    const float* sx = s + ty * kLd;
    const float* sr = s + (bm + tx) * kLd;
    const int dn = min(BK, d_hi - (d_lo + c * BK));
    if (dn == BK)
      mac<TM, TN>(sx, rt * kLd, sr, lt * kLd, BK, acc);
    else
      mac<TM, TN>(sx, rt * kLd, sr, lt * kLd, dn, acc);
  }
  float* o = out + (size_t)seg * l * n;  // this segment's partial sums
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int ll = l0 + tx + j * lt;
    if (ll >= l) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long row = row0 + ty + (long)i * rt;
      if (row < n) o[(long)ll * n + row] = acc[i][j];
    }
  }
}

// out[i] = ((part[0][i] + part[1][i]) + part[2][i]) + ...
__global__ void sum_segments(const float* __restrict__ part, float* __restrict__ out, long m,
                             int segs) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = part[i];
  for (int k = 1; k < segs; ++k) s = __fadd_rn(s, part[(size_t)k * m + i]);
  out[i] = s;
}

template <int TM, int TN, int BK, int RT, int LT, int S>
cudaError_t launch(const float* x, long ldx, const float* r, float* out, long n, int l, int d,
                   int lt, int segs, cudaStream_t s) {
  constexpr int rt = RT;
  if (lt < 1 || rt * lt > kMaxThreads || (LT > 0 && lt != LT)) return cudaErrorInvalidValue;
  const long row_tiles = (n + TM * rt - 1) / (TM * rt);
  const int l_tiles = (l + TN * lt - 1) / (TN * lt);
  if (row_tiles > 0x7fffffffL || l_tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)S * (TM * rt + TN * lt) * (BK + 4) * sizeof(float);
  cudaError_t e = rpt::allow_smem(project_kernel<TM, TN, BK, RT, LT, S>, smem);
  if (e != cudaSuccess) return e;
  const int vec_x = ldx % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_r = d % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  dim3 grid((unsigned)row_tiles, l_tiles, segs);
  project_kernel<TM, TN, BK, RT, LT, S><<<grid, rt * lt, smem, s>>>(x, ldx, r, out, n, l, d,
                                                                    lt, vec_x, vec_r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Segments of kSeg columns a projection needs: the scratch of
// rpt_project holds that many [L, n] partial sums past the first.
int rpt_project_segments(int d) { return (d + kSeg - 1) / kSeg; }

// x [n, d] with row stride ldx, r [l, d] contiguous, out [l, n]; scratch
// [segs, l, n] floats where segs = rpt_project_segments(d) > 1 (else
// unused).  tile (ops/build.py PROJECT_TILES): (rows, projections) a
// thread and threads along the rows 0 (8, 8) 16, 1 (4, 4) 16, 2 (4, 8) 32,
// 3 (8, 10) 16, 4 (8, 11) 16, 5 (8, 13) 16, 6 (8, 16) 16; lt threads along
// the projections (8 for tiles 3-6).  Returns a cudaError_t code.
int rpt_project(const float* x, long ldx, const float* r, float* out, float* scratch, long n,
                int l, int d, int tile, int lt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || l <= 0) return 0;
  if (d < 1 || ldx < d) return (int)cudaErrorInvalidValue;
  const int segs = rpt_project_segments(d);
  float* dst = segs > 1 ? scratch : out;
  cudaError_t e;
  switch (tile) {
    case 0: e = launch<8, 8, 32, 16, 0, 3>(x, ldx, r, dst, n, l, d, lt, segs, s); break;
    case 1: e = launch<4, 4, 32, 16, 0, 3>(x, ldx, r, dst, n, l, d, lt, segs, s); break;
    case 2: e = launch<4, 8, 32, 32, 0, 2>(x, ldx, r, dst, n, l, d, lt, segs, s); break;
    case 3: e = launch<8, 10, 32, 16, 8, 3>(x, ldx, r, dst, n, l, d, lt, segs, s); break;
    case 4: e = launch<8, 11, 32, 16, 8, 3>(x, ldx, r, dst, n, l, d, lt, segs, s); break;
    case 5: e = launch<8, 13, 32, 16, 8, 3>(x, ldx, r, dst, n, l, d, lt, segs, s); break;
    case 6: e = launch<8, 16, 32, 16, 8, 3>(x, ldx, r, dst, n, l, d, lt, segs, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || segs == 1) return (int)e;
  const long m = (long)l * n;
  sum_segments<<<(unsigned)((m + 255) / 256), 256, 0, s>>>(scratch, out, m, segs);
  return (int)cudaGetLastError();
}

}  // extern "C"
