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
// passes kSeg).  Nothing depends on n, L or the grid.
//
// What bounds it on an H100: operations, at the served widths (2 * L per
// 4 bytes of x; fp32 FMAs, no tensor cores, whose TF32 would change the
// bits).  A block stages 128 rows x 32 columns of x and 32 x 16 of r in
// shared memory (x rows padded to 33 words, so each thread reads its own
// row conflict-free; r column-major, so a column's 16 values are four
// 16-byte broadcasts) and each thread keeps its row's 16 sums in
// registers: x is read once per 16 projections (from L2 after the first
// of a row's blocks), r once per block.
//
// One thread block of 128 threads per (128 rows, 16 projections, segment).

#include "common.cuh"

namespace {

constexpr int kRows = 128;  // rows a block, one a thread
constexpr int kL = 16;      // projections a block
constexpr int kD = 32;      // columns a stage
constexpr int kSeg = 1024;  // columns a segment (partial sum)

__global__ void __launch_bounds__(kRows)
project_kernel(const float* __restrict__ x, long ldx, const float* __restrict__ r,
               float* __restrict__ out, long n, int l, int d) {
  __shared__ float sx[kRows][kD + 1];
  __shared__ __align__(16) float sr[kD][kL];  // a column's 16 values together
  const long row0 = (long)blockIdx.x * kRows;
  const int l0 = blockIdx.y * kL;
  const int seg = blockIdx.z;
  const int t = threadIdx.x;
  const int d_lo = seg * kSeg;
  const int d_hi = min(d, d_lo + kSeg);
  float acc[kL];
#pragma unroll
  for (int ll = 0; ll < kL; ++ll) acc[ll] = 0.0f;
  for (int d0 = d_lo; d0 < d_hi; d0 += kD) {
    const int dn = min(kD, d_hi - d0);
    for (int idx = t; idx < kRows * kD; idx += kRows) {
      const int rr = idx / kD, dd = idx - rr * kD;
      const long row = row0 + rr;
      sx[rr][dd] = (row < n && dd < dn) ? x[row * ldx + d0 + dd] : 0.0f;
    }
    for (int idx = t; idx < kL * kD; idx += kRows) {
      const int ll = idx / kD, dd = idx - ll * kD;
      sr[dd][ll] = (l0 + ll < l && dd < dn) ? r[(long)(l0 + ll) * d + d0 + dd] : 0.0f;
    }
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd) {
      const float xv = sx[t][dd];
      const float4* rv = reinterpret_cast<const float4*>(sr[dd]);
#pragma unroll
      for (int v4 = 0; v4 < kL / 4; ++v4) {
        const float4 w = rv[v4];
        acc[4 * v4 + 0] = fmaf(xv, w.x, acc[4 * v4 + 0]);
        acc[4 * v4 + 1] = fmaf(xv, w.y, acc[4 * v4 + 1]);
        acc[4 * v4 + 2] = fmaf(xv, w.z, acc[4 * v4 + 2]);
        acc[4 * v4 + 3] = fmaf(xv, w.w, acc[4 * v4 + 3]);
      }
    }
    __syncthreads();
  }
  const long row = row0 + t;
  if (row >= n) return;
  float* o = out + (size_t)seg * l * n;  // this segment's partial sums
#pragma unroll
  for (int ll = 0; ll < kL; ++ll)
    if (l0 + ll < l) o[(long)(l0 + ll) * n + row] = acc[ll];
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

}  // namespace

extern "C" {

// Segments of kSeg columns a projection needs: the scratch of
// rpt_project holds that many [L, n] partial sums past the first.
int rpt_project_segments(int d) { return (d + kSeg - 1) / kSeg; }

// x [n, d] with row stride ldx, r [l, d] contiguous, out [l, n]; scratch
// [segs, l, n] floats where segs = rpt_project_segments(d) > 1 (else
// unused).  Returns a cudaError_t code.
int rpt_project(const float* x, long ldx, const float* r, float* out, float* scratch, long n,
                int l, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || l <= 0) return 0;
  if (d < 1 || ldx < d) return (int)cudaErrorInvalidValue;
  const int segs = rpt_project_segments(d);
  const long row_blocks = (n + kRows - 1) / kRows;
  if (row_blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)row_blocks, (l + kL - 1) / kL, segs);
  project_kernel<<<grid, kRows, 0, s>>>(x, ldx, r, segs > 1 ? scratch : out, n, l, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || segs == 1) return (int)e;
  const long m = (long)l * n;
  sum_segments<<<(unsigned)((m + 255) / 256), 256, 0, s>>>(scratch, out, m, segs);
  return (int)cudaGetLastError();
}

}  // extern "C"
