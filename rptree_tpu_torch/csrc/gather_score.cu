// Fused block gather and dot for the per-pair rerank: kernel 6.
//
// Replaces the Pallas TPU kernel gather_score
// (rptree_tpu/ops/fused_gather.py:62).  For every query b and probe p it
// reads the leaf block x_leaf[rows_sel[b, p]] ([lmax, D], f32 or bf16) and
// writes
//
//   dots[b, p, j] = <x_leaf[rows_sel[b, p], j], q[b]>      j < lmax
//   sqx[b, p, j]  = sq_leaf[rows_sel[b, p], j]
//
// With bf16 blocks the query is rounded to bf16 first (nearest even), as
// the Pallas kernel's q.astype(x_leaf.dtype) does, so every product of two
// bf16 values is exact in fp32; sums are fp32 FMAs, never TF32.  Block
// rows are clamped into [0, G).  Distances, masks and the selection stay in
// plain torch, as they stay in XLA in the JAX package.
//
// What bounds it on an H100: bytes.  A pair reads one block (lmax * D * 4
// bytes in f32, half that in bf16) and does 2 operations per element it
// reads: 0.5 (f32) or 1 (bf16) operation per byte, some forty times below
// the card's fp32 operations-per-byte balance, so the block read from
// device memory is the floor.  The design therefore reads each block
// element once, 16 bytes per thread (a float4, or eight bf16), with
// neighbouring lanes on neighbouring addresses: a row is taken by an
// aligned group of lanes as wide as its 16-byte chunks (the whole warp for
// a D 128 f32 row, half a warp for a D 128 bf16 row, so a warp then takes
// two rows at once), and each group sums its dot with a shuffle reduction
// inside the group.  A warp loads four row groups before it reduces any,
// so it keeps four 16-byte loads per lane in flight.  The query row sits in
// shared memory.  Rows whose 16-byte chunks would not be aligned (D not a
// multiple of the chunk, or an unaligned base) take the same mapping one
// element per lane at a time.
//
// One thread block of eight warps per (query, probe) pair.

#include "grouped_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// V consecutive elements of a row, as floats: one 16-byte load where V is
// the vector width, one element where V is 1.
template <int V>
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(__ldg(p));
  }
}

// acc + <q chunk, v>, in element order; the query chunk is read from
// shared memory 16 bytes at a time where V > 1 (conflict-free).
template <int V>
__device__ __forceinline__ float dot_chunk(const float* qc, const float (&v)[V], float acc) {
  if constexpr (V == 1) {
    return fmaf(qc[0], v[0], acc);
  } else {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 qv = reinterpret_cast<const float4*>(qc)[h];
      acc = fmaf(qv.x, v[4 * h], acc);
      acc = fmaf(qv.y, v[4 * h + 1], acc);
      acc = fmaf(qv.z, v[4 * h + 2], acc);
      acc = fmaf(qv.w, v[4 * h + 3], acc);
    }
    return acc;
  }
}

// gs: lanes per row group (a power of two <= 32); each lane of a group
// takes the row's chunks gs apart.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gather_score_kernel(const T* __restrict__ x, const float* __restrict__ sq,
                    const float* __restrict__ q, const int* __restrict__ sel,
                    float* __restrict__ dots, float* __restrict__ sqx, int p, int g, int lmax,
                    int d, int gs) {
  extern __shared__ __align__(16) float qs[];  // [d] the query row, rounded to the block type
  const long pair = blockIdx.x;  // b * p + probe
  const long b = pair / p;
  const long blk = min(max(sel[pair], 0), g - 1);
  const float* qrow = q + b * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) qs[c] = rpt::round_to(x, qrow[c]);
  const float* sqb = sq + blk * lmax;
  float* so = sqx + pair * lmax;
  for (int j = threadIdx.x; j < lmax; j += blockDim.x) so[j] = sqb[j];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (gs - 1);      // lane within its row group
  const int rpw = 32 / gs;              // rows a warp takes per step
  const int r0 = lane / gs;             // this lane's row within the step
  const int cpr = (d + V - 1) / V;      // chunks per row (V divides d when V > 1)
  const int step = (blockDim.x >> 5) * rpw;  // rows the block takes per step
  const T* xb = x + (size_t)blk * lmax * d;
  float* out = dots + (size_t)pair * lmax;
  for (int base = warp * rpw; base < lmax; base += step * kUnroll) {
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc[u] = 0.0f;
      const int j = base + u * step + r0;
      if (j < lmax) {
        const T* xr = xb + (size_t)j * d;
        for (int c = sub; c < cpr; c += gs) {
          float v[V];
          load_chunk<V>(xr + c * V, v);
          acc[u] = dot_chunk<V>(qs + c * V, v, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float s = acc[u];
      for (int off = gs >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const int j = base + u * step + r0;
      if (sub == 0 && j < lmax) out[j] = s;
    }
  }
}

int pow2_at_least(int v) {
  int r = 1;
  while (r < v) r <<= 1;
  return r;
}

template <typename T, int V>
int launch(const T* x, const float* sq, const float* q, const int* sel, float* dots,
           float* sqx, long pairs, int p, int g, int lmax, int d, cudaStream_t stream) {
  const int cpr = (d + V - 1) / V;
  const int gs = pow2_at_least(cpr) < 32 ? pow2_at_least(cpr) : 32;
  const size_t smem = sizeof(float) * (size_t)d;
  cudaError_t e = rpt::allow_smem(gather_score_kernel<T, V>, smem);
  if (e != cudaSuccess) return (int)e;
  gather_score_kernel<T, V><<<(unsigned)pairs, kThreads, smem, stream>>>(
      x, sq, q, sel, dots, sqx, p, g, lmax, d, gs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const T* x, const float* sq, const float* q, const int* sel, float* dots,
               float* sqx, int b, int p, int g, int lmax, int d, void* stream) {
  if (b < 0 || p < 1 || g < 1 || lmax < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const long pairs = (long)b * p;
  if (pairs == 0) return 0;
  if (pairs > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / sizeof(T);
  if (d % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0)
    return launch<T, V>(x, sq, q, sel, dots, sqx, pairs, p, g, lmax, d, s);
  return launch<T, 1>(x, sq, q, sel, dots, sqx, pairs, p, g, lmax, d, s);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t code: 0 on a good launch; cudaErrorInvalidValue
// for an empty block array, probe axis or row, or more than 2^31 - 1 pairs.
int rpt_gather_score_f32(const float* x, const float* sq, const float* q, const int* sel,
                         float* dots, float* sqx, int b, int p, int g, int lmax, int d,
                         void* stream) {
  return launch_any(x, sq, q, sel, dots, sqx, b, p, g, lmax, d, stream);
}

int rpt_gather_score_bf16(const __nv_bfloat16* x, const float* sq, const float* q,
                          const int* sel, float* dots, float* sqx, int b, int p, int g,
                          int lmax, int d, void* stream) {
  return launch_any(x, sq, q, sel, dots, sqx, b, p, g, lmax, d, stream);
}

}  // extern "C"
