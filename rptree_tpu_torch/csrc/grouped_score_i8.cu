// Grouped tile scoring of int8 blocks for the query-grouped rerank: kernel 2.
//
// Replaces the Pallas TPU kernel grouped_score_tiles_int8
// (rptree_tpu/ops/grouped_kernel.py:145).  A tile is up to tile_m (query,
// probe) pairs that probe the SAME int8 leaf block; for every tile t and
// slot row i of it the kernel writes
//
//   out[t * m + i, j] = max(sq[b, j] - 2 * dot * (scale[b] * s_i) + |q_i|^2, 0)
//
// (square-rooted for "l2") for j < lens[t], and +inf past the block's
// occupancy, with b = tb[t], q_i the tile's f32 query row, s_i its int8
// scale and dot = <int8(q_i), x[b, j]> an exact integer.  The float order
// is the Pallas kernel's: dots * (block scale * row scale), then the
// factored L2 of the exact stored slot norms and the true f32 |q_i|^2.
//
// The query rows are quantized here, as the JAX package's jitted function
// fuses it beside the pallas_call: per row amax = max |v| (exact in any
// order), s = max(amax, 1e-30) * f32(1 / 127) as one f32 multiply (XLA's
// form of amax / 127), q = clamp(rint(v / s), -127, 127) with an IEEE
// division and rounding half to even, as torch.round does.  So the int8
// rows and their scales are bit-equal to the plain version's
// (ops/grouped_kernel.py _quantize_rows); only |q|^2 sums in another order.
//
// What bounds it on an H100: bytes.  A tile reads its block's occupied
// rows (8 KB at lmax 64, D 128), its m f32 query rows (4 KB at m 8) and
// writes m * lmax distances (2 KB), for 2 * m * len * D operations, ~16 a
// block byte: far below the card's balance.  The design keeps every load
// of a tile in flight at once and many tiles in flight per SM:
//
// - one block of 4 warps per tile, 64 slots a stage (16 a warp, the mma's
//   M), ~10 KB of shared memory at lmax 64, D 128 and at most 40
//   registers a thread, so 12 tiles are resident per SM and each waits out
//   its loads behind the others (64 registers and 8 tiles an SM, or 32
//   and 14, measured slower);
// - first, before the tile's table entries arrive, its f32 query rows are
//   prefetched toward L2, so that the quantization below does not wait out
//   a second trip to device memory;
// - the block's occupied rows stream through shared memory by 16-byte
//   cp.async (score_tile's staging: csrc/grouped_tile.cuh stage_rows,
//   TileShape<int8_t>: 128-byte column chunks, 144-byte staged rows),
//   one stage for lmax <= 64 and D <= 128, else a ring of two; plain loads
//   where D is not a multiple of 16 or the blocks are not 16-byte aligned;
// - while they land, the f32 query rows are read into registers (8 lanes
//   a row, 16-byte loads where D % 4 == 0), quantized and stored as int8
//   rows in shared memory, zero past D and past m;
// - the dots run on the tensor cores, mma.sync m16n8k32 s8 x s8 -> s32:
//   a warp's 16 slots (M) against every query row (N, tiles of 8), 32
//   bytes of columns a k-step; int32 sums are exact;
// - the epilogue runs on the mma's registers and stores each distance
//   once, eight neighbouring slots of four rows a store (whole 32-byte
//   sectors); slots past the occupancy are not scored, only set to +inf.

#include "grouped_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 16 * kWarps;  // slots per stage: one mma M tile a warp
constexpr int kBlocksPerSM = 12;     // resident tiles an SM: caps registers at 40
using Shape = rpt::TileShape<int8_t>;
constexpr int kStageBytes = kSlots * Shape::XS;  // 9,216
constexpr int kXW = Shape::XS / 4;              // staged row stride in words: 36
constexpr int kLPR = 8;  // lanes a query row while it is quantized
constexpr int kQV = 128 / (4 * kLPR);  // 16-byte pieces a lane holds: D <= 128
constexpr float kInv127 = (float)(1.0 / 127.0);

// c += a * b on the tensor cores, one 16 x 8 x 32 int8 tile, int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Columns [c, c + 4) of a query row, zero at and past d (qvec: one 16-byte
// load; the rows are 16-byte aligned and d % 4 == 0).
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int d, int qvec) {
  if (qvec)
    return c < d ? __ldcs(reinterpret_cast<const float4*>(row + c)) : make_float4(0, 0, 0, 0);
  float4 v;
  v.x = c < d ? __ldcs(row + c) : 0.0f;
  v.y = c + 1 < d ? __ldcs(row + c + 1) : 0.0f;
  v.z = c + 2 < d ? __ldcs(row + c + 2) : 0.0f;
  v.w = c + 3 < d ? __ldcs(row + c + 3) : 0.0f;
  return v;
}

__device__ __forceinline__ void absmax_sumsq(const float4 v, float& amax, float& ss) {
  amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  ss = fmaf(v.x, v.x, ss);
  ss = fmaf(v.y, v.y, ss);
  ss = fmaf(v.z, v.z, ss);
  ss = fmaf(v.w, v.w, ss);
}

__device__ __forceinline__ uint32_t quantize1(float v, float s) {
  const int q = min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127);
  return (uint32_t)q & 0xffu;
}

// Four columns quantized and packed as one word, the lowest column in
// the lowest byte (the mma fragments' element order).
__device__ __forceinline__ uint32_t quantize4(const float4 v, float s) {
  return quantize1(v.x, s) | quantize1(v.y, s) << 8 | quantize1(v.z, s) << 16 |
         quantize1(v.w, s) << 24;
}

// Query rows of tile t -> int8 rows qw[MT][qsw] (zero past d and m), with
// qfac[i] = block scale * row scale and qq[i] = |q_i|^2.  kLPR lanes a
// row, each lane four columns of every 4 * kLPR; the first 128 columns stay
// in registers between the two passes, later ones are read again.
template <int MT>
__device__ __forceinline__ void quantize_rows(const float* __restrict__ qt, int t, int m, int d,
                                              int qvec, float sc, uint32_t* qw, int qsw,
                                              float* qfac, float* qq) {
  constexpr int kStep = 4 * kLPR;  // columns a row's lanes cover per step
  const int lr = threadIdx.x % kLPR;
  const int dk = (d + 31) / 32 * 32;
  // warp-uniform: a warp's rows are all below MT or all past it
  for (int i = threadIdx.x / kLPR; i < MT; i += kThreads / kLPR) {
    const bool live = i < m;
    const float* row = qt + ((size_t)t * m + (live ? i : 0)) * d;
    float4 v[kQV];
    float amax = 0.0f, ss = 0.0f;
#pragma unroll
    for (int u = 0; u < kQV; ++u) {
      const int c = 4 * lr + kStep * u;
      v[u] = live ? load4(row, c, d, qvec) : make_float4(0, 0, 0, 0);
      absmax_sumsq(v[u], amax, ss);
    }
    if (live)
      for (int c = 4 * lr + kStep * kQV; c < d; c += kStep)
        absmax_sumsq(load4(row, c, d, qvec), amax, ss);
#pragma unroll
    for (int off = kLPR / 2; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float s = __fmul_rn(fmaxf(amax, 1e-30f), kInv127);
    uint32_t* qrow = qw + i * qsw;
#pragma unroll
    for (int u = 0; u < kQV; ++u) {
      const int c = 4 * lr + kStep * u;
      if (c < dk) qrow[c / 4] = quantize4(v[u], s);
    }
    for (int c = 4 * lr + kStep * kQV; c < dk; c += kStep)
      qrow[c / 4] = quantize4(live ? load4(row, c, d, qvec) : make_float4(0, 0, 0, 0), s);
    if (lr == 0) {
      qfac[i] = __fmul_rn(sc, s);
      qq[i] = ss;
    }
  }
}

// One block per tile.  ring: a ring of two stages (more than one stage
// per tile at this lmax and d), else one.
template <int MT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
grouped_score_i8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sq,
                        const float* __restrict__ scale, const int* __restrict__ tb,
                        const int* __restrict__ lens, const float* __restrict__ qt,
                        float* __restrict__ out, int g, int m, int lmax, int d, int l2, int vec,
                        int qvec, int ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = ring ? 2 : 1;
  const int dk = (d + 31) / 32 * 32;
  const int qsw = dk / 4 + 4;  // a query row's stride in words, 4 past a multiple of 8:
                               // the B fragments' reads of 8 rows x 4 words hit distinct banks
  uint32_t* qw = reinterpret_cast<uint32_t*>(smem + R * kStageBytes);
  float* qfac = reinterpret_cast<float*>(qw + MT * qsw);
  float* qq = qfac + MT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = blockIdx.x;
  {  // the query rows toward L2 now, while the tile's table entries load
    const char* qp = reinterpret_cast<const char*>(qt + (size_t)t * m * d);
    const int lines = (m * d * 4 + 127) / 128;
    for (int l = tid; l < lines; l += kThreads)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(qp + 128 * (size_t)l));
  }
  const long blk = min(max(tb[t], 0), g - 1);
  const int len = min(max(lens[t], 0), lmax);
  const int8_t* xb = x + (size_t)blk * lmax * d;
  float* ot = out + (size_t)t * m * lmax;

  // stage s holds columns [kc * DC, kc * DC + DC) of slot tile st, s = st * nk + kc
  const int nk = (d + Shape::DC - 1) / Shape::DC;
  const int nst = (len + kSlots - 1) / kSlots;  // slot tiles with occupied slots
  const int nstages = nst * nk;
  auto issue = [&](int s) {
    if (s < nstages) {
      const int st = s / nk;
      rpt::stage_rows<int8_t, kThreads>(
          reinterpret_cast<int8_t*>(smem + (s % R) * kStageBytes), xb,
          min(kSlots, len - st * kSlots), st * kSlots, d, (s - st * nk) * Shape::DC, vec);
    }
    rpt::tile_cp_commit();  // an empty group past the last stage keeps the count
  };

  if (nstages > 0) {
    issue(0);
    quantize_rows<MT>(qt, t, m, d, qvec, scale[blk], qw, qsw, qfac, qq);
  }

  const float* sqb = sq + (size_t)blk * lmax;
  const int gq = lane >> 2;  // the mma fragments' row group
  const int t4 = lane & 3;   // and column group
  int acc[MT / 8][4];
  for (int s = 0; s < nstages; ++s) {
    const int st = s / nk;
    const int kc = s - st * nk;
    if (ring) {
      issue(s + 1);
      rpt::tile_cp_wait<1>();
    } else {
      rpt::tile_cp_wait<0>();
    }
    __syncthreads();  // stage s, and the query rows, are in shared memory
    if (kc == 0) {
#pragma unroll
      for (int n = 0; n < MT / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
    }
    const int jw = st * kSlots + warp * 16;  // this warp's first slot
    if (jw < len) {
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(smem + (s % R) * kStageBytes) +
                           (warp * 16 + gq) * kXW + t4;
      const int c0 = kc * Shape::DC;
      const int steps = (min(Shape::DC, d - c0) + 31) / 32;
#pragma unroll
      for (int u = 0; u < Shape::DC / 32; ++u) {
        if (u < steps) {
          const uint32_t a[4] = {xw[8 * u], xw[8 * u + 8 * kXW], xw[8 * u + 4],
                                 xw[8 * u + 8 * kXW + 4]};
#pragma unroll
          for (int n = 0; n < MT / 8; ++n) {
            if (n * 8 < m) {
              const uint32_t* qb = qw + (n * 8 + gq) * qsw + c0 / 4 + 8 * u + t4;
              mma_s8(acc[n], a, qb[0], qb[4]);
            }
          }
        }
      }
    }
    if (kc == nk - 1) {  // the slot tile's distances, from the mma's registers
      const int ja = jw + gq;
      const int jb = ja + 8;
      const float sqa = ja < len ? sqb[ja] : 0.0f;
      const float sqc = jb < len ? sqb[jb] : 0.0f;
#pragma unroll
      for (int n = 0; n < MT / 8; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = n * 8 + 2 * t4 + h;
          if (i < m) {
            float* o = ot + (size_t)i * lmax;
            if (ja < lmax)
              o[ja] = ja < len ? rpt::factored_l2(sqa, __fmul_rn((float)acc[n][h], qfac[i]),
                                                  qq[i], l2)
                               : INFINITY;
            if (jb < lmax)
              o[jb] = jb < len ? rpt::factored_l2(sqc, __fmul_rn((float)acc[n][2 + h], qfac[i]),
                                                  qq[i], l2)
                               : INFINITY;
          }
        }
      }
    }
    __syncthreads();  // before stage s's buffer is filled again
  }
  // slot tiles with no occupied slot: +inf
  const int j0 = nst * kSlots;
  const int w = lmax - j0;
  for (int idx = tid; idx < m * w; idx += kThreads) {
    const int i = idx / w;
    ot[(size_t)i * lmax + j0 + (idx - i * w)] = INFINITY;
  }
}

template <int MT>
cudaError_t launch(const int8_t* x, const float* sq, const float* scale, const int* tb,
                   const int* lens, const float* qt, float* out, int nt, int g, int m, int lmax,
                   int d, int l2, cudaStream_t stream) {
  const int vec = rpt::vec_rows(x, d);
  const int qvec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(qt) & 15) == 0;
  const int nk = (d + Shape::DC - 1) / Shape::DC;
  const int ring = (lmax + kSlots - 1) / kSlots * nk > 1;
  const int dk = (d + 31) / 32 * 32;
  const size_t smem = (size_t)(ring ? 2 : 1) * kStageBytes +
                      sizeof(uint32_t) * MT * (size_t)(dk / 4 + 4) + sizeof(float) * 2 * MT;
  cudaError_t e = rpt::allow_smem(grouped_score_i8_kernel<MT>, smem);
  if (e != cudaSuccess) return e;
  grouped_score_i8_kernel<MT><<<nt, kThreads, smem, stream>>>(
      x, sq, scale, tb, lens, qt, out, g, m, lmax, d, l2, vec, qvec, ring);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a good launch; cudaErrorInvalidValue
// for a tile_m outside [1, 32].
int rpt_grouped_score_i8(const int8_t* x, const float* sq, const float* scale, const int* tb,
                         const int* lens, const float* qt, float* out, int nt, int g, int tile_m,
                         int lmax, int d, int l2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt <= 0) return 0;
  if (tile_m < 1) return (int)cudaErrorInvalidValue;
  if (tile_m <= 8)
    return launch<8>(x, sq, scale, tb, lens, qt, out, nt, g, tile_m, lmax, d, l2, s);
  if (tile_m <= 16)
    return launch<16>(x, sq, scale, tb, lens, qt, out, nt, g, tile_m, lmax, d, l2, s);
  if (tile_m <= 32)
    return launch<32>(x, sq, scale, tb, lens, qt, out, nt, g, tile_m, lmax, d, l2, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
