// Per-row top-k with duplicate-id masking: the selection tail of the
// grouped serving path.
//
// Replaces the Pallas TPU kernel topk_dedup_kernel
// (rptree_tpu/ops/topk_kernel.py:72).  For each row of d[B, W] / ids[B, W]
// it runs k passes; a pass takes the smallest distance m among the slots
// still in play and the lowest position p holding it, and emits
// (m, ids[p]) while m is finite, (+inf, -1) once the row is exhausted.
// With dedup every slot carrying the winner's id leaves play; without it
// only slot p does.
//
// What bounds it on an H100: bytes.  Each candidate is 8 bytes (distance
// and id) read once; the k passes are work on data already read.  So the
// design reads each row once and keeps it in registers for all k passes
// (the register route, W <= 1024: the serving path's W is probes * lmax,
// 8 x 128 or 10 x 64):
//
// - one warp per row, eight rows per block; each lane loads R distances
//   and R ids (16-byte loads where W % 4 == 0 and the arrays are aligned,
//   so a lane's positions are 4 * (lane + 32 q) + e; else lane + 32 s),
//   R = 4 * ceil(W / 128), a template parameter;
// - each lane caches its own (value, position) minimum and that slot's id;
// - a pass is two warp reductions (redux.sync: the least value, then the
//   least position holding it; -0 counts as +0, as a float compare does),
//   one shuffle for the winner's id from the lane that owns it, and the
//   dedup mask as a compare of that id with each lane's R ids; a slot out
//   of play becomes +inf in its register;
// - only lanes that lost a slot rescan their R registers;
// - winners are kept in registers (lane j % 32 holds pass j) and written
//   coalesced at the end.  No shared memory, no re-read of the row.
//
// Rows wider than the register route take the wide-row kernel: k sweeps
// of the row from L1/L2, the winners in shared memory (at most 128 per
// row), any W.  The caller picks the route by W (ops/topk_kernel.py
// topk_route); both compare (value, position) explicitly.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxK = 128;
constexpr int kMaxRegs = 32;  // the register route's R: W <= 32 * R
constexpr unsigned kFull = 0xffffffffu;

// Row position of slot s of a lane.
template <bool VEC>
__device__ __forceinline__ int slot_pos(int lane, int s) {
  return VEC ? 4 * (lane + 32 * (s >> 2)) + (s & 3) : lane + 32 * s;
}

// A lane's cached minimum of its slots: positions rise with s, so the
// first of equal values wins.  bs = R where every slot is +inf.
template <int R>
__device__ __forceinline__ void rescan(const float (&v)[R], const int (&id)[R], float& bv,
                                       int& bs, int& bid) {
  bv = INFINITY;
  bs = R;
  bid = -1;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (v[s] < bv) {
      bv = v[s];
      bs = s;
      bid = id[s];
    }
  }
}

template <int R, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
topk_regs_kernel(const float* __restrict__ d, const int* __restrict__ ids,
                 float* __restrict__ od, int* __restrict__ oi, long b, int w, int k,
                 int dedup) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= b) return;  // whole warp leaves together; no block barrier below
  const float* dr = d + (size_t)row * w;
  const int* ir = ids + (size_t)row * w;

  float v[R];
  int id[R];
  if (VEC) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int p = 4 * (lane + 32 * q);
      float4 a = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
      int4 c = make_int4(-1, -1, -1, -1);
      if (p < w) {  // w % 4 == 0: all four are in the row
        a = __ldg(reinterpret_cast<const float4*>(dr + p));
        c = __ldg(reinterpret_cast<const int4*>(ir + p));
      }
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
      id[4 * q] = c.x, id[4 * q + 1] = c.y, id[4 * q + 2] = c.z, id[4 * q + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int p = lane + 32 * s;
      v[s] = p < w ? __ldg(dr + p) : INFINITY;
      id[s] = p < w ? __ldg(ir + p) : -1;
    }
  }

  float bv;
  int bs, bid;
  rescan(v, id, bv, bs, bid);

  float rd[kMaxK / 32];
  int ri[kMaxK / 32];
#pragma unroll
  for (int q = 0; q < kMaxK / 32; ++q) rd[q] = INFINITY, ri[q] = -1;
  for (int j = 0; j < k; ++j) {
    const unsigned key = rpt::orderable(bv);
    const unsigned mk = __reduce_min_sync(kFull, key);
    const unsigned mp = __reduce_min_sync(
        kFull, key == mk ? (unsigned)slot_pos<VEC>(lane, bs) : 0xffffffffu);
    const int owner = VEC ? (int)((mp >> 2) & 31) : (int)(mp & 31);
    const float wv = __shfl_sync(kFull, bv, owner);
    if (isinf(wv)) {  // exhausted (+inf), or -inf, which never leaves play
      for (int r = j; r < k; ++r) {
#pragma unroll
        for (int q = 0; q < kMaxK / 32; ++q) {
          if (lane == (r & 31) && q == (r >> 5)) rd[q] = wv;
        }
      }
      break;  // the ids stay -1
    }
    const int wid = __shfl_sync(kFull, bid, owner);
#pragma unroll
    for (int q = 0; q < kMaxK / 32; ++q) {
      if (lane == (j & 31) && q == (j >> 5)) rd[q] = wv, ri[q] = wid;
    }
    bool lost = false;
    if (dedup) {
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (id[s] == wid && v[s] < INFINITY) {
          v[s] = INFINITY;
          lost = true;
        }
      }
    } else if (lane == owner) {
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (s == bs) v[s] = INFINITY;
      }
      lost = true;
    }
    if (lost) rescan(v, id, bv, bs, bid);
  }
#pragma unroll
  for (int q = 0; q < kMaxK / 32; ++q) {
    const int r = 32 * q + lane;
    if (r < k) {
      od[(size_t)row * k + r] = rd[q];
      oi[(size_t)row * k + r] = ri[q];
    }
  }
}

// The wide-row route: k sweeps of the row, winners in shared memory.
__global__ void __launch_bounds__(kWarps * 32)
topk_wide_kernel(const float* __restrict__ d, const int* __restrict__ ids,
                 float* __restrict__ od, int* __restrict__ oi, long b, int w, int k,
                 int dedup) {
  __shared__ int win[kWarps][kMaxK];  // winner ids (dedup) or positions
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long row = (long)blockIdx.x * kWarps + warp;
  if (row >= b) return;  // whole warp leaves together; no block barrier below
  const float* dr = d + (size_t)row * w;
  const int* ir = ids + (size_t)row * w;
  int* wl = win[warp];
  int nwin = 0;
  for (int j = 0; j < k; ++j) {
    float best = INFINITY;
    int bpos = INT_MAX;
    for (int c = lane; c < w; c += 32) {
      const float v = dr[c];
      if (!(v < best)) continue;  // positions rise per lane: first minimum wins
      const int key = dedup ? ir[c] : c;
      bool out = false;
      for (int s = 0; s < nwin; ++s) out |= (wl[s] == key);
      if (!out) {
        best = v;
        bpos = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int op = __shfl_xor_sync(kFull, bpos, off);
      if (ov < best || (ov == best && op < bpos)) {
        best = ov;
        bpos = op;
      }
    }
    const bool live = !isinf(best);
    const int wid = live ? ir[bpos] : -1;
    if (lane == 0) {
      od[(size_t)row * k + j] = best;
      oi[(size_t)row * k + j] = wid;
    }
    if (live) {
      if (lane == 0) wl[nwin] = dedup ? wid : bpos;
      __syncwarp();
      ++nwin;
    }
  }
}

template <int R>
cudaError_t launch_regs(const float* d, const int* ids, float* od, int* oi, long b, int w,
                        int k, int dedup, bool vec, unsigned blocks, cudaStream_t s) {
  if (vec)
    topk_regs_kernel<R, true><<<blocks, kWarps * 32, 0, s>>>(d, ids, od, oi, b, w, k, dedup);
  else
    topk_regs_kernel<R, false><<<blocks, kWarps * 32, 0, s>>>(d, ids, od, oi, b, w, k, dedup);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// regs: the register route's R (a multiple of 4 in [4, 32] with W <= 32 *
// R), or 0 for the wide-row route.  Returns a cudaError_t code: 0 on a good
// launch; cudaErrorInvalidValue for k outside [1, 128], W < 1 or a regs
// that does not cover W.
int rpt_topk_dedup(const float* d, const int* ids, float* od, int* oi, long b, int w, int k,
                   int dedup, int regs, void* stream) {
  if (k < 1 || k > kMaxK || w < 1) return (int)cudaErrorInvalidValue;
  if (regs != 0 && (regs % 4 != 0 || regs > kMaxRegs || w > 32 * regs))
    return (int)cudaErrorInvalidValue;
  if (b <= 0) return 0;
  const unsigned blocks = (unsigned)((b + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = w % 4 == 0 && (reinterpret_cast<uintptr_t>(d) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  switch (regs) {
    case 0:
      topk_wide_kernel<<<blocks, kWarps * 32, 0, s>>>(d, ids, od, oi, b, w, k, dedup);
      return (int)cudaGetLastError();
    case 4: return (int)launch_regs<4>(d, ids, od, oi, b, w, k, dedup, vec, blocks, s);
    case 8: return (int)launch_regs<8>(d, ids, od, oi, b, w, k, dedup, vec, blocks, s);
    case 12: return (int)launch_regs<12>(d, ids, od, oi, b, w, k, dedup, vec, blocks, s);
    case 16: return (int)launch_regs<16>(d, ids, od, oi, b, w, k, dedup, vec, blocks, s);
    case 20: return (int)launch_regs<20>(d, ids, od, oi, b, w, k, dedup, vec, blocks, s);
    case 24: return (int)launch_regs<24>(d, ids, od, oi, b, w, k, dedup, vec, blocks, s);
    case 28: return (int)launch_regs<28>(d, ids, od, oi, b, w, k, dedup, vec, blocks, s);
    default: return (int)launch_regs<32>(d, ids, od, oi, b, w, k, dedup, vec, blocks, s);
  }
}

}  // extern "C"
