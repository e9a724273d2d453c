// Per-row top-k with duplicate-id masking: the selection tail of the
// serving path (kernel 3).
//
// Replaces the Pallas TPU kernel topk_dedup_kernel
// (rptree_tpu/ops/topk_kernel.py:72).  Each row of W candidates yields the
// k least (distance, position) pairs in that order, ties to the lowest
// position, -0 equal to +0 (as a float compare has it), NaN never chosen;
// with dedup a winner's id never returns, so each id gives its least copy;
// (+inf, -1) once the row is exhausted, and (-inf, -1) from a -inf winner
// on (-inf never leaves play).
//
// Two forms of the row's ids, one kernel:
//
// - pairs (the serving path): d[B, P * lmax] is the scorer's output and
//   the ids are read in place from the leaf id table id_leaf[NB, lmax]
//   through the row's pair rows rows[B, P] (position p * lmax + s holds
//   id_leaf[rows[b, p], s], a negative row counting from the end as a
//   tensor index does).  No [B, W] id matrix is formed.
// - ids: a materialized ids[B, W], as kernel 4 and the sharded merges hold
//   them: the same kernel through the identity row map (no rows: P = 1,
//   lmax = W, row b's ids are ids[b, :]).
//
// What bounds it on an H100: bytes, 8 per candidate (distance and id) read
// once, 3.35 TB/s: 2.5 us per 1,000 rows at W 1,024 (the pair rows and the
// winners add 0.1 us).  The k serial passes cost instructions, not bytes:
// over all W slots (the earlier register kernel, ~300 a pass on every
// lane: a compare of the winner's id with all R slots and a rescan of
// them) they held the tail to ~40% of that bound, so they run over a short
// prefix.
//
// The design (one-read route, W <= 2,048, both served widths 1,024 and
// 1,280 among them; topk_route in ops/topk_kernel.py gives R, the
// distances a lane holds):
//
// - one warp a row, eight rows a block.  Each lane loads its R distances
//   into registers (16-byte loads where lmax % 4 == 0 and the tables are
//   aligned: positions 4 * (lane + 32 q) + e; else lane + 32 s) and copies
//   the same positions' ids, in place, into the warp's shared memory by
//   cp.async, which lands while the distances are scanned;
// - a threshold t from the lanes' least distances (the largest of them
//   once the kDrop largest are set aside) splits off C, every slot whose
//   distance is <= t: a prefix of the row's (distance, position) order,
//   at least one slot from each of the other lanes, ~45 of 1,024 where
//   the distances fall in no order;
// - C is compacted (a warp scan of the lanes' counts) into shared memory
//   as (distance, position), up to kCap, and the k passes run over C, at
//   most 4 entries a lane: a pass is two redux.sync, a ballot, a compare of
//   the winner's id with each lane's entries and a rescan of them.  Each id
//   gives its least copy inside the prefix exactly as in the whole row;
// - where C runs dry before k winners and live slots remain, C is marked
//   spent in the registers and the next prefix is taken (its entries whose
//   id already won leave play); where even one lane's minimum leaves more
//   than kCap slots (many equal distances: a tie overflow), the same
//   passes run over the lane's R registers, their ids from shared memory.
//
// On an H100 (700 W) over the cells' own id tables this reads 0.202 device
// ms at 65,536 rows of 1,024 (bound 0.162) and 0.039 at 8,192 of 1,280
// (bound 0.025).
//
// Rows past 2,048 take the wide-row kernel: k sweeps of the row from L1/L2,
// the winners in shared memory (at most 128 a row), any W; it computes each
// id's address from its position.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxK = 128;
constexpr int kMaxRegs = 64;   // the one-read route: W <= 32 * 64
constexpr int kFineRegs = 32;  // R steps by 4 up to here, then by 8
constexpr int kCap = 128;      // the prefix a round compacts
constexpr int kDrop = 8;       // lane minima set aside for the first threshold
constexpr unsigned kFull = 0xffffffffu;

// Row position of slot s of a lane.
template <bool VEC>
__device__ __forceinline__ int slot_pos(int lane, int s) {
  return VEC ? 4 * (lane + 32 * (s >> 2)) + (s & 3) : lane + 32 * s;
}

// The ids of a row: position c of row b is ids[rows[b, c / lmax], c %
// lmax], or ids[b, c] where rows is null (the identity row map: p == 1,
// lmax == W).  magic = ceil(2^32 / lmax) divides a position exactly where
// P * lmax^2 < 2^32 (the one-read route: W <= 2,048).
struct PairIds {
  const int* ids;
  const int* rows;
  long nb;
  int p, lmax;
  unsigned long long magic;

  __device__ __forceinline__ const int* at(long row, int pr, int s) const {
    long r = row;
    if (rows) {
      r = __ldg(rows + row * p + pr);
      if (r < 0) r += nb;
    }
    return ids + r * lmax + s;
  }
  // the one-read route's copies
  __device__ __forceinline__ const int* src(long row, int pos) const {
    const int pr = (int)(((unsigned long long)(unsigned)pos * magic) >> 32);
    return at(row, pr, pos - pr * lmax);
  }
  // the wide-row route, any W
  __device__ __forceinline__ int operator()(long row, int c) const {
    const int pr = c / lmax;
    return __ldg(at(row, pr, c - pr * lmax));
  }
};

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The float whose orderable bits are u (rpt::orderable's inverse).
__device__ __forceinline__ float from_orderable(unsigned u) {
  return __uint_as_float(u & 0x80000000u ? u ^ 0x80000000u : ~u);
}

// The k winners of a row: lane r % 32 holds winner r in rd[r / 32], ri[r /
// 32]; nwin of them are set.  (Arrays and a count apart, not one struct:
// with the count in a struct the kernel ran 6-21% slower on the card.)
constexpr int kWin = kMaxK / 32;

__device__ __forceinline__ void win_put(float (&rd)[kWin], int (&ri)[kWin], int& nwin, int lane,
                                        float v, int id) {
#pragma unroll
  for (int q = 0; q < kWin; ++q) {
    if (lane == (nwin & 31) && q == (nwin >> 5)) rd[q] = v, ri[q] = id;
  }
  ++nwin;
}

// ±inf from winner nwin on; the ids stay -1
__device__ __forceinline__ void win_fill(float (&rd)[kWin], int& nwin, int lane, float v, int k) {
#pragma unroll
  for (int q = 0; q < kWin; ++q) {
    const int r = 32 * q + lane;
    if (r >= nwin && r < k) rd[q] = v;
  }
  nwin = k;
}

// winner r's id, on every lane
__device__ __forceinline__ int win_id(const int (&ri)[kWin], int r) {
  int x = ri[0];
#pragma unroll
  for (int q = 1; q < kWin; ++q) {
    if (q == (r >> 5)) x = ri[q];
  }
  return __shfl_sync(kFull, x, r & 31);
}

// The k passes over a lane's RS entries: sv their distances (+inf: out of
// play), pos(t) and id(t) entry t's row position and id.  Entries whose id
// already won leave play first.  A pass takes the least (distance,
// position) of the warp's entries; with dedup every entry of its id then
// leaves play, else the winner alone.  Returns false where the entries ran
// dry before k winners (and no -inf won).  The prefix's entries hold their
// positions and ids in registers; a tie overflow's are the lane's slots,
// their ids in shared memory.
template <int RS, typename Pos, typename Id>
__device__ __forceinline__ bool passes(float (&sv)[RS], Pos pos, Id id, int lane, int k,
                                       int dedup, float (&rd)[kWin], int (&ri)[kWin],
                                       int& nwin) {
  if (dedup) {
    for (int r = 0; r < nwin; ++r) {
      const int wr = win_id(ri, r);
#pragma unroll
      for (int t = 0; t < RS; ++t) {
        if (sv[t] < INFINITY && id(t) == wr) sv[t] = INFINITY;
      }
    }
  }
  float bv;
  int bp, bid, bt;
  auto best = [&] {  // the lane's least (distance, position)
    bv = INFINITY;
    bp = INT_MAX;
    bid = -1;
    bt = 0;
#pragma unroll
    for (int t = 0; t < RS; ++t) {
      if (sv[t] < bv || (sv[t] == bv && pos(t) < bp)) {
        bv = sv[t];
        bp = pos(t);
        bid = id(t);
        bt = t;
      }
    }
  };
  best();
  while (nwin < k) {
    const unsigned key = rpt::orderable(bv);
    const unsigned mk = __reduce_min_sync(kFull, key);
    const unsigned mp = __reduce_min_sync(kFull, key == mk ? (unsigned)bp : 0xffffffffu);
    const int owner = __ffs(__ballot_sync(kFull, key == mk && (unsigned)bp == mp)) - 1;
    const float wv = __shfl_sync(kFull, bv, owner);
    if (isinf(wv)) {  // exhausted (+inf), or -inf, which never leaves play
      if (wv > 0.0f) return false;
      win_fill(rd, nwin, lane, wv, k);
      return true;
    }
    const int wid = __shfl_sync(kFull, bid, owner);
    win_put(rd, ri, nwin, lane, wv, wid);
    bool lost = false;
    if (dedup) {
#pragma unroll
      for (int t = 0; t < RS; ++t) {
        if (sv[t] < INFINITY && id(t) == wid) {
          sv[t] = INFINITY;
          lost = true;
        }
      }
    } else if (lane == owner) {
#pragma unroll
      for (int t = 0; t < RS; ++t) {
        if (t == bt) sv[t] = INFINITY;
      }
      lost = true;
    }
    if (lost) best();
  }
  return true;
}

// The passes over a compacted prefix of n entries (cv, cp: distance and
// row position; sid: the row's ids by position), RS entries a lane.
template <int RS>
__device__ __forceinline__ bool prefix_passes(const float* cv, const int* cp, const int* sid,
                                              int n, int lane, int k, int dedup, float (&rd)[kWin],
                                              int (&ri)[kWin], int& nwin) {
  float sv[RS];
  int sp[RS], si[RS];
#pragma unroll
  for (int t = 0; t < RS; ++t) {
    const int e = lane + 32 * t;
    sv[t] = INFINITY, sp[t] = INT_MAX, si[t] = -1;
    if (e < n) sv[t] = cv[e], sp[t] = cp[e], si[t] = sid[sp[t]];
  }
  return passes(
      sv, [&](int t) { return sp[t]; }, [&](int t) { return si[t]; }, lane, k, dedup, rd, ri,
      nwin);
}

// The distances of a row's slots into a lane's registers (+inf past W).
template <int R, bool VEC>
__device__ __forceinline__ void load_distances(const float* dr, int w, int lane, float (&v)[R]) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int pos = 4 * (lane + 32 * q);
      float4 a = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
      if (pos < w) a = __ldg(reinterpret_cast<const float4*>(dr + pos));
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int pos = lane + 32 * s;
      v[s] = pos < w ? __ldg(dr + pos) : INFINITY;
    }
  }
}

// The one-read route.  Shared memory a warp: the row's ids by position (32
// * R), then the prefix's distances and positions (kCap each).  The
// distances stay in registers only up to the prefix's compaction: a row
// that needs another prefix (rare) reads them again, from L2.  paths, if
// not null, adds the rows that took a second prefix and the rows whose
// prefix overflowed with equal distances (their passes ran over the
// registers).
template <int R, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
topk_pairs_kernel(const float* __restrict__ d, PairIds t, float* __restrict__ od,
                  int* __restrict__ oi, long b, int k, int dedup,
                  unsigned long long* __restrict__ paths) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long row = (long)blockIdx.x * kWarps + warp;
  if (row >= b) return;  // whole warp leaves together; no block barrier below
  const int w = t.p * t.lmax;
  int* sid = smem + warp * (32 * R + 2 * kCap);
  float* cv = reinterpret_cast<float*>(sid + 32 * R);
  int* cp = sid + 32 * R + kCap;
  const float* dr = d + (size_t)row * w;

  float rd[kWin];
  int ri[kWin], nwin = 0;
#pragma unroll
  for (int q = 0; q < kWin; ++q) rd[q] = INFINITY, ri[q] = -1;
  float lo = -INFINITY;  // from the second prefix on: the spent distances, <= lo
  for (bool first = true;; first = false) {
    float v[R];
    load_distances<R, VEC>(dr, w, lane, v);
    if (first) {  // the ids, in place, into shared memory
#pragma unroll
      for (int q = 0; q < (VEC ? R / 4 : R); ++q) {
        const int pos = VEC ? 4 * (lane + 32 * q) : lane + 32 * q;
        if (pos < w) cp_async(sid + pos, t.src(row, pos), VEC ? 16 : 4);
      }
    } else {
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (v[s] <= lo) v[s] = INFINITY;
      }
    }
    // the lanes' least live distances (NaN never counts)
    float m = INFINITY;
#pragma unroll
    for (int s = 0; s < R; ++s) m = fminf(m, v[s]);
    unsigned key = m < INFINITY ? rpt::orderable(m) : 0u;
    int live = __popc(__ballot_sync(kFull, key != 0u));
    if (live == 0) {  // exhausted; the copies land before the warp leaves
      if (first) cp_async_wait_all();
      win_fill(rd, nwin, lane, INFINITY, k);
      break;
    }
    // the threshold: the largest lane minimum once `drop` are set aside,
    // fewer where the prefix it leaves overflows kCap
    int drop = min(kDrop, live - 1), n, c;
    float tau;
    for (;;) {
      for (int i = 0; i < drop; ++i) {
        const unsigned top = __reduce_max_sync(kFull, key);
        if (lane == __ffs(__ballot_sync(kFull, key == top)) - 1) key = 0u;
      }
      live -= drop;
      tau = from_orderable(__reduce_max_sync(kFull, key));
      c = 0;
#pragma unroll
      for (int s = 0; s < R; ++s) c += v[s] <= tau;
      n = c;  // inclusive scan of the lanes' counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, n, o);
        if (lane >= o) n += x;
      }
      if (__shfl_sync(kFull, n, 31) <= kCap || live == 1) break;
      drop = (live + 1) / 2;
    }
    const int total = __shfl_sync(kFull, n, 31);
    if (first) cp_async_wait_all();
    if (total > kCap) {  // a tie overflow: equal distances past the prefix's room
      __syncwarp();
      if (paths && lane == 0) atomicAdd(paths + 1, 1ull);
      if (!passes(
              v, [&](int s) { return slot_pos<VEC>(lane, s); },
              [&](int s) { return sid[slot_pos<VEC>(lane, s)]; }, lane, k, dedup, rd, ri, nwin))
        win_fill(rd, nwin, lane, INFINITY, k);
      break;
    }
    int off = n - c;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (v[s] <= tau) {
        cv[off] = v[s];
        cp[off] = slot_pos<VEC>(lane, s);
        ++off;
      }
    }
    __syncwarp();
    const bool done =
        total <= 32   ? prefix_passes<1>(cv, cp, sid, total, lane, k, dedup, rd, ri, nwin)
        : total <= 64 ? prefix_passes<2>(cv, cp, sid, total, lane, k, dedup, rd, ri, nwin)
                      : prefix_passes<4>(cv, cp, sid, total, lane, k, dedup, rd, ri, nwin);
    __syncwarp();
    if (done) break;
    // the prefix is spent: its slots leave play, the next one follows
    if (paths && lane == 0 && first) atomicAdd(paths, 1ull);
    lo = tau;
  }
#pragma unroll
  for (int q = 0; q < kWin; ++q) {
    const int r = 32 * q + lane;
    if (r < k) {
      od[(size_t)row * k + r] = rd[q];
      oi[(size_t)row * k + r] = ri[q];
    }
  }
}

// The wide-row route: k sweeps of the row, winners in shared memory.
__global__ void __launch_bounds__(kWarps * 32)
topk_wide_kernel(const float* __restrict__ d, PairIds ids, float* __restrict__ od,
                 int* __restrict__ oi, long b, int w, int k, int dedup) {
  __shared__ int win[kWarps][kMaxK];  // winner ids (dedup) or positions
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long row = (long)blockIdx.x * kWarps + warp;
  if (row >= b) return;  // whole warp leaves together; no block barrier below
  const float* dr = d + (size_t)row * w;
  int* wl = win[warp];
  int nwin = 0;
  for (int j = 0; j < k; ++j) {
    float best = INFINITY;
    int bpos = INT_MAX;
    for (int c = lane; c < w; c += 32) {
      const float v = dr[c];
      if (!(v < best)) continue;  // positions rise per lane: first minimum wins
      const int key = dedup ? ids(row, c) : c;
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
    const int wid = live ? ids(row, bpos) : -1;
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

template <int R, bool VEC>
cudaError_t launch_pairs(const float* d, const PairIds& t, float* od, int* oi, long b, int k,
                         int dedup, unsigned long long* paths, unsigned blocks, cudaStream_t s) {
  const size_t smem = (size_t)kWarps * (32 * R + 2 * kCap) * sizeof(int);
  cudaError_t e = rpt::allow_smem(topk_pairs_kernel<R, VEC>, smem);
  if (e != cudaSuccess) return e;
  topk_pairs_kernel<R, VEC><<<blocks, kWarps * 32, smem, s>>>(d, t, od, oi, b, k, dedup, paths);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// d[b, p * lmax]; ids[nb, lmax] read through rows[b, p], or, with rows
// null, ids[b, lmax] (the ids form: p must be 1).  regs: the one-read
// route's R (a multiple of 4 up to 32, then of 8 up to 64, with W <= 32 *
// R; rows of unaligned or lmax % 4 != 0 tables run at the next of 8, 16,
// 32, 64), or 0 for the wide-row route.  paths: null, or an int64[2] that
// adds the rows that took a second prefix and the rows of a tie overflow.
// Returns a cudaError_t code: 0 on a good launch; cudaErrorInvalidValue
// for k outside [1, 128], W < 1, rows null with p != 1 or a regs that does
// not cover W.
int rpt_topk_pairs(const float* d, const int* ids, const int* rows, long nb, float* od,
                   int* oi, long b, int p, int lmax, int k, int dedup, int regs,
                   unsigned long long* paths, void* stream) {
  const long wl = (long)p * lmax;
  if (k < 1 || k > kMaxK || p < 1 || lmax < 1 || wl > INT_MAX || (!rows && p != 1))
    return (int)cudaErrorInvalidValue;
  const int w = (int)wl;
  if (regs != 0 && (regs % 4 != 0 || regs > kMaxRegs || (regs > kFineRegs && regs % 8 != 0) ||
                    w > 32 * regs))
    return (int)cudaErrorInvalidValue;
  if (b <= 0) return 0;
  const unsigned blocks = (unsigned)((b + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PairIds t{ids, rows, nb, p, lmax, ((1ull << 32) + lmax - 1) / (unsigned)lmax};
  if (regs == 0) {
    topk_wide_kernel<<<blocks, kWarps * 32, 0, s>>>(d, t, od, oi, b, w, k, dedup);
    return (int)cudaGetLastError();
  }
  const bool vec = lmax % 4 == 0 && (reinterpret_cast<uintptr_t>(d) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(ids) & 15) == 0;
  if (!vec) {
    if (regs <= 8) return (int)launch_pairs<8, false>(d, t, od, oi, b, k, dedup, paths, blocks, s);
    if (regs <= 16)
      return (int)launch_pairs<16, false>(d, t, od, oi, b, k, dedup, paths, blocks, s);
    if (regs <= 32)
      return (int)launch_pairs<32, false>(d, t, od, oi, b, k, dedup, paths, blocks, s);
    return (int)launch_pairs<64, false>(d, t, od, oi, b, k, dedup, paths, blocks, s);
  }
  switch (regs) {
#define RPT_PAIRS(R) \
  case R: return (int)launch_pairs<R, true>(d, t, od, oi, b, k, dedup, paths, blocks, s);
    RPT_PAIRS(4) RPT_PAIRS(8) RPT_PAIRS(12) RPT_PAIRS(16) RPT_PAIRS(20) RPT_PAIRS(24)
    RPT_PAIRS(28) RPT_PAIRS(32) RPT_PAIRS(40) RPT_PAIRS(48) RPT_PAIRS(56)
#undef RPT_PAIRS
    default: return (int)launch_pairs<64, true>(d, t, od, oi, b, k, dedup, paths, blocks, s);
  }
}

}  // extern "C"
