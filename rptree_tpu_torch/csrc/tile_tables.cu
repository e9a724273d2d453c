// Tile tables of the grouped serving path: kernel 9.
//
// Replaces the stage that both packages compute outside any kernel,
// rptree_tpu/ops/grouped.py:66 _tile_tables (a stable sort of the
// chunk's (query, probe) pairs by block, then cummax and cumsum scans that
// cut each block's run into tiles of at most tile_m pairs; XLA runs it in
// the JAX package).  Its outputs are the plain form's bit for bit:
//
//   tb[nt]          block of each tile (0 past the tiles needed),
//   tp[nt, tile_m]  pair of each tile slot (-1 for an empty slot),
//   needed          the tiles the pairs need (a device scalar),
//   slot[B * P]     each pair's flat tile slot tile * tile_m + row
//                   (nt * tile_m for a masked or overflowing pair),
//   lens_t[nt]      the occupancy of each tile's block, lens[tb].
//
// tally, where given (a profiler's count site, ops/grouped.py), is an
// int64[2] to which the call adds its valid pairs and its tiles needed
// past nt, max(0, needed - nt).
//
// They follow from a closed form.  With c_g the pairs of block g, a valid
// pair's tile is tile_base[g] + rank / tile_m and its row rank % tile_m,
// where tile_base is the exclusive scan of ceil(c_g / tile_m) over g and
// rank the pair's place among block g's pairs in ascending pair index:
// the stable sort's order, which decides which pairs share a tile.
// needed is the sum of ceil(c_g / tile_m).  Pairs whose tile lies at or
// past nt overflow: they fill no tile and point at nt * tile_m.
//
// What bounds it on an H100: bytes, a few MB (the pairs read, the tables
// written), which the card moves in microseconds; what sets its pace is
// the number of dependent grids, each a few microseconds of ramp and
// drain at these sizes, and the passes of the sort.  So the design is an
// LSD radix sort of the valid pairs' ids keyed by block, in the manner of
// Adinets and Merrill's Onesweep, in 2 + passes grids with no memset:
//
// - upsweep_kernel, a block a chunk of 2,048 pairs, reads the pairs once:
//   it counts the chunk's digits of every pass (a column of the digit
//   table), writes the masked pairs' slot, fills every tile with the
//   empty tile's values, and zeroes what the later grids count into: the
//   block counts c_g, the look-back words, the segment states.
// - scan_kernel, 32 digit rows a block of 1,024 threads: the first
//   pass's rows to each chunk's exclusive prefix (in place), every row to
//   its digit's total; with one pass it also counts c_g (atomics over
//   the pairs).
// - scatter_kernel, one grid a pass, a block a chunk: it ranks the chunk's
//   pairs by digit in shared memory (each warp owns 256 consecutive pairs,
//   peers by ballots over the digit's bits; stable, no atomics), takes
//   the earlier chunks' counts of each digit from the table (first pass)
//   or by decoupled look-back (later passes: a 32-bit word a chunk and
//   digit, 0 not yet, count + 1, or the top bit and the inclusive prefix),
//   stages the chunk in sorted order and writes it out in runs of one
//   digit.  Masked pairs are not sorted.  With two passes or more the
//   first pass counts c_g.  The last pass's grid also scans c_g and
//   ceil(c_g / tile_m) over g, in segments of 4,096 blocks with a
//   look-back of their own, into each block's first sorted place and
//   first tile; its segment blocks come first, its chunk blocks wait for
//   them, then write tp, slot, tb and lens_t from each pair's sorted
//   place.  A block only ever waits on blocks of lower index, which
//   the card starts first.  Every block loads its pairs first, as one
//   batch.
//
// Digits are up to max_bits (8 to 11) a pass, the bins in shared memory,
// the key's bits split evenly over the fewest passes: at 11 bits G 65,536
// sorts in two passes of 8 bits, G 524,288 in two of 10 and 9; at 8 in
// three of 7, 7 and 5.  The wrapper asks for 11 up to 524,288 pairs and
// for 8 past them, where the wider digits' shorter runs spread the
// writes (ops/grouped.py table_digit_bits).  No value is read back to
// the host, so the stage never stalls it.

#include <string.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                      // 32-pair rounds a warp
constexpr int kChunk = kWarps * kRounds * 32;   // pairs a block: 2,048
constexpr int kScanThreads = 1024;
constexpr int kMinBits = 8, kMaxBits = 11;      // the widest digit's bits: the caller's choice
constexpr int kMaxPasses = 4;                   // 4 x 8 bits cover any int32 G
constexpr int kSeg = 4096;                      // blocks g a segment of the c_g scan
constexpr int kSegPer = kSeg / kThreads;
constexpr int kWindow = 8;                      // earlier chunks a look-back step reads

// The grids tile_tables_launch has launched in this process
// (rpt_tile_tables_grids: the chip scripts log a call's count).
std::atomic<long long> g_grids{0};
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kIncl = 0x80000000u;
constexpr long long kLow = 0xffffffffLL;

// The digit plan and the scratch layout (ops/grouped.py tile_tables_plan
// mirrors both), in int32 units.
struct Plan {
  int passes;
  int shift[kMaxPasses], bits[kMaxPasses], row0[kMaxPasses];
  int rows;       // digit rows: the passes' bins summed
  long chunks;    // of kChunk pairs
  long segs;      // segments of the c_g scan
  // offsets: segstate[segs], flags[chunks * (rows - 2^bits[0])] (the later
  // passes' look-back words), counts[g] and done[1] (the segments done):
  // the region the upsweep zeroes, from 0; then table[chunks][rows],
  // totals[rows], and 8-byte aligned segagg, seginc (int64[segs] each),
  // base (int64[g]: a block's first sorted place << 32 | its first tile)
  // and the keys / values buffers
  long segstate, flags, counts, done, zero_len, table, totals;
  long segagg, seginc, base, bufs, len;
};

Plan plan_of(long n, int g, int max_bits) {
  Plan pl{};
  int bits = 1;
  while (bits < 31 && ((long)(g - 1) >> bits) > 0) ++bits;
  pl.passes = (bits + max_bits - 1) / max_bits;
  const int w = (bits + pl.passes - 1) / pl.passes;
  int shift = 0;
  pl.rows = 0;
  for (int p = 0; p < pl.passes; ++p) {
    pl.shift[p] = shift;
    pl.bits[p] = min(w, bits - shift);
    pl.row0[p] = pl.rows;
    pl.rows += 1 << pl.bits[p];
    shift += pl.bits[p];
  }
  pl.chunks = n > 0 ? (n + kChunk - 1) / kChunk : 1;
  pl.segs = ((long)g + kSeg - 1) / kSeg;
  long at = 0;
  pl.segstate = at;
  at += pl.segs;
  pl.flags = at;
  at += pl.chunks * (pl.rows - (1 << pl.bits[0]));
  pl.counts = at;
  at += g;
  pl.done = at;
  at += 1;
  pl.zero_len = at;
  pl.table = at;
  at += (long)pl.rows * pl.chunks;
  pl.totals = at;
  at += pl.rows;
  at = (at + 1) & ~1L;
  pl.segagg = at;
  at += 2 * pl.segs;
  pl.seginc = at;
  at += 2 * pl.segs;
  pl.base = at;
  at += 2L * g;
  pl.bufs = at;
  at += 2 * n * min(pl.passes - 1, 2);
  pl.len = at;
  return pl;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Look-back words, segment states and values, coherent at the scope of
// the card.
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ long long ld_relaxed64(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.s64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed64(long long* p, long long v) {
  asm volatile("st.relaxed.gpu.global.s64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ int ld_relaxed_s32(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// Waits until *p reaches at least v: spins on relaxed loads (an acquire
// load invalidates the SM's L1 each time), then one fence for what the
// writer published before it.
__device__ __forceinline__ int wait_at_least(const int* p, int v) {
  int got;
  while ((got = ld_relaxed_s32(p)) < v) __nanosleep(64);
  __threadfence();
  return got;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A pair's key: its block clamped into [0, g), or -1 where it is masked.
__device__ __forceinline__ int key_of(const int* __restrict__ gsel, const int* __restrict__ lsel,
                                      long i, int g) {
  return lsel[i] < 0 ? -1 : min(max(gsel[i], 0), g - 1);
}

// The lanes of the warp whose digit equals this lane's, d in [-1, 2^bits)
// (-1: no pair), from one ballot a bit of d + 1.
__device__ __forceinline__ unsigned peers_of(int d, int bits) {
  const unsigned v = (unsigned)(d + 1);
  unsigned m = kFull;
  for (int b = 0; b <= bits; ++b) {
    const unsigned bal = __ballot_sync(kFull, (v >> b) & 1u);
    m &= ((v >> b) & 1u) ? bal : ~bal;
  }
  return m;
}

template <typename V>
__device__ __forceinline__ V warp_incl_scan(V x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const V o = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += o;
  }
  return x;
}

// The exclusive prefix of each thread's x in thread order, and the block's
// total.  Every thread calls it; it starts and ends with a barrier.
template <typename V>
__device__ V block_excl_scan(V x, V* total) {
  __shared__ V part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  const V incl = warp_incl_scan(x, lane);
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const V t = warp_incl_scan(lane < kWarps ? part[lane] : V(0), lane);
    if (lane < kWarps) part[lane] = t;
  }
  __syncthreads();
  const V before = warp ? part[warp - 1] : V(0);
  *total = part[kWarps - 1];
  __syncthreads();
  return before + incl - x;
}

// Grid 1.  Blocks below pl.chunks count their chunk's digits (a table
// column); every block zeroes a share of the counted region and fills a
// share of the tiles with the empty tile's values (the last pass
// overwrites the slots and tiles that hold pairs).
__global__ void __launch_bounds__(kThreads)
upsweep_kernel(const int* __restrict__ gsel, const int* __restrict__ lsel,
               const int* __restrict__ lens, long n, int g, long nt, int tile_m,
               int* __restrict__ tb, int* __restrict__ tp, long long* __restrict__ slot,
               int* __restrict__ lens_t, int* __restrict__ scratch, Plan pl) {
  extern __shared__ int h[];  // [pl.rows]
  const long stride = (long)gridDim.x * kThreads;
  const long t0 = (long)blockIdx.x * kThreads + threadIdx.x;
  for (long i = t0; i < pl.zero_len; i += stride) scratch[i] = 0;
  const int empty_len = lens[0];
  for (long t = t0; t < nt * tile_m; t += stride) {
    tp[t] = -1;
    if (t < nt) {
      tb[t] = 0;
      lens_t[t] = empty_len;
    }
  }
  if (blockIdx.x >= pl.chunks) return;
  int key[kRounds];
  const long c0 = (long)blockIdx.x * kChunk + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long i = c0 + (long)r * kThreads;
    key[r] = i < n ? key_of(gsel, lsel, i, g) : -2;
  }
  for (int i = threadIdx.x; i < pl.rows; i += kThreads) h[i] = 0;
  __syncthreads();
  const long long trash = (long long)nt * tile_m;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (key[r] == -1) slot[c0 + (long)r * kThreads] = trash;
    if (key[r] < 0) continue;
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p)
      if (p < pl.passes)
        atomicAdd(h + pl.row0[p] + ((key[r] >> pl.shift[p]) & ((1 << pl.bits[p]) - 1)), 1);
  }
  __syncthreads();
  int* table = scratch + pl.table + (long)blockIdx.x * pl.rows;
  for (int i = threadIdx.x; i < pl.rows; i += kThreads) table[i] = h[i];
}

// Grid 2.  Blocks [0, row_blocks): 32 digit rows a block, a lane a row,
// each of its 32 warps a thirty-second of the chunks: every row's total,
// and the first pass's rows to each chunk's exclusive prefix, in place.
// Blocks past them (one pass only): c_g over the pairs.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ gsel, const int* __restrict__ lsel, long n, int g,
            int* __restrict__ scratch, Plan pl, int row_blocks) {
  constexpr int kScanWarps = kScanThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x < row_blocks) {
    __shared__ int part[kScanWarps][32];
    const int row = blockIdx.x * 32 + lane;
    const bool ok = row < pl.rows;
    int* table = scratch + pl.table;
    const long per = (pl.chunks + kScanWarps - 1) / kScanWarps;
    const long lo = min(pl.chunks, warp * per), hi = min(pl.chunks, lo + per);
    int sum = 0;
    if (ok)
      for (long c = lo; c < hi; ++c) sum += table[c * pl.rows + row];
    part[warp][lane] = sum;
    __syncthreads();
    int run = 0, total = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      run += w < warp ? part[w][lane] : 0;
      total += part[w][lane];
    }
    if (ok && row < (1 << pl.bits[0]))
      for (long c = lo; c < hi; ++c) {
        const int v = table[c * pl.rows + row];
        table[c * pl.rows + row] = run;
        run += v;
      }
    if (ok && warp == 0) scratch[pl.totals + row] = total;
    return;
  }
  int* counts = scratch + pl.counts;
  for (long i = (long)(blockIdx.x - row_blocks) * kChunk + threadIdx.x;
       i < min(n, (long)(blockIdx.x - row_blocks + 1) * kChunk); i += kScanThreads) {
    const int key = key_of(gsel, lsel, i, g);
    if (key >= 0) atomicAdd(counts + key, 1);
  }
}

// The segment blocks of the last scatter grid (states: 1 aggregate, 2
// inclusive prefix): segment s of c_g, packed (pairs << 32) +
// ceil(c_g / tile_m) (both sums stay below 2^31, so neither carries),
// scanned within the segment; the segment's aggregate and, by look-back,
// its exclusive prefix; then each block's first sorted place and first
// tile, packed, into base, and one more segment done.  The last segment
// writes needed, and adds to tally where given.
__device__ void segment_scan(long s, int g, long nt, int tile_m, int* __restrict__ scratch,
                             int* __restrict__ needed,
                             unsigned long long* __restrict__ tally, const Plan& pl) {
  __shared__ long long excl_s;
  const long lo = s * kSeg + (long)threadIdx.x * kSegPer;
  const int* counts = scratch + pl.counts;
  long long v[kSegPer];
  long long sum = 0;
#pragma unroll
  for (int i = 0; i < kSegPer; ++i) {
    const int c = lo + i < g ? counts[lo + i] : 0;
    v[i] = ((long long)c << 32) + (c + tile_m - 1) / tile_m;
    sum += v[i];
  }
  long long agg;
  const long long run = block_excl_scan(sum, &agg);
  if (threadIdx.x < 32) {  // the look-back, 32 segments a step, a lane each
    const int lane = threadIdx.x;
    int* state = scratch + pl.segstate;
    long long* segagg = reinterpret_cast<long long*>(scratch + pl.segagg);
    long long* seginc = reinterpret_cast<long long*>(scratch + pl.seginc);
    long long excl = 0;
    if (s > 0) {
      if (lane == 0) {
        st_relaxed64(segagg + s, agg);
        st_release(state + s, 1);
      }
      for (long top = s - 1;; top -= 32) {
        const long j = top - lane;  // before segment 0: an inclusive 0
        const int st = j >= 0 ? wait_at_least(state + j, 1) : 2;
        long long v = j < 0 ? 0 : ld_relaxed64((st == 2 ? seginc : segagg) + j);
        const unsigned incl = __ballot_sync(kFull, st == 2);
        if (incl != 0 && lane > __ffs(incl) - 1) v = 0;  // past the nearest inclusive
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
        excl += v;
        if (incl != 0) break;
      }
    }
    if (lane == 0) {
      st_relaxed64(seginc + s, excl + agg);
      st_release(state + s, 2);
      if (s == pl.segs - 1) {
        const long long total = excl + agg, tiles = total & kLow;
        *needed = (int)tiles;
        if (tally != nullptr) {
          atomicAdd(tally, (unsigned long long)(total >> 32));
          if (tiles > nt) atomicAdd(tally + 1, (unsigned long long)(tiles - nt));
        }
      }
      excl_s = excl;
    }
  }
  __syncthreads();
  long long at = excl_s + run;
  long long* base = reinterpret_cast<long long*>(scratch + pl.base);
#pragma unroll
  for (int i = 0; i < kSegPer; ++i) {
    if (lo + i < g) base[lo + i] = at;
    at += v[i];
  }
  __syncthreads();  // then one fence for the block's writes, as a grid barrier does
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(scratch + pl.done, 1);
  }
}

// Grid 3 + p: pass p of the sort (see the top).  kFirst: keys from the
// pairs, values their index, the chunk's digit offsets from the table;
// kLast: the segment blocks first, then the tables out.
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ gsel, const int* __restrict__ lsel,
               const int* __restrict__ lens, long n, int g, long nt, int tile_m,
               int* __restrict__ tb, int* __restrict__ tp, long long* __restrict__ slot,
               int* __restrict__ lens_t, int* __restrict__ needed,
               unsigned long long* __restrict__ tally, int* __restrict__ scratch, Plan pl,
               int p, const int* __restrict__ keys_in, const int* __restrict__ vals_in,
               int* __restrict__ keys_out, int* __restrict__ vals_out) {
  extern __shared__ __align__(16) int sm[];
  const int bins = 1 << pl.bits[p], shift = pl.shift[p], mask = bins - 1;
  int* cnt = sm;                          // [kWarps][bins]
  int* tot = cnt + kWarps * bins;         // the chunk's count of each digit
  int* lstart = tot + bins;               // its exclusive scan over digits
  int* gbase = lstart + bins;             // a digit's first output place, less lstart
  int* skey = gbase + bins;               // [kChunk], the chunk in sorted order
  int* sval = skey + kChunk;
  long id = blockIdx.x;
  if (kLast) {
    if (id < pl.segs) {
      segment_scan(id, g, nt, tile_m, scratch, needed, tally, pl);
      return;
    }
    id -= pl.segs;
  }
  // the chunk's pairs first, as one batch of loads (a later pass reads
  // past its valid pairs and drops them below)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long c0 = id * kChunk;
  const long base = c0 + (long)warp * kRounds * 32 + lane;
  int key[kRounds], dig[kRounds], val[kRounds];
  unsigned peers[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long i = base + r * 32;
    key[r] = -1;
    val[r] = 0;
    if (i < n) {
      key[r] = kFirst ? key_of(gsel, lsel, i, g) : keys_in[i];
      val[r] = kFirst ? (int)i : vals_in[i];
    }
  }
  for (int i = threadIdx.x; i < kWarps * bins; i += kThreads) cnt[i] = 0;
  const int* totals = scratch + pl.totals + pl.row0[p];
  // each digit's first place in the pass's output (the earlier digits'
  // totals); the total is the valid pairs
  const int dpt = (bins + kThreads - 1) / kThreads;  // digits a thread
  const int d0 = threadIdx.x * dpt;
  int dsum = 0;
  for (int i = 0; i < dpt; ++i) dsum += d0 + i < bins ? totals[d0 + i] : 0;
  int nvalid;
  int drun = block_excl_scan(dsum, &nvalid);
  for (int i = 0; i < dpt && d0 + i < bins; ++i) {
    gbase[d0 + i] = drun;
    drun += totals[d0 + i];
  }
  if (!kFirst && c0 >= nvalid && !kLast) return;  // no later chunk holds a pair either
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (!kFirst && base + r * 32 >= nvalid) key[r] = -1;
    if (kFirst && !kLast && key[r] >= 0) atomicAdd(scratch + pl.counts + key[r], 1);
    dig[r] = key[r] < 0 ? -1 : (key[r] >> shift) & mask;
    peers[r] = peers_of(dig[r], pl.bits[p]);
    // one writer a digit and round: no other warp touches this row
    if (dig[r] >= 0 && (peers[r] & lanes_below()) == 0)
      cnt[warp * bins + dig[r]] += __popc(peers[r]);
    __syncwarp();
  }
  __syncthreads();
  int lsum = 0;
  for (int i = 0; i < dpt && d0 + i < bins; ++i) {
    const int d = d0 + i;
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * bins + d];
      cnt[w * bins + d] = run;
      run += c;
    }
    tot[d] = run;
    lsum += run;
  }
  if (kFirst) {  // the earlier chunks' counts: the table's prefix
    const int* prefix = scratch + pl.table + id * pl.rows;
    for (int i = 0; i < dpt && d0 + i < bins; ++i) gbase[d0 + i] += prefix[d0 + i];
  } else if (c0 < nvalid) {
    // this chunk's counts out, the earlier chunks' in: aggregates first,
    // so that the next chunk never waits on a digit this one has not
    // reached
    unsigned* flags = reinterpret_cast<unsigned*>(scratch + pl.flags) +
                      (long)(pl.row0[p] - (1 << pl.bits[0])) * pl.chunks + id * bins;
    for (int i = 0; i < dpt && d0 + i < bins; ++i)
      st_relaxed(flags + d0 + i, id == 0 ? kIncl | tot[d0 + i] : tot[d0 + i] + 1u);
    if (id > 0) {
      for (int i = 0; i < dpt && d0 + i < bins; ++i) {
        const int d = d0 + i;
        unsigned run = 0;
        // kWindow earlier chunks' words a step, read together (before
        // chunk 0: an inclusive 0)
        for (long top = id - 1;; top -= kWindow) {
          unsigned w[kWindow];
#pragma unroll
          for (int k = 0; k < kWindow; ++k)
            w[k] = top - k >= 0 ? ld_relaxed(flags - (id - top + k) * bins + d) : kIncl;
          bool found = false;
#pragma unroll
          for (int k = 0; k < kWindow && !found; ++k) {
            while (w[k] == 0) w[k] = ld_relaxed(flags - (id - top + k) * bins + d);
            if (w[k] & kIncl) {
              run += w[k] & ~kIncl;
              found = true;
            } else {
              run += w[k] - 1;
            }
          }
          if (found) break;
        }
        st_relaxed(flags + d, kIncl | (run + tot[d]));
        gbase[d] += (int)run;
      }
    }
  }
  int m;
  int lrun = block_excl_scan(lsum, &m);
  for (int i = 0; i < dpt && d0 + i < bins; ++i) {
    lstart[d0 + i] = lrun;
    gbase[d0 + i] -= lrun;
    lrun += tot[d0 + i];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int d = dig[r];
    int first = 0;
    if (d >= 0) {
      first = cnt[warp * bins + d];
      const int pos = lstart[d] + first + __popc(peers[r] & lanes_below());
      skey[pos] = key[r];
      sval[pos] = val[r];
    }
    __syncwarp();
    if (d >= 0 && (peers[r] & lanes_below()) == 0) cnt[warp * bins + d] = first + __popc(peers[r]);
    __syncwarp();
  }
  if (kLast && threadIdx.x == 0)  // every block's first place and tile
    wait_at_least(scratch + pl.done, (int)pl.segs);
  __syncthreads();
  if (!kLast) {
    for (int t = threadIdx.x; t < m; t += kThreads) {
      const int k = skey[t];
      const int pos = gbase[(k >> shift) & mask] + t;
      keys_out[pos] = k;
      vals_out[pos] = sval[t];
    }
    return;
  }
  const long long* start_of = reinterpret_cast<const long long*>(scratch + pl.base);
  for (int t = threadIdx.x; t < m; t += kThreads) {
    const int k = skey[t], v = sval[t];
    const int pos = gbase[(k >> shift) & mask] + t;
    const long long at = __ldcg(start_of + k);  // the block's first place and tile
    const int rank = pos - (int)(at >> 32);
    const long long tile = (at & kLow) + rank / tile_m;
    const int row = rank % tile_m;
    long long s = (long long)nt * tile_m;
    if (tile < nt) {
      s = tile * tile_m + row;
      tp[s] = v;
      if (row == 0) {
        tb[tile] = k;
        lens_t[tile] = lens[k];
      }
    }
    slot[v] = s;
  }
}

size_t scatter_smem(int bits) {
  return sizeof(int) * ((size_t)(kWarps + 3) * (1 << bits) + 2 * kChunk);
}

int tile_tables_launch(const int* gsel, const int* lsel, const int* lens, int* tb, int* tp,
                       long long* slot, int* lens_t, int* needed, unsigned long long* tally,
                       int* scratch, long scratch_len,
                       long n, int g, long nt, int tile_m, int max_bits, cudaStream_t stream) {
  if (g < 1 || tile_m < 1 || nt < 0 || n < 0 || n >= (1L << 31) || max_bits < kMinBits ||
      max_bits > kMaxBits || reinterpret_cast<uintptr_t>(scratch) % 8)
    return cudaErrorInvalidValue;
  const Plan pl = plan_of(n, g, max_bits);
  if (pl.passes > kMaxPasses || scratch_len < pl.len) return cudaErrorInvalidValue;
  // grid 1: a block a chunk, and enough blocks to zero and fill
  const long work = max(pl.zero_len, nt * tile_m);
  const long up_grid = max(pl.chunks, min(1024L, (work + 16L * kThreads - 1) / (16L * kThreads)));
  upsweep_kernel<<<(unsigned)up_grid, kThreads, sizeof(int) * pl.rows, stream>>>(
      gsel, lsel, lens, n, g, nt, tile_m, tb, tp, slot, lens_t, scratch, pl);
  g_grids.fetch_add(1, std::memory_order_relaxed);
  const int row_blocks = (pl.rows + 31) / 32;
  const long count_blocks = pl.passes == 1 ? (n + kChunk - 1) / kChunk : 0;
  scan_kernel<<<(unsigned)(row_blocks + count_blocks), kScanThreads, 0, stream>>>(
      gsel, lsel, n, g, scratch, pl, row_blocks);
  g_grids.fetch_add(1, std::memory_order_relaxed);
  int* bufs = scratch + pl.bufs;
  int* buf[2][2] = {{bufs, bufs + n}, {bufs + 2 * n, bufs + 3 * n}};
  for (int p = 0; p < pl.passes; ++p) {
    const bool first = p == 0, last = p == pl.passes - 1;
    const size_t smem = scatter_smem(pl.bits[p]);
    const int* ki = first ? nullptr : buf[(p - 1) & 1][0];
    const int* vi = first ? nullptr : buf[(p - 1) & 1][1];
    int* ko = last ? nullptr : buf[p & 1][0];
    int* vo = last ? nullptr : buf[p & 1][1];
    const unsigned grid = (unsigned)((last ? pl.segs : 0) + pl.chunks);
    cudaError_t e = cudaSuccess;
#define RPT_SCATTER(F, L)                                                                      \
  e = rpt::allow_smem(scatter_kernel<F, L>, smem);                                            \
  if (e == cudaSuccess)                                                                       \
    scatter_kernel<F, L><<<grid, kThreads, smem, stream>>>(gsel, lsel, lens, n, g, nt, tile_m, \
                                                           tb, tp, slot, lens_t, needed,       \
                                                           tally, scratch, pl, p, ki, vi, ko, vo);
    if (first && last) {
      RPT_SCATTER(true, true)
    } else if (first) {
      RPT_SCATTER(true, false)
    } else if (last) {
      RPT_SCATTER(false, true)
    } else {
      RPT_SCATTER(false, false)
    }
#undef RPT_SCATTER
    if (e != cudaSuccess) return (int)e;
    g_grids.fetch_add(1, std::memory_order_relaxed);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The wrapper passes the arguments packed, an int64 each in the order of
// tile_tables_launch's parameters (ops/grouped.py _TABLES_ARGS): gsel,
// lsel int32[n] pairs; lens int32[g]; outputs tb int32[nt], tp int32[nt *
// tile_m], slot int64[n], lens_t int32[nt], needed int32[1]; tally
// int64[2] or 0 (the count site's pairs and overflow tiles); scratch
// int32[scratch_len], 8-byte aligned, of at least the plan's length
// (rpt_tile_tables_scratch); max_bits the widest digit, 8 to 11.
int rpt_tile_tables(const long long* packed) {
  long long a[17];
  memcpy(a, packed, sizeof a);
  return tile_tables_launch(
      reinterpret_cast<const int*>(a[0]), reinterpret_cast<const int*>(a[1]),
      reinterpret_cast<const int*>(a[2]), reinterpret_cast<int*>(a[3]),
      reinterpret_cast<int*>(a[4]), reinterpret_cast<long long*>(a[5]),
      reinterpret_cast<int*>(a[6]), reinterpret_cast<int*>(a[7]),
      reinterpret_cast<unsigned long long*>(a[8]), reinterpret_cast<int*>(a[9]), a[10], a[11],
      (int)a[12], a[13], (int)a[14], (int)a[15], reinterpret_cast<cudaStream_t>(a[16]));
}

// The scratch int32s tile_tables_launch needs for n pairs over g blocks at
// digits of at most max_bits; -1 for arguments it refuses.
long rpt_tile_tables_scratch(long n, int g, int max_bits) {
  if (g < 1 || n < 0 || max_bits < kMinBits || max_bits > kMaxBits) return -1;
  return plan_of(n, g, max_bits).len;
}

// The grids rpt_tile_tables has launched in this process.
long long rpt_tile_tables_grids() { return g_grids.load(std::memory_order_relaxed); }

}  // extern "C"
