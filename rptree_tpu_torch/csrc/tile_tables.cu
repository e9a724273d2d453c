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
// They follow from a closed form.  With c_g the pairs of block g, a valid
// pair's tile is tile_base[g] + rank / tile_m and its row rank % tile_m,
// where tile_base is the exclusive scan of ceil(c_g / tile_m) over g and
// rank the pair's place among block g's pairs in ascending pair index:
// the stable sort's order, which decides which pairs share a tile.
// needed is the sum of ceil(c_g / tile_m).  Pairs whose tile lies at or
// past nt overflow: they fill no tile and point at nt * tile_m.
//
// What bounds it on an H100: bytes, a few MB (the pairs' blocks and
// masks read once, the tables written once), which the card moves in
// microseconds; the launches, the passes over the pairs and the scans'
// latency set its pace.  The pairs' ranks need a stable sort, and a sort
// by atomic cursors (as kernel 6's rpt_pair_runs does) is not stable;
// per-block counters for every block of the chunk do not fit in shared
// memory (G is 65,536 on the clustered cell).  So the design is an LSD
// radix sort of the pair ids keyed by block, 8 bits a pass (2 passes up
// to G = 65,536, 3 up to 2^24), that holds at any skew, even one block
// that every query probes.  Pairs go in chunks of 2,048, one thread
// block each:
//
// - hist_kernel: each chunk counts its digits (257 bins: the masked
//   pairs take a bin of their own, last in every pass, so they end behind
//   every valid pair); the first pass also adds each pair to its block's
//   count c_g (a global atomic) and fills every tile with the empty
//   tile's values;
// - scan_kernel: one thread block per digit scans that digit's counts
//   over the chunks (its row of the digit-major table) and keeps the
//   digit's total; on the first pass one more block per 1,024 blocks g
//   scans c_g and ceil(c_g / tile_m), packed in one 64-bit sum, and keeps
//   the segment's totals; seg_kernel then scans the segment totals and
//   writes needed.  The scans run side by side, none on one block alone;
// - scatter_kernel: each warp owns 128 consecutive pairs of its chunk and
//   counts their digits; the warps' counts are scanned in warp order, the
//   digits' chunk totals in digit order, and the digit totals (every
//   block does this 257-entry scan itself); then each warp walks its
//   pairs again, 32 at a time in order, and a pair's place in the chunk
//   is its digit's start, the earlier warps' and rounds' pairs of that
//   digit, and its lanes below it with the same digit (a mask of 9
//   ballots, one a bit of the digit): a stable order, no atomics.  The
//   chunk is staged in that order in shared memory and written out in
//   runs of one digit, so consecutive threads store to consecutive
//   places;
// - hist_kernel and scan_kernel again for each later pass;
// - final_kernel: for each sorted position its pair's rank, tile and row,
//   written to tp, slot, tb and lens_t.
//
// No value is read back to the host, so the stage never stalls it.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;                      // 32-pair rounds a warp
constexpr int kChunk = kWarps * kRounds * 32;   // pairs a block: 2,048
constexpr int kBins = 257;                      // 256 digits, then masked
constexpr int kSeg = 1024;                      // blocks g a scan block
constexpr int kScanThreads = 256;
constexpr int kSegThreads = 1024;
constexpr int kFinalThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kLow = 0xffffffffLL;

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A pair's key: its block clamped into [0, g), or -1 where it is masked.
__device__ __forceinline__ int key_of(const int* __restrict__ gsel, const int* __restrict__ lsel,
                                      long i, int g) {
  return lsel[i] < 0 ? -1 : min(max(gsel[i], 0), g - 1);
}

__device__ __forceinline__ int digit_of(int key, int shift) {
  return key < 0 ? kBins - 1 : (key >> shift) & 255;
}

// The key of pair slot i of a pass: from the pairs on the first pass, from
// the previous pass's output after it; -2 past the end.
template <bool FIRST>
__device__ __forceinline__ int load_key(const int* __restrict__ gsel,
                                        const int* __restrict__ lsel,
                                        const int* __restrict__ keys, long i, long n, int g) {
  if (i >= n) return -2;
  return FIRST ? key_of(gsel, lsel, i, g) : keys[i];
}

// The lanes of the warp whose digit equals this lane's, d in [-1, 256]
// (-1 past the end), from one ballot per bit of d + 1.
__device__ __forceinline__ unsigned peers_of(int d) {
  const unsigned v = (unsigned)(d + 1);
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const unsigned bal = __ballot_sync(kFull, (v >> b) & 1u);
    m &= ((v >> b) & 1u) ? bal : ~bal;
  }
  return m;
}

__device__ __forceinline__ long long warp_incl_scan(long long x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long o = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += o;
  }
  return x;
}

// Exclusive prefix sums of the n values v(i) by one block of T threads:
// warp w owns one contiguous segment and reads it 32 consecutive values
// at a time; put(i, prefix) for every i.  Returns the total.  Every
// thread of the block calls it: it starts and ends with a block barrier,
// so what the block wrote before is read and what put writes is seen.
template <int T, typename V, typename P>
__device__ long long block_scan(long n, V v, P put) {
  constexpr int kW = T / 32;
  __shared__ long long part[kW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long seg = ((n + kW - 1) / kW + 31) / 32 * 32;
  const long lo = min(n, (long)warp * seg), hi = min(n, lo + seg);
  __syncthreads();
  long long sum = 0;
#pragma unroll 4
  for (long i = lo + lane; i < hi; i += 32) sum += v(i);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) part[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    const long long x = lane < kW ? part[lane] : 0;
    const long long incl = warp_incl_scan(x, lane);
    if (lane < kW) part[lane] = incl;
  }
  __syncthreads();
  long long run = warp ? part[warp - 1] : 0;
  const long long total = part[kW - 1];
#pragma unroll 4
  for (long b = lo; b < hi; b += 32) {
    const long i = b + lane;
    const long long x = i < hi ? v(i) : 0;
    const long long incl = warp_incl_scan(x, lane);
    if (i < hi) put(i, run + incl - x);
    run += __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();
  return total;
}

// Digit counts of each chunk, stored digit-major: hist[d * chunks + c].
// The first pass also counts the pairs of each block and fills the
// tiles with the empty tile's values (tiles past `needed` keep them).
template <bool FIRST>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ gsel, const int* __restrict__ lsel,
            const int* __restrict__ keys, long n, int g, int shift, int* __restrict__ hist,
            int chunks, int* __restrict__ counts, const int* __restrict__ lens, long nt,
            int tile_m, int* __restrict__ tb, int* __restrict__ tp, int* __restrict__ lens_t) {
  __shared__ int h[kBins];
  for (int i = threadIdx.x; i < kBins; i += kThreads) h[i] = 0;
  __syncthreads();
  const long base = (long)blockIdx.x * kChunk + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {  // a count: any order of the pairs
    const int key = load_key<FIRST>(gsel, lsel, keys, base + (long)r * kThreads, n, g);
    if (FIRST && key >= 0) atomicAdd(counts + key, 1);
    if (key != -2) atomicAdd(h + digit_of(key, shift), 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[(long)i * chunks + blockIdx.x] = h[i];
  if (!FIRST) return;
  const long stride = (long)gridDim.x * kThreads;
  const int empty_len = lens[0];
  for (long t = (long)blockIdx.x * kThreads + threadIdx.x; t < nt * tile_m; t += stride) {
    tp[t] = -1;
    if (t < nt) {
      tb[t] = 0;
      lens_t[t] = empty_len;
    }
  }
}

// Blocks [0, 257): digit d's row of hist, in place, to the offsets of its
// pairs in each chunk among the digit's pairs; the digit's total to
// dtot[d].  Blocks past them (first pass): segment s of the blocks g to
// the offsets of their pairs and tiles within the segment (start,
// tile_base), and the segment's totals, packed, to seg[s].
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ hist, int chunks, int* __restrict__ dtot,
            const int* __restrict__ counts, int g, int tile_m, int* __restrict__ start,
            int* __restrict__ tile_base, long long* __restrict__ seg) {
  if (blockIdx.x < kBins) {
    int* row = hist + (long)blockIdx.x * chunks;
    const long long total = block_scan<kScanThreads>(
        chunks, [&](long i) { return (long long)row[i]; },
        [&](long i, long long pre) { row[i] = (int)pre; });
    if (threadIdx.x == 0) dtot[blockIdx.x] = (int)total;
    return;
  }
  const int s = blockIdx.x - kBins;
  const int lo = s * kSeg;
  // (pairs << 32) + tiles: both sums stay below 2^31, so neither carries
  const long long total = block_scan<kScanThreads>(
      min(kSeg, g - lo),
      [&](long i) {
        const int c = counts[lo + i];
        return ((long long)c << 32) + (c + tile_m - 1) / tile_m;
      },
      [&](long i, long long pre) {
        start[lo + i] = (int)(pre >> 32);
        tile_base[lo + i] = (int)(pre & kLow);
      });
  if (threadIdx.x == 0) seg[s] = total;
}

// The segments' packed totals to their offsets, in place; needed.
__global__ void __launch_bounds__(kSegThreads)
seg_kernel(long long* __restrict__ seg, int nseg, int* __restrict__ needed) {
  const long long total = block_scan<kSegThreads>(
      nseg, [&](long i) { return seg[i]; }, [&](long i, long long pre) { seg[i] = pre; });
  if (threadIdx.x == 0) *needed = (int)(total & kLow);
}

// One stable pass: each pair to its place by digit (see the top).
template <bool FIRST>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ gsel, const int* __restrict__ lsel,
               const int* __restrict__ keys, const int* __restrict__ vals, long n, int g,
               int shift, const int* __restrict__ offs, const int* __restrict__ dtot, int chunks,
               int* __restrict__ keys_out, int* __restrict__ vals_out) {
  __shared__ int cnt[kWarps][kBins];
  __shared__ int lstart[kBins], gbase[kBins];
  __shared__ int skey[kChunk], sval[kChunk];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) (&cnt[0][0])[i] = 0;
  // each digit's first place in the output: the earlier digits' totals
  block_scan<kThreads>(kBins, [&](long i) { return (long long)dtot[i]; },
                       [&](long i, long long pre) { gbase[i] = (int)pre; });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long c0 = (long)blockIdx.x * kChunk;
  const long base = c0 + (long)warp * kRounds * 32 + lane;
  int key[kRounds], dig[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    key[r] = load_key<FIRST>(gsel, lsel, keys, base + r * 32, n, g);
    dig[r] = key[r] == -2 ? -1 : digit_of(key[r], shift);
    const unsigned peers = peers_of(dig[r]);
    // one writer per digit and round: no other warp touches this row
    if (dig[r] >= 0 && (peers & lanes_below()) == 0) cnt[warp][dig[r]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kBins; d += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w][d];
      cnt[w][d] = run;
      run += c;
    }
    lstart[d] = run;  // the digit's pairs in this chunk, for now
  }
  block_scan<kThreads>(kBins, [&](long i) { return (long long)lstart[i]; },
                       [&](long i, long long pre) { lstart[i] = (int)pre; });
  // an output place is gbase[digit] + the place in the chunk's order
  for (int d = threadIdx.x; d < kBins; d += kThreads)
    gbase[d] += offs[(long)d * chunks + blockIdx.x] - lstart[d];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long i = base + r * 32;
    const int d = dig[r];
    const unsigned peers = peers_of(d);
    int first = 0;
    if (d >= 0) {
      first = cnt[warp][d];
      const int pos = lstart[d] + first + __popc(peers & lanes_below());
      skey[pos] = key[r];
      sval[pos] = FIRST ? (int)i : vals[i];
    }
    __syncwarp();
    if (d >= 0 && (peers & lanes_below()) == 0) cnt[warp][d] = first + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const int m = (int)min((long)kChunk, n - c0);
  for (int t = threadIdx.x; t < m; t += kThreads) {
    const int k = skey[t];
    const int pos = gbase[digit_of(k, shift)] + t;
    keys_out[pos] = k;
    vals_out[pos] = sval[t];
  }
}

__global__ void __launch_bounds__(kFinalThreads)
final_kernel(const int* __restrict__ keys, const int* __restrict__ vals, long n,
             const int* __restrict__ start, const int* __restrict__ tile_base,
             const long long* __restrict__ seg, const int* __restrict__ lens, long nt,
             int tile_m, int* __restrict__ tb, int* __restrict__ tp,
             long long* __restrict__ slot, int* __restrict__ lens_t) {
  const long i = (long)blockIdx.x * kFinalThreads + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i], pair = vals[i];
  long long s = (long long)nt * tile_m;
  if (key >= 0) {
    const long long off = seg[key / kSeg];
    const int rank = (int)(i - start[key] - (off >> 32));
    const long long tile = tile_base[key] + (off & kLow) + rank / tile_m;
    const int row = rank % tile_m;
    if (tile < nt) {
      s = tile * tile_m + row;
      tp[s] = pair;
      if (row == 0) {
        tb[tile] = key;
        lens_t[tile] = lens[key];
      }
    }
  }
  slot[pair] = s;
}

}  // namespace

extern "C" {

// gsel, lsel: int32[n] pairs; lens: int32[g]; outputs tb int32[nt], tp
// int32[nt * tile_m], slot int64[n], lens_t int32[nt], needed int32[1];
// scratch: int32[scratch_len] of at least 3 * g + 257 * (chunks + 1) +
// 4 * n + 2 * segs + 1, chunks = max(1, ceil(n / 2048)), segs =
// ceil(g / 1024), 8-byte aligned.
int rpt_tile_tables(const int* gsel, const int* lsel, const int* lens, int* tb, int* tp,
                    long long* slot, int* lens_t, int* needed, int* scratch, long scratch_len,
                    long n, int g, long nt, int tile_m, cudaStream_t stream) {
  const long chunks = n > 0 ? (n + kChunk - 1) / kChunk : 1;
  const long segs = ((long)g + kSeg - 1) / kSeg;
  if (g < 1 || tile_m < 1 || nt < 0 || n < 0 || n >= (1L << 31) || chunks > INT32_MAX ||
      scratch_len < 3L * g + kBins * (chunks + 1) + 4 * n + 2 * segs + 1 ||
      reinterpret_cast<uintptr_t>(scratch) % 8)
    return cudaErrorInvalidValue;
  int* counts = scratch;
  int* start = counts + g;
  int* tile_base = start + g;
  int* hist = tile_base + g;
  int* dtot = hist + kBins * chunks;
  int* bufs = dtot + kBins;
  int* buf[2][2] = {{bufs, bufs + n}, {bufs + 2 * n, bufs + 3 * n}};
  // the packed segment totals, on the next 8-byte boundary
  const long at = (3L * g + kBins * (chunks + 1) + 4 * n + 1) & ~1L;
  long long* seg = reinterpret_cast<long long*>(scratch + at);
  int passes = 1;
  while (passes < 4 && ((long)(g - 1) >> (8 * passes)) > 0) ++passes;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)g, stream);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)chunks;
  hist_kernel<true><<<grid, kThreads, 0, stream>>>(gsel, lsel, nullptr, n, g, 0, hist, (int)chunks,
                                                   counts, lens, nt, tile_m, tb, tp, lens_t);
  scan_kernel<<<(unsigned)(kBins + segs), kScanThreads, 0, stream>>>(
      hist, (int)chunks, dtot, counts, g, tile_m, start, tile_base, seg);
  seg_kernel<<<1, kSegThreads, 0, stream>>>(seg, (int)segs, needed);
  scatter_kernel<true><<<grid, kThreads, 0, stream>>>(gsel, lsel, nullptr, nullptr, n, g, 0, hist,
                                                      dtot, (int)chunks, buf[0][0], buf[0][1]);
  for (int p = 1; p < passes; ++p) {
    const int* ki = buf[(p - 1) & 1][0];
    const int* vi = buf[(p - 1) & 1][1];
    hist_kernel<false><<<grid, kThreads, 0, stream>>>(nullptr, nullptr, ki, n, g, 8 * p, hist,
                                                      (int)chunks, nullptr, nullptr, 0, tile_m,
                                                      nullptr, nullptr, nullptr);
    scan_kernel<<<kBins, kScanThreads, 0, stream>>>(hist, (int)chunks, dtot, nullptr, g, tile_m,
                                                    nullptr, nullptr, nullptr);
    scatter_kernel<false><<<grid, kThreads, 0, stream>>>(nullptr, nullptr, ki, vi, n, g, 8 * p,
                                                         hist, dtot, (int)chunks, buf[p & 1][0],
                                                         buf[p & 1][1]);
  }
  if (n > 0) {
    const int* keys = buf[(passes - 1) & 1][0];
    const int* vals = buf[(passes - 1) & 1][1];
    final_kernel<<<(unsigned)((n + kFinalThreads - 1) / kFinalThreads), kFinalThreads, 0,
                   stream>>>(keys, vals, n, start, tile_base, seg, lens, nt, tile_m, tb, tp,
                             slot, lens_t);
  }
  return cudaGetLastError();
}

}  // extern "C"
