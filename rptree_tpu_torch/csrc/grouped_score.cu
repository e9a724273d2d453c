// Grouped scoring for the query-grouped rerank: kernel 1.
//
// Replaces the Pallas TPU kernel grouped_score_tiles (f32 and bf16
// blocks; rptree_tpu/ops/grouped_kernel.py:63).  A tile is up to tile_m
// (query, probe) pairs that probe the SAME leaf block, as the tile tables
// give them (kernel 9, csrc/tile_tables.cu): tb[t] the block, lens[t] its
// occupancy, tp[t * m + i] the pair in slot i (-1 for an empty slot).
// For every pair e in a tile, at slot i of tile t, the kernel writes
//
//   out[e, j] = max(sq_leaf[tb[t], j] - 2 * <q[e / p], x_leaf[tb[t], j]> + |q[e / p]|^2, 0)
//
// (square-rooted for "l2") for j < lens[t], and +inf past the block's
// occupancy; with slot given, every pair in no tile (slot[e] >= nt * m:
// masked probes, capacity overflow) reads +inf.  The query rows are read
// in place from q [B, D] and each distance row is written straight to the
// pair's row of out [B * P, lmax]: no query row is copied into tile-slot
// order and no distance row out of it.  Without tp the pair map is the
// identity (slot t * m + i holds pair t * m + i, p 1): the JAX package's
// slot-order contract, grouped_score_tiles.  The arithmetic is
// grouped_tile.cuh's, shared with kernel 4 (csrc/grouped_topk.cu), so the
// distances are bit-equal to kernel 4's and to those of the one-tile-a-
// block design this kernel replaces.  int8 blocks are kernel 2's
// (csrc/grouped_score_i8.cu).
//
// What bounds it on an H100: bytes, then shared-memory loads.  A block's
// occupied rows (58-62 KB in f32 at the SIFT cells' 114-122 rows of D 128)
// meet a few query rows: 2 operations per 4 block bytes per pair, so at 8
// pairs a block the block read from device memory is the floor, and every
// probed block read once is the least any design reads.  The design before
// this one gave each tile (8 slots) a thread block of its own with a
// two-stage ring: it scored the empty slots and the capacity tiles past
// the tiles needed, read a block once a tile, and read its query rows
// from a copy in tile-slot order into a distance copy in the same order.
// On the grouped cell's chunk (65,536 queries x 8 probes over 65,536
// blocks of 128 x 128) it took 3.08 ms, plus 0.50 ms for the query-row
// copy and ~0.6 ms for the reorder, where a plain read of the 4.3 GB of
// blocks takes 1.37 ms.  So:
//
// - the unit of work is a run: consecutive tiles of one block (one tb and
//   lens), at most 32 slots (32 / tile_m tiles), so one staging of the
//   block's rows serves up to 32 pairs and a hot block's pairs spread over
//   several runs and thread blocks;
// - each thread block takes 32 tiles (256 / tile_m past tile_m 8; fewer
//   where the tiles would give the SMs under about four waves of two
//   thread blocks, ops/grouped_kernel.py range_tiles) and
//   walks their runs with one cp.async ring, four stages of 128 slots x
//   128 bytes deep, that runs on across runs: the next run's rows land
//   while this run computes, and the same columns of its query rows
//   (cp.async through tp / p) with them.  Runs break where a thread block's
//   tiles end,
//   so a block whose tiles straddle two such ranges is read twice
//   (66,352 runs for at most 65,536 blocks on that chunk);
// - the per-stage work is lean: each thread's 16-byte pieces of a stage
//   are fixed at the start, the producer walks (run, slot tile, chunk)
//   without a division, and one barrier a stage both publishes stage s
//   and frees stage s - 1's slot for the next copy.  The first version of
//   this design, with a division-heavy copy loop and two barriers a stage,
//   took 3.07 ms: it spent more instructions on the copies than on the
//   dots;
// - only pairs are scored: a run's rows end at its last pair, an f32
//   thread takes ceil(rows / 2) rounded up to 1, 2, 4, 8 or 16 query rows
//   in registers (one instantiation a count), and a tile with no pair (the
//   capacity past the tiles needed) costs its test;
// - each distance goes from the registers that summed it to the pair's
//   row: a warp's 32 slots are 128 bytes of one row.
//
// Measured on that chunk (NVIDIA H100 80GB HBM3, 700 W): 2.06 ms, against
// 1.66 ms with the dots left out and 1.83 ms with the copies left out.
// The dots load shared memory for every 4 FMAs: 16 bytes of the slot row
// and, broadcast, 16 of the query row.
//
// The query rows stream with the block: each stage of the ring holds, beside
// its 128 slots x 128 bytes of block columns, the same columns of the run's
// up to 32 query rows (f32, 4 KB for f32 blocks, 9 KB for bf16 ones), copied
// in the same cp.async group.  So the shared memory does not grow with D:
// 93 KB for f32 blocks and 114 KB for bf16 ones at every width, two thread
// blocks of 256 threads an SM with a four-stage ring, and a run's query rows
// land in flight with its block rows, never between runs.  The bound the
// design is under is sm_90's 233,472 bytes an SM, 1,024 of them reserved a
// thread block: two thread blocks of the four-stage ring take 188,472 bytes
// (f32) and 229,432 (bf16), checked at compile time below.  |q|^2 is
// summed along the stages, warp w taking rows w, w + 8, ...: lane l adds
// column c0 + l of each chunk (c0 + 32 + l too for bf16 blocks), so each
// lane's chain runs over its columns l, l + 32, ... in order, then a warp
// sum, as row_norm sums it.  bf16 blocks round the f32 query columns to bf16
// in registers as each mma fragment is read (bf16_dots_f32q), as bf16_word
// rounds them.  So the distances keep their bits at every D.
//
// While a profiler runs (reads not null), each thread block adds its block
// stagings, the runs it scores, to reads[0], and the bytes of block rows and
// query rows it copies into shared memory to reads[1].

#include <cuda_bf16.h>

#include "grouped_tile.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(kThreads == rpt::kTileThreads, "the tile scoring's block size");
constexpr int kRunSlots = 32;    // tile slots a run holds at most
constexpr int kRangeSlots = 256; // tile slots of a thread block's tiles, at most
constexpr int kMaxTiles = 32;    // tiles a thread block takes, at most (a lane each)
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* x;
  const float* sq;
  const int* tb;
  const int* tp;  // null: the identity pair map
  const int* lens;
  const long long* slot;  // null: no pair outside the tiles
  const float* q;
  float* out;
  unsigned long long* reads;  // null: not counted; else stagings, staged bytes
  long long e;                // pairs (slot's length)
  int nt, g, m, lmax, d, p, l2;
  int vec, qvec;  // 16-byte copies of block rows / query rows
  int ring;       // stages in flight: kRing
  int range_tiles, run_tiles;
};

// A stage's query columns: a run's 32 rows of DC f32 columns, the row stride
// in words.  f32 blocks read them as broadcasts (32 words a row); bf16 blocks
// read mma fragments of 8 rows x 2 columns as 8-byte loads, conflict-free at
// a stride 8 past a multiple of 32.
template <typename T>
__host__ __device__ constexpr int qc_stride() {
  return sizeof(T) == 4 ? rpt::TileShape<T>::DC : rpt::TileShape<T>::DC + 8;
}

// A stage in 4-byte words: the block columns, then the query columns.
template <typename T>
__host__ __device__ constexpr int stage_words() {
  return rpt::TileShape<T>::kStageFloats + kRunSlots * qc_stride<T>();
}

constexpr int kRunInts = 5 * (kMaxTiles + 1) + 2 * kMaxTiles + 2;
constexpr int kRing = 4;  // stages in flight

// Shared bytes: the ring, the norms, the tiles' pairs and their query rows,
// and the run table.  They do not depend on D.
template <typename T>
constexpr size_t score_bytes() {
  return 4 * ((size_t)kRing * stage_words<T>() + kRunSlots + 2 * kRangeSlots + kRunInts);
}

// sm_90: a thread block may opt into 227 KB, an SM holds 228 KB with 1 KB
// reserved for each thread block; two thread blocks an SM at every D
constexpr size_t kBlockSmem = 232448, kSmSmem = 233472;
static_assert(score_bytes<float>() <= kBlockSmem && 2 * (score_bytes<float>() + 1024) <= kSmSmem,
              "f32 blocks: two thread blocks an SM");
static_assert(score_bytes<__nv_bfloat16>() <= kBlockSmem &&
                  2 * (score_bytes<__nv_bfloat16>() + 1024) <= kSmSmem,
              "bf16 blocks: two thread blocks an SM");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// cp.async.wait_group with a count known at run time (at most 3).
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: rpt::tile_cp_wait<0>(); break;
    case 1: rpt::tile_cp_wait<1>(); break;
    case 2: rpt::tile_cp_wait<2>(); break;
    default: rpt::tile_cp_wait<3>(); break;
  }
}

// A compile-time count, the argument of the kernel's slot-tile lambda.
template <int N>
struct Rows {
  static constexpr int value = N;
};

// Pairs of f32 values rounded to a bf16 pair (round to nearest even), the
// low half the first: bf16_word's rounding.
__device__ __forceinline__ uint32_t bf16_pair(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16_dots with the query rows as f32 columns (a stage's, stride qs words,
// zero past D), each fragment rounded to bf16 as it is read: the same
// operands and the same mma order, so the same bits.
template <int NN>
__device__ __forceinline__ void bf16_dots_f32q(float (&acc)[NN][4], const uint32_t* xw,
                                               const float* qc, int steps, int rows) {
  constexpr int XW = rpt::TileShape<__nv_bfloat16>::XS / 2;  // staged row stride in words: 36
  constexpr int QS = qc_stride<__nv_bfloat16>();
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int u = 0; u < rpt::TileShape<__nv_bfloat16>::DC / 16; ++u) {
    if (u < steps) {
      const uint32_t a[4] = {xw[8 * u], xw[8 * u + 8 * XW], xw[8 * u + 4],
                             xw[8 * u + 8 * XW + 4]};
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        if (n * 8 < rows) {
          const float* qr = qc + (n * 8 + g) * QS + 16 * u + 2 * t4;
          rpt::mma_bf16(acc[n], a, bf16_pair(*reinterpret_cast<const float2*>(qr)),
                        bf16_pair(*reinterpret_cast<const float2*>(qr + 8)));
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) grouped_score_kernel(const Args a) {
  using S = rpt::TileShape<T>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int QS = qc_stride<T>();
  constexpr int SW = stage_words<T>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = a.d, m = a.m, lmax = a.lmax, K = a.ring;
  float* ring = smem;  // [K][SW]: block columns, then query columns
  float* qq = ring + (size_t)K * SW;                  // [32] |q|^2
  int* tps = reinterpret_cast<int*>(qq + kRunSlots);  // the tiles' pairs
  int* tqr = tps + kRangeSlots;                       // their query rows (-1: none)
  int* r_slot = tqr + kRangeSlots;                    // a run's first slot in tps
  int* r_rows = r_slot + kMaxTiles + 1;               // its slots up to its last pair
  int* r_blk = r_rows + kMaxTiles + 1;
  int* r_len = r_blk + kMaxTiles + 1;
  int* r_s0 = r_len + kMaxTiles + 1;  // its first stage; r_s0[runs] = all stages
  int* z_slot = r_s0 + kMaxTiles + 1;  // runs of blocks with no occupied row
  int* z_rows = z_slot + kMaxTiles;
  int* counts = z_rows + kMaxTiles;  // runs, empty-block runs

  // this thread block's tiles, their pairs and the pairs' query rows
  const long long t0 = (long long)blockIdx.x * a.range_tiles;
  const int nh = (int)max(0LL, min((long long)a.range_tiles, (long long)a.nt - t0));
  for (int i = tid; i < nh * m; i += kThreads) {
    const int e = a.tp ? a.tp[t0 * m + i] : (int)(t0 * m + i);
    tps[i] = e;
    tqr[i] = e >= 0 ? e / a.p : -1;
  }
  __syncthreads();

  // the run table, a lane a tile: a run starts at the first tile, after a
  // tile with no pair, where the block or occupancy changes, and every
  // run_tiles tiles of one block; it ends before the next start or a tile
  // with no pair
  const int nk = rpt::padded_d<T>(d) / S::DC;
  if (warp == 0) {
    const bool in = lane < nh;
    const int kb = in ? a.tb[t0 + lane] : 0;
    const int kl = in ? a.lens[t0 + lane] : 0;
    const bool ne = in && tps[lane * m] >= 0;
    const int pkb = __shfl_up_sync(kFull, kb, 1);
    const int pkl = __shfl_up_sync(kFull, kl, 1);
    const int pne = __shfl_up_sync(kFull, (int)ne, 1);
    const bool fresh = ne && (lane == 0 || !pne || pkb != kb || pkl != kl);
    const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1;  // lanes <= this one
    const unsigned lower = (1u << lane) - 1;                       // lanes below it
    const unsigned seg = __ballot_sync(kFull, fresh) & upto;
    const int start = seg ? 31 - __clz(seg) : 0;
    const bool head = ne && (lane - start) % a.run_tiles == 0;
    const unsigned ends = __ballot_sync(kFull, head || !ne) & ~upto;
    const int end = ends ? __ffs(ends) - 1 : 32;
    const int len = min(max(kl, 0), lmax);
    int rows = 0;
    if (head) {
      for (int i = (end - lane) * m - 1; i >= 0; --i) {
        if (tps[lane * m + i] >= 0) {
          rows = i + 1;
          break;
        }
      }
    }
    const bool staged = head && len > 0;
    const int tiles = (len + rpt::kSlotTile - 1) / rpt::kSlotTile;
    const int stages = staged ? tiles * nk : 0;
    int incl = stages;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned sm = __ballot_sync(kFull, staged);
    const unsigned zm = __ballot_sync(kFull, head && len == 0);
    if (staged) {
      const int r = __popc(sm & lower);
      r_slot[r] = lane * m;
      r_rows[r] = rows;
      r_blk[r] = min(max(kb, 0), a.g - 1);
      r_len[r] = len;
      r_s0[r] = incl - stages;
    } else if (head) {
      const int z = __popc(zm & lower);
      z_slot[z] = lane * m;
      z_rows[z] = rows;
    }
    if (lane == 31) {
      r_s0[__popc(sm)] = incl;
      counts[0] = __popc(sm);
      counts[1] = __popc(zm);
    }
    if (a.reads && sm) {
      // the bytes copied: the block's rows once, its pairs' query rows once
      // a slot tile
      unsigned long long bytes = 0;
      if (staged) {
        int pairs = 0;
        for (int i = 0; i < rows; ++i) pairs += tps[lane * m + i] >= 0;
        bytes = ((unsigned long long)len * sizeof(T) + (unsigned long long)pairs * tiles * 4) * d;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(kFull, bytes, o);
      if (lane == 0) {
        atomicAdd(a.reads, (unsigned long long)__popc(sm));
        atomicAdd(a.reads + 1, bytes);
      }
    }
  }
  __syncthreads();
  const int nr = counts[0];
  for (int z = 0; z < counts[1]; ++z) {  // blocks with no occupied row: +inf rows
    for (int i = tid; i < z_rows[z] * lmax; i += kThreads) {
      const int e = tps[z_slot[z] + i / lmax];
      if (e >= 0) a.out[(size_t)e * lmax + i % lmax] = INFINITY;
    }
  }

  // stage s holds columns [kc * DC, kc * DC + DC) of slot tile st of the run
  // r holding it, s - r_s0[r] = st * nk + kc, and the same columns of r's
  // query rows, in ring buffer s % K; the producer walks (r, st, kc) one
  // stage a call
  const int total = r_s0[nr];
  const T* x = static_cast<const T*>(a.x);
  int pr = 0, pst = 0, pkc = 0, pslot = 0;  // the next stage to issue and its ring slot
  // this thread's 16-byte pieces of a stage of whole 128-byte row chunks:
  // rows r0 + 32 k at column cv
  const int r0 = tid / (rpt::kChunkBytes / 16);
  const int cv = tid % (rpt::kChunkBytes / 16) * S::V;
  // and of its query columns: rows q0p + 256 k / (DC / 4) at column qcv
  constexpr int QP = S::DC / 4;  // 16-byte pieces of a query row's chunk
  const int q0p = tid / QP;
  const int qcv = tid % QP * 4;
  auto issue = [&](int s) {
    if (s < total) {
      float* stage = ring + (size_t)pslot * SW;
      T* xs = reinterpret_cast<T*>(stage);
      const int len = r_len[pr];
      const int rows = min(rpt::kSlotTile, len - pst * rpt::kSlotTile);
      const int c0 = pkc * S::DC;
      const T* xb = x + (size_t)r_blk[pr] * lmax * d;
      if (a.vec && c0 + S::DC <= d) {
        const T* src = xb + (size_t)(pst * rpt::kSlotTile) * d + c0 + cv;
#pragma unroll
        for (int k = 0; k < rpt::kSlotTile * (rpt::kChunkBytes / 16) / kThreads; ++k) {
          const int r = r0 + k * (kThreads / (rpt::kChunkBytes / 16));
          if (r < rows) rpt::tile_cp_async16(xs + r * S::XS + cv, src + (size_t)r * d);
        }
      } else {
        rpt::stage_rows(xs, xb, rows, pst * rpt::kSlotTile, d, c0, a.vec);
      }
      // the run's query rows, the same columns, zero past d
      float* qs = stage + S::kStageFloats;
      const int* qr = tqr + r_slot[pr];
      const int qrows = r_rows[pr];
      if (a.qvec) {
#pragma unroll
        for (int k = 0; k < kRunSlots * QP / kThreads; ++k) {
          const int row = q0p + k * (kThreads / QP);
          const int c = c0 + qcv;
          if (c >= d) {
            *reinterpret_cast<float4*>(qs + row * QS + qcv) = make_float4(0.f, 0.f, 0.f, 0.f);
          } else if (row < qrows && qr[row] >= 0) {
            rpt::tile_cp_async16(qs + row * QS + qcv, a.q + (size_t)qr[row] * d + c);
          }
        }
      } else {
        for (int i = tid; i < kRunSlots * S::DC; i += kThreads) {
          const int row = i / S::DC;
          const int cc = i - row * S::DC;
          if (c0 + cc >= d)
            qs[row * QS + cc] = 0.0f;
          else if (row < qrows && qr[row] >= 0)
            cp_async4(qs + row * QS + cc, a.q + (size_t)qr[row] * d + c0 + cc);
        }
      }
      if (++pkc == nk) {
        pkc = 0;
        if (++pst * rpt::kSlotTile >= len) {
          pst = 0;
          ++pr;
        }
      }
      if (++pslot == K) pslot = 0;
    }
    rpt::tile_cp_commit();  // an empty group past the last stage keeps the count
  };
  for (int s = 0; s < K - 1; ++s) issue(s);

  // one slot tile of run cr, stages s .. s + nk - 1, with H query rows a
  // thread (f32) or H mma row groups a warp (bf16) in registers
  const int jj = F32 ? tid % rpt::kSlotTile : warp * 16;
  const int g8 = lane >> 2;  // the mma fragments' row group
  const int t4 = lane & 3;   // and column pair
  int s = 0;
  int cr = 0;     // the run of stage s
  int cslot = 0;  // and its ring slot
  auto slot_tile = [&](auto hc) {
    constexpr int H = decltype(hc)::value;
    const int rows = r_rows[cr];
    const int len = r_len[cr];
    const int* pairs = tps + r_slot[cr];
    const float* sqb = a.sq + (size_t)r_blk[cr] * lmax;
    const int j = (s - r_s0[cr]) / nk * rpt::kSlotTile + jj;
    const int q0 = F32 ? tid / rpt::kSlotTile * H : 0;
    // the slot norms, loaded while the stages land
    const int ja = F32 ? j : j + g8;
    const float sqa = ja < len ? sqb[ja] : 0.0f;
    const float sqc = !F32 && ja + 8 < len ? sqb[ja + 8] : 0.0f;
    float acc[H][4];
#pragma unroll
    for (int h = 0; h < H; ++h) acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.0f;
    // |q|^2 of rows warp + 8 w: this lane's chain over its columns
    float nrm[kRunSlots / 8];
#pragma unroll
    for (int w = 0; w < kRunSlots / 8; ++w) nrm[w] = 0.0f;
    for (int kc = 0; kc < nk; ++kc, ++s) {
      cp_wait(K - 2);   // stage s has landed, its query columns with it
      __syncthreads();  // stage s seen by all; every thread past stage s - 1
      issue(s + K - 1);  // into stage s - 1's slot
      if (kc == 0 && s == r_s0[cr]) {  // +inf past the block's occupancy
        const int w = lmax - len;
        for (int i = tid; i < rows * w; i += kThreads) {
          const int e = pairs[i / w];
          if (e >= 0) a.out[(size_t)e * lmax + len + i % w] = INFINITY;
        }
      }
      const float* stage = ring + (size_t)cslot * SW;
      const T* xs = reinterpret_cast<const T*>(stage);
      const float* qs = stage + S::kStageFloats;
      if (++cslot == K) cslot = 0;
      const int c0 = kc * S::DC;
#pragma unroll
      for (int w = 0; w < kRunSlots / 8; ++w) {
        const int i = warp + 8 * w;
        if (i < rows) {
#pragma unroll
          for (int h = 0; h < S::DC / 32; ++h) {
            const float v = qs[i * QS + 32 * h + lane];
            if (c0 + 32 * h + lane < d) nrm[w] = fmaf(v, v, nrm[w]);
          }
        }
      }
      if constexpr (F32) {
        if (j < len && q0 < rows) {
          if (c0 + S::DC <= d)  // a whole column chunk
            rpt::f32_dots<H, H, true>(acc, xs + jj * S::XS, qs, QS, q0, 0, S::DC / 4);
          else
            rpt::f32_dots<H>(acc, xs + jj * S::XS, qs, QS, q0, 0, (d - c0 + 3) / 4);
        }
      } else if (j < len) {
        bf16_dots_f32q(acc, reinterpret_cast<const uint32_t*>(xs) + (jj + g8) * (S::XS / 2) + t4,
                       qs, (min(S::DC, d - c0) + 15) / 16, rows);
      }
    }
#pragma unroll
    for (int w = 0; w < kRunSlots / 8; ++w) {
      const int i = warp + 8 * w;
      if (i < rows) {
        const float v = rpt::warp_sum(nrm[w]);
        if (lane == 0) qq[i] = v;
      }
    }
    __syncthreads();  // the norms seen by all
    // each distance from the registers that summed it to its pair's row
    if constexpr (F32) {
      if (j < len) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const int i = q0 + h;
          const int e = i < rows ? pairs[i] : -1;
          if (e >= 0)
            a.out[(size_t)e * lmax + j] = rpt::factored_l2(sqa, rpt::f32_dot(acc[h]), qq[i], a.l2);
        }
      }
    } else if (j < len) {
#pragma unroll
      for (int n = 0; n < H; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = n * 8 + 2 * t4 + h;
          const int e = i < rows ? pairs[i] : -1;
          if (e >= 0) {
            float* o = a.out + (size_t)e * lmax;
            if (ja < len) o[ja] = rpt::factored_l2(sqa, acc[n][h], qq[i], a.l2);
            if (ja + 8 < len) o[ja + 8] = rpt::factored_l2(sqc, acc[n][2 + h], qq[i], a.l2);
          }
        }
      }
    }
  };
  while (s < total) {
    while (s >= r_s0[cr + 1]) ++cr;
    const int rows = r_rows[cr];
    if constexpr (F32) {  // ceil(rows / 2) a thread, rounded up to a power of 2
      if (rows <= 2)
        slot_tile(Rows<1>{});
      else if (rows <= 4)
        slot_tile(Rows<2>{});
      else if (rows <= 8)
        slot_tile(Rows<4>{});
      else if (rows <= 16)
        slot_tile(Rows<8>{});
      else
        slot_tile(Rows<16>{});
    } else {  // ceil(rows / 8) mma row groups
      if (rows <= 8)
        slot_tile(Rows<1>{});
      else if (rows <= 16)
        slot_tile(Rows<2>{});
      else if (rows <= 24)
        slot_tile(Rows<3>{});
      else
        slot_tile(Rows<4>{});
    }
  }
  rpt::tile_cp_wait<0>();

  // pairs in no tile: this thread block's share of them reads +inf
  if (a.slot) {
    const long long lo = a.e * blockIdx.x / gridDim.x;
    const long long hi = a.e * (blockIdx.x + 1) / gridDim.x;
    const long long none = (long long)a.nt * m;
    for (long long i = lo + tid; i < hi; i += kThreads) {
      if (a.slot[i] >= none) {
        float* o = a.out + i * lmax;
        for (int c = 0; c < lmax; ++c) o[c] = INFINITY;
      }
    }
  }
}

template <typename T>
int launch(Args a, cudaStream_t stream) {
  if (a.m < 1 || a.m > kRunSlots || a.nt < 0 || a.p < 1 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  a.run_tiles = max(1, kRunSlots / a.m);
  if (a.range_tiles < 1 || a.range_tiles > min(kMaxTiles, max(1, kRangeSlots / a.m)))
    return (int)cudaErrorInvalidValue;
  const long long grid = max(1LL, ((long long)a.nt + a.range_tiles - 1) / a.range_tiles);
  if (a.nt == 0 && (a.slot == nullptr || a.e == 0)) return 0;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.vec = rpt::vec_rows(static_cast<const T*>(a.x), a.d);
  a.qvec = a.d % 4 == 0 && (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;
  // The ring's depth reaches the kernel as an argument: as a compile-time
  // constant, ptxas spilled more of the f32 kernel (464 bytes of loads
  // against 108) and the D 128 grouped chunk took 4% longer (H100).
  a.ring = kRing;
  constexpr size_t bytes = score_bytes<T>();
  cudaError_t e = rpt::allow_smem(grouped_score_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  grouped_score_kernel<T><<<(unsigned)grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments packed as int64 (ops/grouped_kernel.py _SCORE_ARGS): x, sq,
// tb, tp, lens, slot, q, out, reads (null, or two counters: stagings and
// staged bytes), pairs, nt, g, tile_m, lmax, d, p, l2, bf16, the tiles a
// thread block takes (1 to min(32, 256 / tile_m)), stream.  Returns a
// cudaError_t code: 0 on a good launch; cudaErrorInvalidValue for a tile_m
// outside [1, 32] or a range outside its bounds.  The shared memory does not
// depend on D, so every width launches.
int rpt_grouped_score(const long long* v) {
  Args a{};
  a.x = reinterpret_cast<const void*>(v[0]);
  a.sq = reinterpret_cast<const float*>(v[1]);
  a.tb = reinterpret_cast<const int*>(v[2]);
  a.tp = reinterpret_cast<const int*>(v[3]);
  a.lens = reinterpret_cast<const int*>(v[4]);
  a.slot = reinterpret_cast<const long long*>(v[5]);
  a.q = reinterpret_cast<const float*>(v[6]);
  a.out = reinterpret_cast<float*>(v[7]);
  a.reads = reinterpret_cast<unsigned long long*>(v[8]);
  a.e = v[9];
  a.nt = (int)v[10];
  a.g = (int)v[11];
  a.m = (int)v[12];
  a.lmax = (int)v[13];
  a.d = (int)v[14];
  a.p = (int)v[15];
  a.l2 = (int)v[16];
  a.range_tiles = (int)v[18];
  cudaStream_t s = reinterpret_cast<cudaStream_t>(v[19]);
  return v[17] ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

const char* rpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
