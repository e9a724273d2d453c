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
// With bf16 blocks the query is rounded to bf16 first (nearest even; once
// per call, by rpt_pair_runs), as the Pallas kernel's
// q.astype(x_leaf.dtype) does, so every product of two bf16 values is
// exact in fp32; sums are fp32 FMAs, never TF32.  Block rows are clamped
// into [0, G).  Distances, masks and the selection stay in plain torch, as
// they stay in XLA in the JAX package.
//
// What bounds it on an H100: bytes.  Each (query, probe) pair needs one
// block (lmax * D * 4 bytes in f32, half that in bf16) for 2 operations per
// element: 0.5 (f32) or 1 (bf16) operation per byte, far below the card's
// fp32 balance.  The floor is reading each DISTINCT block once: the pairs
// of one launch probe the same block again and again (on the clustered
// chunk 16,384 pairs touch 7,030 blocks), and the blocks do not fit in L2.
// The design therefore works block-major:
//
// - A first launch (rpt_pair_runs) orders the pairs by block row, clamped
//   into [0, G), with a counting sort on the card (a histogram, one scan
//   of the G counts, a scatter by atomic cursors), and cuts each block's
//   run of pairs into work items of at most 8 pairs: (first slot, pairs,
//   block) and their number.  No value is read back to the host.
// - A persistent grid, sized to what the SMs hold, walks the work units:
//   an item and a segment of up to 2 row tiles of 128 rows of its block
//   (one on the clustered chunk, thirteen a block on the bracket's 3,128
//   rows).  For a unit, a thread block streams its tiles through shared
//   memory once, one 128-byte column chunk of every row at a time,
//   double-buffered with cp.async (16 bytes per copy, asking L2 for the
//   256-byte line, so a row's next chunk is on its way) across chunks and
//   tiles, beside the item's query rows for the same columns.  Two stages
//   of 128-byte chunks keep a block small (41 KB of shared memory for
//   bf16), so five blocks run on an SM; deeper rings, wider chunks and
//   query rows kept for the whole unit measured slower, by fewer blocks in
//   flight.  Each thread owns one row and keeps one fp32 sum per pair of
//   the item in registers, from four FMA chains a chunk; the query chunk is
//   read as a broadcast, the row chunk from a row stride padded to an odd
//   number of 16-byte units so that the row reads do not collide in the
//   banks.  Rows that are not 16-byte aligned (D not a multiple of the
//   vector, or an unaligned base) are staged with plain loads, zero-padded
//   to the vector.
// - For every pair of the item it writes dots[b, p, rows] and sqx[b, p,
//   rows]; the output layout [B, P, lmax] is the Pallas kernel's.
//
// So a block is read from device memory once per work item: once, unless
// more than 8 pairs probe it.
//
// Shared-row mode (rpt_gather_score_shared_*; replaces, with the Pallas
// kernel, rptree_tpu/ops/shared.py fetch_blocks): the packed layout is one
// row store rows [N, D] and each block's id table ids [G, lmax] (-1 in empty
// slots), so slot j of block g is row rows[ids[g, j]], and an empty slot a
// row of zeros, as in a blocked pack.  It is a compile-time variant of the
// same kernel: at the start of a work unit its thread block copies the
// segment's row ids (clamped below N) into shared memory, and every stage
// reads row rid[j] where the blocked route reads row j of the block; an
// empty slot's copies zero-fill without a read (cp.async with a source
// size of 0).  Every empty slot reading one real row instead would send
// a quarter of a chunk's copies, from every SM, to the same lines: that
// measured 3.3x the blocked route's time.  The runs, items, ring and FMA
// order are the blocked route's, so the dots are bit-equal to it over the
// same rows; the slot norms come from the layout's own sq table [G, lmax].

#include "grouped_tile.cuh"

namespace {

constexpr int RT = 128;            // rows per tile: one per thread
constexpr int kSegTiles = 2;       // row tiles per work unit
constexpr int kStages = 2;         // ring depth
constexpr int kChunkBytes = 128;   // a row's bytes per column chunk
constexpr int kMaxPairs = 8;       // pairs per work item, at most

template <typename T>
struct Shape {
  static constexpr int V = 16 / sizeof(T);            // elements per 16 bytes
  static constexpr int DC = kChunkBytes / sizeof(T);  // columns per chunk
  static constexpr int XS = DC + V;                   // row stride: an odd count of 16 bytes
  static constexpr int kStage = RT * XS * sizeof(T) + kMaxPairs * DC * sizeof(float);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
// The same copy, reading src_bytes (0 or 16) and zero-filling the rest.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V elements of a staged row, as floats.
__device__ __forceinline__ void load_row(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Row j of the block: row j of xb on the blocked route; on the shared-row
// route (xb the row store) row rid[j - jbase] of the segment's staged ids,
// and null for an empty slot (id -1).
template <typename T, bool kShared>
__device__ __forceinline__ const T* block_row(const T* __restrict__ xb, const int* rid,
                                              int jbase, int j, int d) {
  if constexpr (kShared) {
    const int id = rid[j - jbase];
    return id < 0 ? nullptr : xb + (size_t)id * d;
  }
  return xb + (size_t)j * d;
}

// Stages columns [c0, c0 + DC) of rows [j0, j0 + rows) of block xb and of
// the item's query rows (already rounded to the block type) into one
// stage, as one cp.async group.  vec: 16-byte cp.async copies (d % V == 0,
// x and q 16-byte aligned); else plain loads, zeros past d.
template <typename T, bool kShared>
__device__ void stage_chunk(T* xs, float* qs, const T* __restrict__ xb, const int* rid,
                            int jbase, const float* __restrict__ q, const int* qrow, int cnt,
                            int rows, int j0, int d, int c0, int vec) {
  using S = Shape<T>;
  const int w = min(S::DC, d - c0);
  if (vec) {
    const int ppr = w / S::V;
    for (int i = threadIdx.x; i < rows * ppr; i += RT) {
      const int r = i / ppr;
      const int c = (i - r * ppr) * S::V;
      if constexpr (kShared) {  // an empty slot: zeros, no read
        const T* row = block_row<T, true>(xb, rid, jbase, j0 + r, d);
        cp_async16_zfill(xs + r * S::XS + c, (row ? row : xb) + c0 + c, row ? 16 : 0);
      } else {
        cp_async16(xs + r * S::XS + c, block_row<T, false>(xb, rid, jbase, j0 + r, d) + c0 + c);
      }
    }
    const int qpr = w / 4;
    for (int i = threadIdx.x; i < cnt * qpr; i += RT) {
      const int j = i / qpr;
      const int c = (i - j * qpr) * 4;
      cp_async16(qs + j * S::DC + c, q + (size_t)qrow[j] * d + c0 + c);
    }
  } else {
    const int wp = (w + S::V - 1) / S::V * S::V;
    for (int i = threadIdx.x; i < rows * wp; i += RT) {
      const int r = i / wp;
      const int c = i - r * wp;
      const T* row = block_row<T, kShared>(xb, rid, jbase, j0 + r, d);
      xs[r * S::XS + c] = c < w && row != nullptr ? row[c0 + c] : T(0.0f);
    }
    for (int i = threadIdx.x; i < cnt * S::DC; i += RT) {
      const int j = i / S::DC;
      const int c = i - j * S::DC;
      qs[i] = c0 + c < d ? q[(size_t)qrow[j] * d + c0 + c] : 0.0f;
    }
  }
  cp_async_commit();
}

// Persistent: thread block i takes units i, i + gridDim.x, ... of the
// nitems[0] items (start[it], count[it], block[it]: the pairs order[start
// .. start + count) on one block) times their segments of kSegTiles row
// tiles.  kShared: x is the row store [nrows, D] and ids the blocks' id
// tables [G, lmax] (unused on the blocked route).
template <typename T, bool kShared>
__global__ void __launch_bounds__(RT)
gather_score_kernel(const T* __restrict__ x, const int* __restrict__ ids, long nrows,
                    const float* __restrict__ sq,
                    const float* __restrict__ q, const int* __restrict__ order,
                    const int* __restrict__ start, const int* __restrict__ count,
                    const int* __restrict__ block, const int* __restrict__ nitems,
                    float* __restrict__ dots, float* __restrict__ sqx, int p, int lmax, int d,
                    int vec) {
  using S = Shape<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int pair[kMaxPairs];
  __shared__ int qrow[kMaxPairs];
  __shared__ int rid[kShared ? kSegTiles * RT : 1];  // the segment's row ids
  const int r = threadIdx.x;
  const int nchunk = (d + S::DC - 1) / S::DC;
  const int ntiles = (lmax + RT - 1) / RT;
  const int nseg = (ntiles + kSegTiles - 1) / kSegTiles;
  const long units = (long)nitems[0] * nseg;
  for (long u = blockIdx.x; u < units; u += gridDim.x) {
    const int it = (int)(u / nseg);
    const int t0 = (int)(u - (long)it * nseg) * kSegTiles;  // the segment's first tile
    const int nsteps = (min(ntiles, t0 + kSegTiles) - t0) * nchunk;  // (tile, chunk)
    const int cnt = count[it];
    const long blk = block[it];
    if (threadIdx.x < cnt) {
      pair[threadIdx.x] = order[start[it] + threadIdx.x];
      qrow[threadIdx.x] = pair[threadIdx.x] / p;
    }
    const int jbase = t0 * RT;
    if constexpr (kShared) {
      const int jn = min(lmax, jbase + kSegTiles * RT) - jbase;
      for (int i = threadIdx.x; i < jn; i += RT) {
        const int id = ids[(size_t)blk * lmax + jbase + i];
        rid[i] = id < 0 ? -1 : (id < nrows ? id : (int)(nrows - 1));
      }
    }
    __syncthreads();
    const T* xb = kShared ? x : x + (size_t)blk * lmax * d;
    auto xs = [&](int step) {
      return reinterpret_cast<T*>(smem + step % kStages * S::kStage);
    };
    auto qs = [&](int step) {
      return reinterpret_cast<float*>(smem + step % kStages * S::kStage +
                                      RT * S::XS * sizeof(T));
    };
    auto stage = [&](int step) {  // an empty group past the last step
      if (step < nsteps) {
        const int j0 = (t0 + step / nchunk) * RT;
        stage_chunk<T, kShared>(xs(step), qs(step), xb, rid, jbase, q, qrow, cnt,
                                min(RT, lmax - j0), j0, d, step % nchunk * S::DC, vec);
      } else {
        cp_async_commit();
      }
    };
    float acc[kMaxPairs];
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) acc[j] = 0.0f;
    for (int s = 0; s < kStages - 1; ++s) stage(s);
    for (int step = 0; step < nsteps; ++step) {
      stage(step + kStages - 1);
      cp_async_wait<kStages - 1>();  // the group of this step has landed
      __syncthreads();
      const float* qc = qs(step);
      const int c = step % nchunk;
      const int j0 = (t0 + step / nchunk) * RT;
      const int rows = min(RT, lmax - j0);
      const int w = min(S::DC, d - c * S::DC);
      const int kw = (w + S::V - 1) / S::V * S::V;
      if (r < rows) {
        // per pair, four FMA chains over the chunk (one per position in a
        // float4), added as a tree into the row's sum: a shorter chain
        // than one FMA per element, so the sum stays as close to the other
        // kernels' shuffle trees as their checks need
        const T* xr = xs(step) + r * S::XS;
        float part[kMaxPairs][4];
#pragma unroll
        for (int j = 0; j < kMaxPairs; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) part[j][h] = 0.0f;
        for (int e = 0; e < kw; e += S::V) {
          float v[S::V];
          load_row(xr + e, v);
#pragma unroll
          for (int j = 0; j < kMaxPairs; ++j) {
            if (j < cnt) {
#pragma unroll
              for (int h = 0; h < S::V / 4; ++h) {
                const float4 qv = *reinterpret_cast<const float4*>(qc + j * S::DC + e + 4 * h);
                part[j][0] = fmaf(qv.x, v[4 * h], part[j][0]);
                part[j][1] = fmaf(qv.y, v[4 * h + 1], part[j][1]);
                part[j][2] = fmaf(qv.z, v[4 * h + 2], part[j][2]);
                part[j][3] = fmaf(qv.w, v[4 * h + 3], part[j][3]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxPairs; ++j)
          acc[j] += (part[j][0] + part[j][1]) + (part[j][2] + part[j][3]);
        if (c == nchunk - 1) {  // the tile's rows are summed: write them
          const float sv = sq[(size_t)blk * lmax + j0 + r];
#pragma unroll
          for (int j = 0; j < kMaxPairs; ++j) {
            if (j < cnt) {
              const size_t o = (size_t)pair[j] * lmax + j0 + r;
              dots[o] = acc[j];
              sqx[o] = sv;
            }
            acc[j] = 0.0f;
          }
        }
      }
      __syncthreads();  // the stage is refilled kStages - 1 steps on
    }
    cp_async_wait<0>();  // the empty groups
  }
}

// -- the query route of the shared-row mode --------------------------------

constexpr int kQThreads = 128;
constexpr int kSegChunks = 4;  // 128-byte chunks a staged row segment, at most

// One 128-byte column chunk of a staged row against the query's: four FMA
// chains over the chunk, added as a tree (the blocked route's order).
template <typename T>
__device__ __forceinline__ float chunk_dot(const T* xr, const float* qc, int kw) {
  using S = Shape<T>;
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int e = 0; e < kw; e += S::V) {
    float v[S::V];
    load_row(xr + e, v);
#pragma unroll
    for (int h = 0; h < S::V / 4; ++h) {
      const float4 qv = *reinterpret_cast<const float4*>(qc + e + 4 * h);
      part[0] = fmaf(qv.x, v[4 * h], part[0]);
      part[1] = fmaf(qv.y, v[4 * h + 1], part[1]);
      part[2] = fmaf(qv.z, v[4 * h + 2], part[2]);
      part[3] = fmaf(qv.w, v[4 * h + 3], part[3]);
    }
  }
  return (part[0] + part[1]) + (part[2] + part[3]);
}

// The same for a row of zeros (an empty slot), the blocked route's bits.
__device__ __forceinline__ float zero_chunk_dot(const float* qc, int kw) {
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int e = 0; e < kw; e += 4)
#pragma unroll
    for (int h = 0; h < 4; ++h) part[h] = fmaf(qc[e + h], 0.0f, part[h]);
  return (part[0] + part[1]) + (part[2] + part[3]);
}

// The columns a staged row segment covers, and its stride in elements: an
// odd count of 16 bytes, so that the row reads do not collide in banks.
template <typename T>
struct QueryShape {
  int nchunk, cps, segw, nseg, stride;
  __host__ __device__ QueryShape(int d) {
    using S = Shape<T>;
    nchunk = (d + S::DC - 1) / S::DC;
    cps = nchunk < kSegChunks ? nchunk : kSegChunks;
    segw = cps * S::DC;
    nseg = (nchunk + cps - 1) / cps;
    stride = segw + S::V;
  }
};

template <typename T>
size_t query_smem(int p, int lmax, int d, int rs, int hbits) {
  const QueryShape<T> qs(d);
  return (size_t)kStages * rs * qs.stride * sizeof(T) + sizeof(float) * qs.nchunk * Shape<T>::DC +
         sizeof(int) * ((size_t)2 * ((size_t)1 << hbits) + 2 * (size_t)p * lmax + p);
}

// The entry of row id in the query's hash: linear probing from its hash.
__device__ __forceinline__ int hash_slot(const int* keys, int id, int hbits) {
  int h = (int)(((unsigned)id * 0x9E3779B1u) >> (32 - hbits));
  while (keys[h] != id) h = (h + 1) & ((1 << hbits) - 1);
  return h;
}

// One thread block a query b: its P blocks' slots (ids and norms read once, as one batch of
// loads), the distinct rows they name by a hash in shared memory (empty
// slots name none), each distinct row streamed once, whole (up to 512
// bytes a segment, 16-byte cp.async copies, a warp on a row) through a
// ring of kStages stages of `rs` rows, one thread a row summing its dot
// with q[b]; then every slot's dot from its row's, zdot for an empty one.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
gather_query_kernel(const T* __restrict__ x, const int* __restrict__ ids, long nrows,
                    const float* __restrict__ sq, const float* __restrict__ q,
                    const int* __restrict__ sel, float* __restrict__ dots,
                    float* __restrict__ sqx, int p, int g, int lmax, int d, int vec, int rs,
                    int hbits) {
  using S = Shape<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int nd;
  __shared__ float zdot;
  const QueryShape<T> sh(d);
  const int nslots = p * lmax, hmask = (1 << hbits) - 1;
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + (size_t)kStages * rs * sh.stride * sizeof(T));
  int* keys = reinterpret_cast<int*>(qs + sh.nchunk * S::DC);
  float* vals = reinterpret_cast<float*>(keys + hmask + 1);  // a distinct row's dot
  int* pos = reinterpret_cast<int*>(vals + hmask + 1);       // a slot's id, then entry
  int* list = pos + nslots;                                  // the distinct rows' ids
  int* bsel = list + nslots;
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i <= hmask; i += kQThreads) keys[i] = -1;
  if (threadIdx.x == 0) nd = 0;
  for (int j = threadIdx.x; j < p; j += kQThreads)
    bsel[j] = min(max(sel[(size_t)b * p + j], 0), g - 1);
  for (int c = threadIdx.x; c < sh.nchunk * S::DC; c += kQThreads) {
    float v = c < d ? q[(size_t)b * d + c] : 0.0f;
    if (sizeof(T) == 2) v = __bfloat162float(__float2bfloat16_rn(v));
    qs[c] = v;
  }
  __syncthreads();
  const size_t out0 = (size_t)b * nslots;
  // the slots' ids and norms as one batch of loads, then the hash: a
  // thread hashes the slots it loaded
  for (int s = threadIdx.x; s < nslots; s += kQThreads) {
    const int pp = s / lmax;
    const size_t off = (size_t)bsel[pp] * lmax + (s - pp * lmax);
    pos[s] = ids[off];
    sqx[out0 + s] = sq[off];
  }
  for (int s = threadIdx.x; s < nslots; s += kQThreads) {
    int id = pos[s], h = -1;
    if (id >= 0) {
      id = id < nrows ? id : (int)(nrows - 1);
      h = (int)(((unsigned)id * 0x9E3779B1u) >> (32 - hbits));
      while (true) {
        const int old = atomicCAS(keys + h, -1, id);
        if (old == -1) {
          list[atomicAdd(&nd, 1)] = id;
          break;
        }
        if (old == id) break;
        h = (h + 1) & hmask;
      }
    }
    pos[s] = h;
  }
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int c = 0; c < sh.nchunk; ++c) {
      const int w = min(S::DC, d - c * S::DC);
      acc += zero_chunk_dot(qs + c * S::DC, (w + S::V - 1) / S::V * S::V);
    }
    zdot = acc;
  }
  __syncthreads();
  const int n = nd;
  const int nsteps = (n + rs - 1) / rs * sh.nseg;  // (row group, segment)
  auto ring_at = [&](int step) { return ring + (size_t)(step % kStages) * rs * sh.stride; };
  auto stage = [&](int step) {  // an empty group past the last step
    if (step < nsteps) {
      const int gi = step / sh.nseg, si = step - gi * sh.nseg;
      const int r0 = gi * rs, rows_n = min(rs, n - r0);
      const int c0 = si * sh.segw, w = min(sh.segw, d - c0);
      T* xs = ring_at(step);
      if (vec) {
        const int upr = w / S::V;
        for (int i = threadIdx.x; i < rows_n * upr; i += kQThreads) {
          const int r = i / upr, u = i - r * upr;
          const size_t id = (size_t)list[r0 + r];
          cp_async16(xs + r * sh.stride + u * S::V, x + id * d + c0 + u * S::V);
        }
      } else {
        const int wp = (w + S::V - 1) / S::V * S::V;
        for (int i = threadIdx.x; i < rows_n * wp; i += kQThreads) {
          const int r = i / wp, c = i - r * wp;
          const size_t id = (size_t)list[r0 + r];
          xs[r * sh.stride + c] = c < w ? x[id * d + c0 + c] : T(0.0f);
        }
      }
    }
    cp_async_commit();
  };
  float acc = 0.0f;
  for (int s = 0; s < kStages - 1; ++s) stage(s);
  for (int step = 0; step < nsteps; ++step) {
    stage(step + kStages - 1);
    cp_async_wait<kStages - 1>();  // the group of this step has landed
    __syncthreads();
    const int gi = step / sh.nseg, si = step - gi * sh.nseg;
    const int r0 = gi * rs;
    if (threadIdx.x < min(rs, n - r0)) {
      const T* xr = ring_at(step) + threadIdx.x * sh.stride;
      const int c1 = min(sh.nchunk, (si + 1) * sh.cps);
      for (int c = si * sh.cps; c < c1; ++c) {
        const int w = min(S::DC, d - c * S::DC);
        acc += chunk_dot(xr + (c - si * sh.cps) * S::DC, qs + c * S::DC,
                         (w + S::V - 1) / S::V * S::V);
      }
      if (si == sh.nseg - 1) {
        vals[hash_slot(keys, list[r0 + threadIdx.x], hbits)] = acc;
        acc = 0.0f;
      }
    }
    __syncthreads();  // the stage is refilled kStages - 1 steps on
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int s = threadIdx.x; s < nslots; s += kQThreads) {
    const int h = pos[s];
    dots[out0 + s] = h < 0 ? zdot : vals[h];
  }
}

template <typename T>
int launch_query(const T* x, const int* ids, long nrows, const float* sq, const float* q,
                 const int* sel, float* dots, float* sqx, int b, int p, int g, int lmax, int d,
                 int rs, int hbits, void* stream) {
  if (b < 0 || p < 1 || g < 1 || lmax < 1 || d < 1 || nrows < 1 || rs < 1 ||
      rs > kQThreads || hbits < 6 || hbits > 16 ||
      (1L << hbits) < (long)p * lmax + 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const size_t smem = query_smem<T>(p, lmax, d, rs, hbits);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int vec = d % Shape<T>::V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  cudaError_t e = rpt::allow_smem(gather_query_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  gather_query_kernel<T><<<(unsigned)b, kQThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, ids, nrows, sq, q, sel, dots, sqx, p, g, lmax, d, vec, rs, hbits);
  return (int)cudaGetLastError();
}

// -- the work items --------------------------------------------------------

constexpr int kScanThreads = 1024;

// Also rounds the nq query values q to bf16 into qr where qr is given (the
// queries of bf16 blocks), in the same launch.
__global__ void histogram_kernel(const int* __restrict__ sel, long n, int g, int* counts,
                                 const float* __restrict__ q, float* __restrict__ qr, long nq) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(counts + min(max(sel[i], 0), g - 1), 1);
  if (qr != nullptr)
    for (long j = i; j < nq; j += (long)gridDim.x * blockDim.x)
      qr[j] = __bfloat162float(__float2bfloat16_rn(q[j]));
}

// One block: offsets (and the cursors) = the exclusive prefix sums of counts.
__global__ void __launch_bounds__(kScanThreads)
scan_counts_kernel(const int* __restrict__ counts, int* offsets, int* cursor, int g) {
  __shared__ int warp_tot[kScanThreads / 32];
  const int per = (g + kScanThreads - 1) / kScanThreads;
  const int lo = min(g, threadIdx.x * per), hi = min(g, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;  // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = warp_tot[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += o;
    }
    warp_tot[lane] = t - warp_tot[lane];  // exclusive over warps
  }
  __syncthreads();
  int run = warp_tot[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    cursor[i] = run;
    run += counts[i];
  }
}

// Each pair takes the next slot of its block's run; the pair at every
// kMaxPairs-th slot of a run opens a work item.
__global__ void scatter_kernel(const int* __restrict__ sel, long n, int g,
                               const int* __restrict__ counts, const int* __restrict__ offsets,
                               int* cursor, int* order, int* start, int* count, int* block,
                               int* nitems) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int blk = min(max(sel[i], 0), g - 1);
  const int slot = atomicAdd(cursor + blk, 1);
  order[slot] = (int)i;
  const int rel = slot - offsets[blk];
  if (rel % kMaxPairs == 0) {
    const int it = atomicAdd(nitems, 1);
    start[it] = slot;
    count[it] = min(kMaxPairs, counts[blk] - rel);
    block[it] = blk;
  }
}

// The int32 scratch of rpt_pair_runs: counts[g], nitems[1], offsets[g],
// cursor[g], then order, start, count, block [n] each.
struct Runs {
  int *counts, *nitems, *offsets, *cursor, *order, *start, *count, *block;
};

Runs runs_of(int* base, int g, long n) {
  Runs t;
  t.counts = base;
  t.nitems = t.counts + g;
  t.offsets = t.nitems + 1;
  t.cursor = t.offsets + g;
  t.order = t.cursor + g;
  t.start = t.order + n;
  t.count = t.start + n;
  t.block = t.count + n;
  return t;
}

template <typename T, bool kShared>
int launch(const T* x, const int* ids, long nrows, const float* sq, const float* q,
           const int* runs, float* dots, float* sqx, int b, int p, int g, int lmax, int d,
           void* stream) {
  if (b < 0 || p < 1 || g < 1 || lmax < 1 || d < 1 || (kShared && nrows < 1))
    return (int)cudaErrorInvalidValue;
  const long pairs = (long)b * p;
  if (pairs == 0) return 0;
  if (pairs > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  using S = Shape<T>;
  const int vec = d % S::V == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                      reinterpret_cast<uintptr_t>(q)) & 15) == 0;
  const size_t smem = kStages * (size_t)S::kStage;
  cudaError_t e = rpt::allow_smem(gather_score_kernel<T, kShared>, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_score_kernel<T, kShared>,
                                                      RT, smem);
  if (e != cudaSuccess) return (int)e;
  const Runs t = runs_of(const_cast<int*>(runs), g, pairs);
  const long grid = min(pairs, (long)sms * (per_sm > 0 ? per_sm : 1));
  gather_score_kernel<T, kShared><<<(unsigned)grid, RT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, ids, nrows, sq, q, t.order, t.start, t.count, t.block, t.nitems, dots, sqx, p, lmax, d,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The work items of at most 8 pairs of the n pairs sel (int32 block rows,
// clamped into [0, g)) into the int32 scratch runs (3 g + 4 n + 1
// entries; see Runs); where qr is not null, also the nq values of q
// rounded to bf16 (nearest even) into qr.  Returns a cudaError_t code.
int rpt_pair_runs(const int* sel, long n, int g, int* runs, const float* q, float* qr, long nq,
                  void* stream) {
  if (n < 1 || g < 1 || n > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Runs t = runs_of(runs, g, n);
  cudaError_t e = cudaMemsetAsync(t.counts, 0, sizeof(int) * ((size_t)g + 1), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((n + 255) / 256);
  histogram_kernel<<<grid, 256, 0, s>>>(sel, n, g, t.counts, q, qr, nq);
  scan_counts_kernel<<<1, kScanThreads, 0, s>>>(t.counts, t.offsets, t.cursor, g);
  scatter_kernel<<<grid, 256, 0, s>>>(sel, n, g, t.counts, t.offsets, t.cursor, t.order,
                                      t.start, t.count, t.block, t.nitems);
  return (int)cudaGetLastError();
}

// runs: rpt_pair_runs's scratch for the b * p pairs.  Each returns a
// cudaError_t code: 0 on a good launch; cudaErrorInvalidValue for an empty
// block array, probe axis or row, or more than 2^31 - 1 pairs.
int rpt_gather_score_f32(const float* x, const float* sq, const float* q, const int* runs,
                         float* dots, float* sqx, int b, int p, int g, int lmax, int d,
                         void* stream) {
  return launch<float, false>(x, nullptr, 0, sq, q, runs, dots, sqx, b, p, g, lmax, d, stream);
}

int rpt_gather_score_bf16(const __nv_bfloat16* x, const float* sq, const float* q,
                          const int* runs, float* dots, float* sqx, int b, int p, int g,
                          int lmax, int d, void* stream) {
  return launch<__nv_bfloat16, false>(x, nullptr, 0, sq, q, runs, dots, sqx, b, p, g, lmax, d,
                                      stream);
}

// The shared-row mode: rows [n, d] the row store, ids [g, lmax] the blocks'
// id tables (int32; -1 in empty slots, which read as zeros; ids are clamped
// below n).  Also cudaErrorInvalidValue for n < 1.
int rpt_gather_score_shared_f32(const float* rows, const int* ids, long n, const float* sq,
                                const float* q, const int* runs, float* dots, float* sqx, int b,
                                int p, int g, int lmax, int d, void* stream) {
  return launch<float, true>(rows, ids, n, sq, q, runs, dots, sqx, b, p, g, lmax, d, stream);
}

int rpt_gather_score_shared_bf16(const __nv_bfloat16* rows, const int* ids, long n,
                                 const float* sq, const float* q, const int* runs, float* dots,
                                 float* sqx, int b, int p, int g, int lmax, int d, void* stream) {
  return launch<__nv_bfloat16, true>(rows, ids, n, sq, q, runs, dots, sqx, b, p, g, lmax, d,
                                     stream);
}

// The shared-row mode's query route (no pair runs): sel the int32 [b, p]
// block rows; rs and hbits the plan (ops/fused_gather.py shared_route):
// the ring's rows a stage, and log2 of the hash size (more than p lmax).
// The ring has kStages stages.  cudaErrorInvalidValue for a plan outside the
// kernel's bounds or past the shared memory of a block.
int rpt_gather_score_shared_query_f32(const float* rows, const int* ids, long n,
                                      const float* sq, const float* q, const int* sel,
                                      float* dots, float* sqx, int b, int p, int g, int lmax,
                                      int d, int rs, int hbits, void* stream) {
  return launch_query<float>(rows, ids, n, sq, q, sel, dots, sqx, b, p, g, lmax, d, rs, hbits,
                             stream);
}

int rpt_gather_score_shared_query_bf16(const __nv_bfloat16* rows, const int* ids, long n,
                                       const float* sq, const float* q, const int* sel,
                                       float* dots, float* sqx, int b, int p, int g, int lmax,
                                       int d, int rs, int hbits, void* stream) {
  return launch_query<__nv_bfloat16>(rows, ids, n, sq, q, sel, dots, sqx, b, p, g, lmax, d, rs,
                                     hbits, stream);
}

}  // extern "C"
