// Kernels 7 and 8: the forest descent and the probe selection.
//
// Kernel 7 replaces the JAX package's traverse_tree in all three of its
// forms (rptree_tpu/ops/traverse.py: _traverse_frontier, and the
// superlevel fast paths _traverse_b1 and _traverse_fk over build_b1_tables
// and rptree_tpu/models/forest.py _b1_forest_tables), which XLA runs
// there, not Pallas.  For each (tree, query) it walks the levels keeping
// a frontier of at most F nodes: each live split node forks into one or
// both children by the reference's margin table, and the frontier keeps
// the F lowest (priority, encoding) pairs in ascending order.  Live
// entries are distinct nodes, so that order is strict on them, and every
// empty slot is the same (+inf, INT_MIN): any exact selection of the F
// smallest gives the plain form's frontier bit for bit.  The comparisons
// are the plain form's (lt = proj < thr, gt = proj > thr, dl = |lo - proj|
// and dr = |hi - proj| in f32, priorities as minima with the running one).
//
// What bounds it on an H100: the node records.  Each (tree, query) makes
// a chain of L dependent reads, and every live slot of every level reads
// one 32-byte record (thr, mgl, mgh, lc, rc as f32 and int32, padded: one
// sector) of a table that fits in L2 and, a tree at a time, mostly in L1:
// the record reads, not the bytes read once (projections, table,
// outputs), set the time.  So the design takes everything but the
// records off that chain, keeps the frontier on chip for the whole
// descent, and gives each live slot a thread or lane of its own, with
// many descents in flight.  Four routes, picked by the caller
// (ops/traverse.py traverse_route):
//
// - F <= 8: one thread per (tree, query), the frontier in registers, the
//   2F children inserted into a sorted list of F (F = 1 is the lexicographic
//   minimum of two children, the JAX package's _b1_step); a level's
//   projection and offset read one level ahead;
// - next_pow2(2F) = M <= 64: one warp per (tree, query), a lane per
//   frontier slot, M / 32 entries a lane in registers, the plain form's
//   bitonic network by shuffles (no shared memory, no barrier);
// - M <= 16384: a group of M / 2 threads (64 to 1,024) per (tree, query),
//   the entries in shared memory, the same network (two groups of 64 share
//   a block and its barrier at M 128);
// - larger M: the same with the entries in global scratch, one block per
//   (tree, query) at a time over a fixed grid.
//
// The projections are [T, L, B], so one level's reads coalesce over
// queries.  Offsets are 64-bit.
//
// Kernel 8 replaces the JAX package's _select_probes (a stable lax.sort
// of [B, T * F] priorities, then the knnH bucket stop; XLA there too).
// An entry's place in the stable sort is its rank: the count of entries
// before it in (key, tree, slot) order.  Each query's T * F keys are read
// once, with the loads of neighbouring queries side by side ([T, B, F]),
// turned into orderable bits once and kept in registers; the ranks are
// counted over the group by shuffles.  Entries of rank < P go to shared
// memory, the bucket stop's 64-bit scan reads them there, and the block
// writes its [B, P] rows with coalesced stores.  Lanes are sized to the
// query (ops/traverse.py probe_route): a group of next_pow2(T * F) <= 32
// lanes, several queries a warp; one warp up to T * F = 1,024, ceil(T * F
// / 32) entries a lane; past that the merge route (a binary search a
// lane over each other tree's ascending list in global memory).

#include <climits>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kInvalid = INT_MIN;
constexpr float kPrioCap = 3.0e38f;  // VALID_PRIO_CAP
constexpr int kRegThreads = 128;
constexpr int kWarpThreads = 128;
constexpr int kMaxGroup = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Entry {
  float p;
  int e;
};

struct Node {
  float thr, lo, hi;
  int lc, rc;
};

__device__ __forceinline__ bool before(float pa, int ea, float pb, int eb) {
  return pa < pb || (pa == pb && ea < eb);
}

__device__ __forceinline__ Node load_node(const int4* __restrict__ rec, long long row) {
  const int4 a = __ldg(rec + 2 * row);
  const int c = __ldg(reinterpret_cast<const int*>(rec + 2 * row + 1));
  return {__int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z), a.w, c};
}

// One frontier entry's two slots at a level, as the plain form makes them:
// bank 1 is the left child, or the entry itself when it is a leaf or empty;
// bank 2 is the right child.
__device__ __forceinline__ void expand(int enc, float pri, float proj, const Node& nd,
                                       Entry& l, Entry& r) {
  if (enc < 0) {
    l = {enc == kInvalid ? INFINITY : pri, enc};
    r = {INFINITY, kInvalid};
    return;
  }
  const float dl = fabsf(__fsub_rn(nd.lo, proj));
  const float dr = fabsf(__fsub_rn(nd.hi, proj));
  const bool lt = proj < nd.thr;
  const bool gt = proj > nd.thr;
  const bool both = (lt && dl > dr) || (gt && dl < dr);
  const bool go_l = lt || both;
  const bool go_r = !lt || both;
  l = go_l ? Entry{fminf(pri, dl), nd.lc} : Entry{INFINITY, kInvalid};
  r = go_r ? Entry{fminf(pri, dr), nd.rc} : Entry{INFINITY, kInvalid};
}

__device__ __forceinline__ void store_leaf(int enc, float pri, int* leaf, float* out_pri,
                                           long long at) {
  leaf[at] = enc == kInvalid ? -1 : -(enc + 1);
  out_pri[at] = pri;
}

// Register route: one thread per (tree, query), F a template parameter.
// At F = 1 a level's projection and record offset are read one level
// ahead, so that a level waits on its record reads alone.
template <int F>
__global__ void __launch_bounds__(kRegThreads)
traverse_regs(const float* __restrict__ projq, const int4* __restrict__ rec,
              const int* __restrict__ off, int root, int T, int B, int L, long long N,
              int* __restrict__ leaf, float* __restrict__ out_pri) {
  const long long item = (long long)blockIdx.x * kRegThreads + threadIdx.x;
  if (item >= (long long)T * B) return;
  const int t = (int)(item / B);
  const int b = (int)(item % B);
  const float* pq = projq + (long long)t * L * B + b;
  const int4* rt = rec + (long long)t * N * 2;
  int fe[F];
  float fp[F];
#pragma unroll
  for (int s = 0; s < F; ++s) {
    fe[s] = s ? kInvalid : root;
    fp[s] = s ? INFINITY : kPrioCap;
  }
  constexpr bool ahead = F == 1;  // in-level reads where F > 1: faster there
  float proj_next = ahead && L > 0 ? __ldg(pq) : 0.0f;
  int off_next = ahead && L > 0 ? __ldg(off) : 0;
  for (int l = 0; l < L; ++l) {
    float proj;
    long long base;
    if (ahead) {
      proj = proj_next;
      base = off_next;
      if (l + 1 < L) {
        proj_next = __ldg(pq + (long long)(l + 1) * B);
        off_next = __ldg(off + l + 1);
      }
    } else {
      proj = __ldg(pq + (long long)l * B);
      base = __ldg(off + l);
    }
    Node nd[F];
#pragma unroll
    for (int s = 0; s < F; ++s) {  // every live slot's record at once
      nd[s] = Node{0.0f, 0.0f, 0.0f, 0, 0};
      if (fe[s] >= 0) nd[s] = load_node(rt, base + fe[s]);
    }
    int ne[F];
    float np[F];
#pragma unroll
    for (int s = 0; s < F; ++s) {
      ne[s] = kInvalid;
      np[s] = INFINITY;
    }
#pragma unroll
    for (int s = 0; s < F; ++s) {
      Entry c[2];
      expand(fe[s], fp[s], proj, nd[s], c[0], c[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // insert into the sorted F smallest
        float p = c[h].p;
        int e = c[h].e;
#pragma unroll
        for (int i = 0; i < F; ++i) {
          if (before(p, e, np[i], ne[i])) {
            const float tp = np[i];
            const int te = ne[i];
            np[i] = p;
            ne[i] = e;
            p = tp;
            e = te;
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < F; ++s) {
      fe[s] = ne[s];
      fp[s] = np[s];
    }
  }
  const long long at = item * F;
#pragma unroll
  for (int s = 0; s < F; ++s) store_leaf(fe[s], fp[s], leaf, out_pri, at + s);
}

// One stage of a bitonic network over a warp, partners j lanes apart:
// this lane keeps the lesser entry of the pair where `keep_min`.
__device__ __forceinline__ void warp_stage(float& p, int& e, int j, bool keep_min) {
  const float op = __shfl_xor_sync(kFull, p, j);
  const int oe = __shfl_xor_sync(kFull, e, j);
  if (before(op, oe, p, e) == keep_min) {
    p = op;
    e = oe;
  }
}

// Warp route: one warp per (tree, query), M = 32 R entries, entry x = 32 r
// + lane in register r of a lane, so that each frontier slot (x < F <= 32)
// has a lane of its own for its record read.  Each level places the
// children as the plain form does (slot s's left child at x = s, its
// right one at F + s, empty slots after) and runs its bitonic network,
// stage for stage, by shuffles (the stage of partners 32 apart within a
// lane), but for the stages that only order entries 32 .. 63, which the
// next level drops; the frontier is then register 0 of lanes 0 .. F - 1.
// Lane i holds level 32 c + i's projection and offset, broadcast by
// shuffles.  32 registers: a warp for each of an SM's 64 warp slots.
template <int R>
__global__ void __launch_bounds__(kWarpThreads)
traverse_warp(const float* __restrict__ projq, const int4* __restrict__ rec,
              const int* __restrict__ off, int root, int T, int B, int L, long long N, int F,
              int* __restrict__ leaf, float* __restrict__ out_pri) {
  constexpr int M = 32 * R;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * (kWarpThreads / 32) + threadIdx.x / 32;
  if (item >= (long long)T * B) return;  // the whole warp
  const int t = (int)(item / B);
  const int b = (int)(item % B);
  const float* pq = projq + (long long)t * L * B + b;
  const int4* rt = rec + (long long)t * N * 2;
  float p[R];
  int e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    p[r] = r == 0 && lane == 0 ? kPrioCap : INFINITY;
    e[r] = r == 0 && lane == 0 ? root : kInvalid;
  }
  float proj_l = 0.0f;
  int off_l = 0;
  for (int l = 0; l < L; ++l) {
    if ((l & 31) == 0) {
      const int ll = l + lane;
      proj_l = ll < L ? __ldg(pq + (long long)ll * B) : 0.0f;
      off_l = ll < L ? __ldg(off + ll) : 0;
    }
    const float proj = __shfl_sync(kFull, proj_l, l & 31);
    const int base = __shfl_sync(kFull, off_l, l & 31);
    const int enc = lane < F ? e[0] : kInvalid;
    Node nd{0.0f, 0.0f, 0.0f, 0, 0};
    if (enc >= 0) nd = load_node(rt, (long long)base + enc);
    Entry a, c;
    expand(enc, p[0], proj, nd, a, c);
#pragma unroll
    for (int r = 0; r < R; ++r) {  // x < F: own left child; F <= x < 2F: lane x - F's right one
      const int x = 32 * r + lane;
      const int src = (x - F) & 31;
      const float cp = __shfl_sync(kFull, c.p, src);
      const int ce = __shfl_sync(kFull, c.e, src);
      p[r] = x < F ? a.p : (x < 2 * F ? cp : INFINITY);
      e[r] = x < F ? a.e : (x < 2 * F ? ce : kInvalid);
    }
#pragma unroll
    for (int k = 2; k <= M; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (R == 2 && j == 32) {  // partner in this lane's other register (k = 64)
          if (before(p[R - 1], e[R - 1], p[0], e[0])) {
            const float tp = p[0];
            const int te = e[0];
            p[0] = p[R - 1];
            e[0] = e[R - 1];
            p[R - 1] = tp;
            e[R - 1] = te;
          }
        } else {
#pragma unroll
          for (int r = 0; r < (R == 2 && k == 64 ? 1 : R); ++r) {
            warp_stage(p[r], e[r], j, (((32 * r + lane) & k) == 0) == ((lane & j) == 0));
          }
        }
      }
    }
  }
  if (lane < F) store_leaf(e[0], p[0], leaf, out_pri, item * F + lane);
}

// Ascending bitonic sort of buf[0, M) by (p, e), by the G threads of a
// group; every thread of the block calls it (it synchronises the block).
__device__ __forceinline__ void bitonic_sort(Entry* buf, int M, int tid, int G) {
  for (int k = 2; k <= M; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < (M >> 1); q += G) {
        const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int hi = lo | j;
        const Entry a = buf[lo];
        const Entry c = buf[hi];
        const bool swap = (lo & k) == 0 ? before(c.p, c.e, a.p, a.e) : before(a.p, a.e, c.p, c.e);
        if (swap) {
          buf[lo] = c;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Shared-memory and global routes: `groups` groups of G threads per block,
// each group one (tree, query) at a time; a group's M entries are in
// shared memory, or in `scratch` (one group per block) when it is given.
__global__ void traverse_wide(const float* __restrict__ projq, const int4* __restrict__ rec,
                              const int* __restrict__ off, int root, int T, int B, int L,
                              long long N, int F, int M, int G, int groups, Entry* scratch,
                              int* __restrict__ leaf, float* __restrict__ out_pri) {
  extern __shared__ Entry smem[];
  const int g = threadIdx.x / G;
  const int tid = threadIdx.x % G;
  Entry* buf = scratch ? scratch + (long long)blockIdx.x * M : smem + (long long)g * M;
  const long long tb = (long long)T * B;
  const long long step = (long long)gridDim.x * groups;
  for (long long first = (long long)blockIdx.x * groups; first < tb; first += step) {
    const long long item = first + g;
    const bool live = item < tb;  // every thread joins each barrier
    const long long it = live ? item : tb - 1;
    const int t = (int)(it / B);
    const int b = (int)(it % B);
    const float* pq = projq + (long long)t * L * B + b;
    const int4* rt = rec + (long long)t * N * 2;
    for (int s = tid; s < M; s += G) buf[s] = s ? Entry{INFINITY, kInvalid} : Entry{kPrioCap, root};
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const float proj = __ldg(pq + (long long)l * B);
      const long long base = __ldg(off + l);
      // a thread reads and rewrites only its own slots s, and writes F + s,
      // which no thread reads in this step
      for (int s = tid; s < F; s += G) {
        const Entry cur = buf[s];
        Node nd{0.0f, 0.0f, 0.0f, 0, 0};
        if (cur.e >= 0) nd = load_node(rt, base + cur.e);
        Entry a, c;
        expand(cur.e, cur.p, proj, nd, a, c);
        buf[s] = a;
        buf[F + s] = c;
      }
      for (int s = 2 * F + tid; s < M; s += G) buf[s] = Entry{INFINITY, kInvalid};
      __syncthreads();
      bitonic_sort(buf, M, tid, G);
    }
    if (live) {
      for (int s = tid; s < F; s += G) store_leaf(buf[s].e, buf[s].p, leaf, out_pri, it * F + s);
    }
    __syncthreads();
  }
}

template <int F>
cudaError_t launch_regs(const float* projq, const int4* rec, const int* off, int root, int T,
                        int B, int L, long long N, int* leaf, float* pri, cudaStream_t stream) {
  const long long tb = (long long)T * B;
  const unsigned grid = (unsigned)((tb + kRegThreads - 1) / kRegThreads);
  traverse_regs<F><<<grid, kRegThreads, 0, stream>>>(projq, rec, off, root, T, B, L, N, leaf,
                                                     pri);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_warp(const float* projq, const int4* rec, const int* off, int root, int T,
                        int B, int L, long long N, int F, int* leaf, float* pri,
                        cudaStream_t stream) {
  constexpr int per = kWarpThreads / 32;
  const long long tb = (long long)T * B;
  const unsigned grid = (unsigned)((tb + per - 1) / per);
  traverse_warp<R><<<grid, kWarpThreads, 0, stream>>>(projq, rec, off, root, T, B, L, N, F,
                                                      leaf, pri);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 8: probe selection.

// The stable sort's key of a slot: its priority, +inf where it holds no
// leaf; as orderable bits, NaN past +inf (torch.sort puts NaN last) and
// -0 as +0.
__device__ __forceinline__ float probe_prio(const int* leaf, const float* pri, long long at) {
  return __ldg(leaf + at) >= 0 ? __ldg(pri + at) : INFINITY;
}

__device__ __forceinline__ unsigned key_bits(float p) {
  return isnan(p) ? 0xffffffffu : rpt::orderable(p);
}

__device__ __forceinline__ unsigned probe_key(const int* leaf, const float* pri, long long at) {
  return key_bits(probe_prio(leaf, pri, at));
}

constexpr int kProbeThreads = 128;

// One entry i = t * F + s of query b: its key (pad entries, past T * F
// or past B, take the last key) and its leaf, -1 where the plain form
// masks it (an infinite priority, which a slot without a leaf has).
struct Probe {
  unsigned key;
  int lf;
};

__device__ __forceinline__ Probe load_probe(const int* __restrict__ leaf,
                                            const float* __restrict__ pri, int B, int F, int b,
                                            int i, bool live) {
  if (!live) return {0xffffffffu, -1};
  const int t = i / F;
  const long long at = ((long long)t * B + b) * F + (i - t * F);
  const int lf = __ldg(leaf + at);
  const float raw = __ldg(pri + at);  // both loads in flight together
  const float pe = lf >= 0 ? raw : INFINITY;
  return {key_bits(pe), isinf(pe) ? -1 : lf};
}

// The probe of entry i into rank r of a query's shared row: the global
// block `t * nl + leaf`, or block 0 and leaf -1 where masked.
__device__ __forceinline__ void put_probe(int* sg, int* sl, int r, const Probe& e, int i, int F,
                                          int nl) {
  sg[r] = e.lf >= 0 ? (i / F) * nl + e.lf : 0;
  sl[r] = e.lf;
}

// knnH on a shared row, entries r0 + lane over a group of G lanes: a
// bucket past the first whose running 64-bit size (from `carry`) passes k
// is masked.  Returns the group's sum.
template <int G>
__device__ __forceinline__ long long stop_scan(int* sg, int* sl, const int* __restrict__ lens,
                                               int r, bool in, long long carry, long long k) {
  const int j = threadIdx.x % G;
  int ls = -1;
  long long sz = 0;
  if (in) {
    ls = sl[r];
    if (ls >= 0) sz = __ldg(lens + sg[r]);
  }
  long long v = sz;
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const long long up = __shfl_up_sync(kFull, v, o, G);
    if (j >= o) v += up;
  }
  if (in && ls >= 0 && !(carry + v <= k || r == 0)) {
    sg[r] = 0;
    sl[r] = -1;
  }
  return __shfl_sync(kFull, v, G - 1, G);
}

// The block's rows of P probes, queries b0 .. b0 + nq - 1, from shared
// memory to gsel / lsel in coalesced stores.
__device__ __forceinline__ void store_rows(const int* sg, const int* sl, int* gsel, int* lsel,
                                           int b0, int nq, int P) {
  const long long base = (long long)b0 * P;
  for (int i = threadIdx.x; i < nq * P; i += kProbeThreads) {
    gsel[base + i] = sg[i];
    lsel[base + i] = sl[i];
  }
}

// Lanes route: G = next_pow2(T * F) <= 32 lanes a query, entry j = t * F +
// s on lane j of the group, kProbeThreads / G queries a block.
template <int G>
__global__ void __launch_bounds__(kProbeThreads)
probes_lanes(const int* __restrict__ leaf, const float* __restrict__ pri,
             const int* __restrict__ lens, int* __restrict__ gsel, int* __restrict__ lsel, int T,
             int B, int F, int P, int nl, long long k, int bucket_stop) {
  constexpr int Q = kProbeThreads / G;
  __shared__ int sg[kProbeThreads], sl[kProbeThreads];  // Q rows of P <= G
  const int j = threadIdx.x % G;
  const int qi = threadIdx.x / G;
  const int b0 = blockIdx.x * Q;
  const int b = b0 + qi;
  const bool live = b < B && j < T * F;
  const Probe e = load_probe(leaf, pri, B, F, b, j, live);
  int rank = 0;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const unsigned v = __shfl_sync(kFull, e.key, i, G);
    rank += v < e.key || (v == e.key && i < j);
  }
  int* rg = sg + qi * P;
  int* rl = sl + qi * P;
  if (live && rank < P) put_probe(rg, rl, rank, e, j, F, nl);
  __syncwarp();
  if (bucket_stop) stop_scan<G>(rg, rl, lens, j, b < B && j < P, 0, k);
  __syncthreads();
  store_rows(sg, sl, gsel, lsel, b0, min(Q, B - b0), P);
}

// Warp route: one warp a query, entry i = 32 e + lane in register e (E of
// them, T * F <= 32 E), kProbeThreads / 32 queries a block; the rows in
// dynamic shared memory (2 x 4 rows of P ints).
template <int E>
__global__ void __launch_bounds__(kProbeThreads)
probes_warp(const int* __restrict__ leaf, const float* __restrict__ pri,
            const int* __restrict__ lens, int* __restrict__ gsel, int* __restrict__ lsel, int T,
            int B, int F, int P, int nl, long long k, int bucket_stop) {
  constexpr int W = kProbeThreads / 32;
  extern __shared__ int rows[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b0 = blockIdx.x * W;
  const int b = b0 + w;
  const int n = T * F;
  Probe e[E];
  int rank[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = 32 * r + lane;
    e[r] = load_probe(leaf, pri, B, F, b, i, b < B && i < n);
    rank[r] = 0;
  }
#pragma unroll 1
  for (int r2 = 0; 32 * r2 < n; ++r2) {  // past n, pads only: they count for no entry
    unsigned kv = e[0].key;  // register r2's key, without indexing registers
#pragma unroll
    for (int q = 1; q < E; ++q) kv = q == r2 ? e[q].key : kv;
#pragma unroll 4
    for (int src = 0; src < 32; ++src) {
      const unsigned v = __shfl_sync(kFull, kv, src);
      const int i2 = 32 * r2 + src;
#pragma unroll
      for (int r = 0; r < E; ++r) rank[r] += v < e[r].key || (v == e[r].key && i2 < 32 * r + lane);
    }
  }
  int* sg = rows;
  int* sl = rows + W * P;
  int* rg = sg + w * P;
  int* rl = sl + w * P;
  if (b < B) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const int i = 32 * r + lane;
      if (i < n && rank[r] < P) put_probe(rg, rl, rank[r], e[r], i, F, nl);
    }
  }
  __syncwarp();
  if (bucket_stop) {
    long long carry = 0;
    for (int r0 = 0; r0 < P; r0 += 32) {
      carry += stop_scan<32>(rg, rl, lens, r0 + lane, b < B && r0 + lane < P, carry, k);
    }
  }
  __syncthreads();
  store_rows(sg, sl, gsel, lsel, b0, min(W, B - b0), P);
}

// Merge route (T * F past the warp route's): one warp per query, each lane
// an entry's rank by a binary search over each other tree's ascending
// list, the probes scattered by rank, then the bucket stop over them.
constexpr int kMergeWarps = 4;

__global__ void __launch_bounds__(32 * kMergeWarps)
probes_merge(const int* __restrict__ leaf, const float* __restrict__ pri,
             const int* __restrict__ lens, int* gsel, int* lsel, int T, int B, int F, int P,
             int nl, long long k, int bucket_stop) {
  const int b = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= B) return;  // the whole warp
  const long long row = (long long)b * P;
  const int n = T * F;
  for (int i = lane; i < n; i += 32) {
    const int t = i / F;
    const int s = i % F;
    const long long at = ((long long)t * B + b) * F + s;
    const float pe = probe_prio(leaf, pri, at);
    const unsigned u = key_bits(pe);
    int rank = s;
    for (int t2 = 0; t2 < T && rank < P; ++t2) {
      if (t2 == t) continue;
      const long long base = ((long long)t2 * B + b) * F;
      const bool upto = t2 < t;  // an earlier tree's equal keys come first
      int lo = 0, hi = F;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const unsigned v = probe_key(leaf, pri, base + mid);
        if (upto ? v <= u : v < u) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      rank += lo;
    }
    if (rank < P) {
      const bool fin = !isinf(pe);  // the plain form masks infinite priorities
      const int lf = __ldg(leaf + at);
      gsel[row + rank] = fin ? t * nl + lf : 0;
      lsel[row + rank] = fin ? lf : -1;
    }
  }
  if (!bucket_stop) return;
  __syncwarp();
  long long carry = 0;
  for (int first = 0; first < P; first += 32) {
    const int r = first + lane;
    int g = 0, ls = -1;
    long long sz = 0;
    if (r < P) {
      g = gsel[row + r];
      ls = lsel[row + r];
      if (ls >= 0) sz = __ldg(lens + g);
    }
    long long v = sz;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v += up;
    }
    if (r < P && ls >= 0 && !(carry + v <= k || r == 0)) {
      gsel[row + r] = 0;
      lsel[row + r] = -1;
    }
    carry += __shfl_sync(kFull, v, 31);
  }
}

template <int G>
cudaError_t launch_lanes(const int* leaf, const float* pri, const int* lens, int* gsel, int* lsel,
                         int T, int B, int F, int P, int nl, long long k, int stop,
                         cudaStream_t stream) {
  constexpr int Q = kProbeThreads / G;
  const unsigned grid = (unsigned)((B + Q - 1) / Q);
  probes_lanes<G><<<grid, kProbeThreads, 0, stream>>>(leaf, pri, lens, gsel, lsel, T, B, F, P,
                                                      nl, k, stop);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_probe_warp(const int* leaf, const float* pri, const int* lens, int* gsel,
                              int* lsel, int T, int B, int F, int P, int nl, long long k,
                              int stop, cudaStream_t stream) {
  constexpr int W = kProbeThreads / 32;
  const unsigned grid = (unsigned)((B + W - 1) / W);
  const size_t smem = (size_t)2 * W * P * sizeof(int);
  probes_warp<E><<<grid, kProbeThreads, smem, stream>>>(leaf, pri, lens, gsel, lsel, T, B, F, P,
                                                        nl, k, stop);
  return cudaGetLastError();
}

// route: 0 registers (F <= 8), 1 shared memory, 2 global scratch (grid
// blocks, `scratch` holding grid * M entries of 8 bytes), 3 a warp (M 32
// or 64).
int traverse_launch(const float* projq, const int* rec, const int* off, int* leaf, float* pri,
                    void* scratch, int root, int T, int B, int L, long long N, int F, int M,
                    int route, int grid, cudaStream_t stream) {
  const int4* r4 = reinterpret_cast<const int4*>(rec);
  if (route == 0) {
    switch (F) {
#define RPT_REGS(f) \
  case f: return launch_regs<f>(projq, r4, off, root, T, B, L, N, leaf, pri, stream);
      RPT_REGS(1) RPT_REGS(2) RPT_REGS(3) RPT_REGS(4)
      RPT_REGS(5) RPT_REGS(6) RPT_REGS(7) RPT_REGS(8)
#undef RPT_REGS
      default: return cudaErrorInvalidValue;
    }
  }
  if (F < 1 || M < 2 * F || (M & (M - 1))) return cudaErrorInvalidValue;
  if (route == 3) {
    if (M == 32) return launch_warp<1>(projq, r4, off, root, T, B, L, N, F, leaf, pri, stream);
    if (M == 64) return launch_warp<2>(projq, r4, off, root, T, B, L, N, F, leaf, pri, stream);
    return cudaErrorInvalidValue;
  }
  const long long tb = (long long)T * B;
  int G = M / 2 < 32 ? 32 : (M / 2 > kMaxGroup ? kMaxGroup : M / 2);
  int groups = G >= kRegThreads ? 1 : kRegThreads / G;
  size_t smem = 0;
  unsigned blocks;
  Entry* buf = nullptr;
  if (route == 1) {
    smem = (size_t)groups * M * sizeof(Entry);
    blocks = (unsigned)((tb + groups - 1) / groups);
    const cudaError_t err = rpt::allow_smem(traverse_wide, smem);
    if (err != cudaSuccess) return err;
  } else if (route == 2) {
    if (!scratch || grid < 1) return cudaErrorInvalidValue;
    G = kMaxGroup;
    groups = 1;
    blocks = (unsigned)grid;
    buf = reinterpret_cast<Entry*>(scratch);
  } else {
    return cudaErrorInvalidValue;
  }
  traverse_wide<<<blocks, G * groups, smem, stream>>>(projq, r4, off, root, T, B, L, N, F, M, G,
                                                     groups, buf, leaf, pri);
  return cudaGetLastError();
}

// route: 0 lanes (`width` = G lanes a query, a power of two >= T * F, <=
// 32), 1 a warp (`width` = E entries a lane, a power of two, 32 E >= T *
// F, E <= 32), 2 the merge of ascending lists (any T * F).
int select_probes_launch(const int* leaf, const float* pri, const int* lens, int* gsel,
                         int* lsel, int T, int B, int F, int P, int nl, long long k,
                         int bucket_stop, int route, int width, cudaStream_t stream) {
  const long long n = (long long)T * F;
  if (P < 1 || P > n) return cudaErrorInvalidValue;
  if (route == 0) {
    if (width < n) return cudaErrorInvalidValue;
    switch (width) {
#define RPT_LANES(g) \
  case g: return launch_lanes<g>(leaf, pri, lens, gsel, lsel, T, B, F, P, nl, k, bucket_stop, stream);
      RPT_LANES(1) RPT_LANES(2) RPT_LANES(4) RPT_LANES(8) RPT_LANES(16) RPT_LANES(32)
#undef RPT_LANES
      default: return cudaErrorInvalidValue;
    }
  }
  if (route == 1) {
    if (32LL * width < n) return cudaErrorInvalidValue;
    switch (width) {
#define RPT_PWARP(e)                                                                      \
  case e:                                                                                 \
    return launch_probe_warp<e>(leaf, pri, lens, gsel, lsel, T, B, F, P, nl, k, bucket_stop, \
                                stream);
      RPT_PWARP(1) RPT_PWARP(2) RPT_PWARP(4) RPT_PWARP(8) RPT_PWARP(16) RPT_PWARP(32)
#undef RPT_PWARP
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != 2) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((B + kMergeWarps - 1) / kMergeWarps);
  probes_merge<<<grid, 32 * kMergeWarps, 0, stream>>>(leaf, pri, lens, gsel, lsel, T, B, F, P, nl,
                                                      k, bucket_stop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The wrappers pass each entry point's arguments packed, an int64 each in
// the order of the launch function's parameters (ops/traverse.py
// _TRAVERSE_ARGS, _PROBES_ARGS): ctypes converts one argument in a
// fraction of the host time that fifteen take, and these run once a
// query chunk, where the chunk's kernels are short.
int rpt_traverse(const long long* packed) {
  long long a[16];
  memcpy(a, packed, sizeof a);
  return traverse_launch(reinterpret_cast<const float*>(a[0]), reinterpret_cast<const int*>(a[1]),
                         reinterpret_cast<const int*>(a[2]), reinterpret_cast<int*>(a[3]),
                         reinterpret_cast<float*>(a[4]), reinterpret_cast<void*>(a[5]),
                         (int)a[6], (int)a[7], (int)a[8], (int)a[9], a[10], (int)a[11],
                         (int)a[12], (int)a[13], (int)a[14],
                         reinterpret_cast<cudaStream_t>(a[15]));
}

int rpt_select_probes(const long long* packed) {
  long long a[15];
  memcpy(a, packed, sizeof a);
  return select_probes_launch(
      reinterpret_cast<const int*>(a[0]), reinterpret_cast<const float*>(a[1]),
      reinterpret_cast<const int*>(a[2]), reinterpret_cast<int*>(a[3]),
      reinterpret_cast<int*>(a[4]), (int)a[5], (int)a[6], (int)a[7], (int)a[8], (int)a[9], a[10],
      (int)a[11], (int)a[12], (int)a[13], reinterpret_cast<cudaStream_t>(a[14]));
}

}  // extern "C"
