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
// smallest gives the plain form's frontier bit for bit, so no kernel
// here replays its bitonic network slot for slot.  The comparisons are the
// plain form's (lt = proj < thr, gt = proj > thr, dl = |lo - proj| and
// dr = |hi - proj| in f32, priorities as minima with the running one).
//
// What bounds it on an H100: latency.  The work is a chain of L dependent
// reads per (tree, query), each one 32-byte node record (thr, mgl, mgh,
// lc, rc as f32 and int32, padded: one sector) of a table that fits in
// L2; the bytes (the projections, the table, the outputs) take
// microseconds.  So the design keeps the frontier on chip for the whole
// descent, issues each level's record reads together, and keeps enough
// (tree, query) descents in flight to cover them.  Three routes, picked
// by the caller (ops/traverse.py traverse_route):
//
// - F <= 8: one thread per (tree, query), the frontier in registers, the
//   2F children inserted into a sorted list of F (F = 1 is the lexicographic
//   minimum of two children, the JAX package's _b1_step);
// - next_pow2(2F) <= 16384: a group of threads per (tree, query) (a warp
//   for F <= 32, up to 1,024 threads), the frontier and its children in
//   shared memory, a bitonic sort of the 2F entries a level;
// - larger F: the same with the entries in global scratch, one block per
//   (tree, query) at a time over a fixed grid.
//
// The projections are [T, L, B], so one level's reads coalesce over
// queries.  Offsets are 64-bit.
//
// Kernel 8 replaces the JAX package's _select_probes (a stable lax.sort
// of [B, T * F] priorities, then the knnH bucket stop; XLA there too).
// Each tree's list is already ascending, so the stable sort over (tree,
// slot) order is a T-way merge: the rank of entry (t, s) is s plus, for
// each other tree, the count of its entries that precede it (key <= for
// an earlier tree, < for a later one), found by binary search.  One warp
// per query scatters its first P entries by rank, then scans the bucket
// sizes in 64 bits for the stop rule.  Latency-bound as well: a few reads
// per entry of lists that sit in L1.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kInvalid = INT_MIN;
constexpr float kPrioCap = 3.0e38f;  // VALID_PRIO_CAP
constexpr int kRegThreads = 128;
constexpr int kMaxGroup = 1024;

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
  for (int l = 0; l < L; ++l) {
    const float proj = __ldg(pq + (long long)l * B);
    const long long base = __ldg(off + l);
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

constexpr int kProbeWarps = 4;

__global__ void __launch_bounds__(32 * kProbeWarps)
select_probes_kernel(const int* __restrict__ leaf, const float* __restrict__ pri,
                     const int* __restrict__ lens, int* gsel, int* lsel, int T, int B, int F,
                     int P, int nl, long long k, int bucket_stop) {
  const int b = blockIdx.x * kProbeWarps + threadIdx.x / 32;
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
  // knnH: buckets in ascending priority while the running size stays <= k,
  // the first always kept
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
      const long long up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    if (r < P && ls >= 0 && !(carry + v <= k || r == 0)) {
      gsel[row + r] = 0;
      lsel[row + r] = -1;
    }
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

}  // namespace

extern "C" {

// route: 0 registers (F <= 8), 1 shared memory, 2 global scratch (grid
// blocks, `scratch` holding grid * M entries of 8 bytes).
int rpt_traverse(const float* projq, const int* rec, const int* off, int* leaf, float* pri,
                 void* scratch, int root, int T, int B, int L, long N, int F, int M, int route,
                 int grid, cudaStream_t stream) {
  const int4* r4 = reinterpret_cast<const int4*>(rec);
  if (route == 0) {
    switch (F) {
      case 1: return launch_regs<1>(projq, r4, off, root, T, B, L, N, leaf, pri, stream);
      case 2: return launch_regs<2>(projq, r4, off, root, T, B, L, N, leaf, pri, stream);
      case 3: return launch_regs<3>(projq, r4, off, root, T, B, L, N, leaf, pri, stream);
      case 4: return launch_regs<4>(projq, r4, off, root, T, B, L, N, leaf, pri, stream);
      case 5: return launch_regs<5>(projq, r4, off, root, T, B, L, N, leaf, pri, stream);
      case 6: return launch_regs<6>(projq, r4, off, root, T, B, L, N, leaf, pri, stream);
      case 7: return launch_regs<7>(projq, r4, off, root, T, B, L, N, leaf, pri, stream);
      case 8: return launch_regs<8>(projq, r4, off, root, T, B, L, N, leaf, pri, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (F < 1 || M < 2 * F || (M & (M - 1))) return cudaErrorInvalidValue;
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
  } else {
    if (!scratch || grid < 1) return cudaErrorInvalidValue;
    G = kMaxGroup;
    groups = 1;
    blocks = (unsigned)grid;
    buf = reinterpret_cast<Entry*>(scratch);
  }
  traverse_wide<<<blocks, G * groups, smem, stream>>>(projq, r4, off, root, T, B, L, N, F, M, G,
                                                     groups, buf, leaf, pri);
  return cudaGetLastError();
}

int rpt_select_probes(const int* leaf, const float* pri, const int* lens, int* gsel, int* lsel,
                      int T, int B, int F, int P, int nl, long k, int bucket_stop,
                      cudaStream_t stream) {
  const unsigned grid = (unsigned)((B + kProbeWarps - 1) / kProbeWarps);
  select_probes_kernel<<<grid, 32 * kProbeWarps, 0, stream>>>(leaf, pri, lens, gsel, lsel, T, B,
                                                               F, P, nl, k, bucket_stop);
  return cudaGetLastError();
}

}  // extern "C"
