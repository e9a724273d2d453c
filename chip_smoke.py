"""Smoke test of the PyTorch / CUDA port (``rptree_tpu_torch``) on one
NVIDIA GPU: builds the port's CUDA kernels from ``rptree_tpu_torch/csrc``,
holds each against its plain PyTorch version at the serving path's shapes,
then drives the grouped, per-pair, unpacked and exact-scan query paths end
to end and checks recall against the exact fp32 scan.

    python3 chip_smoke.py

Phases, one line each (phases 3-7 one per variant, and one more with
its launch counts):

1. set-up: the card, torch and CUDA versions, TF32 off, kernel build time;
2. each kernel against its plain version on the card (distances to 1e-4
   relative, top-k exactly equal; the fused tile top-k's distances
   bit-equal to the tile kernel's, sorted; the block gather's norms
   bit-equal; the scan's ids equal outside near-ties), with both times by
   CUDA events, the least time the card could take (``bound_ms``) and,
   where one PyTorch call computes the same function, its time; the
   scan's time excludes its bf16 copy of the rows, made once per call and
   timed apart (``cast_ms``), and a bf16 ``torch.matmul`` of its operands
   stands beside it as a yardstick for the products alone (``gemm_ms``);
   the tile kernels are also checked and timed on tiles in block order,
   as the serving path makes them (``*_block_order``), and the top-k tail
   at a clustered chunk's 65,536 x 1,024 (``ms_chunk``) and on its
   wide-row route past W 1,024 (``ms_wide``), both held against the plain
   version; the descent (kernel 7) and the probe selection (kernel 8) at
   the descents the main path runs (``DESCENTS``: the clustered and iid
   chunks, the bracket's, and unpacked ``knn`` at budget 32), leaves,
   priorities and probes bit-equal, with each wrapper's host time a call
   (``host_us``); the tile tables (kernel 9) bit-equal
   to their twin, all five outputs, on the pairs of ``TABLES`` (the
   clustered and iid chunks' shapes, a hot block that every query probes,
   all pairs masked, a capacity below the tiles needed, tile_m 1 and 16,
   G past 65,536); the ELL tile scoring (kernel 10) at the sparse cell's
   shapes (K 32, lmax 128, V 65,536; a grouped chunk at tile_m 8 and a
   per-pair chunk as tiles of one; f32 and bf16 values; l2, sql2, cosine
   and dot; masked pairs, a capacity below the tiles needed: distances
   within 1e-4, squared ones within 1e-5 of ``|x|^2 + |q|^2``); the row
   projections (kernel 11) against ``torch.matmul`` at the clustered
   query chunk, the 1M build and the sparse query chunk, within the fp32
   sum's bound, a row's bits the same in any batch;
3. clustered 1M cell (``bench.py``'s flagship parameters): one build and
   one exact ground truth (recall@10 on 1,024 queries); unpacked ``knn``
   on those 1,024 queries at budget 1 and at its default budget 32; then
   131,072 queries served by six variants:
   f32 blocks with the kernel tail, the sort tail, and the fused tile
   top-k (``impl="kernel_topk"``); the per-pair path (``knn_batched``,
   variant f, held against the sort tail and the unpacked result); bf16
   blocks with the sort tail and the fused tile top-k; then three
   variants through the XLA-form scorer on the f32 blocks: (g)
   ``metric="cosine"`` with the kernel tail, (h) ``metric="dot"`` with
   the sort tail, each held against the per-pair path with the same
   metric and scored against its own exact scan (recall reported, no
   floor: the JAX package has no record to pin it to), and (i)
   ``impl="xla"`` on ``l2``, held against (b) and required to reach (b)'s
   recall exactly.  The fused variants' distances must be bit-equal to
   their full-kernel twins'.  Kernel 9 is held against its twin on the
   first chunk's own pairs.
   Then the bf16 scan (``brute_force_knn(precision="fastest")``) of
   16,384 queries, recall@10 >= 0.88;
4. iid 100k cell, int8 blocks with slack 8 (``bench.py``'s headline
   parameters): the same on 65,536 queries with the kernel tail; then
   the int8 tile kernel against its plain version on the tiles of the
   cell's first chunk, and kernel 9 on its pairs;
5. iid 100k bracket (``bench.py``'s >= 0.9 recall points on the same
   data): the quality forest (32 trees, ``min_leaf`` 4,096, bf16 blocks)
   served per pair, recall@10 >= 0.90, and the bf16 scan, >= 0.98;
6. iid 1M scan: the bf16 scan of 4,096 queries over 1M rows against the
   fp32 scan on 256, recall@10 >= 0.98;
7. online updates (``updates_*`` lines), on phase 3's forest packed f32
   with slack 32: 100,000 points of the same mixture added in four
   chunks with payloads, each chunk folded into the blocks' slack slots;
   5,000 more left pending; 10,000 ids removed over indexed, folded and
   pending points.  Then (a) on 65,536 queries, the per-pair path at
   ``precision="default"`` (its pending merge through the scan kernel)
   and ``knn_h`` on 8,192, ``knn_h_buckets`` on 1,024, each counted.
   Checks: recall@10 of (a) >= 0.90 against the exact scan of the live
   points, which this script builds; no removed id returned; 4,096 folded
   points and every live pending point each find itself; the fold's
   leaves against a query's primary-side descent (>= 99.9% of the (tree,
   point) pairs) and kernel 7's budget-1 leaves (>= 99%, and equal to its
   plain twin's); ``payload_of`` naming each returned row; each kernel of
   the phase against its plain version on the phase's own first chunks,
   with the fold's occupancy table (kernels 7, 8 with and without the
   bucket stop, 9, 1, 3, 6, 5);
   after ``rebuild``, the size, the counts at 0, the permutation of a
   fresh build and pack of the same rows (both timed), and (a)'s recall
   >= 0.90 and within 0.01 of the folded forest's.  Then on phase 4's
   int8 forest: 10,000 points added and folded (overflow printed), 32,768
   queries with the kernel tail, recall@10 >= 0.10 against the live
   truth, and kernel 2 on the folded chunk.  The steps' times stand with
   the card's name and power limit;
8. the other dense layouts (``layouts_*`` and ``shared_10m*`` lines).
   8a, on phase 3's forest, run after phase 3: 65,536 queries grouped
   (chunk 65,536, tile_m 8) and 8,192 per pair (chunk 2,048) on (j) f32
   sub-blocks of 4 (kmeans; kernel tail and per pair, held against (a)
   and (f): distances within 1e-5, ids outside near-ties, recall within
   0.001 of (a)'s), (k) int8 sub-blocks of 4 (kernel 2 on 32-row
   blocks), (m) centered int8 sub-blocks of 8 (recall >= 0.80 and above
   (l)'s), (n) shared f32 rows (per pair through kernel 6's shared-row
   mode, held against (f); grouped in the XLA form, against (b), recall
   within 0.001 of (b)'s; the rows alias the dataset), and (l) centered
   int8 whole leaves with slack 32, on a twin of the forest, served,
   then with 25,000 points of the mixture folded in and served against
   the live truth (recall within 0.01 of before); each variant's kernels
   on its own first chunk.  8b, after phase 7 with every earlier forest
   freed: ``examples/scale_10m.py``'s cell, 10M x 128 points of 40,000
   centers drawn on the card, ``rp_tree_cfg_clustered``, T 8,
   ``store="shared"``; 65,536 queries per pair (chunk 8,192, sort and
   kernel tails: the same ids outside near-ties) and grouped, recall@10
   >= 0.88 on both, grouped within 0.005 of per pair; the bf16 scan of
   4,096; build, pack and serve times, peak memory, the shared tables'
   bytes beside the blocked layout's;
9. sparse (ELL) data (``sparse_*`` lines): ``examples/bow_sparse.py``'s
   cell, 262,144 documents of 32 terms over 65,536 columns, 256 topic
   bands, drawn with numpy; T 8, ``min_leaf`` 128, f32 ``EllBlocks``;
   8,192 dataset rows as queries: (s1) per pair (chunk 512), (s2) grouped
   with the kernel tail (chunk 4,096), (s3) and (s4) the same with the
   queries an ``EllMatrix``, densified a chunk at a time; recall@10 of
   each >= 0.095 against the exact ELL scan (the JAX package's 0.104
   beside it), (s3) the bits of (s2) and (s4) of (s1), kernel 10 on
   (s2)'s first chunk; then a repack with slack 8 and 4,096 documents
   folded: no row past the blocks' K slots folded, >= 99% of the folded
   documents found by themselves through (s3)'s path;
10. the user surface (``surface_*`` lines), run in two parts: 10a on
   phase 3's forest before phase 8a, 10b on phase 4's after phase 6.
   (u1) ``rp.forest`` over phase 3's 1M rows in 16 chunks from the host
   with phase 3's parameters: the trees ``torch.equal`` to phase 3's;
   packed f32 and served grouped with the kernel tail on 65,536 queries,
   bit-equal to (a).  (u4) ``rp.tune`` on phase 3's forest packed f32,
   measured, ``serving="grouped"`` and ``"batched"`` on 1,024 queries
   (budgets 1, 2, 4; probes 1 and 2 a tree), and grouped again on 8,192
   (timed in chunks of 8,192): the target 0.9 met, the returned recall
   that of ``rp.knn`` (or of the scan) at the returned knobs, every
   frontier point timed.  (u5) ``rp.data_batch`` of 1M ``normal_dense2``
   rows at D 128 on the card, its mixture share and component means
   within 5 standard errors; ``circle2d2`` within radius 1 of its
   centres.  (u2) ``ForestBuilder(anytime_slack=8)`` over the iid 100k
   rows in 4 chunks: after each, the partial index per pair on 8,192
   queries drawn from the rows seen (a seen point plus 0.1 noise),
   recall@10 >= 0.10 against the exact scan of the rows seen,
   the pending count printed; ``build()`` ``torch.equal`` to phase 4's
   batch build.  (u3) ``save_forest`` / ``load_forest`` of phase 4's
   forest (arrays ``torch.equal``; repacked int8 with slack 8, 32,768
   queries with the kernel tail bit-equal to the original's), the
   per-tree blobs in order and reversed, ``save_forest`` refused after
   ``add``; bytes and host-clock seconds.  (u4) ``rp.tune_build`` on the
   iid rows, ``measure=False``, target 0.10: a forest meets it;
11. the kernels' launch counts over phases 3-10 and 12-15, each of
   which must be > 0;
12. the side layers (``side_*`` lines), run in two parts: 12a on phase
   3's forest after 10a, 12b on phase 4's after 10b.  (p1)
   ``rp.profiling.trace`` around one grouped chunk of phase 3's forest
   (f32 blocks, kernel tail, 65,536 queries): the Chrome trace read back
   holds the query scopes (``rpt_candidates``, ``rpt_tile_tables``,
   ``rpt_grouped_score``, ``rpt_topk_tail``) and
   kernels 11, 7, 8, 9, 1 and 3 as CUDA kernel events, the result
   bit-equal to the untraced call's, each scope's summed CUDA time
   printed; then one ``knn_batched`` chunk (``rpt_rerank``), a build of
   phase 4's rows (``rpt_project``, ``rpt_partition_at_median``) and a
   fold of 1,000 rows (``rpt_insert``), each scope present;
   ``region()``'s host cost with no profiler running.  (p2)
   ``rp.device_time`` of the grouped chunk, > 0 and at most 1.1 times
   the synchronised host-clock median of the same call.  (p6)
   ``forest_batch(dtype=torch.bfloat16)`` on phase 3's rows: the trees
   ``torch.equal`` to an f32 build over the bf16-rounded rows; packed
   (bf16 blocks) and served grouped with the kernel tail, recall@10 >=
   0.90 against its own exact scan; ``save_forest`` (``x`` a ``|V2``
   array) / ``load_forest`` bit-equal.  (p3) ``rptree_tpu_torch.demo``:
   its four files, 10,000 rows each (the knn files plus hits labelled
   -1), a dot leaf label per plan leaf.  (p4) the native ingest library
   loaded; phase 4's rows through ``write_fvecs`` / ``read_fvecs``
   ``torch.equal``, and ``rp.forest`` over ``fvecs_source`` (chunks of
   25,000) equal to phase 4's build; MB/s.  (p5)
   ``bench_grid(REFERENCE_SCALE_GRID)``: five rows, dense, sparse (ELL)
   and streaming, recall > 0.  (p7) ``examples/torch_sift_pipeline.py``
   on three files written by ``write_fvecs`` / ``write_ivecs`` (20,000 x
   64 synthetic rows) and ``examples/torch_clustered_scatter.py``, each a
   process of its own, exit 0;
13. the tree- and query-sharded forests (``sharded_*`` lines), four
   shards on the one card (``forest_mesh(..., devices=[card] * 4)``), in
   two parts: 13a on phase 3's forest after 12a, 13b on phase 4's right
   after it is served.  (d1) ``forest_batch_distributed`` on
   ``forest_mesh(4, 1)``: the trees ``torch.equal`` to phase 3's, the
   dataset shared.  (d2) leaf-sharded f32 blocks served grouped at phase
   3's settings, with the kernel tail and with ``kernel_topk``, held
   against (a) and (c): distances within 1e-4 relative (the entries
   whose bits differ counted), ids outside near-ties, recall within
   0.001 of (a)'s.  (d3) ``distribute`` onto ``forest_mesh(2, 2)``,
   tree-sharded f32 blocks: per pair (kernel 6) against (f), then
   ``knn_h`` (the global bucket stop) on 16,384 queries against the
   single-device ``knn_h``.  (d4) phase 4's forest on ``forest_mesh(4,
   1)``, leaf-sharded int8 blocks with slack 8 served as phase 4 serves
   them, against phase 4's result; then 2,000 points added to it and to
   a single-device twin, served pending at ``precision="default"``
   (kernel 5), folded, ``recall_with`` within 1e-6 and served again,
   each against the twin.  Each sharded variant's kernels launch once a
   chunk on each shard.  QPS beside the single-device variant's;
14. the data-parallel forests (``dataparallel_*`` lines), the dataset
   sharded over four shards of the one card (``data_mesh(devices=[card]
   * 4)``), in three parts.  14a on phase 3's forest after 13a: (e1)
   ``forest_batch_data_parallel`` over views of phase 3's rows with its
   projections: thresholds and margins bit-equal to phase 3's on the live
   segments, every leaf phase 3's member set; its seconds and kernel
   launches (``torch.profiler``) against a single-device build's;
   (e2) packed f32 from the sharded rows, served like (a) and like (c):
   distances within 1e-4 relative of theirs (differing bits counted), ids
   outside near-ties, recall within 0.001 of (a)'s; (e3)
   ``brute_force_knn_sharded`` on 1,024 queries against the fp32 scan;
   (e4) ``recall_with`` within 1e-6 of one device's; (e5) the rows in 16
   chunks through ``ForestBuilder(mesh=...)``: the batch build's trees.
   14b on phase 4's forest after 13b: (e6) the data-parallel trees are
   phase 4's; int8 blocks with slack 8 served as phase 4 serves them,
   against its result; (e7) ``save_forest_sharded`` then
   ``load_forest_sharded`` onto a two-shard mesh: the same bits served;
   (e8) two processes of a gloo group, two shards of the card each,
   each ingesting only its half of the rows from an fvecs file
   (``examples/torch_multihost_bench.py``): ``perm`` equal to the
   four-shard build's, its grouped ids too; (e9) 2,000 points added,
   served pending, folded, ``recall_with`` and served again against a
   single-device twin.  14c inside phase 8b, on its 10M rows before its
   forest is freed: (e10) the data-parallel build's trees are phase 8b's;
   ``pack_leaves(store="shared")`` (each shard's rows its row store, the
   ``all_probes`` mode) served per pair like ``shared_10m_per_pair_sort``
   (kernel 6's shared-row mode, the sort tail) and grouped with the
   kernel tail (the XLA form, kernel 3): distances within 1e-4 relative
   of phase 8b's per-pair ones (differing bits counted), recall within
   0.001; each shard's slot-table bytes beside the blocked layout's and
   phase 8b's shared tables'.
   Bytes a shard, peak memory and the phase's seconds stand with each.
15. the examples (``examples_*`` lines), after every other phase with
   every forest freed: the seven ``examples/torch_*.py`` ports of
   ``clustered_1m``, ``serving_loop``, ``scale_10m``, ``bow_sparse``,
   ``scale_1m``, ``fold_drift`` and ``scan_ladder``, one after another,
   each a process of its own on the card at its defaults
   (``python3 chip_smoke.py --example NAME [args]`` runs the file as
   ``__main__``, as ``python examples/NAME.py [args]`` does, with each
   kernel's first launch at each new shape of its arguments held against
   its plain version, as phase 2 holds it, then prints those checks and
   the kernels' launch counts of that run); each must exit 0, launch the
   kernels of its path, every one of them checked, and print its lines,
   which are held to the repo's floors: the clustered sweep's f32 T 8 /
   ``min_leaf`` 128 / budget 1 / probes 8 row recall@10 >= 0.90; the 10M
   shared cell per pair and grouped >= 0.88; bag-of-words, its three
   paths >= 0.095; the scan ladder's ``highest`` rung >= 0.999 and its
   bf16 rungs and kernel 5 >= 0.98; the stationary fold-drift stream up
   to 80% folded, fold-only and rebuilt recall each >= 0.99 and within
   0.02 of each other; the serving loop's ``overflow`` False, its
   ``check=False`` calls run under ``torch.cuda.set_sync_debug_mode(
   "error")`` (a sync it detects raises); the 1M scale check's recall >
   0.  Each line carries the example's seconds, its numbers and the
   card.  Before them, ``check=False`` calls on a smaller clustered
   forest under ``torch.profiler``: no runtime synchronize, copy to the
   host or scalar read in the trace.

Each scan of phases 3, 5, 6 and 8 is also held, on its first chunk of
queries, against the scan kernel's plain version at that shape; kernels
7 and 8, on the cells' own forests and first chunks (phases 3-5).

Every variant is served with the launch counts set to 0 just before it
and read just after it: the kernels it must run have launched once per
chunk and pass, and every other kernel of the path not at all.  Every
query path runs kernels 11 (the query projections) and 7 once per chunk,
the packed ones kernel 8 too, the grouped ones kernel 9 too, the ELL ones
kernel 10 and no dense path kernel 10.

Then one JSON line describing each kernel and, last, the result line
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero and prints no result line.  It needs a CUDA device and
the checkout's ``rptree_tpu_torch`` package; it never imports JAX.
"""

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20260816
K = 10
DIST_RTOL = 1e-4           # kernel vs plain version, distances (relative)
# f32 / bf16 tile kernels on a served chunk: squared distances within this
# share of |x|^2 + |q|^2, the terms the factored form cancels (a 128-term
# fp32 dot product's error bound, 2 * 128 * 2**-24, is 1.5e-5 of them); the
# clustered cell's distances are ~1% of its norms, so two correct summation
# orders can part by more than DIST_RTOL of a distance there
SUM_RTOL = 1e-5
CLUSTERED_MIN_RECALL = 0.90
BF16_MIN_RECALL = 0.80     # single-pass bf16 products; the JAX package: 0.860
IID_MIN_RECALL = 0.10
SCAN_MIN_RECALL = {"clustered": 0.88, "bracket": 0.98, "1m": 0.98}
BRACKET_MIN_RECALL = 0.90
KP = 16                    # the fused tile top-k's per-pair width at k = 10
JAX_RECALL = {"clustered": 0.9249, "iid": 0.123,   # the JAX package's records
              "clustered_scan": 0.9037, "bracket_tree": 0.9276,
              "bracket_scan": 0.9943, "scan_1m": 0.9937}
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory bytes / s, and operations / s by operand type
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(nbytes, ops, kind):
    """``{"bound_ms", "bound_by"}``: the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) and
    to do ``ops`` operations on ``kind`` operands, whichever is longer."""
    by_bytes = nbytes / HBM_BPS * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(nbytes), "bound_ops": int(ops)}


def tile_bound(x, tb, lens, tile_m, qt, out_bytes_per_row, kind, ids=False):
    """:func:`bound` of a tile kernel on these inputs: the occupied rows
    of the blocks the tiles use (the most any tile reads of each), their
    norms (and ids), the tiles' query rows and tables, the output."""
    import torch

    g, lmax, d = x.shape
    rows = torch.zeros(g, dtype=torch.int64, device=tb.device).scatter_reduce(
        0, tb.long(), lens.long().clamp(0, lmax), "amax")
    nrows = int(rows.sum())
    row_bytes = d * x.element_size() + 4 + (4 if ids else 0)
    nbytes = (nrows * row_bytes + qt.numel() * 4 + tb.numel() * 8
              + qt.shape[0] * out_bytes_per_row)
    if kind == "int8":
        nbytes += int((rows > 0).sum()) * 4  # block scales
    ops = 2 * tile_m * int(lens.long().clamp(0, lmax).sum()) * d
    return bound(nbytes, ops, kind)


def cuda_ms(fn, reps=5):
    """Mean milliseconds of ``fn()`` on the card by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, replays=5):
    """Mean device milliseconds of ``fn()``: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between two CUDA events, so that
    the host's cost of each call (argument checks, launch) is off the
    clock; where a call costs the host more than the card, :func:`cuda_ms`
    times the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up on a side stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def host_us(fn, calls=20, batches=5):
    """Microseconds of host time a call of ``fn`` takes to return (the
    card may still be running it): the median over ``batches`` of
    ``calls`` calls each, every batch after a synchronise."""
    import torch

    fn()
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return float(np.median(per))


def tables_grids(fn):
    """The grids kernel 9 launches in one call of ``fn``, by the kernel
    library's own count (``rpt_tile_tables_grids``)."""
    from rptree_tpu_torch import _cuda

    lib = _cuda.lib()
    before = lib.rpt_tile_tables_grids()
    fn()
    return lib.rpt_tile_tables_grids() - before


# -- phase 2: kernels against their plain versions -------------------------

def _rel_err(got, want):
    """Largest ``|got - want| / max(|want|, 1)`` over finite entries, after
    checking that both are infinite at the same places."""
    import torch

    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError("kernel and plain version disagree on masking")
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    if diff.numel() == 0:
        return 0.0, 0.0
    rel = diff / want[fin].abs().clamp_min(1.0)
    return float(diff.max()), float(rel.max())


def tile_inputs(g, lmax, d, nt, tile_m, int8, device, seed=1, bf16=False):
    """Blocks, tables and query rows at the serving path's shapes: runs of
    one repeated block, partial and empty occupancy, junk empty slots;
    slot norms from the f32 rows, as packing takes them."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(g, lmax, d, generator=gen)
    sq = (x * x).sum(-1)
    tb = torch.randint(0, g, (nt,), generator=gen, dtype=torch.int32)
    tb[: nt // 8] = tb[0]
    lens = torch.randint(1, lmax + 1, (nt,), generator=gen, dtype=torch.int32)
    lens[::7] = lmax
    lens[1] = 0
    qt = torch.randn(nt * tile_m, d, generator=gen)
    scale = None
    if bf16:
        x = x.bfloat16()
    if int8:
        from rptree_tpu_torch.ops.grouped_kernel import INV_127

        scale = x.abs().amax(dim=(1, 2)) * INV_127
        x = torch.round(x / scale[:, None, None]).clamp(-127, 127).to(
            torch.int8)
    to = {"device": device}
    return (x.to(**to), sq.to(**to), None if scale is None else scale.to(**to),
            tb.to(**to), lens.to(**to), qt.to(**to))


def block_order(g, lmax, nt, device, seed=4, run=8):
    """Tile tables as the serving path's ``_tile_tables`` makes them: tiles
    in block order, runs of ``run`` tiles on one block, one occupancy per
    block.  Returns ``(tb, lens)``."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    blocks = torch.randperm(g, generator=gen)[: -(-nt // run)].sort().values
    tb = blocks.repeat_interleave(run)[:nt].to(torch.int32)
    lens = torch.randint(1, lmax + 1, (g,), generator=gen, dtype=torch.int32)
    return tb.to(device), lens[tb.long()].to(device)


def topk_inputs(b, w, device, seed=2):
    """Candidate rows with ties, duplicate ids (duplicates carry the same
    distance, as on exact layouts, and different ones) and exhausted rows."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    d = torch.randint(0, 2000, (b, w), generator=gen).float() / 100.0
    ids = torch.randint(0, 4 * w, (b, w), generator=gen, dtype=torch.int32)
    ids[:, w // 2:] = ids[:, : w - w // 2]     # every id twice
    d[::3, w // 2:] = d[::3, : w - w // 2]     # same-distance copies
    masked = torch.rand(b, w, generator=gen) < 0.3
    masked[5::97] = True                       # exhausted rows
    masked[5::97, :3] = False
    d = torch.where(masked, float("inf"), d)
    ids = torch.where(masked, -1, ids)
    return d.to(device), ids.to(device)


# Kernel 3's chunks at the cells' sizes: (rows, pairs, lmax, leaves of the
# id table): the grouped cells' chunk over SIFT-1M's 65,536 leaves of 128,
# and the 10M cell's chunk over BIGANN-10M's 524,288 leaves of 160.
TAIL_CHUNKS = {"": (65536, 8, 128, 65536), "_10m": (8192, 8, 160, 524288)}


def pair_topk_inputs(b, p, lmax, nb, device, seed=3):
    """The selection tail's operands at a chunk of ``b`` rows of ``p``
    pairs over an id table of ``nb`` leaves of ``lmax``, as a cell holds
    it: 8 trees of ``nb / 8`` leaves, each tree's leaves a permutation of
    its points (random lengths, -1 past them); pair ``j`` of a row is a
    leaf of tree ``j % 8`` drawn from the whole tree, a tenth of the pairs
    masked (+inf, row 0).  A point's distance depends on the row and the
    id alone, so its copies in other trees are equal."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    t = 8
    per = nb // t
    id_leaf = torch.cat([torch.randperm(per * lmax, generator=gen,
                                        device=device).reshape(per, lmax)
                         for _ in range(t)]).to(torch.int32)
    lens = torch.randint(lmax // 2, lmax + 1, (nb, 1), generator=gen,
                         device=device)
    id_leaf = torch.where(torch.arange(lmax, device=device) < lens, id_leaf,
                          -1)
    rows = (torch.arange(p, device=device) % t * per + torch.randint(
        0, per, (b, p), generator=gen, device=device)).to(torch.int32)
    ids = id_leaf[rows.long()].long()
    key = ids * 2654435761 + torch.arange(b, device=device)[:, None, None] \
        * 40503
    d = (key % (1 << 20)).float() / (1 << 20)
    masked = (torch.rand(b, p, generator=gen, device=device) < 0.1)[..., None]
    d = torch.where((ids < 0) | masked, float("inf"), d)
    rows = torch.where(masked[..., 0], 0, rows).to(torch.int32)
    return d.reshape(b, p * lmax).contiguous(), id_leaf.contiguous(), rows


def check_topk_pairs(device, reps):
    """Kernel 3's pair form (the ids read in place from the leaf id table)
    at the grouped chunk and the 10M chunk, each over its cell's own id
    table (``TAIL_CHUNKS``): bit for bit against the ids form on the
    gathered ids and against the plain version, dedup on and off; then its
    time against the route that gathers the ids first (the id gather, then
    the ids form), in turns (pairs, gather, gather, pairs), by CUDA events
    and as device time, and the rows that took a second prefix or a tie
    overflow."""
    import torch

    from rptree_tpu_torch.ops import topk_kernel as tk

    rec = {"max_abs_err": 0.0, "ids_equal": True, "library_ms": None}
    for label, (b, p, lmax, nb) in TAIL_CHUNKS.items():
        d, id_leaf, rows = pair_topk_inputs(b, p, lmax, nb, device)
        paths = torch.zeros(2, dtype=torch.int64, device=device)
        for dedup in (True, False):
            got = tk.topk_dedup_pairs(d, id_leaf, rows, K, dedup=dedup,
                                      paths=paths)
            ids = id_leaf[rows.long()].reshape(b, -1)
            _same_bits(f"topk_dedup_pairs{label} against the ids form", got,
                       tk.topk_dedup_kernel(d, ids, K, dedup=dedup))
            _same_bits(f"topk_dedup_pairs{label}", got,
                       tk.topk_dedup_pairs_reference(d, id_leaf, rows, K,
                                                     dedup=dedup))
            del ids

        def pairs():
            return tk.topk_dedup_pairs(d, id_leaf, rows, K)

        def gather():
            return tk.topk_dedup_kernel(
                d, id_leaf[rows.long()].reshape(b, -1), K)

        turns = {"pairs": [], "gather": []}
        for turn, fn in (("pairs", pairs), ("gather", gather),
                         ("gather", gather), ("pairs", pairs)):
            turns[turn].append(cuda_ms(fn, reps))
        w = p * lmax
        # the id table's rows the chunk touches: the least id bytes a read
        # from HBM can take, where the card's L2 holds a row between pairs
        touched = int(torch.unique(rows).numel()) * lmax * 4
        rec.update({
            f"ms{label}": min(turns["pairs"]),
            f"device_ms{label}": graph_ms(pairs),
            f"gather_route_ms{label}": min(turns["gather"]),
            f"gather_route_device_ms{label}": graph_ms(gather),
            f"turns_ms{label}": turns,
            # the design reads each distance and each id once (the pair rows
            # too) and writes the k winners; the gather route also writes
            # and reads back the [B, W] ids
            **{f"{key}{label}": v for key, v in bound(
                b * w * 8 + b * p * 4 + b * K * 8, b * w, "f32").items()},
            f"bound_ms_touched{label}": bound(
                b * w * 4 + touched + b * p * 4 + b * K * 8, b * w,
                "f32")["bound_ms"],
            f"gather_route_bytes{label}": b * w * 16 + b * p * 4 + b * K * 8,
            f"paths{label}": {"rows": 2 * b,
                              "second_prefix": int(paths[0]),
                              "tie_overflow": int(paths[1])},
            f"shape{label}": {"rows": b, "P": p, "lmax": lmax, "W": w,
                              "k": K, "table_leaves": nb,
                              "table_bytes": nb * lmax * 4,
                              "table_bytes_touched": touched,
                              "route": tk.topk_route(w)},
        })
        if label == "":
            rec["plain_ms"] = cuda_ms(lambda: tk.topk_dedup_pairs_reference(
                d, id_leaf, rows, K), 2)
        del d, id_leaf, rows
        torch.cuda.empty_cache()
    return rec


def pairs_bound(x, tb, lens_t, tp, slot, q, kind):
    """:func:`bound` of kernel 1's pair form: each probed block's occupied
    rows and norms once, each query row once, the tables, the pairs'
    distance rows."""
    import torch

    g, lmax, d = x.shape
    filled = tp[:, 0] >= 0
    blocks = torch.unique(tb[filled].long())
    nrows = int(lens_t.new_zeros(g).scatter_(
        0, tb.long(), lens_t.clamp(0, lmax))[blocks].sum())
    nbytes = (nrows * (d * x.element_size() + 4) + q.numel() * 4
              + tb.numel() * 8 + tp.numel() * 4 + slot.numel() * 8
              + slot.numel() * lmax * 4)
    pair_lens = lens_t[:, None].expand_as(tp)[tp >= 0]
    ops = 2 * d * int(pair_lens.clamp(0, lmax).long().sum())
    return bound(nbytes, ops, kind)


def check_pairs_chunk(device, b, g=65_536, lmax=128, dim=128, p=8, tile_m=8,
                      reps=5, bf16=False):
    """Kernel 1's pair form (``grouped_score_pairs``) at a cell's chunk:
    ``b`` queries x ``p`` probes drawn uniformly over ``g`` blocks of
    ``lmax`` x ``dim`` f32 (``bf16``: bf16) rows, 100-128 occupied, 2% of
    the probes masked, at the serving path's capacity (1.125 times the
    tiles needed): bit-equal to the slot-order composition through the
    same kernel, within ``DIST_RTOL`` of the plain version; with its
    times, the plain version's, its launches, its block stagings and its
    bound."""
    import torch

    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops import grouped_kernel as gk

    gen = torch.Generator(device=device).manual_seed(b)
    x = torch.randn(g, lmax, dim, generator=gen, device=device)
    if bf16:
        x = x.bfloat16()
        torch.cuda.empty_cache()
    # the norms a slice of blocks at a time (at D 960 x is 32 GB)
    sq = torch.cat([(c.float() * c.float()).sum(-1) for c in x.split(4096)])
    lens = torch.randint(lmax - 28, lmax + 1, (g,), generator=gen,
                         device=device, dtype=torch.int32)
    q = torch.randn(b, dim, generator=gen, device=device)
    gsel = torch.randint(0, g, (b, p), generator=gen, device=device,
                         dtype=torch.int32)
    lsel = torch.where(torch.rand(b, p, generator=gen, device=device) < 0.02,
                       -1, 1).to(torch.int32)
    need = int(og.tile_tables(gsel, lsel, lens, tile_m, 1)[2])
    tb, tp, _, slot, lens_t = og.tile_tables(gsel, lsel, lens, tile_m,
                                             need + need // 8)
    args = (x, sq, tb, tp, lens_t, slot, q, "l2", tile_m)

    def launches():
        return (gk.grouped_score_tiles.launches_bf16 if bf16 else
                gk.grouped_score_tiles.launches)

    before = launches()
    got = gk.grouped_score_pairs(*args)
    if launches() != before + 1:
        raise AssertionError(f"grouped_score_pairs at {b} queries, D {dim}: "
                             f"{launches() - before} launches, not 1")
    qi = torch.where(tp >= 0, tp // p, 0).reshape(-1).long()
    slot_order = og._pair_rows(gk.grouped_score_tiles(
        x, sq, tb, lens_t, q[qi], "l2", tile_m), slot, float("inf"), b,
        p).reshape(b * p, lmax)
    if not torch.equal(got.view(torch.int32), slot_order.view(torch.int32)):
        raise AssertionError(f"grouped_score_pairs at {b} queries, D {dim}: "
                             "differs from the slot-order composition")
    del slot_order
    abs_err, rel_err = _rel_err(got, gk.grouped_score_pairs_reference(*args))
    if rel_err > DIST_RTOL:
        raise AssertionError(f"grouped_score_pairs at {b} queries, D {dim}: "
                             f"relative error {rel_err} > {DIST_RTOL}")
    del got
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    runs = int(gk.score_runs(tb, tp, lens_t, tile_m, sms))
    before = launches()
    rec = {"max_abs_err": abs_err, "max_rel_err": rel_err,
           "ms": cuda_ms(lambda: gk.grouped_score_pairs(*args), reps),
           "device_ms": graph_ms(lambda: gk.grouped_score_pairs(*args),
                                 reps=5),
           "plain_ms": cuda_ms(
               lambda: gk.grouped_score_pairs_reference(*args), reps),
           "library_ms": None, "launches": launches() - before,
           "block_reads": runs,
           "pairs_per_read": int((lsel >= 0).sum()) / runs,
           **pairs_bound(x, tb, lens_t, tp, slot, q,
                         "bf16" if bf16 else "f32"),
           "shape": {"queries": b, "probes": p, "blocks": g, "lmax": lmax,
                     "D": dim, "dtype": "bf16" if bf16 else "f32",
                     "tile_m": tile_m, "tiles": tb.shape[0],
                     "tiles_needed": need}}
    del x, sq, args
    torch.cuda.empty_cache()
    return rec


def check_kernels(device, g=4096, nt=4096, dim=128, reps=5):
    """Phase 2: each kernel against its plain version at the path's shapes
    (f32 and bf16 lmax 128, int8 lmax 64, tile_m 8, D 128, tile top-k kp
    16, tiles in random and in block order; kernel 1's pair form at the
    grouped and online cells' chunks and, f32 and bf16, at the GIST
    cell's (D 960), :func:`check_pairs_chunk`; top-k W
    1024 and 640, k 10, 65,536 x 1,024 and the wide-row route at W 3,000).
    Returns one record per kernel."""
    import torch

    from rptree_tpu_torch.ops import grouped_kernel as gk
    from rptree_tpu_torch.ops import topk_kernel as tk

    tile_m = 8
    shape = {"tiles": nt, "tile_m": tile_m, "D": dim}
    out = {}
    for name, kind, lmax in (("grouped_score_tiles", "f32", 128),
                             ("grouped_score_tiles_bf16", "bf16", 128),
                             ("grouped_score_tiles_int8", "int8", 64)):
        x, sq, scale, tb, lens, qt = tile_inputs(
            g, lmax, dim, nt, tile_m, kind == "int8", device,
            bf16=kind == "bf16")
        if kind == "int8":
            args = (x, sq, scale, tb, lens, qt)
            kern, plain = gk.grouped_score_tiles_int8, \
                gk.grouped_score_tiles_int8_reference
        else:
            args = (x, sq, tb, lens, qt)
            kern, plain = gk.grouped_score_tiles, \
                gk.grouped_score_tiles_reference
        for metric in ("sql2", "l2"):
            got = kern(*args, metric, tile_m)
            want = plain(*args, metric, tile_m)
            torch.cuda.synchronize()
            abs_err, rel_err = _rel_err(got, want)
            if rel_err > DIST_RTOL:
                raise AssertionError(f"{name} {metric}: relative error "
                                     f"{rel_err} > {DIST_RTOL}")
        out[name] = {
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": cuda_ms(lambda: kern(*args, "l2", tile_m), reps),
            "plain_ms": cuda_ms(lambda: plain(*args, "l2", tile_m), reps),
            "library_ms": None,
            **tile_bound(x, tb, lens, tile_m, qt, lmax * 4, kind),
            "shape": {**shape, "lmax": lmax},
        }
        # the serving path's tile order as well
        tbo, lenso = block_order(g, lmax, nt, device)
        argso = (*args[:-3], tbo, lenso, qt)
        _, rel_o = _rel_err(kern(*argso, "l2", tile_m),
                            plain(*argso, "l2", tile_m))
        if rel_o > DIST_RTOL:
            raise AssertionError(f"{name} in block order: relative "
                                 f"error {rel_o} > {DIST_RTOL}")
        out[name]["ms_block_order"] = cuda_ms(
            lambda: kern(*argso, "l2", tile_m), reps)
        out[name]["device_ms"] = graph_ms(lambda: kern(*args, "l2", tile_m))
        out[name]["device_ms_block_order"] = graph_ms(
            lambda: kern(*argso, "l2", tile_m))
        out[name].update({
            f"{key}_block_order": v for key, v in tile_bound(
                x, tbo, lenso, tile_m, qt, lmax * 4, kind).items()})
    # the pair form at the grouped and online cells' chunks, and at the
    # GIST cell's (D 960), f32 and bf16 blocks
    for b in (65_536, 8_192):
        out[f"grouped_score_pairs_{b}"] = check_pairs_chunk(device, b)
    for bf16 in (False, True):
        out["grouped_score_pairs_gist" + "_bf16" * bf16] = check_pairs_chunk(
            device, 65_536, dim=960, bf16=bf16)
    rec = {"shape": {**shape, "lmax": 128, "kp": KP}}
    for kind in ("f32", "bf16"):
        x, sq, _, tb, lens, qt = tile_inputs(g, 128, dim, nt, tile_m, False,
                                             device, bf16=kind == "bf16")
        ids = torch.randperm(g * 128, generator=torch.Generator().manual_seed(3)
                             ).to(torch.int32).reshape(g, 128).to(device)
        args = (x, sq, ids, tb, lens, qt)
        for metric in ("sql2", "l2"):
            kd, ki = gk.grouped_score_topk(*args, metric, tile_m, KP)
            pd, pi = gk.grouped_score_topk_reference(*args, metric, tile_m, KP)
            full = gk.grouped_score_tiles(x, sq, tb, lens, qt, metric, tile_m)
            first = torch.sort(full, dim=1, stable=True).values[:, :KP]
            torch.cuda.synchronize()
            abs_err, rel_err = _rel_err(kd, pd)
            if rel_err > DIST_RTOL:
                raise AssertionError(f"grouped_score_topk {kind} {metric}: "
                                     f"relative error {rel_err}")
            if not torch.equal(kd.view(torch.int32), first.view(torch.int32)):
                raise AssertionError(f"grouped_score_topk {kind} {metric}: "
                                     "distances differ from the tile kernel's")
            # the kp-th id is compared only where the unseen (kp + 1)-th
            # does not nearly tie it
            wide = gk.grouped_score_topk_reference(*args, metric, tile_m,
                                                   KP + 1)[0]
            chk = gk.untied(wide, DIST_RTOL)[:, :KP]
            if not torch.equal(ki[chk], pi[chk]) or bool(
                    (ki[torch.isinf(kd)] != -1).any()):
                raise AssertionError(f"grouped_score_topk {kind} {metric}: "
                                     "ids differ from the plain version's")
        sfx = "" if kind == "f32" else "_bf16"
        rec.update({
            f"max_abs_err{sfx}": abs_err, f"max_rel_err{sfx}": rel_err,
            f"ms{sfx}": cuda_ms(lambda: gk.grouped_score_topk(
                *args, "l2", tile_m, KP), reps),
            f"plain_ms{sfx}": cuda_ms(lambda: gk.grouped_score_topk_reference(
                *args, "l2", tile_m, KP), reps),
        })
        b = tile_bound(x, tb, lens, tile_m, qt, KP * 8, kind, ids=True)
        rec.update({f"{key}{sfx}": v for key, v in b.items()})
        tbo, lenso = block_order(g, 128, nt, device)
        argso = (x, sq, ids, tbo, lenso, qt)
        kdo, _ = gk.grouped_score_topk(*argso, "l2", tile_m, KP)
        fullo = gk.grouped_score_tiles(x, sq, tbo, lenso, qt, "l2", tile_m)
        if not torch.equal(kdo.view(torch.int32), torch.sort(
                fullo, dim=1, stable=True).values[:, :KP].view(torch.int32)):
            raise AssertionError(f"grouped_score_topk {kind} in block order:"
                                 " distances differ from the tile kernel's")
        rec[f"ms_block_order{sfx}"] = cuda_ms(lambda: gk.grouped_score_topk(
            *argso, "l2", tile_m, KP), reps)
        b = tile_bound(x, tbo, lenso, tile_m, qt, KP * 8, kind, ids=True)
        rec.update({f"{key}_block_order{sfx}": v for key, v in b.items()})
    rec["max_abs_err"] = max(rec["max_abs_err"], rec["max_abs_err_bf16"])
    rec["library_ms"] = None
    out["grouped_score_topk"] = rec
    topk_err, times = 0.0, {}
    for w in (1024, 640):
        d, ids = topk_inputs(8192, w, device)
        for dedup in (True, False):
            kd, ki = tk.topk_dedup_kernel(d, ids, K, dedup=dedup)
            pd, pi = tk.topk_dedup_kernel_reference(d, ids, K, dedup=dedup)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and torch.equal(
                    kd.view(torch.int32), pd.view(torch.int32))):
                bad = int((ki != pi).any(dim=1).sum())
                raise AssertionError(f"topk_dedup_kernel W={w} dedup={dedup}"
                                     f": {bad} rows differ")
            topk_err = max(topk_err, _rel_err(kd, pd)[0])
        times[w] = (cuda_ms(lambda: tk.topk_dedup_kernel(d, ids, K), reps),
                    cuda_ms(lambda: tk.topk_dedup_kernel_reference(d, ids, K),
                            reps),
                    cuda_ms(lambda: tk.topk_dedup_kernel(d, ids, K,
                                                         dedup=False), reps),
                    # the one PyTorch call that computes dedup=False's
                    # function (its tie order unpromised)
                    cuda_ms(lambda: torch.topk(d, K, dim=1, largest=False),
                            reps))
    # a real clustered chunk (65,536 queries x 8 probes x lmax 128), and the
    # wide-row route past W 1,024, each held against the plain version
    big = {}
    for b, w in ((65536, 1024), (2048, 3000)):
        d, ids = topk_inputs(b, w, device)
        for dedup in (True, False):
            kd, ki = tk.topk_dedup_kernel(d, ids, K, dedup=dedup)
            pd, pi = tk.topk_dedup_kernel_reference(d, ids, K, dedup=dedup)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and torch.equal(
                    kd.view(torch.int32), pd.view(torch.int32))):
                raise AssertionError(f"topk_dedup_kernel B={b} W={w} "
                                     f"dedup={dedup}: rows differ")
        big[w] = cuda_ms(lambda: tk.topk_dedup_kernel(d, ids, K), reps)
        del d, ids, kd, ki, pd, pi
    out["topk_dedup_kernel"] = {
        "max_abs_err": topk_err, "ids_equal": True,
        "ms": times[1024][0], "plain_ms": times[1024][1],
        "ms_no_dedup": times[1024][2], "library_ms": times[1024][3],
        "library_call": "torch.topk(largest=False), the dedup=False function",
        "ms_w640": times[640][0], "plain_ms_w640": times[640][1],
        # the rows read once and the k winners written; a selection does at
        # least one comparison per candidate
        **bound(8192 * 1024 * 8 + 8192 * K * 8, 8192 * 1024, "f32"),
        "shape": {"rows": 8192, "W": [1024, 640], "k": K},
        "ms_chunk": big[1024],
        **{f"{key}_chunk": v for key, v in bound(
            65536 * 1024 * 8 + 65536 * K * 8, 65536 * 1024, "f32").items()},
        "shape_chunk": {"rows": 65536, "W": 1024, "k": K},
        "ms_wide": big[3000], "shape_wide": {"rows": 2048, "W": 3000, "k": K},
    }
    out["topk_dedup_pairs"] = check_topk_pairs(device, reps)
    out.update(check_gather(device, reps))
    out.update(check_scan(device, reps))
    out.update(check_descent(device, reps))
    out.update(check_tables(device, reps))
    out.update(check_ell(device, reps))
    out.update(check_project(device, reps))
    return out


# (cell, n, min_leaf, trees, queries a launch, budget, probes): the
# descents the main path runs (phases 3-5), then one past shared memory's
# cap (kernel 7's global-scratch route, which no served cell takes)
DESCENTS = (("clustered_chunk", 1_000_000, 128, 8, 65_536, 1, 8),
            ("iid_chunk", 100_000, 64, 8, 32_768, 2, 10),
            ("bracket_chunk", 100_000, 4096, 32, 32, 2, 32),
            ("unpacked_b32", 1_000_000, 128, 8, 1_024, 32, None),
            ("global_route", 1_000_000, 64, 2, 64, 8_500, None))


def descent_inputs(n, min_leaf, trees, b, device, seed):
    """A plan at a cell's shape (its depth from ``rp_tree_cfg``), a node
    table of thresholds and margins, and ``[T, L, B]`` projections, all
    multiples of 1/64 so that projections hit thresholds and margins
    exactly (the forks' tie rules); one query in 16 is all zeros."""
    import torch

    import rptree_tpu_torch as rp
    from rptree_tpu_torch.ops import traverse as tv

    plan = rp.make_plan(n, rp.rp_tree_cfg(min_leaf, n, 128).max_depth,
                        min_leaf)
    nl, smax = plan.n_levels, max(lp.n_segs for lp in plan.levels)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dyadic(*shape):
        return torch.round(64 * torch.randn(*shape, generator=gen,
                                            device=device)) / 64

    thr = dyadic(trees, nl, smax)
    mgl = thr - dyadic(trees, nl, smax).abs()
    mgh = thr + dyadic(trees, nl, smax).abs()
    projq = dyadic(trees, nl, b)
    projq[..., ::16] = 0.0
    return plan, tv.node_table(plan, thr, mgl, mgh), projq


def check_descent(device, reps):
    """Kernels 7 and 8 against their plain versions at the descents of
    ``DESCENTS`` (each on its kernel-7 route): leaves and priorities
    bit-equal, probes equal with the
    bucket stop off (as served) and on; both times, device times, bounds,
    and for kernel 8 the one PyTorch call that orders the same entries
    (a stable ``torch.sort`` over ``[B, T * F]``); each wrapper's host time
    a call (``host_us``: the call returns before the card ends), and each
    kernel's route.  The first shape is the record's; every shape's
    numbers are under ``by_shape``."""
    import torch

    from rptree_tpu_torch.ops import traverse as tv

    rec7, rec8 = {"by_shape": {}}, {"by_shape": {}}
    for i, (name, n, min_leaf, trees, b, budget, probes) in enumerate(
            DESCENTS):
        plan, table, projq = descent_inputs(n, min_leaf, trees, b, device,
                                            seed=11 + i)
        args = (plan, table, projq, budget)
        leaf, pri = tv.traverse_kernel(*args)
        want_l, want_p = tv.traverse_tree_reference(*args)
        torch.cuda.synchronize()
        if not (torch.equal(leaf, want_l) and torch.equal(
                pri.view(torch.int32), want_p.view(torch.int32))):
            raise AssertionError(f"traverse_kernel {name}: differs from the "
                                 "plain version")
        t, nlev, f = trees, plan.n_levels, budget
        s7 = {"max_abs_err": 0.0, "route": tv.traverse_route(f)[0],
              "ms": cuda_ms(lambda: tv.traverse_kernel(*args), reps),
              "device_ms": graph_ms(lambda: tv.traverse_kernel(*args)),
              "host_us": host_us(lambda: tv.traverse_kernel(*args)),
              "plain_ms": cuda_ms(lambda: tv.traverse_tree_reference(*args),
                                  reps),
              "library_ms": None,
              # projections and node table read once, leaves and
              # priorities written once; ~8 f32 operations a slot and level
              **bound(projq.numel() * 4 + table.rec.numel() * 4
                      + t * b * f * 8, 8 * t * b * f * nlev, "f32"),
              "shape": {"T": t, "L": nlev, "B": b, "F": f,
                        "nodes": table.rec.shape[1]}}
        rec7["by_shape"][name] = s7
        if probes is None:
            continue
        lens = torch.as_tensor(np.tile(plan.leaf_len, t), device=device)
        for stop in (False, True):
            pargs = (leaf, pri, plan.n_leaves, probes, lens, K, stop)
            got, want = tv.select_probes(*pargs), \
                tv.select_probes_reference(*pargs)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(got, want)):
                raise AssertionError(f"select_probes {name} bucket_stop="
                                     f"{stop}: differs from the plain version")
        pargs = (leaf, pri, plan.n_leaves, probes, lens, K, False)
        keys = pri.transpose(0, 1).reshape(b, t * f)
        p = min(probes, t * f)
        rec8["by_shape"][name] = {
            "max_abs_err": 0.0, "route": tv.probe_route(t, f)[0],
            "ms": cuda_ms(lambda: tv.select_probes(*pargs), reps),
            "device_ms": graph_ms(lambda: tv.select_probes(*pargs)),
            "host_us": host_us(lambda: tv.select_probes(*pargs)),
            "plain_ms": cuda_ms(lambda: tv.select_probes_reference(*pargs),
                                reps),
            "library_ms": cuda_ms(lambda: torch.sort(keys, dim=1,
                                                     stable=True), reps),
            "library_call": "torch.sort(stable=True) over [B, T * F]",
            # leaves and priorities read once, the probes written once;
            # at least one comparison per entry and other tree
            **bound(t * b * f * 8 + b * p * 8, b * t * f * t, "f32"),
            "shape": {"T": t, "B": b, "F": f, "P": p}}
        del leaf, pri, want_l, want_p, table, projq
    torch.cuda.empty_cache()
    for rec in (rec7, rec8):
        first = next(iter(rec["by_shape"].values()))
        rec.update({key: v for key, v in first.items() if key != "shape"})
    return {"traverse": rec7, "select_probes": rec8}


# (name, blocks G, trees, queries, probes, tile_m, hot block, masked
# share, capacity as a share of the tiles needed (None: as served, the
# need plus 1/8)): kernel 9's cases; the first is the record's
TABLES = (("clustered_chunk", 65_536, 8, 65_536, 8, 8, False, 0.0, None),
          ("iid_chunk", 16_384, 8, 32_768, 10, 8, False, 0.0, None),
          ("hot_block", 16_384, 8, 32_768, 10, 8, True, 0.0, None),
          ("all_masked", 65_536, 8, 4_096, 8, 8, False, 1.0, None),
          ("overflow", 65_536, 8, 65_536, 8, 8, False, 0.1, 0.5),
          ("tile_m_1", 16_384, 8, 8_192, 10, 1, False, 0.1, None),
          ("tile_m_16", 16_384, 8, 8_192, 10, 16, False, 0.1, None),
          ("g_past_65536", 131_072, 8, 16_384, 8, 8, True, 0.1, None))


def table_pairs(g, trees, b, p, hot, masked, device, seed):
    """``(gsel, lsel, lens)`` as the probe selection makes them: probe j
    of a query in tree ``j % trees`` at a random leaf of ``g / trees``; a
    ``masked`` share of the pairs masked (block 0, leaf -1); with ``hot``
    every query probes block 5 first; occupancies 1-128."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    nl = g // trees
    leaf = torch.randint(0, nl, (b, p), generator=gen, device=device)
    tree = torch.arange(p, device=device) % trees
    gsel = (tree * nl + leaf).to(torch.int32)
    if hot:
        gsel[:, 0] = 5
    off = torch.rand(b, p, generator=gen, device=device) < masked
    lsel = torch.where(off, -1, gsel % nl).to(torch.int32)
    gsel = torch.where(off, 0, gsel).to(torch.int32)
    lens = torch.randint(1, 129, (g,), generator=gen, device=device,
                         dtype=torch.int32)
    return gsel, lsel, lens


def tables_record(name, gsel, lsel, lens, tile_m, nt, reps):
    """Kernel 9 against its twin on these pairs: ``tb``, ``tp``,
    ``needed``, ``slot`` and ``lens_t`` equal (``torch.equal``), then both
    times, the device time, the bound (the pairs read once, the tables
    written once) and the library call that is the plain form's first
    step, a stable ``torch.sort`` of the ``B * P`` flat keys."""
    import torch

    from rptree_tpu_torch.ops import grouped as og

    args = (gsel, lsel, lens, tile_m, nt)
    got, want = og.tile_tables(*args), og.tile_tables_reference(*args)
    torch.cuda.synchronize()
    for key, a, w in zip(("tb", "tp", "needed", "slot", "lens_t"), got, want):
        if a.dtype != w.dtype or not torch.equal(a, w):
            raise AssertionError(f"tile_tables {name}: {key} differs from "
                                 "the plain version")
    e, g = gsel.numel(), lens.shape[0]
    keys = torch.where(lsel >= 0, gsel.long(), og._BIG).reshape(e)
    return {"max_abs_err": 0.0, "bit_equal": True,
            "ms": cuda_ms(lambda: og.tile_tables(*args), reps),
            "device_ms": graph_ms(lambda: og.tile_tables(*args)),
            "plain_ms": cuda_ms(lambda: og.tile_tables_reference(*args), reps),
            "library_ms": cuda_ms(lambda: torch.sort(keys, stable=True), reps),
            "library_call": "torch.sort(stable=True) of the B * P flat keys",
            **bound(8 * e + 4 * g + 4 * nt * (tile_m + 2) + 4 + 8 * e, e,
                    "int8"),
            "shape": {"pairs": e, "G": g, "tile_m": tile_m, "nt": nt,
                      "needed": int(want[2])},
            "grids": tables_grids(lambda: og.tile_tables(*args))}


def check_tables(device, reps):
    """Kernel 9 against its twin on the pairs of ``TABLES``."""
    import torch

    from rptree_tpu_torch.ops import grouped as og

    rec = {"by_shape": {}}
    for i, (name, g, trees, b, p, tile_m, hot, masked, share) in enumerate(
            TABLES):
        gsel, lsel, lens = table_pairs(g, trees, b, p, hot, masked, device,
                                       seed=21 + i)
        need = int(og.tile_tables_reference(gsel, lsel, lens, tile_m, 1)[2])
        nt = max(1, need + need // 8 if share is None else int(need * share))
        rec["by_shape"][name] = tables_record(name, gsel, lsel, lens, tile_m,
                                              nt, reps)
        del gsel, lsel, lens
    torch.cuda.empty_cache()
    first = next(iter(rec["by_shape"].values()))
    rec.update({key: v for key, v in first.items() if key != "shape"})
    return {"tile_tables": rec}


def check_tables_chunk(f, qc, serve, kern, name):
    """Kernel 9 against its twin on the pairs that the grouped path makes
    for the chunk ``qc`` at the capacity it learned, timed as
    :func:`tables_record` does; the record joins kernel 9's ``by_shape``
    as ``name``.  Launches here are not counted."""
    from rptree_tpu_torch.models import forest as fm

    lens = f._lens_global()
    gsel, lsel = fm._probe_pairs(f, qc, serve["budget"], serve["probes"], K)
    cap = max(f._grouped_nt.values())  # per chunk of serve["chunk"]
    rec = tables_record(name, gsel, lsel, lens, serve["tile_m"], cap, 5)
    kern["tile_tables"]["by_shape"][name] = rec
    return rec


def gather_inputs(g, lmax, d, b, p, bf16, device, seed):
    """Blocks, norms, queries and block rows for the block gather, made on
    the card from a seed; every fourth query probes one block twice."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(g, lmax, d, generator=gen, device=device)
    sq = (x * x).sum(-1)
    if bf16:
        x = x.bfloat16()
    q = torch.randn(b, d, generator=gen, device=device)
    sel = torch.randint(0, g, (b, p), generator=gen, device=device,
                        dtype=torch.int32)
    sel[::4, 1] = sel[::4, 0]
    return x, sq, q, sel


def check_gather(device, reps):
    """Kernel 6 against its plain version at the per-pair path's chunks:
    the clustered cell's (2,048 queries x 8 probes over 8,192 blocks of
    128 x 128, f32 and bf16) and the iid bracket's (32 queries x 32
    probes over 1,024 bf16 blocks of 3,128 x 128)."""
    import torch

    from rptree_tpu_torch.ops import fused_gather as fg

    out = {}
    cases = (("gather_score", False, (8192, 128, 128, 2048, 8)),
             ("gather_score_bf16", True, (8192, 128, 128, 2048, 8)),
             ("gather_score_bf16_bracket", True, (1024, 3128, 128, 32, 32)))
    for name, bf16, (g, lmax, d, b, p) in cases:
        x, sq, q, sel = gather_inputs(g, lmax, d, b, p, bf16, device, seed=g + p)
        got, gsq = fg.gather_score(x, sq, q, sel)
        want, wsq = fg.gather_score_reference(x, sq, q, sel)
        torch.cuda.synchronize()
        abs_err, rel_err = _rel_err(got, want)
        if rel_err > DIST_RTOL or not torch.equal(gsq, wsq):
            raise AssertionError(f"{name}: relative error {rel_err}, norms "
                                 f"equal {torch.equal(gsq, wsq)}")
        blocks = int(torch.unique(sel).numel())
        nbytes = (blocks * lmax * (d * x.element_size() + 4) + q.numel() * 4
                  + sel.numel() * 4 + 2 * b * p * lmax * 4)
        out[name] = {
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": cuda_ms(lambda: fg.gather_score(x, sq, q, sel), reps),
            "plain_ms": cuda_ms(
                lambda: fg.gather_score_reference(x, sq, q, sel), reps),
            "library_ms": None,
            **bound(nbytes, 2 * b * p * lmax * d, "bf16" if bf16 else "f32"),
            "shape": {"blocks": g, "lmax": lmax, "D": d, "B": b, "P": p,
                      "distinct_blocks": blocks},
        }
        del x, sq, q, sel, got, gsq, want, wsq
    torch.cuda.empty_cache()
    out["gather_score_shared"] = check_gather_shared(device, reps)
    return out


def shared_inputs(n, g, lmax, d, b, p, device, seed):
    """Shared rows ``f32[n, d]``, id tables ``[g, lmax]`` over them (each
    block a random occupancy, -1 past it; one block empty), their slot
    norms, queries and block rows with one hot block, made on the card."""
    import torch

    from rptree_tpu_torch.ops.shared import SharedRows

    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randn(n, d, generator=gen, device=device)
    ids = torch.randint(0, n, (g, lmax), generator=gen, device=device,
                        dtype=torch.int32)
    occ = torch.randint(lmax // 2, lmax + 1, (g, 1), generator=gen,
                        device=device)
    occ[0] = 0
    ids = torch.where(torch.arange(lmax, device=device) < occ, ids, -1)
    sq = torch.where(ids >= 0, (rows * rows).sum(-1)[ids.clamp_min(0).long()],
                     0.0)
    q = torch.randn(b, d, generator=gen, device=device)
    sel = torch.randint(0, g, (b, p), generator=gen, device=device,
                        dtype=torch.int32)
    sel[::4, 0] = g // 2
    return SharedRows(rows, ids.to(torch.int32).contiguous()), sq, q, sel


def gather_shared_bound(xs, sel, b, p):
    """:func:`bound` of kernel 6's shared-row mode on these pairs: each
    distinct row that a filled slot of a selected block names, read once
    (empty slots read no row), the selected blocks' ids and slot norms,
    the queries and block rows, and the two outputs.  Also what it reads:
    the named filled slots, the distinct rows, the rows each route reads
    (the query route each query's distinct rows, the block route each
    item's block's filled slots) and the bytes each moves."""
    import torch

    from rptree_tpu_torch.ops import fused_gather as fg

    g, lmax, d = xs.shape
    sel_c = sel.long().clamp(0, g - 1)
    blocks = torch.unique(sel_c)
    ids = xs.ids[blocks]
    rows = int(torch.unique(ids[ids >= 0]).numel())
    elem = xs.rows.element_size()
    nbytes = (rows * d * elem + blocks.numel() * lmax * (4 + 4)
              + b * d * 4 + sel.numel() * 4 + 2 * b * p * lmax * 4)
    rec = bound(nbytes, 2 * b * p * lmax * d,
                "bf16" if xs.dtype == torch.bfloat16 else "f32")
    named = xs.ids[sel_c].reshape(b, -1)
    n = xs.rows.shape[0]
    named = torch.where(named >= 0, named.clamp_max(n - 1), -1)
    srt = torch.sort(named, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    per_query = int((first & (srt >= 0)).sum())
    filled = (xs.ids >= 0).sum(1)
    pairs = torch.bincount(sel_c.reshape(-1), minlength=g)
    items = (pairs + fg.MAX_PAIRS - 1) // fg.MAX_PAIRS
    per_item = int((items * filled).sum())
    slots = b * p * lmax
    rec.update({
        "distinct_rows": rows, "named_filled_slots": int((named >= 0).sum()),
        "query_route_rows": per_query, "block_route_rows": per_item,
        "shared_route": fg.shared_route(p, lmax, d, elem)[0],
        "moved_bytes": {
            "query": per_query * d * elem + slots * 16 + b * d * 4
            + sel.numel() * 4,
            "block": per_item * d * elem + int(items.sum()) * lmax * 8
            + slots * 8 + 2 * slots * 4 + sel.numel() * 4 * 3}})
    return rec


def shared_routes_same(xs, sq, q, sel, dots, sqx):
    """Whether kernel 6's shared-row mode gives ``(dots, sqx)`` bit for bit
    by both its routes (the query route and the block route's items)."""
    import torch

    from rptree_tpu_torch.ops import fused_gather as fg

    ok = True
    for route in ("query", "block"):
        d, s = fg._gather_score(xs, sq, q, sel, route=route)
        ok &= torch.equal(d.view(torch.int32), dots.view(torch.int32))
        ok &= torch.equal(s, sqx)
    return bool(ok)


def check_gather_shared(device, reps, n=1_000_000, g=65_536, lmax=128,
                        d=128, b=2048, p=8):
    """Kernel 6's shared-row mode against its plain version (``fetch_
    blocks`` and the einsum) at a per-pair chunk over 1M shared rows:
    dots within 1e-4 relative, norms bit-equal; and against the blocked
    route on the blocks those rows make (zeros in empty slots): every
    dot bit-equal (``blocked_same_bits``)."""
    import torch

    from rptree_tpu_torch.ops import fused_gather as fg

    xs, sq, q, sel = shared_inputs(n, g, lmax, d, b, p, device, seed=17)
    got, gsq = fg.gather_score(xs, sq, q, sel)
    want, wsq = fg.gather_score_reference(xs, sq, q, sel)
    torch.cuda.synchronize()
    abs_err, rel_err = _rel_err(got, want)
    if rel_err > DIST_RTOL or not torch.equal(gsq, wsq):
        raise AssertionError(f"gather_score_shared: relative error {rel_err}, "
                             f"norms equal {torch.equal(gsq, wsq)}")
    blocks = torch.where((xs.ids >= 0)[..., None],
                         xs.rows[xs.ids.long().clamp_min(0)], 0.0)
    blocked = fg.gather_score(blocks, sq, q, sel)[0]
    same = torch.equal(got.view(torch.int32), blocked.view(torch.int32))
    routes = shared_routes_same(xs, sq, q, sel, got, gsq)
    if not same or not routes:
        raise AssertionError("gather_score_shared: dots differ from the "
                             "blocked route's over the same rows, or the "
                             "shared mode's routes from each other")
    rec = {"max_abs_err": abs_err, "max_rel_err": rel_err,
           "blocked_same_bits": same, "routes_same_bits": routes,
           "ms": cuda_ms(lambda: fg.gather_score(xs, sq, q, sel), reps),
           "device_ms": graph_ms(lambda: fg.gather_score(xs, sq, q, sel)),
           "block_route_ms": cuda_ms(
               lambda: fg._gather_score(xs, sq, q, sel, route="block"), reps),
           "blocked_ms": cuda_ms(lambda: fg.gather_score(blocks, sq, q, sel),
                                 reps),
           "plain_ms": cuda_ms(
               lambda: fg.gather_score_reference(xs, sq, q, sel), reps),
           "library_ms": None, **gather_shared_bound(xs, sel, b, p),
           "shape": {"rows": n, "blocks": g, "lmax": lmax, "D": d, "B": b,
                     "P": p}}
    del xs, sq, q, sel, got, gsq, want, wsq, blocks, blocked
    torch.cuda.empty_cache()
    return rec


def check_gather_chunk(f, qc, serve):
    """Kernel 6 (blocked or shared-row mode, by ``f``'s layout) against
    its plain version on the pairs the per-pair path makes for the chunk
    ``qc``: dots within ``DIST_RTOL``, norms bit-equal, both timed.
    Launches here are not counted."""
    import torch

    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import fused_gather as fg
    from rptree_tpu_torch.ops.shared import SharedRows

    x_leaf, sq_leaf, _ = f._packed
    sel, _ = fm._probe_pairs(f, qc, serve["budget"], serve["probes"], K)
    (gd, gs), (wd, ws) = (fg.gather_score(x_leaf, sq_leaf, qc, sel),
                          fg.gather_score_reference(x_leaf, sq_leaf, qc, sel))
    torch.cuda.synchronize()
    abs_err, rel = _rel_err(gd, wd)
    if rel > DIST_RTOL or not torch.equal(gs, ws):
        raise AssertionError(f"gather_score on the chunk: {rel}")
    b, p = sel.shape
    rec = {"queries": b, "pairs_per_query": p, "lmax": int(x_leaf.shape[1]),
           "max_abs_err": abs_err, "max_rel_err": rel,
           "ms": cuda_ms(lambda: fg.gather_score(x_leaf, sq_leaf, qc, sel)),
           "plain_ms": cuda_ms(
               lambda: fg.gather_score_reference(x_leaf, sq_leaf, qc, sel),
               reps=2)}
    if isinstance(x_leaf, SharedRows):
        rec.update(gather_shared_bound(x_leaf, sel, b, p))
        rec["routes_same_bits"] = shared_routes_same(x_leaf, sq_leaf, qc, sel,
                                                     gd, gs)
        if not rec["routes_same_bits"]:
            raise AssertionError("gather_score_shared on the chunk: the "
                                 "routes differ")
        rec["block_route_ms"] = cuda_ms(lambda: fg._gather_score(
            x_leaf, sq_leaf, qc, sel, route="block"))
        rec["device_ms"] = graph_ms(
            lambda: fg.gather_score(x_leaf, sq_leaf, qc, sel))
    del gd, gs, wd, ws
    return rec


def check_scan(device, reps, n=100_000, b=4096, d=128):
    """Kernel 5 against its plain version on 100,000 iid rows and 4,096
    queries, k 10, for l2, sql2 and dot: partial distances within 1e-4
    relative, ids equal outside near-ties.  Its time is on the call's bf16
    copy of the rows (``scan_rows``), which is timed apart.  (The main path's own shapes,
    1M x 2,048, 100k x 2,048 and 1M x 1,024 with l2, are held against the
    plain version by :func:`scan_phase`.)"""
    import torch

    from rptree_tpu_torch.ops import scan as sc
    from rptree_tpu_torch.ops.grouped_kernel import untied

    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(n, d, generator=gen, device=device)
    q = x[torch.randint(0, n, (b,), generator=gen, device=device)]
    q += 0.1 * torch.randn(b, d, generator=gen, device=device)
    sq = (x * x).sum(-1)
    abs_err = rel_err = 0.0
    untied_ids = 0
    for metric in sc.SCAN_METRICS:
        kd, ki = sc._scan_partial(x, sq, q, K, metric)
        pd, pi = sc._partial_reference(x, sq, q, K, metric)
        torch.cuda.synchronize()
        a, r = _rel_err(kd, pd)
        chk = untied(pd, DIST_RTOL)
        if r > DIST_RTOL or not torch.equal(ki[chk], pi[chk]):
            raise AssertionError(f"scan_topk {metric}: relative error {r}, "
                                 f"ids equal {torch.equal(ki[chk], pi[chk])}")
        abs_err, rel_err = max(abs_err, a), max(rel_err, r)
        untied_ids += int(chk.sum())
    rows = sc.scan_rows(x, sq)
    xb, qb = rows.x[:n, :d], q.bfloat16()
    rec = {
        "max_abs_err": abs_err, "max_rel_err": rel_err,
        "ids_equal_untied": untied_ids,
        # the kernel on the call's bf16 copy of the rows, made once per
        # call and timed apart (cast_ms)
        "ms": cuda_ms(lambda: sc.scan_topk(x, sq, q, K, "l2", rows), reps),
        "cast_ms": cuda_ms(lambda: sc.scan_rows(x, sq), reps),
        "plain_ms": cuda_ms(lambda: sc.scan_topk_reference(x, sq, q, K, "l2"),
                            reps),
        "library_ms": None,
        # a yardstick for the products alone: no one call computes the scan
        "gemm_ms": cuda_ms(lambda: torch.matmul(qb, xb.T), reps),
        **bound(n * d * 4 + n * 4 + b * d * 4 + b * K * 8, 2 * b * n * d,
                "bf16"),
        "shape": {"N": n, "B": b, "D": d, "k": K},
    }
    del x, q, sq, rows, xb, qb
    torch.cuda.empty_cache()
    return {"scan_topk": rec}


# the bag-of-words cell (examples/bow_sparse.py:39-73): documents of
# SPARSE_NNZ terms from one of SPARSE_TOPICS bands of a SPARSE_V vocabulary
SPARSE_N, SPARSE_V, SPARSE_NNZ, SPARSE_TOPICS = 262_144, 65_536, 32, 256
SPARSE_PAIR = dict(budget=2, precision="default", chunk=512)
SPARSE_GROUPED = dict(budget=2, tile_m=8, chunk=4096, selection="kernel")
SPARSE_PROBES = 16         # T 8 x budget 2
WIDE_V = 2 * SPARSE_V      # past kernel 10's room for a quad of rows' support


def sparse_rows(n, seed, v=SPARSE_V, nnz=SPARSE_NNZ, topics=SPARSE_TOPICS):
    """``examples/bow_sparse.py``'s documents, drawn with numpy: ``nnz``
    columns of one topic's band (offsets below ``v // 64``, sorted,
    duplicates kept: they add), values ``|N(0, 1)| + 0.1``.  Returns
    ``(cols int32[n, nnz], vals f32[n, nnz])``."""
    rng = np.random.default_rng(seed)
    topic = rng.integers(0, topics, size=(n, 1))
    off = rng.integers(0, v // 64, size=(n, nnz))
    cols = np.sort(np.clip(topic * (v // topics) + off, 0, v - 1), axis=1)
    vals = np.abs(rng.standard_normal((n, nnz), dtype=np.float32)) + 0.1
    return cols.astype(np.int32), vals.astype(np.float32)


def ell_bound(blocks, tb, tp, lens, q, p):
    """:func:`bound` of kernel 10 on these tiles: each probed block's
    occupied slots once (cols, values, norms), each distinct (query,
    column) value the tiles' rows read, the queries' norms, the tables
    and the output; two operations per (row, slot, K) product."""
    import torch

    g, lmax, kz = blocks.shape
    nt, m = tp.shape
    b, v = q.shape
    occ = lens.long().clamp(0, lmax)
    nslots = int(torch.zeros(g, dtype=torch.int64, device=tb.device)
                 .scatter_reduce(0, tb.long(), occ, "amax").sum())
    mark = torch.zeros(b * v, dtype=torch.bool, device=q.device)
    col = torch.arange(lmax, device=q.device)
    for s in range(0, nt, 512):
        c = min(512, nt - s)
        rows = tp[s:s + c]
        cols = blocks.cols[tb[s:s + c].long()].long()          # [c, lmax, K]
        keys = (rows.long() // p)[:, :, None, None] * v + cols[:, None]
        ok = ((rows >= 0)[:, :, None, None]
              & (col < occ[s:s + c, None])[:, None, :, None])
        mark[keys[ok.expand_as(keys)]] = True
    live = tp[tp >= 0]
    n_queries = int(torch.unique(live.long() // p).numel())
    nbytes = (nslots * (kz * (4 + blocks.vals.element_size()) + 4)
              + int(mark.sum()) * 4 + n_queries * 4 + nt * (8 + 4 * m)
              + nt * m * lmax * 4)
    ops = 2 * kz * int(((tp >= 0).sum(1) * occ).sum())
    return bound(nbytes, ops, "f32")


def ell_tiles_inputs(device, b, p, tile_m, seed, g=16_384, lmax=128,
                     bf16=False, banded=False, v=None):
    """ELL blocks at the cell's shapes (``g`` blocks of ``lmax`` slots of
    ``SPARSE_NNZ``, occupancy from half to all of ``lmax``, padding past
    it), ``b`` dense query rows of the cell's kind and their norms, and the
    tile tables of ``b * p`` pairs (kernel 9; a fifth masked, queries of a
    topic probing that topic's blocks) at a capacity of 90% of the tiles
    needed.  A block's documents are of any topic, or with ``banded`` of
    the block's one topic (a window of 1,024 columns); ``v`` columns (the
    cell's 65,536 by default).  Returns ``(blocks, sq, tb, tp, lens_t, q,
    qq, needed, capacity)``."""
    import torch

    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops.sparse import EllBlocks, EllMatrix, ell_to_dense

    v = v or SPARSE_V
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cols, vals = sparse_rows(g * lmax, seed, v=v)
    if banded:
        band = v // SPARSE_TOPICS
        topic = np.arange(g * lmax)[:, None] // lmax % SPARSE_TOPICS
        cols = np.sort(np.minimum(topic * band + cols % (v // 64), v - 1),
                       axis=1).astype(np.int32)
    cols = torch.as_tensor(cols).reshape(g, lmax, SPARSE_NNZ)
    vals = torch.as_tensor(vals).reshape(g, lmax, SPARSE_NNZ)
    lens = torch.randint(lmax // 2, lmax + 1, (g,), generator=gen,
                         dtype=torch.int32)
    empty = torch.arange(lmax)[None, :] >= lens[:, None]
    cols[empty], vals[empty] = 0, 0.0
    sq = (vals * vals).sum(-1)
    qc, qv = sparse_rows(b, seed + 1, v=v)
    q = ell_to_dense(EllMatrix(v, qc, qv).to(device), torch.float32)
    # a query probes blocks whose rows share its band
    band = torch.as_tensor(qc[:, :1] // (v // SPARSE_TOPICS))
    blk_band = cols[:, 0, 0] // (v // SPARSE_TOPICS)
    order = torch.argsort(blk_band)
    start = torch.searchsorted(blk_band[order], band)
    pick = (start + torch.randint(0, 64, (b, p), generator=gen)) % g
    gsel = order[pick].to(torch.int32)
    lsel = torch.where(torch.rand(b, p, generator=gen) < 0.2, -1, gsel)
    gsel = torch.where(lsel < 0, 0, gsel).to(torch.int32)
    to = dict(device=device)
    gsel, lsel, lens_d = gsel.to(**to), lsel.to(**to), lens.to(**to)
    _, _, needed, _, _ = og.tile_tables(gsel, lsel, lens_d, tile_m, b * p)
    cap = max(1, int(needed) * 9 // 10)
    tb, tp, _, _, lens_t = og.tile_tables(gsel, lsel, lens_d, tile_m, cap)
    if bf16:
        vals = vals.bfloat16()
    blocks = EllBlocks(v, cols.to(**to), vals.to(**to))
    return (blocks, sq.to(**to), tb, tp, lens_t, q, (q * q).sum(-1),
            int(needed), cap)


def ell_agree(name, got, want, sq, qq, tb, tp, p, metric, by_norms=False):
    """Kernel 10 against its plain version: infinite at the same places;
    ``sql2`` within ``SUM_RTOL`` of ``|x|^2 + |q|^2``, the other metrics
    within ``DIST_RTOL``.  With ``by_norms`` (queries that meet documents of
    their own band, as the cell's own chunk does: near a query's like an
    l2 distance is the square root of fp32 cancellation alone) l2 is held
    as sql2 is, by its square.  Returns the error."""
    import torch

    abs_err, rel_err = _rel_err(got, want)
    if metric != "sql2" and not (by_norms and metric == "l2"):
        if rel_err > DIST_RTOL:
            raise AssertionError(f"{name} ({metric}): relative error "
                                 f"{rel_err} > {DIST_RTOL}")
        return abs_err, rel_err
    if metric == "l2":
        got, want = got * got, want * want
    qn = torch.where(tp >= 0, qq[(tp.long() // p).clamp_min(0)], 0.0)
    scale = sq[tb.long()][:, None, :] + qn[..., None]
    fin = torch.isfinite(want.reshape(scale.shape))
    err = float(((got - want).abs().reshape(scale.shape)[fin]
                 / scale[fin]).max()) if bool(fin.any()) else 0.0
    if err > SUM_RTOL:
        raise AssertionError(f"{name}: squared distances off by {err} of "
                             f"|x|^2 + |q|^2 > {SUM_RTOL}")
    return abs_err, err


def ell_route_share(args, tb):
    """The share of tiles on each of kernel 10's routes (``ELL_ROUTES``),
    counted by the kernel on ``ell_score_tiles`` arguments ``args``;
    raises unless the counts are ``ell_tile_routes``' rule's."""
    import torch

    from rptree_tpu_torch.ops import ell_kernel as ek

    _, routes = ek.ell_score_tiles_routes(*args)
    rule = torch.bincount(ek.ell_tile_routes(args[0], args[3], args[4]),
                          minlength=len(ek.ELL_ROUTES))
    if routes.tolist() != rule.tolist():
        raise AssertionError(f"kernel 10's routes {routes.tolist()} are not "
                             f"the rule's {rule.tolist()}")
    return {k: int(v) / tb.shape[0] for k, v in zip(ek.ELL_ROUTES,
                                                     routes.tolist())}


def check_ell(device, reps):
    """Kernel 10 against its plain version at the sparse cell's shapes (K
    32, lmax 128, V 65,536): a grouped chunk (4,096 queries x 16 probes,
    tile_m 8) and a per-pair chunk (512 x 16, tiles of one), f32 and bf16
    values, every metric, with masked pairs and a capacity below the tiles
    needed; both times, the device time, the bound and the share of tiles
    on each route on those tiles (the support route at V 65,536).  Then
    the grouped chunk on banded blocks (one topic a block, ``_banded``),
    held the same way but l2 by its square (its queries meet documents of
    their own band: near a query's like an l2 distance is fp32
    cancellation), and a grouped chunk of 1,024 queries over a vocabulary
    of 131,072 (``_l2``: past the support's room, so the queries are read
    through L2)."""
    import torch

    from rptree_tpu_torch.ops import ell_kernel as ek

    rec = {"shape": {"K": SPARSE_NNZ, "lmax": 128, "V": SPARSE_V,
                     "grouped": [4096, SPARSE_PROBES, 8],
                     "per_pair": [512, SPARSE_PROBES, 1]}}
    worst = 0.0
    for label, b, tile_m, banded, v in (("", 4096, 8, False, SPARSE_V),
                                        ("_pairs", 512, 1, False, SPARSE_V),
                                        ("_banded", 4096, 8, True, SPARSE_V),
                                        ("_l2", 1024, 8, False, WIDE_V)):
        for bf16 in (False, True):
            if label in ("_banded", "_l2") and bf16:
                continue
            sfx = label + ("_bf16" if bf16 else "")
            (blocks, sq, tb, tp, lens, q, qq, needed,
             cap) = ell_tiles_inputs(device, b, SPARSE_PROBES, tile_m, 7,
                                     bf16=bf16, banded=banded, v=v)
            p = SPARSE_PROBES
            for metric in ("l2", "sql2", "cosine", "dot"):
                args = (blocks, sq, tb, tp, lens, q, qq, p, metric)
                got = ek.ell_score_tiles(*args)
                want = ek.ell_score_tiles_reference(*args)
                torch.cuda.synchronize()
                a, r = ell_agree(f"ell_score_tiles{sfx}", got, want, sq, qq,
                                 tb, tp, p, metric, by_norms=banded)
                worst = max(worst, a)
                rec[f"max_err_{metric}{sfx}"] = r
                del got, want
            args = (blocks, sq, tb, tp, lens, q, qq, p, "l2")
            rec[f"route_share{sfx}"] = ell_route_share(args, tb)
            want = "l2" if label == "_l2" else "support"
            if rec[f"route_share{sfx}"][want] < 0.5:
                raise AssertionError(f"kernel 10{sfx}: most tiles not on the "
                                     f"{want} route {rec[f'route_share{sfx}']}")
            rec[f"ms{sfx}"] = cuda_ms(lambda: ek.ell_score_tiles(*args), reps)
            rec[f"device_ms{sfx}"] = graph_ms(
                lambda: ek.ell_score_tiles(*args), reps=5)
            rec[f"plain_ms{sfx}"] = cuda_ms(
                lambda: ek.ell_score_tiles_reference(*args), 2)
            rec[f"tiles{sfx}"] = {"needed": needed, "capacity": cap}
            b_rec = ell_bound(blocks, tb, tp, lens, q, p)
            rec.update({f"{k}{sfx}": v for k, v in b_rec.items()})
            del blocks, q
            torch.cuda.empty_cache()
    rec["max_abs_err"] = worst
    rec["library_ms"] = None
    return {"ell_score_tiles": rec}


# kernel 11 at the main path's projections: (label, rows, D, L, rows are
# the sparse cell's documents made dense)
PROJECTIONS = (("", 65_536, 128, 104, False),        # clustered query chunk
               ("_iid", 32_768, 128, 80, False),     # iid query chunk
               ("_pairs", 2048, 128, 104, False),    # a per-pair chunk
               ("_bracket", 32, 128, 160, False),    # the bracket, T 32
               ("_build", 1_000_000, 128, 13, False),  # a tree of the 1M build
               ("_sparse", 4096, SPARSE_V, 88, False),   # sparse query chunk
               ("_sparse_rows", 4096, SPARSE_V, 88, True))


def project_within_bound(name, x, r, got, rows=1 << 20):
    """Kernel 11's ``got = r @ x.T`` against the exact product (float64),
    ``rows`` rows of ``x`` a step: past the error bound of its own order
    of summation nowhere.  Returns ``(the largest error, its largest share
    of the bound)``."""
    from rptree_tpu_torch.ops import build as ob

    d, worst, share = x.shape[1], 0.0, 0.0
    r64 = r.double()
    for s in range(0, x.shape[0], rows):
        x64 = x[s:s + rows].double()
        exact = r64 @ x64.T
        # the float64 product's own error, d * 2**-53 of the terms, added
        tol = ((ob.project_rows_error_bound(d) + d * 2.0 ** -53)
               * (r64.abs() @ x64.abs().T))
        err = (got[:, s:s + rows].double() - exact).abs()
        if bool((err > tol).any()):
            raise AssertionError(f"{name}: past the bound of its order of "
                                 "summation")
        worst = max(worst, float(err.max()))
        share = max(share, float((err / tol).nan_to_num(0.0).max()))
    return worst, share


def check_project(device, reps):
    """Kernel 11 at the main path's projections (``PROJECTIONS``): the
    clustered, iid and per-pair query chunks, the bracket's 32 queries at
    T 32, the 1M build's tree (13 levels), the sparse cell's query chunk
    (4,096 x 65,536, T 8 x 11 levels) with random rows and with the cell's
    own sparse rows.  At each: held against the exact product (float64)
    within the error bound of its own order of summation,
    ``project_rows_error_bound(D) * sum |x_d r_d|`` (2.7 at 65,536
    columns, where a segment of 1,024 columns dropped or doubled moves an
    entry by ~32); the same bits for a row in another batch;
    ``max_abs_err`` its distance from the plain version, ``torch.matmul``,
    which is also the library call.  Every shape's numbers are under
    ``by_shape``; the clustered chunk's are the record's."""
    import torch

    from rptree_tpu_torch.ops import build as ob
    from rptree_tpu_torch.ops.sparse import EllMatrix, ell_to_dense

    rec, worst = {"by_shape": {}}, 0.0
    gen = torch.Generator(device=device).manual_seed(3)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for label, n, d, nl, docs in PROJECTIONS:
        if docs:
            cols, vals = sparse_rows(n, SEED + 5, v=d)
            x = ell_to_dense(EllMatrix(d, cols, vals).to(device),
                             torch.float32)
        else:
            x = torch.randn(n, d, device=device, generator=gen)
        r = torch.randn(nl, d, device=device, generator=gen)
        got = ob.project_rows(x, r)
        want = ob.project_rows_reference(x, r)
        err_f64, share = project_within_bound(f"project_rows{label}", x, r,
                                              got)
        part = ob.project_rows(x[n // 3:n // 2 + 1].contiguous(), r)
        if not torch.equal(part.view(torch.int32),
                           got[:, n // 3:n // 2 + 1].view(torch.int32)):
            raise AssertionError(f"project_rows{label}: a row's bits depend "
                                 "on its batch")
        diff = float((got - want).abs().max())
        worst = max(worst, diff)
        plain = cuda_ms(lambda: ob.project_rows_reference(x, r), reps)
        one = {"rows": n, "D": d, "projections": nl,
               "tile": ob.project_plan(n, nl, d, sms),
               "max_abs_err": diff, "max_abs_err_vs_f64": err_f64,
               "max_share_of_bound": share,
               "ms": cuda_ms(lambda: ob.project_rows(x, r), reps),
               "device_ms": graph_ms(lambda: ob.project_rows(x, r), reps=5),
               "plain_ms": plain, "library_ms": plain,
               "library_device_ms": graph_ms(
                   lambda: ob.project_rows_reference(x, r), reps=5),
               **bound(4 * (n * d + nl * d + nl * n), 2 * n * d * nl, "f32")}
        rec["by_shape"][label.lstrip("_") or "clustered_chunk"] = one
        if not label:
            rec.update({k: one[k] for k in ("ms", "device_ms", "plain_ms",
                                            "bound_ms", "bound_by")})
        del x, r, got, want, part
        torch.cuda.empty_cache()
    rec["max_abs_err"] = worst
    # the plain version is the one PyTorch call of the same function
    rec["library_ms"] = rec["plain_ms"]
    rec["library_call"] = "torch.matmul(r, x.T), IEEE fp32"
    return {"project_rows": rec}


# -- phases 3-4: the serving path ------------------------------------------

def clustered_data(n, dim, centers, sigma, n_queries, seed=SEED):
    """Gaussian mixture around N(0, 1) centers; queries are dataset points
    plus half-sigma noise (``bench.py``'s clustered family, drawn with
    numpy instead of ``jax.random``)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, dim), dtype=np.float32)
    x = c[rng.integers(0, centers, size=n)]
    x += sigma * rng.standard_normal((n, dim), dtype=np.float32)
    q = x[rng.integers(0, n, size=n_queries)]
    q += 0.5 * sigma * rng.standard_normal((n_queries, dim), dtype=np.float32)
    return x, q


def iid_data(n, dim, n_queries, seed=SEED):
    """``bench.py``'s iid headline data: N(0, 1) points; queries are
    dataset points plus 0.1 noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    q = (x[rng.integers(0, n, size=n_queries)]
         + 0.1 * rng.normal(size=(n_queries, dim)).astype(np.float32))
    return x, q


def recall(ids, truth):
    ids, truth = ids.cpu().numpy(), truth.cpu().numpy()
    return float(np.mean([len(set(a) & set(b)) / truth.shape[1]
                          for a, b in zip(ids.tolist(), truth.tolist())]))


def sync_time(fn):
    """``(fn(), seconds)`` on the host clock between two synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def build_cell(x, q, min_leaf, n_trees, device, n_recall=1024):
    """Build one cell's forest through the port's public entry points and
    its exact ground truth for the first ``n_recall`` queries; returns
    ``(forest, queries on the card, truth ids, record)``."""
    import torch

    import rptree_tpu_torch as rp

    n, dim = x.shape
    cfg = rp.rp_tree_cfg(min_leaf, n, dim)
    xd = torch.as_tensor(x, device=device)
    qd = torch.as_tensor(q, device=device)
    f, build_s = sync_time(lambda: rp.forest_batch(
        SEED, cfg.max_depth, min_leaf, n_trees, cfg.proj_nz_density, xd,
        device=device))
    (_, truth), truth_s = sync_time(lambda: f.brute_force_knn(qd[:n_recall],
                                                              K))
    return f, qd, truth, {
        "n": n, "dim": dim, "trees": n_trees, "min_leaf": min_leaf,
        "depth": cfg.max_depth, "leaves": f.plan.n_leaves,
        "queries": q.shape[0], "build_s": build_s, "ground_truth_s": truth_s,
    }


def chunk_tiles(f, qc, budget, probes, tile_m):
    """The tile operands ``(tb, lens_t, qt)`` that the grouped path makes
    for the chunk ``qc`` at the tile capacity it learned (one serving
    configuration on ``f``)."""
    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import grouped as og

    lens = f._lens_global()
    gsel, lsel = fm._probe_pairs(f, qc, budget, probes, K)
    cap = max(f._grouped_nt.values())  # per chunk of serve["chunk"]
    tb, lens_t, qi, _, _ = og._tile_operands(gsel, lsel, lens, tile_m, cap)
    return tb, lens_t, qc[qi]


def tiles_within_norms(name, got, want, sq, tb, qt, tile_m):
    """Squared tile distances ``got`` against the plain version's ``want``:
    infinite at the same places, elsewhere within ``SUM_RTOL`` of ``|x|^2
    + |q|^2``, the terms the factored form cancels.  Returns that share."""
    import torch

    scale = (sq[tb.long()].repeat_interleave(tile_m, 0)
             + (qt * qt).sum(-1)[:, None])
    _rel_err(got, want)  # masking must agree
    fin = torch.isfinite(want)
    err = float(((got - want).abs()[fin] / scale[fin]).max()) \
        if bool(fin.any()) else 0.0
    if err > SUM_RTOL:
        raise AssertionError(f"{name}: squared distances off by {err} of "
                             f"|x|^2 + |q|^2 > {SUM_RTOL}")
    return err


def check_tiles_chunk(f, qc, serve, reps=5, clustered=False):
    """The tile kernel of ``f``'s blocks (kernel 2 on int8, kernel 1 on f32
    and bf16) against its plain version on the tiles the grouped path
    makes for the chunk ``qc``, with the blocks' occupancy table: int8
    distances within ``DIST_RTOL`` (exact integer dots), f32 / bf16
    squared distances within ``SUM_RTOL`` of ``|x|^2 + |q|^2``; with both
    times and the bound on those tiles.  ``clustered``: int8 too is held
    by the squared distances' share of the norms, as the clustered
    cell's distances are ~1% of the norms the factored form cancels
    (the int8 dots are exact; the dequantized terms' float order is
    not)."""
    import torch

    from rptree_tpu_torch.ops import grouped_kernel as gk

    x, sq, _ = f._packed
    tm = serve["tile_m"]
    tb, lens, qt = chunk_tiles(f, qc, serve["budget"], serve["probes"], tm)
    int8 = x.dtype == torch.int8
    if int8:
        name, kind = "grouped_score_tiles_int8", "int8"
        args = (x, sq, f._block_scale, tb, lens, qt, "l2", tm)
    else:
        name = "grouped_score_tiles"
        kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
        args = (x, sq, tb, lens, qt, "l2", tm)
    fn, ref = getattr(gk, name), getattr(gk, name + "_reference")
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    abs_err, rel_err = _rel_err(got, want)
    rec = {"kernel": name, "tiles": tb.shape[0], "max_abs_err": abs_err,
           "max_rel_err": rel_err}
    if int8 and not clustered and rel_err > DIST_RTOL:
        raise AssertionError(f"{name} on the chunk: relative error "
                             f"{rel_err} > {DIST_RTOL}")
    if not int8 or clustered:
        sargs = (*args[:-2], "sql2", tm)
        rec["max_err_of_norms"] = tiles_within_norms(
            f"{name} on the chunk", fn(*sargs), ref(*sargs), sq, tb, qt, tm)
    del got, want
    if not int8:  # the serving path's pair form on the chunk's own tables
        from rptree_tpu_torch.models import forest as fm
        from rptree_tpu_torch.ops import grouped as og

        gsel, lsel = fm._probe_pairs(f, qc, serve["budget"], serve["probes"],
                                     K)
        tables = og.tile_tables(gsel, lsel, f._lens_global(), tm,
                                tb.shape[0])
        pargs = dict(x_leaf=x, sq_leaf=sq, tb=tables[0], tp=tables[1],
                     lens_t=tables[4], slot=tables[3], q=qc, metric="sql2",
                     tile_m=tm)
        pd = gk.grouped_score_pairs(**pargs)
        qi = torch.where(tables[1] >= 0, tables[1] // gsel.shape[1], 0)
        slot_order = og._pair_rows(fn(x, sq, tables[0], tables[4],
                                      qc[qi.reshape(-1).long()], "sql2", tm),
                                   tables[3], float("inf"), *gsel.shape)
        if not torch.equal(pd.view(torch.int32),
                           slot_order.reshape(pd.shape).view(torch.int32)):
            raise AssertionError("grouped_score_pairs on the chunk: differs "
                                 "from the slot-order composition")
        rec["pairs_max_err_of_norms"] = _check_pairs(pargs, pd)
        rec["pairs_block_reads"] = int(gk.score_runs(
            tables[0], tables[1], tables[4], tm,
            torch.cuda.get_device_properties(x.device).multi_processor_count))
        del pd, slot_order
    return {**rec, "ms": cuda_ms(lambda: fn(*args), reps),
            "device_ms": graph_ms(lambda: fn(*args), reps=5),
            "plain_ms": cuda_ms(lambda: ref(*args), reps),
            **tile_bound(x, tb, lens, tm, qt, x.shape[1] * 4, kind)}


def check_descent_chunk(f, qc, budget, probes=None, bucket_stop=False):
    """Kernels 7 and 8 against their plain versions on a cell's own forest
    and queries ``qc``: leaves, priorities (as int32 bits) and probes
    equal (kernel 8 over the blocks' occupancy table, with the knnH bucket
    stop where asked).  Their launches here are not counted."""
    import torch

    from rptree_tpu_torch.ops import traverse as tv

    args = (f.plan, f._table(),
            tv.project_queries(qc, f.arrays.r, f.plan.n_levels), budget)
    leaf, pri = tv.traverse_kernel(*args)
    want_l, want_p = tv.traverse_tree_reference(*args)
    same = torch.equal(leaf, want_l) and torch.equal(
        pri.view(torch.int32), want_p.view(torch.int32))
    if probes is not None:
        pargs = (leaf, pri, f.plan.n_leaves, probes, f._leaf_lens(), K,
                 bucket_stop)
        same = same and all(torch.equal(a, c) for a, c in zip(
            tv.select_probes(*pargs), tv.select_probes_reference(*pargs)))
    torch.cuda.synchronize()
    if not same:
        raise AssertionError(f"kernels 7/8 on {qc.shape[0]} queries at "
                             f"budget {budget}: differ from the plain versions")
    return {"queries": qc.shape[0], "budget": budget, "probes": probes,
            "bit_equal": True, "live_slots": int((leaf >= 0).sum())}


def kernel_counts():
    """The launch count of each kernel of the path: ``{name: (wrapper,
    attribute)}``."""
    from rptree_tpu_torch.ops import build as ob
    from rptree_tpu_torch.ops import ell_kernel as ek
    from rptree_tpu_torch.ops import fused_gather as fg
    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops import grouped_kernel as gk
    from rptree_tpu_torch.ops import scan as sc
    from rptree_tpu_torch.ops import topk_kernel as tk
    from rptree_tpu_torch.ops import traverse as tv

    return {
        "project_rows": (ob.project_rows, "launches"),
        "traverse": (tv.traverse_kernel, "launches"),
        "select_probes": (tv.select_probes, "launches"),
        "tile_tables": (og.tile_tables, "launches"),
        "grouped_score_tiles": (gk.grouped_score_tiles, "launches"),
        "grouped_score_tiles_bf16": (gk.grouped_score_tiles, "launches_bf16"),
        "grouped_score_tiles_int8": (gk.grouped_score_tiles_int8, "launches"),
        "topk_dedup_kernel": (tk.topk_dedup_kernel, "launches"),
        "topk_dedup_pairs": (tk.topk_dedup_pairs, "launches"),
        "grouped_score_topk": (gk.grouped_score_topk, "launches"),
        "gather_score": (fg.gather_score, "launches"),
        "gather_score_bf16": (fg.gather_score, "launches_bf16"),
        "gather_score_shared": (fg.gather_score, "launches_shared"),
        "scan_topk": (sc.scan_topk, "launches"),
        "ell_score_tiles": (ek.ell_score_tiles, "launches"),
    }


def with_projections(runs):
    """``runs`` with kernel 11 (``project_rows``), which projects each
    query chunk that kernel 7 (``traverse``) descends: as many launches as
    it, on every query path."""
    if isinstance(runs, dict):
        return {**runs, "project_rows": runs.get("traverse", 0)}
    return set(runs) | ({"project_rows"} if "traverse" in runs else set())


def counted(fn):
    """``(fn(), launches)``: every kernel's count set to 0 just before
    ``fn`` runs and read just after it."""
    counts = kernel_counts()
    for wrapper, attr in counts.values():
        setattr(wrapper, attr, 0)
    res = fn()
    return res, {name: getattr(wrapper, attr)
                 for name, (wrapper, attr) in counts.items()}


def check_launches(name, runs, warm, steady, chunks, passes):
    """The kernels ``runs`` launched once per chunk in each steady-state
    pass and at least once per chunk in the checked call (which may retry
    with more tiles); every other kernel of the path not at all (kernel 11
    with kernel 7: :func:`with_projections`)."""
    runs = with_projections(runs)
    for kern in warm:
        if kern in runs:
            ok = steady[kern] == passes * chunks and warm[kern] >= chunks
        else:
            ok = steady[kern] == warm[kern] == 0
        if not ok:
            raise AssertionError(
                f"{name}: {kern} launched {warm[kern]} + {steady[kern]} "
                f"times; expected {'>= ' if kern in runs else ''}"
                f"{chunks if kern in runs else 0} + "
                f"{passes * chunks if kern in runs else 0}")


def serve_variant(name, f, qd, truth, pack, serve, runs, n_passes=3,
                  per_chunk=1):
    """Pack ``f`` as ``pack`` asks and serve ``qd`` with ``serve``: one
    checked call that learns the tile capacity, then ``n_passes``
    steady-state ``check=False`` passes that must return the same.  The
    launch counts are read around each of the two and must show that the
    kernels ``runs`` served the variant, ``per_chunk`` times a chunk (a
    sharded forest's shards each launch them), and no other kernel did.
    Returns the record (recall@10 against ``truth``, QPS of the median
    pass, launches) and the last pass's ``(dists, ids)``."""
    import torch

    _, pack_s = sync_time(lambda: f.pack_leaves(**pack))
    ((_, ids0), warm_s), warm_n = counted(lambda: sync_time(
        lambda: f.knn_grouped(qd, K, check=True, **serve)))
    passes, steady_n = counted(lambda: [sync_time(
        lambda: f.knn_grouped(qd, K, check=False, **serve))
        for _ in range(n_passes)])
    chunks = -(-qd.shape[0] // serve["chunk"]) * per_chunk
    check_launches(name, runs, warm_n, steady_n, chunks, n_passes)
    serve_s = float(np.median([s for _, s in passes]))
    dist, ids = passes[-1][0]
    check_result(name, (dist, ids), qd.shape[0])
    if not all(torch.equal(r[1], ids0) for r, _ in passes):
        raise AssertionError(f"{name}: a steady-state pass differs from "
                             "the checked pass")
    over = f.grouped_overflow()
    if over["overflow"]:
        raise AssertionError(f"{name}: tile capacity overflow {over}")
    x_leaf = f._packed[0]
    return {
        "lmax": int(x_leaf.shape[1]),
        "block_dtype": str(x_leaf.dtype).replace("torch.", ""),
        "x_leaf_gb": rows_gb(x_leaf),
        **serve, "recall_at_10": recall(ids[:truth.shape[0]], truth),
        "qps": qd.shape[0] / serve_s, "serve_s": serve_s,
        "checked_serve_s": warm_s, "pack_s": pack_s, "tiles": over,
        "launches": {kern: warm_n[kern] + steady_n[kern] for kern in warm_n},
    }, (dist, ids)


def rows_gb(x_leaf):
    """The packed rows' gigabytes: the blocks, the shared row store, or
    the ELL blocks' columns and values."""
    ts = ((x_leaf.cols, x_leaf.vals) if hasattr(x_leaf, "cols")
          else (getattr(x_leaf, "rows", x_leaf),))
    return sum(t.numel() * t.element_size() for t in ts) / 1e9


def counted_calls(name, fn, runs, n_calls):
    """``fn()`` ``n_calls`` times between synchronisations, with every
    kernel's count set to 0 just before and read just after: each kernel
    that ``runs`` maps must have launched that many times per call and
    every other kernel of the path not at all.  Returns ``(the last
    result, the median seconds of a call, the launches)``."""
    outs, launches = counted(lambda: [sync_time(fn) for _ in range(n_calls)])
    runs = with_projections(runs)
    for kern, n in launches.items():
        want = runs.get(kern, 0) * n_calls
        if n != want:
            raise AssertionError(f"{name}: {kern} launched {n} times; "
                                 f"expected {want}")
    return outs[-1][0], float(np.median([s for _, s in outs])), launches


def check_result(name, res, n_queries):
    """Shape ``[n_queries, K]``, finite ascending distances on live ids and
    +inf exactly where the id is -1."""
    import torch

    dist, ids = res
    if tuple(ids.shape) != (n_queries, K) or tuple(dist.shape) != (
            n_queries, K):
        raise AssertionError(f"{name}: result shape {tuple(ids.shape)}")
    live = ids >= 0
    if not bool(torch.isfinite(dist[live]).all()) or not torch.equal(
            torch.isinf(dist), ~live):
        raise AssertionError(f"{name}: non-finite distances on live ids")
    if int(((dist[:, 1:] - dist[:, :-1]) < 0).sum()):
        raise AssertionError(f"{name}: distances not ascending")


def close_results(name, got, want, rtol=DIST_RTOL):
    """``got`` against ``want``, both ``(dists, ids)`` over the same
    candidates summed in other orders: distances within ``rtol``
    relative, ids equal wherever ``want``'s distance is apart from its
    row neighbours by more than that.  The k-th id is not compared: its
    neighbour past the k-th, which neither result shows, may be as near
    and trade places with it.  Returns the ids compared."""
    import torch

    from rptree_tpu_torch.ops.grouped_kernel import untied

    (gd, gi), (wd, wi) = got, want
    _, rel = _rel_err(gd, wd)
    if rel > rtol:
        raise AssertionError(f"{name}: distances differ by {rel} relative")
    chk = untied(wd, rtol)
    chk[:, -1] = False
    if not torch.equal(gi[chk], wi[chk]):
        bad = int(((gi != wi) & chk).any(1).sum())
        raise AssertionError(f"{name}: ids differ outside near-ties on {bad} "
                             "rows")
    return int(chk.sum())


def same_results(name, got, want):
    """``got`` against ``want``, both ``(dists, ids)``: distances bit-equal
    on every row, ids equal outside runs of equal distances."""
    import torch

    from rptree_tpu_torch.ops.grouped_kernel import untied

    (gd, gi), (wd, wi) = got, want
    if not torch.equal(gd.view(torch.int32), wd.view(torch.int32)):
        bad = int((gd.view(torch.int32) != wd.view(torch.int32)).any(1).sum())
        raise AssertionError(f"{name}: distances differ on {bad} rows")
    chk = untied(wd)
    if not torch.equal(gi[chk], wi[chk]):
        raise AssertionError(f"{name}: ids differ outside runs of ties")
    return int(chk.sum())


def serve_grouped(variants, f, qd, truth, launches, out):
    """Serve each grouped variant ``(name, pack, serve, runs, floor)`` and
    log its record and launch line; ``out`` collects the results by the
    variant's letter, ``launches`` the launch totals."""
    for name, pack, serve, runs, floor in variants:
        rec, out[name[0]] = serve_variant(name, f, qd, truth, pack, serve,
                                          runs)
        out.setdefault("qps", {})[name[0]] = rec["qps"]
        add_launches(launches, name, rec["launches"])
        if name[0] in "ce":
            twin = chr(ord(name[0]) - 1)
            rec[f"same_as_{twin}_untied_ids"] = same_results(
                name, out[name[0]], out[twin])
        log(f"clustered_1m_{name}", **rec, jax_recall=JAX_RECALL["clustered"])
        if rec["recall_at_10"] < floor:
            raise AssertionError(f"{name}: recall {rec['recall_at_10']} < "
                                 f"{floor}")


def add_launches(launches, variant, counts):
    log("launches", variant=variant, **counts)
    for kname, n in counts.items():
        launches[kname] += n


def scan_phase(name, f, qd, truth, query_chunk, floor, launches, jax_recall):
    """The bf16 scan (``brute_force_knn(precision="fastest")``) of ``qd``,
    ``query_chunk`` queries per launch of kernel 5, twice; recall@10 of
    its first rows against ``truth`` must reach ``floor``.  Then the
    kernel at its first launch's shape (the forest's rows, the first
    ``query_chunk`` queries) against its plain version, as
    :func:`close_results` compares: this shape sets its grid."""
    from rptree_tpu_torch.ops import scan as sc

    chunks = -(-qd.shape[0] // query_chunk)
    res, s, n = counted_calls(name, lambda: f.brute_force_knn(
        qd, K, precision="fastest", query_chunk=query_chunk),
        {"scan_topk": chunks}, n_calls=2)
    check_result(name, res, qd.shape[0])
    add_launches(launches, name, n)
    qc = qd[:query_chunk].contiguous()
    got = sc._scan_partial(f.x, f.sq_norms, qc, K, "l2")
    want = sc._partial_reference(f.x, f.sq_norms, qc, K, "l2")
    rec = {"queries": qd.shape[0], "query_chunk": query_chunk,
           "recall_at_10": recall(res[1][:truth.shape[0]], truth),
           "recall_queries": truth.shape[0], "qps": qd.shape[0] / s,
           "serve_s": s, "jax_recall": jax_recall,
           "plain_max_rel_err": _rel_err(got[0], want[0])[1],
           "plain_same_untied_ids": close_results(f"{name} vs plain", got,
                                                  want)}
    del got, want
    log(name, **rec)
    if rec["recall_at_10"] < floor:
        raise AssertionError(f"{name}: recall {rec['recall_at_10']} < {floor}")


def xla_variants(f, qd, truth, serve, launches, out):
    """(g)-(i) on the f32 blocks, through the XLA-form scorer: (g)
    ``cosine`` with the kernel tail and (h) ``dot`` with the sort tail,
    each held against the per-pair path (``knn_batched``) with the same
    metric, probes and tail, its recall@10 against the exact fp32 scan
    with that metric; (i) ``impl="xla"`` on ``l2`` with the sort tail,
    held against (b), whose recall it must reach exactly."""
    walk, probe, tables = "traverse", "select_probes", "tile_tables"
    n_truth = truth.shape[0]
    for name, metric, sel, runs in (
            ("g_f32_cosine_kernel_tail", "cosine", "kernel",
             {walk, probe, tables, "topk_dedup_pairs"}),
            ("h_f32_dot_sort_tail", "dot", "sort", {walk, probe, tables})):
        (_, exact), truth_s = sync_time(lambda: f.brute_force_knn(
            qd[:n_truth], K, metric=metric))
        rec, out[name[0]] = serve_variant(
            name, f, qd, exact, {}, {**serve, "metric": metric,
                                     "selection": sel}, runs)
        add_launches(launches, name, rec["launches"])
        pair = f.knn_batched(qd, K, metric=metric, budget=serve["budget"],
                             probes=serve["probes"], chunk=2048,
                             selection=sel)
        rec["per_pair_same_untied_ids"] = close_results(name, out[name[0]],
                                                        pair)
        log(f"clustered_1m_{name}", **rec, ground_truth_s=truth_s,
            recall_against=f"brute_force_knn(metric={metric!r}), highest")
        del pair
    name = "i_f32_xla_sort_tail"
    rec, out["i"] = serve_variant(name, f, qd, truth, {},
                                  {**serve, "selection": "sort",
                                   "impl": "xla"}, {walk, probe, tables})
    add_launches(launches, name, rec["launches"])
    rec["same_as_b_untied_ids"] = close_results(name, out["i"], out["b"])
    rec["b_recall_at_10"] = recall(out["b"][1][:n_truth], truth)
    log(f"clustered_1m_{name}", **rec, jax_recall=JAX_RECALL["clustered"])
    if rec["recall_at_10"] != rec["b_recall_at_10"]:
        raise AssertionError(f"{name}: recall {rec['recall_at_10']} != "
                             f"(b)'s {rec['b_recall_at_10']}")


def per_pair_phase(name, f, qd, truth, serve, runs, n_calls, launches):
    """The per-pair path (``knn_batched``) over ``qd``, ``n_calls`` times:
    kernel 6 (``runs``) once per chunk and call, no other kernel.
    Returns its record and its last result."""
    chunks = -(-qd.shape[0] // serve["chunk"])
    res, s, n = counted_calls(name, lambda: f.knn_batched(qd, K, **serve),
                              dict.fromkeys(runs, chunks), n_calls)
    check_result(name, res, qd.shape[0])
    add_launches(launches, name, n)
    x_leaf = f._packed[0]
    return {"block_dtype": str(x_leaf.dtype).replace("torch.", ""),
            "lmax": int(x_leaf.shape[1]),
            "x_leaf_gb": rows_gb(x_leaf),
            **serve, "queries": qd.shape[0],
            "recall_at_10": recall(res[1][:truth.shape[0]], truth),
            "qps": qd.shape[0] / s, "serve_s": s}, res


# -- phase 7: online updates ----------------------------------------------

UPDATE_CHUNKS, UPDATE_CHUNK = 4, 25_000   # added and folded in turn
UPDATE_PENDING = 5_000                    # then added and left pending
# removed: indexed, folded and pending ids; the pending share keeps
# k + removed <= 128, so that the pending merge runs kernel 5
UPDATE_REMOVED = {"indexed": 7_000, "folded": 2_900, "pending": 100}
SELF_QUERIES = 4_096
PLACEMENT_MIN_AGREE = 0.999
# kernel 7's budget-1 leaf leaves the fold's at margin forks: ~0.35% of
# the pairs on the clustered cell, the same pairs as JAX's on the CPU
# (tests/test_torch_updates.py); a change in how forks go fails here
BUDGET1_MIN_AGREE = 0.99
IID_ADD = 10_000


def clustered_more(m, dim, centers, sigma, seed=SEED):
    """``m`` more points from :func:`clustered_data`'s mixture: the same
    centers (its generator's first draw), new members and noise."""
    c = np.random.default_rng(seed).standard_normal((centers, dim),
                                                    dtype=np.float32)
    rng = np.random.default_rng(seed + 1)
    x = c[rng.integers(0, centers, size=m)]
    x += sigma * rng.standard_normal((m, dim), dtype=np.float32)
    return x


def rows_by_id(f, new):
    """Every point of ``f`` in id order, ``f32[n + folded + pending, D]``:
    the indexed and folded rows (``points()``), then the pending ones,
    found in ``new`` by the payload (an index into ``new``) each carries."""
    import torch

    lo = f.n_points + f.n_folded
    pend = np.asarray(f.payload_of(np.arange(lo, lo + f.n_pending)),
                      dtype=np.int64)
    return torch.cat([f.points(), new[torch.as_tensor(pend,
                                                      device=new.device)]])


def live_truth(f, new, removed, q):
    """The exact fp32 k nearest of ``q`` among the live points of ``f``
    (indexed, folded and pending, less the ids ``removed``), in ``f``'s
    ids.  Built here, as ``brute_force_knn`` covers neither the pending
    buffer nor the tombstones."""
    import torch

    from rptree_tpu_torch.models import forest as fm

    rows = rows_by_id(f, new)
    live = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    live[torch.as_tensor(removed, device=rows.device)] = False
    ids = torch.nonzero(live).squeeze(1)
    xl = rows[ids]
    _, idx = fm._brute_force(xl, (xl * xl).sum(-1), q, K, "l2")
    return ids[idx.long()].to(torch.int32)


def path_gap(f, projq):
    """Along each (tree, point)'s primary-side path (``proj >= thr`` goes
    right) over the projections ``projq [T, L, M]``: the smallest ``|proj
    - thr|`` of its levels, ``f32[T, M]``."""
    import torch

    child = torch.as_tensor(f.plan.padded_child_table(), dtype=torch.int64,
                            device=projq.device)
    t, nl, m = projq.shape
    code = torch.zeros((t, m), dtype=torch.int64, device=projq.device)
    done = torch.zeros((t, m), dtype=torch.bool, device=projq.device)
    gap = torch.full((t, m), float("inf"), device=projq.device)
    for lvl in range(nl):
        thr = f.arrays.thr[:, lvl, :].gather(1, code)
        gap = torch.where(done, gap, torch.minimum(
            gap, (projq[:, lvl] - thr).abs()))
        nxt = child[lvl][code.clamp(0, child.shape[1] - 1),
                         (projq[:, lvl] >= thr).long()]
        done = done | (nxt < 0)
        code = torch.where(nxt >= 0, nxt, code)
    return gap


def check_placement(f, ids, pts):
    """Where the fold put the points ``pts`` (ids ``ids``), against where
    a query at each one goes: (i) the primary-side descent of the points
    projected as one query batch, which must agree on at least
    ``PLACEMENT_MIN_AGREE`` of the (tree, point) pairs (a miss: the batch
    shape moved a projection across a threshold), with the smallest
    ``|proj - thr|`` on the misses' paths; (ii) kernel 7's budget-1 leaf,
    which also leaves the primary side where a fork's margin priority
    prefers the other child (the reference traversal's own rule): it must
    equal its plain twin's pair for pair, and agree with the fold's leaf
    on at least ``BUDGET1_MIN_AGREE`` of the pairs."""
    import torch

    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import traverse as tv

    fold_leaf = torch.as_tensor(np.concatenate(f._folded_leaf, axis=1)[
        :, ids - f.n_points], device=pts.device)
    projq = tv.project_queries(pts, f.arrays.r, f.plan.n_levels)
    primary = fm._descend(f.plan, f.arrays, pts)
    b1 = tv.traverse_kernel(f.plan, f._table(), projq, 1)[0][:, :, 0]
    b1_plain = tv.traverse_tree_reference(f.plan, f._table(), projq,
                                          1)[0][:, :, 0]
    miss, fork = fold_leaf != primary, fold_leaf != b1
    gap = path_gap(f, projq)
    rec = {"pairs": miss.numel(), "misses": int(miss.sum()),
           "agree": 1.0 - float(miss.float().mean()),
           "misses_min_gap": (float(gap[miss].min())
                              if bool(miss.any()) else None),
           "budget1_agree": 1.0 - float(fork.float().mean()),
           "budget1_margin_forks": int((primary != b1).sum()),
           # whether the budget-1 misses sit at threshold ties
           "budget1_misses_min_gap": (float(gap[fork].min())
                                      if bool(fork.any()) else None)}
    if (rec["agree"] < PLACEMENT_MIN_AGREE
            or rec["budget1_agree"] < BUDGET1_MIN_AGREE
            or not torch.equal(b1, b1_plain)):
        raise AssertionError(f"fold placement: {rec}")
    return rec


def check_update_chunk(f, qd, serve, kern, pending_q):
    """On phase 7's own first chunks, each kernel that runs against its
    plain twin, with the fold's occupancy table: kernels 7 and 8 (with and
    without the bucket stop), 9, 1 (:func:`check_tiles_chunk`) and 3 on
    the grouped chunk, 6 on the first per-pair chunk, 5 on the pending
    merge's own shape (the buffer, ``k`` plus the removed pending points,
    the per-pair call's queries).  Launches here are not counted."""
    import torch

    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import fused_gather as fg
    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops import scan as sc
    from rptree_tpu_torch.ops import topk_kernel as tk

    qc = qd[:serve["chunk"]]
    rec = {"kernels7_8": check_descent_chunk(f, qc, serve["budget"],
                                             serve["probes"]),
           "kernel8_bucket_stop": check_descent_chunk(
               f, qd[:8192], serve["budget"], serve["probes"], True),
           "kernel9": check_tables_chunk(f, qc, serve, kern,
                                         "updates_chunk_own_pairs"),
           "kernel1": check_tiles_chunk(f, qc, serve)}
    x_leaf, sq_leaf, id_leaf = f._packed
    lens = f._lens_global()
    gsel, lsel = fm._probe_pairs(f, qc, serve["budget"], serve["probes"], K)
    cap = max(f._grouped_nt.values())
    d, _ = og.grouped_distances_kernel(x_leaf, sq_leaf, lens, gsel, lsel, qc,
                                       "l2", serve["tile_m"], cap)
    d = d.reshape(qc.shape[0], -1)
    ids = id_leaf[gsel.long()].reshape(qc.shape[0], -1)
    got = tk.topk_dedup_pairs(d, id_leaf, gsel, K)
    for want in (tk.topk_dedup_kernel(d, ids, K),
                 tk.topk_dedup_pairs_reference(d, id_leaf, gsel, K)):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("topk_dedup_pairs on the updates chunk "
                                 "differs")
    rec["kernel3"] = {"rows": d.shape[0], "width": d.shape[1],
                      "bit_equal": True}
    del d, ids, got, want
    qp = qd[:2048]
    sel, _ = fm._probe_pairs(f, qp, serve["budget"], serve["probes"], K)
    (gd, gs), (wd, ws) = (fg.gather_score(x_leaf, sq_leaf, qp, sel),
                          fg.gather_score_reference(x_leaf, sq_leaf, qp, sel))
    rel = _rel_err(gd, wd)[1]
    if rel > DIST_RTOL or not torch.equal(gs, ws):
        raise AssertionError(f"gather_score on the updates chunk: {rel}")
    rec["kernel6"] = {"queries": 2048, "max_rel_err": rel}
    xp = torch.cat(f._pending)
    kp = min(K + len(f._pending_deleted or ()), xp.shape[0])
    sqp = (xp * xp).sum(-1)
    got = sc._scan_partial(xp, sqp, pending_q, kp, "l2")
    want = sc._partial_reference(xp, sqp, pending_q, kp, "l2")
    rec["kernel5"] = {"rows": xp.shape[0], "k": kp,
                      "queries": pending_q.shape[0],
                      "max_rel_err": _rel_err(got[0], want[0])[1],
                      "same_untied_ids": close_results(
                          "scan_topk on the pending merge", got, want)}
    return rec


def updates_phase(f, qd, device, launches, kern, card):
    """Phase 7 on the clustered 1M forest: pack f32 with slack 32; add
    100,000 points of the same mixture in four chunks, with payloads
    (their index into the added points), and fold after each; add 5,000
    more and leave them pending; remove 10,000 ids over indexed, folded
    and pending points; serve (a), per pair (``knn_batched``), ``knn_h``
    and ``knn_h_buckets``, each counted; check recall against the live
    truth, tombstones, placement, self-queries, payloads; time the steps;
    rebuild and check again."""
    import torch

    import rptree_tpu_torch as rp

    t_phase = time.perf_counter()
    walk, probe, tables = "traverse", "select_probes", "tile_tables"
    n = f.n_points
    serve = dict(budget=1, probes=8, tile_m=8, chunk=65536,
                 selection="kernel")
    pack = dict(slack=32)
    _, pack_s = sync_time(lambda: f.pack_leaves(**pack))
    total = UPDATE_CHUNKS * UPDATE_CHUNK + UPDATE_PENDING
    new = torch.as_tensor(clustered_more(total, f.dim, 4_000, 0.15),
                          device=device)
    steps = []
    for c in range(UPDATE_CHUNKS):
        lo = c * UPDATE_CHUNK
        hi = lo + UPDATE_CHUNK
        _, add_s = sync_time(lambda: f.add(new[lo:hi],
                                           payloads=range(lo, hi)))
        _, fold_s = sync_time(f.fold)
        steps.append({"add_s": add_s, "fold_s": fold_s,
                      "folded": f.n_folded, "pending": f.n_pending})
    overflow = f.n_pending
    lo = UPDATE_CHUNKS * UPDATE_CHUNK
    _, add_s = sync_time(lambda: f.add(new[lo:], payloads=range(lo, total)))
    log("updates_added", card=card, pack_s=pack_s, chunks=steps,
        pending_add_s=add_s, overflow_pending=overflow,
        folded=f.n_folded, pending=f.n_pending,
        slack_lmax=int(f._packed[0].shape[1]))
    # the ids to remove, and the folded points to query by themselves
    rng = np.random.default_rng(SEED + 7)
    nf, npend = f.n_folded, f.n_pending
    folded = n + rng.permutation(nf)
    self_ids = np.sort(folded[:SELF_QUERIES])
    pend = n + nf + rng.permutation(npend)
    removed = np.concatenate([
        rng.choice(n, UPDATE_REMOVED["indexed"], replace=False),
        folded[SELF_QUERIES:SELF_QUERIES + UPDATE_REMOVED["folded"]],
        pend[:UPDATE_REMOVED["pending"]]])
    _, remove_s = sync_time(lambda: f.remove(removed))
    dead = set(removed.tolist())
    if f.n_deleted != removed.size:
        raise AssertionError(f"n_deleted {f.n_deleted} != {removed.size}")
    n_truth = 1024
    truth, truth_s = sync_time(lambda: live_truth(f, new, removed,
                                                  qd[:n_truth]))
    qa = qd[:serve["chunk"]]
    rec, res_a = serve_variant(
        "updates_a", f, qa, truth, pack, serve,
        {walk, probe, tables, "grouped_score_tiles", "topk_dedup_pairs"})
    add_launches(launches, "updates_a", rec["launches"])
    pending_q = qd[:8192]
    pair, pair_s, pair_n = counted_calls(
        "updates_per_pair", lambda: f.knn_batched(
            pending_q, K, budget=1, probes=8, precision="default",
            chunk=2048),
        {walk: 4, probe: 4, "gather_score": 4, "scan_topk": 1}, 2)
    add_launches(launches, "updates_per_pair", pair_n)
    knnh, knnh_s, knnh_n = counted_calls(
        "updates_knn_h", lambda: f.knn_h(pending_q, K, budget=1, probes=8),
        {walk: 1, probe: 1, "gather_score": 1}, 2)
    add_launches(launches, "updates_knn_h", knnh_n)
    buckets, buckets_s, buckets_n = counted_calls(
        "updates_knn_h_buckets", lambda: f.knn_h_buckets(qd[:1024], K,
                                                         budget=1),
        {walk: 1, probe: 1}, 2)
    add_launches(launches, "updates_knn_h_buckets", buckets_n)
    for name, res in (("updates_a", res_a), ("updates_per_pair", pair),
                      ("updates_knn_h", knnh)):
        check_result(name, res, res[1].shape[0])
        back = dead & set(res[1].reshape(-1).tolist())
        if back:
            raise AssertionError(f"{name}: removed ids returned: "
                                 f"{sorted(back)[:5]}")
    if int(buckets.shape[0]) != 1024 or int((buckets >= 0).sum(1).min()) < 1:
        raise AssertionError("knn_h_buckets: a query with no bucket")
    chunk_checks = check_update_chunk(f, qd, serve, kern, pending_q)
    # the merge's cost: one chunk with the pending buffer, and without it
    with_s = float(np.median([sync_time(lambda: f.knn_grouped(
        qa, K, check=False, **serve))[1] for _ in range(3)]))
    held, f._pending = f._pending, []
    try:
        without_s = float(np.median([sync_time(lambda: f.knn_grouped(
            qa, K, check=False, **serve))[1] for _ in range(3)]))
    finally:
        f._pending = held
    # each folded point queried by itself, through (a)'s settings
    pay = np.asarray(f.payload_of(self_ids), dtype=np.int64)
    pts = new[torch.as_tensor(pay, device=device)]
    placement = check_placement(f, self_ids, pts)
    _, own = f.knn_grouped(pts, K, **serve)
    own_ok = (own == torch.as_tensor(self_ids, device=device)[:, None]).any(1)
    if not bool(own_ok.all()):
        raise AssertionError(f"{int((~own_ok).sum())} folded points miss "
                             "themselves")
    # each live pending point queried by itself
    live_pend = np.setdiff1d(np.arange(n + nf, n + nf + npend), removed)
    pend_rows = rows_by_id(f, new)[torch.as_tensor(live_pend, device=device)]
    _, pown = f.knn_grouped(pend_rows, K, **serve)
    p_ok = (pown == torch.as_tensor(live_pend, device=device)[:, None]).any(1)
    if not bool(p_ok.all()):
        raise AssertionError(f"{int((~p_ok).sum())} pending points miss "
                             "themselves")
    # payloads resolve the ids returned past n to the rows they were given
    got = np.unique(torch.cat([own.reshape(-1), pown.reshape(-1)]).cpu()
                    .numpy())
    got = got[got >= n]
    pays = np.asarray(f.payload_of(got), dtype=np.int64)
    if not torch.equal(rows_by_id(f, new)[torch.as_tensor(got, device=device)],
                       new[torch.as_tensor(pays, device=device)]):
        raise AssertionError("payload_of: a returned id's payload names "
                             "another row")
    recall_a = rec["recall_at_10"]
    log("updates_served", card=card, remove_s=remove_s, removed=int(
        removed.size), truth_s=truth_s, **rec, per_pair_s=pair_s,
        per_pair_recall=recall(pair[1][:n_truth], truth), knn_h_s=knnh_s,
        knn_h_recall=recall(knnh[1][:n_truth], truth),
        buckets_s=buckets_s, buckets_width=int(buckets.shape[1]),
        chunk_with_pending_s=with_s, chunk_without_pending_s=without_s,
        self_queries=int(own_ok.numel()), pending_self_queries=int(
            p_ok.numel()), payloads_checked=int(got.size),
        placement=placement, chunk_kernels=chunk_checks)
    if recall_a < CLUSTERED_MIN_RECALL:
        raise AssertionError(f"updates (a): recall {recall_a}")
    # rebuild, against a fresh build and pack of the same rows
    _, rebuild_s = sync_time(f.rebuild)
    want_n = n + total - removed.size
    counts = (f.n_pending, f.n_folded, f.n_deleted)
    if f.tree_size() != want_n or counts != (0, 0, 0):
        raise AssertionError(f"rebuild: size {f.tree_size()}, counts "
                             f"{counts}")
    cfg = f.config
    fresh, fresh_s = sync_time(lambda: rp.forest_batch(
        SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees, cfg.proj_nz_density,
        f.x, device=device, r=f.arrays.r).pack_leaves(**pack))
    same_perm = torch.equal(fresh.arrays.perm, f.arrays.perm)
    del fresh
    (_, truth_r), _ = sync_time(lambda: f.brute_force_knn(qd[:n_truth], K))
    rec_r, _ = serve_variant(
        "updates_rebuilt_a", f, qa, truth_r, pack, serve,
        {walk, probe, tables, "grouped_score_tiles", "topk_dedup_pairs"})
    add_launches(launches, "updates_rebuilt_a", rec_r["launches"])
    log("updates_rebuilt", card=card, rebuild_s=rebuild_s,
        fresh_build_pack_s=fresh_s, same_perm_as_fresh=same_perm,
        tree_size=f.tree_size(), **rec_r, folded_recall=recall_a,
        phase_s=time.perf_counter() - t_phase)
    if not same_perm:
        raise AssertionError("rebuild differs from a fresh build")
    if rec_r["recall_at_10"] < CLUSTERED_MIN_RECALL or abs(
            rec_r["recall_at_10"] - recall_a) > 0.01:
        raise AssertionError(f"rebuilt recall {rec_r['recall_at_10']} "
                             f"against folded {recall_a}")


def updates_int8(f, qd, device, launches, card):
    """Phase 7's int8 step on the iid 100k forest (int8 blocks, slack 8):
    add 10,000 points and fold (each row quantized by its target block's
    scale); serve 32,768 queries with the kernel tail (kernels 7, 8, 9, 2,
    3) against the live truth; kernel 2 on the folded chunk."""
    import torch

    rng = np.random.default_rng(SEED + 9)
    new = torch.as_tensor(rng.normal(size=(IID_ADD, f.dim)).astype(
        np.float32), device=device)
    f.add(new, payloads=range(IID_ADD))
    _, fold_s = sync_time(f.fold)
    serve = dict(budget=2, probes=10, tile_m=8, chunk=32768,
                 selection="kernel")
    q = qd[:serve["chunk"]]
    truth = live_truth(f, new, np.zeros(0, np.int64), q[:1024])
    rec, _ = serve_variant(
        "updates_iid_int8", f, q, truth, dict(dtype=torch.int8, slack=8),
        serve, {"traverse", "select_probes", "tile_tables",
                "grouped_score_tiles_int8", "topk_dedup_pairs"})
    add_launches(launches, "updates_iid_int8", rec["launches"])
    log("updates_iid_int8", card=card, added=IID_ADD, fold_s=fold_s,
        folded=f.n_folded, overflow_pending=f.n_pending, **rec,
        kernel2_chunk=check_tiles_chunk(f, q, serve))
    if rec["recall_at_10"] < IID_MIN_RECALL:
        raise AssertionError(f"iid int8 after fold: recall "
                             f"{rec['recall_at_10']}")


# -- phase 8: the other dense layouts --------------------------------------

LAYOUT_GROUPED = dict(budget=1, probes=8, tile_m=8, chunk=65_536)
LAYOUT_PAIR = dict(budget=1, probes=8, precision="default", chunk=2048)
LAYOUT_QUERIES, LAYOUT_PAIR_QUERIES = 65_536, 8_192
SUB_RTOL = 1e-5            # sub-blocks re-block the same candidates
SUB_RECALL_GAP = 0.001
CENTERED_SUB_MIN_RECALL = 0.80
LAYOUT_ADD = 25_000        # points folded into the centered blocks
FOLD_RECALL_DROP = 0.01
SHARED_MIN_RECALL = 0.88
SHARED_GROUPED_GAP = 0.005
JAX_LAYOUT_RECALL = {"int8c_sub8_kmeans": 0.8666, "int8c_whole_leaf": 0.754,
                     "shared_10m_per_pair": 0.9093,
                     "shared_10m_grouped": 0.9090}


def bits_equal(got, want):
    """Whether two ``(dists, ids)`` results are the same bits."""
    import torch

    return bool(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1]))


def layouts_phase(f, qd, truth, out, launches, kern):
    """Phase 8a on phase 3's clustered 1M forest: (j) f32 sub-blocks of
    4 (kmeans), (k) int8 sub-blocks of 4, (m) centered int8 sub-blocks of
    8, (n) shared f32 rows, each grouped on 65,536 queries and, where
    asked, per pair on 8,192; (l) centered int8 whole-leaf blocks with
    slack 32, on a twin of the forest (the same plan, arrays and rows),
    served, then with 25,000 points of the mixture folded in, served
    again.  Each variant's own kernels are checked on its first chunk."""
    import torch

    from rptree_tpu_torch.models import forest as fm

    walk, probe, tables = "traverse", "select_probes", "tile_tables"
    topk = "topk_dedup_pairs"
    g, qg, qp = LAYOUT_GROUPED, qd[:LAYOUT_QUERIES], qd[:LAYOUT_PAIR_QUERIES]
    n_truth = truth.shape[0]
    a = tuple(t[:LAYOUT_QUERIES] for t in out["a"])
    b = tuple(t[:LAYOUT_QUERIES] for t in out["b"])
    pf = tuple(t[:LAYOUT_PAIR_QUERIES] for t in out["f"])
    rec_a, rec_b = recall(a[1][:n_truth], truth), recall(b[1][:n_truth], truth)
    t_phase = time.perf_counter()

    def grouped(name, fo, pack, serve, runs, against=truth):
        rec, res = serve_variant(name, fo, qg, against, pack, serve, runs)
        add_launches(launches, name, rec["launches"])
        return rec, res

    def per_pair(name, fo, runs):
        rec, res = per_pair_phase(name, fo, qp, truth, LAYOUT_PAIR, runs, 2,
                                  launches)
        return rec, res

    # (j) f32, sub-blocks of 4, kmeans: the kernel tail and per pair
    name = "j_f32_sub4_kernel_tail"
    rec, res = grouped(name, f, dict(sub_block=4), {**g, "selection": "kernel"},
                       {walk, probe, tables, "grouped_score_tiles", topk})
    rec.update(same_as_a_untied_ids=close_results(name, res, a, SUB_RTOL),
               max_rel_err_vs_a=_rel_err(res[0], a[0])[1],
               same_bits_as_a=bits_equal(res, a), a_recall_at_10=rec_a,
               kernel1_chunk=check_tiles_chunk(f, qg, g),
               kernel9_chunk=check_tables_chunk(f, qg, g, kern,
                                                "j_sub4_chunk_own_pairs"),
               kernels7_8_chunk=check_descent_chunk(f, qg, g["budget"],
                                                    g["probes"]))
    log(f"layouts_{name}", **rec)
    if abs(rec["recall_at_10"] - rec_a) > SUB_RECALL_GAP:
        raise AssertionError(f"{name}: recall {rec['recall_at_10']} vs (a)'s "
                             f"{rec_a}")
    name = "j_f32_sub4_per_pair"
    rec, res = per_pair(name, f, {walk, probe, "gather_score"})
    rec.update(same_as_f_untied_ids=close_results(name, res, pf, SUB_RTOL),
               same_bits_as_f=bits_equal(res, pf),
               kernel6_chunk=check_gather_chunk(f, qp[:2048], LAYOUT_PAIR))
    log(f"layouts_{name}", **rec)

    # (k) int8, sub-blocks of 4, kmeans, not centered: kernel 2 on them
    name = "k_int8_sub4_kernel_tail"
    rec, _ = grouped(name, f, dict(dtype=torch.int8, sub_block=4),
                     {**g, "selection": "kernel"},
                     {walk, probe, tables, "grouped_score_tiles_int8", topk})
    rec["kernel2_chunk"] = check_tiles_chunk(f, qg, g, clustered=True)
    log(f"layouts_{name}", **rec)

    # (m) centered int8, sub-blocks of 8, kmeans: the XLA form, per pair
    name = "m_int8c_sub8_kernel_tail"
    rec_m, _ = grouped(name, f, dict(dtype=torch.int8, centered=True,
                                     sub_block=8),
                       {**g, "selection": "kernel"},
                       {walk, probe, tables, topk})
    rec_m["kernel9_chunk"] = check_tables_chunk(f, qg, g, kern,
                                                "m_sub8_chunk_own_pairs")
    log(f"layouts_{name}", **rec_m,
        jax_recall=JAX_LAYOUT_RECALL["int8c_sub8_kmeans"])
    name = "m_int8c_sub8_per_pair"
    rec, _ = per_pair(name, f, {walk, probe})
    log(f"layouts_{name}", **rec)

    # (n) shared f32 rows: kernel 6's shared-row mode, the XLA form
    name = "n_shared_f32_per_pair"
    shared = dict(store="shared")
    f.pack_leaves(**shared)
    rec, res = per_pair(name, f, {walk, probe, "gather_score_shared"})
    rows = f._packed[0]
    blocked = fm.RPForest(f.plan, f.arrays, f.x, f.sq_norms, f.config,
                          seed=f.seed).pack_leaves()._packed[1]
    rec["norms_same_bits_as_blocked"] = torch.equal(f._packed[1], blocked)
    del blocked
    if not rec["norms_same_bits_as_blocked"]:
        raise AssertionError("shared slot norms differ from the blocked "
                             "f32 pack's")
    rec.update(same_as_f_untied_ids=close_results(name, res, pf, SUB_RTOL),
               same_bits_as_f=bits_equal(res, pf),
               rows_alias_dataset=rows.rows.data_ptr() == f.x.data_ptr(),
               shared_tables_gb=(rows.ids.numel() * 4
                                 + f._packed[1].numel() * 4) / 1e9,
               kernel6_chunk=check_gather_chunk(f, qp[:2048], LAYOUT_PAIR))
    log(f"layouts_{name}", **rec)
    print(f"shared rows alias the dataset: "
          f"{rows.rows.data_ptr() == f.x.data_ptr()}", flush=True)
    if not rec["rows_alias_dataset"]:
        raise AssertionError("shared f32 rows are a copy of the dataset")
    name = "n_shared_f32_sort_tail"
    rec, res = grouped(name, f, shared, {**g, "selection": "sort"},
                       {walk, probe, tables})
    rec.update(same_as_b_untied_ids=close_results(name, res, b),
               max_rel_err_vs_b=_rel_err(res[0], b[0])[1],
               b_recall_at_10=rec_b)
    log(f"layouts_{name}", **rec)
    if abs(rec["recall_at_10"] - rec_b) > SUB_RECALL_GAP:
        raise AssertionError(f"{name}: recall {rec['recall_at_10']} vs (b)'s "
                             f"{rec_b}")

    # (l) centered int8 whole-leaf blocks, slack 32, on a twin: served,
    # then 25,000 points folded into the centered blocks, served again
    fl = fm.RPForest(f.plan, f.arrays, f.x, f.sq_norms, f.config,
                     seed=f.seed)
    name = "l_int8c_kernel_tail"
    rec_l, _ = grouped(name, fl, dict(dtype=torch.int8, centered=True,
                                      slack=32),
                       {**g, "selection": "kernel"},
                       {walk, probe, tables, topk})
    log(f"layouts_{name}", **rec_l,
        jax_recall=JAX_LAYOUT_RECALL["int8c_whole_leaf"])
    name = "l_int8c_per_pair"
    rec, _ = per_pair(name, fl, {walk, probe})
    log(f"layouts_{name}", **rec)
    new = torch.as_tensor(clustered_more(LAYOUT_ADD, qd.shape[1], 4000, 0.15),
                          device=qd.device)
    fl.add(new, payloads=list(range(LAYOUT_ADD)))
    _, fold_s = sync_time(fl.fold)
    live = live_truth(fl, new, np.zeros(0, np.int64), qd[:n_truth])
    runs = {walk, probe, tables, topk}
    name = "l_int8c_folded_kernel_tail"
    rec, _ = grouped(name, fl, dict(dtype=torch.int8, centered=True,
                                    slack=32),
                     {**g, "selection": "kernel"}, runs, against=live)
    rec.update(added=LAYOUT_ADD, folded=fl.n_folded,
               overflow_pending=fl.n_pending, fold_s=fold_s,
               before_recall_at_10=rec_l["recall_at_10"])
    log(f"layouts_{name}", **rec)
    del fl, new, live
    torch.cuda.empty_cache()
    if rec["recall_at_10"] < rec_l["recall_at_10"] - FOLD_RECALL_DROP:
        raise AssertionError(f"{name}: recall {rec['recall_at_10']} after "
                             f"the fold, {rec_l['recall_at_10']} before")
    if not (rec_m["recall_at_10"] >= CENTERED_SUB_MIN_RECALL
            and rec_m["recall_at_10"] > rec_l["recall_at_10"]):
        raise AssertionError(f"(m) recall {rec_m['recall_at_10']}: needs >= "
                             f"{CENTERED_SUB_MIN_RECALL} and above (l)'s "
                             f"{rec_l['recall_at_10']}")
    log("layouts_1m", phase_s=time.perf_counter() - t_phase)


def clustered_on_card(n, dim, centers, sigma, nq, device, seed=SEED):
    """:func:`clustered_data`'s family drawn on the card by a CUDA
    ``torch.Generator`` (10M rows would take minutes through numpy):
    ``(x f32[n, dim], q f32[nq, dim])``, the queries dataset points plus
    half-sigma noise."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn(centers, dim, generator=gen, device=device)
    x = c[torch.randint(0, centers, (n,), generator=gen, device=device)]
    x += sigma * torch.randn(n, dim, generator=gen, device=device)
    q = x[torch.randint(0, n, (nq,), generator=gen, device=device)]
    q += 0.5 * sigma * torch.randn(nq, dim, generator=gen, device=device)
    return x, q


def shared_10m_phase(device, launches, kern, card):
    """Phase 8b, ``examples/scale_10m.py``'s cell: 10M x 128 f32 points of
    40,000 N(0, 1) centers, sigma 0.15, drawn on the card; the forest of
    ``rp_tree_cfg_clustered`` (T 8) packed with ``store="shared"``; 65,536
    queries served per pair (sort tail and kernel tail) and grouped
    (the XLA form), each against the exact fp32 scan of 1,024; the bf16
    scan of 4,096 (kernel 5 at N 10M)."""
    import torch

    import rptree_tpu_torch as rp

    n, dim, centers, sigma, nq = 10_000_000, 128, 40_000, 0.15, 65_536
    walk, probe, tables = "traverse", "select_probes", "tile_tables"
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    x, q = clustered_on_card(n, dim, centers, sigma, nq, device)
    cfg = rp.rp_tree_cfg_clustered(n, dim, centers=centers)
    f, build_s = sync_time(lambda: rp.forest_batch(
        SEED, cfg.max_depth, cfg.min_leaf, 8, cfg.proj_nz_density, x,
        device=device))
    _, pack_s = sync_time(lambda: f.pack_leaves(store="shared"))
    g_blocks, lmax, _ = f._packed[0].shape
    (_, truth), truth_s = sync_time(lambda: f.brute_force_knn(q[:1024], K))
    cell = {"n": n, "dim": dim, "centers": centers, "sigma": sigma,
            "trees": 8, "min_leaf": cfg.min_leaf, "depth": cfg.max_depth,
            "leaves": f.plan.n_leaves, "lmax": int(lmax), "queries": nq,
            "data": "drawn on the card by a torch.Generator (the JAX "
                    "example draws with jax.random)",
            "build_s": build_s, "pack_s": pack_s, "ground_truth_s": truth_s,
            "shared_tables_gb": 2 * g_blocks * lmax * 4 / 1e9,
            "blocked_t8_rows_gb": g_blocks * lmax * dim * 4 / 1e9,
            "dataset_gb": n * dim * 4 / 1e9, "card": card}
    log("shared_10m", **cell)
    pair = dict(budget=1, probes=8, precision="default", chunk=8192)
    rec_p, res_p = per_pair_phase(
        "shared_10m_per_pair_sort", f, q, truth, pair,
        {walk, probe, "gather_score_shared"}, 3, launches)
    log("shared_10m_per_pair_sort", **rec_p,
        jax_recall=JAX_LAYOUT_RECALL["shared_10m_per_pair"],
        kernel6_chunk=check_gather_chunk(f, q[:pair["chunk"]], pair),
        kernels7_8_chunk=check_descent_chunk(f, q[:pair["chunk"]], 1, 8))
    rec, res = per_pair_phase(
        "shared_10m_per_pair_kernel", f, q, truth,
        {**pair, "selection": "kernel"},
        {walk, probe, "gather_score_shared", "topk_dedup_pairs"}, 3,
        launches)
    rec["sort_tail_same_untied_ids"] = close_results(
        "shared_10m_per_pair_kernel", res, res_p)
    log("shared_10m_per_pair_kernel", **rec)
    del res
    serve = dict(budget=1, probes=8, precision="default", chunk=8192,
                 tile_m=16)
    rec_g, _ = serve_variant("shared_10m_grouped", f, q, truth,
                             dict(store="shared"), serve,
                             {walk, probe, tables})
    add_launches(launches, "shared_10m_grouped", rec_g["launches"])
    log("shared_10m_grouped", **rec_g,
        jax_recall=JAX_LAYOUT_RECALL["shared_10m_grouped"],
        kernel9_chunk=check_tables_chunk(f, q[:serve["chunk"]], serve, kern,
                                         "shared_10m_chunk_own_pairs"))
    scan_phase("shared_10m_scan", f, q[:4096], truth, 1024, 0.0, launches,
               None)
    rp_, rg = rec_p["recall_at_10"], rec_g["recall_at_10"]
    log("shared_10m_summary", per_pair_recall_at_10=rp_,
        grouped_recall_at_10=rg, per_pair_qps=rec_p["qps"],
        grouped_qps=rec_g["qps"],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        phase_s=time.perf_counter() - t_phase, card=card)
    if min(rp_, rg) < SHARED_MIN_RECALL or abs(rg - rp_) > SHARED_GROUPED_GAP:
        raise AssertionError(f"shared 10M: recall per pair {rp_}, grouped "
                             f"{rg}: needs >= {SHARED_MIN_RECALL}, within "
                             f"{SHARED_GROUPED_GAP}")
    # -- phase 14c: the data-parallel forest on these rows ---------------
    dp_s = dp_shared_10m(f, x, q, truth, res_p, rec_p, launches, card)
    del f, x, q, truth, res_p
    torch.cuda.empty_cache()
    return dp_s


# -- phase 9: sparse (ELL) data, the bag-of-words cell ----------------------

SPARSE_QUERIES = 8_192
SPARSE_RECALL_QUERIES = 1_024
SPARSE_MIN_RECALL = 0.095
JAX_SPARSE_RECALL = 0.104  # examples/bow_sparse.py, per pair, a TPU v5e
SPARSE_ADD, SPARSE_FAT = 4_096, 16
SPARSE_MIN_FOUND = 0.99


def check_ell_chunk(f, qc, serve, reps=5):
    """Kernel 10 against its plain version on the tiles that the grouped
    path makes for the chunk ``qc`` (its probes, kernel 9's tables at the
    learned capacity): squared distances within ``SUM_RTOL`` of ``|x|^2 +
    |q|^2`` (the queries are dataset rows: near their own rows the l2
    distance is the square root of that cancellation alone), l2 infinite
    at the same places; both times and the bound there."""
    import torch

    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import ell_kernel as ek
    from rptree_tpu_torch.ops import grouped as og

    blocks, sq, _ = f._packed
    gsel, lsel = fm._probe_pairs(f, qc, serve["budget"], SPARSE_PROBES, K)
    cap = max(f._grouped_nt.values())
    tb, tp, needed, _, lens = og.tile_tables(gsel, lsel, f._lens_global(),
                                             serve["tile_m"], cap)
    qq = (qc * qc).sum(-1)
    rec = {"tiles": {"needed": int(needed), "capacity": cap}}
    for metric in ("l2", "sql2"):
        args = (blocks, sq, tb, tp, lens, qc, qq, SPARSE_PROBES, metric)
        got, want = ek.ell_score_tiles(*args), ek.ell_score_tiles_reference(
            *args)
        torch.cuda.synchronize()
        if metric == "sql2":
            rec["max_abs_err"], rec["max_err_of_norms"] = ell_agree(
                "ell_score_tiles on the chunk", got, want, sq, qq, tb, tp,
                SPARSE_PROBES, metric)
        else:
            rec["l2_max_abs_err"] = _rel_err(got, want)[0]
        del got, want
    args = (blocks, sq, tb, tp, lens, qc, qq, SPARSE_PROBES, "l2")
    rec["route_share"] = ell_route_share(args, tb)
    return {**rec, "ms": cuda_ms(lambda: ek.ell_score_tiles(*args), reps),
            "device_ms": graph_ms(lambda: ek.ell_score_tiles(*args), reps=5),
            "plain_ms": cuda_ms(lambda: ek.ell_score_tiles_reference(*args),
                                2),
            **ell_bound(blocks, tb, tp, lens, qc, SPARSE_PROBES)}


def sparse_phase(device, launches, card, n=SPARSE_N, n_queries=SPARSE_QUERIES,
                 n_add=SPARSE_ADD, on_card=True):
    """Phase 9, ``examples/bow_sparse.py``'s cell: 262,144 documents of 32
    terms over a 65,536-term vocabulary, 256 topic bands, drawn with numpy
    at the smoke's seed (the example draws with ``jax.random``);
    ``rp_tree_cfg(128, n, 65,536)``, T 8, f32 ``EllBlocks``; 8,192 queries
    that are dataset rows, served (s1) per pair (``knn_batched``, chunk
    512), (s2) grouped with the kernel tail (chunk 4,096), (s3) (s2) with
    the queries an ``EllMatrix`` and (s4) (s1) with them so; recall@10 of
    the first 1,024 against the exact ELL scan; (s3) the bits of (s2) and
    (s4) of (s1); kernel 10 on (s2)'s first chunk.  Then a repack with
    slack 8, 4,096 documents of the mixture and 16 rows of 64 nonzeros
    added and folded: no row past the blocks' K slots folded, every folded
    document found by itself through (s3)'s path (>= 99%)."""
    import torch

    import rptree_tpu_torch as rp
    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops.sparse import EllMatrix, ell_take, ell_to_dense

    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    walk, probe, tables, ell = ("traverse", "select_probes", "tile_tables",
                                "ell_score_tiles")
    cols, vals = sparse_rows(n, SEED)
    x = EllMatrix(SPARSE_V, cols, vals)
    cfg = rp.rp_tree_cfg(128, n, SPARSE_V)
    f, build_s = sync_time(lambda: rp.forest_batch(
        SEED, cfg.max_depth, 128, 8, cfg.proj_nz_density, x, device=device))
    _, pack_s = sync_time(f.pack_leaves)
    blocks = f._packed[0]
    qi = np.random.default_rng(SEED + 11).integers(0, n, size=n_queries)
    qe = ell_take(f.x, torch.as_tensor(qi, device=device))
    qd, densify_s = sync_time(lambda: ell_to_dense(qe, torch.float32))
    nr = min(SPARSE_RECALL_QUERIES, n_queries)
    (_, truth), scan_s = sync_time(lambda: f.brute_force_knn(qd[:nr], K))
    cell = {"n": n, "V": SPARSE_V, "nnz": SPARSE_NNZ, "topics": SPARSE_TOPICS,
            "trees": 8, "min_leaf": 128, "depth": cfg.max_depth,
            "leaves": f.plan.n_leaves, "lmax": int(blocks.shape[1]),
            "K": int(blocks.shape[2]), "queries": n_queries,
            "build_s": build_s, "pack_s": pack_s, "densify_s": densify_s,
            "ell_blocks_gb": rows_gb(blocks), "scan_s": scan_s,
            "scan_qps": nr / scan_s, "card": card,
            "data": "numpy at the smoke's seed (the example: jax.random)"}
    log("sparse_bow_262k", **cell)
    out, recs = {}, {}
    pair_runs = {walk, probe, ell}
    grouped_runs = {walk, probe, tables, ell, "topk_dedup_pairs"}
    for name, q in (("s1_per_pair", qd), ("s4_per_pair_sparse_queries", qe)):
        recs[name], out[name] = per_pair_phase(
            f"sparse_{name}", f, q, truth, SPARSE_PAIR, pair_runs, 2,
            launches)
    for name, q in (("s2_grouped", qd), ("s3_grouped_sparse_queries", qe)):
        recs[name], out[name] = serve_variant(
            f"sparse_{name}", f, q, truth, {}, SPARSE_GROUPED, grouped_runs)
        add_launches(launches, f"sparse_{name}", recs[name]["launches"])
    recs["s3_grouped_sparse_queries"]["same_as_s2_untied_ids"] = same_results(
        "sparse (s3)", out["s3_grouped_sparse_queries"], out["s2_grouped"])
    recs["s4_per_pair_sparse_queries"]["same_as_s1_untied_ids"] = \
        same_results("sparse (s4)", out["s4_per_pair_sparse_queries"],
                     out["s1_per_pair"])
    recs["s2_grouped"]["kernel10_chunk"] = (
        check_ell_chunk(f, qd[:SPARSE_GROUPED["chunk"]], SPARSE_GROUPED)
        if on_card else None)
    for name, rec in recs.items():
        log(f"sparse_{name}", **rec, jax_recall=JAX_SPARSE_RECALL)
        if rec["recall_at_10"] < SPARSE_MIN_RECALL:
            raise AssertionError(f"sparse {name}: recall "
                                 f"{rec['recall_at_10']} < "
                                 f"{SPARSE_MIN_RECALL}")
    del out, qd, truth
    # the fold: a repack with slack, documents of the mixture and rows past
    # the blocks' K slots, which stay pending
    _, repack_s = sync_time(lambda: f.pack_leaves(slack=8))
    kz = int(f._packed[0].shape[2])
    ac, av = sparse_rows(n_add, SEED + 12)
    new = ell_to_dense(EllMatrix(SPARSE_V, ac, av).to(device), torch.float32)
    fc, fv = sparse_rows(SPARSE_FAT, SEED + 13, nnz=2 * SPARSE_NNZ,
                         topics=1)
    fat = ell_to_dense(EllMatrix(SPARSE_V, fc, fv).to(device), torch.float32)
    _, add_s = sync_time(lambda: f.add(torch.cat([new, fat])))
    _, fold_s = sync_time(f.fold)
    folded, pending = f.n_folded, f.n_pending
    fx = torch.cat(f._folded_x)
    widest = int((fx != 0).sum(1).max())
    left = torch.cat(f._pending)
    fat_pending = bool(pending >= SPARSE_FAT and torch.equal(
        left[-SPARSE_FAT:], fat))
    if widest > kz or not fat_pending:
        raise AssertionError(f"sparse fold: a folded row of {widest} > {kz} "
                             f"nonzeros, or a wide row folded "
                             f"({pending} pending)")
    # the rows left pending removed and dropped, so that sparse queries serve
    f.remove(np.arange(n + folded, n + folded + pending))
    f.fold()
    rc, rv = fm._ell_slots(fx, kz)
    (_, own), self_s = sync_time(lambda: f.knn_grouped(
        EllMatrix(SPARSE_V, rc, rv), K, **SPARSE_GROUPED))
    want = torch.arange(n, n + folded, device=device)[:, None]
    found = float((own == want).any(1).float().mean())
    log("sparse_fold", card=card, slack=8, repack_s=repack_s, added=n_add,
        wide_rows=SPARSE_FAT, add_s=add_s, fold_s=fold_s, folded=folded,
        pending_after_fold=pending, overflow_pending=pending - SPARSE_FAT,
        widest_folded_row=widest, k_slots=kz, wide_rows_pending=fat_pending,
        self_queries=folded, self_query_s=self_s, found_self=found,
        peak_allocated_gb=(torch.cuda.max_memory_allocated() / 1e9
                           if on_card else None),
        phase_s=time.perf_counter() - t_phase)
    if found < SPARSE_MIN_FOUND:
        raise AssertionError(f"sparse fold: {found} of the folded documents "
                             f"find themselves < {SPARSE_MIN_FOUND}")


# -- phase 10: the user surface ---------------------------------------------

STREAM_CHUNKS = 16                  # (u1) phase 3's rows, streamed from the host
STREAM_QUERIES = 65_536             # (u1) (a)'s first chunk
ANYTIME_CHUNKS, ANYTIME_SLACK = 4, 8
ANYTIME_QUERIES = 8_192
ANYTIME_SERVE = dict(budget=2, probes=10, precision="default", chunk=2048)
CHECKPOINT_QUERIES = 32_768
TUNE_QUERIES, TUNE_WIDE_QUERIES, TUNE_TARGET = 1_024, 8_192, 0.9
TUNE_SWEEP = dict(budgets=(1, 2, 4), probes_per_tree=(1.0, 2.0))
GEN_ROWS, GEN_SIGMAS = 1_000_000, 5


def check_ran(name, counts, must, may=()):
    """Every kernel of ``must`` launched in ``counts`` (a :func:`counted`
    reading), none outside ``must`` and ``may``."""
    must = with_projections(must)
    bad = {k: n for k, n in counts.items()
           if (k in must and n < 1) or (k not in must and k not in may
                                         and n)}
    if bad:
        raise AssertionError(f"{name}: launches {bad} (must {sorted(must)})")


def surface_stream(f, qd, truth, out, launches, card):
    """(u1) ``rp.forest`` over phase 3's rows, 16 chunks from the host,
    with phase 3's parameters: the trees ``torch.equal`` to phase 3's; then
    packed f32 and served grouped with the kernel tail on (a)'s first
    chunk, bit-equal to (a)."""
    import torch

    import rptree_tpu_torch as rp

    x = f.x.cpu().numpy()
    n, dim = x.shape
    step = -(-n // STREAM_CHUNKS)
    cfg = f.config
    source = (x[s:s + step] for s in range(0, n, step))
    (fs, build_s), n_build = counted(lambda: sync_time(lambda: rp.forest(
        SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees, 65_536,
        cfg.proj_nz_density, dim, source, device=f.device)))
    check_ran("u1 build", n_build, {"project_rows"})
    add_launches(launches, "u1_stream_build", n_build)
    del x
    same = {k: bool(torch.equal(getattr(fs.arrays, k), getattr(f.arrays, k)))
            for k in ("r", "perm", "thr", "mgl", "mgh")}
    if not all(same.values()) or not torch.equal(fs.x, f.x):
        raise AssertionError(f"u1: streamed forest differs from phase 3's: "
                             f"{same}")
    serve = dict(budget=1, probes=8, tile_m=8, chunk=STREAM_QUERIES,
                 selection="kernel")
    q = qd[:STREAM_QUERIES]
    rec, res = serve_variant(
        "u1_streamed_f32_kernel_tail", fs, q, truth, {}, serve,
        {"traverse", "select_probes", "tile_tables", "grouped_score_tiles",
         "topk_dedup_pairs"})
    add_launches(launches, "u1_streamed_f32_kernel_tail", rec["launches"])
    a = tuple(t[:STREAM_QUERIES] for t in out["a"])
    if not bits_equal(res, a):
        raise AssertionError("u1: the streamed forest's results differ from "
                             "(a)'s")
    log("surface_u1_stream", card=card, chunks=STREAM_CHUNKS, chunk_rows=step,
        stream_build_s=build_s, trees_equal=same, bits_equal_a=True, **rec)
    del fs, res


def surface_tune(f, qd, launches, card):
    """(u4) ``rp.tune`` on phase 3's forest packed f32, measured, grouped
    and per pair: met, every frontier point timed, the returned recall
    that of ``rp.knn`` (or of the scan) at the returned knobs."""
    import torch

    import rptree_tpu_torch as rp

    f.pack_leaves()
    grouped = {"traverse", "select_probes", "tile_tables",
               "grouped_score_tiles", "gather_score", "scan_topk"}
    for serving, nq, must in (
            ("grouped", TUNE_QUERIES, grouped),
            ("batched", TUNE_QUERIES, {"traverse", "select_probes",
                                       "gather_score", "scan_topk"}),
            # the same sweep timed on chunks of 8,192 (the timed batch is
            # the validation set, chunked by its own size)
            ("grouped", TUNE_WIDE_QUERIES, grouped)):
        q = qd[:nq]
        exact = f.brute_force_knn(q, K)[1]
        (best, tune_s), n = counted(lambda: sync_time(lambda: rp.tune(
            f, q, K, TUNE_TARGET, serving=serving, **TUNE_SWEEP)))
        name = f"u4_tune_{serving}" + ("" if nq == TUNE_QUERIES else
                                       f"_{nq}")
        check_ran(name, n, must)
        add_launches(launches, name, n)
        if best.get("scan"):
            ids = f.brute_force_knn(q, K, precision="fastest")[1]
        else:
            ids = rp.knn(f, q, K, budget=best["budget"],
                         probes=best["probes"])[1]
        again = recall(ids, exact)
        frontier = [{k: p.get(k) for k in ("budget", "probes", "recall",
                                           "cost", "qps", "scan")}
                    for p in best["frontier"]]
        log(f"surface_{name}", card=card, queries=nq,
            target=TUNE_TARGET, **TUNE_SWEEP, tune_s=tune_s,
            best={k: v for k, v in best.items() if k != "frontier"},
            recall_again=again, frontier=frontier)
        if not best["met"]:
            raise AssertionError(f"{name}: target not met")
        if again != best["recall"]:
            raise AssertionError(f"{name}: recall {best['recall']}"
                                 f" but knn at its knobs {again}")
        if not all(p["qps"] > 0 for p in best["frontier"]):
            raise AssertionError(f"{name}: a point without QPS")
        del ids
    torch.cuda.empty_cache()


def surface_generators(device, card):
    """(u5) ``rp.data_batch`` on the card: ``normal_dense2`` at D 128, its
    mixture share and component means within 5 standard errors;
    ``circle2d2`` within radius 1 of its centres, half in each disk."""
    import torch

    import rptree_tpu_torch as rp

    (x, s), n = counted(lambda: sync_time(lambda: rp.data_batch(
        SEED, GEN_ROWS, lambda k, m: rp.normal_dense2(k, m, 128),
        device=device)))
    check_ran("u5 generators", n, set())
    if x.device.type != device.type or tuple(x.shape) != (GEN_ROWS, 128):
        raise AssertionError(f"u5: data_batch gave {tuple(x.shape)} on "
                             f"{x.device}")
    high = x.mean(1) > 1.0
    m_high = int(high.sum())
    share = m_high / GEN_ROWS
    se_share = (0.25 / GEN_ROWS) ** 0.5
    means = (float(x[~high].double().mean()), float(x[high].double().mean()))
    se = (0.5 / ((GEN_ROWS - m_high) * 128) ** 0.5,
          0.5 / (m_high * 128) ** 0.5)
    c = rp.data_batch(SEED, GEN_ROWS, rp.circle2d2, device=device)
    cs = torch.stack([c.norm(dim=1), (c - torch.tensor(
        [2.0, 3.0], device=device)).norm(dim=1)])
    radius = float(cs.min(0).values.max())
    first = int((cs[0] <= cs[1]).sum()) / GEN_ROWS
    rec = {"rows": GEN_ROWS, "dim": 128, "draw_s": s, "share_high": share,
           "share_se": se_share, "means": means, "means_se": se,
           "circle_max_radius": radius, "circle_first_share": first}
    log("surface_u5_generators", card=card, **rec)
    if (abs(share - 0.5) > GEN_SIGMAS * se_share
            or abs(means[0]) > GEN_SIGMAS * se[0]
            or abs(means[1] - 2.0) > GEN_SIGMAS * se[1]):
        raise AssertionError(f"u5: normal_dense2 off its distribution: {rec}")
    if radius > 1.0 + 1e-6 or abs(first - 0.5) > GEN_SIGMAS * se_share:
        raise AssertionError(f"u5: circle2d2 off its disks: {rec}")
    del x, c, cs


def surface_anytime(f, launches, card):
    """(u2) ``ForestBuilder(anytime_slack=8)`` over the iid 100k rows in 4
    chunks: after each, the partial index served per pair on 8,192
    queries drawn from the rows seen (each a seen point plus 0.1 noise,
    the iid cell's queries), recall@10 >= 0.10 against the exact scan of
    the rows seen;
    ``build()`` ``torch.equal`` to phase 4's batch build of all rows."""
    import torch

    import rptree_tpu_torch as rp

    cfg, x = f.config, f.x
    n, dim = x.shape
    step = n // ANYTIME_CHUNKS
    rng = np.random.default_rng(SEED + 10)
    b = rp.ForestBuilder(SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
                         cfg.proj_nz_density, dim,
                         anytime_slack=ANYTIME_SLACK, device=f.device)
    host = x.cpu().numpy()
    steps = []
    for i in range(ANYTIME_CHUNKS):
        lo = i * step
        (_, insert_s), n_ins = counted(lambda: sync_time(lambda: b.insert_chunk(
            host[lo:lo + step], payloads=range(lo, lo + step))))
        add_launches(launches, f"u2_insert_{i}", n_ins)
        p = b.partial_index
        # the iid cell's queries (dataset points plus 0.1 noise), drawn
        # from the rows seen so far
        pick = torch.as_tensor(rng.integers(0, lo + step,
                                            size=ANYTIME_QUERIES),
                               device=x.device)
        q = x[pick] + torch.as_tensor(0.1 * rng.standard_normal(
            (ANYTIME_QUERIES, dim), dtype=np.float32), device=x.device)
        (res, serve_s), n_q = counted(lambda: sync_time(
            lambda: p.knn_batched(q, K, **ANYTIME_SERVE)))
        check_ran(f"u2 chunk {i}", n_q,
                  {"traverse", "select_probes", "gather_score"},
                  may={"scan_topk"})
        add_launches(launches, f"u2_serve_{i}", n_q)
        check_result(f"u2 chunk {i}", res, q.shape[0])
        truth = live_truth(p, x, np.zeros(0, np.int64), q)
        step_rec = {"rows_seen": lo + step, "pending": p.n_pending,
                    "folded": p.n_folded, "insert_s": insert_s,
                    "serve_s": serve_s, "qps": q.shape[0] / serve_s,
                    "recall_at_10": recall(res[1], truth)}
        steps.append(step_rec)
        log("surface_u2_anytime_chunk", card=card, chunk=i, **step_rec)
        if step_rec["recall_at_10"] < IID_MIN_RECALL:
            raise AssertionError(f"u2 chunk {i}: recall "
                                 f"{step_rec['recall_at_10']}")
        del res, truth
    (fb, build_s), n_b = counted(lambda: sync_time(b.build))
    add_launches(launches, "u2_build", n_b)
    same = {k: bool(torch.equal(getattr(fb.arrays, k), getattr(f.arrays, k)))
            for k in ("r", "perm", "thr", "mgl", "mgh")}
    log("surface_u2_anytime", card=card, chunks=ANYTIME_CHUNKS, slack=ANYTIME_SLACK,
        queries=ANYTIME_QUERIES, **ANYTIME_SERVE, build_s=build_s,
        build_equals_batch=same)
    if not all(same.values()) or not torch.equal(fb.x, x):
        raise AssertionError(f"u2: build() differs from the batch build: "
                             f"{same}")
    del b, p, fb
    torch.cuda.empty_cache()


def surface_checkpoints(f, qd, launches, card):
    """(u3) ``save_forest`` / ``load_forest`` of phase 4's iid forest onto
    the card (arrays ``torch.equal``; repacked int8 with slack 8 and
    served with the kernel tail, bit-equal to the original), the per-tree
    blobs in order and reversed, and the refusal after ``add``.  Save,
    load and (de)serialise times are host-clock seconds."""
    import os
    import tempfile

    import torch

    import rptree_tpu_torch as rp

    names = ("r", "perm", "thr", "mgl", "mgh")

    def same_as(g, order=None):
        order = list(range(f.n_trees)) if order is None else order
        return all(torch.equal(getattr(g.arrays, k),
                               getattr(f.arrays, k)[order]) for k in names) \
            and torch.equal(g.x, f.x) and torch.equal(g.sq_norms, f.sq_norms)

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root) as td:
        path = os.path.join(td, "iid_100k.npz")
        _, save_s = sync_time(lambda: rp.save_forest(path, f))
        nbytes = os.path.getsize(path)
        g, load_s = sync_time(lambda: rp.load_forest(path, device=f.device))
        loaded_equal = same_as(g)
        serve = dict(budget=2, probes=10, tile_m=8, chunk=CHECKPOINT_QUERIES,
                     selection="kernel")
        q = qd[:CHECKPOINT_QUERIES]
        runs = {"traverse", "select_probes", "tile_tables",
                "grouped_score_tiles_int8", "topk_dedup_pairs"}
        truth = f.brute_force_knn(q[:1024], K)[1]
        want, n = counted(lambda: f.knn_grouped(q, K, **serve))
        check_ran("u3 original", n, runs)
        add_launches(launches, "u3_original_int8", n)
        rec, got = serve_variant("u3_loaded_int8", g, q, truth,
                                 dict(dtype=torch.int8, slack=8), serve,
                                 runs)
        add_launches(launches, "u3_loaded_int8", rec["launches"])
        served_equal = bits_equal(got, want)
        g.add(f.x[:1] + 0.5)
        try:
            rp.save_forest(os.path.join(td, "refused.npz"), g)
            refused = None
        except ValueError as e:
            refused = str(e)
        del g, got, want
    blobs, ser_s = sync_time(lambda: rp.serialise_rp_forest(f))
    g, des_s = sync_time(lambda: rp.deserialise_rp_forest(blobs,
                                                          device=f.device))
    blobs_equal = same_as(g)
    g = rp.deserialise_rp_forest(blobs[::-1], device=f.device)
    reversed_equal = same_as(g, list(range(f.n_trees))[::-1])
    del g
    log("surface_u3_checkpoints", card=card, bytes=nbytes, save_s=save_s,
        load_s=load_s, blob_bytes=sum(len(b) for b in blobs),
        serialise_s=ser_s, deserialise_s=des_s,
        clock="host (synchronised): compression and file reads included",
        loaded_equal=loaded_equal, served_bits_equal=served_equal,
        blobs_equal=blobs_equal, reversed_equal=reversed_equal,
        refused_after_add=refused, **rec)
    if not (loaded_equal and served_equal and blobs_equal and reversed_equal):
        raise AssertionError("u3: a checkpoint round trip differs")
    if refused is None:
        raise AssertionError("u3: save_forest after add() did not refuse")


def surface_tune_build(f, qd, launches, card):
    """(u4) ``rp.tune_build`` on the iid 100k rows, ``measure=False``, the
    iid cell's recall floor as the target: a forest configuration meets
    it."""
    import rptree_tpu_torch as rp

    (best, s), n = counted(lambda: sync_time(lambda: rp.tune_build(
        f.x, qd[:TUNE_QUERIES], K, IID_MIN_RECALL, device=f.device)))
    check_ran("u4 tune_build", n, {"traverse", "select_probes",
                                   "gather_score", "scan_topk"})
    add_launches(launches, "u4_tune_build", n)
    log("surface_u4_tune_build", card=card, target=IID_MIN_RECALL, tune_build_s=s,
        best={k: v for k, v in best.items() if k != "frontier"},
        grid=[(p["n_trees"], p["min_leaf"], p["recall"], p["met"])
              for p in best["frontier"]])
    if not best["met"] or best.get("scan"):
        raise AssertionError(f"u4 tune_build: no forest met "
                             f"{IID_MIN_RECALL}")


SIDE_QUERIES = 65_536        # (p1, p2, p6) one grouped chunk of phase 3's forest
SIDE_SERVE = dict(budget=1, probes=8, tile_m=8, chunk=SIDE_QUERIES,
                  selection="kernel")
SIDE_PAIR_SERVE = dict(budget=1, probes=8, precision="default", chunk=2048)
SIDE_FOLD = 1_000            # (p1) rows folded under rpt_insert
REGION_CALLS = 100_000       # (p1) region() entries timed, no profiler running
DEVICE_TIME_SLACK = 1.1      # (p2) device_time <= 1.1 x the host-clock median
INGEST_CHUNK = 25_000        # (p4) rows a chunk of fvecs_source
SIFT_ROWS, SIFT_DIM, SIFT_QUERIES = 20_000, 64, 256  # (p7) the original's data
# (kernel 1 writes each pair's row in place: no rpt_pair_reorder on f32)
QUERY_SCOPES = ("rpt_candidates", "rpt_tile_tables", "rpt_grouped_score",
                "rpt_topk_tail")
# (p1) each kernel of the grouped chunk by the names of its CUDA functions
TRACE_KERNELS = {
    "project_rows": ("project_kernel",),
    "traverse": ("traverse_regs", "traverse_warp", "traverse_wide"),
    "select_probes": ("probes_lanes", "probes_warp", "probes_merge"),
    "tile_tables": ("upsweep_kernel",),
    "grouped_score_tiles": ("grouped_score_kernel",),
    "topk_dedup_pairs": ("topk_pairs_kernel",),
}


def read_trace(logdir):
    """The Chrome trace that :func:`rptree_tpu_torch.profiling.trace` wrote
    into ``logdir``: ``(the range names, the CUDA kernel names, each
    range's summed span on the card in ms)``."""
    import os

    files = [n for n in os.listdir(logdir) if n.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"trace: {len(files)} traces in {logdir}")
    with open(os.path.join(logdir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    ranges, kernels, gpu_ms = set(), [], {}
    for e in events:
        cat = e.get("cat")
        if cat in ("user_annotation", "gpu_user_annotation"):
            ranges.add(e["name"])
        if cat == "gpu_user_annotation":
            gpu_ms[e["name"]] = gpu_ms.get(e["name"], 0.0) + e["dur"] / 1e3
        elif cat == "kernel":
            kernels.append(e["name"])
    return ranges, kernels, gpu_ms


def traced(name, fn, root, scopes):
    """``fn()`` under ``rp.profiling.trace`` (its outputs synchronised
    inside), and the trace read back: each of ``scopes`` must be a range
    in it.  Returns ``(result, kernel names, record)``; the record has
    each scope's summed CUDA time by ``key_averages()`` and its span on
    the card in the trace."""
    import os

    import torch

    import rptree_tpu_torch as rp

    logdir = os.path.join(root, name)
    with rp.profiling.trace(logdir) as prof:
        res = fn()
        outs = res if isinstance(res, tuple) else (res,)
        rp.profiling.sync(*[t for t in outs if torch.is_tensor(t)])
        torch.cuda.synchronize()  # a build or a fold returns no tensor
    ranges, kernels, gpu_ms = read_trace(logdir)
    missing = sorted(set(scopes) - ranges)
    if missing:
        raise AssertionError(f"{name}: scopes {missing} not in the trace")
    cuda_ms = {}
    for e in prof.key_averages():
        if e.key in scopes:
            total = getattr(e, "device_time_total", None)
            cuda_ms[e.key] = (e.cuda_time_total if total is None
                              else total) / 1e3
    return res, kernels, {
        "scopes_cuda_ms": {s: cuda_ms.get(s) for s in scopes},
        "scopes_span_ms": {s: gpu_ms.get(s) for s in scopes},
        "kernel_events": len(kernels)}


def region_host_us(calls=REGION_CALLS):
    """Host microseconds of one ``region()`` entry and exit with no
    profiler running."""
    from rptree_tpu_torch.utils.profiling import region

    t0 = time.perf_counter()
    for _ in range(calls):
        with region("rpt_candidates"):
            pass
    return (time.perf_counter() - t0) / calls * 1e6


def side_query_phase(f, qd, truth, launches, card):
    """Phase 12 on phase 3's forest (after 10a): (p1) traces of one
    grouped chunk (f32 blocks, kernel tail, 65,536 queries) and one
    per-pair ``knn_batched`` chunk, (p2) ``device_time`` of the grouped
    chunk against the host clock, (p6) a bf16 dataset of the same rows.
    Returns each step's host-clock seconds."""
    import os
    import tempfile

    import torch

    import rptree_tpu_torch as rp

    walk, probe, tables = "traverse", "select_probes", "tile_tables"
    f.pack_leaves()
    q = qd[:SIDE_QUERIES]
    grouped = {walk, probe, tables, "grouped_score_tiles",
               "topk_dedup_pairs"}
    # the checked call learns the tile capacity; the untraced twin
    f.knn_grouped(q, K, **SIDE_SERVE)
    plain = f.knn_grouped(q, K, check=False, **SIDE_SERVE)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as td:
        (got, kernels, rec), n = counted(lambda: traced(
            "p1_grouped", lambda: f.knn_grouped(q, K, check=False,
                                                **SIDE_SERVE),
            td, QUERY_SCOPES))
        check_ran("p1 grouped", n, grouped)
        add_launches(launches, "p1_trace_grouped", n)
        found = {k: sorted({e for e in kernels for s in subs if s in e})
                 for k, subs in TRACE_KERNELS.items()}
        if not all(found.values()):
            raise AssertionError(f"p1: kernels not in the trace: "
                                 f"{[k for k, v in found.items() if not v]}")
        if not bits_equal(got, plain):
            raise AssertionError("p1: the traced chunk differs from the "
                                 "untraced one")
        st = rp.profiling.stats()
        rec["topk_rows"] = {n: st[n] for n in ("topk.rows_one_read",
                                               "topk.rows_swept")}
        if rec["topk_rows"] != {"topk.rows_one_read": SIDE_QUERIES,
                                "topk.rows_swept": 0}:
            raise AssertionError(f"p1: kernel 3's rows by route "
                                 f"{rec['topk_rows']}, {SIDE_QUERIES} "
                                 "served")
        rec["topk_paths"] = {n: st[n] for n in ("topk.rows_second_prefix",
                                                "topk.rows_tie_overflow")}
        log("side_p1_trace_grouped", card=card, queries=SIDE_QUERIES,
            **SIDE_SERVE, bits_equal_untraced=True, kernels=found, **rec,
            region_host_us_no_profiler=region_host_us())
        qp = qd[:SIDE_PAIR_SERVE["chunk"]]
        (_, _, rec), n = counted(lambda: traced(
            "p1_per_pair", lambda: f.knn_batched(qp, K, **SIDE_PAIR_SERVE),
            td, ("rpt_candidates", "rpt_rerank", "rpt_topk_tail")))
        check_ran("p1 per pair", n, {walk, probe, "gather_score"})
        add_launches(launches, "p1_trace_per_pair", n)
        log("side_p1_trace_per_pair", card=card, **SIDE_PAIR_SERVE, **rec)

    steps = {"p1_traces_s": time.perf_counter() - t0}
    t0 = time.perf_counter()

    # (p2) device_time of the grouped chunk beside the host clock
    def step(qq):
        return f.knn_grouped(qq, K, check=False, **SIDE_SERVE)

    (dt, host), n = counted(lambda: (
        rp.device_time(step, q, reps=20),
        float(np.median([sync_time(lambda: step(q))[1] for _ in range(7)]))))
    check_ran("p2 device_time", n, grouped)
    add_launches(launches, "p2_device_time", n)
    log("side_p2_device_time", card=card, device_time_ms=dt * 1e3,
        host_clock_median_ms=host * 1e3, ratio=dt / host,
        limit=DEVICE_TIME_SLACK)
    if not 0 < dt <= DEVICE_TIME_SLACK * host:
        raise AssertionError(f"p2: device_time {dt} s against the host "
                             f"clock's {host} s")
    steps["p2_device_time_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    side_bf16(f, qd, truth, launches, card)
    steps["p6_bf16_s"] = time.perf_counter() - t0
    return steps


def side_bf16(f, qd, truth, launches, card):
    """(p6) ``forest_batch(dtype=torch.bfloat16)`` on phase 3's rows: the
    trees of an f32 build over the bf16-rounded rows, packed (bf16 blocks)
    and served grouped with the kernel tail, recall@10 >= 0.90 against its
    own exact scan; ``save_forest`` / ``load_forest`` bit-equal."""
    import os
    import tempfile

    import torch

    import rptree_tpu_torch as rp

    cfg = f.config
    args = (SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
            cfg.proj_nz_density)
    (fb, build_s), n = counted(lambda: sync_time(lambda: rp.forest_batch(
        *args, f.x, dtype=torch.bfloat16, device=f.device)))
    check_ran("p6 build", n, {"project_rows"})
    add_launches(launches, "p6_bf16_build", n)
    xr = f.x.to(torch.bfloat16).float()
    fr, n = counted(lambda: rp.forest_batch(*args, xr, device=f.device))
    add_launches(launches, "p6_f32_rounded_build", n)
    names = ("r", "perm", "thr", "mgl", "mgh")
    same = {k: bool(torch.equal(getattr(fb.arrays, k), getattr(fr.arrays, k)))
            for k in names}
    if fb.x.dtype != torch.bfloat16 or fb.sq_norms.dtype != torch.bfloat16 \
            or not torch.equal(fb.x.float(), xr) or not all(same.values()):
        raise AssertionError(f"p6: the bf16 build differs from the f32 "
                             f"build over the rounded rows: {same}")
    nr = truth.shape[0]
    # its own exact scan (fp32 products, the stored bf16 norms), and the
    # f32 scan of the rounded rows with f32 norms beside it
    own = fb.brute_force_knn(qd[:nr], K)[1]
    f32_norms = fr.brute_force_knn(qd[:nr], K)[1]
    del fr, xr
    q = qd[:SIDE_QUERIES]
    rec, res = serve_variant(
        "p6_bf16_dataset", fb, q, own, {}, SIDE_SERVE,
        {"traverse", "select_probes", "tile_tables",
         "grouped_score_tiles_bf16", "topk_dedup_pairs"})
    add_launches(launches, "p6_bf16_dataset", rec["launches"])
    ids = res[1][:nr]
    rec["recall_vs_f32_norms_scan"] = recall(ids, f32_norms)
    rec["recall_vs_phase3_truth"] = recall(ids, truth)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root) as td:
        path = os.path.join(td, "clustered_1m_bf16.npz")
        _, save_s = sync_time(lambda: rp.save_forest(path, fb))
        with np.load(path, allow_pickle=False) as z:
            stored = str(z["x"].dtype)
        g, load_s = sync_time(lambda: rp.load_forest(path, device=f.device))
        nbytes = os.path.getsize(path)
    loaded = (g.x.dtype == torch.bfloat16
              and torch.equal(g.x.view(torch.int16), fb.x.view(torch.int16))
              and torch.equal(g.sq_norms.view(torch.int16),
                              fb.sq_norms.view(torch.int16))
              and all(torch.equal(getattr(g.arrays, k), getattr(fb.arrays, k))
                      for k in names))
    del g
    d = res[0]
    log("side_p6_bf16", card=card, build_s=build_s, trees_equal=same,
        distances_dtype=str(d.dtype), checkpoint_x=stored, bytes=nbytes,
        save_s=save_s, load_s=load_s, loaded_bits_equal=loaded, **rec)
    if d.dtype != torch.float32 or stored != "|V2" or not loaded:
        raise AssertionError("p6: f32 distances, a |V2 checkpoint and a "
                             "bit-equal load expected")
    if rec["recall_at_10"] < CLUSTERED_MIN_RECALL:
        raise AssertionError(f"p6: recall {rec['recall_at_10']} < "
                             f"{CLUSTERED_MIN_RECALL}")
    del fb
    torch.cuda.empty_cache()


def side_layers_phase(f, device, launches, card):
    """Phase 12 on phase 4's iid forest (after 10b): (p1) traces of a
    build of its rows and of a fold of 1,000 rows, (p3) the demo, (p4)
    ingest, (p5) ``bench_grid(REFERENCE_SCALE_GRID)``, (p7) the examples.
    Returns each step's host-clock seconds."""
    import os
    import tempfile

    import torch

    import rptree_tpu_torch as rp

    cfg = f.config
    args = (SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
            cfg.proj_nz_density)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as td:
        # (p1) the build's and the fold's regions
        (fb, _, rec_b), n = counted(lambda: traced(
            "p1_build", lambda: rp.forest_batch(*args, f.x, device=device),
            td, ("rpt_project", "rpt_partition_at_median")))
        check_ran("p1 build", n, {"project_rows"})
        add_launches(launches, "p1_trace_build", n)
        fb.pack_leaves(slack=8)
        gen = torch.Generator(device=device).manual_seed(SEED + 12)
        fb.add(torch.randn(SIDE_FOLD, f.dim, generator=gen, device=device))
        (_, _, rec_f), n = counted(lambda: traced(
            "p1_fold", fb.fold, td, ("rpt_insert",)))
        check_ran("p1 fold", n, set(), may={"project_rows"})
        add_launches(launches, "p1_trace_fold", n)
        log("side_p1_trace_build_fold", card=card, build=rec_b, fold=rec_f,
            folded=fb.n_folded, pending=fb.n_pending)
        del fb
        steps = {"p1_build_fold_s": time.perf_counter() - t0}
        for name, step in (
                ("p3_demo_s", lambda: side_demo(td, device, launches, card)),
                ("p4_ingest_s", lambda: side_ingest(f, td, args, device,
                                                    launches, card))):
            t0 = time.perf_counter()
            step()
            steps[name] = time.perf_counter() - t0
    for name, step in (
            ("p5_bench_s", lambda: side_bench(device, launches, card)),
            ("p7_examples_s", lambda: side_examples(device, card))):
        t0 = time.perf_counter()
        step()
        steps[name] = time.perf_counter() - t0
    return steps


def side_demo(td, device, launches, card):
    """(p3) ``rptree_tpu_torch.demo.main`` on the card into a temporary
    directory: its four files, 10,000 rows each (the knn files plus
    their hits, labelled -1), a labelled dot leaf per plan leaf."""
    import os

    from rptree_tpu_torch import demo
    from rptree_tpu_torch.models.plan import make_plan

    out = os.path.join(td, "demo")
    (_, s), n = counted(lambda: sync_time(lambda: demo.main(out,
                                                            device=device)))
    check_ran("p3 demo", n, {"traverse"}, may={"select_probes"})
    add_launches(launches, "p3_demo", n)
    rows = {}
    for name in ("scatter.csv", "knn.csv", "knn_h.csv"):
        with open(os.path.join(out, name)) as fh:
            labels = [line.rsplit(",", 1)[1] for line in fh.read().split()]
        rows[name] = (len(labels), labels.count("-1"))
    with open(os.path.join(out, "tree.dot")) as fh:
        dot = fh.read()
    leaves = make_plan(demo.N, demo.MAX_DEPTH, demo.MIN_LEAF).n_leaves
    log("side_p3_demo", card=card, demo_s=s, rows=rows,
        dot_leaves=dot.count("label="), plan_leaves=leaves)
    if rows["scatter.csv"] != (demo.N, 0) or dot.count("label=") != leaves \
            or any(rows[k][0] - rows[k][1] != demo.N or rows[k][1] < 1
                   for k in ("knn.csv", "knn_h.csv")):
        raise AssertionError(f"p3: demo files {rows}, dot leaves "
                             f"{dot.count('label=')} of {leaves}")


def side_ingest(f, td, args, device, launches, card):
    """(p4) the native reader: phase 4's rows written with ``write_fvecs``
    read back equal, and ``rp.forest`` over ``fvecs_source`` equal to
    phase 4's batch build."""
    import os

    import torch

    import rptree_tpu_torch as rp

    ingest = rp.ingest
    if not ingest.native_available():
        raise AssertionError("p4: the native ingest library did not load")
    path = os.path.join(td, "iid_100k.fvecs")
    ingest.write_fvecs(path, f.x)
    t0 = time.perf_counter()
    back = ingest.read_fvecs(path)
    read_s = time.perf_counter() - t0
    equal = bool(torch.equal(torch.from_numpy(back), f.x.cpu()))
    (fs, s), n = counted(lambda: sync_time(lambda: rp.forest(
        *args[:4], INGEST_CHUNK, args[4], f.dim,
        ingest.fvecs_source(path, chunk_size=INGEST_CHUNK), device=device)))
    check_ran("p4 stream", n, {"project_rows"})
    add_launches(launches, "p4_fvecs_stream", n)
    same = {k: bool(torch.equal(getattr(fs.arrays, k), getattr(f.arrays, k)))
            for k in ("r", "perm", "thr", "mgl", "mgh")}
    mb = os.path.getsize(path) / 1e6
    log("side_p4_ingest", card=card, native=True, bytes=int(mb * 1e6),
        read_s=read_s, read_mb_s=mb / read_s, read_equal=equal,
        stream_build_s=s, chunk=INGEST_CHUNK, trees_equal=same)
    if not equal or not all(same.values()) or not torch.equal(fs.x, f.x):
        raise AssertionError(f"p4: ingest round trip {equal}, trees {same}")


def side_bench(device, launches, card):
    """(p5) ``bench_grid(REFERENCE_SCALE_GRID)`` on the card: all five
    configurations (dense, sparse ELL, streaming) served, recall > 0."""
    from rptree_tpu_torch import benchmarks

    (res, s), n = counted(lambda: sync_time(lambda: benchmarks.bench_grid(
        benchmarks.REFERENCE_SCALE_GRID, device=device)))
    check_ran("p5 bench_grid", n, {"traverse", "select_probes",
                                   "gather_score", "ell_score_tiles"})
    add_launches(launches, "p5_bench_grid", n)
    rows = [{k: v for k, v in r.items() if k != "config"} for r in res]
    log("side_p5_bench_grid", card=card, seconds=s, results=rows)
    if len(rows) != 5 or not all(r["recall_at_10"] > 0 for r in rows):
        raise AssertionError(f"p5: {rows}")


def side_examples(device, card):
    """(p7) ``examples/torch_sift_pipeline.py`` on three files that
    ``write_fvecs`` / ``write_ivecs`` made (the original's 20,000 x 64
    synthetic rows), then ``examples/torch_clustered_scatter.py``, each a
    process of its own on the card; each must exit 0."""
    import os
    import tempfile

    import torch

    import rptree_tpu_torch as rp

    root = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(7)
    xb = rng.normal(size=(SIFT_ROWS, SIFT_DIM)).astype(np.float32)
    xq = (xb[rng.integers(0, SIFT_ROWS, SIFT_QUERIES)]
          + 0.05 * rng.normal(size=(SIFT_QUERIES, SIFT_DIM)).astype(
              np.float32))
    xd, qd = torch.as_tensor(xb, device=device), torch.as_tensor(xq,
                                                                 device=device)
    gt = torch.cdist(qd, xd).topk(K, largest=False).indices
    env = {**os.environ, "RPTREE_EXAMPLE_FAST": "1"}
    out = {}
    with tempfile.TemporaryDirectory(dir=root) as td:
        files = [os.path.join(td, n) for n in ("base.fvecs", "query.fvecs",
                                               "gt.ivecs")]
        rp.ingest.write_fvecs(files[0], xb)
        rp.ingest.write_fvecs(files[1], xq)
        rp.ingest.write_ivecs(files[2], gt)
        # both at once: each process spends seconds reaching the card
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, os.path.join(root, "examples", name + ".py"),
             *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=root)
            for name, argv in (("torch_sift_pipeline", files),
                               ("torch_clustered_scatter", [td]))}
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[name] = {"rc": p.returncode, "s": time.perf_counter() - t0,
                         "tail": stdout.strip().splitlines()[-2:]}
            if p.returncode != 0:
                raise AssertionError(f"p7 {name}: rc {p.returncode}\n"
                                     f"{stdout[-2000:]}{stderr[-4000:]}")
    log("side_p7_examples", card=card, **out)


# -- phase 13: the tree- and query-sharded forests --------------------------

SHARDED_RECALL_GAP = 0.001       # (d2) against (a)'s recall
SHARDED_H_QUERIES = 16_384       # (d3) knn_h
SHARDED_PAIR = dict(budget=1, precision="default", chunk=2048)   # (f)'s
SHARDED_ADD = 2_000              # 13b: points added, then folded
SHARDED_UPDATE_QUERIES = 8_192


def one_card_mesh(device, tree, query):
    """A ``tree x query`` mesh of one card repeated: the port's stand-in
    for a mesh of several cards, whose shards' launches then run in
    turn."""
    from rptree_tpu_torch.parallel import forest_mesh

    return forest_mesh(tree, query, devices=[device] * (tree * query))


def bits_differ(got, want):
    """Entries whose distance bits differ between two ``(dists, ids)``."""
    import torch

    return int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum())


def sharded_clustered_phase(f, qd, truth, out, launches, card):
    """Phase 13a on phase 3's clustered 1M forest, four shards on the one
    card: (d1) ``forest_batch_distributed`` on ``forest_mesh(4, 1)``, its
    trees ``torch.equal`` to phase 3's; (d2) its blocks leaf-sharded
    (f32) and served grouped at phase 3's settings with the kernel tail
    and with ``kernel_topk``, each held against (a) / (c): distances
    within 1e-4 relative (their differing bits counted), ids equal
    outside near-ties, recall within 0.001 of (a)'s; (d3) ``distribute``
    onto ``forest_mesh(2, 2)``, tree-sharded f32 blocks, per pair against
    (f), then ``knn_h`` (the global bucket stop) against the forest's own
    on 16,384 queries.  QPS beside the single-device variant's."""
    import torch

    from rptree_tpu_torch.parallel import distribute, forest_batch_distributed

    t_phase = time.perf_counter()
    dev, cfg = f.device, f.config
    walk, probe, tables = "traverse", "select_probes", "tile_tables"
    # (d1) the tree-parallel build
    (fd, build_s), n = counted(lambda: sync_time(
        lambda: forest_batch_distributed(
            SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
            cfg.proj_nz_density, f.x, mesh=one_card_mesh(dev, 4, 1))))
    check_ran("d1 build", n, {"project_rows"})
    add_launches(launches, "d1_sharded_build", n)
    same = {k: bool(torch.equal(getattr(fd.arrays, k), getattr(f.arrays, k)))
            for k in ("r", "perm", "thr", "mgl", "mgh")}
    if not all(same.values()):
        raise AssertionError(f"d1: sharded trees differ from phase 3's: "
                             f"{same}")
    if fd.x.data_ptr() != f.x.data_ptr():
        raise AssertionError("d1: the sharded forest copied the dataset")
    log("sharded_d1_build", card=card, shards=4, build_s=build_s,
        trees_equal=same, dataset_shared=True)
    # (d2) leaf-sharded f32 blocks, grouped
    serve = dict(budget=1, probes=8, tile_m=8, chunk=65536)
    n_truth = truth.shape[0]
    a_recall = recall(out["a"][1][:n_truth], truth)
    for name, extra, twin, runs in (
            ("d2_leaf_f32_kernel_tail", {"selection": "kernel"}, "a",
             {walk, probe, tables, "grouped_score_tiles",
              "topk_dedup_pairs"}),
            ("d2_leaf_f32_kernel_topk", {"selection": "sort",
                                         "impl": "kernel_topk"}, "c",
             {walk, probe, tables, "grouped_score_topk"}),
            # a shard's kernel 4 under the kernel tail: the ids form of
            # kernel 3 on kernel 4's output
            ("d2_leaf_f32_kernel_topk_kernel_tail",
             {"selection": "kernel", "impl": "kernel_topk"}, "c",
             {walk, probe, tables, "grouped_score_topk",
              "topk_dedup_kernel"})):
        rec, res = serve_variant(name, fd, qd, truth, dict(shard_by="leaf"),
                                 {**serve, **extra}, runs, per_chunk=4)
        add_launches(launches, name, rec["launches"])
        rec["same_as_untied_ids"] = close_results(name, res, out[twin])
        rec["bits_differ"] = bits_differ(res, out[twin])
        rec["single_device_qps"] = out["qps"][twin]
        log(f"sharded_{name}", card=card, twin=twin, shards=4, **rec,
            a_recall_at_10=a_recall)
        if abs(rec["recall_at_10"] - a_recall) > SHARDED_RECALL_GAP:
            raise AssertionError(f"{name}: recall {rec['recall_at_10']} vs "
                                 f"(a)'s {a_recall}")
        del res
    del fd
    torch.cuda.empty_cache()
    # (d3) tree-sharded f32 blocks on the 2 x 2 mesh: per pair, then knn_h
    f.pack_leaves()
    fd = distribute(f, one_card_mesh(dev, 2, 2))
    _, pack_s = sync_time(lambda: fd.pack_leaves(shard_by="tree"))
    name = "d3_tree_f32_per_pair"
    calls = 2 * 2 * -(-(qd.shape[0] // 2) // SHARDED_PAIR["chunk"])
    res, s, n = counted_calls(name, lambda: fd.knn_batched(
        qd, K, **SHARDED_PAIR), dict.fromkeys(
            {walk, probe, "gather_score"}, calls), 2)
    check_result(name, res, qd.shape[0])
    add_launches(launches, name, n)
    log(f"sharded_{name}", card=card, mesh="2x2", **SHARDED_PAIR,
        pack_s=pack_s, queries=qd.shape[0], serve_s=s,
        qps=qd.shape[0] / s, single_device_qps=out["qps"]["f"],
        recall_at_10=recall(res[1][:n_truth], truth),
        same_as_f_untied_ids=close_results(name, res, out["f"]),
        bits_differ=bits_differ(res, out["f"]))
    del res
    qh = qd[:SHARDED_H_QUERIES]
    name = "d3_tree_knn_h"
    (got, s), n = counted(lambda: sync_time(lambda: fd.knn_h(qh, K,
                                                             budget=1)))
    check_ran(name, n, {walk, "gather_score"})
    add_launches(launches, name, n)
    (want, s1), n1 = counted(lambda: sync_time(lambda: f.knn_h(qh, K,
                                                               budget=1)))
    check_ran(f"{name} single device", n1, {walk, probe, "gather_score"})
    check_result(name, got, qh.shape[0])
    log(f"sharded_{name}", card=card, mesh="2x2", queries=qh.shape[0],
        budget=1, serve_s=s, qps=qh.shape[0] / s,
        single_device_qps=qh.shape[0] / s1,
        same_as_single_untied_ids=close_results(name, got, want),
        bits_differ=bits_differ(got, want))
    del fd, got, want
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


def sharded_iid_phase(f, qd, served, serve, truth, launches, card):
    """Phase 13b on phase 4's iid 100k forest, ``forest_mesh(4, 1)`` on the
    one card: leaf-sharded int8 blocks with slack 8, served as phase 4
    serves (kernels 2 and 3) and held against phase 4's result; then
    2,000 points added to it and to a single-device twin built and packed
    alike (its trees ``torch.equal`` to phase 4's): 8,192 queries with the
    points pending at ``precision="default"`` (the pending merge through
    kernel 5), ``fold``, ``recall_with`` (within 1e-6) and the served
    result after the fold, each held against the twin's."""
    import torch

    import rptree_tpu_torch as rp
    from rptree_tpu_torch.parallel import distribute

    t_phase = time.perf_counter()
    walk, probe, tables = "traverse", "select_probes", "tile_tables"
    runs = {walk, probe, tables, "grouped_score_tiles_int8",
            "topk_dedup_pairs"}
    pack = dict(dtype=torch.int8, slack=8)
    fd = distribute(f, one_card_mesh(f.device, 4, 1))
    name = "d4_iid_int8_leaf"
    rec, res = serve_variant(name, fd, qd, truth, {**pack, "shard_by": "leaf"},
                             serve, runs, per_chunk=4)
    add_launches(launches, name, rec["launches"])
    rec["same_as_phase4_untied_ids"] = close_results(name, res, served[:2])
    rec["bits_differ"] = bits_differ(res, served[:2])
    log(f"sharded_{name}", card=card, shards=4, **rec,
        single_device_qps=served[2])
    del res
    cfg = f.config
    twin = rp.forest_batch(SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
                           cfg.proj_nz_density, f.x, device=f.device)
    if not torch.equal(twin.arrays.perm, f.arrays.perm):
        raise AssertionError("13b: the twin's trees differ from phase 4's")
    twin.pack_leaves(**pack)
    rng = np.random.default_rng(SEED + 13)
    new = torch.as_tensor(rng.normal(size=(SHARDED_ADD, f.dim)).astype(
        np.float32), device=f.device)
    q = qd[:SHARDED_UPDATE_QUERIES]
    steps = {}
    for g in (fd, twin):
        g.add(new)
    pend = {**serve, "chunk": SHARDED_UPDATE_QUERIES, "precision": "default"}
    name = "d4_pending"
    (got, s), n = counted(lambda: sync_time(lambda: fd.knn_grouped(
        q, K, **pend)))
    check_ran(name, n, runs | {"scan_topk"})
    add_launches(launches, name, n)
    steps["pending_same_untied_ids"] = close_results(
        name, got, twin.knn_grouped(q, K, **pend))
    steps["pending_serve_s"] = s
    (_, steps["fold_s"]), n = counted(lambda: sync_time(fd.fold))
    add_launches(launches, "d4_fold", n)
    twin.fold()
    if fd.n_folded != twin.n_folded or fd.n_pending != twin.n_pending:
        raise AssertionError(f"13b: folded {fd.n_folded} / {twin.n_folded}")
    (rec_d, recall_s), n = counted(lambda: sync_time(
        lambda: fd.recall_with(q[:1024], K)))
    add_launches(launches, "d4_recall_with", n)
    gap = float((rec_d - twin.recall_with(q[:1024], K)).abs().max())
    if gap > 1e-6:
        raise AssertionError(f"13b: recall_with differs by {gap}")
    (got, s), n = counted(lambda: sync_time(lambda: fd.knn_grouped(
        q, K, **{**serve, "chunk": SHARDED_UPDATE_QUERIES})))
    check_ran("d4_folded", n, runs)
    add_launches(launches, "d4_folded", n)
    steps["folded_same_untied_ids"] = close_results(
        "d4_folded", got, twin.knn_grouped(
            q, K, **{**serve, "chunk": SHARDED_UPDATE_QUERIES}))
    log("sharded_d4_updates", card=card, added=SHARDED_ADD,
        folded=fd.n_folded, pending=fd.n_pending,
        recall_with_mean=float(rec_d.mean()), recall_with_gap=gap,
        recall_with_s=recall_s, folded_serve_s=s, **steps)
    del fd, twin, got
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


# -- phase 14: the data-parallel forests --------------------------------------

DP_SHARDS = 4
DP_BF_QUERIES = 1_024            # (e3) the sharded scan
DP_STREAM_CHUNKS = 16            # (e5)
DP_MP_QUERIES = 1_024            # (e8) the two-process run's queries
DP_ADD = 2_000                   # (e9)
DP_UPDATE_QUERIES = 8_192


def one_card_data_mesh(device, shards=DP_SHARDS):
    """A data mesh of ``shards`` shards of one card."""
    from rptree_tpu_torch.parallel import data_mesh

    return data_mesh(devices=[device] * shards)


def leaf_keys(f):
    """Each tree's ``(leaf, point)`` pairs as sorted int64 keys ``[T, N]``:
    equal for two forests exactly where every leaf holds the same points
    (whatever their order within it)."""
    import torch

    plan, n = f.plan, f.plan.n
    leaf = torch.as_tensor(np.repeat(np.arange(plan.n_leaves),
                                     plan.leaf_len), device=f.device)
    return torch.sort(leaf[None] * n + f.arrays.perm.long(), dim=1).values


def same_trees(name, got, want):
    """``got``'s thresholds and margins bit-equal to ``want``'s on every
    level's live segments and every leaf ``want``'s point set, else it
    raises; returns the comparison's record."""
    import torch

    for key in ("thr", "mgl", "mgh"):
        a, b = getattr(got.arrays, key), getattr(want.arrays, key)
        for lvl, lp in enumerate(want.plan.levels):
            if not torch.equal(a[:, lvl, :lp.n_segs], b[:, lvl, :lp.n_segs]):
                raise AssertionError(f"{name}: {key} differs at level {lvl}")
    if not torch.equal(leaf_keys(got), leaf_keys(want)):
        raise AssertionError(f"{name}: a leaf holds other points")
    return {"thresholds_margins_bit_equal": True, "leaf_sets_equal": True}


def profiled_kernels(fn):
    """``(fn(), CUDA kernels launched)`` by ``torch.profiler`` (None where
    it records no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return res, n or None


def shard_bytes(f):
    """Bytes a shard: its dataset rows, its packed blocks (rows, norms, ids
    and scales) or slot tables (local rows, global ids, norms)."""
    def nbytes(t):
        return t.numel() * t.element_size()

    rows = nbytes(f.x.parts[0])
    out = {"rows_bytes": rows}
    if f._packed is None:
        return out
    blocks, sq, ids = f._packed
    tables = nbytes(sq.parts[0]) + nbytes(ids.parts[0])
    if hasattr(blocks, "rows"):  # shared rows: the row store is the dataset
        out["slot_table_bytes"] = tables + nbytes(blocks.ids.parts[0])
    else:
        out["block_bytes"] = nbytes(blocks.parts[0]) + tables + (
            nbytes(f._block_scale.parts[0]) if f._block_scale is not None
            else 0)
    return out


def dp_clustered_phase(f, qd, truth, out, launches, card):
    """Phase 14a on phase 3's clustered 1M forest, four data shards on the
    one card: (e1) the build, (e2) leaf-sharded f32 blocks grouped like (a)
    and (c), (e3) the sharded exact scan, (e4) ``recall_with``, (e5) the
    streamed build onto the data mesh."""
    import torch

    import rptree_tpu_torch as rp
    from rptree_tpu_torch.parallel import (brute_force_knn_sharded,
                                           forest_batch_data_parallel)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dev, cfg = f.device, f.config
    mesh = one_card_data_mesh(dev)
    walk, probe, tables = "traverse", "select_probes", "tile_tables"
    args = (SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
            cfg.proj_nz_density)

    def dp_build():
        return forest_batch_data_parallel(*args, f.x, mesh=mesh,
                                          r=f.arrays.r)

    def one_build():
        return rp.forest_batch(*args, f.x, device=dev, r=f.arrays.r)

    # (e1) the build, its seconds and launches against one device's
    (fd, build_s), n = counted(lambda: sync_time(dp_build))
    check_ran("e1 build", n, {"project_rows"})
    add_launches(launches, "e1_dataparallel_build", n)
    _, one_s = sync_time(one_build)
    _, dp_kernels = profiled_kernels(dp_build)
    _, one_kernels = profiled_kernels(one_build)
    trees = same_trees("e1", fd, f)
    if any(p.data_ptr() != f.x[i * p.shape[0]:].data_ptr()
           for i, p in enumerate(fd.x.parts)):
        raise AssertionError("e1: the shards copied the dataset")
    log("dataparallel_e1_build", card=card, shards=DP_SHARDS,
        build_s=build_s, single_device_build_s=one_s,
        project_rows_launches=n["project_rows"],
        cuda_kernels=dp_kernels, single_device_cuda_kernels=one_kernels,
        kernels_by="torch.profiler", dataset_views=True, **trees)
    # (e2) leaf-sharded f32 blocks packed from the sharded rows, grouped
    serve = dict(budget=1, probes=8, tile_m=8, chunk=65536)
    a_recall = recall(out["a"][1][:truth.shape[0]], truth)
    for name, extra, twin, runs in (
            ("e2_dp_f32_kernel_tail", {"selection": "kernel"}, "a",
             {walk, probe, tables, "grouped_score_tiles",
              "topk_dedup_pairs"}),
            ("e2_dp_f32_kernel_topk", {"selection": "sort",
                                       "impl": "kernel_topk"}, "c",
             {walk, probe, tables, "grouped_score_topk"})):
        rec, res = serve_variant(name, fd, qd, truth, {}, {**serve, **extra},
                                 runs, per_chunk=DP_SHARDS)
        add_launches(launches, name, rec["launches"])
        rec["same_as_untied_ids"] = close_results(name, res, out[twin])
        rec["bits_differ"] = bits_differ(res, out[twin])
        rec["single_device_qps"] = out["qps"][twin]
        log(f"dataparallel_{name}", card=card, twin=twin, shards=DP_SHARDS,
            **rec, a_recall_at_10=a_recall, **shard_bytes(fd))
        if abs(rec["recall_at_10"] - a_recall) > SHARDED_RECALL_GAP:
            raise AssertionError(f"{name}: recall {rec['recall_at_10']} vs "
                                 f"(a)'s {a_recall}")
        del res
    # (e3) the sharded exact scan, (e4) recall_with
    q = qd[:DP_BF_QUERIES]
    (got, bf_s), n = counted(lambda: sync_time(lambda: (
        brute_force_knn_sharded(f.x, q, K, mesh=mesh))))
    check_ran("e3 scan", n, set())
    want, one_bf_s = sync_time(lambda: f.brute_force_knn(q, K))
    checked = close_results("e3_sharded_scan", got, want)
    (rec_d, recall_s), n = counted(lambda: sync_time(
        lambda: fd.recall_with(q, K)))
    add_launches(launches, "e4_dp_recall_with", n)
    gap = float((rec_d - f.recall_with(q, K)).abs().max())
    if gap > 1e-6:
        raise AssertionError(f"e4: recall_with differs by {gap}")
    log("dataparallel_e3_e4", card=card, queries=q.shape[0],
        scan_s=bf_s, single_device_scan_s=one_bf_s, scan_untied_ids=checked,
        scan_bits_differ=bits_differ(got, want), recall_with_gap=gap,
        recall_with_s=recall_s, recall_with_mean=float(rec_d.mean()))
    del fd, got, want
    torch.cuda.empty_cache()
    # (e5) the rows streamed in 16 chunks onto the data mesh
    n_rows, dim = f.x.shape
    step = -(-n_rows // DP_STREAM_CHUNKS)

    def stream():
        b = rp.ForestBuilder(*args[:4], cfg.proj_nz_density, dim, mesh=mesh)
        for s in range(0, n_rows, step):
            b.insert_chunk(f.x[s:s + step])
        return b.build()

    (fs, stream_s), n = counted(lambda: sync_time(stream))
    check_ran("e5 stream", n, {"project_rows"})
    add_launches(launches, "e5_dp_stream_build", n)
    fb = dp_build()
    same = {k: bool(torch.equal(getattr(fs.arrays, k).view(torch.int32),
                                getattr(fb.arrays, k).view(torch.int32)))
            for k in ("r", "perm", "thr", "mgl", "mgh")}
    if not all(same.values()):
        raise AssertionError(f"e5: the streamed trees differ: {same}")
    log("dataparallel_e5_stream", card=card, chunks=DP_STREAM_CHUNKS,
        chunk_rows=step, stream_build_s=stream_s, trees_bit_equal=same,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        phase_s=time.perf_counter() - t_phase)
    del fs, fb
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


def dp_iid_phase(f, qd, served, serve, truth, launches, card):
    """Phase 14b on phase 4's iid 100k forest: (e6) the data-parallel trees
    and int8 blocks with slack 8 served as phase 4 serves them, (e7) the
    sharded checkpoint reloaded onto two shards, (e8) the two-process
    build, (e9) the updates against a single-device twin."""
    import importlib.util
    import os
    import tempfile

    import torch

    import rptree_tpu_torch as rp
    from rptree_tpu_torch.parallel import forest_batch_data_parallel

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dev, cfg = f.device, f.config
    args = (SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
            cfg.proj_nz_density)
    runs = {"traverse", "select_probes", "tile_tables",
            "grouped_score_tiles_int8", "topk_dedup_pairs"}
    pack = dict(dtype=torch.int8, slack=8)
    # (e6)
    (fd, build_s), n = counted(lambda: sync_time(
        lambda: forest_batch_data_parallel(*args, f.x,
                                           mesh=one_card_data_mesh(dev))))
    add_launches(launches, "e6_dp_iid_build", n)
    trees = same_trees("e6", fd, f)
    name = "e6_dp_iid_int8"
    rec, res = serve_variant(name, fd, qd, truth, pack, serve, runs,
                             per_chunk=DP_SHARDS)
    add_launches(launches, name, rec["launches"])
    rec["same_as_phase4_untied_ids"] = close_results(name, res, served[:2])
    rec["bits_differ"] = bits_differ(res, served[:2])
    log(f"dataparallel_{name}", card=card, shards=DP_SHARDS, build_s=build_s,
        **trees, **rec, single_device_qps=served[2], **shard_bytes(fd))
    del res
    # (e7) the sharded checkpoint, reloaded onto two shards
    root = os.path.dirname(os.path.abspath(__file__))
    q = qd[:DP_UPDATE_QUERIES]
    chunked = {**serve, "chunk": DP_UPDATE_QUERIES}
    want = fd.knn_grouped(q, K, **chunked)
    with tempfile.TemporaryDirectory(dir=root) as td:
        _, save_s = sync_time(lambda: rp.save_forest_sharded(td, fd))
        nbytes = sum(os.path.getsize(os.path.join(td, p))
                     for p in os.listdir(td))
        g, load_s = sync_time(lambda: rp.load_forest_sharded(
            td, one_card_data_mesh(dev, 2)))
    g.pack_leaves(**pack)
    got, n = counted(lambda: g.knn_grouped(q, K, **chunked))
    check_ran("e7 reloaded", n, runs)
    add_launches(launches, "e7_dp_reloaded_int8", n)
    checked = same_results("e7_reloaded", got, want)
    log("dataparallel_e7_checkpoint", card=card, files=DP_SHARDS + 1,
        bytes=nbytes, save_s=save_s, load_s=load_s, reloaded_shards=2,
        served_bits_equal=True, untied_ids=checked,
        clock="host (synchronised): compression and file reads included")
    del g, got
    # (e8) two processes, two shards of the card each, each its own rows
    spec = importlib.util.spec_from_file_location(
        "torch_multihost_bench",
        os.path.join(root, "examples", "torch_multihost_bench.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    qm = qd[:DP_MP_QUERIES]
    mp_serve = {**serve, "chunk": DP_MP_QUERIES}
    t0 = time.perf_counter()
    records, mp = example.run(
        f.x.cpu().numpy(), nproc=2, shards=2, device=str(dev), seed=SEED,
        depth=cfg.max_depth, min_leaf=cfg.min_leaf, trees=cfg.n_trees,
        pnz=cfg.proj_nz_density, queries=qm.cpu().numpy(), k=K, budget=1,
        pack={"dtype": "int8", "slack": 8}, serve=mp_serve, timeout=300,
        tmp_root=root)
    mp_s = time.perf_counter() - t0
    if not np.array_equal(mp["perm"], fd.arrays.perm.cpu().numpy()):
        raise AssertionError("e8: the two-process perm differs")
    one = fd.knn_grouped(qm, K, **mp_serve)
    mp_res = (torch.as_tensor(mp["dists_grouped"], device=dev),
              torch.as_tensor(mp["ids_grouped"], device=dev))
    checked = close_results("e8_two_process_grouped", mp_res, one)
    if len({(r["thr_sha"], r["perm_sha"]) for r in records}) != 1 or not all(
            r["jax_free"] for r in records):
        raise AssertionError(f"e8: the processes disagree: {records}")
    log("dataparallel_e8_two_processes", card=card, processes=2,
        shards_each=2, backend="gloo (collectives staged through the host: "
        "a stand-in for NCCL, which refuses two ranks on one card)",
        perm_equal=True, grouped_untied_ids=checked,
        grouped_bits_differ=bits_differ(mp_res, one), wall_s=mp_s,
        processes_records=records)
    # (e9) updates against a single-device twin
    twin = rp.forest_batch(*args, f.x, device=dev)
    twin.pack_leaves(**pack)
    rng = np.random.default_rng(SEED + 14)
    new = torch.as_tensor(rng.normal(size=(DP_ADD, f.dim)).astype(
        np.float32), device=dev)
    for g in (fd, twin):
        g.add(new)
    pend = {**chunked, "precision": "default"}
    steps = {}
    (got, s), n = counted(lambda: sync_time(lambda: fd.knn_grouped(
        q, K, **pend)))
    check_ran("e9 pending", n, runs | {"scan_topk"})
    add_launches(launches, "e9_dp_pending", n)
    steps["pending_same_untied_ids"] = close_results(
        "e9_pending", got, twin.knn_grouped(q, K, **pend))
    steps["pending_serve_s"] = s
    (_, steps["fold_s"]), n = counted(lambda: sync_time(fd.fold))
    add_launches(launches, "e9_dp_fold", n)
    twin.fold()
    if fd.n_folded != twin.n_folded or fd.n_pending != twin.n_pending:
        raise AssertionError(f"e9: folded {fd.n_folded} / {twin.n_folded}")
    (rec_d, recall_s), n = counted(lambda: sync_time(
        lambda: fd.recall_with(q[:1024], K)))
    add_launches(launches, "e9_dp_recall_with", n)
    gap = float((rec_d - twin.recall_with(q[:1024], K)).abs().max())
    if gap > 1e-6:
        raise AssertionError(f"e9: recall_with differs by {gap}")
    (got, s), n = counted(lambda: sync_time(lambda: fd.knn_grouped(
        q, K, **chunked)))
    check_ran("e9 folded", n, runs)
    add_launches(launches, "e9_dp_folded", n)
    steps["folded_same_untied_ids"] = close_results(
        "e9_folded", got, twin.knn_grouped(q, K, **chunked))
    steps["folded_bits_differ"] = bits_differ(
        got, twin.knn_grouped(q, K, **chunked))
    log("dataparallel_e9_updates", card=card, added=DP_ADD,
        folded=fd.n_folded, pending=fd.n_pending, recall_with_gap=gap,
        recall_with_s=recall_s, folded_serve_s=s, **steps,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        phase_s=time.perf_counter() - t_phase)
    del fd, twin, got
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


def dp_shared_10m(f, x, q, truth, res_p, rec_p, launches, card):
    """Phase 14c, inside phase 8b on its 10M rows: (e10) the data-parallel
    build over views of them, its trees phase 8b's; shared rows from the
    sharded dataset (``all_probes``), served per pair (the sort tail) and
    grouped (the kernel tail), against phase 8b's per-pair result."""
    import torch

    from rptree_tpu_torch.parallel import forest_batch_data_parallel

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = f.config
    walk, probe = "traverse", "select_probes"
    (fd, build_s), n = counted(lambda: sync_time(
        lambda: forest_batch_data_parallel(
            SEED, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
            cfg.proj_nz_density, x, mesh=one_card_data_mesh(x.device),
            r=f.arrays.r)))
    check_ran("e10 build", n, {"project_rows"})
    add_launches(launches, "e10_dp_10m_build", n)
    trees = same_trees("e10", fd, f)
    _, pack_s = sync_time(lambda: fd.pack_leaves(store="shared"))
    if not fd._shared_all_probes:
        raise AssertionError("e10: the shared pack did not set all_probes")
    g_blocks, lmax, dim = f._packed[0].shape
    lmax_loc = int(fd._packed[0].ids.parts[0].shape[1])
    pair = dict(budget=1, probes=8, precision="default", chunk=8192)
    grouped = dict(budget=1, probes=8, precision="default", chunk=8192,
                   tile_m=16, selection="kernel")
    name = "e10_dp_shared_10m_per_pair_sort"
    chunks = -(-q.shape[0] // pair["chunk"]) * DP_SHARDS
    res, s, n = counted_calls(name, lambda: fd.knn_batched(q, K, **pair),
                              dict.fromkeys({walk, probe,
                                             "gather_score_shared"}, chunks),
                              3)
    check_result(name, res, q.shape[0])
    add_launches(launches, name, n)
    per_pair = {"qps": q.shape[0] / s, "serve_s": s,
                "recall_at_10": recall(res[1][:truth.shape[0]], truth)}
    name = "e10_dp_shared_10m_grouped_kernel"
    rec_g, res_g = serve_variant(name, fd, q, truth, dict(store="shared"),
                                 grouped, {walk, probe, "tile_tables",
                                           "topk_dedup_pairs"},
                                 per_chunk=DP_SHARDS)
    add_launches(launches, name, rec_g.pop("launches"))
    rec_s = {}
    for name, rec, got in (("per_pair_sort", per_pair, res),
                           ("grouped_kernel", rec_g, res_g)):
        rec["same_as_8b_per_pair_untied_ids"] = close_results(name, got,
                                                              res_p)
        rec["bits_differ"] = bits_differ(got, res_p)
        rec_s[name] = rec
        if abs(rec["recall_at_10"] - rec_p["recall_at_10"]) > \
                SHARDED_RECALL_GAP:
            raise AssertionError(f"e10 {name}: recall {rec} vs phase "
                                 f"8b's {rec_p['recall_at_10']}")
    del res, res_g
    log("dataparallel_e10_shared_10m", card=card, shards=DP_SHARDS,
        build_s=build_s, pack_s=pack_s, **trees, lmax=int(lmax),
        lmax_loc=lmax_loc, **shard_bytes(fd),
        blocked_t8_bytes=g_blocks * lmax * dim * 4,
        blocked_t8_bytes_a_shard=g_blocks * lmax * dim * 4 // DP_SHARDS,
        single_device_shared_table_bytes=2 * g_blocks * lmax * 4,
        served=rec_s, single_device_per_pair_qps=rec_p["qps"],
        single_device_recall_at_10=rec_p["recall_at_10"],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        phase_s=time.perf_counter() - t_phase)
    del fd
    torch.cuda.empty_cache()
    return time.perf_counter() - t_phase


# -- phase 15: the examples -------------------------------------------------

EXAMPLE_TIMEOUT = 600           # seconds an example may take
# the stationary stream up to 80% folded: fold-only within 0.02 of the
# rebuild, and each at least 0.99 of the fp32 scan's neighbours (the JAX
# example's table, BASELINE.md "Fold drift, measured", reads 0.999-1.000)
FOLD_SAFE_GAP, FOLD_SAFE_UP_TO, FOLD_MIN_RECALL = 0.02, 0.80, 0.99
SCAN_LADDER_MIN = {"highest": 0.999, "bf16": 0.98}
_NUM = r"([-+]?\d+(?:\.\d+)?)"


def _arg_key(v, tensor=None):
    """A hashable key of a kernel argument's shape, cheap enough for every
    call: a tensor (``tensor``, ``torch.Tensor``) by its shape and type, a
    tuple by its parts, a plain value by itself, an object (a plan,
    shared rows, ELL blocks: each made once a forest) by its identity."""
    if isinstance(v, tensor):
        return v.shape, v.dtype
    if isinstance(v, tuple):
        return tuple(_arg_key(u, tensor) for u in v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return type(v).__name__, id(v)


def _same_bits(name, got, want):
    """Each output tensor of a kernel equal to the plain version's, floats
    as bits."""
    import torch

    for i, (a, w) in enumerate(zip(got, want)):
        if a.is_floating_point():
            a, w = a.view(torch.int32), w.view(torch.int32)
        if a.dtype != w.dtype or not torch.equal(a, w):
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 "version")
    return 0.0


def _check_pairs(a, got):
    import torch

    from rptree_tpu_torch.ops import grouped_kernel as gk

    name = "grouped_score_pairs"
    a = {k: v for k, v in a.items() if k != "reads"}
    want = gk.grouped_score_pairs_reference(**a)
    if a["metric"] == "l2":  # held by its square, as the sql2 form is
        got, want = got * got, want * want
    # each pair's row against |x|^2 + |q|^2 of its block and query
    nt, m = a["tb"].shape[0], a["tile_m"]
    e, b = a["slot"].shape[0], a["q"].shape[0]
    tile = (a["slot"] // m).clamp(0, max(0, nt - 1))
    blk = a["tb"][tile].long() if nt else tile
    scale = a["sq_leaf"][blk] + (a["q"] * a["q"]).sum(-1).repeat_interleave(
        e // max(1, b))[:, None]
    _rel_err(got, want)  # masking must agree
    fin = torch.isfinite(want)
    err = float(((got - want).abs()[fin] / scale[fin]).max()) \
        if bool(fin.any()) else 0.0
    if err > SUM_RTOL:
        raise AssertionError(f"{name}: squared distances off by {err} of "
                             f"|x|^2 + |q|^2 > {SUM_RTOL}")
    return err


def _within(name, got, want, rtol=DIST_RTOL):
    abs_err, rel_err = _rel_err(got, want)
    if rel_err > rtol:
        raise AssertionError(f"{name}: relative error {rel_err} > {rtol}")
    return abs_err


def _check_gather(a, got):
    import torch

    from rptree_tpu_torch.ops import fused_gather as fg

    dots, sqx = fg.gather_score_reference(**a)
    if not torch.equal(got[1], sqx):
        raise AssertionError("gather_score: slot norms differ")
    return _within("gather_score", got[0], dots)


def _check_scan(a, got):
    from rptree_tpu_torch.ops import scan as sc

    if a["rows"] is None:
        want = sc._partial_reference(a["x"], a["sq"], a["q"], a["k"],
                                     a["metric"])
    else:
        want = sc._partial_reference_rows(a["rows"], a["q"], a["k"],
                                          a["metric"])
    close_results("scan_topk", got, want)
    return _rel_err(got[0], want[0])[0]


def _check_ell(a, got):
    from rptree_tpu_torch.ops import ell_kernel as ek

    # the queries are documents' rows, near their own band (by_norms)
    return ell_agree("ell_score_tiles", got,
                     ek.ell_score_tiles_reference(**a), a["sq_leaf"],
                     a["qq"], a["tb"], a["tp"], a["p"], a["metric"],
                     by_norms=True)[0]


def example_checks():
    """The function that launches each kernel the examples reach, by its
    module and name, and its check against the plain version on the
    arguments of a launch: ``{kernel: (module, name, check)}``; a check
    takes the bound arguments and the kernel's output, raises where they
    disagree and returns the largest absolute error."""
    from rptree_tpu_torch.ops import build as ob
    from rptree_tpu_torch.ops import ell_kernel as ek
    from rptree_tpu_torch.ops import fused_gather as fg
    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops import grouped_kernel as gk
    from rptree_tpu_torch.ops import scan as sc
    from rptree_tpu_torch.ops import topk_kernel as tk
    from rptree_tpu_torch.ops import traverse as tv

    def bits(name, ref):
        return lambda a, got: _same_bits(name, got, ref(**a))

    return {
        "project_rows": (ob, "project_rows", lambda a, got:
                         project_within_bound("project_rows", a["x"],
                                              a["r"], got)[0]),
        "traverse": (tv, "traverse_kernel",
                     bits("traverse", tv.traverse_tree_reference)),
        "select_probes": (tv, "select_probes",
                          bits("select_probes", tv.select_probes_reference)),
        "tile_tables": (og, "tile_tables",
                        bits("tile_tables", og.tile_tables_reference)),
        # kernel 1 on the serving path: the pair form
        "grouped_score_tiles": (gk, "grouped_score_pairs", _check_pairs),
        "topk_dedup_kernel": (tk, "topk_dedup_kernel", bits(
            "topk_dedup_kernel", tk.topk_dedup_kernel_reference)),
        "topk_dedup_pairs": (tk, "topk_dedup_pairs", lambda a, got: _same_bits(
            "topk_dedup_pairs", got, tk.topk_dedup_pairs_reference(
                a["d"], a["id_leaf"], a["rows_sel"], a["k"], a["dedup"]))),
        "gather_score": (fg, "gather_score", _check_gather),
        "scan_topk": (sc, "_scan_partial", _check_scan),
        "ell_score_tiles": (ek, "ell_score_tiles", _check_ell),
    }


def hook_example_checks():
    """Wrap each function of :func:`example_checks` wherever the port holds
    it, so that its first launch at each shape of its arguments is held
    against the plain version (outside any sync-debug mode the caller
    set, whose syncs are the check's, not the port's).  The wrapper takes
    over the function's launch counts, as the function adds to them by
    its module's name.  Returns ``{kernel: {"shapes", "max_abs_err"}}``,
    filled as the example runs."""
    import functools
    import inspect

    import torch

    import rptree_tpu_torch  # noqa: F401  (every module the facade loads)

    seen = {}
    for kname, (mod, attr, check) in example_checks().items():
        fn = getattr(mod, attr)
        rec = seen[kname] = {"shapes": 0, "max_abs_err": 0.0, "keys": set()}
        sig = inspect.signature(fn)

        def hooked(*args, _fn=fn, _sig=sig, _check=check, _rec=rec,
                   **kwargs):
            out = _fn(*args, **kwargs)
            key = _arg_key((args, tuple(sorted(kwargs.items()))),
                           torch.Tensor)
            if key in _rec["keys"]:
                return out
            _rec["keys"].add(key)
            a = _sig.bind(*args, **kwargs)
            a.apply_defaults()
            if any(torch.is_tensor(v) and v.is_cuda
                   for v in a.arguments.values()):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode(0)
                try:
                    err = _check(dict(a.arguments), out)
                    torch.cuda.synchronize()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                _rec["shapes"] += 1
                _rec["max_abs_err"] = max(_rec["max_abs_err"], float(err))
            return out

        functools.update_wrapper(hooked, fn)
        for m in list(sys.modules.values()):
            if (getattr(m, "__name__", "") or "").startswith(
                    "rptree_tpu_torch"):
                for k, v in list(vars(m).items()):
                    if v is fn:
                        setattr(m, k, hooked)
    return seen


def example_child(name, argv):
    """Run ``examples/<name>.py`` with ``argv`` as ``__main__`` in this
    process, as ``python examples/<name>.py`` runs it (its directory
    first on ``sys.path``), with every kernel's launch count set to 0
    just before it and each kernel's launches held against its plain
    version at each new shape (:func:`hook_example_checks`); then print
    the checks as one ``EXAMPLE_CHECKS`` line and the counts as one
    ``EXAMPLE_LAUNCHES`` line."""
    import runpy

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", name + ".py")
    sys.argv = [path, *argv]
    sys.path.insert(0, os.path.dirname(path))
    checks = hook_example_checks()
    counts = kernel_counts()
    for wrapper, attr in counts.values():
        setattr(wrapper, attr, 0)
    runpy.run_path(path, run_name="__main__")
    print("EXAMPLE_CHECKS " + json.dumps(
        {k: {"shapes": r["shapes"], "max_abs_err": r["max_abs_err"]}
         for k, r in checks.items()}), flush=True)
    print("EXAMPLE_LAUNCHES " + json.dumps(
        {kname: getattr(wrapper, attr)
         for kname, (wrapper, attr) in counts.items()}), flush=True)


def run_example(name, must, launches):
    """:func:`example_child` at the example's defaults in a process of its
    own on the card; returns ``(its printed lines, seconds)``.  It must
    exit 0 and launch every kernel of ``must``; its counts join
    ``launches``."""
    env = {k: v for k, v in os.environ.items()
           if k != "RPTREE_EXAMPLE_DEVICE"}
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--example", name],
        capture_output=True, text=True, env=env,
        timeout=EXAMPLE_TIMEOUT, cwd=os.path.dirname(os.path.abspath(
            __file__)))
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"examples {name}: rc {p.returncode}\n"
                             f"{p.stdout[-3000:]}{p.stderr[-5000:]}")
    lines = p.stdout.rstrip().splitlines()
    counts = json.loads(lines[-1].split(" ", 1)[1])
    checks = json.loads(lines[-2].split(" ", 1)[1])
    add_launches(launches, f"examples_{name}", counts)
    missing = sorted(k for k in must if counts[k] < 1)
    if missing:
        raise AssertionError(f"examples {name}: {missing} never launched")
    # a kernel that launched was held against its plain version
    for kname, n in counts.items():
        base = kname.split("_bf16")[0].split("_shared")[0]
        if n and checks.get(base, {}).get("shapes", 0) < 1:
            raise AssertionError(f"examples {name}: {kname} launched "
                                 "unchecked")
    return lines[:-2], seconds, {k: r for k, r in checks.items()
                                 if r["shapes"]}


def _match(pattern, lines, what):
    import re

    found = [m for m in (re.search(pattern, line) for line in lines) if m]
    if not found:
        raise AssertionError(f"examples: no line {what!r} ({pattern})")
    return found


# what a host sync leaves in a torch.profiler trace: a CUDA runtime
# *Synchronize call, a copy to the host, a scalar read
SYNC_EVENTS = ("Synchronize", "Memcpy DtoH", "aten::_local_scalar_dense",
               "aten::item")


def check_false_trace(device, card, n=262144, centers=1024, bq=32768):
    """``knn_grouped(check=False)``, a batch and a chunked call of 4, after
    a checked call at each shape, under ``torch.profiler`` (CPU and CUDA
    activities) on a clustered forest of ``n`` rows (the serving loop's
    T, ``min_leaf``, budget and probes): the events inside their range
    must hold none of ``SYNC_EVENTS``, a check that, unlike
    ``set_sync_debug_mode``, sees every CUDA runtime call.  A range that
    reads one scalar back is the control: its sync must show.  Logs the
    events seen in each range and outside them (the profiler's own)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import rptree_tpu_torch as rp

    x, q = clustered_on_card(n, 128, centers, 0.15, 4 * bq, device)
    cfg = rp.rp_tree_cfg(128, n, 128)
    f = rp.forest_batch(SEED, cfg.max_depth, 128, 8, cfg.proj_nz_density, x,
                        device=device)
    f.pack_leaves()
    kw = dict(budget=1, probes=8, precision="default", tile_m=8)
    f.knn_grouped(q[:bq], K, check=True, **kw)
    f.knn_grouped(q, K, check=True, chunk=bq, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("check_false_calls"):
            f.knn_grouped(q[:bq], K, check=False, **kw)
            f.knn_grouped(q, K, check=False, chunk=bq, **kw)
        with record_function("control_scalar_read"):
            int(x[:1, 0].sum())
    torch.cuda.synchronize()
    events = prof.events()
    # the ranges on the host's clock (each also has a span on the card's,
    # which runs on past the host's while the kernels drain)
    spans = {e.name: e.time_range for e in events
             if e.name in ("check_false_calls", "control_scalar_read")
             and e.device_type == torch.autograd.DeviceType.CPU}

    def where(e):
        return next((name for name, r in spans.items()
                     if r.start <= e.time_range.start <= r.end), "outside")

    syncs = collections.defaultdict(collections.Counter)
    runtime = collections.Counter()
    for e in events:
        if e.name.startswith(("cuda", "cu")):
            runtime[where(e)] += 1
        if any(s in e.name for s in SYNC_EVENTS):
            syncs[where(e)][e.name] += 1
    rec = {"card": card, "rows": n, "batch": bq, "chunked_batches": 4,
           "sync_events": {k: dict(v) for k, v in syncs.items()},
           "runtime_calls": dict(runtime),
           "copies": {k: c for k, c in collections.Counter(
               e.name for e in events if where(e) == "check_false_calls"
               and "Memcpy" in e.name).items()}}
    log("examples_check_false_trace", **rec)
    if syncs.get("check_false_calls") or not runtime["check_false_calls"] \
            or not syncs.get("control_scalar_read"):
        raise AssertionError(f"check=False trace: {rec}")
    del f, x, q
    torch.cuda.empty_cache()


def examples_phase(device, launches, card):
    """Phase 15: the seven examples of queue 1 item [24], one after
    another (their QPS are recorded, so never two at once), each held to
    its floor, after :func:`check_false_trace`; returns the phase's
    seconds."""
    t_phase = time.perf_counter()
    check_false_trace(device, card)
    rec = {}
    for name, (must, check) in EXAMPLES.items():
        lines, s, held = run_example(name, must, launches)
        rec[name] = {"seconds": s, "lines": lines, "card": card,
                     "kernels_held_at_shapes": held, **check(lines)}
        log(f"examples_{name[len('torch_'):]}", **rec[name])
    seconds = time.perf_counter() - t_phase
    log("examples", card=card, seconds=seconds,
        example_seconds={n: r["seconds"] for n, r in rec.items()})
    return seconds


def _example_clustered_1m(lines):
    rows, shape = [], None
    for line in lines:
        if "built+packed" in line:
            shape = line.split(":")[0]
        elif line.strip().startswith("budget="):
            b, p, qps, r = _match(
                rf"budget={_NUM} probes={_NUM}: {_NUM} QPS @ recall {_NUM}",
                [line], "budget")[0].groups()
            rows.append({"shape": shape, "budget": int(b), "probes": int(p),
                         "qps": float(qps), "recall_at_10": float(r)})
    scan_qps, scan_rec = map(float, _match(
        rf"^scan: {_NUM} QPS @ recall {_NUM}", lines, "scan")[0].groups())
    pinned = [r for r in rows if r["shape"] == "T=8 ml=128 f32"
              and (r["budget"], r["probes"]) == (1, 8)]
    if len(rows) != 9 or not pinned or \
            pinned[0]["recall_at_10"] < CLUSTERED_MIN_RECALL:
        raise AssertionError(f"clustered_1m: {rows}")
    return {"rows": rows, "scan_qps": scan_qps, "scan_recall_at_10": scan_rec,
            "pinned_recall_at_10": pinned[0]["recall_at_10"],
            "floor": CLUSTERED_MIN_RECALL}


def _example_serving_loop(lines):
    qps = {m.group(1): float(m.group(2)) for m in _match(
        rf"^(sync|depth=\d+|chunked):\s+{_NUM} QPS wall", lines, "QPS")}
    over = _match(r"overflow=(True|False)$", lines, "overflow")[0].group(1)
    if over != "False" or set(qps) != {"sync", "depth=2", "depth=4",
                                       "chunked"}:
        raise AssertionError(f"serving_loop: overflow {over}, {qps}")
    return {"qps": qps, "overflow": False,
            "check_false_sync_debug_mode":
                "error: no sync detected by set_sync_debug_mode"}


def _example_scale_10m(lines):
    paths = {m.group(1): (float(m.group(2)), float(m.group(3))) for m in
             _match(rf"^(per-pair knn_batched(?: selection=kernel)?|grouped "
                    rf"knn_grouped): {_NUM} QPS wall @ recall {_NUM}",
                    lines, "paths")}
    peak = max(float(m.group(1)) for m in _match(rf"peak={_NUM} GB", lines,
                                                 "peak"))
    if len(paths) != 3 or min(r for _, r in paths.values()) < \
            SHARED_MIN_RECALL:
        raise AssertionError(f"scale_10m: {paths}")
    return {"qps_recall": paths, "peak_gib": peak,
            "floor": SHARED_MIN_RECALL}


def _example_bow_sparse(lines):
    paths = {m.group(1): (float(m.group(2)), float(m.group(3))) for m in
             _match(rf"^(per-pair knn_batched|grouped knn_grouped|grouped "
                    rf"SPARSE queries): {_NUM} QPS wall @ recall {_NUM}",
                    lines, "paths")}
    scan = float(_match(rf"^exact sparse scan: {_NUM} QPS", lines,
                        "scan")[0].group(1))
    if len(paths) != 3 or min(r for _, r in paths.values()) < \
            SPARSE_MIN_RECALL:
        raise AssertionError(f"bow_sparse: {paths}")
    return {"qps_recall": paths, "scan_qps": scan, "floor": SPARSE_MIN_RECALL,
            "jax_recall": JAX_SPARSE_RECALL}


def _example_scale_1m(lines):
    build = float(_match(rf"^build device {_NUM}s", lines, "build")[0]
                  .group(1))
    ms, qps = map(float, _match(rf"^query device {_NUM}ms per \d+ queries "
                                rf"\({_NUM} QPS/chip\)", lines,
                                "query")[0].groups())
    rec = float(_match(rf"^recall@10 = {_NUM}", lines, "recall")[0].group(1))
    if not rec > 0:
        raise AssertionError(f"scale_1m: recall {rec}")
    return {"build_device_s": build, "query_device_ms": ms, "qps": qps,
            "recall_at_10": rec}


def _example_fold_drift(lines):
    step = (rf"folded\s+{_NUM}%\s+pending\s+{_NUM}\s+recall fold-only "
            rf"{_NUM}\s+rebuilt {_NUM}")
    split = lines.index("drifting stream (centers random-walk):")
    streams = {name: [dict(zip(("folded_pct", "pending", "fold_only",
                                "rebuilt"), map(float, m.groups())))
                      for m in _match(step, part, name)]
               for name, part in (("stationary", lines[:split]),
                                  ("drifting", lines[split:]))}
    bad = [r for r in streams["stationary"]
           if r["folded_pct"] <= 100 * FOLD_SAFE_UP_TO
           and (abs(r["rebuilt"] - r["fold_only"]) > FOLD_SAFE_GAP
                or min(r["rebuilt"], r["fold_only"]) < FOLD_MIN_RECALL)]
    if len(streams["stationary"]) != 5 or bad:
        raise AssertionError(f"fold_drift: {streams}")
    return {"streams": streams, "gap_limit": FOLD_SAFE_GAP,
            "floor": FOLD_MIN_RECALL}


def _example_scan_ladder(lines):
    rungs = {m.group(1): (float(m.group(2)), float(m.group(3))) for m in
             _match(rf"^\s+(xla scan precision=\w+|cuda scan_topk)\s+{_NUM} "
                    rf"QPS\s+recall@10 {_NUM}", lines, "rungs")}
    highest = rungs.get("xla scan precision=highest", (0, 0))[1]
    bf16 = [r for n, (_, r) in rungs.items() if "highest" not in n]
    if len(rungs) != 4 or highest < SCAN_LADDER_MIN["highest"] or \
            min(bf16) < SCAN_LADDER_MIN["bf16"]:
        raise AssertionError(f"scan_ladder: {rungs}")
    return {"qps_recall": rungs, "floors": SCAN_LADDER_MIN}


# name: (kernels its run must launch, the check of its printed lines)
EXAMPLES = {
    "torch_clustered_1m": ({"project_rows", "traverse", "select_probes",
                            "gather_score", "scan_topk"},
                           _example_clustered_1m),
    "torch_serving_loop": ({"project_rows", "traverse", "select_probes",
                            "tile_tables", "grouped_score_tiles"},
                           _example_serving_loop),
    "torch_scale_10m": ({"project_rows", "traverse", "select_probes",
                         "gather_score_shared", "topk_dedup_pairs",
                         "tile_tables", "scan_topk"}, _example_scale_10m),
    "torch_bow_sparse": ({"project_rows", "traverse", "select_probes",
                          "tile_tables", "ell_score_tiles"},
                         _example_bow_sparse),
    "torch_scale_1m": ({"project_rows", "traverse", "select_probes",
                        "gather_score_bf16"}, _example_scale_1m),
    "torch_fold_drift": ({"project_rows", "traverse", "select_probes",
                          "gather_score"}, _example_fold_drift),
    "torch_scan_ladder": ({"scan_topk"}, _example_scan_ladder),
}


def main():
    import torch

    if len(sys.argv) > 2 and sys.argv[1] == "--example":
        return example_child(sys.argv[2], sys.argv[3:])
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    import rptree_tpu_torch as rp
    from rptree_tpu_torch import _cuda

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, build_s, _ = _cuda.build()
    _cuda.lib()
    log("setup", device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        kernel_build_s=build_s)

    kern = check_kernels(device)
    for name, rec in kern.items():
        log("kernel", name=name, **rec)
    launches = dict.fromkeys(kernel_counts(), 0)

    # -- phase 3: clustered 1M --------------------------------------------
    x, q = clustered_data(1_000_000, 128, 4_000, 0.15, 131_072)
    f, qd, truth, cell = build_cell(x, q, 128, 8, device)
    del x, q
    log("clustered_1m", **cell)
    n_truth = truth.shape[0]
    walk, probe, tables = "traverse", "select_probes", "tile_tables"
    unpacked, s, n = counted_calls(
        "clustered_unpacked", lambda: f.knn(qd[:n_truth], K, budget=1),
        {walk: 1}, n_calls=1)
    check_result("clustered_unpacked", unpacked, n_truth)
    add_launches(launches, "clustered_unpacked", n)
    log("clustered_1m_unpacked", queries=n_truth, budget=1, serve_s=s,
        recall_at_10=recall(unpacked[1], truth))
    # unpacked knn at its default budget (32: kernel 7's shared-memory route)
    wide, s, n = counted_calls(
        "clustered_unpacked_b32", lambda: f.knn(qd[:n_truth], K), {walk: 1},
        n_calls=1)
    check_result("clustered_unpacked_b32", wide, n_truth)
    add_launches(launches, "clustered_unpacked_b32", n)
    log("clustered_1m_unpacked_b32", queries=n_truth, budget=f._budget(None),
        serve_s=s, recall_at_10=recall(wide[1], truth),
        kernel7_chunk=check_descent_chunk(f, qd[:n_truth], f._budget(None)))
    serve = dict(budget=1, probes=8, tile_m=8, chunk=65536)
    bf16 = dict(dtype=torch.bfloat16)
    tiles, tiles_bf16, topk, topk_tiles = (
        "grouped_score_tiles", "grouped_score_tiles_bf16",
        "topk_dedup_pairs", "grouped_score_topk")
    out = {}
    serve_grouped((  # (name, pack, serve, the kernels it runs, recall floor)
        ("a_f32_kernel_tail", {}, {**serve, "selection": "kernel"},
         {walk, probe, tables, tiles, topk}, CLUSTERED_MIN_RECALL),
        ("b_f32_sort_tail", {}, {**serve, "selection": "sort",
                                 "impl": "kernel"},
         {walk, probe, tables, tiles}, CLUSTERED_MIN_RECALL),
        ("c_f32_kernel_topk", {}, {**serve, "selection": "sort",
                                   "impl": "kernel_topk"},
         {walk, probe, tables, topk_tiles}, CLUSTERED_MIN_RECALL),
    ), f, qd, truth, launches, out)
    # kernels 7 and 8 on the served chunk's own forest and queries
    log("clustered_1m_descent", **check_descent_chunk(
        f, qd[:serve["chunk"]], serve["budget"], serve["probes"]))
    # (f) the per-pair path on the same f32 blocks, bench.py's setting
    rec, out["f"] = per_pair_phase(
        "f_f32_per_pair", f, qd, truth,
        dict(budget=1, probes=8, precision="default", chunk=2048),
        {walk, probe, "gather_score"}, 4, launches)
    rec["same_as_b_untied_ids"] = close_results("f_f32_per_pair", out["f"],
                                                out["b"])
    rec["unpacked_same_untied_ids"] = close_results(
        "clustered_unpacked", unpacked,
        (out["f"][0][:n_truth], out["f"][1][:n_truth]))
    log("clustered_1m_f_f32_per_pair", **rec,
        jax_recall=JAX_RECALL["clustered"])
    out["qps"]["f"] = rec["qps"]
    if rec["recall_at_10"] < CLUSTERED_MIN_RECALL:
        raise AssertionError(f"per-pair recall {rec['recall_at_10']}")
    xla_variants(f, qd, truth, serve, launches, out)
    log("clustered_1m_kernel9_chunk", **check_tables_chunk(
        f, qd[:serve["chunk"]], serve, kern, "clustered_chunk_own_pairs"))
    serve_grouped((
        ("d_bf16_sort_tail", bf16, {**serve, "selection": "sort",
                                    "impl": "kernel"},
         {walk, probe, tables, tiles_bf16}, BF16_MIN_RECALL),
        ("e_bf16_kernel_topk", bf16, {**serve, "selection": "sort",
                                      "impl": "kernel_topk"},
         {walk, probe, tables, topk_tiles}, BF16_MIN_RECALL),
    ), f, qd, truth, launches, out)
    scan_phase("clustered_1m_scan", f, qd[:16384], truth, 2048,
               SCAN_MIN_RECALL["clustered"], launches,
               JAX_RECALL["clustered_scan"])
    # -- phase 10a: the user surface on this forest (u1, u4, u5) -----------
    t_surface = time.perf_counter()
    surface_stream(f, qd, truth, out, launches, card)
    surface_tune(f, qd, launches, card)
    surface_generators(device, card)
    surface_s = time.perf_counter() - t_surface
    torch.cuda.empty_cache()
    # -- phase 12a: the side layers on this forest (p1, p2, p6) -----------
    t_side = time.perf_counter()
    side_steps = side_query_phase(f, qd, truth, launches, card)
    side_s = time.perf_counter() - t_side
    # -- phase 13a: the sharded forests on this forest --------------------
    sharded_s = sharded_clustered_phase(f, qd, truth, out, launches, card)
    # -- phase 14a: the data-parallel forests on this forest --------------
    dataparallel_s = dp_clustered_phase(f, qd, truth, out, launches, card)
    # -- phase 8a: the other dense layouts on this forest, before phase 7
    # repacks it --------------------------------------------------------
    layouts_phase(f, qd, truth, out, launches, kern)
    # phase 7 takes up this forest and its queries again
    f_clustered, qd_clustered = f, qd
    del f, qd, truth, out, unpacked, wide
    torch.cuda.empty_cache()

    # -- phase 4: iid 100k, int8 blocks -----------------------------------
    x, q = iid_data(100_000, 128, 65_536)
    f, qd, truth, cell = build_cell(x, q, 64, 8, device)
    del x, q
    iid_serve = dict(budget=2, probes=10, tile_m=8, chunk=32768,
                     selection="kernel")
    rec, iid_res = serve_variant("iid", f, qd, truth,
                                 dict(dtype=torch.int8, slack=8), iid_serve,
                           {walk, probe, tables, "grouped_score_tiles_int8",
                            "topk_dedup_pairs"})
    add_launches(launches, "iid_100k_int8", rec["launches"])
    # kernel 2 on the first chunk's own tiles (launches here are not counted)
    rec["kernel2_chunk"] = check_tiles_chunk(f, qd[:iid_serve["chunk"]],
                                             iid_serve)
    rec["kernels7_8_chunk"] = check_descent_chunk(
        f, qd[:iid_serve["chunk"]], iid_serve["budget"], iid_serve["probes"])
    rec["kernel9_chunk"] = check_tables_chunk(
        f, qd[:iid_serve["chunk"]], iid_serve, kern, "iid_chunk_own_pairs")
    log("iid_100k_int8", **cell, **rec, jax_recall=JAX_RECALL["iid"])
    if rec["recall_at_10"] < IID_MIN_RECALL:
        raise AssertionError(f"iid recall {rec['recall_at_10']} < "
                             f"{IID_MIN_RECALL}")
    # -- phase 13b: the sharded forests on this forest ---------------------
    sharded_s += sharded_iid_phase(f, qd, (*iid_res, rec["qps"]), iid_serve,
                                   truth, launches, card)
    log("sharded", card=card, seconds=sharded_s)
    # -- phase 14b: the data-parallel forests on this forest --------------
    dataparallel_s += dp_iid_phase(f, qd, (*iid_res, rec["qps"]), iid_serve,
                                   truth, launches, card)
    del iid_res

    # -- phase 5: the iid 100k bracket (bench.py's >= 0.9 recall points) --
    xd = f.x
    f_iid, qd_iid = f, qd  # phase 7 takes them up again
    del f
    torch.cuda.empty_cache()
    n, dim = xd.shape
    cfg = rp.rp_tree_cfg(4096, n, dim)
    fq, build_q_s = sync_time(lambda: rp.forest_batch(
        SEED, cfg.max_depth, 4096, 32, cfg.proj_nz_density, xd,
        device=device))
    _, pack_q_s = sync_time(lambda: fq.pack_leaves(dtype=torch.bfloat16))
    lmax_q = fq.plan.max_leaf_len
    chunk_q = 1 << int(np.log2(max(32, (1 << 21) // max(32 * lmax_q, 1))))
    rec, _ = per_pair_phase(
        "bracket_tree", fq, qd[:8192], truth,
        dict(budget=2, probes=32, precision="default", chunk=chunk_q),
        {walk, probe, "gather_score_bf16"}, 2, launches)
    log("iid_100k_bracket_tree", trees=32, min_leaf=4096,
        depth=cfg.max_depth, leaves=fq.plan.n_leaves, build_s=build_q_s,
        pack_s=pack_q_s, **rec, jax_recall=JAX_RECALL["bracket_tree"],
        kernels7_8_chunk=check_descent_chunk(fq, qd[:8192], 2, 32))
    if rec["recall_at_10"] < BRACKET_MIN_RECALL:
        raise AssertionError(f"bracket recall {rec['recall_at_10']}")
    scan_phase("iid_100k_bracket_scan", fq, qd[:16384], truth, 2048,
               SCAN_MIN_RECALL["bracket"], launches,
               JAX_RECALL["bracket_scan"])
    del fq, xd, truth
    torch.cuda.empty_cache()

    # -- phase 6: the iid 1M scan (a single-leaf forest hosts the rows) ---
    gen = torch.Generator(device=device).manual_seed(SEED)
    x1 = torch.randn(1_000_000, 128, generator=gen, device=device)
    f1, build_1_s = sync_time(lambda: rp.forest_batch(
        SEED, 3, x1.shape[0], 1, 1.0, x1, device=device))
    q1 = qd[:4096]
    (_, exact), truth_s = sync_time(lambda: f1.brute_force_knn(q1[:256], K))
    log("iid_1m", n=x1.shape[0], dim=128, leaves=f1.plan.n_leaves,
        build_s=build_1_s, ground_truth_s=truth_s)
    scan_phase("iid_1m_scan", f1, q1, exact, 1024, SCAN_MIN_RECALL["1m"],
               launches, JAX_RECALL["scan_1m"])
    del f1, x1, qd
    torch.cuda.empty_cache()

    # -- phase 10b: the user surface on the iid cell (u2, u3, u4) ---------
    t_surface = time.perf_counter()
    surface_anytime(f_iid, launches, card)
    surface_checkpoints(f_iid, qd_iid, launches, card)
    surface_tune_build(f_iid, qd_iid, launches, card)
    log("surface", card=card,
        seconds=surface_s + time.perf_counter() - t_surface)
    torch.cuda.empty_cache()
    # -- phase 12b: the side layers on the iid cell (p1, p3, p4, p5, p7) --
    t_side = time.perf_counter()
    side_steps.update(side_layers_phase(f_iid, device, launches, card))
    log("side", card=card, seconds=side_s + time.perf_counter() - t_side,
        **side_steps)
    torch.cuda.empty_cache()

    # -- phase 7: online updates on the clustered and iid forests ---------
    updates_phase(f_clustered, qd_clustered, device, launches, kern, card)
    del f_clustered, qd_clustered
    updates_int8(f_iid, qd_iid, device, launches, card)
    del f_iid, qd_iid
    torch.cuda.empty_cache()

    # -- phase 8b: the 10M shared-row cell, every earlier forest freed, with
    # phase 14c on it ------------------------------------------------------
    dataparallel_s += shared_10m_phase(device, launches, kern, card)
    log("dataparallel", card=card, seconds=dataparallel_s)
    torch.cuda.empty_cache()

    # -- phase 9: sparse (ELL) data, the bag-of-words cell ----------------
    sparse_phase(device, launches, card)
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 15: the examples, each a process of its own ----------------
    examples_phase(device, launches, card)

    log("launches", variant="all", **launches)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")

    sources = {  # name: (source, TPU kernel or XLA stage, phase-2 record)
        "traverse": ("rptree_tpu_torch/csrc/traverse.cu",
                     "rptree_tpu/ops/traverse.py:154", "traverse"),
        "select_probes": ("rptree_tpu_torch/csrc/traverse.cu",
                          "rptree_tpu/models/forest.py:449", "select_probes"),
        "tile_tables": ("rptree_tpu_torch/csrc/tile_tables.cu",
                        "rptree_tpu/ops/grouped.py:66", "tile_tables"),
        "grouped_score_tiles": ("rptree_tpu_torch/csrc/grouped_score.cu",
                                "rptree_tpu/ops/grouped_kernel.py:63",
                                "grouped_score_tiles"),
        "grouped_score_tiles_bf16": ("rptree_tpu_torch/csrc/grouped_score.cu",
                                     "rptree_tpu/ops/grouped_kernel.py:63",
                                     "grouped_score_tiles_bf16"),
        "grouped_score_tiles_int8": ("rptree_tpu_torch/csrc/grouped_score_i8.cu",
                                     "rptree_tpu/ops/grouped_kernel.py:145",
                                     "grouped_score_tiles_int8"),
        "topk_dedup_kernel": ("rptree_tpu_torch/csrc/topk_dedup.cu",
                              "rptree_tpu/ops/topk_kernel.py:72",
                              "topk_dedup_kernel"),
        "topk_dedup_pairs": ("rptree_tpu_torch/csrc/topk_dedup.cu",
                             "rptree_tpu/ops/topk_kernel.py:72, its ids "
                             "read in place from the leaf id table",
                             "topk_dedup_pairs"),
        "grouped_score_topk": ("rptree_tpu_torch/csrc/grouped_topk.cu",
                               "rptree_tpu/ops/grouped_kernel.py:233",
                               "grouped_score_topk"),
        "gather_score": ("rptree_tpu_torch/csrc/gather_score.cu",
                         "rptree_tpu/ops/fused_gather.py:62", "gather_score"),
        "gather_score_bf16": ("rptree_tpu_torch/csrc/gather_score.cu",
                              "rptree_tpu/ops/fused_gather.py:62",
                              "gather_score_bf16_bracket"),
        "gather_score_shared": ("rptree_tpu_torch/csrc/gather_score.cu",
                                "rptree_tpu/ops/fused_gather.py:62 with "
                                "rptree_tpu/ops/shared.py:67 fetch_blocks",
                                "gather_score_shared"),
        "scan_topk": ("rptree_tpu_torch/csrc/scan_topk.cu",
                      "rptree_tpu/ops/scan.py:102", "scan_topk"),
        "ell_score_tiles": ("rptree_tpu_torch/csrc/ell_score.cu",
                            "rptree_tpu/ops/grouped.py:170 (XLA-form ELL "
                            "step) and rptree_tpu/models/forest.py:612 "
                            "(per-pair ELL step)", "ell_score_tiles"),
        "project_rows": ("rptree_tpu_torch/csrc/project.cu",
                         "rptree_tpu/models/forest.py:378 (query "
                         "projections) and rptree_tpu/ops/build.py:58 "
                         "project_dataset", "project_rows"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # where the library call computes a variant's function, that variant's
    # time and the call's name stand beside it; the tile kernels' device
    # time (graph_ms) beside their wrapper's
    extra = ("ms_no_dedup", "library_call", "gemm_ms", "cast_ms",
             "device_ms", "by_shape", "blocked_ms", "blocked_same_bits",
             "ms_pairs", "device_ms_pairs", "bound_ms_pairs", "ms_bf16",
             "bound_ms_bf16", "route_share", "route_share_pairs",
             "ms_banded", "route_share_banded", "ms_l2", "route_share_l2",
             "block_route_ms", "routes_same_bits", "device_ms_10m",
             "ms_10m", "gather_route_ms", "gather_route_device_ms",
             "gather_route_ms_10m", "gather_route_device_ms_10m",
             "bound_ms_10m", "bound_ms_touched", "bound_ms_touched_10m",
             "paths", "paths_10m")

    def line(key, v):  # kernel 9's grid counts stand in the phase-2 and
        # chunk records only
        if key == "by_shape":
            return {s: {k: w for k, w in one.items() if k != "grids"}
                    for s, one in v.items()}
        return v

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **{key: kern[r][key] for key in keys},
         **{key: line(key, kern[r][key]) for key in extra if key in kern[r]}}
        for name, (src, rep, r) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
