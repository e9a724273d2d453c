"""Where the time of the serving paths goes, on one NVIDIA GPU: the stage
times of one clustered 1M chunk (65,536 queries, ``chip_smoke.py``'s
phase-3 cell) under the grouped path's three selection tails, on f32 and
bf16 blocks, and the device time by kernel of one whole call of each
tail; then the stages of one per-pair chunk (2,048 queries, variant f)
and the time of one bf16 scan chunk (2,048 queries over the 1M rows).

    python3 chip_stages.py            # on the card
    python3 chip_stages.py --cpu      # a tiny rehearsal on the CPU

Each stage runs as the serving path runs it (``_knn_grouped``), between
two ``torch.cuda.synchronize`` calls, seven times; the line gives the
median on the host clock in ms, so launch latency is not overlapped
between stages.  The sums are per tail:

- kernel tail (``selection="kernel"``): traversal, tile tables, query
  gather, kernel 1, pair reorder, id gather, kernel 3;
- sort tail (``selection="sort", impl="kernel"``): the same up to the id
  gather, then the stable sort, its first ``kk`` and ``merge_top_k``;
- ``impl="kernel_topk"``: traversal, tile tables, query gather, kernel 4,
  the pair reorder of its ``(d, ids)`` and the sort tail over them.

On the card it first times the kernel build two ways from the same
sources: one ``nvcc`` over all of them, and ``_cuda.build``'s one
process per source plus a link.  One JSON object per line; it never
imports JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

K, TILE_M, PROBES, BUDGET = 10, 8, 8, 1


def timed(fn, sync, reps=7):
    """``(fn(), median ms)`` over ``reps`` synchronised runs."""
    ts, res = [], None
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    return res, float(np.median(ts))


def build_times():
    """Seconds of ``_cuda.build`` (one ``nvcc`` per source, then a link)
    before and after one ``nvcc`` over every source, each from nothing."""
    from rptree_tpu_torch import _cuda

    cus, _ = _cuda._sources()
    path, _, _ = _cuda.build()
    path.unlink()
    _, first, _ = _cuda.build()
    with tempfile.TemporaryDirectory(dir=_cuda._BUILD) as tmp:
        t0 = time.perf_counter()
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                        os.path.join(tmp, "one.so"), *map(str, cus)],
                       check=True, capture_output=True)
        one = time.perf_counter() - t0
    path.unlink()
    _, last, _ = _cuda.build()
    return {"sources": len(cus), "one_nvcc_s": one,
            "one_nvcc_per_source_s": [first, last]}


def stages(f, fm, og, gk, tk, rr, qc, cap, sync):
    """Stage times of one chunk ``qc`` at tile capacity ``cap``."""
    x_leaf, sq_leaf, id_leaf = f._packed
    lens = f._lens_global()
    st = {}
    (gsel, lsel), st["traversal_probes"] = timed(lambda: fm._select_probes(
        f.plan, f.arrays, qc, BUDGET, PROBES, k=K, block_len=lens,
        children=f._children()), sync)
    b, p = gsel.shape
    (tb, tp, needed, inv), st["tile_tables"] = timed(
        lambda: og._tile_tables(gsel, lsel, TILE_M, cap, with_slots=True),
        sync)
    (lens_t, qt), st["query_gather"] = timed(lambda: (
        lens[tb.long()].to(torch.int32),
        qc[torch.where(tp >= 0, tp // p, 0).reshape(-1).long()]), sync)
    d_all, st["kernel1_tiles"] = timed(lambda: gk.grouped_score_tiles(
        x_leaf, sq_leaf, tb, lens_t, qt, "l2", TILE_M), sync)
    d, st["pair_reorder"] = timed(lambda: og._pair_rows(
        d_all, inv, float("inf"), b, p).reshape(b, -1), sync)
    ids, st["id_gather"] = timed(
        lambda: id_leaf[gsel.long()].reshape(b, -1), sync)
    _, st["kernel3_topk_tail"] = timed(
        lambda: tk.topk_dedup_kernel(d, ids, K), sync)
    (ds, order), st["sort_tail_sort"] = timed(
        lambda: torch.sort(d, dim=1, stable=True), sync)
    kk = K * f.n_trees
    (d_kk, i_kk), st["sort_tail_take_kk"] = timed(lambda: (
        ds[:, :kk], torch.where(torch.isinf(ds[:, :kk]), -1,
                                ids.gather(1, order[:, :kk]))), sync)
    _, st["sort_tail_merge"] = timed(lambda: rr.merge_top_k(d_kk, i_kk, K),
                                     sync)
    kp = -(-max(K, 8) // 8) * 8
    (dk, ik), st["kernel4_tiles_topk"] = timed(lambda: gk.grouped_score_topk(
        x_leaf, sq_leaf, id_leaf, tb, lens_t, qt, "l2", TILE_M, kp), sync)
    (dp, ip), st["kp_pair_reorder"] = timed(lambda: (
        og._pair_rows(dk, inv, float("inf"), b, p).reshape(b, -1),
        og._pair_rows(ik, inv, -1, b, p).reshape(b, -1)), sync)
    _, st["kp_sort_tail"] = timed(lambda: fm._selection_tail_ids(
        dp, ip, K, min(kk, p * kp), True), sync)
    head = st["traversal_probes"] + st["tile_tables"] + st["query_gather"]
    scored = head + st["kernel1_tiles"] + st["pair_reorder"] + st["id_gather"]
    st["sum_kernel_tail"] = scored + st["kernel3_topk_tail"]
    st["sum_sort_tail"] = (scored + st["sort_tail_sort"]
                           + st["sort_tail_take_kk"] + st["sort_tail_merge"])
    st["sum_kernel_topk"] = (head + st["kernel4_tiles_topk"]
                             + st["kp_pair_reorder"] + st["kp_sort_tail"])
    return st, int(needed)


def pair_stages(f, fm, fg, rr, qc, sync):
    """Stage times of one per-pair chunk ``qc`` on f32 blocks, as
    ``_knn_packed`` runs it: probe selection, kernel 6, distances and
    occupancy mask, the sort tail; then the whole call."""
    x_leaf, sq_leaf, id_leaf = f._packed
    lens = f._lens_global()
    lmax = x_leaf.shape[1]
    st = {}
    (gsel, lsel), st["traversal_probes"] = timed(lambda: fm._select_probes(
        f.plan, f.arrays, qc, BUDGET, PROBES, k=K, block_len=lens,
        children=f._children()), sync)
    b = gsel.shape[0]
    (dots, sqx), st["kernel6_gather_score"] = timed(
        lambda: fg.gather_score(x_leaf, sq_leaf, qc, gsel.contiguous()), sync)
    col = torch.arange(lmax, device=qc.device)
    d, st["distances_mask"] = timed(lambda: torch.where(
        (lsel >= 0)[..., None] & (col < lens[gsel.long()][..., None]),
        rr.distances_from_dots(dots, sqx, qc[:, None], "l2"),
        float("inf")).reshape(b, -1), sync)
    _, st["sort_tail"] = timed(lambda: fm._selection_tail(
        d, id_leaf, gsel, K, K * f.n_trees, True), sync)
    st["sum"] = sum(st.values())
    _, st["whole_call"] = timed(
        lambda: f.knn(qc, K, budget=BUDGET, probes=PROBES), sync)
    return st


def device_times(f, qd, serve, sel, impl, on_card):
    """Wall ms of one whole call under ``torch.profiler`` and its kernels'
    device ms, the largest eight by name."""
    def self_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    f.knn_grouped(qd, K, selection=sel, impl=impl, check=False, **serve)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize()
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        f.knn_grouped(qd, K, selection=sel, impl=impl, check=False, **serve)
        if on_card:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = sorted(prof.key_averages(), key=lambda e: -self_ms(e))
    return {"wall_ms_under_profiler": wall,
            "device_ms": sum(self_ms(e) for e in ka),
            "top": [(e.key[:60], self_ms(e)) for e in ka[:8]]}


def main():
    import rptree_tpu_torch as rp
    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import fused_gather as fg
    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops import grouped_kernel as gk
    from rptree_tpu_torch.ops import rerank as rr
    from rptree_tpu_torch.ops import topk_kernel as tk

    on_card = "--cpu" not in sys.argv[1:]
    if on_card and not torch.cuda.is_available():
        raise SystemExit("chip_stages: no CUDA device (use --cpu to rehearse)")
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        print(smi.strip().splitlines()[0], flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"build": build_times()}), flush=True)
    n, nq, centers, chunk = ((1_000_000, 131_072, 4_000, 65_536) if on_card
                             else (20_000, 1_024, 80, 512))
    x, q = cs.clustered_data(n, 128, centers, 0.15, nq)
    cfg = rp.rp_tree_cfg(128, *x.shape)
    f = rp.forest_batch(cs.SEED, cfg.max_depth, 128, 8, cfg.proj_nz_density,
                        torch.as_tensor(x, device=dev), device=dev)
    qd = torch.as_tensor(q, device=dev)
    del x, q
    serve = dict(budget=BUDGET, probes=PROBES, tile_m=TILE_M, chunk=chunk)
    for dtype, name in ((None, "f32"), (torch.bfloat16, "bf16")):
        f.pack_leaves(dtype=dtype)
        f.knn_grouped(qd, K, selection="sort", **serve)  # learn the capacity
        (cap,) = f._grouped_nt.values()
        st, needed = stages(f, fm, og, gk, tk, rr, qd[:chunk], cap, sync)
        print(json.dumps({"stages_ms": name, "chunk": chunk, "needed": needed,
                          "cap": cap, **st}), flush=True)
        for sel, impl in (("kernel", "kernel"), ("sort", "kernel"),
                          ("sort", "kernel_topk")):
            print(json.dumps({"profile": name, "selection": sel, "impl": impl,
                              **device_times(f, qd, serve, sel, impl,
                                             on_card)}), flush=True)
        if dtype is None:
            pc = min(2048, chunk)
            print(json.dumps({"pair_stages_ms": name, "chunk": pc,
                              **pair_stages(f, fm, fg, rr, qd[:pc], sync)}),
                  flush=True)
    _, scan_ms = timed(lambda: f.brute_force_knn(
        qd[:2048], K, precision="fastest"), sync)
    print(json.dumps({"scan_chunk_ms": scan_ms, "queries": min(2048, len(qd)),
                      "rows": f.n_points}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
