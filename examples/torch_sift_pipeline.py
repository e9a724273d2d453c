"""End-to-end ANN pipeline through the PyTorch / CUDA port
(``rptree_tpu_torch``; ``examples/sift_pipeline.py`` through the JAX
package): file ingest -> tune build -> build -> tune query knobs -> serve
-> evaluate.

The production recipe for an fvecs-format benchmark dataset (SIFT1M /
GIST1M layout: base vectors, query vectors, ivecs ground truth).  Without
arguments it runs on a self-generated synthetic dataset so the script
doubles as an executable smoke test:

    python examples/torch_sift_pipeline.py [base.fvecs query.fvecs gt.ivecs]

Stages:
  0. probe   -- read a subsample, sweep build-side knobs with
                rptree_tpu_torch.tune_build (min_leaf transfers by the
                n/centers scale law);
  1. ingest  -- native chunked readers (rptree_tpu_torch.ingest, C++ via
                ctypes) streamed into the builder;
  2. build   -- streaming build at the tuned parameters;
  3. tune    -- cheapest (budget, probes) meeting the recall target,
                measured against the exact answer on held-out queries;
  4. serve   -- grouped batches (knn_grouped), or the exact scan where
                tune picked it;
  5. evaluate-- recall@k against the ground truth (file or brute force).

It runs on the card (``RPTREE_EXAMPLE_DEVICE=cpu`` runs it on the CPU);
``RPTREE_EXAMPLE_N`` sets the synthetic size and ``RPTREE_EXAMPLE_FAST=1``
narrows the sweeps, as in the original.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(base=None, query=None, gt=None, n_trees=8, k=10,
         target_recall=0.9, centers_estimate=None, device=None):
    import torch

    import rptree_tpu_torch as rp

    device = device or os.environ.get("RPTREE_EXAMPLE_DEVICE") or None

    def sync():
        if torch.cuda.is_available() and device != "cpu":
            torch.cuda.synchronize()

    if base is None:
        n_syn = int(os.environ.get("RPTREE_EXAMPLE_N", 20_000))
        print(f"no dataset given; generating synthetic (n={n_syn}, d=64)")
        rng = np.random.default_rng(7)
        xb = rng.normal(size=(n_syn, 64)).astype(np.float32)
        xq = (xb[rng.integers(0, len(xb), 256)]
              + 0.05 * rng.normal(size=(256, 64)).astype(np.float32))
        gt_ids = None
        n, dim = xb.shape
        sub = xb[:4096]

        def source():
            return iter(np.split(xb, 20))
    else:
        n, dim = rp.ingest.fvecs_meta(base)
        # ingest throughput: one full native read pass over the base file
        t0 = time.perf_counter()
        mb = 0.0
        for chunk in rp.ingest.fvecs_source(base, chunk_size=200_000):
            mb += chunk.nbytes / 1e6
        dt = time.perf_counter() - t0
        print(f"ingest: {n} x {dim} f32 ({mb:.0f} MB) in {dt:.2f}s "
              f"-> {mb / dt:.0f} MB/s "
              f"(native={rp.ingest.native_available()})")
        xq = rp.ingest.read_fvecs(query)
        gt_ids = rp.ingest.read_ivecs(gt)[:, :k] if gt else None
        sub = rp.ingest.read_fvecs(base, 0, 131072)

        def source():
            return rp.ingest.fvecs_source(base, chunk_size=200_000)

    # stage 0: build-side knobs on the subsample (min_leaf transfers to
    # the full n by the measured scale law).  RPTREE_EXAMPLE_FAST=1
    # narrows the sweep grids (the pipeline's stages all still run).
    fast = os.environ.get("RPTREE_EXAMPLE_FAST") == "1"
    t0 = time.perf_counter()
    tb = rp.tune_build(sub, xq[:128], k=k, target_recall=target_recall,
                       centers_estimate=centers_estimate,
                       min_leaf_grid=(64, 256) if fast else None,
                       sample=len(sub), full_n=n,
                       budgets=(2,) if fast else (1, 2),
                       probes_per_tree=(1.0,) if fast else (1.0, 2.0),
                       measure=False, device=device)
    min_leaf = int(tb["min_leaf_full"])
    print(f"tune_build ({time.perf_counter() - t0:.1f}s): "
          f"min_leaf={min_leaf} (subsample winner {tb['min_leaf']} "
          f"recall {tb['recall']:.3f}, met={tb['met']})")

    cfg = rp.rp_tree_cfg(min_leaf=min_leaf, n=n, dim=dim)
    print(f"config: depth={cfg.max_depth} pnz={cfg.proj_nz_density:.3f}")

    t0 = time.perf_counter()
    f = rp.forest(seed=42, max_depth=cfg.max_depth, min_leaf=min_leaf,
                  n_trees=n_trees, chunk_size=200_000,
                  pnz=cfg.proj_nz_density, dim=dim, source=source(),
                  device=device)
    sync()
    build_s = time.perf_counter() - t0
    print(f"built {f!r} in {build_s:.1f}s (stream + device build)")

    f.pack_leaves()
    xq = torch.as_tensor(xq, device=f.device)
    best = rp.tune(f, xq[: min(128, len(xq))], k=k,
                   target_recall=target_recall,
                   budgets=(2,) if fast else (1, 2),
                   probes_per_tree=(1.0, 2.0) if fast
                   else (1.0, 1.5, 2.0),
                   reps=1 if fast else 2,
                   time_rows=512 if fast else 8192)
    print(f"tuned: budget={best['budget']} probes={best['probes']} "
          f"recall={best['recall']:.3f} (target met: {best['met']})")

    if gt_ids is None:
        gt_ids = torch.cat([f.brute_force_knn(xq[s:s + 2048], k)[1]
                            for s in range(0, len(xq), 2048)]).cpu().numpy()

    if best.get("scan"):
        # tune() found the exact scan to be the cheapest config meeting
        # the target (small/hard datasets) -- serve with it
        print("serving via the exact scan (tune() picked it)")

        def serve():
            return f.brute_force_knn(xq, k, precision="fastest",
                                     query_chunk=2048)[1]
    else:
        # query-grouped block-resident rerank: same results as knn()
        def serve():
            return f.knn_grouped(xq, k, budget=best["budget"],
                                 probes=best["probes"],
                                 precision="default")[1]

    t0 = time.perf_counter()
    ids = serve().cpu().numpy()  # the first call builds and learns
    cold = time.perf_counter() - t0
    reps = 3
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        serve()
    sync()
    dt = (time.perf_counter() - t0) / reps
    recall = float(np.mean([
        len(set(ids[b].tolist()) & set(gt_ids[b].tolist())) / k
        for b in range(len(xq))
    ]))
    print(f"served {len(xq)} queries in {dt * 1e3:.1f}ms "
          f"({len(xq) / dt:.0f} QPS wall; first call "
          f"{cold * 1e3:.0f}ms); recall@{k}={recall:.3f}")
    return recall


if __name__ == "__main__":
    a = sys.argv[1:]
    kw = {}
    if "--centers" in a:
        i = a.index("--centers")
        kw["centers_estimate"] = int(a[i + 1])
        a = a[:i] + a[i + 2:]
    main(*a[:3], **kw)
