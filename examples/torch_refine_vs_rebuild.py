"""Measure refine-vs-rebuild streaming semantics (oracle-level), through
the PyTorch / CUDA port's copy of the numpy oracle
(``rptree_tpu_torch.reference``; ``examples/refine_vs_rebuild.py``
through the JAX package's).

The reference's conduit builder REFINES thresholds by running average and
merges margins monoidally as chunks arrive (``Conduit.hs:49-57``,
``Internal.hs:280-285``); the port, like the JAX package, replaces that
with an exact rebuild over everything seen
(``rptree_tpu_torch/streaming.py``).  This script converts the
documented "exact medians dominate under stationarity" claim into a
measurement: on a stationary and on a drifting chunk stream, build both
ways with the SAME projections (the numpy oracle re-executes both
semantics; ``ref_forest_stream`` is the refine path, ``ref_forest_batch``
the exact path), and report knn recall@10 plus build CPU time.

Run: ``python examples/torch_refine_vs_rebuild.py [n_chunks chunk]``
(CPU-only, numpy oracle; the defaults are the original's 8 chunks of 500).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(kind: str, n_chunks: int = 8, chunk: int = 500, dim: int = 32,
        n_trees: int = 4, k: int = 10, seed: int = 5):
    from rptree_tpu_torch import reference as ref

    rng = np.random.default_rng(seed)
    chunks = []
    for i in range(n_chunks):
        centers = rng.normal(size=(8, dim))
        if kind == "drifting":
            # the component means walk: later chunks occupy new territory
            centers = centers + 2.0 * i
        assign = rng.integers(0, 8, size=chunk)
        chunks.append(
            (centers[assign]
             + 0.3 * rng.normal(size=(chunk, dim))).astype(np.float32)
        )
    x = np.concatenate(chunks)
    n = x.shape[0]
    max_depth, min_leaf = 6, 20
    r = rng.normal(size=(n_trees, max_depth, dim))

    t0 = time.process_time()
    f_refine = ref.ref_forest_stream(x, r, max_depth, min_leaf, chunk)
    t_refine = time.process_time() - t0
    t0 = time.process_time()
    f_exact = ref.ref_forest_batch(x, r, max_depth, min_leaf)
    t_exact = time.process_time() - t0

    qi = rng.integers(0, n, size=64)
    q = x[qi] + 0.05 * rng.normal(size=(64, dim)).astype(np.float32)
    sq = (x * x).sum(1)

    def recall(forest):
        """(recall@10, mean candidates reranked per query) -- the refine
        path's unbalanced trees inflate leaf sizes, so recall alone
        overstates it: the candidate count is the serving cost."""
        hits, cands = [], []
        for b in range(q.shape[0]):
            d2 = sq - 2.0 * (x @ q[b])
            exact = set(np.argpartition(d2, k)[:k].tolist())
            union = set()
            for tree in forest:
                union |= set(ref.ref_candidates(tree, q[b]).tolist())
            cands.append(len(union))
            _, ids = ref.ref_knn(forest, x, q[b], k, dedup=True)
            hits.append(len(set(ids.tolist()) & exact) / k)
        return float(np.mean(hits)), float(np.mean(cands))

    rec_refine, cand_refine = recall(f_refine)
    rec_exact, cand_exact = recall(f_exact)
    print(f"{kind:<11} refine: recall@10 {rec_refine:.4f} "
          f"({cand_refine:6.0f} cands/q, build {t_refine:5.2f}s) | "
          f"exact rebuild: recall@10 {rec_exact:.4f} "
          f"({cand_exact:6.0f} cands/q, build {t_exact:5.2f}s)")
    return {"kind": kind, "recall_refine": rec_refine,
            "recall_exact": rec_exact, "cand_refine": cand_refine,
            "cand_exact": cand_exact, "t_refine": t_refine,
            "t_exact": t_exact}


if __name__ == "__main__":
    n_chunks, chunk = (int(a) for a in (sys.argv[1:3] or (8, 500)))
    print(f"oracle-level refine-vs-rebuild (same projections, "
          f"n={n_chunks * chunk}, {n_chunks} chunks x {chunk}, d=32, T=4, "
          f"k=10)")
    run("stationary", n_chunks, chunk)
    run("drifting", n_chunks, chunk)
