"""Fold-drift measurement through the PyTorch / CUDA port
(``rptree_tpu_torch``; ``examples/fold_drift.py`` through the JAX
package): how long is fold()-only operation safe?

``fold()`` places new points by the STORED thresholds (the placement step
of the reference's ``insert``, ``Internal.hs:270-276``) without refreshing
thresholds or margins, so a long-folded index drifts from what a rebuild
would produce.  This script measures recall as a function of the FOLDED
FRACTION, under a stationary stream and under center drift, against a
fresh rebuild at identical contents.

The data are the JAX example's: numpy ``default_rng(seed)``, the same
calls in the same order, so the rows carry the same bits; the port draws
its own projections, so the trees are not the JAX example's.  The folded
rows are scored by kernel 6 (``csrc/gather_score.cu``) with the indexed
ones; a point whose leaf has no free slot stays pending, and every query
merges the pending rows' exact scan (kernel 5, ``csrc/scan_topk.cu``, at
``precision="default"``); the exact ground truth scans the indexed and
the folded rows.  It runs on the card (``RPTREE_EXAMPLE_DEVICE=cpu``
runs it on the CPU).

    python examples/torch_fold_drift.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(drift: bool, n0=32768, dim=32, centers=64, sigma=0.15, t=8,
        steps=5, step_frac=0.2, k=10, seed=3, device=None):
    import rptree_tpu_torch as rp

    device = device or os.environ.get("RPTREE_EXAMPLE_DEVICE") or None
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, dim)).astype(np.float32)

    def draw(m, c_now):
        return (c_now[rng.integers(0, centers, m)]
                + sigma * rng.normal(size=(m, dim)).astype(np.float32))

    x0 = draw(n0, c)
    min_leaf = max(8, n0 // centers)
    cfg = rp.rp_tree_cfg(min_leaf, n0, dim)
    f = rp.forest_batch(seed, cfg.max_depth, min_leaf, t,
                        cfg.proj_nz_density, x0, device=device)
    # slack for a 100% folded fraction: leaves grow to ~2x occupancy
    f.pack_leaves(slack=f.plan.max_leaf_len + 8)
    probes = 2 * t
    rows = []
    c_now = c.copy()
    for s in range(1, steps + 1):
        if drift:
            # centers random-walk 0.25 sigma per coordinate per step: by
            # the last step the mixture has moved ~0.5-1 sigma from the
            # build-time geometry
            c_now = c_now + (0.25 * sigma) * rng.normal(
                size=c_now.shape).astype(np.float32)
        chunk = draw(int(n0 * step_frac), c_now)
        f.add(chunk)
        f.fold()
        frac = f.n_folded / f.plan.n
        q = draw(512, c_now)  # queries follow the live distribution
        _, gt = f.brute_force_knn(q, k)  # folded-aware ground truth
        gt = gt.cpu().numpy()
        _, ids = f.knn(q, k, budget=1, probes=probes, precision="default")
        ids = ids.cpu().numpy()
        r_fold = float(np.mean([
            len(set(ids[b].tolist()) & set(gt[b].tolist())) / k
            for b in range(len(q))]))
        # fresh rebuild at identical contents (exact level-sync build)
        fr = rp.forest_batch(seed, cfg.max_depth, min_leaf, t,
                             cfg.proj_nz_density, f.points(),
                             device=f.device)
        fr.pack_leaves()
        _, idr = fr.knn(q, k, budget=1, probes=probes,
                        precision="default")
        idr = idr.cpu().numpy()
        r_reb = float(np.mean([
            len(set(idr[b].tolist()) & set(gt[b].tolist())) / k
            for b in range(len(q))]))
        rows.append((frac, r_fold, r_reb))
        print(f"  folded {frac:5.1%}  pending {f.n_pending:5d}  "
              f"recall fold-only {r_fold:.3f}  rebuilt {r_reb:.3f}  "
              f"gap {r_reb - r_fold:+.3f}", flush=True)
        del fr
    return rows


def main(**kw):
    """Both streams; ``kw`` go to :func:`run` (sizes, ``device``)."""
    print("stationary stream (same mixture):", flush=True)
    t0 = time.perf_counter()
    stat = run(drift=False, **kw)
    print("drifting stream (centers random-walk):", flush=True)
    dri = run(drift=True, **kw)
    print(f"total {time.perf_counter() - t0:.0f}s")
    # recommended default: largest folded fraction keeping the gap <= 0.02
    for name, rows in (("stationary", stat), ("drifting", dri)):
        safe = [f for f, rf, rr in rows if rr - rf <= 0.02]
        print(f"{name}: fold-only safe up to "
              f"{(max(safe) if safe else 0.0):.0%} folded fraction "
              f"(gap <= 0.02)")
    return stat, dri


if __name__ == "__main__":
    main()
