"""Million-point scale check through the PyTorch / CUDA port
(``rptree_tpu_torch``; ``examples/scale_1m.py`` through the JAX package):
build an 8-tree index over 1M synthetic 128-d vectors on one card, pack
to bf16 blocks, and report device-side build and query times plus
recall@10 against the exact scan.

The rows and queries are the JAX example's: numpy ``default_rng(1)``,
the same calls in the same order, so they carry the same bits.  Device
times come from ``rptree_tpu_torch.device_time`` (CUDA events; the host
clock on the CPU): the build is ``build_forest_arrays`` over the forest's
own projections, the query the per-pair path ``_knn_packed`` (budget 4,
probes 12) on bf16 blocks, which kernel 6 (``csrc/gather_score.cu``)
fetches and scores.  It runs on the card (``RPTREE_EXAMPLE_DEVICE=cpu``
runs it on the CPU).

Run: ``python examples/torch_scale_1m.py [n]``  (default 1,000,000)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n: int = 1_000_000, device=None):
    import torch

    import rptree_tpu_torch as rt
    from rptree_tpu_torch.models.forest import _knn_packed
    from rptree_tpu_torch.ops.build import build_forest_arrays

    device = device or os.environ.get("RPTREE_EXAMPLE_DEVICE") or None
    dim, n_trees, k = 128, 8, 10
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    cfg = rt.rp_tree_cfg(64, n, dim)
    print(f"n={n} depth={cfg.max_depth} pnz={cfg.proj_nz_density:.3f}")

    t0 = time.perf_counter()
    f = rt.forest_batch(1, cfg.max_depth, 64, n_trees,
                        cfg.proj_nz_density, x, device=device)
    rt.profiling.sync(f.arrays.perm)
    print(f"build wall {time.perf_counter() - t0:.1f}s "
          "(includes host->device transfer and the first kernel loads)")

    dt = rt.device_time(
        lambda rr, xx: build_forest_arrays(f.plan, xx, rr).perm,
        f.arrays.r, f.x, reps=3,
    )
    print(f"build device {dt:.2f}s")

    f.pack_leaves(dtype=torch.bfloat16)
    b = 2048
    q = torch.as_tensor((x[rng.integers(0, n, size=b)]
                         + 0.1 * rng.normal(size=(b, dim))).astype(
                             np.float32), device=f.device)

    # the port's _knn_packed takes the forest (its packed tables ride on
    # it) and no precision: bf16 blocks are scored by exact products of
    # bf16 values summed in fp32 at every precision
    dt = rt.device_time(
        lambda qq: _knn_packed(f, qq, k, 4, 12, "l2", True),
        q, reps=10,
    )
    print(f"query device {dt * 1e3:.2f}ms per {b} queries "
          f"({b / dt:.0f} QPS/chip)")

    _, ids = f.knn(q[:256], k, budget=4, probes=12, precision="default")
    _, exact = f.brute_force_knn(q[:256], k)
    ids, exact = ids.cpu().numpy(), exact.cpu().numpy()
    rec = np.mean([
        len(set(ids[i].tolist()) & set(exact[i].tolist())) / k
        for i in range(len(ids))
    ])
    print(f"recall@{k} = {rec:.4f}")
    return float(rec)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000)
