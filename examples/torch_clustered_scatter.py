"""Leaf-colored scatter of the clustered bench family through the PyTorch /
CUDA port (``rptree_tpu_torch``; ``examples/clustered_scatter.py``
through the JAX package) -- the visual story of WHY the tree wins there.

The reference's README figure is a leaf-colored scatter of a 2-D
Gaussian mixture (r/scatter.r:1-42, README.md:7; reproduced by
``python -m rptree_tpu_torch.demo``).  This renders the same picture on
the CLUSTERED BENCH FAMILY (the flagship's data, reduced to 2-D): a
Gaussian mixture with ``min_leaf ~ n/centers``, where each leaf tiles
roughly one cluster.

Writes ``clustered_scatter.csv`` (point, leaf label -- the reference's
CSV contract, Draw.hs:55-59) and, when matplotlib is importable,
``clustered_scatter.png``.  The data are the original's (numpy, seed 7);
the projections are the port's own draw, so the leaves differ from the
JAX package's.  It builds on the card (``RPTREE_EXAMPLE_DEVICE=cpu`` on
the CPU).

    python examples/torch_clustered_scatter.py [output_dir]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_dir=".", device=None):
    import rptree_tpu_torch as rp
    from rptree_tpu_torch.utils.draw import leaf_label_of_points, write_csv

    device = device or os.environ.get("RPTREE_EXAMPLE_DEVICE") or None
    n, centers, sigma, seed = 20_000, 24, 0.12, 7
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, size=(centers, 2)).astype(np.float32)
    x = (c[rng.integers(0, centers, n)]
         + sigma * rng.normal(size=(n, 2)).astype(np.float32))

    min_leaf = max(8, n // centers)  # the measured clustered heuristic
    cfg = rp.rp_tree_cfg(min_leaf, n, 2)
    f = rp.forest_batch(seed, cfg.max_depth, min_leaf, 1, 1.0, x,
                        device=device)
    labels = leaf_label_of_points(f)
    csv = os.path.join(out_dir, "clustered_scatter.csv")
    write_csv(csv, x, labels)
    print(f"wrote {csv} ({f.plan.n_leaves} leaves over {centers} "
          f"clusters, min_leaf={min_leaf})")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        print("matplotlib unavailable; CSV only")
        return labels
    fig, ax = plt.subplots(figsize=(7, 7), dpi=120)
    ax.scatter(x[:, 0], x[:, 1], c=labels % 20, s=1.5, cmap="tab20",
               linewidths=0)
    ax.set_title(f"rp-tree leaves on the clustered bench family\n"
                 f"n={n}, {centers} clusters, min_leaf={min_leaf} "
                 f"(~ n/centers): leaves tile clusters")
    ax.set_aspect("equal")
    png = os.path.join(out_dir, "clustered_scatter.png")
    fig.savefig(png, bbox_inches="tight")
    print(f"wrote {png}")
    return labels


if __name__ == "__main__":
    main(*sys.argv[1:2])
