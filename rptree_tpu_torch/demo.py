"""Demo entry point (``rptree_tpu/demo.py``; the reference executable,
``app/Main.hs:34-126``).

Builds a single streaming tree over 10,000 2-D Gaussian-mixture points
(seed 1235137, max depth 5, min leaf 10, chunk 100, dense projections --
the reference's hardcoded parameters, app/Main.hs:36-44,120-126), then
writes:

* ``scatter.csv``      -- all points labelled by the leaf they landed in
                          (app/Main.hs:79-99 -> Draw.hs:55-59);
* ``tree.dot``         -- GraphViz structure with bucket sizes as leaf
                          labels (app/Main.hs:72-76 -> Draw.hs:85-108);
* ``knn.csv``          -- points + the k=10 nearest neighbours of query
                          (1, 1) via ``knn``, hits labelled -1
                          (app/Main.hs:49-61);
* ``knn_h.csv``        -- same via the margin-priority ``knn_h``.

The points are drawn from the port's generator (``torch.Generator``), so
the files hold other points than the JAX package's demo writes.

Run: ``python -m rptree_tpu_torch.demo [output_dir]`` (on the card; the
CPU with ``main(out_dir, device="cpu")``).
"""

from __future__ import annotations

import os
import sys

import torch

from .streaming import forest as forest_stream
from .utils import gen as rgen
from .utils.draw import knn_write_csv, leaf_label_of_points, write_csv, write_dot

SEED = 1235137        # app/Main.hs:44
N = 10_000            # app/Main.hs:37
MAX_DEPTH = 5         # app/Main.hs:38
MIN_LEAF = 10         # app/Main.hs:39 (minLeaf)
CHUNK = 100           # app/Main.hs:41
PNZ = 1.0             # app/Main.hs:42 (dense projections)
K = 10                # app/Main.hs:40
QUERY = torch.tensor([1.0, 1.0])  # app/Main.hs:49,56


def main(out_dir: str = ".", *, device=None) -> None:
    """Build the demo tree on ``device`` (default: the card) and write the
    four files into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    src = rgen.data_source(SEED, N, CHUNK, rgen.normal2, device=device)
    t = forest_stream(SEED, MAX_DEPTH, MIN_LEAF, 1, CHUNK, PNZ, 2, src,
                      device=device)
    pts = t.points()

    labels = leaf_label_of_points(t, 0)
    write_csv(os.path.join(out_dir, "scatter.csv"), pts, labels)
    write_dot(os.path.join(out_dir, "tree.dot"), t, name="tree0")

    _, ids = t.knn(QUERY, K)
    hits = pts[ids[0][ids[0] >= 0].long()]
    knn_write_csv(os.path.join(out_dir, "knn.csv"), pts, labels, hits)

    _, ids_h = t.knn_h(QUERY, K)
    hits_h = pts[ids_h[0][ids_h[0] >= 0].long()]
    knn_write_csv(os.path.join(out_dir, "knn_h.csv"), pts, labels, hits_h)

    stats = t.tree_stats()
    print(f"tree: {stats['n_leaves']} leaves, {stats['n_branches']} branches, "
          f"{t.tree_size()} points")
    print(f"wrote scatter.csv tree.dot knn.csv knn_h.csv to {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
