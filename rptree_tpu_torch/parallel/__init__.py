"""Parallel runtime of the port: device meshes, the tree-parallel build
and the tree- and query-sharded query paths (``rptree_tpu/parallel``),
driven by one process over a grid of devices (:mod:`.mesh`), each shard's
work a call on its own device and the collectives plain functions over
the shards' tensors (:mod:`.collectives`).

Not ported yet (ROADMAP.md queue 1 item 20b): the data-parallel forests
(``DATA_AXIS``, ``DataParallelForest``, ``brute_force_knn_sharded``,
``data_mesh``, ``forest_batch_data_parallel``).
"""

from .mesh import QUERY_AXIS, TREE_AXIS, forest_mesh
from .distributed import (
    DistributedForest,
    distribute,
    forest_batch_distributed,
    merge_top_k,
)

__all__ = [
    "QUERY_AXIS",
    "TREE_AXIS",
    "forest_mesh",
    "DistributedForest",
    "distribute",
    "forest_batch_distributed",
    "merge_top_k",
]
