"""Parallel runtime of the port: device meshes, the tree-parallel build,
the tree- and query-sharded query paths and the data-parallel forests
(``rptree_tpu/parallel``), driven by one process over a grid of devices
(:mod:`.mesh`; a data mesh may also span the processes of a
``torch.distributed`` group), each shard's work a call on its own device
and the collectives plain functions over the shards' tensors
(:mod:`.collectives`).
"""

from .mesh import QUERY_AXIS, TREE_AXIS, forest_mesh
from .distributed import (
    DistributedForest,
    distribute,
    forest_batch_distributed,
    merge_top_k,
)
from .data_parallel import (
    DATA_AXIS,
    DataParallelForest,
    brute_force_knn_sharded,
    data_mesh,
    forest_batch_data_parallel,
)

__all__ = [
    "QUERY_AXIS",
    "TREE_AXIS",
    "forest_mesh",
    "DistributedForest",
    "distribute",
    "forest_batch_distributed",
    "merge_top_k",
    "DATA_AXIS",
    "DataParallelForest",
    "brute_force_knn_sharded",
    "data_mesh",
    "forest_batch_data_parallel",
]
