"""Device mesh of the forest's two parallel axes (``rptree_tpu/parallel/
mesh.py``).

* ``"tree"``: the forest axis.  Trees are independent during the build and
  the candidate generation; only the final top-k merge of a query couples
  them, which becomes a gather of each shard's k best and a re-top-k.
* ``"query"``: the query batch, embarrassingly parallel.

The mesh is a grid of ``torch.device`` s driven by one process: each shard's
work is a call on its own device, and the collectives are plain functions
over the shards' tensors (:mod:`.collectives`).  A device may repeat in the
grid.  That is how one device stands in for several: the CPU tests pass
``[torch.device("cpu")] * 8`` where the JAX package's tests take eight
virtual CPU devices, and one card runs four shards with ``[cuda:0] * 4``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["forest_mesh", "ForestMesh", "TREE_AXIS", "QUERY_AXIS"]

TREE_AXIS = "tree"
QUERY_AXIS = "query"


class ForestMesh:
    """A ``[tree, query]`` grid of devices: ``devices`` (an object array of
    ``torch.device``, so ``devices.flatten()`` lists them) and ``shape``
    (``{"tree": S_t, "query": S_q}``), the two fields the JAX package's
    code reads of its ``Mesh``."""

    def __init__(self, grid):
        self.devices = np.empty((len(grid), len(grid[0])), dtype=object)
        for i, row in enumerate(grid):
            for j, dev in enumerate(row):
                self.devices[i, j] = torch.device(dev)
        self.shape = {TREE_AXIS: self.devices.shape[0],
                      QUERY_AXIS: self.devices.shape[1]}

    def device(self, i: int, j: int = 0) -> torch.device:
        """The device of tree shard ``i`` and query shard ``j``."""
        return self.devices[i, j]

    @property
    def first(self) -> torch.device:
        """The device that holds the sharded forest's global tensors."""
        return self.devices[0, 0]

    def __repr__(self):
        return (f"ForestMesh(tree={self.shape[TREE_AXIS]}, "
                f"query={self.shape[QUERY_AXIS]}, "
                f"devices={[str(d) for d in self.devices.flatten()]})")


def forest_mesh(n_tree_shards: Optional[int] = None, n_query_shards: int = 1,
                devices: Optional[Sequence] = None) -> ForestMesh:
    """A ``(tree, query)`` mesh over ``devices`` (default: every visible
    CUDA device; with none it raises, as the entry points do, and never
    falls back to the CPU).  ``n_tree_shards`` defaults to the device count
    over ``n_query_shards``: tree parallelism is the workload's first
    scaling direction.  ``n_tree_shards * n_query_shards`` must equal the
    number of devices; a device may be listed more than once."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: forest_mesh() spans the "
                               "visible cards; pass devices= (for example "
                               "[torch.device('cpu')] * 8) to use others")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_tree_shards is None:
        n_tree_shards = max(1, n // max(1, n_query_shards))
    if n_tree_shards * n_query_shards != n:
        raise ValueError(
            f"mesh shape ({n_tree_shards} tree x {n_query_shards} query) "
            f"!= {n} devices")
    return ForestMesh([devices[i * n_query_shards:(i + 1) * n_query_shards]
                       for i in range(n_tree_shards)])
