"""Device mesh of the forest's two parallel axes (``rptree_tpu/parallel/
mesh.py``).

* ``"tree"``: the forest axis.  Trees are independent during the build and
  the candidate generation; only the final top-k merge of a query couples
  them, which becomes a gather of each shard's k best and a re-top-k.
* ``"query"``: the query batch, embarrassingly parallel.
* ``"data"``: the dataset's rows (:func:`data_mesh`), for the
  data-parallel forests of :mod:`.data_parallel`.

The mesh is a grid of ``torch.device`` s driven by one process: each shard's
work is a call on its own device, and the collectives are plain functions
over the shards' tensors (:mod:`.collectives`).  A device may repeat in the
grid.  That is how one device stands in for several: the CPU tests pass
``[torch.device("cpu")] * 8`` where the JAX package's tests take eight
virtual CPU devices, and one card runs four shards with ``[cuda:0] * 4``.

A data mesh may also span the processes of an initialised
``torch.distributed`` process group: each process drives its own devices'
shards, and the collectives reduce over them and then over the group
(:mod:`.collectives`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["forest_mesh", "ForestMesh", "TREE_AXIS", "QUERY_AXIS"]

TREE_AXIS = "tree"
QUERY_AXIS = "query"
DATA_AXIS = "data"


class ProcessSpan:
    """The processes a mesh spans: this process's ``rank`` in a
    ``torch.distributed`` group of ``world`` processes, each driving the
    same number of shards, rank ``r`` the ``r``-th run of them."""

    def __init__(self, rank: int, world: int, backend: str):
        self.rank, self.world, self.backend = int(rank), int(world), backend


class ForestMesh:
    """A grid of devices over two axes (``axes``: ``("tree", "query")``,
    or a data mesh's, whose query axis is named only where it has more
    than one shard): ``devices`` (an object array of ``torch.device``, so
    ``devices.flatten()`` lists them) and ``shape`` (``{"tree": S_t,
    "query": S_q}``), the two fields the JAX package's code reads of its
    ``Mesh``.  ``span``: the processes the mesh spans (None: this one
    alone), whose shards ``local`` (a range of the first axis) this
    process drives; ``devices`` lists theirs only."""

    def __init__(self, grid, axes=(TREE_AXIS, QUERY_AXIS),
                 span: Optional[ProcessSpan] = None):
        self.devices = np.empty((len(grid), len(grid[0])), dtype=object)
        for i, row in enumerate(grid):
            for j, dev in enumerate(row):
                self.devices[i, j] = torch.device(dev)
        rows, cols = self.devices.shape
        self.span = span
        lo = 0 if span is None else span.rank * rows
        self.local = range(lo, lo + rows)
        total = rows if span is None else rows * span.world
        self.shape = dict(zip(axes, (total, cols)))

    def device(self, i: int, j: int = 0) -> torch.device:
        """The device of shard ``i`` (of the first axis, one this process
        drives) and query shard ``j``."""
        return self.devices[i - self.local.start, j]

    @property
    def first(self) -> torch.device:
        """The device that holds the sharded forest's global tensors."""
        return self.devices[0, 0]

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        procs = "" if self.span is None else (
            f", process {self.span.rank} of {self.span.world}")
        return (f"ForestMesh({axes}, "
                f"devices={[str(d) for d in self.devices.flatten()]}{procs})")


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
