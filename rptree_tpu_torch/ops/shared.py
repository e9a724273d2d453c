"""Shared-row serving layout (``rptree_tpu/ops/shared.py``): one copy of
the dataset and per-tree slot-to-point id tables.

The blocked pack (:meth:`..models.forest.RPForest.pack_leaves`) copies each
tree's leaves into contiguous row blocks: T copies of the dataset on the
card.  ``pack_leaves(store="shared")`` keeps one row store (the dataset
tensor itself for f32, a bf16 copy for bf16) and packs only the ids and
slot norms of every block, so a probed block is fetched row by row through
its id table.  Kernel 6 (:func:`.fused_gather.gather_score`) reads shared
rows in that way; the grouped path fetches them with :func:`fetch_blocks`
(the XLA form, as in the JAX package).

The scored rows are the same f32 or bf16 rows a blocked pack would copy,
so results equal the blocked layout's.
"""

from __future__ import annotations

import torch

__all__ = ["SharedRows", "fetch_blocks"]


class SharedRows:
    """Shared-row stand-in for the block tensor ``x_leaf``: ``rows f32 or
    bf16[N, D]`` and ``ids int32[G, lmax]`` (each block's slot -> point
    id, -1 in empty slots).  It has the block tensor's ``shape``, ``dtype``
    and ``device``, so masks and capacities are layout-blind; only the
    block fetch dispatches (:func:`fetch_blocks`).  It is not a
    ``torch.Tensor``, so the tile kernels' gate
    (``grouped_kernel_ok``) refuses it."""

    def __init__(self, rows: torch.Tensor, ids: torch.Tensor):
        self.rows = rows
        self.ids = ids

    @property
    def shape(self):
        g, lmax = self.ids.shape
        return torch.Size((g, lmax, self.rows.shape[-1]))

    @property
    def dtype(self):
        return self.rows.dtype

    @property
    def device(self):
        return self.rows.device


def fetch_blocks(x_leaf, idx):
    """The blocks ``[..., lmax, D]`` at block indices ``idx``: one block
    gather on a block tensor; on :class:`SharedRows` the id table's rows,
    then the rows they name, and zeros in empty slots, as a blocked pack's
    padding slots hold (every caller masks them by occupancy; the JAX
    package reads row 0 there).  Kernel 6's shared-row mode reads no row
    for an empty slot either."""
    if isinstance(x_leaf, SharedRows):
        ids = x_leaf.ids[idx]
        rows = x_leaf.rows[ids.long().clamp_min(0)]
        return torch.where((ids >= 0)[..., None], rows, 0)
    return x_leaf[idx]
