"""Sharded forest build and query over a device mesh
(``rptree_tpu/parallel/distributed.py``).

Tree parallelism shards the forest axis ``[T, ...]``, query parallelism
the batch axis ``[B, ...]``; one process drives every shard
(:mod:`.mesh`).  The JAX package's ``shard_map`` bodies become loops over
the mesh's shards, each shard calling the single-device serving functions
of :mod:`..models.forest` on its own tensors and on its own device, and
its collectives become functions over the shards' results
(:mod:`.collectives`):

* the candidate union across trees becomes each shard's exact rerank to
  its k best, a gather of those over the tree axis, and a dedup merge and
  re-top-k (:func:`merge_top_k`);
* the per-tree recall mean becomes a sum of the shards' per-tree recall
  sums (``psum``);
* the build is tree-parallel: each shard builds its trees, no collective.

Where the tensors live.  The forest's :class:`TreeArrays`, its dataset and
norms stay on the mesh's first device, as one global tensor each; a shard
reads its ``[T]``-axis slice of them, a view where its device is the first
device and otherwise one copy a device, kept until the forest changes.
The packed blocks and their tables live in their shards only
(:class:`.collectives.Sharded`): by tree group (``shard_by="tree"``) or
round-robin by leaf (``shard_by="leaf"``: leaf block ``g`` on shard ``g %
S`` at row ``g // S``).  The single-device code that updates a whole table
(``fold``) writes through to the shards.

The data-parallel forests (:mod:`.data_parallel`) serve their leaf-sharded
blocks through this module's leaf-sharded pipeline over the data axis,
and their shared-row layout through its ``all_probes`` mode, a state of
the forest (``_shared_all_probes``) that their pack sets.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ForestConfig
from ..models import forest as fm
from ..models.forest import RPForest
from ..models.plan import make_plan
from ..ops.build import TreeArrays, build_forest_arrays
from ..ops.rerank import gather_leaf_points, merge_top_k, rerank_top_k
from ..ops.shared import SharedRows
from ..ops.sparse import EllBlocks, EllMatrix
from ..ops.topk_kernel import topk_kernel_ok
from ..ops.traverse import NodeTable
from ..utils import gen as rgen
from .collectives import Sharded, all_gather, pmax, psum
from .mesh import QUERY_AXIS, TREE_AXIS, ForestMesh, forest_mesh

__all__ = [
    "DistributedForest",
    "distribute",
    "forest_batch_distributed",
    "merge_top_k",
]

def _pad_k(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Right-pad a ``(dists, ids)`` pair to width ``k`` with ``(inf, -1)``
    (or cut it there), so that every shard gives the gather a block of
    one width."""
    w = ids.shape[-1]
    if w >= k:
        return dists[..., :k], ids[..., :k]
    return (F.pad(dists, (0, k - w), value=float("inf")),
            F.pad(ids, (0, k - w), value=-1))


def _merge(outs, k_eff, k, dedup, min_votes, device, span=None):
    """The cross-shard merge: each shard's ``(dists, ids) [B, <= k_eff]``
    padded to ``k_eff``, gathered on ``device`` in shard order (across
    ``span``'s processes where the mesh spans them), ordered by
    distance (stable) and re-selected by :func:`merge_top_k` (duplicates
    masked; with ``min_votes > 1`` the copies counted as votes).  The
    order makes a point's nearest copy the one kept: on quantized blocks
    its copies in two shards' blocks differ, and the result is then one
    device's (the JAX package keeps the first shard's copy)."""
    padded = [_pad_k(d, i, k_eff) for d, i in outs]
    d_all = all_gather([p[0] for p in padded], device, span)  # [S, B, k_eff]
    i_all = all_gather([p[1] for p in padded], device, span)
    s, b = d_all.shape[:2]
    d_all, order = torch.sort(d_all.transpose(0, 1).reshape(b, s * k_eff),
                              dim=1, stable=True)
    i_all = i_all.transpose(0, 1).reshape(b, s * k_eff).gather(1, order)
    return merge_top_k(d_all, i_all, k, dedup=(dedup or min_votes > 1),
                       min_votes=min_votes)


def _split_rows(t: torch.Tensor, mesh: ForestMesh):
    """``t``'s rows in ``S`` equal contiguous parts, part ``s`` on tree
    shard ``s``'s device: views of ``t`` where every shard is on ``t``'s
    device, else each part a tensor of its own, so that ``t`` itself can
    be freed."""
    s = mesh.shape[TREE_AXIS]
    devs = [mesh.device(i) for i in range(s)]
    parts = list(t.chunk(s))
    if all(d == t.device for d in devs):
        return Sharded(parts)
    return Sharded([p.to(d) if p.device != d else p.clone()
                    for p, d in zip(parts, devs)])


def _shard_table(obj, mesh: ForestMesh):
    """A packed table (a tensor or :class:`EllBlocks`, or a tuple of
    them) with its row axis split over the tree shards."""
    if obj is None:
        return None
    if isinstance(obj, tuple):
        return tuple(_shard_table(o, mesh) for o in obj)
    if isinstance(obj, EllBlocks):
        return EllBlocks(obj.dim, _shard_table(obj.cols, mesh),
                         _shard_table(obj.vals, mesh))
    return _split_rows(obj, mesh)


@torch.no_grad()
def _dist_build(mesh: ForestMesh, plan, x, r) -> TreeArrays:
    """Tree-parallel build: each tree shard runs the level-synchronous
    builder on its slice of the projection stack, on its own device, and
    the shards' trees are stacked on the mesh's first device.  No
    collective; a tree's bits do not depend on its shard."""
    s = mesh.shape[TREE_AXIS]
    tl = r.shape[0] // s
    x_on = {x.device: x}
    parts = []
    for i in range(s):
        dev = mesh.device(i)
        if dev not in x_on:
            x_on[dev] = x.to(dev)
        parts.append(build_forest_arrays(plan, x_on[dev],
                                         r[i * tl:(i + 1) * tl].to(dev)))
    del x_on
    first = mesh.first
    return TreeArrays(*(torch.cat([getattr(p, name).to(first) for p in parts])
                        for name in TreeArrays._fields))


class _Shard:
    """One mesh cell (tree shard ``index``, one query shard) of a
    :class:`DistributedForest`: its ``device`` and its share of the
    forest's tensors there, under the names that the single-device
    serving functions of :mod:`..models.forest` read of a forest, so that
    they take a shard where they take a forest.  ``arrays``, ``table`` and
    ``leaf_lens`` are the shard's trees'; ``small_*`` the whole forest's
    structure, which the leaf-sharded layout replicates; ``_packed`` and
    its tables the shard's storage rows, ``lens`` their occupancy (on the
    data-parallel shared rows, the shard's own members of every block);
    ``x`` and ``sq_norms`` the dataset the shard reranks from (a
    data-parallel shard's own rows)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def _table(self):
        return self.table

    def _leaf_lens(self):
        return self.leaf_lens

    def _lens_global(self):
        return self.lens


class DistributedForest(RPForest):
    """An :class:`RPForest` sharded over a device mesh.

    Queries run tree- and query-parallel, with a gather of each shard's k
    best and a re-top-k; every inherited accessor (``leaves``,
    ``tree_stats``, ``save_forest``, rendering) and the updates (``add``,
    ``remove``, ``fold``) keep working, because the forest's global
    tensors are ordinary tensors on the mesh's first device and the
    sharded tables take the whole-table updates (``Sharded``).
    """

    _index_axis = TREE_AXIS  # blocks shard over the tree axis

    def __init__(self, plan, arrays, x, sq_norms, config, mesh: ForestMesh,
                 payloads: Optional[Sequence] = None, seed=None):
        super().__init__(plan, arrays, x, sq_norms, config,
                         payloads=payloads, seed=seed)
        self.mesh = mesh
        if self._index_axis == TREE_AXIS:
            n_shards = mesh.shape[TREE_AXIS]
            if self.n_trees % n_shards:
                raise ValueError(f"n_trees={self.n_trees} not divisible by "
                                 f"tree shards {n_shards}")
        self._packed_mode = None  # "tree" or "leaf" once packed
        self._row_block = None    # leaf layout: global block of each row
        self._cells = None        # per query shard, the tree shards' cells
        self._lens_rows = None    # occupancy in storage-row order
        self._shared_all_probes = False  # data-parallel shared rows
        self._shared_len_loc = None      # their per-shard occupancy

    @property
    def _s_q(self) -> int:
        """Query shards (1 where the mesh names no query axis)."""
        return self.mesh.shape.get(QUERY_AXIS, 1)

    # -- the shards' views ------------------------------------------------

    def _invalidate(self):
        """Forget the cells and the storage-order occupancy (rebuilt on
        next use): the tables they view or copy have changed."""
        self._cells = None
        self._lens_rows = None

    def _drop_pack(self) -> None:
        super()._drop_pack()
        self._packed_mode = None
        self._row_block = None
        self._shared_all_probes = False
        self._shared_len_loc = None
        self._invalidate()

    def _store_block_len(self, bl: np.ndarray) -> None:
        """The fold's occupancy, in global block order (the bucket stop
        counts it by global block) and, derived from it on next use, in
        storage-row order (the scorers read it by row)."""
        super()._store_block_len(bl)
        self._invalidate()

    def drop_dataset(self) -> "DistributedForest":
        super().drop_dataset()
        self._invalidate()
        return self

    def _fold_row_of(self, g):
        """Storage row of global block ``g``: itself on the tree-sharded
        layout; on the leaf-sharded one block ``g`` is on shard ``g % S``
        at local row ``g // S``, global row ``(g % S) * G/S + g // S``."""
        if self._packed_mode != "leaf":
            return g
        s = self.mesh.shape[self._index_axis]
        rows = int(self._packed[0].shape[0])  # padded block count
        return (g % s) * (rows // s) + g // s

    def _storage_lens(self) -> torch.Tensor:
        """Each storage row's occupancy ``int32[G_rows]`` on the first
        device: :meth:`_lens_global` reordered by the leaf layout's rows
        (padding rows hold nothing), as it is on the tree layout."""
        if self._lens_rows is None:
            lens = self._lens_global()
            if self._row_block is not None:
                rb = self._row_block
                lens = torch.where(rb >= 0, lens[rb.clamp_min(0)], 0).to(
                    torch.int32)
            self._lens_rows = lens
        return self._lens_rows

    def _cell_list(self, j: int):
        """The cells of query shard ``j``, one a tree shard."""
        if self._cells is None:
            self._cells = self._make_cells()
        return self._cells[j]

    def _cell_data(self, i, put, dev):
        """Shard ``i``'s dataset and norms on ``dev`` for the unpacked
        paths: the whole dataset (``put``: a view or a cached copy); none
        once packed, where the blocks serve."""
        if self._packed is not None:
            return None, None
        return put(self.x, dev), put(self.sq_norms, dev)

    def _make_cells(self):
        mesh = self.mesh
        s_t, s_q = mesh.shape[self._index_axis], self._s_q
        by_tree = self._index_axis == TREE_AXIS
        tl, nl = (self.n_trees // s_t if by_tree else self.n_trees,
                  self.plan.n_leaves)
        leaf = self._packed_mode == "leaf"
        packed = self._packed is not None
        copies = {}

        def put(t, dev, lo=None, hi=None):
            """``t[lo:hi]`` on ``dev``: a view where ``t`` is there, else
            one copy a device (``t`` is a tensor this forest holds, so its
            id is stable while the cells are made)."""
            if t is None:
                return None
            if isinstance(t, EllMatrix):
                return t if t.device == dev else copies.setdefault(
                    (id(t), dev), t.to(dev))
            if t.device == dev:
                return t[lo:hi]
            key = (id(t), lo, hi, dev)
            if key not in copies:
                copies[key] = t[lo:hi].to(dev)
            return copies[key]

        def part(obj, i, dev):
            """Tree shard ``i``'s part of a packed table on ``dev``."""
            if obj is None:
                return None
            if isinstance(obj, tuple):
                return tuple(part(o, i, dev) for o in obj)
            if isinstance(obj, SharedRows):
                rows = (part(obj.rows, i, dev) if isinstance(obj.rows, Sharded)
                        else put(obj.rows, dev))
                return SharedRows(rows, part(obj.ids, i, dev))
            if isinstance(obj, EllBlocks):
                return EllBlocks(obj.dim, part(obj.cols, i, dev),
                                 part(obj.vals, i, dev))
            return put(obj.part(i), dev)

        a, table = self.arrays, self._table()
        leaf_lens = self._leaf_lens()
        local_lens = self._shared_len_loc
        lens = (self._storage_lens() if packed and local_lens is None
                else None)
        rows = int(self._packed[0].shape[0]) // s_t if packed else 0
        cells = []
        for j in range(s_q):
            col = []
            for i in mesh.local:
                dev = mesh.device(i, j)
                t0, t1 = (i * tl, (i + 1) * tl) if by_tree else (0, tl)
                x, sq = self._cell_data(i, put, dev)
                cell = _Shard(
                    index=i, device=dev, plan=self.plan, n_trees=tl,
                    arrays=TreeArrays(*(put(t, dev, t0, t1) for t in a)),
                    table=NodeTable(put(table.rec, dev, t0, t1),
                                    put(table.level_off, dev), table.offsets),
                    leaf_lens=put(leaf_lens, dev, t0 * nl, t1 * nl),
                    x=x, sq_norms=sq,
                    _packed=part(self._packed, i, dev),
                    _block_scale=part(self._block_scale, i, dev),
                    _block_center=part(self._block_center, i, dev),
                    lens=(part(local_lens, i, dev) if local_lens is not None
                          else put(lens, dev, i * rows, (i + 1) * rows)
                          if packed else None),
                    _sub_block=self._sub_block)
                if leaf:
                    # the replicated structure: every shard selects from
                    # all trees, then keeps the probes it owns
                    cell.n_trees = self.n_trees
                    cell.small_arrays = TreeArrays(
                        *(put(t, dev) for t in a[:4]), perm=None)
                    cell.small_table = NodeTable(
                        put(table.rec, dev), put(table.level_off, dev),
                        table.offsets)
                    cell.small_leaf_lens = put(leaf_lens, dev)
                col.append(cell)
            cells.append(col)
        return cells

    def _over_queries(self, qb, chunk, fn):
        """``fn(cells, q)`` over the mesh: query shard ``j`` takes the
        ``j``-th equal slice of ``qb`` (a multiple of ``S_q`` rows) in
        chunks of ``chunk`` rows (None: whole) and gives each chunk to its
        cells.  The chunks' ``(dists, ids)`` are concatenated in query
        order on the first device; a third output (the tile count a
        chunk needed) is reduced to its maximum."""
        s_q = self._s_q
        bl = qb.shape[0] // s_q
        step = bl if chunk is None else max(1, int(chunk))
        outs = []
        for j in range(s_q):
            cells = self._cell_list(j)
            qj = qb[j * bl:(j + 1) * bl]
            for s in range(0, bl, step):
                outs.append(fn(cells, qj[s:s + step]))
        first = self.device
        res = [torch.cat([o[n].to(first) for o in outs]) for n in range(2)]
        if len(outs[0]) > 2:
            res.append(torch.stack([o[2].to(first) for o in outs]).amax())
        return tuple(res)

    def _pad_queries(self, qb: torch.Tensor):
        """``qb`` padded with zero rows to a multiple of the query shards,
        and its own row count."""
        s = self._s_q
        b = qb.shape[0]
        pad = (-b) % s
        if pad:
            qb = torch.cat([qb, qb.new_zeros((pad, qb.shape[1]))])
        return qb, b

    def _queries(self, q):
        return self._pad_queries(fm._as_dense_queries(q, self.dim,
                                                      self.device))

    # -- the tree-sharded pipeline ----------------------------------------

    def _bucket_keep(self, trav, k, device):
        """The reference knnH's global stop rule over every shard's
        buckets (``trav``: each shard's ``(leaf_ids, prio) [Tl, B, F]``):
        the buckets gathered in global tree order, ordered by priority
        (stable), kept while the running size stays ``<= k`` (the first
        always).  The same ``bool[B, T * F]`` mask for every shard, made
        once on ``device``."""
        leafs, prios = [], []
        for leaf_ids, prio in trav:
            tl, b, fw = leaf_ids.shape
            leafs.append(leaf_ids.transpose(0, 1).reshape(b, tl * fw))
            prios.append(prio.transpose(0, 1).reshape(b, tl * fw))
        s = len(trav)
        m = s * tl * fw
        leaf_g = all_gather(leafs, device).transpose(0, 1).reshape(b, m)
        prio_g = all_gather(prios, device).transpose(0, 1).reshape(b, m)
        lens = self._leaf_lens().to(device)
        tree_of = torch.arange(m, device=device) // fw
        gblock = tree_of[None, :] * self.plan.n_leaves + leaf_g.clamp_min(0)
        sizes = torch.where(leaf_g >= 0, lens[gblock.long()], 0)
        order = torch.sort(prio_g, dim=1, stable=True).indices
        csum = torch.cumsum(sizes.gather(1, order), dim=1)
        keep_sorted = (csum <= k) | (torch.arange(m, device=device) == 0)
        return torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)

    def _tree_chunk(self, cells, q, k, budget, probes, metric, dedup,
                    variant, min_votes):
        """One chunk of the tree-sharded pipeline (``_dist_knn``): each
        shard serves its trees (``variant`` "flat"; "h" / "h_packed" keep
        only the buckets of the global stop rule, a gather between the
        shards' two passes), then the merge."""
        plan, sub = self.plan, self._sub_block
        packed = self._packed is not None
        tl = self.n_trees // len(cells)
        if min_votes > 1:
            # the full local candidate width: vote copies must not be cut
            lmax = (int(self._packed[0].shape[1]) if packed
                    else max(plan.max_leaf_len, 1))
            k_eff = (probes if packed else tl * budget) * sub * lmax
            dedup_eff = False
        else:
            k_eff, dedup_eff = k, dedup
        qs = [q.to(c.device) for c in cells]
        if variant == "flat":
            outs = [fm._knn_packed(c, qc, k_eff, budget, probes, metric,
                                   dedup_eff) if packed else
                    fm._knn(c, qc, k_eff, budget, metric, dedup_eff)
                    for c, qc in zip(cells, qs)]
        else:
            trav = [fm._traverse_forest(plan, c.arrays, qc, budget, c.table)
                    for c, qc in zip(cells, qs)]
            keep = self._bucket_keep(trav, k, cells[0].device)
            outs = []
            for (leaf_ids, _), c, qc in zip(trav, cells, qs):
                tl_, b, fw = leaf_ids.shape
                w = tl_ * fw
                mine = keep[:, c.index * w:(c.index + 1) * w].to(c.device)
                leaf_kept = torch.where(
                    mine, leaf_ids.transpose(0, 1).reshape(b, w), -1)
                if variant == "h":
                    lk = leaf_kept.reshape(b, tl_, fw).transpose(0, 1)
                    cand = torch.stack([
                        gather_leaf_points(plan, c.arrays.perm[t], lk[t])
                        for t in range(tl_)])           # [Tl, B, F * lmax]
                    union = cand.transpose(0, 1).reshape(b, -1)
                    outs.append(rerank_top_k(c.x, c.sq_norms, qc, union,
                                             k_eff, metric, dedup=dedup_eff))
                    continue
                # the kept buckets scored on the shard's packed blocks
                tree_of = torch.arange(
                    tl_, dtype=torch.int32,
                    device=c.device).repeat_interleave(fw)[None, :]
                rows = torch.where(leaf_kept >= 0, tree_of * plan.n_leaves
                                   + leaf_kept.clamp_min(0), 0)
                lsel = leaf_kept
                if sub > 1:
                    rows, lsel = fm._expand_sub_probes(rows, leaf_kept, sub)
                kk = k_eff * tl_ if dedup_eff else k_eff
                outs.append(fm._score_blocks(c, rows, lsel, qc, k_eff, kk,
                                             metric, dedup_eff))
        return _merge(outs, k_eff, k, dedup, min_votes, cells[0].device)

    # -- the leaf-sharded pipeline ----------------------------------------

    def _leaf_chunk(self, cells, q, k, budget, probes, probes_per_shard,
                    metric, dedup, min_votes, bucket_stop=False,
                    grouped=None):
        """One chunk of the leaf-sharded pipeline
        (``_dist_knn_leaf_sharded``): every shard selects the probes over
        the whole (replicated) forest structure, keeps the
        ``probes_per_shard`` best it owns (block ``g`` on shard ``g % S``),
        compacted in priority order, and scores them per pair or, with
        ``grouped = (tile_m, nt, tile_chunk, impl, selection)``, grouped
        (``nt`` a shard's tile capacity); then the merge.  Grouped, the
        third output is the most tiles a shard needed.

        In the ``all_probes`` mode (the data-parallel shared rows,
        ``_shared_all_probes``) every shard holds a table of its own
        members for every block, so there is no ownership filter: each
        shard scores every selected probe against its part of the block
        (``rows = gsel``, its occupancy the shard's local counts), and the
        merge is exact, each member row being one shard's."""
        n_sh, sub = self.mesh.shape[self._index_axis], self._sub_block
        span = self.mesh.span
        all_probes = self._shared_all_probes
        pps = int(probes) if all_probes else int(probes_per_shard)
        if min_votes > 1:
            # the full owned-probe width: vote copies must not be cut
            k_eff = pps * sub * int(self._packed[0].shape[1])
            dedup_eff = False
        else:
            k_eff, dedup_eff = k, dedup
        kk = k_eff * self.n_trees if dedup_eff else k_eff
        outs, needs = [], []
        for c in cells:
            qc = q.to(c.device)
            gsel, lsel = fm._select_probes(
                self.plan, c.small_arrays, qc, budget, probes, k=k,
                bucket_stop=bucket_stop, block_len=c.small_leaf_lens,
                table=c.small_table)
            m = gsel.shape[-1]
            if all_probes:
                rows, l_s = torch.where(lsel >= 0, gsel, 0), lsel
            else:
                mine = (lsel >= 0) & (gsel % n_sh == c.index)
                keep = mine & (torch.cumsum(mine.to(torch.int32), dim=-1)
                               <= pps)
                # my highest-priority owned probes, compacted to the front
                # in their priority order
                key = torch.where(keep, torch.arange(m, device=c.device), m)
                key_s, order = torch.sort(key, dim=-1, stable=True)
                order, pad = order[:, :pps], key_s[:, :pps] >= m
                l_s = torch.where(pad, -1, lsel.gather(1, order))
                rows = torch.where(pad, 0, gsel.gather(1, order) // n_sh)
            if sub > 1:
                # a leaf's sub-blocks are the sub contiguous rows under
                # its local leaf row
                rows, l_s = fm._expand_sub_probes(rows, l_s, sub)
            if grouped is None:
                outs.append(fm._score_blocks(c, rows, l_s, qc, k_eff, kk,
                                             metric, dedup_eff))
                continue
            tile_m, nt, tile_chunk, impl, selection = grouped
            if impl == "kernel_topk" and min_votes > 1:
                impl = "kernel"  # vote counting needs the full lists
            d, i, need = fm._grouped_pairs(
                c, rows, l_s, qc, k_eff, kk, metric, dedup_eff, tile_m, nt,
                tile_chunk, 1, selection, impl, topk_tail=selection)
            outs.append((d, i))
            needs.append(need)
        dev = cells[0].device
        out = _merge(outs, k_eff, k, dedup, min_votes, dev, span)
        if grouped is None:
            return out
        return out + (pmax(needs, dev, span).reshape(1),)

    # -- packing ----------------------------------------------------------

    @torch.no_grad()
    def pack_leaves(self, dtype=None, shard_by: Optional[str] = None,
                    slack: int = 0, centered: bool = False,
                    sub_block: int = 1, sub_split: str = "kmeans",
                    store: str = "blocks", *, r_sub=None
                    ) -> "DistributedForest":
        """Leaf-blocked packing, sharded over the tree axis; the layouts
        and their parameters are :meth:`RPForest.pack_leaves`', in the JAX
        package's order, with ``shard_by`` second.

        ``shard_by="tree"``: each shard holds its tree group's blocks.
        ``shard_by="leaf"``: blocks round-robin by global leaf (leaf ``g``
        on shard ``g % S`` at row ``g // S``, padding rows of id -1 where
        ``S`` does not divide the leaves, a leaf's sub-blocks contiguous
        on its owner): a shard holds 1/S of the index and serves the
        probes it owns.  ``shard_by=None`` keeps the current mode when
        packed and means ``"tree"`` on a first pack.  ``store="shared"``
        keeps one row store, the dataset, whole, and shards only the id
        and norm tables.  The blocks are packed on the first device, as
        one forest packs them, then cut into the shards' parts."""
        if shard_by is None:
            shard_by = (self._packed_mode if self._packed is not None
                        else None) or "tree"
        if shard_by not in ("tree", "leaf"):
            raise ValueError("shard_by must be 'tree' or 'leaf'")
        cfg = self._validate_pack_args(dtype, slack, centered, sub_block,
                                       sub_split, store)
        if self._packed is not None:
            if cfg == self._pack_cfg and shard_by == self._packed_mode:
                return self
            self._clear_pack_for_repack()
        super().pack_leaves(dtype, slack, centered, sub_block, sub_split,
                            store, r_sub=r_sub)
        if shard_by == "leaf":
            self._round_robin()
        mesh = self.mesh
        blocks, sq, ids = self._packed
        ids = _shard_table(ids, mesh)
        # a shared row store stays whole (every tree indexes every point)
        blocks = (SharedRows(blocks.rows, ids) if isinstance(blocks, SharedRows)
                  else _shard_table(blocks, mesh))
        self._packed = (blocks, _shard_table(sq, mesh), ids)
        self._block_scale = _shard_table(self._block_scale, mesh)
        self._block_center = _shard_table(self._block_center, mesh)
        self._packed_mode = shard_by
        self._invalidate()
        return self

    def _round_robin(self) -> None:
        """Reorder the packed tables (global block order) into the leaf
        layout's storage rows: leaf ``g`` at row ``(g % S) * Gl/S + g //
        S`` (``Gl`` the leaves padded to a multiple of ``S``), its ``sub``
        sub-blocks contiguous; padding rows copy the last leaf's blocks
        with ids -1.  ``_row_block`` keeps each row's global block (-1 on
        padding)."""
        s_blk, n_sh = self._sub_block, self.mesh.shape[TREE_AXIS]
        g_leaf = int(self._packed[2].shape[0]) // s_blk
        pad_l = (-g_leaf) % n_sh
        idx = np.arange(g_leaf + pad_l)
        rr_leaf = np.concatenate([idx[s::n_sh] for s in range(n_sh)])
        pad_row = np.repeat(rr_leaf >= g_leaf, s_blk)
        rr = (np.clip(rr_leaf, 0, g_leaf - 1)[:, None] * s_blk
              + np.arange(s_blk)[None, :]).reshape(-1)
        dev = self.device
        rr_t = torch.as_tensor(rr, device=dev)
        pad_t = torch.as_tensor(pad_row, device=dev)

        def take(t):
            if t is None:
                return None
            if isinstance(t, tuple):
                return tuple(take(a) for a in t)
            if isinstance(t, SharedRows):
                return SharedRows(t.rows, take(t.ids))
            if isinstance(t, EllBlocks):
                return EllBlocks(t.dim, take(t.cols), take(t.vals))
            return t[rr_t]

        blocks, sq, ids = self._packed
        ids = torch.where(pad_t[:, None], -1, take(ids))
        if isinstance(blocks, SharedRows):
            blocks = SharedRows(blocks.rows, ids)
        else:
            blocks = take(blocks)
        self._packed = (blocks, take(sq), ids)
        self._block_scale = take(self._block_scale)
        self._block_center = take(self._block_center)
        self._row_block = torch.where(pad_t, -1, rr_t)

    def _replay_pack(self, cfg) -> None:
        mode = self._packed_mode
        self._drop_pack()
        self.pack_leaves(fm._BLOCK_DTYPES[cfg.dtype], mode, cfg.slack,
                         cfg.centered, cfg.sub_block,
                         cfg.sub_split or "kmeans", cfg.store,
                         r_sub=self._r_sub)

    def _build_arrays(self, plan, x, r) -> TreeArrays:
        return _dist_build(self.mesh, plan, x, r)

    def rebuild(self) -> "DistributedForest":
        """:meth:`RPForest.rebuild` with the tree-parallel build, the pack
        replayed in its shard mode: the forest stays sharded."""
        super().rebuild()
        self._invalidate()
        return self

    # -- sharded query paths ----------------------------------------------

    def _part0(self):
        """Tree shard 0's blocks, for the checks that look at a layout."""
        return self._cell_list(0)[0]._packed[0]

    @torch.no_grad()
    def knn(self, q, k: int, metric="l2", budget: Optional[int] = None,
            dedup: bool = True, precision: str = "highest",
            probes: Optional[int] = None,
            probes_per_shard: Optional[int] = None, min_votes: int = 1):
        """k nearest neighbours, tree- and query-parallel; the parameters
        are the JAX package's.  On leaf-sharded blocks ``probes`` caps the
        probes over all trees (default ``n_trees * budget``) and
        ``probes_per_shard`` those a shard scores (default ``probes``: no
        owned probe is dropped); elsewhere ``probes`` caps each shard's
        probes (default its trees times ``budget``).  Each shard serves
        its part as :meth:`RPForest.knn` would, and the merge re-selects
        over the shards' k best."""
        if self._packed is None:
            self._require_x("the unpacked path")
        return self._per_pair(q, k, metric, budget, dedup, precision, probes,
                              probes_per_shard, min_votes, None)

    @torch.no_grad()
    def knn_batched(self, q, k: int, metric="l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest", probes: Optional[int] = None,
                    probes_per_shard: Optional[int] = None,
                    min_votes: int = 1, chunk: int = 4096):
        """:meth:`knn` over a large batch, each query shard's slice
        ``chunk`` queries at a time (a shorter last chunk), so that the
        rerank buffers stay per chunk; results equal :meth:`knn`'s.
        Requires :meth:`pack_leaves`."""
        if self._packed is None:
            raise ValueError("pack_leaves() first: knn_batched runs the "
                             "leaf-blocked pipeline")
        return self._per_pair(q, k, metric, budget, dedup, precision, probes,
                              probes_per_shard, min_votes, int(chunk))

    def _per_pair(self, q, k, metric, budget, dedup, precision, probes,
                  probes_per_shard, min_votes, chunk):
        """:meth:`knn` / :meth:`knn_batched`: each query shard's slice in
        chunks of ``chunk`` (None: whole) through the leaf- or
        tree-sharded pipeline, then the tombstones and the pending
        merge."""
        k = self._check_k(k)
        fm._check_precision(precision)
        min_votes = int(min_votes)
        qb, b = self._queries(q)
        if chunk is not None:
            chunk = max(1, min(chunk, qb.shape[0] // self._s_q))
        budget = self._budget(budget)
        if self._packed_mode == "leaf":
            probes = self.n_trees * budget if probes is None else int(probes)
            pps = probes if probes_per_shard is None else probes_per_shard
            d, i = self._over_queries(qb, chunk, lambda cells, qc: (
                self._leaf_chunk(cells, qc, k, budget, probes, pps, metric,
                                 dedup, min_votes)))
        else:
            if probes is None:
                probes = (self.n_trees // self.mesh.shape[TREE_AXIS]) * budget
            d, i = self._over_queries(qb, chunk, lambda cells, qc: (
                self._tree_chunk(cells, qc, k, budget, int(probes), metric,
                                 dedup, "flat", min_votes)))
        return self._apply_update_hooks(qb[:b], d[:b], i[:b], k, metric,
                                        precision)

    @torch.no_grad()
    def knn_grouped(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest", probes: Optional[int] = None,
                    probes_per_shard: Optional[int] = None,
                    min_votes: int = 1, tile_m: int = 16,
                    nt: Optional[int] = None, tile_chunk: int = 2048,
                    chunk: Optional[int] = None, impl: str = "auto",
                    check: bool = True, selection: str = "sort"):
        """Query-grouped kNN on the leaf-sharded blocks: each shard tiles
        its owned (query, probe) pairs by block and scores them as
        :meth:`RPForest.knn_grouped` does (kernels 9, then 1 / 2, or 4 with
        ``impl="kernel_topk"``, under either tail); the merge is
        :meth:`knn`'s.  ``nt`` is a shard's tile capacity per chunk,
        sized automatically as on one device (the most tiles any shard
        needed is read once a call, unless ``check=False``).
        ``selection="kernel"`` takes the sort tail when ``min_votes > 1``.
        On the data-parallel shared rows every shard scores every probe
        (the ``all_probes`` mode) and ``probes_per_shard`` is ignored."""
        if self._packed_mode != "leaf":
            raise ValueError("pack_leaves(shard_by='leaf') first: the "
                             "sharded knn_grouped serves the leaf-sharded "
                             "blocks; other layouts serve through knn()")
        if callable(metric):
            raise ValueError("knn_grouped supports builtin metrics only; "
                             "use knn() for distance callables")
        k = self._check_k(k)
        fm._check_precision(precision)
        min_votes = int(min_votes)
        if selection == "kernel":
            # vote counting keeps full candidate lists: the sort tail
            if min_votes > 1:
                selection = "sort"
            elif not topk_kernel_ok(2, k):
                raise ValueError("selection='kernel' needs k <= 128; use "
                                 "selection='sort'")
        fm._check_selection(selection, k, min_votes)
        if impl not in fm._IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        fm._grouped_use_kernel(impl, self._part0(), metric,
                               self._block_center)  # raises early
        qb, b = self._queries(q)
        budget = self._budget(budget)
        probes = self.n_trees * budget if probes is None else int(probes)
        pps = (probes if probes_per_shard is None or self._shared_all_probes
               else int(probes_per_shard))
        sub = self._sub_block
        b_local = qb.shape[0] // self._s_q
        step = b_local if chunk is None else max(1, min(int(chunk), b_local))

        def run(cap):
            d, i, needed = self._over_queries(qb, step, lambda cells, qc: (
                self._leaf_chunk(cells, qc, k, budget, probes, pps, metric,
                                 dedup, min_votes,
                                 grouped=(int(tile_m), cap, int(tile_chunk),
                                          impl, selection))))
            return (d, i), needed

        key = (qb.shape[0], pps, int(tile_m), sub,
               chunk if chunk is not None else 0)
        d, i = fm._grouped_auto_capacity(self, key, step * pps * sub, tile_m,
                                         nt, run, check=check)
        return self._apply_update_hooks(qb[:b], d[:b], i[:b], k, metric,
                                        precision)

    @torch.no_grad()
    def knn_h(self, q, k: int, metric="l2", budget: Optional[int] = None,
              dedup: bool = True, precision: str = "highest",
              probes: Optional[int] = None):
        """Margin-priority kNN with the reference's global bucket stop:
        every shard's bucket priorities and sizes gathered, the same
        cutoff applied, each shard reranking only its own kept buckets,
        then the merge.  On packed blocks (also after ``drop_dataset``)
        tree-sharded blocks score the kept buckets directly; leaf-sharded
        ones apply the stop on the replicated structure before the
        ownership filter."""
        k = self._check_k(k)
        fm._check_precision(precision)
        qb, b = self._queries(q)
        budget = self._budget(budget)
        if self._packed_mode == "leaf":
            probes = self.n_trees * budget if probes is None else int(probes)
            d, i = self._over_queries(qb, None, lambda cells, qc: (
                self._leaf_chunk(cells, qc, k, budget, probes, probes,
                                 metric, dedup, 1, bucket_stop=True)))
        else:
            if self._packed is None:
                self._require_x("the unpacked path")
            variant = "h" if self._packed is None else "h_packed"
            d, i = self._over_queries(qb, None, lambda cells, qc: (
                self._tree_chunk(cells, qc, k, budget, 1, metric, dedup,
                                 variant, 1)))
        return self._apply_update_hooks(qb[:b], d[:b], i[:b], k, metric,
                                        precision)

    @torch.no_grad()
    def recall_with(self, q, k: int, metric="l2",
                    budget: Optional[int] = None) -> torch.Tensor:
        """Mean per-tree recall@k: each shard sums its trees' recall of
        the exact k nearest (the fp32 scan, folded rows included, made
        once on the first device), the sums added over the shards and
        divided by the tree count.  A folded row is a tree's candidate
        where the leaf it was folded into is among the descent's."""
        self._require_x("recall")
        k = self._check_k(k)
        qb, b = self._queries(q)
        budget = self._budget(budget)
        _, exact = self.brute_force_knn(qb, k, metric=metric)
        folded = (torch.as_tensor(np.concatenate(self._folded_leaf, axis=1),
                                  device=self.device)
                  if self.n_folded else None)
        n, t_all = self.plan.n, self.n_trees
        s_q = self.mesh.shape[QUERY_AXIS]
        bl = qb.shape[0] // s_q
        outs = []
        for j in range(s_q):
            cells = self._cell_list(j)
            sums = []
            for c in cells:
                qc = qb[j * bl:(j + 1) * bl].to(c.device)
                ex = exact[j * bl:(j + 1) * bl].to(c.device)
                leaf_sel, _ = fm._traverse_forest(self.plan, c.arrays, qc,
                                                  budget, c.table)
                found = fm._found(ex, fm._candidate_ids(
                    self.plan, c.arrays, qc, budget, leaf_ids=leaf_sel))
                if folded is not None:
                    tl = t_all // len(cells)
                    fl = folded[c.index * tl:(c.index + 1) * tl].to(c.device)
                    fleaf = fl[:, (ex.long() - n).clamp(0, fl.shape[1] - 1)]
                    found_f = (leaf_sel[:, :, None, :]
                               == fleaf[..., None]).any(-1)
                    found = torch.where((ex >= n)[None], found_f, found)
                sums.append((found.sum(-1).float() / k).sum(0))
            outs.append(psum(sums, cells[0].device).to(self.device) / t_all)
        return torch.cat(outs)[:b]

    def __repr__(self):
        return (f"DistributedForest(trees={self.n_trees}, n={self.n_points}, "
                f"dim={self.dim}, {self.mesh!r}, {self.plan!r})")


def distribute(forest: RPForest, mesh: Optional[ForestMesh] = None
               ) -> DistributedForest:
    """Shard an existing forest over a mesh (an index built elsewhere or
    restored from a checkpoint); its global tensors go to the mesh's first
    device (shared, where they are there already).  Pending inserts,
    tombstones and folded rows are single-device state: ``rebuild()``
    first.  The forest is not packed; pack it with its shard mode."""
    if mesh is None:
        mesh = forest_mesh()
    if (getattr(forest, "_pending", None) or getattr(forest, "n_deleted", 0)
            or getattr(forest, "n_folded", 0)):
        raise ValueError("rebuild() before distribute(): pending inserts / "
                         "tombstones are single-device state")
    first = mesh.first
    arrays = TreeArrays(*(t.to(first) for t in forest.arrays))
    x = forest.x.to(first) if forest.x is not None else None
    sq = forest.sq_norms.to(first) if forest.sq_norms is not None else None
    return DistributedForest(forest.plan, arrays, x, sq, forest.config, mesh,
                             payloads=forest.payloads, seed=forest.seed)


@torch.no_grad()
def forest_batch_distributed(seed, max_depth: int, min_leaf: int,
                             n_trees: int, pnz: float, data,
                             mesh: Optional[ForestMesh] = None,
                             payloads: Optional[Sequence] = None,
                             dtype=torch.float32, *, r=None
                             ) -> DistributedForest:
    """Tree-parallel batch build (the sharded ``forestBatch``): sample the
    projection stack (or take ``r [n_trees, max_depth, D]``, the port's
    own keyword), cut it over the tree axis and build each shard's trees
    on its device; the dataset is on the mesh's first device.  The
    parameters are the JAX package's, in its order."""
    if mesh is None:
        mesh = forest_mesh()
    x, sq_norms, dim, n = fm._prepare_data(data, dtype, mesh.first)
    n_shards = mesh.shape[TREE_AXIS]
    if n_trees % n_shards:
        raise ValueError(f"n_trees={n_trees} not divisible by tree shards "
                         f"{n_shards}")
    plan = make_plan(n, max_depth, min_leaf)
    if r is None:
        r = rgen.sample_projections(seed, n_trees, max_depth, dim, pnz,
                                    device=x.device)
    else:
        r = torch.as_tensor(r, dtype=torch.float32, device=x.device)
        if tuple(r.shape) != (n_trees, max_depth, dim):
            raise ValueError(f"r must be {(n_trees, max_depth, dim)}, "
                             f"got {tuple(r.shape)}")
    arrays = _dist_build(mesh, plan, x, r)
    cfg = ForestConfig(n_trees=n_trees, max_depth=max_depth,
                       min_leaf=min_leaf, proj_nz_density=pnz, dim=dim)
    return DistributedForest(plan, arrays, x, sq_norms, cfg, mesh,
                             payloads=payloads, seed=seed)
