"""Data-parallel forests: the dataset sharded over points
(``rptree_tpu/parallel/data_parallel.py``).

For a dataset larger than one card's memory.  Shard ``s`` of a ``data``
mesh (:func:`data_mesh`) holds rows ``[s * N/S, (s + 1) * N/S)`` of the
dataset, a :class:`.collectives.Sharded` (views of the caller's tensor
where every shard is on its device), and nothing but ``rebuild`` and
``points()`` makes it whole:

1. the build (:func:`forest_batch_data_parallel`): every shard projects
   its own rows (kernel 11 on the card), and the medians and margins of
   every (tree, level, segment) are exact order statistics of the global
   projection multiset, found by a **distributed radix selection** on the
   32-bit monotone integer image of the float projections: 32 rounds from
   the most significant bit, each counting ``keys < candidate`` per
   segment in each shard's sorted run (one ``torch.searchsorted`` a shard
   over every tree, segment and rank at once) and summing the counts over
   the shards (``psum``).  Points below a threshold go left, and the
   left side's quota of the points equal to it goes in the single-device
   build's order, by their earlier levels' projections (JAX's
   data-parallel build takes them by index, and its leaves then differ
   from its single-device build's).  Node codes advance level by level,
   and the leaf codes gathered at the end give the permutation by a
   stable sort, each leaf's points in original-index order (the
   single-device build keeps them in projection order: leaf sets are
   equal, the order within a leaf is not);
2. queries over the raw rows (:meth:`DataParallelForest.knn` unpacked,
   ``knn_h``, ``brute_force_knn``, ``recall_with``): the small structure
   arrays are traversed alike on every shard, each shard reranks only the
   candidates whose rows it owns, and the shards' k best are merged;
3. :meth:`DataParallelForest.pack_leaves` packs the leaf blocks from the
   sharded rows into leaf-sharded blocks (block ``g`` on shard ``g % S``
   at row ``g // S``, the layout of :class:`.distributed.DistributedForest`
   ``shard_by="leaf"``, whose serving loop then serves them over the data
   axis), each shard's blocks assembled from every shard's owned rows; or
   with ``store="shared"`` keeps each shard's rows as its row store with a
   table of its own members for every block, served in the ``all_probes``
   mode (every shard scores every probe against its part of the block).

No kernel is new here: the radix selection, the sort and the packing are
plain torch (XLA stages in the JAX package), and every shard runs the
existing kernels on its tensors.  A mesh may span the processes of a
``torch.distributed`` group (:func:`data_mesh`, :func:`process_local_rows`):
the build, the raw-row queries, the blocked packs and the leaf-sharded
serving then run over it; ``fold``, ``rebuild`` and streaming need
every shard in one process.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import ForestConfig
from ..models import forest as fm
from ..models.forest import RPForest
from ..models.plan import make_plan
from ..ops.build import TreeArrays, ieee_fp32, project_dataset
from ..ops.rerank import dedup_ids, rerank_top_k
from ..ops.shared import SharedRows
from ..ops.sparse import EllBlocks, EllMatrix, ell_sq_norms
from ..utils import gen as rgen
from .collectives import Sharded, _reduce, all_gather, pmax, psum
from .distributed import DistributedForest, _merge, _Shard
from .mesh import DATA_AXIS, QUERY_AXIS, ForestMesh, ProcessSpan

__all__ = ["DataParallelForest", "forest_batch_data_parallel",
           "brute_force_knn_sharded", "DATA_AXIS", "data_mesh"]

_MASK32 = 0xFFFFFFFF


def _process_span() -> Optional[ProcessSpan]:
    """This process's place in an initialised ``torch.distributed`` group
    of more than one process, else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if world < 2:
        return None
    return ProcessSpan(dist.get_rank(), world, dist.get_backend())


def data_mesh(n_shards: Optional[int] = None, devices=None,
              n_query: int = 1) -> ForestMesh:
    """A mesh over the data (points) axis, ``shape == {"data": S}``;
    ``n_query > 1`` adds a ``query`` axis (``{"data": S, "query": Q}``),
    so that a large batch splits over the devices of a data shard instead
    of being copied to each.  ``devices`` defaults to every visible CUDA
    device (with none it raises, and never falls back to the CPU); a
    device may repeat (``[torch.device("cpu")] * 8``).  ``n_shards *
    n_query`` must not exceed the devices; the first ones are taken.

    In an initialised ``torch.distributed`` group of several processes the
    mesh spans them: ``devices`` are this process's own, every process
    lists as many, and the ``S`` shards (``n_shards``, default the
    processes times the local devices) are the processes' in rank order."""
    span = _process_span()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: data_mesh() spans the "
                               "visible cards; pass devices= (for example "
                               "[torch.device('cpu')] * 8) to use others")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n_query = max(1, int(n_query))
    world = 1 if span is None else span.world
    if span is not None and n_query > 1:
        raise ValueError("a (data, query) mesh runs in one process")
    if n_shards is None:
        n_local = len(devices) // n_query
    else:
        if int(n_shards) % world:
            raise ValueError(f"{n_shards} data shards do not divide over "
                             f"{world} processes")
        n_local = int(n_shards) // world
    if n_local < 1 or n_local * n_query > len(devices):
        raise ValueError(f"mesh shape ({n_local * world} data x {n_query} "
                         f"query) exceeds the {len(devices) * world} "
                         f"devices")
    grid = [devices[i * n_query:(i + 1) * n_query] for i in range(n_local)]
    axes = (DATA_AXIS, QUERY_AXIS) if n_query > 1 else (DATA_AXIS,)
    return ForestMesh(grid, axes, span)


# -- the dataset's shards -------------------------------------------------

def _rows_of(data, s: int, per: int, dev: torch.device, dtype,
             own: bool = False):
    """Rows ``[s * per, (s + 1) * per)`` of ``data`` (a tensor or a host
    array) on ``dev`` in ``dtype``: a view where ``data`` is a tensor
    there already in that type, unless ``own`` (then a copy, so that
    ``data`` can be freed)."""
    if torch.is_tensor(data):
        part = data[s * per:(s + 1) * per]
        out = part.to(device=dev, dtype=dtype).contiguous()
        return out.clone() if own and out is part else out
    return torch.as_tensor(np.ascontiguousarray(
        np.asarray(data)[s * per:(s + 1) * per]), dtype=dtype, device=dev)


def _shard(data, n: int, mesh: ForestMesh, dtype, own: bool = False
           ) -> Sharded:
    """``data``'s rows over the mesh's data shards: contiguous parts of
    ``n / S`` rows, this process's on their devices, each a copy of its
    own where ``own`` (a :class:`Sharded` of this mesh is kept as it
    is)."""
    s_all = mesh.shape[DATA_AXIS]
    if isinstance(data, Sharded):
        if (data.n_parts != s_all or data.first != mesh.local.start
                or any(p.device != mesh.device(i) for i, p in
                       zip(mesh.local, data.parts))):
            raise ValueError("a Sharded dataset must have this mesh's "
                             "shards on their devices")
        return data
    per = n // s_all
    return Sharded([_rows_of(data, i, per, mesh.device(i), dtype, own)
                    for i in mesh.local], mesh.local.start, s_all)


def _sharded_ell(dim: int, cols: Sharded, vals: Sharded) -> EllMatrix:
    """An :class:`EllMatrix` whose tables are :class:`Sharded` (the
    constructor would make them tensors)."""
    m = EllMatrix.__new__(EllMatrix)
    m.dim, m.cols, m.vals = int(dim), cols, vals
    return m


def _ell_part(x: EllMatrix, i: int) -> EllMatrix:
    """Shard ``i``'s rows of a sharded :class:`EllMatrix`."""
    return EllMatrix(x.dim, x.cols.part(i), x.vals.part(i))


def _part(x, i: int):
    """Shard ``i``'s rows of a sharded dataset (dense or ELL)."""
    return _ell_part(x, i) if isinstance(x, EllMatrix) else x.part(i)


def _n_rows(x) -> int:
    return x.n if isinstance(x, EllMatrix) else int(x.shape[0])


def process_local_rows(rows, n: int, mesh: Optional[ForestMesh] = None):
    """A data-parallel dataset from this process's own rows (the port's
    ``jax.make_array_from_process_local_data``): ``rows`` are the
    contiguous rows of this process's shards, in order, of a global
    dataset of ``n`` rows (dense ``[n / P, D]``, or an :class:`EllMatrix`);
    returns the dataset :func:`forest_batch_data_parallel` takes."""
    if mesh is None:
        mesh = data_mesh()
    s_all = mesh.shape[DATA_AXIS]
    if n % s_all:
        raise ValueError(f"N={n} not divisible by {s_all} data shards")
    per, n_local = n // s_all, len(mesh.local)
    if _n_rows(rows) != per * n_local:
        raise ValueError(f"this process holds {n_local} shards of {per} "
                         f"rows, got {_n_rows(rows)} rows")

    def own(t, dtype):
        return Sharded([_rows_of(t, j, per, mesh.device(i), dtype)
                        for j, i in enumerate(mesh.local)],
                       mesh.local.start, s_all)

    if isinstance(rows, EllMatrix):
        return _sharded_ell(rows.dim, own(rows.cols, torch.int32),
                            own(rows.vals, torch.float32))
    return own(rows, torch.float32)


def _place(data, mesh: ForestMesh, own: bool = False):
    """The dataset on the mesh (dense rows f32, an ELL matrix as int32
    columns and f32 values; every part a copy of its own where ``own``):
    ``(x, n, dim)``."""
    if isinstance(data, EllMatrix):
        cols, vals = data.cols, data.vals
        n = int(cols.shape[0])
    elif isinstance(data, Sharded):
        n, dim = int(data.shape[0]), int(data.shape[1])
    else:
        if not torch.is_tensor(data):
            data = np.asarray(data, dtype=np.float32)
        if data.ndim != 2:
            raise ValueError(f"dataset must be [n, dim], got shape "
                             f"{tuple(data.shape)}")
        n, dim = int(data.shape[0]), int(data.shape[1])
    s_all = mesh.shape[DATA_AXIS]
    if n % s_all:
        raise ValueError(f"N={n} not divisible by {s_all} data shards")
    if isinstance(data, EllMatrix):
        x = _sharded_ell(data.dim, _shard(cols, n, mesh, torch.int32, own),
                         _shard(vals, n, mesh, torch.float32, own))
        return x, n, x.dim
    return _shard(data, n, mesh, torch.float32, own), n, dim


def _sq_norms_sharded(x) -> Sharded:
    """Each shard's squared row norms, f32 (ELL rows summed over the slots
    in order, as one device sums them)."""
    if isinstance(x, EllMatrix):
        parts = [ell_sq_norms(EllMatrix(x.dim, c, v))
                 for c, v in zip(x.cols.parts, x.vals.parts)]
        return Sharded(parts, x.cols.first, x.cols.n_parts)
    return Sharded([(p * p).sum(-1) for p in x.parts], x.first, x.n_parts)


# -- the build: distributed radix selection --------------------------------

def _f32_to_key(p: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> 32-bit key (as int64): the keys' integer order is
    the floats' order.  ``-0.0`` is first made ``+0.0``, so that the two
    tie as the single-device build's float comparisons tie them."""
    u = (p + 0.0).view(torch.int32).to(torch.int64) & _MASK32
    return torch.where(u >> 31 == 1, ~u & _MASK32, u | 0x80000000)


def _key_to_f32(k: torch.Tensor) -> torch.Tensor:
    u = torch.where(k >> 31 == 0, ~k & _MASK32, k & 0x7FFFFFFF)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(
        torch.int32).view(torch.float32)


class _LevelRun:
    """One shard's points at one level, sorted by ``(tree, segment, key)``
    as one int64 a point, ``((tree *
    (S_max + 1) + segment) << 32) + key``, a level's dead points in each
    tree's sentinel segment (its segment count ``ns``, as in the JAX
    package, whose selection over the ``S_max`` padded segments then
    reads the dead points' keys at ``ns``).  :meth:`count_less` counts a
    segment's keys below a candidate by one ``searchsorted`` over every
    query."""

    def __init__(self, key, code, smax):
        t, n = key.shape
        tree = torch.arange(t, device=key.device)[:, None]
        ck = (((tree * (smax + 1) + code) << 32) + key).reshape(-1)
        self.sorted = torch.sort(ck).values
        self.base = (tree * (smax + 1) + torch.arange(smax, device=key.device)
                     ) << 32                                  # [T, S_max]
        self.lo = torch.searchsorted(self.sorted, self.base)   # [T, S_max]

    def count_less(self, cand: torch.Tensor) -> torch.Tensor:
        """``cand int64[T, R, S_max]`` (keys, up to ``2**32``) -> the count
        of each segment's keys below it, ``[T, R, S_max]``."""
        q = self.base[:, None, :] + cand
        at = torch.searchsorted(self.sorted, q.reshape(-1)).reshape(q.shape)
        return at - self.lo[:, None, :]


@torch.no_grad()
def _dp_build(mesh: ForestMesh, plan, x, r):
    """Every tree's data-parallel build: ``(thr, mgl, mgh f32[T, L, S_max]``
    on the mesh's first device, ``leaf int32[T, N]`` (each point's leaf)).
    A level's unused segments hold what the JAX package's selection gives
    them, bit for bit: rank 0 of the level's dead points at the segment
    count, NaN past it (no traversal reads them).  Each shard projects its
    rows, then every level runs the radix selection of its ``(mgl, thr,
    mgh)`` ranks for every tree and segment at once (32 rounds, each one
    ``searchsorted`` a shard and one ``psum``), then the split.  Points
    equal to a threshold that split between the sides go in the
    single-device build's order (:func:`_split_ties`); that takes one host
    read a level."""
    nl, t = plan.n_levels, int(r.shape[0])
    first, span = mesh.first, mesh.span
    smax = max(lp.n_segs for lp in plan.levels)
    child = torch.as_tensor(plan.padded_child_table(), dtype=torch.int64)
    shards = []
    for i in mesh.local:
        dev = mesh.device(i)
        xi, ri = _part(x, i), r.to(dev)
        proj = torch.stack([project_dataset(xi, ri[tt, :nl]).T
                            for tt in range(t)])               # [T, L, n_l]
        n_l = proj.shape[-1]
        shards.append(dict(
            dev=dev, proj=proj, child=child.to(dev),
            code=torch.zeros((t, n_l), dtype=torch.int64, device=dev),
            leaf=torch.full((t, n_l), -1, dtype=torch.int64, device=dev)))
    out = torch.zeros((3, t, nl, smax), device=first)
    for lvl, lp in enumerate(plan.levels):
        ns = lp.n_segs
        ranks = np.zeros((3, smax), np.int64)
        ranks[:, :ns] = np.stack([lp.mgl_pos, lp.thr_pos, lp.mgr_pos]
                                 ) - lp.seg_start
        ranks = torch.as_tensor(ranks, device=first)             # [3, S_max]
        runs = []
        for sh in shards:
            key = _f32_to_key(sh["proj"][:, lvl])
            live = sh["leaf"] < 0
            sh["key"], sh["live"] = key, live
            runs.append(_LevelRun(key, torch.where(live, sh["code"], ns),
                                  smax))
        # the radix selection: bit by bit from the top, a candidate stays
        # where fewer than rank + 1 keys lie below it
        prefix = torch.zeros((t, 3, smax), dtype=torch.int64, device=first)
        for bit in range(31, -1, -1):
            cand = prefix | (1 << bit)
            cnt = psum([run.count_less(cand.to(sh["dev"]))
                        for run, sh in zip(runs, shards)], first, span)
            prefix = torch.where(cnt <= ranks, cand, prefix)
        out[:, :, lvl] = _key_to_f32(prefix).permute(1, 0, 2)
        thr_key = prefix[:, 1, :]                                # [T, S_max]
        # the split: keys below the threshold go left, and of the equal
        # ones the left side's quota (the half less the keys below)
        counts = []
        for run, sh in zip(runs, shards):
            tk = thr_key[:, None].to(sh["dev"])
            lt, le = run.count_less(torch.cat([tk, tk + 1], 1)).unbind(1)
            counts.append(torch.stack([lt, le - lt]))
        less_glob, eq_glob = psum(counts, first, span)        # [T, S_max]
        nh = torch.zeros(smax, dtype=torch.int64, device=first)
        nh[:ns] = torch.as_tensor(lp.seg_size // 2)
        quota = (nh - less_glob).clamp_min(0)
        # all equal points go left where the quota is not 0; where it is
        # between none and all of them, they go in the single-device
        # build's order: one host read
        split = (eq_glob > 1) & (quota > 0) & (quota < eq_glob)
        ties = (_split_ties(mesh, shards, lvl, thr_key, split, quota)
                if bool(split.any()) else None)
        for i, sh in zip(mesh.local, shards):
            dev = sh["dev"]
            key, code = sh["key"], sh["code"].clamp_max(smax - 1)
            tree = torch.arange(t, device=dev)[:, None]
            tk = thr_key.to(dev)[tree, code]
            left = (key < tk) | ((key == tk) & (quota.to(dev)[tree, code] > 0))
            if ties is not None:
                at_t, at_p, go = ties[i - mesh.local.start]
                left[at_t, at_p] = go
            code, live = sh["code"], sh["live"]
            nxt = sh["child"][lvl][code.clamp(0, smax - 1),
                                   (~left).to(torch.int64)]
            sh["leaf"] = torch.where(live & (nxt < 0), -(nxt + 1), sh["leaf"])
            sh["code"] = torch.where(live, nxt.clamp_min(0), code)
            del sh["key"], sh["live"]
    leaf = all_gather([sh["leaf"].to(torch.int32) for sh in shards], first,
                      span)                                      # [S, T, n_l]
    del shards
    return out[1], out[0], out[2], leaf.permute(1, 0, 2).reshape(t, -1)


def _split_ties(mesh, shards, lvl, thr_key, split, quota):
    """Which points equal to their segment's threshold go left, in the
    segments where they split (``split bool[T, S_max]``: more than one
    equal point, the quota ``quota [T, S_max]`` of the left side between
    none and all of them).  The single-device build orders a segment's
    points by projection, ties by their order at the level before, so
    equal points go left in the order of their earlier levels'
    projections, from the level just above to the first, then of their
    index: that tuple, gathered for these few points from every shard,
    is sorted on the first device, and a segment's first ``quota`` go
    left.  Returns each shard's ``(trees, positions, left)``."""
    first, span = mesh.first, mesh.span
    found = []
    for i, sh in zip(mesh.local, shards):
        dev = sh["dev"]
        code = sh["code"].clamp_max(split.shape[1] - 1)
        tree = torch.arange(code.shape[0], device=dev)[:, None]
        member = (sh["live"] & split.to(dev)[tree, code]
                  & (sh["key"] == thr_key.to(dev)[tree, code]))
        at_t, at_p = member.nonzero(as_tuple=True)
        earlier = _f32_to_key(sh["proj"][at_t, :lvl, at_p]).flip(1)
        cols = torch.cat([at_t[:, None], code[at_t, at_p][:, None], earlier,
                          (at_p + i * sh["proj"].shape[-1])[:, None]], 1)
        found.append((at_t, at_p, cols.to(first)))
    counts = [c.shape[0] for _, _, c in found]
    width = found[0][2].shape[1]
    most = max(counts)
    if span is not None:  # pad every process's members to one length
        most = int(pmax([torch.tensor(most, device=first)], first, span))
    table = all_gather([torch.cat([c, c.new_full((most - c.shape[0], width),
                                                 -1)]) for _, _, c in found],
                       first, span).reshape(-1, width)
    valid = table[:, 0] >= 0
    order = torch.arange(table.shape[0], device=first)
    for col in range(width - 1, -1, -1):  # lexicographic, by stable passes
        order = order[torch.sort(table[order, col], stable=True).indices]
    order = order[valid[order]]
    group = table[order, 0] * quota.shape[1] + table[order, 1]
    rank = (torch.arange(order.shape[0], device=first)
            - torch.searchsorted(group, group))
    go = torch.zeros(table.shape[0], dtype=torch.bool, device=first)
    go[order] = rank < quota.reshape(-1)[group]
    rows = mesh.local.start * most
    out = []
    for j, (at_t, at_p, _) in enumerate(found):
        start = rows + j * most
        out.append((at_t, at_p, go[start:start + counts[j]].to(at_t.device)))
    return out


def _leaf_perm(leaf: torch.Tensor) -> torch.Tensor:
    """Each tree's permutation from its points' leaf codes ``[T, N]``: a
    stable sort, so a leaf's points stay in original-index order."""
    return torch.sort(leaf, dim=-1, stable=True).indices.to(torch.int32)


@torch.no_grad()
def forest_batch_data_parallel(seed, max_depth: int, min_leaf: int,
                               n_trees: int, pnz: float, data,
                               mesh: Optional[ForestMesh] = None,
                               payloads: Optional[Sequence] = None, *,
                               r=None) -> "DataParallelForest":
    """Batch-build with the dataset sharded over points, end to end; the
    parameters are the JAX package's, in its order.  ``data``: dense rows
    (a tensor, whose shards are views of it where they share its device
    and type f32, or a host array, copied a shard at a time), an
    :class:`EllMatrix`, or the dataset of :func:`process_local_rows`.
    ``N`` must be divisible by the shard count.  The projections and the
    median selection run sharded, the permutation is a stable sort of the
    leaf codes, and the forest keeps the dataset sharded: reranking, the
    exact scan, recall and packing read each shard's own rows.  ``r
    [n_trees, max_depth, D]`` (the port's own, keyword-only) replaces the
    projections drawn from ``seed``."""
    if mesh is None:
        mesh = data_mesh()
    x, n, dim = _place(data, mesh)
    plan = make_plan(n, max_depth, min_leaf)
    first = mesh.first
    if r is None:
        r = rgen.sample_projections(seed, n_trees, max_depth, dim, pnz,
                                    device=first)
    else:
        r = torch.as_tensor(r, dtype=torch.float32, device=first)
        if tuple(r.shape) != (n_trees, max_depth, dim):
            raise ValueError(f"r must be {(n_trees, max_depth, dim)}, "
                             f"got {tuple(r.shape)}")
    if plan.n_levels == 0:  # single-leaf trees
        z = torch.zeros((n_trees, 0, 1), device=first)
        arrays = TreeArrays(r=r, thr=z, mgl=z.clone(), mgh=z.clone(),
                            perm=torch.arange(n, dtype=torch.int32,
                                              device=first).repeat(n_trees, 1))
    else:
        thr, mgl, mgh, leaf = _dp_build(mesh, plan, x, r)
        arrays = TreeArrays(r=r, thr=thr, mgl=mgl, mgh=mgh,
                            perm=_leaf_perm(leaf))
    cfg = ForestConfig(n_trees=n_trees, max_depth=max_depth,
                       min_leaf=min_leaf, proj_nz_density=pnz, dim=dim)
    return DataParallelForest(plan, arrays, x, _sq_norms_sharded(x), cfg,
                              mesh, payloads=payloads, seed=seed)


# -- queries over the raw rows --------------------------------------------

def _scan_merge(cells, q, k, metric, span):
    """The exact scan over the shards' rows (fp32): each shard's k best
    with its ids made global, merged by :func:`.distributed._merge`
    (equal distances to the lower id)."""
    outs = []
    for c in cells:
        d, i = fm._brute_force(c.x, c.sq_norms, q.to(c.device), k, metric)
        base = c.index * _n_rows(c.x)
        outs.append((d, torch.where(i >= 0, i + base, -1)))
    return _merge(outs, k, k, False, 1, cells[0].device, span)


def brute_force_knn_sharded(data, q, k: int, metric: str = "l2",
                            mesh: Optional[ForestMesh] = None):
    """Exact kNN with the dataset sharded over points: each shard scans its
    rows (fp32), its ids offset to global, and the shards' k best are
    merged; the ground truth for a dataset beyond one card.  ``len(data)``
    must be divisible by the shard count.  Returns ``(dists f32[B, k],
    ids int32[B, k])`` on the mesh's first device."""
    if mesh is None:
        mesh = data_mesh()
    x, _, dim = _place(data, mesh)
    sq = _sq_norms_sharded(x)
    qb = fm._as_dense_queries(q, dim, mesh.first)
    cells = [_Shard(index=i, device=mesh.device(i), x=_part(x, i),
                    sq_norms=sq.part(i)) for i in mesh.local]
    return _scan_merge(cells, qb, int(k), metric, mesh.span)


# -- packing from the sharded rows ----------------------------------------

def _owned_rows(mesh, tables, ids, dev):
    """Rows ``ids`` (global point ids, any shape, -1 for none) of each
    sharded table in ``tables``, assembled on ``dev``: every shard gathers
    the rows it owns and writes them there (zeros elsewhere), and across
    processes the tables are summed (one owner a row).  Returns one tensor
    a table."""
    out = [torch.zeros((*ids.shape, *tab.shape[1:]), dtype=tab.dtype,
                       device=dev) for tab in tables]
    for i in mesh.local:
        n_l = tables[0].part_rows
        local = ids.to(mesh.device(i)) - i * n_l
        mine = ((local >= 0) & (local < n_l)).nonzero(as_tuple=True)
        at = tuple(a.to(dev) for a in mine)
        for acc, tab in zip(out, tables):
            acc[at] = tab.part(i)[local[mine]].to(dev)
    return [_reduce(acc, mesh.span, "SUM") for acc in out]


def _dest_blocks(plan, perm, pos, in_leaf, dst, s_all, dev):
    """Destination shard ``dst``'s blocks ``g = dst + S * j``: their point
    ids ``[g_per, lmax]`` (-1 in empty slots and padding blocks), slot
    validity, leaf ids and whether each is a block at all (not padding)."""
    g_total = perm.shape[0] * plan.n_leaves
    g_per = -(-g_total // s_all)
    g = dst + s_all * torch.arange(g_per, device=dev)
    ok = g < g_total
    gc = g.clamp_max(g_total - 1)
    leaf = gc % plan.n_leaves
    valid = in_leaf.to(dev)[leaf] & ok[:, None]
    ids = perm.to(dev)[(gc // plan.n_leaves)[:, None], pos.to(dev)[leaf]]
    return torch.where(valid, ids, -1), valid, leaf, ok


class DataParallelForest(DistributedForest):
    """An :class:`RPForest` whose dataset is sharded over points on a data
    mesh: for datasets beyond one card's memory.

    Build, reranking, the exact scan, recall and packing read each
    shard's own rows; serving reads leaf-sharded blocks (1/S of the index
    a shard) through :class:`.distributed.DistributedForest`'s
    leaf-sharded pipeline over the data axis, or the shards' own rows
    (``store="shared"``).  The small structure arrays (projections,
    thresholds, margins, permutation) are whole on the mesh's first
    device and read by every shard.  ``x`` and ``sq_norms`` are
    :class:`Sharded` (an ELL dataset: an :class:`EllMatrix` of two)."""

    _index_axis = DATA_AXIS  # blocks shard over the data axis

    def _cell_data(self, i, put, dev):
        """Shard ``i``'s own rows and norms, on ``dev``."""
        if self.x is None:
            return None, None
        return put(_part(self.x, i), dev), put(self.sq_norms.part(i), dev)

    # -- the raw rows -----------------------------------------------------

    def points(self) -> torch.Tensor:
        """The indexed points (and the folded ones), gathered whole on the
        mesh's first device: this makes the dataset whole, as the JAX
        package's does."""
        self._require_x("points()")
        if isinstance(self.x, EllMatrix):
            dense = fm.ell_to_dense(EllMatrix(self.dim, self.x.cols.whole(),
                                              self.x.vals.whole()))
            return torch.cat([dense, *self._folded_x])
        return torch.cat([self.x.whole(), *self._folded_x])

    def _raw_chunk(self, cells, q, k, budget, metric, dedup, min_votes,
                   variant):
        """One chunk of the queries over the raw rows (JAX ``_dp_knn``):
        every shard forms the candidate union on the whole structure
        (``variant`` "flat": every tree's buckets; "h": the knnH bucket
        stop), keeps the vote filter's survivors where ``min_votes > 1``
        (exact: every copy of an id is in the union), reranks the ones
        whose rows it owns, and the shards' k best are merged."""
        outs = []
        for c in cells:
            qc = q.to(c.device)
            b = qc.shape[0]
            if variant == "h":
                union = fm._knn_h_ids(self.plan, c.arrays, qc, k, budget,
                                      c.table)
            else:
                cand = fm._candidate_ids(self.plan, c.arrays, qc, budget,
                                         c.table)
                union = cand.transpose(0, 1).reshape(b, -1)
            dedup_l = dedup
            if min_votes > 1:
                union, dedup_l = dedup_ids(union, min_votes=min_votes), False
            n_l = _n_rows(c.x)
            local = union - c.index * n_l
            mine = (union >= 0) & (local >= 0) & (local < n_l)
            d, i = rerank_top_k(c.x, c.sq_norms, qc,
                                torch.where(mine, local, -1), k, metric,
                                dedup=dedup_l)
            outs.append((d, torch.where(i >= 0, i + c.index * n_l, -1)))
        return _merge(outs, k, k, dedup or min_votes > 1, 1, cells[0].device,
                      self.mesh.span)

    def _raw(self, q, k, metric, budget, dedup, precision, min_votes,
             variant):
        if self.x is None:
            raise ValueError("dataset dropped; only packed-path queries are "
                             "available")
        k = self._check_k(k)
        fm._check_precision(precision)
        qb, b = self._queries(q)
        budget = self._budget(budget)
        d, i = self._over_queries(qb, None, lambda cells, qc: self._raw_chunk(
            cells, qc, k, budget, metric, dedup, int(min_votes), variant))
        return self._apply_update_hooks(qb[:b], d[:b], i[:b], k, metric,
                                        precision)

    @torch.no_grad()
    def knn(self, q, k: int, metric: str = "l2",
            budget: Optional[int] = None, dedup: bool = True,
            precision: str = "highest", probes: Optional[int] = None,
            min_votes: int = 1):
        """k nearest neighbours; the parameters are the JAX package's.
        Unpacked, over the raw rows (each shard reranks the candidates it
        owns); packed, the leaf-sharded pipeline (``probes`` caps the
        probes over all trees, default ``n_trees * budget``)."""
        if self._packed is None:
            return self._raw(q, k, metric, budget, dedup, precision,
                             min_votes, "flat")
        return self._per_pair(q, k, metric, budget, dedup, precision, probes,
                              None, min_votes, None)

    @torch.no_grad()
    def knn_batched(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest",
                    probes: Optional[int] = None, min_votes: int = 1,
                    chunk: int = 4096):
        """:meth:`knn` on the packed blocks ``chunk`` queries at a time;
        requires :meth:`pack_leaves`; results equal :meth:`knn`'s."""
        if self._packed is None:
            raise ValueError("pack_leaves() first: knn_batched serves the "
                             "leaf-sharded packed blocks")
        return self._per_pair(q, k, metric, budget, dedup, precision, probes,
                              None, min_votes, int(chunk))

    @torch.no_grad()
    def knn_h(self, q, k: int, metric: str = "l2",
              budget: Optional[int] = None, dedup: bool = True,
              precision: str = "highest", probes: Optional[int] = None):
        """Margin-priority kNN (the reference's bucket stop): over the raw
        rows unpacked, else the leaf-sharded pipeline's."""
        if self._packed is None:
            return self._raw(q, k, metric, budget, dedup, precision, 1, "h")
        return super().knn_h(q, k, metric, budget, dedup, precision, probes)

    @torch.no_grad()
    def brute_force_knn(self, q, k: int, metric: str = "l2",
                        precision: str = "highest"):
        """Exact kNN by the sharded scan (fp32 at every ``precision``, as
        the JAX package's sharded scan; ``precision`` sets the folded
        rows' scan), the folded rows merged in."""
        fm._check_precision(precision)
        self._require_x("brute force")
        k = self._check_k(k)
        qb, b = self._queries(q)
        d, i = self._over_queries(qb, None, lambda cells, qc: _scan_merge(
            cells, qc, k, metric, self.mesh.span))
        d, i = d[:b], i[:b]
        if self.n_folded:
            d, i = self._merge_folded(qb[:b], d, i, k, metric, precision)
        return d, i

    @torch.no_grad()
    def recall_with(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None) -> torch.Tensor:
        """Mean per-tree recall@k against the sharded scan (folded rows
        included), the candidates from the whole structure."""
        return RPForest.recall_with(self, q, k, metric, budget)

    # -- packing ----------------------------------------------------------

    @torch.no_grad()
    def pack_leaves(self, dtype=None, shard_by: Optional[str] = "leaf",
                    slack: int = 0, centered: bool = False,
                    sub_block: int = 1, sub_split: str = "kmeans",
                    store: str = "blocks", *, r_sub=None
                    ) -> "DataParallelForest":
        """Pack the leaf blocks from the sharded rows into leaf-sharded
        blocks (block ``g`` on shard ``g % S`` at row ``g // S``; 1/S of
        the index a shard), each shard's blocks assembled from the rows
        every shard owns; the layouts and parameters are
        :meth:`RPForest.pack_leaves`' in the JAX package's order, with
        ``shard_by`` second and only ``"leaf"`` (any other layout would
        hold more than 1/S of the data somewhere).  A leaf's sub-blocks
        are ordered and cut on its owner shard.  ``store="shared"`` keeps
        no row copy: each shard's row store is its own dataset part, with
        a table of its members for every block (``lmax_loc`` slots, the
        most any shard has in a block, rounded up to 8), served in the
        ``all_probes`` mode.  An invalid call leaves the layout as it
        was."""
        if shard_by not in (None, "leaf"):
            raise ValueError("DataParallelForest packs shard_by='leaf' only "
                             "(the memory-complete layout)")
        cfg = self._validate_pack_args(dtype, slack, centered, sub_block,
                                       sub_split, store)
        if self._packed is not None:
            if cfg == self._pack_cfg:
                return self
            self._clear_pack_for_repack()
        with ieee_fp32():
            if cfg.store == "shared":
                self._pack_shared_dp(cfg)
            elif isinstance(self.x, EllMatrix):
                self._pack_ell_dp(cfg)
            else:
                self._pack_blocks_dp(cfg, r_sub)
        self._pack_cfg = cfg
        self._grouped_nt = {}
        self._packed_mode = "leaf"
        self._invalidate()
        return self

    def _storage_rows(self, sub: int) -> torch.Tensor:
        """Each storage row's global block (``_row_block``), -1 on padding:
        row ``d * G/S + j`` holds leaf block ``d + S * j``, its ``sub``
        sub-blocks contiguous."""
        s_all = self.mesh.shape[DATA_AXIS]
        g_total = self.n_trees * self.plan.n_leaves
        g_per = -(-g_total // s_all)
        g = (torch.arange(s_all)[:, None]
             + s_all * torch.arange(g_per)[None, :]).reshape(-1)
        rb = (g[:, None] * sub + torch.arange(sub)[None, :]).reshape(-1)
        rb = torch.where(torch.repeat_interleave(g < g_total, sub), rb, -1)
        return rb.to(self.device)

    def _for_dests(self, fn):
        """``fn(dst, dev)`` for every destination shard, in order, and the
        results of this process's shards: across processes every shard's
        blocks take part in each destination's assembly."""
        mesh, out = self.mesh, []
        dests = (range(mesh.shape[DATA_AXIS]) if mesh.span is not None
                 else mesh.local)
        for dst in dests:
            dev = mesh.device(dst) if dst in mesh.local else mesh.first
            res = fn(dst, dev)
            if dst in mesh.local:
                out.append(res)
        return out

    def _sharded(self, parts):
        """This process's parts as a :class:`Sharded` of the mesh."""
        return Sharded(parts, self.mesh.local.start,
                       self.mesh.shape[DATA_AXIS])

    def _pack_blocks_dp(self, cfg, r_sub) -> None:
        """The dense blocked layouts (f32, bf16, int8, centered int8,
        sub-blocks), one destination shard at a time."""
        plan, s = self.plan, cfg.sub_block
        lmax0 = max(plan.max_leaf_len, 1) + cfg.slack
        ls = -(-lmax0 // s)
        ls = fm._tile_align(ls, cfg.dtype) if s == 1 else -(-ls // 8) * 8
        lmax = ls * s
        pos, in_leaf = self._slot_positions(lmax)
        nl, t = plan.n_leaves, self.n_trees
        s_all = self.mesh.shape[DATA_AXIS]
        valid_sub = None
        if s > 1:
            r_sub = (fm._sub_r(self.seed, self.dim, self.device)
                     if r_sub is None else torch.as_tensor(
                         r_sub, dtype=torch.float32, device=self.device))
            sub_len = fm._sub_lens(plan.leaf_len, ls, s)
            valid_sub = torch.as_tensor(
                np.arange(ls)[None, :] < sub_len[:, None],
                device=self.device).reshape(nl, s, ls)
            self._sub_len_dev = torch.as_tensor(np.tile(sub_len, t),
                                                device=self.device)
            self._r_sub = r_sub

        def dest(dst, dev):
            ids, valid, leaf, ok = _dest_blocks(plan, self.arrays.perm, pos,
                                                in_leaf, dst, s_all, dev)
            rows, = _owned_rows(self.mesh, [self.x], ids, dev)
            vs = valid
            if s > 1:
                vs = (valid_sub.to(dev)[leaf] & ok[:, None, None]).reshape(
                    -1, ls)
            vals = self._block_values(cfg, ids, rows.float(), valid, vs,
                                      None if r_sub is None
                                      else r_sub.to(dev))
            return (vals[0].to(self._block_dtype(cfg)),) + vals[1:]

        parts = self._for_dests(dest)
        x_leaf, sq, ids, scale, mu, mudr = (
            [p[n] for p in parts] for n in range(6))
        self._packed = (self._sharded(x_leaf), self._sharded(sq),
                        self._sharded(ids))
        self._block_scale = (self._sharded(scale) if scale[0] is not None
                             else None)
        self._block_center = ((self._sharded(mu), self._sharded(mudr))
                              if mu[0] is not None else None)
        self._row_block = self._storage_rows(s)

    def _pack_ell_dp(self, cfg) -> None:
        """ELL blocks (f32 or bf16 values) of ``max leaf + slack`` slots,
        assembled from the shards' column and value tables; the slot norms
        are the dataset's."""
        plan = self.plan
        lmax = max(plan.max_leaf_len, 1) + cfg.slack
        pos, in_leaf = self._slot_positions(lmax)
        s_all = self.mesh.shape[DATA_AXIS]
        dt = self._block_dtype(cfg)

        def dest(dst, dev):
            ids, valid, _, _ = _dest_blocks(plan, self.arrays.perm, pos,
                                            in_leaf, dst, s_all, dev)
            cols, vals, sq = _owned_rows(
                self.mesh, [self.x.cols, self.x.vals, self.sq_norms], ids,
                dev)
            return (cols, vals.to(dt), torch.where(valid, sq.float(), 0.0),
                    ids.to(torch.int32))

        parts = self._for_dests(dest)
        cols, vals, sq, ids = ([p[n] for p in parts] for n in range(4))
        self._packed = (EllBlocks(self.dim, self._sharded(cols),
                                  self._sharded(vals)),
                        self._sharded(sq), self._sharded(ids))
        self._row_block = self._storage_rows(1)

    def _pack_shared_dp(self, cfg) -> None:
        """The shared-row layout from the point-sharded rows: each shard's
        row store is its own dataset part (bf16: a copy of it), with a
        table of its own members of every block, compacted to the front in
        slot order: local rows (``SharedRows.ids``), global ids and slot
        norms (summed from the f32 rows, as the blocked pack sums them).
        ``lmax_loc``, the most members any shard has in a block rounded up
        to 8, is read to the host once.  Serving runs the ``all_probes``
        mode, each shard's occupancy its own counts."""
        plan, t = self.plan, self.n_trees
        lmax = fm._tile_align(max(plan.max_leaf_len, 1), cfg.dtype)
        pos, in_leaf = self._slot_positions(lmax)
        mesh = self.mesh

        def owned(i):
            """Shard ``i``'s rows, its members' local rows ``[T, nl,
            lmax]`` and where they are its own."""
            xi = self.x.part(i)
            dev, n_l = xi.device, int(xi.shape[0])
            local = (self.arrays.perm.to(dev)[:, pos.to(dev)].to(torch.int64)
                     - i * n_l)
            return xi, local, in_leaf.to(dev) & (local >= 0) & (local < n_l)

        counts = [owned(i)[2].sum(-1).reshape(-1).to(torch.int32)
                  for i in mesh.local]
        top = int(pmax([c.amax() for c in counts], mesh.first, mesh.span))
        lmax_loc = min(max(-(-max(top, 1) // 8) * 8, 8), lmax)
        rows_p, loc_p, gid_p, sq_p = [], [], [], []
        for i in mesh.local:
            xi, local, mine = owned(i)
            dev, n_l = xi.device, int(xi.shape[0])
            slot = torch.arange(lmax, device=dev)
            key_s, order = torch.sort(torch.where(mine, slot, lmax), dim=-1,
                                      stable=True)
            ok = key_s[..., :lmax_loc] < lmax
            loc = torch.where(ok, local.gather(-1, order)[..., :lmax_loc], -1)
            sq = torch.stack([self._slot_norms(torch.where(
                ok[tt, ..., None], xi[loc[tt].clamp_min(0)], 0.0).float())
                for tt in range(t)])
            rows_p.append(xi if xi.dtype == self._block_dtype(cfg)
                          else xi.to(self._block_dtype(cfg)))
            loc_p.append(loc.reshape(-1, lmax_loc).to(torch.int32))
            gid_p.append(torch.where(loc >= 0, loc + i * n_l, -1).reshape(
                -1, lmax_loc).to(torch.int32))
            sq_p.append(sq.reshape(-1, lmax_loc))
            del local, mine
        self._packed = (SharedRows(self._sharded(rows_p),
                                   self._sharded(loc_p)),
                        self._sharded(sq_p), self._sharded(gid_p))
        self._shared_all_probes = True
        self._shared_len_loc = self._sharded(counts)

    # -- rebuild ----------------------------------------------------------

    def _indexed_rows(self) -> torch.Tensor:
        """The dense indexed rows made whole on the host: the rebuild's
        staging, as the JAX package's."""
        self.x._whole_table("rebuild()")
        return torch.cat([p.cpu() for p in self.x.parts])

    def _rebuild_rows_ell(self):
        """The ELL counterpart of :meth:`_rebuild_rows`, staged through the
        host: the sharded (cols, vals) tables, the folded and pending dense
        rows as padded slot lists (a row of more nonzeros than the tables'
        K slots raises), tombstones purged; never densified."""
        cols = torch.cat([p.cpu() for p in self.x.cols.parts])
        vals = torch.cat([p.cpu() for p in self.x.vals.parts]).float()
        kz = cols.shape[1]
        pays = (list(self.payloads) if self.payloads is not None
                else [None] * self.plan.n)

        def to_ell(chunk):
            c = chunk.cpu().float()
            wide = int((c != 0).sum(1).max()) if c.shape[0] else 0
            if wide > kz:
                raise ValueError(
                    f"update row has {wide} nonzeros > the ELL table's {kz} "
                    "slots; rebuild from source rows with "
                    "forest_batch_data_parallel")
            return fm._ell_slots(c, kz)

        cs, vs = [cols], [vals]
        for chunk in self._folded_x:
            rc, rv = to_ell(chunk)
            cs.append(rc)
            vs.append(rv)
        pays = pays + list(self._folded_payloads)
        cols, vals = torch.cat(cs), torch.cat(vs)
        if self._deleted is not None and self._deleted.any():
            keep = torch.as_tensor(~self._deleted)
            cols, vals = cols[keep], vals[keep]
            pays = [p for p, kp in zip(pays, ~self._deleted) if kp]
        if self._pending:
            xp = torch.cat(self._pending).cpu()
            pp = sum(self._pending_payloads, [])
            if self._pending_deleted:
                xp, pp = fm._keep_rows(xp, pp, np.isin(
                    np.arange(xp.shape[0]), list(self._pending_deleted)))
            rc, rv = to_ell(xp)
            cols, vals, pays = (torch.cat([cols, rc]), torch.cat([vals, rv]),
                                pays + pp)
        return (EllMatrix(self.dim, cols, vals),
                None if all(p is None for p in pays) else pays)

    @torch.no_grad()
    def rebuild(self) -> "DataParallelForest":
        """Fold the pending inserts and purge the tombstones by the
        data-parallel build over the live rows (staged whole on the host,
        then each shard's part copied to its device, a tensor of its own),
        with the forest's own projections; the forest stays a
        :class:`DataParallelForest` on its mesh, an ELL one stays sparse,
        and the pack is replayed.  The new size must be divisible by the
        shard count (else it raises and nothing changes)."""
        if not self._pending and self.n_deleted == 0 and self.n_folded == 0:
            return self
        self._require_x("rebuild()")
        s_all = self.mesh.shape[DATA_AXIS]
        x_all, payloads = (self._rebuild_rows_ell()
                           if isinstance(self.x, EllMatrix)
                           else self._rebuild_rows())
        if _n_rows(x_all) % s_all:
            raise ValueError(f"rebuilt size {_n_rows(x_all)} does not divide "
                             f"the {s_all} data shards; add/remove to a "
                             f"divisible size")
        x_sh, _, _ = _place(x_all, self.mesh, own=True)
        del x_all
        cfg = self.config
        fresh = forest_batch_data_parallel(
            self.seed, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
            cfg.proj_nz_density, x_sh, mesh=self.mesh, payloads=payloads,
            r=self.arrays.r)
        self.plan, self.arrays = fresh.plan, fresh.arrays
        self.x, self.sq_norms = fresh.x, fresh.sq_norms
        self.payloads = fresh.payloads
        self._reset_updates()
        self._nodes = self._lens_dev = self._grouped_last = None
        self._grouped_nt = {}
        self._invalidate()
        if self._packed is not None:
            self._replay_pack(self._pack_cfg)
        return self

    def __repr__(self):
        return (f"DataParallelForest(trees={self.n_trees}, n={self.n_points}"
                f", dim={self.dim}, {self.mesh!r}, {self.plan!r})")
