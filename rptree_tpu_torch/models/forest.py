"""RP forest index: construction, leaf packing, serving and exact ground
truth (``rptree_tpu/models/forest.py``, the part of it that ``bench.py``
drives).

``RPForest`` holds the static :class:`TreePlan`, the forest's
:class:`TreeArrays`, the dataset and its squared norms, all tensors on one
device (the ``device=`` given to :func:`forest_batch` or the loader; the
card unless the caller names the CPU).  The query paths are:

1. unpacked :meth:`RPForest.knn`: the union of the trees' candidate
   buckets (:meth:`RPForest.candidates`), reranked exactly;
2. :meth:`RPForest.pack_leaves`: each leaf's points copied into one
   contiguous block (f32, bf16, or int8 with a per-block scale);
3. per pair, :meth:`RPForest.knn` / :meth:`RPForest.knn_batched` on packed
   blocks: probe selection, then each (query, probe) block fetched and
   scored (kernel 6, :mod:`..ops.fused_gather`, on f32 / bf16 blocks)
   and the selection tail (the sort tail, or kernel 3,
   :mod:`..ops.topk_kernel`);
4. grouped, :meth:`RPForest.knn_grouped`: probe selection, pair to tile
   grouping (kernel 9, :func:`..ops.grouped.tile_tables`), tile scoring
   (kernels 1 and 2, or kernel 4 with its per-pair top-kp,
   :mod:`..ops.grouped_kernel`; for ``cosine``, ``dot``, callables and
   ``impl="xla"`` the batched products of :func:`..ops.grouped.
   grouped_distances`) and the same tail, chunk by chunk;
5. :meth:`RPForest.brute_force_knn`: the exact scan, fp32 at
   ``precision="highest"``, bf16 products otherwise (kernel 5,
   :mod:`..ops.scan`); :meth:`RPForest.recall_with` holds the trees'
   candidates against it.

Every query path starts with the descent of all trees (kernel 7 on the
card, over the forest's node table, :meth:`RPForest._table`) and, on
packed blocks, the probe selection (kernel 8), both in
:mod:`..ops.traverse`.  :meth:`RPForest.knn_h` keeps the reference
``knnH``'s buckets (the bucket stop, kernel 8 on packed blocks);
:meth:`RPForest.knn_h_buckets` returns them unranked.

The index takes updates between rebuilds (the JAX package's freshness
layer): :meth:`RPForest.add` puts new points in a pending buffer that
every dense query surface scans exactly and merges (kernel 5 at
``precision="default"``), :meth:`RPForest.remove` sets tombstones that
every surface masks, :meth:`RPForest.fold` writes pending points into
the packed blocks' slack slots at the leaf each tree's thresholds send
them to (the blocks' occupancy table, :meth:`RPForest._lens_global`, then
feeds every kernel that reads occupancy), and :meth:`RPForest.rebuild`
builds a fresh index over what is live with the forest's own
projections.  :meth:`RPForest.drop_dataset` keeps only the packed blocks.

Every dense layout of the JAX package packs and serves: f32, bf16 and int8
blocks, int8 residuals around each block's mean (``centered``), leaves cut
into ``sub_block`` spatially ordered sub-blocks, and the shared-row store
(``store="shared"``: one copy of the rows and per-block id tables, fetched
by kernel 6's shared-row mode per pair and by :func:`..ops.shared.
fetch_blocks` in the grouped XLA form).

Sparse datasets (an :class:`..ops.sparse.EllMatrix`) build by gathered
projections, pack into :class:`..ops.sparse.EllBlocks` (f32 or bf16
values) and serve on every query path; the grouped and per-pair paths
score their blocks with kernel 10 (:mod:`..ops.ell_kernel`).  Query
batches may be sparse too: :meth:`RPForest.knn_batched` and
:meth:`RPForest.knn_grouped` densify one chunk of an ``EllMatrix`` at a
time, and every surface densifies an ``SVec`` or a small ``EllMatrix``.

A dataset may be f32, bf16 or f16 (``forest_batch(dtype=...)``): the rows
and their squared norms stay in that type, the projections are made in
f32 on the rows raised to f32, every query path returns f32 distances,
and ``pack_leaves()`` keeps bf16 blocks for a bf16 dataset.

Streaming construction is :mod:`..streaming`; the tree- and
query-sharded forests and the data-parallel ones are :mod:`..parallel`,
whose shards call this module's serving functions on their own tables.
The ``approx`` selection tail is not to be ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._cuda import resolve_device
from ..config import ForestConfig
from ..ops.build import (CAST_ROWS, TreeArrays, build_forest_arrays,
                         ieee_fp32)
from ..ops.ell_kernel import ell_score_tiles
from ..ops.fused_gather import gather_score, gather_score_ok
from ..ops.grouped import (grouped_distances, grouped_distances_kernel,
                           grouped_topk_kernel)
from ..ops.grouped_kernel import (INV_127, _int8_dots, _quantize_rows,
                                  grouped_kernel_ok)
from ..ops.rerank import (dedup_ids, distances_from_dots, gather_leaf_points,
                          leaf_positions, merge_top_k, rerank_top_k)
from ..ops.scan import MAX_K as SCAN_MAX_K
from ..ops.scan import SCAN_METRICS, scan_rows, scan_topk, stream_topk
from ..ops.shared import SharedRows, fetch_blocks
from ..ops.sparse import (EllBlocks, EllMatrix, ell_sq_norms, ell_take,
                          ell_to_dense)
from ..ops.topk_kernel import topk_dedup_kernel, topk_kernel_ok
from ..ops.traverse import (node_table, project_queries, select_probes,
                             traverse_kernel)
from ..ops.vector import SVec, to_dense
from ..utils import gen as rgen
from ..utils.profiling import entry, region
from .plan import TreePlan, make_plan

__all__ = ["RPForest", "forest_batch", "tree_batch", "DEFAULT_BUDGET"]

DEFAULT_BUDGET = 32
# the dataset types a forest holds; distances are f32 on every path
_DATA_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_PRECISIONS = ("highest", "default", "fastest")
_BLOCK_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}


def _dtype_str(dtype) -> str:
    """Validated block-dtype name for pack_leaves: ``f32``, ``bf16`` or
    ``int8``; anything else raises."""
    if dtype is None:
        return "f32"
    for name, dt in _BLOCK_DTYPES.items():
        if dtype == dt:
            return name
    raise ValueError(f"pack_leaves supports f32 / bf16 / int8 blocks; "
                     f"got {dtype}")


def _tile_align(n: int, dtype_str: str) -> int:
    """The JAX package's slot-axis alignment: 8 rows, or the dtype's full
    sublane tile when that adds no padding beyond the 8-rounding.  Kept so
    that the packed arrays have the JAX package's shapes."""
    n8 = -(-n // 8) * 8
    tile = {"f32": 8, "bf16": 16, "int8": 32}[dtype_str]
    nt = -(-n // tile) * tile
    return nt if nt == n8 else n8


class _PackCfg(NamedTuple):
    """A packed layout as :meth:`RPForest.pack_leaves` takes it, with the
    fields that do not shape the blocks canonicalised away (``sub_split``
    at ``sub_block`` 1), so that two requests of one layout compare
    equal."""

    dtype: str                 # "f32", "bf16" or "int8"
    slack: int
    centered: bool
    sub_block: int
    sub_split: Optional[str]   # None at sub_block 1
    store: str                 # "blocks" or "shared"


def _sub_split_of(sub_split: str, s: int) -> str:
    """The sub-block ordering: an unknown mode raises; ``"kmeans"``
    halves recursively, so it needs a power-of-two ``s`` and takes the
    projection sort otherwise."""
    if sub_split not in ("kmeans", "proj"):
        raise ValueError("sub_split must be 'kmeans' or 'proj', "
                         f"got {sub_split!r}")
    if s > 1 and sub_split == "kmeans" and (s & (s - 1)):
        return "proj"
    return sub_split


def _center_quantize(rows, valid):
    """Centered (residual) int8 quantization of blocks ``rows f32[..., L,
    D]`` with slot validity ``valid bool[..., L]``: each block's mean over
    its valid rows, the residuals scaled by ``max |residual| / 127``
    (rounded half to even, a true division) and ``mudr``, the mean's dot
    with each dequantized residual.  Returns ``(q int8[..., L, D], scale
    f32[..., 1, 1], mu f32[..., D], mudr f32[..., L])``."""
    occ = valid.sum(-1).float().clamp_min(1.0)
    mu = rows.sum(-2) / occ[..., None]
    res = torch.where(valid[..., None], rows - mu[..., None, :], 0.0)
    amax = res.abs().amax(dim=(-2, -1), keepdim=True)
    scale = amax.clamp_min(1e-30) * INV_127
    q = torch.round(res / scale).clamp(-127, 127).to(torch.int8)
    mudr = ((q.float() * scale) * mu[..., None, :]).sum(-1)
    return q, scale, mu, mudr


def _sq_dist(rs, c):
    """``|rs - c|^2`` over the last axis, ``rs [S, M, D]``, ``c [S, D]``."""
    return ((rs - c[:, None]) ** 2).sum(-1)


def _sub_order_kmeans(rows, valid, r_sub, sub):
    """Within-leaf row order for sub-block packing by recursive balanced
    2-means, ``log2(sub)`` levels: each segment seeds its two centers at
    the row of least projection on ``r_sub`` and the valid row farthest
    from it, runs four Lloyd steps over its valid rows (an empty cluster
    keeps its center), sorts its rows by the margin ``|x - c1|^2 - |x -
    c2|^2`` (stable; invalid rows last) and splits at the midpoint.  So
    each sub-block's rows share a cluster center where the leaf straddles
    clusters, and the valid rows stay a prefix of every segment.
    ``rows f32[nl, lmax, D]``, ``valid bool[nl, lmax]``; returns ``order
    int64[nl, lmax]`` (apply it to ids and rows alike)."""
    nl, lmax, d = rows.shape
    order = torch.arange(lmax, device=rows.device).expand(nl, lmax)
    r, v = rows, valid
    inf = float("inf")
    for j in range(sub.bit_length() - 1):
        segs, m = nl << j, lmax >> j
        rs, vs = r.reshape(segs, m, d), v.reshape(segs, m)
        os_ = order.reshape(segs, m)
        key = torch.where(vs, rs @ r_sub, inf)
        c1 = rs[torch.arange(segs, device=rs.device), key.argmin(-1)]
        far = torch.where(vs, _sq_dist(rs, c1), -inf).argmax(-1)
        c2 = rs[torch.arange(segs, device=rs.device), far]
        for _ in range(4):
            d1, d2 = _sq_dist(rs, c1), _sq_dist(rs, c2)
            a1 = ((d1 <= d2) & vs).float()
            a2 = ((d1 > d2) & vs).float()
            n1 = a1.sum(-1, keepdim=True)
            n2 = a2.sum(-1, keepdim=True)
            c1 = torch.where(n1 > 0, torch.einsum("sm,smd->sd", a1, rs)
                             / n1.clamp_min(1.0), c1)
            c2 = torch.where(n2 > 0, torch.einsum("sm,smd->sd", a2, rs)
                             / n2.clamp_min(1.0), c2)
        margin = _sq_dist(rs, c1) - _sq_dist(rs, c2)
        ord2 = torch.argsort(torch.where(vs, margin, inf), dim=-1,
                             stable=True)
        r = rs.gather(1, ord2[..., None].expand(segs, m, d)).reshape(
            nl, lmax, d)
        v = vs.gather(1, ord2).reshape(nl, lmax)
        order = os_.gather(1, ord2).reshape(nl, lmax)
    return order


def _sub_r(seed, dim: int, device) -> torch.Tensor:
    """The sub-block ordering direction ``f32[dim]``: N(0, 1) from a
    ``torch.Generator`` on the CPU seeded with the forest's seed and salt
    987 (0 where the seed is unknown), then moved to ``device``.  The JAX
    package draws its own from threefry with the same salt; parity tests
    hand it over (``pack_leaves(r_sub=...)``)."""
    seed0 = int(seed) if isinstance(seed, (int, np.integer)) else 0
    g = torch.Generator(device="cpu")
    g.manual_seed((seed0 * 1_000_003 + 987) & 0x7FFFFFFFFFFFFFFF)
    return torch.randn(int(dim), generator=g).to(device)


def _sub_lens(lens: np.ndarray, ls: int, sub: int) -> np.ndarray:
    """Each sub-block's occupancy ``int32[n_leaves * sub]``: a leaf's
    valid rows are a prefix of it, so sub-block ``j`` holds ``clip(len -
    j * ls, 0, ls)``."""
    j = np.arange(sub)
    return np.clip(np.asarray(lens)[:, None] - j[None, :] * ls, 0, ls
                   ).astype(np.int32).reshape(-1)


def _expand_sub_probes(gsel, lsel, sub: int):
    """A leaf-granular probe selection ``[B, P]`` at sub-block
    granularity ``[B, P * sub]``: leaf block ``g`` becomes blocks ``g *
    sub .. g * sub + sub - 1`` (a leaf's sub-blocks are contiguous), and
    the leaf ids repeat."""
    b, p = gsel.shape
    gsel = (gsel[..., None] * sub + torch.arange(
        sub, dtype=gsel.dtype, device=gsel.device)).reshape(b, p * sub)
    return gsel, lsel.repeat_interleave(sub, dim=-1)


def _grouped_auto_capacity(f, key, e, tile_m, nt, run, check=True):
    """Tile-capacity sizing for the grouped rerank: start from the cached
    capacity for this shape key (else 2.25x pairs / tile_m), run, and
    retry with 12.5% headroom while the run needed more tiles than it had
    (results are exact only when ``needed <= capacity``).

    An explicit ``nt`` never writes the cache, and an automatic run
    re-tightens a cached capacity above twice the need.  ``check=False``
    reuses a known capacity without reading ``needed`` back to the host;
    overflow pairs then come back masked (+inf), never wrong.

    A capacity is any tile count in ``[1, e]`` (``e`` pairs: every pair its
    own tile).  The JAX package rounds it up to a multiple of its
    ``tile_chunk``, the step of its XLA scorer's ``lax.map``, and leaves
    that chunk out of the cache key (ROADMAP.md queue 3); the port's XLA
    form takes a shorter last step instead, so a capacity learned at one
    ``tile_chunk`` serves every other, and neither the rounding nor the
    fault exists here."""

    def _clip(n):
        return min(max(int(n), 1), e)

    if not check and (nt is not None or key in f._grouped_nt):
        cap = _clip(nt) if nt is not None else f._grouped_nt[key]
        out, needed = run(cap)
        f._grouped_last = (needed, cap)
        return out
    cap = _clip(nt) if nt is not None else f._grouped_nt.get(
        key, _clip(2 * e // int(tile_m) + e // (4 * int(tile_m))))
    while True:
        out, needed = run(cap)
        needed = int(needed)
        if needed <= cap or nt is not None:
            break
        cap = _clip(needed + needed // 8)
    f._grouped_last = (needed, cap)
    if nt is None:
        tight = _clip(needed + needed // 8)
        cached = f._grouped_nt.get(key, 0)
        if cached < tight or cached > 2 * tight:
            f._grouped_nt[key] = tight
    return out


def _check_precision(precision):
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}")


def _check_selection(selection, k, min_votes):
    """The selection tails the port serves: "sort", and "kernel" (the
    top-k kernel, k <= 128, unless vote counting takes the sort tail)."""
    if selection == "approx":
        raise NotImplementedError(
            "selection='approx': not to be ported (ROADMAP.md, "
            "\"Not to port\")")
    if selection not in ("sort", "kernel"):
        raise ValueError(f"unknown selection {selection!r}")
    if selection == "kernel" and min_votes == 1 and not topk_kernel_ok(1, k):
        raise ValueError("selection='kernel' needs k <= 128; use "
                         "selection='sort'")


def _pad_to_chunk(qb, chunk: int):
    """Pad a ``[B, D]`` batch (or an :class:`EllMatrix` batch, with empty
    rows) with zero rows up to a multiple of ``chunk`` rows; returns
    ``(padded batch, original B, effective chunk)``."""
    b = qb.shape[0]
    ch = max(1, min(int(chunk), b))
    pad = (-b) % ch
    if pad and isinstance(qb, EllMatrix):
        qb = EllMatrix(qb.dim, torch.cat([qb.cols, qb.cols.new_zeros(
            (pad, qb.k))]), torch.cat([qb.vals, qb.vals.new_zeros((pad, qb.k))]))
    elif pad:
        qb = torch.cat([qb, qb.new_zeros((pad, qb.shape[1]))])
    return qb, b, ch


def _query_chunks(qb, chunk: int):
    """The ``chunk``-row slices of a batch whose rows are a multiple of
    ``chunk``, as dense ``f32[chunk, D]``: an :class:`EllMatrix` batch is
    densified one slice at a time, so ``[B, D]`` never exists."""
    ell = isinstance(qb, EllMatrix)
    for s in range(0, qb.shape[0], chunk):
        yield (ell_to_dense(ell_take(qb, slice(s, s + chunk)), torch.float32)
               if ell else qb[s:s + chunk])


def _as_dense_queries(q, dim: int, device) -> torch.Tensor:
    """Queries as ``f32[B, D]`` on ``device``; a single vector becomes a
    batch of one, and a sparse query (an :class:`SVec`, or an
    :class:`EllMatrix` batch) is densified."""
    if isinstance(q, SVec):
        q = to_dense(q)
    elif isinstance(q, EllMatrix):
        q = ell_to_dense(q.to(device))
    q = torch.as_tensor(q, dtype=torch.float32, device=device)
    if q.dim() == 1:
        q = q[None, :]
    if q.dim() != 2 or q.shape[0] == 0:
        raise ValueError(f"queries must be [B>=1, dim], got shape {tuple(q.shape)}")
    if q.shape[-1] != dim:
        raise ValueError(f"query dim {q.shape[-1]} != index dim {dim}")
    return q.contiguous()


def _descent_inputs(plan: TreePlan, arrays: TreeArrays, q: torch.Tensor,
                    table=None):
    """The descent's operands: the forest's node table (built here when
    not given) and the query projections (kernel 11 on the card, the
    ``rpt_project`` region)."""
    if table is None:
        table = node_table(plan, arrays.thr, arrays.mgl, arrays.mgh)
    with region("rpt_project"):
        return table, project_queries(q, arrays.r, plan.n_levels)


def _traverse_forest(plan: TreePlan, arrays: TreeArrays, q: torch.Tensor,
                     budget: int, table=None):
    """All-tree traversal (kernel 7 on the card): ``(leaf_ids int32[T, B,
    F], prio f32[T, B, F])``.  ``table``: the forest's node table, built
    here when not given.  The descent is the ``rpt_candidates`` region;
    the query projections precede it, as in the JAX package."""
    table, projq = _descent_inputs(plan, arrays, q, table)
    with region("rpt_candidates"):
        return traverse_kernel(plan, table, projq, budget)


@torch.no_grad()
def _select_probes(plan, arrays, q, budget, probes, k=None,
                   bucket_stop=False, block_len=None, table=None):
    """Traverse and keep each query's ``probes`` lowest-priority leaves
    (kernels 7 and 8 on the card).

    Returns ``(gsel int32[B, P], lsel int32[B, P])``: global block index
    (tree * n_leaves + leaf; masked entries point at block 0) and leaf id
    (-1 where masked).  With ``bucket_stop`` the reference knnH rule masks
    buckets beyond the first ``k`` collected points, counting ``block_len``
    (each global block's occupancy) or else the plan's leaf sizes.  The
    descent and the selection are one ``rpt_candidates`` region."""
    table, projq = _descent_inputs(plan, arrays, q, table)
    with region("rpt_candidates"):
        leaf_ids, prio = traverse_kernel(plan, table, projq, budget)
        if block_len is None:
            block_len = torch.as_tensor(
                np.tile(np.asarray(plan.leaf_len, np.int32),
                        leaf_ids.shape[0]), device=leaf_ids.device)
        return select_probes(leaf_ids, prio, plan.n_leaves, probes,
                             block_len, k=k, bucket_stop=bucket_stop)


def _probe_pairs(f, q, budget, probes, k, bucket_stop=False):
    """The (query, block) pairs a packed path scores: ``(gsel, lsel)
    int32[B, P * sub]``.  Probes are selected at leaf granularity, the
    bucket stop counting the leaves' occupancy (:meth:`RPForest.
    _leaf_lens`), then widened to the leaf's ``sub`` sub-blocks."""
    gsel, lsel = _select_probes(f.plan, f.arrays, q, budget, probes, k=k,
                                bucket_stop=bucket_stop,
                                block_len=f._leaf_lens(), table=f._table())
    if f._sub_block > 1:
        gsel, lsel = _expand_sub_probes(gsel, lsel, f._sub_block)
    return gsel, lsel


def _selection_tail(d, id_leaf, rows_sel, k, kk, dedup, min_votes=1,
                    selection="sort"):
    """Candidate-selection tail over ``d f32[B, P * lmax]`` (+inf in masked
    slots): the ids are fetched as whole leaf blocks with the rows' ``[B,
    P]`` pattern, then :func:`_selection_tail_ids` selects; both in one
    ``rpt_topk_tail`` region."""
    with region("rpt_topk_tail"):
        b = d.shape[0]
        ids_flat = id_leaf[rows_sel.long()].reshape(b, -1)
        return _tail(d, ids_flat, k, kk, dedup, min_votes, selection)


def _selection_tail_ids(d, ids_flat, k, kk, dedup, min_votes=1,
                        selection="sort"):
    """The k best of ``(d, ids_flat) [B, W]``; returns ``(dists f32[B, k],
    ids int32[B, k])``.

    ``selection="kernel"`` with ``min_votes == 1`` is the top-k kernel
    (kernel 3).  Otherwise the sort tail: a stable sort of the row by
    distance, its first ``kk`` entries (ids -1 at +inf), then
    :func:`merge_top_k`.  Vote counting is exact only over the full
    candidate list, so ``min_votes > 1`` takes ``kk = W``.  The
    ``rpt_topk_tail`` region."""
    with region("rpt_topk_tail"):
        return _tail(d, ids_flat, k, kk, dedup, min_votes, selection)


def _tail(d, ids_flat, k, kk, dedup, min_votes, selection):
    """:func:`_selection_tail_ids`'s body."""
    w = d.shape[1]
    kk = w if min_votes > 1 else min(int(kk), w)
    if selection == "kernel" and min_votes == 1:
        return topk_dedup_kernel(d, ids_flat, k, dedup=dedup)
    d_top, order = torch.sort(d, dim=1, stable=True)
    d_top = d_top[:, :kk]
    ids_top = ids_flat.gather(1, order[:, :kk])
    ids_top = torch.where(torch.isinf(d_top), -1, ids_top)
    return merge_top_k(d_top, ids_top, k, dedup=dedup, min_votes=min_votes)


_IMPLS = ("auto", "xla", "kernel", "kernel_full", "kernel_topk")


def _grouped_use_kernel(impl, x_leaf, metric, block_center=None) -> bool:
    """Whether the grouped path scores with the tile kernels (the JAX
    package's gate, less its TPU-backend clause): dense f32 / bf16 / int8
    blocks (not shared rows), no centered residuals, and ``l2`` /
    ``sql2``.  ``impl="xla"`` never does; "auto" does where the kernels
    serve; "kernel", "kernel_full" and "kernel_topk" raise where they do
    not."""
    if impl == "xla":
        return False
    ok = (block_center is None and not callable(metric)
          and grouped_kernel_ok(x_leaf, metric))
    if impl in ("kernel", "kernel_full", "kernel_topk") and not ok:
        raise ValueError(
            f"impl={impl!r} needs dense f32/bf16/int8 blocks (not centered, "
            f"not shared rows, not ELL) and metric l2 / sql2, got "
            f"{metric!r}; use impl='auto' or 'xla'")
    return ok


def _knn_grouped(f, q, k, budget, probes, metric, dedup, tile_m, nt,
                 tile_chunk=2048, bucket_stop=False, min_votes=1,
                 selection="sort", impl="auto"):
    """One chunk of the grouped serving path; returns
    ``(dists f32[B, k], ids int32[B, k], needed int32[])``, exact iff
    ``needed <= nt``.

    Where :func:`_grouped_use_kernel` admits the tile kernels,
    ``impl="kernel_topk"`` scores with kernel 4, which keeps each pair's
    ``kp = ceil(max(k, 8) / 8) * 8`` nearest in-block candidates, and runs
    the sort tail over ``P * kp`` of them: exact for the top-k, since
    ``kp >= k``.  It needs the sort tail, no vote counting (which needs
    the full lists), f32 or bf16 blocks and ``2 * kp <= lmax``; otherwise,
    and for the other ``impl`` values, the full tile kernel runs and then
    :func:`_selection_tail`.  Where it does not, the XLA form
    (:func:`grouped_distances`, ``tile_chunk`` tiles a step) scores and
    the same tail selects."""
    gsel, lsel = _probe_pairs(f, q, budget, probes, k, bucket_stop)
    kk = k * f.n_trees if dedup else k
    return _grouped_pairs(f, gsel, lsel, q, k, kk, metric, dedup, tile_m, nt,
                          tile_chunk, min_votes, selection, impl)


def _grouped_pairs(f, gsel, lsel, q, k, kk, metric, dedup, tile_m, nt,
                   tile_chunk, min_votes, selection, impl, topk_tail=None):
    """:func:`_knn_grouped` from its (query, block) pairs on: ``gsel``
    rows of ``f``'s packed tables, ``lsel`` leaf ids (-1 to skip), ``kk``
    the sort tail's width.  Kernel 4 (``impl="kernel_topk"``) is followed
    by the sort tail, and runs only with ``selection="sort"``; a sharded
    forest's shard passes ``topk_tail=selection``, as the JAX package's
    sharded scorer runs kernel 4 under either tail."""
    x_leaf, sq_leaf, id_leaf = f._packed
    lens = f._lens_global()
    b, p = gsel.shape
    kp = -(-max(k, 8) // 8) * 8
    if not _grouped_use_kernel(impl, x_leaf, metric, f._block_center):
        d, needed = grouped_distances(
            x_leaf, sq_leaf, lens, gsel, lsel, q, metric, tile_m, nt,
            tile_chunk, block_scale=f._block_scale,
            block_center=f._block_center)
    elif (impl == "kernel_topk" and min_votes == 1
            and (selection == "sort" or topk_tail is not None)
            and 2 * kp <= x_leaf.shape[1] and x_leaf.dtype != torch.int8):
        d_t, i_t, needed = grouped_topk_kernel(
            x_leaf, sq_leaf, id_leaf, lens, gsel, lsel, q, metric, tile_m,
            nt, kp)
        d_out, i_out = _selection_tail_ids(
            d_t.reshape(b, p * kp), i_t.reshape(b, p * kp), k,
            min(kk, p * kp), dedup, selection=topk_tail or "sort")
        return d_out, i_out, needed
    else:
        d, needed = grouped_distances_kernel(
            x_leaf, sq_leaf, lens, gsel, lsel, q, metric, tile_m, nt,
            block_scale=f._block_scale)
    d_out, i_out = _selection_tail(d.reshape(b, -1), id_leaf, gsel, k, kk,
                                   dedup, min_votes, selection)
    return d_out, i_out, needed


def _knn_grouped_many(f, q, chunk, **kw):
    """The grouped path over ``chunk``-query slices of ``q`` (a multiple of
    ``chunk`` rows; :func:`_query_chunks`); ``kw`` are
    :func:`_knn_grouped`'s arguments, its ``nt`` the per-chunk capacity.
    The returned ``needed`` is the maximum over chunks."""
    ds, ids, needs = [], [], []
    for qc in _query_chunks(q, chunk):
        d, i, n = _knn_grouped(f, qc, **kw)
        ds.append(d)
        ids.append(i)
        needs.append(n)
    return torch.cat(ds), torch.cat(ids), torch.stack(needs).amax()


@torch.no_grad()
def _candidate_ids(plan, arrays, q, budget, table=None, leaf_ids=None):
    """Per-tree candidate point ids: ``int32[T, B, F * lmax]``, -1 padded.
    ``leaf_ids``: the descent's leaves, where the caller has them."""
    if leaf_ids is None:
        leaf_ids, _ = _traverse_forest(plan, arrays, q, budget, table)
    return torch.stack([gather_leaf_points(plan, arrays.perm[t], leaf_ids[t])
                        for t in range(leaf_ids.shape[0])])


@torch.no_grad()
def _knn(f, q, k, budget, metric, dedup, min_votes=1):
    """Unpacked forest kNN: the union of the trees' candidates, reranked
    exactly (reference ``knn``; with ``dedup`` it is ``knnPQ``).  With
    ``min_votes > 1`` only ids found by that many trees stay."""
    cand = _candidate_ids(f.plan, f.arrays, q, budget, f._table())
    t, b, c1 = cand.shape
    union = cand.transpose(0, 1).reshape(b, t * c1)
    if min_votes > 1:
        union, dedup = dedup_ids(union, min_votes=min_votes), False
    return rerank_top_k(f.x, f.sq_norms, q, union, k, metric, dedup=dedup)


def _int8_block_dots(x_leaf, block_scale, block_center, sel, q):
    """Dots of int8 blocks ``x_leaf[sel]`` with ``q f32[B, D]`` as the JAX
    package's per-pair scorer forms them: the query quantized per row,
    exact integer dots, then ``dots * block scale * row scale`` in that
    order.  On centered blocks (``block_center = (mu, mudr)``) the query
    less each block's mean is quantized per (query, block) pair and the
    dot is ``q . mu + mudr + dots * block scale * pair scale``.  ``f32[B,
    P, lmax]``."""
    b, p = sel.shape
    _, lmax, d = x_leaf.shape
    bscale = block_scale[sel][..., None]
    if block_center is None:
        q_i8, qscale = _quantize_rows(q)                   # [B, D], [B, 1]
        dots = _int8_dots(q_i8[:, None, :],
                          x_leaf[sel].reshape(b, p * lmax, d))
        return dots.reshape(b, p, lmax) * bscale * qscale[:, :, None]
    mu, mudr = block_center
    mu_g = mu[sel]                                         # [B, P, D]
    qc_i8, qscale = _quantize_rows(q[:, None, :] - mu_g)   # [B, P, D], [B, P, 1]
    dots = _int8_dots(qc_i8.reshape(b * p, 1, d),
                      x_leaf[sel].reshape(b * p, lmax, d)).reshape(b, p, lmax)
    q_mu = (mu_g * q[:, None, :]).sum(-1)
    return q_mu[..., None] + mudr[sel] + dots * bscale * qscale


@torch.no_grad()
def _score_blocks(f, rows_sel, lsel, q, k, kk, metric, dedup, min_votes=1,
                  selection="sort"):
    """Fetch and exactly score each query's selected blocks ``rows_sel
    int32[B, P]`` (``lsel``: leaf ids, -1 to skip), then select: ``(dists
    f32[B, k], ids int32[B, k])``.  f32 and bf16 blocks, and shared f32 /
    bf16 rows, are fetched and multiplied by kernel 6
    (:func:`gather_score`); int8 blocks, plain and centered, by plain
    torch, as the JAX package leaves them to an XLA einsum; a callable
    ``metric`` gets the fetched rows as f32 (not on int8 blocks).  ELL
    blocks are scored by kernel 10, each pair a tile of one
    (:func:`_score_ell_pairs`).  The fetch, the scores and the tail are
    one ``rpt_rerank`` region."""
    with region("rpt_rerank"):
        return _score_blocks_body(f, rows_sel, lsel, q, k, kk, metric, dedup,
                                  min_votes, selection)


def _score_blocks_body(f, rows_sel, lsel, q, k, kk, metric, dedup,
                       min_votes, selection):
    """:func:`_score_blocks`'s body."""
    x_leaf, sq_leaf, id_leaf = f._packed
    b, p = rows_sel.shape
    lmax = x_leaf.shape[1]
    sel = rows_sel.long()
    if isinstance(x_leaf, EllBlocks):
        d = _score_ell_pairs(f, rows_sel, lsel, q, metric)
        return _selection_tail(d, id_leaf, rows_sel, k, kk, dedup, min_votes,
                               selection)
    if callable(metric):
        if x_leaf.dtype == torch.int8:
            raise NotImplementedError(
                "custom distance callables are unsupported on int8-"
                "quantized blocks (pack with f32/bf16)")
        d = metric(fetch_blocks(x_leaf, sel).float(), q[:, None, None, :])
    else:
        if gather_score_ok(x_leaf, p):
            dots, sqx = gather_score(x_leaf, sq_leaf, q,
                                     rows_sel.contiguous())
        else:  # int8 blocks
            dots = _int8_block_dots(x_leaf, f._block_scale, f._block_center,
                                    sel, q)
            sqx = sq_leaf[sel]
        d = distances_from_dots(dots, sqx, q[:, None], metric)
    lens = f._lens_global()[sel]
    valid = (lsel >= 0)[..., None] & (
        torch.arange(lmax, device=q.device) < lens[..., None])
    d = torch.where(valid, d, float("inf")).reshape(b, p * lmax)
    return _selection_tail(d, id_leaf, rows_sel, k, kk, dedup, min_votes,
                           selection)


def _score_ell_pairs(f, rows_sel, lsel, q, metric):
    """Distances ``f32[B, P * lmax]`` of each query to the slots of its
    selected ELL blocks: the pairs in their own order as tiles of one
    (``tb = rows_sel``, ``tp`` the pair index, -1 where ``lsel < 0``)
    through :func:`..ops.ell_kernel.ell_score_tiles`, +inf past each
    block's occupancy."""
    x_leaf, sq_leaf, _ = f._packed
    b, p = rows_sel.shape
    tb = rows_sel.reshape(b * p).contiguous()
    tp = torch.where(lsel.reshape(b * p) >= 0,
                     torch.arange(b * p, dtype=torch.int32, device=q.device),
                     -1).reshape(b * p, 1)
    lens_t = f._lens_global()[tb.long()]
    d = ell_score_tiles(x_leaf, sq_leaf, tb, tp, lens_t, q, (q * q).sum(-1),
                        p, metric)
    return d.reshape(b, p * x_leaf.shape[1])


def _knn_packed(f, q, k, budget, probes, metric, dedup, min_votes=1,
                selection="sort", bucket_stop=False):
    """One chunk of the per-pair path: each query's ``probes``
    lowest-priority leaves (:func:`_probe_pairs`: their sub-blocks where
    the layout has them), fetched and scored one (query, block) pair at a
    time (:func:`_score_blocks`).  ``bucket_stop``: the reference
    ``knnH`` rule keeps only the buckets up to the first ``k`` points,
    counted by the leaves' occupancy."""
    gsel, lsel = _probe_pairs(f, q, budget, probes, k, bucket_stop)
    kk = k * f.n_trees if dedup else k
    return _score_blocks(f, gsel, lsel, q, k, kk, metric, dedup, min_votes,
                         selection)


def _knn_packed_many(f, q, chunk, **kw):
    """The per-pair path over ``chunk``-query slices of ``q`` (a multiple
    of ``chunk`` rows; :func:`_query_chunks`); ``kw`` are
    :func:`_knn_packed`'s arguments."""
    outs = [_knn_packed(f, qc, **kw) for qc in _query_chunks(q, chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


@torch.no_grad()
def _brute_force(x, sq_norms, q, k, metric, precision="highest", rows=None):
    """Exact k nearest neighbours over the whole dataset: ``(dists f32[B,
    k'], ids int32[B, k'])``, ``k' = min(k, n)``, ties to the lower index.

    ``precision="highest"``: fp32 products.  ``"default"`` / ``"fastest"``:
    data and queries rounded to bf16, products summed in fp32; for l2,
    sql2 and dot at ``k <= 128`` that is kernel 5 (:func:`scan_topk`,
    the JAX package's own gate for its fused selection), otherwise a plain
    product of the rounded operands.  The plain forms stream the rows with
    a running exact selection (:func:`stream_topk`); a callable metric gets
    f32 rows at every precision.  Every form selects exactly: the JAX
    package's ``"fastest"`` selects with the TPU's approximate
    ``lax.approx_max_k``.  ``rows``: kernel 5's bf16 copy of ``(x,
    sq_norms)`` (:func:`scan_rows`), where the caller made one.

    Sparse rows (an :class:`EllMatrix`) stream in row chunks, each slot
    gathering the query at its column, in fp32 at every precision, as in
    the JAX package; callables raise there.  Rows and norms of a bf16 or
    f16 dataset are raised to f32 a chunk at a time (kernel 5 reads its
    bf16 copy)."""
    if isinstance(x, EllMatrix):
        return _brute_force_ell(x, sq_norms, q, k, metric)
    k = min(int(k), x.shape[0])
    sq_norms = sq_norms.float()
    fast = precision in ("default", "fastest") and not callable(metric)
    if _uses_scan(fast, metric, k):
        return scan_topk(x, sq_norms, q, k, metric, rows=rows)
    if callable(metric):  # the callable sees [B, c, D] f32 rows
        return stream_topk(
            x, q, k, lambda xc, s: metric(xc.float()[None], q[:, None]),
            width=x.shape[1])
    qf = q.to(torch.bfloat16).float() if fast else q

    def dist(xc, s):
        xc = xc.to(torch.bfloat16).float() if fast else xc.float()
        return distances_from_dots(qf @ xc.T, sq_norms[s:s + xc.shape[0]][None],
                                   q, metric)

    return stream_topk(x, q, k, dist)


@torch.no_grad()
def _brute_force_many(x, sq_norms, q, k, metric, precision, chunk):
    """The exact scan of ``q`` over the raw rows ``x`` (norms
    ``sq_norms``), ``chunk`` queries at a time: :func:`_brute_force` a
    chunk, ``(dists f32[B, k'], ids int32[B, k'])``.  The JAX package's
    ``rptree_tpu/models/forest.py`` ``_brute_force_many``, one
    ``lax.map`` over the chunks there, a loop of calls here; kernel 5's
    bf16 copy of the rows (:func:`scan_rows`) is made once a call, for
    every chunk.  The JAX package needs ``B`` a multiple of ``chunk``;
    here the last chunk may be shorter."""
    rows = None
    if not isinstance(x, EllMatrix) and _uses_scan(
            precision in ("default", "fastest"), metric,
            min(int(k), x.shape[0])):
        rows = scan_rows(x, sq_norms)
    step = int(chunk)
    outs = [_brute_force(x, sq_norms, q[s:s + step], k, metric, precision,
                         rows) for s in range(0, q.shape[0], step)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _brute_force_ell(x, sq_norms, q, k, metric):
    """:func:`_brute_force` over ELL rows: row chunks of the gather form
    (the one-shot form would make ``[B, n, K]``) and a running exact
    selection, ties to the lower index."""
    if callable(metric):
        raise NotImplementedError("custom distance callables need dense "
                                  "data rows")
    b, kz = q.shape[0], x.k
    vals, sq_norms = x.vals.float(), sq_norms.float()

    def dist(cc, s):
        c = cc.shape[0]
        qg = q[:, cc.reshape(c * kz).long()].reshape(b, c, kz)
        dots = (vals[s:s + c][None] * qg).sum(-1)
        return distances_from_dots(dots, sq_norms[s:s + c][None], q, metric)

    return stream_topk(x.cols, q, min(int(k), x.n), dist, width=kz)


def _uses_scan(fast, metric, k):
    """Whether a scan at these settings runs kernel 5: bf16 products, l2 /
    sql2 / dot, ``k <= 128`` (the JAX package's gate for its fused scan)."""
    return fast and not callable(metric) and metric in SCAN_METRICS \
        and k <= SCAN_MAX_K


def _found(exact_ids, cand):
    """Which of the exact ids each tree's candidates hold: ``bool[T, B,
    k']`` (``exact_ids int32[B, k']``, ``cand int32[T, B, C]``, -1
    padded)."""
    return torch.stack([((exact_ids[:, :, None] == c[:, None, :])
                         & (c[:, None, :] >= 0)).any(-1) for c in cand])


def _recall(found, k):
    """Mean over trees of ``|candidates . exact top-k| / k``: ``f32[B]``."""
    return (found.sum(-1).float() / k).mean(0)


@torch.no_grad()
def _knn_h_ids(plan, arrays, q, k, budget, table=None):
    """Candidate point ids selected by the knnH bucket-stop rule
    (reference ``knnH``): all trees' buckets in ascending priority (a
    stable sort; empty slots +inf) while the running size stays ``<= k``,
    the first always kept.  ``int32[B, T * F * lmax]``, -1 padded."""
    leaf_ids, prio = _traverse_forest(plan, arrays, q, budget, table)
    t, b, f = leaf_ids.shape
    leaf_bt = leaf_ids.transpose(0, 1).reshape(b, t * f)
    prio_bt = torch.where(leaf_bt >= 0,
                          prio.transpose(0, 1).reshape(b, t * f),
                          float("inf"))
    order = torch.sort(prio_bt, dim=1, stable=True).indices
    leaf_s = leaf_bt.gather(1, order)
    tree_s = order // f                     # the (tree, slot) order's tree
    lens = torch.as_tensor(plan.leaf_len, dtype=torch.int64,
                           device=q.device)
    sizes = torch.where(leaf_s >= 0, lens[leaf_s.long().clamp_min(0)], 0)
    first = torch.arange(t * f, device=q.device)[None, :] == 0
    keep = (torch.cumsum(sizes, dim=1) <= k) | first
    leaf_kept = torch.where(keep & (leaf_s >= 0), leaf_s, -1)
    pos, valid = leaf_positions(plan, leaf_kept)      # [B, T * F * lmax]
    lmax = max(plan.max_leaf_len, 1)
    tree_pos = tree_s.repeat_interleave(lmax, dim=1)
    ids = arrays.perm.reshape(-1)[tree_pos * plan.n + pos]
    return torch.where(valid, ids, -1).to(torch.int32)


@torch.no_grad()
def _knn_h_ids_packed(f, q, k, budget):
    """:func:`_knn_h_ids` over the packed id blocks and their occupancy
    (:meth:`RPForest._lens_global`), so that folded rows appear in, and
    count toward the stop rule of, the buckets they were folded into.
    Kernels 7 and 8 select the buckets."""
    lens = f._lens_global()
    id_leaf = f._packed[2]
    gsel, lsel = _select_probes(f.plan, f.arrays, q, budget,
                                f.n_trees * budget, k=k, bucket_stop=True,
                                block_len=lens, table=f._table())
    sel = gsel.long()
    slots = torch.arange(id_leaf.shape[1], device=q.device)
    valid = (lsel >= 0)[..., None] & (slots < lens[sel][..., None])
    ids = id_leaf[f._fold_row_of(sel)]
    return torch.where(valid, ids, -1).reshape(q.shape[0], -1)


@torch.no_grad()
def _descend(plan, arrays, xnew):
    """The leaf each point of ``xnew f32[M, D]`` reaches in each tree by
    pure threshold descent (the placement step of the reference's
    ``insert``): ``proj >= thr`` goes right, the primary side that the
    query descent follows, over the projections that it uses
    (:func:`..ops.traverse.project_queries`, IEEE fp32), so that a folded
    point and a query at its place reach the same leaf.  ``int32[T,
    M]``."""
    nl = plan.n_levels
    t, m, dev = arrays.perm.shape[0], xnew.shape[0], xnew.device
    if nl == 0:
        return torch.zeros((t, m), dtype=torch.int32, device=dev)
    proj = project_queries(xnew, arrays.r, nl)               # [T, L, M]
    child = torch.as_tensor(plan.padded_child_table(), dtype=torch.int64,
                            device=dev)
    smax = child.shape[1]
    code = torch.zeros((t, m), dtype=torch.int64, device=dev)
    leaf = torch.full((t, m), -1, dtype=torch.int64, device=dev)
    for lvl in range(nl):
        my_thr = arrays.thr[:, lvl, :].gather(1, code)
        live = leaf < 0
        side = (proj[:, lvl, :] >= my_thr).long()
        nxt = child[lvl][code.clamp(0, smax - 1), side]
        leaf = torch.where(live & (nxt < 0), -(nxt + 1), leaf)
        code = torch.where(live & (nxt >= 0), nxt, code)
    return leaf.to(torch.int32)


def _ranks(g_row: np.ndarray) -> np.ndarray:
    """Stable rank of each element within its group of equal values."""
    width = g_row.shape[0]
    order = np.argsort(g_row, kind="stable")
    gs = g_row[order]
    first = np.concatenate([[True], gs[1:] != gs[:-1]])
    start = np.maximum.accumulate(np.where(first, np.arange(width), 0))
    rank = np.empty(width, np.int64)
    rank[order] = np.arange(width) - start
    return rank


def _ell_slots(rows, kz: int):
    """Dense rows ``f32[M, D]`` of at most ``kz`` nonzeros each as ELL slot
    lists ``(cols int32[M, kz], vals f32[M, kz])``: the nonzero columns in
    ascending order, then padding ``(0, 0)``."""
    nz = rows != 0
    at = nz.cumsum(1, dtype=torch.int32) - 1       # each nonzero's slot
    r, c = (nz & (at < kz)).nonzero(as_tuple=True)
    cols = torch.zeros((rows.shape[0], kz), dtype=torch.int32,
                       device=rows.device)
    vals = torch.zeros((rows.shape[0], kz), device=rows.device)
    cols[r, at[r, c]] = c.to(torch.int32)
    vals[r, at[r, c]] = rows[r, c]
    return cols, vals


def _keep_rows(x, payloads, dead):
    """``x`` and its payload list without the rows where the bool mask
    ``dead`` is set."""
    keep = ~dead
    return (x[torch.as_tensor(keep, device=x.device)],
            [p for p, kp in zip(payloads, keep) if kp])


class RPForest:
    """A built RP forest index over a dataset, with online updates.

    Attributes:
      plan: static tree shape (shared by all trees).
      arrays: :class:`TreeArrays` with a leading ``[T]`` axis.
      x: the dataset ``f32[n, D]``, or an :class:`EllMatrix` of sparse
        rows, on the forest's device (None after :meth:`drop_dataset`).
      sq_norms: ``f32[n]`` squared norms.
      config: the :class:`ForestConfig` it was built with.
      payloads: an optional host-side sequence of per-point payloads
        (the reference's ``Embed.eData``; row ids key into it).
      seed: the seed the projections were drawn from, where known.
    """

    def __init__(self, plan: TreePlan, arrays: TreeArrays, x: torch.Tensor,
                 sq_norms: torch.Tensor, config: ForestConfig,
                 payloads: Optional[Sequence] = None,
                 seed: Optional[int] = None):
        self.plan = plan
        self.arrays = arrays
        self.x = x
        self.sq_norms = sq_norms
        self.config = config
        self.payloads = payloads
        self.seed = seed
        self._packed = None        # (x_leaf, sq_leaf, id_leaf) or None
        self._block_scale = None   # f32[G] for int8 blocks
        self._block_center = None  # (mu f32[G, D], mudr f32[G, lmax]), centered
        self._sub_len_dev = None   # int32[G] sub-block occupancy (sub > 1)
        self._r_sub = None         # f32[D] the sub-block ordering direction
        self._pack_cfg = None      # the packed layout's _PackCfg
        self._lens_dev = None      # int32[T * n_leaves] leaf occupancy
        self._nodes = None         # node table (kernel 7's records)
        self._grouped_nt = {}      # learned tile capacities by shape key
        self._grouped_last = None  # (needed, capacity) of the last call
        self._reset_updates()

    def _reset_updates(self):
        """No pending, folded or removed points (a fresh build)."""
        self._pending = []          # pending rows f32[m, D], one per add
        self._pending_payloads = []
        self._pending_deleted = None  # removed offsets into the buffer
        self._deleted = None        # host bool[n + n_folded] tombstones
        self._deleted_dev = None    # their copy on the forest's device
        self._block_len = None      # host int32[G] occupancy after fold
        self._folded_x = []         # folded rows f32[m, D], one per fold
        self._folded_leaf = []      # host int32[T, m]: their leaves
        self._folded_payloads = []
        self._folded_cat = None     # (n_folded, x, sq): x with folded rows

    @property
    def n_trees(self) -> int:
        return int(self.arrays.perm.shape[0])

    @property
    def n_points(self) -> int:
        return self.plan.n

    @property
    def dim(self) -> int:
        if self.x is None:  # serve-only: the packed blocks' width
            blocks = self._packed[0]
            return (blocks.dim if isinstance(blocks, EllBlocks)
                    else int(blocks.shape[-1]))
        return (self.x.dim if isinstance(self.x, EllMatrix)
                else int(self.x.shape[1]))

    @property
    def _is_ell(self) -> bool:
        """Whether the dataset is sparse (ELL), also after
        :meth:`drop_dataset`."""
        return isinstance(self.x, EllMatrix) or (
            self._packed is not None and isinstance(self._packed[0],
                                                    EllBlocks))

    @property
    def device(self) -> torch.device:
        return self.arrays.perm.device

    def _budget(self, budget: Optional[int]) -> int:
        if budget is None:
            budget = min(self.plan.n_leaves, DEFAULT_BUDGET)
        return max(1, min(int(budget), self.plan.n_leaves))

    @staticmethod
    def _check_k(k) -> int:
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        return k

    def _require_x(self, what: str):
        if self.x is None:
            raise ValueError(f"dataset dropped (drop_dataset); {what} "
                             f"needs the raw rows")

    def _table(self):
        """The forest's node table, built on first use and dropped by
        :meth:`rebuild`, which replaces ``arrays``."""
        if self._nodes is None:
            a = self.arrays
            self._nodes = node_table(self.plan, a.thr, a.mgl, a.mgh)
        return self._nodes

    def _leaf_lens(self) -> torch.Tensor:
        """Per-leaf occupancy ``int32[T * n_leaves]`` in global leaf
        order, which the probe selection's bucket stop counts: after
        :meth:`fold` the blocks' own counts (:meth:`_store_block_len`),
        else the plan's leaf lengths tiled over trees."""
        if self._lens_dev is None:
            self._lens_dev = torch.as_tensor(
                np.tile(np.asarray(self.plan.leaf_len, np.int32),
                        self.n_trees), device=self.device)
        return self._lens_dev

    @property
    def _sub_block(self) -> int:
        """Sub-blocks per leaf of the packed layout (1 unpacked)."""
        return 1 if self._pack_cfg is None else self._pack_cfg.sub_block

    def _lens_global(self) -> torch.Tensor:
        """Per-block occupancy ``int32[G]`` in global block order, the one
        table every kernel that reads block occupancy gets (kernels 1, 2,
        4, 6 and 9, and the masks): the sub-blocks' where the layout has
        them, else :meth:`_leaf_lens`."""
        if self._sub_block > 1:
            return self._sub_len_dev
        return self._leaf_lens()

    def _store_block_len(self, bl: np.ndarray) -> None:
        """Record the blocks' occupancy after a fold, on the host and as
        the device table :meth:`_lens_global` returns."""
        self._block_len = bl
        self._lens_dev = torch.as_tensor(bl, device=self.device)

    _index_axis = None  # the sharded subclass names its mesh axis

    def _fold_row_of(self, g):
        """The storage row of global block ``g`` (a numpy array or an
        integer tensor) in the packed tables: ``g`` itself here; the
        leaf-sharded layout of :class:`..parallel.DistributedForest` stores
        it elsewhere."""
        return g

    # -- introspection (reference Internal.hs / RPTree.hs accessors) ------

    def levels(self) -> int:
        """Number of projection levels (the length of the reference's
        ``rvs``)."""
        return int(self.arrays.r.shape[1])

    def tree_size(self, t: int = 0) -> int:
        """Points stored in tree ``t`` (reference ``treeSize``): ``n`` for
        every tree."""
        del t
        return self.plan.n

    def leaf_sizes(self) -> np.ndarray:
        """Per-leaf occupancy (reference ``leafSizes``), the same in every
        tree."""
        return np.asarray(self.plan.leaf_len)

    def tree_stats(self) -> dict:
        """Node counts (reference ``treeStats``)."""
        return {"n_leaves": self.plan.n_leaves,
                "n_branches": self.plan.n_branches,
                "n_levels": self.plan.n_levels,
                "max_leaf_len": self.plan.max_leaf_len}

    def leaves(self, t: int = 0) -> list:
        """Leaf buckets of tree ``t`` as lists of point ids (reference
        ``leaves``)."""
        perm = self.arrays.perm[t].cpu().numpy()
        return [perm[s:s + m].tolist()
                for s, m in zip(self.plan.leaf_start, self.plan.leaf_len)]

    def points(self) -> torch.Tensor:
        """The indexed dataset (reference ``points``), densified, with the
        rows :meth:`fold` appended after it, so that row ``i`` is the point
        of id ``i``: ``[n + n_folded, D]`` on the forest's device, in the
        dataset's type (f32 once folded rows join a bf16 / f16 one)."""
        self._require_x("points()")
        if isinstance(self.x, EllMatrix):
            return torch.cat([ell_to_dense(self.x), *self._folded_x])
        return self._with_folded()[0]

    def _merge_folded(self, qb, d, ids, k, metric, precision):
        """Merge an exact scan of the folded rows (dense, ids after the
        indexed points') into a ``(dists, ids)`` result over sparse rows,
        which cannot be concatenated with them."""
        xf = torch.cat(self._folded_x)
        df, idf = _brute_force(xf, (xf * xf).sum(-1), qb,
                               min(int(k), xf.shape[0]), metric, precision)
        idf = torch.where(idf >= 0, idf + self.plan.n, -1)
        return merge_top_k(torch.cat([d, df], dim=1),
                           torch.cat([ids, idf.to(ids.dtype)], dim=1), k,
                           dedup=False)

    def _with_folded(self):
        """``(x, sq_norms)`` with the folded rows appended (their ids
        continue after the indexed points'): what the exact scan covers,
        on dense rows (sparse ones take :meth:`_merge_folded`).  The
        concatenation is kept until the next fold."""
        if not self.n_folded:
            return self.x, self.sq_norms
        nf = self.n_folded
        if self._folded_cat is None or self._folded_cat[0] != nf:
            xf = torch.cat([self.x, *self._folded_x])
            self._folded_cat = (nf, xf, (xf * xf).sum(-1))
        return self._folded_cat[1], self._folded_cat[2]

    # -- leaf packing ----------------------------------------------------

    def _validate_pack_args(self, dtype, slack, centered, sub_block,
                            sub_split, store) -> _PackCfg:
        """The requested layout as a :class:`_PackCfg`, or the JAX
        package's refusal, raised before any state changes (a repack first
        drops the old layout, so an invalid call must fail while it is
        still intact)."""
        s = int(sub_block) if sub_block else 1
        if s < 1:
            raise ValueError(f"sub_block must be >= 1, got {sub_block}")
        if int(slack) < 0:
            raise ValueError(f"slack must be >= 0, got {slack}")
        if store not in ("blocks", "shared"):
            raise ValueError(f"store must be 'blocks' or 'shared', "
                             f"got {store!r}")
        int8 = dtype is not None and dtype == torch.int8
        if store == "shared":
            if self._is_ell:
                raise ValueError("store='shared' applies to dense datasets "
                                 "(ELL rows already pack by value)")
            if slack:
                raise ValueError("store='shared' keeps no row blocks for "
                                 "fold() to write into; slack requires "
                                 "the blocked layout")
            if s > 1:
                raise ValueError("sub_block quantization state requires "
                                 "the blocked layout (store='blocks')")
            if centered or int8:
                raise ValueError("quantized blocks require the blocked "
                                 "layout (store='blocks'); shared rows "
                                 "serve the dataset's own f32/bf16 rows")
        if self._is_ell:
            if centered:
                raise ValueError("centered quantization applies to dense "
                                 "blocks only")
            if s > 1:
                raise ValueError("sub_block applies to dense blocks only")
            if int8:
                raise ValueError("int8 quantization applies to dense "
                                 "blocks; ELL blocks pack f32/bf16 values")
            _sub_split_of(sub_split, s)
            bf16 = dtype is not None and dtype == torch.bfloat16
            return _PackCfg("bf16" if bf16 else "f32", int(slack), False, 1,
                            None, store)
        if s > 1 and slack:
            raise ValueError("sub_block and slack are mutually exclusive "
                             "(fold() addresses whole-leaf blocks)")
        if centered and not int8:
            raise ValueError("centered=True applies to int8 blocks "
                             "(pass dtype=torch.int8)")
        dtype_str = _dtype_str(dtype)
        split = _sub_split_of(sub_split, s)
        return _PackCfg(dtype_str, int(slack), bool(centered), s,
                        split if s > 1 else None, store)

    def _clear_pack_for_repack(self) -> None:
        """Drop the packed layout so that another can be packed.  Folded
        rows block it (they live only in the blocks' slack slots) and a
        serve-only forest has nothing to repack from."""
        if self.x is None:
            raise ValueError("cannot repack a serve-only forest "
                             "(drop_dataset was called); the packed "
                             "blocks are the only copy of the data")
        if self.n_folded or self._block_len is not None:
            raise ValueError("cannot repack with folded rows in the "
                             "blocks (they live only in the packed slack "
                             "slots); rebuild() first")
        self._drop_pack()

    def _drop_pack(self) -> None:
        """Forget the packed layout and every table it owns."""
        self._packed = self._block_scale = self._block_center = None
        self._sub_len_dev = self._pack_cfg = None
        # learned tile capacities depend on the layout (sub multiplies
        # the pairs); a stale one would mask pairs under check=False
        self._grouped_nt = {}

    @torch.no_grad()
    def pack_leaves(self, dtype=None, slack: int = 0, centered: bool = False,
                    sub_block: int = 1, sub_split: str = "kmeans",
                    store: str = "blocks", *, r_sub=None) -> "RPForest":
        """Copy each leaf's points into one contiguous block: ``x_leaf
        [T * n_leaves, lmax, D]``, with the slot squared norms ``sq_leaf``
        (exact, from the f32 rows; on a bf16 / f16 dataset rounded to its
        type, as its norms are), the point ids ``id_leaf`` (-1 in empty
        slots) and, for ``dtype=torch.int8``, one scale per block
        (``max |row| / 127``; rows divided by it and rounded half to even).
        ``dtype=torch.bfloat16`` rounds the rows to nearest even and
        halves the blocks' memory and read bytes; distances are then
        computed from the bf16 rows.  ``dtype=None`` (or f32) keeps the
        dataset's type as the JAX package does: bf16 blocks for a bf16
        dataset, f32 otherwise (f16 rows as exact f32).  ``slack`` adds
        empty slots per block for :meth:`fold`; the slot axis is aligned
        as in the JAX package.  The parameters are the JAX package's, in
        its order.

        ``centered=True`` (int8 only) quantizes each row's residual around
        its block's f32 mean, and keeps per slot the mean's dot with the
        dequantized residual (``mudr``): the quantization step shrinks by
        the block's center-to-spread ratio, which restores recall on
        clustered data.  ``sub_block=s > 1`` orders each leaf's rows
        (``sub_split="kmeans"``: recursive balanced 2-means, a power of
        two ``s``, else ``"proj"``: a sort by projection on ``r_sub``) and
        cuts it into ``s`` sub-blocks of ``ceil(lmax / s)`` slots rounded
        to 8, each with its own scale and mean; queries still probe whole
        leaves.  ``store="shared"`` keeps one row store (the dataset
        itself for f32, a bf16 copy for bf16) and packs only the blocks'
        id and norm tables: 1/T of the blocked layout's memory, bought
        with row-by-row fetches; results equal the blocked layout's.
        Shared rows exclude ``slack``, int8 and ``sub_block``; sub-blocks
        exclude ``slack``.

        Sparse (ELL) datasets pack into :class:`EllBlocks` of ``lmax =
        max leaf length + slack`` slots (no alignment, as in the JAX
        package), with f32 values, or bf16 for ``dtype=torch.bfloat16``;
        any other ``dtype`` but int8 packs f32.  They refuse int8,
        ``centered``, ``sub_block`` and ``store="shared"``.

        ``r_sub`` (the port's own, keyword-only): the ordering direction
        ``f32[D]`` of sub-blocks; by default drawn from the forest's seed
        (:func:`_sub_r`, not the JAX package's threefry draw).

        Packing the same layout again is a no-op; another layout repacks
        from the dataset (it raises after :meth:`drop_dataset` or with
        folded rows).  An invalid request raises before anything
        changes."""
        cfg = self._validate_pack_args(dtype, slack, centered, sub_block,
                                       sub_split, store)
        if self._packed is not None:
            if cfg == self._pack_cfg:
                return self
            self._clear_pack_for_repack()
        with ieee_fp32():
            if cfg.store == "shared":
                self._pack_shared(cfg)
            elif isinstance(self.x, EllMatrix):
                self._pack_ell(cfg)
            else:
                self._pack_blocks(cfg, r_sub)
        self._pack_cfg = cfg
        self._grouped_nt = {}
        return self

    def _slot_positions(self, lmax: int):
        """Each leaf's dataset positions ``int64[nl, lmax]`` (0 past its
        length) and their validity ``bool[nl, lmax]``, on the forest's
        device."""
        plan = self.plan
        offs = np.arange(lmax)
        lens = np.asarray(plan.leaf_len)
        in_leaf = offs < lens[:, None]
        pos = np.where(in_leaf, np.asarray(plan.leaf_start)[:, None] + offs,
                       0)
        return (torch.as_tensor(pos, device=self.device),
                torch.as_tensor(in_leaf, device=self.device))

    def _tree_rows(self, ti: int, pos: torch.Tensor, in_leaf: torch.Tensor):
        """Tree ``ti``'s leaves as blocks: the ids ``[nl, lmax]`` (-1 in
        empty slots) and the rows ``[nl, lmax, D]`` (zeros there), raised
        to f32."""
        ids = torch.where(in_leaf, self.arrays.perm[ti].long()[pos], -1)
        rows = torch.where(in_leaf[..., None], self.x[ids.clamp_min(0)], 0.0)
        return ids, rows.float()

    def _slot_norms(self, rows: torch.Tensor) -> torch.Tensor:
        """The slot squared norms of f32 ``rows [..., D]``: summed in f32,
        rounded to the dataset's type as its norms are (the bits of the JAX
        package's slot norms on a bf16 dataset), returned as f32."""
        sq = (rows * rows).sum(-1)
        return sq if self.x.dtype == torch.float32 else sq.to(
            self.x.dtype).float()

    def _block_dtype(self, cfg: _PackCfg) -> torch.dtype:
        """The blocks' value type: bf16 or int8 where asked; otherwise
        (``"f32"``, the JAX package's "keep the dataset's type") bf16 on a
        bf16 dataset and f32 on the others (an f16 dataset packs exact f32
        blocks: the kernels read f32 or bf16)."""
        if cfg.dtype != "f32":
            return _BLOCK_DTYPES[cfg.dtype]
        vals = self.x.vals if isinstance(self.x, EllMatrix) else self.x
        return torch.bfloat16 if vals.dtype == torch.bfloat16 else torch.float32

    def _pack_shared(self, cfg: _PackCfg) -> None:
        """The shared-row layout: per tree the blocks' ids and slot norms
        (0 in empty slots), over one row store.  The norms are the blocked
        pack's sums, one tree of rows at a time, so that they are its bits
        on every device (``sq_norms[ids]`` sums in another order on the
        card)."""
        t, nl = self.n_trees, self.plan.n_leaves
        lmax = _tile_align(max(self.plan.max_leaf_len, 1), cfg.dtype)
        pos, in_leaf = self._slot_positions(lmax)
        ids = torch.empty((t, nl, lmax), dtype=torch.int32, device=self.device)
        sq = torch.empty((t, nl, lmax), device=self.device)
        for ti in range(t):
            tid, rows = self._tree_rows(ti, pos, in_leaf)
            ids[ti], sq[ti] = tid, self._slot_norms(rows)
            del rows
        ids = ids.reshape(t * nl, lmax)
        dt = self._block_dtype(cfg)
        rows = self.x if self.x.dtype == dt else self.x.to(dt)
        self._packed = (SharedRows(rows, ids), sq.reshape(t * nl, lmax), ids)

    def _pack_ell(self, cfg: _PackCfg) -> None:
        """The ELL layout, one tree at a time: each leaf's rows' (col, val)
        slot lists, padding slots ``(0, 0)``, the slot norms from the
        dataset's (0 in empty slots) and the ids (-1 there)."""
        plan, x = self.plan, self.x
        lmax = max(plan.max_leaf_len, 1) + cfg.slack
        pos, in_leaf = self._slot_positions(lmax)
        t, nl, kz = self.n_trees, plan.n_leaves, x.k
        dev = self.device
        cols = torch.empty((t, nl, lmax, kz), dtype=torch.int32, device=dev)
        vals = torch.empty((t, nl, lmax, kz), dtype=self._block_dtype(cfg),
                           device=dev)
        sq = torch.empty((t, nl, lmax), device=dev)
        ids = torch.empty((t, nl, lmax), dtype=torch.int32, device=dev)
        for ti in range(t):
            tid = torch.where(in_leaf, self.arrays.perm[ti].long()[pos], -1)
            safe = tid.clamp_min(0)
            cols[ti] = torch.where(in_leaf[..., None], x.cols[safe], 0)
            vals[ti] = torch.where(in_leaf[..., None], x.vals[safe], 0.0)
            sq[ti] = torch.where(in_leaf, self.sq_norms[safe], 0.0)
            ids[ti] = tid
        g = t * nl
        self._packed = (EllBlocks(self.dim, cols.reshape(g, lmax, kz),
                                  vals.reshape(g, lmax, kz)),
                        sq.reshape(g, lmax), ids.reshape(g, lmax))

    def _pack_blocks(self, cfg: _PackCfg, r_sub) -> None:
        """The blocked layouts, one tree at a time (which bounds the f32
        temporaries): rows gathered, ordered and cut into sub-blocks where
        asked, then stored as f32, bf16, int8 or centered int8."""
        plan, s = self.plan, cfg.sub_block
        lmax0 = max(plan.max_leaf_len, 1) + cfg.slack
        # sub-blocks round to 8 rows whatever the dtype (int8's 32-row
        # tile would coarsen their centers)
        ls = -(-lmax0 // s)
        ls = _tile_align(ls, cfg.dtype) if s == 1 else -(-ls // 8) * 8
        lmax = ls * s
        pos, in_leaf = self._slot_positions(lmax)
        nl, d, t = plan.n_leaves, self.dim, self.n_trees
        nb = nl * s                                     # blocks a tree
        valid = in_leaf
        if s > 1:
            r_sub = (_sub_r(self.seed, d, self.device) if r_sub is None
                     else torch.as_tensor(r_sub, dtype=torch.float32,
                                          device=self.device))
            sub_len = _sub_lens(plan.leaf_len, ls, s)
            valid = torch.as_tensor(np.arange(ls)[None, :] < sub_len[:, None],
                                    device=self.device)
            self._sub_len_dev = torch.as_tensor(np.tile(sub_len, t),
                                                device=self.device)
            self._r_sub = r_sub
        int8 = cfg.dtype == "int8"
        x_leaf = torch.empty((t, nb, ls, d), dtype=self._block_dtype(cfg),
                             device=self.device)
        sq_leaf = torch.empty((t, nb, ls), device=self.device)
        id_leaf = torch.empty((t, nb, ls), dtype=torch.int32,
                              device=self.device)
        scale = torch.empty((t, nb), device=self.device) if int8 else None
        mu = (torch.empty((t, nb, d), device=self.device) if cfg.centered
              else None)
        mudr = (torch.empty((t, nb, ls), device=self.device) if cfg.centered
                else None)
        for ti in range(t):
            ids, rows = self._tree_rows(ti, pos, in_leaf)
            (x_leaf[ti], sq_leaf[ti], id_leaf[ti], sc, m,
             md) = self._block_values(cfg, ids, rows, in_leaf, valid, r_sub)
            if int8:
                scale[ti] = sc
            if cfg.centered:
                mu[ti], mudr[ti] = m, md
        g = t * nb
        self._packed = (x_leaf.reshape(g, ls, d), sq_leaf.reshape(g, ls),
                        id_leaf.reshape(g, ls))
        self._block_scale = None if scale is None else scale.reshape(g)
        self._block_center = (None if mu is None else
                              (mu.reshape(g, d), mudr.reshape(g, ls)))

    def _block_values(self, cfg: _PackCfg, ids, rows, in_leaf, valid, r_sub):
        """The packed values of leaf blocks ``rows f32[nb, lmax, D]`` with
        point ids ``ids [nb, lmax]`` (-1 in empty slots) and slot validity
        ``in_leaf``: ordered and cut into ``s`` sub-blocks where the layout
        has them (``valid bool[nb * s, ls]``, their validity; ``in_leaf``
        itself at ``s`` 1), then stored as f32, bf16, int8 or centered
        int8.  Returns ``(x_leaf, sq_leaf, id_leaf int32, scale f32[nb *
        s] or None, mu or None, mudr or None)``."""
        s = cfg.sub_block
        nb, lmax, d = rows.shape
        if s > 1:
            ls = lmax // s
            order = (_sub_order_kmeans(rows, in_leaf, r_sub, s)
                     if cfg.sub_split == "kmeans" else torch.argsort(
                         torch.where(in_leaf, rows @ r_sub, float("inf")),
                         dim=-1, stable=True))
            ids = ids.gather(1, order).reshape(nb * s, ls)
            rows = rows.gather(1, order[..., None].expand(-1, -1, d))
            rows = torch.where(valid[..., None], rows.reshape(nb * s, ls, d),
                               0.0)
            ids = torch.where(valid, ids, -1)
        sq = self._slot_norms(rows)
        ids = ids.to(torch.int32)
        if cfg.centered:
            q8, sc, mu, mudr = _center_quantize(rows, valid)
            return q8, sq, ids, sc.reshape(-1), mu, mudr
        if cfg.dtype == "int8":
            sc = rows.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(
                1e-30) * INV_127
            q8 = torch.round(rows / sc).clamp(-127, 127).to(torch.int8)
            return q8, sq, ids, sc.reshape(-1), None, None
        return rows, sq, ids, None, None, None

    # -- online updates (the freshness layer) --------------------------------

    def add(self, points, payloads: Optional[Sequence] = None,
            rebuild_every: int = 0) -> "RPForest":
        """Insert points online (the reference's streaming ``insert``):
        they land in a pending buffer on the forest's device, which every
        dense query surface scans exactly and merges; their ids continue
        after the indexed and folded points.  :meth:`fold` moves them into
        the packed blocks, :meth:`rebuild` into a fresh index;
        ``rebuild_every > 0`` rebuilds once the buffer holds that many."""
        if self.x is None:
            raise ValueError("cannot add to a serve-only forest "
                             "(drop_dataset was called)")
        p = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        if p.dim() == 1:
            p = p[None, :]
        if p.shape[-1] != self.dim:
            raise ValueError(f"point dim {p.shape[-1]} != index dim "
                             f"{self.dim}")
        if payloads is not None and len(payloads) != p.shape[0]:
            raise ValueError("payloads length != points length")
        self._pending.append(p.contiguous())
        self._pending_payloads.append(
            list(payloads) if payloads is not None else [None] * p.shape[0])
        if rebuild_every and self.n_pending >= rebuild_every:
            self.rebuild()
        return self

    def remove(self, ids) -> "RPForest":
        """Delete points by id (tombstones, kept on the forest's device):
        they stop appearing in results at once, and :meth:`rebuild` purges
        them.  Ids past the indexed and folded points address the pending
        buffer; ids out of range are ignored."""
        ids = (ids.cpu().numpy() if torch.is_tensor(ids)
               else np.asarray(ids)).reshape(-1).astype(np.int64)
        n_idx = self.plan.n + self.n_folded
        if self._deleted is None:
            self._deleted = np.zeros(n_idx, dtype=bool)
        self._deleted[ids[(ids >= 0) & (ids < n_idx)]] = True
        self._deleted_dev = torch.as_tensor(self._deleted, device=self.device)
        in_pending = (ids >= n_idx) & (ids < n_idx + self.n_pending)
        if in_pending.any():
            self._pending_deleted = (self._pending_deleted or set()) | {
                int(i) - n_idx for i in ids[in_pending]}
        return self

    @property
    def n_deleted(self) -> int:
        n = int(self._deleted.sum()) if self._deleted is not None else 0
        return n + len(self._pending_deleted or ())

    @property
    def n_pending(self) -> int:
        return sum(int(c.shape[0]) for c in self._pending)

    @property
    def n_folded(self) -> int:
        return sum(int(c.shape[0]) for c in self._folded_x)

    def _apply_update_hooks(self, qb, d, ids, k, metric, precision):
        """Tombstone masking, then the exact pending merge: applied by
        every dense query surface."""
        if self._deleted is not None:
            d, ids = self._mask_deleted(d, ids, k)
        if self._pending:
            d, ids = self._merge_pending(qb, d, ids, k, metric, precision)
        return d, ids

    def _mask_deleted(self, d, ids, k):
        """Drop tombstoned ids from a ``(dists, ids)`` result and
        re-select."""
        flags = self._deleted_dev
        nflag = flags.shape[0]
        dead = (flags[ids.long().clamp(0, nflag - 1)] & (ids >= 0)
                & (ids < nflag))
        return merge_top_k(torch.where(dead, float("inf"), d),
                           torch.where(dead, -1, ids), k, dedup=False)

    def _merge_pending(self, qb, d, ids, k, metric, precision):
        """The exact scan of the pending buffer (:func:`_brute_force` at
        the caller's ``precision``: kernel 5 where its gate admits the
        settings), merged with the forest's result.  It over-fetches by
        the removed pending points, so that they never crowd live ones
        out of the k."""
        xp = torch.cat(self._pending)
        dead = self._pending_deleted
        kp = min(k + len(dead or ()), xp.shape[0])
        dp, ip = _brute_force(xp, (xp * xp).sum(-1), qb, kp, metric,
                              precision)
        if dead:
            mask = torch.zeros(xp.shape[0], dtype=torch.bool,
                               device=xp.device)
            mask[list(dead)] = True
            hit = mask[ip.long().clamp_min(0)] & (ip >= 0)
            dp = torch.where(hit, float("inf"), dp)
            ip = torch.where(hit, -1, ip)
        ip = torch.where(ip >= 0, ip + self.plan.n + self.n_folded, -1)
        return merge_top_k(torch.cat([d, dp], dim=1),
                           torch.cat([ids, ip.to(ids.dtype)], dim=1), k,
                           dedup=False)

    @torch.no_grad()
    def fold(self) -> "RPForest":
        """Fold the pending buffer into the packed blocks' slack slots:
        each point descends every tree by the stored thresholds
        (:func:`_descend`) and is appended to the block of the leaf it
        reaches, as the next of its slots; ids continue after the indexed
        and the earlier folded points.  A point is folded only if it fits
        in every tree (stable ranks within each block, over all
        candidates first, then over those accepted); the rest stay
        pending.  Rows, norms, the int8 quantization (each row by its
        target block's scale: a true division, rounded half to even,
        clipped to +-127; on centered blocks the residual around the block's
        mean, and the slots' ``mudr`` with it) and the scatter run on the
        forest's device; the ranks on the host, as in the JAX package.
        Needs :meth:`pack_leaves` (``slack=...`` reserves room) with
        whole-leaf blocks: shared rows and sub-blocks refuse, as in the
        JAX package.  Into ELL blocks each point goes as its nonzero
        columns, ascending, in the blocks' K slots; a point with more
        nonzeros than K stays pending.  A sharded forest folds into its
        shards' blocks (:meth:`_fold_row_of` maps a block to its storage
        row)."""
        if self._packed is None:
            raise ValueError("pack_leaves(slack=...) first: fold inserts "
                             "into the packed blocks' slack slots")
        if isinstance(self._packed[0], SharedRows):
            raise ValueError("fold() writes rows into the packed blocks' "
                             "slack slots; the shared-row layout "
                             "(store='shared') keeps no row blocks -- "
                             "rebuild() folds pending points instead")
        if self._sub_block > 1:
            raise ValueError("fold() needs whole-leaf blocks; pack "
                             "without sub_block (or rebuild())")
        if not self._pending:
            return self
        xp = torch.cat(self._pending)
        pays = sum(self._pending_payloads, [])
        if self._pending_deleted:
            xp, pays = _keep_rows(xp, pays, np.isin(
                np.arange(xp.shape[0]), list(self._pending_deleted)))
            self._pending_deleted = None
        m = int(xp.shape[0])
        if m == 0:
            self._pending, self._pending_payloads = [], []
            return self
        with region("rpt_insert"):
            return self._fold_pending(xp, pays, m)

    def _fold_pending(self, xp, pays, m) -> "RPForest":
        """:meth:`fold`'s placement and writes of the live pending rows
        ``xp f32[m, D]`` (the ``rpt_insert`` region)."""
        t, nl = self.n_trees, self.plan.n_leaves
        x_leaf, sq_leaf, id_leaf = self._packed
        lmax = x_leaf.shape[1]
        ell = isinstance(x_leaf, EllBlocks)
        bl = (np.tile(np.asarray(self.plan.leaf_len, np.int32), t)
              if self._block_len is None else self._block_len.copy())
        leaf = _descend(self.plan, self.arrays, xp).cpu().numpy()  # [T, M]
        g = leaf + np.arange(t, dtype=np.int32)[:, None] * nl
        # pass 1: acceptance with conservative ranks over all candidates
        # (rejecting a point only frees slots, so pass 2's ranks are
        # never larger); into ELL blocks only rows that fit the K slots
        fits = (((xp != 0).sum(1) <= x_leaf.shape[2]).cpu().numpy() if ell
                else np.ones(m, bool))
        for tt in range(t):
            fits &= bl[g[tt]] + _ranks(g[tt]) < lmax
        sel = np.flatnonzero(fits)
        if sel.size:
            msel = int(sel.size)
            gsel = g[:, sel]
            # pass 2: contiguous slots among the accepted
            slots = np.stack([bl[gsel[tt]] + _ranks(gsel[tt])
                              for tt in range(t)])
            dev = self.device
            rows = xp[torch.as_tensor(sel, device=dev)]
            # the blocks' storage rows (the leaf-sharded layout keeps
            # block g elsewhere: _fold_row_of)
            gi = torch.as_tensor(self._fold_row_of(gsel.reshape(-1)),
                                 dtype=torch.int64, device=dev)
            si = torch.as_tensor(slots.reshape(-1), dtype=torch.int64,
                                 device=dev)
            if ell:
                rc, rv = _ell_slots(rows, x_leaf.shape[2])
                x_leaf.cols.index_put_((gi, si), rc.repeat(t, 1))
                x_leaf.vals.index_put_((gi, si),
                                       rv.repeat(t, 1).to(x_leaf.dtype))
            else:
                x_leaf.index_put_((gi, si), self._fold_rows(rows, gi, si, t)
                                  .to(x_leaf.dtype))
            base = self.plan.n + self.n_folded
            sq_leaf.index_put_((gi, si), (rows * rows).sum(-1).repeat(t))
            id_leaf.index_put_((gi, si), torch.arange(
                base, base + msel, dtype=torch.int32, device=dev).repeat(t))
            bl += np.bincount(gsel.reshape(-1), minlength=bl.size).astype(
                np.int32)
            self._store_block_len(bl)
            self._folded_x.append(rows)
            self._folded_leaf.append(leaf[:, sel])
            self._folded_payloads.extend(pays[j] for j in sel.tolist())
            if self._deleted is not None:
                self._deleted = np.concatenate([self._deleted,
                                                np.zeros(msel, bool)])
                self._deleted_dev = torch.as_tensor(self._deleted,
                                                    device=dev)
        # the points that overflow stay in the exact pending merge
        rest = np.flatnonzero(~fits)
        self._pending = ([xp[torch.as_tensor(rest, device=xp.device)]]
                         if rest.size else [])
        self._pending_payloads = ([[pays[j] for j in rest.tolist()]]
                                  if rest.size else [])
        return self

    def _fold_rows(self, rows, gi, si, t):
        """The dense blocks' values of folded ``rows f32[M, D]`` for the
        slots ``(gi, si)`` (tree-major, ``T * M``): the rows as they are,
        or int8 codes by each target block's scale (on centered blocks the
        residual around the block's mean, whose ``mudr`` is written
        here)."""
        if self._block_scale is None:
            return rows.repeat(t, 1)
        m = rows.shape[0]
        sc = self._block_scale[gi].reshape(t, m, 1)
        if self._block_center is None:
            vals = torch.round(rows[None] / sc).clamp(-127, 127)
        else:
            mu, mudr = self._block_center
            mu_sel = mu[gi].reshape(t, m, -1)
            vals = torch.round((rows[None] - mu_sel) / sc).clamp(-127, 127)
            mudr.index_put_((gi, si), ((vals * sc) * mu_sel).sum(-1)
                            .reshape(-1))
        return vals.reshape(t * m, -1)

    def _indexed_rows(self) -> torch.Tensor:
        """The indexed rows as one dense tensor on the forest's device, for
        a rebuild (sparse rows densified, as in the JAX package)."""
        return (ell_to_dense(self.x) if isinstance(self.x, EllMatrix)
                else self.x)

    def _rebuild_rows(self):
        """The live dataset for a rebuild: the indexed, folded and pending
        rows, less the removed ones; ``(x_all, payloads or None)``.  Sparse
        rows are densified, as in the JAX package: the rebuilt index is
        dense."""
        x_old = self._indexed_rows()
        pays = (list(self.payloads) if self.payloads is not None
                else [None] * self.plan.n)
        if self.n_folded:
            x_old = torch.cat([x_old, *(f.to(x_old.device)
                                        for f in self._folded_x)])
            pays = pays + list(self._folded_payloads)
        if self._deleted is not None and self._deleted.any():
            x_old, pays = _keep_rows(x_old, pays, self._deleted)
        if self._pending:
            xp = torch.cat(self._pending).to(x_old.device)
            pp = sum(self._pending_payloads, [])
            if self._pending_deleted:
                xp, pp = _keep_rows(xp, pp, np.isin(
                    np.arange(xp.shape[0]), list(self._pending_deleted)))
            x_old, pays = torch.cat([x_old, xp]), pays + pp
        return x_old, (None if all(p is None for p in pays) else pays)

    @torch.no_grad()
    def rebuild(self) -> "RPForest":
        """A fresh index over the live points (pending and folded points
        in, removed ones out), with the forest's own projections
        (``arrays.r``, which the JAX package draws again from ``seed``) and
        construction parameters; the plan follows the new size.  Ids are
        renumbered; payloads follow their points.  A packed forest is
        packed again in the same layout.  Every cache that the old plan or
        arrays fed is dropped: the node table (kernel 7 reads its records,
        not ``arrays``), the occupancy table (kernels 1, 2, 4, 6, 8 and 9)
        and the learned tile capacities (a stale one would mask pairs
        under ``check=False``).  A sparse forest rebuilds over its rows
        densified, as the JAX package's does, and packs them as dense
        blocks of its layout's value type and slack."""
        if not self._pending and self.n_deleted == 0 and self.n_folded == 0:
            return self
        self._require_x("rebuild()")
        x_all, payloads = self._rebuild_rows()
        cfg = self.config
        self.plan = make_plan(int(x_all.shape[0]), cfg.max_depth,
                              cfg.min_leaf)
        self.arrays = self._build_arrays(self.plan, x_all, self.arrays.r)
        self.x, self.sq_norms = x_all, _sq_norms(x_all)
        self.payloads = payloads
        self._reset_updates()
        self._nodes = self._lens_dev = self._grouped_last = None
        self._grouped_nt = {}
        if self._packed is not None:  # the whole remembered layout
            self._replay_pack(self._pack_cfg)
        return self

    def _build_arrays(self, plan, x, r) -> TreeArrays:
        """The trees of ``x`` under ``r`` (the sharded forest builds them
        tree-parallel)."""
        return build_forest_arrays(plan, x, r)

    def _replay_pack(self, cfg: _PackCfg) -> None:
        """Pack again in the layout ``cfg`` (the sharded forest in its
        shard mode too)."""
        self._drop_pack()
        self.pack_leaves(_BLOCK_DTYPES[cfg.dtype], cfg.slack, cfg.centered,
                         cfg.sub_block, cfg.sub_split or "kmeans", cfg.store,
                         r_sub=self._r_sub)

    def drop_dataset(self) -> "RPForest":
        """Serve-only mode: release the dataset and its norms and keep the
        packed blocks, which hold every point.  The packed query paths
        keep working; :meth:`brute_force_knn`, :meth:`recall_with`,
        :meth:`points`, :meth:`add`, :meth:`rebuild` and the unpacked
        paths raise."""
        if self._packed is None:
            raise ValueError("pack_leaves() first: the packed blocks are "
                             "the only remaining copy of the data")
        if isinstance(self._packed[0], SharedRows):
            raise ValueError("the shared-row layout (store='shared') "
                             "serves from the dataset array itself -- "
                             "there is no separate copy to drop (it is "
                             "already the single-copy mode)")
        self.x = self.sq_norms = self._folded_cat = None
        return self

    def payload_of(self, ids) -> list:
        """Resolve ids to payloads: None where the id is negative or past
        every point, the id itself where no payloads were given.  Ids past
        the indexed points resolve into the folded rows first, then the
        pending buffer."""
        ids = (ids.cpu().numpy() if torch.is_tensor(ids)
               else np.asarray(ids)).reshape(-1)
        pending = sum(self._pending_payloads, [])
        folded = self._folded_payloads

        def one(i):
            i = int(i)
            if i < 0:
                return None
            if i >= self.plan.n:
                j = i - self.plan.n
                if j < len(folded):
                    return folded[j]
                j -= len(folded)
                return pending[j] if j < len(pending) else None
            return i if self.payloads is None else self.payloads[i]

        return [one(i) for i in ids]

    # -- per-pair and unpacked serving --------------------------------------

    @torch.no_grad()
    def knn(self, q, k: int, metric="l2", budget: Optional[int] = None,
            dedup: bool = True, precision: str = "highest",
            probes: Optional[int] = None, min_votes: int = 1,
            selection: str = "sort") -> Tuple[torch.Tensor, torch.Tensor]:
        """k nearest neighbours of ``q`` (a vector or a ``[B, D]`` batch):
        ``(dists f32[B, k], ids int32[B, k])`` in ascending distance,
        ``(+inf, -1)`` where fewer than k candidates.  The parameters are
        the JAX package's, in its order.

        Unpacked, the trees' candidate buckets are unioned and reranked
        exactly (``dedup=False`` keeps the reference ``knn``'s repeats).
        After :meth:`pack_leaves`, the per-pair path: ``probes`` caps the
        leaf blocks reranked per query (lowest margin priority first;
        default ``n_trees * budget``, no cap), and ``selection`` is "sort"
        or "kernel" (the top-k kernel, k <= 128).  ``min_votes > 1`` keeps
        only candidates found by at least that many trees.  ``metric``:
        ``l2``, ``sql2``, ``cosine``, ``dot`` or a callable
        ``distf(rows[..., C, D], q[..., 1, D]) -> [..., C]`` of torch
        operations (not on int8 blocks).

        ``precision`` takes the JAX package's values and sets only the
        exact scan of the pending buffer (:meth:`add`; bf16 products at
        "default" / "fastest", kernel 5 where its gate admits them): f32
        rows are always multiplied in full fp32, bf16 blocks by exact
        products of bf16 values summed in fp32.  Removed points
        (:meth:`remove`) never appear."""
        k = self._check_k(k)
        _check_precision(precision)
        min_votes = int(min_votes)
        qb = _as_dense_queries(q, self.dim, self.device)
        budget = self._budget(budget)
        if self._packed is None:
            self._require_x("the unpacked path")
            d, ids = _knn(self, qb, k, budget, metric, dedup, min_votes)
        else:
            _check_selection(selection, k, min_votes)
            probes = int(self.n_trees * budget if probes is None else probes)
            d, ids = _knn_packed(self, qb, k, budget, probes, metric, dedup,
                                 min_votes, selection)
        return self._apply_update_hooks(qb, d, ids, k, metric, precision)

    @torch.no_grad()
    def knn_batched(self, q, k: int, metric="l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest",
                    probes: Optional[int] = None, min_votes: int = 1,
                    chunk: int = 4096, selection: str = "sort"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The per-pair path of :meth:`knn` over a large batch, ``chunk``
        queries at a time, so its rerank buffers stay per chunk.  Requires
        :meth:`pack_leaves`; results equal chunked :meth:`knn` calls.

        An :class:`EllMatrix` batch stays sparse: each chunk densifies
        only its own ``[chunk, dim]`` rows.  It takes no pending merge,
        which needs dense query rows: with points pending it raises
        (``fold()`` or ``rebuild()`` first)."""
        with entry("rpt_knn_batched"):
            if self._packed is None:
                raise ValueError("pack_leaves() first: knn_batched runs "
                                 "the leaf-blocked pipeline")
            k = self._check_k(k)
            _check_precision(precision)
            min_votes = int(min_votes)
            _check_selection(selection, k, min_votes)
            budget = self._budget(budget)
            probes = int(self.n_trees * budget if probes is None
                         else probes)
            qb, b, chunk = _pad_to_chunk(self._query_batch(q), chunk)
            d, ids = _knn_packed_many(self, qb, chunk, k=k, budget=budget,
                                      probes=probes, metric=metric,
                                      dedup=dedup, min_votes=min_votes,
                                      selection=selection)
            return self._apply_update_hooks(
                None if isinstance(qb, EllMatrix) else qb[:b], d[:b],
                ids[:b], k, metric, precision)

    def _query_batch(self, q):
        """A batch for the chunked paths: an :class:`EllMatrix` stays
        sparse (on the forest's device; it refuses pending points, whose
        merge needs dense query rows), anything else becomes dense rows
        (:func:`_as_dense_queries`)."""
        if not isinstance(q, EllMatrix):
            return _as_dense_queries(q, self.dim, self.device)
        if q.dim != self.dim:
            raise ValueError(f"query dim {q.dim} != index dim {self.dim}")
        if self._pending:
            raise ValueError("sparse-query batches do not support the exact "
                             "pending merge (it needs dense query rows); "
                             "fold() or rebuild() first")
        return q.to(self.device)

    @torch.no_grad()
    def candidates(self, q, budget: Optional[int] = None,
                   tree: Optional[int] = None) -> torch.Tensor:
        """Candidate point ids per tree (reference ``candidates``):
        ``int32[T, B, C]`` (-1 padded), or ``[B, C]`` for one ``tree``."""
        qb = _as_dense_queries(q, self.dim, self.device)
        cand = _candidate_ids(self.plan, self.arrays, qb,
                              self._budget(budget), self._table())
        return cand if tree is None else cand[tree]

    @torch.no_grad()
    def recall_with(self, q, k: int, metric="l2",
                    budget: Optional[int] = None) -> torch.Tensor:
        """Average recall@k over the forest's trees (reference
        ``recallWith``): per tree, the share of the exact k nearest (fp32
        scan, folded rows included) among its candidates.  A folded row
        is a tree's candidate where the leaf it was folded into is among
        the descent's leaves.  Returns ``f32[B]``."""
        self._require_x("recall")
        qb = _as_dense_queries(q, self.dim, self.device)
        k = self._check_k(k)
        budget = self._budget(budget)
        _, exact = self.brute_force_knn(qb, k, metric=metric)
        leaf_sel, _ = _traverse_forest(self.plan, self.arrays, qb, budget,
                                       self._table())
        found = _found(exact, _candidate_ids(self.plan, self.arrays, qb,
                                             budget, leaf_ids=leaf_sel))
        if self.n_folded:
            n = self.plan.n
            fl = torch.as_tensor(np.concatenate(self._folded_leaf, axis=1),
                                 device=self.device)           # [T, M]
            fleaf = fl[:, (exact.long() - n).clamp(0, fl.shape[1] - 1)]
            found_f = (leaf_sel[:, :, None, :] == fleaf[..., None]).any(-1)
            found = torch.where((exact >= n)[None], found_f, found)
        return _recall(found, k)

    # -- the reference knnPQ / knnH ----------------------------------------

    @torch.no_grad()
    def knn_pq(self, q, k: int, metric="l2", budget: Optional[int] = None,
               precision: str = "highest"):
        """Deduplicating kNN (reference ``knnPQ``): :meth:`knn` with
        ``dedup=True``."""
        return self.knn(q, k, metric=metric, budget=budget, dedup=True,
                        precision=precision)

    @torch.no_grad()
    def knn_h(self, q, k: int, metric="l2", budget: Optional[int] = None,
              dedup: bool = True, precision: str = "highest",
              probes: Optional[int] = None):
        """Margin-priority kNN (reference ``knnH``): all trees' buckets in
        ascending margin priority until ``k`` points are collected (the
        first always kept), reranked exactly and cut to k.  Packed, it is
        the per-pair path with the bucket stop (kernels 7, 8 and 6;
        ``probes`` bounds the bucket window, default ``n_trees * budget``),
        counting the blocks' occupancy, folded rows included; unpacked,
        the buckets of :meth:`knn_h_buckets`, reranked.  Tombstones and
        the pending buffer apply as in :meth:`knn`."""
        k = self._check_k(k)
        _check_precision(precision)
        qb = _as_dense_queries(q, self.dim, self.device)
        budget = self._budget(budget)
        if self._packed is not None:
            probes = int(self.n_trees * budget if probes is None else probes)
            d, ids = _knn_packed(self, qb, k, budget, probes, metric, dedup,
                                 bucket_stop=True)
        else:
            self._require_x("the unpacked path")
            ids = _knn_h_ids(self.plan, self.arrays, qb, k, budget,
                             self._table())
            d, ids = rerank_top_k(self.x, self.sq_norms, qb, ids, k, metric,
                                  dedup=dedup)
        return self._apply_update_hooks(qb, d, ids, k, metric, precision)

    @torch.no_grad()
    def knn_h_buckets(self, q, k: int, budget: Optional[int] = None):
        """The candidate ids the knnH bucket stop selects, unsorted and
        untruncated (the reference ``knnH``'s own return): ``int32[B,
        M]``, -1 padded, buckets in ascending priority.  After
        :meth:`fold` they are read from the packed id blocks with their
        occupancy, so folded rows appear in their buckets and count toward
        the stop."""
        k = self._check_k(k)
        qb = _as_dense_queries(q, self.dim, self.device)
        if self.n_folded:
            return _knn_h_ids_packed(self, qb, k, self._budget(budget))
        return _knn_h_ids(self.plan, self.arrays, qb, k, self._budget(budget),
                          self._table())

    # -- grouped serving ---------------------------------------------------

    @torch.no_grad()
    def knn_grouped(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest",
                    probes: Optional[int] = None, tile_m: int = 16,
                    nt: Optional[int] = None, tile_chunk: int = 2048,
                    bucket_stop: bool = False, min_votes: int = 1,
                    selection: str = "sort", impl: str = "auto",
                    check: bool = True, chunk: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Query-grouped block-resident kNN: queries probing the same leaf
        block share one read of it per tile.  Returns ``(dists f32[B, k],
        ids int32[B, k])`` (``(+inf, -1)`` where fewer than k candidates).
        The parameters are the JAX package's, in its order.

        ``selection``: "sort" (stable sort, ``k * n_trees`` overselect
        with ``dedup``, then :func:`merge_top_k`) or "kernel" (the top-k
        kernel; k <= 128).  ``min_votes > 1`` keeps only ids found in at
        least that many of the probed blocks and always takes the sort
        tail over the full candidate list.  ``metric``: ``l2``, ``sql2``,
        ``cosine``, ``dot`` or a callable ``distf(rows[..., L, D], q[...,
        1, D]) -> [..., L]`` of torch operations (not on int8 blocks).
        ``impl``: "auto" scores ``l2`` / ``sql2`` with the full tile
        kernel and every other metric with the XLA form (batched products,
        :func:`..ops.grouped.grouped_distances`); "xla" always with the
        XLA form; "kernel" and "kernel_full" with the full tile kernel,
        "kernel_topk" with the per-pair top-kp kernel where it applies
        (see :func:`_knn_grouped`), and these three raise ``ValueError``
        for a metric the kernels do not serve.  ``tile_chunk`` is the
        XLA form's step in tiles (it bounds the gathered blocks' memory).

        ``precision`` takes the JAX package's values and sets only the
        pending buffer's scan, as in :meth:`knn`; on the JAX package's
        kernel paths it changes nothing either: f32 blocks are always
        scored in full fp32 (the XLA form too: the JAX package floors it
        at ``HIGH``), bf16 blocks by exact products of bf16 values summed
        in fp32.

        The tile capacity auto-sizes (see :func:`_grouped_auto_capacity`);
        ``check=False`` is the steady-state mode that skips reading the
        needed tile count back once a capacity for this shape is known
        (overflow then masks candidates, see :meth:`grouped_overflow`).
        ``chunk`` serves the batch ``chunk`` queries at a time (default:
        all at once; 4,096 for an :class:`EllMatrix` batch, which stays
        sparse as in :meth:`knn_batched`), with ``nt`` and the cached
        capacity per chunk.
        """
        with entry("rpt_knn_grouped"):
            if self._packed is None:
                raise ValueError("pack_leaves() first: knn_grouped runs on "
                                 "the leaf-blocked layout")
            _check_precision(precision)
            k = self._check_k(k)
            min_votes = int(min_votes)
            _check_selection(selection, k, min_votes)
            if impl not in _IMPLS:
                raise ValueError(f"unknown impl {impl!r}")
            if callable(metric) and isinstance(self._packed[0], EllBlocks):
                raise NotImplementedError(
                    "custom distance callables need dense data rows "
                    "(ELL-sparse datasets support the builtin metrics "
                    "only)")
            if callable(metric) and self._packed[0].dtype == torch.int8:
                raise NotImplementedError(
                    "custom distance callables are unsupported on int8-"
                    "quantized blocks (pack with f32/bf16)")
            _grouped_use_kernel(impl, self._packed[0], metric,
                                self._block_center)  # raises early
            budget = self._budget(budget)
            probes = int(self.n_trees * budget if probes is None
                         else probes)
            qb = self._query_batch(q)
            ell = isinstance(qb, EllMatrix)
            qb, b, chunk = _pad_to_chunk(qb, (4096 if ell else qb.shape[0])
                                         if chunk is None else chunk)

            def run(cap):
                d, ids, needed = _knn_grouped_many(
                    self, qb, chunk, k=k, budget=budget, probes=probes,
                    metric=metric, dedup=dedup, tile_m=int(tile_m), nt=cap,
                    tile_chunk=int(tile_chunk), bucket_stop=bucket_stop,
                    min_votes=min_votes, selection=selection, impl=impl)
                return (d, ids), needed

            key = (qb.shape[0], probes, int(tile_m), chunk)
            d, ids = _grouped_auto_capacity(self, key,
                                            chunk * probes * self._sub_block,
                                            tile_m, nt, run, check=check)
            return self._apply_update_hooks(None if ell else qb[:b], d[:b],
                                            ids[:b], k, metric, precision)

    def grouped_overflow(self) -> Optional[dict]:
        """Overflow telemetry of the most recent :meth:`knn_grouped` call:
        ``{"needed", "capacity", "overflow"}`` (reads the needed tile count
        back from the device), or None before any call."""
        if self._grouped_last is None:
            return None
        needed, cap = self._grouped_last
        n = int(needed)
        return {"needed": n, "capacity": int(cap), "overflow": n > cap}

    # -- ground truth ------------------------------------------------------

    @torch.no_grad()
    def brute_force_knn(self, q, k: int, metric="l2",
                        precision: str = "highest",
                        query_chunk: Optional[int] = None):
        """Exact kNN by full scan (the recall oracle) over the indexed and
        the folded rows (not the pending buffer, and removed points too,
        as in the JAX package): ``(dists f32[B, k], ids int32[B, k])``,
        ties to the lower index.  ``precision``:
        "highest" multiplies in fp32; "default" and "fastest" round data
        and queries to bf16 and sum in fp32 (kernel 5 for l2 / sql2 / dot
        and k <= 128; see :func:`_brute_force`), and select exactly.
        ``query_chunk`` scans the batch that many queries at a time; kernel
        5's bf16 copy of the rows is made once a call, for all of them.
        Sparse rows are scanned in fp32 at every precision, and the folded
        rows' scan is merged in (:meth:`_merge_folded`)."""
        _check_precision(precision)
        self._require_x("brute force")
        qb = _as_dense_queries(q, self.dim, self.device)
        k = self._check_k(k)
        step = int(query_chunk) if query_chunk else qb.shape[0]
        ell = isinstance(self.x, EllMatrix)
        x, sq = (self.x, self.sq_norms) if ell else self._with_folded()
        d, ids = _brute_force_many(x, sq, qb, k, metric, precision, step)
        if ell and self.n_folded:
            d, ids = self._merge_folded(qb, d, ids, k, metric, precision)
        return d, ids

    def __repr__(self):
        return (f"RPForest(trees={self.n_trees}, n={self.n_points}, "
                f"dim={self.dim}, device={self.device}, {self.plan!r})")


def _check_data_dtype(dtype) -> torch.dtype:
    """``dtype`` if the port builds on it (f32, bf16, f16), else raises:
    ``ValueError`` for an integer type, whose rows wrap when cast and whose
    squared norms wrap too (the JAX package takes ``jnp.int8`` and returns
    wrong neighbours; ROADMAP.md queue 3)."""
    if dtype in _DATA_DTYPES:
        return dtype
    if isinstance(dtype, torch.dtype) and not dtype.is_floating_point:
        raise ValueError(
            f"forest_batch(dtype={dtype}): integer datasets are refused; the "
            f"rows wrap when cast and their squared norms wrap in the "
            f"integer type (quantize the packed blocks instead: "
            f"pack_leaves(dtype=torch.int8))")
    raise ValueError(f"forest_batch(dtype={dtype}): the dataset type must be "
                     f"torch.float32, torch.bfloat16 or torch.float16")


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Squared norms of the rows of ``x [n, D]``, summed in f32 and stored
    in ``x``'s type (as the JAX package stores them), over bf16 / f16 rows
    ``CAST_ROWS`` at a time, so that no f32 copy of the dataset exists."""
    if x.dtype == torch.float32:
        return (x * x).sum(-1)
    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[0], CAST_ROWS):
        rows = x[s:s + CAST_ROWS].float()
        out[s:s + rows.shape[0]] = (rows * rows).sum(-1)
    return out


def _prepare_data(data, dtype, device):
    """``(x, sq_norms, dim, n)`` on ``device``: dense rows, or an
    :class:`EllMatrix`, with values of ``dtype`` (f32, bf16 or f16) and
    the rows' norms in that type."""
    dtype = _check_data_dtype(dtype)
    if isinstance(data, EllMatrix):
        x = data.to(resolve_device(device), dtype)
        return x, ell_sq_norms(x).to(dtype), x.dim, x.n
    x = torch.as_tensor(data, dtype=dtype, device=resolve_device(device))
    if x.dim() != 2:
        raise ValueError(f"dataset must be [n, dim], got shape {tuple(x.shape)}")
    x = x.contiguous()
    return x, _sq_norms(x), int(x.shape[1]), int(x.shape[0])


@torch.no_grad()
def forest_batch(seed, max_depth: int, min_leaf: int, n_trees: int,
                 pnz: float, data, payloads: Optional[Sequence] = None,
                 dtype=torch.float32, pack=False, *, device=None,
                 r=None) -> RPForest:
    """Batch-build a random projection forest: sample ``n_trees x
    max_depth`` sparse Gaussian projections from ``seed`` (or take ``r
    [n_trees, max_depth, D]`` as given), then run the level-synchronous
    builder tree by tree.  The parameters are the JAX package's, in its
    order; ``device`` and ``r`` are the port's own.

    ``data`` is ``[n, D]`` dense rows or an :class:`EllMatrix` of sparse
    ones.  ``payloads`` is an optional host-side sequence of one payload
    per point (:meth:`RPForest.payload_of`).  ``dtype`` is the type the data
    are cast to and stored in, as in the JAX package: ``torch.float32``,
    ``torch.bfloat16`` or ``torch.float16`` (the squared norms too; the
    projections are made in f32 on the rows raised to f32, so the trees
    are those of an f32 build over the rounded rows, and every query path
    returns f32 distances).  An integer ``dtype`` raises ``ValueError``.
    ``pack=True`` (or a block dtype, ``torch.bfloat16`` or ``torch.int8``)
    packs the leaves at build (:meth:`RPForest.pack_leaves`).  Builds on
    ``device`` (default: the card; it raises where CUDA is absent, and the
    CPU is used only with ``device="cpu"``)."""
    x, sq_norms, dim, n = _prepare_data(data, dtype, device)
    plan = make_plan(n, max_depth, min_leaf)
    if r is None:
        r = rgen.sample_projections(seed, n_trees, max_depth, dim, pnz,
                                    device=x.device)
    else:
        r = torch.as_tensor(r, dtype=torch.float32, device=x.device)
        if tuple(r.shape) != (n_trees, max_depth, dim):
            raise ValueError(f"r must be {(n_trees, max_depth, dim)}, "
                             f"got {tuple(r.shape)}")
    arrays = build_forest_arrays(plan, x, r)
    cfg = ForestConfig(n_trees=n_trees, max_depth=max_depth,
                       min_leaf=min_leaf, proj_nz_density=pnz, dim=dim)
    f = RPForest(plan, arrays, x, sq_norms, cfg, payloads=payloads,
                 seed=seed)
    if pack:
        f.pack_leaves(dtype=None if pack is True else pack)
    return f


def tree_batch(seed, max_depth: int, min_leaf: int, pnz: float, data,
               payloads: Optional[Sequence] = None, dtype=torch.float32, *,
               device=None, r=None) -> RPForest:
    """Batch-build a single tree (reference ``treeBatch``): a forest of
    one tree, :func:`forest_batch`'s parameters less ``n_trees`` (``r``
    is then ``[1, max_depth, D]``)."""
    return forest_batch(seed, max_depth, min_leaf, 1, pnz, data,
                        payloads=payloads, dtype=dtype, device=device, r=r)
