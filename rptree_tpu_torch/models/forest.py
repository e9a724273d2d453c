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
:mod:`..ops.traverse`.

Not ported yet (ROADMAP.md): centered / sub-block / shared / ELL layouts
and sparse query batches,
online updates, streaming and the sharded forests.  The ``approx``
selection tail is not to be ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._cuda import resolve_device
from ..config import ForestConfig
from ..ops.build import TreeArrays, build_forest_arrays
from ..ops.fused_gather import gather_score, gather_score_ok
from ..ops.grouped import (grouped_distances, grouped_distances_kernel,
                           grouped_topk_kernel)
from ..ops.grouped_kernel import (INV_127, _int8_dots, _quantize_rows,
                                  grouped_kernel_ok)
from ..ops.rerank import (dedup_ids, distances_from_dots, gather_leaf_points,
                          merge_top_k, rerank_top_k)
from ..ops.scan import MAX_K as SCAN_MAX_K
from ..ops.scan import SCAN_METRICS, scan_rows, scan_topk, stream_topk
from ..ops.topk_kernel import topk_dedup_kernel, topk_kernel_ok
from ..ops.traverse import (node_table, project_queries, select_probes,
                             traverse_kernel)
from ..utils import gen as rgen
from .plan import TreePlan, make_plan

__all__ = ["RPForest", "forest_batch", "DEFAULT_BUDGET"]

DEFAULT_BUDGET = 32
_LAYOUTS_TODO = "ROADMAP.md queue 1 item 13 (other dense layouts)"
_PAYLOADS_TODO = "ROADMAP.md queue 1 item 12 (online updates and payloads)"
_DATA_DTYPES_TODO = "ROADMAP.md queue 1 item 22 (datasets of other types)"
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


def _pad_to_chunk(qb: torch.Tensor, chunk: int):
    """Pad a ``[B, D]`` batch with zero rows up to a multiple of ``chunk``
    rows; returns ``(padded batch, original B, effective chunk)``."""
    b = qb.shape[0]
    ch = max(1, min(int(chunk), b))
    pad = (-b) % ch
    if pad:
        qb = torch.cat([qb, qb.new_zeros((pad, qb.shape[1]))])
    return qb, b, ch


def _as_dense_queries(q, dim: int, device) -> torch.Tensor:
    """Queries as ``f32[B, D]`` on ``device``; a single vector becomes a
    batch of one.  Sparse (ELL) query batches are not ported."""
    if hasattr(q, "cols") and hasattr(q, "vals"):
        raise NotImplementedError("sparse (ELL) query batches: ROADMAP.md "
                                  "queue 1 item 14")
    q = torch.as_tensor(q, dtype=torch.float32, device=device)
    if q.dim() == 1:
        q = q[None, :]
    if q.dim() != 2 or q.shape[0] == 0:
        raise ValueError(f"queries must be [B>=1, dim], got shape {tuple(q.shape)}")
    if q.shape[-1] != dim:
        raise ValueError(f"query dim {q.shape[-1]} != index dim {dim}")
    return q.contiguous()


def _traverse_forest(plan: TreePlan, arrays: TreeArrays, q: torch.Tensor,
                     budget: int, table=None):
    """All-tree traversal (kernel 7 on the card): ``(leaf_ids int32[T, B,
    F], prio f32[T, B, F])``.  ``table``: the forest's node table, built
    here when not given."""
    if table is None:
        table = node_table(plan, arrays.thr, arrays.mgl, arrays.mgh)
    projq = project_queries(q, arrays.r, plan.n_levels)
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
    (each global block's occupancy) or else the plan's leaf sizes."""
    leaf_ids, prio = _traverse_forest(plan, arrays, q, budget, table)
    if block_len is None:
        block_len = torch.as_tensor(
            np.tile(np.asarray(plan.leaf_len, np.int32), leaf_ids.shape[0]),
            device=leaf_ids.device)
    return select_probes(leaf_ids, prio, plan.n_leaves, probes, block_len,
                         k=k, bucket_stop=bucket_stop)


def _selection_tail(d, id_leaf, rows_sel, k, kk, dedup, min_votes=1,
                    selection="sort"):
    """Candidate-selection tail over ``d f32[B, P * lmax]`` (+inf in masked
    slots): the ids are fetched as whole leaf blocks with the rows' ``[B,
    P]`` pattern, then :func:`_selection_tail_ids` selects."""
    b = d.shape[0]
    ids_flat = id_leaf[rows_sel.long()].reshape(b, -1)
    return _selection_tail_ids(d, ids_flat, k, kk, dedup, min_votes,
                               selection)


def _selection_tail_ids(d, ids_flat, k, kk, dedup, min_votes=1,
                        selection="sort"):
    """The k best of ``(d, ids_flat) [B, W]``; returns ``(dists f32[B, k],
    ids int32[B, k])``.

    ``selection="kernel"`` with ``min_votes == 1`` is the top-k kernel
    (kernel 3).  Otherwise the sort tail: a stable sort of the row by
    distance, its first ``kk`` entries (ids -1 at +inf), then
    :func:`merge_top_k`.  Vote counting is exact only over the full
    candidate list, so ``min_votes > 1`` takes ``kk = W``."""
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


def _grouped_use_kernel(impl, x_leaf, metric) -> bool:
    """Whether the grouped path scores with the tile kernels (the JAX
    package's gate, less its TPU-backend clause): dense f32 / bf16 / int8
    blocks and ``l2`` / ``sql2``.  ``impl="xla"`` never does; "auto" does
    where the kernels serve; "kernel", "kernel_full" and "kernel_topk"
    raise where they do not."""
    if impl == "xla":
        return False
    ok = not callable(metric) and grouped_kernel_ok(x_leaf, metric)
    if impl in ("kernel", "kernel_full", "kernel_topk") and not ok:
        raise ValueError(
            f"impl={impl!r} needs dense f32/bf16/int8 blocks and metric l2 / "
            f"sql2, got {metric!r}; use impl='auto' or 'xla'")
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
    x_leaf, sq_leaf, id_leaf = f._packed
    lens = f._lens_global()
    gsel, lsel = _select_probes(f.plan, f.arrays, q, budget, probes, k=k,
                                bucket_stop=bucket_stop, block_len=lens,
                                table=f._table())
    b, p = gsel.shape
    kk = k * f.n_trees if dedup else k
    kp = -(-max(k, 8) // 8) * 8
    if not _grouped_use_kernel(impl, x_leaf, metric):
        d, needed = grouped_distances(
            x_leaf, sq_leaf, lens, gsel, lsel, q, metric, tile_m, nt,
            tile_chunk, block_scale=f._block_scale)
    elif (impl == "kernel_topk" and min_votes == 1 and selection == "sort"
            and 2 * kp <= x_leaf.shape[1] and x_leaf.dtype != torch.int8):
        d_t, i_t, needed = grouped_topk_kernel(
            x_leaf, sq_leaf, id_leaf, lens, gsel, lsel, q, metric, tile_m,
            nt, kp)
        d_out, i_out = _selection_tail_ids(
            d_t.reshape(b, p * kp), i_t.reshape(b, p * kp), k,
            min(kk, p * kp), dedup)
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
    ``chunk`` rows); ``kw`` are :func:`_knn_grouped`'s arguments, its
    ``nt`` the per-chunk capacity.  The returned ``needed`` is the
    maximum over chunks."""
    ds, ids, needs = [], [], []
    for s in range(0, q.shape[0], chunk):
        d, i, n = _knn_grouped(f, q[s:s + chunk], **kw)
        ds.append(d)
        ids.append(i)
        needs.append(n)
    return torch.cat(ds), torch.cat(ids), torch.stack(needs).amax()


@torch.no_grad()
def _candidate_ids(plan, arrays, q, budget, table=None):
    """Per-tree candidate point ids: ``int32[T, B, F * lmax]``, -1 padded."""
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


def _int8_block_dots(x_leaf, block_scale, sel, q):
    """Dots of int8 blocks ``x_leaf[sel]`` with ``q f32[B, D]`` as the JAX
    package's per-pair scorer forms them: the query quantized per row,
    exact integer dots, then ``dots * block scale * row scale`` in that
    order.  ``f32[B, P, lmax]``."""
    b, p = sel.shape
    _, lmax, d = x_leaf.shape
    q_i8, qscale = _quantize_rows(q)                       # [B, D], [B, 1]
    dots = _int8_dots(q_i8[:, None, :], x_leaf[sel].reshape(b, p * lmax, d))
    return (dots.reshape(b, p, lmax) * block_scale[sel][..., None]
            * qscale[:, :, None])


@torch.no_grad()
def _score_blocks(f, rows_sel, lsel, q, k, kk, metric, dedup, min_votes=1,
                  selection="sort"):
    """Fetch and exactly score each query's selected blocks ``rows_sel
    int32[B, P]`` (``lsel``: leaf ids, -1 to skip), then select: ``(dists
    f32[B, k], ids int32[B, k])``.  f32 and bf16 blocks are fetched and
    multiplied by kernel 6 (:func:`gather_score`); int8 blocks by plain
    torch, as the JAX package leaves them to an XLA einsum; a callable
    ``metric`` gets the gathered rows as f32 (not on int8 blocks)."""
    x_leaf, sq_leaf, id_leaf = f._packed
    b, p = rows_sel.shape
    lmax = x_leaf.shape[1]
    sel = rows_sel.long()
    if callable(metric):
        if x_leaf.dtype == torch.int8:
            raise NotImplementedError(
                "custom distance callables are unsupported on int8-"
                "quantized blocks (pack with f32/bf16)")
        d = metric(x_leaf[sel].float(), q[:, None, None, :])
    else:
        if gather_score_ok(x_leaf, p):
            dots, sqx = gather_score(x_leaf, sq_leaf, q,
                                     rows_sel.contiguous())
        else:  # int8 blocks
            dots = _int8_block_dots(x_leaf, f._block_scale, sel, q)
            sqx = sq_leaf[sel]
        d = distances_from_dots(dots, sqx, q[:, None], metric)
    lens = f._lens_global()[sel]
    valid = (lsel >= 0)[..., None] & (
        torch.arange(lmax, device=q.device) < lens[..., None])
    d = torch.where(valid, d, float("inf")).reshape(b, p * lmax)
    return _selection_tail(d, id_leaf, rows_sel, k, kk, dedup, min_votes,
                           selection)


def _knn_packed(f, q, k, budget, probes, metric, dedup, min_votes=1,
                selection="sort"):
    """One chunk of the per-pair path: each query's ``probes``
    lowest-priority leaf blocks, fetched and scored one (query, probe)
    pair at a time (:func:`_score_blocks`)."""
    gsel, lsel = _select_probes(f.plan, f.arrays, q, budget, probes, k=k,
                                block_len=f._lens_global(),
                                table=f._table())
    kk = k * f.n_trees if dedup else k
    return _score_blocks(f, gsel, lsel, q, k, kk, metric, dedup, min_votes,
                         selection)


def _knn_packed_many(f, q, chunk, **kw):
    """The per-pair path over ``chunk``-query slices of ``q`` (a multiple
    of ``chunk`` rows); ``kw`` are :func:`_knn_packed`'s arguments."""
    outs = [_knn_packed(f, q[s:s + chunk], **kw)
            for s in range(0, q.shape[0], chunk)]
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
    sq_norms)`` (:func:`scan_rows`), where the caller made one."""
    k = min(int(k), x.shape[0])
    fast = precision in ("default", "fastest") and not callable(metric)
    if _uses_scan(fast, metric, k):
        return scan_topk(x, sq_norms, q, k, metric, rows=rows)
    if callable(metric):  # the callable sees [B, c, D] rows
        return stream_topk(x, q, k, lambda xc, s: metric(xc[None], q[:, None]),
                           width=x.shape[1])
    qf = q.to(torch.bfloat16).float() if fast else q

    def dist(xc, s):
        if fast:
            xc = xc.to(torch.bfloat16).float()
        return distances_from_dots(qf @ xc.T, sq_norms[s:s + xc.shape[0]][None],
                                   q, metric)

    return stream_topk(x, q, k, dist)


def _uses_scan(fast, metric, k):
    """Whether a scan at these settings runs kernel 5: bf16 products, l2 /
    sql2 / dot, ``k <= 128`` (the JAX package's gate for its fused scan)."""
    return fast and not callable(metric) and metric in SCAN_METRICS \
        and k <= SCAN_MAX_K


def _recall(exact_ids, cand, k):
    """Mean over trees of ``|candidates . exact top-k| / k``: ``f32[B]``
    (``exact_ids int32[B, k']``, ``cand int32[T, B, C]``, -1 padded)."""
    per_tree = [((exact_ids[:, :, None] == c[:, None, :])
                 & (c[:, None, :] >= 0)).any(-1).sum(-1).float() / k
                for c in cand]
    return torch.stack(per_tree).mean(0)


class RPForest:
    """A built RP forest index over a fixed dataset.

    Attributes:
      plan: static tree shape (shared by all trees).
      arrays: :class:`TreeArrays` with a leading ``[T]`` axis.
      x: the dataset ``f32[n, D]`` on the forest's device.
      sq_norms: ``f32[n]`` squared norms.
      config: the :class:`ForestConfig` it was built with.
    """

    def __init__(self, plan: TreePlan, arrays: TreeArrays, x: torch.Tensor,
                 sq_norms: torch.Tensor, config: ForestConfig):
        self.plan = plan
        self.arrays = arrays
        self.x = x
        self.sq_norms = sq_norms
        self.config = config
        self._packed = None        # (x_leaf, sq_leaf, id_leaf) or None
        self._block_scale = None   # f32[G] for int8 blocks
        self._pack_cfg = None      # (dtype_str, slack) of the packed layout
        self._lens_dev = None      # int32[G] block occupancy
        self._nodes = None         # node table (kernel 7's records)
        self._grouped_nt = {}      # learned tile capacities by shape key
        self._grouped_last = None  # (needed, capacity) of the last call

    @property
    def n_trees(self) -> int:
        return int(self.arrays.perm.shape[0])

    @property
    def n_points(self) -> int:
        return self.plan.n

    @property
    def dim(self) -> int:
        return int(self.x.shape[1])

    @property
    def device(self) -> torch.device:
        return self.x.device

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

    def _table(self):
        """The forest's node table, built on first use.  Nothing in the
        port changes ``arrays`` after the build; online updates
        (ROADMAP.md queue 1 item 12) must rebuild it."""
        if self._nodes is None:
            a = self.arrays
            self._nodes = node_table(self.plan, a.thr, a.mgl, a.mgh)
        return self._nodes

    def _lens_global(self) -> torch.Tensor:
        """Per-block occupancy ``int32[G]`` in global block order: the
        plan's leaf lengths tiled over trees."""
        if self._lens_dev is None:
            self._lens_dev = torch.as_tensor(
                np.tile(np.asarray(self.plan.leaf_len, np.int32),
                        self.n_trees), device=self.device)
        return self._lens_dev

    # -- leaf packing ----------------------------------------------------

    @torch.no_grad()
    def pack_leaves(self, dtype=None, slack: int = 0, centered: bool = False,
                    sub_block: int = 1, sub_split: str = "kmeans",
                    store: str = "blocks") -> "RPForest":
        """Copy each leaf's points into one contiguous block: ``x_leaf
        [T * n_leaves, lmax, D]``, with the slot squared norms ``sq_leaf``
        (exact, from the f32 rows), the point ids ``id_leaf`` (-1 in empty
        slots) and, for ``dtype=torch.int8``, one scale per block
        (``max |row| / 127``; rows divided by it and rounded half to even).
        ``dtype=torch.bfloat16`` rounds the rows to nearest even and
        halves the blocks' memory and read bytes; distances are then
        computed from the bf16 rows.  ``slack`` adds empty slots per
        block; the slot axis is aligned as in the JAX package.  Packing
        the same layout again is a no-op.  The parameters are the JAX
        package's, in its order.  ``centered``, ``sub_block > 1`` (with
        its ``sub_split`` ordering, which one block a leaf ignores) and
        ``store="shared"`` are not ported yet and raise."""
        if sub_split not in ("kmeans", "proj"):
            raise ValueError(f"sub_split must be 'kmeans' or 'proj', got "
                             f"{sub_split!r}")
        if store != "blocks" or centered or int(sub_block or 1) > 1:
            raise NotImplementedError(
                f"store={store!r} centered={centered} sub_block={sub_block}: "
                f"{_LAYOUTS_TODO}")
        dtype_str = _dtype_str(dtype)
        if slack < 0:
            raise ValueError(f"slack must be >= 0, got {slack}")
        if self._pack_cfg == (dtype_str, int(slack)):
            return self
        plan = self.plan
        lmax = _tile_align(max(plan.max_leaf_len, 1) + int(slack), dtype_str)
        starts = np.asarray(plan.leaf_start)
        lens = np.asarray(plan.leaf_len)
        offs = np.arange(lmax)
        in_leaf_np = offs < lens[:, None]
        pos = torch.as_tensor(
            np.where(in_leaf_np, starts[:, None] + offs, 0), device=self.device)
        in_leaf = torch.as_tensor(in_leaf_np, device=self.device)
        nl, d, t = plan.n_leaves, self.dim, self.n_trees
        dt = _BLOCK_DTYPES[dtype_str]
        x_leaf = torch.empty((t, nl, lmax, d), dtype=dt, device=self.device)
        sq_leaf = torch.empty((t, nl, lmax), device=self.device)
        id_leaf = torch.empty((t, nl, lmax), dtype=torch.int32,
                              device=self.device)
        scale = (torch.empty((t, nl), device=self.device)
                 if dtype_str == "int8" else None)
        for ti in range(t):  # one tree at a time bounds the f32 temporaries
            ids = self.arrays.perm[ti].long()[pos]          # [nl, lmax]
            rows = torch.where(in_leaf[..., None], self.x[ids], 0.0)
            id_leaf[ti] = torch.where(in_leaf, ids, -1).to(torch.int32)
            sq_leaf[ti] = (rows * rows).sum(-1)
            if scale is None:
                x_leaf[ti] = rows  # bf16: the copy rounds to nearest even
                continue
            amax = rows.abs().amax(dim=(-2, -1), keepdim=True)
            sc = amax.clamp_min(1e-30) * INV_127
            x_leaf[ti] = torch.round(rows / sc).clamp(-127, 127).to(torch.int8)
            scale[ti] = sc.reshape(nl)
        g = t * nl
        self._packed = (x_leaf.reshape(g, lmax, d), sq_leaf.reshape(g, lmax),
                        id_leaf.reshape(g, lmax))
        self._block_scale = None if scale is None else scale.reshape(g)
        self._pack_cfg = (dtype_str, int(slack))
        self._grouped_nt = {}
        return self

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

        ``precision`` takes the JAX package's values and changes nothing
        here: f32 rows are always multiplied in full fp32, bf16 blocks by
        exact products of bf16 values summed in fp32."""
        k = self._check_k(k)
        _check_precision(precision)
        min_votes = int(min_votes)
        qb = _as_dense_queries(q, self.dim, self.device)
        budget = self._budget(budget)
        if self._packed is None:
            return _knn(self, qb, k, budget, metric, dedup, min_votes)
        _check_selection(selection, k, min_votes)
        probes = int(self.n_trees * budget if probes is None else probes)
        return _knn_packed(self, qb, k, budget, probes, metric, dedup,
                           min_votes, selection)

    @torch.no_grad()
    def knn_batched(self, q, k: int, metric="l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest",
                    probes: Optional[int] = None, min_votes: int = 1,
                    chunk: int = 4096, selection: str = "sort"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The per-pair path of :meth:`knn` over a large batch, ``chunk``
        queries at a time, so its rerank buffers stay per chunk.  Requires
        :meth:`pack_leaves`; results equal chunked :meth:`knn` calls."""
        if self._packed is None:
            raise ValueError("pack_leaves() first: knn_batched runs the "
                             "leaf-blocked pipeline")
        k = self._check_k(k)
        _check_precision(precision)
        min_votes = int(min_votes)
        _check_selection(selection, k, min_votes)
        budget = self._budget(budget)
        probes = int(self.n_trees * budget if probes is None else probes)
        qb, b, chunk = _pad_to_chunk(
            _as_dense_queries(q, self.dim, self.device), chunk)
        d, ids = _knn_packed_many(self, qb, chunk, k=k, budget=budget,
                                  probes=probes, metric=metric, dedup=dedup,
                                  min_votes=min_votes, selection=selection)
        return d[:b], ids[:b]

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
        scan) among its candidates.  Returns ``f32[B]``."""
        qb = _as_dense_queries(q, self.dim, self.device)
        k = self._check_k(k)
        _, exact = _brute_force(self.x, self.sq_norms, qb, k, metric)
        cand = _candidate_ids(self.plan, self.arrays, qb,
                              self._budget(budget), self._table())
        return _recall(exact, cand, k)

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

        ``precision`` takes the JAX package's values and changes nothing
        here, as on the JAX package's kernel paths: f32 blocks are always
        scored in full fp32 (the XLA form too: the JAX package floors it
        at ``HIGH``), bf16 blocks by exact products of bf16 values summed
        in fp32.

        The tile capacity auto-sizes (see :func:`_grouped_auto_capacity`);
        ``check=False`` is the steady-state mode that skips reading the
        needed tile count back once a capacity for this shape is known
        (overflow then masks candidates, see :meth:`grouped_overflow`).
        ``chunk`` serves the batch ``chunk`` queries at a time (default:
        all at once), with ``nt`` and the cached capacity per chunk.
        """
        if self._packed is None:
            raise ValueError("pack_leaves() first: knn_grouped runs on the "
                             "leaf-blocked layout")
        _check_precision(precision)
        k = self._check_k(k)
        min_votes = int(min_votes)
        _check_selection(selection, k, min_votes)
        if impl not in _IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        if callable(metric) and self._packed[0].dtype == torch.int8:
            raise NotImplementedError(
                "custom distance callables are unsupported on int8-"
                "quantized blocks (pack with f32/bf16)")
        _grouped_use_kernel(impl, self._packed[0], metric)  # raises early
        budget = self._budget(budget)
        probes = int(self.n_trees * budget if probes is None else probes)
        qb = _as_dense_queries(q, self.dim, self.device)
        qb, b, chunk = _pad_to_chunk(qb, qb.shape[0] if chunk is None
                                     else chunk)

        def run(cap):
            d, ids, needed = _knn_grouped_many(
                self, qb, chunk, k=k, budget=budget, probes=probes,
                metric=metric, dedup=dedup, tile_m=int(tile_m), nt=cap,
                tile_chunk=int(tile_chunk), bucket_stop=bucket_stop,
                min_votes=min_votes, selection=selection, impl=impl)
            return (d, ids), needed

        key = (qb.shape[0], probes, int(tile_m), chunk)
        d, ids = _grouped_auto_capacity(self, key, chunk * probes, tile_m, nt,
                                        run, check=check)
        return d[:b], ids[:b]

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
        """Exact kNN by full scan (the recall oracle): ``(dists f32[B, k],
        ids int32[B, k])``, ties to the lower index.  ``precision``:
        "highest" multiplies in fp32; "default" and "fastest" round data
        and queries to bf16 and sum in fp32 (kernel 5 for l2 / sql2 / dot
        and k <= 128; see :func:`_brute_force`), and select exactly.
        ``query_chunk`` scans the batch that many queries at a time; kernel
        5's bf16 copy of the rows is made once for all of them."""
        _check_precision(precision)
        qb = _as_dense_queries(q, self.dim, self.device)
        k = self._check_k(k)
        step = int(query_chunk) if query_chunk else qb.shape[0]
        fast = precision in ("default", "fastest")
        rows = (scan_rows(self.x, self.sq_norms)
                if _uses_scan(fast, metric, min(k, self.n_points)) else None)
        outs = [_brute_force(self.x, self.sq_norms, qb[s:s + step], k, metric,
                             precision, rows)
                for s in range(0, qb.shape[0], step)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def __repr__(self):
        return (f"RPForest(trees={self.n_trees}, n={self.n_points}, "
                f"dim={self.dim}, device={self.device}, {self.plan!r})")


def _prepare_data(data, dtype, device):
    if dtype != torch.float32:
        raise NotImplementedError(
            f"forest_batch(dtype={dtype}): the port builds on f32 data only; "
            f"{_DATA_DTYPES_TODO}")
    x = torch.as_tensor(data, dtype=dtype, device=resolve_device(device))
    if x.dim() != 2:
        raise ValueError(f"dataset must be [n, dim], got shape {tuple(x.shape)}")
    x = x.contiguous()
    return x, (x * x).sum(-1), int(x.shape[1]), int(x.shape[0])


@torch.no_grad()
def forest_batch(seed, max_depth: int, min_leaf: int, n_trees: int,
                 pnz: float, data, payloads=None, dtype=torch.float32,
                 pack=False, *, device=None, r=None) -> RPForest:
    """Batch-build a random projection forest: sample ``n_trees x
    max_depth`` sparse Gaussian projections from ``seed`` (or take ``r
    [n_trees, max_depth, D]`` as given), then run the level-synchronous
    builder tree by tree.  The parameters are the JAX package's, in its
    order; ``device`` and ``r`` are the port's own.

    ``dtype`` is the type the data are cast to, as in the JAX package;
    only ``torch.float32`` is ported.  ``pack=True`` (or a block dtype,
    ``torch.bfloat16`` or ``torch.int8``) packs the leaves at build
    (:meth:`RPForest.pack_leaves`).  ``payloads`` are not ported yet and
    raise.  Builds on ``device`` (default: the card; it raises where CUDA
    is absent, and the CPU is used only with ``device="cpu"``)."""
    if payloads is not None:
        raise NotImplementedError(f"forest_batch(payloads=...): "
                                  f"{_PAYLOADS_TODO}")
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
    f = RPForest(plan, arrays, x, sq_norms, cfg)
    if pack:
        f.pack_leaves(dtype=None if pack is True else pack)
    return f
