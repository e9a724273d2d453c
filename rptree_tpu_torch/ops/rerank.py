"""Candidate gather, union / dedup, exact rerank and merging
(``rptree_tpu/ops/rerank.py``): ``leaf_positions``, ``gather_leaf_points``,
``dedup_ids``, ``merge_top_k``, ``distances_from_dots``,
``candidate_distances`` and ``rerank_top_k``, for dense and sparse (ELL)
data.

JAX's multi-operand ``lax.sort((keys, payload), num_keys=1)`` becomes a
stable ``torch.sort`` of the keys and a gather of the payload by the
returned order.  The JAX sort is not declared stable, so where two
entries tie on the key the two packages may order them differently; the
parity tests compare such rows as sets.  ``lax.top_k`` keeps the lower
position on ties, which ``torch.topk`` does not promise, so the port
selects with a stable sort there too.

Metrics (the reference's ``distf``): ``l2``, ``sql2``, ``cosine`` (1 -
cosine similarity), ``dot`` (negative inner product), or a callable
``distf(rows f32[..., C, D], q f32[..., 1, D]) -> f32[..., C]`` of torch
operations (smaller is closer).
"""

from __future__ import annotations

import torch

from ..models.plan import TreePlan
from .sparse import EllMatrix

__all__ = ["leaf_positions", "gather_leaf_points", "distances_from_dots",
           "distances_from_norms", "dedup_ids", "merge_top_k", "candidate_distances",
           "rerank_top_k", "METRICS"]

METRICS = ("l2", "sql2", "cosine", "dot")


def leaf_positions(plan: TreePlan, leaf_ids: torch.Tensor):
    """Leaf ids ``int32[..., F]`` (-1 for empty) to positions in
    leaf-sorted (permutation) order: ``(pos int64[..., F * lmax], valid
    bool[same])``, ``lmax = max(plan.max_leaf_len, 1)``; invalid slots
    point at position 0."""
    lmax = max(plan.max_leaf_len, 1)
    dev = leaf_ids.device
    starts = torch.as_tensor(plan.leaf_start, dtype=torch.int64, device=dev)
    lens = torch.as_tensor(plan.leaf_len, dtype=torch.int64, device=dev)
    safe = leaf_ids.long().clamp(0, plan.n_leaves - 1)
    offs = torch.arange(lmax, device=dev)
    pos = starts[safe][..., None] + offs
    valid = (leaf_ids >= 0)[..., None] & (offs < lens[safe][..., None])
    pos = torch.where(valid, pos, 0)
    flat = pos.shape[:-2] + (pos.shape[-2] * pos.shape[-1],)
    return pos.reshape(flat), valid.reshape(flat)


def gather_leaf_points(plan: TreePlan, perm: torch.Tensor,
                       leaf_ids: torch.Tensor) -> torch.Tensor:
    """The point ids stored in the leaf buckets ``leaf_ids int32[..., F]``
    of one tree (``perm int32[n]``): ``int32[..., F * lmax]``, -1 where a
    bucket is empty or shorter than ``lmax``."""
    pos, valid = leaf_positions(plan, leaf_ids)
    return torch.where(valid, perm[pos], -1).to(torch.int32)


def _run_lengths(ids_sorted: torch.Tensor) -> torch.Tensor:
    """Length of each equal-id run, at every position (ids sorted
    ascending along the last axis): a forward ``cummax`` of run-start
    positions gives each run's start, a reversed ``cummin`` of run-end
    positions its end."""
    m = ids_sorted.shape[-1]
    pos = torch.arange(m, device=ids_sorted.device).expand(ids_sorted.shape)
    first = torch.ones_like(ids_sorted[..., :1], dtype=torch.bool)
    start = torch.cat([first, ids_sorted[..., 1:] != ids_sorted[..., :-1]],
                      dim=-1)
    run_start = torch.cummax(torch.where(start, pos, -1), dim=-1).values
    end_mark = torch.cat([start[..., 1:], first], dim=-1)
    run_end = torch.cummin(torch.where(end_mark, pos, m).flip(-1),
                           dim=-1).values.flip(-1)
    return run_end - run_start + 1


def dedup_ids(ids: torch.Tensor, min_votes: int = 1) -> torch.Tensor:
    """Sort candidate ids ascending and mask duplicates and -1 padding to
    -1 (``int32[B, C]`` in and out).  ``min_votes > 1`` also drops ids
    that appear fewer than that many times (the voting filter)."""
    ids_sorted = torch.sort(ids, dim=-1).values
    dup = torch.cat([torch.zeros_like(ids_sorted[..., :1], dtype=torch.bool),
                     ids_sorted[..., 1:] == ids_sorted[..., :-1]], dim=-1)
    out = torch.where(dup | (ids_sorted < 0), -1, ids_sorted)
    if min_votes > 1:
        out = torch.where(_run_lengths(ids_sorted) < min_votes, -1, out)
    return out


def merge_top_k(dists: torch.Tensor, ids: torch.Tensor, k: int,
                dedup: bool = True, min_votes: int = 1):
    """The k best of a scored candidate list ``dists f32[B, M]`` / ``ids
    int32[B, M]``, with duplicate ids masked first (``dedup``) and ids
    seen fewer than ``min_votes`` times dropped.  Returns ``([B, k'],
    [B, k'])`` with ``k' = min(k, M)``; ids are -1 where the distance is
    +inf.  Duplicates carry equal distances on exact layouts, so keeping
    any one copy is exact."""
    if dedup or min_votes > 1:
        ids, order = torch.sort(ids, dim=-1, stable=True)
        dists = dists.gather(-1, order)
        drop = torch.cat([torch.zeros_like(ids[..., :1], dtype=torch.bool),
                          (ids[..., 1:] == ids[..., :-1]) & (ids[..., 1:] >= 0)],
                         dim=-1)
        if min_votes > 1:
            drop = drop | (_run_lengths(ids) < min_votes)
        dists = torch.where(drop, float("inf"), dists)
        ids = torch.where(drop, -1, ids)
    k = min(int(k), ids.shape[-1])
    d, order = torch.sort(dists, dim=-1, stable=True)
    d = d[..., :k]
    out_ids = ids.gather(-1, order[..., :k])
    return d, torch.where(torch.isinf(d), -1, out_ids)


def distances_from_dots(dots: torch.Tensor, sqx: torch.Tensor,
                        q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Distances from inner products ``dots[..., C]`` and candidate
    squared norms ``sqx[..., C]`` (``q [B, D]`` broadcast against the
    trailing query axes of ``dots``)."""
    return distances_from_norms(dots, sqx, (q * q).sum(-1)[..., None],
                                metric)


def distances_from_norms(dots: torch.Tensor, sqx: torch.Tensor,
                         sqq: torch.Tensor, metric: str = "l2"
                         ) -> torch.Tensor:
    """:func:`distances_from_dots` with the queries' squared norms ``sqq``
    given, broadcast against ``dots``."""
    if metric in ("l2", "sql2"):
        d = (sqx - 2.0 * dots + sqq).clamp_min(0.0)
        return d.sqrt() if metric == "l2" else d
    if metric == "cosine":
        return 1.0 - dots / (sqx.sqrt() * sqq.sqrt()).clamp_min(1e-30)
    if metric == "dot":
        return -dots
    raise ValueError(f"unknown metric {metric!r}; one of {sorted(METRICS)}")


def candidate_distances(x: torch.Tensor, sq_norms: torch.Tensor,
                        q: torch.Tensor, ids: torch.Tensor,
                        metric="l2") -> torch.Tensor:
    """Exact distances ``f32[B, C]`` from each query ``q [B, D]`` to its
    candidate rows ``x[ids]`` (``ids int32[B, C]``, -1 for none: +inf),
    with the squared norms ``sq_norms [n]`` precomputed.  Inner products
    are fp32 (rows of a bf16 or f16 dataset raised to f32 as gathered).
    ``x`` is dense ``[n, D]`` or an :class:`.sparse.EllMatrix`, whose
    rows' slots gather the query at their columns (builtin metrics
    only)."""
    valid = ids >= 0
    safe = ids.long().clamp_min(0)
    if isinstance(x, EllMatrix):
        if callable(metric):
            raise NotImplementedError(
                "custom distance callables need dense data rows "
                "(ELL-sparse datasets support the builtin metrics only)")
        cols, vals = x.cols[safe].long(), x.vals[safe]      # [B, C, K]
        b, c, k = cols.shape
        qg = q.gather(1, cols.reshape(b, c * k)).reshape(b, c, k)
        dots = (vals.float() * qg).sum(-1)
        d = distances_from_dots(dots, sq_norms[safe].float(), q, metric)
    elif callable(metric):
        d = metric(x[safe].float(), q[:, None, :])
    else:
        dots = torch.einsum("bcd,bd->bc", x[safe].float(), q)
        d = distances_from_dots(dots, sq_norms[safe].float(), q, metric)
    return torch.where(valid, d, float("inf"))


def rerank_top_k(x, sq_norms, q, ids, k: int, metric="l2",
                 dedup: bool = True):
    """Exact rerank of the candidate union ``ids int32[B, C]`` and its k
    best: ``(dists f32[B, k'], ids int32[B, k'])``, ``k' = min(k, C)``, in
    ascending order, ties to the lower position; unfilled slots are
    ``(+inf, -1)``."""
    if dedup:
        ids = dedup_ids(ids)
    d = candidate_distances(x, sq_norms, q, ids, metric)
    k = min(int(k), ids.shape[-1])
    d, order = torch.sort(d, dim=-1, stable=True)
    d = d[..., :k]
    out = ids.gather(-1, order[..., :k])
    return d, torch.where(torch.isinf(d), -1, out).to(torch.int32)
