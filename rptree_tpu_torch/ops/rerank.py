"""Candidate merging and distances from inner products
(``rptree_tpu/ops/rerank.py``): ``dedup_ids``, ``merge_top_k`` and the
L2 metrics of ``distances_from_dots`` that the serving path uses.

JAX's multi-operand ``lax.sort((keys, payload), num_keys=1)`` becomes a
stable ``torch.sort`` of the keys and a gather of the payload by the
returned order.  The JAX sort is not declared stable, so where two
entries tie on the key the two packages may order them differently; the
parity tests compare such rows as sets.
"""

from __future__ import annotations

import torch

__all__ = ["distances_from_dots", "dedup_ids", "merge_top_k", "METRICS"]

METRICS = ("l2", "sql2")


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
    trailing query axes of ``dots``).  The JAX package's ``cosine`` and
    ``dot`` metrics are not ported yet and raise."""
    if metric not in METRICS:
        raise NotImplementedError(f"metric {metric!r}: the port serves "
                                  f"{', '.join(METRICS)}")
    sqq = (q * q).sum(-1)[..., None]
    d = (sqx - 2.0 * dots + sqq).clamp_min(0.0)
    return d.sqrt() if metric == "l2" else d
