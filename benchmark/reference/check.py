"""The comparison that decides ``correct``: served answers against the
plain reference's (:mod:`.forest`), and the recall of served answers
against the exact scan."""

from __future__ import annotations

import torch

from .forest import distinct, exact_l2

# An answer falls behind the reference where, rank by rank, the exact
# distances of its ids exceed the reference's by more than this share.
# Float32 scoring of the program moves a distance by about 1e-5 of it at
# these widths, so two candidates it orders against their exact order
# lie within that of each other; bf16 rows move it by about 3e-3.
TIE = 1e-3


def compare(x: torch.Tensor, q: torch.Tensor, served_d: torch.Tensor,
            served_ids: torch.Tensor, ref_d: torch.Tensor) -> dict:
    """Numbers over the answers ``(served_d f32[B, k], served_ids [B, k])``
    to the queries ``q f32[B, D]``, against the reference's exact top-k
    distances ``ref_d f64[B, k]``:

    - ``miss_share``: the share of answers whose ids, sorted by exact
      distance, fall behind the reference's by more than :data:`TIE` at
      some rank (a missing id, -1, or a repeated one reads +inf);
    - ``dist_err``: the widest relative gap between a served distance and
      the exact distance of the id it was served with;
    - ``holes``: the answers that name no row (an id -1, or a distance
      that is not finite) at a rank where the reference names one."""
    ids = served_ids.long()
    hole = ((ids < 0) | ~torch.isfinite(served_d)) & torch.isfinite(ref_d)
    e_raw = exact_l2(x, q, ids)
    served_d = served_d.to(torch.float64)
    both_inf = torch.isinf(served_d) & torch.isinf(e_raw)
    err = ((served_d - e_raw).abs() / e_raw.clamp(min=1e-12))
    err = torch.where(both_inf, 0.0, err)
    err = torch.nan_to_num(err, nan=float("inf"))
    e = torch.sort(exact_l2(x, q, distinct(ids)), dim=1).values
    gap = (e - ref_d) / ref_d.clamp(min=1e-12)
    gap = torch.where(torch.isinf(e) & torch.isinf(ref_d), 0.0, gap)
    gap = torch.nan_to_num(gap, nan=float("inf"))
    miss = (gap > TIE).any(1)
    return {"miss_share": float(miss.double().mean()) if miss.numel() else 0.0,
            "dist_err": float(err.max()) if err.numel() else 0.0,
            "holes": int(hole.any(1).sum()),
            "answers": int(miss.numel()), "misses": int(miss.sum())}


def recall(served_ids: torch.Tensor, truth: torch.Tensor) -> float:
    """Mean recall@k of the served ids (each distinct id once) against
    the exact ids."""
    k = truth.shape[1]
    ids = distinct(served_ids.long())
    hit = (ids[:, :, None] == truth[:, None, :]).any(2)
    return float(hit.double().sum() / (hit.shape[0] * k))
