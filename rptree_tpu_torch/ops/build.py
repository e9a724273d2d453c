"""Level-synchronous tree construction (``rptree_tpu/ops/build.py``).

One projection GEMM per tree (``proj = X @ R.T`` -> ``[n, L]``), then a
Python loop over levels whose body is one segmented stable sort of the
points by ``(segment key, projection)``, carrying the point permutation,
and static gathers of the median and margin values at the plan's
positions.  Sort stability plus the plan's positional split reproduce the
reference's ``take nh / drop nh`` partition of the stably-sorted
projections, so the permutation is bit-identical to the JAX package's
whenever the projections are.

``lax.sort`` over two keys has no single torch counterpart; two stable
``torch.sort`` passes (by projection, then by segment key) give the same
lexicographic order with the same tie rule (input order).  Both sides
compare ``-0.0`` and ``+0.0`` as equal.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..models.plan import TreePlan

__all__ = ["TreeArrays", "build_tree_arrays", "build_forest_arrays",
           "project_dataset", "ieee_fp32"]


class TreeArrays(NamedTuple):
    """Data-dependent arrays of one tree, or of a forest with a leading
    ``[T]`` axis on every field."""

    r: torch.Tensor     # [depth, D] projections (forest: [T, depth, D])
    thr: torch.Tensor   # f32[L, S_max] median thresholds per (level, segment)
    mgl: torch.Tensor   # f32[L, S_max] low margin
    mgh: torch.Tensor   # f32[L, S_max] high margin
    perm: torch.Tensor  # int32[n] point ids sorted by leaf


@contextlib.contextmanager
def ieee_fp32():
    """Run the float32 matrix products inside in IEEE fp32, never TF32,
    whatever the caller's switch, and restore the switch after.  The JAX
    package pins ``Precision.HIGHEST`` on the build and query projections;
    the leaves depend on their bits.  A caller may have set either of
    PyTorch's two switches (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.set_float32_matmul_precision``, or the per-backend
    ``torch.backends.cuda.matmul.fp32_precision``), and PyTorch refuses
    to read the first kind once the second is set apart from it, so each
    is saved and restored in its own terms."""
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:  # the per-backend switch is set apart
        prev = None
    if prev is None:
        m = torch.backends.cuda.matmul
        old = m.fp32_precision
        m.fp32_precision = "ieee"
        try:
            yield
        finally:
            m.fp32_precision = old
    else:
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)


def project_dataset(x: torch.Tensor, r_l: torch.Tensor) -> torch.Tensor:
    """``x [n, D] @ r_l [L, D].T`` in IEEE fp32.  The JAX package runs this
    product outside any kernel at HIGHEST precision; the port leaves it to
    ``torch.matmul`` under :func:`ieee_fp32`."""
    with ieee_fp32():
        return torch.matmul(x, r_l.T)


def _stacked_plan_constants(plan: TreePlan, device):
    """``[L, ...]`` constants on ``device``: the region-start positions of
    every level, and the threshold / margin gather positions padded with 0
    to the deepest level's segment count (so the padded tail of ``thr``
    holds the level's first sorted projection, as in the JAX package).
    Built once per forest; every tree shares the plan."""
    smax = max(lp.n_segs for lp in plan.levels)

    def pad(name):
        return np.stack([
            np.pad(getattr(lp, name), (0, smax - lp.n_segs))
            for lp in plan.levels
        ])

    starts = [
        np.flatnonzero(np.r_[True, lp.seg_key[1:] != lp.seg_key[:-1]])
        for lp in plan.levels
    ]
    rmax = max(len(s) for s in starts)
    # padding with 0 re-scatters value 0 onto position 0, itself always a
    # region start
    reg_starts = np.stack([np.pad(s, (0, rmax - len(s))) for s in starts])
    return tuple(torch.as_tensor(a.astype(np.int64), device=device)
                 for a in (reg_starts, pad("thr_pos"), pad("mgl_pos"),
                           pad("mgr_pos")))


def _level_order(seg_key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts positions by ``(seg_key, p)``, ties kept
    in input order: ``lax.sort((seg_key, p, ids), num_keys=2,
    is_stable=True)`` as two stable passes, by ``p`` and then by
    ``seg_key``.  Sorts on the float values, never on their bits, so
    ``-0.0`` and ``+0.0`` tie as they do in the JAX package."""
    order = torch.sort(p, stable=True).indices
    return order[torch.sort(seg_key[order], stable=True).indices]


@torch.no_grad()
def build_tree_arrays(plan: TreePlan, x: torch.Tensor, r: torch.Tensor,
                      consts=None) -> TreeArrays:
    """Build one tree's arrays from ``x f32[n, D]`` and ``r f32[depth, D]``
    (both on the same device); ``consts`` is the plan's
    :func:`_stacked_plan_constants`, built here when not given.  The
    permutation starts in dataset order so that stable-sort tie-breaking
    matches the reference's stable merge sort over the same order."""
    n = plan.n
    nl = plan.n_levels
    dev = x.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    if nl == 0:  # single-leaf tree (n <= min_leaf or max_depth == 0)
        z = torch.zeros((0, 1), dtype=torch.float32, device=dev)
        return TreeArrays(r=r, thr=z, mgl=z, mgh=z, perm=ids.to(torch.int32))

    proj = project_dataset(x, r[:nl]).to(torch.float32).T.contiguous()
    reg_starts, thr_pos, mgl_pos, mgr_pos = (
        consts or _stacked_plan_constants(plan, dev))
    thr = torch.empty(thr_pos.shape, dtype=torch.float32, device=dev)
    mgl = torch.empty_like(thr)
    mgh = torch.empty_like(thr)
    for l in range(nl):
        # per-position segment key = largest region start <= position
        starts = reg_starts[l]
        mark = torch.zeros(n, dtype=torch.int64, device=dev)
        mark.scatter_reduce_(0, starts, starts, "amax")
        seg_key = torch.cummax(mark, 0).values
        p = proj[l][ids]
        order = _level_order(seg_key, p)
        ids = ids[order]
        p_sorted = p[order]
        thr[l] = p_sorted[thr_pos[l]]
        mgl[l] = p_sorted[mgl_pos[l]]
        mgh[l] = p_sorted[mgr_pos[l]]
    return TreeArrays(r=r, thr=thr, mgl=mgl, mgh=mgh,
                      perm=ids.to(torch.int32))


@torch.no_grad()
def build_forest_arrays(plan: TreePlan, x: torch.Tensor,
                        r: torch.Tensor) -> TreeArrays:
    """Build a whole forest from ``r [T, depth, D]``: one tree at a time
    (bounding the projection buffer to one tree's ``[n, L]``), stacked on
    a leading ``[T]`` axis."""
    consts = _stacked_plan_constants(plan, x.device) if plan.n_levels else None
    trees = [build_tree_arrays(plan, x, r[t], consts)
             for t in range(r.shape[0])]
    return TreeArrays(*(torch.stack(f) for f in zip(*trees)))
