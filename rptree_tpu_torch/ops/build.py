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
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda
from ..utils.profiling import region
from ..models.plan import TreePlan
from .sparse import EllMatrix, ell_project

__all__ = ["TreeArrays", "build_tree_arrays", "build_forest_arrays",
           "project_dataset", "project_rows", "project_rows_error_bound",
           "project_rows_reference", "project_plan", "ieee_fp32"]


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


def project_rows_reference(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`project_rows`: ``r @ x.T`` by
    ``torch.matmul`` in IEEE fp32."""
    with ieee_fp32():
        return torch.matmul(r, x.T)


def project_rows(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Projections ``f32[L, n]`` of the rows ``x f32[n, D]`` (rows may be
    strided, columns contiguous) onto ``r f32[L, D]``, ``out[l, i] = x[i]
    . r[l]``: kernel 11 on the card (``csrc/project.cu``), whose order of
    summation depends on D alone, so that the build, the fold and every
    query chunk give a row the same bits whatever their shapes (cuBLAS
    picks its kernel by shape, and its products differ in the last bits
    between the served build and query shapes).  On the CPU the plain
    version, ``torch.matmul``, whose build and query products agree.
    ``project_rows.launches`` counts launches."""
    dev = x.device
    if dev.type == "cpu":
        return project_rows_reference(x, r)
    name = "project_rows"
    for key, t in (("x", x), ("r", r)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.device != dev:
            raise ValueError(f"{name}: {key} must be a 2-D float32 tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    n, d = x.shape
    nl = r.shape[0]
    if r.shape[1] != d or x.stride(1) != 1 or not r.is_contiguous():
        raise ValueError(f"{name}: x {tuple(x.shape)} (strides {x.stride()}) "
                         f"and r {tuple(r.shape)} must share D, with "
                         f"contiguous rows")
    out = torch.empty((nl, n), dtype=torch.float32, device=dev)
    if n == 0 or nl == 0:
        return out
    segs = -(-d // PROJECT_SEGMENT)  # csrc/project.cu rpt_project_segments
    scratch = (torch.empty((segs, nl, n), dtype=torch.float32, device=dev)
               if segs > 1 else None)
    tile, lt = project_plan(n, nl, d, _sm_count(dev))
    # plain ints for the pointers and the stream: this wrapper runs once a
    # query chunk, and its host time counts where the chunk's kernels are
    # short
    with _cuda.on(dev):
        code = _cuda.lib().rpt_project(
            x.data_ptr(), max(x.stride(0), d), r.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, nl, d, tile,
            lt, _cuda.raw_stream(dev))
    _cuda.check(code, name)
    project_rows.launches += 1
    return out


project_rows.launches = 0

PROJECT_SEGMENT = 1024  # columns a partial sum in kernel 11 (csrc/project.cu kSeg)
# kernel 11's tiles (csrc/project.cu rpt_project): sums a thread (rows,
# projections) and threads along the rows; at most PROJECT_THREADS a block.
# Tiles 3-6 keep 8 threads along the projections, a block spanning 80, 88,
# 104 or 128 of them (T 8 x 10, 11, 13, 16 levels)
PROJECT_TILES = ((8, 8, 16), (4, 4, 16), (4, 8, 32), (8, 10, 16), (8, 11, 16),
                 (8, 13, 16), (8, 16, 16))
PROJECT_THREADS = 256
_FITTED = (3, 4, 5, 6)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def project_plan(n: int, nl: int, d: int, sms: int):
    """Kernel 11's tile for ``n`` rows, ``nl`` projections and ``d``
    columns on a card of ``sms`` multiprocessors: ``(tile, lt)``, an index
    into :data:`PROJECT_TILES` and the threads a block along the
    projections.  A block spans the fewest even shares of the projections
    of at most 128 each: tile 2 (4 x 8 sums a thread) for at most 16
    projections; else, where the blocks (row tiles x projection tiles x
    1,024-column segments) are at least one a multiprocessor, the tile of
    8 rows and the fewest projections a thread that covers a share of 65
    to 128 with 8 threads (tiles 3-6), or tile 0 (8 x 8) for a smaller
    share; else tile 1 (4 x 4, shares of at most 64).  The sums' order
    depends on ``d`` alone, so the plan moves no bit."""
    if nl <= 16:
        return 2, -(-nl // 8)
    segs = -(-d // PROJECT_SEGMENT)
    per = -(-nl // -(-nl // 128))
    if per > 64:
        tile = next(t for t in _FITTED if 8 * PROJECT_TILES[t][1] >= per)
        lt = 8
    else:
        tile, lt = 0, -(-per // 8)
    tm, tn, rt = PROJECT_TILES[tile]
    if -(-n // (tm * rt)) * -(-nl // (tn * lt)) * segs >= sms:
        return tile, lt
    return 1, -(-(-(-nl // -(-nl // 64))) // 4)


def project_rows_error_bound(d: int) -> float:
    """Kernel 11's error bound as a share of ``sum_d |x_d r_d|``: a sum of
    at most ``PROJECT_SEGMENT`` fused multiply-adds a segment, each one
    rounding, then one addition a further segment, ``gamma_k = k u / (1 -
    k u)`` with ``u = 2**-24`` and ``k = min(D, 1024) + ceil(D / 1024)``."""
    k = min(d, PROJECT_SEGMENT) + -(-d // PROJECT_SEGMENT)
    u = 2.0 ** -24
    return k * u / (1.0 - k * u)


CAST_ROWS = 1 << 16  # rows of a bf16 / f16 dataset raised to f32 a step


def project_dataset(x, r_l: torch.Tensor) -> torch.Tensor:
    """``x [n, D] @ r_l [L, D].T`` in IEEE fp32: :func:`project_rows`,
    transposed.  The JAX package runs this product outside any kernel at
    HIGHEST precision.  Rows of another float type (bf16, f16) are raised
    to f32 ``CAST_ROWS`` at a time, so that no f32 copy of the
    whole dataset exists (the JAX package's ``bf16 @ f32`` product
    promotes the same way); on the card kernel 11 gives a row the same
    bits in any batch, so the trees are those of an f32 build over the
    rounded rows.  Sparse rows (an :class:`.sparse.EllMatrix`) project by
    :func:`.sparse.ell_project`."""
    if isinstance(x, EllMatrix):
        return ell_project(x, r_l)
    if x.dtype == torch.float32:
        return project_rows(x, r_l).T
    out = torch.empty((x.shape[0], r_l.shape[0]), dtype=torch.float32,
                      device=x.device)
    for s in range(0, x.shape[0], CAST_ROWS):
        rows = x[s:s + CAST_ROWS].float()
        out[s:s + rows.shape[0]] = project_rows(rows, r_l).T
    return out


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
    """Build one tree's arrays from ``x f32[n, D]`` (or an
    :class:`.sparse.EllMatrix`) and ``r f32[depth, D]`` (both on the same
    device); ``consts`` is the plan's
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

    # profiler regions named after the reference's SCC cost centres
    # ({-# SCC partitionAtMedian #-}, Internal.hs:484)
    with region("rpt_project"):
        proj = project_dataset(x, r[:nl]).to(torch.float32).T.contiguous()
    reg_starts, thr_pos, mgl_pos, mgr_pos = (
        consts or _stacked_plan_constants(plan, dev))
    thr = torch.empty(thr_pos.shape, dtype=torch.float32, device=dev)
    mgl = torch.empty_like(thr)
    mgh = torch.empty_like(thr)
    with region("rpt_partition_at_median"):
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
