"""Per-row top-k with duplicate-id masking (``rptree_tpu/ops/topk_kernel.py``):
kernel 3 of the serving path, the selection tail, CUDA in
``csrc/topk_dedup.cu``.

Serving needs only the k smallest DISTINCT ids of each query's
``W = probes * lmax`` scored slots, and k is small (10).  The kernel
extracts them with k serial passes: the smallest distance still in play,
the lowest position holding it, and its id; with ``dedup`` every slot
carrying that id then leaves play, so a duplicated id keeps its
lowest-distance copy and no id is returned twice.  Rows with fewer than k
live (finite) candidates pad with ``(+inf, -1)``.  These semantics are
pinned by ``tests/test_topk_kernel.py`` for the JAX kernel and by
``tests/test_torch_topk_kernel.py`` for this port.

Two forms, one kernel.  The serving path calls :func:`topk_dedup_pairs` on
the scorer's ``d f32[B, P * lmax]`` with the leaf id table ``id_leaf
int32[NB, lmax]`` and each row's pair rows ``rows_sel int32[B, P]``: the
kernel reads position ``p * lmax + s``'s id in place, ``id_leaf[rows_sel[b,
p], s]``, so no ``[B, W]`` id matrix is formed.  :func:`topk_dedup_kernel`
takes a materialized ``ids int32[B, W]`` (kernel 4's output, the sharded
merges) through the same kernel, each row its own pair row.

Each wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a tensor on a CUDA device, or raises there.  On the card a
row of ``W <= 2048`` is read once (:func:`topk_route` gives the distances
a lane holds); a wider row takes the wide-row kernel, which sweeps it once
per pass.  Each wrapper's ``launches`` counts its launches of either
route.  While a profiler runs, each launch adds its rows to the counter
``topk.rows_one_read`` or ``topk.rows_swept`` by the route its width takes
(``utils/profiling.py`` :func:`topk_rows`), and ``paths`` (an ``int64[2]``
on the card, :func:`..utils.profiling.topk_paths`) gains the rows the
kernel saw take a second prefix of their distance order and the rows
whose prefix overflowed with equal distances (``csrc/topk_dedup.cu``).
"""

from __future__ import annotations

import torch

from .. import _cuda
from ..utils import profiling

__all__ = ["topk_dedup_kernel", "topk_dedup_kernel_reference",
           "topk_dedup_pairs", "topk_dedup_pairs_reference",
           "topk_kernel_ok", "topk_route"]

_MAX_K = 128
_MAX_REGS = 64      # the one-read route's distances per lane: W <= 32 * 64


def topk_route(w: int) -> int:
    """The kernel's route for rows of width ``w``: the distances each lane
    of a warp holds (a multiple of 4 up to 32, then of 8, so that 16-byte
    loads fill them), or 0 for the wide-row route past ``32 * 64``."""
    regs = 4 * -(-w // 128)
    if regs > 32:
        regs = 8 * -(-regs // 8)
    return regs if regs <= _MAX_REGS else 0


def topk_kernel_ok(w: int, k: int, min_votes: int = 1) -> bool:
    """Gate: k within the kernel's winner list, a non-empty candidate
    width, and no vote counting (which needs the full candidate lists)."""
    return min_votes == 1 and 1 <= k <= _MAX_K and w >= 1


def _check_args(d, ids, k):
    if d.dim() != 2 or tuple(ids.shape) != tuple(d.shape):
        raise ValueError(f"d and ids must be [B, W] alike, got "
                         f"{tuple(d.shape)} and {tuple(ids.shape)}")
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k must be in [1, {_MAX_K}], got {k}")
    if d.shape[1] < 1:
        raise ValueError("topk over an empty candidate width")


@torch.no_grad()
def topk_dedup_kernel_reference(d, ids, k: int, dedup: bool = True):
    """Plain torch version of :func:`topk_dedup_kernel`: the same k
    passes over the whole ``[B, W]`` state."""
    _check_args(d, ids, k)
    b, w = d.shape
    dv = d.clone()
    ids = ids.to(torch.int32)
    pos = torch.arange(w, device=d.device)
    od = torch.empty((b, k), dtype=torch.float32, device=d.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=d.device)
    for j in range(k):
        m = dv.amin(dim=1, keepdim=True)
        # first slot at the minimum (ties -> lowest position)
        p = torch.where(dv == m, pos, w).amin(dim=1, keepdim=True)
        live = ~torch.isinf(m)
        wid = torch.where(live, ids.gather(1, p.clamp(max=w - 1)), -1)
        od[:, j] = m[:, 0]
        oi[:, j] = wid[:, 0]
        kill = (ids == wid) if dedup else (pos == p)
        dv = torch.where(kill & live, float("inf"), dv)
    return od, oi


def _launch(name, d, ids, rows, k, dedup, paths):
    """One launch of kernel 3 on ``d f32[B, W]`` with ``ids`` read through
    ``rows`` (or, with ``rows`` None, ``ids int32[B, W]`` itself); returns
    ``(dk, ik)``."""
    _cuda.check_operands(name, d.device, ("d", d, torch.float32),
                         ("ids" if rows is None else "id_leaf", ids,
                          torch.int32),
                         *(() if rows is None else
                           (("rows_sel", rows, torch.int32),)),
                         *(() if paths is None else
                           (("paths", paths, torch.int64),)))
    if paths is not None and paths.numel() != 2:
        raise ValueError(f"{name}: paths must be int64[2], got "
                         f"{tuple(paths.shape)}")
    b, w = d.shape
    od = torch.empty((b, k), dtype=torch.float32, device=d.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=d.device)
    if b == 0:
        return od, oi
    route = topk_route(w)
    nb, lmax = ids.shape
    with _cuda.on(d.device):
        code = _cuda.lib().rpt_topk_pairs(
            _cuda.ptr(d), _cuda.ptr(ids),
            None if rows is None else _cuda.ptr(rows), nb, _cuda.ptr(od),
            _cuda.ptr(oi), b, 1 if rows is None else rows.shape[1], lmax, k,
            int(bool(dedup)), route,
            None if paths is None else _cuda.ptr(paths),
            _cuda.raw_stream(d.device))
    _cuda.check(code, name)
    profiling.topk_rows(b, route > 0)
    return od, oi


def topk_dedup_kernel(d, ids, k: int, dedup: bool = True, paths=None):
    """Per-row k smallest ``(distance, id)`` of ``d f32[B, W]`` /
    ``ids int32[B, W]``; with ``dedup`` the k winners have distinct ids.
    Returns ``(dk f32[B, k], ik int32[B, k])``.  Any ``B`` and ``W``;
    ``paths`` as the module docstring says."""
    _check_args(d, ids, k)
    if d.device.type == "cpu":
        return topk_dedup_kernel_reference(d, ids, k, dedup=dedup)
    out = _launch("topk_dedup_kernel", d, ids, None, k, dedup, paths)
    topk_dedup_kernel.launches += 1
    return out


topk_dedup_kernel.launches = 0


def _check_pairs(d, id_leaf, rows_sel, k):
    if (d.dim() != 2 or id_leaf.dim() != 2 or rows_sel.dim() != 2
            or rows_sel.shape[0] != d.shape[0]
            or d.shape[1] != rows_sel.shape[1] * id_leaf.shape[1]):
        raise ValueError(f"d [B, P * lmax], id_leaf [NB, lmax] and rows_sel "
                         f"[B, P] disagree: {tuple(d.shape)}, "
                         f"{tuple(id_leaf.shape)}, {tuple(rows_sel.shape)}")
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k must be in [1, {_MAX_K}], got {k}")
    if d.shape[1] < 1:
        raise ValueError("topk over an empty candidate width")


@torch.no_grad()
def topk_dedup_pairs_reference(d, id_leaf, rows_sel, k: int,
                               dedup: bool = True):
    """Plain torch version of :func:`topk_dedup_pairs`: the ids gathered
    into ``[B, P * lmax]``, then :func:`topk_dedup_kernel_reference`."""
    _check_pairs(d, id_leaf, rows_sel, k)
    ids = id_leaf[rows_sel.long()].reshape(d.shape[0], -1)
    return topk_dedup_kernel_reference(d, ids, k, dedup=dedup)


def topk_dedup_pairs(d, id_leaf, rows_sel, k: int, dedup: bool = True,
                     paths=None):
    """:func:`topk_dedup_kernel` of ``(d, id_leaf[rows_sel].reshape(B,
    -1))`` with the ids read in place: ``d f32[B, P * lmax]``, ``id_leaf
    int32[NB, lmax]``, ``rows_sel int32[B, P]`` (a negative row counts from
    the end, as a tensor index does).  Returns ``(dk f32[B, k], ik
    int32[B, k])``, bit-equal to the ids form's; ``paths`` as the module
    docstring says."""
    _check_pairs(d, id_leaf, rows_sel, k)
    if d.device.type == "cpu":
        return topk_dedup_pairs_reference(d, id_leaf, rows_sel, k,
                                          dedup=dedup)
    out = _launch("topk_dedup_pairs", d, id_leaf, rows_sel, k, dedup, paths)
    topk_dedup_pairs.launches += 1
    return out


topk_dedup_pairs.launches = 0
