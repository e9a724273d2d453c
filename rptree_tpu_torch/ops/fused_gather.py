"""Fused block gather and dot (``rptree_tpu/ops/fused_gather.py``): kernel
6, the block fetch of the per-pair rerank, CUDA in ``csrc/gather_score.cu``.

For every query ``b`` and probe ``p`` it returns the dots of the leaf block
``x_leaf[rows_sel[b, p]]`` with ``q[b]`` and the block's stored slot norms:
``(dots f32[B, P, lmax], sqx f32[B, P, lmax])``, the two intermediates the
JAX package's per-pair scorer builds (``models/forest.py``
``_score_blocks_body``).  Distances, the occupancy mask and the selection
stay in plain torch, as they stay in XLA there.

f32 blocks are multiplied in full fp32, never TF32; with bf16 blocks the
query is rounded to bf16 (nearest even) first, as the JAX package's
``q.astype(x_leaf.dtype)`` does, so each product of two bf16 values is
exact and the sums are fp32.

The kernel works block-major: a first launch orders the pairs by block on
the card (:func:`_pair_runs`) and one thread block serves every pair of a
run from one read of the block, so each distinct block is read once per
launch (once per ``MAX_PAIRS`` pairs of a longer run).  The ordering
counts in the kernel's time and launch: ``gather_score`` launches both.

On the shared-row layout (:class:`.shared.SharedRows`: one row store and
each block's id table) the kernel's shared-row mode has two routes
(:func:`shared_route`, from the shapes alone).  The query route (one
launch, no runs) serves one query a thread block: it takes the union of
the rows that its P blocks' filled slots name, streams each distinct row
once, whole, through a ring of ``cp.async`` stages, sums its one dot
with the query, and writes it to every slot that names the row; an empty
slot gets a row of zeros' dot.  The block route, for a query whose
slots or row do not fit the query route's shared memory, is the blocked
route's items reading row ``rows[ids[g, j]]`` for slot ``j`` of block
``g``.  Both sum a dot in the blocked
route's order (four FMA chains a 128-byte chunk, added as a tree, the
chunks in order), so their dots are bit-equal to it over the same rows.

The wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a tensor on a CUDA device, or raises there: it never falls
back.  ``gather_score.launches`` counts f32 launches,
``gather_score.launches_bf16`` bf16 ones and
``gather_score.launches_shared`` those of the shared-row mode (f32 and
bf16 rows).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _cuda
from .shared import SharedRows, fetch_blocks

__all__ = ["gather_score", "gather_score_reference", "gather_score_ok",
           "shared_route", "shared_union_reference"]

_FLOAT_BLOCKS = (torch.float32, torch.bfloat16)
# (query, probe) pairs per step of the plain version (bounds its gathered
# block buffer)
_REF_PAIRS = 1 << 14
# pairs the kernel serves from one read of a block (csrc/gather_score.cu),
# at most
MAX_PAIRS = 8
# the shared-row query route (csrc/gather_score.cu gather_query_kernel): a
# query's slots P * lmax and row width D it takes, at most; the bytes of a
# staged row segment (kSegChunks 128-byte chunks) and of one of the ring's
# two stages (kStages)
QUERY_MAX_SLOTS, QUERY_MAX_D = 2048, 2048
_SEG_BYTES, _STAGE_BYTES = 512, 14 << 10


def gather_score_ok(x_leaf, probes: int) -> bool:
    """Whether the kernel serves this packed layout: dense 3-D f32 or bf16
    blocks, or shared f32 or bf16 rows (its shared-row mode), and at least
    one probe; never int8 blocks.  The Pallas kernel's TPU tiling rules
    (``lmax`` a multiple of 8 or 16, ``D`` of 128) do not apply here."""
    if isinstance(x_leaf, SharedRows):
        ok = x_leaf.rows.dim() == 2 and x_leaf.ids.dim() == 2
    else:
        ok = isinstance(x_leaf, torch.Tensor) and x_leaf.dim() == 3
    return ok and x_leaf.dtype in _FLOAT_BLOCKS and int(probes) >= 1


def _check_shapes(x_leaf, sq_leaf, q, rows_sel):
    if x_leaf.dtype not in _FLOAT_BLOCKS:
        raise TypeError(f"gather_score: x_leaf must be float32 or bfloat16, "
                        f"got {x_leaf.dtype}")
    if isinstance(x_leaf, SharedRows):
        rows, ids = x_leaf.rows, x_leaf.ids
        if rows.dim() != 2 or rows.shape[0] < 1 or ids.dim() != 2 \
                or ids.shape[0] < 1 or ids.dtype != torch.int32:
            raise ValueError(f"shared rows must be [N >= 1, D] with int32 "
                             f"ids [G >= 1, lmax], got {tuple(rows.shape)} "
                             f"and {tuple(ids.shape)} {ids.dtype}")
    elif x_leaf.dim() != 3 or x_leaf.shape[0] < 1:
        raise ValueError(f"x_leaf must be [G >= 1, lmax, D], got "
                         f"{tuple(x_leaf.shape)}")
    g, lmax, d = x_leaf.shape
    if tuple(sq_leaf.shape) != (g, lmax):
        raise ValueError(f"sq_leaf {tuple(sq_leaf.shape)} != {(g, lmax)}")
    if q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"q must be [B, {d}], got {tuple(q.shape)}")
    if rows_sel.dim() != 2 or rows_sel.shape[0] != q.shape[0] or \
            rows_sel.shape[1] < 1:
        raise ValueError(f"rows_sel must be [{q.shape[0]}, P >= 1], got "
                         f"{tuple(rows_sel.shape)}")


@torch.no_grad()
def gather_score_reference(x_leaf, sq_leaf, q, rows_sel):
    """Plain torch version of :func:`gather_score`: the fetched blocks
    (:func:`.shared.fetch_blocks` of ``rows_sel``) times the query rounded
    to the block type, as an fp32 product, and the gathered slot norms."""
    _check_shapes(x_leaf, sq_leaf, q, rows_sel)
    b, p = rows_sel.shape
    sel = rows_sel.long().clamp(0, x_leaf.shape[0] - 1)
    qr = q.to(x_leaf.dtype).float()
    dots = torch.empty((b, p, x_leaf.shape[1]), dtype=torch.float32,
                       device=q.device)
    step = max(1, _REF_PAIRS // p)
    for s in range(0, b, step):
        blk = fetch_blocks(x_leaf, sel[s:s + step]).float()  # [c, P, lmax, D]
        dots[s:s + step] = torch.einsum("bpld,bd->bpl", blk, qr[s:s + step])
    return dots, sq_leaf[sel]


class PairRuns(NamedTuple):
    """Kernel 6's work items over the flattened (query, probe) pairs
    (views of one int32 buffer, the layout the card fills): ``counts[g]``
    pairs per block row (clamped into ``[0, g)``), ``n_items[1]``,
    ``offsets[g]`` their exclusive prefix sums, ``cursor[g] = offsets +
    counts``; ``order[n]`` the pairs (``b * P + p``) by block, each
    block's run at ``[offsets, offsets + counts)``; and over the first
    ``n_items`` entries of ``start``, ``count``, ``block`` ``[n]`` the
    items: every ``MAX_PAIRS``-th slot of a run opens one, of the run's
    next ``min(MAX_PAIRS, left)`` pairs."""

    buf: torch.Tensor
    counts: torch.Tensor
    n_items: torch.Tensor
    offsets: torch.Tensor
    cursor: torch.Tensor
    order: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor
    block: torch.Tensor


def _runs_view(buf, g, n):
    parts = buf.split([g, 1, g, g, n, n, n, n])
    return PairRuns(buf, *parts)


def _runs_on_card(rows_sel, g, q=None):
    """The card's :class:`PairRuns` buffer of ``rows_sel`` (its counting
    sort, ``csrc/gather_score.cu`` ``rpt_pair_runs``: the order inside a
    run and of the items is that of its atomics), and, where ``q`` is
    given, ``q`` rounded to bf16 by the same launch (else None)."""
    flat = rows_sel.reshape(-1)
    n = flat.numel()
    buf = torch.empty(3 * g + 4 * n + 1, dtype=torch.int32, device=flat.device)
    qr = None if q is None else torch.empty_like(q)
    with _cuda.on(flat.device):
        code = _cuda.lib().rpt_pair_runs(
            _cuda.ptr(flat), n, g, _cuda.ptr(buf),
            None if q is None else _cuda.ptr(q),
            None if qr is None else _cuda.ptr(qr),
            0 if q is None else q.numel(), _cuda.stream_of(flat))
    _cuda.check(code, "gather_score")
    return buf, qr


def _pair_runs(rows_sel, g):
    """:class:`PairRuns` of ``rows_sel [B, P]``: on a CUDA device by the
    card's counting sort (:func:`_runs_on_card`), on the CPU by the plain
    version (a stable sort; the same runs, items and counts)."""
    flat = rows_sel.reshape(-1)
    n = flat.numel()
    if flat.device.type != "cpu":
        return _runs_view(_runs_on_card(rows_sel, g)[0], g, n)
    blk = flat.long().clamp(0, g - 1)
    counts = torch.bincount(blk, minlength=g)
    offsets = counts.cumsum(0) - counts
    blocks, order = torch.sort(blk, stable=True)
    rel = torch.arange(n) - offsets[blocks]
    first = torch.nonzero(rel % MAX_PAIRS == 0).reshape(-1)
    runs = _runs_view(torch.zeros(3 * g + 4 * n + 1, dtype=torch.int32), g, n)
    for view, val in ((runs.counts, counts), (runs.offsets, offsets),
                      (runs.cursor, offsets + counts), (runs.order, order)):
        view.copy_(val)
    k = first.numel()
    runs.n_items.fill_(k)
    runs.start[:k] = first
    runs.count[:k] = (counts[blocks[first]] - rel[first]).clamp_max(MAX_PAIRS)
    runs.block[:k] = blocks[first]
    return runs


def shared_route(p: int, lmax: int, d: int, itemsize: int):
    """The shared-row mode's route for P probes of blocks of ``lmax``
    slots over rows of ``D`` values of ``itemsize`` bytes: ``("query",
    (rows a stage, log2 hash size))`` where a query's slots and
    its row fit the query route's shared memory, else ``("block",
    None)``.  The query route stages a row in segments of up to 512
    bytes, about 14 KB a stage in a ring of two, and hashes the slots
    into at least one and a half times their count."""
    slots = p * lmax
    if slots > QUERY_MAX_SLOTS or d > QUERY_MAX_D:
        return "block", None
    chunk = 128 // itemsize                    # columns a 128-byte chunk
    seg = min(-(-d // chunk), _SEG_BYTES // 128) * chunk
    rows = min(128, max(8, _STAGE_BYTES // (seg * itemsize)))
    hbits = max(6, (-(-3 * slots // 2) - 1).bit_length())
    return "query", (rows, hbits)


@torch.no_grad()
def shared_union_reference(xs, sq_leaf, q, rows_sel):
    """The query route's rule in plain torch: for each query, the distinct
    rows that its blocks' filled slots name (ids clamped below N), one dot
    each with the query rounded to the row type, written to every slot
    that names the row; an empty slot takes a zero row's dot.  Returns
    ``(dots, sqx, distinct)``, ``distinct[b]`` the rows query b reads.
    (The kernel sums each dot in the blocked route's order; this rule
    leaves the order to ``torch.mv``.)"""
    _check_shapes(xs, sq_leaf, q, rows_sel)
    g, lmax, d = xs.shape
    b, p = rows_sel.shape
    sel = rows_sel.long().clamp(0, g - 1)
    qr = q.to(xs.dtype).float()
    n = xs.rows.shape[0]
    dots = torch.empty((b, p * lmax), dtype=torch.float32, device=q.device)
    distinct = torch.empty(b, dtype=torch.int64)
    zero = torch.zeros(d, dtype=torch.float32, device=q.device)
    for i in range(b):
        ids = xs.ids[sel[i]].reshape(-1).long()
        filled = ids >= 0
        uniq, inv = torch.unique(ids[filled].clamp_max(n - 1),
                                 return_inverse=True)
        distinct[i] = uniq.numel()
        dots[i] = torch.dot(zero, qr[i])
        dots[i, filled] = torch.mv(xs.rows[uniq].float(), qr[i])[inv]
    return dots.reshape(b, p, lmax), sq_leaf[sel], distinct


def gather_score(x_leaf, sq_leaf, q, rows_sel):
    """``dots[b, p, :] = x_leaf[rows_sel[b, p]] @ q[b]`` and ``sqx[b, p, :]
    = sq_leaf[rows_sel[b, p]]``.

    ``x_leaf f32 or bf16 [G, lmax, D]`` packed blocks, or
    :class:`.shared.SharedRows` (``x_leaf[g, j]`` is then ``rows[ids[g,
    j]]``, zeros where the id is -1), ``sq_leaf f32[G, lmax]`` slot norms,
    ``q f32[B, D]``,
    ``rows_sel int32[B, P]`` block rows (clamped into ``[0, G)``).
    Returns two ``f32[B, P, lmax]``."""
    if x_leaf.device.type == "cpu":
        return gather_score_reference(x_leaf, sq_leaf, q, rows_sel)
    return _gather_score(x_leaf, sq_leaf, q, rows_sel)


def _gather_score(x_leaf, sq_leaf, q, rows_sel, route=None):
    """:func:`gather_score` on the card; on shared rows by ``route``
    (``"query"`` or ``"block"``; None: :func:`shared_route`'s), which
    the chip scripts set to time one route where the other runs."""
    name = "gather_score"
    _check_shapes(x_leaf, sq_leaf, q, rows_sel)
    shared = isinstance(x_leaf, SharedRows)
    store = ((("rows", x_leaf.rows, x_leaf.dtype),
              ("ids", x_leaf.ids, torch.int32)) if shared
             else (("x_leaf", x_leaf, x_leaf.dtype),))
    for key, t, dtype in (*store, ("sq_leaf", sq_leaf, torch.float32),
                          ("q", q, torch.float32),
                          ("rows_sel", rows_sel, torch.int32)):
        if t.device != x_leaf.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{x_leaf.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    g, lmax, d = x_leaf.shape
    b, p = rows_sel.shape
    dots = torch.empty((b, p, lmax), dtype=torch.float32, device=q.device)
    sqx = torch.empty((b, p, lmax), dtype=torch.float32, device=q.device)
    if b == 0:
        return dots, sqx
    bf16 = x_leaf.dtype == torch.bfloat16
    lib = _cuda.lib()
    if shared:
        auto, plan = shared_route(p, lmax, d, x_leaf.rows.element_size())
        if (route or auto) == "query":
            if plan is None:
                raise ValueError(f"{name}: {p} x {lmax} slots or D {d} past "
                                 f"the query route's shared memory")
            fn = (lib.rpt_gather_score_shared_query_bf16 if bf16
                  else lib.rpt_gather_score_shared_query_f32)
            with _cuda.on(x_leaf.device):
                code = fn(_cuda.ptr(x_leaf.rows), _cuda.ptr(x_leaf.ids),
                          x_leaf.rows.shape[0], _cuda.ptr(sq_leaf),
                          _cuda.ptr(q), _cuda.ptr(rows_sel), _cuda.ptr(dots),
                          _cuda.ptr(sqx), b, p, g, lmax, d, *plan,
                          _cuda.stream_of(q))
            _cuda.check(code, name)
            gather_score.launches_shared += 1
            return dots, sqx
    with _cuda.on(x_leaf.device):
        # with bf16 blocks the kernel multiplies the query rounded to bf16
        runs, qr = _runs_on_card(rows_sel, g, q=q if bf16 else None)
        tail = (_cuda.ptr(sq_leaf), _cuda.ptr(q if qr is None else qr),
                _cuda.ptr(runs), _cuda.ptr(dots), _cuda.ptr(sqx), b, p, g,
                lmax, d, _cuda.stream_of(q))
        if shared:
            fn = (lib.rpt_gather_score_shared_bf16 if bf16
                  else lib.rpt_gather_score_shared_f32)
            code = fn(_cuda.ptr(x_leaf.rows), _cuda.ptr(x_leaf.ids),
                      x_leaf.rows.shape[0], *tail)
        else:
            fn = lib.rpt_gather_score_bf16 if bf16 else lib.rpt_gather_score_f32
            code = fn(_cuda.ptr(x_leaf), *tail)
    _cuda.check(code, name)
    if shared:
        gather_score.launches_shared += 1
    elif bf16:
        gather_score.launches_bf16 += 1
    else:
        gather_score.launches += 1
    return dots, sqx


gather_score.launches = 0
gather_score.launches_bf16 = 0
gather_score.launches_shared = 0
