"""Exact k-nearest scan with bf16 products (``rptree_tpu/ops/scan.py``):
kernel 5, the scan behind ``brute_force_knn(precision="default" /
"fastest")``, CUDA in ``csrc/scan_topk.cu``.

The data rows and the queries are rounded to bf16 (nearest even), each
product is accumulated in fp32, and each query keeps the k smallest
partial distances ``sq[n] - 2 x[n].q`` (``-2 x[n].q`` for ``dot``), ties to
the lower data index.  The query-norm term, the clamp and the square root
are added afterwards (:func:`_epilogue`), as in the JAX package, so the
selection order is that of the partial distances.

The kernel reads one bf16 copy of the rows (:func:`scan_rows`), made once
per call by ``brute_force_knn`` before its query-chunk loop, as the JAX
package casts its rows once.

The wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a tensor on a CUDA device, or raises there: it never falls
back.  ``scan_topk.launches`` counts its launches (each is the scan kernel
and its merge of the data ranges).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _cuda

__all__ = ["scan_topk", "scan_topk_reference", "scan_rows", "ScanRows",
           "stream_topk", "SCAN_METRICS", "MAX_K"]

SCAN_METRICS = ("l2", "sql2", "dot")
MAX_K = 128
# the bf16 copy's padding: the kernel's row tile and its D chunk (one
# 128-byte swizzle atom of bf16)
_ROW_TILE, _D_CHUNK = 128, 64
# the plain version's [B, chunk] partial-distance block stays ~32M floats
_REF_FLOATS = 32 * 1024 * 1024


def _check_metric(metric):
    if metric not in SCAN_METRICS:
        raise ValueError(
            f"scan_topk supports metrics ('l2', 'sql2', 'dot'); got "
            f"{metric!r} (cosine has no factored partial-distance form "
            "here -- use brute_force_knn)")


def _check_args(x, sq, q, k):
    if x.dim() != 2 or q.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"x [N, D] and q [B, D] expected, got "
                         f"{tuple(x.shape)} and {tuple(q.shape)}")
    if tuple(sq.shape) != (x.shape[0],):
        raise ValueError(f"sq {tuple(sq.shape)} != {(x.shape[0],)}")
    if x.shape[0] < 1:
        raise ValueError("scan over an empty dataset")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")


def _epilogue(part, ids, q, metric):
    """Distances from the partial ones: halved for ``dot``; for the L2
    metrics ``max(part + |q|^2, 0)``, square-rooted for ``l2``."""
    if metric == "dot":
        return part * 0.5, ids
    d = (part + (q * q).sum(-1)[:, None]).clamp_min(0.0)
    return (d.sqrt() if metric == "l2" else d), ids


@torch.no_grad()
def stream_topk(x, q, k: int, dist, width: int = 1):
    """The exact ``k <= N`` smallest of ``dist(rows, start)`` over the rows
    of ``x``: ``(dists f32[B, k], ids int32[B, k])``, ascending.

    ``dist`` gives ``[B, c]`` for the rows ``x[start:start + c]``.  The rows
    stream in chunks whose ``[B, c, width]`` block stays ~32M floats, and
    the kept entries go before each chunk's into a stable sort, so equal
    distances keep the lower index, whatever the chunk."""
    n, b = x.shape[0], q.shape[0]
    c = max(1, min(n, _REF_FLOATS // max(b * width, 1)))
    bd = torch.empty((b, 0), device=q.device)
    bi = torch.empty((b, 0), dtype=torch.int64, device=q.device)
    for s in range(0, n, c):
        xc = x[s:s + c]
        alld = torch.cat([bd, dist(xc, s)], dim=1)
        ids = torch.arange(s, s + xc.shape[0], device=q.device)
        alli = torch.cat([bi, ids.expand(b, -1)], dim=1)
        order = torch.sort(alld, dim=1, stable=True).indices[:, :k]
        bd, bi = alld.gather(1, order), alli.gather(1, order)
    return bd, bi.to(torch.int32)


class ScanRows(NamedTuple):
    """The bf16 copy of the rows that kernel 5 reads (:func:`scan_rows`):
    ``x bf16[N', D']`` rounded to nearest even, zeros past ``(n, d)``;
    ``sq f32[N']``, the norms and ``+inf`` past ``n``."""

    x: torch.Tensor
    sq: torch.Tensor
    n: int
    d: int


@torch.no_grad()
def scan_rows(x, sq) -> ScanRows:
    """One bf16 copy of ``x f32[N, D]`` for every scan of a call, as the
    JAX package casts its rows once: D padded with zeros to a multiple of
    64, N to a multiple of the kernel's 128-row tile, padded rows with
    ``sq = +inf`` (kept +inf under ``dot``, so that they are never
    selected).  It costs ``N' * D' * 2`` bytes on the rows' device."""
    n, d = x.shape
    np_, dp = -(-n // _ROW_TILE) * _ROW_TILE, -(-d // _D_CHUNK) * _D_CHUNK
    xb = torch.zeros((np_, dp), dtype=torch.bfloat16, device=x.device)
    xb[:n, :d] = x
    sqp = torch.full((np_,), float("inf"), dtype=torch.float32,
                     device=x.device)
    sqp[:n] = sq
    return ScanRows(xb, sqp, n, d)


def _dot_norms(sq):
    """``sq`` under ``dot``: 0, but +inf where ``sq`` is +inf (padding),
    as the JAX kernel keeps its mask."""
    return torch.where(torch.isinf(sq), sq, torch.zeros_like(sq))


def _partial_reference(x, sq, q, k, metric):
    """The plain version's ranked partial distances ``sq - 2 x.q`` of the
    bf16-rounded operands and their ids, before :func:`_epilogue`."""
    _check_metric(metric)
    k = min(int(k), x.shape[0])
    _check_args(x, sq, q, k)
    qb = q.to(torch.bfloat16).float()
    s = _dot_norms(sq) if metric == "dot" else sq.float()
    return stream_topk(x, q, k, lambda xc, s0: s[s0:s0 + xc.shape[0]][None, :]
                       - 2.0 * (qb @ xc.to(torch.bfloat16).float().T))


def _partial_reference_rows(rows: ScanRows, q, k, metric):
    """:func:`_partial_reference` on the bf16 copy :func:`scan_rows` made:
    its live rows and columns, its norms."""
    x, sq = rows.x[:rows.n, :rows.d], rows.sq[:rows.n]
    qb = q.to(torch.bfloat16).float()
    s = _dot_norms(sq) if metric == "dot" else sq
    return stream_topk(x, q, k, lambda xc, s0: s[s0:s0 + xc.shape[0]][None, :]
                       - 2.0 * (qb @ xc.float().T))


def scan_topk_reference(x, sq, q, k: int, metric: str = "l2"):
    """Plain torch version of :func:`scan_topk`: bf16-rounded operands, an
    fp32 product per row chunk, and a running exact top-k
    (:func:`stream_topk`)."""
    return _epilogue(*_partial_reference(x, sq, q, k, metric), q, metric)


def scan_topk(x, sq, q, k: int, metric: str = "l2", rows=None):
    """Exact kNN over dense rows with bf16 products: ``(dists f32[B, k'],
    ids int32[B, k'])``, ``k' = min(k, N)``, in ascending order, ties to
    the lower data index.

    ``x f32[N, D]`` rows (or bf16 / f16 ones: the kernel reads its bf16
    copy either way), ``sq f32[N]`` their squared norms, ``q f32[B, D]``.
    Metrics ``l2`` / ``sql2`` (factored form) and ``dot`` (``sq`` taken as
    0, the result halved); ``k`` up to 128.  The kernel reads
    ``rows``, the bf16 copy :func:`scan_rows` makes of ``(x, sq)``; a
    caller that scans one dataset many times makes it once and passes it,
    otherwise it is made here."""
    return _epilogue(*_scan_partial(x, sq, q, k, metric, rows), q, metric)


def _check_rows(rows, x, name):
    if not isinstance(rows, ScanRows) or (rows.n, rows.d) != tuple(x.shape):
        raise ValueError(f"{name}: rows must be scan_rows(x, sq) of this x")
    if rows.x.device != x.device or rows.x.dtype != torch.bfloat16 or \
            not rows.x.is_contiguous() or not rows.sq.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous bf16 on "
                         f"{x.device}")


def _scan_partial(x, sq, q, k, metric, rows=None):
    """:func:`scan_topk` before its epilogue: the ranked partial distances
    ``sq - 2 x.q`` and their ids, from the kernel on a CUDA device and
    from the plain version on the CPU (on ``rows`` where given)."""
    _check_metric(metric)
    name = "scan_topk"
    k = min(int(k), x.shape[0])
    _check_args(x, sq, q, k)
    if rows is not None:
        _check_rows(rows, x, name)
    if x.device.type == "cpu":
        if rows is None:
            return _partial_reference(x, sq, q, k, metric)
        return _partial_reference_rows(rows, q, k, metric)
    for key, t in (("x", x), ("sq", sq), ("q", q)):
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{x.device}")
        if t.dtype != torch.float32 and (key != "x" or t.dtype not in (
                torch.bfloat16, torch.float16)):
            raise TypeError(f"{name}: {key} must be float32 (x also bf16 or "
                            f"f16), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if rows is None:
        rows = scan_rows(x, sq)
    b = q.shape[0]
    od = torch.empty((b, k), dtype=torch.float32, device=x.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=x.device)
    if b == 0:
        return od, oi
    np_, dp = rows.x.shape
    lib = _cuda.lib()
    with _cuda.on(x.device):
        plan = (ctypes.c_int * 3)()
        _cuda.check(lib.rpt_scan_plan(np_, dp, b, k, plan), name)
        bq, splits, tps = plan
        qb = torch.zeros((-(-b // bq) * bq, dp), dtype=torch.bfloat16,
                         device=x.device)
        qb[:b, :rows.d] = q
        pd = torch.empty((splits, b, k), dtype=torch.float32, device=x.device)
        pi = torch.empty((splits, b, k), dtype=torch.int32, device=x.device)
        code = lib.rpt_scan_topk(
            _cuda.ptr(rows.x), _cuda.ptr(rows.sq), _cuda.ptr(qb),
            _cuda.ptr(pd), _cuda.ptr(pi), _cuda.ptr(od), _cuda.ptr(oi), np_,
            dp, b, k, int(metric == "dot"), splits, tps, _cuda.stream_of(x))
    _cuda.check(code, name)
    scan_topk.launches += 1
    return od, oi


scan_topk.launches = 0
