"""Exact k-nearest scan with bf16 products (``rptree_tpu/ops/scan.py``):
kernel 5, the scan behind ``brute_force_knn(precision="default" /
"fastest")``, CUDA in ``csrc/scan_topk.cu``.

The data rows and the queries are rounded to bf16 (nearest even), each
product is accumulated in fp32, and each query keeps the k smallest
partial distances ``sq[n] - 2 x[n].q`` (``-2 x[n].q`` for ``dot``), ties to
the lower data index.  The query-norm term, the clamp and the square root
are added afterwards (:func:`_epilogue`), as in the JAX package, so the
selection order is that of the partial distances.

The wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a tensor on a CUDA device, or raises there: it never falls
back.  ``scan_topk.launches`` counts its launches (each is the scan kernel
and its merge of the data ranges).
"""

from __future__ import annotations

import torch

from .. import _cuda

__all__ = ["scan_topk", "scan_topk_reference", "stream_topk", "SCAN_METRICS",
           "MAX_K"]

SCAN_METRICS = ("l2", "sql2", "dot")
MAX_K = 128
_BQ, _BN = 128, 64  # the kernel's queries per block and rows per tile
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


def _partial_reference(x, sq, q, k, metric):
    """The plain version's ranked partial distances ``sq - 2 x.q`` of the
    bf16-rounded operands and their ids, before :func:`_epilogue`."""
    _check_metric(metric)
    k = min(int(k), x.shape[0])
    _check_args(x, sq, q, k)
    qb = q.to(torch.bfloat16).float()
    s = torch.zeros_like(sq) if metric == "dot" else sq.float()
    return stream_topk(x, q, k, lambda xc, s0: s[s0:s0 + xc.shape[0]][None, :]
                       - 2.0 * (qb @ xc.to(torch.bfloat16).float().T))


def scan_topk_reference(x, sq, q, k: int, metric: str = "l2"):
    """Plain torch version of :func:`scan_topk`: bf16-rounded operands, an
    fp32 product per row chunk, and a running exact top-k
    (:func:`stream_topk`)."""
    return _epilogue(*_partial_reference(x, sq, q, k, metric), q, metric)


def _splits(n, b, device):
    """Data ranges per query tile: enough blocks to fill every SM four
    times over (two resident per SM), each range at least 4 tiles long.
    Returns ``(splits, rows per split)``, the latter a multiple of 64."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    qtiles = -(-b // _BQ)
    splits = max(1, min(-(-4 * sms // qtiles), -(-n // (4 * _BN))))
    rows = -(-n // splits)
    rows = -(-rows // _BN) * _BN
    return -(-n // rows), rows


def scan_topk(x, sq, q, k: int, metric: str = "l2"):
    """Exact kNN over dense rows with bf16 products: ``(dists f32[B, k'],
    ids int32[B, k'])``, ``k' = min(k, N)``, in ascending order, ties to
    the lower data index.

    ``x f32[N, D]`` rows (rounded to bf16 as they are read), ``sq f32[N]``
    their squared norms, ``q f32[B, D]``.  Metrics ``l2`` / ``sql2``
    (factored form) and ``dot`` (``sq`` taken as 0, the result halved);
    ``k`` up to 128."""
    return _epilogue(*_scan_partial(x, sq, q, k, metric), q, metric)


def _scan_partial(x, sq, q, k, metric):
    """:func:`scan_topk` before its epilogue: the ranked partial distances
    ``sq - 2 x.q`` and their ids, from the kernel on a CUDA device and
    from the plain version on the CPU."""
    _check_metric(metric)
    if x.device.type == "cpu":
        return _partial_reference(x, sq, q, k, metric)
    name = "scan_topk"
    k = min(int(k), x.shape[0])
    _check_args(x, sq, q, k)
    for key, t in (("x", x), ("sq", sq), ("q", q)):
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    n, d = x.shape
    b = q.shape[0]
    od = torch.empty((b, k), dtype=torch.float32, device=x.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=x.device)
    if b == 0:
        return od, oi
    splits, rows = _splits(n, b, x.device)
    pd = torch.empty((splits, b, k), dtype=torch.float32, device=x.device)
    pi = torch.empty((splits, b, k), dtype=torch.int32, device=x.device)
    lib = _cuda.lib()
    with torch.cuda.device(x.device):
        code = lib.rpt_scan_topk(
            _cuda.ptr(x), _cuda.ptr(sq), _cuda.ptr(q), _cuda.ptr(pd),
            _cuda.ptr(pi), _cuda.ptr(od), _cuda.ptr(oi), n, b, d, k,
            int(metric == "dot"), splits, rows, _cuda.stream_of(x))
    _cuda.check(code, name)
    scan_topk.launches += 1
    return od, oi


scan_topk.launches = 0
