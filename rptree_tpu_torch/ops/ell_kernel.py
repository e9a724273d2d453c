"""ELL tile scoring: kernel 10 of the port, CUDA in ``csrc/ell_score.cu``.

The JAX package scores sparse (ELL) leaf blocks outside Pallas: ELL
blocks fail its tile kernels' gate, so the grouped path takes the XLA
form's ELL step (``rptree_tpu/ops/grouped.py:170-192``) and the per-pair
path its own ELL step (``rptree_tpu/models/forest.py:612-627``).  Both
gather the dense query at each stored column and contract over the K
slots.  :func:`ell_score_tiles` is both steps: a tile is up to ``tile_m``
(query, probe) pairs that probe one block (the grouped path's tiles from
kernel 9, or the per-pair path's pairs as tiles of one), and each tile
row gets the distances to every slot of its block.

:func:`ell_score_tiles_reference` is the XLA form's gather, line for
line: it materialises each step's ``[tc, m, D]`` query tile and ``[tc, m,
lmax, K]`` gather, so it takes ``tile_chunk`` tiles a step, capped as the
JAX package caps it (:func:`ell_tile_chunk_cap`).  The kernel reads each
query row in place through the tile table and makes neither, so the cap
binds only the plain version.  The wrapper takes the plain version for
blocks on the CPU and launches the kernel for blocks on a CUDA device, or
raises there: it never falls back.  ``ell_score_tiles.launches`` counts
launches.

The kernel takes one of two routes a tile (:data:`ELL_ROUTES`), with the
same bits: it stages the rows' support (a bit a column: the value is not
+0.0, from a first pass over the queries) and reads only the values whose
bit is set; or, where the vocabulary is too wide for a quad of rows'
support in shared memory, it reads every value through L2.
:func:`ell_tile_routes` is its rule in plain torch, and
:func:`ell_score_tiles_routes` returns the kernel's own count.
"""

from __future__ import annotations

import torch

from .. import _cuda
from .rerank import distances_from_norms
from .sparse import EllBlocks

__all__ = ["ell_score_tiles", "ell_score_tiles_reference",
           "ell_score_tiles_routes", "ell_tile_routes", "ell_support_reference",
           "ell_tile_chunk_cap",
           "ELL_METRICS", "ELL_ROUTES"]

ELL_METRICS = {"sql2": 0, "l2": 1, "cosine": 2, "dot": 3}
_MAX_TILE_M = 32
# kernel 10's routes (csrc/ell_score.cu): the rows' support bitmaps staged,
# four rows at a time; the query read through L2 (a vocabulary too wide
# for the support); nothing to score
ELL_ROUTES = ("support", "l2", "empty")
ELL_SUPPORT_BYTES = 40 * 1024      # kSupportBytes: a quad of rows' support
ELL_SUPPORT_BYTES_ONE = 16 * 1024  # kSupportBytesOne, tile_m 1


def ell_tile_chunk_cap(lmax: int, k: int, dim: int, tile_m: int,
                       tile_chunk: int) -> int:
    """The JAX package's ``_ell_tile_chunk_cap``: tiles a step of the
    plain form, so that the larger of its query tile ``[tc, m, dim]`` and
    its gather ``[tc, m, lmax, K]`` stays ~64M elements (at 65,536 columns
    the default step's query tile alone would be 8 GB)."""
    per = max(int(tile_m) * max(int(dim), int(lmax) * int(k)), 1)
    return max(16, min(int(tile_chunk), (64 << 20) // per))


def _check_metric(metric):
    if callable(metric):
        raise NotImplementedError("custom distance callables need dense "
                                  "data rows (ELL-sparse datasets support "
                                  "the builtin metrics only)")
    if metric not in ELL_METRICS:
        raise ValueError(f"unknown metric {metric!r}; one of "
                         f"{sorted(ELL_METRICS)}")


def _check_shapes(blocks, sq_leaf, tb, tp, lens_t, q, qq, p):
    if not isinstance(blocks, EllBlocks):
        raise TypeError(f"blocks must be EllBlocks, got {type(blocks)}")
    g, lmax, _ = blocks.shape
    nt = tb.shape[0]
    if tuple(blocks.vals.shape) != tuple(blocks.cols.shape):
        raise ValueError(f"vals {tuple(blocks.vals.shape)} != cols "
                         f"{tuple(blocks.cols.shape)}")
    if tuple(sq_leaf.shape) != (g, lmax):
        raise ValueError(f"sq_leaf {tuple(sq_leaf.shape)} != {(g, lmax)}")
    if tp.dim() != 2 or tp.shape[0] != nt or tuple(lens_t.shape) != (nt,):
        raise ValueError(f"tp {tuple(tp.shape)} and lens_t "
                         f"{tuple(lens_t.shape)} must be [{nt}, m] and "
                         f"[{nt}]")
    if q.dim() != 2 or q.shape[1] != blocks.dim or tuple(qq.shape) != (
            q.shape[0],):
        raise ValueError(f"q {tuple(q.shape)} and qq {tuple(qq.shape)} must "
                         f"be [B, {blocks.dim}] and [B]")
    if g < 1 or q.shape[0] < 1 or int(p) < 1:
        raise ValueError("ell_score_tiles needs blocks, queries and p >= 1")


@torch.no_grad()
def ell_score_tiles_reference(blocks, sq_leaf, tb, tp, lens_t, q, qq, p,
                              metric, tile_chunk: int = 2048):
    """Plain torch version of :func:`ell_score_tiles`: the XLA form's ELL
    step, ``tile_chunk`` tiles a step (capped by
    :func:`ell_tile_chunk_cap`)."""
    _check_metric(metric)
    _check_shapes(blocks, sq_leaf, tb, tp, lens_t, q, qq, p)
    g, lmax, k = blocks.shape
    nt, m = tp.shape
    step = ell_tile_chunk_cap(lmax, k, blocks.dim, m, tile_chunk)
    col = torch.arange(lmax, device=q.device)
    out = torch.empty((nt * m, lmax), dtype=torch.float32, device=q.device)
    for s in range(0, nt, step):
        c = min(step, nt - s)
        rows = tb[s:s + c].long()
        tp_i = tp[s:s + c]
        qi = torch.where(tp_i >= 0, tp_i // p, 0).long()
        qt = q[qi]                                          # [c, m, D]
        cols = blocks.cols[rows].long()                     # [c, lmax, K]
        vals = blocks.vals[rows]
        qg = qt.gather(2, cols.reshape(c, 1, lmax * k).expand(c, m, -1))
        dots = (vals[:, None].float() * qg.reshape(c, m, lmax, k)).sum(-1)
        d = distances_from_norms(dots, sq_leaf[rows][:, None, :],
                                 qq[qi][..., None], metric)
        valid = (tp_i >= 0)[:, :, None] & (col < lens_t[s:s + c, None, None])
        out[s * m:(s + c) * m] = torch.where(valid, d, float("inf")).reshape(
            c * m, lmax)
    return out


def _check_cuda(name, dev, **tensors):
    for key, (t, dtypes, ndim) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {key} must be {dtypes[0]}, got "
                            f"{t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: {key} must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def ell_score_tiles(blocks, sq_leaf, tb, tp, lens_t, q, qq, p, metric,
                    tile_chunk: int = 2048):
    """Distances of every tile row to every slot of its block: ``d
    f32[nt * m, lmax]``.

    ``blocks`` :class:`.sparse.EllBlocks` (``cols int32``, ``vals f32 or
    bf16 [G, lmax, K]``), ``sq_leaf f32[G, lmax]`` slot squared norms,
    ``tb int32[nt]`` each tile's block, ``tp int32[nt, m]`` each tile
    row's pair (-1: none), ``lens_t int32[nt]`` each tile's occupancy,
    ``q f32[B, dim]`` the dense query rows, ``qq f32[B]`` their squared
    norms, ``p`` pairs per query (a pair's query is ``tp // p``),
    ``metric`` ``l2``, ``sql2``, ``cosine`` or ``dot``.  For row ``i`` of
    tile ``t`` and slot ``j``: ``dot = sum_k vals[tb, j, k] * q[tp // p,
    cols[tb, j, k]]``, turned into a distance as the JAX package's
    ``distances_from_dots`` does with ``sqq = qq``; +inf where ``tp < 0``
    or ``j >= lens_t``.  ``tile_chunk`` steps only the plain version.  On
    the card, block and column ids outside their ranges are clamped into
    them."""
    _check_metric(metric)
    if blocks.device.type == "cpu":
        return ell_score_tiles_reference(blocks, sq_leaf, tb, tp, lens_t, q,
                                         qq, p, metric, tile_chunk)
    out = _launch(blocks, sq_leaf, tb, tp, lens_t, q, qq, p, metric, None)
    ell_score_tiles.launches += 1
    return out


ell_score_tiles.launches = 0


def ell_score_tiles_routes(blocks, sq_leaf, tb, tp, lens_t, q, qq, p,
                           metric):
    """:func:`ell_score_tiles` with the kernel's count of the tiles on each
    route: ``(d, int32[3])``, indexed as :data:`ELL_ROUTES`.  For checks
    and measurements: it does not add to ``ell_score_tiles.launches``.
    On the CPU the plain version and :func:`ell_tile_routes`' counts."""
    _check_metric(metric)
    if blocks.device.type == "cpu":
        return (ell_score_tiles_reference(blocks, sq_leaf, tb, tp, lens_t, q,
                                          qq, p, metric),
                torch.bincount(ell_tile_routes(blocks, tp, lens_t),
                               minlength=3).to(torch.int32))
    routes = torch.zeros(3, dtype=torch.int32, device=q.device)
    out = _launch(blocks, sq_leaf, tb, tp, lens_t, q, qq, p, metric, routes)
    return out, routes


def _launch(blocks, sq_leaf, tb, tp, lens_t, q, qq, p, metric, routes):
    name = "ell_score_tiles"
    _check_shapes(blocks, sq_leaf, tb, tp, lens_t, q, qq, p)
    f32, i32 = (torch.float32,), (torch.int32,)
    _check_cuda(name, blocks.device, cols=(blocks.cols, i32, 3),
                vals=(blocks.vals, (torch.float32, torch.bfloat16), 3),
                sq_leaf=(sq_leaf, f32, 2), tb=(tb, i32, 1), tp=(tp, i32, 2),
                lens_t=(lens_t, i32, 1), q=(q, f32, 2), qq=(qq, f32, 1))
    g, lmax, k = blocks.shape
    nt, m = tp.shape
    if not 1 <= m <= _MAX_TILE_M:
        raise ValueError(f"{name}: tile_m must be in [1, {_MAX_TILE_M}], "
                         f"got {m}")
    out = torch.empty((nt * m, lmax), dtype=torch.float32, device=q.device)
    if nt == 0 or lmax == 0:
        return out
    lib = _cuda.lib()
    bf16 = blocks.vals.dtype == torch.bfloat16
    fn = lib.rpt_ell_score_bf16 if bf16 else lib.rpt_ell_score_f32
    # the queries' support, one bit a column (the kernel's first pass)
    bits = torch.empty((q.shape[0], -(-blocks.dim // 32)), dtype=torch.int32,
                       device=q.device)
    with _cuda.on(q.device):
        code = fn(*map(_cuda.ptr, (blocks.cols, blocks.vals, sq_leaf, tb, tp,
                                   lens_t, q, qq, bits, out)),
                  nt, g, m, lmax, k, blocks.dim, q.shape[0], int(p),
                  ELL_METRICS[metric],
                  None if routes is None else _cuda.ptr(routes),
                  _cuda.stream_of(q))
    _cuda.check(code, name)
    return out


def ell_support_reference(q: torch.Tensor) -> torch.Tensor:
    """The queries' support as kernel 10's first pass makes it: ``int32[B,
    ceil(V / 32)]``, bit ``i`` of word ``w`` set where ``q[:, 32 w + i]``
    is not +0.0 (any other bits: a nonzero, -0.0, inf, NaN)."""
    b, v = q.shape
    words = -(-v // 32)
    nz = q.contiguous().view(torch.int32) != 0
    nz = torch.nn.functional.pad(nz, (0, words * 32 - v)).reshape(b, words, 32)
    w = (nz.long() << torch.arange(32, device=q.device)).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _ell_support(q: torch.Tensor) -> torch.Tensor:
    """Kernel 10's first pass alone on the card (for checks and timing)."""
    bits = torch.empty((q.shape[0], -(-q.shape[1] // 32)), dtype=torch.int32,
                       device=q.device)
    with _cuda.on(q.device):
        code = _cuda.lib().rpt_ell_support(_cuda.ptr(q), q.shape[0],
                                           q.shape[1], _cuda.ptr(bits),
                                           _cuda.stream_of(q))
    _cuda.check(code, "ell_support")
    return bits


@torch.no_grad()
def ell_tile_routes(blocks, tp, lens_t):
    """The route kernel 10 takes for each tile, ``int64[nt]`` indexed as
    :data:`ELL_ROUTES`, by the kernel's own rule in plain torch (any
    device): 2 (``empty``) where the tile has no row or no occupied slot;
    else 0 (``support``) where a quad of rows' support, ``ceil(V / 32)``
    words a row (one row at ``tile_m`` 1), fits ``ELL_SUPPORT_BYTES``
    (``ELL_SUPPORT_BYTES_ONE``) of shared memory, and 1 (``l2``) where
    it does not."""
    lmax = blocks.shape[1]
    m = tp.shape[1]
    words = -(-blocks.dim // 32)
    fits = (words * 4 <= ELL_SUPPORT_BYTES_ONE if m == 1
            else 4 * words * 4 <= ELL_SUPPORT_BYTES)
    empty = ~(tp >= 0).any(-1) | (lens_t.long().clamp(0, lmax) == 0)
    return torch.where(empty, 2, 0 if fits else 1)
