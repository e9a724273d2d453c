"""Grouped tile scoring (``rptree_tpu/ops/grouped_kernel.py``): kernels 1
(f32 and bf16 blocks, CUDA in ``csrc/grouped_score.cu``) and 2 (int8,
``csrc/grouped_score_i8.cu``) of the serving path, and kernel 4, the tile
scoring fused with a per-slot top-kp (``impl="kernel_topk"``), CUDA in
``csrc/grouped_topk.cu``.

A tile is up to ``tile_m`` (query, probe) pairs that probe the same leaf
block; each tile's rows are scored against its one block.  Each kernel
has a plain torch version beside it (``*_reference``), and a wrapper that
takes the plain version for a tensor on the CPU and launches the kernel
for a tensor on a CUDA device, or raises there: it never falls back.
``<wrapper>.launches`` counts kernel launches; ``grouped_score_tiles``
counts its bf16 launches apart, in ``launches_bf16``.

bf16 blocks are scored as the Pallas kernels' ``qm.astype(bf16)`` dot:
the query rows are rounded to bf16 (nearest even), each product of two
bf16 values is exact in fp32 and the sums are fp32; ``|q|^2`` comes from
the unrounded f32 rows and the slot norms stay f32.

The Pallas kernels' ``tc_k`` grid chunking and their sublane alignment
gate are TPU grid artifacts: the CUDA kernels take any ``lmax`` and any
tile count.
"""

from __future__ import annotations

import torch

from .. import _cuda

__all__ = ["grouped_score_tiles", "grouped_score_tiles_reference",
           "grouped_score_tiles_int8", "grouped_score_tiles_int8_reference",
           "grouped_score_topk", "grouped_score_topk_reference",
           "grouped_kernel_ok", "untied"]

_METRICS = ("l2", "sql2")
_MAX_TILE_M = 32
_MAX_KP = 128
_FLOAT_BLOCKS = (torch.float32, torch.bfloat16)
# tiles per step of the plain versions (bounds their gathered-block buffer)
_REF_CHUNK = 4096
# int8 scales are ``amax / 127`` as the JAX package's compiled programs
# compute it: XLA turns a division by a constant into a multiply by the
# constant's f32 reciprocal, so the port multiplies too, bit for bit
INV_127 = 1.0 / 127.0


def grouped_kernel_ok(x_leaf, metric) -> bool:
    """Whether the tile kernels serve these blocks: dense 3-D f32, bf16 or
    int8 blocks and a builtin ``l2``/``sql2`` metric."""
    return (metric in _METRICS and isinstance(x_leaf, torch.Tensor)
            and x_leaf.dim() == 3
            and x_leaf.dtype in (*_FLOAT_BLOCKS, torch.int8))


def _check_metric(metric):
    if metric not in _METRICS:
        raise ValueError(f"tile scoring serves metric l2 / sql2, got {metric!r}")


def _check_float_blocks(name, x_leaf):
    if x_leaf.dtype not in _FLOAT_BLOCKS:
        raise TypeError(f"{name}: x_leaf must be float32 or bfloat16, got "
                        f"{x_leaf.dtype}")


def _check_cuda(name, tile_m, **tensors):
    """Device, dtype, shape and contiguity checks before pointers go to
    the kernel (raises; nothing is converted)."""
    dev = None
    for key, (t, dtype, ndim) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, others on {dev}")
        dev = t.device
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: {key} must be {ndim}-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if not 1 <= tile_m <= _MAX_TILE_M:
        raise ValueError(f"{name}: tile_m must be in [1, {_MAX_TILE_M}], got {tile_m}")


def _check_shapes(x_leaf, sq_leaf, tb, lens_t, qt, tile_m):
    g, lmax, d = x_leaf.shape
    nt = tb.shape[0]
    if tuple(sq_leaf.shape) != (g, lmax):
        raise ValueError(f"sq_leaf {tuple(sq_leaf.shape)} != {(g, lmax)}")
    if tuple(lens_t.shape) != (nt,):
        raise ValueError(f"lens_t {tuple(lens_t.shape)} != {(nt,)}")
    if tuple(qt.shape) != (nt * tile_m, d):
        raise ValueError(f"qt {tuple(qt.shape)} != {(nt * tile_m, d)}")
    if g < 1:
        raise ValueError("x_leaf holds no blocks")


def _occupancy(lens, lmax):
    """``[c, 1, lmax]`` mask of the slots below each tile's occupancy."""
    col = torch.arange(lmax, device=lens.device)
    return col[None, None, :] < lens[:, None, None]


def _factored_l2(sq, dots, qq, metric):
    d = (sq - 2.0 * dots + qq).clamp_min(0.0)
    return d.sqrt() if metric == "l2" else d


@torch.no_grad()
def grouped_score_tiles_reference(x_leaf, sq_leaf, tb, lens_t, qt, metric,
                                  tile_m: int):
    """Plain torch version of :func:`grouped_score_tiles`."""
    _check_metric(metric)
    _check_float_blocks("grouped_score_tiles", x_leaf)
    _check_shapes(x_leaf, sq_leaf, tb, lens_t, qt, tile_m)
    g, lmax, d = x_leaf.shape
    nt = tb.shape[0]
    out = torch.empty((nt * tile_m, lmax), dtype=torch.float32,
                      device=x_leaf.device)
    for s in range(0, nt, _REF_CHUNK):
        c = min(_REF_CHUNK, nt - s)
        tbs = tb[s:s + c].long()
        blk = x_leaf[tbs].float()                            # [c, lmax, D]
        qm = qt[s * tile_m:(s + c) * tile_m].reshape(c, tile_m, d)
        qr = qm.to(x_leaf.dtype).float()      # bf16 blocks: rounded rows
        dots = torch.bmm(qr, blk.transpose(1, 2))            # [c, m, lmax]
        qq = (qm * qm).sum(-1, keepdim=True)
        dd = _factored_l2(sq_leaf[tbs][:, None, :], dots, qq, metric)
        dd = torch.where(_occupancy(lens_t[s:s + c], lmax), dd, float("inf"))
        out[s * tile_m:(s + c) * tile_m] = dd.reshape(c * tile_m, lmax)
    return out


def grouped_score_tiles(x_leaf, sq_leaf, tb, lens_t, qt, metric,
                        tile_m: int):
    """Exact per-slot distances of every tile: ``d f32[nt * tile_m, lmax]``.

    ``x_leaf f32 or bf16 [G, lmax, D]`` packed blocks, ``sq_leaf f32[G,
    lmax]`` slot squared norms, ``tb int32[nt]`` block row per tile,
    ``lens_t int32[nt]`` occupancy per tile, ``qt f32[nt * tile_m, D]``
    query rows in tile-slot order.  Slots at or past a tile's occupancy
    return +inf; rows of empty tile slots are junk that callers never
    read.  Block rows are clamped into ``[0, G)`` on the card.
    """
    _check_metric(metric)
    if x_leaf.device.type == "cpu":
        return grouped_score_tiles_reference(x_leaf, sq_leaf, tb, lens_t, qt,
                                             metric, tile_m)
    name = "grouped_score_tiles"
    _check_float_blocks(name, x_leaf)
    _check_cuda(name, tile_m, x_leaf=(x_leaf, x_leaf.dtype, 3),
                sq_leaf=(sq_leaf, torch.float32, 2), tb=(tb, torch.int32, 1),
                lens_t=(lens_t, torch.int32, 1), qt=(qt, torch.float32, 2))
    _check_shapes(x_leaf, sq_leaf, tb, lens_t, qt, tile_m)
    g, lmax, d = x_leaf.shape
    nt = tb.shape[0]
    out = torch.empty((nt * tile_m, lmax), dtype=torch.float32,
                      device=x_leaf.device)
    if nt == 0:
        return out
    lib = _cuda.lib()
    bf16 = x_leaf.dtype == torch.bfloat16
    fn = lib.rpt_grouped_score_bf16 if bf16 else lib.rpt_grouped_score_f32
    with _cuda.on(x_leaf.device):
        code = fn(_cuda.ptr(x_leaf), _cuda.ptr(sq_leaf), _cuda.ptr(tb),
                  _cuda.ptr(lens_t), _cuda.ptr(qt), _cuda.ptr(out), nt, g,
                  tile_m, lmax, d, int(metric == "l2"),
                  _cuda.stream_of(x_leaf))
    _cuda.check(code, name)
    if bf16:
        grouped_score_tiles.launches_bf16 += 1
    else:
        grouped_score_tiles.launches += 1
    return out


grouped_score_tiles.launches = 0
grouped_score_tiles.launches_bf16 = 0


def _check_topk(x_leaf, id_leaf, kp):
    g, lmax, _ = x_leaf.shape
    if tuple(id_leaf.shape) != (g, lmax):
        raise ValueError(f"id_leaf {tuple(id_leaf.shape)} != {(g, lmax)}")
    if not 1 <= kp <= min(_MAX_KP, lmax):
        raise ValueError(f"kp must be in [1, min({_MAX_KP}, lmax={lmax})], "
                         f"got {kp}")


@torch.no_grad()
def grouped_score_topk_reference(x_leaf, sq_leaf, id_leaf, tb, lens_t, qt,
                                 metric, tile_m: int, kp: int):
    """Plain torch version of :func:`grouped_score_topk`: the plain tile
    distances, a stable sort of each row (``torch.topk`` does not keep
    the slot order on ties), its first ``kp`` entries and their ids."""
    _check_topk(x_leaf, id_leaf, kp)
    lmax = x_leaf.shape[1]
    nt = tb.shape[0]
    full = grouped_score_tiles_reference(x_leaf, sq_leaf, tb, lens_t, qt,
                                         metric, tile_m)
    d, order = torch.sort(full, dim=1, stable=True)
    d = d[:, :kp].contiguous()
    ids_t = id_leaf[tb.long()][:, None, :].expand(nt, tile_m, lmax)
    ids = ids_t.gather(2, order[:, :kp].reshape(nt, tile_m, kp))
    ids = torch.where(torch.isinf(d), -1, ids.reshape(nt * tile_m, kp))
    return d, ids.to(torch.int32)


def grouped_score_topk(x_leaf, sq_leaf, id_leaf, tb, lens_t, qt, metric,
                       tile_m: int, kp: int):
    """:func:`grouped_score_tiles` fused with a per-slot top-``kp``:
    ``(d f32[nt * tile_m, kp], ids int32[nt * tile_m, kp])``, each slot
    row's ``kp`` nearest in-block candidates in ascending distance order,
    ties to the lowest slot, with the point ids from ``id_leaf int32[G,
    lmax]``.  Slots are taken by index, so duplicated rows come out once
    per copy; rows with fewer than ``kp`` occupied slots pad with ``(+inf,
    -1)``.  f32 or bf16 blocks; ``kp`` in ``[1, min(128, lmax)]``."""
    _check_metric(metric)
    if x_leaf.device.type == "cpu":
        return grouped_score_topk_reference(x_leaf, sq_leaf, id_leaf, tb,
                                            lens_t, qt, metric, tile_m, kp)
    name = "grouped_score_topk"
    _check_float_blocks(name, x_leaf)
    _check_cuda(name, tile_m, x_leaf=(x_leaf, x_leaf.dtype, 3),
                sq_leaf=(sq_leaf, torch.float32, 2),
                id_leaf=(id_leaf, torch.int32, 2), tb=(tb, torch.int32, 1),
                lens_t=(lens_t, torch.int32, 1), qt=(qt, torch.float32, 2))
    _check_shapes(x_leaf, sq_leaf, tb, lens_t, qt, tile_m)
    _check_topk(x_leaf, id_leaf, kp)
    g, lmax, d = x_leaf.shape
    nt = tb.shape[0]
    od = torch.empty((nt * tile_m, kp), dtype=torch.float32,
                     device=x_leaf.device)
    oi = torch.empty((nt * tile_m, kp), dtype=torch.int32,
                     device=x_leaf.device)
    if nt == 0:
        return od, oi
    lib = _cuda.lib()
    fn = (lib.rpt_grouped_topk_bf16 if x_leaf.dtype == torch.bfloat16
          else lib.rpt_grouped_topk_f32)
    with _cuda.on(x_leaf.device):
        code = fn(_cuda.ptr(x_leaf), _cuda.ptr(sq_leaf), _cuda.ptr(id_leaf),
                  _cuda.ptr(tb), _cuda.ptr(lens_t), _cuda.ptr(qt),
                  _cuda.ptr(od), _cuda.ptr(oi), nt, g, tile_m, lmax, d,
                  int(metric == "l2"), kp, _cuda.stream_of(x_leaf))
    _cuda.check(code, name)
    grouped_score_topk.launches += 1
    return od, oi


grouped_score_topk.launches = 0


def untied(d, rtol: float = 0.0):
    """Entries of the ascending rows ``d [R, W]`` that are finite and in no
    run of distances equal to within ``rtol`` (relative to the larger
    neighbour's magnitude, floored at 1): where two top-k's of the same
    candidates must give the same id.  ``rtol=0`` for results of the same
    bits, a float-noise bound for results summed in other orders."""
    d = torch.as_tensor(d)
    gap = (d[:, 1:] - d[:, :-1]).abs()
    eq = ~(gap > rtol * d[:, 1:].abs().clamp_min(1.0))
    tied = torch.zeros_like(d, dtype=torch.bool)
    tied[:, 1:] |= eq
    tied[:, :-1] |= eq
    return torch.isfinite(d) & ~tied


def _quantize_rows(qrows):
    """Symmetric per-row int8 quantization of query rows ``[..., D]``;
    returns ``(int8 rows, f32 scale [..., 1])``.  Divides the rows by the
    scale (no multiply by its reciprocal) and rounds half to even, as the JAX
    package does, so the int8 rows are bit-equal."""
    amax = qrows.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-30) * INV_127
    qi = torch.round(qrows / scale).clamp(-127, 127).to(torch.int8)
    return qi, scale


def _int8_dots(qm, blk):
    """Exact integer dots of int8 rows ``[c, m, D]`` x blocks ``[c, L, D]``
    as f32: every product and partial sum is an integer below 2**24 when
    ``D * 127 * 127 < 2**24`` (D <= 1040), so an fp32 product is exact;
    wider rows go through f64."""
    dt = torch.float32 if qm.shape[-1] * 127 * 127 < (1 << 24) else torch.float64
    return torch.bmm(qm.to(dt), blk.to(dt).transpose(1, 2)).to(torch.float32)


def _int8_operands(scale, tb, qt):
    q_i8, qscale = _quantize_rows(qt)                  # [nt*m, D], [nt*m, 1]
    qq = (qt * qt).sum(dim=1, keepdim=True)            # true f32 norms
    scale_t = scale[tb.long()]                         # [nt]
    return q_i8, qscale, qq, scale_t


@torch.no_grad()
def grouped_score_tiles_int8_reference(x_leaf, sq_leaf, scale, tb, lens_t, qt,
                                       metric, tile_m: int):
    """Plain torch version of :func:`grouped_score_tiles_int8`."""
    _check_metric(metric)
    _check_shapes(x_leaf, sq_leaf, tb, lens_t, qt, tile_m)
    g, lmax, d = x_leaf.shape
    nt = tb.shape[0]
    q_i8, qscale, qq, scale_t = _int8_operands(scale, tb, qt)
    out = torch.empty((nt * tile_m, lmax), dtype=torch.float32,
                      device=x_leaf.device)
    for s in range(0, nt, _REF_CHUNK):
        c = min(_REF_CHUNK, nt - s)
        rows = slice(s * tile_m, (s + c) * tile_m)
        tbs = tb[s:s + c].long()
        dots = _int8_dots(q_i8[rows].reshape(c, tile_m, d), x_leaf[tbs])
        # the Pallas kernel's order: dots * (block scale * row scale)
        dotsf = dots * (scale_t[s:s + c, None, None]
                        * qscale[rows].reshape(c, tile_m, 1))
        dd = _factored_l2(sq_leaf[tbs][:, None, :], dotsf,
                          qq[rows].reshape(c, tile_m, 1), metric)
        dd = torch.where(_occupancy(lens_t[s:s + c], lmax), dd, float("inf"))
        out[rows] = dd.reshape(c * tile_m, lmax)
    return out


def grouped_score_tiles_int8(x_leaf, sq_leaf, scale, tb, lens_t, qt, metric,
                             tile_m: int):
    """:func:`grouped_score_tiles` for int8 blocks: ``x_leaf int8[G, lmax,
    D]`` with per-block scales ``scale f32[G]``.  Query rows are quantized
    to int8 per row (:func:`_quantize_rows`; on the card inside the
    kernel, to the same bits); the dots are exact integers, dequantized
    with the block scale times the row scale, and the factored L2 is
    assembled against the exact stored slot norms and the true f32 query
    norms (summed in another order on the card)."""
    _check_metric(metric)
    if x_leaf.device.type == "cpu":
        return grouped_score_tiles_int8_reference(x_leaf, sq_leaf, scale, tb,
                                                  lens_t, qt, metric, tile_m)
    name = "grouped_score_tiles_int8"
    _check_cuda(name, tile_m, x_leaf=(x_leaf, torch.int8, 3),
                sq_leaf=(sq_leaf, torch.float32, 2),
                scale=(scale, torch.float32, 1), tb=(tb, torch.int32, 1),
                lens_t=(lens_t, torch.int32, 1), qt=(qt, torch.float32, 2))
    _check_shapes(x_leaf, sq_leaf, tb, lens_t, qt, tile_m)
    g, lmax, d = x_leaf.shape
    if tuple(scale.shape) != (g,):
        raise ValueError(f"scale {tuple(scale.shape)} != {(g,)}")
    nt = tb.shape[0]
    out = torch.empty((nt * tile_m, lmax), dtype=torch.float32,
                      device=x_leaf.device)
    if nt == 0:
        return out
    lib = _cuda.lib()
    with _cuda.on(x_leaf.device):
        code = lib.rpt_grouped_score_i8(
            _cuda.ptr(x_leaf), _cuda.ptr(sq_leaf), _cuda.ptr(scale),
            _cuda.ptr(tb), _cuda.ptr(lens_t), _cuda.ptr(qt), _cuda.ptr(out),
            nt, g, tile_m, lmax, d, int(metric == "l2"),
            _cuda.stream_of(x_leaf))
    _cuda.check(code, name)
    grouped_score_tiles_int8.launches += 1
    return out


grouped_score_tiles_int8.launches = 0
