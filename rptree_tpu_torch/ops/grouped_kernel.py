"""Grouped tile scoring (``rptree_tpu/ops/grouped_kernel.py``): kernels 1
(f32 and bf16 blocks, CUDA in ``csrc/grouped_score.cu``) and 2 (int8,
``csrc/grouped_score_i8.cu``) of the serving path, and kernel 4, the tile
scoring fused with a per-slot top-kp (``impl="kernel_topk"``), CUDA in
``csrc/grouped_topk.cu``.

A tile is up to ``tile_m`` (query, probe) pairs that probe the same leaf
block; each tile's rows are scored against its one block.  Kernel 1
serves two forms: :func:`grouped_score_pairs`, the serving path's, reads
each pair's query row in place through the tile tables and writes its
distance row straight to the pair's place; :func:`grouped_score_tiles`,
the JAX package's slot-order contract, is the same launch through the
identity pair map.  Each kernel has a plain torch version beside it
(``*_reference``), and a wrapper that takes the plain version for a
tensor on the CPU and launches the kernel for a tensor on a CUDA device,
or raises there: it never falls back.  ``<wrapper>.launches`` counts
kernel launches; kernel 1's, in either form, count on
``grouped_score_tiles``, its bf16 launches apart in ``launches_bf16``.

bf16 blocks are scored as the Pallas kernels' ``qm.astype(bf16)`` dot:
the query rows are rounded to bf16 (nearest even), each product of two
bf16 values is exact in fp32 and the sums are fp32; ``|q|^2`` comes from
the unrounded f32 rows and the slot norms stay f32.

The Pallas kernels' ``tc_k`` grid chunking and their sublane alignment
gate are TPU grid artifacts: the CUDA kernels take any ``lmax`` and any
tile count.
"""

from __future__ import annotations

import functools
import struct

import torch

from .. import _cuda

__all__ = ["grouped_score_pairs", "grouped_score_pairs_reference",
           "score_runs", "staged_bytes", "range_tiles",
           "grouped_score_tiles",
           "grouped_score_tiles_reference",
           "grouped_score_tiles_int8", "grouped_score_tiles_int8_reference",
           "grouped_score_topk", "grouped_score_topk_reference",
           "grouped_kernel_ok", "untied"]

_METRICS = ("l2", "sql2")
_MAX_TILE_M = 32
_MAX_KP = 128
_FLOAT_BLOCKS = (torch.float32, torch.bfloat16)
# tiles per step of the plain versions (bounds their gathered-block buffer)
_REF_CHUNK = 4096
# csrc/grouped_score.cu's work units: a run of one block's tiles holds at
# most 32 slots (kRunSlots), and a thread block takes the tiles of at most
# 256 slots, 32 tiles at most (kRangeSlots, kMaxTiles); runs break there
_RUN_SLOTS, _RANGE_SLOTS, _MAX_TILES = 32, 256, 32
# slots a stage of its ring holds (kSlotTile): a run's query rows are
# staged once for every such tile of its block's slots
_SLOT_TILE = 128
# thread blocks an SM holds (its shared memory) and the waves of them that
# a launch should give the SMs before its ranges shrink (range_tiles)
_BLOCKS_PER_SM, _WAVES = 2, 4
# The C entry point's arguments, an int64 each in their order
# (csrc/grouped_score.cu rpt_grouped_score): x, sq, tb, tp, lens, slot, q,
# out, reads, pairs, nt, g, tile_m, lmax, d, p, l2, bf16, range_tiles,
# stream
_SCORE_ARGS = struct.Struct("20q")
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


def _tile_dists(x_leaf, sq_leaf, tbs, lens_s, qm, metric):
    """The plain distances ``[c, m, lmax]`` of ``c`` tiles: blocks ``tbs
    int64[c]``, occupancy ``lens_s [c]``, query rows ``qm f32[c, m, D]``."""
    blk = x_leaf[tbs].float()                            # [c, lmax, D]
    qr = qm.to(x_leaf.dtype).float()      # bf16 blocks: rounded rows
    dots = torch.bmm(qr, blk.transpose(1, 2))            # [c, m, lmax]
    qq = (qm * qm).sum(-1, keepdim=True)
    dd = _factored_l2(sq_leaf[tbs][:, None, :], dots, qq, metric)
    return torch.where(_occupancy(lens_s, x_leaf.shape[1]), dd, float("inf"))


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
        qm = qt[s * tile_m:(s + c) * tile_m].reshape(c, tile_m, d)
        dd = _tile_dists(x_leaf, sq_leaf, tb[s:s + c].long(),
                         lens_t[s:s + c], qm, metric)
        out[s * tile_m:(s + c) * tile_m] = dd.reshape(c * tile_m, lmax)
    return out


def _launch_score(x_leaf, sq_leaf, tb, tp, lens_t, slot, q, out, reads,
                  tile_m, p, metric):
    """One launch of kernel 1 (``csrc/grouped_score.cu``); ``tp`` and
    ``slot`` None for the identity pair map."""
    g, lmax, d = x_leaf.shape
    nt = tb.shape[0]
    bf16 = x_leaf.dtype == torch.bfloat16
    with _cuda.on(x_leaf.device):
        code = _cuda.lib().rpt_grouped_score(_SCORE_ARGS.pack(
            x_leaf.data_ptr(), sq_leaf.data_ptr(), tb.data_ptr(),
            0 if tp is None else tp.data_ptr(), lens_t.data_ptr(),
            0 if slot is None else slot.data_ptr(), q.data_ptr(),
            out.data_ptr(), 0 if reads is None else reads.data_ptr(),
            out.shape[0], nt, g, tile_m, lmax, d, p, int(metric == "l2"),
            int(bf16), range_tiles(nt, tile_m, _sm_count(x_leaf.device)),
            _cuda.raw_stream(x_leaf.device)))
    _cuda.check(code, "grouped_score_tiles")
    if bf16:
        grouped_score_tiles.launches_bf16 += 1
    else:
        grouped_score_tiles.launches += 1


@functools.lru_cache(maxsize=64)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def range_tiles(nt: int, tile_m: int, sms: int = None) -> int:
    """The tiles each thread block of kernel 1 takes: ``min(32, 256 //
    tile_m)``, or fewer where ``nt`` tiles would give ``sms`` SMs under
    about four waves of two thread blocks each (``sms`` None: no such
    limit, the plain versions' count)."""
    cap = min(_MAX_TILES, max(1, _RANGE_SLOTS // tile_m))
    if sms is None:
        return cap
    return max(1, min(cap, -(-nt // (_WAVES * _BLOCKS_PER_SM * sms))))


def grouped_score_tiles(x_leaf, sq_leaf, tb, lens_t, qt, metric,
                        tile_m: int):
    """Exact per-slot distances of every tile: ``d f32[nt * tile_m, lmax]``.

    ``x_leaf f32 or bf16 [G, lmax, D]`` packed blocks, ``sq_leaf f32[G,
    lmax]`` slot squared norms, ``tb int32[nt]`` block row per tile,
    ``lens_t int32[nt]`` occupancy per tile, ``qt f32[nt * tile_m, D]``
    query rows in tile-slot order.  Slots at or past a tile's occupancy
    return +inf; rows of empty tile slots are junk that callers never
    read.  Block rows are clamped into ``[0, G)`` on the card, where
    kernel 1 scores every slot as a pair of the identity pair map (see
    :func:`grouped_score_pairs`).
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
    out = torch.empty((tb.shape[0] * tile_m, x_leaf.shape[1]),
                      dtype=torch.float32, device=x_leaf.device)
    if tb.shape[0] == 0:
        return out
    _launch_score(x_leaf, sq_leaf, tb, None, lens_t, None, qt, out, None,
                  tile_m, 1, metric)
    return out


def _check_pairs(x_leaf, sq_leaf, tb, tp, lens_t, slot, q, tile_m):
    g, lmax, d = x_leaf.shape
    nt, e = tb.shape[0], slot.shape[0]
    if tuple(sq_leaf.shape) != (g, lmax):
        raise ValueError(f"sq_leaf {tuple(sq_leaf.shape)} != {(g, lmax)}")
    if tuple(tp.shape) != (nt, tile_m):
        raise ValueError(f"tp {tuple(tp.shape)} != {(nt, tile_m)}")
    if tuple(lens_t.shape) != (nt,):
        raise ValueError(f"lens_t {tuple(lens_t.shape)} != {(nt,)}")
    if q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"q {tuple(q.shape)} must be [B, {d}]")
    if e and (q.shape[0] == 0 or e % q.shape[0]):
        raise ValueError(f"{e} pairs are not a whole number of probes for "
                         f"each of {q.shape[0]} queries")
    if g < 1:
        raise ValueError("x_leaf holds no blocks")


def _run_heads(tb, tp, lens_t, tile_m: int, sms: int = None):
    """``(head, pair)``: the tiles where kernel 1's runs start (see
    :func:`score_runs`), and the tiles that hold a pair in their first
    slot, each in the run of the latest head at or before it."""
    nt = tb.shape[0]
    t = torch.arange(nt, device=tb.device)
    pair = (torch.ones(nt, dtype=torch.bool, device=tb.device)
            if tp is None else tp[:, 0] >= 0)
    same = torch.zeros(nt, dtype=torch.bool, device=tb.device)
    same[1:] = pair[:-1] & (tb[1:] == tb[:-1]) & (lens_t[1:] == lens_t[:-1])
    fresh = pair & (~same | (t % range_tiles(nt, tile_m, sms) == 0))
    start = torch.cummax(torch.where(fresh, t, 0), 0).values
    head = pair & ((t - start) % max(1, _RUN_SLOTS // tile_m) == 0)
    return head, pair


def score_runs(tb, tp, lens_t, tile_m: int, sms: int = None):
    """The block stagings kernel 1 makes on these tables
    (``csrc/grouped_score.cu``): the runs, each one block's consecutive
    tiles (equal ``tb`` and ``lens_t``) of at most ``32 // tile_m`` (1 at
    least), that hold a pair in their first slot and a block with an
    occupied row; runs also break where a tile holds no pair and every
    :func:`range_tiles` tiles (a thread block's tiles; ``sms`` the SMs of
    the card, None for the plain versions).  ``tp`` None: the identity
    pair map.  An int64 device scalar."""
    head, _ = _run_heads(tb, tp, lens_t, tile_m, sms)
    return (head & (lens_t > 0)).sum()


def staged_bytes(tb, tp, lens_t, tile_m: int, lmax: int, d: int,
                 itemsize: int, sms: int = None):
    """The bytes kernel 1 copies into shared memory on these tables: for
    each run of :func:`score_runs`, its block's ``min(lens, lmax)``
    occupied rows of ``d`` elements of ``itemsize`` bytes once, and its
    pairs' f32 query rows once for every 128 of those rows.  An int64
    device scalar."""
    head, pair = _run_heads(tb, tp, lens_t, tile_m, sms)
    run = torch.cumsum(head.long(), 0) - 1
    per_tile = (torch.full_like(lens_t, tile_m, dtype=torch.int64)
                if tp is None else (tp >= 0).sum(1))
    pairs = torch.zeros(int(head.sum()), dtype=torch.int64,
                        device=tb.device).index_add_(0, run[pair],
                                                     per_tile[pair])
    rows = lens_t[head].long().clamp(0, lmax)
    tiles = (rows + _SLOT_TILE - 1) // _SLOT_TILE
    return ((rows * itemsize + pairs * tiles * 4) * d).sum()


@torch.no_grad()
def grouped_score_pairs_reference(x_leaf, sq_leaf, tb, tp, lens_t, slot, q,
                                  metric, tile_m: int, reads=None):
    """Plain torch version of :func:`grouped_score_pairs`: each chunk of
    tiles scored as :func:`grouped_score_tiles_reference` scores it, the
    query rows gathered through ``tp // p``, each pair's row put in its
    place; ``reads`` gains :func:`score_runs` and :func:`staged_bytes`."""
    _check_metric(metric)
    _check_float_blocks("grouped_score_pairs", x_leaf)
    _check_pairs(x_leaf, sq_leaf, tb, tp, lens_t, slot, q, tile_m)
    lmax = x_leaf.shape[1]
    nt, e = tb.shape[0], slot.shape[0]
    p = e // max(1, q.shape[0])
    out = torch.full((e, lmax), float("inf"), dtype=torch.float32,
                     device=x_leaf.device)
    for s in range(0, nt, _REF_CHUNK):
        c = min(_REF_CHUNK, nt - s)
        tps = tp[s:s + c].long()
        qm = q[torch.where(tps >= 0, tps // p, 0)]          # [c, m, D]
        dd = _tile_dists(x_leaf, sq_leaf, tb[s:s + c].long(),
                         lens_t[s:s + c], qm, metric)
        ok = tps >= 0
        out[tps[ok]] = dd[ok]
    if reads is not None:
        reads[0] += score_runs(tb, tp, lens_t, tile_m)
        reads[1] += staged_bytes(tb, tp, lens_t, tile_m, lmax, x_leaf.shape[2],
                                 x_leaf.element_size())
    return out


def grouped_score_pairs(x_leaf, sq_leaf, tb, tp, lens_t, slot, q, metric,
                        tile_m: int, reads=None):
    """Exact distances of every (query, probe) pair to its block's slots,
    scored by the tiles of the tile tables: ``d f32[B * P, lmax]``, row
    ``e`` pair ``e`` (query ``e // P``).

    ``x_leaf f32 or bf16 [G, lmax, D]``, ``sq_leaf f32[G, lmax]``; ``tb
    int32[nt]``, ``tp int32[nt, tile_m]``, ``lens_t int32[nt]`` and
    ``slot int64[B * P]`` as :func:`.grouped.tile_tables` gives them; ``q
    f32[B, D]`` the queries, read in place.  Slots at or past a block's
    occupancy and pairs in no tile (``slot >= nt * tile_m``: masked
    probes, capacity overflow) read +inf.  On the card kernel 1 stages
    each run of one block's tiles once (:func:`score_runs` with the card's
    SM count) and writes each pair's row in place; ``reads``, an
    ``int64[2]`` on its device or None, gains those stagings and the bytes
    they copy (:func:`staged_bytes`) with no read back.  Each launch counts on
    ``grouped_score_tiles.launches`` (bf16: ``launches_bf16``)."""
    _check_metric(metric)
    if x_leaf.device.type == "cpu":
        return grouped_score_pairs_reference(x_leaf, sq_leaf, tb, tp, lens_t,
                                             slot, q, metric, tile_m, reads)
    name = "grouped_score_pairs"
    _check_float_blocks(name, x_leaf)
    _check_cuda(name, tile_m, x_leaf=(x_leaf, x_leaf.dtype, 3),
                sq_leaf=(sq_leaf, torch.float32, 2), tb=(tb, torch.int32, 1),
                tp=(tp, torch.int32, 2), lens_t=(lens_t, torch.int32, 1),
                slot=(slot, torch.int64, 1), q=(q, torch.float32, 2),
                **({} if reads is None else
                   {"reads": (reads, torch.int64, 1)}))
    _check_pairs(x_leaf, sq_leaf, tb, tp, lens_t, slot, q, tile_m)
    if reads is not None and reads.numel() != 2:
        raise ValueError(f"reads must be int64[2], got {tuple(reads.shape)}")
    e = slot.shape[0]
    out = torch.empty((e, x_leaf.shape[1]), dtype=torch.float32,
                      device=x_leaf.device)
    if e == 0:
        return out
    _launch_score(x_leaf, sq_leaf, tb, tp, lens_t, slot, q, out, reads,
                  tile_m, e // q.shape[0], metric)
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
