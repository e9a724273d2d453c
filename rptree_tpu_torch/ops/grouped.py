"""Query-grouped block-resident rerank (``rptree_tpu/ops/grouped.py``):
the XLA-form scorer ``grouped_distances`` and the kernel forms
``grouped_distances_kernel`` and ``grouped_topk_kernel``.

1. Flatten the batch's (query, probe) pairs and sort them by probed block.
2. Chop each equal-block run into tiles of at most ``tile_m`` pairs, so a
   tile references exactly one block.  Steps 1-2 are the tile tables,
   kernel 9 on the card (:func:`tile_tables`, ``csrc/tile_tables.cu``).
3. Score every tile against its block: in one launch of a tile kernel
   (:mod:`.grouped_kernel`), or, in the XLA form, as batched products of
   ``tile_chunk`` tiles at a time (the JAX package's einsum, here
   ``torch.bmm``), which serves every metric (``l2``, ``sql2``,
   ``cosine``, ``dot``, a callable) on f32, bf16, int8 and centered int8
   blocks and on shared rows (:func:`.shared.fetch_blocks`); ELL blocks
   take kernel 10 (:mod:`.ell_kernel`) for the XLA form's ELL step.  Each
   distinct probed block is read once per tile instead of once per pair.
4. Gather each pair's distance row back to its slot through the inverse
   permutation that rides the tile tables.

``grouped_topk_kernel`` scores the same tiles with kernel 4, which keeps
only each pair's ``kp`` nearest in-block candidates and their point ids.

Static shapes: the tile count ``sum_g ceil(c_g / tile_m)`` depends on the
data, so the tables take a capacity ``nt`` and report the tiles actually
``needed``; pairs beyond the capacity are masked (+inf).  Results are
exact whenever ``needed <= nt``, and the caller
(``RPForest.knn_grouped``) retries with a larger capacity when not.
"""

from __future__ import annotations

import functools
import struct
from typing import NamedTuple, Tuple

import torch

from .. import _cuda
from ..utils import profiling
from ..utils.profiling import region
from .build import ieee_fp32
from .ell_kernel import ell_score_tiles
from .grouped_kernel import (_int8_dots, _quantize_rows, grouped_score_tiles,
                             grouped_score_tiles_int8, grouped_score_topk)
from .rerank import distances_from_dots
from .shared import fetch_blocks
from .sparse import EllBlocks

__all__ = ["grouped_distances", "grouped_distances_kernel",
           "grouped_topk_kernel", "tile_tables", "tile_tables_reference"]

_BIG = 1 << 30  # sentinel block id for masked pairs (sorts to the end)
# The tile kernels sum each f32 dot in four FMA chains added as a tree; one
# chain over the whole row (a plain product's order) strays past 1e-4 from
# them on the clustered cell's small l2 distances, so the XLA form sums
# four partial products over quarters of the row the same way.
_PARTS = 4
# csrc/tile_tables.cu's pairs a block (kChunk), blocks g a segment of the
# c_g scan (kSeg) and the widest digit's bounds (kMinBits, kMaxBits): its
# digit plan and scratch layout follow from them (:func:`tile_tables_plan`,
# the rule the tests hold the kernel's algorithm to; the wrapper takes the
# scratch's length from the kernel library)
_TT_CHUNK, _TT_SEG, _TT_MIN_BITS, _TT_MAX_BITS = 2048, 4096, 8, 11
# kernel 9's widest digit: 11 bits (two passes to G 4,194,304) up to
# 524,288 pairs, 8 past them, where the wider digits' short runs spread
# the writes (chip_stages.py --turns --tune, PERF.md)
_TT_WIDE_PAIRS = 1 << 19


def table_digit_bits(n: int) -> int:
    """The widest digit kernel 9 sorts ``n`` pairs by on the card."""
    return _TT_MAX_BITS if n <= _TT_WIDE_PAIRS else _TT_MIN_BITS
_TT_INCL = 1 << 31  # a look-back word's flag: the inclusive prefix


@torch.no_grad()
def _tile_tables(gsel, lsel, tile_m: int, nt: int, with_slots=False):
    """Sort the batch's (query, probe) pairs by block id and chop
    equal-block runs into tiles of at most ``tile_m`` pairs.  Returns
    ``(tb int32[nt], tp int32[nt, tile_m], needed int32[])``: block id per
    tile, pair index per slot (-1 = empty slot), and the tiles actually
    needed.  Overflow pairs land in a trash tile ``nt`` that is sliced
    away.

    ``with_slots`` appends ``slot int64[b * p]``: each pair's flat tile
    slot ``tile * tile_m + row`` (``nt * tile_m`` for pairs in no tile:
    masked probes and capacity overflow), the inverse of ``tp``."""
    b, p = gsel.shape
    e = b * p
    dev = gsel.device
    g_flat = torch.where(lsel >= 0, gsel.long(), _BIG).reshape(e)
    g_s, pair_s = torch.sort(g_flat, stable=True)
    pos = torch.arange(e, device=dev)
    new = torch.ones(e, dtype=torch.bool, device=dev)
    new[1:] = g_s[1:] != g_s[:-1]
    seg_start = torch.cummax(torch.where(new, pos, 0), 0).values
    rank = pos - seg_start
    valid_s = g_s < _BIG
    tile_start = (new | (rank % tile_m == 0)) & valid_s
    tile_id = torch.cumsum(tile_start, 0) - 1
    needed = (tile_id[-1] + 1).to(torch.int32)
    ok = valid_s & (tile_id >= 0) & (tile_id < nt)
    tid = torch.where(ok, tile_id, nt)  # capacity overflow -> trash tile
    row = rank % tile_m
    tile_block = torch.zeros(nt + 1, dtype=torch.int32, device=dev)
    tile_block[tid] = torch.where(ok, g_s, 0).to(torch.int32)
    tile_pair = torch.full((nt + 1, tile_m), -1, dtype=torch.int32, device=dev)
    tile_pair[tid, row] = torch.where(ok, pair_s, -1).to(torch.int32)
    if not with_slots:
        return tile_block[:nt], tile_pair[:nt], needed
    slot = torch.empty(e, dtype=torch.int64, device=dev)
    slot[pair_s] = torch.where(ok, tile_id * tile_m + row, nt * tile_m)
    return tile_block[:nt], tile_pair[:nt], needed, slot


def tile_tables_reference(gsel, lsel, lens_of_block, tile_m: int, nt: int):
    """Plain torch version of :func:`tile_tables`: :func:`_tile_tables`
    and the gather of each tile's occupancy."""
    tb, tp, needed, slot = _tile_tables(gsel, lsel, tile_m, nt,
                                        with_slots=True)
    return tb, tp, needed, slot, lens_of_block[tb.long()].to(torch.int32)


class TablesPlan(NamedTuple):
    """Kernel 9's digit plan and scratch layout for ``n`` pairs over ``g``
    blocks (``csrc/tile_tables.cu`` ``plan_of``): ``passes`` LSD passes,
    pass p sorting ``bits[p]`` bits from ``shifts[p]`` (the key's
    ``max(1, bit_length(g - 1))`` bits split evenly over the fewest passes
    of at most ``max_bits``, by default :func:`table_digit_bits`);
    ``chunks`` of 2,048 pairs, a block each;
    ``segs`` segments of 4,096 blocks in the ``c_g`` scan; ``layout``
    each scratch region's ``(offset, int32s)`` in the kernel's order,
    ``length`` their sum."""

    passes: int
    shifts: Tuple[int, ...]
    bits: Tuple[int, ...]
    chunks: int
    segs: int
    layout: dict
    length: int


def tile_tables_plan(n: int, g: int, max_bits: int = None) -> TablesPlan:
    """:class:`TablesPlan` of ``n`` pairs over ``g`` blocks.  The regions:
    ``segstate`` (a state a segment of the ``c_g`` scan), ``flags`` (the
    later passes' look-back words: pass p's ``chunks * 2**bits[p]`` from
    ``chunks * sum(2**bits[1:p])``, chunk-major), ``counts`` (``c_g``) and
    ``done`` (the segments scanned), which the upsweep zeroes, then
    ``table`` (a row a chunk, a column a digit of every pass; the first
    pass's columns become each chunk's exclusive prefix), ``totals``, the
    int64 ``segagg``, ``seginc`` (8-byte aligned, two int32 an entry),
    ``base`` (int64 a block: its first sorted place << 32 | its first
    tile) and ``bufs`` (the keys and values between passes, two or four
    ``n``)."""
    if max_bits is None:
        max_bits = table_digit_bits(n)
    if not _TT_MIN_BITS <= max_bits <= _TT_MAX_BITS:
        raise ValueError(f"tile_tables: max_bits {max_bits} outside "
                         f"[{_TT_MIN_BITS}, {_TT_MAX_BITS}]")
    key_bits = max(1, (g - 1).bit_length())
    passes = -(-key_bits // max_bits)
    w = -(-key_bits // passes)
    bits = tuple(min(w, key_bits - w * p) for p in range(passes))
    shifts = tuple(w * p for p in range(passes))
    rows = sum(1 << b for b in bits)
    chunks = max(1, -(-n // _TT_CHUNK))
    segs = -(-g // _TT_SEG)
    sizes = (("segstate", segs), ("flags", chunks * (rows - (1 << bits[0]))),
             ("counts", g), ("done", 1), ("table", rows * chunks),
             ("totals", rows))
    layout, at = {}, 0
    for name, size in sizes:
        layout[name] = (at, size)
        at += size
    at += at & 1
    for name, size in (("segagg", 2 * segs), ("seginc", 2 * segs),
                       ("base", 2 * g), ("bufs", 2 * n * min(passes - 1, 2))):
        layout[name] = (at, size)
        at += size
    return TablesPlan(passes, shifts, bits, chunks, segs, layout, at)


@torch.no_grad()
def tile_tables_by_plan(gsel, lsel, lens_of_block, tile_m: int, nt: int,
                        max_bits: int = None):
    """Kernel 9's algorithm in plain torch (CPU): the plan's LSD passes
    over the valid pairs (masked ones are not sorted; they point at ``nt *
    tile_m``), each pair placed by its digit's start, its digit's count in
    earlier chunks (the table's prefix on the first pass, the look-back
    sum after it) and its rank in its chunk; then ``c_g`` scanned in
    segments of 4,096 blocks and each pair's tile and row from its sorted
    place.  Returns the five tables and the scratch as the kernel leaves
    it (``int64`` per layout entry; ``bufs`` the keys then values of every
    pass but the last; the first segment's ``segagg``, which the kernel
    never writes, 0)."""
    b, p = gsel.shape
    e, g = b * p, lens_of_block.shape[0]
    plan = tile_tables_plan(e, g, max_bits)
    scratch = torch.zeros(plan.length, dtype=torch.int64)

    def region(name):
        off, size = plan.layout[name]
        return scratch[off:off + size]

    key = torch.where(lsel.reshape(-1) >= 0,
                      gsel.reshape(-1).long().clamp(0, g - 1), -1)
    valid = key >= 0
    keys, vals = key[valid], torch.nonzero(valid).reshape(-1)
    counts = torch.bincount(keys, minlength=g)
    region("counts").copy_(counts)
    table = region("table").view(plan.chunks, -1)
    flags = region("flags")
    rows0 = 0
    for i, (shift, bits) in enumerate(zip(plan.shifts, plan.bits)):
        bins = 1 << bits
        # the upsweep's table: each chunk's digits of every pass, in pair
        # order; the first pass's rows then each chunk's exclusive prefix
        dig = (keys >> shift) & (bins - 1)
        up = torch.bincount(dig * plan.chunks + vals // _TT_CHUNK,
                            minlength=bins * plan.chunks).view(bins,
                                                               plan.chunks)
        table[:, rows0:rows0 + bins] = (up.cumsum(1) - up if i == 0
                                        else up).T
        region("totals")[rows0:rows0 + bins] = up.sum(1)
        # the pass's chunks: every pair's place in pair order on the first
        # pass, the earlier pass's output after it
        ch = (vals if i == 0 else torch.arange(keys.numel())) // _TT_CHUNK
        hist = torch.bincount(ch * bins + dig, minlength=plan.chunks * bins)
        hist = hist.reshape(plan.chunks, bins)
        if i > 0:  # the look-back words of the chunks that hold pairs
            ran = -(-keys.numel() // _TT_CHUNK)
            lo = plan.chunks * (rows0 - (1 << plan.bits[0]))
            flags[lo:lo + plan.chunks * bins].view(plan.chunks, bins)[:ran] \
                = hist.cumsum(0)[:ran] | _TT_INCL
        before = hist.cumsum(0) - hist
        dstart = hist.sum(0).cumsum(0) - hist.sum(0)
        order = torch.sort(ch * bins + dig, stable=True).indices
        grp = (ch * bins + dig)[order]
        rank = torch.empty_like(keys)
        rank[order] = torch.arange(keys.numel()) - torch.searchsorted(grp, grp)
        pos = dstart[dig] + before[ch, dig] + rank
        new_k, new_v = torch.empty_like(keys), torch.empty_like(vals)
        new_k[pos], new_v[pos] = keys, vals
        keys, vals = new_k, new_v
        if i < plan.passes - 1:
            off = plan.layout["bufs"][0] + 2 * e * (i & 1)
            scratch[off:off + keys.numel()] = keys
            scratch[off + e:off + e + keys.numel()] = vals
        rows0 += bins
    # c_g and ceil(c_g / tile_m), packed (pairs << 32) + tiles, scanned in
    # segments of 4,096 blocks: each block's first sorted place and tile
    packed = (counts << 32) + (counts + tile_m - 1) // tile_m
    first = packed.cumsum(0) - packed
    seg_total = torch.zeros(plan.segs, dtype=torch.int64).index_add_(
        0, torch.arange(g) // _TT_SEG, packed)
    region("segstate").fill_(2)
    region("done").fill_(plan.segs)
    for name, val in (("segagg", seg_total), ("seginc", seg_total.cumsum(0)),
                      ("base", first)):
        r = region(name).view(-1, 2)
        r[:, 0], r[:, 1] = val & 0xFFFFFFFF, val >> 32
    region("segagg")[:2] = 0  # the first segment publishes its prefix only
    needed = int(seg_total.sum() & 0xFFFFFFFF)
    # the last pass's output: each pair's tile and row
    rank = torch.arange(keys.numel()) - (first[keys] >> 32)
    tile = (first[keys] & 0xFFFFFFFF) + rank // tile_m
    row = rank % tile_m
    ok = tile < nt
    tb = torch.zeros(nt, dtype=torch.int32)
    tp = torch.full((nt * tile_m,), -1, dtype=torch.int32)
    slot = torch.full((e,), nt * tile_m, dtype=torch.int64)
    s = tile * tile_m + row
    tp[s[ok]] = vals[ok].to(torch.int32)
    slot[vals[ok]] = s[ok]
    head = ok & (row == 0)
    tb[tile[head]] = keys[head].to(torch.int32)
    lens_t = lens_of_block[tb.long()].to(torch.int32)
    return (tb, tp.view(nt, tile_m), torch.tensor(needed, dtype=torch.int32),
            slot, lens_t, scratch)


def _check_tables(gsel, lsel, lens_of_block, tile_m, nt):
    name = "tile_tables"
    if gsel.dim() != 2 or lsel.shape != gsel.shape:
        raise ValueError(f"{name}: gsel and lsel must be [B, P] alike, got "
                         f"{tuple(gsel.shape)} and {tuple(lsel.shape)}")
    if lens_of_block.dim() != 1 or lens_of_block.shape[0] < 1:
        raise ValueError(f"{name}: lens_of_block must be [G >= 1], got "
                         f"{tuple(lens_of_block.shape)}")
    if tile_m < 1 or nt < 0:
        raise ValueError(f"{name}: tile_m {tile_m} < 1 or nt {nt} < 0")
    if gsel.numel() >= 1 << 31:
        raise ValueError(f"{name}: {gsel.numel()} pairs; int32 ids hold "
                         f"fewer than 2**31")


# The C entry point's arguments, an int64 each in their order
# (csrc/tile_tables.cu rpt_tile_tables): gsel, lsel, lens, tb, tp, slot,
# lens_t, needed, tally, scratch, scratch_len, n, g, nt, tile_m, max_bits,
# stream
_TABLES_ARGS = struct.Struct("17q")


@functools.lru_cache(maxsize=256)
def _tables_scratch(n: int, g: int, max_bits: int) -> int:
    """The int32s of kernel 9's scratch for ``n`` pairs over ``g`` blocks
    (``csrc/tile_tables.cu`` ``rpt_tile_tables_scratch``)."""
    return _cuda.lib().rpt_tile_tables_scratch(n, g, max_bits)


def _tables_buffers(dev, e, nt, tile_m):
    """Kernel 9's five outputs as views of one int32 allocation, cut by
    one ``split``: ``(tb, tp, needed, slot, lens_t)``; ``slot`` first, so
    it is 8-byte aligned."""
    slot, tb, lens_t, tp, needed = torch.empty(
        2 * e + nt * (tile_m + 2) + 1, dtype=torch.int32,
        device=dev).split([2 * e, nt, nt, nt * tile_m, 1])
    return (tb, tp.view(nt, tile_m), needed.view(()), slot.view(torch.int64),
            lens_t)


def tile_tables(gsel, lsel, lens_of_block, tile_m: int, nt: int):
    """The tile tables of a chunk's pairs (kernel 9 on the card,
    ``csrc/tile_tables.cu``): ``(tb int32[nt], tp int32[nt, tile_m],
    needed int32[], slot int64[B * P], lens_t int32[nt])``, bit-equal to
    :func:`tile_tables_reference`.

    ``gsel``/``lsel int32[B, P]``: each pair's block and leaf (-1 =
    masked); ``lens_of_block int32[G]``: occupancy per block.  Tiles hold
    the runs of one block's pairs in ascending pair order, ``tile_m`` at
    a time, blocks in ascending order: ``tb`` is each tile's block, ``tp``
    its pairs (-1 for an empty slot), ``needed`` the tiles the pairs need
    (a device scalar, never read back here), ``slot`` each pair's flat
    tile slot (``nt * tile_m`` for a masked pair and one past the
    capacity), ``lens_t`` each tile's occupancy ``lens_of_block[tb]``.
    Tiles past ``needed`` hold block 0 and no pair.  On the card block
    ids outside ``[0, G)`` are clamped into it, and the five tables are
    views of one allocation.  While a profiler runs, the chunk adds its
    valid pairs, its tiles needed past ``nt`` and its ``nt * tile_m``
    slots to the grouped layer's counters (``profiling.grouped_counts``;
    kernel 9 adds the first two itself)."""
    with region("rpt_tile_tables"):
        tally = profiling.grouped_counts(gsel.device, int(nt) * int(tile_m))
        if gsel.device.type != "cpu":
            return _tables_on_card(gsel, lsel, lens_of_block, tile_m, nt,
                                   tally=tally)
        out = tile_tables_reference(gsel, lsel, lens_of_block, tile_m, nt)
        if tally is not None:
            tally += torch.stack(((lsel >= 0).sum(),
                                   (out[2].long() - int(nt)).clamp(min=0)))
        return out


def _tables_on_card(gsel, lsel, lens_of_block, tile_m, nt, max_bits=None,
                    tally=None):
    """:func:`tile_tables` on the card with digits of at most
    ``max_bits`` (None: :func:`table_digit_bits`'s; the tests and the chip
    scripts run the other plan through it).  ``tally``, an ``int64[2]``
    on the card or None, gains the chunk's valid pairs and its tiles
    needed past ``nt``."""
    tile_m, nt = int(tile_m), int(nt)
    _check_tables(gsel, lsel, lens_of_block, tile_m, nt)
    dev = gsel.device
    _cuda.check_operands("tile_tables", dev, ("gsel", gsel, torch.int32),
                         ("lsel", lsel, torch.int32),
                         ("lens_of_block", lens_of_block, torch.int32))
    e, g = gsel.numel(), lens_of_block.shape[0]
    if tally is not None:
        _cuda.check_operands("tile_tables", dev, ("tally", tally, torch.int64))
    if max_bits is None:
        max_bits = table_digit_bits(e)
    length = _tables_scratch(e, g, max_bits)
    if length < 0:
        raise ValueError(f"tile_tables: max_bits {max_bits} outside "
                         f"[{_TT_MIN_BITS}, {_TT_MAX_BITS}]")
    tb, tp, needed, slot, lens_t = _tables_buffers(dev, e, nt, tile_m)
    # the scratch apart from the outputs, so that it returns to the
    # allocator when the call does
    scratch = torch.empty(length, dtype=torch.int32, device=dev)
    with _cuda.on(dev):
        code = _cuda.lib().rpt_tile_tables(_TABLES_ARGS.pack(
            gsel.data_ptr(), lsel.data_ptr(), lens_of_block.data_ptr(),
            tb.data_ptr(), tp.data_ptr(), slot.data_ptr(), lens_t.data_ptr(),
            needed.data_ptr(),
            0 if tally is None else tally.data_ptr(), scratch.data_ptr(),
            length, e, g, nt, tile_m, max_bits, _cuda.raw_stream(dev)))
    _cuda.check(code, "tile_tables")
    tile_tables.launches += 1
    return tb, tp, needed, slot, lens_t


tile_tables.launches = 0


def _tile_operands(gsel, lsel, lens_of_block, tile_m, nt):
    """Tile tables of a chunk's pairs and the kernels' query-row index:
    ``(tb, lens_t, qi, needed, inv)``, with ``qi int64[nt * tile_m]`` the
    query of each tile slot (``q[qi]``, the query rows in tile-slot order,
    is gathered in the ``rpt_grouped_score`` region) and ``inv`` each
    pair's flat tile slot."""
    p = gsel.shape[1]
    tb, tp, needed, inv, lens_t = tile_tables(gsel, lsel, lens_of_block,
                                              tile_m, nt)
    qi = torch.where(tp >= 0, tp // p, 0).reshape(-1).long()
    return tb, lens_t, qi, needed, inv


def _pair_rows(rows, inv, fill, b, p):
    """Pair reorder: each pair's tile-slot row of ``rows [nt * tile_m,
    w]``, with pairs in no tile reading a pad row of ``fill`` (the
    ``rpt_pair_reorder`` region)."""
    with region("rpt_pair_reorder"):
        pad = torch.full((1, rows.shape[1]), fill, dtype=rows.dtype,
                         device=rows.device)
        return torch.cat([rows, pad])[inv].reshape(b, p, rows.shape[1])


def _float_dots(qr, blk):
    """``qr [c, m, D] x blk [c, L, D]`` dots ``[c, m, L]``: one IEEE-fp32
    product per quarter of the row, added as ``(p0 + p1) + (p2 + p3)``."""
    p = [torch.bmm(a, b.transpose(1, 2)) for a, b in
         zip(qr.tensor_split(_PARTS, -1), blk.tensor_split(_PARTS, -1))]
    return (p[0] + p[1]) + (p[2] + p[3])


@torch.no_grad()
def grouped_distances(x_leaf, sq_leaf, lens_of_block, gsel, lsel, q, metric,
                      tile_m: int, nt: int, tile_chunk: int, block_scale=None,
                      block_center=None):
    """Exact distances of every (query, probe) pair, computed block-major
    as batched products (the JAX package's XLA form, which serves every
    metric and block type; :func:`grouped_distances_kernel` is the tile
    kernels' form).

    Args:
      x_leaf/sq_leaf: packed blocks ``f32, bf16 or int8 [G, lmax, D]`` (or
        :class:`.shared.SharedRows`, or :class:`.sparse.EllBlocks`, scored
        by kernel 10 for the builtin metrics) and ``f32[G, lmax]`` slot
        squared norms.
      lens_of_block: ``int32[G]`` occupancy per block.
      gsel/lsel: probe selection ``int32[B, P]`` (block id / leaf id, -1 =
        masked) from ``_select_probes``.
      q: ``f32[B, D]`` queries.
      metric: ``l2``, ``sql2``, ``cosine``, ``dot``, or a callable
        ``distf(rows[..., L, D], q[..., 1, D]) -> [..., L]`` of torch
        operations, given the block rows as f32 (not on int8 blocks).
      tile_m: pairs per tile.
      nt: tile capacity.
      tile_chunk: tiles scored a step (bounds the gathered blocks'
        memory); the last step may be shorter.
      block_scale: ``f32[G]`` per-block scales of int8 blocks.
      block_center: ``(mu f32[G, D], mudr f32[G, lmax])`` of centered int8
        blocks, else None.

    f32 blocks are multiplied in IEEE fp32 (never TF32), bf16 blocks
    against the query rows rounded to bf16 (exact products, fp32 sums),
    int8 blocks against the rows quantized per row (exact integer dots,
    then ``dots * block scale * row scale``); on centered blocks each
    query row less the block's mean is quantized and the dot is ``q . mu
    + mudr + dots * block scale * row scale``.

    Returns ``(d f32[B, P, lmax], needed int32[])``: masked slots (invalid
    probes, occupancy padding, capacity overflow) carry +inf.
    """
    b, p = gsel.shape
    lmax = x_leaf.shape[1]
    if isinstance(x_leaf, EllBlocks):
        return _grouped_ell(x_leaf, sq_leaf, lens_of_block, gsel, lsel, q,
                            metric, tile_m, nt, tile_chunk)
    int8 = x_leaf.dtype == torch.int8
    if callable(metric) and int8:
        raise NotImplementedError(
            "custom distance callables are unsupported on int8-quantized "
            "blocks (pack with f32/bf16)")
    tb, tp, needed, inv, lens_t = tile_tables(gsel, lsel, lens_of_block,
                                              tile_m, nt)
    step = max(1, int(tile_chunk))
    col = torch.arange(lmax, device=q.device)
    d_all = torch.empty((nt * tile_m, lmax), dtype=torch.float32,
                        device=q.device)
    with region("rpt_grouped_score"), ieee_fp32():
        for s in range(0, nt, step):
            c = min(step, nt - s)
            rows = tb[s:s + c].long()
            tp_i = tp[s:s + c]
            qt = q[torch.where(tp_i >= 0, tp_i // p, 0).long()]  # [c, m, D]
            blk = fetch_blocks(x_leaf, rows)                      # [c, L, D]
            if callable(metric):
                d = metric(blk.float()[:, None].expand(
                    c, tile_m, lmax, blk.shape[-1]), qt[:, :, None, :])
            else:
                if int8 and block_center is not None:
                    mu = block_center[0][rows]                    # [c, D]
                    qc_i8, qscale = _quantize_rows(qt - mu[:, None, :])
                    dots = ((qt * mu[:, None, :]).sum(-1)[..., None]
                            + block_center[1][rows][:, None, :]
                            + _int8_dots(qc_i8, blk)
                            * block_scale[rows][:, None, None] * qscale)
                elif int8:
                    q_i8, qscale = _quantize_rows(qt)
                    dots = (_int8_dots(q_i8, blk)
                            * block_scale[rows][:, None, None] * qscale)
                else:  # f32; bf16: the rows rounded, products exact
                    dots = _float_dots(qt.to(x_leaf.dtype).float(),
                                       blk.float())
                d = distances_from_dots(dots, sq_leaf[rows][:, None, :], qt,
                                        metric)
            valid = (tp_i >= 0)[:, :, None] & (
                col < lens_t[s:s + c, None, None])
            d_all[s * tile_m:(s + c) * tile_m] = torch.where(
                valid, d, float("inf")).reshape(c * tile_m, lmax)
    return _pair_rows(d_all, inv, float("inf"), b, p), needed


def _grouped_ell(blocks, sq_leaf, lens_of_block, gsel, lsel, q, metric,
                 tile_m, nt, tile_chunk):
    """:func:`grouped_distances` on ELL blocks: the tile tables, then every
    tile scored by :func:`.ell_kernel.ell_score_tiles` (kernel 10 on the
    card, reading the query rows in place; its plain version, the XLA
    form's gather, on the CPU)."""
    b, p = gsel.shape
    tb, tp, needed, inv, lens_t = tile_tables(gsel, lsel, lens_of_block,
                                              tile_m, nt)
    with region("rpt_grouped_score"):
        d_all = ell_score_tiles(blocks, sq_leaf, tb, tp, lens_t, q,
                                (q * q).sum(-1), p, metric, tile_chunk)
    return _pair_rows(d_all, inv, float("inf"), b, p), needed


@torch.no_grad()
def grouped_distances_kernel(x_leaf, sq_leaf, lens_of_block, gsel, lsel, q,
                             metric, tile_m: int, nt: int, block_scale=None):
    """Exact distances of every (query, probe) pair, computed block-major
    by the tile kernels.

    Args:
      x_leaf/sq_leaf: packed blocks ``f32, bf16 or int8 [G, lmax, D]`` and
        ``f32[G, lmax]`` slot squared norms.
      lens_of_block: ``int32[G]`` occupancy per block.
      gsel/lsel: probe selection ``int32[B, P]`` (block id / leaf id, -1 =
        masked) from ``_select_probes``.
      q: ``f32[B, D]`` queries.
      tile_m: pairs per tile.
      nt: tile capacity.
      block_scale: ``f32[G]`` per-block scales of int8 blocks.

    Returns ``(d f32[B, P, lmax], needed int32[])``: masked slots (invalid
    probes, occupancy padding, capacity overflow) carry +inf.
    """
    b, p = gsel.shape
    tb, lens_t, qi, needed, inv = _tile_operands(gsel, lsel, lens_of_block,
                                                 tile_m, nt)
    with region("rpt_grouped_score"):
        qt = q[qi]
        if x_leaf.dtype == torch.int8:
            d_all = grouped_score_tiles_int8(x_leaf, sq_leaf, block_scale,
                                             tb, lens_t, qt, metric, tile_m)
        else:
            d_all = grouped_score_tiles(x_leaf, sq_leaf, tb, lens_t, qt,
                                        metric, tile_m)
    return _pair_rows(d_all, inv, float("inf"), b, p), needed


@torch.no_grad()
def grouped_topk_kernel(x_leaf, sq_leaf, id_leaf, lens_of_block, gsel, lsel,
                        q, metric, tile_m: int, nt: int, kp: int):
    """Each (query, probe) pair's ``kp`` nearest in-block candidates, by
    the same tiling as :func:`grouped_distances_kernel` and kernel 4
    (:func:`..grouped_kernel.grouped_score_topk`); f32 or bf16 blocks.
    Exact for the final per-query top-k whenever ``kp >= k``.

    Returns ``(d f32[B, P, kp], ids int32[B, P, kp], needed int32[])``:
    masked and overflow pairs carry ``(+inf, -1)``.
    """
    b, p = gsel.shape
    tb, lens_t, qi, needed, inv = _tile_operands(gsel, lsel, lens_of_block,
                                                 tile_m, nt)
    with region("rpt_grouped_score"):
        d_all, i_all = grouped_score_topk(x_leaf, sq_leaf, id_leaf, tb,
                                          lens_t, q[qi], metric, tile_m, kp)
    return (_pair_rows(d_all, inv, float("inf"), b, p),
            _pair_rows(i_all, inv, -1, b, p), needed)
