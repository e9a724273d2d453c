"""Query-grouped block-resident rerank (``rptree_tpu/ops/grouped.py``, the
kernel forms ``grouped_distances_kernel`` and ``grouped_topk_kernel``;
the XLA-form ``grouped_distances`` is not ported).

1. Flatten the batch's (query, probe) pairs and sort them by probed block.
2. Chop each equal-block run into tiles of at most ``tile_m`` pairs, so a
   tile references exactly one block.
3. Score every tile against its block in one kernel launch
   (:mod:`.grouped_kernel`): each distinct probed block is read once per
   tile instead of once per pair.
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

import torch

from .grouped_kernel import (grouped_score_tiles, grouped_score_tiles_int8,
                             grouped_score_topk)

__all__ = ["grouped_distances_kernel", "grouped_topk_kernel"]

_BIG = 1 << 30  # sentinel block id for masked pairs (sorts to the end)


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


def _tile_operands(gsel, lsel, lens_of_block, q, tile_m, nt):
    """Tile tables and kernel operands of a chunk's pairs: ``(tb, lens_t,
    qt, needed, inv)``, with ``qt f32[nt * tile_m, D]`` the query rows in
    tile-slot order and ``inv`` each pair's flat tile slot."""
    p = gsel.shape[1]
    tb, tp, needed, inv = _tile_tables(gsel, lsel, tile_m, nt,
                                       with_slots=True)
    lens_t = lens_of_block[tb.long()].to(torch.int32)
    qi = torch.where(tp >= 0, tp // p, 0).reshape(-1).long()
    return tb, lens_t, q[qi], needed, inv


def _pair_rows(rows, inv, fill, b, p):
    """Pair reorder: each pair's tile-slot row of ``rows [nt * tile_m,
    w]``, with pairs in no tile reading a pad row of ``fill``."""
    pad = torch.full((1, rows.shape[1]), fill, dtype=rows.dtype,
                     device=rows.device)
    return torch.cat([rows, pad])[inv].reshape(b, p, rows.shape[1])


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
    tb, lens_t, qt, needed, inv = _tile_operands(gsel, lsel, lens_of_block,
                                                 q, tile_m, nt)
    if x_leaf.dtype == torch.int8:
        d_all = grouped_score_tiles_int8(x_leaf, sq_leaf, block_scale, tb,
                                         lens_t, qt, metric, tile_m)
    else:
        d_all = grouped_score_tiles(x_leaf, sq_leaf, tb, lens_t, qt, metric,
                                    tile_m)
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
    tb, lens_t, qt, needed, inv = _tile_operands(gsel, lsel, lens_of_block,
                                                 q, tile_m, nt)
    d_all, i_all = grouped_score_topk(x_leaf, sq_leaf, id_leaf, tb, lens_t,
                                      qt, metric, tile_m, kp)
    return (_pair_rows(d_all, inv, float("inf"), b, p),
            _pair_rows(i_all, inv, -1, b, p), needed)
