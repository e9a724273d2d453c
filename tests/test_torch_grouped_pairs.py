"""Kernel 1's pair-addressed form (``ops/grouped_kernel.py``
``grouped_score_pairs``) on the CPU: its plain version against the
slot-order composition it replaces on the serving path (the query rows
gathered into tile-slot order, ``grouped_score_tiles_reference``, then
the pair reorder), bit for bit; the block stagings it counts
(``score_runs``) against a plain walk of the tables; and the serving
path's ``grouped_distances_kernel`` and its counter."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rptree_tpu_torch as rp
from rptree_tpu_torch.ops import grouped as og
from rptree_tpu_torch.ops import grouped_kernel as gk
from rptree_tpu_torch.utils import profiling


def _pairs(seed, g, lmax, d, b, p, hot=40):
    """Blocks (some empty), queries, and pairs with masked probes and a
    hot block probed by ``hot`` queries."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(g, lmax, d, generator=gen)
    sq = (x * x).sum(-1)
    lens = torch.randint(1, lmax + 1, (g,), generator=gen, dtype=torch.int32)
    lens[1] = 0
    lens[2] = lmax
    q = torch.randn(b, d, generator=gen)
    gsel = torch.randint(0, g, (b, p), generator=gen, dtype=torch.int32)
    gsel[:hot, 0] = 3
    gsel[5, 1] = 1                       # a probe of an empty block
    lsel = torch.ones(b, p, dtype=torch.int32)
    lsel[torch.rand(b, p, generator=gen) < 0.15] = -1
    return x, sq, lens, q, gsel, lsel


def _composition(x, sq, q, tables, metric, tile_m, b, p):
    """The slot-order path: ``q[qi]``, the tile scoring, the reorder."""
    tb, tp, _, slot, lens_t = tables
    qi = torch.where(tp >= 0, tp // p, 0).reshape(-1).long()
    rows = gk.grouped_score_tiles_reference(x, sq, tb, lens_t, q[qi], metric,
                                            tile_m)
    return og._pair_rows(rows, slot, float("inf"), b, p)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("cap", ["spare", "overflow"])
@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_m", [1, 8, 16, 32])
def test_pairs_plain_bit_equal_to_the_composition(tile_m, dtype, metric, cap):
    """Masked probes, a hot block of 40 pairs, an empty block, and a
    capacity past the tiles needed (tiles with no pair) or below them
    (overflow pairs +inf)."""
    g, lmax, d, b, p = 30, 20, 12, 64, 5
    x, sq, lens, q, gsel, lsel = _pairs(tile_m, g, lmax, d, b, p)
    x = x.to(dtype)
    need = int(og.tile_tables(gsel, lsel, lens, tile_m, 1)[2])
    nt = need + need // 2 + 3 if cap == "spare" else need // 2
    tables = og.tile_tables(gsel, lsel, lens, tile_m, nt)
    tb, tp, _, slot, lens_t = tables
    want = _composition(x, sq, q, tables, metric, tile_m, b, p)
    got = gk.grouped_score_pairs(x, sq, tb, tp, lens_t, slot, q, metric,
                                 tile_m)
    assert got.shape == (b * p, lmax)
    assert torch.equal(_bits(got), _bits(want.reshape(b * p, lmax)))
    inf_rows = torch.isinf(got).all(1)
    assert bool(inf_rows[slot >= nt * tile_m].all())
    if cap == "overflow":
        assert bool((slot[lsel.reshape(-1) >= 0] >= nt * tile_m).any())
    else:
        assert bool((tp[need:] < 0).all())


def _runs_walk(tb, tp, lens_t, tile_m, range_tiles):
    """Kernel 1's runs by a plain walk over each thread block's tiles."""
    run_tiles = max(1, 32 // tile_m)
    tb, tp, lens_t = tb.tolist(), tp[:, 0].tolist(), lens_t.tolist()
    runs = 0
    for t0 in range(0, len(tb), range_tiles):
        prev, k = None, 0
        for t in range(t0, min(t0 + range_tiles, len(tb))):
            if tp[t] < 0:
                prev = None
                continue
            key = (tb[t], lens_t[t])
            k = k + 1 if key == prev else 0
            prev = key
            if k % run_tiles == 0 and lens_t[t] > 0:
                runs += 1
    return runs


@pytest.mark.parametrize("tile_m", [1, 3, 8, 16, 32])
@pytest.mark.parametrize("cap", ["spare", "overflow"])
@pytest.mark.parametrize("sms", [None, 2, 132])
def test_score_runs_walk_the_tables(tile_m, cap, sms):
    """Whole ranges (``sms`` None), and ranges shrunk for a card of 2 or
    132 SMs, where the tiles give under four waves of thread blocks."""
    g, lmax, d, b, p = 30, 20, 12, 200, 5
    _, _, lens, _, gsel, lsel = _pairs(7, g, lmax, d, b, p, hot=150)
    need = int(og.tile_tables(gsel, lsel, lens, tile_m, 1)[2])
    nt = need + 9 if cap == "spare" else need // 2
    tb, tp, _, _, lens_t = og.tile_tables(gsel, lsel, lens, tile_m, nt)
    rt = gk.range_tiles(nt, tile_m, sms)
    cap_tiles = min(32, max(1, 256 // tile_m))
    assert rt == (cap_tiles if sms is None else
                  max(1, min(cap_tiles, -(-nt // (8 * sms)))))
    want = _runs_walk(tb, tp, lens_t, tile_m, rt)
    assert int(gk.score_runs(tb, tp, lens_t, tile_m, sms)) == want
    # the identity pair map: every tile holds pairs
    assert int(gk.score_runs(tb, None, lens_t, tile_m, sms)) == _runs_walk(
        tb, torch.zeros_like(tp), lens_t, tile_m, rt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nt", [None, 7])
def test_grouped_distances_kernel_unchanged(dtype, nt):
    """The serving path's scorer gives the slot-order composition's bits,
    its capacity overflow included."""
    g, lmax, d, b, p, tile_m = 25, 16, 10, 40, 6, 4
    x, sq, lens, q, gsel, lsel = _pairs(3, g, lmax, d, b, p, hot=20)
    x = x.to(dtype)
    if nt is None:
        nt = int(og.tile_tables(gsel, lsel, lens, tile_m, 1)[2]) + 5
    for metric in ("l2", "sql2"):
        got, need = og.grouped_distances_kernel(x, sq, lens, gsel, lsel, q,
                                                metric, tile_m, nt)
        tables = og.tile_tables(gsel, lsel, lens, tile_m, nt)
        want = _composition(x, sq, q, tables, metric, tile_m, b, p)
        assert int(need) == int(tables[2])
        assert torch.equal(_bits(got), _bits(want))


def test_block_reads_count_the_runs():
    """Under a profiler ``grouped.block_reads`` adds each chunk's runs,
    and ``grouped.pairs`` over it is the pairs a block staging serves."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(1500, 8, generator=gen)
    q = x[:96] + 0.1 * torch.randn(96, 8, generator=gen)
    f = rp.forest_batch(4, 5, 24, 3, 1.0, x, device="cpu")
    f.pack_leaves(slack=4)
    f.knn_grouped(q, 5, budget=2, chunk=32, tile_m=4)
    with profile(activities=[ProfilerActivity.CPU]):
        f.knn_grouped(q, 5, budget=2, chunk=32, tile_m=4, check=False)
    s = profiling.stats()
    from rptree_tpu_torch.models import forest as fm

    want = 0
    lens = f._lens_global()
    nt = max(f._grouped_nt.values())
    for qc in q.split(32):
        gsel, lsel = fm._probe_pairs(f, qc, 2, f.n_trees * 2, 5)
        tb, tp, _, _, lens_t = og.tile_tables(gsel, lsel, lens, 4, nt)
        want += int(gk.score_runs(tb, tp, lens_t, 4))
    assert s["grouped.block_reads"] == want > 0
    assert s["grouped.pairs"] >= s["grouped.block_reads"]
