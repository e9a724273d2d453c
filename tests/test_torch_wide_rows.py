"""The port's grouped path at wide rows on the CPU: a seeded forest of the
benchmark's Gaussian mixture at GIST-1M's 960 dimensions (ANN-Benchmarks
gist-960-euclidean), at 1,000 (not a multiple of 32, kernel 1's column
chunk) and at 3,000, served by ``knn_grouped`` on f32 blocks, checked and
not, against the benchmark's plain reference (``benchmark/reference``:
the same trees and probes rebuilt in plain torch, exact float64
distances).  Kernel 1's counters at these widths: its stagings and the
bytes they copy."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rptree_tpu_torch as rp
from benchmark import datagen
from benchmark.reference import check as rcheck
from benchmark.reference import forest as rforest
from rptree_tpu_torch.ops import grouped_kernel as gk
from rptree_tpu_torch.utils import profiling

N, T, DEPTH, MIN_LEAF, K = 6000, 4, 5, 128, 10
BUDGET, PROBES = 1, 8
# The factored f32 distance sq - 2 <q, x> + |q|^2 cancels norms of ~1,000
# down to squared distances of ~5 at these widths: the served distances
# read 4.0e-5 to 4.3e-5 from the exact ones at D 960 to 3,000 (the
# benchmark's sound runs up to 8.2e-5 at D 128), bf16 blocks ~1e-3.
DIST_ERR = 2e-4


def _cell(d, seed):
    """Rows, queries and projections from the seed, as the benchmark makes
    them (a mixture of 40 centers, sigma 0.15, queries a row plus half a
    sigma), and the forest built and packed in f32 blocks."""
    g = datagen.generator(seed, "cpu")
    x, q = datagen.mixture(g, N, d, 40, 0.15, 512, 0.5)
    r = datagen.projections(g, T, DEPTH, d, 0.34)
    f = rp.forest_batch(seed, DEPTH, MIN_LEAF, T, 0.34, x, device="cpu", r=r)
    f.pack_leaves()
    return x, q, r, f


@pytest.mark.parametrize("d", [960, 1000, 3000])
def test_wide_rows_match_the_plain_reference(d):
    x, q, r, f = _cell(d, 2 ** 33 + d)
    assert f._packed[0].shape[2] == d
    rf = rforest.build_forest(x, r, DEPTH, MIN_LEAF)
    want = rforest.answers(rf, x, q, K, BUDGET, PROBES)
    kw = dict(budget=BUDGET, probes=PROBES, selection="kernel", tile_m=8,
              chunk=256)
    for check in (True, False):
        dist, ids = f.knn_grouped(q, K, check=check, **kw)
        c = rcheck.compare(x, q, dist, ids, want)
        assert c["answers"] == q.shape[0]
        assert c["misses"] == 0 and c["holes"] == 0, (check, c)
        assert c["dist_err"] <= DIST_ERR, (check, c)
    # the tolerance is one that bf16 blocks, the nearest precision below,
    # fail
    f.pack_leaves(dtype=torch.bfloat16)
    dist, ids = f.knn_grouped(q, K, check=False, **kw)
    assert rcheck.compare(x, q, dist, ids, want)["dist_err"] > DIST_ERR


def test_wide_rows_count_their_staged_bytes():
    """Under a profiler at D 960, ``grouped.staged_bytes`` adds each
    chunk's :func:`staged_bytes` on its tile tables, beside its runs."""
    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import grouped as og

    x, q, _, f = _cell(960, 17)
    kw = dict(budget=BUDGET, probes=PROBES, tile_m=8, chunk=128)
    f.knn_grouped(q, K, **kw)
    with profile(activities=[ProfilerActivity.CPU]):
        f.knn_grouped(q, K, check=False, **kw)
    s = profiling.stats()
    lens = f._lens_global()
    nt = max(f._grouped_nt.values())
    lmax = f._packed[0].shape[1]
    runs = staged = 0
    for qc in q.split(128):
        gsel, lsel = fm._probe_pairs(f, qc, BUDGET, PROBES, K)
        tb, tp, _, _, lens_t = og.tile_tables(gsel, lsel, lens, 8, nt)
        runs += int(gk.score_runs(tb, tp, lens_t, 8))
        staged += int(gk.staged_bytes(tb, tp, lens_t, 8, lmax, 960, 4))
    assert s["grouped.block_reads"] == runs > 0
    assert s["grouped.staged_bytes"] == staged
    # every run copies its block's rows and its pairs' query rows at least
    assert staged >= (runs + s["grouped.pairs"]) * 960 * 4


def test_staged_bytes_past_a_slot_tile():
    """Blocks past 128 slots stage their pairs' query rows once for each
    128 of their rows; blocks with no occupied row stage nothing."""
    tile_m, lmax, d = 4, 300, 24
    tb = torch.tensor([0, 0, 1, 2, 2, 3], dtype=torch.int32)
    lens_t = torch.tensor([300, 300, 0, 129, 129, 5], dtype=torch.int32)
    tp = torch.tensor([[0, 1, 2, 3], [4, -1, -1, -1], [5, 6, -1, -1],
                       [7, 8, 9, 10], [11, -1, -1, -1], [-1, -1, -1, -1]],
                      dtype=torch.int32)
    want = ((300 * 4 + 5 * 3 * 4) + (129 * 4 + 5 * 2 * 4)) * d
    assert int(gk.staged_bytes(tb, tp, lens_t, tile_m, lmax, d, 4)) == want
    assert int(gk.score_runs(tb, tp, lens_t, tile_m)) == 2
    want16 = ((300 * 2 + 5 * 3 * 4) + (129 * 2 + 5 * 2 * 4)) * d
    assert int(gk.staged_bytes(tb, tp, lens_t, tile_m, lmax, d, 2)) == want16


def _staged_walk(tb, tp, lens_t, tile_m, range_tiles, lmax, d, itemsize):
    """Kernel 1's staged bytes by a plain walk over each thread block's
    tiles: a run's block rows once, its pairs' query rows once a 128
    rows."""
    run_tiles = max(1, 32 // tile_m)
    pairs_t = (tp >= 0).sum(1).tolist()
    tb, first, lens_t = tb.tolist(), tp[:, 0].tolist(), lens_t.tolist()
    runs = []      # [rows, pairs] of each run
    for t0 in range(0, len(tb), range_tiles):
        prev, k = None, 0
        for t in range(t0, min(t0 + range_tiles, len(tb))):
            if first[t] < 0:
                prev = None
                continue
            key = (tb[t], lens_t[t])
            k = k + 1 if key == prev else 0
            prev = key
            if k % run_tiles == 0:
                runs.append([min(max(lens_t[t], 0), lmax), 0])
            runs[-1][1] += pairs_t[t]
    return sum((rows * itemsize + pairs * -(-rows // 128) * 4) * d
               for rows, pairs in runs)


@pytest.mark.parametrize("tile_m", [1, 3, 8, 32])
@pytest.mark.parametrize("sms", [None, 2])
@pytest.mark.parametrize("lmax", [20, 300])
def test_staged_bytes_walk_the_tables(tile_m, sms, lmax):
    """Against a plain walk, with a hot block, masked probes, empty blocks
    and blocks past a slot tile (lmax 300)."""
    from rptree_tpu_torch.ops import grouped as og

    gen = torch.Generator().manual_seed(tile_m * 7 + lmax)
    g, b, p, d = 30, 200, 5, 12
    lens = torch.randint(0, lmax + 1, (g,), generator=gen, dtype=torch.int32)
    lens[1] = 0
    gsel = torch.randint(0, g, (b, p), generator=gen, dtype=torch.int32)
    gsel[:150, 0] = 3
    lsel = torch.where(torch.rand(b, p, generator=gen) < 0.15, -1, 1).int()
    need = int(og.tile_tables(gsel, lsel, lens, tile_m, 1)[2])
    tb, tp, _, _, lens_t = og.tile_tables(gsel, lsel, lens, tile_m, need + 9)
    rt = gk.range_tiles(tb.shape[0], tile_m, sms)
    for itemsize in (4, 2):
        want = _staged_walk(tb, tp, lens_t, tile_m, rt, lmax, d, itemsize)
        assert int(gk.staged_bytes(tb, tp, lens_t, tile_m, lmax, d, itemsize,
                                   sms)) == want > 0
