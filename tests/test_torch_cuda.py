"""The port's CUDA kernels against their plain torch versions on the card.

These tests need a CUDA device and skip without one.  This file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch (pass ``--noconftest`` there, since ``tests/conftest.py``
sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rptree_tpu_torch.ops import fused_gather as fg
from rptree_tpu_torch.ops import grouped_kernel as gk
from rptree_tpu_torch.ops import scan as sc
from rptree_tpu_torch.ops import topk_kernel as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _tiles(dev, g, lmax, d, nt, tile_m, int8, seed=0, bf16=False):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(g, lmax, d, generator=gen)
    sq = (x * x).sum(-1)
    tb = torch.randint(0, g, (nt,), generator=gen, dtype=torch.int32)
    tb[: nt // 3] = tb[0]
    lens = torch.randint(0, lmax + 1, (nt,), generator=gen,
                         dtype=torch.int32)
    qt = torch.randn(nt * tile_m, d, generator=gen)
    scale = None
    if bf16:
        x = x.bfloat16()
    if int8:
        scale = x.abs().amax(dim=(1, 2)) * gk.INV_127
        x = torch.round(x / scale[:, None, None]).clamp(-127, 127).to(
            torch.int8)
        scale = scale.to(dev)
    return x.to(dev), sq.to(dev), scale, tb.to(dev), lens.to(dev), qt.to(dev)


def _close(got, want, rtol=1e-4):
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs() / want[fin].abs().clamp_min(1.0)
    assert err.numel() == 0 or float(err.max()) <= rtol


@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,nt,tile_m", [
    (50, 128, 128, 300, 8), (7, 24, 20, 33, 3), (9, 40, 130, 17, 16),
    (5, 8, 1, 4, 32), (5, 33, 7, 20, 1), (4, 300, 20, 9, 3),
])
def test_f32_tiles(dev, metric, g, lmax, d, nt, tile_m):
    x, sq, _, tb, lens, qt = _tiles(dev, g, lmax, d, nt, tile_m, False)
    before = gk.grouped_score_tiles.launches
    got = gk.grouped_score_tiles(x, sq, tb, lens, qt, metric, tile_m)
    assert gk.grouped_score_tiles.launches == before + 1
    want = gk.grouped_score_tiles_reference(x, sq, tb, lens, qt, metric,
                                            tile_m)
    torch.cuda.synchronize()
    _close(got, want)
    # blocks 4-byte aligned take the plain staging loads, to the same bits
    xo = _misaligned(x)
    assert torch.equal(gk.grouped_score_tiles(xo, sq, tb, lens, qt, metric,
                                              tile_m), got)


def _misaligned(x):
    """A copy of ``x`` one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    xo = buf[1:].view(x.shape)
    xo.copy_(x)
    return xo


@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,nt,tile_m", [
    (50, 128, 128, 300, 8), (7, 24, 20, 33, 3), (9, 40, 131, 17, 16),
    (5, 8, 1, 4, 32), (5, 33, 7, 20, 1), (4, 300, 20, 9, 3),
])
def test_bf16_tiles(dev, metric, g, lmax, d, nt, tile_m):
    x, sq, _, tb, lens, qt = _tiles(dev, g, lmax, d, nt, tile_m, False,
                                    bf16=True)
    before = (gk.grouped_score_tiles.launches,
              gk.grouped_score_tiles.launches_bf16)
    got = gk.grouped_score_tiles(x, sq, tb, lens, qt, metric, tile_m)
    assert (gk.grouped_score_tiles.launches,
            gk.grouped_score_tiles.launches_bf16) == (before[0],
                                                      before[1] + 1)
    want = gk.grouped_score_tiles_reference(x, sq, tb, lens, qt, metric,
                                            tile_m)
    torch.cuda.synchronize()
    _close(got, want)
    # blocks 2-byte aligned take the plain staging loads, to the same bits
    xo = _misaligned(x)
    assert torch.equal(gk.grouped_score_tiles(xo, sq, tb, lens, qt, metric,
                                              tile_m), got)


def _topk_case(dev, g, lmax, d, nt, tile_m, bf16, seed):
    x, sq, _, tb, lens, qt = _tiles(dev, g, lmax, d, nt, tile_m, False,
                                    seed=seed, bf16=bf16)
    x[0, 1::2] = x[0, ::2][: lmax // 2]          # duplicated rows
    sq[0, 1::2] = sq[0, ::2][: lmax // 2]
    tb[0], lens[0] = 0, lmax
    lens[1] = 0                                  # an empty tile
    lens[2] = 1                                  # one occupied slot
    ids = torch.randint(0, 1 << 20, (g, lmax), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(seed))
    return x, sq, ids.to(dev), tb, lens, qt


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,nt,tile_m,kp", [
    (50, 128, 128, 300, 8, 16), (7, 24, 20, 33, 3, 12), (9, 40, 130, 17, 16, 8),
    (5, 16, 8, 9, 32, 8), (6, 256, 64, 40, 8, 128), (4, 8, 4, 5, 1, 1),
    (5, 40, 7, 11, 32, 16), (4, 130, 130, 6, 1, 128), (3, 300, 20, 7, 3, 100),
    (4, 200, 20, 9, 8, 32), (5, 100, 24, 9, 8, 64),
])
def test_topk_tiles(dev, bf16, metric, g, lmax, d, nt, tile_m, kp):
    x, sq, ids, tb, lens, qt = _topk_case(dev, g, lmax, d, nt, tile_m, bf16,
                                          seed=g * lmax)
    before = gk.grouped_score_topk.launches
    kd, ki = gk.grouped_score_topk(x, sq, ids, tb, lens, qt, metric, tile_m,
                                   kp)
    assert gk.grouped_score_topk.launches == before + 1
    pd, pi = gk.grouped_score_topk_reference(x, sq, ids, tb, lens, qt, metric,
                                             tile_m, kp)
    full = gk.grouped_score_tiles(x, sq, tb, lens, qt, metric, tile_m)
    torch.cuda.synchronize()
    _close(kd, pd)
    # kernel 4's distances are kernel 1's, bit for bit, in sorted order
    first = torch.sort(full, dim=1, stable=True).values[:, :kp]
    assert torch.equal(kd.view(torch.int32), first.view(torch.int32))
    # ids agree wherever the distance is finite and not tied in its row
    chk = gk.untied(pd) & torch.isfinite(kd)
    assert torch.equal(ki[chk], pi[chk])
    assert bool((ki[~torch.isfinite(kd)] == -1).all())
    # both copies of a duplicated row come out (tile 0 holds block 0,
    # whose slots 2j and 2j + 1 are twins)
    twin = {}
    for a, b in ids[0].reshape(-1, 2).tolist():
        twin[a], twin[b] = b, a
    got = set(ki[0, : kp - kp % 2].tolist())
    assert got == {twin[i] for i in got}
    assert bool(torch.isinf(kd[tile_m:2 * tile_m]).all())  # the empty tile
    assert bool(torch.isinf(kd[2 * tile_m:3 * tile_m, 1:]).all())  # one slot
    # misaligned blocks take the plain staging loads, to the same result
    md, mi = gk.grouped_score_topk(_misaligned(x), sq, ids, tb, lens, qt,
                                   metric, tile_m, kp)
    assert torch.equal(md, kd) and torch.equal(mi, ki)


def _int8_case(dev, g, lmax, d, nt, tile_m, seed):
    """int8 tiles with an empty tile, a tile of one occupied slot, a full
    one, and a query row of zeros in the full one."""
    x, sq, scale, tb, lens, qt = _tiles(dev, g, lmax, d, nt, tile_m, True,
                                        seed=seed)
    lens[0], lens[1], lens[2] = 0, 1, lmax
    qt[2 * tile_m] = 0.0
    return x, sq, scale, tb, lens, qt


@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,nt,tile_m", [
    (50, 64, 128, 300, 8), (6, 32, 30, 21, 5), (4, 16, 7, 9, 32),
    (7, 33, 20, 40, 3), (9, 96, 130, 17, 16), (5, 200, 1000, 6, 32),
    (8, 64, 7, 25, 1), (6, 200, 20, 11, 8), (4, 96, 1000, 5, 1),
    (5, 33, 128, 12, 16), (3, 64, 130, 7, 32), (6, 200, 128, 9, 3),
])
def test_int8_tiles(dev, metric, g, lmax, d, nt, tile_m):
    x, sq, scale, tb, lens, qt = _int8_case(dev, g, lmax, d, nt, tile_m,
                                            seed=g * d + tile_m)
    before = gk.grouped_score_tiles_int8.launches
    got = gk.grouped_score_tiles_int8(x, sq, scale, tb, lens, qt, metric,
                                      tile_m)
    assert gk.grouped_score_tiles_int8.launches == before + 1
    want = gk.grouped_score_tiles_int8_reference(x, sq, scale, tb, lens, qt,
                                                 metric, tile_m)
    torch.cuda.synchronize()
    _close(got, want)
    # blocks one byte past a 16-byte boundary take the plain staging loads,
    # and query rows one float past it the plain query loads: same bits
    xo = _misaligned(x)
    assert torch.equal(gk.grouped_score_tiles_int8(xo, sq, scale, tb, lens,
                                                   qt, metric, tile_m), got)
    qo = _misaligned(qt)
    assert torch.equal(gk.grouped_score_tiles_int8(x, sq, scale, tb, lens,
                                                   qo, metric, tile_m), got)


@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,nt,tile_m", [
    (50, 64, 128, 300, 8), (6, 200, 130, 21, 16), (5, 33, 7, 9, 32),
    (4, 96, 20, 13, 3), (4, 64, 1000, 5, 1),
])
def test_int8_tiles_bit_equal_on_dyadic_rows(dev, metric, g, lmax, d, nt,
                                             tile_m):
    """Query rows of quarters of small integers make |q|^2 exact in any
    order, so the kernel's in-kernel quantization and epilogue order give
    the plain version's bits."""
    x, sq, scale, tb, lens, _ = _int8_case(dev, g, lmax, d, nt, tile_m,
                                           seed=g + d)
    gen = torch.Generator().manual_seed(d)
    qt = (torch.randint(-8, 9, (nt * tile_m, d), generator=gen).float()
          / 4).to(dev)
    qt[2 * tile_m] = 0.0
    got = gk.grouped_score_tiles_int8(x, sq, scale, tb, lens, qt, metric,
                                      tile_m)
    want = gk.grouped_score_tiles_int8_reference(x, sq, scale, tb, lens, qt,
                                                 metric, tile_m)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("b,w,k", [(300, 1024, 10), (77, 640, 10),
                                   (9, 33, 128), (5, 3, 7), (40, 3000, 10),
                                   (50, 1023, 128), (64, 1024, 1),
                                   (20, 130, 128), (6, 2500, 128)])
def test_topk(dev, dedup, b, w, k):
    gen = torch.Generator().manual_seed(b * w)
    d = torch.randint(0, 50, (b, w), generator=gen).float()
    ids = torch.randint(0, max(2, w // 3), (b, w), generator=gen,
                        dtype=torch.int32)
    masked = torch.rand(b, w, generator=gen) < 0.3
    masked[1] = True
    d = torch.where(masked, float("inf"), d).to(dev)
    ids = torch.where(masked, -1, ids).to(dev)
    before = tk.topk_dedup_kernel.launches
    kd, ki = tk.topk_dedup_kernel(d, ids, k, dedup=dedup)
    assert tk.topk_dedup_kernel.launches == before + 1
    pd, pi = tk.topk_dedup_kernel_reference(d, ids, k, dedup=dedup)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    np.testing.assert_array_equal(kd.cpu().numpy().view(np.int32),
                                  pd.cpu().numpy().view(np.int32))


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("w", [1024, 640, 1023, 3000])
def test_topk_ties(dev, dedup, w):
    """Rows of all-equal distances (ties to the lowest position, whichever
    lane holds it), ids repeated across lanes, and an exhausted row, on
    each route, bit for bit against the plain version."""
    b, k = 4, 128
    pos = torch.arange(w, dtype=torch.int32)
    d = torch.full((b, w), 2.5)
    ids = torch.stack([pos, pos % 7, (w - 1 - pos) % 37, pos])
    d[2] = (pos % 5).float()              # five runs of ties, interleaved
    d[3] = float("inf")                   # exhausted
    ids[3] = -1
    d, ids = d.to(dev), ids.to(dev)
    before = tk.topk_dedup_kernel.launches
    kd, ki = tk.topk_dedup_kernel(d, ids, k, dedup=dedup)
    assert tk.topk_dedup_kernel.launches == before + 1
    pd, pi = tk.topk_dedup_kernel_reference(d, ids, k, dedup=dedup)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    assert ki[0].tolist() == list(range(k))
    assert ki[3].tolist() == [-1] * k


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("g,lmax,d,b,p", [
    (50, 128, 128, 40, 8), (7, 13, 20, 9, 3), (9, 40, 130, 5, 4),
    (5, 8, 1, 4, 2), (6, 33, 256, 3, 5), (4, 3128, 128, 2, 3),
    (5, 40, 3000, 6, 8),
])
def test_gather_score(dev, bf16, g, lmax, d, b, p):
    gen = torch.Generator().manual_seed(g * lmax + d)
    x = torch.randn(g, lmax, d, generator=gen)
    sq = (x * x).sum(-1)
    q = torch.randn(b, d, generator=gen)
    sel = torch.randint(0, g, (b, p), generator=gen, dtype=torch.int32)
    sel[0] = sel[0, 0]                     # one block probed p times
    sel[-1, -1] = g + 3                    # clamped to the last block
    x = (x.bfloat16() if bf16 else x).to(dev)
    sq, q, sel = sq.to(dev), q.to(dev), sel.to(dev)
    key = "launches_bf16" if bf16 else "launches"
    before = getattr(fg.gather_score, key)
    dots, sqx = fg.gather_score(x, sq, q, sel)
    assert getattr(fg.gather_score, key) == before + 1
    want_d, want_s = fg.gather_score_reference(x, sq, q, sel)
    torch.cuda.synchronize()
    _close(dots, want_d)
    assert torch.equal(sqx, want_s)
    assert torch.equal(dots[0, 0], dots[0, -1])
    # a block array that is not 16-byte aligned takes the element loads
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    xo = buf[1:].view(x.shape)
    xo.copy_(x)
    _close(fg.gather_score(xo, sq, q, sel)[0], want_d)


@pytest.mark.parametrize("metric", ["l2", "sql2", "dot"])
@pytest.mark.parametrize("n,b,d,k", [
    (5000, 300, 128, 10), (131, 9, 10, 5), (1000, 129, 130, 128),
    (70, 3, 8, 100), (20000, 2, 64, 1), (3000, 200, 256, 16),
    (9, 4, 16, 3), (700, 100, 1000, 10), (300, 70, 3000, 128),
])
def test_scan_topk(dev, metric, n, b, d, k):
    gen = torch.Generator().manual_seed(n + b + d)
    x = torch.randn(n, d, generator=gen)
    q = x[torch.randint(0, n, (b,), generator=gen)] + 0.3 * torch.randn(
        b, d, generator=gen)
    x[n // 2] = x[3]                       # an exact tie: index 3 first
    q[0] = x[3]
    x, q = x.to(dev), q.to(dev)
    sq = (x * x).sum(-1)
    before = sc.scan_topk.launches
    kd, ki = sc._scan_partial(x, sq, q, k, metric)
    assert sc.scan_topk.launches == before + 1
    pd, pi = sc._partial_reference(x, sq, q, k, metric)
    torch.cuda.synchronize()
    assert kd.shape == (b, min(k, n)) and ki.dtype == torch.int32
    _close(kd, pd)
    chk = gk.untied(pd, 1e-4)
    assert torch.equal(ki[chk], pi[chk])
    assert bool((ki >= 0).all()) and bool((ki < n).all())
    assert bool((kd[:, 1:] >= kd[:, :-1]).all())
    row = ki[0].tolist()
    if metric != "dot" and min(k, n) > 1:
        assert row[:2] == [3, n // 2]
    # the final distances are the epilogue of the kernel's partial ones
    # (near a zero distance the epilogue's cancellation amplifies the
    # partials' fp32 noise, so they are not held to 1e-4 relative)
    fd, fi = sc.scan_topk(x, sq, q, k, metric)
    assert torch.equal(fi, ki)
    assert torch.equal(fd, sc._epilogue(kd, ki, q, metric)[0])


@pytest.mark.parametrize("copies", [range(3, 23), [*range(3, 9), *range(500, 521)]])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_scan_ties_past_k(dev, copies, metric):
    """More than k rows equal to the best, inside one row tile and across
    two row ranges (384 rows each at 50,000 rows and 5 queries): the k
    lowest indices, whatever order the candidates reach the k-list in.
    Small integer entries make every sum exact, so the copies tie."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randint(-3, 4, (50_000, 32), generator=gen).float()
    copies = list(copies)
    x[copies] = x[copies[0]].clone()
    q = x[[copies[0]] * 5].clone()
    q[1:, 0] += 1.0                          # other queries: other best rows
    x, q = x.to(dev), q.to(dev)
    sq = (x * x).sum(-1)
    kd, ki = sc._scan_partial(x, sq, q, 10, metric)
    pd, pi = sc._partial_reference(x, sq, q, 10, metric)
    torch.cuda.synchronize()
    if metric == "l2":  # under dot a longer row may beat the copies
        assert ki[0].tolist() == copies[:10]
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_scan_dot_never_selects_padding(dev):
    """``dot`` with every inner product negative: the zero rows padding N
    and D would win with partial 0 if their +inf norm were lost."""
    gen = torch.Generator().manual_seed(12)
    x = torch.rand(1000, 70, generator=gen).to(dev)      # 1000 -> 1024 rows
    q = -torch.rand(37, 70, generator=gen).to(dev)
    sq = (x * x).sum(-1)
    kd, ki = sc._scan_partial(x, sq, q, 20, "dot")
    pd, pi = sc._partial_reference(x, sq, q, 20, "dot")
    torch.cuda.synchronize()
    assert bool((ki >= 0).all()) and bool((ki < 1000).all())
    assert bool((kd > 0).all())
    _close(kd, pd)
    chk = gk.untied(pd, 1e-4)
    assert torch.equal(ki[chk], pi[chk])


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_score_runs(dev, bf16):
    """Block-major work items: one block probed by every pair (a run of
    320 pairs, 20 items), a query probing a block twice, ids clamped from
    both sides."""
    g, lmax, d, b, p = 6, 200, 72, 40, 8
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(g, lmax, d, generator=gen)
    sq = (x * x).sum(-1)
    q = torch.randn(b, d, generator=gen)
    x = (x.bfloat16() if bf16 else x).to(dev)
    sq, q = sq.to(dev), q.to(dev)
    for sel in (torch.full((b, p), 2, dtype=torch.int32),
                torch.tensor([[1, 1, -5, g + 7, 0, 5, 1, 3]] * b,
                             dtype=torch.int32)):
        sel = sel.to(dev)
        dots, sqx = fg.gather_score(x, sq, q, sel)
        want_d, want_s = fg.gather_score_reference(x, sq, q, sel)
        torch.cuda.synchronize()
        _close(dots, want_d)
        assert torch.equal(sqx, want_s)
        assert torch.equal(dots[:, 0], dots[:, 1])


@pytest.mark.parametrize("g,b,p", [(50, 40, 8), (3, 300, 7), (1000, 2, 1)])
def test_pair_runs(dev, g, b, p):
    """The card's counting sort of the pairs against the plain stable
    sort: the same counts, runs and items; inside a run, and in the item
    list, the order of the card's atomics."""
    gen = torch.Generator().manual_seed(g + b)
    sel = torch.randint(-2, g + 2, (b, p), generator=gen, dtype=torch.int32)
    sel[: b // 2, 0] = 1                   # a run past 16 pairs
    got = fg._pair_runs(sel.to(dev), g)
    want = fg._pair_runs(sel, g)
    torch.cuda.synchronize()
    for key in ("counts", "n_items", "offsets", "cursor"):
        assert torch.equal(getattr(got, key).cpu(), getattr(want, key)), key
    k = int(want.n_items)
    by_start = torch.sort(got.start[:k].cpu()).indices
    for key in ("start", "count", "block"):
        assert torch.equal(getattr(got, key)[:k].cpu()[by_start],
                           getattr(want, key)[:k]), key
    for o, c in zip(want.offsets.tolist(), want.counts.tolist()):
        assert sorted(got.order[o:o + c].tolist()) == want.order[o:o + c].tolist()


def test_wrappers_raise_on_what_they_do_not_serve(dev):
    x, sq, scale, tb, lens, qt = _tiles(dev, 4, 16, 8, 4, 2, False)
    with pytest.raises(TypeError):
        gk.grouped_score_tiles(x.double(), sq, tb, lens, qt, "l2", 2)
    with pytest.raises(TypeError):
        gk.grouped_score_tiles(x, sq, tb.long(), lens, qt, "l2", 2)
    with pytest.raises(ValueError):
        gk.grouped_score_tiles(x, sq, tb, lens, qt.cpu(), "l2", 2)
    with pytest.raises(ValueError):
        gk.grouped_score_tiles(x[:, ::2], sq[:, ::2], tb, lens, qt, "l2", 2)
    with pytest.raises(ValueError):
        gk.grouped_score_tiles(x, sq, tb, lens, qt, "cosine", 2)
    with pytest.raises(TypeError):
        gk.grouped_score_tiles(x.half(), sq, tb, lens, qt, "l2", 2)
    with pytest.raises(ValueError):
        gk.grouped_score_tiles(x, sq, tb, lens, qt[:-2], "l2", 2)
    with pytest.raises(ValueError):
        gk.grouped_score_tiles(x, sq, tb, lens, qt, "l2", 33)
    ids = torch.zeros(4, 16, dtype=torch.int32, device=dev)
    for bad_kp in (0, 17, 129):
        with pytest.raises(ValueError):
            gk.grouped_score_topk(x, sq, ids, tb, lens, qt, "l2", 2, bad_kp)
    with pytest.raises(ValueError):
        gk.grouped_score_topk(x, sq, ids, tb, lens, qt, "l2", 33, 8)
    with pytest.raises(TypeError):
        gk.grouped_score_topk(x.half(), sq, ids, tb, lens, qt, "l2", 2, 8)
    with pytest.raises(TypeError):
        gk.grouped_score_topk(x, sq, ids.long(), tb, lens, qt, "l2", 2, 8)
    with pytest.raises(ValueError):
        gk.grouped_score_topk(x, sq, ids[:, :8], tb, lens, qt, "l2", 2, 8)
    with pytest.raises(ValueError):
        gk.grouped_score_topk(x, sq, ids.cpu(), tb, lens, qt, "l2", 2, 8)
    d = torch.zeros(4, 8, device=dev)
    with pytest.raises(TypeError):
        tk.topk_dedup_kernel(d, torch.zeros(4, 8, dtype=torch.int64,
                                            device=dev), 3)
    with pytest.raises(ValueError):
        tk.topk_dedup_kernel(d, torch.zeros(4, 8, dtype=torch.int32), 3)
    q, sel = torch.zeros(3, 8, device=dev), torch.zeros(
        3, 2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        fg.gather_score(x.half(), sq, q, sel)
    with pytest.raises(TypeError):
        fg.gather_score(x, sq, q, sel.long())
    with pytest.raises(ValueError):
        fg.gather_score(x, sq, q.cpu(), sel)
    with pytest.raises(ValueError):
        fg.gather_score(x, sq, q.t().contiguous().t(), sel)
    xs = torch.zeros(300, 8, device=dev)
    sqs = torch.zeros(300, device=dev)
    with pytest.raises(TypeError):
        sc.scan_topk(xs.double(), sqs, q, 3)
    with pytest.raises(ValueError):
        sc.scan_topk(xs, sqs, q, 3, "cosine")
    with pytest.raises(ValueError):
        sc.scan_topk(xs, sqs, q, 129)
    with pytest.raises(ValueError):
        sc.scan_topk(xs[:, ::2], sqs, q[:, :4], 3)
    with pytest.raises(ValueError):  # a copy of other rows
        sc.scan_topk(xs, sqs, q, 3, rows=sc.scan_rows(xs[:100], sqs[:100]))


# -- kernels 7 and 8: the descent and the probe selection -----------------

def _dyadic(rng, shape):
    """Multiples of 1/16 in [-2, 2]: with D <= 16 every projection is
    exact in f32 in any order, and data points and thresholds tie."""
    return (rng.integers(-32, 33, size=shape) / 16.0).astype(np.float32)


def _descent_forest(dev, n, dim, depth, min_leaf, trees, seed, b=333):
    """A forest built by the port on the card from dyadic data, its node
    table, and the projections of ``b`` queries (not a multiple of any
    block size): dyadic points, a few zero queries, a few data points."""
    from rptree_tpu_torch import forest_batch
    from rptree_tpu_torch.ops import traverse as tv

    rng = np.random.default_rng(seed)
    x = _dyadic(rng, (n, dim))
    f = forest_batch(seed, depth, min_leaf, trees, 1.0, x, device=dev,
                     r=_dyadic(rng, (trees, depth, dim)))
    q = _dyadic(rng, (b, dim))
    q[:7] = 0.0
    q[7:40] = x[rng.integers(0, n, size=q[7:40].shape[0])]
    qd = torch.as_tensor(q, device=dev)
    return f, tv.project_queries(qd, f.arrays.r, f.plan.n_levels), qd


def _same_descent(plan, table, projq, budget):
    from rptree_tpu_torch.ops import traverse as tv

    leaf, pri = tv.traverse_kernel(plan, table, projq, budget)
    want_l, want_p = tv.traverse_tree_reference(plan, table, projq, budget)
    torch.cuda.synchronize()
    assert torch.equal(leaf, want_l)
    assert torch.equal(pri.view(torch.int32), want_p.view(torch.int32))
    return leaf, pri


_DESCENT_PLANS = {  # (n, dim, depth, min_leaf, trees)
    "one_tree": (3000, 12, 12, 2, 1),
    "ragged": (777, 5, 9, 3, 3),
}


@pytest.mark.parametrize("budget", [1, 2, 3, 8, 9, 32, 64, "all"])
@pytest.mark.parametrize("plan_name", list(_DESCENT_PLANS))
def test_traverse_and_probes(dev, plan_name, budget):
    """Kernel 7 bit-equal to its plain twin (leaves, priorities as int32
    bits) on every route, and kernel 8 on its output, with and without
    the bucket stop, for a probe count below, at and past T * F."""
    from rptree_tpu_torch.ops import traverse as tv

    f, projq, _ = _descent_forest(dev, *_DESCENT_PLANS[plan_name], seed=7)
    plan = f.plan
    budget = plan.n_leaves if budget == "all" else budget
    leaf, pri = _same_descent(plan, f._table(), projq, budget)
    t = leaf.shape[0]
    lens = f._lens_global()
    for probes in (1, max(1, t * budget // 2), t * budget + 3):
        for stop in (False, True):
            args = (leaf, pri, plan.n_leaves, probes, lens, 24, stop)
            g, s = tv.select_probes(*args)
            wg, ws = tv.select_probes_reference(*args)
            torch.cuda.synchronize()
            assert torch.equal(g, wg) and torch.equal(s, ws), (probes, stop)


def test_traverse_tied_forks(dev):
    """Projections that hit thresholds and margins exactly at every
    level (the JAX package's fork tie-break test), one tree and three."""
    rng = np.random.default_rng(3)
    f, projq, _ = _descent_forest(dev, 1500, 4, 14, 2, 3, seed=11, b=130)
    plan, table = f.plan, f._table()
    for l, lp in enumerate(plan.levels):
        cols = [f.arrays.thr, f.arrays.mgl, f.arrays.mgh]
        pick = torch.as_tensor(rng.integers(0, lp.n_segs, size=projq.shape[2]),
                               device=dev)
        src = torch.as_tensor(rng.integers(0, 3, size=projq.shape[2]),
                              device=dev)
        vals = torch.stack([c[:, l, pick] for c in cols])  # [3, T, B]
        projq[:, l] = vals.gather(0, src[None, None].expand(1, *vals.shape[1:]))[0]
    one = table._replace(rec=table.rec[:1].contiguous())
    for budget in (1, 2, 3, 8, 9, 32):
        _same_descent(plan, table, projq, budget)
        _same_descent(plan, one, projq[:1].contiguous(), budget)


@pytest.mark.parametrize("budget", [1, 9])
def test_traverse_without_levels(dev, budget):
    """A single-leaf forest (no levels): leaf 0 at VALID_PRIO_CAP in slot 0,
    empty slots after it; probe selection of it."""
    from rptree_tpu_torch.ops import traverse as tv

    f, projq, _ = _descent_forest(dev, 5, 3, 4, 8, 2, seed=1, b=70)
    assert f.plan.n_levels == 0 and projq.shape == (2, 0, 70)
    leaf, pri = _same_descent(f.plan, f._table(), projq, budget)
    assert bool((leaf[..., 0] == 0).all()) and bool((leaf[..., 1:] == -1).all())
    assert bool((pri[..., 0] == tv.VALID_PRIO_CAP).all())
    lens = f._lens_global()
    g, s = tv.select_probes(leaf, pri, 1, 4, lens, 3, True)
    assert torch.equal(s, tv.select_probes_reference(leaf, pri, 1, 4, lens, 3,
                                                     True)[1])
    assert s[:, 0].eq(0).all() and s[:, 1:].eq(-1).all() and g.eq(0).all()


def test_traverse_past_shared_memory(dev):
    """A budget whose 2F entries pass shared memory's cap: the global-
    scratch route, bit-equal to the plain twin."""
    from rptree_tpu_torch.ops import traverse as tv

    f, projq, _ = _descent_forest(dev, 20000, 6, 15, 1, 2, seed=5, b=3)
    budget = tv.SMEM_MAX_ENTRIES // 2 + 300
    assert f.plan.n_leaves > budget
    assert tv.traverse_route(budget)[0] == "global"
    assert tv.traverse_route(tv.SMEM_MAX_ENTRIES // 2)[0] == "shared"
    leaf, pri = _same_descent(f.plan, f._table(), projq, budget)
    g, s = tv.select_probes(leaf, pri, f.plan.n_leaves, 500,
                            f._lens_global(), 10, True)
    wg, ws = tv.select_probes_reference(leaf, pri, f.plan.n_leaves, 500,
                                        f._lens_global(), 10, True)
    assert torch.equal(g, wg) and torch.equal(s, ws)


def test_every_path_traverses_on_the_card(dev, monkeypatch):
    """Every query path runs kernel 7 (and the packed ones kernel 8) with
    contiguous operands; a non-contiguous projection or a CPU operand is
    refused by the wrappers."""
    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import traverse as tv

    f, projq, q = _descent_forest(dev, 3000, 12, 12, 16, 3, seed=9, b=50)
    seen = []
    orig = fm.traverse_kernel

    def checked(plan, table, pq, budget):
        seen.append(pq.is_contiguous() and table.rec.is_contiguous())
        return orig(plan, table, pq, budget)

    monkeypatch.setattr(fm, "traverse_kernel", checked)
    n7, n8 = tv.traverse_kernel.launches, tv.select_probes.launches
    f.knn(q, 5)
    f.candidates(q, budget=3)
    f.recall_with(q, 5)
    f.pack_leaves()
    f.knn(q, 5, budget=2)
    f.knn_batched(q, 5, budget=2, chunk=20)
    f.knn_grouped(q, 5, budget=1, probes=3, nt=150, selection="kernel")
    assert seen and all(seen)
    # unpacked knn, candidates, recall_with; per pair 1 + 3 chunks; grouped
    assert tv.traverse_kernel.launches - n7 == len(seen) == 8
    assert tv.select_probes.launches - n8 == 5
    table = f._table()
    with pytest.raises(ValueError):
        tv.traverse_kernel(f.plan, table, projq.transpose(1, 2).contiguous()
                           .transpose(1, 2), 2)
    with pytest.raises(ValueError):
        tv.traverse_kernel(f.plan, table._replace(rec=table.rec.cpu()), projq, 2)
    leaf, pri = tv.traverse_kernel(f.plan, table, projq, 2)
    with pytest.raises(ValueError):
        tv.select_probes(leaf, pri, f.plan.n_leaves, 3, f._lens_global().cpu())
    with pytest.raises(TypeError):
        tv.select_probes(leaf, pri.double(), f.plan.n_leaves, 3,
                         f._lens_global())


def _random_plan(levels, width, seed):
    """A plan-shaped DAG of ``levels`` levels (level l has min(2^l,
    ``width``) split segments; a child is a segment of the next level or,
    one time in five and at the last level always, a leaf of 64), for
    descents at any depth without building a forest."""
    import types

    from rptree_tpu_torch.models.plan import _encode_leaf

    rng = np.random.default_rng(seed)
    segs = [min(2 ** l, width) for l in range(levels)]
    lvls = []
    for l, ns in enumerate(segs):
        nxt = segs[l + 1] if l + 1 < levels else 0
        enc = rng.integers(0, max(nxt, 1), size=(ns, 2))
        leafy = (rng.random((ns, 2)) < 0.2) | (nxt == 0)
        enc = np.where(leafy, _encode_leaf(rng.integers(0, 64, size=(ns, 2))),
                       enc).astype(np.int32)
        lvls.append(types.SimpleNamespace(n_segs=ns, child_enc=enc))
    return types.SimpleNamespace(levels=lvls, n_levels=levels, n_leaves=64,
                                 root_enc=0 if levels else _encode_leaf(0))


def _dyadic_table(dev, plan, trees, b, seed):
    """Dyadic thresholds, margins and projections (ties at every level; a
    query in 16 all zeros) for :func:`_random_plan`."""
    from rptree_tpu_torch.ops import traverse as tv

    gen = torch.Generator(device=dev).manual_seed(seed)
    nl = plan.n_levels
    smax = max([lp.n_segs for lp in plan.levels], default=1)

    def dyadic(*shape):
        return torch.round(16 * torch.randn(*shape, generator=gen,
                                            device=dev)) / 16

    thr = dyadic(trees, max(nl, 1), smax)[:, :nl]
    mgl = thr - dyadic(*thr.shape).abs()
    mgh = thr + dyadic(*thr.shape).abs()
    projq = dyadic(trees, nl, b)
    projq[..., ::16] = 0.0
    return tv.node_table(plan, thr, mgl, mgh), projq.contiguous()


@pytest.mark.parametrize("levels", [0, 1, 13, 20])
@pytest.mark.parametrize("budget", [1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 32, 33])
def test_traverse_routes_at_depth(dev, levels, budget):
    """Kernel 7 bit-equal to its plain twin on every route (registers; one
    warp at M 32 and 64; shared memory past it) at L 0, 1, 13 and 20, on
    70 queries of 3 trees (no multiple of a block's items)."""
    from rptree_tpu_torch.ops import traverse as tv

    plan = _random_plan(levels, 48, seed=levels)
    table, projq = _dyadic_table(dev, plan, 3, 70, seed=budget)
    leaf, _ = _same_descent(plan, table, projq, budget)
    assert bool((leaf[..., 0] >= 0).all())
    assert tv.traverse_route(budget)[0] == (
        "registers" if budget <= 8 else "warp" if budget <= 32 else "shared")


def _probe_case(dev, t, f, b, nl, seed, sort):
    """Adversarial kernel-8 inputs on the card: ties across and within
    trees, -0.0 and +0.0, NaN, +inf, empty slots (leaf -1); with ``sort``
    each (tree, query) list ascending, as kernel 7 returns it."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 0.25, 0.25, 1.0, 3.0e38, np.inf, np.nan,
                     0.5], np.float32)
    prio = rng.choice(pool, size=(t, b, f))
    leaf = rng.integers(-1, nl, size=(t, b, f)).astype(np.int32)
    if sort:
        order = np.argsort(np.where(leaf >= 0, prio, np.inf), axis=-1,
                           kind="stable")
        prio = np.take_along_axis(prio, order, -1)
        leaf = np.take_along_axis(leaf, order, -1)
    lens = rng.integers(0, 4, size=t * nl).astype(np.int32)
    return (torch.as_tensor(leaf, device=dev),
            torch.as_tensor(prio, device=dev),
            torch.as_tensor(lens, device=dev))


@pytest.mark.parametrize("t,f", [(1, 1), (8, 1), (8, 2), (31, 1), (16, 2),
                                 (11, 3), (32, 2), (13, 5), (32, 32)])
@pytest.mark.parametrize("sort", [False, True])
def test_select_probes_routes(dev, t, f, sort):
    """Kernel 8 bit-equal to its plain twin and to its rank rule on every
    lanes and warp route (T * F = 1, 8, 16, 31, 32, 33, 64, 65, 1,024), on
    37 queries (no multiple of the queries a block takes), for P from 1
    past T * F, with the bucket stop off and on (k 6: it fires early; k
    40: past entry 32 where there are that many)."""
    from rptree_tpu_torch.ops import traverse as tv

    nl = 7
    leaf, prio, lens = _probe_case(dev, t, f, 37, nl, t * 64 + f, sort)
    n = t * f
    for probes in sorted({1, max(1, n // 2), n, n + 3}):
        for k, stop in ((None, False), (6, True), (40, True)):
            args = (leaf, prio, nl, probes, lens, k, stop)
            got = tv.select_probes(*args)
            want = tv.select_probes_reference(*args)
            rank = tv.select_probes_by_rank(*args)
            torch.cuda.synchronize()
            for g, w, r in zip(got, want, rank):
                assert torch.equal(g, w) and torch.equal(g, r), (probes, k)


def test_select_probes_merge_route(dev):
    """Past 1,024 entries a query the merge of ascending lists: bit-equal
    on sorted adversarial lists, bucket stop off and on."""
    from rptree_tpu_torch.ops import traverse as tv

    t, f, nl = 3, 400, 9
    assert tv.probe_route(t, f)[0] == "merge"
    leaf, prio, lens = _probe_case(dev, t, f, 21, nl, 5, sort=True)
    for k, stop in ((None, False), (50, True)):
        args = (leaf, prio, nl, 700, lens, k, stop)
        got, want = tv.select_probes(*args), tv.select_probes_reference(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_descent_wrappers_refuse_mixed_devices_and_count(dev):
    """Both wrappers raise on a CPU operand beside CUDA ones (no plain
    fallback on the card) and count each launch once."""
    from rptree_tpu_torch.ops import traverse as tv

    plan = _random_plan(6, 16, seed=1)
    table, projq = _dyadic_table(dev, plan, 2, 40, seed=2)
    n7 = tv.traverse_kernel.launches
    leaf, pri = tv.traverse_kernel(plan, table, projq, 2)
    tv.traverse_kernel(plan, table, projq, 20)
    assert tv.traverse_kernel.launches - n7 == 2
    with pytest.raises(ValueError):
        tv.traverse_kernel(plan, table._replace(
            level_off=table.level_off.cpu()), projq, 2)
    lens = torch.ones(2 * plan.n_leaves, dtype=torch.int32, device=dev)
    n8 = tv.select_probes.launches
    tv.select_probes(leaf, pri, plan.n_leaves, 3, lens, 2, True)
    assert tv.select_probes.launches - n8 == 1
    with pytest.raises(ValueError):
        tv.select_probes(leaf, pri.cpu(), plan.n_leaves, 3, lens)
    with pytest.raises(ValueError):
        tv.select_probes(leaf, pri, plan.n_leaves, 3, lens.cpu())
    assert tv.traverse_kernel.launches - n7 == 2
    assert tv.select_probes.launches - n8 == 1


@pytest.mark.parametrize("switch", ["allow_tf32", "precision"])
def test_projections_ignore_tf32(dev, switch):
    """The build and query projections run in IEEE fp32 whatever the
    caller's TF32 switch: thresholds, projections and leaves bit-equal with
    TF32 on and off, and the caller's switch restored."""
    from rptree_tpu_torch import forest_batch
    from rptree_tpu_torch.models import forest as fm

    rng = np.random.default_rng(2)
    x = rng.normal(size=(4000, 96)).astype(np.float32)
    q = torch.as_tensor(rng.normal(size=(500, 96)).astype(np.float32),
                        device=dev)

    def run():
        f = forest_batch(3, 9, 8, 4, 1.0, x, device=dev)
        pq = fm.project_queries(q, f.arrays.r, f.plan.n_levels)
        leaf, pri = fm._traverse_forest(f.plan, f.arrays, q, 2, f._table())
        return f.arrays.thr, pq, leaf, pri

    off = run()
    if switch == "allow_tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        torch.set_float32_matmul_precision("high")
    try:
        on = run()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(off, on):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# -- kernel 9: the tile tables ---------------------------------------------

def _pairs(dev, g, b, p, seed, hot=False, masked=0.2):
    """Pairs over ``g`` blocks: a share masked, one query in three
    probing block ``g - 1`` (past 65,536 where ``g`` is), and with
    ``hot`` every query probing block 5 once."""
    gen = torch.Generator().manual_seed(seed)
    gsel = torch.randint(0, g, (b, p), generator=gen, dtype=torch.int32)
    gsel[::3, -1] = g - 1
    if hot:
        gsel[:, 0] = min(5, g - 1)
    lsel = torch.where(torch.rand(b, p, generator=gen) < masked, -1,
                       gsel % 97).to(torch.int32)
    gsel = torch.where(lsel < 0, 0, gsel).to(torch.int32)
    lens = torch.randint(0, 130, (g,), generator=gen, dtype=torch.int32)
    return gsel.to(dev), lsel.to(dev), lens.to(dev)


def _same_tables(gsel, lsel, lens, tile_m, nt):
    """Kernel 9 against its twin: all five outputs bit-equal, and the
    wrapper counted one launch."""
    from rptree_tpu_torch.ops import grouped as og

    before = og.tile_tables.launches
    got = og.tile_tables(gsel, lsel, lens, tile_m, nt)
    assert og.tile_tables.launches == before + 1
    want = og.tile_tables_reference(gsel, lsel, lens, tile_m, nt)
    torch.cuda.synchronize()
    for name, a, w in zip(("tb", "tp", "needed", "slot", "lens_t"), got,
                          want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, w), name
    return int(want[2])


@pytest.mark.parametrize("case", [
    # (blocks, queries, probes, tile_m, hot, masked, capacity: None = ample)
    (50, 300, 8, 8, False, 0.2, None), (50, 300, 8, 1, False, 0.2, None),
    (50, 300, 8, 16, False, 0.2, None), (40, 3000, 10, 8, True, 0.1, None),
    (65_536, 3000, 8, 8, False, 0.1, None), (70_000, 700, 8, 8, True, 0.1,
                                               None),
    (1, 33, 3, 8, False, 0.3, None), (257, 41, 7, 3, False, 0.0, None),
    (300, 999, 5, 8, True, 1.0, None), (300, 999, 5, 8, True, 0.2, 100),
    (300, 999, 5, 16, False, 0.2, 1), (8192, 5000, 8, 8, True, 0.05, None),
])
def test_tile_tables(dev, case):
    """Kernel 9 bit-equal to ``_tile_tables`` over chunks of one and many
    4,096-pair blocks: a hot block that every query probes, all pairs
    masked, a capacity below the tiles needed, tile_m 1, 3, 8 and 16, one
    block, and G past 256, at 65,536 and past it (the radix sort's one,
    two and three passes)."""
    g, b, p, tile_m, hot, masked, nt = case
    gsel, lsel, lens = _pairs(dev, g, b, p, seed=g + b, hot=hot,
                              masked=masked)
    if nt is None:
        nt = b * p
    need = _same_tables(gsel, lsel, lens, tile_m, nt)
    if masked == 1.0:
        assert need == 0
    if case[-1] is not None:
        assert need > nt


@pytest.mark.parametrize("g,b,p,tile_m,hot,masked", [
    (1, 40, 3, 8, False, 0.2), (256, 300, 8, 8, True, 0.2),
    (65_536, 3000, 8, 8, False, 0.1), (65_537, 700, 8, 8, True, 0.1),
    (524_288, 8192, 8, 16, True, 0.05), (300, 999, 5, 8, True, 1.0),
])
@pytest.mark.parametrize("max_bits", [8, 11])
def test_tile_tables_digit_plans(dev, g, b, p, tile_m, hot, masked, max_bits):
    """Kernel 9 at digits of at most 8 and 11 bits (one to three passes,
    2 + passes grids) bit-equal to the twin and to the plan's rule in
    plain torch; the C entry point sizes the scratch as the plan does."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import grouped as og

    gsel, lsel, lens = _pairs(dev, g, b, p, seed=g + p, hot=hot,
                              masked=masked)
    need = int(og.tile_tables_reference(gsel, lsel, lens, tile_m, 1)[2])
    nt = max(1, need + need // 8)
    got = og._tables_on_card(gsel, lsel, lens, tile_m, nt, max_bits=max_bits)
    want = og.tile_tables_reference(gsel, lsel, lens, tile_m, nt)
    rule = og.tile_tables_by_plan(gsel.cpu(), lsel.cpu(), lens.cpu(), tile_m,
                                  nt, max_bits)
    torch.cuda.synchronize()
    for name, a, w, r in zip(("tb", "tp", "needed", "slot", "lens_t"), got,
                             want, rule):
        assert a.dtype == w.dtype and torch.equal(a, w), name
        assert torch.equal(a.cpu(), r), name
    assert _cuda.lib().rpt_tile_tables_scratch(b * p, g, max_bits) == \
        og.tile_tables_plan(b * p, g, max_bits).length


@pytest.mark.parametrize("g,b,p,tile_m,hot,masked,cut", [
    (1, 40, 3, 8, False, 0.2, 1), (300, 999, 5, 8, True, 1.0, 1),
    (300, 999, 5, 16, False, 0.2, 3), (65_537, 700, 8, 8, True, 0.1, 1),
    (65_537, 700, 8, 8, True, 0.1, 4), (524_288, 8192, 8, 16, True, 0.05, 2),
])
@pytest.mark.parametrize("max_bits", [8, 11])
def test_tile_tables_add_their_counts(dev, g, b, p, tile_m, hot, masked, cut,
                                      max_bits):
    """Given ``tally``, kernel 9 adds each call's valid pairs and its
    tiles needed past ``nt`` (at a capacity of the tiles needed, and cut
    below it), and its tables are those of a call without them."""
    from rptree_tpu_torch.ops import grouped as og

    gsel, lsel, lens = _pairs(dev, g, b, p, seed=g + b, hot=hot,
                              masked=masked)
    need = int(og.tile_tables_reference(gsel, lsel, lens, tile_m, 1)[2])
    nt = max(1, need // cut)
    want = og._tables_on_card(gsel, lsel, lens, tile_m, nt, max_bits=max_bits)
    tally = torch.zeros(2, dtype=torch.int64, device=dev)
    for _ in range(2):
        got = og._tables_on_card(gsel, lsel, lens, tile_m, nt,
                                 max_bits=max_bits, tally=tally)
    torch.cuda.synchronize()
    for name, a, w in zip(("tb", "tp", "needed", "slot", "lens_t"), got,
                          want):
        assert torch.equal(a, w), name
    assert tally.tolist() == [2 * int((lsel >= 0).sum()),
                               2 * max(0, need - nt)]


@pytest.mark.parametrize("g,max_bits", [(1, 11), (65_536, 11), (65_537, 8),
                                        (524_288, 11), (524_288, 8)])
def test_tile_tables_launch_two_plus_passes_grids(dev, g, max_bits):
    """A call launches the upsweep, the scan and one scatter a pass, by the
    library's own count."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import grouped as og

    gsel, lsel, lens = _pairs(dev, g, 256, 8, seed=g)
    before = _cuda.lib().rpt_tile_tables_grids()
    og._tables_on_card(gsel, lsel, lens, 8, 512, max_bits=max_bits)
    torch.cuda.synchronize()
    assert _cuda.lib().rpt_tile_tables_grids() - before == \
        2 + og.tile_tables_plan(256 * 8, g, max_bits).passes


def test_tile_tables_refuse_what_they_do_not_serve(dev):
    from rptree_tpu_torch.ops import grouped as og

    gsel, lsel, lens = _pairs(dev, 20, 10, 4, seed=1)
    with pytest.raises(TypeError):
        og.tile_tables(gsel.long(), lsel, lens, 8, 10)
    with pytest.raises(ValueError):
        og.tile_tables(gsel, lsel, lens.cpu(), 8, 10)
    with pytest.raises(ValueError):
        og.tile_tables(gsel, lsel[:, :3].contiguous(), lens, 8, 10)
    with pytest.raises(ValueError):
        og.tile_tables(gsel, lsel, lens[:0], 8, 10)
    with pytest.raises(ValueError):
        og.tile_tables(gsel, lsel, lens, 0, 10)


def _served_forest(dev, n=6000, dim=24, seed=3):
    from rptree_tpu_torch import forest_batch

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    q = torch.as_tensor(x[:400] + 0.1 * rng.normal(size=(400, dim)).astype(
        np.float32), device=dev)
    f = forest_batch(seed, 8, 16, 4, 1.0, x, device=dev)
    f.pack_leaves()
    return f, q


def test_grouped_steady_state_never_syncs(dev):
    """``knn_grouped(check=False)`` at a cached capacity reads nothing
    back to the host, through the tile kernels and through the XLA form
    (kernel 9 builds the tables of both)."""
    from rptree_tpu_torch.ops import grouped as og

    f, q = _served_forest(dev)
    serve = dict(budget=2, probes=6, tile_m=8, chunk=200)
    runs = (dict(selection="kernel"), dict(metric="cosine"),
            dict(impl="xla", selection="sort"))
    want = [f.knn_grouped(q, 10, check=True, **serve, **kw) for kw in runs]
    n9 = og.tile_tables.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [f.knn_grouped(q, 10, check=False, **serve, **kw)
               for kw in runs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert og.tile_tables.launches == n9 + 2 * len(runs)
    for (gd, gi), (wd, wi) in zip(got, want):
        assert torch.equal(gd, wd) and torch.equal(gi, wi)


def test_serving_loop_check_false_never_syncs(dev):
    """``examples/torch_serving_loop.py``'s calls: ``knn_grouped(...,
    check=False)`` after one checked call at the shape, on f32 blocks with
    the default sort tail, one batch a call and four in flight, then four
    batches as one call of ``chunk=`` batch, make no sync that
    ``torch.cuda.set_sync_debug_mode("error")`` detects, and return the
    checked calls' bits."""
    import collections

    f, q = _served_forest(dev)
    serve = dict(budget=1, probes=4, precision="default", tile_m=8)
    batches = [q[i * 100:(i + 1) * 100] for i in range(4)]
    want = f.knn_grouped(batches[0], 10, check=True, **serve)
    want_big = f.knn_grouped(q, 10, check=True, chunk=100, **serve)
    torch.cuda.synchronize()
    window = collections.deque()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for qb in batches:
            window.append(f.knn_grouped(qb, 10, check=False, **serve))
        big = f.knn_grouped(q, 10, check=False, chunk=100, **serve)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(window[0][0], want[0])
    assert torch.equal(window[0][1], want[1])
    assert torch.equal(big[0], want_big[0]) and torch.equal(big[1],
                                                            want_big[1])
    for (d, i), s in zip(window, range(0, 400, 100)):
        assert torch.equal(i, want_big[1][s:s + 100])
    assert not f.grouped_overflow()["overflow"]


@pytest.mark.parametrize("switch", ["allow_tf32", "precision"])
def test_xla_form_ignores_tf32(dev, switch):
    """The XLA form multiplies f32 blocks in IEEE fp32 whatever the
    caller's TF32 switch: the same bits with TF32 on and off, and the
    caller's switch restored."""
    from rptree_tpu_torch.ops import grouped as og

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(30, 40, 96, generator=gen).to(dev)
    sq = (x * x).sum(-1)
    q = torch.randn(64, 96, generator=gen).to(dev)
    gsel, lsel, _ = _pairs(dev, 30, 64, 5, seed=4)
    lens = torch.full((30,), 37, dtype=torch.int32, device=dev)

    def run():
        return og.grouped_distances(x, sq, lens, gsel, lsel, q, "l2", 4,
                                    200, 16)[0]

    off = run()
    if switch == "allow_tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        torch.set_float32_matmul_precision("high")
    try:
        on = run()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(off.view(torch.int32), on.view(torch.int32))


def test_dot_through_kernel_3_equals_the_sort_tail(dev):
    """``dot`` distances are negative: the top-k kernel (kernel 3) selects
    them as the sort tail does, distances bit-equal and ids equal outside
    runs of equal distances."""
    f, q = _served_forest(dev, seed=8)
    serve = dict(budget=2, probes=6, tile_m=8, metric="dot")
    kd, ki = f.knn_grouped(q, 10, selection="kernel", **serve)
    sd, si = f.knn_grouped(q, 10, selection="sort", **serve)
    torch.cuda.synchronize()
    assert bool((kd[:, 0] < 0).all())
    assert torch.equal(kd.view(torch.int32), sd.view(torch.int32))
    chk = gk.untied(sd)
    assert torch.equal(ki[chk], si[chk])


# -- online updates: the fold, its occupancy, the pending merge -------------

def _to_device(f, dev):
    """``f``'s twin on ``dev``: the same plan, arrays and rows."""
    from rptree_tpu_torch import RPForest
    from rptree_tpu_torch.ops.build import TreeArrays

    return RPForest(f.plan, TreeArrays(*(a.to(dev) for a in f.arrays)),
                    f.x.to(dev), f.sq_norms.to(dev), f.config)


_BLOCKS = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}


def _folded_twins(dev, block, n=6000, dim=24, seed=11):
    """A forest built on the CPU and its twin on the card, packed alike
    with slack 8; on both the same 600 points added and folded (some
    overflow and stay pending), two indexed, one folded and one pending
    point removed, and 100 more points added."""
    from rptree_tpu_torch import forest_batch

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + 700, dim)).astype(np.float32)
    q = x[:400] + 0.1 * rng.normal(size=(400, dim)).astype(np.float32)
    fc = forest_batch(seed, 8, 16, 4, 1.0, x[:n], device="cpu")
    fd = _to_device(fc, dev)
    for f in (fc, fd):
        f.pack_leaves(dtype=_BLOCKS[block], slack=8)
        f.add(x[n:n + 600])
        f.fold()
        f.remove([1, 2, n + 3, n + f.n_folded + 1])
        f.add(x[n + 600:])
    return fc, fd, torch.as_tensor(q)


def _agree(got, want, rtol=1e-4):
    """A path on the card against the same path on the CPU (the plain
    twins): distances within ``rtol``, ids equal outside near-ties."""
    (gd, gi), (wd, wi) = (tuple(t.cpu() for t in r) for r in (got, want))
    _close(gd, wd, rtol)
    chk = gk.untied(wd, rtol)
    assert torch.equal(gi[chk], wi[chk])


@pytest.mark.parametrize("block", list(_BLOCKS))
def test_fold_on_the_card_equals_the_cpu_fold(dev, block):
    """The fold on the card writes the CPU fold's blocks: rows (int8 by
    each target block's scale, bf16 rounded to even) and ids bit-equal,
    the same occupancy table, leaves and counts; norms to fp32 order."""
    fc, fd, _ = _folded_twins(dev, block)
    assert 0 < fd.n_pending and fd.n_folded > 500
    assert (fd.n_pending, fd.n_folded, fd.n_deleted) == (
        fc.n_pending, fc.n_folded, fc.n_deleted)
    (xc, sc_, ic), (xd, sd, idd) = fc._packed, fd._packed
    if xc.dtype == torch.bfloat16:
        xc, xd = xc.view(torch.int16), xd.view(torch.int16)
    assert torch.equal(xd.cpu(), xc) and torch.equal(idd.cpu(), ic)
    _close(sd.cpu(), sc_, rtol=1e-6)
    assert torch.equal(fd._lens_global().cpu(), fc._lens_global())
    assert fd._lens_global().device.type == "cuda"
    for a, b in zip(fd._folded_leaf, fc._folded_leaf):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("block", list(_BLOCKS))
def test_kernels_on_folded_occupancy(dev, block):
    """Every kernel that reads occupancy, on the fold's table: kernel 8
    (with the bucket stop) and kernel 9 bit-equal to their twins; the
    grouped kernel tail (kernels 1 or 2, and 3), ``kernel_topk`` (kernel
    4), the per-pair path (kernel 6) and packed ``knn_h`` against the
    same calls on the CPU, tombstones and the pending merge included."""
    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops import traverse as tv

    fc, fd, q = _folded_twins(dev, block)
    qd = q.to(dev)
    lens = fd._lens_global()
    leaf, pri = fm._traverse_forest(fd.plan, fd.arrays, qd, 2, fd._table())
    for stop in (False, True):
        args = (leaf, pri, fd.plan.n_leaves, 8, lens, 10, stop)
        got, want = tv.select_probes(*args), tv.select_probes_reference(*args)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    _same_tables(*got, lens, 8, 2 * got[0].numel())
    scorer = (gk.grouped_score_tiles_int8 if block == "int8"
              else gk.grouped_score_tiles)
    count = "launches_bf16" if block == "bf16" else "launches"
    n_score = getattr(scorer, count)
    serve = dict(budget=2, probes=6, tile_m=8)
    for kw in (dict(selection="kernel"), dict(impl="kernel_topk")):
        if block == "int8" and "impl" in kw:
            continue
        _agree(fd.knn_grouped(qd, 10, **serve, **kw),
               fc.knn_grouped(q, 10, **serve, **kw))
    assert getattr(scorer, count) > n_score
    n6 = getattr(fg.gather_score, count)
    _agree(fd.knn_batched(qd, 10, budget=2, chunk=128),
           fc.knn_batched(q, 10, budget=2, chunk=128))
    _agree(fd.knn_h(qd, 10, budget=2), fc.knn_h(q, 10, budget=2))
    assert (getattr(fg.gather_score, count) > n6) == (block != "int8")


@pytest.mark.parametrize("n_pending,n_dead", [(3, 0), (3, 1), (300, 5),
                                              (300, 150)])
def test_pending_merge_through_kernel_5(dev, n_pending, n_dead):
    """The pending merge at ``precision="default"`` on the card: kernel 5
    on a buffer of fewer rows than k, or of a row count that is no
    multiple of its 128-row tile; where the removed pending points push
    ``k + removed`` past kernel 5's k of 128, the gate (JAX's own) takes
    the plain bf16 product, and kernel 5 is not launched."""
    from rptree_tpu_torch import forest_batch

    rng = np.random.default_rng(n_pending + n_dead)
    x = rng.normal(size=(3000 + n_pending, 16)).astype(np.float32)
    fc = forest_batch(2, 7, 16, 3, 1.0, x[:3000], device="cpu")
    fd = _to_device(fc, dev)
    q = torch.as_tensor(x[3000:][:64] + 0.01)
    for f in (fc, fd):
        f.pack_leaves()
        f.add(x[3000:])
        f.remove(3000 + np.arange(n_dead))
    launches = sc.scan_topk.launches
    got = fd.knn(q.to(dev), 10, budget=2, precision="default")
    want = fc.knn(q, 10, budget=2, precision="default")
    served = 10 + n_dead <= sc.MAX_K
    assert sc.scan_topk.launches - launches == int(served)
    _agree(got, want)
    ids = got[1].cpu()
    assert not set(ids.reshape(-1).tolist()) & set(range(3000, 3000 + n_dead))
    own = torch.arange(3000, 3000 + q.shape[0], dtype=torch.int32)
    assert torch.equal(ids[n_dead:, 0], own[n_dead:])


# -- the other dense layouts: kernel 6's shared-row mode, sub-block shapes --

def _shared_case(dev, n, g, lmax, d, b, p, bf16, seed):
    """Shared rows ``[n, d]`` and id tables ``[g, lmax]`` with -1 padding
    (a ragged tail per block, an empty block), one hot block that every
    query probes, the slot norms from the rows; and queries, block rows."""
    from rptree_tpu_torch.ops.shared import SharedRows

    gen = torch.Generator().manual_seed(seed)
    rows = torch.randn(n, d, generator=gen)
    ids = torch.randint(0, n, (g, lmax), generator=gen, dtype=torch.int32)
    occ = torch.randint(0, lmax + 1, (g, 1), generator=gen)
    occ[0] = 0
    ids = torch.where(torch.arange(lmax) < occ, ids, -1).to(torch.int32)
    sq = torch.where(ids >= 0, (rows * rows).sum(-1)[ids.clamp_min(0).long()],
                     0.0)
    q = torch.randn(b, d, generator=gen)
    sel = torch.randint(0, g, (b, p), generator=gen, dtype=torch.int32)
    sel[:, 0] = g // 2                     # the hot block
    rows = rows.bfloat16() if bf16 else rows
    return (SharedRows(rows.to(dev), ids.to(dev)), sq.to(dev), q.to(dev),
            sel.to(dev))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,g,lmax,d,b,p", [
    (5000, 300, 160, 128, 64, 8), (900, 40, 24, 20, 9, 3),
    (700, 17, 40, 130, 33, 5), (300, 6, 200, 72, 40, 8),
    (2000, 9, 3128, 128, 2, 3),
])
def test_gather_score_shared(dev, bf16, n, g, lmax, d, b, p):
    """Kernel 6's shared-row mode against its twin (``fetch_blocks`` and
    the einsum): dots within 1e-4, norms bit-equal; D not a multiple of
    the 16-byte vector takes the element loads; counted apart."""
    xs, sq, q, sel = _shared_case(dev, n, g, lmax, d, b, p, bf16, seed=n + d)
    counts = {k: getattr(fg.gather_score, k)
              for k in ("launches", "launches_bf16", "launches_shared")}
    dots, sqx = fg.gather_score(xs, sq, q, sel)
    assert fg.gather_score.launches_shared == counts["launches_shared"] + 1
    assert fg.gather_score.launches == counts["launches"]
    assert fg.gather_score.launches_bf16 == counts["launches_bf16"]
    want_d, want_s = fg.gather_score_reference(xs, sq, q, sel)
    torch.cuda.synchronize()
    _close(dots, want_d)
    assert torch.equal(sqx, want_s)


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_score_shared_bit_equal_to_blocked(dev, bf16):
    """The shared-row mode over a store and the blocked route over the
    blocks those rows make (empty slots zero in both): every dot
    bit-equal."""
    xs, sq, q, sel = _shared_case(dev, 3000, 200, 128, 128, 256, 8, bf16,
                                  seed=5)
    blocks = xs.rows[xs.ids.long().clamp_min(0)]
    blocks = torch.where((xs.ids >= 0)[..., None], blocks, 0).contiguous()
    got, gsq = fg.gather_score(xs, sq, q, sel)
    want, wsq = fg.gather_score(blocks, sq, q, sel)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(gsq, wsq)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,g,lmax,d,b,p", [
    (5000, 300, 160, 128, 64, 8), (900, 40, 24, 20, 9, 3),
    (700, 17, 40, 130, 33, 5), (300, 6, 200, 72, 40, 8),
    (4000, 64, 128, 600, 16, 8), (60, 12, 16, 8, 50, 4),
])
def test_gather_score_shared_routes_bit_equal(dev, bf16, n, g, lmax, d, b, p):
    """The shared-row mode's query route and block route on the same pairs,
    and the blocked route over the blocks the rows make: dots bit-equal,
    norms equal; rows named by several slots of a query (few rows, the
    hot block), ids past N clamped, rows off the 16-byte grid (the element
    loads), D past one 512-byte segment; and the query route's rule in
    plain torch within 1e-4 of the kernel."""
    xs, sq, q, sel = _shared_case(dev, n, g, lmax, d, b, p, bf16, seed=n + b)
    xs.ids[1, :3] = n + 5                  # clamped below N
    assert fg.shared_route(p, lmax, d, xs.rows.element_size())[0] == "query"
    got = fg._gather_score(xs, sq, q, sel, route="query")
    blk = fg._gather_score(xs, sq, q, sel, route="block")
    blocks = xs.rows[xs.ids.long().clamp(0, n - 1)]
    blocks = torch.where((xs.ids >= 0)[..., None], blocks, 0).contiguous()
    dense = fg.gather_score(blocks, sq, q, sel)
    for other in (blk, dense):
        assert torch.equal(got[0].view(torch.int32), other[0].view(torch.int32))
        assert torch.equal(got[1], other[1])
    off = _misaligned(xs.rows)
    from rptree_tpu_torch.ops.shared import SharedRows
    moved = fg._gather_score(SharedRows(off, xs.ids), sq, q, sel,
                             route="query")
    assert torch.equal(moved[0].view(torch.int32), got[0].view(torch.int32))
    rule, rsq, distinct = fg.shared_union_reference(xs, sq, q, sel)
    torch.cuda.synchronize()
    _close(got[0], rule)
    assert torch.equal(got[1], rsq) and int(distinct.min()) >= 0


def test_gather_score_shared_refuses(dev):
    from rptree_tpu_torch.ops.shared import SharedRows

    xs, sq, q, sel = _shared_case(dev, 100, 8, 16, 8, 4, 2, False, seed=1)
    assert fg.gather_score_ok(xs, 2)
    assert not fg.gather_score_ok(SharedRows(xs.rows.to(torch.int8), xs.ids),
                                  2)
    assert not gk.grouped_kernel_ok(xs, "l2")
    with pytest.raises(TypeError):
        fg.gather_score(SharedRows(xs.rows.half(), xs.ids), sq, q, sel)
    with pytest.raises(ValueError):
        fg.gather_score(SharedRows(xs.rows, xs.ids.long()), sq, q, sel)
    with pytest.raises(ValueError):
        fg.gather_score(SharedRows(xs.rows, xs.ids.cpu()), sq, q, sel)
    with pytest.raises(ValueError):
        fg.gather_score(xs, sq[:, :8], q, sel)


@pytest.mark.parametrize("lmax", [16, 32])
def test_tile_kernels_at_sub_block_shapes(dev, lmax):
    """Kernels 1 (f32, bf16), 2 and 4 on sub-blocks: 16 and 32 rows, G
    past 131,072 blocks, tile_m 8, as a sub-blocked pack serves them."""
    g, d, nt, tile_m = 140_000, 128, 4096, 8
    for bf16 in (False, True):
        x, sq, _, tb, lens, qt = _tiles(dev, g, lmax, d, nt, tile_m, False,
                                        seed=lmax, bf16=bf16)
        tb[-8:] = g - 1
        args = (x, sq, tb, lens, qt, "l2", tile_m)
        _close(gk.grouped_score_tiles(*args),
               gk.grouped_score_tiles_reference(*args))
        ids = torch.arange(g * lmax, dtype=torch.int32,
                           device=dev).reshape(g, lmax)
        kp = 8 if lmax == 16 else 16       # 2 * kp <= lmax, as served
        dt, it = gk.grouped_score_topk(x, sq, ids, tb, lens, qt, "l2",
                                       tile_m, kp)
        dw, iw = gk.grouped_score_topk_reference(x, sq, ids, tb, lens, qt,
                                                 "l2", tile_m, kp)
        _close(dt, dw)
        chk = gk.untied(dw, 1e-4)
        assert torch.equal(it[chk], iw[chk])
        del x, sq, ids
    x, sq, scale, tb, lens, qt = _tiles(dev, g, lmax, d, nt, tile_m, True,
                                        seed=lmax + 1)
    args = (x, sq, scale, tb, lens, qt, "l2", tile_m)
    _close(gk.grouped_score_tiles_int8(*args),
           gk.grouped_score_tiles_int8_reference(*args))


@pytest.mark.parametrize("g,b,p", [(262_144, 8192, 32), (524_288, 4096, 64)])
def test_tile_tables_at_sub_block_counts(dev, g, b, p):
    """Kernel 9 at a sub-blocked pack's block counts (4 and 8 sub-blocks
    of 65,536 leaves) and probe widths (8 probes x 4 or 8): its 3-pass
    route, bit-equal to its twin."""
    gsel, lsel, lens = _pairs(dev, g, b, p, seed=g, hot=True, masked=0.05)
    _same_tables(gsel, lsel, lens.clamp_max(32), 8, b * p)


_LAYOUTS = {"f32_sub4": dict(sub_block=4), "int8_sub4": dict(
    dtype=torch.int8, sub_block=4), "int8c": dict(dtype=torch.int8,
                                                 centered=True),
    "int8c_sub8": dict(dtype=torch.int8, centered=True, sub_block=8),
    "shared_f32": dict(store="shared"),
    "shared_bf16": dict(dtype=torch.bfloat16, store="shared")}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_layouts_on_the_card_equal_the_cpu(dev, layout):
    """Each layout packed on the card and on the CPU from one forest: the
    same rows in every block (as sets: the 2-means order sums in other
    float orders on the card), shared slot norms bit-equal to the blocked
    pack's, and every query path on the card (kernels 6 to 9 and
    the tile kernels where the layout takes them) against the same path
    on the CPU."""
    from rptree_tpu_torch import forest_batch
    from rptree_tpu_torch.ops.shared import SharedRows

    rng = np.random.default_rng(4)
    c = rng.normal(size=(40, 24))
    x = (c[rng.integers(0, 40, 6000)]
         + 0.3 * rng.normal(size=(6000, 24))).astype(np.float32)
    q = torch.as_tensor(x[:300] + 0.05)
    fc = forest_batch(3, 8, 16, 4, 1.0, x, device="cpu")
    fd = _to_device(fc, dev)
    fd.seed = fc.seed
    for f in (fc, fd):
        f.pack_leaves(**_LAYOUTS[layout])
    ic, idd = fc._packed[2], fd._packed[2]
    assert torch.equal(torch.sort(idd.cpu(), 1).values,
                       torch.sort(ic, 1).values)
    if isinstance(fd._packed[0], SharedRows):
        assert fd._packed[0].ids is idd
        if fd._packed[0].dtype == torch.float32:
            assert fd._packed[0].rows.data_ptr() == fd.x.data_ptr()
        # slot norms: the blocked pack's sums over the same rows, bit for
        # bit (sq_norms at the ids had parted from them by 2 ulps here)
        blocked = _to_device(fc, dev).pack_leaves(
            dtype=fd._packed[0].dtype)._packed[1]
        assert torch.equal(fd._packed[1], blocked)
    qd = q.to(dev)
    # int8 distances: exact integer dots, but the dequantized terms sum in
    # another float order, ~1e-5 of the norms (~48 here) on distances of
    # ~1-2 (measured 1.05e-4 on sub-blocks of 4); bf16 rows: the f32 rows'
    # norms against the rounded rows' dots leave distances near zero, where
    # the square root widens the same float-order difference (measured
    # 2.3e-4 on the shared bf16 rows' XLA form)
    rtol = 3e-4 if layout.startswith("int8") or "bf16" in layout else 1e-4
    serve = dict(budget=2, probes=6, tile_m=8)
    for kw in (dict(selection="kernel"), dict(impl="xla")):
        _agree(fd.knn_grouped(qd, 10, **serve, **kw),
               fc.knn_grouped(q, 10, **serve, **kw), rtol)
    n6 = fg.gather_score.launches_shared
    _agree(fd.knn_batched(qd, 10, budget=2, chunk=128),
           fc.knn_batched(q, 10, budget=2, chunk=128), rtol)
    _agree(fd.knn_h(qd, 10, budget=2), fc.knn_h(q, 10, budget=2), rtol)
    assert (fg.gather_score.launches_shared > n6) == layout.startswith(
        "shared")


# -- kernel 10: ELL tile scoring -------------------------------------------

def _ell_case(dev, g, lmax, kz, v, b, p, nt, tile_m, seed, masked=0.2):
    """ELL blocks over ``v`` columns with a quarter of the slots padding
    ``(0, 0)``, runs of equal columns (duplicates add), occupancy below
    ``lmax`` (empty slots all padding), f32 norms; queries, their norms
    and tiles over ``b * p`` pairs, a share of the rows empty."""
    from rptree_tpu_torch.ops.sparse import EllBlocks

    gen = torch.Generator().manual_seed(seed)
    cols = torch.randint(0, v, (g, lmax, kz), generator=gen,
                         dtype=torch.int32)
    cols[..., 1::3] = cols[..., ::3][..., :cols[..., 1::3].shape[-1]]
    vals = torch.randn(g, lmax, kz, generator=gen)
    lens = torch.randint(0, lmax + 1, (g,), generator=gen, dtype=torch.int32)
    pad = ((torch.rand(g, lmax, kz, generator=gen) < 0.25)
           | (torch.arange(lmax)[None, :, None] >= lens[:, None, None]))
    cols[pad], vals[pad] = 0, 0.0
    sq = (vals * vals).sum(-1)
    q = torch.randn(b, v, generator=gen)
    tb = torch.randint(0, g, (nt,), generator=gen, dtype=torch.int32)
    tb[: nt // 3] = tb[0]
    tp = torch.randint(0, b * p, (nt, tile_m), generator=gen,
                       dtype=torch.int32)
    tp[torch.rand(nt, tile_m, generator=gen) < masked] = -1
    dv = [t.to(dev) for t in (cols, vals, sq, tb, tp, lens[tb.long()], q)]
    return (EllBlocks(v, dv[0], dv[1]), dv[2], dv[3], dv[4], dv[5], dv[6],
            (dv[6] * dv[6]).sum(-1))


_ELL_SHAPES = {  # g, lmax, K, V, B, P, tiles, tile_m
    "cell_grouped": (64, 128, 32, 65_536, 64, 16, 300, 8),
    "cell_pairs": (64, 128, 32, 65_536, 256, 16, 4096, 1),
    "tile_m_16": (40, 96, 20, 4000, 60, 10, 200, 16),
    "k1": (20, 40, 1, 300, 30, 5, 50, 8),
    "ragged": (16, 24, 5, 97, 20, 3, 33, 3),
    "long_blocks": (8, 300, 7, 500, 10, 4, 20, 8),
    "wide_k": (6, 50, 2000, 3000, 8, 2, 10, 4),   # slots staged in chunks
}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("metric", ["l2", "sql2", "cosine", "dot"])
@pytest.mark.parametrize("shape", list(_ELL_SHAPES))
def test_ell_score_tiles(dev, shape, metric, bf16):
    """Kernel 10 against its plain version: padding, duplicate columns, K
    1, V 65,536, tile_m 1 to 16, blocks past the threads and K past one
    staging of the slots; distances within 1e-4 (the dots sum in other
    orders), +inf at the same places."""
    from rptree_tpu_torch.ops import ell_kernel as ek

    blocks, sq, tb, tp, lens, q, qq = _ell_case(dev, *_ELL_SHAPES[shape], 3)
    if bf16:
        blocks.vals = blocks.vals.bfloat16()
    p = _ELL_SHAPES[shape][5]
    n0 = ek.ell_score_tiles.launches
    got = ek.ell_score_tiles(blocks, sq, tb, tp, lens, q, qq, p, metric)
    want = ek.ell_score_tiles_reference(blocks, sq, tb, tp, lens, q, qq, p,
                                        metric)
    torch.cuda.synchronize()
    assert ek.ell_score_tiles.launches == n0 + 1
    _close(got, want)
    assert torch.isfinite(got).any()


def test_ell_score_tiles_all_masked_and_refusals(dev):
    """Every row empty: all +inf.  The wrapper raises on what the kernel
    does not take: a non-contiguous operand, a CPU operand, other types,
    tile_m past 32, a callable metric."""
    from rptree_tpu_torch.ops import ell_kernel as ek
    from rptree_tpu_torch.ops.sparse import EllBlocks

    blocks, sq, tb, tp, lens, q, qq = _ell_case(dev, 10, 16, 4, 64, 8, 2, 12,
                                                4, 5)
    out = ek.ell_score_tiles(blocks, sq, tb, torch.full_like(tp, -1), lens,
                             q, qq, 2, "l2")
    assert torch.isinf(out).all()
    args = (blocks, sq, tb, tp, lens, q, qq, 2, "l2")
    bad = {5: q.T.contiguous().T, 3: tp.cpu(), 1: sq.double(),
           6: qq.repeat(2)[::2]}
    for i, t in bad.items():
        with pytest.raises((ValueError, TypeError)):
            ek.ell_score_tiles(*args[:i], t, *args[i + 1:])
    with pytest.raises(ValueError):
        ek.ell_score_tiles(EllBlocks(64, blocks.cols.transpose(1, 2)
                                     .contiguous().transpose(1, 2),
                                     blocks.vals), *args[1:])
    with pytest.raises(ValueError):
        ek.ell_score_tiles(blocks, sq, tb[:1],
                           tp[:1].repeat(1, 9)[:, :33].contiguous(),
                           lens[:1], q, qq, 2, "l2")
    with pytest.raises(NotImplementedError):
        ek.ell_score_tiles(*args[:8], lambda x, y: x)


def _ell_forest(dev, n=5000, dim=512, nnz=12, seed=8):
    """A sparse forest built on the CPU and its twin on the card."""
    from rptree_tpu_torch import RPForest, forest_batch
    from rptree_tpu_torch.ops.build import TreeArrays
    from rptree_tpu_torch.ops.sparse import EllMatrix

    rng = np.random.default_rng(seed)
    topic = rng.integers(0, 16, size=(n, 1))
    cols = np.sort(topic * (dim // 16) + rng.integers(0, dim // 16,
                                                      size=(n, nnz)), 1)
    vals = (np.abs(rng.normal(size=(n, nnz))) + 0.1).astype(np.float32)
    fc = forest_batch(seed, 6, 32, 4, 1.0, EllMatrix(dim, cols, vals),
                      device="cpu")
    fd = RPForest(fc.plan, TreeArrays(*(a.to(dev) for a in fc.arrays)),
                  fc.x.to(dev), fc.sq_norms.to(dev), fc.config)
    q = fc.x.to(dev)
    qi = torch.as_tensor(rng.integers(0, n, 300), device=dev)
    return fc, fd, EllMatrix(dim, q.cols[qi], q.vals[qi] * 1.25)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_ell_paths_on_the_card_equal_the_cpu(dev, dtype):
    """A sparse forest on the card and on the CPU: the same slot norms and
    packed blocks, and every query path (per pair and grouped through
    kernel 10, sparse and dense query batches, the ELL scan, the fold)
    alike; kernel 10 launched once per chunk, never on a dense path."""
    from rptree_tpu_torch.ops import ell_kernel as ek
    from rptree_tpu_torch.ops.sparse import ell_to_dense

    fc, fd, qe = _ell_forest(dev)
    assert torch.equal(fd.sq_norms.cpu(), fc.sq_norms)
    for f in (fc, fd):
        f.pack_leaves(dtype=dtype, slack=8)
    for a, b in zip((fd._packed[0].cols, fd._packed[0].vals, *fd._packed[1:]),
                    (fc._packed[0].cols, fc._packed[0].vals, *fc._packed[1:])):
        assert torch.equal(a.cpu(), b)
    qd = ell_to_dense(qe, torch.float32)
    n0 = ek.ell_score_tiles.launches
    runs = {"pair": lambda f, q: f.knn_batched(q, 10, budget=2, chunk=100),
            "grouped": lambda f, q: f.knn_grouped(q, 10, budget=2, chunk=100,
                                                  tile_m=8),
            "kernel_tail": lambda f, q: f.knn_grouped(
                q, 10, budget=2, selection="kernel", tile_m=16),
            "cosine": lambda f, q: f.knn_grouped(q, 10, budget=2,
                                                 metric="cosine"),
            "brute": lambda f, q: f.brute_force_knn(q, 10)}
    for name, run in runs.items():
        _agree(run(fd, qd), run(fc, qd.cpu()))
        if name in ("pair", "grouped"):
            sparse = run(fd, qe)
            assert all(torch.equal(a, b) for a, b in zip(sparse, run(fd, qd)))
    assert ek.ell_score_tiles.launches > n0
    xa = qd[:50] * 0.5   # other points than the queries
    for f in (fc, fd):
        f.add(xa.to(f.device))
        f.fold()
    assert fd.n_folded == fc.n_folded > 0
    assert torch.equal(fd._packed[0].cols.cpu(), fc._packed[0].cols)
    _agree(runs["grouped"](fd, qd), runs["grouped"](fc, qd.cpu()))
    _agree(runs["brute"](fd, qd), runs["brute"](fc, qd.cpu()))


# -- projections: the build's and the queries' bits --------------------------

_PROJ_CELLS = {  # n, D, trees, levels, query chunk: the cells' shapes
    "clustered_1m": (1_000_000, 128, 8, 13, 65_536),
    "iid_100k": (100_000, 128, 8, 10, 32_768),
    "bracket": (100_000, 128, 32, 5, 32),
    "per_pair": (1_000_000, 128, 8, 13, 2_048),
    "shared_10m_rows": (2_000_000, 128, 8, 16, 8_192),
}


@pytest.mark.parametrize("cell", list(_PROJ_CELLS))
def test_build_and_query_projections_bit_equal(dev, cell):
    """The build's projection of every row (``project_dataset``, one
    product per tree) and a query's projection of the same row
    (``project_queries``, all trees at once, a chunk of queries) are the
    same bits on the card, at the cells' shapes: a folded point and a
    query at its place then reach the same leaves (``_descend``)."""
    from rptree_tpu_torch.ops.build import project_dataset
    from rptree_tpu_torch.ops.traverse import project_queries

    n, d, t, lv, chunk = _PROJ_CELLS[cell]
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n, d, device=dev, generator=gen)
    r = torch.randn(t, lv, d, device=dev, generator=gen)
    starts = (0, n // 2 - 17, n - chunk)
    for s in starts:
        pq = project_queries(x[s:s + chunk], r, lv)         # [T, L, B]
        for ti in range(t):
            full = project_dataset(x, r[ti])[s:s + chunk]     # [B, L]
            assert torch.equal(full.T.contiguous().view(torch.int32),
                               pq[ti].view(torch.int32)), (cell, s, ti)


@pytest.mark.parametrize("n,d,nl,ldx", [
    (5000, 128, 13, 128), (777, 24, 40, 24), (300, 65_536, 88, 65_536),
    (129, 1500, 5, 1600), (1, 3, 1, 3)])
def test_project_rows(dev, n, d, nl, ldx):
    """Kernel 11 against the exact product (float64), within the error
    bound of its own order of summation (``project_rows_error_bound``:
    one rounding a column of a 1,024-column segment, one a segment), a
    bound that a segment dropped or doubled breaks; and within that bound
    plus ``torch.matmul``'s own (``D * 2**-24``) of its plain version;
    strided rows; D past one segment; one launch a call."""
    from rptree_tpu_torch.ops import build as ob

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(n, ldx, device=dev, generator=gen)[:, :d]
    r = torch.randn(nl, d, device=dev, generator=gen)
    n0 = ob.project_rows.launches
    got = ob.project_rows(x, r)
    want = ob.project_rows_reference(x, r)
    torch.cuda.synchronize()
    assert ob.project_rows.launches == n0 + 1 and got.shape == (nl, n)
    exact = r.double() @ x.double().T
    terms = r.abs().double() @ x.abs().double().T
    own = (ob.project_rows_error_bound(d) + d * 2.0 ** -53) * terms
    assert bool(((got.double() - exact).abs() <= own).all())
    assert bool(((got - want).abs().double()
                 <= own + d * 2.0 ** -24 * terms).all())
    # the same rows in another batch: the same bits
    sub = ob.project_rows(x[n // 3:].contiguous(), r)
    assert torch.equal(sub.view(torch.int32), got[:, n // 3:].view(torch.int32))
    with pytest.raises(ValueError):
        ob.project_rows(x.T, r.T)


def _project_tile(x, r, tile, lt):
    """Kernel 11 launched on a tile the caller names (``project_plan``'s
    choice set aside)."""
    from rptree_tpu_torch import _cuda

    (n, d), nl = x.shape, r.shape[0]
    lib = _cuda.lib()
    out = torch.empty((nl, n), device=x.device)
    segs = lib.rpt_project_segments(d)
    scratch = torch.empty((segs, nl, n), device=x.device) if segs > 1 else None
    code = lib.rpt_project(
        _cuda.ptr(x), max(x.stride(0), d), _cuda.ptr(r), _cuda.ptr(out),
        None if scratch is None else _cuda.ptr(scratch), n, nl, d, tile, lt,
        _cuda.stream_of(x))
    assert code == 0, code
    return out


def _project_holds(x, r, tiles=True):
    """Kernel 11 on ``x``, ``r``: within its own order's bound of the
    float64 product, a row's bits the same in another batch and, with
    ``tiles``, on each of the three tiles."""
    from rptree_tpu_torch.ops import build as ob

    (n, d), nl = x.shape, r.shape[0]
    n0 = ob.project_rows.launches
    got = ob.project_rows(x, r)
    torch.cuda.synchronize()
    assert ob.project_rows.launches == n0 + 1 and got.shape == (nl, n)
    exact = r.double() @ x.double().T
    terms = r.abs().double() @ x.abs().double().T
    own = (ob.project_rows_error_bound(d) + d * 2.0 ** -53) * terms
    assert bool(((got.double() - exact).abs() <= own).all())
    del exact, terms, own
    s = n // 3
    sub = ob.project_rows(x[s:], r)
    assert torch.equal(sub.view(torch.int32), got[:, s:].view(torch.int32))
    if tiles:
        for tile, (_, tn, rt) in enumerate(ob.PROJECT_TILES):
            lt = 8 if tile >= 3 else min(-(-nl // tn), ob.PROJECT_THREADS // rt)
            assert torch.equal(_project_tile(x, r, tile, lt).view(torch.int32),
                               got.view(torch.int32)), tile


@pytest.mark.parametrize("nl", [1, 13, 88, 104, 160, 200])
@pytest.mark.parametrize("n", [1, 31, 129, 2048])
@pytest.mark.parametrize("d", [1, 31, 32, 33, 1023, 1024, 1025, 3000,
                               65_536])
def test_project_rows_shapes(dev, d, n, nl):
    """Kernel 11 at D on both sides of a 32-column stage and of a
    1,024-column segment, up to the sparse cell's 65,536; from one row to
    a per-pair chunk; from one projection through a tree's 13 levels and
    the served 88 and 104 to two projection tiles (160, 200): within its
    own order's bound of the float64 product, a row's bits the same in
    another batch and on every tile (the order depends on D alone)."""
    gen = torch.Generator(device=dev).manual_seed(d + n + nl)
    x = torch.randn(n, d, device=dev, generator=gen)
    r = torch.randn(nl, d, device=dev, generator=gen)
    _project_holds(x, r)


@pytest.mark.parametrize("nl", [13, 104])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("d", [1, 31, 33, 1025, 3000])
def test_project_rows_strided(dev, d, aligned, nl):
    """Rows with a stride past D: 16-byte aligned rows (the 16-byte
    copies) and odd strides (the 4-byte copies), beside D not a multiple
    of 4 (r's 4-byte copies)."""
    ldx = (-(-d // 4) * 4 + 4) if aligned else d + 1
    gen = torch.Generator(device=dev).manual_seed(d + ldx)
    x = torch.randn(129, ldx, device=dev, generator=gen)[:, :d]
    r = torch.randn(nl, d, device=dev, generator=gen)
    assert x.stride(0) == ldx
    _project_holds(x, r)


def _ell_window_case(dev, tile_m, kz, seed, v, g=24, lmax=40, b=50, p=6,
                     nt=60):
    """ELL blocks of which the even ones keep their columns in a band of
    256 (a narrow window) and the odd ones spread them over ``v`` (a wide
    one), with duplicate columns, padding ``(0, 0)`` and occupancy 0, 1,
    ``lmax`` and between; sparse queries (a fifth of their values 0.0, a
    few -0.0) and tiles of ``tile_m`` rows masked anywhere, a few tiles
    all masked."""
    from rptree_tpu_torch.ops.sparse import EllBlocks

    gen = torch.Generator().manual_seed(seed)
    band = torch.randint(0, v - 256, (g, 1, 1), generator=gen)
    cols = torch.where(torch.arange(g)[:, None, None] % 2 == 0,
                       band + torch.randint(0, 256, (g, lmax, kz),
                                            generator=gen),
                       torch.randint(0, v, (g, lmax, kz), generator=gen))
    cols = cols.to(torch.int32)
    cols[..., 1::3] = cols[..., ::3][..., :cols[..., 1::3].shape[-1]]
    vals = torch.randn(g, lmax, kz, generator=gen)
    lens = torch.randint(0, lmax + 1, (g,), generator=gen, dtype=torch.int32)
    lens[:6] = torch.tensor([0, 1, lmax, 0, 1, lmax], dtype=torch.int32)
    pad = ((torch.rand(g, lmax, kz, generator=gen) < 0.25)
           | (torch.arange(lmax)[None, :, None] >= lens[:, None, None]))
    cols[pad], vals[pad] = 0, 0.0
    sq = (vals * vals).sum(-1)
    q = torch.randn(b, v, generator=gen)
    q[torch.rand(b, v, generator=gen) < 0.8] = 0.0
    q[torch.rand(b, v, generator=gen) < 0.01] = -0.0
    tb = torch.randint(0, g, (nt,), generator=gen, dtype=torch.int32)
    tp = torch.randint(0, b * p, (nt, tile_m), generator=gen,
                       dtype=torch.int32)
    tp[torch.rand(nt, tile_m, generator=gen) < 0.2] = -1
    tp[:3] = -1
    dv = [t.to(dev) for t in (cols, vals, sq, tb, tp, lens[tb.long()], q)]
    return (EllBlocks(v, dv[0], dv[1]), dv[2], dv[3], dv[4], dv[5], dv[6],
            (dv[6] * dv[6]).sum(-1))


@pytest.mark.parametrize("v", [20_000, 140_000])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("metric", ["l2", "sql2", "cosine", "dot"])
@pytest.mark.parametrize("kz", [1, 32, 64])
@pytest.mark.parametrize("tile_m", [1, 3, 8, 16, 32])
def test_ell_score_tiles_routes(dev, tile_m, kz, metric, bf16, v):
    """Kernel 10 with narrow and wide windows of columns in one launch and
    sparse queries (-0.0 among their values): within 1e-4 of its plain
    version, +inf at the same places; each tile on the route of
    ``ell_tile_routes`` (the counts the kernel keeps equal the rule's):
    the support route at V 20,000, L2 at V 140,000 (past the support's
    room in shared memory), the empty tiles; the counting launch the same
    bits as the served one."""
    from rptree_tpu_torch.ops import ell_kernel as ek

    blocks, sq, tb, tp, lens, q, qq = _ell_window_case(
        dev, tile_m, kz, tile_m * 100 + kz, v)
    if bf16:
        blocks.vals = blocks.vals.bfloat16()
    args = (blocks, sq, tb, tp, lens, q, qq, 6, metric)
    n0 = ek.ell_score_tiles.launches
    got = ek.ell_score_tiles(*args)
    counted, routes = ek.ell_score_tiles_routes(*args)
    want = ek.ell_score_tiles_reference(*args)
    torch.cuda.synchronize()
    assert ek.ell_score_tiles.launches == n0 + 1
    _close(got, want)
    assert torch.equal(counted.view(torch.int32), got.view(torch.int32))
    rule = torch.bincount(ek.ell_tile_routes(blocks, tp, lens), minlength=3)
    assert routes.tolist() == rule.tolist() and routes[2] > 0
    assert (routes[0] > 0, routes[1] > 0) == (v == 20_000, v != 20_000)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("b,v", [(1, 1), (3, 31), (3, 32), (50, 97),
                                 (50, 4096), (7, 65_536)])
def test_ell_support_bits(dev, b, v, aligned):
    """Kernel 10's first pass, the queries' support, equals its plain
    version bit for bit: +0.0 clear; nonzeros, -0.0, inf and NaN set; the
    16-byte route (V a multiple of 32, q aligned) and the word-a-warp
    route."""
    from rptree_tpu_torch.ops import ell_kernel as ek

    gen = torch.Generator(device=dev).manual_seed(b * v)
    q = torch.randn(b, v, device=dev, generator=gen)
    q[torch.rand(b, v, device=dev, generator=gen) < 0.9] = 0.0
    q.view(-1)[::7] = -0.0
    q.view(-1)[::11] = float("nan")
    q.view(-1)[::13] = float("inf")
    if not aligned:
        buf = torch.empty(b * v + 1, device=dev)
        buf[1:] = q.reshape(-1)
        q = buf[1:].view(b, v)
    got = ek._ell_support(q)
    torch.cuda.synchronize()
    assert torch.equal(got, ek.ell_support_reference(q))


def _dp_twins(dev, n=20_000, d=64, shards=4):
    """A clustered dataset on the card, its single-device forest and the
    data-parallel forest of the same projections on ``shards`` shards of
    the card."""
    import rptree_tpu_torch as rp
    from rptree_tpu_torch.parallel import (data_mesh,
                                           forest_batch_data_parallel)

    gen = torch.Generator(device=dev).manual_seed(5)
    c = torch.randn(40, d, generator=gen, device=dev)
    x = c[torch.randint(0, 40, (n,), generator=gen, device=dev)]
    x += 0.2 * torch.randn(n, d, generator=gen, device=dev)
    q = x[:512] + 0.05 * torch.randn(512, d, generator=gen, device=dev)
    f1 = rp.forest_batch(3, 8, 32, 4, 1.0, x, device=dev)
    f2 = forest_batch_data_parallel(3, 8, 32, 4, 1.0, x,
                                    mesh=data_mesh(devices=[dev] * shards),
                                    r=f1.arrays.r)
    return f1, f2, q


def test_data_parallel_build_equals_single_device(dev):
    """On the card kernel 11 gives a row the same bits in any batch, so the
    data-parallel trees are the single-device ones: thresholds and margins
    bit-equal on the live segments, the same leaf sets; the leaf-sharded
    f32 blocks then serve grouped what one device serves."""
    from rptree_tpu_torch.ops.grouped_kernel import untied

    f1, f2, q = _dp_twins(dev)
    for name in ("thr", "mgl", "mgh"):
        a, b = getattr(f1.arrays, name), getattr(f2.arrays, name)
        for lvl, lp in enumerate(f1.plan.levels):
            assert torch.equal(a[:, lvl, :lp.n_segs], b[:, lvl, :lp.n_segs])
    for t in range(f1.n_trees):
        assert ([sorted(b) for b in f1.leaves(t)]
                == [sorted(b) for b in f2.leaves(t)])
    for f in (f1, f2):
        f.pack_leaves()
    d1, i1 = f1.knn_grouped(q, 10, budget=2, selection="kernel")
    d2, i2 = f2.knn_grouped(q, 10, budget=2, selection="kernel")
    _close(d2, d1, 1e-5)
    chk = untied(d1, 1e-5)
    chk[:, -1] = False
    assert torch.equal(i1[chk], i2[chk])


def test_all_probes_per_pair_equals_shared_rows(dev):
    """The data-parallel shared rows served per pair in the ``all_probes``
    mode (each shard's kernel 6 over its own members of every probed
    block, then the merge) give one device's shared-row results."""
    from rptree_tpu_torch.ops import fused_gather as fgm
    from rptree_tpu_torch.ops.grouped_kernel import untied

    f1, f2, q = _dp_twins(dev)
    for f in (f1, f2):
        f.pack_leaves(store="shared")
    assert f2._shared_all_probes
    fgm.gather_score.launches_shared = 0
    d2, i2 = f2.knn_batched(q, 10, budget=2, chunk=256)
    assert fgm.gather_score.launches_shared == 4 * 2
    d1, i1 = f1.knn_batched(q, 10, budget=2, chunk=256)
    _close(d2, d1, 1e-5)
    chk = untied(d1, 1e-5)
    chk[:, -1] = False
    assert torch.equal(i1[chk], i2[chk])
