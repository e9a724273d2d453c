"""Host-side rules of kernels 9 and 6's shared-row mode, on the CPU.

Kernel 9 (``ops/grouped.py``): its digit plan (``tile_tables_plan``: the
key's bits split evenly over the fewest passes of at most 11 or 8 bits),
its scratch layout (the regions the upsweep zeroes first, the int64
look-back values 8-byte aligned) and the plan's algorithm in plain torch
(``tile_tables_by_plan``: LSD passes placing each pair by its digit's
start, the look-back sum over earlier chunks and its rank in its chunk),
held equal to the closed form ``_tile_tables`` (the port's twin and the
JAX package's) at G 1 to 524,288, a hot block, all pairs masked and a
capacity overflow; the look-back words it leaves.  Kernel 6 (``ops/
fused_gather.py``): the shared-row route rule by shape and the query
route's union rule (``shared_union_reference``) bit-equal to the twin on
a forest's shared rows.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rptree_tpu_torch as rp
from rptree_tpu.ops import grouped as jg
from rptree_tpu_torch.models import forest as fm
from rptree_tpu_torch.ops import fused_gather as fg
from rptree_tpu_torch.ops import grouped as og

_SRC = Path(og.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("g,max_bits,want", [
    (1, 11, (1,)), (2, 11, (1,)), (256, 11, (8,)), (2048, 11, (11,)),
    (2049, 11, (6, 6)), (16_384, 11, (7, 7)), (65_536, 11, (8, 8)),
    (65_537, 11, (9, 8)), (131_072, 11, (9, 8)), (524_288, 11, (10, 9)),
    (1 << 22, 11, (11, 11)), ((1 << 22) + 1, 11, (8, 8, 7)),
    (2**31 - 1, 11, (11, 11, 9)),
    (256, 8, (8,)), (257, 8, (5, 4)), (65_536, 8, (8, 8)),
    (65_537, 8, (6, 6, 5)), (524_288, 8, (7, 7, 5)),
    ((1 << 24) + 1, 8, (7, 7, 7, 4)),
])
def test_digit_plan(g, max_bits, want):
    """The fewest passes of at most ``max_bits`` that cover the key's
    bits, split evenly, the last pass taking what is left; LSD shifts."""
    plan = og.tile_tables_plan(1000, g, max_bits)
    assert plan.bits == want and plan.passes == len(want)
    assert plan.shifts == tuple(int(np.sum(want[:i])) for i in range(len(want)))
    assert sum(want) == max(1, (g - 1).bit_length())


@pytest.mark.parametrize("n,g", [(0, 1), (1, 1), (5000, 300),
                                 (524_288, 65_536), (65_536, 524_288),
                                 (4_096, 65_537), (2049, 2048)])
@pytest.mark.parametrize("max_bits", [8, 11])
def test_scratch_layout(n, g, max_bits):
    """Regions follow each other in the kernel's order without gaps (one
    pad before the int64 ones, which start 8-byte aligned); the upsweep's
    zeroed regions come first; the look-back words are a chunk and digit
    of every pass; the key buffers hold a pass's output (two for three
    passes or more, none for one)."""
    plan = og.tile_tables_plan(n, g, max_bits)
    names = ["segstate", "flags", "counts", "done", "table", "totals",
             "segagg", "seginc", "base", "bufs"]
    assert list(plan.layout) == names
    at = 0
    for name in names:
        off, size = plan.layout[name]
        if name == "segagg":
            at += at & 1
            assert off % 2 == 0
        assert off == at, name
        at += size
    assert at == plan.length
    rows = sum(1 << b for b in plan.bits)
    assert plan.chunks == max(1, -(-n // 2048))
    assert plan.segs == -(-g // 4096)
    assert plan.layout["flags"][1] == plan.chunks * (rows - (1 << plan.bits[0]))
    assert plan.layout["table"][1] == plan.chunks * rows
    assert plan.layout["table"][0] == plan.segs + plan.layout["flags"][1] \
        + g + 1
    assert plan.layout["bufs"][1] == 2 * n * min(plan.passes - 1, 2)


def test_plan_constants_match_the_source():
    """The plan's constants and the packed arguments are the kernel's
    (``csrc/tile_tables.cu``): threads, rounds, segment, digit bounds; 17
    int64 for the 17 parameters of the launch function; the default digit
    plan 11 bits up to 524,288 pairs, 8 past them."""
    src = (_SRC / "tile_tables.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    warps = const("kThreads") // 32
    assert warps * const("kRounds") * 32 == og._TT_CHUNK
    assert const("kSeg") == og._TT_SEG
    assert (const("kMinBits"), const("kMaxBits")) == (og._TT_MIN_BITS,
                                                      og._TT_MAX_BITS)
    body = src[src.index("int rpt_tile_tables(const long long* packed)"):]
    count = int(re.search(r"long long a\[(\d+)\];", body).group(1))
    assert og._TABLES_ARGS.size == 8 * count
    params = src[src.index("int tile_tables_launch("):]
    assert params[:params.index(")")].count(",") + 1 == count
    for n in (0, 1 << 19, (1 << 19) + 1, 1 << 22):
        assert og.tile_tables_plan(n, 524_288) == og.tile_tables_plan(
            n, 524_288, og.table_digit_bits(n))
    assert (og.table_digit_bits(1 << 19), og.table_digit_bits((1 << 19) + 1)
            ) == (og._TT_MAX_BITS, og._TT_MIN_BITS)


def _pairs(g, b, p, seed, hot=False, masked=0.2):
    rng = np.random.default_rng(seed)
    gsel = rng.integers(0, g, size=(b, p)).astype(np.int32)
    gsel[::3, -1] = g - 1
    if hot:
        gsel[:, 0] = min(5, g - 1)
    lsel = np.where(rng.random((b, p)) < masked, -1, gsel % 97).astype(
        np.int32)
    gsel = np.where(lsel < 0, 0, gsel).astype(np.int32)
    lens = rng.integers(0, 130, size=g).astype(np.int32)
    return gsel, lsel, lens


_CASES = [  # (G, queries, probes, tile_m, hot, masked share, capacity share)
    (1, 33, 3, 8, False, 0.3, None), (256, 300, 8, 8, True, 0.2, None),
    (256, 300, 8, 1, False, 0.0, None), (65_536, 3000, 8, 8, False, 0.1, None),
    (65_537, 700, 8, 3, True, 0.1, None), (300, 999, 5, 8, True, 1.0, None),
    (300, 999, 5, 8, True, 0.2, 0.5), (2049, 4000, 4, 16, True, 0.1, None),
]


@pytest.mark.parametrize("max_bits", [8, 11])
@pytest.mark.parametrize("case", _CASES)
def test_plan_rule_equals_the_closed_form(case, max_bits):
    """The plan's LSD passes give ``_tile_tables``'s five tables bit for
    bit (the port's twin and the JAX package's closed form): a hot block,
    all pairs masked (needed 0), a capacity under the need, tile_m 1 to
    16, one to three passes."""
    g, b, p, tile_m, hot, masked, share = case
    gs, ls, lens = _pairs(g, b, p, seed=g + b, hot=hot, masked=masked)
    gsel, lsel, lens_t = map(torch.as_tensor, (gs, ls, lens))
    need = int(og.tile_tables_reference(gsel, lsel, lens_t, tile_m, 1)[2])
    nt = max(1, need + need // 8 if share is None else int(need * share))
    got = og.tile_tables_by_plan(gsel, lsel, lens_t, tile_m, nt, max_bits)
    want = og.tile_tables_reference(gsel, lsel, lens_t, tile_m, nt)
    for name, a, w in zip(("tb", "tp", "needed", "slot", "lens_t"), got, want):
        assert a.dtype == w.dtype and torch.equal(a, w), name
    if masked == 1.0:
        assert int(got[2]) == 0
    if share is not None:
        assert int(got[2]) > nt
    tb, tp, needed, slot = jg._tile_tables(jnp.asarray(gs), jnp.asarray(ls),
                                           tile_m, nt, with_slots=True)
    for a, w in zip(got[:4], (tb, tp, needed, slot)):
        assert np.array_equal(a.numpy(), np.asarray(w).astype(a.numpy().dtype))


@pytest.mark.parametrize("b,p,tile_m", [(8192, 8, 16), (65_536, 8, 8)])
def test_plan_rule_at_g_524288(b, p, tile_m):
    """The 10M cell's G (524,288 blocks, 128 segments of the c_g scan):
    two passes of 10 and 9 bits, or three of 8 bits or fewer, give the
    twin's tables."""
    g = 524_288
    gsel, lsel, lens = map(torch.as_tensor, _pairs(g, b, p, seed=3, hot=True,
                                                   masked=0.05))
    need = int(og.tile_tables_reference(gsel, lsel, lens, tile_m, 1)[2])
    want = og.tile_tables_reference(gsel, lsel, lens, tile_m, need)
    for max_bits in (8, 11):
        got = og.tile_tables_by_plan(gsel, lsel, lens, tile_m, need, max_bits)
        for a, w in zip(got, want):
            assert torch.equal(a, w)


def test_look_back_words_and_scans():
    """The scratch as the kernel leaves it: the table's first-pass rows
    are each chunk's exclusive prefix of the digit, every row's sum its
    total; each later pass's look-back word of chunk c and digit d is the
    top bit and the pairs of digit d in chunks up to c (chunks past the
    valid pairs publish none); c_g is the valid pairs' count, base the
    exclusive scan of (c_g << 32) + ceil(c_g / tile_m), the segments'
    inclusive prefixes their ends, every segment scanned."""
    g, b, p, tile_m = 9000, 1500, 8, 8
    gsel, lsel, lens = map(torch.as_tensor, _pairs(g, b, p, seed=5,
                                                   hot=True, masked=0.3))
    need = int(og.tile_tables_reference(gsel, lsel, lens, tile_m, 1)[2])
    plan = og.tile_tables_plan(b * p, g, 11)
    assert plan.passes == 2 and plan.segs == 3
    *_, scratch = og.tile_tables_by_plan(gsel, lsel, lens, tile_m, need, 11)

    def region(name):
        off, size = plan.layout[name]
        return scratch[off:off + size]

    key = torch.where(lsel.reshape(-1) >= 0, gsel.reshape(-1).long(), -1)
    counts = torch.bincount(key[key >= 0], minlength=g)
    assert torch.equal(region("counts"), counts)
    valid = key[key >= 0]
    nvalid = valid.numel()
    table = region("table").view(plan.chunks, -1).T
    bins0 = 1 << plan.bits[0]
    chunk = torch.nonzero(key >= 0).reshape(-1) // 2048
    dig = valid & (bins0 - 1)
    hist0 = torch.zeros(bins0, plan.chunks, dtype=torch.int64)
    hist0.index_put_((dig, chunk), torch.ones_like(dig), accumulate=True)
    assert torch.equal(table[:bins0], hist0.cumsum(1) - hist0)
    assert torch.equal(region("totals")[:bins0], hist0.sum(1))
    shift, bits = plan.shifts[1], plan.bits[1]
    bins = 1 << bits
    seq = valid[torch.sort(valid & (bins0 - 1), stable=True).indices]
    ch = torch.arange(nvalid) // 2048
    hist = torch.zeros(plan.chunks, bins, dtype=torch.int64)
    hist.index_put_((ch, (seq >> shift) & (bins - 1)), torch.ones_like(ch),
                    accumulate=True)
    assert torch.equal(region("totals")[bins0:], hist.sum(0))
    words = region("flags").view(plan.chunks, bins)
    ran = -(-nvalid // 2048)
    assert ran < plan.chunks
    assert torch.equal(words[:ran], hist.cumsum(0)[:ran] | (1 << 31))
    assert not bool(words[ran:].any())
    packed = (counts << 32) + (counts + tile_m - 1) // tile_m
    excl = packed.cumsum(0) - packed
    base = region("base").view(-1, 2)
    assert torch.equal(base[:, 0] + (base[:, 1] << 32), excl)
    inc = region("seginc").view(-1, 2)
    ends = [int(packed[:4096 * (s + 1)].sum()) for s in range(plan.segs)]
    assert torch.equal(inc[:, 0] + (inc[:, 1] << 32), torch.tensor(ends))
    assert bool((region("segstate") == 2).all())
    assert int(region("done")[0]) == plan.segs


@pytest.mark.parametrize("p,lmax,d,itemsize,want", [
    (8, 160, 128, 4, ("query", (28, 11))),   # the 10M cell's chunk
    (8, 128, 128, 4, ("query", (28, 11))),   # (n)'s chunk, phase 2
    (8, 128, 128, 2, ("query", (56, 11))),   # bf16 rows
    (3, 24, 20, 4, ("query", (112, 7))),     # one 128-byte chunk a row
    (1, 4, 8, 4, ("query", (112, 6))),
    (8, 256, 600, 4, ("query", (28, 12))),   # 2,048 slots, segments
    (8, 257, 128, 4, ("block", None)),       # past the query's room
    (8, 128, 2049, 4, ("block", None)),
    (32, 3128, 128, 2, ("block", None)),     # the bracket's blocks
])
def test_shared_route(p, lmax, d, itemsize, want):
    """The query route up to 2,048 slots a query and rows of 2,048 values;
    two stages of about 14 KB of rows staged in segments of up to 512
    bytes;
    a hash of at least one and a half times the slots (64 entries at
    least)."""
    got = fg.shared_route(p, lmax, d, itemsize)
    assert got == want
    if got[0] == "query":
        rows, hbits = got[1]
        assert 2 * (1 << hbits) >= 3 * p * lmax and 8 <= rows <= 128


@pytest.fixture(scope="module")
def shared_forest():
    """A forest's shared rows of small dyadic values (every dot exact in
    fp32 in any order) and probe pairs of queries near its points."""
    rng = np.random.default_rng(9)
    x = (rng.integers(-8, 9, size=(3000, 24)) / 4).astype(np.float32)
    q = x[rng.integers(0, 3000, size=64)] + (
        rng.integers(-2, 3, size=(64, 24)) / 8).astype(np.float32)
    cfg = rp.rp_tree_cfg(32, *x.shape)
    f = rp.forest_batch(7, cfg.max_depth, 32, 4, 1.0, x, device="cpu")
    return f, torch.as_tensor(q)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_union_rule_on_shared_rows(shared_forest, dtype):
    """The query route's rule (each query's distinct rows, one dot each,
    written to every slot naming the row, a zero row's dot in empty
    slots) bit-equal to the twin on a forest's shared rows, f32 and bf16;
    a query reads fewer rows than its filled slots name."""
    f, q = shared_forest
    f.pack_leaves(dtype=dtype, store="shared")
    rows, sq_leaf, _ = f._packed
    sel, _ = fm._probe_pairs(f, q, 2, 8, 10)
    sel = sel.contiguous()
    assert fg.shared_route(sel.shape[1], rows.shape[1], rows.shape[2],
                           rows.rows.element_size())[0] == "query"
    got, gsq, distinct = fg.shared_union_reference(rows, sq_leaf, q, sel)
    want, wsq = fg.gather_score_reference(rows, sq_leaf, q, sel)
    assert torch.equal(got, want) and torch.equal(gsq, wsq)
    filled = (rows.ids[sel.long()] >= 0).reshape(q.shape[0], -1).sum(1)
    assert bool((distinct <= filled).all()) and bool((distinct < filled).any())


@pytest.mark.parametrize("e,nt,tile_m", [(0, 0, 8), (10, 5, 8),
                                          (524_288, 104_049, 8)])
def test_tables_buffers(e, nt, tile_m):
    """Kernel 9's five outputs cut from one allocation, its scratch apart:
    ``slot`` int64 first (8-byte aligned on the card), the shapes and
    dtypes of the twin's tables, no two views overlapping."""
    tb, tp, needed, slot, lens_t = og._tables_buffers(torch.device("cpu"), e,
                                                      nt, tile_m)
    assert slot.dtype == torch.int64 and slot.shape == (e,)
    assert slot.storage_offset() == 0
    assert tb.shape == lens_t.shape == (nt,) and tp.shape == (nt, tile_m)
    assert needed.shape == () and needed.dtype == torch.int32
    spans = sorted((t.storage_offset() * t.element_size(),
                    (t.storage_offset() + t.numel()) * t.element_size())
                   for t in (tb, tp, needed, slot, lens_t))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] == (2 * e + nt * (tile_m + 2) + 1) * 4
