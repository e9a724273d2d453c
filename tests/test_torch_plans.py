"""Host-side choices of kernels 10 and 11, on the CPU.

Kernel 11's tile plan (``ops/build.py`` ``project_plan``) and kernel 10's
route rule (``ops/ell_kernel.py`` ``ell_tile_routes``, the kernel's own
rule in plain torch), held against the shapes the served paths give them
and against a rule written out tile by tile.  Neither imports JAX.
"""

import numpy as np
import pytest
import torch

from rptree_tpu_torch.ops import build as ob
from rptree_tpu_torch.ops import ell_kernel as ek
from rptree_tpu_torch.ops.sparse import EllBlocks

_SMEM = 227 * 1024  # an H100 block's shared memory


def _smem_bytes(tile, lt):  # csrc/project.cu launch: a ring of 32 columns
    tm, tn, rt = ob.PROJECT_TILES[tile]
    return (2 if tile == 2 else 3) * (tm * rt + tn * lt) * 36 * 4


@pytest.mark.parametrize("shape,want", [
    ((65_536, 104, 128), (5, 8)),       # clustered query chunk
    ((32_768, 80, 128), (3, 8)),        # iid query chunk
    ((2048, 104, 128), (1, 13)),        # per-pair chunk
    ((32, 160, 128), (1, 14)),          # the bracket's 32 queries, T 32
    ((1_000_000, 13, 128), (2, 2)),     # a tree of the 1M build
    ((4096, 88, 65_536), (4, 8)),       # the sparse cell's query chunk
    ((8192, 128, 128), (1, 16)),        # the 10M cell's per-pair chunk
    ((65_536, 40, 128), (0, 5)),        # a share of at most 64
])
def test_project_plan_served_shapes(shape, want):
    """The tile of each served shape on 132 multiprocessors: 8 rows x L / 8
    projections a thread where the row tiles fill the card, 4 x 4 where
    they do not, 4 x 8 for a tree's 13 levels."""
    assert ob.project_plan(*shape, 132) == want


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("d", [1, 128, 1025, 65_536])
def test_project_plan_covers_every_projection(d, sms):
    """For every n and L: a known tile, at most 256 threads a block, the
    projection tiles cover L with none empty, shared memory for two blocks
    an SM, tile 2 exactly where L <= 16, a wide tile only where its
    blocks are at least one a multiprocessor and tile 1 only where they
    are not."""
    segs = -(-d // ob.PROJECT_SEGMENT)
    for n in (1, 31, 129, 2048, 65_536, 1_000_000):
        for nl in (1, 8, 13, 16, 17, 64, 65, 80, 81, 88, 104, 105, 128, 129,
                   160, 200, 257):
            tile, lt = ob.project_plan(n, nl, d, sms)
            tm, tn, rt = ob.PROJECT_TILES[tile]
            assert 1 <= lt and lt * rt <= ob.PROJECT_THREADS
            bl = tn * lt
            tiles = -(-nl // bl)
            assert (tiles - 1) * bl < nl <= tiles * bl
            assert 2 * _smem_bytes(tile, lt) <= _SMEM
            assert (tile == 2) == (nl <= 16)
            wide = ob.project_plan(10 ** 9, nl, d, sms)
            wtm, wtn, wrt = ob.PROJECT_TILES[wide[0]]
            fills = (-(-n // (wtm * wrt)) * -(-nl // (wtn * wide[1])) * segs
                     >= sms)
            if nl > 16:
                assert (tile, lt) == (wide if fills else (tile, lt))
                assert (tile == 1) == (not fills)


def _routes_by_hand(tp, lens_t, lmax, v):
    """Kernel 10's rule, one tile at a time."""
    words = -(-v // 32)
    fits = (words * 4 <= ek.ELL_SUPPORT_BYTES_ONE if tp.shape[1] == 1
            else 16 * words <= ek.ELL_SUPPORT_BYTES)
    return [2 if not (tp[t] >= 0).any() or min(max(int(lens_t[t]), 0), lmax) == 0
            else 0 if fits else 1 for t in range(tp.shape[0])]


@pytest.mark.parametrize("v", [20_000, 140_000])
@pytest.mark.parametrize("tile_m", [1, 3, 8, 32])
def test_ell_tile_routes_follow_the_kernel_rule(tile_m, v):
    """Empty and full occupancy, rows masked anywhere and tiles all
    masked: each tile's route is the rule's: +inf for the empty tiles, the
    support route at V 20,000 and L2 at V 140,000 (past the support's
    room in shared memory) for the others."""
    rng = np.random.default_rng(tile_m)
    g, lmax, kz, nt = 12, 20, 6, 80
    cols = rng.integers(-5, v + 5, size=(g, lmax, kz))
    vals = rng.standard_normal((g, lmax, kz)).astype(np.float32)
    lens = rng.integers(0, lmax + 1, size=g)
    lens[:3] = (0, 1, lmax)
    tb = rng.integers(-1, g + 1, size=nt)
    tp = rng.integers(0, 50, size=(nt, tile_m))
    tp[rng.random((nt, tile_m)) < 0.4] = -1
    tp[:4] = -1
    lens_t = lens[np.clip(tb, 0, g - 1)]
    blocks = EllBlocks(v, torch.as_tensor(cols, dtype=torch.int32),
                       torch.as_tensor(vals))
    got = ek.ell_tile_routes(blocks, *(torch.as_tensor(a, dtype=torch.int32)
                                       for a in (tp, lens_t)))
    want = _routes_by_hand(tp, lens_t, lmax, v)
    assert got.tolist() == want
    assert set(want) == ({0, 2} if v == 20_000 else {1, 2})


def test_ell_score_tiles_routes_on_the_cpu():
    """On the CPU the counting wrapper gives the plain version's distances
    and the rule's counts."""
    rng = np.random.default_rng(5)
    g, lmax, kz, v, b, p, nt, m = 6, 10, 4, 3000, 8, 3, 20, 4
    cols = torch.as_tensor(rng.integers(0, v, size=(g, lmax, kz)),
                           dtype=torch.int32)
    cols[::2] = cols[::2] % 64
    vals = torch.as_tensor(rng.standard_normal((g, lmax, kz)),
                           dtype=torch.float32)
    blocks = EllBlocks(v, cols, vals)
    sq = (vals * vals).sum(-1)
    tb = torch.as_tensor(rng.integers(0, g, size=nt), dtype=torch.int32)
    tp = torch.as_tensor(rng.integers(-1, b * p, size=(nt, m)),
                         dtype=torch.int32)
    lens_t = torch.full((nt,), lmax, dtype=torch.int32)
    q = torch.as_tensor(rng.standard_normal((b, v)), dtype=torch.float32)
    args = (blocks, sq, tb, tp, lens_t, q, (q * q).sum(-1), p, "l2")
    d, routes = ek.ell_score_tiles_routes(*args)
    assert torch.equal(d, ek.ell_score_tiles_reference(*args))
    want = torch.bincount(ek.ell_tile_routes(blocks, tp, lens_t),
                          minlength=3)
    assert routes.tolist() == want.tolist() and int(routes.sum()) == nt
    assert routes[0] > 0


def test_ell_support_reference_bits():
    """The queries' support: bit i of word w set where q[:, 32 w + i] is
    not +0.0, words padded with clear bits past V."""
    rng = np.random.default_rng(9)
    b, v = 5, 77
    q = rng.standard_normal((b, v)).astype(np.float32)
    q[rng.random((b, v)) < 0.7] = 0.0
    q[0, 3], q[1, 40], q[2, 76] = -0.0, np.nan, np.inf
    got = ek.ell_support_reference(torch.as_tensor(q)).numpy().view(np.uint32)
    for i in range(b):
        for c in range(96):
            bit = (int(got[i, c // 32]) >> (c % 32)) & 1
            assert bit == (c < v and q[i, c].view(np.uint32) != 0), (i, c)
