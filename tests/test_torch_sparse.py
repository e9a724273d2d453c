"""Sparse (ELL) data in the port against the JAX package: the ELL tables
and their operations, the build on ELL rows, the packed ELL blocks, kernel
10's plain version against the JAX package's XLA-form ELL step, and the
JAX package's refusals.  The serving paths are in
``test_torch_sparse_serve.py``.

Each test mirrors one of ``tests/test_sparse.py`` or holds a port
function against its JAX twin on the same numpy inputs.  Floats agree
within 1e-5 relative (sums over the slots run in other orders: the port
adds slot by slot), integer outputs (cols, perms, ids, tables) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import rptree_tpu as rt
from rptree_tpu.ops import grouped as jg
from rptree_tpu.ops import sparse as js
from rptree_tpu.utils import gen as jgen
import rptree_tpu_torch as tp
from rptree_tpu_torch.ops import ell_kernel as ek
from rptree_tpu_torch.ops import grouped as tg
from rptree_tpu_torch.ops import sparse as ts

from torch_parity import carry, one_torch_thread  # noqa: F401

RTOL = 1e-5


def random_svecs(n, dim, pnz, seed=0):
    """``tests/test_sparse.py``'s sparse vectors, as both packages'
    ``SVec``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = np.nonzero(rng.random(dim) < pnz)[0]
        if idx.size == 0:
            idx = np.array([rng.integers(dim)])
        out.append((idx, rng.normal(size=idx.size)))
    return ([rt.SVec(dim, i, v) for i, v in out],
            [tp.SVec(dim, i, v) for i, v in out])


def bow(seed, n, dim, nnz, bands=8):
    """Bag-of-words rows like ``examples/bow_sparse.py``'s, from numpy:
    ``nnz`` columns drawn in one of ``bands`` topic bands (duplicates
    kept: they add), values ``|N(0, 1)| + 0.1``."""
    rng = np.random.default_rng(seed)
    width = dim // bands
    topic = rng.integers(0, bands, size=(n, 1))
    cols = np.sort(topic * width + rng.integers(0, width, size=(n, nnz)),
                   axis=1).astype(np.int32)
    vals = (np.abs(rng.normal(size=(n, nnz))) + 0.1).astype(np.float32)
    return cols, vals


def test_ell_pack_and_densify():
    sj, st = random_svecs(50, 20, 0.3)
    mj, mt = js.ell_from_svecs(sj), ts.ell_from_svecs(st)
    assert mt.cols.dtype == torch.int32 and mt.vals.dtype == torch.float32
    assert (mt.n, mt.k, mt.dim, mt.shape) == (mj.n, mj.k, mj.dim, mj.shape)
    np.testing.assert_array_equal(mt.cols.numpy(), np.asarray(mj.cols))
    np.testing.assert_array_equal(mt.vals.numpy(), np.asarray(mj.vals))
    dense = ts.ell_to_dense(mt).numpy()
    np.testing.assert_array_equal(dense, np.asarray(js.ell_to_dense(mj)))
    expect = np.stack([tp.to_dense(s) for s in st]).astype(np.float32)
    np.testing.assert_allclose(dense, expect, rtol=1e-6)


def test_ell_to_dense_adds_duplicate_columns_in_slot_order():
    """Duplicate columns add, slot by slot, to the JAX package's bits."""
    cols, vals = bow(1, 400, 64, 24, bands=16)  # ~4 duplicate pairs a row
    assert (np.diff(cols, axis=1) == 0).any()
    vals = vals * np.float32(1.0 / 3.0)
    got = ts.ell_to_dense(ts.EllMatrix(64, cols, vals)).numpy()
    want = np.asarray(js.ell_to_dense(js.EllMatrix(64, cols, vals)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_ell_from_scipy_like_and_back_to_svecs():
    sj, st = random_svecs(30, 40, 0.2, seed=6)
    mj = js.ell_from_svecs(sj)
    nnz = (np.asarray(mj.cols) != 0) | (np.asarray(mj.vals) != 0)
    indptr = np.concatenate([[0], np.cumsum(nnz.sum(1))])
    indices = np.asarray(mj.cols)[nnz]
    data = np.asarray(mj.vals)[nnz]
    cj = js.ell_from_scipy_like(indptr, indices, data, 40)
    ct = ts.ell_from_scipy_like(indptr, indices, data, 40)
    np.testing.assert_array_equal(ct.cols.numpy(), np.asarray(cj.cols))
    np.testing.assert_array_equal(ct.vals.numpy(), np.asarray(cj.vals))
    rows = [0, 7, 29]
    for a, b in zip(ts.ell_rows_to_svecs(ct, rows),
                    js.ell_rows_to_svecs(cj, rows)):
        np.testing.assert_array_equal(a.idx, b.idx)
        np.testing.assert_array_equal(a.val, b.val)


def test_ell_project_matches_jax_and_dense():
    sj, st = random_svecs(30, 16, 0.4, seed=1)
    mj, mt = js.ell_from_svecs(sj), ts.ell_from_svecs(st)
    r = np.asarray(jgen.sample_projections(1, 1, 3, 16, 1.0))[0]  # [3, 16]
    for rr in (r[0], r):
        got = ts.ell_project(mt, torch.as_tensor(rr)).numpy()
        want = np.asarray(js.ell_project(mj, jnp.asarray(rr)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    expect = np.stack([tp.to_dense(s) for s in st]) @ r[0]
    np.testing.assert_allclose(ts.ell_project(mt, torch.as_tensor(r[0])),
                               expect, rtol=1e-4, atol=1e-5)


def test_ell_sq_norms():
    sj, st = random_svecs(10, 8, 0.5, seed=2)
    got = ts.ell_sq_norms(ts.ell_from_svecs(st)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(js.ell_sq_norms(js.ell_from_svecs(sj))), rtol=RTOL)
    expect = np.array([np.sum(tp.to_dense(s) ** 2) for s in st])
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def test_sparse_build_perm_matches_jax_and_densified():
    """``tests/test_sparse.py``'s build on 400 sparse rows: the port's
    perm equals the JAX package's on the same projections, with the same
    thresholds, and equals its own build of the densified rows; knn of a
    dataset row finds itself at distance ~0 in both."""
    sj, st = random_svecs(400, 32, 0.25, seed=3)
    mj, mt = js.ell_from_svecs(sj), ts.ell_from_svecs(st)
    fj = rt.forest_batch(7, 5, 10, 3, 0.5, mj)
    r = np.asarray(fj.arrays.r)
    fs = tp.forest_batch(7, 5, 10, 3, 0.5, mt, device="cpu", r=r)
    fd = tp.forest_batch(7, 5, 10, 3, 0.5, ts.ell_to_dense(mt), device="cpu",
                         r=r)
    perm = np.asarray(fj.arrays.perm)
    np.testing.assert_array_equal(fs.arrays.perm.numpy(), perm)
    np.testing.assert_array_equal(fd.arrays.perm.numpy(), perm)
    for name in ("thr", "mgl", "mgh"):
        np.testing.assert_allclose(getattr(fs.arrays, name).numpy(),
                                   np.asarray(getattr(fj.arrays, name)),
                                   rtol=RTOL, atol=RTOL)
    q = tp.to_dense(st[0]).astype(np.float32)
    ds, is_ = fs.knn(q, 5)
    dd, id_ = fd.knn(q, 5)
    np.testing.assert_array_equal(is_.numpy(), id_.numpy())
    # squared distances within the factored form's fp32 bound, 1e-5 of
    # |x|^2 + |q|^2 (the self-distance is that cancellation alone)
    qq = float((q * q).sum())
    np.testing.assert_allclose(ds.numpy() ** 2, dd.numpy() ** 2, rtol=1e-4,
                               atol=2e-5 * qq)
    assert int(is_[0, 0]) == 0 and float(ds[0, 0]) ** 2 < 2e-5 * qq
    # tree_batch: one tree, the same perm as the JAX package's
    tj = rt.tree_batch(7, 5, 10, 0.5, mj)
    tt = tp.tree_batch(7, 5, 10, 0.5, mt, device="cpu",
                       r=np.asarray(tj.arrays.r))
    np.testing.assert_array_equal(tt.arrays.perm.numpy(),
                                  np.asarray(tj.arrays.perm))


def test_high_dim_bag_of_words_shape():
    """Sparse high-dim rows (dim >> nnz): the port's perm equals the JAX
    package's."""
    sj, st = random_svecs(128, 5000, 0.002, seed=5)
    mt = ts.ell_from_svecs(st)
    assert mt.dim == 5000 and mt.k < 40
    fj = rt.forest_batch(2, 4, 8, 2, 0.05, js.ell_from_svecs(sj))
    f = tp.forest_batch(2, 4, 8, 2, 0.05, mt, device="cpu",
                        r=np.asarray(fj.arrays.r))
    assert f.tree_size() == 128 and f.dim == 5000
    np.testing.assert_array_equal(f.arrays.perm.numpy(),
                                  np.asarray(fj.arrays.perm))


def test_forest_from_numpy_reads_an_ell_forest():
    """A JAX ELL forest's arrays (header ``"sparse"``, ``x_cols`` /
    ``x_vals``) carry into the port: the dataset, its norms and the
    arrays."""
    cols, vals = bow(2, 600, 96, 6)
    fj = rt.forest_batch(4, 4, 16, 2, 1.0, js.EllMatrix(96, cols, vals))
    ft = carry(fj)
    assert isinstance(ft.x, ts.EllMatrix) and ft.dim == 96
    np.testing.assert_array_equal(ft.x.cols.numpy(), cols)
    np.testing.assert_array_equal(ft.x.vals.numpy(), vals)
    np.testing.assert_allclose(ft.sq_norms.numpy(), np.asarray(fj.sq_norms),
                               rtol=RTOL)
    np.testing.assert_array_equal(ft.arrays.perm.numpy(),
                                  np.asarray(fj.arrays.perm))


# -- packing ---------------------------------------------------------------

@pytest.fixture(scope="module")
def packed_pair():
    cols, vals = bow(4, 900, 128, 8)
    fj = rt.forest_batch(5, 4, 16, 3, 1.0, js.EllMatrix(128, cols, vals))
    return fj, carry(fj)


@pytest.mark.parametrize("dtype,slack", [(None, 0), ("bf16", 0), (None, 8)])
def test_pack_ell_blocks_equal_jax(packed_pair, dtype, slack):
    """EllBlocks ``[G, lmax + slack, K]``: cols, values (bf16 rounded to
    nearest even), slot norms and ids equal to the JAX package's; padding
    ``(0, 0)``, no slot alignment."""
    fj, ft = packed_pair
    fj.pack_leaves(dtype=jnp.bfloat16 if dtype else None, slack=slack)
    ft.pack_leaves(dtype=torch.bfloat16 if dtype else None, slack=slack)
    (bj, sqj, idj), (bt, sqt, idt) = fj._packed, ft._packed
    assert isinstance(bt, ts.EllBlocks) and bt.dim == bj.dim
    assert bt.shape == tuple(bj.shape)
    assert bt.shape[1] == fj.plan.max_leaf_len + slack
    assert bt.dtype == (torch.bfloat16 if dtype else torch.float32)
    np.testing.assert_array_equal(bt.cols.numpy(), np.asarray(bj.cols))
    np.testing.assert_array_equal(bt.vals.float().numpy(),
                                  np.asarray(bj.vals.astype(jnp.float32)))
    np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))
    np.testing.assert_allclose(sqt.numpy(), np.asarray(sqj), rtol=RTOL)
    # the same layout again is a no-op; another one repacks
    same = ft._packed
    ft.pack_leaves(dtype=torch.bfloat16 if dtype else None, slack=slack)
    assert ft._packed is same
    ft.pack_leaves(dtype=None if dtype else torch.bfloat16, slack=slack)
    assert ft._packed is not same


REFUSALS = {  # pack_leaves arguments: the JAX package's ValueError text
    "shared": (dict(store="shared"), "store='shared' applies to dense"),
    "centered": (dict(dtype="int8", centered=True),
                 "centered quantization applies to dense"),
    "sub_block": (dict(sub_block=4), "sub_block applies to dense"),
    "int8": (dict(dtype="int8"), "int8 quantization applies to dense"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_pack_refusals_match_jax(packed_pair, case):
    fj, ft = packed_pair
    kw, text = REFUSALS[case]
    kw = dict(kw)
    dt = kw.pop("dtype", None)
    with pytest.raises(ValueError, match=text):
        fj.pack_leaves(dtype=jnp.int8 if dt else None, **kw)
    with pytest.raises(ValueError, match=text):
        ft.pack_leaves(dtype=torch.int8 if dt else None, **kw)


# -- kernel 10's plain version ---------------------------------------------

def _ell_operands():
    """ELL blocks with partial occupancy (padding past it), their norms,
    queries and pairs: G 20, lmax 12, K 6, dim 48, B 40, P 5, a fifth of
    the pairs masked, one block probed by every fourth query."""
    rng = np.random.default_rng(12)
    g, lmax, kz, dim, b, p = 20, 12, 6, 48, 40, 5
    cols = rng.integers(0, dim, size=(g, lmax, kz)).astype(np.int32)
    vals = rng.normal(size=(g, lmax, kz)).astype(np.float32)
    vals[..., -1] = 0.0
    cols[..., -1] = 0                                # a padding slot
    lens = rng.integers(1, lmax + 1, size=g).astype(np.int32)
    empty = np.arange(lmax)[None, :] >= lens[:, None]
    cols[empty], vals[empty] = 0, 0.0
    sq = (vals * vals).sum(-1).astype(np.float32)
    q = rng.normal(size=(b, dim)).astype(np.float32)
    gsel = rng.integers(0, g, size=(b, p)).astype(np.int32)
    gsel[::4, 0] = 3
    lsel = np.where(rng.uniform(size=(b, p)) < 0.2, -1, gsel).astype(np.int32)
    gsel = np.where(lsel < 0, 0, gsel).astype(np.int32)
    return dim, cols, vals, sq, lens, gsel, lsel, q


_JAX_ELL = {}


def _jax_ell_distances(dtype, metric, nt, tile_chunk):
    key = (dtype, metric, nt)
    if key not in _JAX_ELL:
        dim, cols, vals, sq, lens, gsel, lsel, q = _ell_operands()
        vj = jnp.asarray(vals, jnp.bfloat16 if dtype == "bf16" else None)
        d, need = jax.jit(
            jg.grouped_distances,
            static_argnames=("metric", "precision", "tile_m", "nt",
                             "tile_chunk"))(
            js.EllBlocks(dim, jnp.asarray(cols), vj), jnp.asarray(sq),
            jnp.asarray(lens), jnp.asarray(gsel), jnp.asarray(lsel),
            jnp.asarray(q), metric=metric, precision=lax.Precision.HIGHEST,
            tile_m=4, nt=nt, tile_chunk=tile_chunk)
        _JAX_ELL[key] = (np.asarray(d), int(need))
    return _JAX_ELL[key]


@pytest.mark.parametrize("nt,tile_chunk", [(64, 16), (32, 8)])  # 32 < needed
@pytest.mark.parametrize("metric", ["l2", "sql2", "cosine", "dot"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ell_scoring_matches_jax(dtype, metric, nt, tile_chunk):
    """The port's grouped ELL scoring (kernel 9's and kernel 10's plain
    versions, ``tile_chunk`` tiles a step) against the JAX package's
    XLA-form ELL branch, every metric, f32 and bf16 values, with a
    capacity above and below the tiles needed."""
    dim, cols, vals, sq, lens, gsel, lsel, q = _ell_operands()
    vt = torch.as_tensor(vals)
    if dtype == "bf16":
        vt = vt.bfloat16()
    blocks = ts.EllBlocks(dim, torch.as_tensor(cols), vt)
    want, need_j = _jax_ell_distances(dtype, metric, nt, tile_chunk)
    got, need_t = tg.grouped_distances(
        blocks, *map(torch.as_tensor, (sq, lens, gsel, lsel, q)), metric, 4,
        nt, tile_chunk)
    assert int(need_t) == need_j == 45
    got = got.numpy()
    assert got.shape == want.shape == (40, 5, 12)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("tile_m", [1, 3, 8])
def test_ell_tiles_of_one_equal_the_grouped_rows(tile_m):
    """The per-pair path's form (each pair a tile of one, in pair order)
    gives each pair the row the grouped tiles give it; the plain
    version's step cap changes nothing."""
    dim, cols, vals, sq, lens, gsel, lsel, q = _ell_operands()
    blocks = ts.EllBlocks(dim, torch.as_tensor(cols), torch.as_tensor(vals))
    sq_t, lens_t, q_t = map(torch.as_tensor, (sq, lens, q))
    b, p = gsel.shape
    grouped, _ = tg.grouped_distances(
        blocks, sq_t, lens_t, torch.as_tensor(gsel), torch.as_tensor(lsel),
        q_t, "l2", tile_m, b * p, 2048)
    tb = torch.as_tensor(gsel.reshape(-1))
    tpair = torch.where(torch.as_tensor(lsel.reshape(-1)) >= 0,
                        torch.arange(b * p, dtype=torch.int32), -1)[:, None]
    for step in (16, 2048):
        pairs = ek.ell_score_tiles(blocks, sq_t, tb, tpair, lens_t[tb.long()],
                                   q_t, (q_t * q_t).sum(-1), p, "l2", step)
        assert torch.equal(pairs.reshape(b, p, -1), grouped)


def test_ell_scoring_refuses_callables_and_unknown_metrics():
    dim, cols, vals, sq, lens, gsel, lsel, q = _ell_operands()
    blocks = ts.EllBlocks(dim, torch.as_tensor(cols), torch.as_tensor(vals))
    args = (blocks, *map(torch.as_tensor, (sq, lens, gsel, lsel, q)))
    with pytest.raises(NotImplementedError, match="dense data rows"):
        tg.grouped_distances(*args, lambda x, y: (x - y).abs().sum(-1), 4,
                             64, 16)
    with pytest.raises(ValueError, match="unknown metric"):
        tg.grouped_distances(*args, "l1", 4, 64, 16)
    assert ek.ell_tile_chunk_cap(128, 32, 65_536, 8, 2048) == 128
    assert ek.ell_tile_chunk_cap(12, 6, 48, 4, 2048) == 2048
