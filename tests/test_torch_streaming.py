"""Streaming construction in the port against the JAX package
(``streaming.py``): ``forest`` / ``tree`` over a source of chunks or rows
give JAX's streamed forest and the port's batch build, the anytime
``partial_index`` follows JAX's after every chunk, and the builder keeps
JAX's errors and payloads.

The JAX package draws its projections inside its builder; the tests hand
the same small-integer projections to both (each package's sampler
replaced for the test), and the data are small integers, so that
every projection is exact on both sides and the trees are compared bit
for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rptree_tpu as rt
from rptree_tpu.utils import gen as jgen
import rptree_tpu_torch as rp
import rptree_tpu_torch.parallel  # noqa: F401  (rp.parallel)
from rptree_tpu_torch.utils import gen as tgen

from torch_parity import knn_agree, one_torch_thread  # noqa: F401

FIELDS = ("perm", "thr", "mgl", "mgh")
DIM = 6


def int_data(seed, n, dim=DIM):
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 5, size=(n, dim)).astype(np.float32)


@pytest.fixture
def jax_r(monkeypatch):
    """Small-integer projections for a seed's shape, and both packages'
    samplers replaced by them for the test."""
    def make(seed, n_trees, depth, dim, pnz=1.0, dtype=None, *, device=None):
        rng = np.random.default_rng(seed)
        return rng.integers(-2, 3, size=(n_trees, depth, dim)).astype(
            np.float32)

    monkeypatch.setattr(jgen, "sample_projections",
                        lambda *a, **kw: jnp.asarray(make(*a, **kw)))
    monkeypatch.setattr(tgen, "sample_projections",
                        lambda *a, device=None, **kw: torch.as_tensor(
                            make(*a, **kw), device=device))
    return make


def assert_same_trees(ft, fj):
    for k in FIELDS:
        a, b = getattr(ft.arrays, k).numpy(), np.asarray(getattr(fj.arrays, k))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def _source(x, kind, size):
    if kind == "rows":
        return iter(list(x))
    return iter([x[s:s + size] for s in range(0, len(x), size)])


@pytest.mark.parametrize("kind", ["chunks", "rows"])
@pytest.mark.parametrize("n_trees", [1, 3])
def test_streamed_forest_matches_jax_and_batch(jax_r, kind, n_trees):
    """``forest`` (``tree`` for one tree) with JAX's projections: JAX's
    streamed ``perm``, ``thr``, ``mgl``, ``mgh`` bit for bit, and the
    port's batch build over the same rows."""
    x = int_data(1, 700)
    depth, min_leaf, chunk = 6, 8, 128
    r = jax_r(11, n_trees, depth, DIM)
    if n_trees == 1:
        fj = rt.tree(11, depth, min_leaf, chunk, 1.0, DIM,
                     _source(x, kind, chunk))
        ft = rp.tree(11, depth, min_leaf, chunk, 1.0, DIM,
                     _source(x, kind, chunk), device="cpu")
    else:
        fj = rt.forest(11, depth, min_leaf, n_trees, chunk, 1.0, DIM,
                       _source(x, kind, chunk))
        ft = rp.forest(11, depth, min_leaf, n_trees, chunk, 1.0, DIM,
                       _source(x, kind, chunk), device="cpu")
    np.testing.assert_array_equal(np.asarray(fj.arrays.r), r)
    np.testing.assert_array_equal(ft.arrays.r.numpy(), r)
    assert_same_trees(ft, fj)
    fb = rp.forest_batch(11, depth, min_leaf, n_trees, 1.0, x, device="cpu",
                         r=r)
    for k in FIELDS:
        assert torch.equal(getattr(ft.arrays, k), getattr(fb.arrays, k)), k
    assert torch.equal(ft.x, fb.x)
    assert ft.config == fb.config.__class__(**{**vars(fb.config),
                                               "chunk_size": chunk})
    assert vars(ft.config) == vars(fj.config)


@pytest.mark.parametrize("chunk", [1, 97, 1000])
def test_streamed_equals_batch_on_float_data(chunk):
    """Float rows in chunks of any size: the port's streamed forest is its
    batch build over the concatenated rows, with its own projections."""
    x = np.random.default_rng(2).normal(size=(1000, 8)).astype(np.float32)
    b = rp.ForestBuilder(5, 6, 10, 2, 0.5, 8, chunk_size=chunk, device="cpu")
    for s in range(0, len(x), chunk):
        b.insert_chunk(torch.as_tensor(x[s:s + chunk]))
    fs, fb = b.build(), rp.forest_batch(5, 6, 10, 2, 0.5, x, device="cpu")
    assert b.n_points == 1000 and b.build() is fs
    for k in ("r", *FIELDS):
        assert torch.equal(getattr(fs.arrays, k), getattr(fb.arrays, k)), k


def test_partial_index_follows_jax(jax_r):
    """``anytime_slack``: after every chunk the partial index has JAX's
    candidates and pending and folded counts; at the end, served per pair
    with its pending merge, JAX's neighbours; ``build()`` is the batch
    build."""
    x = int_data(3, 1200)
    q = x[::40] + 0.5
    depth, min_leaf, t, slack = 6, 16, 2, 8
    r = jax_r(13, t, depth, DIM)
    bj = rt.ForestBuilder(13, depth, min_leaf, t, 1.0, DIM,
                          anytime_slack=slack)
    bt = rp.ForestBuilder(13, depth, min_leaf, t, 1.0, DIM,
                          anytime_slack=slack, device="cpu")
    for s, e in ((0, 400), (400, 800), (800, 1200)):
        c = x[s:e]
        bj.insert_chunk(c)
        bt.insert_chunk(c)
        pj, pt = bj.partial_index, bt.partial_index
        assert (pt.n_pending, pt.n_folded) == (pj.n_pending, pj.n_folded)
        np.testing.assert_array_equal(pt.candidates(q, budget=2).numpy(),
                                      np.asarray(pj.candidates(q, budget=2)))
    knn_agree(pt.knn(q, 5, budget=2), pj.knn(q, 5, budget=2))
    assert bt.partial_index.n_folded > 0 and bt.partial_index.n_pending > 0
    assert bt.partial_index.plan.n == 400
    assert_same_trees(bt.build(), bj.build())


def test_builder_payloads_and_rebuilds():
    b = rp.ForestBuilder(0, 4, 5, 2, 1.0, 3, periodic_rebuild_every=1,
                         device="cpu")
    b.insert_chunk(np.ones((4, 3), np.float32), payloads=["a", "b", "c", "d"])
    assert b.build().tree_size() == 4
    b.insert_chunk(np.zeros((2, 3), np.float32))
    b.insert_chunk(np.zeros(3, np.float32), payloads=["g"])
    f = b.build()
    assert f.payloads == ["a", "b", "c", "d", None, None, "g"]
    assert f.tree_size() == 7 and f.device.type == "cpu"


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_builder_keeps_its_own_copy(kind):
    """A source may reuse its buffer for the next chunk: the builder holds
    a copy of each chunk, never the caller's memory."""
    buf = np.ones((40, 3), np.float32)
    if kind == "tensor":
        buf = torch.as_tensor(buf)
    b = rp.ForestBuilder(0, 4, 5, 2, 1.0, 3, device="cpu")
    b.insert_chunk(buf)
    buf[:] = 7.0
    b.insert_chunk(buf)
    x = b.build().x
    assert (x[:40] == 1.0).all() and (x[40:] == 7.0).all()


@pytest.mark.parametrize("case", ["empty", "chunk_dim", "row_dim",
                                  "payloads", "mesh", "data_parallel",
                                  "no_card"])
def test_builder_errors(case, monkeypatch):
    """JAX's errors (an empty source, a wrong chunk dim, a payload count
    that does not match; on a data mesh, streamed rows that do not divide
    the shards at the finalize, and an ``anytime_slack`` first chunk that
    does not); without a card and without ``device="cpu"`` (or a mesh)
    ``ForestBuilder`` raises."""
    if case in ("mesh", "data_parallel"):
        mesh = rp.parallel.data_mesh(4, devices=["cpu"] * 4)
        if case == "mesh":
            b = rp.ForestBuilder(0, 4, 5, 2, 1.0, 3, mesh=mesh)
            b.insert_chunk(np.ones((10, 3), np.float32))
            with pytest.raises(ValueError, match=r"streamed rows \(10\) "
                               "must divide the data-shard count"):
                b.build()
        else:
            monkeypatch.setattr(rp.parallel.data_parallel, "data_mesh",
                                lambda *a, **kw: mesh)
            b = rp.ForestBuilder(0, 4, 5, 2, 1.0, 3, data_parallel=True,
                                 anytime_slack=4)
            with pytest.raises(ValueError, match=r"first chunk \(6 rows\) "
                               "to divide the 4 data shards"):
                b.insert_chunk(np.ones((6, 3), np.float32))
        return
    if case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rp.ForestBuilder(0, 4, 5, 2, 1.0, 3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rp.forest(0, 4, 5, 2, 10, 1.0, 3, [np.ones((4, 3))])
        return
    b = rp.ForestBuilder(0, 4, 5, 2, 1.0, 3, device="cpu")
    with pytest.raises(ValueError):
        {"empty": lambda: b.build(),
         "chunk_dim": lambda: b.insert_chunk(np.ones((2, 5), np.float32)),
         "row_dim": lambda: b.insert_chunk(np.ones(4, np.float32)),
         "payloads": lambda: b.insert_chunk(np.ones((2, 3), np.float32),
                                            payloads=["x"])}[case]()
    assert b.n_points == 0


@pytest.mark.parametrize("anytime", [0, 8])
def test_streamed_data_parallel_equals_batch_and_jax(jax_r, anytime):
    """``mesh=`` a data mesh: the chunks go round-robin over its devices,
    the finalize re-chunks them into the shards' contiguous rows in ingest
    order and builds data-parallel: the batch data-parallel build of the
    concatenated rows bit for bit, and the leaf sets and (live) thresholds
    of JAX's streamed forest (tie-heavy integer data: equal points split
    in the single-device order).  With ``anytime_slack`` the partial index
    is a data-parallel forest with leaf-sharded slack blocks, whose
    counts and candidate sets are a single-device anytime index's."""
    x = int_data(4, 800)
    q = x[::50] + 0.5
    depth, min_leaf, t, chunk = 6, 12, 2, 100
    r = jax_r(17, t, depth, DIM)
    mesh = rp.parallel.data_mesh(4, devices=["cpu"] * 4)
    bt = rp.ForestBuilder(17, depth, min_leaf, t, 1.0, DIM, mesh=mesh,
                          anytime_slack=anytime)
    bs = rp.ForestBuilder(17, depth, min_leaf, t, 1.0, DIM,
                          anytime_slack=anytime, device="cpu")
    bj = rt.ForestBuilder(17, depth, min_leaf, t, 1.0, DIM)
    for s in range(0, len(x), chunk):
        for b in (bt, bs, bj):
            b.insert_chunk(x[s:s + chunk])
    assert [c.device for c in bt._chunks] == [torch.device("cpu")] * 8
    if anytime:
        pt, ps = bt.partial_index, bs.partial_index
        assert isinstance(pt, rp.parallel.DataParallelForest)
        assert (pt.n_pending, pt.n_folded) == (ps.n_pending, ps.n_folded)
        ct, cs = (torch.sort(p.candidates(q, budget=2), dim=-1).values
                  for p in (pt, ps))
        assert torch.equal(ct, cs)
    ft, fj = bt.build(), bj.build()
    assert isinstance(ft, rp.parallel.DataParallelForest)
    assert [p.shape[0] for p in ft.x.parts] == [200] * 4
    for k in range(t):
        assert ([sorted(b) for b in ft.leaves(k)]
                == [sorted(b) for b in fj.leaves(k)])
    for k in ("thr", "mgl", "mgh"):
        a, b = getattr(ft.arrays, k).numpy(), np.asarray(getattr(fj.arrays, k))
        for lvl, lp in enumerate(ft.plan.levels):
            np.testing.assert_array_equal(a[:, lvl, :lp.n_segs],
                                          b[:, lvl, :lp.n_segs])
    fb = rp.parallel.forest_batch_data_parallel(17, depth, min_leaf, t, 1.0,
                                                x, mesh=mesh, r=r)
    for k in FIELDS:  # bit for bit (the unused segments hold NaN, as JAX's)
        a, b = getattr(ft.arrays, k), getattr(fb.arrays, k)
        assert a.numpy().tobytes() == b.numpy().tobytes(), k
    assert torch.equal(torch.cat(ft.x.parts), torch.as_tensor(x))
