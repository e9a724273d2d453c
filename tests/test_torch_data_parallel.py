"""The port's data-parallel forests (``rptree_tpu_torch.parallel.
data_parallel``): the build and the queries over the sharded raw rows,
against the JAX package's ``forest_batch_data_parallel`` on conftest's
eight virtual CPU devices and against the port's own single-device
forest.  The port's meshes list the CPU device 1, 4 or 8 times.

The sizes are ``tests/test_data_parallel.py``'s (N 1,600, D 24, T 3,
depth 6, ``min_leaf`` 12).  Two cases:

* JAX's float rows with JAX's own projections handed to the port: the
  port's data-parallel permutation is JAX's bit for bit (each leaf's
  points in original-index order in both), thresholds and margins within
  1e-6 (relative, and absolute near 0: the two packages' products may
  part in the last bits);
* tie-heavy data, small-integer rows and projections fed to both packages
  (JAX's sampler replaced for the build), so every projection is exact
  and many distinct points tie at a median.  The single-device build
  splits equal points by their earlier levels' order; so does the port's
  data-parallel build, whose leaf sets, thresholds and margins (live
  segments) are then the single-device build's, the port's and JAX's,
  bit for bit.  The JAX package's data-parallel build splits them by
  index and leaves them elsewhere (ROADMAP.md queue 3):
  :func:`test_jax_data_parallel_splits_ties_by_index` pins that, so that
  a fix shows.

Tolerances: integer outputs equal (``perm``, leaf sets, ids outside
near-ties); distances within 1e-5 (``knn_agree``, JAX's own
``test_queries_match_single_device`` bound); recall within 1e-6.
"""

import numpy as np
import pytest
import torch

import rptree_tpu as rt
import rptree_tpu.parallel as jpar
import rptree_tpu_torch as rp
import rptree_tpu_torch.parallel as tpar
from rptree_tpu_torch.parallel.collectives import Sharded
from rptree_tpu_torch.parallel.data_parallel import process_local_rows

from torch_parity import knn_agree, one_torch_thread  # noqa: F401

SEED, N, DIM, T, MAXD, MINL, PNZ = 909, 1600, 24, 3, 6, 12, 1.0
CPU = torch.device("cpu")
SHARDS = [1, 4, 8]


def mesh(s, n_query=1):
    return tpar.data_mesh(s, devices=[CPU] * (s * n_query), n_query=n_query)


@pytest.fixture(scope="module")
def case():
    """Integer rows and projections (tie-heavy), float queries, and the
    JAX package's single-device forest of them and its data-parallel one
    on eight devices."""
    rng = np.random.default_rng(99)
    x = rng.integers(-3, 4, size=(N, DIM)).astype(np.float32)
    r = rng.integers(-2, 3, size=(T, MAXD, DIM)).astype(np.float32)
    q = (2.0 * np.random.default_rng(100).normal(size=(13, DIM))).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("rptree_tpu.utils.gen.sample_projections",
                   lambda *a, **kw: r)
        jax_single = rt.forest_batch(SEED, MAXD, MINL, T, PNZ, x)
        jax_dp = jpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ, x,
                                                 mesh=jpar.data_mesh(8))
    return dict(x=x, r=r, q=q, jax_single=jax_single, jax_dp=jax_dp)


@pytest.fixture(scope="module")
def floats():
    """JAX's test data (float rows) and the JAX package's data-parallel
    forests of them, one a mesh, with its own projections."""
    x = np.random.default_rng(11).normal(size=(N, DIM)).astype(np.float32)
    jax_dp = {s: jpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ, x,
                                                 mesh=jpar.data_mesh(s))
              for s in SHARDS}
    return dict(x=x, jax_dp=jax_dp, r=np.array(jax_dp[8].arrays.r))


def port_dp(case, s=8, n_query=1, data=None):
    return tpar.forest_batch_data_parallel(
        SEED, MAXD, MINL, T, PNZ, case["x"] if data is None else data,
        mesh=mesh(s, n_query), r=case["r"])


def live_equal(a, b, plan):
    """Thresholds / margins ``[T, L, S_max]`` equal on every level's live
    segments."""
    for lvl, lp in enumerate(plan.levels):
        np.testing.assert_array_equal(np.asarray(a)[:, lvl, :lp.n_segs],
                                      np.asarray(b)[:, lvl, :lp.n_segs])


def leaf_sets(f):
    return [[set(b) for b in f.leaves(t)] for t in range(f.n_trees)]


def test_data_mesh_shapes_and_refusals(monkeypatch):
    m = mesh(8)
    assert m.shape == {"data": 8} == jpar.data_mesh(8).shape
    assert mesh(4, 2).shape == {"data": 4, "query": 2} == dict(
        jpar.data_mesh(4, n_query=2).shape)
    assert len(m.devices.flatten()) == 8 and m.device(5) == CPU
    assert tpar.data_mesh(devices=[CPU] * 6, n_query=2).shape == {
        "data": 3, "query": 2}
    assert tpar.data_mesh(2, devices=[CPU] * 8).shape == {"data": 2}
    with pytest.raises(ValueError, match="exceeds"):
        tpar.data_mesh(5, devices=[CPU] * 8, n_query=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.data_mesh()


@pytest.mark.parametrize("s", SHARDS)
def test_trees_equal_jax(floats, s):
    """The JAX package's data-parallel build on its own test data: the
    permutation bit for bit (each leaf's points in original-index order
    in both), the projections, and the thresholds and margins within 1e-6
    (relative, and absolute near 0: the two packages' products may part
    in the last bits); the dataset's parts are views of the caller's
    tensor, N/S rows each."""
    xt = torch.as_tensor(floats["x"])
    f = tpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ, xt,
                                        mesh=mesh(s), r=floats["r"])
    fj = floats["jax_dp"][s]
    np.testing.assert_array_equal(f.arrays.perm.numpy(),
                                  np.asarray(fj.arrays.perm))
    np.testing.assert_array_equal(f.arrays.r.numpy(), np.asarray(fj.arrays.r))
    for name in ("thr", "mgl", "mgh"):
        for lvl, lp in enumerate(f.plan.levels):
            np.testing.assert_allclose(
                getattr(f.arrays, name)[:, lvl, :lp.n_segs].numpy(),
                np.asarray(getattr(fj.arrays, name))[:, lvl, :lp.n_segs],
                rtol=1e-6, atol=1e-6)
    assert isinstance(f.x, Sharded) and len(f.x.parts) == s
    assert all(p.shape[0] == N // s for p in f.x.parts)
    assert f.x.parts[0].data_ptr() == xt.data_ptr()
    assert f.tree_size() == N and f.device == CPU


@pytest.mark.parametrize("s", SHARDS)
def test_tie_heavy_trees_equal_single_device(case, s):
    """Tie-heavy integer data: points equal to a median split in the
    single-device build's order (their earlier levels' projections), so
    the leaf sets are the single-device build's, the port's and the JAX
    package's, and so are the thresholds and margins on the live
    segments, bit for bit."""
    f = port_dp(case, s)
    single = rp.forest_batch(SEED, MAXD, MINL, T, PNZ, case["x"],
                             device="cpu", r=case["r"])
    fj = case["jax_single"]
    assert leaf_sets(f) == leaf_sets(single) == leaf_sets(fj)
    for name in ("thr", "mgl", "mgh"):
        live_equal(getattr(f.arrays, name), getattr(single.arrays, name),
                   f.plan)
        live_equal(getattr(f.arrays, name), getattr(fj.arrays, name), f.plan)


@pytest.mark.parametrize("s", SHARDS)
def test_float_trees_equal_single_device(s):
    """Float rows (JAX's test data): each shard's projections are rows of
    the whole product, so the data-parallel thresholds and margins are the
    single-device build's bit for bit and every leaf holds its point set
    (the order within a leaf differs by design)."""
    x = np.random.default_rng(11).normal(size=(N, DIM)).astype(np.float32)
    single = rp.forest_batch(SEED, MAXD, MINL, T, PNZ, x, device="cpu")
    r = single.arrays.r
    xt = torch.as_tensor(x)
    whole = rp.ops.build.project_dataset(xt, r[0])
    per = N // s
    for i in range(s):
        sliced = rp.ops.build.project_dataset(xt[i * per:(i + 1) * per], r[0])
        assert torch.equal(sliced, whole[i * per:(i + 1) * per])
    f = tpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ, x,
                                        mesh=mesh(s), r=r)
    for name in ("thr", "mgl", "mgh"):
        live_equal(getattr(f.arrays, name), getattr(single.arrays, name),
                   f.plan)
    assert leaf_sets(f) == leaf_sets(single)


def test_jax_data_parallel_splits_ties_by_index(case):
    """The JAX package's data-parallel build splits points equal to a
    median by index, so on tie-heavy data some of its leaves hold other
    points than its own single-device build's (the port's data-parallel
    build holds the single-device sets: the test above).  Pinned, so that
    a fix in the JAX package shows."""
    jax_sets, one_sets = leaf_sets(case["jax_dp"]), leaf_sets(
        case["jax_single"])
    assert jax_sets != one_sets
    assert leaf_sets(port_dp(case)) == one_sets


def test_quantized_ties_match_single_device():
    """JAX's tie-heavy edge case (rows of half-integers, whose ties are
    rows that repeat): the distributed equal-split quota gives the
    single-device leaf sets, the port's and JAX's."""
    x = (np.round(np.random.default_rng(5).normal(size=(1600, 6)) * 2)
         / 2).astype(np.float32)
    f1 = rp.forest_batch(9, 5, 12, 2, 1.0, x, device="cpu")
    f2 = tpar.forest_batch_data_parallel(9, 5, 12, 2, 1.0, x, mesh=mesh(8),
                                         r=f1.arrays.r)
    fj = jpar.forest_batch_data_parallel(9, 5, 12, 2, 1.0, x,
                                         mesh=jpar.data_mesh(8))
    f3 = tpar.forest_batch_data_parallel(9, 5, 12, 2, 1.0, x, mesh=mesh(8),
                                         r=np.array(fj.arrays.r))
    assert leaf_sets(f2) == leaf_sets(f1)
    assert leaf_sets(f3) == leaf_sets(fj)


def test_negative_zero_projections():
    """``-0.0`` and ``+0.0`` keys tie, as the single-device build's float
    comparisons tie them: the same leaf sets and neighbours."""
    x = np.zeros((160, 2), np.float32)
    x[80:, 0] = -0.0
    x[:, 1] = np.arange(160)
    f1 = rp.forest_batch(3, 3, 10, 1, 1.0, x, device="cpu")
    f2 = tpar.forest_batch_data_parallel(3, 3, 10, 1, 1.0, x, mesh=mesh(8),
                                         r=f1.arrays.r)
    assert f2.tree_size() == 160 and leaf_sets(f2) == leaf_sets(f1)
    d1, _ = f1.knn(x[:3], 4)
    d2, _ = f2.knn(x[:3], 4)
    assert torch.equal(d1, d2)


@pytest.mark.parametrize("what", ["indivisible", "single_leaf", "r_shape",
                                  "process_rows"])
def test_build_edges(case, what):
    """JAX's refusal of an indivisible row count; the single-leaf plan;
    the port's ``r`` checked; :func:`process_local_rows` in one process is
    the sharded dataset."""
    x = case["x"]
    if what == "indivisible":
        with pytest.raises(ValueError, match="not divisible by 8"):
            tpar.forest_batch_data_parallel(SEED, 6, 12, 1, 1.0, x[:1593],
                                            mesh=mesh(8))
    elif what == "single_leaf":
        f = tpar.forest_batch_data_parallel(SEED, 0, 12, 1, 1.0, x[:800],
                                            mesh=mesh(8))
        assert f.tree_size() == 800 and f.plan.n_leaves == 1
        np.testing.assert_array_equal(f.arrays.perm.numpy(),
                                      np.arange(800)[None])
        knn_agree(f.knn(case["q"], 5), f.brute_force_knn(case["q"], 5))
    elif what == "r_shape":
        with pytest.raises(ValueError, match="r must be"):
            tpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ, x,
                                            mesh=mesh(8), r=case["r"][:1])
    else:
        rows = process_local_rows(torch.as_tensor(x), N, mesh(8))
        f = port_dp(case, data=rows)
        assert f.x is rows
        assert torch.equal(f.arrays.perm, port_dp(case).arrays.perm)
        with pytest.raises(ValueError, match="holds 8 shards"):
            process_local_rows(x[:800], N, mesh(8))


QUERIES = ["knn", "knn_nodedup", "knn_h", "min_votes", "brute_force",
           "recall"]


@pytest.mark.parametrize("what", QUERIES)
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_raw_queries_equal_jax(case, what, shape):
    """The queries over the sharded raw rows (each shard reranks the
    candidates it owns, then the merge) on a 1-D and a (data, query)
    mesh, against the JAX package's single-device forest of the same
    leaf sets."""
    f = port_dp(case, *shape)
    fj = case["jax_single"]
    q = case["q"]
    calls = {
        "knn": lambda g: g.knn(q, 5, budget=4),
        "knn_nodedup": lambda g: g.knn(q, 5, budget=4, dedup=False),
        "knn_h": lambda g: g.knn_h(q, 5, budget=4),
        "min_votes": lambda g: g.knn(q, 5, budget=4, min_votes=2),
        "brute_force": lambda g: g.brute_force_knn(q, 9),
        "recall": lambda g: g.recall_with(q, 5, budget=4),
    }
    got, want = calls[what](f), calls[what](fj)
    if what == "recall":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    else:
        knn_agree(got, want)


def test_query_axis_splits_the_batch(case):
    """A (data, query) mesh serves each query shard's slice of the batch
    (an odd batch padded) on its own devices: the same results as the
    1-D mesh, bit for bit."""
    q = np.concatenate([case["q"], case["q"][:9] + 0.5])        # 22 rows
    f1, f2 = port_dp(case), port_dp(case, 4, 2)
    qb, b = f2._queries(q)
    assert b == 22 and qb.shape[0] == 22 and len(f2._cell_list(1)) == 4
    for fn in ("knn", "knn_h", "brute_force_knn"):
        got = getattr(f2, fn)(q, 5)
        want = getattr(f1, fn)(q, 5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_brute_force_knn_sharded_equals_jax(case, kind):
    """The sharded exact scan of a dataset (no forest), dense and ELL."""
    q = case["q"][:7]
    if kind == "dense":
        data_t = data_j = case["x"]
    else:
        rng = np.random.default_rng(21)
        cols = rng.integers(0, DIM, size=(N, 4)).astype(np.int32)
        vals = rng.integers(-3, 4, size=(N, 4)).astype(np.float32)
        data_t = rp.EllMatrix(DIM, cols, vals)
        data_j = rt.EllMatrix(DIM, cols, vals)
    got = tpar.brute_force_knn_sharded(data_t, q, 9, mesh=mesh(8))
    want = jpar.brute_force_knn_sharded(data_j, q, 9, mesh=jpar.data_mesh(8))
    knn_agree(got, want)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.brute_force_knn_sharded(case["x"][:1599], q, 3, mesh=mesh(8))


def test_memory_complete_end_to_end(case, monkeypatch):
    """Build, pack, every query path and serve-only mode with the dataset
    sharded throughout: ``Sharded.whole`` raises for the dataset and the
    blocks, and no shard holds more than its 1/S of either."""
    def refuse(self):
        raise AssertionError("a sharded table was made whole")

    monkeypatch.setattr(Sharded, "whole", refuse)
    f = port_dp(case)
    q = case["q"]
    assert {p.shape[0] for p in f.x.parts} == {N // 8}
    assert {p.shape[0] for p in f.sq_norms.parts} == {N // 8}
    fj = case["jax_single"]
    knn_agree(f.brute_force_knn(q, 5), fj.brute_force_knn(q, 5))
    np.testing.assert_allclose(f.recall_with(q, 5, budget=4).numpy(),
                               np.asarray(fj.recall_with(q, 5, budget=4)),
                               atol=1e-6)
    unpacked = f.knn(q, 5, budget=16)
    f.pack_leaves()
    g_total = T * f.plan.n_leaves
    assert {p.shape[0] for p in f._packed[0].parts} == {-(-g_total // 8)}
    packed = f.knn(q, 5, budget=16)
    knn_agree(packed, unpacked)
    knn_agree(f.knn_grouped(q, 5, budget=16), packed)
    f.knn_h(q, 5, budget=4)
    f.drop_dataset()
    assert f.x is None
    knn_agree(f.knn(q, 5, budget=16), packed, rtol=1e-6)
    with pytest.raises(ValueError, match="dataset dropped"):
        f.brute_force_knn(q, 5)
