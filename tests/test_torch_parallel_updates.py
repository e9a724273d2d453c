"""The port's sharded forests under updates and the surfaces around them:
``fold`` into tree- and leaf-sharded blocks (dense, centered int8, ELL),
``rebuild`` replaying the pack in its shard mode, ``recall_with`` after a
fold, tombstones and the pending merge, the inherited accessors and
checkpoints, ``tune`` / ``tune_build`` on a sharded handle and
``run_bench`` on a mesh; against the JAX package's ``DistributedForest``
where it runs the same sequence, and against the port's single-device
forest.  Sizes and data are ``test_torch_parallel.py``'s."""

import dataclasses

import numpy as np
import pytest
import torch

import rptree_tpu as rt
import rptree_tpu.parallel as jpar
import rptree_tpu_torch as rp
import rptree_tpu_torch.parallel as tpar
from rptree_tpu_torch import benchmarks

from torch_parity import knn_agree, one_torch_thread  # noqa: F401

SEED, N, DIM, T, MAXD, MINL, PNZ = 7071, 1500, 32, 8, 6, 16, 1.0
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    """Integer rows and projections (``test_torch_parallel.py``'s), 12
    new points of quarters, queries, and the JAX package's forest."""
    rng = np.random.default_rng(99)
    x = rng.integers(-3, 4, size=(N, DIM)).astype(np.float32)
    r = rng.integers(-2, 3, size=(T, MAXD, DIM)).astype(np.float32)
    new = (rng.integers(-12, 13, size=(12, DIM)) / 4).astype(np.float32)
    q = (2.0 * np.random.default_rng(100).normal(size=(13, DIM))).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("rptree_tpu.utils.gen.sample_projections",
                   lambda *a, **kw: r)
        jax_single = rt.forest_batch(SEED, MAXD, MINL, T, PNZ, x)
    return dict(x=x, r=r, new=new, q=q, jax_single=jax_single)


def mesh(shape):
    return tpar.forest_mesh(*shape, devices=[CPU] * (shape[0] * shape[1]))


def twins(case, shape, **pack):
    """A sharded forest and a single-device one of the same trees, both
    packed as asked (the single one without ``shard_by``)."""
    f = tpar.forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, case["x"],
                                      mesh=mesh(shape), r=case["r"])
    fs = rp.forest_batch(SEED, MAXD, MINL, T, PNZ, case["x"], device="cpu",
                         r=case["r"])
    if pack:
        f.pack_leaves(**pack)
        fs.pack_leaves(**{k: v for k, v in pack.items() if k != "shard_by"})
    return f, fs


@pytest.mark.parametrize("shape,mode", [((8, 1), "tree"), ((4, 2), "leaf")])
def test_fold_both_modes_then_rebuild(case, shape, mode):
    """Folded points land in the shards' slack slots through the storage
    map (``_fold_row_of``): served as one device serves them on every
    path, and as the JAX package serves them; ``rebuild`` builds
    tree-parallel and packs again in the same shard mode."""
    q, new = case["q"], case["new"]
    f, fs = twins(case, shape, shard_by=mode, slack=8)
    for g in (f, fs):
        g.add(new)
        g.fold()
    assert f.n_folded == fs.n_folded == 12 and f.n_pending == 0
    np.testing.assert_array_equal(f._block_len, fs._block_len)
    nl = f.plan.n_leaves
    qn = new + 1e-3
    got = f.knn(qn, 3, budget=nl)
    knn_agree(got, fs.knn(qn, 3, budget=nl))
    assert (got[1][:, 0] >= N).all()
    knn_agree(f.knn_batched(q, 5, budget=8, chunk=4),
              fs.knn_batched(q, 5, budget=8, chunk=4))
    knn_agree(f.knn_h(qn, 3, budget=nl), fs.knn_h(qn, 3, budget=nl))
    assert torch.equal(f.knn_h_buckets(qn, 3, budget=4),
                       fs.knn_h_buckets(qn, 3, budget=4))
    if mode == "leaf":
        knn_agree(f.knn_grouped(qn, 3, budget=nl),
                  fs.knn_grouped(qn, 3, budget=nl))
        fj = jpar.distribute(case["jax_single"], jpar.forest_mesh(*shape))
        fj.pack_leaves(shard_by=mode, slack=8)
        fj.add(new)
        fj.fold()
        # the folded points find themselves; distances this near 0 are
        # all rounding, so they are compared on the other queries
        both = np.concatenate([qn, q])
        d, i = f.knn(both, 3, budget=nl)
        dj, ij = map(np.asarray, fj.knn(both, 3, budget=nl))
        np.testing.assert_array_equal(i[:12, 0].numpy(), ij[:12, 0])
        knn_agree((d[12:], i[12:]), (dj[12:], ij[12:]))
    f.rebuild()
    fs.rebuild()
    assert isinstance(f, tpar.DistributedForest) and f._packed_mode == mode
    assert f.tree_size() == N + 12 and f.n_folded == 0
    assert torch.equal(f.arrays.perm, fs.arrays.perm)
    knn_agree(f.knn(q, 5, budget=8), fs.knn(q, 5, budget=8))


def test_recall_after_fold(case):
    """``recall_with`` on a folded tree-sharded forest (the folded-aware
    truth, each shard's trees matched by the leaves the rows were folded
    into) equals the JAX package's and the single-device forest's."""
    q, new = case["q"], case["new"][:6]
    f, fs = twins(case, (8, 1), slack=8)
    fj = jpar.distribute(case["jax_single"], jpar.forest_mesh(8, 1))
    fj.pack_leaves(slack=8)
    for g in (f, fs, fj):
        g.add(new)
        g.fold()
    rec = f.recall_with(q, 10, budget=16).numpy()
    np.testing.assert_allclose(rec, np.asarray(fj.recall_with(
        q, 10, budget=16)), atol=1e-6)
    np.testing.assert_allclose(rec, fs.recall_with(q, 10, budget=16).numpy(),
                               atol=1e-6)
    assert (f.recall_with(new[:2], 1, budget=16).numpy() > 0.99).all()


def test_centered_fold_writes_the_shards(case):
    """Folding into centered int8 blocks writes each row's code and its
    slot's ``mudr`` into the shard holding the block; the tables equal a
    single-device fold's, bit for bit."""
    f, fs = twins(case, (4, 2), shard_by="leaf", dtype=torch.int8,
                  centered=True, slack=8)
    for g in (f, fs):
        g.add(case["new"])
        g.fold()
    rows = torch.as_tensor(f._row_block)
    live = rows >= 0
    for got, want in zip((*f._packed, f._block_scale, *f._block_center),
                         (*fs._packed, fs._block_scale, *fs._block_center)):
        assert torch.equal(got.whole()[live], want[rows[live]])
    qn = case["new"] + 1e-3
    knn_agree(f.knn(qn, 3, budget=f.plan.n_leaves, dedup=False),
              fs.knn(qn, 3, budget=f.plan.n_leaves, dedup=False))


def test_sparse_fold_tree_sharded(case):
    """ELL blocks, tree-sharded: two sparse points fold and find
    themselves per pair and through the bucket stop."""
    rng = np.random.default_rng(61)
    cols = np.stack([np.sort(rng.choice(DIM, size=5, replace=False))
                     for _ in range(800)]).astype(np.int32)
    vals = rng.normal(size=(800, 5)).astype(np.float32)
    m = rp.EllMatrix(DIM, torch.as_tensor(cols), torch.as_tensor(vals))
    f = tpar.forest_batch_distributed(3, 5, 16, T, 1.0, m,
                                      mesh=mesh((8, 1))).pack_leaves(slack=8)
    new = np.zeros((2, DIM), np.float32)
    new[0, [1, 5, 9]] = (0.5, -0.25, 1.0)
    new[1, [2, 3]] = (1.5, 0.75)
    f.add(new)
    f.fold()
    assert f.n_folded == 2 and f.n_pending == 0
    _, ids = f.knn(new, 1, budget=8)
    assert ids[:, 0].tolist() == [800, 801]
    _, ih = f.knn_h(new[:1], 1, budget=8)
    assert ih[0, 0] == 800


def test_tombstones_and_pending_merge(case):
    """``remove`` hides points and ``add`` serves pending ones exactly on
    the sharded paths (tree-sharded ``knn_h``, leaf-sharded grouped), as
    on one device; a slack-0 fold leaves what does not fit pending."""
    x, q = case["x"], case["q"]
    f, fs = twins(case, (8, 1))
    for g in (f, fs):
        g.remove([0, 1])
        g.add(x[:2] + 5.0)
    knn_agree(f.knn_h(q, 5, budget=8), fs.knn_h(q, 5, budget=8))
    _, i = f.knn_h(x[:2] + 1e-4, 2, budget=8)
    assert not set(i.reshape(-1).tolist()) & {0, 1}
    _, i = f.knn(x[:1] + 5.0, 1, budget=8)
    assert i[0, 0] >= N
    g, gs = twins(case, (4, 2), shard_by="leaf")
    for h in (g, gs):
        h.add(x[:4] + 3.0)
        h.fold()
    assert g.n_pending + g.n_folded == 4 and g.n_pending == gs.n_pending
    knn_agree(g.knn_grouped(q, 5, budget=4, precision="default"),
              gs.knn_grouped(q, 5, budget=4, precision="default"))


def test_inherited_surface_and_checkpoint(case, tmp_path):
    """Accessors, payloads and ``save_forest`` work on the sharded handle
    (its global tensors are on the mesh's first device); the loaded
    forest serves the sharded one's results."""
    pays = [f"p{i}" for i in range(N)]
    f = tpar.forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, case["x"],
                                      mesh=mesh((4, 2)), payloads=pays,
                                      r=case["r"])
    fs = rp.forest_batch(SEED, MAXD, MINL, T, PNZ, case["x"], device="cpu",
                         r=case["r"])
    assert f.tree_stats() == fs.tree_stats() and f.levels() == fs.levels()
    assert f.leaves(5) == fs.leaves(5)
    assert torch.equal(f.candidates(case["q"], budget=2),
                       fs.candidates(case["q"], budget=2))
    assert f.payload_of([3, -1]) == ["p3", None]
    path = str(tmp_path / "f.npz")
    rp.save_forest(path, f)
    back = rp.load_forest(path, device="cpu")
    assert torch.equal(back.arrays.perm, f.arrays.perm)
    f.pack_leaves(shard_by="leaf")
    knn_agree(f.knn(case["q"], 5), back.pack_leaves().knn(case["q"], 5))


def test_tune_and_tune_build_on_sharded_handles(case):
    """``tune`` drives a sharded forest through its own query surface and
    returns the single-device forest's knobs by the static cost; measured,
    it times the sharded ``knn_batched`` and grouped paths.
    ``tune_build`` on a sharded handle samples its dataset."""
    q = case["q"]
    sweep = dict(k=5, target_recall=0.3, budgets=(1, 2),
                 probes_per_tree=(1.0, 2.0), measure=False)
    f, fs = twins(case, (4, 2), shard_by="leaf")
    best, best0 = rp.tune(f, q, **sweep), rp.tune(fs, q, **sweep)
    assert best["met"] and not best.get("scan")
    assert (best["budget"], best["probes"]) == (best0["budget"],
                                                best0["probes"])
    assert [p["recall"] for p in best["frontier"]] == [
        p["recall"] for p in best0["frontier"]]
    for serving in ("batched", "grouped"):
        m = rp.tune(f, q, k=5, target_recall=0.3, budgets=(1,),
                    probes_per_tree=(1.0,), reps=1, time_rows=32,
                    serving=serving)
        assert m["frontier"][0]["qps"] > 0
    kw = dict(k=5, target_recall=0.1, n_trees_grid=(4,),
              min_leaf_grid=(32,), sample=600, budgets=(1,),
              probes_per_tree=(1.0,), device="cpu")
    got = rp.tune_build(f, q, **kw)
    want = rp.tune_build(torch.as_tensor(case["x"]), q, **kw)
    assert got["frontier"][0]["recall"] == want["frontier"][0]["recall"]
    assert got["min_leaf_full"] == want["min_leaf_full"]


def test_run_bench_on_a_mesh(case):
    """``run_bench`` on an explicit (tree x query) mesh and with the
    config's shard counts returns the single-device run's recall
    (``tests/test_torch_side.py`` holds ``n_tree_shards=2`` alone)."""
    cfg = dataclasses.replace(benchmarks.DEFAULT_GRID[0], num_trees=4)
    one = benchmarks.run_bench(cfg, reps=1, device="cpu")
    grid = benchmarks.run_bench(cfg, reps=1, mesh=mesh((2, 2)),
                                device="cpu")
    counts = benchmarks.run_bench(dataclasses.replace(
        cfg, n_tree_shards=2, n_query_shards=2), reps=1, device="cpu")
    for r in (grid, counts):
        assert r["recall_at_10"] == one["recall_at_10"]
        assert r["recall_per_tree"] == one["recall_per_tree"]
