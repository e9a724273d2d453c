"""The port's online updates (``add``, ``remove``, ``fold``, ``rebuild``,
``drop_dataset``, payloads) against the JAX package: the same sequence of
updates runs on a JAX forest and on its carried twin, and after each step
the counts, the packed blocks and their occupancy, the fold's leaves, every
dense query surface, the knnH buckets, the exact scan, recall and the
payloads agree.

Query results are held by ``torch_parity.knn_agree`` (1e-5); ids, blocks,
occupancy and buckets are exact integer (and, for int8 / bf16 rows, bit)
checks.  The JAX package's own kernel tail needs a TPU, so the port's
kernel tail is held against JAX's sort tail, as in the slice tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu.models.forest import _descend as jax_descend
from rptree_tpu_torch.models.forest import _descend
from rptree_tpu_torch.ops.traverse import node_table

from torch_parity import carry, clustered, jax_forest, one_torch_thread  # noqa: F401
from torch_parity import knn_agree

K = 10
N = 2000
SERVE = dict(budget=2)
LAYOUTS = {"f32": (None, None, 8), "bf16": (jnp.bfloat16, torch.bfloat16, 8),
           "int8": (jnp.int8, torch.int8, 8), "f32_full": (None, None, 0)}
# the steps each layout runs: the whole sequence on f32 blocks, the folds
# on the others (f32_full: no slack, so that points overflow)
STEPS = {"f32": ("pending", "folded", "refolded", "rebuilt"),
         "bf16": ("folded", "refolded"), "int8": ("folded", "refolded"),
         "f32_full": ("folded",)}
CASES = [(lay, step) for lay, steps in STEPS.items() for step in steps]
SURFACES = ("knn", "knn_batched", "grouped_sort", "grouped_kernel", "knn_h",
            "buckets", "brute", "recall")
# where a step's new shapes would cost the JAX package a compile of every
# surface, a few of them stand for the rest
SERVED = {("f32", "pending"): SURFACES[:5],   # the rest ignore the buffer
          ("f32_full", "folded"): ("knn", "grouped_sort"),
          ("f32", "rebuilt"): ("knn", "grouped_sort", "grouped_kernel",
                               "knn_h", "buckets")}


def _cases(surface):
    return [c for c in CASES if surface in SERVED.get(c, SURFACES)]


@pytest.fixture(scope="module")
def data():
    xa, q = clustered(31, N + 400, 16, 24, 0.5, 48)
    return xa[:N], xa[N:], q


def _twins(x, layout):
    pays = [f"p{i}" for i in range(N)]
    fj = jax_forest(x, seed=7, n_trees=4, min_leaf=32, payloads=pays)
    ft = carry(fj)
    dj, dt, slack = LAYOUTS[layout]
    fj.pack_leaves(dtype=dj, slack=slack)
    ft.pack_leaves(dtype=dt, slack=slack)
    return fj, ft


def _serve(f, q, port, surfaces):
    """The dense query surfaces ``surfaces`` at one setting; JAX's sort
    tail stands for its kernel tail, which needs a TPU."""
    g = dict(SERVE, tile_m=8)
    calls = {"knn": lambda: f.knn(q, K, **SERVE),
             "knn_batched": lambda: f.knn_batched(
                 q, K, chunk=32, precision="default", **SERVE),
             "grouped_sort": lambda: f.knn_grouped(q, K, **g),
             "grouped_kernel": lambda: f.knn_grouped(
                 q, K, selection="kernel" if port else "sort", **g),
             "knn_h": lambda: f.knn_h(q, K, **SERVE),
             "buckets": lambda: f.knn_h_buckets(q, K, **SERVE),
             "brute": lambda: f.brute_force_knn(q, K),
             "recall": lambda: f.recall_with(q, K, **SERVE)}
    return {name: calls[name]() for name in surfaces}


def _snap(f, q, port, surfaces):
    """The state after a step: counts, serving results, and copies of the
    blocks and occupancy (the port writes them in place; JAX's host
    occupancy too, under a device array that may alias it)."""
    x_leaf, sq_leaf, id_leaf = f._packed
    arr = ((lambda a: a.clone()) if port else np.array)
    return {"counts": (f.n_pending, f.n_folded, f.n_deleted, f.tree_size()),
            "serve": _serve(f, q, port, surfaces),
            "blocks": tuple(arr(a) for a in (x_leaf, sq_leaf, id_leaf)),
            "lens": arr(f._lens_global()),
            "folded_leaf": [np.asarray(a) for a in f._folded_leaf],
            "perm": arr(f.arrays.perm), "thr": arr(f.arrays.thr)}


def _step(f, step, new, xt):
    """Apply one step of the sequence (``xt``: the package's array
    constructor)."""
    if step in ("pending", "folded") and f.n_pending + f.n_folded == 0:
        f.add(xt(new[:120]), payloads=[f"a{i}" for i in range(120)])
        f.remove([0, 1, N + 3])        # two indexed points, one pending
    if step == "refolded":
        f.add(xt(new[120:240]), payloads=[f"b{i}" for i in range(120)])
        # a folded point, a pending one, and two ids out of range
        f.remove([N + 5, N + f.n_folded + f.n_pending - 2, -4, 10 ** 6])
    if step in ("folded", "refolded"):
        f.fold()
    if step == "rebuilt":
        f.rebuild()


@pytest.fixture(scope="module")
def runs(data):
    """Each layout's sequence on both sides: ``{(layout, step): (jax
    snapshot, port snapshot, removed ids)}``."""
    x, new, q = data
    out = {}
    for layout, steps in STEPS.items():
        fj, ft = _twins(x, layout)
        for step in steps:
            _step(fj, step, new, jnp.asarray)
            _step(ft, step, new, torch.as_tensor)
            dead = set(np.flatnonzero(ft._deleted).tolist()
                       if ft._deleted is not None else ())
            base = N + ft.n_folded
            dead |= {base + i for i in ft._pending_deleted or ()}
            surfaces = SERVED.get((layout, step), SURFACES)
            out[layout, step] = (_snap(fj, q, False, surfaces),
                                 _snap(ft, q, True, surfaces), dead,
                                 (fj, ft))
    return out


@pytest.mark.parametrize("layout,step", CASES)
def test_counts_match_jax(runs, layout, step):
    sj, st, _, _ = runs[layout, step]
    assert st["counts"] == sj["counts"]
    if step == "rebuilt":
        assert st["counts"][:3] == (0, 0, 0)
    if layout == "f32_full":  # no slack: some points overflow
        assert 0 < st["counts"][0] and 0 < st["counts"][1]


@pytest.mark.parametrize("layout,step,surface", [
    (*c, s) for s in SURFACES[:5] for c in _cases(s)])
def test_serving_matches_jax(runs, layout, step, surface):
    """Every dense surface applies the tombstones and the pending merge
    as JAX does; no removed id comes back."""
    sj, st, dead, _ = runs[layout, step]
    got = st["serve"][surface]
    knn_agree(got, sj["serve"][surface])
    assert not set(got[1].reshape(-1).tolist()) & dead


@pytest.mark.parametrize("layout,step", _cases("buckets"))
def test_buckets_match_jax(runs, layout, step):
    """knnH's buckets: the same ids in the same order (the packed id
    blocks with their occupancy once rows are folded)."""
    sj, st, _, _ = runs[layout, step]
    np.testing.assert_array_equal(st["serve"]["buckets"].numpy(),
                                  np.asarray(sj["serve"]["buckets"]))


@pytest.mark.parametrize("layout,step", _cases("brute"))
def test_ground_truth_covers_folded_rows(runs, layout, step):
    """``brute_force_knn`` and ``recall_with`` over the folded rows."""
    sj, st, _, (_, ft) = runs[layout, step]
    knn_agree(st["serve"]["brute"], sj["serve"]["brute"])
    np.testing.assert_allclose(st["serve"]["recall"].numpy(),
                               np.asarray(sj["serve"]["recall"]), atol=1e-6)
    if ft.n_folded and step != "rebuilt":
        assert int(st["serve"]["brute"][1].max()) >= N  # folded rows reach


@pytest.mark.parametrize("layout,step", CASES)
def test_payloads_match_jax(runs, layout, step):
    sj, st, _, (fj, ft) = runs[layout, step]
    ids = np.unique(np.concatenate([st["serve"]["knn"][1].numpy().ravel(),
                                    [-1, 0, N, N + ft.n_folded,
                                     N + ft.n_folded + ft.n_pending + 5]]))
    assert ft.payload_of(ids) == fj.payload_of(ids)
    assert ft.payload_of(torch.as_tensor(ids)) == fj.payload_of(ids)


@pytest.mark.parametrize("layout,step", [c for c in CASES
                                         if c[1] in ("folded", "refolded")])
def test_fold_writes_jax_blocks(runs, layout, step):
    """After a fold the packed blocks equal JAX's: ids and occupancy
    exactly, int8 and bf16 rows bit for bit (int8 quantized by the target
    block's scale), f32 rows as copied, norms as the pack tests hold them;
    the fold's leaves are JAX's."""
    sj, st, _, _ = runs[layout, step]
    (xj, sqj, ij), (xt, sqt, it) = sj["blocks"], st["blocks"]
    if xt.dtype == torch.bfloat16:
        np.testing.assert_array_equal(xt.view(torch.int16).numpy(),
                                      np.asarray(xj).view(np.int16))
    else:
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(sqt.numpy(), sqj, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(st["lens"].numpy(), sj["lens"])
    # the occupancy table counts each block's filled slots
    np.testing.assert_array_equal(st["lens"].numpy(),
                                  (it >= 0).sum(1).numpy())
    assert len(st["folded_leaf"]) == len(sj["folded_leaf"]) > 0
    for a, b in zip(st["folded_leaf"], sj["folded_leaf"]):
        np.testing.assert_array_equal(a, b)


def test_descend_matches_jax(data, runs):
    """The placement descent reaches JAX's leaves on new points.  (An
    indexed point can sit exactly on a threshold, the median of the
    points' own projections, where the last bit of two correct products
    decides its side.)"""
    _, new, _ = data
    _, _, _, (fj, ft) = runs["f32", "folded"]
    pts = new
    want = np.asarray(jax_descend(fj.plan, fj.arrays, jnp.asarray(pts)))
    got = _descend(ft.plan, ft.arrays, torch.as_tensor(pts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_budget_1_leaves_leave_the_fold_leaf_as_in_jax(data, runs):
    """A query's budget-1 descent takes a fork's other child where its
    margin priority is the lower (the reference traversal's rule), so it
    can end in another leaf than the fold's primary-side descent: the
    (tree, point) pairs where the two differ are the same in both
    packages."""
    from rptree_tpu.models.forest import _traverse_forest as jax_traverse
    from rptree_tpu_torch.models.forest import _traverse_forest

    _, new, _ = data
    _, _, _, (fj, ft) = runs["f32", "folded"]
    pj = jnp.asarray(new)
    want = (np.asarray(jax_traverse(fj.plan, fj.arrays, pj, 1)[0])[..., 0]
            != np.asarray(jax_descend(fj.plan, fj.arrays, pj)))
    pt = torch.as_tensor(new)
    got = (_traverse_forest(ft.plan, ft.arrays, pt, 1)[0][..., 0]
           != _descend(ft.plan, ft.arrays, pt))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and want.mean() < 0.05


def test_rebuild_matches_jax(runs):
    """A rebuild with the forest's own projections gives JAX's rebuilt
    trees (JAX draws them again from the seed): the permutation equal,
    the thresholds within the build tests' tolerance."""
    sj, st, _, (fj, ft) = runs["f32", "rebuilt"]
    np.testing.assert_array_equal(st["perm"].numpy(), sj["perm"])
    np.testing.assert_allclose(st["thr"].numpy(), sj["thr"], rtol=1e-5,
                               atol=1e-5)
    assert ft.plan.n == fj.plan.n == N + 240 - 5
    assert ft.payloads == fj.payloads
    assert ft._pack_cfg == ("f32", 8, False, 1, None, "blocks")  # replayed


def test_rebuild_drops_every_stale_cache(data):
    """Fold replaces the occupancy table; rebuild also the node table and
    the learned tile capacities.  A cache that survived would serve the
    old plan: the checks compare each with one made afresh."""
    x, new, q = data
    _, ft = _twins(x, "f32")
    g = dict(SERVE, tile_m=8)
    ft.knn_grouped(q, K, **g)        # learns a capacity; table, occupancy
    table, lens = ft._table(), ft._lens_global()
    ft.add(torch.as_tensor(new[:200]))
    ft.fold()
    assert ft._table() is table      # fold changes no arrays
    assert not torch.equal(ft._lens_global(), lens)
    np.testing.assert_array_equal(ft._lens_global().numpy(),
                                  (ft._packed[2] >= 0).sum(1).numpy())
    assert ft._grouped_nt
    ft.rebuild()
    fresh = node_table(ft.plan, ft.arrays.thr, ft.arrays.mgl, ft.arrays.mgh)
    assert torch.equal(ft._table().rec, fresh.rec)
    np.testing.assert_array_equal(ft._lens_global().numpy(),
                                  np.tile(ft.plan.leaf_len, ft.n_trees))
    assert ft._grouped_nt == {} and ft._grouped_last is None
    want = ft.knn_grouped(q, K, **g)
    got = ft.knn_grouped(q, K, check=False, **g)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_pending_smaller_than_k_and_removed(data):
    """A pending buffer of fewer rows than k, one of them removed: the
    merge over-fetches by the tombstones, at every precision."""
    x, new, q = data
    fj, ft = _twins(x, "f32")
    for f, xt in ((fj, jnp.asarray), (ft, torch.as_tensor)):
        f.add(xt(new[:3]))
        f.remove([N + 1])
    for precision in ("highest", "default"):
        got = ft.knn(q[:8], K, precision=precision, **SERVE)
        knn_agree(got, fj.knn(q[:8], K, precision=precision, **SERVE))
        assert N + 1 not in got[1].tolist()
    # each pending point is its own nearest
    _, ids = ft.knn(torch.as_tensor(new[[0, 2]]), 1, **SERVE)
    assert ids[:, 0].tolist() == [N, N + 2]


def test_rebuild_every(data):
    x, new, _ = data
    fj, ft = _twins(x, "f32")
    for f, xt in ((fj, jnp.asarray), (ft, torch.as_tensor)):
        f.add(xt(new[:30]), rebuild_every=50)
        assert f.n_pending == 30
        f.add(xt(new[30:60]), rebuild_every=50)
    assert ft.n_pending == fj.n_pending == 0
    assert ft.tree_size() == fj.tree_size() == N + 60
    np.testing.assert_array_equal(ft.arrays.perm.numpy(),
                                  np.asarray(fj.arrays.perm))


def test_serve_only_after_drop_dataset(data, runs):
    """``drop_dataset`` keeps the packed paths serving (folded rows and
    the pending buffer included); the scan, recall, ``points``, ``add``,
    ``rebuild`` and repacking raise, as in JAX."""
    x, new, q = data
    fj, ft = _twins(x, "f32")
    for f, xt in ((fj, jnp.asarray), (ft, torch.as_tensor)):
        f.add(xt(new[:50]))
        f.fold()
        f.remove([3])
        f.drop_dataset()
    assert ft.dim == fj.dim == 16
    knn_agree(ft.knn(q, K, **SERVE), fj.knn(q, K, **SERVE))
    knn_agree(ft.knn_h(q, K, **SERVE), fj.knn_h(q, K, **SERVE))
    np.testing.assert_array_equal(ft.knn_h_buckets(q, K, **SERVE).numpy(),
                                  np.asarray(fj.knn_h_buckets(q, K, **SERVE)))
    for call in (lambda: ft.brute_force_knn(q, K),
                 lambda: ft.recall_with(q, K), ft.points,
                 lambda: ft.add(new[:2]), ft.rebuild,
                 lambda: ft.pack_leaves(dtype=torch.int8)):
        with pytest.raises(ValueError):
            call()


def test_updates_refuse_what_jax_refuses(data):
    x, new, _ = data
    _, ft = _twins(x, "f32")
    with pytest.raises(ValueError):
        ft.add(new[:4, :8])                      # wrong dim
    with pytest.raises(ValueError):
        ft.add(new[:4], payloads=["a"])          # payload count
    ft.add(new[:4])
    ft.fold()
    with pytest.raises(ValueError):              # folded rows block a repack
        ft.pack_leaves(dtype=torch.int8)
    unpacked = carry(jax_forest(x, seed=7, n_trees=4, min_leaf=32))
    unpacked.add(new[:4])
    for call in (unpacked.fold, unpacked.drop_dataset):
        with pytest.raises(ValueError):          # both need packed blocks
            call()
    assert unpacked.n_pending == 4
