"""The rest of the reference API in the port against the JAX package:
``knn_h`` (unpacked, and packed through the bucket stop), ``knn_h_buckets``,
``knn_pq``, the accessors (``levels``, ``tree_size``, ``leaf_sizes``,
``tree_stats``, ``leaves``, ``points``), ``tree_batch``, the carry-over of
payloads and seed, and the parameters of every entry point of the slice.

Results are held by ``torch_parity.knn_agree`` (1e-5); buckets, leaves
and permutations are exact integer checks."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rptree_tpu as rt
import rptree_tpu_torch as rp

from torch_parity import carry, clustered, jax_forest, one_torch_thread  # noqa: F401
from torch_parity import knn_agree

K = 10


@pytest.fixture(scope="module")
def twins():
    x, q = clustered(41, 2000, 16, 24, 0.5, 40)
    fj = jax_forest(x, seed=9, n_trees=4, min_leaf=32,
                    payloads=[("row", i) for i in range(2000)])
    fu, fp = carry(fj), carry(fj)
    fp.pack_leaves()
    return x, q, fj, fu, fp


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dedup", [True, False])
def test_knn_h_matches_jax(twins, packed, dedup):
    """knnH: buckets in ascending priority until k points, reranked.  JAX
    serves the packed form from its own packed forest."""
    _, q, fj, fu, fp = twins
    ft = fp if packed else fu
    if packed:
        fj.pack_leaves()
    try:
        want = fj.knn_h(q, K, budget=3, dedup=dedup)
    finally:
        fj._packed = None
    knn_agree(ft.knn_h(q, K, budget=3, dedup=dedup), want)


def test_packed_knn_h_with_probes(twins):
    _, q, fj, _, fp = twins
    fj.pack_leaves()
    try:
        want = fj.knn_h(q, 3, budget=2, probes=3)
    finally:
        fj._packed = None
    knn_agree(fp.knn_h(q, 3, budget=2, probes=3), want)


@pytest.mark.parametrize("k,budget", [(10, 3), (1, 2), (200, 4)])
def test_knn_h_buckets_match_jax(twins, k, budget):
    """The bucket stop's ids in JAX's order: priority order by a stable
    sort, the first bucket always kept (k 1 is below any bucket's size),
    the running size stopping at k.  Packed blocks without folded rows
    give the same buckets."""
    _, q, fj, fu, fp = twins
    want = np.asarray(fj.knn_h_buckets(q, k, budget=budget))
    for ft in (fu, fp):
        got = ft.knn_h_buckets(q, k, budget=budget)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("packed", [False, True])
def test_knn_pq_matches_jax(twins, packed):
    _, q, fj, fu, fp = twins
    want = fj.knn_pq(q, K, budget=2)
    knn_agree((fp if packed else fu).knn_pq(q, K, budget=2), want)


@pytest.mark.parametrize("name", ["levels", "tree_size", "leaf_sizes",
                                  "tree_stats", "leaves", "points"])
def test_accessors_match_jax(twins, name):
    _, _, fj, fu, _ = twins
    args = {"tree_size": [(0,), (3,)], "leaves": [(0,), (2,)]}.get(name,
                                                                   [()])
    for a in args:
        got, want = getattr(fu, name)(*a), getattr(fj, name)(*a)
        if name == "points":
            got = got.numpy()
        if isinstance(want, dict) or isinstance(want, (list, int)):
            assert got == want
        else:
            np.testing.assert_array_equal(got, np.asarray(want))


def test_tree_batch_matches_jax():
    """One tree, JAX's parameters and payloads; the projections handed
    over, as for ``forest_batch``."""
    x, _ = clustered(42, 600, 8, 10, 0.5, 1)
    pays = [f"t{i}" for i in range(600)]
    tj = rt.tree_batch(5, 5, 16, 1.0, x, pays)
    tt = rp.tree_batch(5, 5, 16, 1.0, x, pays, device="cpu",
                       r=np.array(tj.arrays.r))
    assert tt.n_trees == tj.n_trees == 1
    np.testing.assert_array_equal(tt.arrays.perm.numpy(),
                                  np.asarray(tj.arrays.perm))
    assert tt.payloads == pays and tt.seed == 5
    assert tt.payload_of([3, -1]) == tj.payload_of([3, -1])


def test_carry_and_load_keep_payloads_and_seed(twins, tmp_path):
    """``forest_from_numpy`` takes the payloads and the header's seed;
    ``load_forest`` reads no pickles, so payloads come from the caller."""
    from rptree_tpu.utils.io import save_forest

    _, _, fj, fu, _ = twins
    assert fu.seed == fj.seed == 9
    assert fu.payload_of([0, 1999]) == fj.payload_of([0, 1999])
    path = str(tmp_path / "f.npz")
    save_forest(path, fj)
    bare = rp.load_forest(path, device="cpu")
    assert bare.seed == 9 and bare.payloads is None
    assert bare.payload_of([7]) == [7]           # ids stand for themselves
    named = rp.load_forest(path, device="cpu", payloads=fj.payloads)
    assert named.payload_of([7]) == [("row", 7)]
    with pytest.raises(ValueError):
        rp.load_forest(path, device="cpu", payloads=fj.payloads[:5])


_METHODS = ("knn_h", "knn_h_buckets", "knn_pq", "levels", "tree_size",
            "leaf_sizes", "tree_stats", "leaves", "points", "add", "remove",
            "fold", "rebuild", "drop_dataset", "payload_of")


@pytest.mark.parametrize("name", [*_METHODS, "tree_batch", "forest_batch"])
def test_parameters_match_jax(name):
    """JAX's parameters in JAX's order and with its defaults; the port's
    own keyword-only ``device`` and ``r`` follow on the builders."""
    if name in _METHODS:
        port_fn, jax_fn = getattr(rp.RPForest, name), getattr(rt.RPForest,
                                                              name)
    else:
        port_fn, jax_fn = getattr(rp, name), getattr(rt, name)
    pj = list(inspect.signature(jax_fn).parameters.values())
    pt = list(inspect.signature(port_fn).parameters.values())
    assert [p.name for p in pt[:len(pj)]] == [p.name for p in pj]
    for a, b in zip(pt, pj):
        assert a.kind is b.kind, a.name
        assert a.default == b.default or (
            a.default is torch.float32 and b.default is jnp.float32), a.name
    extra = pt[len(pj):]
    assert [p.name for p in extra] == ([] if name in _METHODS
                                       else ["device", "r"])
    assert all(p.kind is p.KEYWORD_ONLY for p in extra)
