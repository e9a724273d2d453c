"""The port's per-pair and unpacked query paths (``knn``, ``knn_batched``,
``candidates``, ``recall_with``) against the JAX package on the same
forest: a small clustered forest built by JAX and carried into the port.

Results are held to each other by ``torch_parity.knn_agree``: distances
within 1e-5, the noise of two correct fp32 summation orders at this
data's scale (sigma 0.5: neighbour distances within a few times the
norms), and ids equal outside near-ties."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu.reference import ref_forest_batch, ref_knn

from torch_parity import carry, clustered, jax_forest, one_torch_thread  # noqa: F401
from torch_parity import knn_agree as _agree

K = 10
MIN_LEAF = 64
DTYPES = {"f32": (None, None, 0), "bf16": (jnp.bfloat16, torch.bfloat16, 0),
          "int8": (jnp.int8, torch.int8, 8)}


@pytest.fixture(scope="module")
def data():
    # leaves of 64 keep the forest 4 levels deep: the JAX package's query
    # compiles, one per configuration, are most of this file's time
    x, q = clustered(21, 1024, 16, 24, 0.5, 48)
    return x, q


def _forests(x, dtype=None):
    """A JAX forest and its carried port twin, packed as ``dtype`` asks
    (a key of DTYPES) or unpacked (None)."""
    fj = jax_forest(x, seed=12, n_trees=4, min_leaf=MIN_LEAF)
    ft = carry(fj)
    if dtype is not None:
        dj, dt, slack = DTYPES[dtype]
        fj.pack_leaves(dtype=dj, slack=slack)
        ft.pack_leaves(dtype=dt, slack=slack)
    return fj, ft


@pytest.mark.parametrize("dtype,probes,dedup", [
    ("f32", None, True), ("f32", 3, False), ("bf16", 3, True),
    ("bf16", None, False), ("int8", 3, True), ("int8", None, False),
])
def test_packed_matches_jax(data, dtype, probes, dedup):
    x, q = data
    fj, ft = _forests(x, dtype)
    kw = dict(budget=2, probes=probes, dedup=dedup)
    want = fj.knn(q, K, precision="default", **kw)
    _agree(ft.knn(q, K, precision="default", **kw), want)
    # the top-k kernel tail (its plain version here) on the same candidates
    if dedup:
        _agree(ft.knn(q, K, selection="kernel", **kw), want)
    else:  # copies of an id across trees are kept
        assert (want[0][:, 0] == want[0][:, 1]).any()


@pytest.mark.parametrize("packed", [False, True])
def test_min_votes_matches_jax(data, packed):
    x, q = data
    fj, ft = _forests(x, "f32" if packed else None)
    k = 3 * K  # past the ids that two of the four trees share, on some rows
    want = fj.knn(q, k, budget=2, min_votes=2)
    got = ft.knn(q, k, budget=2, min_votes=2)
    _agree(got, want)
    assert (got[1] < 0).any() and (got[1] >= 0).any()
    if packed:  # vote counting takes the sort tail under "kernel" too
        _agree(ft.knn(q, k, budget=2, min_votes=2, selection="kernel"), want)


def _l1(mod):
    return lambda rows, qq: mod.sum(mod.abs(rows - qq), -1)


@pytest.mark.parametrize("metric", ["sql2", "cosine", "dot", "l1"])
def test_metrics_match_jax(data, metric):
    x, q = data
    fj, ft = _forests(x, "f32")
    mj, mt = (_l1(jnp), _l1(torch)) if metric == "l1" else (metric, metric)
    _agree(ft.knn(q, K, mt, budget=2, probes=5),
           fj.knn(q, K, mj, budget=2, probes=5))
    fj._packed = None  # the JAX forest's unpacked path
    ft._packed = None
    _agree(ft.knn(q, K, mt, budget=2), fj.knn(q, K, mj, budget=2))


@pytest.mark.parametrize("dedup", [True, False])
def test_unpacked_matches_jax(data, dedup):
    x, q = data
    fj, ft = _forests(x)
    _agree(ft.knn(q, K, budget=3, dedup=dedup),
           fj.knn(q, K, budget=3, dedup=dedup))


def test_unpacked_full_budget_matches_oracle(data):
    """At full budget the unpacked path is the reference's ``knnPQ``
    (``tests/test_query.py``'s oracle check)."""
    x, q = data
    fj, ft = _forests(x)
    ref = ref_forest_batch(x, np.asarray(fj.arrays.r), fj.plan.max_depth,
                           MIN_LEAF)
    d, i = ft.knn(q[:8], 5, budget=ft.plan.n_leaves)
    for b in range(8):
        d_o, i_o = ref_knn(ref, x.astype(np.float64), q[b].astype(np.float64),
                           5, dedup=True)
        np.testing.assert_allclose(d[b].numpy(), d_o, rtol=2e-4, atol=2e-5)
        assert set(i[b].tolist()) == set(i_o.tolist())


def test_packed_full_probes_equals_unpacked(data):
    """Packing changes the layout, not the result
    (``tests/test_query.py``'s packed-versus-unpacked check)."""
    x, q = data
    _, ft = _forests(x)
    d1, i1 = ft.knn(q, K, budget=2)
    ft.pack_leaves()
    d2, i2 = ft.knn(q, K, budget=2)
    _agree((d2, i2), (d1, i1))


def test_batched_equals_chunked_knn(data):
    x, q = data
    fj, ft = _forests(x, "f32")
    kw = dict(budget=2, probes=5)
    d, i = ft.knn_batched(q, K, chunk=20, **kw)
    parts = [ft.knn(q[s:s + 20], K, **kw) for s in range(0, len(q), 20)]
    assert torch.equal(d, torch.cat([p[0] for p in parts]))
    assert torch.equal(i, torch.cat([p[1] for p in parts]))
    _agree((d, i), fj.knn_batched(q, K, chunk=20, **kw))


def test_kernel_gets_contiguous_operands(data, monkeypatch):
    """At budget 1 the probe table is a transposed view of the traversal's
    output; kernel 6's wrapper takes only contiguous tensors (a check that
    runs on the card, not in the plain version), so the path hands it
    contiguous ones."""
    from rptree_tpu_torch.models import forest as fm

    x, q = data
    _, ft = _forests(x, "f32")
    seen, orig = [], fm.gather_score

    def checked(*args):
        seen.append(all(t.is_contiguous() for t in args))
        return orig(*args)

    monkeypatch.setattr(fm, "gather_score", checked)
    ft.knn(q, K, budget=1)
    ft.knn_batched(q, K, budget=1, chunk=20)
    assert len(seen) == 4 and all(seen)


def test_candidates_and_recall_match_jax(data):
    x, q = data
    fj, ft = _forests(x)
    cj, ct = np.asarray(fj.candidates(q, budget=2)), ft.candidates(q, budget=2)
    assert ct.dtype == torch.int32
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_array_equal(ft.candidates(q, budget=2, tree=1).numpy(),
                                  cj[1])
    rj, rt = np.asarray(fj.recall_with(q, K, budget=2)), ft.recall_with(
        q, K, budget=2)
    assert rt.shape == (len(q),) and 0.2 < float(rt.mean()) < 1.0
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-6)


def test_per_pair_raises(data):
    x, q = data
    _, ft = _forests(x)
    with pytest.raises(ValueError):
        ft.knn_batched(q, K)  # not packed
    ft.pack_leaves(dtype=torch.int8, slack=8)
    with pytest.raises(NotImplementedError):
        ft.knn(q, K, _l1(torch))  # callables need f32 / bf16 blocks
    with pytest.raises(NotImplementedError, match="Not to port"):
        ft.knn(q, K, selection="approx")
    with pytest.raises(ValueError):
        ft.knn(q, 129, selection="kernel")
    with pytest.raises(ValueError):
        ft.knn(q, K, metric="l3")
    with pytest.raises(ValueError):
        ft.knn_batched(q, K, precision="exact")
    with pytest.raises(ValueError):
        ft.knn(q[:, :5], K)
    # sparse query batches are ported: an EllMatrix of the same rows gives
    # the dense rows' result
    from rptree_tpu_torch import EllMatrix

    cols = np.tile(np.arange(16, dtype=np.int32), (q.shape[0], 1))
    (d0, i0), (d1, i1) = (ft.knn_batched(qq, K) for qq in (
        q, EllMatrix(16, cols, q)))
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
