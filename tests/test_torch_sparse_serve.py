"""Serving sparse (ELL) datasets in the port against the JAX package: every
query path (per pair, grouped, unpacked, knnH, candidates, the exact
scan, recall), sparse query batches, the fold into ELL blocks, serve-only
forests, rebuilds and ELL checkpoints, and the JAX package's refusals.

A JAX ELL forest and its carried twin answer the same numpy queries.
Queries are dataset rows plus noise, so that no query projection lies on
a threshold (``test_torch_ties.py`` has the data-point queries).  Query
results are held by ``torch_parity.knn_agree`` (1e-5); blocks and ids are
exact.  The JAX package's kernel tail needs a TPU, so the port's is held
against JAX's sort tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rptree_tpu as rt
import rptree_tpu_torch as tp
from rptree_tpu.ops import sparse as js
from rptree_tpu.utils.io import save_forest
from rptree_tpu_torch import load_forest
from rptree_tpu_torch.ops import sparse as ts

from test_torch_sparse import bow
from torch_parity import carry, knn_agree, one_torch_thread  # noqa: F401

K = 10
N, DIM, NNZ = 1200, 128, 8
SERVE = dict(budget=2)


def noisy(cols, vals, seed, b, extra=4):
    """``b`` sparse queries near dataset rows: each a row's columns with
    its values moved by 30%, plus ``extra`` columns of its own (the
    nearest rows then lie well away from 0)."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, cols.shape[0], size=b)
    qc = np.concatenate([cols[i], rng.integers(0, DIM, size=(b, extra))], 1)
    qv = np.concatenate([vals[i] * (1 + 0.3 * rng.normal(size=vals[i].shape)),
                         np.abs(rng.normal(size=(b, extra))) + 0.5], 1)
    return qc.astype(np.int32), qv.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    cols, vals = bow(21, N, DIM, NNZ)
    qc, qv = noisy(cols, vals, 22, 40)
    dense_q = ts.ell_to_dense(ts.EllMatrix(DIM, qc, qv)).numpy()
    return cols, vals, qc, qv, dense_q


def _twins(data, pack=None, slack=0):
    cols, vals = data[:2]
    fj = rt.forest_batch(5, 4, 24, 4, 1.0, js.EllMatrix(DIM, cols, vals))
    ft = carry(fj)
    if pack is not None:
        fj.pack_leaves(dtype=jnp.bfloat16 if pack == "bf16" else None,
                       slack=slack)
        ft.pack_leaves(dtype=torch.bfloat16 if pack == "bf16" else None,
                       slack=slack)
    return fj, ft


@pytest.fixture(scope="module")
def unpacked(data):
    return _twins(data)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def packed(data, request):
    return _twins(data, request.param)


UNPACKED = {
    "knn": lambda f, q: f.knn(q, K, **SERVE),
    "knn_votes": lambda f, q: f.knn(q, K, min_votes=2, **SERVE),
    "knn_h": lambda f, q: f.knn_h(q, K, **SERVE),
    "brute": lambda f, q: f.brute_force_knn(q, K),
    "brute_cosine": lambda f, q: f.brute_force_knn(q, K, metric="cosine"),
}


@pytest.mark.parametrize("path", sorted(UNPACKED))
def test_unpacked_paths_match_jax(unpacked, data, path):
    fj, ft = unpacked
    q = data[4]
    knn_agree(UNPACKED[path](ft, q), UNPACKED[path](fj, q))


def test_candidates_and_recall_match_jax(unpacked, data):
    fj, ft = unpacked
    q = data[4]
    np.testing.assert_array_equal(ft.candidates(q, **SERVE).numpy(),
                                  np.asarray(fj.candidates(q, **SERVE)))
    np.testing.assert_array_equal(ft.knn_h_buckets(q, K, **SERVE).numpy(),
                                  np.asarray(fj.knn_h_buckets(q, K, **SERVE)))
    np.testing.assert_allclose(ft.recall_with(q, K, **SERVE).numpy(),
                               np.asarray(fj.recall_with(q, K, **SERVE)),
                               rtol=1e-6)


PACKED = {
    "knn": lambda f, q, port: f.knn(q, K, **SERVE),
    "knn_probes": lambda f, q, port: f.knn(q, K, probes=5, **SERVE),
    "knn_batched": lambda f, q, port: f.knn_batched(q, K, chunk=16, **SERVE),
    "knn_h": lambda f, q, port: f.knn_h(q, K, **SERVE),
    "grouped_sort": lambda f, q, port: f.knn_grouped(q, K, tile_m=8, **SERVE),
    "grouped_kernel_tail": lambda f, q, port: f.knn_grouped(
        q, K, tile_m=8, selection="kernel" if port else "sort", **SERVE),
    "grouped_cosine": lambda f, q, port: f.knn_grouped(
        q, K, metric="cosine", tile_m=4, chunk=16, **SERVE),
    "grouped_dot_xla": lambda f, q, port: f.knn_grouped(
        q, K, metric="dot", impl="xla", tile_m=8, **SERVE),
}


@pytest.mark.parametrize("path", sorted(PACKED))
def test_packed_paths_match_jax(packed, data, path):
    """Per pair and grouped (kernel 10's plain version), every tail and
    metric, on f32 and bf16 ELL blocks."""
    fj, ft = packed
    q = data[4]
    knn_agree(PACKED[path](ft, q, True), PACKED[path](fj, q, False))


def test_packed_knn_matches_unpacked(unpacked, data):
    """``tests/test_sparse.py``: the packed ELL path returns the unpacked
    rerank's neighbours (all leaves probed)."""
    fj, ft = _twins(data, "f32")
    q = data[4]
    budget = ft.plan.n_leaves
    d1, i1 = unpacked[1].knn(q, 5, budget=budget)
    d2, i2 = ft.knn(q, 5, budget=budget)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), atol=1e-5)
    for a, b in zip(i1.tolist(), i2.tolist()):
        assert set(a) == set(b)


def test_sparse_queries_equal_dense_queries(packed, data):
    """An ``EllMatrix`` batch through ``knn_batched`` and ``knn_grouped``
    (one chunk densified at a time; checked, default-chunk and
    ``check=False`` forms) gives the bits of its densified rows, and the
    JAX package's results."""
    fj, ft = packed
    _, _, qc, qv, dq = data
    qt, qj = ts.EllMatrix(DIM, qc, qv), js.EllMatrix(DIM, qc, qv)
    for call in (lambda f, q: f.knn_batched(q, K, chunk=8, **SERVE),
                 lambda f, q: f.knn_grouped(q, K, chunk=8, **SERVE)):
        sparse, dense = call(ft, qt), call(ft, dq)
        assert torch.equal(sparse[1], dense[1])
        assert torch.equal(sparse[0], dense[0])
        knn_agree(sparse, call(fj, qj))
    d2, i2 = ft.knn_grouped(qt, K, **SERVE)                 # chunk 4,096
    d3, i3 = ft.knn_grouped(qt, K, chunk=8, check=False, **SERVE)
    assert torch.equal(i2, sparse[1]) and torch.equal(i3, sparse[1])
    assert not ft.grouped_overflow()["overflow"]


def test_sparse_queries_mask_removed_and_refuse_pending(data):
    """Tombstones apply to sparse query batches; pending points, whose
    merge needs dense query rows, make them raise as in the JAX
    package."""
    fj, ft = _twins(data, "f32")
    _, _, qc, qv, _ = data
    qt, qj = ts.EllMatrix(DIM, qc, qv), js.EllMatrix(DIM, qc, qv)
    _, i0 = ft.knn_batched(qt, 5, chunk=8)
    gone = int(i0[0, 0])
    for f in (fj, ft):
        f.remove([gone])
    for q, f in ((qt, ft), (qj, fj)):
        _, i1 = f.knn_batched(q, 5, chunk=8)
        _, i2 = f.knn_grouped(q, 5, chunk=8)
        assert gone not in set(np.asarray(i1[0]).tolist())
        assert gone not in set(np.asarray(i2[0]).tolist())
    for f in (fj, ft):
        f.add(np.zeros((2, DIM), np.float32))
    for q, f in ((qt, ft), (qj, fj)):
        with pytest.raises(ValueError, match="pending"):
            f.knn_batched(q, 5, chunk=8)
        with pytest.raises(ValueError, match="pending"):
            f.knn_grouped(q, 5, chunk=8)
    with pytest.raises(ValueError, match="query dim"):
        ft.knn_batched(ts.EllMatrix(DIM + 1, qc, qv), 5)


def test_svec_and_small_ell_queries_densify(unpacked, data):
    """An ``SVec`` and an ``EllMatrix`` passed to any surface are
    densified, as in the JAX package."""
    fj, ft = unpacked
    _, _, qc, qv, dq = data
    idx = np.flatnonzero(dq[3])
    got = ft.knn(tp.SVec(DIM, idx, dq[3][idx]), K, **SERVE)
    assert torch.equal(got[1], ft.knn(dq[3], K, **SERVE)[1])
    knn_agree(got, fj.knn(rt.SVec(DIM, idx, dq[3][idx]), K, **SERVE))
    assert torch.equal(ft.candidates(ts.EllMatrix(DIM, qc, qv), **SERVE),
                       ft.candidates(dq, **SERVE))


def test_serve_only_ell_forest(data):
    """``pack_leaves`` + ``drop_dataset``: the packed paths keep answering
    and keep the dimension; the raw-row paths raise."""
    fj, ft = _twins(data, "f32")
    q = data[4]
    d1, i1 = ft.knn(q, 3)
    ft.drop_dataset()
    assert ft.dim == DIM and ft.x is None
    d2, i2 = ft.knn(q, 3)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    knn_agree(ft.knn_grouped(q, 3, **SERVE), fj.knn_grouped(q, 3, **SERVE))
    for call in (lambda: ft.brute_force_knn(q, 3), lambda: ft.points(),
                 lambda: ft.pack_leaves(dtype=torch.bfloat16)):
        with pytest.raises(ValueError):
            call()


def _fold_case(data):
    """``tests/test_sparse.py``'s fold: 5 rows of K - 1 nonzeros and one
    dense row added to blocks with slack 8."""
    fj, ft = _twins(data, "f32", slack=8)
    rng = np.random.default_rng(91)
    new = np.zeros((5, DIM), np.float32)
    for j in range(5):
        idx = rng.choice(np.arange(1, DIM), size=NNZ - 1, replace=False)
        new[j, idx] = np.abs(rng.normal(size=NNZ - 1)) + 0.1
    fat = rng.normal(size=(1, DIM)).astype(np.float32)
    for f in (fj, ft):
        f.add(np.concatenate([new, fat]))
        f.fold()
    return fj, ft, new, fat


def test_fold_into_ell_blocks_matches_jax(data):
    """Folded rows go into the blocks' K slots (ascending columns, then
    padding) exactly as in the JAX package; the row with more nonzeros
    than K stays pending and is found by the pending merge; the scan
    merges the folded rows."""
    fj, ft, new, fat = _fold_case(data)
    assert ft.n_folded == fj.n_folded == 5
    assert ft.n_pending == fj.n_pending == 1
    (bj, sqj, idj), (bt, sqt, idt) = fj._packed, ft._packed
    np.testing.assert_array_equal(bt.cols.numpy(), np.asarray(bj.cols))
    np.testing.assert_array_equal(bt.vals.numpy(), np.asarray(bj.vals))
    np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))
    np.testing.assert_allclose(sqt.numpy(), np.asarray(sqj), rtol=1e-5)
    np.testing.assert_array_equal(ft._block_len, fj._block_len)
    q = new + 0.05
    _, ids = ft.knn(q, 1, budget=ft.plan.n_leaves)
    assert (ids[:, 0] >= N).all()
    _, idf = ft.knn(fat + 1e-3, 1, budget=4)
    assert int(idf[0, 0]) == N + 5
    for call in (lambda f: f.knn(q, K, **SERVE),
                 lambda f: f.knn_grouped(q, K, **SERVE),
                 lambda f: f.knn_h(q, K, **SERVE),
                 lambda f: f.brute_force_knn(q, K),
                 lambda f: f.brute_force_knn(q, K, precision="default")):
        knn_agree(call(ft), call(fj))
    np.testing.assert_array_equal(ft.points().numpy(), np.asarray(fj.points()))
    np.testing.assert_allclose(ft.recall_with(q, K, **SERVE).numpy(),
                               np.asarray(fj.recall_with(q, K, **SERVE)),
                               rtol=1e-6)


def test_rebuild_densifies_as_jax_does(data):
    """``rebuild`` on an ELL forest builds over the live rows densified
    and packs them as dense blocks of the layout's type and slack, as the
    JAX package does; the two answer alike."""
    fj, ft, new, _ = _fold_case(data)
    for f in (fj, ft):
        f.remove([0, 7])
        f.rebuild()
    assert isinstance(ft.x, torch.Tensor) and ft.x.shape == (N + 4, DIM)
    assert ft._packed[0].shape == tuple(fj._packed[0].shape)
    np.testing.assert_array_equal(ft.arrays.perm.numpy(),
                                  np.asarray(fj.arrays.perm))
    q = new + 0.05
    knn_agree(ft.knn(q, K, **SERVE), fj.knn(q, K, **SERVE))


def test_load_forest_reads_a_jax_ell_checkpoint(data, tmp_path):
    """``save_forest`` of a JAX ELL forest (header ``"sparse"``, arrays
    ``x_cols`` / ``x_vals``) loads into the port and serves alike."""
    fj, _ = _twins(data)
    path = str(tmp_path / "ell.npz")
    save_forest(path, fj)
    ft = load_forest(path, device="cpu")
    assert isinstance(ft.x, ts.EllMatrix) and ft.seed == fj.seed
    np.testing.assert_array_equal(ft.x.cols.numpy(), np.asarray(fj.x.cols))
    q = data[4]
    knn_agree(ft.knn(q, K, **SERVE), fj.knn(q, K, **SERVE))


def test_refusals_match_jax(data):
    """Callables on ELL rows raise ``NotImplementedError``, the tile
    kernels' ``impl`` values ``ValueError``, on every path, as in the JAX
    package."""
    fj, ft = _twins(data)
    q = data[4][:4]

    def l1(x, y):
        return (x - y).abs().sum(-1)

    with pytest.raises(NotImplementedError, match="dense data rows"):
        ft.knn(q, K, metric=l1)
    with pytest.raises(NotImplementedError, match="dense data rows"):
        ft.brute_force_knn(q, K, metric=l1)
    ft.pack_leaves()
    for call in (lambda: ft.knn(q, K, metric=l1),
                 lambda: ft.knn_grouped(q, K, metric=l1)):
        with pytest.raises(NotImplementedError, match="dense data rows"):
            call()
    for impl in ("kernel", "kernel_full", "kernel_topk"):
        with pytest.raises(ValueError, match="impl"):
            ft.knn_grouped(q, K, impl=impl)
    fj.pack_leaves()
    with pytest.raises(ValueError, match="impl"):
        fj.knn_grouped(q, K, impl="kernel")
