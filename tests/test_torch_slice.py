"""The port's grouped serving path end to end against the JAX package: a
small clustered forest built by JAX, carried into the port (from its
arrays and through a ``save_forest`` checkpoint), packed and served by
both, with the exact scan as ground truth."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu.utils.io import save_forest
from rptree_tpu_torch import load_forest

from torch_parity import carry, clustered, jax_forest, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
K = 10
SERVE = dict(budget=2, probes=6, tile_m=8)


@pytest.fixture(scope="module")
def data():
    # f32 contraction-order noise in a distance grows with |x|^2 / d^2;
    # sigma 0.5 keeps neighbour distances within a few times the norms,
    # where 1e-5 holds between two correct f32 summation orders
    x, q = clustered(8, 4096, 32, 40, 0.5, 256)
    fj = jax_forest(x, seed=12, n_trees=4, min_leaf=32)
    return x, q, fj


def _recall(ids, truth):
    return float(np.mean([len(set(a) & set(b)) / K
                          for a, b in zip(ids.tolist(), truth.tolist())]))


def _set_equal_rows(a, b):
    return np.array([set(r) == set(s) for r, s in zip(a.tolist(),
                                                        b.tolist())])


def test_brute_force_matches(data):
    x, q, fj = data
    ft = carry(fj)
    dj, ij = fj.brute_force_knn(q, K)
    dt, it = ft.brute_force_knn(q, K)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    dc, ic = ft.brute_force_knn(q, K, query_chunk=100)
    assert torch.equal(ic, it)


@pytest.mark.parametrize("carry_by", ["arrays", "checkpoint"])
@pytest.mark.parametrize("chunk", [None, 100])
def test_f32_serving_matches(data, tmp_path, carry_by, chunk):
    x, q, fj = data
    if carry_by == "arrays":
        ft = carry(fj)
    else:
        path = tmp_path / "forest.npz"
        save_forest(str(path), fj)
        ft = load_forest(str(path), device="cpu")
    fj.pack_leaves()
    ft.pack_leaves()
    dj, ij = fj.knn_grouped(q, K, selection="sort", chunk=chunk, **SERVE)
    dt, it = ft.knn_grouped(q, K, selection="kernel", chunk=chunk, **SERVE)
    dj, ij, dt, it = (np.asarray(dj), np.asarray(ij), dt.numpy(),
                      it.numpy())
    assert it.shape == (q.shape[0], K) and dt.dtype == np.float32
    same = _set_equal_rows(it, ij)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(dt[same], dj[same], rtol=1e-5, atol=1e-5)
    over = ft.grouped_overflow()
    assert over["overflow"] is False and over["needed"] <= over["capacity"]


def test_int8_serving_matches(data):
    x, q, fj = data
    ft = carry(fj)
    fj.pack_leaves(dtype=jnp.int8, slack=8)
    ft.pack_leaves(dtype=torch.int8, slack=8)
    _, ij = fj.knn_grouped(q, K, selection="sort", **SERVE)
    _, it = ft.knn_grouped(q, K, selection="kernel", **SERVE)
    ij, it = np.asarray(ij), it.numpy()
    same = _set_equal_rows(it, ij)
    assert same.mean() >= 0.99, same.mean()
    truth = np.asarray(fj.brute_force_knn(q, K)[1])
    rj, rt = _recall(ij, truth), _recall(it, truth)
    assert abs(rj - rt) <= 0.005, (rj, rt)


def test_capacity_cache_and_steady_state(data):
    x, q, fj = data
    ft = carry(fj).pack_leaves()
    d1, i1 = ft.knn_grouped(q, K, **SERVE)          # learns the capacity
    key_caps = dict(ft._grouped_nt)
    d2, i2 = ft.knn_grouped(q, K, check=False, **SERVE)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    assert ft._grouped_nt == key_caps
    (cap,) = key_caps.values()
    over = ft.grouped_overflow()
    assert over["capacity"] == cap and over["needed"] <= cap
    assert cap <= over["needed"] + over["needed"] // 8
    # another chunk is another shape, with its own capacity
    ft.knn_grouped(q, K, chunk=64, **SERVE)
    assert len(ft._grouped_nt) == 2
    # an explicit capacity is used as given and never cached; too small,
    # it masks candidates (+inf, -1), never returns wrong ones
    d3, i3 = ft.knn_grouped(q, K, nt=2, check=False, **SERVE)
    over = ft.grouped_overflow()
    assert over["overflow"] and over["capacity"] == 2
    assert len(ft._grouped_nt) == 2
    live = i3.numpy() >= 0
    np.testing.assert_array_equal(np.isinf(d3.numpy()), ~live)
    assert live.sum() > 0 and (~live).sum() > 0
    rows, cols = np.nonzero(live)
    true = np.linalg.norm(q[rows].astype(np.float64)
                          - x[i3.numpy()[rows, cols]], axis=1)
    np.testing.assert_allclose(d3.numpy()[rows, cols], true, rtol=1e-5,
                               atol=1e-5)


def test_kernel_selection_counts_votes_like_jax(data):
    """``selection="kernel"`` with ``min_votes=2``: vote counting needs the
    full candidate lists, so both packages take the sort tail."""
    x, q, fj = data
    ft = carry(fj)
    fj.pack_leaves()
    ft.pack_leaves()
    dj, ij = fj.knn_grouped(q, K, selection="kernel", min_votes=2, **SERVE)
    dt, it = ft.knn_grouped(q, K, selection="kernel", min_votes=2, **SERVE)
    dj, ij, dt, it = np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()
    same = _set_equal_rows(it, ij)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(dt[same], dj[same], rtol=1e-5, atol=1e-5)
    # the vote filter dropped candidates found in one probed block only
    assert (it < 0).any() and (it >= 0).any()
    # k past the top-k kernel's 128 is served through the sort tail
    d129, i129 = ft.knn_grouped(q[:8], 129, selection="kernel", min_votes=2,
                                **SERVE)
    assert i129.shape == (8, 129)


def test_signature_and_positional_binding_match_jax(data):
    """The query entry points, the builder, the sampler and the packer
    take the JAX package's parameters in its order and with its defaults
    (the port's own ``device`` and ``r`` follow, keyword-only), so a
    positional call binds alike in both."""
    import inspect

    import rptree_tpu as rt
    import rptree_tpu_torch as rp

    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]

    for name in ("knn_grouped", "knn", "knn_batched", "brute_force_knn",
                 "recall_with", "candidates"):
        assert params(getattr(rp.RPForest, name)) == params(
            getattr(rt.RPForest, name)), name
    for name, (port_fn, jax_fn) in {
            "forest_batch": (rp.forest_batch, rt.forest_batch),
            "sample_projections": (rp.sample_projections,
                                   rt.sample_projections),
            "pack_leaves": (rp.RPForest.pack_leaves,
                            rt.RPForest.pack_leaves)}.items():
        pj = list(inspect.signature(jax_fn).parameters.values())
        pt = list(inspect.signature(port_fn).parameters.values())
        assert [p.name for p in pt[:len(pj)]] == [p.name for p in pj], name
        for a, b in zip(pt, pj):
            assert a.kind is b.kind, (name, a.name)
            assert a.default == b.default or (
                a.default is torch.float32 and b.default is jnp.float32), (
                name, a.name)
        assert [p.name for p in pt[len(pj):]] == {
            "forest_batch": ["device", "r"], "sample_projections": ["device"],
            "pack_leaves": ["r_sub"]}[name], name
        assert all(p.kind is p.KEYWORD_ONLY for p in pt[len(pj):]), name
    x, q, fj = data
    ft = carry(fj)
    fj.pack_leaves()
    ft.pack_leaves()
    args = (q, K, "sql2", 2, False, "default", 6, 8, None, 2048, False, 1,
            "sort", "auto", True, 100)
    dj, ij = fj.knn_grouped(*args)
    dt, it = ft.knn_grouped(*args)
    dj, ij, dt, it = np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()
    same = _set_equal_rows(it, ij)
    assert same.mean() >= 0.99, same.mean()
    # sql2 squares the distances, and with them their relative noise:
    # compared as l2 distances, at the slice's l2 tolerance
    np.testing.assert_allclose(np.sqrt(dt[same]), np.sqrt(dj[same]),
                               rtol=1e-5, atol=1e-5)
    # without dedup the copies of an id (one per tree) are kept
    assert (dt[:, 0] == dt[:, 1]).any()
    with pytest.raises(ValueError):
        ft.knn_grouped(q, K, precision="exact")
    # brute_force_knn's fourth parameter is the precision, as in JAX
    dj, ij = fj.brute_force_knn(q[:20], K, "l2", "fastest")
    dt, it = ft.brute_force_knn(q[:20], K, "l2", "fastest")
    same = _set_equal_rows(it.numpy(), np.asarray(ij))
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_allclose(dt.numpy()[same], np.asarray(dj)[same],
                               rtol=1e-5, atol=1e-5)
    # knn's sixth parameter is the precision, its seventh the probes
    dj, ij = fj.knn(q, K, "l2", 2, True, "default", 3)
    dt, it = ft.knn(q, K, "l2", 2, True, "default", 3)
    same = _set_equal_rows(it.numpy(), np.asarray(ij))
    assert same.mean() >= 0.99, same.mean()
    # pack_leaves' fifth parameter is sub_split, its sixth the store
    fj.pack_leaves(jnp.int8, 8, False, 1, "kmeans", "blocks")
    ft.pack_leaves(torch.int8, 8, False, 1, "kmeans", "blocks")
    np.testing.assert_array_equal(ft._packed[0].numpy(),
                                  np.asarray(fj._packed[0]))
    np.testing.assert_array_equal(ft._block_scale.numpy(),
                                  np.asarray(fj._block_scale))
    with pytest.raises(ValueError):  # an ordering neither package knows
        ft.pack_leaves(None, 0, False, 1, "random")
    fj.pack_leaves()
    # sample_projections' sixth parameter is the dtype
    rj = rt.sample_projections(5, 2, 3, 8, 0.5, jnp.bfloat16)
    rt_ = rp.sample_projections(5, 2, 3, 8, 0.5, torch.bfloat16, device="cpu")
    assert rj.dtype == jnp.bfloat16 and rt_.dtype == torch.bfloat16
    assert tuple(rt_.shape) == rj.shape == (2, 3, 8)


def test_unported_options_raise(data):
    _, q, fj = data
    ft = carry(fj)
    with pytest.raises(ValueError):
        ft.knn_grouped(q, K)  # not packed yet
    with pytest.raises(ValueError, match="centered=True applies to int8"):
        ft.pack_leaves(centered=True)  # as the JAX package refuses it
    ft.pack_leaves()
    # the XLA-form scorer serves impl="xla" and the metrics the tile
    # kernels do not
    for kw in (dict(impl="xla"), dict(metric="cosine")):
        d, i = ft.knn_grouped(q, K, **kw)
        assert d.shape == i.shape == (q.shape[0], K)
        assert d.dtype == torch.float32 and i.dtype == torch.int32
    with pytest.raises(NotImplementedError, match="Not to port"):
        ft.knn_grouped(q, K, selection="approx")
    with pytest.raises(ValueError):
        ft.knn_grouped(q, K, selection="exact")
    with pytest.raises(ValueError):
        ft.knn_grouped(q, K, impl="pallas")
    with pytest.raises(ValueError):  # every JAX metric is served; not typos
        ft.brute_force_knn(q, K, metric="l3")
    with pytest.raises(ValueError):
        ft.knn_grouped(q[:, :5], K)
    with pytest.raises(ValueError):
        ft.knn_grouped(q, 129, selection="kernel")


def test_port_imports_no_jax():
    code = ("import sys, rptree_tpu_torch, rptree_tpu_torch.streaming, "
            "rptree_tpu_torch.tuning, rptree_tpu_torch.utils.io, "
            "rptree_tpu_torch.utils.gen; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'rptree_tpu' not in sys.modules, 'rptree_tpu imported'")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA card, and alone outside the repository, the smoke
    script exits non-zero and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert p.returncode != 0, p.stdout
        assert '"ok"' not in p.stdout
