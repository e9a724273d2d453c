"""Tuning in the port against the JAX package (``tuning.py``): ``tune`` at
``measure=False`` on a forest carried from JAX returns JAX's choice and
frontier for both ``serving`` values, and its refusals; ``tune_build``
sweeps JAX's candidate grid to JAX's result when both build with the same
projections; ``measure=True`` times every point on the forest's device.

Recall values are compared exactly: the queries sit near data points, far
from distance ties at the k-th neighbour."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rptree_tpu as rt
from rptree_tpu.utils import gen as jgen
import rptree_tpu_torch as rp
from rptree_tpu_torch.utils import gen as tgen

from torch_parity import carry, clustered, jax_forest, one_torch_thread  # noqa: F401

SWEEP = dict(k=5, budgets=(1, 2), probes_per_tree=(1.0, 2.0))


@pytest.fixture(scope="module")
def twins():
    x, q = clustered(47, 2000, 8, 16, 0.3, 32)
    fj = jax_forest(x, seed=3, n_trees=4, min_leaf=32)
    ft = carry(fj)
    fj.pack_leaves()
    ft.pack_leaves()
    return x, q, fj, ft


def _strip(best):
    return {k: v for k, v in best.items() if k != "frontier"}


@pytest.mark.parametrize("target", [0.8, 1.01])
@pytest.mark.parametrize("serving", ["batched", "grouped"])
def test_tune_matches_jax(twins, serving, target):
    """JAX's budget, probes, recall, cost, ``met`` and ``scan``, and its
    whole frontier in its order: every swept point and the exact scan."""
    _, q, fj, ft = twins
    want = rt.tune(fj, q, target_recall=target, measure=False,
                   serving=serving, **SWEEP)
    got = rp.tune(ft, q, target_recall=target, measure=False,
                  serving=serving, **SWEEP)
    assert got["frontier"] == want["frontier"]
    assert _strip(got) == _strip(want)
    assert len(got["frontier"]) == 2 * 2 + 1
    assert got["met"] == (target < 1.0)


def test_tune_refusals(twins):
    x, q, fj, ft = twins
    for pkg, f in ((rt, fj), (rp, ft)):
        with pytest.raises(ValueError, match="serving"):
            pkg.tune(f, q, serving="turbo", measure=False)
    unpacked = rp.forest_batch(3, 6, 32, 2, 1.0, x, device="cpu")
    with pytest.raises(ValueError, match="pack_leaves"):
        rp.tune(unpacked, q, serving="grouped")


@pytest.mark.parametrize("serving", ["batched", "grouped"])
def test_tune_measures_every_point(twins, serving):
    """``measure=True``: every frontier point timed (QPS > 0), the grouped
    points tagged, the winner the fastest point meeting the target."""
    _, q, _, ft = twins
    best = rp.tune(ft, q[:8], target_recall=0.5, reps=1, time_rows=32,
                   serving=serving, k=5, budgets=(1, 2),
                   probes_per_tree=(1.0,))
    assert best["met"] and all(r["qps"] > 0 for r in best["frontier"])
    assert all(r.get("serving") == "grouped"
               for r in best["frontier"] if not r.get("scan")) == (
        serving == "grouped")
    assert best["qps"] == max(r["qps"] for r in best["frontier"]
                              if r["recall"] >= 0.5)


@pytest.fixture
def jax_projections(monkeypatch):
    """The port's sampler replaced by the JAX package's draws, so that both
    ``tune_build`` sweeps build the same forests."""
    def sample(seed, n_trees, depth, dim, pnz, dtype=torch.float32, *,
               device=None):
        r = np.array(jgen.sample_projections(seed, n_trees, depth, dim, pnz))
        return torch.as_tensor(r, device=device)

    monkeypatch.setattr(tgen, "sample_projections", sample)


@pytest.mark.parametrize("data", ["numpy", "tensor"])
def test_tune_build_sweeps_jax_grid(jax_projections, data):
    """The (n_trees, min_leaf) grid around ``sample / centers_estimate``,
    the subsample, each point's ``tune`` and the scaled leaf size: JAX's
    (a tensor subsamples as JAX does a device array)."""
    x, q = clustered(48, 2500, 8, 24, 0.2, 16)
    kw = dict(k=5, target_recall=0.9, n_trees_grid=(3, 2),
              centers_estimate=24, sample=2048, full_n=60_000,
              budgets=(1,), probes_per_tree=(1.0,), measure=False)
    want = rt.tune_build(x if data == "numpy" else jnp.asarray(x), q, **kw)
    got = rp.tune_build(x if data == "numpy" else torch.as_tensor(x), q,
                        device="cpu", **kw)
    grid = [(r["n_trees"], r["min_leaf"]) for r in want["frontier"]]
    assert grid == [(t, ml) for t in (2, 3) for ml in (42, 85, 170)]
    assert [(r["n_trees"], r["min_leaf"]) for r in got["frontier"]] == grid
    for g, w in zip(got["frontier"], want["frontier"]):
        assert g == w
    assert _strip(got) == _strip(want)


def test_tune_build_default_ladder():
    """Without an estimate: the power-of-four ladder below the sample."""
    x, q = clustered(49, 1200, 6, 8, 0.2, 8)
    best = rp.tune_build(x, q, k=3, target_recall=0.5, sample=1000,
                         budgets=(1,), probes_per_tree=(1.0,), device="cpu")
    assert [r["min_leaf"] for r in best["frontier"]] == [16, 64, 256]
    ml = best["min_leaf_full"]
    assert ml & (ml - 1) == 0 and ml >= best["min_leaf"] * 1200 // 1000


def test_tune_on_data_parallel_forest():
    """``tune`` on a data-parallel forest (its sweep's queries and exact
    scan run the sharded paths): the forest points of the single-device
    forest with the same trees, and its choice; the scan point is the
    sharded scan's, fp32 at every precision as in the JAX package (one
    device's scans at "fastest" in bf16), so its recall is 1."""
    from rptree_tpu_torch.parallel import (data_mesh,
                                           forest_batch_data_parallel)

    x, q = clustered(50, 1600, 8, 16, 0.3, 24)
    fs = rp.forest_batch(3, 6, 12, 3, 1.0, x, device="cpu")
    fd = forest_batch_data_parallel(3, 6, 12, 3, 1.0, x,
                                    mesh=data_mesh(8, devices=["cpu"] * 8),
                                    r=fs.arrays.r)
    kw = dict(k=5, target_recall=0.6, budgets=(1, 2),
              probes_per_tree=(1.0,), measure=False)
    got, want = rp.tune(fd, q, **kw), rp.tune(fs, q, **kw)
    forest_points = [r for r in got["frontier"] if not r.get("scan")]
    assert forest_points == [r for r in want["frontier"]
                             if not r.get("scan")]
    assert [r["recall"] for r in got["frontier"] if r.get("scan")] == [1.0]
    assert _strip(got) == _strip(want) and not got.get("scan")


def test_tune_build_on_data_parallel_forest(monkeypatch):
    """``tune_build`` on a data-parallel forest samples its rows by one
    gather a shard, never making the dataset whole, and sweeps what the
    same rows from the host sweep (JAX's
    ``test_tune_build_on_sharded_dataset``); ``full_n`` is the sharded
    corpus's size."""
    from rptree_tpu_torch.parallel import (data_mesh,
                                           forest_batch_data_parallel)
    from rptree_tpu_torch.parallel.collectives import Sharded

    x, q = clustered(51, 1600, 8, 16, 0.3, 32)
    f = forest_batch_data_parallel(3, 6, 12, 3, 1.0, x,
                                   mesh=data_mesh(8, devices=["cpu"] * 8))

    def refuse(self):
        raise AssertionError("the sharded dataset was made whole")

    monkeypatch.setattr(Sharded, "whole", refuse)
    kw = dict(k=5, target_recall=0.3, n_trees_grid=(3,),
              min_leaf_grid=(16,), seed=3, budgets=(1,),
              probes_per_tree=(1.0,), measure=False)
    got = rp.tune_build(f, q, sample=512, device="cpu", **kw)
    idx = np.sort(np.random.default_rng(3).choice(1600, size=512,
                                                  replace=False))
    want = rp.tune_build(x[idx], q, sample=512, full_n=1600, device="cpu",
                         **kw)
    assert got["frontier"] == want["frontier"]
    assert _strip(got) == _strip(want)
    assert got["min_leaf_full"] >= got["min_leaf"]
