"""The port's side layers against the JAX package's: the demo
(``rptree_tpu_torch/demo.py``) writes its four files, the bench harness
(``rptree_tpu_torch/benchmarks.py``) returns JAX's keys and packs ELL rows
as JAX does, the numpy oracle (``rptree_tpu_torch/reference.py``) gives
the JAX copy's bits, and ``examples/torch_refine_vs_rebuild.py`` runs."""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rptree_tpu import benchmarks as jax_bench
from rptree_tpu import reference as jax_ref
from rptree_tpu_torch import benchmarks, demo
from rptree_tpu_torch import reference as ref
from rptree_tpu_torch.models.plan import make_plan

from torch_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_demo_writes_its_four_files(tmp_path):
    """The reference demo's parameters, on the CPU: every point labelled
    by its leaf, the knn hits labelled -1 after them, a dot leaf label
    per plan leaf."""
    demo.main(str(tmp_path), device="cpu")
    scatter = (tmp_path / "scatter.csv").read_text().split()
    assert len(scatter) == demo.N
    assert all(int(line.rsplit(",", 1)[1]) >= 0 for line in scatter)
    for name in ("knn.csv", "knn_h.csv"):
        rows = (tmp_path / name).read_text().split()
        assert rows[:demo.N] == scatter
        hits = rows[demo.N:]
        assert 1 <= len(hits) <= demo.K
        assert all(h.endswith(",-1") for h in hits)
    dot = (tmp_path / "tree.dot").read_text()
    assert dot.startswith("digraph tree0 {")
    assert dot.count("label=") == make_plan(demo.N, demo.MAX_DEPTH,
                                            demo.MIN_LEAF).n_leaves


def _jax_run_bench_keys():
    """The keys of the dict JAX's ``run_bench`` returns, read from its
    source (running it costs seconds of JAX compiles)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(jax_bench.run_bench)))
    ret, = [n for n in ast.walk(tree) if isinstance(n, ast.Return)
            and isinstance(n.value, ast.Dict)]
    return [k.value for k in ret.value.keys]


def test_run_bench_returns_jax_keys():
    got = benchmarks.run_bench(benchmarks.DEFAULT_GRID[0], reps=1,
                               device="cpu")
    assert list(got) == _jax_run_bench_keys()
    assert 0.0 <= got["recall_at_10"] <= 1.0
    assert got["build_s"] > 0 and got["qps"] > 0
    assert got["description"] == jax_bench.DEFAULT_GRID[0].description
    assert got["config"] == benchmarks.DEFAULT_GRID[0]


def test_grids_equal_jax():
    for a, b in ((benchmarks.DEFAULT_GRID, jax_bench.DEFAULT_GRID),
                 (benchmarks.REFERENCE_SCALE_GRID,
                  jax_bench.REFERENCE_SCALE_GRID)):
        assert [vars(c) for c in a] == [vars(c) for c in b]


@pytest.mark.parametrize("kind", ["sparse", "streaming"])
def test_run_bench_sparse_and_streaming(kind):
    cfg = benchmarks.BenchConfig(
        description=kind, max_depth=4, min_leaf=8, num_trees=2,
        chunk_size=100, nz_density=0.5, vector_dim=64, data_size=400,
        num_query_points=8, batch_size=8, sparse_input=kind == "sparse",
        streaming=kind == "streaming", data_nz=0.1)
    r = benchmarks.run_bench(cfg, seed=3, reps=1, device="cpu")
    assert 0.0 < r["recall_at_10"] <= 1.0 and r["qps"] > 0


def test_run_bench_refuses_a_mesh():
    """A mesh that is not a ``forest_mesh`` (a data mesh among them) is
    refused, as the JAX package's ``run_bench`` distributes over the tree
    axis; the config's tree shards run the sharded forest, with the
    single-device run's recall."""
    from rptree_tpu_torch.parallel import data_mesh

    for mesh in (object(), data_mesh(2, devices=["cpu"] * 2)):
        with pytest.raises(ValueError, match="forest_mesh"):
            benchmarks.run_bench(benchmarks.DEFAULT_GRID[0], mesh=mesh,
                                 device="cpu")
    cfg = dataclasses.replace(benchmarks.DEFAULT_GRID[0], num_trees=4)
    one = benchmarks.run_bench(cfg, reps=1, device="cpu")
    two = benchmarks.run_bench(dataclasses.replace(cfg, n_tree_shards=2),
                               reps=1, device="cpu")
    assert two["recall_at_10"] == one["recall_at_10"]
    assert two["recall_per_tree"] == one["recall_per_tree"]


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_to_ell_equals_jax(seed):
    rng = np.random.default_rng(seed)
    x = np.where(rng.uniform(size=(40, 30)) < 0.2,
                 rng.normal(size=(40, 30)), 0.0).astype(np.float32)
    x[3] = 0.0  # an empty row
    want = jax_bench.dense_to_ell(x)
    for data in (x, torch.as_tensor(x)):
        got = benchmarks.dense_to_ell(data)
        assert got.dim == want.dim
        np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
        np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))


def _forest_bits(forest):
    """Each tree's projections and nodes, leaves as their id bytes and
    branches as their threshold and margin bits, in pre-order."""
    def walk(node):
        if hasattr(node, "ids"):
            return ("tip", np.asarray(node.ids).tobytes())
        return ("bin", np.float64([node.thr, node.mgl, node.mgh]).tobytes(),
                walk(node.left), walk(node.right))
    return [(np.asarray(t.r).tobytes(), walk(t.root)) for t in forest]


@pytest.mark.parametrize("chunk", [None, 50])
def test_reference_oracle_equals_jax_copy(chunk):
    """Batch and streaming builds, candidates, knn, knnH and recall of
    the port's copy give the JAX package's values on the same inputs."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    rs = rng.normal(size=(3, 5, 6))
    q = x[:4] + 0.05
    build = ((lambda m: m.ref_forest_batch(x, rs, 5, 10)) if chunk is None
             else (lambda m: m.ref_forest_stream(x, rs, 5, 10, chunk)))
    ft, fj = build(ref), build(jax_ref)
    assert _forest_bits(ft) == _forest_bits(fj)
    for b in range(q.shape[0]):
        for t in range(3):
            np.testing.assert_array_equal(ref.ref_candidates(ft[t], q[b]),
                                          jax_ref.ref_candidates(fj[t], q[b]))
            assert ref.tree_size(ft[t]) == jax_ref.tree_size(fj[t])
        for dedup in (False, True):
            got = ref.ref_knn(ft, x, q[b], 5, dedup=dedup)
            want = jax_ref.ref_knn(fj, x, q[b], 5, dedup=dedup)
            for g, w in zip(got, want):
                assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
        for g, w in zip(ref.ref_knn_h(ft, x, q[b], 5),
                        jax_ref.ref_knn_h(fj, x, q[b], 5)):
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
        assert ref.ref_recall_with(ft, x, q[b], 5) == \
            jax_ref.ref_recall_with(fj, x, q[b], 5)


def test_refine_vs_rebuild_example_runs():
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_refine_vs_rebuild.py"),
         "3", "120"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert lines[0].startswith("oracle-level refine-vs-rebuild")
    assert [line.split()[0] for line in lines[1:]] == ["stationary",
                                                       "drifting"]
