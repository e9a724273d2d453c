"""The port's multi-process data-parallel build (``tests/test_multihost.py``
for the JAX package): two processes of a gloo ``torch.distributed`` group,
four CPU shards each, every process ingesting only its own half of the
rows from its own .fvecs file (``examples/torch_multihost_bench.py``'s
``run``, whose children import neither JAX nor the JAX package), held
against the port's single-process eight-shard mesh: ``perm`` equal (the
within-leaf order is original-index order in both), the grouped ids on
the leaf-sharded blocks equal, and the unpacked distances within the
5e-4 that ``tests/test_multihost.py`` states (the sizes are its: N 1,600,
D 16, T 2).  Each child has its own 120 s timeout."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import rptree_tpu_torch.parallel as tpar

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_multihost_bench",
        os.path.join(REPO, "examples", "torch_multihost_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("data,pack", [
    ("normal", {}), ("normal", {"dtype": "int8", "slack": 8}),
    ("tie_heavy", {})], ids=["f32", "int8_slack", "tie_heavy"])
def test_two_process_build_equals_one_process_mesh(tmp_path, data, pack):
    """``tie_heavy``: rows of small integers under sparse projections
    (density 0.15, two or three terms a projection), so that distinct
    points tie at medians and split across processes in the
    single-device order."""
    rng = np.random.default_rng(55)
    if data == "normal":
        x, pnz = rng.normal(size=(1600, 16)).astype(np.float32), 1.0
    else:
        x, pnz = rng.integers(-2, 3, size=(1600, 16)).astype(np.float32), 0.15
    q = x[:4] + 0.01
    records, got = _example().run(
        x, nproc=2, shards=4, device="cpu", seed=7, depth=6, min_leaf=16,
        trees=2, pnz=pnz, queries=q, k=3, pack=pack, serve={"budget": 4},
        timeout=120, tmp_root=str(tmp_path))
    assert len(records) == 2 and all(r["jax_free"] for r in records)
    assert len({(r["thr_sha"], r["perm_sha"]) for r in records}) == 1
    single = tpar.forest_batch_data_parallel(
        7, 6, 16, 2, pnz, x,
        mesh=tpar.data_mesh(8, devices=[torch.device("cpu")] * 8))
    np.testing.assert_array_equal(got["perm"], single.arrays.perm.numpy())
    d1, i1 = single.knn(q, 3)
    np.testing.assert_allclose(got["dists"], d1.numpy(), atol=5e-4)
    np.testing.assert_array_equal(got["ids"], i1.numpy())
    single.pack_leaves(**{k: getattr(torch, v) if k == "dtype" else v
                          for k, v in pack.items()})
    _, ig = single.knn_grouped(q, 3, budget=4)
    np.testing.assert_array_equal(got["ids_grouped"], ig.numpy())
