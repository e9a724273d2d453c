"""The port's rendering (``rptree_tpu_torch/utils/draw.py``) against the
JAX package's on the same forest (a JAX forest carried across with
``torch_parity.carry``): leaf labels equal, and the CSV, dot and ASCII
text byte for byte the same."""

import numpy as np
import pytest
import torch

import rptree_tpu as rt
import rptree_tpu_torch as rp

from torch_parity import carry, clustered, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def twins():
    """A 2-D forest of 3 trees (the reference demo's shape) and a
    single-leaf tree, each with its carried twin."""
    x, q = clustered(11, 600, 2, 6, 0.4, 8)
    fj = rt.forest_batch(3, 4, 10, 3, 1.0, x)
    one = np.ones((5, 2), np.float32)
    gj = rt.tree_batch(0, 3, 10, 1.0, one)
    return x, q, fj, carry(fj), gj, carry(gj)


def _text(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("tree", [0, 2])
def test_leaf_labels_equal_jax(twins, tree):
    x, _, fj, ft, _, _ = twins
    got = rp.leaf_label_of_points(ft, tree)
    want = rt.leaf_label_of_points(fj, tree)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.bincount(got), ft.leaf_sizes()[:ft.plan.n_leaves])


@pytest.mark.parametrize("points", ["numpy", "tensor"])
def test_csv_bytes_equal_jax(twins, tmp_path, points):
    """``write_csv`` and ``knn_write_csv`` from numpy rows or from the
    forest's own tensors (``points()``, the knn hits) write JAX's bytes."""
    x, q, fj, ft, _, _ = twins
    pts = x if points == "numpy" else ft.points()
    labels = rp.leaf_label_of_points(ft)
    rp.write_csv(str(tmp_path / "t.csv"), pts, labels if points == "numpy"
                 else torch.as_tensor(labels))
    rt.write_csv(str(tmp_path / "j.csv"), np.asarray(fj.points()),
                 rt.leaf_label_of_points(fj))
    assert _text(tmp_path / "t.csv") == _text(tmp_path / "j.csv")
    _, ids = ft.knn(q[0], 10)
    hits = pts[ids[0][ids[0] >= 0].long()] if points == "tensor" else \
        x[ids[0][ids[0] >= 0].numpy()]
    _, jids = map(np.asarray, fj.knn(q[0], 10))
    rp.knn_write_csv(str(tmp_path / "tk.csv"), pts, labels, hits)
    rt.knn_write_csv(str(tmp_path / "jk.csv"), x, labels,
                     x[jids[0][jids[0] >= 0]])
    assert _text(tmp_path / "tk.csv") == _text(tmp_path / "jk.csv")


@pytest.mark.parametrize("tree", [0, 1])
def test_dot_bytes_equal_jax(twins, tmp_path, tree):
    _, _, fj, ft, _, _ = twins
    assert rp.to_dot(ft, name="g", tree=tree) == rt.to_dot(fj, name="g",
                                                           tree=tree)
    label = lambda lid, ids: f"{lid}:{int(np.sum(ids))}"  # noqa: E731
    assert rp.to_dot(ft, tree=tree, leaf_label=label) == rt.to_dot(
        fj, tree=tree, leaf_label=label)
    rp.write_dot(str(tmp_path / "t.dot"), ft, name="tree0", tree=tree)
    rt.write_dot(str(tmp_path / "j.dot"), fj, name="tree0", tree=tree)
    assert _text(tmp_path / "t.dot") == _text(tmp_path / "j.dot")


@pytest.mark.parametrize("tree,items", [(0, 4), (1, 2)])
def test_ascii_equal_jax(twins, capsys, tree, items):
    _, _, fj, ft, _, _ = twins
    assert rp.tree_to_string(ft, tree, items) == rt.tree_to_string(
        fj, tree, items)
    rp.draw(ft, tree)
    got = capsys.readouterr().out
    rt.draw(fj, tree)
    assert got == capsys.readouterr().out


def test_single_leaf_renderings_equal_jax(twins):
    _, _, _, _, gj, gt = twins
    assert "leaf#0 (5)" in rp.tree_to_string(gt)
    assert rp.tree_to_string(gt) == rt.tree_to_string(gj)
    assert rp.to_dot(gt) == rt.to_dot(gj)
    np.testing.assert_array_equal(rp.leaf_label_of_points(gt),
                                  rt.leaf_label_of_points(gj))
