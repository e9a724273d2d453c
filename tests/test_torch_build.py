"""The port's level-synchronous builder against the JAX package's
(``ops/build.py``): the same data and projections give the same trees."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from rptree_tpu.models.plan import make_plan
from rptree_tpu.ops.build import build_forest_arrays as jax_build
from rptree_tpu.utils.io import save_forest
from rptree_tpu_torch.ops.build import _level_order
from rptree_tpu_torch.ops.build import build_forest_arrays as torch_build
from rptree_tpu_torch.models.forest import forest_batch as torch_forest_batch
from rptree_tpu_torch.utils.gen import sample_projections
from rptree_tpu_torch.utils.io import forest_from_numpy, load_forest

from torch_parity import jax_forest, one_torch_thread  # noqa: F401

_FIELDS = ("perm", "thr", "mgl", "mgh")


def _both(x, r, depth, min_leaf):
    plan = make_plan(x.shape[0], depth, min_leaf)
    a = jax_build(plan, jnp.asarray(x), jnp.asarray(r))
    b = torch_build(plan, torch.as_tensor(x), torch.as_tensor(r))
    return ({f: np.asarray(getattr(a, f)) for f in _FIELDS},
            {f: getattr(b, f).numpy() for f in _FIELDS})


def _bits(a):
    return a.view(np.int32)


@pytest.mark.parametrize("n,dim,depth,min_leaf,seed", [
    (1000, 8, 6, 8, 0), (777, 5, 9, 3, 1), (4096, 16, 8, 16, 2),
    (50, 3, 4, 1, 3),
])
def test_integer_data_bit_equal(n, dim, depth, min_leaf, seed):
    """Small integers make every f32 product and sum exact, so both sides
    see the same projections, with many ties among them (the data has only
    a few distinct values, and rows of zeros project to zero)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(n, dim)).astype(np.float32)
    x[rng.uniform(size=n) < 0.05] = 0.0
    r = rng.integers(-2, 3, size=(3, depth, dim)).astype(np.float32)
    a, b = _both(x, r, depth, min_leaf)
    for f in _FIELDS:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(_bits(a[f]), _bits(b[f]), err_msg=f)


def test_level_sort_matches_lax_sort_with_signed_zeros():
    """The two stable passes equal the 2-key stable ``lax.sort``, with
    ``-0.0`` and ``+0.0`` tied and kept in input order on both sides."""
    z = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
    _, order = lax.sort((jnp.asarray(z), jnp.arange(4)), num_keys=1,
                        is_stable=True)
    np.testing.assert_array_equal(np.asarray(order), [0, 1, 2, 3])
    np.testing.assert_array_equal(
        torch.sort(torch.as_tensor(z), stable=True).indices.numpy(),
        [0, 1, 2, 3])
    rng = np.random.default_rng(5)
    n = 2000
    seg = np.sort(rng.integers(0, 40, size=n)).astype(np.int32)
    p = rng.integers(-3, 4, size=n).astype(np.float32)
    p = np.where(rng.uniform(size=n) < 0.5, p, -p)  # +0.0 and -0.0 both
    ids = np.arange(n, dtype=np.int32)
    _, _, want = lax.sort((jnp.asarray(seg), jnp.asarray(p),
                           jnp.asarray(ids)), num_keys=2, is_stable=True)
    got = _level_order(torch.as_tensor(seg).long(), torch.as_tensor(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_float_data_close():
    """Float data: projections round differently in the two GEMMs, so
    thresholds agree to 1e-5 relative and leaf contents to >= 99%."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4096, 32)).astype(np.float32)
    fj = jax_forest(x, seed=3, n_trees=4, min_leaf=32)
    r = np.array(fj.arrays.r)
    ft = torch_forest_batch(3, fj.plan.max_depth, 32, 4, 1.0, x, r=r,
                            device="cpu")
    for f in ("thr", "mgl", "mgh"):
        np.testing.assert_allclose(getattr(ft.arrays, f).numpy(),
                                   np.asarray(getattr(fj.arrays, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    plan = fj.plan
    pj, pt = np.asarray(fj.arrays.perm), ft.arrays.perm.numpy()
    same = total = 0
    for t in range(pj.shape[0]):
        for s, m in zip(plan.leaf_start, plan.leaf_len):
            a, b = set(pj[t, s:s + m]), set(pt[t, s:s + m])
            same += len(a & b)
            total += m
    assert same / total >= 0.99, same / total
    # each tree's permutation is a permutation of the dataset
    assert (np.sort(pt, axis=1) == np.arange(x.shape[0])).all()


def test_forest_batch_own_projections():
    """Without ``r`` the port samples its own projections from a
    ``torch.Generator`` (bits differ from jax threefry by design): same
    seed, same forest; Bernoulli(pnz) support; valid permutations."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(600, 12)).astype(np.float32)
    f1 = torch_forest_batch(9, 4, 16, 3, 0.5, x, device="cpu")
    f2 = torch_forest_batch(9, 4, 16, 3, 0.5, x, device="cpu")
    assert torch.equal(f1.arrays.perm, f2.arrays.perm)
    assert torch.equal(f1.arrays.r, f2.arrays.r)
    assert tuple(f1.arrays.r.shape) == (3, 4, 12)
    nz = (f1.arrays.r != 0).float().mean().item()
    assert 0.3 < nz < 0.7, nz
    perm = f1.arrays.perm.numpy()
    assert (np.sort(perm, axis=1) == np.arange(600)).all()
    with pytest.raises(ValueError):
        torch_forest_batch(9, 4, 16, 3, 0.5, x, r=np.zeros((3, 5, 12)),
                           device="cpu")


def _one_hot_rows(seed, n, dim):
    """Rows with one nonzero coordinate, a small integer: every projection
    is one exact product, so both builders see the same projections."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, dim), np.float32)
    x[np.arange(n), rng.integers(0, dim, size=n)] = (
        rng.integers(1, 8, size=n) * rng.choice([-1, 1], size=n))
    return x


@pytest.mark.parametrize("pack", ["true", "int8", "bf16"])
def test_forest_batch_packs_at_build_as_jax(pack):
    """forest_batch's seventh to ninth parameters are JAX's (payloads,
    dtype, pack), bound by position: ``pack=True`` and a block dtype pack
    the leaves at build into JAX's blocks."""
    import rptree_tpu as rt

    x = _one_hot_rows(6, 800, 6)
    pj, pt = {"true": (True, True), "int8": (jnp.int8, torch.int8),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[pack]
    fj = rt.forest_batch(3, 5, 16, 3, 1.0, x, None, jnp.float32, pj)
    ft = torch_forest_batch(3, 5, 16, 3, 1.0, x, None, torch.float32, pt,
                            device="cpu", r=np.array(fj.arrays.r))
    np.testing.assert_array_equal(ft.arrays.perm.numpy(),
                                  np.asarray(fj.arrays.perm))
    (xt, st, it), (xj, sj, ij) = ft._packed, fj._packed
    if pack == "bf16":
        xt, xj = xt.view(torch.int16), np.asarray(xj).view(np.int16)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    if pack == "int8":
        np.testing.assert_array_equal(ft._block_scale.numpy(),
                                      np.asarray(fj._block_scale))
    # unpacked by default, as in JAX
    assert torch_forest_batch(3, 5, 16, 3, 1.0, x, device="cpu")._packed \
        is None


def test_forest_batch_unported_parameters_raise():
    x = _one_hot_rows(7, 300, 4)
    # payloads are ported: kept as given, with the seed
    f = torch_forest_batch(1, 3, 16, 2, 1.0, x, list(range(300)),
                           device="cpu")
    assert f.payloads == list(range(300)) and f.seed == 1
    # sparse (ELL) datasets are ported: the same rows as one (col, val)
    # slot each build the same trees
    from rptree_tpu_torch import EllMatrix

    cols = np.argmax(x != 0, axis=1)
    fe = torch_forest_batch(1, 3, 16, 2, 1.0, EllMatrix(
        4, cols[:, None], x[np.arange(300), cols][:, None]), device="cpu")
    assert fe.dim == 4 and torch.equal(fe.arrays.perm, f.arrays.perm)
    # datasets of other types are ported (the one-hot rows are exact in
    # bf16: the same trees); integer ones are refused
    fb = torch_forest_batch(1, 3, 16, 2, 1.0, x, None, torch.bfloat16,
                            device="cpu")
    assert fb.x.dtype == torch.bfloat16
    assert torch.equal(fb.arrays.perm, f.arrays.perm)
    with pytest.raises(ValueError, match="squared norms wrap"):
        torch_forest_batch(1, 3, 16, 2, 1.0, x, None, torch.int8,
                           device="cpu")
    with pytest.raises(TypeError):  # device is keyword-only
        torch_forest_batch(1, 3, 16, 2, 1.0, x, None, torch.float32, False,
                           "cpu")


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """``device=None`` builds on the card: without CUDA it raises, and the
    CPU is used only when asked for."""
    x = np.random.default_rng(4).normal(size=(300, 8)).astype(np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_forest_batch(1, 3, 16, 2, 1.0, x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_projections(1, 2, 3, 8, 1.0)
    f = torch_forest_batch(1, 3, 16, 2, 1.0, x, device="cpu")
    assert f.device.type == "cpu"
    header = {"n": 300, "max_depth": 3, "min_leaf": 16,
              "n_levels": f.plan.n_levels,
              "config": dict(n_trees=2, max_depth=3, min_leaf=16,
                             proj_nz_density=1.0, dim=8)}
    arrays = {k: getattr(f.arrays, k).numpy()
              for k in ("r", "thr", "mgl", "mgh", "perm")}
    arrays["x"] = x
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forest_from_numpy(header, arrays)
    assert forest_from_numpy(header, arrays, device="cpu").device.type == \
        "cpu"
    path = str(tmp_path / "forest.npz")
    save_forest(path, jax_forest(x, seed=3, n_trees=2, min_leaf=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_forest(path)
    assert load_forest(path, device="cpu").device.type == "cpu"
