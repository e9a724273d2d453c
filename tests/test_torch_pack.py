"""The port's leaf packing against the JAX package's ``pack_leaves``: the
same forest gives the same blocks, f32, bf16 and int8, with slack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu_torch.models.forest import _tile_align

from torch_parity import carry, clustered, jax_forest, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def forests():
    x, _ = clustered(4, 3000, 24, 30, 0.2, 1)
    fj = jax_forest(x, seed=5, n_trees=3, min_leaf=24)
    return fj, carry(fj)


_DTYPES = {None: (None, None, torch.float32),
           "int8": (jnp.int8, torch.int8, torch.int8),
           "bf16": (jnp.bfloat16, torch.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("layout", [
    dict(), dict(slack=3), dict(dtype="int8", slack=8), dict(dtype="int8"),
    dict(dtype="bf16"), dict(dtype="bf16", slack=5),
])
def test_pack_equal(forests, layout):
    fj, ft = forests
    dj, dt, want_dtype = _DTYPES[layout.get("dtype")]
    int8 = layout.get("dtype") == "int8"
    slack = layout.get("slack", 0)
    fj.pack_leaves(dtype=dj, slack=slack)
    ft.pack_leaves(dtype=dt, slack=slack)
    (xj, sj, ij), (xt, st, it) = fj._packed, ft._packed
    assert tuple(xt.shape) == tuple(xj.shape)
    assert xt.dtype == want_dtype
    if want_dtype == torch.bfloat16:  # bit for bit: both round to even
        np.testing.assert_array_equal(xt.view(torch.int16).numpy(),
                                      np.asarray(xj).view(np.int16))
    else:
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6,
                               atol=0)
    if int8:
        np.testing.assert_array_equal(ft._block_scale.numpy(),
                                      np.asarray(fj._block_scale))
    else:
        assert ft._block_scale is None
    np.testing.assert_array_equal(ft._lens_global().numpy(),
                                  np.asarray(fj._lens_global()))


def test_pack_is_idempotent_and_repacks(forests):
    _, ft = forests
    ft.pack_leaves()
    first = ft._packed
    assert ft.pack_leaves()._packed is first
    ft.pack_leaves(dtype=torch.int8, slack=8)
    assert ft._packed[0].dtype == torch.int8
    assert ft._packed[0].shape[1] == _tile_align(ft.plan.max_leaf_len + 8,
                                                 "int8")


def test_unported_layouts_raise(forests):
    """The layout requests both packages refuse, with the JAX package's
    messages; block dtypes neither packs."""
    fj, ft = forests
    for kw, jkw, msg in (
            (dict(centered=True), dict(centered=True), "centered"),
            (dict(dtype=torch.bfloat16, centered=True),
             dict(dtype=jnp.bfloat16, centered=True), "centered"),
            (dict(sub_block=2, slack=4), dict(sub_block=2, slack=4),
             "exclusive"),
            (dict(store="shared", dtype=torch.int8),
             dict(store="shared", dtype=jnp.int8), "blocked layout"),
            (dict(store="shared", slack=1), dict(store="shared", slack=1),
             "slack"),
            (dict(store="rows"), dict(store="rows"), "store")):
        with pytest.raises(ValueError, match=msg):
            ft.pack_leaves(**kw)
        with pytest.raises(ValueError, match=msg):
            fj.pack_leaves(**jkw)
    with pytest.raises(ValueError):
        ft.pack_leaves(dtype=torch.float64)
    with pytest.raises(ValueError):
        ft.pack_leaves(dtype=torch.float16)


@pytest.mark.parametrize("n,dtype,want", [
    (56, "f32", 56), (57, "f32", 64), (64, "int8", 64), (56, "int8", 56),
    (72, "int8", 72), (96, "int8", 96), (30, "bf16", 32), (17, "bf16", 24),
])
def test_tile_align(n, dtype, want):
    from rptree_tpu.models.forest import _tile_align as jax_tile_align

    assert _tile_align(n, dtype) == jax_tile_align(n, dtype) == want
