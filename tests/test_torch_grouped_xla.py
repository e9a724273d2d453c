"""The port's XLA-form grouped scorer (``ops/grouped.py``
``grouped_distances``) and the grouped path's routing to it, against the
JAX package on the CPU, where the JAX package scores every grouped call
with its own XLA form: f32, bf16 and int8 blocks; ``l2``, ``sql2``,
``cosine``, ``dot`` and a callable (L1); a capacity with and without
overflow; a ``tile_chunk`` that divides the capacity and one that leaves a
shorter last step (the JAX package needs the first kind)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from rptree_tpu.ops import grouped as jg
from rptree_tpu_torch.models import forest as tf
from rptree_tpu_torch.ops import grouped as tg
from rptree_tpu_torch.ops.grouped_kernel import INV_127

from torch_parity import carry, clustered, jax_forest, knn_agree, one_torch_thread  # noqa: F401

# the tolerance of tests/test_torch_grouped_kernel.py: f32 sums in two
# orders, on rows of a few units
RTOL = ATOL = 1e-5
K = 10
SERVE = dict(budget=2, probes=6, tile_m=8)


def l1_jax(x, q):
    return jnp.abs(x - q).sum(-1)


def l1_torch(x, q):
    return (x - q).abs().sum(-1)


METRICS = {"l2": ("l2", "l2"), "sql2": ("sql2", "sql2"),
           "cosine": ("cosine", "cosine"), "dot": ("dot", "dot"),
           "l1": (l1_jax, l1_torch)}
# (capacity, the JAX package's tile_chunk, a ragged one): needed is 57
CAPS = {96: 32, 40: 8}
RAGGED = 7


def _operands(dtype):
    """Blocks with partial occupancy (zero rows past it, as packing
    leaves them), their norms and scales, queries and pairs: G 24, lmax
    16, D 16, B 48, P 5, a fifth of the pairs masked, one block probed by
    every fourth query."""
    rng = np.random.default_rng(11)
    g, lmax, d, b, p = 24, 16, 16, 48, 5
    x = rng.normal(size=(g, lmax, d)).astype(np.float32)
    lens = rng.integers(1, lmax + 1, size=g).astype(np.int32)
    x = np.where(np.arange(lmax)[None, :, None] < lens[:, None, None], x,
                 0).astype(np.float32)
    sq = (x * x).sum(-1).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    gsel = rng.integers(0, g, size=(b, p)).astype(np.int32)
    gsel[::4, 0] = 3
    lsel = np.where(rng.uniform(size=(b, p)) < 0.2, -1, gsel).astype(np.int32)
    gsel = np.where(lsel < 0, 0, gsel).astype(np.int32)
    scale = None
    if dtype == "int8":
        scale = (np.abs(x).max(axis=(1, 2)) * np.float32(INV_127)).astype(
            np.float32)
        x = np.clip(np.round(x / scale[:, None, None]), -127,
                    127).astype(np.int8)
    return x, sq, lens, gsel, lsel, q, scale


_JAX = {}


def _jax_distances(dtype, metric, nt):
    key = (dtype, metric, nt)
    if key not in _JAX:
        x, sq, lens, gsel, lsel, q, scale = _operands(dtype)
        xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else None)
        d, need = jax.jit(
            jg.grouped_distances,
            static_argnames=("metric", "precision", "tile_m", "nt",
                             "tile_chunk"))(
            xj, jnp.asarray(sq), jnp.asarray(lens), jnp.asarray(gsel),
            jnp.asarray(lsel), jnp.asarray(q), metric=METRICS[metric][0],
            precision=lax.Precision.HIGHEST, tile_m=4, nt=nt,
            tile_chunk=CAPS[nt],
            block_scale=None if scale is None else jnp.asarray(scale))
        _JAX[key] = (np.asarray(d), int(need))
    return _JAX[key]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("nt", sorted(CAPS))  # 40 < needed: pairs masked
@pytest.mark.parametrize("metric", sorted(METRICS))
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_grouped_distances_match_jax(dtype, metric, nt, ragged):
    x, sq, lens, gsel, lsel, q, scale = _operands(dtype)
    xt = torch.as_tensor(x)
    if dtype == "bf16":
        xt = xt.bfloat16()
    args = (xt, *map(torch.as_tensor, (sq, lens, gsel, lsel, q)),
            METRICS[metric][1], 4, nt, RAGGED if ragged else CAPS[nt])
    kw = dict(block_scale=None if scale is None else torch.as_tensor(scale))
    if dtype == "int8" and metric == "l1":
        with pytest.raises(NotImplementedError):
            tg.grouped_distances(*args, **kw)
        return
    want, need_j = _jax_distances(dtype, metric, nt)
    got, need_t = tg.grouped_distances(*args, **kw)
    assert need_t.dtype == torch.int32 and need_t.dim() == 0
    assert int(need_t) == need_j == 57
    got = got.numpy()
    assert got.shape == want.shape == (48, 5, 16)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_tile_tables_wrapper_takes_the_twin_on_the_cpu():
    """On CPU tensors kernel 9's wrapper is :func:`_tile_tables` and the
    gather of each tile's occupancy, and counts no launch."""
    _, _, lens, gsel, lsel, _, _ = _operands("f32")
    gsel, lsel, lens = map(torch.as_tensor, (gsel, lsel, lens))
    before = tg.tile_tables.launches
    tb, tp, need, slot, lens_t = tg.tile_tables(gsel, lsel, lens, 4, 40)
    assert tg.tile_tables.launches == before
    want = tg._tile_tables(gsel, lsel, 4, 40, with_slots=True)
    for a, w in zip((tb, tp, need, slot), want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert torch.equal(lens_t, lens[tb.long()])
    assert int(need) > 40 and (tp[:, 0] >= 0).all()  # overflow: every tile used


@pytest.fixture(scope="module")
def forest():
    x, q = clustered(8, 2048, 16, 20, 0.5, 128)
    fj = jax_forest(x, seed=12, n_trees=4, min_leaf=32)
    ft = carry(fj)
    fj.pack_leaves()
    ft.pack_leaves()
    return q, fj, ft


@pytest.mark.parametrize("metric,selection,min_votes,impl", [
    ("cosine", "sort", 1, "auto"), ("cosine", "kernel", 1, "auto"),
    ("dot", "sort", 1, "auto"), ("dot", "kernel", 1, "auto"),
    ("l1", "sort", 1, "auto"), ("cosine", "sort", 2, "auto"),
    ("l2", "sort", 1, "xla"),
])
def test_knn_grouped_matches_jax(forest, monkeypatch, metric, selection,
                                 min_votes, impl):
    """The port's ``knn_grouped`` through the XLA form against the JAX
    package's (its sort tail), on a carried forest; ``impl="xla"`` on
    ``l2`` also against the port's tile-kernel form."""
    q, fj, ft = forest
    mj, mt = METRICS[metric]
    want = fj.knn_grouped(q, K, metric=mj, min_votes=min_votes,
                          selection="sort", **SERVE)
    calls, real = [], tf.grouped_distances

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tf, "grouped_distances", spy)
    got = ft.knn_grouped(q, K, metric=mt, min_votes=min_votes,
                         selection=selection, impl=impl, **SERVE)
    assert calls  # the XLA form scored
    knn_agree(got, want)
    if metric == "dot":
        assert (got[0][:, 0] < 0).all()
    if impl == "xla":
        calls.clear()
        auto = ft.knn_grouped(q, K, metric=mt, selection=selection, **SERVE)
        assert not calls  # l2 under "auto": the tile kernels' form
        knn_agree(got, auto)


def test_kernel_impls_refuse_what_the_kernels_do_not_serve(forest):
    q, fj, ft = forest
    for impl in ("kernel", "kernel_full", "kernel_topk"):
        with pytest.raises(ValueError, match="impl"):
            ft.knn_grouped(q, K, metric="cosine", impl=impl, **SERVE)
        with pytest.raises(ValueError):
            ft.knn_grouped(q, K, metric=l1_torch, impl=impl, **SERVE)
    with pytest.raises(ValueError):  # the JAX package's gate raises too
        fj.knn_grouped(q, K, metric="cosine", impl="kernel", **SERVE)
    with pytest.raises(ValueError):
        ft.knn_grouped(q, K, metric="l3", **SERVE)
    fj.pack_leaves(jnp.int8)
    ft.pack_leaves(torch.int8)
    try:
        with pytest.raises(NotImplementedError, match="int8"):
            fj.knn_grouped(q, K, metric=l1_jax, **SERVE)
        with pytest.raises(NotImplementedError, match="int8"):
            ft.knn_grouped(q, K, metric=l1_torch, **SERVE)
        # builtin metrics serve int8 blocks through the XLA form
        d, i = ft.knn_grouped(q, K, metric="cosine", **SERVE)
        assert d.shape == (q.shape[0], K) and (i >= 0).all()
    finally:
        fj.pack_leaves()
        ft.pack_leaves()


def test_capacity_serves_a_larger_tile_chunk(forest):
    """A capacity learned at ``tile_chunk=8`` serves a later call at 64
    without a check: the XLA form's last step is shorter, so no capacity
    has to be a multiple of the step (the JAX package rounds it to one and
    keeps the step out of its cache key)."""
    q, _, ft = forest
    ft._grouped_nt.clear()
    first = ft.knn_grouped(q, K, metric="cosine", tile_chunk=8, **SERVE)
    (cap,) = ft._grouped_nt.values()
    assert cap % 64  # not a whole number of steps at 64
    again = ft.knn_grouped(q, K, metric="cosine", tile_chunk=64, check=False,
                           **SERVE)
    assert ft._grouped_last[1] == cap and list(ft._grouped_nt.values()) == [cap]
    assert not ft.grouped_overflow()["overflow"]
    for a, b in zip(first, again):
        assert torch.equal(a, b)
