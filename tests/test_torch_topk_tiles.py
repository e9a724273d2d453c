"""Kernel 1's bf16 input and kernel 4, the tile scoring fused with a
per-slot top-kp (``ops/grouped_kernel.py``), and the grouping around them
(``ops/grouped.py``), in the port against the JAX package: the plain
torch versions against the Pallas kernels in interpret mode, and
``grouped_topk_kernel`` / the bf16 ``grouped_distances_kernel`` against
the JAX package's own functions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import rptree_tpu.ops.grouped_kernel as jk
from rptree_tpu.ops import grouped as jg
from rptree_tpu_torch.ops import grouped as tg
from rptree_tpu_torch.ops import grouped_kernel as tk

from torch_parity import one_torch_thread  # noqa: F401

# Both sides sum exact fp32 products (of bf16 values, for bf16 blocks) in
# fp32, in different orders: 1e-5 holds at these widths and norms.
RTOL = ATOL = 1e-5
# ids must agree on entries apart from their row neighbours by more than
# this (relative, floored at 1): noise of 1e-5 can reorder closer ones
NEAR_TIE = 1e-4
TC_K = 8


def _tiles(seed, g, lmax, d, tile_m, nt):
    """Blocks with repeated tiles, partial and empty occupancy, and point
    ids; slot norms from the f32 rows, as packing takes them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, lmax, d)).astype(np.float32)
    sq = (x * x).sum(-1).astype(np.float32)
    ids = rng.permutation(g * lmax).astype(np.int32).reshape(g, lmax)
    tb = rng.integers(0, g, size=nt).astype(np.int32)
    tb[: nt // 4] = tb[0]
    lens = rng.integers(1, lmax + 1, size=nt).astype(np.int32)
    lens[1] = 0
    lens[2] = lmax
    qt = rng.normal(size=(nt * tile_m, d)).astype(np.float32)
    return x, sq, ids, tb, lens, qt


def _blocks(x, bf16):
    """The same blocks for both packages; bf16 rounds to nearest even on
    both sides (checked bit for bit)."""
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    if bf16:
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
        np.testing.assert_array_equal(
            xt.view(torch.int16).numpy(),
            np.asarray(xj).view(np.int16))
    return xj, xt


def _prec(bf16):
    """The precision the JAX package hands its kernels: HIGHEST for f32
    blocks, the native single pass for bf16."""
    return None if bf16 else lax.Precision.HIGHEST


@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,tile_m,nt", [
    (24, 16, 32, 4, 32), (6, 32, 20, 8, 16),
])
def test_bf16_plain_matches_pallas(metric, g, lmax, d, tile_m, nt):
    x, sq, _, tb, lens, qt = _tiles(0, g, lmax, d, tile_m, nt)
    xj, xt = _blocks(x, True)
    want = np.asarray(jk.grouped_score_tiles(
        xj, jnp.asarray(sq), jnp.asarray(tb), jnp.asarray(lens),
        jnp.asarray(qt), metric, tile_m, TC_K, interpret=True))
    args = [xt] + [torch.as_tensor(a) for a in (sq, tb, lens, qt)]
    got = tk.grouped_score_tiles_reference(*args, metric, tile_m).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the query rows were rounded: f32 blocks of the same values differ
    f32 = tk.grouped_score_tiles_reference(
        xt.float(), *args[1:], metric, tile_m).numpy()
    fin = np.isfinite(want)
    assert np.abs(f32[fin] - want[fin]).max() > 1e-3
    before = (tk.grouped_score_tiles.launches,
              tk.grouped_score_tiles.launches_bf16)
    np.testing.assert_array_equal(
        tk.grouped_score_tiles(*args, metric, tile_m).numpy(), got)
    assert (tk.grouped_score_tiles.launches,
            tk.grouped_score_tiles.launches_bf16) == before


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,tile_m,nt,kp", [
    (24, 16, 32, 4, 32, 8), (6, 32, 20, 8, 16, 16),
])
def test_topk_plain_matches_pallas(bf16, metric, g, lmax, d, tile_m, nt, kp):
    x, sq, ids, tb, lens, qt = _tiles(2, g, lmax, d, tile_m, nt)
    xj, xt = _blocks(x, bf16)
    od, oi = jk.grouped_score_topk(
        xj, jnp.asarray(sq), jnp.asarray(ids), jnp.asarray(tb),
        jnp.asarray(lens), jnp.asarray(qt), metric, tile_m, TC_K, kp,
        precision=_prec(bf16), interpret=True)
    od, oi = np.asarray(od), np.asarray(oi)
    args = [xt] + [torch.as_tensor(a) for a in (sq, ids, tb, lens, qt)]
    pd, pi = tk.grouped_score_topk_reference(*args, metric, tile_m, kp)
    pd, pi = pd.numpy(), pi.numpy()
    assert pd.shape == pi.shape == (nt * tile_m, kp) and pi.dtype == np.int32
    np.testing.assert_allclose(pd, od, rtol=RTOL, atol=ATOL)
    chk = tk.untied(pd, NEAR_TIE).numpy()
    assert chk.sum() > 0.8 * np.isfinite(pd).sum()
    np.testing.assert_array_equal(pi[chk], oi[chk])
    # the port writes -1 where the Pallas kernel leaves a junk id
    assert (pi[np.isinf(pd)] == -1).all()
    assert np.isinf(pd[tile_m:2 * tile_m]).all()  # the empty tile
    before = tk.grouped_score_topk.launches
    wd, wi = tk.grouped_score_topk(*args, metric, tile_m, kp)
    assert torch.equal(wd, torch.as_tensor(pd))
    assert torch.equal(wi, torch.as_tensor(pi))
    assert tk.grouped_score_topk.launches == before


@pytest.mark.parametrize("bf16", [False, True])
def test_topk_duplicates_and_empty(bf16):
    """Duplicate rows come out once per copy (slots are taken by index,
    not by id), in slot order; a tile with no occupancy returns +inf."""
    g, lmax, d, kp, tile_m, nt = 2, 8, 16, 8, 2, 4
    x = np.zeros((g, lmax, d), np.float32)
    x[0, :, 0] = [1, 1, 2, 2, 2, 3, 4, 5]
    x[1] = np.random.default_rng(0).normal(size=(lmax, d))
    sq = (x * x).sum(-1).astype(np.float32)
    ids = np.arange(g * lmax, dtype=np.int32).reshape(g, lmax)
    tb = np.array([0, 0, 1, 1], np.int32)
    lens = np.array([lmax, lmax, 0, lmax], np.int32)
    qt = np.zeros((nt * tile_m, d), np.float32)
    xj, xt = _blocks(x, bf16)
    od, oi = jk.grouped_score_topk(
        xj, jnp.asarray(sq), jnp.asarray(ids), jnp.asarray(tb),
        jnp.asarray(lens), jnp.asarray(qt), "l2", tile_m, 2, kp,
        precision=_prec(bf16), interpret=True)
    pd, pi = tk.grouped_score_topk_reference(
        xt, *[torch.as_tensor(a) for a in (sq, ids, tb, lens, qt)], "l2",
        tile_m, kp)
    pd, pi = pd.numpy(), pi.numpy()
    np.testing.assert_array_equal(pd[0], [1, 1, 2, 2, 2, 3, 4, 5])
    np.testing.assert_array_equal(pi[0], np.arange(8))
    np.testing.assert_array_equal(pd[:2 * tile_m], np.asarray(od)[:2 * tile_m])
    np.testing.assert_array_equal(pi[:2 * tile_m], np.asarray(oi)[:2 * tile_m])
    assert np.isinf(pd[2 * tile_m:3 * tile_m]).all()
    assert (pi[2 * tile_m:3 * tile_m] == -1).all()


def test_topk_bad_arguments():
    x, sq, ids, tb, lens, qt = (torch.as_tensor(a)
                                for a in _tiles(3, 4, 16, 8, 2, 4))
    for kp in (0, 17, 129):
        with pytest.raises(ValueError):
            tk.grouped_score_topk(x, sq, ids, tb, lens, qt, "l2", 2, kp)
    with pytest.raises(ValueError):
        tk.grouped_score_topk(x, sq, ids[:, :8], tb, lens, qt, "l2", 2, 8)
    with pytest.raises(ValueError):
        tk.grouped_score_topk(x, sq, ids, tb, lens, qt, "cosine", 2, 8)
    with pytest.raises(TypeError):
        tk.grouped_score_topk(x.to(torch.int8), sq, ids, tb, lens, qt, "l2",
                              2, 8)


def _pairs(seed, b, p, g, lens_max, d):
    rng = np.random.default_rng(seed)
    gsel = rng.integers(0, g, size=(b, p)).astype(np.int32)
    lsel = np.where(rng.uniform(size=(b, p)) < 0.2, -1, gsel % 97)
    gsel = np.where(lsel < 0, 0, gsel).astype(np.int32)
    lens = rng.integers(1, lens_max + 1, size=g).astype(np.int32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    return gsel, lsel.astype(np.int32), lens, q


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("nt", [96, 32])  # 32 overflows: pairs masked
def test_grouped_topk_kernel_matches(monkeypatch, bf16, nt):
    """The JAX package's own ``grouped_topk_kernel``, its kernel run in
    interpret mode; ``nt`` a multiple of its 16-tile grid step, so both
    sides hold the same capacity."""
    monkeypatch.setattr(jk, "grouped_score_topk", functools.partial(
        jk.grouped_score_topk, interpret=True))
    g, lmax, d, b, p, tile_m, kp = 20, 32, 24, 40, 5, 4, 16
    x, sq, ids, _, _, _ = _tiles(6, g, lmax, d, tile_m, 4)
    gsel, lsel, lens, q = _pairs(7, b, p, g, lmax, d)
    xj, xt = _blocks(x, bf16)
    dj, ij, need_j = jg.grouped_topk_kernel(
        xj, jnp.asarray(sq), jnp.asarray(ids), jnp.asarray(lens),
        jnp.asarray(gsel), jnp.asarray(lsel), jnp.asarray(q), "l2",
        lax.Precision.HIGHEST, tile_m, nt, kp)
    dt, it, need_t = tg.grouped_topk_kernel(
        xt, *[torch.as_tensor(a) for a in (sq, ids, lens, gsel, lsel, q)],
        "l2", tile_m, nt, kp)
    assert int(need_t) == int(need_j)
    assert dt.shape == it.shape == (b, p, kp)
    dj, ij, dt, it = np.asarray(dj), np.asarray(ij), dt.numpy(), it.numpy()
    np.testing.assert_array_equal(np.isinf(dt), np.isinf(dj))
    fin = np.isfinite(dj)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=RTOL, atol=ATOL)
    chk = tk.untied(dt.reshape(b * p, kp), NEAR_TIE).numpy()
    chk = chk.reshape(b, p, kp)
    np.testing.assert_array_equal(it[chk], ij[chk])
    assert (it[~fin] == -1).all()
    if nt < int(need_j):
        assert np.isinf(dt).all(axis=-1).sum() > np.isinf(dt).all(-1).size // 10


@pytest.mark.parametrize("metric", ["l2", "sql2"])
def test_bf16_grouped_distances_match(metric):
    """bf16 blocks through the port's tile kernel against the JAX
    package's XLA grouped scorer, which rounds the query rows the same
    way (``qt.astype(bf16)``)."""
    g, lmax, d, b, p, tile_m, nt = 20, 16, 24, 40, 5, 4, 200
    x, sq, _, _, _, _ = _tiles(8, g, lmax, d, tile_m, 4)
    gsel, lsel, lens, q = _pairs(9, b, p, g, lmax, d)
    xj, xt = _blocks(x, True)
    want, need_j = jax.jit(
        jg.grouped_distances,
        static_argnames=("metric", "precision", "tile_m", "nt",
                         "tile_chunk"))(
        xj, jnp.asarray(sq), jnp.asarray(lens), jnp.asarray(gsel),
        jnp.asarray(lsel), jnp.asarray(q), metric=metric,
        precision=lax.Precision.HIGHEST, tile_m=tile_m, nt=nt,
        tile_chunk=nt // 2)
    got, need_t = tg.grouped_distances_kernel(
        xt, *[torch.as_tensor(a) for a in (sq, lens, gsel, lsel, q)], metric,
        tile_m, nt)
    assert int(need_t) == int(need_j)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
