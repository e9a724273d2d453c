"""Grouped tile scoring in the port (``ops/grouped_kernel.py``,
``ops/grouped.py``) against the JAX package: the plain torch versions of
the f32 and int8 tile kernels against the Pallas kernels in interpret
mode, and the tile tables and pair reorder against the JAX grouping."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from rptree_tpu.ops import grouped as jg
from rptree_tpu.ops import grouped_kernel as jk
from rptree_tpu_torch.ops import grouped as tg
from rptree_tpu_torch.ops import grouped_kernel as tk

from torch_parity import one_torch_thread  # noqa: F401

RTOL = ATOL = 1e-5


def _tiles(seed, g, lmax, d, tile_m, nt):
    """Blocks with repeated tiles, partial and empty occupancy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, lmax, d)).astype(np.float32)
    sq = (x * x).sum(-1).astype(np.float32)
    tb = rng.integers(0, g, size=nt).astype(np.int32)
    tb[: nt // 4] = tb[0]                    # a run of one block
    lens = rng.integers(1, lmax + 1, size=nt).astype(np.int32)
    lens[1] = 0                              # an empty tile
    lens[2] = lmax
    qt = rng.normal(size=(nt * tile_m, d)).astype(np.float32)
    qt[tile_m - 1::tile_m] = 0.0             # junk rows of empty slots
    return x, sq, tb, lens, qt


def _int8(x):
    scale = (np.abs(x).max(axis=(1, 2)) * np.float32(1 / 127)).astype(
        np.float32)
    xi = np.clip(np.round(x / scale[:, None, None]), -127, 127)
    return xi.astype(np.int8), scale


@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,tile_m,nt", [
    (24, 16, 32, 4, 32), (6, 24, 20, 8, 16), (10, 8, 32, 1, 8),
    (4, 24, 960, 8, 8), (4, 24, 1000, 8, 8),
])
def test_f32_plain_matches_pallas(metric, g, lmax, d, tile_m, nt):
    x, sq, tb, lens, qt = _tiles(0, g, lmax, d, tile_m, nt)
    want = np.asarray(jk.grouped_score_tiles(
        jnp.asarray(x), jnp.asarray(sq), jnp.asarray(tb), jnp.asarray(lens),
        jnp.asarray(qt), metric, tile_m, 8, interpret=True))
    args = [torch.as_tensor(a) for a in (x, sq, tb, lens, qt)]
    got = tk.grouped_score_tiles_reference(*args, metric, tile_m).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isinf(got[tile_m:2 * tile_m]).all()  # the empty tile
    # the wrapper takes the plain version on the CPU; no launch counted
    before = tk.grouped_score_tiles.launches
    np.testing.assert_array_equal(
        tk.grouped_score_tiles(*args, metric, tile_m).numpy(), got)
    assert tk.grouped_score_tiles.launches == before


@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,tile_m,nt", [
    (6, 24, 20, 8, 16), (4, 24, 960, 8, 8), (4, 24, 1000, 8, 8),
])
def test_bf16_plain_matches_pallas(metric, g, lmax, d, tile_m, nt):
    """bf16 blocks: both round the query rows to bf16 and sum the exact
    products in f32, at D up to the GIST width and past it."""
    x, sq, tb, lens, qt = _tiles(3, g, lmax, d, tile_m, nt)
    xb = torch.as_tensor(x).bfloat16()
    want = np.asarray(jk.grouped_score_tiles(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(sq), jnp.asarray(tb), jnp.asarray(lens), jnp.asarray(qt),
        metric, tile_m, 8, interpret=True))
    args = [xb, *(torch.as_tensor(a) for a in (sq, tb, lens, qt))]
    got = tk.grouped_score_tiles_reference(*args, metric, tile_m).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isinf(got[tile_m:2 * tile_m]).all()  # the empty tile


@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("g,lmax,d,tile_m,nt", [
    (12, 32, 32, 4, 32), (5, 64, 30, 8, 16),
])
def test_int8_plain_matches_pallas(metric, g, lmax, d, tile_m, nt):
    x, sq, tb, lens, qt = _tiles(1, g, lmax, d, tile_m, nt)
    xi, scale = _int8(x)
    want = np.asarray(jk.grouped_score_tiles_int8(
        jnp.asarray(xi), jnp.asarray(sq), jnp.asarray(scale),
        jnp.asarray(tb), jnp.asarray(lens), jnp.asarray(qt), metric,
        tile_m, 8, interpret=True))
    args = [torch.as_tensor(a) for a in (xi, sq, scale, tb, lens, qt)]
    got = tk.grouped_score_tiles_int8_reference(*args, metric,
                                                tile_m).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    before = tk.grouped_score_tiles_int8.launches
    np.testing.assert_array_equal(
        tk.grouped_score_tiles_int8(*args, metric, tile_m).numpy(), got)
    assert tk.grouped_score_tiles_int8.launches == before


def test_quantize_rows_bit_equal():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(300, 40)).astype(np.float32)
    q[0] = 0.0
    q[1, :5] = [127.0, -63.5, 0.5, 1.5, -2.5]  # round-half-even cases
    qi_j, s_j = jax.jit(jg._quantize_rows)(jnp.asarray(q))
    qi_t, s_t = tk._quantize_rows(torch.as_tensor(q))
    np.testing.assert_array_equal(qi_t.numpy(), np.asarray(qi_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.int32),
                                  np.asarray(s_j).view(np.int32))


def test_gate_and_bad_arguments():
    assert tk.grouped_kernel_ok(torch.zeros(4, 13, 8), "l2")
    assert tk.grouped_kernel_ok(torch.zeros(4, 16, 8, dtype=torch.int8),
                                "sql2")
    assert not tk.grouped_kernel_ok(torch.zeros(4, 16, 8), "cosine")
    assert tk.grouped_kernel_ok(
        torch.zeros(4, 16, 8, dtype=torch.bfloat16), "l2")
    assert not tk.grouped_kernel_ok(
        torch.zeros(4, 16, 8, dtype=torch.float16), "l2")
    x, sq, tb, lens, qt = (torch.as_tensor(a)
                           for a in _tiles(3, 4, 8, 8, 2, 4))
    with pytest.raises(ValueError):
        tk.grouped_score_tiles(x, sq, tb, lens, qt, "cosine", 2)
    with pytest.raises(ValueError):
        tk.grouped_score_tiles(x, sq, tb, lens, qt[:-1], "l2", 2)


def _pairs(seed, b, p, g, masked=0.2):
    rng = np.random.default_rng(seed)
    # few blocks, so runs of one block span several tiles
    gsel = rng.integers(0, g, size=(b, p)).astype(np.int32)
    lsel = np.where(rng.uniform(size=(b, p)) < masked, -1, gsel % 97)
    gsel = np.where(lsel < 0, 0, gsel).astype(np.int32)
    return gsel, lsel.astype(np.int32)


@pytest.mark.parametrize("nt", [400, 60, 13])  # 60 and 13 overflow
def test_tile_tables_match(nt):
    tile_m = 4
    gsel, lsel = _pairs(4, 96, 6, 30)
    tb_j, tp_j, need_j, slot_j = jg._tile_tables(
        jnp.asarray(gsel), jnp.asarray(lsel), tile_m, nt, with_slots=True)
    tb_t, tp_t, need_t, slot_t = tg._tile_tables(
        torch.as_tensor(gsel), torch.as_tensor(lsel), tile_m, nt,
        with_slots=True)
    assert int(need_t) == int(need_j)
    if nt < int(need_j):
        assert int(need_t) > nt
    np.testing.assert_array_equal(tb_t.numpy(), np.asarray(tb_j))
    tp_j = np.asarray(tp_j)
    for a, b in zip(tp_t.numpy(), tp_j):
        assert set(a.tolist()) == set(b.tolist())
    # slot is the inverse of tp; pairs in no tile point at the pad row
    slot_t = slot_t.numpy()
    tp_flat = tp_t.numpy().reshape(-1)
    for pair, s in enumerate(slot_t):
        if s < nt * tile_m:
            assert tp_flat[s] == pair
        else:
            assert pair not in tp_flat
    assert (slot_t == nt * tile_m).sum() == (np.asarray(slot_j)
                                             == nt * tile_m).sum()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("metric", ["l2", "sql2"])
@pytest.mark.parametrize("nt", [200, 24])  # 24 overflows: pairs masked
def test_grouped_distances_match(int8, metric, nt):
    rng = np.random.default_rng(6)
    g, lmax, d, b, p, tile_m = 20, 16, 24, 40, 5, 4
    x = rng.normal(size=(g, lmax, d)).astype(np.float32)
    lens = rng.integers(1, lmax + 1, size=g).astype(np.int32)
    x = np.where(np.arange(lmax)[None, :, None] < lens[:, None, None], x, 0)
    x = x.astype(np.float32)
    sq = (x * x).sum(-1).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    gsel, lsel = _pairs(7, b, p, g)
    scale = None
    if int8:
        x, scale = _int8(x)
    want, need_j = jax.jit(
        jg.grouped_distances,
        static_argnames=("metric", "precision", "tile_m", "nt",
                         "tile_chunk"))(
        jnp.asarray(x), jnp.asarray(sq), jnp.asarray(lens),
        jnp.asarray(gsel), jnp.asarray(lsel), jnp.asarray(q),
        metric=metric, precision=lax.Precision.HIGHEST, tile_m=tile_m,
        nt=nt, tile_chunk=nt // 2 if nt % 2 == 0 else nt,
        block_scale=None if scale is None else jnp.asarray(scale))
    got, need_t = tg.grouped_distances_kernel(
        torch.as_tensor(x), torch.as_tensor(sq), torch.as_tensor(lens),
        torch.as_tensor(gsel), torch.as_tensor(lsel), torch.as_tensor(q),
        metric, tile_m, nt,
        block_scale=None if scale is None else torch.as_tensor(scale))
    assert int(need_t) == int(need_j)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == (b, p, lmax)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
