"""Serving the port's data-parallel forests: the leaf-sharded packs from
the sharded rows (f32, bf16, int8 with slack, centered int8, sub-blocks,
ELL) and the shared-row layout with its ``all_probes`` mode, served per
pair, grouped (both tails) and with the bucket stop, then fold and
rebuild, against the JAX package's ``DataParallelForest`` on conftest's
eight virtual CPU devices and against the port's single-device forests.

Two cases.  Small-integer rows with the JAX package's own (float)
projections handed to the port, so that the two data-parallel builds
place every point alike (no two points tie at a median) and every row
and norm is exact: the packed tables (the shards' parts in storage order
against JAX's global arrays) are equal bit for bit and the served results
agree within ``knn_agree``'s 1e-5.  And
float rows, whose data-parallel trees hold the single-device build's leaf
sets, so that every layout serves what one device's pack of the same
layout serves, ids equal outside near-ties.

Queries near their own rows (the float case's, and the folded rows')
have distances of ~0.1 against norms of ~24 to ~100, which the factored
``|x|^2 - 2 x.q + |q|^2`` cancels: a block's slots in another order, or a
batch of another shape, sum the CPU products in another order there, so
those comparisons hold distances within 2e-4 (the JAX package's own bound
for them, ``tests/test_data_parallel.py``
``test_dp_knn_grouped_matches_knn``); the others within 1e-5.
"""

import numpy as np
import pytest
import torch

import rptree_tpu as rt
import rptree_tpu.parallel as jpar
import rptree_tpu_torch as rp
import rptree_tpu_torch.parallel as tpar
from rptree_tpu_torch.parallel.collectives import Sharded

from torch_parity import (JAX_DTYPES, TORCH_DTYPES, jax_r_sub, knn_agree,
                          one_torch_thread)  # noqa: F401

SEED, N, DIM, T, MAXD, MINL, PNZ = 909, 1600, 24, 3, 6, 12, 1.0
CPU = torch.device("cpu")


def mesh(s=8, n_query=1):
    return tpar.data_mesh(s, devices=[CPU] * (s * n_query), n_query=n_query)


@pytest.fixture(scope="module")
def case():
    """Integer rows, float queries, and the JAX package's data-parallel
    forest of them on eight devices, whose projections the port takes."""
    rng = np.random.default_rng(99)
    x = rng.integers(-3, 4, size=(N, DIM)).astype(np.float32)
    q = (2.0 * np.random.default_rng(100).normal(size=(13, DIM))).astype(
        np.float32)
    fj = jpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ, x,
                                         mesh=jpar.data_mesh(8))
    return dict(x=x, r=np.array(fj.arrays.r), q=q, fj=fj)


@pytest.fixture(scope="module")
def floats():
    """Float rows, queries near them, and the port's single-device forest
    (its projections drawn from the seed)."""
    x = np.random.default_rng(11).normal(size=(N, DIM)).astype(np.float32)
    q = (x[:9] + 0.02).astype(np.float32)
    single = rp.forest_batch(SEED, MAXD, MINL, T, PNZ, x, device="cpu")
    return dict(x=x, q=q, r=single.arrays.r)


def port_dp(x, r, s=8, n_query=1):
    return tpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ, x,
                                           mesh=mesh(s, n_query), r=r)


def jax_dp(case):
    """A fresh JAX data-parallel forest over the case's trees."""
    fj = case["fj"]
    return jpar.DataParallelForest(fj.plan, fj.arrays, fj.x, fj.sq_norms,
                                   fj.config, fj.mesh, seed=fj.seed)


def whole(t):
    return t.whole() if isinstance(t, Sharded) else t


def equal_table(got, want, name):
    got = whole(got)
    if got.dtype == torch.bfloat16:
        got = got.float()
        want = np.asarray(want).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=name)


LAYOUTS = {
    "f32": {}, "bf16": dict(dtype="bf16"),
    "int8_slack": dict(dtype="int8", slack=8),
    "int8_centered": dict(dtype="int8", centered=True),
    "sub2_proj": dict(sub_block=2, sub_split="proj"),
    "sub4_kmeans": dict(sub_block=4),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_packed_tables_equal_jax(case, layout):
    """The leaf-sharded blocks assembled from the sharded rows: blocks,
    slot norms, ids, scales and centers (the shards' parts in storage
    order) bit-equal to the JAX package's, each part ``ceil(G / 8)``
    blocks (times the sub-blocks) on its shard."""
    kw = dict(LAYOUTS[layout])
    dtype = kw.pop("dtype", None)
    fj = jax_dp(case).pack_leaves(dtype=JAX_DTYPES[dtype], **kw)
    r_sub = jax_r_sub(fj) if kw.get("sub_block", 1) > 1 else None
    f = port_dp(case["x"], case["r"]).pack_leaves(
        dtype=TORCH_DTYPES[dtype], **kw, r_sub=r_sub)
    np.testing.assert_array_equal(f.arrays.perm.numpy(),
                                  np.asarray(fj.arrays.perm))
    if kw.get("sub_block", 1) > 1 and kw.get("sub_split") != "proj":
        # the 2-means order of tied integer rows is not JAX's on one
        # device either (tests/test_torch_parallel.py): the ids' sets
        ids, idj = whole(f._packed[2]).numpy(), np.asarray(fj._packed[2])
        s = kw["sub_block"]
        np.testing.assert_array_equal(
            np.sort(ids.reshape(-1, s * ids.shape[1]), 1),
            np.sort(idj.reshape(-1, s * idj.shape[1]), 1))
        return
    for name, got, want in zip(("blocks", "sq", "ids"), f._packed,
                               fj._packed):
        equal_table(got, want, name)
    g_rows = -(-T * f.plan.n_leaves // 8) * f._sub_block
    assert {p.shape[0] for p in f._packed[0].parts} == {g_rows}
    if dtype == "int8":
        equal_table(f._block_scale, fj._block_scale, "scale")
    if kw.get("centered"):
        for got, want, name in zip(f._block_center, fj._block_center,
                                   ("mu", "mudr")):
            np.testing.assert_allclose(whole(got).numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-5, err_msg=name)


def test_shared_tables_equal_jax(case):
    """``store="shared"``: each shard's row store is its own dataset part
    (the same tensor), and its local slot tables (local rows, global ids,
    slot norms) and member counts equal the JAX package's; the
    ``all_probes`` mode is the forest's state."""
    fj = jax_dp(case).pack_leaves(store="shared")
    f = port_dp(case["x"], case["r"]).pack_leaves(store="shared")
    assert f._shared_all_probes and fj._shared_all_probes
    blocks, sq, gid = f._packed
    assert all(r is p for r, p in zip(blocks.rows.parts, f.x.parts))
    equal_table(blocks.ids, fj._packed[0].ids, "local rows")
    equal_table(sq, fj._packed[1], "sq")
    equal_table(gid, fj._packed[2], "gid")
    equal_table(f._shared_len_loc, fj._shared_len_loc, "counts")
    assert blocks.ids.parts[0].shape[1] % 8 == 0


SERVE = {
    "knn": lambda f, q: f.knn(q, 5, budget=4),
    "knn_batched": lambda f, q: f.knn_batched(q, 5, budget=4, chunk=4),
    "grouped_sort": lambda f, q: f.knn_grouped(q, 5, budget=4),
    "grouped_kernel": lambda f, q: f.knn_grouped(q, 5, budget=4,
                                                 selection="kernel"),
    "knn_h": lambda f, q: f.knn_h(q, 5, budget=4),
    "min_votes": lambda f, q: f.knn(q, 5, budget=4, min_votes=2),
}


@pytest.mark.parametrize("store", ["blocks", "shared"])
@pytest.mark.parametrize("call", list(SERVE))
def test_serving_equals_jax(case, store, call):
    """f32 leaf-sharded blocks and the shared rows (``all_probes``: every
    shard scores every probe against its own members), per pair, grouped
    under both tails, with the bucket stop and the vote filter: the JAX
    package's results."""
    fj = jax_dp(case).pack_leaves(store=store)
    f = port_dp(case["x"], case["r"]).pack_leaves(store=store)
    if call == "grouped_kernel":  # the JAX tail is the TPU's: its sort tail
        want = SERVE["grouped_sort"](fj, case["q"])
    else:
        want = SERVE[call](fj, case["q"])
    knn_agree(SERVE[call](f, case["q"]), want)


@pytest.mark.parametrize("layout", ["f32", "bf16", "int8_slack",
                                    "int8_centered", "sub2_proj",
                                    "sub4_kmeans", "shared_f32",
                                    "shared_bf16"])
def test_layouts_serve_as_one_device(floats, layout):
    """Float rows, whose data-parallel trees hold the single-device leaf
    sets: each layout packed from the sharded rows serves, per pair,
    batched, grouped and with the bucket stop, what the single-device
    pack of the same layout serves (the int8 rows of a block, its scale
    and the sub-block orders are the same; ``r_sub`` is handed over)."""
    kw = dict(LAYOUTS.get(layout, {}))
    if layout.startswith("shared"):
        kw = dict(store="shared",
                  **({"dtype": "bf16"} if layout.endswith("bf16") else {}))
    dtype = TORCH_DTYPES[kw.pop("dtype", None)]
    r_sub = (np.random.default_rng(3).normal(size=DIM).astype(np.float32)
             if kw.get("sub_block", 1) > 1 else None)
    f = port_dp(floats["x"], floats["r"]).pack_leaves(dtype=dtype, **kw,
                                                      r_sub=r_sub)
    s = rp.forest_batch(SEED, MAXD, MINL, T, PNZ, floats["x"], device="cpu",
                        r=floats["r"]).pack_leaves(dtype=dtype, **kw,
                                                   r_sub=r_sub)
    q = floats["q"]
    for name in ("knn", "knn_batched", "grouped_sort", "knn_h"):
        knn_agree(SERVE[name](f, q), SERVE[name](s, q), 2e-4)


def test_query_axis_serving(case):
    """Packed serving on a (data, query) mesh, each query shard's slice of
    an odd batch on its own devices, equals the 1-D mesh's and the JAX
    package's."""
    f1 = port_dp(case["x"], case["r"]).pack_leaves()
    f2 = port_dp(case["x"], case["r"], 4, 2).pack_leaves()
    fj = jax_dp(case).pack_leaves()
    q = np.concatenate([case["q"], case["q"][:8] + 0.5])
    for call in ("knn", "knn_batched", "grouped_sort", "knn_h"):
        got = SERVE[call](f2, q)
        knn_agree(got, SERVE[call](f1, q))
        knn_agree(got, SERVE[call](fj, q))


def test_fold_equals_jax(case):
    """``add`` then ``fold`` into the leaf-sharded slack blocks (the writes
    go through to the shards): the folded counts, the served results, the
    exact scan with the folded rows merged and ``recall_with`` equal the
    JAX package's."""
    rng = np.random.default_rng(42)
    new = rng.integers(-3, 4, size=(40, DIM)).astype(np.float32)
    fj = jax_dp(case).pack_leaves(slack=8)
    f = port_dp(case["x"], case["r"]).pack_leaves(slack=8)
    for g in (fj, f):
        g.add(new)
        g.fold()
    assert (f.n_folded, f.n_pending) == (fj.n_folded, fj.n_pending)
    assert f.n_folded > 0
    q = np.concatenate([case["q"], new[:5] + 0.1])
    for call in ("knn", "knn_batched", "grouped_sort", "knn_h"):
        knn_agree(SERVE[call](f, q), SERVE[call](fj, q), 2e-4)
    # the exact scan's k-th may tie the (k+1)-th, which neither shows
    knn_agree(f.brute_force_knn(q, 5), fj.brute_force_knn(q, 5), 2e-4,
              last=False)
    np.testing.assert_allclose(f.recall_with(q, 5, budget=4).numpy(),
                               np.asarray(fj.recall_with(q, 5, budget=4)),
                               atol=1e-6)


def test_rebuild_stays_data_parallel(floats):
    """``rebuild`` gathers the live rows and builds them data-parallel
    again on the same mesh, the pack replayed: the trees of
    a batch build over those rows; an indivisible size raises and leaves
    the forest as it was."""
    x, r = floats["x"], floats["r"]
    f = port_dp(x, r).pack_leaves(dtype=torch.int8, slack=8)
    new = (x[:12] + 3.0).astype(np.float32)
    f.add(new)
    f.fold()
    f.remove([0, 1, 2, 3])
    f.rebuild()
    assert isinstance(f, tpar.DataParallelForest) and f.tree_size() == N + 8
    assert f.n_folded == f.n_pending == f.n_deleted == 0
    assert {p.shape[0] for p in f.x.parts} == {(N + 8) // 8}
    assert f._packed is not None and f._pack_cfg.slack == 8
    live = np.concatenate([x[4:], new])
    fresh = port_dp(live, r)
    for name in ("perm", "thr", "mgl", "mgh"):  # bit for bit, NaN padding
        assert (getattr(f.arrays, name).numpy().tobytes()
                == getattr(fresh.arrays, name).numpy().tobytes()), name
    _, ids = f.knn(new[:3] + 1e-4, 1, budget=f.plan.n_leaves)
    assert (ids[:, 0] >= N - 4).all()
    f.add(x[:3])
    with pytest.raises(ValueError, match="does not divide"):
        f.rebuild()
    assert f.n_pending == 3 and f.tree_size() == N + 8


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "ell"])
def test_rebuild_shards_own_their_rows(floats, sparse):
    """After ``rebuild`` on a four-shard mesh every shard's rows are a
    tensor of their own, N/S rows of storage: no part is a view that
    keeps the whole staged dataset alive."""
    if sparse:
        cols, vals = ell()
        f = tpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ,
                                            rp.EllMatrix(96, cols, vals),
                                            mesh=mesh(4))
        f.remove(np.arange(8))
    else:
        f = port_dp(floats["x"], floats["r"], s=4)
        f.add(floats["x"][:4] + 1.0)
    f.rebuild()
    per = f.n_points // 4
    tables = ((f.x.cols, f.x.vals) if sparse else (f.x,))
    for tab in tables:
        for p in tab.parts:
            assert p.shape[0] == per
            assert p.untyped_storage().nbytes() == p.nbytes


def ell(seed=21):
    rng = np.random.default_rng(seed)
    cols = rng.integers(1, 96, size=(N, 8)).astype(np.int32)
    vals = rng.integers(-3, 4, size=(N, 8)).astype(np.float32)
    vals[rng.random((N, 8)) < 0.2] = 0.0
    cols[vals == 0.0] = 0
    return cols, vals


def test_ell_equals_jax():
    """Sparse rows (integer values, the JAX package's projections handed
    over): the data-parallel ELL build's permutation, its leaf-sharded ELL
    blocks (assembled from the sharded column and value tables) bit-equal
    to the JAX package's, served per pair, grouped (kernel 10's plain
    version) and with the bucket stop; ``drop_dataset`` keeps serving."""
    cols, vals = ell()
    fj = jpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ,
                                         rt.EllMatrix(96, cols, vals),
                                         mesh=jpar.data_mesh(8))
    f = tpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ,
                                        rp.EllMatrix(96, cols, vals),
                                        mesh=mesh(), r=np.array(fj.arrays.r))
    np.testing.assert_array_equal(f.arrays.perm.numpy(),
                                  np.asarray(fj.arrays.perm))
    assert {p.shape[0] for p in f.x.cols.parts} == {N // 8}
    dense = np.zeros((9, 96), np.float32)
    for j in range(9):
        np.add.at(dense[j], cols[j], vals[j])
    q = dense + 0.25
    knn_agree(f.knn(q, 5, budget=4), fj.knn(q, 5, budget=4))
    fj.pack_leaves()
    f.pack_leaves()
    equal_table(f._packed[0].cols, fj._packed[0].cols, "cols")
    equal_table(f._packed[0].vals, fj._packed[0].vals, "vals")
    equal_table(f._packed[1], fj._packed[1], "sq")
    equal_table(f._packed[2], fj._packed[2], "ids")
    want = fj.knn(q, 5, budget=4)
    for call in ("knn", "grouped_sort", "knn_h"):
        knn_agree(SERVE[call](f, q), SERVE[call](fj, q))
    f.drop_dataset()
    knn_agree(f.knn(q, 5, budget=4), want)


def test_ell_rebuild_stays_sparse():
    """ELL ``rebuild``: the sparse tables with the pending rows as slot
    lists, the removed ones purged, never densified; a pending row wider
    than the tables' K slots raises."""
    cols, vals = ell()
    f = tpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ,
                                        rp.EllMatrix(96, cols, vals),
                                        mesh=mesh())
    new = np.zeros((16, 96), np.float32)
    for j in range(16):
        new[j, [j % 96, (j * 3 + 1) % 96]] = (1.0 + j, -0.5)
    f.add(new)
    f.remove(np.arange(N, N + 8))
    f.rebuild()
    assert f.n_points == N + 8 and isinstance(f.x, rp.EllMatrix)
    assert isinstance(f.x.cols, Sharded) and f.n_deleted == 0
    _, ids = f.knn(new[8:10], 1, budget=16)
    np.testing.assert_allclose(f.points()[ids[:, 0].long()].numpy(),
                               new[8:10], atol=1e-6)
    g = tpar.forest_batch_data_parallel(SEED, MAXD, MINL, T, PNZ,
                                        rp.EllMatrix(96, cols, vals),
                                        mesh=mesh())
    g.add(np.ones((8, 96), np.float32))
    with pytest.raises(ValueError, match="nonzeros"):
        g.rebuild()


def test_pack_refusals_keep_the_layout(case):
    """JAX's refusals, raised before anything changes: another shard mode,
    ``centered`` without int8, shared rows with slack; fold and
    ``drop_dataset`` refuse the shared rows."""
    f = port_dp(case["x"], case["r"]).pack_leaves(dtype=torch.int8)
    want = f.knn(case["q"], 5, budget=4)
    with pytest.raises(ValueError, match="shard_by='leaf' only"):
        f.pack_leaves(shard_by="tree")
    with pytest.raises(ValueError, match="centered=True"):
        f.pack_leaves(centered=True)
    with pytest.raises(ValueError, match="slack"):
        f.pack_leaves(store="shared", slack=4)
    got = f.knn(case["q"], 5, budget=4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    g = port_dp(case["x"], case["r"]).pack_leaves(store="shared")
    g.add(case["x"][:2])
    with pytest.raises(ValueError, match="shared-row layout"):
        g.fold()
    with pytest.raises(ValueError, match="shared-row layout"):
        g.drop_dataset()
