"""The port's other dense layouts against the JAX package's
``pack_leaves``: centered int8, sub-blocks (``"kmeans"`` and ``"proj"``
orders) and the shared-row store, packed from the same forest.

What is held, and to what tolerance:

- ids, occupancy, slot order and the shared layout's tables: exact;
- slot squared norms: 1e-6 relative (the same f32 sums);
- int8 scales: 1e-6 relative; int8 codes: equal or within 1 on at least
  99.9% of the slots (the block means differ in float order);
- centered means: 1e-5 (relative, and absolute below 1); ``mudr`` the
  same where the slot's codes equal JAX's, else within the one-off
  codes' share (``scale * |mu|`` a column);
- sub-block orders: exact on data whose margins are far from zero
  (tight groups far apart, :func:`_separated`); on general data the
  orders may part where two margins are within a rounding of each other,
  so there the rows of each sub-block are held as sets and the served
  results by ``knn_agree``.

The JAX package draws its ordering direction ``r_sub`` from threefry; it
is handed to the port (``pack_leaves(r_sub=...)``) wherever the order
matters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rptree_tpu as rt
from rptree_tpu.models import forest as jfm
from rptree_tpu.ops.shared import SharedRows as JaxSharedRows
from rptree_tpu_torch.models import forest as tfm
from rptree_tpu_torch.ops.shared import SharedRows, fetch_blocks

from torch_parity import carry, clustered, jax_forest, one_torch_thread  # noqa: F401
from torch_parity import LAYOUTS, JAX_DTYPES, TORCH_DTYPES, knn_agree, pack_twins

K = 10
@pytest.fixture(scope="module")
def data():
    x, q = clustered(11, 2048, 16, 24, 0.3, 40)
    return x, q


@pytest.fixture(scope="module")
def fj(data):
    return jax_forest(data[0], seed=7, n_trees=4, min_leaf=32)


def _codes_close(got, want):
    """int8 codes equal or within 1 on at least 99.9% of the slots."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def _mudr_close(got, want, codes, want_codes, scale, mu):
    """``mudr`` to 1e-5 on the slots whose codes equal JAX's; where a code
    is one off, by that code's share, ``scale * |mu|`` in its column."""
    diff = np.abs(codes.astype(np.int32) - want_codes.astype(np.int32))
    same = (diff == 0).all(-1)
    np.testing.assert_allclose(got[same], want[same], rtol=1e-5, atol=1e-5)
    slack = (diff * scale[:, None, None] * np.abs(mu)[:, None, :]).sum(-1)
    assert (np.abs(got - want) <= slack + 1e-5 * (1 + np.abs(want))).all()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pack_layout(fj, name):
    ft = carry(fj)
    pack_twins(fj, ft, LAYOUTS[name])
    (xj, sj, ij), (xt, st, it) = fj._packed, ft._packed
    assert tuple(xt.shape) == tuple(xj.shape)
    assert ft._lens_global().dtype == torch.int32
    np.testing.assert_array_equal(ft._lens_global().numpy(),
                                  np.asarray(fj._lens_global()))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=0)
    if isinstance(xj, JaxSharedRows):
        assert isinstance(xt, SharedRows)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert xt.ids is it
        assert xt.rows.dtype == (torch.bfloat16 if "bf16" in name
                                 else torch.float32)
        return
    sub = LAYOUTS[name].get("sub_block", 1)
    jt, jj = it.numpy(), np.asarray(ij)
    if sub > 1:  # rows of each sub-block as sets (see the module doc)
        np.testing.assert_array_equal(np.sort(jt, axis=1),
                                      np.sort(jj, axis=1))
    else:
        np.testing.assert_array_equal(jt, jj)
    if xt.dtype == torch.int8:
        np.testing.assert_allclose(ft._block_scale.numpy(),
                                   np.asarray(fj._block_scale), rtol=1e-6)
    if LAYOUTS[name].get("centered"):
        (mj, mdj), (mt, mdt) = fj._block_center, ft._block_center
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5,
                                   atol=1e-5)
        _mudr_close(mdt.numpy(), np.asarray(mdj), xt.numpy(),
                    np.asarray(xj), ft._block_scale.numpy(), mt.numpy())
    else:
        assert ft._block_center is None
    if sub > 1 and not np.array_equal(jt, jj):
        return  # another order within a sub-block: the rows are compared
    if xt.dtype == torch.int8:
        _codes_close(xt.numpy(), np.asarray(xj))
    elif xt.dtype == torch.bfloat16:
        np.testing.assert_array_equal(xt.view(torch.int16).numpy(),
                                      np.asarray(xj).view(np.int16))
    else:
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))


def _separated(seed=5, groups=128, per=16, dim=8):
    """Tight groups far apart (centers N(0, 10^2), spread 0.01): every
    leaf holds several of them, and every 2-means margin and projection
    gap is far above a rounding."""
    rng = np.random.default_rng(seed)
    c = 10.0 * rng.normal(size=(groups, dim))
    x = c.repeat(per, axis=0) + 0.01 * rng.normal(size=(groups * per, dim))
    return x.astype(np.float32)


@pytest.mark.parametrize("sub,split", [(2, "kmeans"), (4, "kmeans"),
                                       (4, "proj"), (3, "proj")])
def test_sub_orders_equal_on_separated_groups(sub, split):
    fj = jax_forest(_separated(), seed=3, n_trees=2, min_leaf=64)
    ft = carry(fj)
    pack_twins(fj, ft, dict(sub_block=sub, sub_split=split))
    np.testing.assert_array_equal(ft._packed[2].numpy(),
                                  np.asarray(fj._packed[2]))
    np.testing.assert_array_equal(ft._packed[0].numpy(),
                                  np.asarray(fj._packed[0]))


def test_sub_order_kmeans_against_jax():
    """The ordering helper alone, on one forest's leaf rows with invalid
    tails: equal orders on separated groups."""
    x = _separated(seed=9, groups=64, per=8, dim=6)
    rng = np.random.default_rng(2)
    # each leaf: four whole groups, shuffled
    grp = np.stack([rng.choice(64, 4, replace=False) for _ in range(64)])
    idx = (grp[:, :, None] * 8 + np.arange(8)).reshape(64, 32)
    rows = x[np.stack([rng.permutation(r) for r in idx])]
    valid = np.arange(32)[None, :] < rng.integers(20, 33, size=64)[:, None]
    rows = np.where(valid[..., None], rows, 0.0).astype(np.float32)
    r_sub = rng.normal(size=6).astype(np.float32)
    for sub in (2, 4, 8):
        want = np.asarray(jfm._sub_order_kmeans(jnp.asarray(rows),
                                                jnp.asarray(valid),
                                                jnp.asarray(r_sub), sub))
        got = tfm._sub_order_kmeans(torch.as_tensor(rows),
                                    torch.as_tensor(valid),
                                    torch.as_tensor(r_sub), sub)
        np.testing.assert_array_equal(got.numpy(), want)


def test_center_quantize_against_jax():
    rng = np.random.default_rng(4)
    rows = (3.0 + rng.normal(size=(50, 24, 16))).astype(np.float32)
    valid = np.arange(24)[None, :] < rng.integers(0, 25, size=50)[:, None]
    rows = np.where(valid[..., None], rows, 0.0).astype(np.float32)
    qj, sj, mj, mdj = map(np.asarray, jfm._center_quantize(
        jnp.asarray(rows), jnp.asarray(valid)))
    qt, st, mt, mdt = tfm._center_quantize(torch.as_tensor(rows),
                                           torch.as_tensor(valid))
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-6)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mdt.numpy(), mdj, rtol=1e-5, atol=1e-5)
    _codes_close(qt.numpy(), qj)


def test_sub_tables_and_probe_expansion():
    lens = np.array([0, 5, 16, 17, 40])
    np.testing.assert_array_equal(
        tfm._sub_lens(lens, 8, 4),
        np.clip(lens[:, None] - np.arange(4) * 8, 0, 8).reshape(-1))
    gsel = torch.tensor([[3, 0], [7, 2]], dtype=torch.int32)
    lsel = torch.tensor([[1, -1], [5, 2]], dtype=torch.int32)
    g2, l2 = tfm._expand_sub_probes(gsel, lsel, 3)
    wg, wl = jfm._expand_sub_probes(jnp.asarray(gsel.numpy()),
                                    jnp.asarray(lsel.numpy()), 3)
    np.testing.assert_array_equal(g2.numpy(), np.asarray(wg))
    np.testing.assert_array_equal(l2.numpy(), np.asarray(wl))
    assert g2.dtype == torch.int32
    for s in (1, 2, 3, 4, 8):
        for split in ("kmeans", "proj"):
            assert tfm._sub_split_of(split, s) == jfm._sub_split_of(split, s)


def test_r_sub_is_drawn_from_the_seed(data):
    x, _ = data
    a = tfm._sub_r(7, 16, "cpu")
    assert torch.equal(a, tfm._sub_r(np.int64(7), 16, "cpu"))
    assert not torch.equal(a, tfm._sub_r(8, 16, "cpu"))
    import rptree_tpu_torch as rp
    cfg = rp.rp_tree_cfg(32, 2048, 16)
    f = rp.forest_batch(7, cfg.max_depth, 32, 2, 1.0, x, device="cpu")
    f.pack_leaves(sub_block=2, sub_split="proj")
    assert torch.equal(f._r_sub, a)


# -- shared rows -------------------------------------------------------------

def test_shared_rows_alias_and_fetch(fj, data):
    ft = carry(fj)
    ft.pack_leaves(store="shared")
    rows = ft._packed[0]
    assert isinstance(rows, SharedRows) and not isinstance(rows, torch.Tensor)
    assert rows.rows is ft.x and rows.rows.data_ptr() == ft.x.data_ptr()
    assert rows.ids is ft._packed[2]
    assert tuple(rows.shape) == (rows.ids.shape[0], rows.ids.shape[1],
                                 ft.dim)
    # the shared fetch equals a blocked pack's blocks wherever occupied
    fb = carry(fj).pack_leaves()
    idx = torch.tensor([[0, 5], [17, 3]])
    got, want = fetch_blocks(rows, idx), fetch_blocks(fb._packed[0], idx)
    occ = fb._packed[2][idx] >= 0
    assert torch.equal(got[occ], want[occ])
    # slot norms: sq_norms at the ids, bit-equal to the blocked rows' sums
    assert torch.equal(ft._packed[1], fb._packed[1])
    bf = carry(fj).pack_leaves(dtype=torch.bfloat16, store="shared")
    assert bf._packed[0].rows.dtype == torch.bfloat16
    assert bf._packed[0].rows.data_ptr() != bf.x.data_ptr()


def test_shared_rows_served_bit_equal_to_blocked(fj, data):
    """As the JAX package pins it (tests/test_shared_rows.py): every
    packed surface returns the same bits from shared rows as from the
    blocked f32 pack."""
    _, q = data
    ft = carry(fj)
    l1 = lambda rows, qq: (rows - qq).abs().sum(-1)  # noqa: E731

    def run():
        return [ft.knn(q, K), ft.knn(q, K, min_votes=2),
                ft.knn_batched(q, K, chunk=16), ft.knn_h(q, K),
                ft.knn(q, K, metric=l1), ft.knn_grouped(q, K, impl="xla"),
                ft.knn_grouped(q, K, selection="kernel", impl="xla")]

    ft.pack_leaves()
    blocked = run()
    ft.pack_leaves(store="shared")
    for (db, ib), (ds, is_) in zip(blocked, run()):
        assert torch.equal(db, ds) and torch.equal(ib, is_)


# -- refusals, repacks, rebuilds ----------------------------------------------

REFUSALS = [  # (request, message both packages give)
    (dict(store="shared", slack=4), "slack"),
    (dict(store="shared", sub_block=2), "sub_block"),
    (dict(store="shared", dtype="int8"), "blocked layout"),
    (dict(store="shared", dtype="int8", centered=True), "blocked layout"),
    (dict(store="nonsense"), "store"),
    (dict(centered=True), "centered"),
    (dict(dtype="bf16", centered=True), "centered"),
    (dict(sub_block=2, slack=4), "exclusive"),
    (dict(sub_block=2, sub_split="nope"), "sub_split"),
]


@pytest.mark.parametrize("req,msg", REFUSALS)
def test_refusals_leave_the_pack_intact(fj, req, msg):
    ft = carry(fj)
    ft.pack_leaves(dtype=torch.int8)
    blocks, cfg = ft._packed, ft._pack_cfg
    kw = dict(req)
    dtype = kw.pop("dtype", None)
    with pytest.raises(ValueError, match=msg):
        ft.pack_leaves(dtype=TORCH_DTYPES[dtype], **kw)
    with pytest.raises(ValueError, match=msg):
        carry(fj).pack_leaves(dtype=TORCH_DTYPES[dtype], **kw)  # nothing packed yet
    with pytest.raises(ValueError, match=msg):  # the JAX package's refusal
        fj.pack_leaves(dtype=JAX_DTYPES[dtype], **kw)
    assert ft._packed is blocks and ft._pack_cfg == cfg


def test_layout_refusals_of_the_updates(fj):
    ft = carry(fj)
    ft.pack_leaves(store="shared")
    with pytest.raises(ValueError, match="single-copy"):
        ft.drop_dataset()
    ft.add(np.zeros((4, ft.dim), np.float32))
    with pytest.raises(ValueError, match="shared-row"):
        ft.fold()
    ft.rebuild()
    assert isinstance(ft._packed[0], SharedRows)
    assert ft._packed[0].rows is ft.x and ft.n_points == 2048 + 4
    fs = carry(fj).pack_leaves(dtype=torch.int8, centered=True, sub_block=2)
    fs.add(np.zeros((2, fs.dim), np.float32))
    with pytest.raises(ValueError, match="whole-leaf"):
        fs.fold()
    with pytest.raises(ValueError, match="impl='kernel'"):
        fs.knn_grouped(np.zeros((2, fs.dim), np.float32), K, impl="kernel")
    fsh = carry(fj).pack_leaves(store="shared")
    with pytest.raises(ValueError, match="impl='kernel_topk'"):
        fsh.knn_grouped(np.zeros((2, fsh.dim), np.float32), K,
                        impl="kernel_topk")


def test_same_layout_is_a_noop_and_sub_split_is_canonical(fj):
    ft = carry(fj)
    ft.pack_leaves(dtype=torch.int8, centered=True, sub_block=4)
    first = ft._packed
    ft.pack_leaves(dtype=torch.int8, centered=True, sub_block=4,
                   sub_split="kmeans")
    assert ft._packed is first
    ft.pack_leaves(store="shared")
    shared = ft._packed
    assert ft.pack_leaves(store="shared")._packed is shared
    # at sub_block 1 the ordering mode shapes nothing: the same layout
    ft.pack_leaves(slack=4, sub_split="proj")
    ft.add(np.asarray(fj.x)[:3] + 1e-3)
    ft.fold()
    ft.pack_leaves(slack=4)  # a repack would raise with folded rows
    assert ft.n_folded == 3


def test_repack_sub_to_whole_and_back(fj, data):
    _, q = data
    ft = carry(fj)
    ft.pack_leaves(dtype=torch.int8, centered=True, sub_block=2)
    assert ft._sub_block == 2 and ft._lens_global().shape[0] == \
        2 * ft.n_trees * ft.plan.n_leaves
    d0, i0 = ft.knn(q, K)
    ft.pack_leaves()
    assert ft._sub_block == 1 and ft._block_center is None
    assert ft._block_scale is None and ft._grouped_nt == {}
    assert torch.equal(ft._lens_global(), ft._leaf_lens())
    ft.pack_leaves(dtype=torch.int8, centered=True, sub_block=2)
    d1, i1 = ft.knn(q, K)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)


@pytest.mark.parametrize("name", ["int8_centered_slack", "int8_centered_sub8",
                                  "bf16_sub2", "shared_bf16"])
def test_rebuild_replays_the_layout(fj, data, name):
    """``rebuild`` packs the whole remembered layout again, as the JAX
    package does: the same blocks as a fresh pack of the rebuilt rows."""
    x, _ = data
    ft = carry(fj)
    pack_twins(fj, ft, LAYOUTS[name])
    cfg = ft._pack_cfg
    ft.add(x[:6] + 0.5)
    ft.rebuild()
    assert ft._pack_cfg == cfg and ft.n_points == x.shape[0] + 6
    fresh = tfm.RPForest(ft.plan, ft.arrays, ft.x, ft.sq_norms, ft.config,
                         seed=ft.seed)
    fresh.pack_leaves(TORCH_DTYPES[LAYOUTS[name].get("dtype")],
                      **{k: v for k, v in LAYOUTS[name].items()
                         if k != "dtype"}, r_sub=ft._r_sub)
    for a, b in zip(ft._packed, fresh._packed):
        a = a.ids if isinstance(a, SharedRows) else a
        b = b.ids if isinstance(b, SharedRows) else b
        assert torch.equal(a, b)
    if cfg.centered:
        assert all(torch.equal(a, b) for a, b in zip(ft._block_center,
                                                     fresh._block_center))


def test_centered_fold_against_jax(data):
    """``fold`` into centered int8 blocks: the residual around the target
    block's mean, quantized by its scale (a true division), and ``mudr``
    at the written slots, against the JAX package's fold (codes within 1
    on 99.9% of the slots, ``mudr`` to 1e-5); then every packed surface
    (``knn_agree``, 1e-5) and each folded point finding itself."""
    rng = np.random.default_rng(61)
    x = (5.0 + rng.normal(size=(500, 8))).astype(np.float32)
    fj = rt.forest_batch(13, 4, 16, 2, 1.0, x)
    ft = carry(fj)
    fj.pack_leaves(dtype=jnp.int8, centered=True, slack=8)
    ft.pack_leaves(dtype=torch.int8, centered=True, slack=8)
    new = (5.0 + rng.normal(size=(5, 8))).astype(np.float32)
    for f in (fj, ft):
        f.add(new)
        f.fold()
    assert ft.n_folded == fj.n_folded == 5 and ft.n_pending == 0
    np.testing.assert_array_equal(ft._packed[2].numpy(),
                                  np.asarray(fj._packed[2]))
    np.testing.assert_array_equal(ft._lens_global().numpy(),
                                  np.asarray(fj._lens_global()))
    _codes_close(ft._packed[0].numpy(), np.asarray(fj._packed[0]))
    _mudr_close(ft._block_center[1].numpy(), np.asarray(fj._block_center[1]),
                ft._packed[0].numpy(), np.asarray(fj._packed[0]),
                ft._block_scale.numpy(), ft._block_center[0].numpy())
    qn = new + 1e-4
    kw = dict(budget=fj.plan.n_leaves)
    _, ids = ft.knn(qn, 1, **kw)
    assert (ids[:, 0] >= 500).all()
    knn_agree(ft.knn(qn, 3, **kw), fj.knn(qn, 3, **kw))
    knn_agree(ft.knn_grouped(qn, 3, **kw), fj.knn_grouped(qn, 3, **kw))
