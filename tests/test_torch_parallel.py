"""The port's tree- and query-sharded forests (``rptree_tpu_torch.
parallel``) against the JAX package's ``DistributedForest`` on conftest's
eight virtual CPU devices, and against the port's own single-device
forest.  The port's meshes list the CPU device eight times, which is how
one device stands in for several there.

The sizes are ``tests/test_parallel.py``'s (N 1,500, D 32, T 8, depth 6,
``min_leaf`` 16) on small-integer rows with small-integer projections, fed
to both packages (JAX's sampler is replaced for the build), so that every
product and sum is exact and the trees and blocks are equal bit for bit.
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

SEED, N, DIM, T, MAXD, MINL, PNZ = 7071, 1500, 32, 8, 6, 16, 1.0
CPU = torch.device("cpu")
MESHES = [(8, 1), (4, 2)]


@pytest.fixture(scope="module")
def case():
    """Integer rows, integer projections, queries, and the JAX package's
    forests built from them (single-device and one per mesh)."""
    rng = np.random.default_rng(99)
    x = rng.integers(-3, 4, size=(N, DIM)).astype(np.float32)
    r = rng.integers(-2, 3, size=(T, MAXD, DIM)).astype(np.float32)
    q = (2.0 * np.random.default_rng(100).normal(size=(13, DIM))).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("rptree_tpu.utils.gen.sample_projections",
                   lambda *a, **kw: r)
        jax_single = rt.forest_batch(SEED, MAXD, MINL, T, PNZ, x)
        jax_dist = {m: jpar.forest_batch_distributed(
            SEED, MAXD, MINL, T, PNZ, x, mesh=jpar.forest_mesh(*m))
            for m in MESHES}
    return dict(x=x, r=r, q=q, jax_single=jax_single, jax_dist=jax_dist)


def port_mesh(shape):
    return tpar.forest_mesh(*shape, devices=[CPU] * (shape[0] * shape[1]))


def port_dist(case, shape, **pack):
    f = tpar.forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, case["x"],
                                      mesh=port_mesh(shape), r=case["r"])
    return f.pack_leaves(**pack) if pack else f


def port_single(case, **pack):
    f = rp.forest_batch(SEED, MAXD, MINL, T, PNZ, case["x"], device="cpu",
                        r=case["r"])
    return f.pack_leaves(**{k: v for k, v in pack.items()
                            if k != "shard_by"}) if pack else f


def jax_packed(case, shape, **pack):
    """A JAX sharded forest over the case's trees packed as asked (a fresh
    one, so that tests do not share packs)."""
    return jpar.distribute(case["jax_single"], jpar.forest_mesh(*shape)
                           ).pack_leaves(**pack)


def both(got, want_jax, want_single, rtol=1e-5):
    knn_agree(got, want_jax, rtol)
    knn_agree(got, want_single, rtol)


def whole(t):
    return t.whole() if isinstance(t, Sharded) else t


def test_exports_are_jax_less_the_data_parallel_names():
    """Every name of the JAX package's ``parallel``: since the port's
    data-parallel forests, none less."""
    assert set(tpar.__all__) == set(jpar.__all__)


def test_mesh_shapes_and_refusals(monkeypatch):
    m = port_mesh((8, 1))
    assert m.shape == {"tree": 8, "query": 1} == jpar.forest_mesh(8, 1).shape
    assert len(m.devices.flatten()) == 8 and m.device(3, 0) == CPU
    assert tpar.forest_mesh(n_query_shards=2, devices=[CPU] * 8).shape == {
        "tree": 4, "query": 2}
    with pytest.raises(ValueError, match="3 tree x 2 query"):
        tpar.forest_mesh(3, 2, devices=[CPU] * 8)
    # no fallback: without a CUDA device and without devices= it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.forest_mesh()


@pytest.mark.parametrize("shape", MESHES)
def test_trees_equal_jax_and_single_device(case, shape):
    f = port_dist(case, shape)
    ft = port_single(case)
    fj = case["jax_dist"][shape]
    for name in ("r", "thr", "mgl", "mgh", "perm"):
        got = getattr(f.arrays, name)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(fj.arrays, name)),
                                      err_msg=name)
        assert torch.equal(got, getattr(ft.arrays, name)), name
    assert f.device == CPU and f.leaves(3) == ft.leaves(3)


@pytest.mark.parametrize("shape,pack", [
    ((8, 1), dict(shard_by="tree")),
    ((4, 2), dict(shard_by="leaf")),
    ((8, 1), dict(shard_by="leaf", dtype="int8", slack=8)),
    ((4, 2), dict(shard_by="tree", dtype="bf16", slack=3)),
    # projection-ordered: the 2-means order of tied integer rows is not
    # the JAX package's on one device either
    ((8, 1), dict(shard_by="leaf", sub_block=2, sub_split="proj")),
    ((4, 2), dict(shard_by="leaf", dtype="int8", centered=True)),
    ((8, 1), dict(shard_by="leaf", store="shared")),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple)
    else "-".join(f"{k}={w}" for k, w in v.items()))
def test_packed_tables_equal_jax(case, shape, pack):
    """The blocks, norms, ids, scales and centers in storage order (the
    shards' parts concatenated) equal the JAX package's global arrays,
    bit for bit; each part lies in its shard."""
    kw = dict(pack)
    dtype = kw.pop("dtype", None)
    fj = jax_packed(case, shape, dtype=JAX_DTYPES[dtype], **kw)
    r_sub = jax_r_sub(fj) if kw.get("sub_block", 1) > 1 else None
    f = port_dist(case, shape).pack_leaves(dtype=TORCH_DTYPES[dtype], **kw,
                                           r_sub=r_sub)
    assert f._packed_mode == fj._packed_mode == kw["shard_by"]
    (xt, st, it), (xj, sj, ij) = f._packed, fj._packed
    if kw.get("store") == "shared":
        assert xt.rows is f.x
        xt, xj = xt.ids, xj.ids
    xt = whole(xt)
    assert tuple(xt.shape) == tuple(xj.shape)
    if xt.dtype == torch.bfloat16:
        xt, xj = xt.view(torch.int16), np.asarray(xj).view(np.int16)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(whole(st).numpy(), np.asarray(sj))
    np.testing.assert_array_equal(whole(it).numpy(), np.asarray(ij))
    if dtype == "int8":
        np.testing.assert_array_equal(whole(f._block_scale).numpy(),
                                      np.asarray(fj._block_scale))
    if kw.get("centered"):  # the means are sums in another order, as on
        # one device (``test_torch_layouts.py``)
        for a, b in zip(f._block_center, fj._block_center):
            np.testing.assert_allclose(whole(a).numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)
    assert len(f._packed[2].parts) == shape[0]
    assert f._packed[2].part_rows * shape[0] == ij.shape[0]


def test_unpacked_paths_on_the_tree_mesh(case):
    """(8, 1): unpacked ``knn``, the global bucket stop of ``knn_h`` and
    ``recall_with``."""
    q, fj, fs = case["q"], case["jax_dist"][(8, 1)], port_single(case)
    f = port_dist(case, (8, 1))
    both(f.knn(q, 10, budget=16), fj.knn(q, 10, budget=16),
         fs.knn(q, 10, budget=16))
    both(f.knn_h(q, 5, budget=16), fj.knn_h(q, 5, budget=16),
         fs.knn_h(q, 5, budget=16))
    rec = f.recall_with(q, 10, budget=16)
    np.testing.assert_allclose(rec.numpy(), np.asarray(fj.recall_with(
        q, 10, budget=16)), atol=1e-6)
    np.testing.assert_allclose(rec.numpy(), fs.recall_with(
        q, 10, budget=16).numpy(), atol=1e-6)


def test_unpacked_votes_and_padding_on_the_2d_mesh(case):
    """(4, 2): the voting filter on the unpacked path (each shard ships
    its full candidate list), and a batch of 3 over 2 query shards."""
    q, fj, fs = case["q"], case["jax_dist"][(4, 2)], port_single(case)
    f = port_dist(case, (4, 2))
    both(f.knn(q, 8, budget=16, min_votes=2),
         fj.knn(q, 8, budget=16, min_votes=2),
         fs.knn(q, 8, budget=16, min_votes=2))
    d, i = f.knn(q[:3], 5)
    assert d.shape == (3, 5) and i.shape == (3, 5)
    knn_agree((d, i), fs.knn(q[:3], 5))


def test_tree_sharded_blocks(case):
    """``shard_by="tree"``: per-pair ``knn`` on (8, 1), then on (4, 2)
    ``knn_h`` on the blocks (the kept buckets scored where they lie),
    votes and ``knn_batched``."""
    q = case["q"]
    fs = port_single(case, shard_by="tree")
    f = port_dist(case, (8, 1), shard_by="tree")
    both(f.knn(q, 10, budget=16),
         jax_packed(case, (8, 1), shard_by="tree").knn(q, 10, budget=16),
         fs.knn(q, 10, budget=16))
    f = port_dist(case, (4, 2), shard_by="tree")
    fj = jax_packed(case, (4, 2), shard_by="tree")
    both(f.knn_h(q, 5, budget=16), fj.knn_h(q, 5, budget=16),
         fs.knn_h(q, 5, budget=16))
    both(f.knn(q, 8, budget=16, min_votes=2),
         fj.knn(q, 8, budget=16, min_votes=2),
         fs.knn(q, 8, budget=16, min_votes=2))
    got = f.knn_batched(q, 5, budget=8, chunk=4)
    both(got, fj.knn_batched(q, 5, budget=8, chunk=4),
         fs.knn_batched(q, 5, budget=8, chunk=4))
    # the per-shard probe cap: two probes of each shard's four trees
    knn_agree(f.knn(q, 5, budget=4, probes=2),
              fj.knn(q, 5, budget=4, probes=2))


def test_leaf_sharded_blocks_per_pair(case):
    """``shard_by="leaf"`` on (4, 2): ``knn`` (every owned probe scored,
    then with a per-shard quota), votes, ``knn_batched`` with a shorter
    last chunk, and ``knn_h`` on the replicated structure."""
    q = case["q"]
    fs = port_single(case, shard_by="leaf")
    f = port_dist(case, (4, 2), shard_by="leaf")
    fj = jax_packed(case, (4, 2), shard_by="leaf")
    both(f.knn(q, 10, budget=16), fj.knn(q, 10, budget=16),
         fs.knn(q, 10, budget=16))
    knn_agree(f.knn(q, 10, budget=16, probes_per_shard=6),
              fj.knn(q, 10, budget=16, probes_per_shard=6))
    both(f.knn(q, 8, budget=16, min_votes=2),
         fj.knn(q, 8, budget=16, min_votes=2),
         fs.knn(q, 8, budget=16, min_votes=2))
    # a shorter last chunk (13 = 2 x 6 + 1 over the query shards): the
    # bits of knn (JAX's chunked form is held in test_tree_sharded_blocks)
    got = f.knn_batched(q, 5, budget=8, chunk=4)
    want = f.knn(q, 5, budget=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    knn_agree(got, fs.knn(q, 5, budget=8))
    both(f.knn_h(q, 5, budget=16), fj.knn_h(q, 5, budget=16),
         fs.knn_h(q, 5, budget=16))


def test_leaf_sharded_grouped(case):
    """``knn_grouped`` on (8, 1) leaf-sharded f32 blocks against JAX, then
    each route against the single-device forest: the kernel tail,
    ``impl="kernel_topk"`` under both tails, the XLA form, votes, chunks,
    an overflowing capacity and ``check=False``; int8 blocks with slack on
    (4, 2)."""
    q = case["q"]
    fs = port_single(case, shard_by="leaf")
    f = port_dist(case, (8, 1), shard_by="leaf")
    want = fs.knn_grouped(q, 5, budget=4)
    both(f.knn_grouped(q, 5, budget=4),
         jax_packed(case, (8, 1), shard_by="leaf").knn_grouped(
             q, 5, budget=4), want)
    for kw in (dict(selection="kernel"), dict(impl="kernel_topk"),
               dict(impl="kernel_topk", selection="kernel"),
               dict(chunk=4), dict(tile_chunk=8), dict(impl="xla")):
        knn_agree(f.knn_grouped(q, 5, budget=4, **kw), want)
    assert f.grouped_overflow()["overflow"] is False
    # nt=2 is a shard's capacity, below its need: overflow reported
    f.knn_grouped(q, 5, budget=4, nt=2)
    assert f.grouped_overflow()["overflow"] is True
    knn_agree(f.knn_grouped(q, 5, budget=4, check=False), want)
    knn_agree(f.knn_grouped(q, 8, budget=4, min_votes=2,
                            selection="kernel"),
              fs.knn_grouped(q, 8, budget=4, min_votes=2))
    fi = port_dist(case, (4, 2), shard_by="leaf", dtype=torch.int8, slack=8)
    fis = port_single(case, dtype=torch.int8, slack=8)
    knn_agree(fi.knn_grouped(q, 5, budget=4, selection="kernel"),
              fis.knn_grouped(q, 5, budget=4))


def test_grouped_refusals(case):
    f = port_dist(case, (8, 1), shard_by="tree")
    with pytest.raises(ValueError, match="shard_by='leaf'"):
        f.knn_grouped(case["q"], 5)
    f = port_dist(case, (8, 1), shard_by="leaf")
    # the all_probes mode is forest state (the data-parallel shared rows'),
    # not a keyword: the JAX package's knn_grouped takes none
    with pytest.raises(TypeError, match="all_probes"):
        f.knn_grouped(case["q"], 5, all_probes=True)
    with pytest.raises(ValueError, match="k <= 128"):
        f.knn_grouped(case["q"], 200, selection="kernel")
    with pytest.raises(ValueError, match="builtin metrics"):
        f.knn_grouped(case["q"], 5, metric=lambda a, b: a.sum(-1))


@pytest.mark.parametrize("pack", [
    dict(shard_by="tree", sub_block=2), dict(shard_by="leaf", sub_block=2),
    dict(shard_by="tree", dtype=torch.int8, centered=True),
    dict(shard_by="leaf", dtype=torch.int8, centered=True, sub_block=2),
    dict(shard_by="tree", store="shared"),
    dict(shard_by="leaf", store="shared", dtype=torch.bfloat16),
], ids=lambda p: "-".join(f"{k}={v}" for k, v in p.items()))
def test_other_layouts_equal_single_device(case, pack):
    """Sub-blocks, centered int8 and shared rows on both shard modes serve
    what the single-device forest of the same layout serves, per pair,
    with the bucket stop and (leaf-sharded) grouped."""
    q = case["q"]
    r_sub = jax_r_sub(case["jax_single"]) if pack.get("sub_block") else None
    f = port_dist(case, (4, 2)).pack_leaves(**pack, r_sub=r_sub)
    kw = {k: v for k, v in pack.items() if k != "shard_by"}
    fs = rp.forest_batch(SEED, MAXD, MINL, T, PNZ, case["x"], device="cpu",
                         r=case["r"]).pack_leaves(**kw, r_sub=r_sub)
    knn_agree(f.knn(q, 10, budget=16), fs.knn(q, 10, budget=16))
    knn_agree(f.knn_h(q, 5, budget=8), fs.knn_h(q, 5, budget=8))
    if pack["shard_by"] == "leaf":
        knn_agree(f.knn_grouped(q, 5, budget=4), fs.knn_grouped(q, 5,
                                                                budget=4))


def test_quantized_copies_merge_to_the_nearest(case):
    """On int8 blocks a point's copies in two shards' blocks have
    distances of their own; the merge keeps the nearest, as one device's
    dedup does, so the results are one device's bit for bit (the JAX
    package keeps the first shard's copy: its sharded centered results
    differ from its single-device ones on most of these queries)."""
    q = case["q"]
    for pack in (dict(dtype=torch.int8, centered=True),
                 dict(dtype=torch.int8, slack=8)):
        fs = port_single(case, **pack)
        want = fs.knn(q, 10, budget=16)
        for shape, mode in (((8, 1), "tree"), ((4, 2), "leaf")):
            got = port_dist(case, shape, shard_by=mode, **pack).knn(
                q, 10, budget=16)
            assert torch.equal(got[0], want[0]), (pack, mode)
            assert torch.equal(got[1], want[1]), (pack, mode)


def test_sparse_rows_both_modes(case):
    """ELL rows packed tree- and leaf-sharded serve the single-device
    sparse forest's results (per pair, grouped, ``knn_h``)."""
    rng = np.random.default_rng(61)
    cols = np.stack([np.sort(rng.choice(DIM, size=5, replace=False))
                     for _ in range(800)]).astype(np.int32)
    vals = rng.normal(size=(800, 5)).astype(np.float32)
    m = rp.EllMatrix(DIM, torch.as_tensor(cols), torch.as_tensor(vals))
    q = case["q"]
    fs = rp.forest_batch(3, 5, 16, T, 1.0, m, device="cpu").pack_leaves()
    for shape, mode in (((8, 1), "tree"), ((4, 2), "leaf")):
        f = tpar.forest_batch_distributed(3, 5, 16, T, 1.0, m,
                                          mesh=port_mesh(shape))
        f.pack_leaves(shard_by=mode)
        knn_agree(f.knn(q, 5, budget=8), fs.knn(q, 5, budget=8))
        knn_agree(f.knn_h(q, 5, budget=8), fs.knn_h(q, 5, budget=8))
        if mode == "leaf":
            knn_agree(f.knn_grouped(q, 5, budget=8),
                      fs.knn_grouped(q, 5, budget=8))
        f.drop_dataset()
        knn_agree(f.knn(q, 5, budget=8), fs.knn(q, 5, budget=8))


def test_serve_only_after_drop_dataset(case):
    """``drop_dataset`` on tree-sharded blocks: ``knn`` and ``knn_h`` keep
    serving from the blocks; the paths that need rows raise."""
    q = case["q"]
    f = port_dist(case, (8, 1), shard_by="tree")
    before = f.knn(q, 5)
    f.drop_dataset()
    assert f.x is None and f.dim == DIM
    knn_agree(f.knn(q, 5), before, rtol=1e-6)
    knn_agree(f.knn_h(q, 5), port_single(case, shard_by="tree").knn_h(q, 5))
    with pytest.raises(ValueError, match="dataset dropped"):
        f.recall_with(q, 5)


def test_distribute_and_refusals(case):
    """``distribute`` shares a forest's tensors on the mesh's first
    device, refuses pending points, and an indivisible tree count
    raises."""
    fs = port_single(case)
    f = tpar.distribute(fs, port_mesh((4, 2)))
    assert isinstance(f, tpar.DistributedForest)
    assert f.arrays.perm.data_ptr() == fs.arrays.perm.data_ptr()
    assert f.x.data_ptr() == fs.x.data_ptr()
    knn_agree(f.knn(case["q"], 7), fs.knn(case["q"], 7))
    fs.add(case["x"][:2] + 0.5)
    with pytest.raises(ValueError, match="rebuild"):
        tpar.distribute(fs, port_mesh((8, 1)))
    with pytest.raises(ValueError, match="not divisible"):
        tpar.forest_batch_distributed(SEED, MAXD, MINL, 6, PNZ, case["x"],
                                      mesh=port_mesh((8, 1)))


def test_merge_top_k_dedups_across_shards():
    d = torch.tensor([[1.0, 3.0, 1.0, 2.0]])
    i = torch.tensor([[4, 9, 4, 7]], dtype=torch.int32)
    md, mi = tpar.merge_top_k(d, i, 3, dedup=True)
    jd, ji = jpar.merge_top_k(np.asarray(d), np.asarray(i), 3, dedup=True)
    assert mi[0].tolist() == [4, 7, 9] == np.asarray(ji)[0].tolist()
    np.testing.assert_array_equal(md.numpy(), np.asarray(jd))
