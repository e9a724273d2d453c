"""The port's traversal and probe selection against the JAX package's
(``ops/traverse.py``, ``models/forest.py:_select_probes``).

The JAX side runs its own dispatch: the superlevel fast paths at budgets
1-8 (bit-equal to its frontier form) and the frontier form above that.
On the CPU the port's wrappers run the plain twins of kernels 7 and 8
(the frontier form over the node table, and the stable sort), so these
tests hold the twins against every JAX form; ``tests/test_torch_cuda.py``
holds the kernels against the twins on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu.models.forest import _select_probes as jax_select_probes
from rptree_tpu.models.plan import make_plan
from rptree_tpu.ops.build import build_forest_arrays as jax_build
from rptree_tpu.models.forest import _traverse_forest as jax_traverse_forest
from rptree_tpu.ops import traverse as jtv
from rptree_tpu.ops.traverse import bitonic_sort_kv as jax_bitonic
from rptree_tpu.ops.traverse import traverse_tree as jax_traverse
from rptree_tpu_torch.models.forest import _select_probes as torch_select_probes
from rptree_tpu_torch.ops import traverse as ttv
from rptree_tpu_torch.ops.build import TreeArrays
from rptree_tpu_torch.ops.traverse import bitonic_sort_kv
from rptree_tpu_torch.ops.traverse import traverse_tree as torch_traverse

from torch_parity import one_torch_thread  # noqa: F401


def _dyadic(rng, shape):
    """Multiples of 1/16 in [-2, 2]: with D <= 16 every product and sum
    of a projection is exact in f32, in any order, so both packages see
    bit-equal projections (and some exact ties)."""
    return (rng.integers(-32, 33, size=shape) / 16.0).astype(np.float32)


def _forest(n, dim, depth, min_leaf, trees, seed):
    rng = np.random.default_rng(seed)
    x = _dyadic(rng, (n, dim))
    r = _dyadic(rng, (trees, depth, dim))
    plan = make_plan(n, depth, min_leaf)
    ja = jax_build(plan, jnp.asarray(x), jnp.asarray(r))
    ta = TreeArrays(*(torch.as_tensor(np.array(a)) for a in ja))
    return plan, ja, ta, rng


CASES = [  # (n, dim, depth, min_leaf, budgets)
    (4096, 16, 9, 8, (1, 2, 4, 16)),     # superlevel blocks on the JAX side
    (777, 5, 9, 3, (1, 2, 4, None)),     # ragged leaf termination
    (1000, 8, 6, 16, (1, 3, 8, None)),   # None = n_leaves (exact)
]


@pytest.mark.parametrize("n,dim,depth,min_leaf,budgets", CASES)
def test_traverse_bit_equal(n, dim, depth, min_leaf, budgets):
    plan, ja, ta, rng = _forest(n, dim, depth, min_leaf, 2, seed=n)
    q = _dyadic(rng, (48, dim))
    q[:8] = 0.0  # the zero query lands on many cuts
    nl = plan.n_levels
    for budget in budgets:
        budget = plan.n_leaves if budget is None else budget
        for t in range(2):
            projq = (q @ np.asarray(ja.r)[t, :nl].T).astype(np.float32)
            li_j, pr_j = jax_traverse(plan, ja.thr[t], ja.mgl[t], ja.mgh[t],
                                      jnp.asarray(projq), budget)
            li_t, pr_t = torch_traverse(plan, ta.thr[t], ta.mgl[t],
                                        ta.mgh[t], torch.as_tensor(projq),
                                        budget)
            np.testing.assert_array_equal(li_t.numpy(), np.asarray(li_j))
            np.testing.assert_array_equal(pr_t.numpy().view(np.int32),
                                          np.asarray(pr_j).view(np.int32))
        # the all-trees form equals the per-tree form
        projq = np.einsum("bd,tld->tbl", q, np.asarray(ja.r)[:, :nl])
        li_all, pr_all = torch_traverse(plan, ta.thr, ta.mgl, ta.mgh,
                                        torch.as_tensor(projq), budget)
        for t in range(2):
            li_t, pr_t = torch_traverse(plan, ta.thr[t], ta.mgl[t],
                                        ta.mgh[t],
                                        torch.as_tensor(projq[t]), budget)
            assert torch.equal(li_all[t], li_t)
            assert torch.equal(pr_all[t], pr_t)


def test_bitonic_lexicographic():
    """Priority ties break on the encoding, so no entry is duplicated or
    lost."""
    pri = torch.tensor([[2.0, 1.0, 1.0, float("inf"), 1.0, 2.0, 1.0,
                         float("inf")]])
    enc = torch.tensor([[5, 9, 3, -(2 ** 31), -4, 1, 0, -(2 ** 31)]],
                       dtype=torch.int32)
    p, e = bitonic_sort_kv(pri, enc)
    inf = float("inf")
    assert p.tolist() == [[1.0, 1.0, 1.0, 1.0, 2.0, 2.0, inf, inf]]
    assert e.tolist() == [[-4, 0, 3, 9, 1, 5, -(2 ** 31), -(2 ** 31)]]
    with pytest.raises(ValueError):
        bitonic_sort_kv(pri[:, :6], enc[:, :6])


@pytest.mark.parametrize("m", [1, 2, 4, 16, 64])
def test_bitonic_bit_equal(m):
    """The same network as the JAX package's, on rows with many ties."""
    rng = np.random.default_rng(m)
    pri = rng.integers(0, 4, size=(m, 50)).astype(np.float32)
    pri[rng.uniform(size=pri.shape) < 0.2] = np.inf
    enc = rng.permutation(m * 50).reshape(m, 50).astype(np.int32) - 20
    pj, ej = jax_bitonic(jnp.asarray(pri), jnp.asarray(enc))
    pt, et = bitonic_sort_kv(torch.as_tensor(pri.T.copy()),
                             torch.as_tensor(enc.T.copy()))
    np.testing.assert_array_equal(pt.numpy().T, np.asarray(pj))
    np.testing.assert_array_equal(et.numpy().T, np.asarray(ej))


@pytest.mark.parametrize("bucket_stop", [False, True])
@pytest.mark.parametrize("block_len", [False, True])
def test_select_probes_bit_equal(bucket_stop, block_len):
    trees = 4
    plan, ja, ta, rng = _forest(4096, 16, 9, 8, trees, seed=3)
    q = _dyadic(rng, (64, 16))
    lens = np.tile(np.asarray(plan.leaf_len, np.int32), trees)
    for budget, probes in ((1, 4), (2, 6), (4, 16), (4, 40)):
        kw = dict(k=24, bucket_stop=bucket_stop)
        gj, lj = jax_select_probes(
            plan, ja, jnp.asarray(q), budget, probes,
            block_len=jnp.asarray(lens) if block_len else None, **kw)
        gt, lt = torch_select_probes(
            plan, ta, torch.as_tensor(q), budget, probes,
            block_len=torch.as_tensor(lens) if block_len else None, **kw)
        assert gt.dtype == lt.dtype == torch.int32
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def _np(a):
    return torch.as_tensor(np.array(a))


def _port_plain(plan, thr, mgl, mgh, projq, budget):
    """The port's plain frontier form (kernel 7's twin) on one tree's JAX
    arrays and ``projq [B, L]``: ``(leaf_ids [B, F], prio [B, F])``."""
    table = ttv.node_table(plan, _np(thr), _np(mgl), _np(mgh))
    pq = torch.as_tensor(np.ascontiguousarray(np.asarray(projq).T))[None]
    leaf, pri = ttv.traverse_tree_reference(plan, table, pq, budget)
    return leaf[0], pri[0]


def _assert_same(got, want):
    (lt, pt), (lj, pj) = got, want
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(pt.numpy().view(np.int32),
                                  np.asarray(pj).view(np.int32))


@pytest.mark.parametrize("budget", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", ["deep", "prebuilt", "tied_forks"])
def test_plain_form_matches_jax_fast_paths(case, budget):
    """The plain frontier form against JAX's superlevel fast paths called
    directly (``_traverse_b1`` at budget 1, ``_traverse_fk`` above): on a
    plan whose deep levels have more than 64 segments (superlevel
    blocks), with ``build_b1_tables`` prebuilt, and on projections that
    hit thresholds and margins exactly at every level (tied forks)."""
    plan, ja, _, rng = _forest(4096, 16, 9, 8, 2, seed=4096)
    assert jtv._b1_blocks(plan)
    thr, mgl, mgh = ja.thr[1], ja.mgl[1], ja.mgh[1]
    nl = plan.n_levels
    if case == "tied_forks":
        cols = np.stack([np.asarray(a) for a in (thr, mgl, mgh)])
        projq = np.stack([cols[rng.integers(0, 3, size=40), l,
                               rng.integers(0, lp.n_segs, size=40)]
                          for l, lp in enumerate(plan.levels)], axis=1)
    else:
        q = _dyadic(rng, (40, 16))
        q[:5] = 0.0
        projq = q @ np.asarray(ja.r)[1, :nl].T
    projq = jnp.asarray(projq.astype(np.float32))
    tabs = jtv.build_b1_tables(plan, thr, mgl, mgh) if case == "prebuilt" \
        else None
    if budget == 1:
        want = jtv._traverse_b1(plan, thr, mgl, mgh, projq, tabs)
    else:
        want = jtv._traverse_fk(plan, thr, mgl, mgh, projq, budget, tabs)
    _assert_same(_port_plain(plan, thr, mgl, mgh, projq, budget), want)


@pytest.mark.parametrize("trees", [1, 2])
def test_node_table_fields(trees):
    """The node table against JAX's arrays field by field: thresholds and
    margins bit for bit, the plan's child encodings, zero padding, and
    levels at the cumulative segment counts."""
    plan, ja, ta, _ = _forest(777, 5, 9, 3, 2, seed=777)
    arrs = [a[0] if trees == 1 else a for a in (ta.thr, ta.mgl, ta.mgh)]
    table = ttv.node_table(plan, *arrs)
    rec = table.rec.numpy()
    assert rec.shape == (trees, plan.n_branches, 8)
    assert table.level_off.tolist() == list(table.offsets)
    for l, lp in enumerate(plan.levels):
        rows = rec[:, table.offsets[l]:table.offsets[l] + lp.n_segs]
        for c, a in enumerate((ja.thr, ja.mgl, ja.mgh)):
            np.testing.assert_array_equal(
                rows[..., c], np.asarray(a)[:trees, l, :lp.n_segs]
                .view(np.int32))
        np.testing.assert_array_equal(
            rows[..., 3:5], np.broadcast_to(lp.child_enc, rows[..., 3:5].shape))
        assert not rows[..., 5:].any()


@pytest.mark.parametrize("bucket_stop", [False, True])
@pytest.mark.parametrize("block_len", [False, True])
def test_select_probes_reference_on_jax_traversal(bucket_stop, block_len):
    """Kernel 8's twin fed JAX's own traversal, against JAX's
    ``_select_probes``: ``block_len`` (here not the plan's sizes) or the
    plan's leaf sizes tiled over trees."""
    trees = 4
    plan, ja, _, rng = _forest(4096, 16, 9, 8, trees, seed=3)
    q = jnp.asarray(_dyadic(rng, (64, 16)))
    tiled = np.tile(np.asarray(plan.leaf_len, np.int32), trees)
    lens = tiled - rng.integers(0, 4, size=tiled.shape).astype(np.int32)
    for budget, probes in ((1, 4), (2, 9), (4, 40)):
        leaf, pri = jax_traverse_forest(plan, ja, q, budget)
        gj, lj = jax_select_probes(
            plan, ja, q, budget, probes, k=20, bucket_stop=bucket_stop,
            block_len=jnp.asarray(lens) if block_len else None)
        gt, lt = ttv.select_probes_reference(
            _np(leaf), _np(pri), plan.n_leaves, probes,
            torch.as_tensor(lens if block_len else tiled), k=20,
            bucket_stop=bucket_stop)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("budget", [1, 3, 9])
def test_single_leaf_plan(budget):
    """No levels (the single-leaf forest): leaf 0 at VALID_PRIO_CAP in
    slot 0, as JAX's traversal and probe selection give it."""
    plan, ja, ta, rng = _forest(5, 3, 4, 8, 2, seed=5)
    assert plan.n_levels == 0 and plan.root_enc == -1
    q = _dyadic(rng, (6, 3))
    for t in range(2):
        want = jax_traverse(plan, ja.thr[t], ja.mgl[t], ja.mgh[t],
                            jnp.zeros((6, 0), jnp.float32), budget)
        _assert_same(torch_traverse(plan, ta.thr[t], ta.mgl[t], ta.mgh[t],
                                    torch.zeros(6, 0), budget), want)
    gj, lj = jax_select_probes(plan, ja, jnp.asarray(q), budget, 3, k=2,
                               bucket_stop=True)
    gt, lt = torch_select_probes(plan, ta, torch.as_tensor(q), budget, 3,
                                 k=2, bucket_stop=True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_kernels_get_contiguous_operands(monkeypatch):
    """Every query path hands kernels 7 and 8 contiguous operands (their
    wrappers check contiguity only on the card): unpacked ``knn``,
    ``candidates``, ``recall_with``, per pair, batched and grouped."""
    from rptree_tpu_torch import forest_batch
    from rptree_tpu_torch.models import forest as fm

    rng = np.random.default_rng(4)
    f = forest_batch(4, 7, 8, 3, 1.0, _dyadic(rng, (1500, 8)), device="cpu")
    q = torch.as_tensor(_dyadic(rng, (30, 8)))
    seen = []

    def checked(name, orig):
        def run(*args, **kw):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            ts += [a.rec for a in args if isinstance(a, ttv.NodeTable)]
            seen.append((name, all(t.is_contiguous() for t in ts)))
            return orig(*args, **kw)
        return run

    monkeypatch.setattr(fm, "traverse_kernel",
                        checked("traverse", fm.traverse_kernel))
    monkeypatch.setattr(fm, "select_probes",
                        checked("probes", fm.select_probes))
    f.knn(q, 5)
    f.candidates(q, budget=3)
    f.recall_with(q, 5)
    f.pack_leaves()
    f.knn(q, 5, budget=2)
    f.knn_batched(q, 5, budget=2, chunk=8)
    f.knn_grouped(q, 5, budget=1, probes=3, nt=90)
    names = [n for n, _ in seen]
    assert names.count("traverse") == 3 + 1 + 4 + 1
    assert names.count("probes") == 1 + 4 + 1
    assert all(ok for _, ok in seen)
