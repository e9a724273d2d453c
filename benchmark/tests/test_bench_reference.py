"""The plain reference against the port on the CPU at a tiny size: the
same trees and the same answers, and the bfloat16 control fails the
comparison."""

import pytest
import torch

import rptree_tpu_torch as rt
from benchmark import datagen, harness
from benchmark.reference import check, forest
from benchmark.tests.helpers import SEED, tiny


def _small_integer_inputs(n=3000, d=16, t=3, depth=7):
    """Rows and projections of small integers: every projection is exact
    in both, so the trees must agree bit for bit, ties included."""
    g = torch.Generator().manual_seed(4)
    x = torch.randint(-3, 4, (n, d), generator=g).float()
    r = torch.randint(-2, 3, (t, depth, d), generator=g).float()
    return x, r


def test_trees_equal_the_ports():
    x, r = _small_integer_inputs()
    f = rt.forest_batch(1, 7, 20, 3, 1.0, x, device="cpu", r=r)
    ref = forest.build_forest(x, r, 7, 20)
    plan = f.plan
    assert ref.plan.n_leaves == plan.n_leaves
    assert torch.equal(ref.plan.leaf_len, torch.as_tensor(plan.leaf_len,
                                                          dtype=torch.int64))
    for t in range(3):
        for lv, lp in enumerate(plan.levels):
            s = lp.n_segs
            assert torch.equal(ref.trees[t].thr[lv], f.arrays.thr[t, lv, :s])
            assert torch.equal(ref.trees[t].mgl[lv], f.arrays.mgl[t, lv, :s])
            assert torch.equal(ref.trees[t].mgh[lv], f.arrays.mgh[t, lv, :s])
        perm = f.arrays.perm[t].long()
        for s0, m in zip(plan.leaf_start, plan.leaf_len):
            a = perm[s0:s0 + m].sort().values
            b = ref.trees[t].perm[s0:s0 + m].sort().values
            assert torch.equal(a, b)


@pytest.mark.parametrize("budget,probes", [(1, 3), (2, 4)])
def test_probes_equal_the_ports(budget, probes):
    x, r = _small_integer_inputs()
    q = x[:200] + 0.25
    f = rt.forest_batch(1, 7, 20, 3, 1.0, x, device="cpu", r=r)
    f.pack_leaves()
    from rptree_tpu_torch.models.forest import _probe_pairs
    gsel, lsel = _probe_pairs(f, q, budget, probes, 10)
    ref = forest.build_forest(x, r, 7, 20)
    tree, leaf = forest.probes(ref, q, budget, probes)
    assert torch.equal(leaf, lsel.long())
    live = leaf >= 0
    assert torch.equal((tree * ref.plan.n_leaves + leaf)[live],
                       gsel.long()[live])


def test_answers_agree_with_the_port():
    x, r = _small_integer_inputs()
    q = x[:300] + 0.25
    f = rt.forest_batch(1, 7, 20, 3, 1.0, x, device="cpu", r=r)
    f.pack_leaves()
    d, ids = f.knn_grouped(q, 10, budget=2, probes=4, tile_m=8)
    ref = forest.build_forest(x, r, 7, 20)
    ref_d = forest.answers(ref, x, q, 10, 2, 4)
    c = check.compare(x, q, d, ids, ref_d)
    assert c["misses"] == 0 and c["dist_err"] < 1e-5
    # a wrong answer reads as a miss
    bad = ids.clone()
    bad[:, 0] = (bad[:, 0] + 1) % x.shape[0]
    assert check.compare(x, q, d, bad, ref_d)["miss_share"] > 0.5


def test_scan_topk_is_exact():
    g = datagen.generator(3, "cpu")
    x, q = datagen.mixture(g, 4000, 32, 9, 0.15, 64, 0.5)
    got = forest.scan_topk(x, q, 10, q_rows=17, x_rows=900)
    d = torch.cdist(q.double(), x.double())
    want = torch.topk(d, 10, largest=False).indices
    assert (got.sort(1).values == want.sort(1).values).float().mean() > 0.99


@pytest.mark.parametrize("name", ["sift1m.grouped.b131072",
                                  "bigann10m.perpair.b65536",
                                  "sift1m.perpair.b16384"])
def test_run_is_correct_and_its_control_is_not(name):
    cell = tiny(name)
    out = harness.run(name, SEED, 0.3, False, device="cpu", cell=cell)
    assert out["correct"], out["checks"]
    pack = {**cell.config["index"]["pack"], "dtype": "bfloat16"}
    ctl = harness.run(name, SEED, 0.3, False, device="cpu", cell=cell,
                      pack=pack)
    assert not ctl["correct"]
    assert ctl["checks"]["miss_share"]["value"] > 10 * max(
        out["checks"]["miss_share"]["value"], 1e-3)
