"""The spans and counters of ``rptree_tpu_torch/utils/profiling.py``:
``stats()`` under a CPU profiler names each serving entry, its layers and
``rpt_project`` with self times that add up to the entry's total, starts
each profiled stretch from zero and leaves the results' bits alone; with
no profiler a count site counts nothing; the grouped counters agree with
the JAX package's tiles needed and probes on the same trees."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_parity import carry, clustered, jax_forest

import rptree_tpu_torch as rp
from rptree_tpu.models.forest import _select_probes as jax_select_probes
from rptree_tpu_torch.utils import profiling

K = 5
BUDGET = 2
LAYERS = {
    "knn_batched": ("rpt_project", "rpt_candidates", "rpt_rerank",
                    "rpt_topk_tail"),
    "knn_grouped": ("rpt_project", "rpt_candidates", "rpt_tile_tables",
                    "rpt_grouped_score", "rpt_pair_reorder",
                    "rpt_topk_tail"),
}
# the spans directly inside each entry (``rpt_topk_tail`` nests in
# ``rpt_rerank`` on the per-pair path)
CHILDREN = {
    "knn_batched": ("rpt_project", "rpt_candidates", "rpt_rerank"),
    "knn_grouped": LAYERS["knn_grouped"],
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def packed():
    g = torch.Generator().manual_seed(11)
    c = torch.randn(12, 16, generator=g)
    x = c[torch.randint(0, 12, (2400,), generator=g)] + 0.3 * torch.randn(
        2400, 16, generator=g)
    q = x[:160] + 0.15 * torch.randn(160, 16, generator=g)
    f = rp.forest_batch(5, 6, 32, 3, 1.0, x, device="cpu")
    f.pack_leaves(slack=8)
    return f, q


def _serve(f, q, entry):
    if entry == "knn_batched":
        return f.knn_batched(q, K, budget=BUDGET, chunk=64)
    return f.knn_grouped(q, K, budget=BUDGET, chunk=64, check=False)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


@pytest.mark.parametrize("entry", ["knn_batched", "knn_grouped"])
def test_stats_name_the_entry_and_its_layers(packed, entry):
    """Each call counts its entry once, every layer's span and
    ``rpt_project`` appear, no self time is negative, the entry's total
    holds its children's, and the self times add up to the entry's total;
    the traced results are the untraced ones' bits."""
    f, q = packed
    want = _serve(f, q, entry)
    got = _profiled(lambda: [_serve(f, q, entry) for _ in range(2)])
    s = profiling.stats()
    name = f"rpt_{entry}"
    assert name in profiling.ENTRIES
    assert s[name]["calls"] == 2
    spans = {n: v for n, v in s.items() if isinstance(v, dict)}
    assert set(spans) == {name, *LAYERS[entry]}
    assert all(v["self_ns"] >= 0 and v["total_ns"] >= v["self_ns"]
               for v in spans.values())
    assert s[name]["total_ns"] >= sum(s[c]["total_ns"]
                                      for c in CHILDREN[entry])
    assert sum(v["self_ns"] for v in spans.values()) == s[name]["total_ns"]
    for d, ids in got:
        assert torch.equal(d, want[0]) and torch.equal(ids, want[1])


@pytest.mark.parametrize("between", ["an_unprofiled_call", "trace"])
def test_a_second_stretch_starts_from_zero(packed, tmp_path, between):
    """The first span under a profiler after one without it starts the
    numbers anew, and so does ``trace()`` with none between."""
    f, q = packed
    # unprofiled, and learns the capacity that the unchecked calls reuse
    f.knn_grouped(q, K, budget=BUDGET, chunk=64)
    _profiled(lambda: [_serve(f, q, "knn_grouped") for _ in range(3)])
    first = profiling.stats()
    assert first["rpt_knn_grouped"]["calls"] == 3
    if between == "an_unprofiled_call":
        _serve(f, q, "knn_grouped")
        _profiled(lambda: _serve(f, q, "knn_grouped"))
    else:
        with rp.profiling.trace(str(tmp_path)):
            _serve(f, q, "knn_grouped")
    s = profiling.stats()
    assert s["rpt_knn_grouped"]["calls"] == 1
    assert s["grouped.pairs"] * 3 == first["grouped.pairs"]


def test_no_profiler_no_range_and_no_count(packed, monkeypatch):
    """With no profiler running, ``region()`` and ``entry()`` are the
    shared no-op, no ``record_function`` is entered, and no count site
    reaches the stretch's numbers."""
    f, q = packed

    class Refuse:
        def __getattr__(self, name):
            raise AssertionError("counted with no profiler running")

    def refuse(*a, **k):
        raise AssertionError("entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_stretch", Refuse())
    assert profiling.region("rpt_knn_grouped") is profiling.region("x")
    assert profiling.entry("rpt_knn_grouped") is profiling.region("x")
    assert profiling.grouped_counts(torch.device("cpu"), 8) is None
    for entry in LAYERS:
        _serve(f, q, entry)
    f.knn_grouped(q, K, budget=BUDGET, impl="xla")


@pytest.fixture(scope="module")
def twins():
    """A JAX forest and the port's twin carried from it (the same
    projections and trees), both packed, and queries."""
    x, q = clustered(11, 2400, 16, 12, 0.3, 160)
    fj = jax_forest(x, n_trees=3, min_leaf=32)
    ft = carry(fj)
    fj.pack_leaves()
    ft.pack_leaves()
    return fj, ft, q


@pytest.mark.parametrize("impl", ["kernel", "kernel_topk", "xla"])
@pytest.mark.parametrize("how", ["learned_cut", "explicit_nt"])
def test_grouped_counters_on_a_small_capacity(twins, impl, how):
    """On a capacity too small for the chunk, ``grouped.tiles_overflow``
    is the calls times the JAX package's tiles needed past the capacity
    (its ``grouped_overflow()``), ``grouped.pairs`` the calls times its
    valid probes, and the slots launched the capacity's; the same through
    every grouped form."""
    fj, ft, q = twins
    qt = torch.from_numpy(q)
    probes = ft.n_trees * BUDGET
    kw = dict(budget=BUDGET, tile_m=4)
    fj.knn_grouped(jnp.asarray(q), K, **kw)
    need = fj.grouped_overflow()["needed"]
    _, lsel = jax_select_probes(fj.plan, fj.arrays, jnp.asarray(q), BUDGET,
                                probes)
    cap = max(1, need // 3)
    kw["impl"] = impl
    # unprofiled: learns the capacity, and ends the stretch before
    ft.knn_grouped(qt, K, **kw)
    if how == "learned_cut":
        ft._grouped_nt[(q.shape[0], probes, 4, q.shape[0])] = cap
        kw["check"] = False
    else:
        kw["nt"] = cap
    _profiled(lambda: [ft.knn_grouped(qt, K, **kw) for _ in range(2)])
    s = profiling.stats()
    assert need > cap
    assert ft.grouped_overflow() == {"needed": need, "capacity": cap,
                                     "overflow": True}
    assert s["grouped.tiles_overflow"] == 2 * (need - cap)
    assert s["grouped.pairs"] == 2 * int((np.asarray(lsel) >= 0).sum())
    assert s["grouped.slots_launched"] == 2 * cap * 4
