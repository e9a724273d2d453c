"""Host-side rules of kernels 7 and 8, on the CPU.

Kernel 7's route by frontier width (``ops/traverse.py`` ``traverse_route``)
and kernel 8's lanes by entries a query (``probe_route``) at the served
shapes and their boundaries; kernel 8's rank rule in plain torch
(``select_probes_by_rank``: an entry goes to the count of entries before
it in (key, tree, slot) order) held equal to the stable sort of the plain
twin (``select_probes_reference``) on adversarial keys.  Neither imports
JAX.
"""

import numpy as np
import pytest
import torch

from rptree_tpu_torch.ops import traverse as tv


@pytest.mark.parametrize("budget,want", [
    (1, ("registers", 1)),      # clustered chunk, unpacked budget 1
    (2, ("registers", 2)),      # iid chunk, the bracket
    (8, ("registers", 8)),
    (9, ("warp", 32)),
    (16, ("warp", 32)),
    (17, ("warp", 64)),
    (32, ("warp", 64)),         # unpacked knn at its default budget
    (33, ("shared", 128)),
    (64, ("shared", 128)),
    (65, ("shared", 256)),
    (8192, ("shared", 16384)),
    (8193, ("global", 32768)),
    (8500, ("global", 32768)),  # DESCENTS' global-scratch shape
])
def test_traverse_route(budget, want):
    """Registers up to F 8, one warp while next_pow2(2F) <= 64, shared
    memory to 16,384 entries, global scratch past them."""
    assert tv.traverse_route(budget) == want


@pytest.mark.parametrize("trees,budget,want", [
    (1, 1, ("lanes", 1)),
    (8, 1, ("lanes", 8)),       # clustered chunk
    (8, 2, ("lanes", 16)),      # iid chunk
    (31, 1, ("lanes", 32)),
    (16, 2, ("lanes", 32)),
    (33, 1, ("warp", 2)),
    (32, 2, ("warp", 2)),       # the bracket, T 32 x F 2
    (13, 5, ("warp", 4)),       # 65 entries
    (32, 32, ("warp", 32)),     # 1,024
    (1, 1025, ("merge", 0)),
    (8, 8500, ("merge", 0)),
])
def test_probe_route(trees, budget, want):
    """A group of next_pow2(T * F) lanes up to 32 entries, one warp with a
    power of two of entries a lane up to 1,024, the merge past them."""
    assert tv.probe_route(trees, budget) == want


def test_probe_routes_cover_every_entry():
    """Every route holds every entry: G >= n on the lanes route, 32 E >= n
    on the warp route, both powers of two."""
    for n in range(1, tv.PROBE_WARP_MAX + 1):
        route, width = tv.probe_route(1, n)
        assert width & (width - 1) == 0
        if route == "lanes":
            assert n <= width <= 32
        else:
            assert route == "warp" and 32 * width >= n > 32 and width <= 32


_POOL = np.array([0.0, -0.0, 0.25, 0.25, 1.0, 1.0, 3.0e38, np.inf, np.nan,
                  -np.nan, 0.5], np.float32)


def _adversarial(rng, t, b, f, nl, sort=False):
    """``leaf int32[T, B, F]`` (some -1) and ``prio f32[T, B, F]`` drawn
    from a pool of ties across and within trees, -0.0 and +0.0, NaN of both
    signs and +inf; with ``sort`` each (tree, query) list ascending, as
    kernel 7 returns it."""
    prio = rng.choice(_POOL, size=(t, b, f))
    leaf = rng.integers(-1, nl, size=(t, b, f)).astype(np.int32)
    if sort:
        order = np.argsort(np.where(leaf >= 0, prio, np.inf), axis=-1,
                           kind="stable")
        prio = np.take_along_axis(prio, order, -1)
        leaf = np.take_along_axis(leaf, order, -1)
    return torch.as_tensor(leaf), torch.as_tensor(prio)


def _same(leaf, prio, nl, probes, lens, k, stop):
    got = tv.select_probes_by_rank(leaf, prio, nl, probes, lens, k, stop)
    want = tv.select_probes_reference(leaf, prio, nl, probes, lens, k, stop)
    assert all(g.dtype == torch.int32 for g in got)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.parametrize("t,f", [(1, 1), (8, 1), (8, 2), (31, 1), (4, 8),
                                 (11, 3), (32, 2), (13, 5), (2, 40)])
@pytest.mark.parametrize("stop", [False, True])
@pytest.mark.parametrize("sort", [False, True])
def test_rank_rule_is_the_stable_sort(t, f, stop, sort):
    """The rank rule equals the plain twin's stable sort on ties, signed
    zeros, NaN, +inf and empty slots, for P below, at and past T * F, with
    and without the bucket stop."""
    rng = np.random.default_rng(t * 100 + f)
    nl, b = 7, 37
    leaf, prio = _adversarial(rng, t, b, f, nl, sort)
    lens = torch.as_tensor(rng.integers(0, 9, size=t * nl), dtype=torch.int32)
    for probes in (1, max(1, t * f // 2), t * f, t * f + 5):
        _same(leaf, prio, nl, probes, lens, 6, stop)


def test_rank_rule_signed_zero_and_nan_order():
    """-0.0 and +0.0 tie (slot order decides), NaN of either sign goes
    after +inf, and a NaN priority is kept (only infinite ones are
    masked)."""
    nan = float("nan")
    prio = torch.tensor([[[0.0, float("inf"), -nan]], [[-0.0, nan, 1.0]]])
    leaf = torch.tensor([[[0, 1, 2]], [[3, 4, 5]]], dtype=torch.int32)
    lens = torch.ones(2 * 6, dtype=torch.int32)
    g, s = _same(leaf, prio, 6, 6, lens, None, False)
    # (tree, slot): (0,0) +0, (1,0) -0, (1,2) 1.0, (0,1) inf (masked),
    # (0,2) NaN, (1,1) NaN
    assert s.tolist() == [[0, 3, 5, -1, 2, 4]]
    assert g.tolist() == [[0, 9, 11, 0, 2, 10]]


def test_rank_rule_empty_slots_and_full_p():
    """``leaf = -1`` slots sort as +inf whatever their priority and are
    masked; P = T * F keeps every entry in the stable order."""
    prio = torch.tensor([[[0.5, 0.1]], [[0.5, 0.2]]])
    leaf = torch.tensor([[[1, -1]], [[2, -1]]], dtype=torch.int32)
    lens = torch.ones(2 * 4, dtype=torch.int32)
    g, s = _same(leaf, prio, 4, 4, lens, None, False)
    assert s.tolist() == [[1, 2, -1, -1]] and g.tolist() == [[1, 6, 0, 0]]


def test_bucket_stop_at_the_first_entry():
    """A first bucket larger than k is kept alone: every later one
    masked."""
    t, f, nl = 4, 2, 3
    rng = np.random.default_rng(5)
    leaf = torch.as_tensor(rng.integers(0, nl, size=(t, 9, f)), dtype=torch.int32)
    prio = torch.as_tensor(np.sort(rng.random((t, 9, f)), -1).astype(np.float32))
    lens = torch.full((t * nl,), 50, dtype=torch.int32)
    g, s = _same(leaf, prio, nl, t * f, lens, 10, True)
    assert bool((s[:, 0] >= 0).all()) and bool((s[:, 1:] == -1).all())
    assert bool((g[:, 1:] == 0).all())


@pytest.mark.parametrize("t,f", [(20, 2), (3, 20)])
def test_bucket_stop_past_entry_32(t, f):
    """Buckets of one point each and k 37: the stop fires at entry 37, past
    the first 32 (the warp route's second pass of the running size)."""
    nl = 50
    rng = np.random.default_rng(t)
    leaf = torch.as_tensor(rng.integers(0, nl, size=(t, 5, f)), dtype=torch.int32)
    prio = torch.as_tensor(np.sort(rng.random((t, 5, f)), -1).astype(np.float32))
    lens = torch.ones(t * nl, dtype=torch.int32)
    g, s = _same(leaf, prio, nl, t * f, lens, 37, True)
    assert bool((s[:, :37] >= 0).all()) and bool((s[:, 37:] == -1).all())


def test_probe_keys_order_floats():
    """The keys' integer order is the stable sort's float order: -0.0 as
    +0.0, empty slots as +inf, NaN last."""
    vals = torch.tensor([[[-np.inf, -1.5, -0.0, 0.0, 1e-45, 2.0, np.inf,
                           np.nan, -np.nan, 7.0]]], dtype=torch.float32)
    leaf = torch.zeros(vals.shape, dtype=torch.int32)
    leaf[..., -1] = -1
    key = tv.probe_keys(leaf, vals)[0].tolist()
    assert key[0] < key[1] < key[2] == key[3] < key[4] < key[5] < key[6]
    assert key[6] == key[9] < key[7] == key[8] == 0xFFFFFFFF


@pytest.mark.parametrize("operand,error,match", [
    (torch.zeros(4, dtype=torch.int32, device="meta"), ValueError,
     "is on meta"),
    (torch.zeros(4, dtype=torch.int64), TypeError, "must be torch.int32"),
    (torch.zeros(4, 2, dtype=torch.int32).T, ValueError, "contiguous"),
])
def test_check_cuda_names_the_fault(operand, error, match):
    """The wrappers' operand check passes good operands and, on a bad one,
    says which operand and why: the device, the dtype, then contiguity."""
    cpu = torch.device("cpu")
    good = torch.zeros(4, dtype=torch.int32)
    tv._check_cuda("k", cpu, ("a", good, torch.int32))
    with pytest.raises(error, match=f"k: b .*{match}"):
        tv._check_cuda("k", cpu, ("a", good, torch.int32),
                       ("b", operand, torch.int32))


@pytest.mark.parametrize("entry,packer", [
    ("rpt_traverse", tv._TRAVERSE_ARGS),
    ("rpt_select_probes", tv._PROBES_ARGS),
])
def test_packed_arguments_match_the_entry_points(entry, packer):
    """Each wrapper packs as many int64 as its C entry point unpacks
    (``csrc/traverse.cu``), one per parameter of the launch function."""
    import re
    from pathlib import Path

    src = (Path(tv.__file__).resolve().parent.parent / "csrc"
           / "traverse.cu").read_text()
    body = src[src.index(f"int {entry}(const long long* packed)"):]
    count = int(re.search(r"long long a\[(\d+)\];", body).group(1))
    assert packer.size == 8 * count
    launch = re.search(r"return (\w+)\(", body).group(1)
    params = src[src.index(f"int {launch}("):]
    params = params[:params.index(")")]
    assert params.count(",") + 1 == count
