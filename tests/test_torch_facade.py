"""The port's public facade against the JAX package's: the exported names,
the function-first query API (``rp.knn(f, q, k)`` and the accessors)
against the forest's methods and the JAX package's calls, the
single-vector ops against JAX's on the same numpy inputs (bit-equal, and
``tests/test_vector_ops.py``'s hspec values), ``StreamingMedian`` against
numpy, and the parameters of the slice's entry points.

Floats of the vector ops are compared bit for bit (both packages run the
same numpy code); query results by ``torch_parity.knn_agree`` (1e-5)."""

import inspect

import numpy as np
import pytest
import torch

import rptree_tpu as rt
import rptree_tpu_torch as rp
from rptree_tpu_torch.ops import vector as rp_vector

from torch_parity import carry, clustered, jax_forest, one_torch_thread  # noqa: F401
from torch_parity import knn_agree

K = 5

# the JAX package's exports that this slice ports
SLICE_EXPORTS = (
    # function-first API
    "knn", "knn_h", "knn_pq", "knn_h_buckets", "candidates", "recall_with",
    "tree_size", "leaf_sizes", "tree_stats", "leaves", "levels", "points",
    # configuration, median
    "BenchConfig", "StreamingMedian",
    # vector ops
    "SVec", "add", "from_list_dv", "from_list_sv", "from_vector_sv", "inner",
    "inner_dd", "inner_sd", "inner_ss", "metric_dd_l2", "metric_l2",
    "metric_sd_l2", "metric_ss_l2", "normalize", "scale", "sub", "to_dense",
    # generators
    "circle2d", "circle2d2", "data_batch", "data_source", "dense", "mixture",
    "mixture2", "normal2", "normal_dense2", "normal_sparse2", "rand_seed",
    "sample_projections", "sample_wor", "sparse",
    # streaming, tuning, I/O
    "ForestBuilder", "tree", "forest", "tune", "tune_build",
    "deserialise_rp_forest", "load_forest", "load_forest_sharded",
    "save_forest", "save_forest_sharded", "serialise_rp_forest",
    # sparse datasets
    "EllMatrix", "ell_from_scipy_like", "ell_from_svecs", "ell_project",
    "ell_sq_norms", "ell_to_dense",
    # the earlier slices' surface
    "ForestConfig", "RPForest", "RPTreeConfig", "TreePlan", "forest_batch",
    "make_plan", "rp_tree_cfg", "rp_tree_cfg_clustered", "tree_batch",
    # profiling, rendering, ingest
    "profiling", "device_time", "draw", "ingest", "write_csv",
    "knn_write_csv", "write_dot", "to_dot", "tree_to_string",
    "leaf_label_of_points",
)


def test_exports_cover_the_slice():
    """The port exports every name the JAX package does, and one more:
    ``forest_from_numpy``, which carries a forest across."""
    assert set(SLICE_EXPORTS) <= set(rt.__all__)
    assert set(SLICE_EXPORTS) <= set(rp.__all__)
    assert set(rt.__all__) <= set(rp.__all__)
    assert set(rp.__all__) - set(rt.__all__) == {"forest_from_numpy"}
    assert rp.__version__ == rt.__version__


@pytest.fixture(scope="module")
def twins():
    x, q = clustered(43, 1500, 12, 20, 0.5, 24)
    fj = jax_forest(x, seed=5, n_trees=3, min_leaf=32)
    fu, fp = carry(fj), carry(fj)
    fp.pack_leaves()
    return x, q, fj, fu, fp


# (function, its arguments after the forest, compared with JAX's call);
# the query calls also take budget=BUDGET
BUDGET = 4
CALLS = {
    "knn": ((K,), True), "knn_h": ((K,), True), "knn_pq": ((K,), True),
    "knn_h_buckets": ((K,), False), "candidates": ((), False),
    "recall_with": ((K,), False), "tree_size": ((), True),
    "leaf_sizes": ((), True), "tree_stats": ((), True),
    "leaves": ((), True), "levels": ((), True), "points": ((), True),
}
QUERY_CALLS = ("knn", "knn_h", "knn_pq", "knn_h_buckets", "candidates",
               "recall_with")


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_function_first_equals_the_method(twins, name, packed):
    """``rp.name(f, ...)`` returns what ``f.name(...)`` does; the
    structural accessors and the unpacked knn also what JAX's call on the
    same forest returns."""
    _, q, fj, fu, fp = twins
    f = fp if packed else fu
    args, vs_jax = CALLS[name]
    kw = {}
    if name in QUERY_CALLS:
        args, kw = (q, *args), {"budget": BUDGET}
    got = getattr(rp, name)(f, *args, **kw)
    assert _same(got, getattr(f, name)(*args, **kw))
    if not vs_jax or packed:
        return
    want = getattr(rt, name)(fj, *args, **kw)
    if name in ("knn", "knn_h", "knn_pq"):
        knn_agree(got, want)
    elif name == "points":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif name == "leaf_sizes":
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        assert got == want


# -- single-vector ops ----------------------------------------------------

def _vectors(seed, dim=12):
    """A sparse and a dense vector pair from numpy, as ``(idx, val)`` and
    arrays."""
    rng = np.random.default_rng(seed)
    sv = []
    for _ in range(2):
        idx = np.sort(rng.choice(dim, size=4, replace=False))
        sv.append((idx, rng.normal(size=4)))
    return dim, sv, [rng.normal(size=dim) for _ in range(2)]


def _as(mod, dim, sv, dv, kinds):
    out, s, d = [], iter(sv), iter(dv)
    for kind in kinds:
        out.append(mod.SVec(dim, *next(s)) if kind == "s" else next(d))
    return out


def _bits(v):
    if isinstance(v, (rt.SVec, rp.SVec)):
        return (v.dim, v.idx.tobytes(), np.asarray(v.val).tobytes())
    return np.asarray(v, dtype=np.float64).tobytes()


BINARY = ("inner", "metric_l2", "add", "sub")
TYPED = {"inner_ss": "ss", "inner_sd": "sd", "inner_dd": "dd",
         "metric_ss_l2": "ss", "metric_sd_l2": "sd", "metric_dd_l2": "dd"}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(
    "name,kinds",
    [(n, k) for n in BINARY for k in ("ss", "sd", "ds", "dd")]
    + sorted(TYPED.items())
    + [(n, k) for n in ("scale", "norm2", "normalize", "to_dense")
       for k in ("s", "d")])
def test_vector_ops_bit_equal_to_jax(name, kinds, seed):
    dim, sv, dv = _vectors(seed)
    got_args = _as(rp, dim, sv, dv, kinds)
    want_args = _as(rt.ops.vector, dim, sv, dv, kinds)
    if name == "scale":
        got_args, want_args = [1.5, *got_args], [1.5, *want_args]
    got = getattr(rp_vector, name)(*got_args)
    want = getattr(rt.ops.vector, name)(*want_args)
    assert type(got).__name__ == type(want).__name__
    assert _bits(got) == _bits(want)


def test_vector_constructors_equal_jax():
    pairs = [(1, 3.4), (4, 2.1)]
    assert _bits(rp.from_list_sv(5, pairs)) == _bits(rt.from_list_sv(5, pairs))
    assert _bits(rp.from_list_sv(5, [])) == _bits(rt.from_list_sv(5, []))
    assert _bits(rp.from_vector_sv(5, [0, 3], [1.0, -2.0])) == _bits(
        rt.from_vector_sv(5, [0, 3], [1.0, -2.0]))
    assert _bits(rp.from_list_dv([1, 2, 3])) == _bits(rt.from_list_dv([1, 2, 3]))
    assert _bits(rp.normalize(rp.from_list_dv([0.0, 0.0]))) == _bits(
        rt.normalize(rt.from_list_dv([0.0, 0.0])))


# tests/test_vector_ops.py's cases (the reference's hspec values,
# RPTreeSpec.hs:21-45) on the port
VS0 = rp.from_list_sv(5, [(1, 3.4), (4, 2.1)])
VS1 = rp.from_list_sv(5, [(0, 6.7), (3, 5.5)])
V1 = rp.from_list_dv([1, 2, 3, 4, 5])


def _hspec_add():
    np.testing.assert_allclose(rp.add(VS0, V1), [1, 5.4, 3, 4, 7.1])


def _hspec_sub():
    np.testing.assert_allclose(rp.sub(VS0, V1), [-1, 1.4, -3, -4, -2.9])


def _hspec_inner_disjoint():
    assert rp.inner(VS0, VS1) == 0.0


def _hspec_inner_sd():
    assert rp.inner(VS0, V1) == pytest.approx(17.3)


def _hspec_inner_symmetry():
    assert rp.inner(V1, VS0) == pytest.approx(17.3)
    assert rp.inner_dd(V1, V1) == pytest.approx(55.0)


def _hspec_union():
    s = rp.add(VS0, VS1)
    assert isinstance(s, rp.SVec)
    np.testing.assert_allclose(rp.to_dense(s), [6.7, 3.4, 0, 5.5, 2.1])


def _hspec_metric_l2():
    expect = np.sqrt(np.sum((rp.to_dense(VS0) - rp.to_dense(V1)) ** 2))
    assert rp.metric_l2(VS0, V1) == pytest.approx(expect)
    assert rp.metric_l2(V1, V1) == 0.0 and rp.metric_l2(VS0, VS0) == 0.0
    assert rp.metric_l2(VS0, VS1) == pytest.approx(
        np.sqrt(np.sum((rp.to_dense(VS0) - rp.to_dense(VS1)) ** 2)))


def _hspec_scale_normalize():
    np.testing.assert_allclose(rp.scale(2.0, V1), [2, 4, 6, 8, 10])
    np.testing.assert_allclose(rp.scale(-1.0, VS0).val, [-3.4, -2.1])
    nv = rp.normalize(V1)
    assert rp_vector.norm2(nv) == pytest.approx(1.0)


def _hspec_invariants():
    with pytest.raises(ValueError):
        rp.SVec(5, np.array([3, 1]), np.array([1.0, 2.0]))
    with pytest.raises(ValueError):
        rp.SVec(3, np.array([0, 5]), np.array([1.0, 2.0]))


@pytest.mark.parametrize("case", [
    _hspec_add, _hspec_sub, _hspec_inner_disjoint, _hspec_inner_sd,
    _hspec_inner_symmetry, _hspec_union, _hspec_metric_l2,
    _hspec_scale_normalize, _hspec_invariants], ids=lambda c: c.__name__[7:])
def test_vector_ops_hspec_values(case):
    case()


# -- StreamingMedian ------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 501, 1000])
def test_streaming_median_matches_numpy(n):
    xs = np.random.default_rng(n).normal(size=n)
    m = rp.StreamingMedian()
    for v in xs:
        m.insert(float(v))
    assert len(m) == n
    assert m.median() == float(np.median(xs))
    assert m.median() == rt.StreamingMedian(xs.tolist()).median()


def test_streaming_median_empty_raises():
    with pytest.raises(ValueError):
        rp.StreamingMedian().median()


def test_bench_config_fields_match_jax():
    import dataclasses

    assert ([(f.name, f.default) for f in dataclasses.fields(rp.BenchConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(rt.BenchConfig)])


# -- parameters -------------------------------------------------------------

# name: the port's own parameters after JAX's (keyword-only but payloads)
EXTRA = {
    "ForestBuilder": ["device"], "tree": ["device"],
    "forest": ["device"], "tune": [], "tune_build": ["device"],
    "save_forest": [], "serialise_rp_forest": [],
    "deserialise_rp_forest": ["payloads", "device"],
    "save_forest_sharded": [], "load_forest_sharded": ["payloads"],
    "data_batch": ["device"], "data_source": ["device"], "dense": [],
    "sparse": [], "mixture": [], "mixture2": [], "normal2": [],
    "normal_dense2": [], "normal_sparse2": [], "circle2d": [],
    "circle2d2": [], "sample_wor": [], "rand_seed": [],
    "sample_projections": ["device"],
}


@pytest.mark.parametrize("name", sorted(EXTRA))
def test_parameters_match_jax(name):
    """JAX's parameters in JAX's order and with its defaults; the port's
    own follow (``payloads`` of the deserialiser positional, the rest
    keyword-only)."""
    import jax.numpy as jnp

    pj = list(inspect.signature(getattr(rt, name)).parameters.values())
    pt = list(inspect.signature(getattr(rp, name)).parameters.values())
    assert [p.name for p in pt[:len(pj)]] == [p.name for p in pj]
    for a, b in zip(pt, pj):
        assert a.kind is b.kind, a.name
        assert a.default == b.default or (
            a.default is torch.float32 and b.default is jnp.float32), a.name
    extra = pt[len(pj):]
    assert [p.name for p in extra] == EXTRA[name]
    assert all(p.kind is p.KEYWORD_ONLY for p in extra
               if p.name != "payloads")


def test_parallel_exports_equal_jax():
    """``rptree_tpu_torch.parallel`` exports the JAX package's
    ``rptree_tpu.parallel`` names, the data-parallel ones among them."""
    import rptree_tpu.parallel as jpar
    import rptree_tpu_torch.parallel as tpar

    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    assert tpar.DATA_AXIS == jpar.DATA_AXIS == "data"


# the parallel entry points: the port's own parameters after JAX's
PARALLEL_EXTRA = {
    "data_mesh": [], "forest_batch_data_parallel": ["r"],
    "brute_force_knn_sharded": [], "forest_batch_distributed": ["r"],
    "forest_mesh": [],
}
# methods of the data-parallel forest: the port's own parameters after
# JAX's (a method the port inherits may add its own)
DP_METHODS = {
    "knn": [], "knn_batched": [], "knn_grouped": [], "knn_h": [],
    "brute_force_knn": [], "recall_with": [], "pack_leaves": ["r_sub"],
    "rebuild": [],
}


@pytest.mark.parametrize("name", sorted(PARALLEL_EXTRA) + [
    f"DataParallelForest.{m}" for m in sorted(DP_METHODS)])
def test_parallel_parameters_match_jax(name):
    """The parallel entry points and the data-parallel forest's methods
    take JAX's parameters in JAX's order and with its defaults; the port's
    own follow, keyword-only.  ``DistributedForest.knn_grouped`` has
    JAX's signature exactly (no ``all_probes``)."""
    import rptree_tpu.parallel as jpar
    import rptree_tpu_torch.parallel as tpar

    if "." in name:
        cls, meth = name.split(".")
        pj = inspect.signature(getattr(getattr(jpar, cls), meth))
        pt = inspect.signature(getattr(getattr(tpar, cls), meth))
        extra_names = DP_METHODS[meth]
    else:
        pj = inspect.signature(getattr(jpar, name))
        pt = inspect.signature(getattr(tpar, name))
        extra_names = PARALLEL_EXTRA[name]
    import jax.numpy as jnp

    pj, pt = list(pj.parameters.values()), list(pt.parameters.values())
    assert [p.name for p in pt[:len(pj)]] == [p.name for p in pj]
    for a, b in zip(pt, pj):
        assert a.kind is b.kind, a.name
        assert a.default == b.default or (
            a.default is torch.float32 and b.default is jnp.float32), a.name
    extra = pt[len(pj):]
    assert [p.name for p in extra] == extra_names
    assert all(p.kind is p.KEYWORD_ONLY for p in extra)
    sj = inspect.signature(jpar.DistributedForest.knn_grouped)
    st = inspect.signature(tpar.DistributedForest.knn_grouped)
    assert list(st.parameters) == list(sj.parameters)


def test_no_module_of_the_port_imports_jax():
    """No module of the port, no port example and not ``chip_smoke.py``
    imports ``jax`` or the JAX package (read from their sources)."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    files = [*sorted((root / "rptree_tpu_torch").rglob("*.py")),
             *sorted((root / "examples").glob("torch_*.py")),
             root / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [f"{path.relative_to(root)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "rptree_tpu")]
    assert len(files) > 40 and not bad, bad
