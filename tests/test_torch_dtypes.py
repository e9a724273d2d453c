"""Datasets of other types in the port against the JAX package:
``forest_batch(dtype=bf16 / f16)`` stores the rows and their squared norms
in that type, builds the trees of an f32 build over the rounded rows
(JAX's trees, bit for bit, where both see the same projections), returns
f32 distances on every path, packs JAX's block type, and carries across
checkpoints in JAX's layout; integer types are refused.

Tolerances.  Trees, ids tables and stored bits are compared exactly.  The
port sums a row's squared norm in f32 and rounds it once to the dataset's
type, as JAX's packed blocks do; JAX's forest-level norms are summed in the
type itself and may differ by one unit in the last place.  So the unpacked
and scan distances are held to ``ULP[dtype] * (max |x|^2 + |q|^2)`` on the
squared distance (one such unit of the largest norm), and the packed bf16
paths, whose norms are JAX's bits, to ``torch_parity.knn_agree``'s 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rptree_tpu as rt
import rptree_tpu_torch as rp
from rptree_tpu.utils import gen as jgen
from rptree_tpu_torch.utils import gen as tgen

from torch_parity import carry, clustered, knn_agree, one_torch_thread  # noqa: F401

K = 5
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
ULP = {"bf16": 2.0 ** -7, "f16": 2.0 ** -10}
FIELDS = ("perm", "thr", "mgl", "mgh")


@pytest.fixture
def same_r(monkeypatch):
    """Both packages' samplers give the same small-integer projections."""
    def make(seed, n_trees, depth, dim, pnz=1.0, dtype=None, *, device=None):
        rng = np.random.default_rng(seed)
        return rng.integers(-2, 3, size=(n_trees, depth, dim)).astype(
            np.float32)

    monkeypatch.setattr(jgen, "sample_projections",
                        lambda *a, **kw: jnp.asarray(make(*a, **kw)))
    monkeypatch.setattr(tgen, "sample_projections",
                        lambda *a, device=None, **kw: torch.as_tensor(
                            make(*a, **kw), device=device))


def _bits(a):
    """The raw bytes of a numpy, JAX or torch array (bf16 included)."""
    if torch.is_tensor(a):
        return a.contiguous().view(torch.int16 if a.element_size() == 2
                                   else torch.int32).numpy().tobytes()
    return np.asarray(a).tobytes()


@pytest.fixture(scope="module")
def float_twins():
    """Per type: a JAX forest of clustered float rows stored in that type,
    its carried twin, and queries."""
    x, q = clustered(43, 1500, 12, 20, 0.5, 24)
    cfg = rt.rp_tree_cfg(32, x.shape[0], x.shape[1])
    out = {}
    for name, (jdt, _) in DTYPES.items():
        fj = rt.forest_batch(5, cfg.max_depth, 32, 3, cfg.proj_nz_density, x,
                             dtype=jdt)
        out[name] = (fj, carry(fj))
    return x, q, out


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_build_equals_jax(same_r, name):
    """Small integers are exact in bf16 and f16 and in every projection:
    the trees, the stored rows and their norms are JAX's bits, and the
    trees are those of an f32 build over the same rows."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(2)
    x = rng.integers(-4, 5, size=(900, 6)).astype(np.float32)
    fj = rt.forest_batch(3, 6, 16, 3, 1.0, x, dtype=jdt)
    ft = rp.forest_batch(3, 6, 16, 3, 1.0, x, dtype=tdt, device="cpu")
    f32 = rp.forest_batch(3, 6, 16, 3, 1.0, x, device="cpu")
    assert ft.x.dtype == tdt and ft.sq_norms.dtype == tdt
    assert _bits(ft.x) == _bits(fj.x)
    assert _bits(ft.sq_norms) == _bits(fj.sq_norms)
    for k in FIELDS:
        assert _bits(getattr(ft.arrays, k)) == _bits(getattr(fj.arrays, k)), k
        assert torch.equal(getattr(ft.arrays, k), getattr(f32.arrays, k)), k


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_tree_batch_and_pack_at_build(same_r, name):
    jdt, tdt = DTYPES[name]
    x = np.random.default_rng(4).integers(-3, 4, size=(300, 5)).astype(
        np.float32)
    fj = rt.tree_batch(1, 5, 8, 1.0, x, dtype=jdt)
    ft = rp.tree_batch(1, 5, 8, 1.0, x, dtype=tdt, device="cpu")
    assert ft.x.dtype == tdt
    for k in FIELDS:
        assert _bits(getattr(ft.arrays, k)) == _bits(getattr(fj.arrays, k)), k
    fp = rp.forest_batch(1, 5, 8, 2, 1.0, x, dtype=tdt, pack=True,
                         device="cpu")
    assert fp._packed is not None


def _sq_close(name, got, want, x, q):
    """Squared distances within one unit in the last place of the largest
    norm (``ULP``), the same padding, f32 on both sides."""
    (dt, it), (dj, ij) = got, want
    dj = np.asarray(dj)
    assert dt.dtype == torch.float32 and dj.dtype == np.float32
    dt = dt.numpy()
    np.testing.assert_array_equal(np.isinf(dt), np.isinf(dj))
    fin = np.isfinite(dj)
    scale = (x * x).sum(1).max() + (q * q).sum(1)[:, None]
    err = np.abs(dt.astype(np.float64) ** 2 - dj.astype(np.float64) ** 2)
    assert (err[fin] <= ULP[name] * np.broadcast_to(scale, err.shape)[fin]
            ).all()
    same = np.mean([len(set(a) & set(b)) / len(a) for a, b in
                    zip(it.numpy().tolist(), np.asarray(ij).tolist())])
    assert same >= 0.9


@pytest.mark.parametrize("path", ["unpacked", "scan_highest", "scan_default"])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_distances_within_tolerance(float_twins, name, path):
    x, q, twins = float_twins
    fj, ft = twins[name]
    call = {"unpacked": lambda f: f.knn(q, K, budget=4),
            "scan_highest": lambda f: f.brute_force_knn(q, K),
            "scan_default": lambda f: f.brute_force_knn(
                q, K, precision="default")}[path]
    _sq_close(name, call(ft), call(fj), x, q)


@pytest.mark.parametrize("path", ["grouped", "grouped_kernel_tail",
                                  "per_pair"])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_packed_paths(float_twins, name, path):
    """``pack_leaves()`` keeps JAX's block type on a bf16 dataset (bf16
    blocks, JAX's shapes and id tables, its slot norms' bits) and serves
    within 1e-5 of JAX; an f16 dataset packs exact f32 blocks (the
    kernels read f32 or bf16), served within the f16 tolerance."""
    x, q, twins = float_twins
    fj, ft = twins[name]
    fj.pack_leaves()
    ft.pack_leaves()
    (xj, sqj, idj), (xt, sqt, idt) = fj._packed, ft._packed
    assert xt.shape == xj.shape and _bits(idt) == _bits(idj)
    assert xt.dtype == (torch.bfloat16 if name == "bf16" else torch.float32)
    np.testing.assert_array_equal(xt.float().numpy(),
                                  np.asarray(xj.astype(jnp.float32)))
    # the port's kernel tail against JAX's sort tail (JAX runs its kernel
    # tail on a TPU only): the same k best
    tail = "kernel" if path == "grouped_kernel_tail" else "sort"
    call = {"grouped": lambda f, sel: f.knn_grouped(q, K, budget=4,
                                                    selection=sel),
            "grouped_kernel_tail": lambda f, sel: f.knn_grouped(
                q, K, budget=4, selection=sel),
            "per_pair": lambda f, sel: f.knn(q, K, budget=4)}[path]
    got, want = call(ft, tail), call(fj, "sort")
    if name == "bf16":
        assert _bits(sqt.to(torch.bfloat16)) == _bits(sqj)
        knn_agree(got, want)
    else:
        _sq_close(name, got, want, x, q)


def test_explicit_bf16_pack_of_a_bf16_dataset(float_twins):
    _, q, twins = float_twins
    fj, ft = twins["bf16"]
    fj.pack_leaves(dtype=jnp.bfloat16)
    ft.pack_leaves(dtype=torch.bfloat16)
    assert tuple(ft._packed[0].shape) == fj._packed[0].shape
    knn_agree(ft.knn_grouped(q, K, budget=4), fj.knn_grouped(q, K, budget=4))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_forest_from_numpy_keeps_the_type(float_twins, name):
    """``carry`` hands over ``np.array(fj.x)`` (an ml_dtypes bf16 array,
    or float16): the port keeps its bits and type, no f32 copy."""
    _, _, twins = float_twins
    fj, ft = twins[name]
    assert ft.x.dtype == DTYPES[name][1]
    assert _bits(ft.x) == _bits(fj.x)


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int32,
                                   torch.int64])
def test_integer_dtype_raises(dtype):
    x = np.ones((50, 3), np.float32)
    with pytest.raises(ValueError, match="squared norms wrap"):
        rp.forest_batch(0, 3, 8, 2, 1.0, x, dtype=dtype, device="cpu")
    with pytest.raises(ValueError, match="squared norms wrap"):
        rp.tree_batch(0, 3, 8, 1.0, x, dtype=dtype, device="cpu")


def test_float64_dtype_raises():
    with pytest.raises(ValueError, match="bfloat16"):
        rp.forest_batch(0, 3, 8, 2, 1.0, np.ones((50, 3)),
                        dtype=torch.float64, device="cpu")


def test_jax_bf16_checkpoint_read_by_port(float_twins, tmp_path):
    """JAX writes a bf16 dataset as a ``|V2`` array of its bits; the
    port reads it back as bf16, bit for bit."""
    _, _, twins = float_twins
    fj, _ = twins["bf16"]
    path = str(tmp_path / "j.npz")
    rt.save_forest(path, fj)
    with np.load(path) as z:
        assert z["x"].dtype == np.dtype("V2")
    g = rp.load_forest(path, device="cpu")
    assert g.x.dtype == torch.bfloat16 and _bits(g.x) == _bits(fj.x)
    for k in FIELDS:
        assert _bits(getattr(g.arrays, k)) == _bits(getattr(fj.arrays, k)), k


def test_port_bf16_checkpoint_layout_and_jax_refusal(float_twins, tmp_path):
    """The port writes JAX's layout (the same ``|V2`` bytes) and reads it
    back bit for bit.  JAX's own ``load_forest`` cannot read the file (a
    known issue of the reference, ROADMAP.md queue 3): pinned here, so a
    fix in JAX shows up."""
    _, q, twins = float_twins
    fj, ft = twins["bf16"]
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    rp.save_forest(tp, ft)
    rt.save_forest(jp, fj)
    with np.load(tp) as zt, np.load(jp) as zj:
        assert zt["x"].dtype == zj["x"].dtype == np.dtype("V2")
        assert zt["x"].tobytes() == zj["x"].tobytes()
    g = rp.load_forest(tp, device="cpu")
    assert _bits(g.x) == _bits(ft.x) and _bits(g.sq_norms) == _bits(
        ft.sq_norms)
    assert torch.equal(g.brute_force_knn(q, K)[1], ft.brute_force_knn(q, K)[1])
    with pytest.raises(TypeError, match="V2"):
        rt.load_forest(tp)


def test_f16_checkpoint_round_trip(float_twins, tmp_path):
    _, _, twins = float_twins
    fj, ft = twins["f16"]
    path = str(tmp_path / "h.npz")
    rp.save_forest(path, ft)
    g = rp.load_forest(path, device="cpu")
    assert g.x.dtype == torch.float16 and _bits(g.x) == _bits(ft.x)
    assert rt.load_forest(path).x.dtype == jnp.float16


def test_add_and_rebuild_follow_jax(same_r):
    """Pending points stay f32 and merge exactly; a rebuild over a bf16
    dataset and f32 pending rows holds f32 rows, as JAX's promotes."""
    x = np.random.default_rng(6).integers(-4, 5, size=(600, 6)).astype(
        np.float32)
    fj = rt.forest_batch(3, 5, 16, 2, 1.0, x, dtype=jnp.bfloat16)
    ft = rp.forest_batch(3, 5, 16, 2, 1.0, x, dtype=torch.bfloat16,
                         device="cpu")
    new = x[:8] + 0.5
    fj.add(new)
    ft.add(new)
    knn_agree(ft.knn(new, K, budget=2), fj.knn(new, K, budget=2))
    fj.rebuild()
    ft.rebuild()
    assert ft.x.dtype == torch.float32 and fj.x.dtype == jnp.float32
    for k in FIELDS:
        assert _bits(getattr(ft.arrays, k)) == _bits(getattr(fj.arrays, k)), k


def test_sparse_bf16_dataset_equals_jax(same_r):
    """ELL rows of a bf16 dataset: values and norms in bf16 (small
    integers, exact), JAX's trees, and the exact scan's distances."""
    rng = np.random.default_rng(8)
    n, v, kz = 400, 60, 4
    cols = np.sort(rng.choice(v, size=(n, kz)), 1).astype(np.int32)
    vals = rng.integers(1, 4, size=(n, kz)).astype(np.float32)
    fj = rt.forest_batch(2, 5, 16, 2, 1.0, rt.EllMatrix(v, cols, vals),
                         dtype=jnp.bfloat16)
    ft = rp.forest_batch(2, 5, 16, 2, 1.0, rp.EllMatrix(v, cols, vals),
                         dtype=torch.bfloat16, device="cpu")
    assert ft.x.vals.dtype == torch.bfloat16
    assert _bits(ft.x.vals) == _bits(fj.x.vals)
    assert _bits(ft.sq_norms) == _bits(fj.sq_norms)
    for k in FIELDS:
        assert _bits(getattr(ft.arrays, k)) == _bits(getattr(fj.arrays, k)), k
    q = np.zeros((6, v), np.float32)
    for i in range(6):
        q[i, cols[i]] = vals[i]
    knn_agree(ft.brute_force_knn(q, K), fj.brute_force_knn(q, K))
