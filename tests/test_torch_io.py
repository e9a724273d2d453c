"""Checkpoints between the port and the JAX package: ``save_forest`` /
``load_forest`` and the per-tree blobs of ``serialise_rp_forest`` /
``deserialise_rp_forest`` written by either package and read by either,
dense and ELL, with every array bit-equal; the payloads the port writes
read back by the JAX package (the port itself never unpickles); the
errors of malformed blobs; the ``_check_clean`` refusal; and the sharded
checkpoints of the data-parallel forests, written by either package and
read by either."""

import dataclasses
import io
import json
import pickle
import struct
import zipfile

import numpy as np
import pytest
import torch

import rptree_tpu as rt
from rptree_tpu.ops import sparse as js
from rptree_tpu.utils import io as jio
import rptree_tpu_torch as rp
import rptree_tpu_torch.parallel  # noqa: F401  (rp.parallel)
from rptree_tpu_torch.utils import io as tio

from torch_parity import carry, clustered, one_torch_thread  # noqa: F401

ARRAYS = ("r", "perm", "thr", "mgl", "mgh")


def _ell(seed, n, dim, nnz):
    rng = np.random.default_rng(seed)
    cols = np.sort(rng.integers(0, dim, size=(n, nnz)), axis=1).astype(np.int32)
    vals = (np.abs(rng.normal(size=(n, nnz))) + 0.1).astype(np.float32)
    return cols, vals


@pytest.fixture(scope="module")
def forests():
    """JAX forests, dense and ELL, with payloads, and their port twins
    carried over with the same payloads."""
    x, _ = clustered(44, 500, 8, 12, 0.5, 1)
    cols, vals = _ell(45, 400, 64, 6)
    out = {}
    for kind, data, n in (("dense", x, 500),
                          ("ell", js.EllMatrix(64, cols, vals), 400)):
        pays = [f"{kind}-{i}" for i in range(n)]
        fj = rt.forest_batch(3, 4, 16, 3, 1.0, data, payloads=pays)
        out[kind] = (fj, carry(fj))
    return out


def _dataset(f):
    x = f.x
    if hasattr(x, "cols"):
        return [np.asarray(x.cols), np.asarray(x.vals)]
    return [np.asarray(x)]


def _host(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def assert_same_forest(a, b, order=None):
    """Every array of ``b`` bit-equal to ``a``'s (tree ``t`` of ``b`` is
    tree ``order[t]`` of ``a``), the same dataset, plan and config."""
    order = list(range(a.n_trees)) if order is None else list(order)
    assert b.n_trees == len(order)
    for k in ARRAYS:
        want = _host(getattr(a.arrays, k))[order]
        got = _host(getattr(b.arrays, k))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k
    for u, v in zip(_dataset(a), _dataset(b)):
        u, v = _host(u), _host(v)
        assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
    assert (b.plan.n, b.plan.n_levels, b.dim) == (a.plan.n, a.plan.n_levels,
                                                   a.dim)
    assert b.config.n_trees == len(order)
    assert b.seed == a.seed


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_header_is_jax_header(forests, kind):
    fj, ft = forests[kind]
    assert tio._header(ft) == jio._header(fj)


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_port_checkpoint_loads_in_jax(forests, kind, tmp_path):
    """The JAX package reads the port's file with bit-equal arrays, and
    its pickled payloads."""
    fj, ft = forests[kind]
    path = str(tmp_path / "port.npz")
    rp.save_forest(path, ft)
    g = rt.load_forest(path)
    assert_same_forest(ft, g)
    assert g.payloads == ft.payloads == fj.payloads
    assert dataclasses.asdict(g.config) == dataclasses.asdict(ft.config)
    with np.load(path, allow_pickle=False) as z:
        assert "grouped_nt" not in json.loads(z["header"].tobytes())
        assert pickle.loads(z["payloads"].tobytes()) == ft.payloads


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_checkpoint_loads_in_port(forests, kind, writer, tmp_path):
    """The port reads the JAX package's file and its own with bit-equal
    arrays; payloads come from the caller."""
    fj, ft = forests[kind]
    path = str(tmp_path / "f.npz")
    (rt if writer == "jax" else rp).save_forest(path, fj if writer == "jax"
                                                else ft)
    g = rp.load_forest(path, device="cpu")
    assert_same_forest(fj, g)
    assert g.payloads is None and g.config == ft.config
    g = rp.load_forest(path, device="cpu", payloads=fj.payloads)
    assert g.payload_of([0, 5]) == fj.payload_of([0, 5])
    q = _host(g.points())[:6] + 0.01
    assert torch.equal(g.knn(q, 4)[1], ft.knn(q, 4)[1])


ORDERS = {"forward": [0, 1, 2], "reversed": [2, 1, 0], "shuffled": [1, 2, 0]}


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("route", ["port>jax", "jax>port", "port>port"])
@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_blobs_roundtrip_any_order(forests, kind, route, order):
    """Per-tree blobs restore in any order, trees re-keyed ``0..T-1``:
    tree ``t`` of the result is the ``t``-th blob's tree."""
    fj, ft = forests[kind]
    writer, reader = route.split(">")
    blobs = (rp.serialise_rp_forest(ft) if writer == "port"
             else rt.serialise_rp_forest(fj))
    assert len(blobs) == 3
    chosen = [blobs[t] for t in ORDERS[order]]
    if reader == "jax":
        g = rt.deserialise_rp_forest(chosen)
        assert g.payloads == fj.payloads
    else:
        g = rp.deserialise_rp_forest(chosen, device="cpu")
        assert g.payloads is None
    assert_same_forest(fj, g, ORDERS[order])


def test_deserialise_takes_payloads_from_the_caller(forests):
    fj, ft = forests["dense"]
    blobs = rp.serialise_rp_forest(ft)
    g = rp.deserialise_rp_forest(blobs[1:], fj.payloads, device="cpu")
    assert g.n_trees == 2 and g.payload_of([3]) == ["dense-3"]
    with pytest.raises(ValueError, match="payloads"):
        rp.deserialise_rp_forest(blobs, fj.payloads[:4], device="cpu")


def _npz(**arrs):
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    return buf.getvalue()


def _flipped(blob, member="x.npy"):
    """``blob`` of the same length with the first byte of ``member``'s
    deflate stream set to 0xFF: a reserved block type, so inflating it
    raises ``zlib.error``."""
    b = bytearray(blob)
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        off = z.getinfo(member).header_offset
    name_len, extra_len = struct.unpack("<HH", b[off + 26:off + 30])
    b[off + 30 + name_len + extra_len] = 0xFF
    return bytes(b)


@pytest.mark.parametrize("case", ["garbage", "empty_list", "truncated",
                                  "no_header", "bad_header", "mixed_n",
                                  "mixed_kind", "flipped_byte"])
def test_deserialise_errors(forests, case):
    """Malformed or inconsistent blobs raise ``ValueError`` (the
    reference's ``Either String``)."""
    dense = rp.serialise_rp_forest(forests["dense"][1])
    blobs = {
        "garbage": [b"not a checkpoint"],
        "empty_list": [],
        "truncated": [dense[0][:len(dense[0]) // 2]],
        "no_header": [_npz(r=np.zeros((1, 2, 3), np.float32))],
        "bad_header": [_npz(header=np.frombuffer(b"{not json", np.uint8))],
        "mixed_n": [dense[0], rp.serialise_rp_forest(rp.forest_batch(
            3, 4, 16, 2, 1.0, np.ones((300, 8), np.float32),
            device="cpu"))[0]],
        "mixed_kind": [dense[0],
                       rp.serialise_rp_forest(forests["ell"][1])[0]],
        "flipped_byte": [_flipped(dense[0])],
    }[case]
    with pytest.raises(ValueError):
        rp.deserialise_rp_forest(blobs, device="cpu")
    if case == "flipped_byte":   # a corrupt member: JAX's error, too
        with pytest.raises(ValueError):
            jio.deserialise_rp_forest(blobs)


@pytest.mark.parametrize("update", ["add", "remove", "fold", "drop_dataset"])
def test_check_clean_refuses(update, tmp_path):
    """A forest with pending, folded or removed points must ``rebuild()``
    before it is saved or serialised; a serve-only one cannot be."""
    x, _ = clustered(46, 400, 8, 10, 0.5, 1)
    f = rp.forest_batch(2, 4, 16, 2, 1.0, x, device="cpu").pack_leaves(
        slack=8)
    if update == "remove":
        f.remove([3, 7])
    elif update == "drop_dataset":
        f.drop_dataset()
    else:
        f.add(x[:5] + 0.01)
        if update == "fold":
            f.fold()
            assert f.n_folded and not f.n_pending
    path = str(tmp_path / "f.npz")
    for save in (lambda: rp.save_forest(path, f),
                 lambda: rp.serialise_rp_forest(f)):
        with pytest.raises(ValueError, match="rebuild|dataset dropped"):
            save()
    if update != "drop_dataset":
        f.rebuild()
        rp.save_forest(path, f)
        assert rp.load_forest(path, device="cpu").n_points == f.n_points


def _dp_mesh(s):
    return rp.parallel.data_mesh(s, devices=["cpu"] * s)


def test_sharded_checkpoints_name_their_item(tmp_path):
    """The port's sharded checkpoint round trip: ``common.npz`` and one
    ``shard_<i>.npz`` a data shard (each a shard's rows), loaded onto a
    mesh of another shard count with every array and row bit-equal and
    the same served bits; a single-device forest and a forest with
    pending points are refused, as in the JAX package."""
    from rptree_tpu_torch.parallel import forest_batch_data_parallel

    x, q = clustered(46, 800, 8, 12, 0.5, 16)
    pays = [f"p{i}" for i in range(800)]
    f = forest_batch_data_parallel(3, 4, 16, 3, 1.0, x, mesh=_dp_mesh(8),
                                   payloads=pays)
    rp.save_forest_sharded(str(tmp_path), f)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["common.npz"] + [f"shard_{i}.npz" for i in range(8)]
    with np.load(tmp_path / "shard_3.npz") as z:
        np.testing.assert_array_equal(z["x"], x[300:400])
        assert int(z["row_start"][0]) == 300
    g = rp.load_forest_sharded(str(tmp_path), _dp_mesh(2), payloads=pays)
    assert isinstance(g, rp.parallel.DataParallelForest)
    assert [p.shape[0] for p in g.x.parts] == [400, 400]
    for k in ARRAYS:  # bit for bit (unused segments hold NaN, as JAX's)
        assert (getattr(f.arrays, k).numpy().tobytes()
                == getattr(g.arrays, k).numpy().tobytes()), k
    assert torch.equal(torch.cat(g.x.parts), torch.as_tensor(x))
    assert g.payload_of([5]) == ["p5"] and g.seed == 3
    for h in (f, g):
        h.pack_leaves()
    d1, i1 = f.knn_grouped(q, 5, budget=2)
    d2, i2 = g.knn_grouped(q, 5, budget=2)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    with pytest.raises(ValueError, match="DataParallelForest"):
        rp.save_forest_sharded(str(tmp_path / "one"), rp.forest_batch(
            1, 3, 8, 1, 1.0, x, device="cpu"))
    f.add(x[:2])
    with pytest.raises(ValueError, match="rebuild"):
        rp.save_forest_sharded(str(tmp_path / "two"), f)
    with pytest.raises(ValueError, match="divide"):
        rp.load_forest_sharded(str(tmp_path), _dp_mesh(3))


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_checkpoints_across_packages(tmp_path, kind, writer):
    """A sharded checkpoint the JAX package writes loads in the port, and
    the port's in the JAX package (its payloads too), dense and ELL, onto
    a mesh of another shard count: every array and row bit-equal."""
    import rptree_tpu.parallel as jpar
    from rptree_tpu_torch.parallel import forest_batch_data_parallel

    n = 400
    pays = [f"{kind}-{i}" for i in range(n)]
    if kind == "dense":
        data_j = data_t = clustered(47, n, 8, 12, 0.5, 1)[0]
    else:
        cols, vals = _ell(48, n, 64, 6)
        data_j, data_t = js.EllMatrix(64, cols, vals), rp.EllMatrix(64, cols,
                                                                    vals)
    fj = jpar.forest_batch_data_parallel(3, 4, 16, 3, 1.0, data_j,
                                         mesh=jpar.data_mesh(8),
                                         payloads=pays)
    ft = forest_batch_data_parallel(3, 4, 16, 3, 1.0, data_t,
                                    mesh=_dp_mesh(8), payloads=pays,
                                    r=np.array(fj.arrays.r))
    path = str(tmp_path)
    if writer == "jax":
        jio.save_forest_sharded(path, fj)
        got = rp.load_forest_sharded(path, _dp_mesh(4), payloads=pays)
        want = ft
    else:
        rp.save_forest_sharded(path, ft)
        got = jio.load_forest_sharded(path, jpar.data_mesh(4))
        assert got.payloads == pays
        want = fj
    # the JAX forest's arrays are its own build's: compare the written
    # forest's against what was loaded
    src = fj if writer == "jax" else ft
    for k in ARRAYS:
        a, b = _host(getattr(src.arrays, k)), _host(getattr(got.arrays, k))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    rows = (lambda f: [np.concatenate([_host(p) for p in t.parts])
                       if hasattr(t, "parts") else np.asarray(t)
                       for t in ((f.x.cols, f.x.vals) if kind == "ell"
                                 else (f.x,))])
    for a, b in zip(rows(want), rows(got)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
