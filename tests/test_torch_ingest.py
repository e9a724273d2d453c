"""The port's ingest (``rptree_tpu_torch/utils/ingest.py`` and its own
build of ``csrc/ingest.cpp``) against the JAX package's: every reader on
the same files gives the same bytes, native and numpy fallback alike; the
writers take tensors; concurrent first loads never see a half-written
library; a streamed build from an fvecs file equals the batch build."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rptree_tpu_torch as rp
from rptree_tpu.utils import ingest as jax_ingest
from rptree_tpu_torch.utils import ingest

from torch_parity import one_torch_thread  # noqa: F401


def _write_bvecs(path, arr):
    with open(path, "wb") as fh:
        for row in arr:
            np.int32(arr.shape[1]).tofile(fh)
            row.astype(np.uint8).tofile(fh)


def _write_idx(path, arr):
    n, d = arr.shape
    with open(path, "wb") as fh:
        fh.write(bytes([0, 0, 0x08, 2]))
        fh.write(np.array([n, d], ">u4").tobytes())
        arr.astype(np.uint8).tofile(fh)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ingest")
    rng = np.random.default_rng(13)
    x = rng.normal(size=(37, 12)).astype(np.float32)
    ids = rng.integers(0, 1000, size=(9, 10)).astype(np.int32)
    raw = rng.integers(0, 256, size=(11, 16)).astype(np.uint8)
    p = {k: str(d / n) for k, n in (("fvecs", "a.fvecs"), ("ivecs", "g.ivecs"),
                                    ("bvecs", "b.bvecs"), ("idx", "d.idx"))}
    jax_ingest.write_fvecs(p["fvecs"], x)
    jax_ingest.write_ivecs(p["ivecs"], ids)
    _write_bvecs(p["bvecs"], raw)
    _write_idx(p["idx"], raw)
    return p, x, ids, raw


# (reader, file, arguments after the path)
READS = {
    "fvecs_all": ("read_fvecs", "fvecs", ()),
    "fvecs_range": ("read_fvecs", "fvecs", (5, 10)),
    "fvecs_tail": ("read_fvecs", "fvecs", (30, 100)),
    "ivecs": ("read_ivecs", "ivecs", ()),
    "ivecs_range": ("read_ivecs", "ivecs", (2, 3)),
    "bvecs": ("read_bvecs", "bvecs", ()),
    "bvecs_range": ("read_bvecs", "bvecs", (4, 5)),
    "idx": ("read_idx", "idx", ()),
    "idx_scaled": ("read_idx", "idx", (3, 4, 1 / 255.0)),
    "fvecs_meta": ("fvecs_meta", "fvecs", ()),
    "ivecs_meta": ("ivecs_meta", "ivecs", ()),
    "bvecs_meta": ("bvecs_meta", "bvecs", ()),
    "idx_meta": ("idx_meta", "idx", ()),
}


def test_native_builds():
    assert ingest.native_available(), "native ingest library failed to build"
    assert ingest.build_library().parent.name == "_build"


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", sorted(READS))
def test_reads_equal_jax(files, name, native, monkeypatch):
    """Each reader gives JAX's bytes, through the native library and
    through the numpy fallback (forced by marking the library absent)."""
    p, _, _, _ = files
    fn, kind, args = READS[name]
    if not native:
        monkeypatch.setattr(ingest, "_lib", None)
        monkeypatch.setattr(ingest, "_lib_tried", True)
    got = getattr(ingest, fn)(p[kind], *args)
    want = getattr(jax_ingest, fn)(p[kind], *args)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_round_trips(files, tmp_path):
    p, x, ids, raw = files
    np.testing.assert_array_equal(ingest.read_fvecs(p["fvecs"]), x)
    np.testing.assert_array_equal(ingest.read_ivecs(p["ivecs"]), ids)
    np.testing.assert_array_equal(ingest.read_bvecs(p["bvecs"]),
                                  raw.astype(np.float32))
    # the writers take tensors, a bf16 one as its f32 values
    t = torch.as_tensor(x).to(torch.bfloat16)
    ingest.write_fvecs(str(tmp_path / "t.fvecs"), t)
    np.testing.assert_array_equal(ingest.read_fvecs(str(tmp_path / "t.fvecs")),
                                  t.float().numpy())
    ingest.write_ivecs(str(tmp_path / "t.ivecs"), torch.as_tensor(ids).long())
    assert open(str(tmp_path / "t.ivecs"), "rb").read() == open(
        p["ivecs"], "rb").read()


@pytest.mark.parametrize("native", [True, False])
def test_format_error_equals_jax(tmp_path, native, monkeypatch):
    bad = str(tmp_path / "bad.fvecs")
    with open(bad, "wb") as fh:
        np.int32(4).tofile(fh)
        np.zeros(3, np.float32).tofile(fh)
    if not native:
        monkeypatch.setattr(ingest, "_lib", None)
        monkeypatch.setattr(ingest, "_lib_tried", True)
    with pytest.raises(ValueError) as got:
        ingest.read_fvecs(bad)
    with pytest.raises(ValueError) as want:
        jax_ingest.read_fvecs(bad)
    assert str(got.value) == str(want.value)


def test_sources_chunk_like_jax(files):
    p, _, _, _ = files
    for fn, kind, kw in (("fvecs_source", "fvecs", {}),
                         ("bvecs_source", "bvecs", {}),
                         ("idx_source", "idx", {"scale": 0.5})):
        got = list(getattr(ingest, fn)(p[kind], chunk_size=4, limit=10, **kw))
        want = list(getattr(jax_ingest, fn)(p[kind], chunk_size=4, limit=10,
                                            **kw))
        assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


def test_stream_from_fvecs_equals_batch_build(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1000, 8)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    ingest.write_fvecs(path, x)
    fs = rp.forest(5, 6, 16, 2, 300, 1.0, 8,
                   rp.ingest.fvecs_source(path, chunk_size=300),
                   device="cpu")
    fb = rp.forest_batch(5, 6, 16, 2, 1.0, x, device="cpu")
    for k in ("r", "perm", "thr", "mgl", "mgh"):
        assert torch.equal(getattr(fs.arrays, k), getattr(fb.arrays, k)), k


# a fresh process builds (or waits for) the library in a directory and
# loads it; the module is loaded from its file alone (it needs only
# numpy), which spares the child the package's torch import
_CHILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("ingest_child", sys.argv[1])
child = importlib.util.module_from_spec(spec)
spec.loader.exec_module(child)
path = child.build_library(sys.argv[2])
assert child._bind(path).fvecs_read is not None
print(path)
"""


def test_concurrent_first_loads(tmp_path):
    """Two processes start on an empty build directory at once: both load
    the same library, and no temporary file is left beside it."""
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, ingest.__file__,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["ingest.lock", os.path.basename(outs[0])])
