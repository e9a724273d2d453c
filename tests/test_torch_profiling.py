"""The port's profiling module (``rptree_tpu_torch/utils/profiling.py``)
against the JAX package's: the same nine scopes, a CPU trace whose ranges
name the query, build and fold stages, ``region()`` free of
``record_function`` while no profiler runs, ``device_time``'s contract and
JAX's refusal."""

import json
import os

import numpy as np
import pytest
import torch

import rptree_tpu as rt
import rptree_tpu_torch as rp
from rptree_tpu_torch.utils import profiling

from torch_parity import clustered, one_torch_thread  # noqa: F401

K = 5
# the JAX package's grouped scopes but its reorder, which kernel 1's pair
# form (f32 blocks) does in place
GROUPED = ("rpt_candidates", "rpt_tile_tables", "rpt_grouped_score",
           "rpt_topk_tail")


@pytest.fixture(scope="module")
def packed():
    x, q = clustered(7, 1200, 10, 16, 0.5, 16)
    f = rp.forest_batch(3, 5, 32, 3, 1.0, x, device="cpu")
    f.pack_leaves(slack=8)
    return f, x, torch.as_tensor(q)


def _ranges(logdir):
    """The range names of the one Chrome trace in ``logdir``."""
    files = [n for n in os.listdir(logdir) if n.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(logdir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_scopes_equal_jax():
    assert profiling.SCOPES == rt.profiling.SCOPES
    assert rp.profiling is profiling and rp.device_time is profiling.device_time


@pytest.mark.parametrize("call,scopes", [
    ("grouped_sort", GROUPED),
    ("grouped_kernel_tail", GROUPED),
    ("per_pair", ("rpt_candidates", "rpt_rerank", "rpt_topk_tail")),
])
def test_cpu_trace_names_the_query_stages(packed, tmp_path, call, scopes):
    """A CPU trace of a small query holds the JAX package's scopes of that
    path, and the traced result is the untraced one's bits."""
    f, _, q = packed
    run = {
        "grouped_sort": lambda: f.knn_grouped(q, K, budget=2),
        "grouped_kernel_tail": lambda: f.knn_grouped(q, K, budget=2,
                                                     selection="kernel"),
        "per_pair": lambda: f.knn(q, K, budget=2),
    }[call]
    want = run()
    with rp.profiling.trace(str(tmp_path)) as prof:
        got = run()
        rp.profiling.sync(*got)
    assert set(scopes) <= _ranges(tmp_path)
    assert set(scopes) <= {e.key for e in prof.key_averages()}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cpu_trace_names_build_and_fold(packed, tmp_path):
    f, x, _ = packed
    with rp.profiling.trace(str(tmp_path / "build")):
        rp.forest_batch(3, 5, 32, 2, 1.0, x, device="cpu")
    assert {"rpt_project", "rpt_partition_at_median"} <= _ranges(
        tmp_path / "build")
    g = rp.forest_batch(3, 5, 32, 2, 1.0, x, device="cpu").pack_leaves(
        slack=8)
    g.add(x[:20] + 0.25)
    with rp.profiling.trace(str(tmp_path / "fold"), host=True):
        g.fold()
    assert "rpt_insert" in _ranges(tmp_path / "fold")
    assert g.n_folded + g.n_pending == 20


def test_region_enters_no_record_function_without_profiler(packed,
                                                           monkeypatch):
    """With no profiler running, ``region()`` returns the shared no-op
    context: a ``record_function`` that fails is never entered, on a
    whole grouped query, a per-pair one, a build and a fold."""
    f, x, q = packed

    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.region("rpt_candidates") is profiling.region("x")
    f.knn_grouped(q, K, budget=2, selection="kernel")
    f.knn(q, K, budget=2)
    g = rp.forest_batch(3, 5, 32, 2, 1.0, x, device="cpu").pack_leaves(
        slack=8)
    g.add(x[:4] + 0.25).fold()


def test_region_is_record_function_under_profiler():
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.region("rpt_rerank") as r:
            torch.ones(3).sum()
        assert r is not None
    assert "rpt_rerank" in {e.key for e in prof.key_averages()}


def test_device_time_cpu(packed):
    f, _, q = packed
    t = rp.device_time(lambda qq: f.knn(qq, K, budget=2), q, reps=3)
    assert t >= 0.0
    assert rp.device_time(lambda a: a * 2, np.ones(4, np.float32),
                          reps=2) >= 0.0


def test_device_time_refuses_like_jax():
    """No floating-point argument: JAX's ``ValueError``, its message."""
    args = (np.arange(4), torch.arange(4))
    with pytest.raises(ValueError) as want:
        rt.profiling.device_time(lambda *a: a[0], *args)
    with pytest.raises(ValueError) as got:
        rp.device_time(lambda *a: a[0], *args)
    assert str(got.value) == str(want.value)


def test_sync_leaves_cpu_tensors():
    rp.profiling.sync(torch.ones(2), np.ones(2), None)
