"""The port's examples that draw their rows with numpy against the JAX
examples, whole, on the CPU: ``examples/torch_fold_drift.py`` against
``examples/fold_drift.py`` and ``examples/torch_scale_1m.py`` against
``examples/scale_1m.py``.  Each pair draws the same numpy rows (the same
seed, the same calls in the same order), and the port is given the JAX
package's projections (``rptree_tpu.utils.gen.sample_projections`` of the
same arguments, handed to ``rptree_tpu_torch.forest_batch`` as ``r=``).
Counts are equal; each recall is within 0.005 (near-ties of the
projections at a median may send a point to the other child,
``tests/test_torch_ties.py``)."""

import importlib.util
import os
import re

import numpy as np
import pytest

from torch_parity import EXAMPLES, one_torch_thread  # noqa: F401

RECALL_ATOL = 0.005
STEP = re.compile(r"folded\s+([\d.]+)%\s+pending\s+(\d+)\s+recall fold-only "
                  r"([\d.]+)\s+rebuilt ([\d.]+)")


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_projections(monkeypatch):
    """``rptree_tpu_torch.forest_batch`` builds on the JAX package's
    projections of the same arguments."""
    import rptree_tpu_torch as tp
    from rptree_tpu.utils import gen as jgen

    build = tp.forest_batch

    def with_jax_projections(seed, max_depth, min_leaf, n_trees, pnz, data,
                             *args, **kw):
        r = np.array(jgen.sample_projections(seed, n_trees, max_depth,
                                              data.shape[1], pnz))
        return build(seed, max_depth, min_leaf, n_trees, pnz, data, *args,
                     r=r, **kw)

    monkeypatch.setattr(tp, "forest_batch", with_jax_projections)


def _steps(text):
    return [(float(a), int(p), float(f), float(r))
            for a, p, f, r in STEP.findall(text)]


@pytest.mark.parametrize("drift", [False, True])
def test_fold_drift_matches_the_jax_example(drift, jax_projections, capsys):
    """The folded fraction and the pending count equal at every step, each
    recall column within ``RECALL_ATOL``."""
    import torch_fold_drift

    kw = dict(n0=2048, steps=2)
    want_rows = _jax_example("fold_drift").run(drift=drift, **kw)
    want = _steps(capsys.readouterr().out)
    got_rows = torch_fold_drift.run(drift=drift, device="cpu", **kw)
    got = _steps(capsys.readouterr().out)
    assert len(got) == len(want) == 2
    for (gf, gp, gr_f, gr_r), (wf, wp, wr_f, wr_r), grow, wrow in zip(
            got, want, got_rows, want_rows):
        assert gf == wf and gp == wp and grow[0] == wrow[0]
        assert abs(gr_f - wr_f) <= RECALL_ATOL
        assert abs(gr_r - wr_r) <= RECALL_ATOL
        assert abs(grow[1] - wrow[1]) <= RECALL_ATOL
        assert abs(grow[2] - wrow[2]) <= RECALL_ATOL


def test_scale_1m_matches_the_jax_example(jax_projections, monkeypatch,
                                          capsys):
    """At n 8,192 the configuration line is the same and recall@10 of the
    256 queries (budget 4, probes 12, bf16 blocks) is within
    ``RECALL_ATOL`` of the JAX example's.  Each ``device_time`` runs its
    function once: the times are not compared."""
    import rptree_tpu
    import rptree_tpu_torch
    import torch_scale_1m

    def once(fn, *args, reps=1):
        fn(*args)
        return 1.0

    for pkg in (rptree_tpu, rptree_tpu_torch):
        monkeypatch.setattr(pkg, "device_time", once)
    n = 8192
    _jax_example("scale_1m").main(n)
    want = capsys.readouterr().out.splitlines()
    rec = torch_scale_1m.main(n, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]
    want_rec = float(re.fullmatch(r"recall@10 = ([\d.]+)", want[-1])[1])
    assert got[-1] == f"recall@10 = {rec:.4f}"
    assert abs(rec - want_rec) <= RECALL_ATOL
