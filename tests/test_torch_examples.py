"""The port's examples (``examples/torch_*.py``) on the CPU at small
sizes: none imports JAX or the JAX package, each ``main`` prints the JAX
example's lines in its order with its labels, and the port's
``_brute_force_many`` (the exact scan a query chunk at a time, which
``torch_clustered_1m.py`` and ``torch_scan_ladder.py`` call) against the
JAX package's."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import (EXAMPLES, cpu_examples,  # noqa: F401
                          labels, one_torch_thread, recalls)

ROOT = os.path.dirname(EXAMPLES)
SEVEN = ("torch_clustered_1m", "torch_serving_loop", "torch_scale_10m",
         "torch_bow_sparse", "torch_scale_1m", "torch_fold_drift",
         "torch_scan_ladder")


def test_examples_import_neither_jax_nor_the_jax_package():
    """The seven modules, imported and one of them run in a fresh
    interpreter on the CPU, leave ``jax`` and ``rptree_tpu`` out of
    ``sys.modules`` (the examples import the port inside ``main``)."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {EXAMPLES!r})\n"
        f"mods = [__import__(m) for m in {SEVEN!r}]\n"
        "import torch_scan_ladder\n"
        "torch_scan_ladder.main(600, 64)\n"
        "import rptree_tpu_torch.models.forest, rptree_tpu_torch.ops.sparse\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rptree_tpu' or m.startswith('rptree_tpu.')]\n"
        "assert not bad, bad\n"
        "print('jax-free', len(mods))\n")
    env = {**os.environ, "RPTREE_EXAMPLE_DEVICE": "cpu",
           "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "jax-free 7"


def test_examples_raise_without_a_card(monkeypatch):
    """Without CUDA and without ``RPTREE_EXAMPLE_DEVICE`` the examples
    raise, as the port's entry points do: no quiet fallback."""
    import torch_clustered_1m
    import torch_scale_1m

    monkeypatch.delenv("RPTREE_EXAMPLE_DEVICE", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_clustered_1m.make_clustered(100, 4, 8, 0.1, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_scale_1m.main(500)


# -- _brute_force_many against the JAX package's ------------------------------

def _near_tie_ok(got_ids, want_ids, want_d, rtol=1e-5):
    """Ids equal wherever the distance to the next one is not a near-tie
    (the last place is left out: its unseen successor may tie it)."""
    k = want_ids.shape[1]
    for b in range(want_ids.shape[0]):
        d = want_d[b]
        for j in range(k - 1):
            tied = (abs(d[j + 1] - d[j]) <= rtol * max(abs(d[j]), 1e-6)
                    or (j and abs(d[j] - d[j - 1])
                        <= rtol * max(abs(d[j]), 1e-6)))
            if not tied:
                assert got_ids[b, j] == want_ids[b, j], (b, j)


@pytest.mark.parametrize("metric", ["l2", "sql2", "dot"])
@pytest.mark.parametrize("n,b,chunk,k", [(1500, 64, 16, 10), (700, 96, 32, 5)])
def test_brute_force_many_matches_jax(metric, n, b, chunk, k):
    """At ``"highest"`` the port's ``_brute_force_many`` gives the JAX
    package's (``rptree_tpu/models/forest.py`` ``_brute_force_many``) on
    the same numpy rows: distances within 1e-5 relative, ids equal outside
    near-ties."""
    import jax.numpy as jnp

    from rptree_tpu.models.forest import _brute_force_many as jax_bfm
    from rptree_tpu_torch.models.forest import _brute_force_many

    rng = np.random.default_rng(n + b)
    x = rng.normal(size=(n, 24)).astype(np.float32)
    q = rng.normal(size=(b, 24)).astype(np.float32)
    sq = (x * x).sum(-1)
    dj, ij = jax_bfm(jnp.asarray(x), jnp.asarray(sq), jnp.asarray(q), k,
                     metric, "highest", chunk)
    dj, ij = np.asarray(dj), np.asarray(ij)
    dt, it = _brute_force_many(torch.as_tensor(x), torch.as_tensor(sq),
                               torch.as_tensor(q), k, metric, "highest",
                               chunk)
    assert dt.shape == (b, k) and it.dtype == torch.int32
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-5, atol=1e-5)
    _near_tie_ok(it.numpy(), ij, dj)


@pytest.mark.parametrize("precision", ["highest", "default", "fastest"])
def test_brute_force_many_is_the_chunked_scan(precision):
    """The chunks give the one-call scan's bits (``_brute_force`` over the
    whole batch, kernel 5's plain version at ``"default"`` /
    ``"fastest"``), a shorter last chunk included."""
    from rptree_tpu_torch.models.forest import _brute_force, _brute_force_many

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(900, 32, generator=gen)
    q = torch.randn(70, 32, generator=gen)
    sq = (x * x).sum(-1)
    want = _brute_force(x, sq, q, 10, "l2", precision)
    got = _brute_force_many(x, sq, q, 10, "l2", precision, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_brute_force_many_on_ell_rows():
    """Sparse rows take the ELL scan a chunk at a time."""
    from rptree_tpu_torch.models.forest import _brute_force, _brute_force_many
    from rptree_tpu_torch.ops.sparse import EllMatrix, ell_sq_norms

    gen = torch.Generator().manual_seed(6)
    cols = torch.randint(0, 200, (300, 6), generator=gen).to(torch.int32)
    x = EllMatrix(200, cols, torch.rand(300, 6, generator=gen))
    q = torch.rand(40, 200, generator=gen)
    sq = ell_sq_norms(x)
    want = _brute_force(x, sq, q, 5, "l2")
    got = _brute_force_many(x, sq, q, 5, "l2", "default", 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- the examples' main, small, on the CPU -----------------------------------

def test_scan_ladder_main(cpu_examples, capsys):
    import torch_scan_ladder

    res = torch_scan_ladder.main(3000, 256)
    out = capsys.readouterr().out
    assert labels(out) == [
        "backend=cpu n=# d=# b=# k=#",
        *[f"xla scan precision={p} # QPS recall@# #"
          for p in ("highest", "default", "fastest")],
        "plain scan_topk # QPS recall@# #"]
    assert res["xla scan precision=highest"][1] == 1.0
    assert all(0.9 <= rec <= 1.0 for _, rec in res.values())


def test_clustered_1m_main(cpu_examples, capsys):
    import torch_clustered_1m

    res = torch_clustered_1m.main(6000, 24, b_time=256, b_rec=128)
    out = capsys.readouterr().out
    shapes = ("T=# ml=# f#: built+packed in #s (lmax=#, leaves=#)",
              "T=# ml=# int#c: built+packed in #s (lmax=#, leaves=#)",
              "T=# ml=# f#: built+packed in #s (lmax=#, leaves=#)")
    want = ["n=# centers=# dim=# sigma=#", "ground truth in #s",
            "scan: # QPS @ recall #"]
    for s in shapes:
        want += [s] + ["budget=# probes=#: # QPS @ recall #"] * 3
    want += ["", "-- frontier (recall desc) --"]
    want += ["T=# ml=# f# b=# p=# # QPS recall #"] * 6
    want += ["T=# ml=# int#c b=# p=# # QPS recall #"] * 3
    got = labels(out)
    assert sorted(got[len(want) - 9:len(want)]) == sorted(want[-9:])
    assert got[:len(want) - 9] == want[:-9]
    if any(r["recall"] >= 0.9 for r in res):
        assert got[len(want):len(want) + 1] == [""]
        assert re.fullmatch(r"tree winner @>=#: # QPS \(scan #\) -> "
                            r"(TREE WINS|scan wins)", got[-1])
    assert len(res) == 9 and all(0 <= r["recall"] <= 1 for r in res)
    assert all(0 <= r <= 1 for r in recalls(out))


def test_serving_loop_main(cpu_examples, capsys):
    import torch_serving_loop

    res = torch_serving_loop.main(6000, 24, bq=128, n_batches=4, reps=4)
    assert labels(capsys.readouterr().out) == [
        "built+packed in #s (T=# ml=# b=# p=#, B=#)",
        "sync: # QPS wall", "depth=#: # QPS wall", "depth=#: # QPS wall",
        "chunked: # QPS wall (# batches / dispatch)",
        "overflow telemetry after the loop: needed=# capacity=# "
        "overflow=False",
        "", labels(f"best over sync: 1x ({max(res, key=res.get)})")[0]]
    assert set(res) == {"sync", "depth=2", "depth=4", "chunked"}


def test_serving_loop_results_are_the_checked_results(cpu_examples):
    """The example's serving call at ``check=False``, after its checked
    call, returns the checked call's neighbours, and chunked the same as
    the batches served apart."""
    import rptree_tpu_torch as rt
    from torch_clustered_1m import make_clustered
    from torch_serving_loop import BUDGET, PROBES, T

    x, q = make_clustered(6000, 24, 32, 0.15, 256)
    f = rt.forest_batch(3, 6, 64, T, 1.0, x, device="cpu")
    f.pack_leaves()
    kw = dict(budget=BUDGET, probes=PROBES, precision="default", tile_m=8)
    want = f.knn_grouped(q[:128], 10, check=True, **kw)
    got = f.knn_grouped(q[:128], 10, check=False, **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert not f.grouped_overflow()["overflow"]
    f.knn_grouped(q, 10, check=True, chunk=128, **kw)
    big = f.knn_grouped(q, 10, check=False, chunk=128, **kw)
    assert torch.equal(big[1][:128], want[1])


def test_scale_1m_main(cpu_examples, capsys):
    import torch_scale_1m

    rec = torch_scale_1m.main(5000)
    assert labels(capsys.readouterr().out) == [
        "n=# depth=# pnz=#",
        "build wall #s (includes host->device transfer and the first "
        "kernel loads)",
        "build device #s", "query device #ms per # queries (# QPS/chip)",
        "recall@# =#"]
    assert 0 < rec <= 1


def test_make_clustered_is_seeded(cpu_examples):
    """The module-level data helper keeps JAX's name and arguments: the
    same draw twice, queries near data points."""
    from torch_clustered_1m import make_clustered

    x, q = make_clustered(3000, 12, 16, 0.15, 64)
    x2, q2 = make_clustered(3000, 12, 16, 0.15, 64)
    assert x.shape == (3000, 16) and q.shape == (64, 16)
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    assert torch.equal(x, x2) and torch.equal(q, q2)
    assert float(torch.cdist(q, x).min(1).values.max()) < 1.0
