"""The port's serving examples (``examples/torch_scale_10m.py``,
``torch_bow_sparse.py``, ``torch_fold_drift.py``) on the CPU at small
sizes: each ``main`` prints the JAX example's lines in its order with its
labels, recall in [0, 1]; the bag-of-words data helpers draw the JAX
example's distribution and densify as it does."""

import re

import torch

from torch_parity import (cpu_examples, labels,  # noqa: F401
                          one_torch_thread, recalls)


def test_scale_10m_main(cpu_examples, capsys):
    import torch_scale_10m

    torch_scale_10m.main(6000, 24, b_time=512, b_rec=128)
    out = capsys.readouterr().out
    hbm = "hbm=# GB peak=# GB"
    path = "QPS wall @ recall # (B=#, chunk=#, vs scan #x) " + hbm
    assert labels(out) == [
        f"n=# centers=# dim=# sigma=# {hbm} (dataset # GB)",
        "cfg: min_leaf=# depth=# pnz=# T=#",
        f"build wall #s {hbm}",
        "pack(store='shared') #s: # blocks x lmax=#; id+sq tables # GB vs "
        f"blocked layout's # GB of row copies {hbm}",
        "ground truth (exact scan, #q) in #s",
        "exact scan: # QPS (precision='fastest')",
        f"per-pair knn_batched: # {path}",
        f"per-pair knn_batched selection=kernel: # {path}",
        f"grouped knn_grouped: # {path}"]
    got = recalls(out)
    assert len(got) == 3 and all(0 <= r <= 1 for r in got)
    assert got[0] == got[1]  # the same candidates under both tails


def test_bow_sparse_main(cpu_examples, capsys):
    import torch_bow_sparse

    torch_bow_sparse.main(4096, 2048, 32, b=128)
    out = capsys.readouterr().out
    assert labels(out) == [
        "sparse build #s (depth=# ml=#)",
        "EllBlocks pack #s: # blocks x lmax=# x K=#",
        "exact sparse scan: # QPS",
        "per-pair knn_batched: # QPS wall @ recall # (vs scan #x)",
        "grouped knn_grouped: # QPS wall @ recall # (vs scan #x)",
        "grouped SPARSE queries: # QPS wall @ recall # (vs scan #x)"]
    got = recalls(out)
    assert len(got) == 3 and all(0 < r <= 1 for r in got)
    # sparse queries densify to the dense queries' rows
    assert got[1] == got[2]


def test_bow_sparse_gen_and_densify():
    """:func:`gen` draws the JAX example's documents (offsets below v //
    64 from a topic's band start, sorted; values |N(0, 1)| + 0.1), from
    its generator alone; :func:`densify` adds repeated columns, as the
    port's ``ell_to_dense`` does."""
    from torch_bow_sparse import NNZ, densify, gen

    from rptree_tpu_torch.ops.sparse import EllMatrix, ell_to_dense

    n, v, b = 3000, 4096, 64
    cols, vals, qi = gen(n, v, b, torch.Generator().manual_seed(2))
    again = gen(n, v, b, torch.Generator().manual_seed(2))
    assert all(torch.equal(a, w) for a, w in zip((cols, vals, qi), again))
    assert cols.shape == (n, NNZ) and cols.dtype == torch.int32
    assert bool((cols[:, 1:] >= cols[:, :-1]).all())
    band = cols.long() // (v // 256)  # the topic, then 3 bands past it
    assert bool((band.amax(1) - band.amin(1) <= 3).all())
    assert int(cols.max()) < v and int(cols.min()) >= 0
    assert float(vals.min()) >= 0.1 and vals.dtype == torch.float32
    assert qi.shape == (b,) and int(qi.max()) < n
    dense = densify(cols[qi], vals[qi], v)
    want = ell_to_dense(EllMatrix(v, cols[qi], vals[qi]), torch.float32)
    torch.testing.assert_close(dense, want, rtol=1e-6, atol=0)


def test_fold_drift_main(cpu_examples, capsys):
    import torch_fold_drift

    stat, dri = torch_fold_drift.main(n0=1024, steps=2, centers=16)
    out = capsys.readouterr().out
    step = ("folded #% pending # recall fold-only # rebuilt # gap "
            "[+-]#")
    got = labels(out)
    assert got[0] == "stationary stream (same mixture):"
    assert got[3] == "drifting stream (centers random-walk):"
    assert all(re.fullmatch(step, line) for line in got[1:3] + got[4:6])
    assert re.fullmatch(r"total #s", got[6])
    assert got[7:] == [
        "stationary: fold-only safe up to #% folded fraction (gap <=#)",
        "drifting: fold-only safe up to #% folded fraction (gap <=#)"]
    for rows in (stat, dri):
        assert len(rows) == 2 and rows[0][0] < rows[1][0] <= 1.0
        assert all(0 <= r <= 1 for row in rows for r in row[1:])
