"""The port's exact scan (``brute_force_knn``) against the JAX package's at
every precision and metric, on iid data made from a seed with numpy.

"highest" multiplies in fp32 on both sides; "default" and "fastest" round
data and queries to bf16 and sum in fp32 (the port through kernel 5's
plain version for l2 / sql2 / dot).  On the CPU the JAX package's
``lax.approx_max_k`` selects exactly, so every precision compares ids
outside near-ties and distances to 1e-5 (fp32 sums in other orders;
``torch_parity.knn_agree``)."""

import numpy as np
import pytest
import torch

import rptree_tpu as rt
from rptree_tpu_torch.ops import scan as scan_mod

from torch_parity import carry, one_torch_thread  # noqa: F401
from torch_parity import knn_agree as _agree

K = 7


@pytest.fixture(scope="module")
def forests():
    rng = np.random.default_rng(31)
    x = rng.normal(size=(600, 24)).astype(np.float32)
    q = (x[rng.integers(0, 600, size=40)]
         + 0.3 * rng.normal(size=(40, 24))).astype(np.float32)
    fj = rt.forest_batch(3, 3, 64, 2, 1.0, x)
    return x, q, fj, carry(fj)


@pytest.mark.parametrize("precision", ["highest", "default", "fastest"])
@pytest.mark.parametrize("metric", ["l2", "sql2", "cosine", "dot"])
def test_matches_jax(forests, metric, precision):
    _, q, fj, ft = forests
    before = scan_mod.scan_topk.launches
    got = ft.brute_force_knn(q, K, metric, precision)
    _agree(got, fj.brute_force_knn(q, K, metric, precision))
    assert scan_mod.scan_topk.launches == before  # the CPU runs no kernel


def test_fast_precisions_round_to_bf16(forests):
    """"fastest" ranks the bf16-rounded rows: against an fp32 numpy scan
    of the rounded operands, and away from the f32 scan's distances."""
    x, q, _, ft = forests
    d, i = ft.brute_force_knn(q, K, precision="fastest")
    xb = torch.as_tensor(x).bfloat16().double().numpy()
    qb = torch.as_tensor(q).bfloat16().double().numpy()
    sq = (x.astype(np.float64) ** 2).sum(1)
    part = sq[None] - 2.0 * qb @ xb.T
    order = np.argsort(part, axis=1, kind="stable")[:, :K]
    assert (i.numpy() == order).mean() > 0.95
    dh, _ = ft.brute_force_knn(q, K, precision="highest")
    assert not torch.equal(d, dh)


@pytest.mark.parametrize("precision", ["highest", "fastest"])
def test_query_chunk(forests, precision):
    _, q, fj, ft = forests
    d, i = ft.brute_force_knn(q, K, precision=precision)
    dc, ic = ft.brute_force_knn(q, K, precision=precision, query_chunk=16)
    assert torch.equal(ic, i) and torch.equal(dc, d)
    _agree((dc, ic), fj.brute_force_knn(q, K, precision=precision,
                                        query_chunk=16))


def test_k_past_scan_width(forests):
    """k > 128 at "fastest" leaves the fused scan's gate for the plain
    bf16 product with an exact selection, as in the JAX package."""
    _, q, fj, ft = forests
    _agree(ft.brute_force_knn(q[:4], 130, precision="fastest"),
           fj.brute_force_knn(q[:4], 130, precision="fastest"))


def test_callable_and_bad_arguments(forests):
    _, q, fj, ft = forests
    l1 = lambda rows, qq: (rows - qq).abs().sum(-1)  # noqa: E731
    d, i = ft.brute_force_knn(q, K, l1, "fastest")  # callables see f32 rows
    dj, ij = fj.brute_force_knn(q, K, lambda r, qq: abs(r - qq).sum(-1))
    _agree((d, i), (dj, ij))
    with pytest.raises(ValueError):
        ft.brute_force_knn(q, K, "l3", "fastest")
    with pytest.raises(ValueError):
        ft.brute_force_knn(q, K, precision="exact")
    with pytest.raises(ValueError):
        ft.brute_force_knn(q, 0)



@pytest.mark.parametrize("metric", ["l2", "sql2", "dot"])
def test_fastest_query_chunk_makes_one_row_copy(forests, metric):
    """``brute_force_knn`` at "fastest" with ``query_chunk`` makes kernel 5's
    bf16 row copy once for all chunks; the result equals scanning each
    chunk on its own, as the port did before it hoisted the copy."""
    _, q, _, ft = forests
    got = ft.brute_force_knn(q, K, metric, "fastest", query_chunk=16)
    qt = torch.as_tensor(q)
    parts = [scan_mod.scan_topk(ft.x, ft.sq_norms, qt[s:s + 16], K, metric)
             for s in range(0, qt.shape[0], 16)]
    assert torch.equal(got[0], torch.cat([p[0] for p in parts]))
    assert torch.equal(got[1], torch.cat([p[1] for p in parts]))
