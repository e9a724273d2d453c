"""Kernel 5's plain version (``rptree_tpu_torch/ops/scan.py``) against the
JAX package's Pallas ``scan_topk`` run with ``interpret=True``: the same
rows, norms and queries, made from a seed with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu.ops.scan import scan_topk as jax_scan_topk
from rptree_tpu_torch.ops.grouped_kernel import untied
from rptree_tpu_torch.ops.scan import (_partial_reference, scan_rows,
                                       scan_topk, scan_topk_reference)

from torch_parity import one_torch_thread  # noqa: F401

# both sides sum exact bf16 products in fp32, in other orders
RTOL = 1e-5


def _case(seed, n, b, d, positive=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    if positive:  # every inner product negative
        x, q = np.abs(x), -np.abs(q)
    sq = (x * x).sum(1).astype(np.float32)
    return x, sq, q


def _both(x, sq, q, k, metric, block_q, block_n):
    dj, ij = jax_scan_topk(jnp.asarray(x), jnp.asarray(sq), jnp.asarray(q), k,
                           metric=metric, block_q=block_q, block_n=block_n,
                           interpret=True)
    args = (torch.as_tensor(x), torch.as_tensor(sq), torch.as_tensor(q), k,
            metric)
    dt, it = scan_topk_reference(*args)
    dw, iw = scan_topk(*args)  # on the CPU the wrapper is the plain version
    assert torch.equal(dw, dt) and torch.equal(iw, it)
    assert it.dtype == torch.int32 and dt.dtype == torch.float32
    return (np.array(dj), np.array(ij)), (dt.numpy(), it.numpy())


def _agree(dj, ij, dt, it):
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=RTOL)
    chk = untied(torch.as_tensor(dj), RTOL).numpy()
    np.testing.assert_array_equal(it[chk], ij[chk])
    assert chk.mean() > 0.9


@pytest.mark.parametrize("metric", ["l2", "sql2", "dot"])
def test_matches_pallas_interpret(metric):
    # tests/test_scan_kernel.py's shapes
    x, sq, q = _case(5, 300, 50, 24)
    (dj, ij), (dt, it) = _both(x, sq, q, 7, metric, 16, 128)
    assert dt.shape == (50, 7)
    _agree(dj, ij, dt, it)
    assert (np.diff(dt, axis=1) >= 0).all()


def test_ranks_partial_distances():
    """The selection ranks ``sq - 2 x.q`` of the bf16-rounded operands,
    ascending, ties to the lower index."""
    x, sq, q = _case(8, 257, 9, 16)
    x[200] = x[3]  # an exact tie: index 3 must come first
    sq[200] = sq[3]
    q[0] = x[3]
    pd, pi = _partial_reference(torch.as_tensor(x), torch.as_tensor(sq),
                                torch.as_tensor(q), 5, "l2")
    xb = torch.as_tensor(x).bfloat16().float().numpy().astype(np.float64)
    qb = torch.as_tensor(q).bfloat16().float().numpy().astype(np.float64)
    want = sq[None, :] - 2.0 * (qb @ xb.T)
    np.testing.assert_allclose(pd.numpy(), np.take_along_axis(
        want, pi.numpy().astype(np.int64), 1), rtol=1e-6, atol=1e-4)
    assert (np.diff(pd.numpy(), axis=1) >= 0).all()
    assert pi[0, 0] == 3 and pi[0, 1] == 200


def test_padding_edges():
    """Non-multiple N / B / D: no padded row can come out."""
    x, sq, q = _case(6, 131, 9, 10)
    (dj, ij), (dt, it) = _both(x, sq, q, 5, "l2", 8, 64)
    assert ((it >= 0) & (it < 131)).all() and np.isfinite(dt).all()
    _agree(dj, ij, dt, it)


def test_dot_padding_mask():
    """``dot`` with every inner product negative: padded rows would win
    with distance 0 if the padding mask were lost."""
    x, sq, q = _case(7, 130, 8, 16, positive=True)
    (dj, ij), (dt, it) = _both(x, sq, q, 5, "dot", 8, 128)
    assert ((it >= 0) & (it < 130)).all()
    _agree(dj, ij, dt, it)


def test_k_past_n():
    x, sq, q = _case(9, 6, 3, 4)
    d, i = scan_topk(torch.as_tensor(x), torch.as_tensor(sq),
                     torch.as_tensor(q), 10, "sql2")
    assert d.shape == (3, 6)
    assert sorted(i[0].tolist()) == list(range(6))


def test_rejects_unknown_metric():
    x, sq, q = torch.zeros(8, 4), torch.zeros(8), torch.zeros(2, 4)
    for bad in ("cosine", "l3"):
        with pytest.raises(ValueError, match="scan_topk supports"):
            scan_topk(x, sq, q, 2, metric=bad)
        with pytest.raises(ValueError, match="scan_topk supports"):
            scan_topk_reference(x, sq, q, 2, metric=bad)
    with pytest.raises(ValueError):  # past the kernel's 128 kept entries
        scan_topk(torch.zeros(200, 4), torch.zeros(200), q, 129)


@pytest.mark.parametrize("metric", ["l2", "sql2", "dot"])
def test_row_copy_matches_f32_rows(metric):
    """Kernel 5's bf16 copy of the rows (``scan_rows``): zeros past (N, D),
    norms +inf past N, and the plain scan on the copy equal to the plain
    scan on the f32 rows, bit for bit."""
    x, sq, q = _case(10, 131, 9, 10, positive=metric == "dot")  # -> 256 x 64
    xt, sqt, qt = (torch.as_tensor(a) for a in (x, sq, q))
    rows = scan_rows(xt, sqt)
    assert rows.x.shape == (256, 64) and rows.x.dtype == torch.bfloat16
    assert torch.equal(rows.x[:131, :10], xt.bfloat16())
    assert not rows.x[131:].any() and not rows.x[:, 10:].any()
    assert torch.equal(rows.sq[:131], sqt)
    assert bool(torch.isinf(rows.sq[131:]).all())
    got = scan_topk(xt, sqt, qt, 7, metric, rows=rows)
    want = scan_topk(xt, sqt, qt, 7, metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1] < 131).all())
