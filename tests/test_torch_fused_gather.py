"""Kernel 6's plain version (``rptree_tpu_torch/ops/fused_gather.py``)
against the JAX package's Pallas ``gather_score`` run with
``interpret=True``: the same blocks, norms, queries and block rows, made
from a seed with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu.ops.fused_gather import gather_score as jax_gather_score
from rptree_tpu_torch.ops.fused_gather import (MAX_PAIRS, _pair_runs,
                                               gather_score,
                                               gather_score_ok,
                                               gather_score_reference)

from torch_parity import one_torch_thread  # noqa: F401

# the JAX test's own tolerance (tests/test_fused_gather.py): fp32 sums in
# another order
RTOL, ATOL = 2e-5, 1e-4


def _case(seed, g, lmax, d, b, p, bf16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, lmax, d)).astype(np.float32)
    sq = (x * x).sum(-1).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    sel = rng.integers(0, g, size=(b, p)).astype(np.int32)
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    xt = torch.as_tensor(x).to(torch.bfloat16 if bf16 else torch.float32)
    return (xj, x, sq, q, sel), xt


def _both(xj, x, sq, q, sel, xt):
    dj, sj = jax_gather_score(xj, jnp.asarray(sq), jnp.asarray(q),
                              jnp.asarray(sel), sel.shape[1], interpret=True)
    args = (xt, torch.as_tensor(sq), torch.as_tensor(q), torch.as_tensor(sel))
    dt, st = gather_score_reference(*args)
    dw, sw = gather_score(*args)  # on the CPU the wrapper is the plain version
    assert torch.equal(dw, dt) and torch.equal(sw, st)
    return (np.asarray(dj), np.asarray(sj)), (dt.numpy(), st.numpy())


@pytest.mark.parametrize("bf16", [False, True])
def test_matches_pallas_interpret(bf16):
    # the JAX test's shapes; bf16 needs lmax % 16 == 0 for the Pallas gate
    (xj, x, sq, q, sel), xt = _case(0, 40, 16, 128, 12, 5, bf16)
    (dj, sj), (dt, st) = _both(xj, x, sq, q, sel, xt)
    assert dt.shape == (12, 5, 16) and dt.dtype == np.float32
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(st.view(np.int32), sj.view(np.int32))
    if bf16:  # the query is rounded to bf16, as the blocks are
        xr = xt.float().numpy()
        qr = torch.as_tensor(q).bfloat16().float().numpy()
        np.testing.assert_allclose(dt, np.einsum("bpld,bd->bpl", xr[sel], qr),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_duplicate_and_repeated_blocks(bf16):
    (xj, x, sq, q, _), xt = _case(1, 8, 16, 128, 6, 4, bf16)
    sel = np.zeros((6, 4), np.int32)  # every probe the same block ...
    sel[:, 1] = 3                     # ... but one
    (dj, sj), (dt, st) = _both(xj, x, sq, q, sel, xt)
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(st.view(np.int32), sj.view(np.int32))
    # duplicated probes fetch identically
    np.testing.assert_array_equal(dt[:, 0], dt[:, 2])
    np.testing.assert_array_equal(dt[:, 0], dt[:, 3])


def test_any_lmax_and_width():
    """No TPU tiling rule: lmax 13, D 20 (neither on the Pallas tiles)."""
    (_, x, sq, q, sel), xt = _case(2, 9, 13, 20, 7, 3, False)
    dt, st = gather_score_reference(xt, torch.as_tensor(sq),
                                    torch.as_tensor(q), torch.as_tensor(sel))
    np.testing.assert_allclose(dt.numpy(), np.einsum("bpld,bd->bpl", x[sel], q),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(st.numpy(), sq[sel])


def test_gate():
    x = torch.zeros(4, 13, 20)
    assert gather_score_ok(x, 1)
    assert gather_score_ok(x.bfloat16(), 3)  # lmax 13: no sublane rule
    assert not gather_score_ok(x, 0)
    assert not gather_score_ok(x.to(torch.int8), 2)
    assert not gather_score_ok(x.half(), 2)
    assert not gather_score_ok(x[0], 2)
    assert not gather_score_ok(np.zeros((4, 13, 20), np.float32), 2)


def test_raises_on_bad_shapes():
    x, sq = torch.zeros(4, 8, 6), torch.zeros(4, 8)
    q, sel = torch.zeros(3, 6), torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_score(x.to(torch.int8), sq, q, sel)
    with pytest.raises(ValueError):
        gather_score(x, sq[:, :4], q, sel)
    with pytest.raises(ValueError):
        gather_score(x, sq, q[:, :5], sel)
    with pytest.raises(ValueError):
        gather_score(x, sq, q, sel[:2])


@pytest.mark.parametrize("g,b,p", [(9, 40, 3), (4, 40, 8), (1, 5, 2)])
def test_pair_runs(g, b, p):
    """Kernel 6's work items: every pair exactly once, the pairs ordered
    by block row (clamped), a run past ``MAX_PAIRS`` pairs split into
    items of at most that many, each item on one block."""
    rng = np.random.default_rng(g * b)
    sel = rng.integers(-2, g + 2, size=(b, p)).astype(np.int32)
    sel[: b // 2, 0] = g // 2              # a long run on one block
    runs = _pair_runs(torch.as_tensor(sel), g)
    blk = np.clip(sel.reshape(-1), 0, g - 1)
    order = runs.order.numpy()
    assert sorted(order.tolist()) == list(range(b * p))
    assert (np.diff(blk[order]) >= 0).all()  # runs sorted by block
    np.testing.assert_array_equal(runs.counts.numpy(),
                                  np.bincount(blk, minlength=g))
    k = int(runs.n_items)
    served = []
    for s0, c, bl in zip(runs.start[:k].tolist(), runs.count[:k].tolist(),
                         runs.block[:k].tolist()):
        assert 1 <= c <= MAX_PAIRS
        assert (blk[order[s0:s0 + c]] == bl).all()
        served += order[s0:s0 + c].tolist()
    assert sorted(served) == list(range(b * p))  # each pair in one item
    want_items = sum(-(-n // MAX_PAIRS) for n in np.bincount(blk).tolist())
    assert k == want_items
    if b // 2 > MAX_PAIRS:  # the long run was split
        assert int(runs.count[:k].min()) < MAX_PAIRS < int(runs.counts.max())
