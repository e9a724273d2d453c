"""The plain torch version of the port's top-k tail kernel
(``ops/topk_kernel.py``) against the Pallas ``topk_dedup_kernel`` in
interpret mode: exactly equal, distances and ids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu.ops.topk_kernel import topk_dedup_kernel as jax_topk
from rptree_tpu_torch.ops import topk_kernel as tt

from torch_parity import one_torch_thread  # noqa: F401


def _state(seed, b, w, n_ids, masked=0.3, exhausted=(), ties=True):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 9.0, size=(b, w)).astype(np.float32)
    if ties:  # coarse grid: many equal distances
        d = (np.round(d * 4) / 4).astype(np.float32)
    ids = rng.integers(0, n_ids, size=(b, w)).astype(np.int32)
    mask = rng.uniform(size=(b, w)) < masked
    for r in exhausted:  # fewer live slots than k
        mask[r] = True
        mask[r, : r % 3] = False
    d = np.where(mask, np.inf, d).astype(np.float32)
    ids = np.where(mask, -1, ids).astype(np.int32)
    return d, ids


def _check(d, ids, k, dedup):
    kd, ki = jax_topk(jnp.asarray(d), jnp.asarray(ids), k, dedup=dedup,
                      bm=8, interpret=True)
    td, ti = tt.topk_dedup_kernel_reference(torch.as_tensor(d),
                                            torch.as_tensor(ids), k,
                                            dedup=dedup)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ki))
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(kd).view(np.int32))
    return td.numpy(), ti.numpy()


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("b,w,k,n_ids", [
    (24, 256, 10, 40),    # many duplicate ids
    (13, 640, 10, 5000),  # the iid cell's width, not a multiple of 128
    (9, 1024, 10, 300),   # the clustered cell's width
    (5, 200, 7, 20),
    (4, 3, 5, 2),         # k > W: every row runs dry
])
def test_plain_matches_pallas(dedup, b, w, k, n_ids):
    d, ids = _state(b * w, b, w, n_ids, exhausted=(1, 2))
    td, ti = _check(d, ids, k, dedup)
    # exhausted rows pad with (+inf, -1)
    assert ((ti == -1) == np.isinf(td)).all()
    if dedup:
        for row in ti:
            live = row[row >= 0]
            assert len(set(live.tolist())) == len(live)


def test_duplicate_distances_keep_lowest_copy():
    d = np.array([[5.0, 1.0, 3.0, 2.0] + [np.inf] * 4], np.float32)
    ids = np.array([[7, 7, 3, 3] + [-1] * 4], np.int32)
    td, ti = _check(d, ids, 3, True)
    np.testing.assert_array_equal(ti, [[7, 3, -1]])
    td, ti = _check(d, ids, 3, False)
    np.testing.assert_array_equal(ti, [[7, 3, 3]])


def test_ties_take_lowest_position():
    d = np.full((2, 130), 4.0, np.float32)
    ids = np.tile(np.arange(130, dtype=np.int32)[::-1], (2, 1))
    _, ti = _check(d, ids, 5, True)
    np.testing.assert_array_equal(ti[0], [129, 128, 127, 126, 125])


def test_wrapper_on_cpu_and_bad_arguments():
    d, ids = _state(3, 6, 50, 10)
    before = tt.topk_dedup_kernel.launches
    a = tt.topk_dedup_kernel(torch.as_tensor(d), torch.as_tensor(ids), 4)
    b = tt.topk_dedup_kernel_reference(torch.as_tensor(d),
                                       torch.as_tensor(ids), 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert tt.topk_dedup_kernel.launches == before
    with pytest.raises(ValueError):
        tt.topk_dedup_kernel(torch.as_tensor(d), torch.as_tensor(ids), 129)
    with pytest.raises(ValueError):
        tt.topk_dedup_kernel(torch.as_tensor(d), torch.as_tensor(ids[:, 1:]),
                             4)
    assert tt.topk_kernel_ok(640, 10)
    assert not tt.topk_kernel_ok(640, 10, min_votes=2)
    assert not tt.topk_kernel_ok(640, 129)


@pytest.mark.parametrize("w,regs", [(1, 4), (3, 4), (128, 4), (129, 8),
                                    (640, 20), (1023, 32), (1024, 32),
                                    (1025, 40), (1280, 40), (1281, 48),
                                    (2048, 64), (2049, 0), (3000, 0)])
def test_route_by_width(w, regs):
    """The card's route: rows of up to 2,048 read once (4 distances a lane
    for every 128 of W, so 16-byte loads fill them, then 8 for every 256
    past 1,024), wider rows on the wide-row kernel (0)."""
    assert tt.topk_route(w) == regs
    assert regs == 0 or 32 * regs >= w


def _oracle(d, ids, k, dedup):
    """Each id's least (distance, position) copy, those in that order, the
    first k of them (every copy without dedup), padded with (+inf, -1); a
    -inf winner pads with (-inf, -1) from it on."""
    od = np.full((d.shape[0], k), np.inf, np.float32)
    oi = np.full((d.shape[0], k), -1, np.int32)
    for r in range(d.shape[0]):
        order = np.lexsort((np.arange(d.shape[1]), d[r]))
        seen, j = set(), 0
        for p in order:
            if j == k or not d[r, p] < np.inf:
                break
            if d[r, p] == -np.inf:
                od[r, j:] = -np.inf
                break
            if dedup and ids[r, p] in seen:
                continue
            seen.add(ids[r, p])
            od[r, j], oi[r, j] = d[r, p], ids[r, p]
            j += 1
    return od, oi


def _pairs_state(seed, b, p, lmax):
    """Distances on a coarse grid (many equal), leaf tables whose rows share
    ids, pair rows that repeat a leaf (and count one from the end), masked
    pairs, short leaves, and rows with fewer than k live slots or a -inf."""
    rng = np.random.default_rng(seed)
    nb = 12
    id_leaf = rng.integers(0, 2 * lmax, size=(nb, lmax)).astype(np.int32)
    rows = rng.integers(-1, nb, size=(b, p)).astype(np.int32)
    rows[0] = rows[0, 0]                       # one leaf in every pair
    d = (np.round(rng.uniform(1.0, 9.0, size=(b, p, lmax)) * 4) / 4)
    lens = rng.integers(0, lmax + 1, size=(b, p))
    d = np.where(np.arange(lmax) < lens[..., None], d, np.inf)
    d[1, rng.uniform(size=p) < 0.5] = np.inf   # masked pairs
    d[2] = np.inf                              # fewer live slots than k
    d[2, 0, : min(lmax, 3)] = 1.5
    d[3] = 2.0                                 # every distance equal
    d[4, -1, -1] = -np.inf
    return (d.reshape(b, p * lmax).astype(np.float32), id_leaf, rows)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("p", [1, 8, 16])
@pytest.mark.parametrize("lmax", [128, 160, 7])
def test_pair_form_matches_the_ids_form(lmax, p, k, dedup):
    """The pair form (ids read in place from the leaf table through the
    pair rows) on the CPU, and its plain version, against the ids form's
    plain version on ``id_leaf[rows_sel].reshape(B, -1)``, bit for bit,
    and against the selection's rule; no launch is counted."""
    d, id_leaf, rows = _pairs_state(lmax * 1000 + p * 10 + k, 6, p, lmax)
    ids = id_leaf[rows].reshape(d.shape[0], -1)
    want = tt.topk_dedup_kernel_reference(torch.as_tensor(d),
                                          torch.as_tensor(ids), k,
                                          dedup=dedup)
    before = tt.topk_dedup_pairs.launches
    for fn in (tt.topk_dedup_pairs, tt.topk_dedup_pairs_reference):
        got = fn(torch.as_tensor(d), torch.as_tensor(id_leaf),
                 torch.as_tensor(rows), k, dedup=dedup)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
    assert tt.topk_dedup_pairs.launches == before
    od, oi = _oracle(d, ids, k, dedup)
    np.testing.assert_array_equal(want[1].numpy(), oi)
    np.testing.assert_array_equal(want[0].numpy(), od)
    assert (want[0][4] == -np.inf).all() and (want[1][4] == -1).all()


def test_pair_form_bad_arguments():
    d = torch.zeros(4, 16)
    id_leaf = torch.zeros(5, 8, dtype=torch.int32)
    rows = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tt.topk_dedup_pairs(d, id_leaf, rows[:, :1], 3)
    with pytest.raises(ValueError):
        tt.topk_dedup_pairs(d, id_leaf, rows[:3], 3)
    with pytest.raises(ValueError):
        tt.topk_dedup_pairs(d, id_leaf, rows, 129)
