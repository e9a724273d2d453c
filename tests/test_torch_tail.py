"""The port's sort selection tail (``ops/rerank.py``: ``_run_lengths``,
``dedup_ids``, ``merge_top_k``; ``models/forest.py``: ``_selection_tail``)
against the JAX package's functions on the same numpy inputs.

Integer outputs must be equal.  Where two distinct ids tie on distance,
JAX's ``lax.sort`` (not declared stable) and the port's stable sort may
take either first, so such rows are compared by distance and as id sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu.models import forest as jf
from rptree_tpu.ops import rerank as jr
from rptree_tpu_torch.models import forest as tf
from rptree_tpu_torch.ops import rerank as tr

from torch_parity import one_torch_thread  # noqa: F401


def _ids(seed, b, m, hi):
    """Ids with many duplicates and -1 padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, size=(b, m)).astype(np.int32)
    ids[rng.uniform(size=(b, m)) < 0.15] = -1
    ids[0] = -1                      # an all-padding row
    ids[1] = 7                       # one id repeated
    return ids


@pytest.mark.parametrize("m", [1, 2, 9, 64])
def test_run_lengths_equal(m):
    ids = np.sort(_ids(m, 40, m, 6), axis=-1)
    want = np.asarray(jr._run_lengths(jnp.asarray(ids)))
    got = tr._run_lengths(torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_votes", [1, 2, 3])
def test_dedup_ids_equal(min_votes):
    ids = _ids(1, 50, 48, 20)
    want = np.asarray(jr.dedup_ids(jnp.asarray(ids), min_votes))
    got = tr.dedup_ids(torch.as_tensor(ids), min_votes).numpy()
    np.testing.assert_array_equal(got, want)


def _check_top_k(dt, it, dj, ij, d_of_id, dedup):
    """Distances equal; ids equal where the distance is held by one id of
    the row's candidates, else ids of that distance (and distinct with
    ``dedup``)."""
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(it < 0, ij < 0)
    for r in range(dt.shape[0]):
        for c in range(dt.shape[1]):
            if it[r, c] < 0:
                continue
            holders = np.flatnonzero(d_of_id[r] == dt[r, c])
            if len(holders) == 1:
                assert it[r, c] == ij[r, c]
            else:
                assert it[r, c] in holders and ij[r, c] in holders
        live = it[r][it[r] >= 0]
        if dedup:
            assert len(set(live.tolist())) == len(live)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("min_votes", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_merge_top_k_matches(dedup, min_votes, k):
    """Copies of an id carry one distance, as on exact layouts; distances
    are quarter-integers, so distinct ids tie often; +inf at padding."""
    b, m, hi = 60, 48, 24
    ids = _ids(2, b, m, hi)
    rng = np.random.default_rng(3)
    d_of_id = (rng.integers(0, 12, size=(b, hi)) / 4).astype(np.float32)
    d = np.take_along_axis(d_of_id, np.maximum(ids, 0), axis=1)
    d = np.where(ids < 0, np.inf, d).astype(np.float32)
    dj, ij = jr.merge_top_k(jnp.asarray(d), jnp.asarray(ids), k, dedup=dedup,
                            min_votes=min_votes)
    dt, it = tr.merge_top_k(torch.as_tensor(d), torch.as_tensor(ids), k,
                            dedup=dedup, min_votes=min_votes)
    assert it.dtype == torch.int32 and dt.shape == (b, min(k, m))
    _check_top_k(dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij),
                 d_of_id, dedup)


def _tail_inputs(seed, b=48, p=6, g=30, lmax=16, n=150):
    """Leaf blocks holding ids with copies across blocks (the same point in
    several trees) and empty slots; per-(query, id) distances drawn
    continuous, so only copies of one id tie; masked probes are +inf."""
    rng = np.random.default_rng(seed)
    id_leaf = rng.integers(0, n, size=(g, lmax)).astype(np.int32)
    id_leaf[:, -3:] = -1
    rows_sel = rng.integers(0, g, size=(b, p)).astype(np.int32)
    d_of_id = rng.uniform(0.5, 4.0, size=(b, n)).astype(np.float32)
    ids = id_leaf[rows_sel].reshape(b, p * lmax)
    d = np.take_along_axis(d_of_id, np.maximum(ids, 0), axis=1)
    masked = np.repeat(rng.uniform(size=(b, p)) < 0.2, lmax, axis=1)
    d = np.where((ids < 0) | masked, np.inf, d).astype(np.float32)
    return d, id_leaf, rows_sel


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("min_votes", [1, 2])
@pytest.mark.parametrize("selection", ["sort", "kernel"])
def test_selection_tail_matches(dedup, min_votes, selection):
    """The JAX tail on the CPU takes the sort branch for both selections
    at ``min_votes=2`` (vote counting needs the full lists), and the port
    must too; the port's kernel branch is held against the JAX sort tail,
    whose results it shares on exact layouts."""
    d, id_leaf, rows_sel = _tail_inputs(4)
    k, kk = 10, 40 if dedup else 10
    jsel = "sort" if min_votes == 1 else selection
    dj, ij = jf._selection_tail(jnp.asarray(d), jnp.asarray(id_leaf),
                                jnp.asarray(rows_sel), k, kk, dedup,
                                min_votes=min_votes, selection=jsel)
    dt, it = tf._selection_tail(torch.as_tensor(d), torch.as_tensor(id_leaf),
                                torch.as_tensor(rows_sel), k, kk, dedup,
                                min_votes=min_votes, selection=selection)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it.numpy() >= 0).sum() > 0


def test_selection_tail_kk_covers_the_width():
    """``kk`` past the candidate width is clipped, and ``min_votes > 1``
    reads the whole width however small ``kk`` is."""
    d, id_leaf, rows_sel = _tail_inputs(5, b=20, p=3)
    for kk, mv in ((10_000, 1), (1, 2)):
        dj, ij = jf._selection_tail(jnp.asarray(d), jnp.asarray(id_leaf),
                                    jnp.asarray(rows_sel), 10, kk, True,
                                    min_votes=mv)
        dt, it = tf._selection_tail(torch.as_tensor(d),
                                    torch.as_tensor(id_leaf),
                                    torch.as_tensor(rows_sel), 10, kk, True,
                                    min_votes=mv)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
