"""The port's grouped serving path with the sort tail (its default
selection) and the fused tile top-k (``impl="kernel_topk"``), on f32 and
bf16 blocks, against the JAX package's ``knn_grouped`` on the same forest
and queries.

On the CPU the JAX package scores with its XLA grouped scorer, which
rounds query rows to bf16 against bf16 blocks as the tile kernels do;
``test_kernel_topk_matches_jax_branch`` runs the JAX package's own
``kernel_topk`` branch, its Pallas kernel in interpret mode."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rptree_tpu.models.forest as jf
import rptree_tpu.ops.grouped_kernel as jk
from rptree_tpu_torch.models import forest as tf

from torch_parity import carry, clustered, jax_forest, one_torch_thread  # noqa: F401

K = 10
SERVE = dict(budget=2, probes=6, tile_m=8)
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the same criteria as the f32 kernel-tail slice (test_torch_slice.py):
# rows set-equal on >= 99% of queries, and there distances within f32
# contraction-order noise (bf16 blocks: exact products, f32 sums on both
# sides, so the same bound holds)
MIN_SAME_ROWS = 0.99
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def data():
    x, q = clustered(8, 4096, 32, 40, 0.5, 256)
    fj = jax_forest(x, seed=12, n_trees=4, min_leaf=32)
    return q, fj, carry(fj), {}


def _jax_result(data, dtype, dedup, min_votes, chunk):
    """JAX's answer, once per layout and tail setting (both port impls are
    held against it)."""
    q, fj, _, cache = data
    key = (dtype, dedup, min_votes, chunk)
    if key not in cache:
        fj.pack_leaves(dtype=DTYPES[dtype][0])
        d, i = fj.knn_grouped(q, K, dedup=dedup, min_votes=min_votes,
                              selection="sort", chunk=chunk, **SERVE)
        cache[key] = (np.asarray(d), np.asarray(i))
    return cache[key]


def _assert_matches(dt, it, dj, ij):
    assert it.shape == (dj.shape[0], K) and dt.dtype == np.float32
    same = np.array([set(r) == set(s)
                     for r, s in zip(it.tolist(), ij.tolist())])
    assert same.mean() >= MIN_SAME_ROWS, same.mean()
    np.testing.assert_allclose(dt[same], dj[same], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["kernel", "kernel_topk"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("min_votes,dedup,chunk", [
    (1, True, None), (1, False, 100), (2, True, 100), (2, False, None),
])
def test_sort_tail_matches(data, monkeypatch, impl, dtype, min_votes, dedup,
                           chunk):
    dj, ij = _jax_result(data, dtype, dedup, min_votes, chunk)
    q, _, ft, _ = data
    ft.pack_leaves(dtype=DTYPES[dtype][1])
    calls, real = [], tf.grouped_topk_kernel

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tf, "grouped_topk_kernel", spy)
    dt, it = ft.knn_grouped(q, K, dedup=dedup, min_votes=min_votes,
                            impl=impl, chunk=chunk, **SERVE)
    # the fused kernel serves kernel_topk without vote counting only
    assert bool(calls) == (impl == "kernel_topk" and min_votes == 1)
    _assert_matches(dt.numpy(), it.numpy(), dj, ij)
    if min_votes == 1 and dedup:
        assert (it.numpy() >= 0).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_topk_matches_jax_branch(data, monkeypatch, dtype):
    """The JAX package's ``kernel_topk`` branch itself: its gate forced
    open (it admits only a TPU backend) and its kernel in interpret mode.
    ``impl`` is a static argument of its ``_knn_grouped``, so this traces
    a program of its own."""
    traced = []
    kernel = functools.partial(jk.grouped_score_topk, interpret=True)

    def interpreted(*args, **kw):
        traced.append(1)
        return kernel(*args, **kw)

    monkeypatch.setattr(jf, "_grouped_use_kernel", lambda *a, **k: True)
    monkeypatch.setattr(jk, "grouped_score_topk", interpreted)
    q, fj, ft, _ = data
    q = q[:96]
    fj.pack_leaves(dtype=DTYPES[dtype][0])
    ft.pack_leaves(dtype=DTYPES[dtype][1])
    dj, ij = fj.knn_grouped(q, K, impl="kernel_topk", tile_chunk=64, **SERVE)
    assert traced, "the JAX package did not take its kernel_topk branch"
    assert ft._packed[0].shape[1] >= 32  # 2 * kp: the port's branch too
    dt, it = ft.knn_grouped(q, K, impl="kernel_topk", tile_chunk=64, **SERVE)
    _assert_matches(dt.numpy(), it.numpy(), np.asarray(dj), np.asarray(ij))
