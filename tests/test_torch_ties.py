"""Data-point queries on a carried JAX forest: where the port's query
projections may part from the JAX package's (ROADMAP.md, "Deliberate
differences", projection near-ties).

Both packages project in IEEE fp32, but the port cannot follow XLA's
order of summation, so a projection may differ in its last bits.  That
moves no leaf unless the projection lies within those bits of a
threshold, of the midpoint of a node's margins, or of a priority it is
compared with.  A query that is a dataset row meets such ties: the
thresholds and margins are projections of dataset rows.  So:

- on queries that are dataset rows plus noise, every tree's candidates
  equal the JAX package's, at budget 1 and 8;
- on the dataset rows themselves, the port's descent over the JAX
  package's projections gives its leaves exactly, and a (tree, query)
  pair takes another leaf only where one level's projection, moved alone
  from JAX's bits to the port's, moves that pair's leaf: a decision at
  that level flips on the last bits.  The test reports the share of such
  pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rptree_tpu.models.forest import _traverse_forest as jax_traverse_forest
from rptree_tpu_torch.ops import traverse as ttv

from torch_parity import carry, jax_forest, one_torch_thread  # noqa: F401

N, DIM, B = 6000, 32, 1000


@pytest.fixture(scope="module")
def twins():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    fj = jax_forest(x, seed=7, n_trees=4, min_leaf=32)
    rows = x[rng.choice(N, B, replace=False)]
    noisy = (rows + 0.01 * rng.normal(size=rows.shape)).astype(np.float32)
    return fj, carry(fj), rows, noisy


@pytest.mark.parametrize("budget", [1, 8])
def test_noisy_queries_take_jax_candidates(twins, budget):
    fj, ft, _, noisy = twins
    np.testing.assert_array_equal(ft.candidates(noisy, budget=budget).numpy(),
                                  np.asarray(fj.candidates(noisy,
                                                           budget=budget)))


def _jax_projections(fj, q):
    """The JAX package's query projections, ``f32[T, L, B]``, as its
    traversal forms them."""
    r = fj.arrays.r[:, :fj.plan.n_levels, :]
    p = jnp.einsum("bd,tld->tbl", jnp.asarray(q), r,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return torch.as_tensor(np.asarray(p)).permute(0, 2, 1).contiguous()


def test_data_point_queries_differ_only_at_projection_ties(twins,
                                                           record_property):
    fj, ft, rows, _ = twins
    plan, table = ft.plan, ft._table()
    pj = _jax_projections(fj, rows)
    pt = ttv.project_queries(torch.as_tensor(rows), ft.arrays.r,
                             plan.n_levels)
    # the same fp32 sums in another order: within their error bound
    terms = np.abs(np.einsum("bd,tld->tlbd", rows.astype(np.float64),
                             np.asarray(ft.arrays.r[:, :plan.n_levels],
                                        np.float64))).sum(-1)
    assert (np.abs((pt - pj).numpy()) <= DIM * 2.0 ** -24 * terms).all()

    def leaves(projq):
        return ttv.traverse_tree_reference(plan, table, projq, 1)[0][..., 0]

    want = torch.as_tensor(np.asarray(jax_traverse_forest(
        fj.plan, fj.arrays, jnp.asarray(rows), 1)[0]))[..., 0]
    assert torch.equal(leaves(pj), want)       # the descent itself agrees
    got = leaves(pt)
    differ = got != want                                  # [T, B]
    # each level's projection alone moved to the port's bits
    flips = torch.zeros_like(differ)
    for lvl in range(plan.n_levels):
        mixed = pj.clone()
        mixed[:, lvl] = pt[:, lvl]
        flips |= leaves(mixed) != want
    share = float(differ.float().mean())
    record_property("pairs_differing", int(differ.sum()))
    record_property("pairs_share", share)
    print(f"data-point queries: {int(differ.sum())} of {differ.numel()} "
          f"(tree, query) pairs take another leaf ({share:.4%}); "
          f"{int(flips.sum())} pairs flip on one level's last bits")
    assert not (differ & ~flips).any()
    assert share < 0.05
    # the candidates follow the leaves: equal wherever the leaf is
    cand_t = ft.candidates(rows, budget=1).numpy()
    cand_j = np.asarray(fj.candidates(rows, budget=1))
    same = ~differ.numpy()
    np.testing.assert_array_equal(cand_t[same], cand_j[same])
