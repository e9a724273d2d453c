"""The per-pair query surfaces of the port on the other dense layouts
(centered int8, sub-blocks, shared rows) against the JAX package on the
same forest and layout: ``knn``, ``knn_batched`` and ``knn_h``
(``tests/test_torch_layouts_grouped.py`` holds ``knn_grouped``).  Each
is held by ``knn_agree`` at the tolerance stated beside the layout (1e-5
relative: the same candidates summed in other orders; centered int8
adds the block means' and ``mudr``'s float order, which part the two
packages by a few ulps of the norms)."""

import pytest

from torch_parity import LAYOUTS, carry, clustered, jax_forest, knn_agree
from torch_parity import one_torch_thread, pack_twins  # noqa: F401

K = 10
SERVE = dict(budget=2)
# (layout, knn_agree tolerance)
SERVED = {"f32_sub4_kmeans": 1e-5, "bf16_sub2": 1e-5, "int8_sub4": 1e-5,
          "int8_centered": 1e-4, "int8_centered_sub8": 1e-4,
          "shared_f32": 1e-5, "shared_bf16": 1e-5}


@pytest.fixture(scope="module")
def twins():
    x, q = clustered(23, 2048, 16, 24, 0.3, 40)
    fj = jax_forest(x, seed=7, n_trees=4, min_leaf=32)
    return fj, carry(fj), q


@pytest.fixture(scope="module")
def served(twins):
    """The JAX package's results on each layout, computed once."""
    fj, ft, q = twins
    out = {}
    for name in SERVED:
        pack_twins(fj, ft, LAYOUTS[name])
        out[name] = {
            "knn": fj.knn(q, K, **SERVE),
            "knn_batched": fj.knn_batched(q, K, chunk=16,
                                          precision="default", **SERVE),
            "knn_h": fj.knn_h(q, K, **SERVE),
        }
    return out


def _port(twins, name):
    fj, ft, q = twins
    pack_twins(fj, ft, LAYOUTS[name])
    return ft, q


@pytest.mark.parametrize("surface", ["knn", "knn_batched", "knn_h"])
@pytest.mark.parametrize("name", list(SERVED))
def test_per_pair(twins, served, name, surface):
    ft, q = _port(twins, name)
    calls = {"knn": lambda: ft.knn(q, K, **SERVE),
             "knn_batched": lambda: ft.knn_batched(
                 q, K, chunk=16, precision="default", **SERVE),
             "knn_h": lambda: ft.knn_h(q, K, **SERVE)}
    knn_agree(calls[surface](), served[name][surface], rtol=SERVED[name])
