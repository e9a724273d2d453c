"""``knn_grouped`` of the port on the other dense layouts (centered int8,
sub-blocks, shared rows) against the JAX package on the same forest and
layout, on the sort tail and the kernel tail, with ``impl="xla"`` and,
where the layout admits it, ``impl="kernel_topk"`` (centered blocks and
shared rows refuse it, as in the JAX package).

The JAX package scores the grouped path in its XLA form on the CPU and
needs a TPU for its kernel tail, so its sort tail stands for every port
variant; each is held by ``knn_agree`` at the tolerance stated beside
the layout."""

import pytest

from torch_parity import LAYOUTS, carry, clustered, jax_forest, knn_agree
from torch_parity import one_torch_thread, pack_twins  # noqa: F401

K = 10
SERVE = dict(budget=2)
# (layout, knn_agree tolerance): 1e-5 relative, the same candidates summed
# in other orders; centered int8 adds the block means' and mudr's float
# order; on shared f32 rows the grouped path is the XLA form's four fp32
# chains a row (ops/grouped.py _float_dots) against the JAX einsum's one,
# which on this cell's l2 distances (~0.5 against norms ~16) part by up to
# ~6e-5 relative, the amplification of a few ulps of the norms
SERVED = {"f32_sub4_kmeans": 1e-5, "bf16_sub2": 1e-5, "int8_sub4": 1e-5,
          "int8_centered": 1e-4, "int8_centered_sub8": 1e-4,
          "shared_f32": 1e-4, "shared_bf16": 1e-5}
PORT_GROUPED = {"sort": dict(), "kernel_tail": dict(selection="kernel"),
                "xla": dict(impl="xla"), "kernel_topk": dict(impl="kernel_topk")}


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
        out[name] = fj.knn_grouped(q, K, tile_m=8, **SERVE)
    return out


def _port(twins, name):
    fj, ft, q = twins
    pack_twins(fj, ft, LAYOUTS[name])
    return ft, q


@pytest.mark.parametrize("variant", list(PORT_GROUPED))
@pytest.mark.parametrize("name", list(SERVED))
def test_grouped(twins, served, name, variant):
    ft, q = _port(twins, name)
    kw = PORT_GROUPED[variant]
    layout = LAYOUTS[name]
    kernels = not layout.get("centered") and layout.get("store") != "shared"
    if variant == "kernel_topk" and not kernels:
        with pytest.raises(ValueError, match="impl='kernel_topk'"):
            ft.knn_grouped(q, K, tile_m=8, **kw, **SERVE)
        return
    got = ft.knn_grouped(q, K, tile_m=8, **kw, **SERVE)
    knn_agree(got, served[name], rtol=SERVED[name])
    if layout.get("sub_block", 1) > 1:  # the sub-blocks' pairs, all tiled
        assert ft.grouped_overflow()["needed"] <= ft.grouped_overflow()[
            "capacity"]
