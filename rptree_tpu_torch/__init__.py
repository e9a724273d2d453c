"""rptree_tpu_torch: the RP-forest ANN engine on PyTorch and CUDA.

The port of the JAX package ``rptree_tpu`` to an NVIDIA H100, one slice at
a time; ``rptree_tpu`` stays the reference it is tested against.  It
covers build (:func:`forest_batch`, :func:`tree_batch`, with payloads),
pack (:meth:`RPForest.pack_leaves`), the grouped, per-pair and unpacked
query paths (:meth:`RPForest.knn_grouped`, :meth:`RPForest.knn`,
:meth:`RPForest.knn_batched`, the reference's ``knnPQ`` and ``knnH``),
candidates, recall and the accessors, the exact scan
(:meth:`RPForest.brute_force_knn`), online updates
(:meth:`RPForest.add`, ``remove``, ``fold``, ``rebuild``,
``drop_dataset``), and loading a forest the JAX package saved
(:func:`load_forest`, :func:`forest_from_numpy`), on dense rows and on
sparse ones (:class:`EllMatrix`, from :func:`ell_from_svecs` or
:func:`ell_from_scipy_like`), with dense, :class:`SVec` or ``EllMatrix``
queries.  Entry points build on the card unless the caller passes
``device="cpu"``.

Modules keep the JAX package's names.  The CUDA kernels (``csrc/``) are
compiled with nvcc on first use; on CPU tensors their plain torch versions
run instead.  This package never imports JAX.
"""

from .config import (ForestConfig, RPTreeConfig, rp_tree_cfg,
                     rp_tree_cfg_clustered)
from .models.forest import RPForest, forest_batch, tree_batch
from .models.plan import TreePlan, make_plan
from .ops.sparse import EllMatrix, ell_from_scipy_like, ell_from_svecs
from .ops.vector import SVec, to_dense
from .utils.gen import sample_projections
from .utils.io import forest_from_numpy, load_forest

__all__ = [
    "EllMatrix",
    "ForestConfig",
    "RPForest",
    "RPTreeConfig",
    "SVec",
    "TreePlan",
    "ell_from_scipy_like",
    "ell_from_svecs",
    "forest_batch",
    "forest_from_numpy",
    "load_forest",
    "make_plan",
    "rp_tree_cfg",
    "rp_tree_cfg_clustered",
    "sample_projections",
    "to_dense",
    "tree_batch",
]
