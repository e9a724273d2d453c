"""rptree_tpu_torch: the RP-forest ANN engine on PyTorch and CUDA.

The port of the JAX package ``rptree_tpu`` to an NVIDIA H100, one slice at
a time; ``rptree_tpu`` stays the reference it is tested against.  The
public facade mirrors the JAX package's (and the reference's single
exposed module ``Data.RPTree``, ``src/Data/RPTree.hs:50-113``):

Construction (batch):    :func:`tree_batch`, :func:`forest_batch`
Construction (stream):   :func:`tree`, :func:`forest`, :class:`ForestBuilder`
Parameters:              :func:`rp_tree_cfg`, :class:`RPTreeConfig`
Queries:                 :meth:`RPForest.knn`, ``knn_h``, ``knn_pq``,
                         ``knn_batched``, ``knn_grouped``, and the
                         function-first :func:`knn`, :func:`knn_h`, ...
Tuning:                  :func:`tune`, :func:`tune_build`
I/O:                     :func:`save_forest`, :func:`load_forest`,
                         :func:`serialise_rp_forest`,
                         :func:`deserialise_rp_forest`,
                         :func:`save_forest_sharded`,
                         :func:`load_forest_sharded`
Statistics:              :meth:`RPForest.recall_with`
Access:                  ``leaves``, ``levels``, ``points``, ``candidates``
Validation:              ``tree_stats``, ``tree_size``, ``leaf_sizes``
Vector types:            :class:`SVec` (sparse), dense = ndarray;
                         batched sparse datasets: :class:`EllMatrix`
Vector ops (``Inner``):  :func:`inner`, :func:`metric_l2`, ...
Rendering:               :func:`write_csv`, :func:`knn_write_csv`,
                         :func:`write_dot`, :func:`draw`
Testing / generation:    :class:`BenchConfig`, :func:`rand_seed`,
                         :func:`data_batch`, :func:`data_source`, samplers
Profiling / ingest:      :mod:`profiling` (named ``rpt_*`` regions,
                         ``trace``, ``sync``), :func:`device_time`,
                         :mod:`ingest` (fvecs / bvecs / ivecs / idx)

The forest packs (:meth:`RPForest.pack_leaves`), serves on the grouped,
per-pair and unpacked paths and by the exact scan
(:meth:`RPForest.brute_force_knn`), and takes online updates
(:meth:`RPForest.add`, ``remove``, ``fold``, ``rebuild``,
``drop_dataset``), on dense rows and on sparse ones.  Entry points build
on the card unless the caller passes ``device="cpu"``.

Modules keep the JAX package's names.  The CUDA kernels (``csrc/``) are
compiled with nvcc on first use; on CPU tensors their plain torch versions
run instead.  The tree- and query-sharded forests and the data-parallel
ones (the dataset sharded over points) are :mod:`rptree_tpu_torch.parallel`
(one process over a mesh of devices, or the processes of a
``torch.distributed`` group).  This package never imports JAX.
"""

from .config import (BenchConfig, ForestConfig, RPTreeConfig, rp_tree_cfg,
                     rp_tree_cfg_clustered)
from .models.forest import RPForest, forest_batch, tree_batch
from .models.plan import TreePlan, make_plan
from .ops.sparse import (EllMatrix, ell_from_scipy_like, ell_from_svecs,
                         ell_project, ell_sq_norms, ell_to_dense)
from .ops.vector import (SVec, add, from_list_dv, from_list_sv,
                         from_vector_sv, inner, inner_dd, inner_sd, inner_ss,
                         metric_dd_l2, metric_l2, metric_sd_l2, metric_ss_l2,
                         normalize, scale, sub, to_dense)
from .streaming import ForestBuilder, forest, tree
from .tuning import tune, tune_build
from .utils import ingest  # fvecs/bvecs/ivecs/idx readers + chunk sources
from .utils import profiling  # named rpt_* regions + trace()/sync() helpers
from .utils.draw import (draw, knn_write_csv, leaf_label_of_points, to_dot,
                         tree_to_string, write_csv, write_dot)
from .utils.gen import (circle2d, circle2d2, data_batch, data_source, dense,
                        mixture, mixture2, normal2, normal_dense2,
                        normal_sparse2, rand_seed, sample_projections,
                        sample_wor, sparse)
from .utils.io import (deserialise_rp_forest, forest_from_numpy, load_forest,
                       load_forest_sharded, save_forest, save_forest_sharded,
                       serialise_rp_forest)
from .utils.median import StreamingMedian
from .utils.profiling import device_time
from .version import __version__


# Function-first query API (the reference's ``knn distf k forest q`` calling
# convention, pythonified as ``knn(forest, q, k, ...)``).

def knn(forest_, q, k, **kw):
    """k nearest neighbours (reference ``knn``, RPTree.hs:159-176)."""
    return forest_.knn(q, k, **kw)


def knn_h(forest_, q, k, **kw):
    """Margin-priority kNN (reference ``knnH``, RPTree.hs:196-217)."""
    return forest_.knn_h(q, k, **kw)


def knn_pq(forest_, q, k, **kw):
    """Deduplicating kNN (reference ``knnPQ``, RPTree.hs:178-194)."""
    return forest_.knn_pq(q, k, **kw)


def knn_h_buckets(forest_, q, k, **kw):
    """Raw (unsorted, untruncated) knnH bucket contents -- the reference
    ``knnH``'s return contract (RPTree.hs:196-217)."""
    return forest_.knn_h_buckets(q, k, **kw)


def candidates(forest_, q, **kw):
    """Candidate point ids per tree (reference ``candidates``)."""
    return forest_.candidates(q, **kw)


def recall_with(forest_, q, k, **kw):
    """Mean per-tree recall@k (reference ``recallWith``)."""
    return forest_.recall_with(q, k, **kw)


def tree_size(forest_, t: int = 0):
    """Points stored in a tree (reference ``treeSize``)."""
    return forest_.tree_size(t)


def leaf_sizes(forest_):
    """Per-leaf occupancy (reference ``leafSizes``)."""
    return forest_.leaf_sizes()


def tree_stats(forest_):
    """Node counts (reference ``treeStats``)."""
    return forest_.tree_stats()


def leaves(forest_, t: int = 0):
    """Leaf buckets as point-id lists (reference ``leaves``)."""
    return forest_.leaves(t)


def levels(forest_):
    """Number of projection levels (reference ``levels``)."""
    return forest_.levels()


def points(forest_):
    """The indexed dataset (reference ``points``)."""
    return forest_.points()


__all__ = [name for name in dir() if not name.startswith("_")]
