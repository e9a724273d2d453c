"""Benchmark harness (``rptree_tpu/benchmarks.py``; the reference's
``bench/time/Main.hs``).

Reproduces the reference time benchmark's structure:

* a grid of :class:`~rptree_tpu_torch.config.BenchConfig` experiment
  descriptors (``bench/time/Main.hs:42-50`` -- the shipped grid is a single
  point);
* per config: build a forest over a binary sparse-Gaussian-mixture stream
  (``binMixFQBench``, ``bench/time/Main.hs:54-84`` over ``datS``,
  ``Internal/Testing.hs:38-44``), measure mean recall@10 over the query
  points, and wall-clock build/query times with a numerically stable
  running mean (the vendored benchpress-style ``benchmark`` harness,
  ``bench/time/Main.hs:175-230``);
* results printed as one dict per config (the reference ``print``s to
  stdout, ``bench/time/Main.hs:60-62``).

Beside the reference: batched-query QPS (the reference queries one point
at a time).  Every timed call is bracketed by ``torch.cuda.synchronize()``
on the card.  The data come from the port's generators on the forest's
device (``torch.Generator``: JAX's distributions, not its bits).  The
config's mesh fields (``n_tree_shards``, ``n_query_shards``) or a
``mesh`` shard the forest (:func:`..parallel.distribute`) before it is
packed and served.

Run: ``python -m rptree_tpu_torch.benchmarks [--reference-scale]`` (on
the card).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ._cuda import resolve_device
from .config import BenchConfig
from .models.forest import RPForest, forest_batch
from .utils import gen as rgen

__all__ = ["benchmark", "run_bench", "bench_grid", "DEFAULT_GRID",
           "REFERENCE_SCALE_GRID", "dense_to_ell"]

def benchmark(fn: Callable[[], object], reps: int = 2) -> Tuple[float, object]:
    """Mean wall seconds of ``fn`` over ``reps`` runs, running-mean
    accumulation (reference ``benchmark``/``mean``,
    ``bench/time/Main.hs:175-230``; wall clock instead of ``getCPUTime``
    because device work is asynchronous to the host CPU: ``fn`` must
    synchronise before it returns)."""
    mean = 0.0
    out = None
    for i in range(1, reps + 1):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        mean += (dt - mean) / i
    return mean, out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dense_to_ell(x):
    """Pack a dense array's nonzeros into a padded-ELL sparse dataset on
    its device (a numpy array: the CPU): each row's nonzero columns in
    ascending order, then ``(col 0, 0.0)`` padding to the widest row."""
    from .ops.sparse import EllMatrix

    x = torch.as_tensor(x)
    n, dim = x.shape
    nz = x != 0
    k = max(1, int(nz.sum(1).max())) if n else 1
    col = torch.arange(dim, device=x.device)
    # the nonzero columns first, ascending, then the zero ones
    order = torch.sort(torch.where(nz, col, col + dim), dim=1).indices[:, :k]
    keep = nz.gather(1, order)
    cols = torch.where(keep, order, 0).to(torch.int32)
    vals = torch.where(keep, x.gather(1, order), 0.0).to(torch.float32)
    return EllMatrix(dim, cols, vals)


def run_bench(cfg: BenchConfig, seed: int = 1234,
              data_nz: Optional[float] = None,
              reps: int = 2, mesh=None, *, device=None) -> dict:
    """Run one experiment on ``device`` (default: the card): build +
    recall@10 + QPS (``binMixFQBench``, bench/time/Main.hs:54-84).
    ``data_nz`` is the data's nonzero density (the reference grid uses
    0.8).  ``cfg.sparse_input`` routes the dataset through the padded-ELL
    path (SVector semantics); ``cfg.streaming`` builds through the
    chunked-ingest pipeline.  With ``mesh`` (a
    :func:`..parallel.forest_mesh`) or shard counts in the config the
    forest is distributed over the mesh (by default ``forest_mesh(
    n_tree_shards, n_query_shards)`` over the visible cards, or over
    ``device`` repeated where one is named) before it is packed.  As in the
    JAX package, whose ``run_bench`` distributes over the tree axis, any
    other mesh (a data mesh among them) raises."""
    from .parallel.distributed import distribute
    from .parallel.mesh import TREE_AXIS, ForestMesh, forest_mesh

    if mesh is not None and not (isinstance(mesh, ForestMesh)
                                 and TREE_AXIS in mesh.shape):
        raise ValueError("run_bench shards over a forest_mesh (the tree "
                         "axis), as the JAX package's does; build a "
                         "data-parallel forest with "
                         "forest_batch_data_parallel")
    dev = resolve_device(device)
    n_shards = cfg.n_tree_shards * cfg.n_query_shards
    if mesh is None and n_shards > 1:
        mesh = forest_mesh(cfg.n_tree_shards, cfg.n_query_shards,
                           devices=None if device is None
                           else [dev] * n_shards)
    if data_nz is None:
        data_nz = cfg.data_nz
    gen = lambda key, n: rgen.normal_sparse2(  # noqa: E731
        key, n, cfg.vector_dim, data_nz
    )
    x = rgen.data_batch(seed, cfg.data_size, gen, device=dev).float()
    q = rgen.data_batch(seed + 1, cfg.num_query_points, gen,
                        device=dev).float()
    data = dense_to_ell(x) if cfg.sparse_input else x

    def build() -> RPForest:
        if cfg.streaming:
            from .streaming import forest as forest_stream

            chunks = iter(torch.tensor_split(
                x, max(1, cfg.data_size // cfg.chunk_size)))
            f = forest_stream(seed, cfg.max_depth, cfg.min_leaf,
                              cfg.num_trees, cfg.chunk_size, cfg.nz_density,
                              cfg.vector_dim, chunks, device=dev)
        else:
            f = forest_batch(seed, cfg.max_depth, cfg.min_leaf,
                             cfg.num_trees, cfg.nz_density, data, device=dev)
        if mesh is not None:
            f = distribute(f, mesh)
        f.pack_leaves()  # serving layout (dense blocks, or EllBlocks for
        #                  sparse bag-of-words datasets)
        _sync(dev)
        return f

    _sync(dev)
    t_build, f = benchmark(build, reps=1)

    k = 10

    def queries():
        out = []
        for s in range(0, cfg.num_query_points, cfg.batch_size):
            out.append(f.knn(q[s:s + cfg.batch_size], k))
        _sync(dev)
        return out

    queries()  # warm: kernel builds, caches
    t_query, outs = benchmark(queries, reps=reps)

    recall = float(f.recall_with(q, k).float().mean())
    # forest-level recall of the returned neighbours (the per-tree
    # recallWith above mirrors the reference's metric, RPTree.hs:259-268,
    # and is tiny by construction at deep configs)
    got = torch.cat([i for _, i in outs]).cpu().numpy()
    exact = f.brute_force_knn(q, k)[1].cpu().numpy()
    recall_forest = float(np.mean([
        len(set(got[b].tolist()) & set(exact[b].tolist())) / k
        for b in range(got.shape[0])
    ]))
    return {
        "description": cfg.description,
        "recall_at_10": round(recall_forest, 4),
        "recall_per_tree": round(recall, 4),
        "build_s": round(t_build, 4),
        "query_s": round(t_query, 4),
        "qps": round(cfg.num_query_points / t_query, 1),
        "config": cfg,
    }


# the reference's shipped grid: one point (bench/time/Main.hs:42-50)
DEFAULT_GRID: List[BenchConfig] = [
    BenchConfig(
        description="binary sparse-Gaussian mixture",
        max_depth=5, min_leaf=10, num_trees=3, chunk_size=100,
        nz_density=0.2, vector_dim=1000, data_size=1000,
        num_query_points=10, batch_size=10,
    ),
]

# BASELINE.json configs[], scaled to bench-friendly sizes (the JAX
# package's grid, unchanged)
REFERENCE_SCALE_GRID: List[BenchConfig] = [
    BenchConfig(description="configs[0] single tree, 784-d, knn k=10",
                max_depth=9, min_leaf=20, num_trees=1, chunk_size=1000,
                nz_density=0.35, vector_dim=784, data_size=10_000,
                num_query_points=128, batch_size=128),
    BenchConfig(description="configs[1] 10-tree forest recall@10",
                max_depth=9, min_leaf=20, num_trees=10, chunk_size=1000,
                nz_density=0.35, vector_dim=784, data_size=10_000,
                num_query_points=128, batch_size=128),
    BenchConfig(description="configs[2] sparse bag-of-words (padded ELL)",
                max_depth=8, min_leaf=32, num_trees=4, chunk_size=1000,
                nz_density=0.25, vector_dim=10_000, data_size=8_000,
                num_query_points=64, batch_size=64, sparse_input=True,
                data_nz=0.01),
    BenchConfig(description="configs[3] SIFT-shaped dense forest",
                max_depth=11, min_leaf=64, num_trees=8, chunk_size=1000,
                nz_density=0.47, vector_dim=128, data_size=100_000,
                num_query_points=512, batch_size=512),
    BenchConfig(description="configs[4] streaming chunked-ingest build",
                max_depth=9, min_leaf=32, num_trees=4, chunk_size=2_000,
                nz_density=0.35, vector_dim=960, data_size=20_000,
                num_query_points=64, batch_size=64, streaming=True),
]


def bench_grid(grid: Optional[List[BenchConfig]] = None, seed: int = 1234,
               reps: int = 2, *, device=None) -> List[dict]:
    """Run a grid of configs on ``device`` (default: the card), printing
    one result dict per line (the reference's main,
    bench/time/Main.hs:54-66)."""
    results = []
    for cfg in grid if grid is not None else DEFAULT_GRID:
        r = run_bench(cfg, seed=seed, reps=reps, device=device)
        print({k: v for k, v in r.items() if k != "config"}, flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    import sys

    if "--reference-scale" in sys.argv:
        bench_grid(REFERENCE_SCALE_GRID)
    else:
        bench_grid()
