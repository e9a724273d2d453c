"""Device timing and named profiler regions (``rptree_tpu/utils/profiling.py``).

:func:`device_time` gives the marginal seconds a call of a step costs:
one warm-up call, then one call and ``reps`` back-to-back calls timed by
CUDA events on the current stream (by the host clock on CPU tensors), and
``(t_reps - t_1) / (reps - 1)``, which leaves out the fixed launch and
synchronisation costs that one timed call carries.

**Named profiler regions.**  The reference marks its four hot functions
with GHC cost centers -- ``{-# SCC candidates #-}``
(``src/Data/RPTree.hs:289``), ``{-# SCC insertMulti #-}`` / ``{-# SCC
insert #-}`` (``src/Data/RPTree/Internal.hs:244,257``) and ``{-# SCC
partitionAtMedian #-}`` (``Internal.hs:484``) -- so ``+RTS -p`` profiles
attribute time to them.  The port names the same stages as the JAX
package's ``jax.named_scope`` regions, by :func:`region`, a
``torch.profiler.record_function`` range that reaches a profiler trace
with the kernels launched inside it:

=============================  ============================================
scope                          covers (reference analogue)
=============================  ============================================
``rpt_candidates``             forest descent + probe selection, kernels 7
                               and 8 (SCC candidates)
``rpt_insert``                 fold()'s placement descent and writes (SCC
                               insert/insertMulti)
``rpt_partition_at_median``    the build's level split (SCC
                               partitionAtMedian)
``rpt_project``                build-time projections, kernel 11 (inside
                               partitionAtMedian)
``rpt_rerank``                 per-pair block fetch + exact distances,
                               kernels 6 and 10, and their tail
``rpt_tile_tables``            grouped pair sort + tile assignment, kernel 9
``rpt_grouped_score``          grouped query-row gather + tile scoring,
                               kernels 1, 2, 4 and 10, or the XLA form
``rpt_pair_reorder``           grouped inverse-permutation row reorder
``rpt_topk_tail``              candidate selection tail (sort / kernel 3)
=============================  ============================================

A region costs one check of the profiler's state when no profiler is
running: :func:`region` then returns a shared no-op context and enters no
``record_function`` (whose enter and exit cost microseconds a call on
every query chunk).

:func:`trace` wraps ``torch.profiler`` so a stage decomposition needs no
throwaway script::

    import rptree_tpu_torch as rt
    f = rt.forest_batch(...).pack_leaves()
    with rt.profiling.trace("rpt_trace"):
        d, i = f.knn_grouped(q, 10)
        rt.profiling.sync(d)

then open the Chrome trace it writes (``rpt_trace/*.json``) in Perfetto
or ``chrome://tracing`` and group the kernels by the ``rpt_*`` ranges.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch

__all__ = ["device_time", "trace", "sync", "region", "SCOPES"]


def _is_float_array(a) -> bool:
    if torch.is_tensor(a):
        return a.is_floating_point()
    return isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.floating)


def device_time(step: Callable, *args, reps: int = 20) -> float:
    """Marginal seconds per call of ``step(*args)``: one warm-up call, then
    one call and ``reps`` back-to-back calls, each timed by CUDA events on
    the current stream where an argument is a CUDA tensor (by the host
    clock otherwise); returns ``max(0, (t_reps - t_1) / (reps - 1))``.  At
    least one argument must be a floating-point array, as in the JAX
    package (which chains its iterations through it; the port needs no
    chain: the calls run in stream order)."""
    if not any(_is_float_array(a) for a in args):
        raise ValueError("device_time needs at least one floating-point "
                         "array argument to chain iterations through")
    dev = next((a.device for a in args if torch.is_tensor(a) and a.is_cuda),
               None)

    def timed(n: int) -> float:
        if dev is None:
            t0 = time.perf_counter()
            for _ in range(n):
                step(*args)
            return time.perf_counter() - t0
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                step(*args)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3

    step(*args)  # warm-up: kernel builds, caches, allocator
    t1, tn = timed(1), timed(reps)
    return max(0.0, (tn - t1) / (reps - 1))


# ---------------------------------------------------------------------------
# Named profiler regions + trace capture (see module docstring)
# ---------------------------------------------------------------------------


#: The named regions the library emits (see module docstring).
SCOPES = (
    "rpt_candidates",
    "rpt_insert",
    "rpt_partition_at_median",
    "rpt_project",
    "rpt_rerank",
    "rpt_tile_tables",
    "rpt_grouped_score",
    "rpt_pair_reorder",
    "rpt_topk_tail",
)

_NO_REGION = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def region(name: str):
    """A profiler range named ``name`` (``torch.profiler.record_function``)
    while a profiler is running, else a shared no-op context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_REGION


def sync(*arrays) -> None:
    """Wait for the device work that produces ``arrays``, so the trace
    window holds the real execution: ``torch.cuda.synchronize`` on each
    CUDA tensor's device; CPU tensors and other values need nothing."""
    for a in arrays:
        if torch.is_tensor(a) and a.is_cuda:
            torch.cuda.synchronize(a.device)


@contextlib.contextmanager
def trace(logdir: str, host: bool = False) -> Iterator[torch.profiler.profile]:
    """Profile the block body and write a Chrome trace
    (``logdir/rpt_trace_<pid>_<ns>.json``) when it ends.  Kernels land
    under the ``rpt_*`` regions above -- the SCC-style stage decomposition.
    CPU activity is always recorded, CUDA activity where a card is present.
    Yields the ``torch.profiler.profile``, whose ``key_averages()`` sum each
    region's device time.

    ``host=True`` also records the Python stacks (``with_stack=True``), the
    counterpart of the JAX package's host-side Python tracer.  Remember to
    :func:`sync` the outputs INSIDE the block; otherwise the trace window
    closes before the device work runs."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts, with_stack=host)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"rpt_trace_{os.getpid()}_{time.time_ns()}.json"))
