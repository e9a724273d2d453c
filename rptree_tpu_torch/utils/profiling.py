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
``rpt_project``                projections, kernel 11: the build's
                               (inside partitionAtMedian) and the
                               queries' ahead of every descent
``rpt_rerank``                 per-pair block fetch + exact distances,
                               kernels 6 and 10, and their tail
``rpt_tile_tables``            grouped pair sort + tile assignment, kernel 9
``rpt_grouped_score``          grouped tile scoring, kernels 1, 2, 4 and
                               10 (and the query-row gather of 2 and 4),
                               or the XLA form
``rpt_pair_reorder``           grouped inverse-permutation row reorder
                               (kernels 2, 4 and 10, the XLA form)
``rpt_topk_tail``              candidate selection tail (sort / kernel 3)
=============================  ============================================

Two more ranges, :data:`ENTRIES`, are the port's own (the JAX package has
no such scope): ``rpt_knn_batched`` and ``rpt_knn_grouped`` each cover the
whole of their serving entry, so that the entry's own host code (argument
checks, padding, chunk slicing, the capacity logic, the concatenation)
carries a name.

A region costs one check of the profiler's state when no profiler is
running: :func:`region` then returns a shared no-op context and enters no
``record_function`` (whose enter and exit cost microseconds a call on
every query chunk).

**Spans and counters.**  While a profiler runs, each region also reads
the host's clock (``time.perf_counter_ns``) as it enters and leaves, and
each name adds up ``calls``, ``total_ns`` and ``self_ns`` (the total less
the regions directly inside it, such as ``rpt_topk_tail`` inside
``rpt_rerank``), so that the self times of a call's regions add up to its
entry's total.  The grouped layer counts where :func:`..ops.grouped.
tile_tables` makes a chunk's tables, at one count site
(:func:`grouped_counts`) that first checks the profiler's state:

===========================  ==============================================
counter                      adds up, over the chunks
===========================  ==============================================
``grouped.pairs``            valid (query, block) pairs
``grouped.tiles_overflow``   tiles needed past the capacity: pairs masked
                             (``check=False`` serves them as +inf)
``grouped.slots_launched``   tile slots launched, ``nt * tile_m``
``grouped.block_reads``      block stagings of kernel 1: the runs of one
                             block's tiles it scores
                             (:func:`..ops.grouped_kernel.score_runs`)
``grouped.staged_bytes``     bytes of block rows and query rows kernel 1
                             copies into shared memory
                             (:func:`..ops.grouped_kernel.staged_bytes`)
``topk.rows_one_read``       rows kernel 3 launches on its one-read route
                             (W <= 2,048: each candidate read once)
``topk.rows_swept``          rows kernel 3 launches on its wide-row route
                             (one sweep of the row a winner)
``topk.rows_second_prefix``  rows of the one-read route that took a second
                             prefix of their distance order
``topk.rows_tie_overflow``   rows of the one-read route whose prefix held
                             too many equal distances, so that their
                             passes ran over all their slots
===========================  ==============================================

``grouped.pairs``, ``grouped.tiles_overflow``, ``grouped.block_reads``,
``grouped.staged_bytes``, ``topk.rows_second_prefix`` and
``topk.rows_tie_overflow`` add into an ``int64[6]`` on their device, kernel
9 adding a chunk's first two itself on the card, kernel 1 the next two,
one atomic each a thread block (:func:`grouped_reads`), and kernel 3 the
last two, one atomic a row that takes either path (:func:`topk_paths`);
they are read back only by :func:`stats`.  The slots add on the host, and
so do kernel 3's rows by route, which its wrappers
(``ops/topk_kernel.py``) add as they launch it (:func:`topk_rows`); the
plain versions on the CPU add none of kernel 3's counters.  The numbers
cover the latest
stretch in which a profiler ran: the first region entered under a
profiler after a serving entry was called without one (:func:`entry`)
starts them from zero, as :func:`trace` does.  They assume one serving
thread.

:func:`trace` wraps ``torch.profiler`` so a stage decomposition needs no
throwaway script::

    import rptree_tpu_torch as rt
    f = rt.forest_batch(...).pack_leaves()
    with rt.profiling.trace("rpt_trace"):
        d, i = f.knn_grouped(q, 10)
        rt.profiling.sync(d)
    s = rt.profiling.stats()
    s["rpt_knn_grouped"]["self_ns"], s["grouped.tiles_overflow"]

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

__all__ = ["device_time", "trace", "sync", "region", "entry", "stats",
           "grouped_counts", "grouped_reads", "topk_rows", "topk_paths",
           "SCOPES", "ENTRIES", "COUNTERS"]


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

#: The serving entries' ranges, each over a whole call (module docstring).
ENTRIES = ("rpt_knn_batched", "rpt_knn_grouped")

#: The counters a profiled stretch adds up (module docstring).
COUNTERS = (
    "grouped.pairs",
    "grouped.tiles_overflow",
    "grouped.slots_launched",
    "grouped.block_reads",
    "grouped.staged_bytes",
    "topk.rows_one_read",
    "topk.rows_swept",
    "topk.rows_second_prefix",
    "topk.rows_tie_overflow",
)
# the counters added on their device, in the order of their int64[6]
_ON_DEVICE = ("grouped.pairs", "grouped.tiles_overflow",
              "grouped.block_reads", "grouped.staged_bytes",
              "topk.rows_second_prefix", "topk.rows_tie_overflow")

_NO_REGION = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Stretch:
    """The numbers of the latest stretch in which a profiler ran."""

    def __init__(self):
        self.spans = {}      # name -> [calls, total_ns, self_ns]
        self.slots = 0       # grouped.slots_launched
        self.topk = [0, 0]   # topk.rows_one_read, topk.rows_swept
        self.device = {}     # torch.device -> int64[6]: _ON_DEVICE


_stretch = _Stretch()
_stack = []          # the open spans, innermost last
# an entry was called without a profiler since the stretch began: the next
# span entered under one starts a new stretch
_stale = False


def _restart() -> None:
    global _stretch, _stale
    _stretch, _stale = _Stretch(), False


class _Span:
    """A ``record_function`` range that also adds its host time to the
    stretch's numbers (module docstring)."""

    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch.profiler.record_function(name)
        self.inner = 0       # ns of the spans directly inside

    def __enter__(self):
        if _stale:
            _restart()
        self.t0 = time.perf_counter_ns()
        self.rf.__enter__()
        _stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack.pop()
        self.rf.__exit__(*exc)
        t = time.perf_counter_ns() - self.t0
        if _stack:
            _stack[-1].inner += t
        s = _stretch.spans.get(self.name)
        if s is None:
            s = _stretch.spans[self.name] = [0, 0, 0]
        s[0] += 1
        s[1] += t
        s[2] += t - self.inner
        return None


def region(name: str):
    """A profiler range named ``name`` (``torch.profiler.record_function``)
    that also times itself on the host while a profiler is running, else a
    shared no-op context."""
    if _profiler_enabled():
        return _Span(name)
    return _NO_REGION


def entry(name: str):
    """:func:`region` for a serving entry (:data:`ENTRIES`).  Called with
    no profiler running, it also ends the stretch, so that the next span
    entered under a profiler starts the numbers from zero."""
    global _stale
    if _profiler_enabled():
        return _Span(name)
    _stale = True
    return _NO_REGION


def _device_counts(device):
    acc = _stretch.device.get(device)
    if acc is None:
        acc = _stretch.device[device] = torch.zeros(
            len(_ON_DEVICE), dtype=torch.int64, device=device)
    return acc


def grouped_counts(device, slots: int):
    """The grouped layer's count site, one a chunk (``ops/grouped.py``
    ``tile_tables``).  With no profiler running, None, after one check.
    Else it adds the chunk's ``slots`` launched (``nt * tile_m``) on the
    host and returns the stretch's ``int64[6]`` on ``device``, into whose
    first two the chunk's valid pairs and its tiles needed past the
    capacity are added (by kernel 9 itself on the card), with no read
    back."""
    if not _profiler_enabled():
        return None
    _stretch.slots += slots
    return _device_counts(device)


def grouped_reads(device):
    """Kernel 1's count site (``ops/grouped.py``
    ``grouped_distances_kernel``): with no profiler running, None, after
    one check; else the stretch's ``int64[2]`` on ``device`` into which
    the launch adds its block stagings and the bytes they copy (kernel 1
    itself on the card), with no read back."""
    if not _profiler_enabled():
        return None
    return _device_counts(device)[2:4]


def topk_rows(rows: int, one_read: bool) -> None:
    """Kernel 3's host count site, one a launch on the card
    (``ops/topk_kernel.py``): with a profiler running, adds ``rows`` to
    ``topk.rows_one_read`` where the route reads each candidate once, else
    to ``topk.rows_swept``."""
    if _profiler_enabled():
        _stretch.topk[0 if one_read else 1] += rows


def topk_paths(device):
    """Kernel 3's device count site (``models/forest.py``'s selection
    tails): with no profiler running, None, after one check; else the
    stretch's ``int64[2]`` on ``device`` into which kernel 3 adds the rows
    that took a second prefix and the rows of a tie overflow, with no read
    back."""
    if not _profiler_enabled():
        return None
    return _device_counts(device)[4:]


def stats() -> dict:
    """The latest profiled stretch's numbers: each region's name ->
    ``{"calls", "total_ns", "self_ns"}``, and each of :data:`COUNTERS` ->
    its sum (device counts read back here, one sync a device)."""
    st = _stretch
    out = {name: {"calls": c, "total_ns": t, "self_ns": s}
           for name, (c, t, s) in st.spans.items()}
    out.update(dict.fromkeys(_ON_DEVICE, 0))
    for acc in st.device.values():
        for name, v in zip(_ON_DEVICE, acc.tolist()):
            out[name] += v
    out["grouped.slots_launched"] = st.slots
    out["topk.rows_one_read"], out["topk.rows_swept"] = st.topk
    return out


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
    region's device time; :func:`stats` then reads the block's spans and
    counters, which start from zero here.

    ``host=True`` also records the Python stacks (``with_stack=True``), the
    counterpart of the JAX package's host-side Python tracer.  Remember to
    :func:`sync` the outputs INSIDE the block; otherwise the trace window
    closes before the device work runs."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts, with_stack=host)
    _restart()
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"rpt_trace_{os.getpid()}_{time.time_ns()}.json"))
