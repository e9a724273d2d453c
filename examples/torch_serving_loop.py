"""Steady-state serving loop through the PyTorch / CUDA port
(``rptree_tpu_torch``; ``examples/serving_loop.py`` through the JAX
package): what keeping batches in flight and chunking buys over a
synchronous loop.

A synchronous serve loop pays, per batch, the host's dispatch of the
call and a result fetch.  A production server does neither: it keeps a
few batches IN FLIGHT (CUDA launches are asynchronous; results are
fetched when the client consumes them, by which time the card has moved
on).  With ``knn_grouped(..., check=False)``, after one checked call at
the batch's shape, the serving path reads nothing back to the host, so
the pipeline can fill.  On the card this script holds the port to that
as far as PyTorch can tell: every ``check=False`` call runs under
``torch.cuda.set_sync_debug_mode("error")``, which raises on the host
syncs it detects (a prototype that does not detect every synchronizing
operation; ``chip_smoke.py`` phase 15 also traces such calls with
``torch.profiler`` and finds no synchronize call, copy to the host or
scalar read there).

This script measures the 1M clustered flagship (the data of
``examples/torch_clustered_1m.py``, drawn on the card by a
``torch.Generator``) served three ways:
  sync        -- dispatch, fetch, repeat (what bench.py's wall loop does)
  depth=d     -- keep d batches in flight (a ``collections.deque`` of
                 results not yet read), fetch the oldest when the window
                 fills (bounded staleness / memory)
  chunked     -- accumulate 4 batches and serve them as ONE call of
                 ``knn_grouped(chunk=BQ)``: in the port a Python loop of
                 each chunk's launches inside the call (the JAX package's
                 is one ``lax.map`` dispatch), one learned tile capacity
                 per chunk and per-chunk peak memory; the call's own
                 checks and padding are paid once for the 4 batches.

The recipe: batch as large as latency allows, serve with ``chunk=32768``
and ``check=False``, and poll ``f.grouped_overflow()`` every N batches
(the needed-tile count stays on the card; one int fetch tells you if a
traffic shift outgrew the learned tile capacity -- re-run one checked
call to re-learn it).  Each batch's "fetch" is one ``.item()``.  It runs
on the card (``RPTREE_EXAMPLE_DEVICE=cpu`` runs it on the CPU, without
the sync check).

Run: ``python examples/torch_serving_loop.py [n] [centers] [depth...]``
Reference analogue: the reference library serves one query at a time
(``src/Data/RPTree.hs:159-176``); batching + pipelining is the serving
shape of an accelerator.
"""

import collections
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DEFAULT = 1_000_000
C_DEFAULT = 4_000
DIM = 128
K = 10
SIGMA = 0.15
SEED = 20260817
T, ML, BUDGET, PROBES = 8, 128, 1, 8
BQ = 32768          # per-batch queries
N_BATCHES = 8       # distinct in-flight query batches (rotated)
REPS = 24           # total batches served per timing


def main(n=N_DEFAULT, c=C_DEFAULT, depths=(2, 4), bq=BQ,
         n_batches=N_BATCHES, reps=REPS, device=None):
    import torch

    import rptree_tpu_torch as rt

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_clustered_1m import make_clustered

    x, q = make_clustered(n, c, DIM, SIGMA, bq * n_batches, device)
    rt.profiling.sync(q)
    qs = [q[i * bq:(i + 1) * bq] for i in range(n_batches)]

    cfg = rt.rp_tree_cfg(ML, n, DIM)
    t0 = time.perf_counter()
    f = rt.forest_batch(SEED, cfg.max_depth, ML, T, cfg.proj_nz_density, x,
                        device=x.device)
    rt.profiling.sync(f.arrays.perm)
    f.pack_leaves()
    print(f"built+packed in {time.perf_counter() - t0:.1f}s "
          f"(T={T} ml={ML} b={BUDGET} p={PROBES}, B={bq})")

    def no_sync(check):
        # a check=False call must not read anything back to the host
        if check or x.device.type != "cuda":
            return contextlib.nullcontext()
        return _sync_debug_error()

    def serve(qb, check=False):
        with no_sync(check):
            return f.knn_grouped(qb, K, budget=BUDGET, probes=PROBES,
                                 precision="default", tile_m=8, check=check)

    # warm-up: ONE checked call per batch shape caches the tile capacity;
    # everything after runs check=False (no host syncs)
    d0, i0 = serve(qs[0], check=True)
    int(i0[:, 0].clamp(0, 1).sum())  # wait for it + warm the fetch op

    def fetch(res):
        # consume one scalar per batch (a server would stream the ids
        # out; one scalar keeps the measurement honest without timing
        # the bulk result transfer)
        return int(res[1][:, 0].clamp(0, 1).sum())

    results = {}

    # sync loop (dispatch, fetch, repeat)
    fetch(serve(qs[0]))
    t0 = time.perf_counter()
    for r in range(reps):
        fetch(serve(qs[r % n_batches]))
    dt = time.perf_counter() - t0
    results["sync"] = reps * bq / dt
    print(f"sync:    {results['sync']:10.0f} QPS wall")

    # pipelined: keep `depth` batches in flight
    for depth in depths:
        window = collections.deque()
        fetch(serve(qs[0]))  # re-warm the dispatch path
        t0 = time.perf_counter()
        for r in range(reps):
            window.append(serve(qs[r % n_batches]))
            if len(window) >= depth:
                fetch(window.popleft())
        while window:
            fetch(window.popleft())
        dt = time.perf_counter() - t0
        results[f"depth={depth}"] = reps * bq / dt
        print(f"depth={depth}: {results[f'depth={depth}']:10.0f} QPS wall")

    # chunked giant batch: 4 batches, ONE call (a loop over chunks inside)
    qbig = torch.cat(qs[:4], dim=0)

    def serve_big(check=False):
        with no_sync(check):
            return f.knn_grouped(qbig, K, budget=BUDGET, probes=PROBES,
                                 precision="default", tile_m=8, chunk=bq,
                                 check=check)

    fetch(serve_big(check=True))  # capacity at this shape
    fetch(serve_big())
    t0 = time.perf_counter()
    for _ in range(max(1, reps // 4)):
        fetch(serve_big())
    dt = time.perf_counter() - t0
    results["chunked"] = max(1, reps // 4) * 4 * bq / dt
    print(f"chunked: {results['chunked']:10.0f} QPS wall "
          f"(4 batches / dispatch)")

    # production overflow monitoring: the check=False loop above never
    # host-syncs, but its needed-tile counter rides along on the card --
    # poll it every N batches (one int fetch) and re-learn the capacity
    # (a checked call) if a traffic shift ever overflows the headroom
    ov = f.grouped_overflow()
    print(f"overflow telemetry after the loop: needed={ov['needed']} "
          f"capacity={ov['capacity']} overflow={ov['overflow']}")

    best = max(results.values())
    print(f"\nbest over sync: {best / results['sync']:.2f}x "
          f"({max(results, key=results.get)})")
    return results


@contextlib.contextmanager
def _sync_debug_error():
    """Raise on any host sync inside the block
    (``torch.cuda.set_sync_debug_mode("error")``), the caller's mode
    restored after."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else N_DEFAULT
    c = int(sys.argv[2]) if len(sys.argv) > 2 else C_DEFAULT
    ds = tuple(int(a) for a in sys.argv[3:]) or (2, 4)
    main(n, c, ds)
