"""A sweep of an open-loop cell's arrival rate, to find the highest rate
that the program sustains; the cell's traffic file then fixes its rate at
a share of it.  The benchmark's own runs never run it.

    python3 benchmark/sweep.py --workload <name> --seconds <s> --rates 200 300 400

One set-up, then a window a rate, in the order given; one JSON line a
rate: the latency's median and 95th percentile, how late calls began, the
rate of requests completed, and the latency's growth (the median of the
last quarter of requests over the first's: a backlog that grows through
the window reads well above 1).
"""

import argparse
import json
import os
import sys
import time


def _root_on_path():
    """Run as a script, the folder itself leads the path: the checkout's
    root takes its place, so that the folder's modules shadow nothing."""
    sys.path[0:1] = [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    _root_on_path()

    import numpy as np
    import torch

    from benchmark import datagen, harness, loops, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    dev = harness.device_of("cuda")
    sv = harness.Served(cell, args.seed, dev, time.perf_counter())
    for rate in args.rates:
        due = datagen.arrival_times(args.seed, rate, args.seconds)
        win = loops.open_loop(sv.call, lambda j, out: None, sv.n_batches,
                              due, dev)
        lat = np.asarray([d - t for d, t in zip(win.done, win.due)]) * 1e3
        q = max(1, lat.size // 4)
        print(json.dumps({
            "rate": rate, "requests": int(lat.size),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "late_p95_ms": float(np.percentile(win.late_s, 95)) * 1e3,
            "done_per_s": lat.size / (win.end - win.start),
            "growth": float(np.median(lat[-q:]) / np.median(lat[:q])),
            "dispatch_us": 1e6 * float(np.mean(win.dispatch_s))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
