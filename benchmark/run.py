"""The benchmark of ``rptree_tpu_torch``: one run of one cell of
``BENCHMARK.json``, its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (half the window traced by
``torch.profiler``).  It needs as many CUDA devices as the cell asks for
and exits with another code than 0, printing no result, without them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# top-level module names that the process may not hold after the window
FORBIDDEN = ("jax", "jaxlib", "flax", "rptree_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's and the compilers' caches stay inside the checkout, at
    # fixed paths, so that only a checkout's first run builds
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    # run as a script, the folder itself leads the path: the checkout's
    # root takes its place, so that the folder's modules shadow nothing
    sys.path[0:1] = [ROOT]

    import torch

    from benchmark import harness, spec

    bench = spec.benchmark()
    chips = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not chips:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    need = chips[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START,
                      cell=spec.cell(args.workload, bench=bench))
    bad = forbidden_modules()
    if bad:
        print(f"the process holds forbidden modules: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
