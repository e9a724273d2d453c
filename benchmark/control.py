"""Readings of the check's numbers over many seeds in one process: of the
program as the cell runs it (the lower readings), or of the control, the
program with its blocks packed in bfloat16, the nearest precision below
the float32 that the configurations state (the upper readings).  The
benchmark's own runs never run it.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds 1 2 3 [--bf16]

One JSON line a seed: ``correct``, the numbers beside their limits, the
answers compared, and the end-to-end metrics of that run.
"""

import argparse
import gc
import json
import os
import sys


def _root_on_path():
    """Run as a script, the folder itself leads the path: the checkout's
    root takes its place, so that the folder's modules shadow nothing."""
    sys.path[0:1] = [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args(argv)
    _root_on_path()

    import torch

    from benchmark import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    pack = None
    if args.bf16:
        pack = {**cell.config["index"].get("pack", {}), "dtype": "bfloat16"}
    for seed in args.seeds:
        out = harness.run(args.workload, seed, args.seconds, False,
                          cell=cell, pack=pack)
        print(json.dumps({"seed": seed, "bf16": args.bf16,
                          "correct": out["correct"],
                          "checks": out["checks"],
                          "compared": out["compared"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "reference_s": out["reference_s"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
