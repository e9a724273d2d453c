"""Multi-process data-parallel ingest + build through the PyTorch / CUDA
port (``rptree_tpu_torch``; ``examples/multihost_bench.py`` through the
JAX package).

Two local processes in a ``torch.distributed`` group (the stand-in for
two hosts: the same code runs across machines with another
``init_method`` address), each

  1. ingesting ONLY its own rows from its own .fvecs file
     (``rptree_tpu_torch.ingest``), made its shards of the data mesh by
     ``process_local_rows``, then
  2. running the data-parallel forest build over the group: the radix
     selection's counts and the shards' equal counts and leaf codes are
     its collectives,

and every process gets the same tree structure back.  Prints each
process's ingest MB/s, upload and build seconds (cold and warm) and a
structure check (the hashes of ``thr`` and ``perm`` agree).

    python examples/torch_multihost_bench.py [n_rows] [dim]

The group runs on gloo, whose collectives stage their payloads through
the host.  On the card each process drives two shards of ``cuda:0``
(NCCL, the backend for processes on separate cards, refuses two ranks on
one device, so gloo stands in for it there); ``RPTREE_EXAMPLE_DEVICE=cpu``
runs four CPU shards a process.  :func:`run` is the entry point other
scripts call: it also serves queries from the packed blocks and returns
process 0's results.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _sha(t) -> str:
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()[:12]


def worker(args: dict) -> None:
    """One process of the group: ingest its rows, build (twice: cold and
    warm), and with ``queries`` serve them unpacked and, packed as
    ``pack`` asks (a block dtype by its torch name), grouped as ``serve``
    asks; process 0 writes its results to ``out``."""
    import torch
    import torch.distributed as dist

    from rptree_tpu_torch.parallel import data_mesh, forest_batch_data_parallel
    from rptree_tpu_torch.parallel.data_parallel import process_local_rows
    from rptree_tpu_torch.utils import ingest

    rank, world = args["rank"], args["world"]
    torch.set_num_threads(args.get("threads", 1))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{args['port']}", world_size=world, rank=rank)
    try:
        device = torch.device(args["device"])

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        n, seed = args["n"], args["seed"]
        t0 = time.perf_counter()
        x_local = ingest.read_fvecs(os.path.join(args["tmp"],
                                                 f"shard{rank}.fvecs"))
        ingest_s = time.perf_counter() - t0
        mesh = data_mesh(devices=[device] * args["shards"])
        t0 = time.perf_counter()
        xs = process_local_rows(torch.from_numpy(x_local), n, mesh)
        sync()
        upload_s = time.perf_counter() - t0
        cfg = (seed, args["depth"], args["min_leaf"], args["trees"],
               args["pnz"])
        times, f = [], None
        for s in (seed + 1, seed):  # the cold build, then the kept one
            t0 = time.perf_counter()
            f = forest_batch_data_parallel(s, *cfg[1:], xs, mesh=mesh)
            sync()
            times.append(time.perf_counter() - t0)
        record = {"proc": rank, "shards": args["shards"],
                  "ingest_mb": x_local.nbytes / 1e6, "ingest_s": ingest_s,
                  "upload_s": upload_s, "build_cold_s": times[0],
                  "build_warm_s": times[1], "thr_sha": _sha(f.arrays.thr),
                  "perm_sha": _sha(f.arrays.perm)}
        if args.get("queries"):
            q = torch.as_tensor(np.load(args["queries"]), device=device)
            d, i = f.knn(q, args["k"], budget=args.get("budget"))
            f.pack_leaves(**{key: getattr(torch, v) if key == "dtype" else v
                             for key, v in args.get("pack", {}).items()})
            t0 = time.perf_counter()
            dg, ig = f.knn_grouped(q, args["k"], **args.get("serve", {}))
            sync()
            record["grouped_s"] = time.perf_counter() - t0
            if rank == 0:
                np.savez(args["out"], perm=f.arrays.perm.cpu().numpy(),
                         dists=d.cpu().numpy(), ids=i.cpu().numpy(),
                         dists_grouped=dg.cpu().numpy(),
                         ids_grouped=ig.cpu().numpy())
        # the child imports neither JAX nor the JAX package
        record["jax_free"] = not any(m == "jax" or m.startswith("rptree_tpu.")
                                     or m == "rptree_tpu" for m in sys.modules)
        print("RESULT " + json.dumps(record), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(x, nproc=2, shards=2, device="cuda", seed=7, depth=None,
        min_leaf=None, trees=4, pnz=1.0, queries=None, k=10, budget=None,
        pack=None, serve=None, timeout=600, tmp_root=None):
    """Split the rows ``x f32[n, D]`` into ``nproc`` contiguous blocks, one
    .fvecs file each, and run :func:`worker` in ``nproc`` processes of
    ``shards`` shards of ``device`` each, building ``trees`` trees of
    ``depth`` (default ``rp_tree_cfg``'s) with projections of density
    ``pnz`` drawn from ``seed``.  Returns ``(records, results)``:
    each process's record, and with ``queries`` process 0's ``perm``,
    unpacked ``(dists, ids)`` and grouped ``(dists_grouped,
    ids_grouped)``.  Every process is stopped before it returns."""
    from rptree_tpu_torch.config import rp_tree_cfg
    from rptree_tpu_torch.utils.ingest import write_fvecs

    n, dim = x.shape
    if min_leaf is None:
        min_leaf = max(16, n // 256)
    if depth is None:
        depth = rp_tree_cfg(min_leaf, n, dim).max_depth
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        per = n // nproc
        for p in range(nproc):
            write_fvecs(os.path.join(tmp, f"shard{p}.fvecs"),
                        x[p * per:(p + 1) * per])
        base = dict(world=nproc, port=_free_port(), tmp=tmp, n=n,
                    seed=seed, depth=depth, min_leaf=min_leaf, trees=trees,
                    pnz=pnz,
                    device=str(device), shards=shards, k=k, budget=budget,
                    pack=pack or {}, serve=serve or {},
                    out=os.path.join(tmp, "result.npz"))
        if queries is not None:
            base["queries"] = os.path.join(tmp, "queries.npy")
            np.save(base["queries"], np.asarray(queries, np.float32))
        env = {kk: v for kk, v in os.environ.items()
               if kk not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             json.dumps({**base, "rank": r})], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(nproc)]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("a worker failed:\n" + "\n".join(
                log[-3000:] for log in logs))
        records = [json.loads(line[len("RESULT "):]) for log in logs
                   for line in log.splitlines() if line.startswith("RESULT ")]
        results = None
        if queries is not None:
            with np.load(base["out"]) as z:
                results = {key: z[key] for key in z.files}
        return records, results


def main(n=262144, dim=64, nproc=2):
    device = os.environ.get("RPTREE_EXAMPLE_DEVICE") or "cuda"
    shards = 4 if device == "cpu" else 2
    x = np.random.default_rng(11).normal(size=(n, dim)).astype(np.float32)
    t0 = time.perf_counter()
    records, _ = run(x, nproc=nproc, shards=shards, device=device)
    wall = time.perf_counter() - t0
    for rec in sorted(records, key=lambda r: r["proc"]):
        print("RESULT " + " ".join(
            f"{key}={v:.2f}" if isinstance(v, float) else f"{key}={v}"
            for key, v in rec.items()))
    shas = {(r["thr_sha"], r["perm_sha"]) for r in records}
    if len(shas) != 1 or len(records) != nproc:
        raise SystemExit(f"processes disagree on the structure: {shas}")
    print(f"processes agree (thr sha {records[0]['thr_sha']}, perm sha "
          f"{records[0]['perm_sha']}); end-to-end wall {wall:.1f}s for "
          f"n={n} dim={dim} over {nproc} processes x {shards} shards of "
          f"{device}")


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(json.loads(sys.argv[2]))
    else:
        main(*(int(v) for v in sys.argv[1:3]))
