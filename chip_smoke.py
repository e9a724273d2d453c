"""Smoke test of the PyTorch / CUDA port (``rptree_tpu_torch``) on one
NVIDIA GPU: builds the port's CUDA kernels from ``rptree_tpu_torch/csrc``,
holds each against its plain PyTorch version at the serving path's shapes,
then drives the grouped serving path end to end on two cells and checks
recall against the exact scan.

    python3 chip_smoke.py

Phases, one line each (phases 3-4 one per variant, and one more with
its launch counts):

1. set-up: the card, torch and CUDA versions, TF32 off, kernel build time;
2. each kernel against its plain version on the card (distances to 1e-4
   relative, top-k exactly equal; the fused tile top-k's distances
   bit-equal to the tile kernel's, sorted), with both times by CUDA
   events;
3. clustered 1M cell (``bench.py``'s flagship parameters): one build and
   one exact ground truth (recall@10 on 1,024 queries), then 131,072
   queries served by five variants: f32 blocks with the kernel tail, the
   sort tail, and the fused tile top-k (``impl="kernel_topk"``); bf16
   blocks with the sort tail and the fused tile top-k.  The fused
   variants' distances must be bit-equal to their full-kernel twins';
4. iid 100k cell, int8 blocks with slack 8 (``bench.py``'s headline
   parameters): the same on 65,536 queries with the kernel tail;
5. the kernels' launch counts over phases 3-4, each of which must be > 0.

Every variant is served with the launch counts set to 0 just before it
and read just after it: the kernels it must run have launched once per
chunk and pass, and every other kernel of the path not at all.

Then one JSON line describing each kernel and, last, the result line
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero and prints no result line.  It needs a CUDA device and
the checkout's ``rptree_tpu_torch`` package; it never imports JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 20260816
K = 10
DIST_RTOL = 1e-4           # kernel vs plain version, distances (relative)
CLUSTERED_MIN_RECALL = 0.90
BF16_MIN_RECALL = 0.80     # single-pass bf16 products; the JAX package: 0.860
IID_MIN_RECALL = 0.10
KP = 16                    # the fused tile top-k's per-pair width at k = 10
JAX_RECALL = {"clustered": 0.9249, "iid": 0.123}  # the JAX package's records


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps=5):
    """Mean milliseconds of ``fn()`` on the card by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 2: kernels against their plain versions -------------------------

def _rel_err(got, want):
    """Largest ``|got - want| / max(|want|, 1)`` over finite entries, after
    checking that both are infinite at the same places."""
    import torch

    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError("kernel and plain version disagree on masking")
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    if diff.numel() == 0:
        return 0.0, 0.0
    rel = diff / want[fin].abs().clamp_min(1.0)
    return float(diff.max()), float(rel.max())


def tile_inputs(g, lmax, d, nt, tile_m, int8, device, seed=1, bf16=False):
    """Blocks, tables and query rows at the serving path's shapes: runs of
    one repeated block, partial and empty occupancy, junk empty slots;
    slot norms from the f32 rows, as packing takes them."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(g, lmax, d, generator=gen)
    sq = (x * x).sum(-1)
    tb = torch.randint(0, g, (nt,), generator=gen, dtype=torch.int32)
    tb[: nt // 8] = tb[0]
    lens = torch.randint(1, lmax + 1, (nt,), generator=gen, dtype=torch.int32)
    lens[::7] = lmax
    lens[1] = 0
    qt = torch.randn(nt * tile_m, d, generator=gen)
    scale = None
    if bf16:
        x = x.bfloat16()
    if int8:
        from rptree_tpu_torch.ops.grouped_kernel import INV_127

        scale = x.abs().amax(dim=(1, 2)) * INV_127
        x = torch.round(x / scale[:, None, None]).clamp(-127, 127).to(
            torch.int8)
    to = {"device": device}
    return (x.to(**to), sq.to(**to), None if scale is None else scale.to(**to),
            tb.to(**to), lens.to(**to), qt.to(**to))


def topk_inputs(b, w, device, seed=2):
    """Candidate rows with ties, duplicate ids (duplicates carry the same
    distance, as on exact layouts, and different ones) and exhausted rows."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(seed)
    d = torch.randint(0, 2000, (b, w), generator=gen).float() / 100.0
    ids = torch.randint(0, 4 * w, (b, w), generator=gen, dtype=torch.int32)
    ids[:, w // 2:] = ids[:, : w - w // 2]     # every id twice
    d[::3, w // 2:] = d[::3, : w - w // 2]     # same-distance copies
    masked = torch.rand(b, w, generator=gen) < 0.3
    masked[5::97] = True                       # exhausted rows
    masked[5::97, :3] = False
    d = torch.where(masked, float("inf"), d)
    ids = torch.where(masked, -1, ids)
    return d.to(device), ids.to(device)


def check_kernels(device, g=4096, nt=4096, dim=128, reps=5):
    """Phase 2: each kernel against its plain version at the path's shapes
    (f32 and bf16 lmax 128, int8 lmax 64, tile_m 8, D 128, tile top-k kp
    16; top-k W 1024 and 640, k 10).  Returns one record per kernel."""
    import torch

    from rptree_tpu_torch.ops import grouped_kernel as gk
    from rptree_tpu_torch.ops import topk_kernel as tk

    tile_m = 8
    shape = {"tiles": nt, "tile_m": tile_m, "D": dim}
    out = {}
    for name, kind, lmax in (("grouped_score_tiles", "f32", 128),
                             ("grouped_score_tiles_bf16", "bf16", 128),
                             ("grouped_score_tiles_int8", "int8", 64)):
        x, sq, scale, tb, lens, qt = tile_inputs(
            g, lmax, dim, nt, tile_m, kind == "int8", device,
            bf16=kind == "bf16")
        if kind == "int8":
            args = (x, sq, scale, tb, lens, qt)
            kern, plain = gk.grouped_score_tiles_int8, \
                gk.grouped_score_tiles_int8_reference
        else:
            args = (x, sq, tb, lens, qt)
            kern, plain = gk.grouped_score_tiles, \
                gk.grouped_score_tiles_reference
        for metric in ("sql2", "l2"):
            got = kern(*args, metric, tile_m)
            want = plain(*args, metric, tile_m)
            torch.cuda.synchronize()
            abs_err, rel_err = _rel_err(got, want)
            if rel_err > DIST_RTOL:
                raise AssertionError(f"{name} {metric}: relative error "
                                     f"{rel_err} > {DIST_RTOL}")
        out[name] = {
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": cuda_ms(lambda: kern(*args, "l2", tile_m), reps),
            "plain_ms": cuda_ms(lambda: plain(*args, "l2", tile_m), reps),
            "shape": {**shape, "lmax": lmax},
        }
    rec = {"shape": {**shape, "lmax": 128, "kp": KP}}
    for kind in ("f32", "bf16"):
        x, sq, _, tb, lens, qt = tile_inputs(g, 128, dim, nt, tile_m, False,
                                             device, bf16=kind == "bf16")
        ids = torch.randperm(g * 128, generator=torch.Generator().manual_seed(3)
                             ).to(torch.int32).reshape(g, 128).to(device)
        args = (x, sq, ids, tb, lens, qt)
        for metric in ("sql2", "l2"):
            kd, ki = gk.grouped_score_topk(*args, metric, tile_m, KP)
            pd, pi = gk.grouped_score_topk_reference(*args, metric, tile_m, KP)
            full = gk.grouped_score_tiles(x, sq, tb, lens, qt, metric, tile_m)
            first = torch.sort(full, dim=1, stable=True).values[:, :KP]
            torch.cuda.synchronize()
            abs_err, rel_err = _rel_err(kd, pd)
            if rel_err > DIST_RTOL:
                raise AssertionError(f"grouped_score_topk {kind} {metric}: "
                                     f"relative error {rel_err}")
            if not torch.equal(kd.view(torch.int32), first.view(torch.int32)):
                raise AssertionError(f"grouped_score_topk {kind} {metric}: "
                                     "distances differ from the tile kernel's")
            chk = gk.untied(pd, DIST_RTOL)
            if not torch.equal(ki[chk], pi[chk]) or bool(
                    (ki[torch.isinf(kd)] != -1).any()):
                raise AssertionError(f"grouped_score_topk {kind} {metric}: "
                                     "ids differ from the plain version's")
        sfx = "" if kind == "f32" else "_bf16"
        rec.update({
            f"max_abs_err{sfx}": abs_err, f"max_rel_err{sfx}": rel_err,
            f"ms{sfx}": cuda_ms(lambda: gk.grouped_score_topk(
                *args, "l2", tile_m, KP), reps),
            f"plain_ms{sfx}": cuda_ms(lambda: gk.grouped_score_topk_reference(
                *args, "l2", tile_m, KP), reps),
        })
    rec["max_abs_err"] = max(rec["max_abs_err"], rec["max_abs_err_bf16"])
    out["grouped_score_topk"] = rec
    topk_err, times = 0.0, {}
    for w in (1024, 640):
        d, ids = topk_inputs(8192, w, device)
        for dedup in (True, False):
            kd, ki = tk.topk_dedup_kernel(d, ids, K, dedup=dedup)
            pd, pi = tk.topk_dedup_kernel_reference(d, ids, K, dedup=dedup)
            torch.cuda.synchronize()
            if not (torch.equal(ki, pi) and torch.equal(
                    kd.view(torch.int32), pd.view(torch.int32))):
                bad = int((ki != pi).any(dim=1).sum())
                raise AssertionError(f"topk_dedup_kernel W={w} dedup={dedup}"
                                     f": {bad} rows differ")
            topk_err = max(topk_err, _rel_err(kd, pd)[0])
        times[w] = (cuda_ms(lambda: tk.topk_dedup_kernel(d, ids, K), reps),
                    cuda_ms(lambda: tk.topk_dedup_kernel_reference(d, ids, K),
                            reps))
    out["topk_dedup_kernel"] = {
        "max_abs_err": topk_err, "ids_equal": True,
        "ms": times[1024][0], "plain_ms": times[1024][1],
        "ms_w640": times[640][0], "plain_ms_w640": times[640][1],
        "shape": {"rows": 8192, "W": [1024, 640], "k": K},
    }
    return out


# -- phases 3-4: the serving path ------------------------------------------

def clustered_data(n, dim, centers, sigma, n_queries, seed=SEED):
    """Gaussian mixture around N(0, 1) centers; queries are dataset points
    plus half-sigma noise (``bench.py``'s clustered family, drawn with
    numpy instead of ``jax.random``)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, dim), dtype=np.float32)
    x = c[rng.integers(0, centers, size=n)]
    x += sigma * rng.standard_normal((n, dim), dtype=np.float32)
    q = x[rng.integers(0, n, size=n_queries)]
    q += 0.5 * sigma * rng.standard_normal((n_queries, dim), dtype=np.float32)
    return x, q


def iid_data(n, dim, n_queries, seed=SEED):
    """``bench.py``'s iid headline data: N(0, 1) points; queries are
    dataset points plus 0.1 noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    q = (x[rng.integers(0, n, size=n_queries)]
         + 0.1 * rng.normal(size=(n_queries, dim)).astype(np.float32))
    return x, q


def recall(ids, truth):
    ids, truth = ids.cpu().numpy(), truth.cpu().numpy()
    return float(np.mean([len(set(a) & set(b)) / truth.shape[1]
                          for a, b in zip(ids.tolist(), truth.tolist())]))


def sync_time(fn):
    """``(fn(), seconds)`` on the host clock between two synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def build_cell(x, q, min_leaf, n_trees, device, n_recall=1024):
    """Build one cell's forest through the port's public entry points and
    its exact ground truth for the first ``n_recall`` queries; returns
    ``(forest, queries on the card, truth ids, record)``."""
    import torch

    import rptree_tpu_torch as rp

    n, dim = x.shape
    cfg = rp.rp_tree_cfg(min_leaf, n, dim)
    xd = torch.as_tensor(x, device=device)
    qd = torch.as_tensor(q, device=device)
    f, build_s = sync_time(lambda: rp.forest_batch(
        SEED, cfg.max_depth, min_leaf, n_trees, cfg.proj_nz_density, xd,
        device=device))
    (_, truth), truth_s = sync_time(lambda: f.brute_force_knn(qd[:n_recall],
                                                              K))
    return f, qd, truth, {
        "n": n, "dim": dim, "trees": n_trees, "min_leaf": min_leaf,
        "depth": cfg.max_depth, "leaves": f.plan.n_leaves,
        "queries": q.shape[0], "build_s": build_s, "ground_truth_s": truth_s,
    }


def kernel_counts():
    """The launch count of each kernel of the path: ``{name: (wrapper,
    attribute)}``."""
    from rptree_tpu_torch.ops import grouped_kernel as gk
    from rptree_tpu_torch.ops import topk_kernel as tk

    return {
        "grouped_score_tiles": (gk.grouped_score_tiles, "launches"),
        "grouped_score_tiles_bf16": (gk.grouped_score_tiles, "launches_bf16"),
        "grouped_score_tiles_int8": (gk.grouped_score_tiles_int8, "launches"),
        "topk_dedup_kernel": (tk.topk_dedup_kernel, "launches"),
        "grouped_score_topk": (gk.grouped_score_topk, "launches"),
    }


def counted(fn):
    """``(fn(), launches)``: every kernel's count set to 0 just before
    ``fn`` runs and read just after it."""
    counts = kernel_counts()
    for wrapper, attr in counts.values():
        setattr(wrapper, attr, 0)
    res = fn()
    return res, {name: getattr(wrapper, attr)
                 for name, (wrapper, attr) in counts.items()}


def check_launches(name, runs, warm, steady, chunks, passes):
    """The kernels ``runs`` launched once per chunk in each steady-state
    pass and at least once per chunk in the checked call (which may retry
    with more tiles); every other kernel of the path not at all."""
    for kern in warm:
        if kern in runs:
            ok = steady[kern] == passes * chunks and warm[kern] >= chunks
        else:
            ok = steady[kern] == warm[kern] == 0
        if not ok:
            raise AssertionError(
                f"{name}: {kern} launched {warm[kern]} + {steady[kern]} "
                f"times; expected {'>= ' if kern in runs else ''}"
                f"{chunks if kern in runs else 0} + "
                f"{passes * chunks if kern in runs else 0}")


def serve_variant(name, f, qd, truth, pack, serve, runs, n_passes=3):
    """Pack ``f`` as ``pack`` asks and serve ``qd`` with ``serve``: one
    checked call that learns the tile capacity, then ``n_passes``
    steady-state ``check=False`` passes that must return the same.  The
    launch counts are read around each of the two and must show that the
    kernels ``runs`` served the variant and no other kernel did.  Returns
    the record (recall@10 against ``truth``, QPS of the median pass,
    launches) and the last pass's ``(dists, ids)``."""
    import torch

    _, pack_s = sync_time(lambda: f.pack_leaves(**pack))
    ((_, ids0), warm_s), warm_n = counted(lambda: sync_time(
        lambda: f.knn_grouped(qd, K, check=True, **serve)))
    passes, steady_n = counted(lambda: [sync_time(
        lambda: f.knn_grouped(qd, K, check=False, **serve))
        for _ in range(n_passes)])
    chunks = -(-qd.shape[0] // serve["chunk"])
    check_launches(name, runs, warm_n, steady_n, chunks, n_passes)
    serve_s = float(np.median([s for _, s in passes]))
    dist, ids = passes[-1][0]
    if tuple(ids.shape) != (qd.shape[0], K) or tuple(dist.shape) != tuple(
            ids.shape):
        raise AssertionError(f"{name}: result shape {tuple(ids.shape)}")
    live = ids >= 0
    if not bool(torch.isfinite(dist[live]).all()) or not bool(
            torch.equal(torch.isinf(dist), ~live)):
        raise AssertionError(f"{name}: non-finite distances on live ids")
    if not all(torch.equal(r[1], ids0) for r, _ in passes):
        raise AssertionError(f"{name}: a steady-state pass differs from "
                             "the checked pass")
    if int(((dist[:, 1:] - dist[:, :-1]) < 0).sum()):
        raise AssertionError(f"{name}: distances not ascending")
    over = f.grouped_overflow()
    if over["overflow"]:
        raise AssertionError(f"{name}: tile capacity overflow {over}")
    x_leaf = f._packed[0]
    return {
        "lmax": int(x_leaf.shape[1]),
        "block_dtype": str(x_leaf.dtype).replace("torch.", ""),
        "x_leaf_gb": x_leaf.numel() * x_leaf.element_size() / 1e9,
        **serve, "recall_at_10": recall(ids[:truth.shape[0]], truth),
        "qps": qd.shape[0] / serve_s, "serve_s": serve_s,
        "checked_serve_s": warm_s, "pack_s": pack_s, "tiles": over,
        "launches": {kern: warm_n[kern] + steady_n[kern] for kern in warm_n},
    }, (dist, ids)


def same_results(name, got, want):
    """``got`` against ``want``, both ``(dists, ids)``: distances bit-equal
    on every row, ids equal outside runs of equal distances."""
    import torch

    from rptree_tpu_torch.ops.grouped_kernel import untied

    (gd, gi), (wd, wi) = got, want
    if not torch.equal(gd.view(torch.int32), wd.view(torch.int32)):
        bad = int((gd.view(torch.int32) != wd.view(torch.int32)).any(1).sum())
        raise AssertionError(f"{name}: distances differ on {bad} rows")
    chk = untied(wd)
    if not torch.equal(gi[chk], wi[chk]):
        raise AssertionError(f"{name}: ids differ outside runs of ties")
    return int(chk.sum())


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    from rptree_tpu_torch import _cuda

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, build_s, _ = _cuda.build()
    _cuda.lib()
    log("setup", device=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        kernel_build_s=build_s)

    kern = check_kernels(device)
    for name, rec in kern.items():
        log("kernel", name=name, **rec)

    x, q = clustered_data(1_000_000, 128, 4_000, 0.15, 131_072)
    f, qd, truth, cell = build_cell(x, q, 128, 8, device)
    del x, q
    log("clustered_1m", **cell)
    serve = dict(budget=1, probes=8, tile_m=8, chunk=65536)
    bf16 = dict(dtype=torch.bfloat16)
    tiles, tiles_bf16, topk, topk_tiles = (
        "grouped_score_tiles", "grouped_score_tiles_bf16",
        "topk_dedup_kernel", "grouped_score_topk")
    variants = (  # (name, pack, serve, the kernels it runs, recall floor)
        ("a_f32_kernel_tail", {}, dict(selection="kernel"), {tiles, topk},
         CLUSTERED_MIN_RECALL),
        ("b_f32_sort_tail", {}, dict(selection="sort", impl="kernel"),
         {tiles}, CLUSTERED_MIN_RECALL),
        ("c_f32_kernel_topk", {}, dict(selection="sort", impl="kernel_topk"),
         {topk_tiles}, CLUSTERED_MIN_RECALL),
        ("d_bf16_sort_tail", bf16, dict(selection="sort", impl="kernel"),
         {tiles_bf16}, BF16_MIN_RECALL),
        ("e_bf16_kernel_topk", bf16,
         dict(selection="sort", impl="kernel_topk"), {topk_tiles},
         BF16_MIN_RECALL),
    )
    out, launches = {}, dict.fromkeys(kernel_counts(), 0)
    for name, pack, extra, runs, floor in variants:
        rec, out[name[0]] = serve_variant(name, f, qd, truth, pack,
                                          {**serve, **extra}, runs)
        log("launches", variant=name, **rec["launches"])
        for kname, n in rec["launches"].items():
            launches[kname] += n
        if name[0] in "ce":
            twin = chr(ord(name[0]) - 1)
            rec[f"same_as_{twin}_untied_ids"] = same_results(
                name, out[name[0]], out[twin])
        log(f"clustered_1m_{name}", **rec, jax_recall=JAX_RECALL["clustered"])
        if rec["recall_at_10"] < floor:
            raise AssertionError(f"{name}: recall {rec['recall_at_10']} < "
                                 f"{floor}")
    del f, qd, truth, out
    torch.cuda.empty_cache()
    x, q = iid_data(100_000, 128, 65_536)
    f, qd, truth, cell = build_cell(x, q, 64, 8, device)
    del x, q
    rec, _ = serve_variant("iid", f, qd, truth, dict(dtype=torch.int8, slack=8),
                           dict(budget=2, probes=10, tile_m=8, chunk=32768,
                                selection="kernel"),
                           {"grouped_score_tiles_int8", "topk_dedup_kernel"})
    log("launches", variant="iid_100k_int8", **rec["launches"])
    for kname, n in rec["launches"].items():
        launches[kname] += n
    log("iid_100k_int8", **cell, **rec, jax_recall=JAX_RECALL["iid"])
    if rec["recall_at_10"] < IID_MIN_RECALL:
        raise AssertionError(f"iid recall {rec['recall_at_10']} < "
                             f"{IID_MIN_RECALL}")
    log("launches", variant="all", **launches)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")

    sources = {
        "grouped_score_tiles": ("rptree_tpu_torch/csrc/grouped_score.cu",
                                "rptree_tpu/ops/grouped_kernel.py:63"),
        "grouped_score_tiles_bf16": ("rptree_tpu_torch/csrc/grouped_score.cu",
                                     "rptree_tpu/ops/grouped_kernel.py:63"),
        "grouped_score_tiles_int8": ("rptree_tpu_torch/csrc/grouped_score.cu",
                                     "rptree_tpu/ops/grouped_kernel.py:145"),
        "topk_dedup_kernel": ("rptree_tpu_torch/csrc/topk_dedup.cu",
                              "rptree_tpu/ops/topk_kernel.py:72"),
        "grouped_score_topk": ("rptree_tpu_torch/csrc/grouped_topk.cu",
                               "rptree_tpu/ops/grouped_kernel.py:233"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"],
         "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"]}
        for name, (src, rep) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
