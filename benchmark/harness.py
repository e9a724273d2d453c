"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The program under test (``rptree_tpu_torch``) gets the rows, the
projections and the queries that :mod:`.datagen` made from the seed;
the reference (:mod:`.reference`) gets the same tensors and nothing the
program made.  It runs once the window has closed, the peak memory has
been read and the program's state is freed.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from . import datagen, loops, roofline, spec, tracing
from .reference import check as rcheck
from .reference import forest as rforest

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
COMPARE_ROWS = 1 << 15
# passes over the query pool whose sampled answers are kept and compared
KEEP_PASSES = 256


class Run:
    """What a metric reader (``metrics/<name>.py``) reads."""

    def __init__(self, cell):
        self.cell = cell
        self.setup_s = None
        self.peak_bytes = None
        self.qps = None            # closed loop: queries / window second
        self.latency_s = None      # open loop: due to done, each request
        self.dispatch_s = None     # host seconds in each call (untraced)
        self.late_s = None         # open loop: lateness of each call
        self.recall = None
        self.trace = None          # tracing.Reduced of the traced window
        self.traced_queries = 0
        self.traced_batches = []
        self._least = None         # batch -> least seconds, by layer kind

    def range_seconds(self, names) -> float | None:
        """Device seconds of operations launched under the ranges."""
        if self.trace is None:
            return None
        return sum(self.trace.range_s.get(n, 0.0) for n in names)

    def us_per_kq(self, names) -> float | None:
        s = self.range_seconds(names)
        if not s or not self.traced_queries:
            return None
        return s * 1e6 / (self.traced_queries / 1000.0)

    def roofline_pct(self, kind: str, names) -> float | None:
        """The least time of the traced calls' work in layer ``kind``
        ("grouped" or "rerank") over its device time, in percent."""
        s = self.range_seconds(names)
        if not s or self._least is None or kind not in self._least:
            return None
        least = sum(self._least[kind][j] for j in self.traced_batches)
        return 100.0 * least / s


class GcPauses:
    """The collector's pauses while open: count, total and longest (s)."""

    def __init__(self):
        self.count, self.total, self.longest = 0, 0.0, 0.0
        self._t = None

    def _hook(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            d = time.perf_counter() - self._t
            self.count += 1
            self.total += d
            self.longest = max(self.longest, d)

    def __enter__(self):
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._hook)

    def as_dict(self) -> dict:
        return {"collections": self.count, "seconds": self.total,
                "longest_s": self.longest}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pack_kwargs(pack: dict) -> dict:
    kw = dict(pack)
    if "dtype" in kw:
        kw["dtype"] = DTYPES[kw["dtype"]]
    return kw


class Served:
    """A cell's inputs and its index, set up and warm: ``call(j)`` serves
    pool batch ``j`` through the cell's entry."""

    def __init__(self, cell, seed: int, dev: torch.device, t_start: float,
                 pack: dict = None, wrap=None):
        cfg, tr = cell.config, cell.traffic
        ix, data = cfg["index"], cfg["data"]
        cuda = dev.type == "cuda"
        self.dev, self.t_start, self._last = dev, t_start, t_start
        self.phases = {}
        phase = self.phase

        if cuda:
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)
            torch.cuda.reset_peak_memory_stats(dev)
        phase("cuda_context")
        import rptree_tpu_torch as rt
        phase("import")
        if cuda:
            from rptree_tpu_torch import _cuda
            _cuda.lib()
        phase("library")

        g = datagen.generator(seed, dev)
        self.x, self.pool = datagen.mixture(
            g, cfg["n"], cfg["dim"], data["centers"], data["sigma"],
            data["pool"], data["query_noise"])
        self.r = datagen.projections(g, ix["n_trees"], ix["max_depth"],
                                     cfg["dim"], ix["pnz"])
        phase("data")
        self.forest = rt.forest_batch(
            seed % (1 << 63), ix["max_depth"], ix["min_leaf"], ix["n_trees"],
            ix["pnz"], self.x, device=dev, r=self.r)
        phase("build")
        self.pack_kw = _pack_kwargs(ix.get("pack", {}) if pack is None
                                    else pack)
        self.forest.pack_leaves(**self.pack_kw)
        phase("pack")

        self.k = cfg["k"]
        self.b = b = tr["batch"]
        self.n_batches = data["pool"] // b
        self.batches = [self.pool[j * b:(j + 1) * b]
                        for j in range(self.n_batches)]
        query = {key: ix[key] for key in ("budget", "probes", "selection",
                                          "precision", "metric")}
        entry = getattr(self.forest, tr["entry"])
        self.entry = entry if wrap is None else wrap(entry)
        self.kwargs = {**query, **tr.get("kwargs", {})}
        self.entry(self.batches[0], self.k,
                   **{**self.kwargs, **tr.get("warm", {})})
        out = self.call(0)
        self.out_dtypes = (out[0].dtype, out[1].dtype)
        del out
        # set-up's objects go to the collector's permanent generation, so
        # that a full collection in the window scans only what it made
        gc.collect()
        gc.freeze()
        phase("warm")

    def phase(self, name) -> None:
        """Close set-up phase ``name``: its seconds, once the device is
        done."""
        _sync(self.dev)
        now = time.perf_counter()
        self.phases[name] = now - self._last
        self._last = now

    @property
    def setup_s(self) -> float:
        """Process start to the end of the last phase."""
        return self._last - self.t_start

    def call(self, j):
        return self.entry(self.batches[j], self.k, **self.kwargs)

    def free(self) -> None:
        """Drop the program's state (the index and its entry)."""
        self.forest = self.entry = None
        gc.unfreeze()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def device_of(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: float = None, cell=None, pack: dict = None,
        wrap=None, log=sys.stderr) -> dict:
    """One run; returns the result line's object.  ``cell`` replaces the
    cell's files (tests), ``pack`` the index's ``pack_leaves`` arguments
    (the lower-precision control), and ``wrap(entry)`` the served entry
    (the fault tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or spec.cell(workload)
    cfg, tr = cell.config, cell.traffic
    ix = cfg["index"]
    dev = device_of(device)
    cuda = dev.type == "cuda"
    sv = Served(cell, seed, dev, t_start, pack, wrap)
    x, pool, r, k, b = sv.x, sv.pool, sv.r, sv.k, sv.b
    n_batches, call, pack_kw = sv.n_batches, sv.call, sv.pack_kw

    # the sampled pool positions (ascending), and host buffers for their
    # answers
    pos = datagen.sample_positions(seed, n_batches * b, tr["sample"])
    keep = Kept(pos, n_batches, b, k, sv.out_dtypes, dev)
    sv.phase("sample")

    def window(sec, traced):
        if tr["loop"] == "closed":
            return loops.closed(call, keep, n_batches, sec, tr["in_flight"],
                                dev, traced)
        due = datagen.arrival_times(seed, tr["rate_per_s"], sec)
        return loops.open_loop(call, keep, n_batches, due, dev, traced)

    res = Run(cell)
    res.setup_s = sv.setup_s
    reduced = None
    with GcPauses() as pauses:
        if trace:
            # half the window untraced for the host's clock, half traced
            plain = window(seconds / 2, False)
            with tracing.profiler(cuda) as prof:
                with tracing.record_function(tracing.WINDOW):
                    traced = window(seconds / 2, True)
            reduced = tracing.reduce(prof.profiler.kineto_results.events())
            wins = [plain, traced]
            res.trace = reduced
            res.traced_batches = list(traced.batches)
            res.traced_queries = len(traced.batches) * b
        else:
            plain = window(seconds, False)
            wins = [plain]
    res.peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    res.dispatch_s = plain.dispatch_s
    res.late_s = plain.late_s
    if tr["loop"] == "closed":
        res.qps = len(plain.batches) * b / (plain.end - plain.start)
    else:
        res.latency_s = [d - t for d, t in zip(plain.done, plain.due)]
    attempted = sum(len(w.batches) for w in wins) * b
    failed = sum(w.failed for w in wins) * b
    overflow = None
    if "overflow_tiles" in cell.limits:
        overflow = _overflow_tiles(sv, {j for w in wins for j in w.batches})

    # the program's state goes before the reference runs
    sv.free()

    t_ref = time.perf_counter()
    rf = rforest.build_forest(x, r, ix["max_depth"], ix["min_leaf"])
    qs = pool[pos.to(dev)]
    ref_d = rforest.answers(rf, x, qs, k, ix["budget"], ix["probes"])
    truth = rforest.scan_topk(x, qs, k)
    numbers = _compare(x, qs, keep, ref_d, truth)
    numbers["overflow_tiles"] = overflow
    res.recall = numbers.pop("recall")
    if trace:
        res._least = _least_seconds(rf, cfg, tr, pool, set(res.traced_batches),
                                    b, pack_kw)
    ref_s = time.perf_counter() - t_ref

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"], cell.root)(res)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    limits = cell.limits
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in limits}
    correct = (numbers["answers"] > 0 and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda
                      else "cpu",
                      "count": 1, "memory_peak_bytes": int(res.peak_bytes)}}
    if reduced is not None:
        out["device"]["busy_s"] = reduced.busy_s
        out["device"]["window_s"] = reduced.window_s
        out["breakdown"] = {"device_ops": reduced.device_ops,
                            "idle_gaps": reduced.idle_gaps}
        out["trace_ops"] = {"ops": reduced.n_ops,
                            "unlinked": reduced.n_unlinked}
    out["setup_phases"] = sv.phases
    out["gc_pauses"] = pauses.as_dict()
    out["reference_s"] = ref_s
    out["compared"] = {"answers": numbers["answers"],
                       "misses": numbers["misses"]}
    if cuda:
        out["card"] = roofline.card()
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=log)
    return out


class Kept:
    """``keep(j, out)``: the answers of the window's calls to the sampled
    pool positions, copied as they are served into host buffers allocated
    before the window (pinned on a card, the copies asynchronous), so
    that the device's memory, and its peak, hold none of them.  The
    answers of the first :data:`KEEP_PASSES` passes over the pool are
    kept."""

    def __init__(self, pos, n_batches, b, k, dtypes, dev):
        self.pos = pos
        # each batch's share of the positions: its first index into
        # ``pos``, and its rows within the batch
        self.edges = torch.searchsorted(
            pos, torch.arange(n_batches + 1) * b).tolist()
        self.rows_of = [(pos[self.edges[j]:self.edges[j + 1]] - j * b).to(dev)
                        for j in range(n_batches)]
        cap = pos.numel() * KEEP_PASSES
        pin = dev.type == "cuda"
        self.d = torch.empty((cap, k), dtype=dtypes[0], pin_memory=pin)
        self.ids = torch.empty((cap, k), dtype=dtypes[1], pin_memory=pin)
        self.blocks = []     # (first index into ``pos``, count): in order
        self.used = 0

    def __call__(self, j, out) -> None:
        rows = self.rows_of[j]
        m = rows.numel()
        if not m or self.used + m > self.d.shape[0]:
            return
        s = slice(self.used, self.used + m)
        self.d[s].copy_(out[0].index_select(0, rows), non_blocking=True)
        self.ids[s].copy_(out[1].index_select(0, rows), non_blocking=True)
        self.blocks.append((self.edges[j], m))
        self.used += m


def _overflow_tiles(sv, batches) -> int | float:
    """Tiles beyond their capacity that the grouped calls of the window
    needed, summed over the pool batches they served.  Each batch is
    served once more as the window served it, after the window: the
    capacity is the one learned at set-up (``check=False`` never changes
    it), so each batch needs what it needed in the window, and the
    program reports the need (``grouped_overflow()``).  A call that
    raises reads +inf."""
    total = 0
    for j in sorted(batches):
        try:
            sv.call(j)
            o = sv.forest.grouped_overflow()
        except Exception:  # a fault of the program: the run is not correct
            return float("inf")
        total += max(0, o["needed"] - o["capacity"])
    return total


def _compare(x, qs, kept: Kept, ref_d, truth) -> dict:
    """The check's numbers over every kept answer, and recall@k: ``qs``
    are the sampled queries, ``ref_d`` and ``truth`` the reference's
    distances and the exact ids for them."""
    if not kept.blocks:
        return {"miss_share": float("inf"), "dist_err": float("inf"),
                "holes": float("inf"), "answers": 0, "misses": 0,
                "recall": 0.0}
    _sync(x.device)
    at = torch.cat([torch.arange(first, first + m)
                    for first, m in kept.blocks])
    misses = answers = holes = 0
    err = hits = 0.0
    for s in range(0, kept.used, COMPARE_ROWS):
        sl = slice(s, min(s + COMPARE_ROWS, kept.used))
        i = at[sl].to(qs.device)
        d = kept.d[sl].to(qs.device)
        ids = kept.ids[sl].to(qs.device)
        c = rcheck.compare(x, qs[i], d, ids, ref_d[i])
        misses += c["misses"]
        holes += c["holes"]
        answers += c["answers"]
        err = max(err, c["dist_err"])
        hits += rcheck.recall(ids, truth[i]) * c["answers"]
    return {"miss_share": misses / answers, "dist_err": err, "holes": holes,
            "answers": answers, "misses": misses, "recall": hits / answers}


def _least_seconds(rf, cfg, tr, pool, batches, b, pack_kw) -> dict:
    """Each traced batch's least time, by layer kind, from the reference's
    pairs: the grouped layer on blocks, the per-pair rerank on the
    configured layout, a chunk at a time as the call serves it."""
    ix = cfg["index"]
    chunk = tr.get("kwargs", {}).get("chunk") or b
    itemsize = torch.empty((), dtype=pack_kw.get("dtype", torch.float32)
                           ).element_size()
    shared = pack_kw.get("store") == "shared"
    lens = rf.plan.leaf_len.to(pool.device)
    out = {"grouped": {}, "rerank": {}}
    for j in sorted(batches):
        tree, leaf = rforest.probes(rf, pool[j * b:(j + 1) * b],
                                    ix["budget"], ix["probes"])
        total = {"grouped": 0.0, "rerank": 0.0}
        for s in range(0, b, chunk):
            args = (tree[s:s + chunk], leaf[s:s + chunk], lens,
                    rf.leaf_table, cfg["n"], cfg["dim"], cfg["k"], itemsize)
            total["grouped"] += roofline.least_seconds(
                *roofline.chunk_work(*args, shared=False))
            total["rerank"] += roofline.least_seconds(
                *roofline.chunk_work(*args, shared=shared))
        for kind in out:
            out[kind][j] = total[kind]
    return out
