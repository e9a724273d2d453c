"""Where the time of the serving paths goes, on one NVIDIA GPU: the stage
times of one iid 100k chunk (32,768 queries, int8 blocks, ``chip_smoke.py``'s
phase-4 cell) with the kernel tail, and of one clustered 1M chunk (65,536
queries, the phase-3 cell) under the grouped path's three selection tails,
on f32 and bf16 blocks, with the device time by kernel of one whole call of
each; then the stages of one per-pair chunk (2,048 queries, variant f) and
the time of one bf16 scan chunk (2,048 queries over the 1M rows), with its
bf16 row copy timed apart.  The traversal + probe stage of the iid,
clustered and per-pair chunks (kernels 7 and 8) is also timed against its
plain form in turns, with its spread over calls (``descent_turns``), and
so is the tile-table stage of the iid and clustered chunks (kernel 9,
``tables_turns``).
Where an earlier commit's sources sit in
``_checkout/base`` (git-ignored), it times that build against this tree's
in turns (old, new, new, old): kernels 1 to 4 (``git show
21888d1:rptree_tpu_torch/csrc/<name>`` for each of ``GROUPED_BASE``) at
``chip_smoke.py``'s phase-2 shapes, kernel 3 at a chunk's 65,536 x 1,024,
kernel 2 on the iid chunk's own tiles (the earlier kernel 2 both with the
plain-torch query operands its wrapper made and as its launch alone, and
the operands apart), and kernels 1, 3 and 4 on the clustered chunk's own
operands, each also checked for the same bits; kernels 5 and 6 where
``scan_topk.cu`` and ``gather_score.cu`` of an earlier commit sit there
too, at the phase-2 shapes and the 1M scan chunk.  With ``--turns``,
kernels 10 and 11 of the commit whose ``project.cu`` and ``ell_score.cu``
sit there (``git show a42fc83:rptree_tpu_torch/csrc/<name>``), at the
served shapes (``sparse_turns``), each checked for the same bits; and
kernels 7 and 8 of the commit whose ``traverse.cu`` and ``common.cuh``
sit there (``git show 15c5dfb:...``) behind that commit's wrappers, at
every ``DESCENTS`` shape and on the cells' own chunks
(``descent_base_turns``): CUDA events, device time, each wrapper's host
time a call, the same bits; then each wrapper's host time item by item
beside kernel 11's and the stable sort's (``host_breakdown``); and
kernels 9 and 6 of the commit whose ``tile_tables.cu``, ``gather_score.cu``
and ``common.cuh`` sit there (``git show d31cc2c:...``) behind that
commit's wrappers: kernel 9 at every ``TABLES`` shape and on the cells'
chunks' own pairs (the clustered, iid and 10M grouped chunks), kernel 6's
shared-row mode by both this tree's routes at phase 2's shape and on (n)'s
and the 10M cell's per-pair chunks (``shared_base_turns``), with kernel
9's host time item by item (``tables_host_breakdown``).  ``--turns
--tune`` instead gives the design readings: kernel 9's device time by
kernel, and kernel 6's query route at other ring plans beside an
``index_select`` of the same rows (``tune``; ``--tables-only`` stops after
kernel 9).

    python3 chip_stages.py            # on the card
    python3 chip_stages.py --cpu      # a tiny rehearsal on the CPU
    python3 chip_stages.py --shared-10m   # only the 10M shared-row cell
                                          # (add --cpu to rehearse it)
    python3 chip_stages.py --sparse       # only the bag-of-words ELL cell
                                          # (add --cpu to rehearse it)
    python3 chip_stages.py --turns        # only kernels 6-11 against an
                                          # earlier build's

Each stage runs as the serving path runs it (``_knn_grouped``), between
two ``torch.cuda.synchronize`` calls, seven times; the line gives the
median on the host clock in ms, so launch latency is not overlapped
between stages.  The sums are per tail:

- kernel tail (``selection="kernel"``): traversal, tile tables (kernel
  9), query gather, tile scoring (kernel 1, or kernel 2 on int8 blocks),
  pair reorder, id gather, kernel 3;
- sort tail (``selection="sort", impl="kernel"``): the same up to the id
  gather, then the stable sort, its first ``kk`` and ``merge_top_k``;
- ``impl="kernel_topk"`` (f32 and bf16 blocks): traversal, tile tables,
  query gather, kernel 4, the pair reorder of its ``(d, ids)`` and the
  sort tail over them;
- the XLA-form scorer (``grouped_distances``, ``impl="xla"`` and the
  metrics the tile kernels do not serve) on ``l2`` and ``cosine``, its
  tile tables and pair reorder included, apart.

On the card it first times the kernel build two ways from the same
sources: one ``nvcc`` over all of them, and ``_cuda.build``'s one
process per source plus a link; with an earlier commit's sources it also
times their compile against this tree's, in turns.  One JSON object per line; it never
imports JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

K, TILE_M, PROBES, BUDGET = 10, 8, 8, 1
IID_PROBES, IID_BUDGET = 10, 2  # the iid cell's


def timed(fn, sync, reps=7):
    """``(fn(), median ms)`` over ``reps`` synchronised runs."""
    ts, res = [], None
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    return res, float(np.median(ts))


def build_times():
    """Seconds of ``_cuda.build`` (one ``nvcc`` per source, then a link)
    before and after one ``nvcc`` over every source, each from nothing."""
    from rptree_tpu_torch import _cuda

    cus, _ = _cuda._sources()
    path, _, _ = _cuda.build()
    path.unlink()
    _, first, _ = _cuda.build()
    with tempfile.TemporaryDirectory(dir=_cuda._BUILD) as tmp:
        t0 = time.perf_counter()
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                        os.path.join(tmp, "one.so"), *map(str, cus)],
                       check=True, capture_output=True)
        one = time.perf_counter() - t0
    path.unlink()
    _, last, _ = _cuda.build()
    return {"sources": len(cus), "one_nvcc_s": one,
            "one_nvcc_per_source_s": [first, last]}


def compile_s(srcs):
    """Seconds to compile ``srcs`` as ``_cuda.build`` does: one ``nvcc -c``
    per source, all started together (no link)."""
    from rptree_tpu_torch import _cuda

    with tempfile.TemporaryDirectory(dir=_cuda._BUILD) as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda._CSRC), "-c",
             str(p), "-o", os.path.join(tmp, f"{i}.o")],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for i, p in enumerate(srcs)]
        if any([p.wait() for p in procs]):
            raise RuntimeError("nvcc failed")
        return time.perf_counter() - t0


# this tree's sources that the earlier commit in _checkout/base lacks
NEW_SOURCES = ("grouped_score_i8.cu", "traverse.cu")


def build_turns(src):
    """The earlier commit's build (its sources at ``src``, this tree's for
    the kernels ``src`` does not hold, less ``NEW_SOURCES``) against this
    tree's, each compiled as :func:`compile_s`, in turns old, new, new,
    old."""
    from pathlib import Path

    from rptree_tpu_torch import _cuda

    cus, _ = _cuda._sources()
    base = [Path(src) / p.name if (Path(src) / p.name).exists() else p
            for p in cus if p.name not in NEW_SOURCES]
    ts = [compile_s(base), compile_s(cus), compile_s(cus), compile_s(base)]
    return {"base_s": (ts[0] + ts[3]) / 2, "tree_s": (ts[1] + ts[2]) / 2,
            "turns_s": ts}


def base_lib(src):
    """An earlier commit's kernels 5 and 6 (their sources at ``src``: ``git
    show a0583c7:rptree_tpu_torch/csrc/<name>`` for ``scan_topk.cu`` and
    ``gather_score.cu``) built into one library under other symbol names."""
    import ctypes

    from rptree_tpu_torch import _cuda

    out = os.path.join(src, "libbase.so")
    renames = [f"-D{n}={n}_base" for n in (
        "rpt_scan_topk", "rpt_gather_score_f32", "rpt_gather_score_bf16")]
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *renames, "-I",
                    str(_cuda._CSRC), "-shared", "-o", out,
                    os.path.join(src, "scan_topk.cu"),
                    os.path.join(src, "gather_score.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    p, i, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.rpt_scan_topk_base.argtypes = [p] * 7 + [l_] + [i] * 5 + [l_, p]
    for name in ("rpt_gather_score_f32_base", "rpt_gather_score_bf16_base"):
        getattr(lib, name).argtypes = [p] * 6 + [i] * 5 + [p]
    return lib


GROUPED_BASE = ("grouped_score.cu", "grouped_topk.cu", "topk_dedup.cu",
                "grouped_tile.cuh")


def base_grouped_lib(src):
    """An earlier commit's kernels 1 to 4 (their sources at ``src``: ``git
    show 21888d1:rptree_tpu_torch/csrc/<name>`` for each of
    ``GROUPED_BASE``) built into one library under other symbol names."""
    import ctypes

    from rptree_tpu_torch import _cuda

    out = os.path.join(src, "libbase_grouped.so")
    renames = [f"-D{n}={n}_base" for n in (
        "rpt_grouped_score_f32", "rpt_grouped_score_bf16",
        "rpt_grouped_score_i8", "rpt_error_string", "rpt_topk_dedup",
        "rpt_grouped_topk_f32", "rpt_grouped_topk_bf16")]
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *renames, "-I",
                    str(_cuda._CSRC), "-shared", "-o", out,
                    *(os.path.join(src, n) for n in GROUPED_BASE
                      if n.endswith(".cu"))],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    p, i, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for name in ("rpt_grouped_score_f32_base", "rpt_grouped_score_bf16_base"):
        getattr(lib, name).argtypes = [p] * 6 + [i] * 6 + [p]
    for name in ("rpt_grouped_topk_f32_base", "rpt_grouped_topk_bf16_base"):
        getattr(lib, name).argtypes = [p] * 8 + [i] * 7 + [p]
    lib.rpt_topk_dedup_base.argtypes = [p] * 4 + [l_, i, i, i, i, p]
    # x, sq, scale_t, tb, lens, q, qscale, qq, out, nt, g, tile_m, lmax, d,
    # l2, words, stream: kernel 2 as it was before the quantization moved in
    lib.rpt_grouped_score_i8_base.argtypes = [p] * 9 + [i] * 7 + [p]
    return lib


def base_tiles(lib, x, sq, tb, lens, qt, tile_m):
    """The earlier kernel 1 (f32 or bf16 blocks), metric l2."""
    from rptree_tpu_torch import _cuda

    g, lmax, d = x.shape
    nt = tb.shape[0]
    out = torch.empty((nt * tile_m, lmax), device=x.device)
    fn = (lib.rpt_grouped_score_bf16_base if x.dtype == torch.bfloat16
          else lib.rpt_grouped_score_f32_base)
    code = fn(*map(_cuda.ptr, (x, sq, tb, lens, qt, out)), nt, g, tile_m,
              lmax, d, 1, _cuda.stream_of(x))
    assert code == 0, code
    return out


def base_int8_tiles(lib, x, sq, scale, tb, lens, qt, tile_m, ops=None):
    """The earlier kernel 2, metric l2: its launch alone on operands made
    before (``ops``, :func:`_int8_operands`'s), or with the plain-torch
    operands made first, as its wrapper made them."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import grouped_kernel as gk

    q_i8, qscale, qq, scale_t = (ops if ops is not None
                                 else gk._int8_operands(scale, tb, qt))
    g, lmax, d = x.shape
    nt = tb.shape[0]
    out = torch.empty((nt * tile_m, lmax), device=x.device)
    words = int(d % 4 == 0 and x.data_ptr() % 4 == 0)
    code = lib.rpt_grouped_score_i8_base(
        *map(_cuda.ptr, (x, sq, scale_t, tb, lens, q_i8, qscale, qq, out)),
        nt, g, tile_m, lmax, d, 1, words, _cuda.stream_of(x))
    assert code == 0, code
    return out


def base_topk_tiles(lib, x, sq, ids, tb, lens, qt, tile_m, kp):
    """The earlier kernel 4, metric l2."""
    from rptree_tpu_torch import _cuda

    g, lmax, d = x.shape
    nt = tb.shape[0]
    od = torch.empty((nt * tile_m, kp), device=x.device)
    oi = torch.empty((nt * tile_m, kp), dtype=torch.int32, device=x.device)
    fn = (lib.rpt_grouped_topk_bf16_base if x.dtype == torch.bfloat16
          else lib.rpt_grouped_topk_f32_base)
    code = fn(*map(_cuda.ptr, (x, sq, ids, tb, lens, qt, od, oi)), nt, g,
              tile_m, lmax, d, 1, kp, _cuda.stream_of(x))
    assert code == 0, code
    return od, oi


def base_topk(lib, d, ids, k):
    """The earlier kernel 3, with dedup, on its register route where the
    row fits (``topk_route``)."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import topk_kernel as tk

    b, w = d.shape
    od = torch.empty((b, k), device=d.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=d.device)
    code = lib.rpt_topk_dedup_base(*map(_cuda.ptr, (d, ids, od, oi)), b, w,
                                   k, 1, tk.topk_route(w),
                                   _cuda.stream_of(d))
    assert code == 0, code
    return od, oi


def same_bits(a, b):
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def grouped_turns(lib, label, x, sq, ids, tb, lens, qt, kp):
    """Kernels 1 and 4, the earlier build against this tree's in turns on
    these tiles (l2), with whether both give the same bits and their
    largest relative difference; one JSON line each."""
    from rptree_tpu_torch.ops import grouped_kernel as gk

    kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
    new = gk.grouped_score_tiles(x, sq, tb, lens, qt, "l2", TILE_M)
    old = base_tiles(lib, x, sq, tb, lens, qt, TILE_M)
    rel = cs._rel_err(new, old)[1]
    same = same_bits(new, old)
    o, n, raw = turns(lambda: base_tiles(lib, x, sq, tb, lens, qt, TILE_M),
                      lambda: gk.grouped_score_tiles(x, sq, tb, lens, qt,
                                                     "l2", TILE_M))
    do, dn, draw = device_turns(
        lambda: base_tiles(lib, x, sq, tb, lens, qt, TILE_M),
        lambda: gk.grouped_score_tiles(x, sq, tb, lens, qt, "l2", TILE_M))
    b = cs.tile_bound(x, tb, lens, TILE_M, qt, x.shape[1] * 4, kind)
    print(json.dumps({"base_vs_tree": f"grouped_score_tiles_{kind}",
                      "tiles": label, "base_ms": o, "tree_ms": n,
                      "speedup": o / n, "turns_ms": raw,
                      "base_device_ms": do, "tree_device_ms": dn,
                      "device_turns_ms": draw, "rel_err": rel,
                      "same_bits": same, "bound_ms": b["bound_ms"]}),
          flush=True)
    new = gk.grouped_score_topk(x, sq, ids, tb, lens, qt, "l2", TILE_M, kp)
    old = base_topk_tiles(lib, x, sq, ids, tb, lens, qt, TILE_M, kp)
    rel = cs._rel_err(new[0], old[0])[1]
    same = same_bits(new[0], old[0]) and bool(torch.equal(new[1], old[1]))
    o, n, raw = turns(
        lambda: base_topk_tiles(lib, x, sq, ids, tb, lens, qt, TILE_M, kp),
        lambda: gk.grouped_score_topk(x, sq, ids, tb, lens, qt, "l2", TILE_M,
                                      kp))
    do, dn, draw = device_turns(
        lambda: base_topk_tiles(lib, x, sq, ids, tb, lens, qt, TILE_M, kp),
        lambda: gk.grouped_score_topk(x, sq, ids, tb, lens, qt, "l2", TILE_M,
                                      kp))
    b = cs.tile_bound(x, tb, lens, TILE_M, qt, kp * 8, kind, ids=True)
    print(json.dumps({"base_vs_tree": f"grouped_score_topk_{kind}",
                      "tiles": label, "kp": kp, "base_ms": o, "tree_ms": n,
                      "speedup": o / n, "turns_ms": raw,
                      "base_device_ms": do, "tree_device_ms": dn,
                      "device_turns_ms": draw, "rel_err": rel,
                      "same_bits": same, "bound_ms": b["bound_ms"]}),
          flush=True)


def int8_turns(lib, label, x, sq, scale, tb, lens, qt):
    """Kernel 2, the earlier build (its launch with the plain-torch
    operands its wrapper made, and its launch alone) against this tree's
    in turns on these tiles (l2), by CUDA events and by device time, with
    the operands timed apart and the two builds' largest relative
    difference.  One JSON line."""
    from rptree_tpu_torch.ops import grouped_kernel as gk

    new = gk.grouped_score_tiles_int8(x, sq, scale, tb, lens, qt, "l2",
                                      TILE_M)
    old = base_int8_tiles(lib, x, sq, scale, tb, lens, qt, TILE_M)
    rel = cs._rel_err(new, old)[1]
    ops = gk._int8_operands(scale, tb, qt)
    fns = (lambda: base_int8_tiles(lib, x, sq, scale, tb, lens, qt, TILE_M),
           lambda: base_int8_tiles(lib, x, sq, scale, tb, lens, qt, TILE_M,
                                   ops),
           lambda: gk.grouped_score_tiles_int8(x, sq, scale, tb, lens, qt,
                                               "l2", TILE_M))
    o, ol, n, raw = turns(*fns)
    do, dol, dn, draw = device_turns(*fns)
    b = cs.tile_bound(x, tb, lens, TILE_M, qt, x.shape[1] * 4, "int8")
    print(json.dumps({
        "base_vs_tree": "grouped_score_tiles_int8", "tiles": label,
        "nt": tb.shape[0], "lmax": x.shape[1], "D": x.shape[2],
        "base_ms": o, "base_launch_ms": ol,
        "base_operands_ms": cs.cuda_ms(
            lambda: gk._int8_operands(scale, tb, qt), 10),
        "tree_ms": n, "speedup": o / n, "launch_speedup": ol / n,
        "turns_ms": raw, "base_device_ms": do, "base_launch_device_ms": dol,
        "base_operands_device_ms": cs.graph_ms(
            lambda: gk._int8_operands(scale, tb, qt)),
        "tree_device_ms": dn, "device_speedup": do / dn,
        "launch_device_speedup": dol / dn, "device_turns_ms": draw,
        "rel_err": rel, "same_bits": same_bits(new, old),
        "bound_ms": b["bound_ms"]}), flush=True)


def topk_turns(lib, label, d, ids):
    """Kernel 3 (dedup, k = K), the earlier build against this tree's in
    turns, after checking that both give the same bits."""
    from rptree_tpu_torch.ops import topk_kernel as tk

    new, old = tk.topk_dedup_kernel(d, ids, K), base_topk(lib, d, ids, K)
    same = same_bits(new[0], old[0]) and bool(torch.equal(new[1], old[1]))
    fns = (lambda: base_topk(lib, d, ids, K),
           lambda: tk.topk_dedup_kernel(d, ids, K))
    o, n, raw = turns(*fns)
    do, dn, draw = device_turns(*fns)
    b, w = d.shape
    print(json.dumps({"base_vs_tree": "topk_dedup_kernel", "rows": label,
                      "B": b, "W": w, "k": K, "base_ms": o, "tree_ms": n,
                      "speedup": o / n, "turns_ms": raw,
                      "base_device_ms": do, "tree_device_ms": dn,
                      "device_turns_ms": draw, "same_bits": same,
                      "bound_ms": cs.bound(b * w * 8 + b * K * 8, b * w,
                                           "f32")["bound_ms"]}), flush=True)


def compare_grouped_base(lib):
    """The earlier kernels 1 to 4 against this tree's at the shapes of
    ``chip_smoke.py``'s phase 2 (tiles in random and in block order) and
    kernel 3 at a real chunk's 65,536 x 1,024."""
    dev = torch.device("cuda", 0)
    g = nt = 4096
    x, sq, scale, tb, lens, qt = cs.tile_inputs(g, 64, 128, nt, TILE_M, True,
                                                dev)
    int8_turns(lib, "random", x, sq, scale, tb, lens, qt)
    tbo, lenso = cs.block_order(g, 64, nt, dev)
    int8_turns(lib, "block_order", x, sq, scale, tbo, lenso, qt)
    for bf16 in (False, True):
        x, sq, _, tb, lens, qt = cs.tile_inputs(g, 128, 128, nt, TILE_M,
                                                False, dev, bf16=bf16)
        ids = torch.randperm(g * 128, generator=torch.Generator().manual_seed(
            3)).to(torch.int32).reshape(g, 128).to(dev)
        grouped_turns(lib, "random", x, sq, ids, tb, lens, qt, cs.KP)
        tbo, lenso = cs.block_order(g, 128, nt, dev)
        grouped_turns(lib, "block_order", x, sq, ids, tbo, lenso, qt, cs.KP)
    for b, w in ((8192, 1024), (8192, 640), (65536, 1024)):
        d, ids = cs.topk_inputs(b, w, dev)
        topk_turns(lib, "phase2" if b == 8192 else "chunk", d, ids)
    torch.cuda.empty_cache()


def base_scan(lib, x, sq, q, k):
    """The earlier kernel 5, on f32 rows, with its own row ranges."""
    from rptree_tpu_torch import _cuda

    (n, d), b = x.shape, q.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(-(-4 * sms // -(-b // 128)), -(-n // 256)))
    rows = -(-n // splits)
    rows = -(-rows // 64) * 64
    splits = -(-n // rows)
    pd = torch.empty((splits, b, k), device=x.device)
    pi = torch.empty((splits, b, k), dtype=torch.int32, device=x.device)
    od = torch.empty((b, k), device=x.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=x.device)
    code = lib.rpt_scan_topk_base(*map(_cuda.ptr, (x, sq, q, pd, pi, od, oi)),
                                 n, b, d, k, 0, splits, rows,
                                 _cuda.stream_of(x))
    assert code == 0, code
    return od, oi


def base_gather(lib, x, sq, q, sel):
    """The earlier kernel 6: one thread block per (query, probe) pair."""
    from rptree_tpu_torch import _cuda

    g, lmax, d = x.shape
    b, p = sel.shape
    dots = torch.empty((b, p, lmax), device=x.device)
    sqx = torch.empty((b, p, lmax), device=x.device)
    fn = (lib.rpt_gather_score_bf16_base if x.dtype == torch.bfloat16
          else lib.rpt_gather_score_f32_base)
    code = fn(*map(_cuda.ptr, (x, sq, q, sel, dots, sqx)), b, p, g, lmax, d,
              _cuda.stream_of(x))
    assert code == 0, code
    return dots, sqx


def turns(*fns, clock=cs.cuda_ms, reps=10):
    """``(ms of each of fns..., raw)``: each the mean of two timings by
    ``clock`` (``cs.cuda_ms``: CUDA events over ``reps`` calls back to
    back; ``cs.graph_ms``: device time, the calls replayed from a CUDA
    graph), taken in the turns f0 .. fk, fk .. f0 (old, new, new, old for
    two)."""
    first = [clock(fn, reps) for fn in fns]
    last = [clock(fn, reps) for fn in reversed(fns)][::-1]
    return (*[(a + b) / 2 for a, b in zip(first, last)],
            first + last[::-1])


def device_turns(*fns):
    return turns(*fns, clock=cs.graph_ms, reps=20)


def compare_base(src):
    """The earlier kernels 5 and 6 against this tree's, in turns in this call,
    at the shapes of ``chip_smoke.py``'s phase 2 and the 1M scan chunk."""
    from rptree_tpu_torch.ops import fused_gather as fg
    from rptree_tpu_torch.ops import scan as sc

    lib = base_lib(src)
    dev = torch.device("cuda", 0)
    for n, b in ((100_000, 4096), (1_000_000, 2048)):
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(n, 128, generator=gen, device=dev)
        q = x[torch.randint(0, n, (b,), generator=gen, device=dev)]
        q += 0.1 * torch.randn(b, 128, generator=gen, device=dev)
        sq = (x * x).sum(-1)
        rows = sc.scan_rows(x, sq)
        old, new, raw = turns(lambda: base_scan(lib, x, sq, q, K),
                              lambda: sc._scan_partial(x, sq, q, K, "l2", rows))
        print(json.dumps({"base_vs_tree": "scan_topk", "N": n, "B": b, "D": 128,
                          "k": K, "base_ms": old, "tree_ms": new,
                          "speedup": old / new, "turns_ms": raw,
                          "tree_cast_ms": cs.cuda_ms(
                              lambda: sc.scan_rows(x, sq), 10)}), flush=True)
        del x, q, sq, rows
        torch.cuda.empty_cache()
    cases = (("gather_score", False, (8192, 128, 128, 2048, 8)),
             ("gather_score_bf16", True, (8192, 128, 128, 2048, 8)),
             ("gather_score_bf16_bracket", True, (1024, 3128, 128, 32, 32)))
    for name, bf16, (g, lmax, d, b, p) in cases:
        x, sq, q, sel = cs.gather_inputs(g, lmax, d, b, p, bf16, dev,
                                         seed=g + p)
        old, new, raw = turns(lambda: base_gather(lib, x, sq, q, sel),
                              lambda: fg.gather_score(x, sq, q, sel))
        runs_ms = cs.cuda_ms(lambda: fg._pair_runs(sel, g), 10)
        # the step before the block-major design: the earlier kernel on the
        # pairs in block order (L2 serves the repeats; the query gather
        # untimed)
        order = torch.sort(sel.reshape(-1), stable=True).indices
        sel_s = sel.reshape(-1)[order].reshape(-1, 1).contiguous()
        q_s = q[order // p].contiguous()
        sorted_ms = cs.cuda_ms(lambda: base_gather(lib, x, sq, q_s, sel_s), 10)
        print(json.dumps({"base_vs_tree": name, "blocks": g, "lmax": lmax,
                          "D": d, "B": b, "P": p, "base_ms": old,
                          "tree_ms": new, "speedup": old / new,
                          "turns_ms": raw, "tree_pair_runs_ms": runs_ms,
                          "base_sorted_pairs_ms": sorted_ms}),
              flush=True)
        del x, sq, q, sel, q_s, sel_s
        torch.cuda.empty_cache()


SPARSE_BASE = ("project.cu", "ell_score.cu")


def base_sparse_lib(src):
    """An earlier commit's kernels 10 and 11 (their sources at ``src``:
    ``git show a42fc83:rptree_tpu_torch/csrc/<name>`` for each of
    ``SPARSE_BASE``) built into one library under other symbol names."""
    import ctypes

    from rptree_tpu_torch import _cuda

    out = os.path.join(src, "libbase_sparse.so")
    renames = [f"-D{n}={n}_base" for n in (
        "rpt_project", "rpt_project_segments", "rpt_ell_score_f32",
        "rpt_ell_score_bf16")]
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *renames, "-I",
                    str(_cuda._CSRC), "-shared", "-o", out,
                    *(os.path.join(src, n) for n in SPARSE_BASE)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    p, i, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.rpt_project_base.argtypes = [p, l_, p, p, p, l_, i, i, p]
    lib.rpt_project_segments_base.argtypes = [i]
    for name in ("rpt_ell_score_f32_base", "rpt_ell_score_bf16_base"):
        getattr(lib, name).argtypes = [p] * 9 + [i] * 9 + [p]
    return lib


def base_project(lib, x, r):
    """The earlier kernel 11, as its wrapper called it."""
    from rptree_tpu_torch import _cuda

    (n, d), nl = x.shape, r.shape[0]
    out = torch.empty((nl, n), device=x.device)
    segs = lib.rpt_project_segments_base(d)
    scratch = (torch.empty((segs, nl, n), device=x.device) if segs > 1
               else None)
    code = lib.rpt_project_base(
        _cuda.ptr(x), max(x.stride(0), d), _cuda.ptr(r), _cuda.ptr(out),
        None if scratch is None else _cuda.ptr(scratch), n, nl, d,
        _cuda.stream_of(x))
    assert code == 0, code
    return out


def base_ell(lib, blocks, sq, tb, tp, lens, q, qq, p, metric):
    """The earlier kernel 10, as its wrapper called it."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops.ell_kernel import ELL_METRICS

    g, lmax, k = blocks.shape
    nt, m = tp.shape
    out = torch.empty((nt * m, lmax), device=q.device)
    fn = (lib.rpt_ell_score_bf16_base if blocks.vals.dtype == torch.bfloat16
          else lib.rpt_ell_score_f32_base)
    code = fn(*map(_cuda.ptr, (blocks.cols, blocks.vals, sq, tb, tp, lens, q,
                               qq, out)),
              nt, g, m, lmax, k, blocks.dim, q.shape[0], int(p),
              ELL_METRICS[metric], _cuda.stream_of(q))
    assert code == 0, code
    return out


def project_turns(lib, label, x, r):
    """Kernel 11, the earlier build against this tree's and against
    ``torch.matmul(r, x.T)`` in IEEE fp32, in turns (old, new, matmul,
    matmul, new, old) by CUDA events and by device time, with whether the
    two builds give the same bits, each call's host time, this tree's
    tile and the bound.  One JSON line."""
    from rptree_tpu_torch.ops import build as ob

    new, old = ob.project_rows(x, r), base_project(lib, x, r)
    same = same_bits(new, old)
    fns = (lambda: base_project(lib, x, r), lambda: ob.project_rows(x, r),
           lambda: ob.project_rows_reference(x, r))
    o, n, mm, raw = turns(*fns)
    do, dn, dmm, draw = device_turns(*fns)
    (rows, d), nl = x.shape, r.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    b = cs.bound(4 * (rows * d + nl * d + nl * rows), 2 * rows * d * nl,
                 "f32")
    print(json.dumps({
        "base_vs_tree": "project_rows", "shape": label, "rows": rows, "D": d,
        "projections": nl, "tile": ob.project_plan(rows, nl, d, sms),
        "base_ms": o, "tree_ms": n, "matmul_ms": mm, "speedup": o / n,
        "vs_matmul": mm / n, "turns_ms": raw, "base_device_ms": do,
        "tree_device_ms": dn, "matmul_device_ms": dmm,
        "device_turns_ms": draw,
        "host_us": {"base": cs.host_us(fns[0]), "tree": cs.host_us(fns[1]),
                    "matmul": cs.host_us(fns[2])},
        "same_bits": same, **b}), flush=True)
    return same


def window_share(blocks, tb, tp, lens, budget=40 * 1024):
    """The share of the non-empty tiles whose rows over their block's
    window of columns (those of its occupied slots with a nonzero value;
    four rows to a column up to the quad of the last live row) would fit
    ``budget`` bytes of shared memory: how many tiles a kernel 10 that
    staged the query rows over the window, not their support, could
    serve."""
    g, lmax, _ = blocks.shape
    ln = lens.long().clamp(0, lmax)
    nz = blocks.vals != 0
    cols = blocks.cols.long().clamp(0, blocks.dim - 1)
    first = torch.where(nz, cols, blocks.dim).amin(-1).cummin(-1).values
    last = torch.where(nz, cols, -1).amax(-1).cummax(-1).values
    blk, at = tb.long().clamp(0, g - 1), (ln - 1).clamp_min(0)
    width = (last[blk, at] - first[blk, at] + 1).clamp_min(0)
    row = torch.arange(tp.shape[1], device=tp.device)
    last_row = torch.where(tp >= 0, row, -1).amax(-1)
    rows = 1 if tp.shape[1] == 1 else 4 * (last_row // 4 + 1)
    live = (last_row >= 0) & (ln > 0)
    fits = live & (rows * width * 4 <= budget)
    return float(fits.sum()) / max(int(live.sum()), 1)


def ell_turns(lib, label, blocks, sq, tb, tp, lens, q, qq, p):
    """Kernel 10 (l2), the earlier build against this tree's in turns (old,
    new, new, old) by CUDA events and by device time, with whether the two
    give the same bits on every metric, the share of tiles on each of the
    kernel's routes, the first pass's device time, the share of tiles
    whose query rows over the block's window would fit shared memory
    (``window_share``) and the bound.  One JSON line."""
    from rptree_tpu_torch.ops import ell_kernel as ek

    same = True
    for metric in ek.ELL_METRICS:
        args = (blocks, sq, tb, tp, lens, q, qq, p, metric)
        same &= same_bits(ek.ell_score_tiles(*args), base_ell(lib, *args))
    args = (blocks, sq, tb, tp, lens, q, qq, p, "l2")
    _, routes = ek.ell_score_tiles_routes(*args)
    routes = routes.tolist()
    mirror = torch.bincount(ek.ell_tile_routes(blocks, tp, lens),
                            minlength=3).tolist()
    fns = (lambda: base_ell(lib, *args), lambda: ek.ell_score_tiles(*args))
    o, n, raw = turns(*fns)
    do, dn, draw = device_turns(*fns)
    nt = tb.shape[0]
    print(json.dumps({
        "base_vs_tree": "ell_score_tiles", "tiles": label, "nt": nt,
        "tile_m": tp.shape[1], "vals": str(blocks.vals.dtype),
        "base_ms": o, "tree_ms": n, "speedup": o / n, "turns_ms": raw,
        "base_device_ms": do, "tree_device_ms": dn,
        "device_speedup": do / dn, "device_turns_ms": draw,
        "tree_support_device_ms": cs.graph_ms(lambda: ek._ell_support(q)),
        "same_bits": same, "routes": dict(zip(ek.ELL_ROUTES, routes)),
        "route_share": {k: v / nt for k, v in zip(ek.ELL_ROUTES, routes)},
        "routes_as_mirror": routes == mirror,
        "window_fits_share": window_share(blocks, tb, tp, lens),
        **cs.ell_bound(blocks, tb, tp, lens, q, p)}), flush=True)
    return same


def sparse_turns(lib):
    """Kernels 10 and 11 of ``a42fc83`` (or whichever earlier build sits in
    ``_checkout/base``) against this tree's at the served shapes: kernel
    11 on the clustered chunk, the iid chunk, a per-pair chunk, the
    bracket's 32 queries at T 32, the 1M build's tree and the sparse
    chunk (random dense rows, then the bag-of-words cell's own densified
    rows); kernel 10 on ``chip_smoke.py`` phase 2's grouped and per-pair
    chunks, f32 and bf16 values, its banded grouped chunk (through L2) and
    (s2)'s own chunk."""
    import rptree_tpu_torch as rp
    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops.sparse import EllMatrix, ell_take, ell_to_dense

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    same = True
    for label, n, d, nl in (("clustered_chunk", 65_536, 128, 104),
                            ("iid_chunk", 32_768, 128, 80),
                            ("per_pair_chunk", 2048, 128, 104),
                            ("bracket", 32, 128, 160),
                            ("build_1m_tree", 1_000_000, 128, 13),
                            ("sparse_chunk_random", 4096, cs.SPARSE_V, 88)):
        x = torch.randn(n, d, device=dev, generator=gen)
        r = torch.randn(nl, d, device=dev, generator=gen)
        same &= project_turns(lib, label, x, r)
        del x, r
        torch.cuda.empty_cache()
    for label, b, tile_m, banded in (("phase2_grouped", 4096, 8, False),
                                     ("phase2_per_pair", 512, 1, False),
                                     ("phase2_banded", 4096, 8, True)):
        for bf16 in (False, True):
            if banded and bf16:
                continue
            (blocks, sq, tb, tp, lens, q, qq, _,
             _) = cs.ell_tiles_inputs(dev, b, cs.SPARSE_PROBES, tile_m, 7,
                                      bf16=bf16, banded=banded)
            same &= ell_turns(lib, label, blocks, sq, tb, tp, lens, q, qq,
                              cs.SPARSE_PROBES)
            del blocks, q
            torch.cuda.empty_cache()
    # the bag-of-words cell: (s2)'s own first chunk
    n, chunk, p = cs.SPARSE_N, 4096, cs.SPARSE_PROBES
    cols, vals = cs.sparse_rows(n, cs.SEED)
    cfg = rp.rp_tree_cfg(128, n, cs.SPARSE_V)
    f = rp.forest_batch(cs.SEED, cfg.max_depth, 128, 8, cfg.proj_nz_density,
                        EllMatrix(cs.SPARSE_V, cols, vals), device=dev)
    f.pack_leaves()
    qi = np.random.default_rng(cs.SEED + 11).integers(0, n, size=8192)
    qe = ell_take(f.x, torch.as_tensor(qi, device=dev))
    serve = dict(cs.SPARSE_GROUPED, chunk=chunk)
    f.knn_grouped(qe, K, **serve)  # learn the capacity
    cap = max(f._grouped_nt.values())
    qc = ell_to_dense(ell_take(qe, slice(0, chunk)), torch.float32)
    nl = f.plan.n_levels
    rl = f.arrays.r[:, :nl].reshape(-1, cs.SPARSE_V).contiguous()
    same &= project_turns(lib, "sparse_chunk_cell_rows", qc, rl)
    from rptree_tpu_torch.models import forest as fm

    gsel, lsel = fm._probe_pairs(f, qc, serve["budget"], p, K)
    blocks, sq_leaf, _ = f._packed
    tb, tp, _, _, lens_t = og.tile_tables(gsel, lsel, f._lens_global(),
                                          serve["tile_m"], cap)
    same &= ell_turns(lib, "s2_own_chunk", blocks, sq_leaf, tb, tp, lens_t,
                      qc, (qc * qc).sum(-1), p)
    if not same:
        raise AssertionError("kernel 10 or 11 differs from a42fc83's bits")


DESCENT_BASE = ("traverse.cu", "common.cuh")


def base_descent_lib(src):
    """An earlier commit's kernels 7 and 8 (``git show
    15c5dfb:rptree_tpu_torch/csrc/<name>`` for each of ``DESCENT_BASE``
    into ``src``: the source includes its own ``common.cuh``) built into
    one library under other symbol names."""
    import ctypes

    from rptree_tpu_torch import _cuda

    out = os.path.join(src, "libbase_descent.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS,
                    "-Drpt_traverse=rpt_traverse_base",
                    "-Drpt_select_probes=rpt_select_probes_base", "-shared",
                    "-o", out, os.path.join(src, "traverse.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    p, i, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.rpt_traverse_base.argtypes = [p] * 6 + [i] * 4 + [l_] + [i] * 4 + [p]
    lib.rpt_select_probes_base.argtypes = [p] * 5 + [i] * 5 + [l_, i, p]
    return lib


def _base_check(name, device, **tensors):
    """The earlier wrappers' operand checks, as they ran them."""
    for key, (t, dtype) in tensors.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {key}")


def base_traverse(lib, plan, table, projq, budget):
    """The earlier kernel 7 behind the earlier wrapper's host work (its
    checks, ``torch.cuda.device``, ``ctypes`` pointers, the stream object;
    routes: registers up to F 8, shared memory up to 16,384 entries)."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import traverse as tv

    tv._check_traverse_args(plan, table, projq, budget)
    _base_check("traverse_kernel", projq.device,
                projq=(projq, torch.float32), rec=(table.rec, torch.int32),
                level_off=(table.level_off, torch.int32))
    t, nl, b = projq.shape
    f = int(budget)
    leaf = torch.empty((t, b, f), dtype=torch.int32, device=projq.device)
    pri = torch.empty((t, b, f), dtype=torch.float32, device=projq.device)
    m = tv._next_pow2(2 * f)
    route = 0 if f <= 8 else (1 if m <= tv.SMEM_MAX_ENTRIES else 2)
    grid, scratch = 0, None
    if route == 2:
        grid = min(t * b, tv._GLOBAL_BLOCKS)
        scratch = torch.empty((grid, m, 2), dtype=torch.int32,
                              device=projq.device)
    with torch.cuda.device(projq.device):
        code = lib.rpt_traverse_base(
            _cuda.ptr(projq), _cuda.ptr(table.rec), _cuda.ptr(table.level_off),
            _cuda.ptr(leaf), _cuda.ptr(pri),
            None if scratch is None else _cuda.ptr(scratch), plan.root_enc, t,
            b, nl, table.rec.shape[1], f, f if route == 0 else m, route, grid,
            _cuda.stream_of(projq))
    assert code == 0, code
    return leaf, pri


def base_select_probes(lib, leaf_ids, prio, n_leaves, probes, lens, k,
                       bucket_stop):
    """The earlier kernel 8 behind the earlier wrapper's host work."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import traverse as tv

    tv._check_probe_args(leaf_ids, prio, n_leaves, lens, k, bucket_stop)
    _base_check("select_probes", leaf_ids.device,
                leaf_ids=(leaf_ids, torch.int32), prio=(prio, torch.float32),
                lens=(lens, torch.int32))
    t, b, f = leaf_ids.shape
    p = min(int(probes), t * f)
    gsel = torch.empty((b, p), dtype=torch.int32, device=leaf_ids.device)
    lsel = torch.empty((b, p), dtype=torch.int32, device=leaf_ids.device)
    with torch.cuda.device(leaf_ids.device):
        code = lib.rpt_select_probes_base(
            _cuda.ptr(leaf_ids), _cuda.ptr(prio), _cuda.ptr(lens),
            _cuda.ptr(gsel), _cuda.ptr(lsel), t, b, f, p, int(n_leaves),
            int(k) if bucket_stop else 0, int(bool(bucket_stop)),
            _cuda.stream_of(leaf_ids))
    assert code == 0, code
    return gsel, lsel


def kernel_pair_turns(lib, label, plan, table, projq, budget, probes, lens):
    """Kernels 7 and 8 of the earlier build against this tree's on one
    descent, in turns (old, new, new, old) by CUDA events and by device
    time (``graph_ms``), each wrapper's host time a call, whether the two
    give the same bits (leaves, priorities as int32 bits; ``gsel``,
    ``lsel`` with the bucket stop off and on, k 10), the routes and the
    bounds.  Two JSON lines (one without probes); returns whether every
    output matched."""
    from rptree_tpu_torch.ops import traverse as tv

    t, nl, b = projq.shape
    f = budget
    args = (plan, table, projq, budget)
    new, old = tv.traverse_kernel(*args), base_traverse(lib, *args)
    same = same_bits(new[0], old[0]) and same_bits(new[1], old[1])
    fns = (lambda: base_traverse(lib, *args), lambda: tv.traverse_kernel(*args))
    o, n, raw = turns(*fns)
    do, dn, draw = device_turns(*fns)
    print(json.dumps({
        "base_vs_tree": "traverse", "descent": label, "T": t, "L": nl,
        "B": b, "F": f, "route": tv.traverse_route(f)[0], "base_ms": o,
        "tree_ms": n, "turns_ms": raw, "base_device_ms": do,
        "tree_device_ms": dn, "device_turns_ms": draw, "speedup": o / n,
        "device_speedup": do / dn,
        "host_us": {"base": cs.host_us(fns[0]), "tree": cs.host_us(fns[1])},
        "same_bits": same,
        **cs.bound(projq.numel() * 4 + table.rec.numel() * 4 + t * b * f * 8,
                   8 * t * b * f * nl, "f32")}), flush=True)
    if probes is None:
        return same
    leaf, pri = new
    p = min(probes, t * f)
    for stop in (False, True):
        pargs = (leaf, pri, plan.n_leaves, probes, lens, cs.K, stop)
        got, was = tv.select_probes(*pargs), base_select_probes(lib, *pargs)
        same &= all(same_bits(a, c) for a, c in zip(got, was))
    pargs = (leaf, pri, plan.n_leaves, probes, lens, cs.K, False)
    keys = pri.transpose(0, 1).reshape(b, t * f)
    fns = (lambda: base_select_probes(lib, *pargs),
           lambda: tv.select_probes(*pargs),
           lambda: torch.sort(keys, dim=1, stable=True))
    o, n, srt, raw = turns(*fns)
    do, dn, dsrt, draw = device_turns(*fns)
    print(json.dumps({
        "base_vs_tree": "select_probes", "descent": label, "T": t, "B": b,
        "F": f, "P": p, "route": tv.probe_route(t, f),
        "base_ms": o, "tree_ms": n, "stable_sort_ms": srt, "turns_ms": raw,
        "base_device_ms": do, "tree_device_ms": dn,
        "stable_sort_device_ms": dsrt, "device_turns_ms": draw,
        "speedup": o / n, "device_speedup": do / dn,
        "host_us": {"base": cs.host_us(fns[0]), "tree": cs.host_us(fns[1])},
        "same_bits": same,
        **cs.bound(t * b * f * 8 + b * p * 8, b * t * f * t, "f32")}),
        flush=True)
    return same


def host_breakdown(lib):
    """Each wrapper's host time a call (``cs.host_us``), item by item, at
    the iid chunk's and the bracket's descents: kernels 8 and 7 of this
    tree and of the earlier build in ``lib`` (behind that build's
    wrappers), kernel 11's wrapper at the iid chunk's projections, the
    stable ``torch.sort`` of kernel 8's keys, and the units (one
    ``torch.empty``, one view).  Items: ``checks`` (the wrapper's argument
    checks), ``alloc`` (its outputs), ``launch`` (the C entry point through
    ``ctypes``, its arguments made as the wrapper makes them, the launch
    included), ``ctypes`` (the same call with an argument on which the
    entry point returns before launching: the conversion floor), and
    ``rest``, the call less checks, alloc and launch; ``alloc_other``
    times the outputs' other form (one allocation and views of it against
    two allocations) in turns with ``alloc``.  Each the median of 9
    batches of 100 calls (the host's clock is noisy at a few
    microseconds).  One JSON line a shape."""
    import ctypes

    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import build as bd
    from rptree_tpu_torch.ops import traverse as tv

    dev = torch.device("cuda", 0)
    new = _cuda.lib()
    def hu(fn):
        return cs.host_us(fn, calls=100, batches=9)

    def alloc_turns(rec_, form, other):
        first = hu(form), hu(other)
        last = hu(other), hu(form)
        rec_["alloc"] = (first[0] + last[1]) / 2
        rec_["alloc_other"] = (first[1] + last[0]) / 2

    for i, (label, n, min_leaf, trees, b, budget, probes) in enumerate(
            cs.DESCENTS):
        if label not in ("iid_chunk", "bracket_chunk"):
            continue
        plan, table, projq = cs.descent_inputs(n, min_leaf, trees, b, dev,
                                               seed=11 + i)
        rec, off = table.rec, table.level_off
        t, nl, _ = projq.shape
        f = budget
        leaf, pri = tv.traverse_kernel(plan, table, projq, f)
        lens = torch.as_tensor(np.tile(plan.leaf_len, trees), device=dev)
        nlv = plan.n_leaves
        p = min(probes, t * f)
        gsel, lsel = leaf.new_empty((b, p)), leaf.new_empty((b, p))
        route, width = tv.probe_route(t, f)
        m = tv.traverse_route(f)[1]

        def probes_launch(pp=p, check=True):
            with _cuda.on(dev):
                code = new.rpt_select_probes(tv._PROBES_ARGS.pack(
                    leaf.data_ptr(), pri.data_ptr(), lens.data_ptr(),
                    gsel.data_ptr(), lsel.data_ptr(), t, b, f, pp, nlv, 0, 0,
                    tv._PROBE_ROUTES[route], width, _cuda.raw_stream(dev)))
            if check:
                _cuda.check(code, "select_probes")

        def traverse_launch(ff=f, check=True):
            with _cuda.on(dev):
                code = new.rpt_traverse(tv._TRAVERSE_ARGS.pack(
                    projq.data_ptr(), rec.data_ptr(), off.data_ptr(),
                    leaf.data_ptr(), pri.data_ptr(), 0, plan.root_enc, t, b,
                    nl, rec.shape[1], ff, m, 0, 0, _cuda.raw_stream(dev)))
            if check:
                _cuda.check(code, "traverse_kernel")

        def base_traverse_launch(ff=f):
            with torch.cuda.device(dev):
                return lib.rpt_traverse_base(
                    _cuda.ptr(projq), _cuda.ptr(rec), _cuda.ptr(off),
                    _cuda.ptr(leaf), _cuda.ptr(pri), None, plan.root_enc, t,
                    b, nl, rec.shape[1], ff, ff, 0, 0, _cuda.stream_of(projq))

        def base_probes_launch():
            with torch.cuda.device(dev):
                return lib.rpt_select_probes_base(
                    _cuda.ptr(leaf), _cuda.ptr(pri), _cuda.ptr(lens),
                    _cuda.ptr(gsel), _cuda.ptr(lsel), t, b, f, p, nlv, 0, 0,
                    _cuda.stream_of(leaf))

        pargs = (leaf, pri, nlv, probes, lens, cs.K, False)
        targs = (plan, table, projq, f)
        k8 = {"call": hu(lambda: tv.select_probes(*pargs)),
              "checks": hu(lambda: (
                  tv._check_probe_args(leaf, pri, nlv, lens, cs.K, False),
                  tv._check_cuda("select_probes", dev,
                                 ("leaf_ids", leaf, torch.int32),
                                 ("prio", pri, torch.float32),
                                 ("lens", lens, torch.int32)))),
              "launch": hu(probes_launch),
              "ctypes": hu(lambda: probes_launch(0, False))}
        k7 = {"call": hu(lambda: tv.traverse_kernel(*targs)),
              "checks": hu(lambda: (
                  tv._check_traverse_args(*targs),
                  tv._check_cuda("traverse_kernel", dev,
                                 ("projq", projq, torch.float32),
                                 ("rec", rec, torch.int32),
                                 ("level_off", off, torch.int32)))),
              "launch": hu(traverse_launch),
              "ctypes": hu(lambda: traverse_launch(0, False))}
        alloc_turns(k8, lambda: (leaf.new_empty((b, p)),
                                 leaf.new_empty((b, p))),
                    lambda: leaf.new_empty((2, b, p)).unbind(0))

        def one_alloc7():
            out = projq.new_empty((2, t, b, f), dtype=torch.int32)
            return out[0], out[1].view(torch.float32)

        alloc_turns(k7, lambda: (projq.new_empty((t, b, f),
                                                 dtype=torch.int32),
                                 projq.new_empty((t, b, f))), one_alloc7)
        for rec_ in (k8, k7):
            rec_["rest"] = (rec_["call"] - rec_["checks"] - rec_["alloc"]
                            - rec_["launch"])
        keys = pri.transpose(0, 1).reshape(b, t * f)
        line = {
            "host_breakdown_us": label, "T": t, "B": b, "F": f, "P": p,
            "select_probes": k8, "traverse_kernel": k7,
            "base": {
                "select_probes": {
                    "call": hu(lambda: base_select_probes(lib, *pargs)),
                    "launch": hu(base_probes_launch)},
                "traverse_kernel": {
                    "call": hu(lambda: base_traverse(lib, *targs)),
                    "launch": hu(base_traverse_launch),
                    "ctypes": hu(lambda: base_traverse_launch(0))}},
            "stable_sort": hu(lambda: torch.sort(keys, dim=1, stable=True)),
            "units": {"empty": hu(lambda: leaf.new_empty((b, p))),
                      "view": hu(lambda: gsel[0])}}
        if label == "iid_chunk":
            # kernel 11's wrapper at this chunk's projections (T * L rows
            # of r, 32,768 queries of D 128), the same items
            x = torch.randn(b, 128, device=dev)
            r = torch.randn(t * nl, 128, device=dev)
            out = torch.empty((t * nl, b), device=dev)
            tile, lt = bd.project_plan(b, t * nl, 128, bd._sm_count(dev))

            def project_launch(nn=b, check=True):
                with _cuda.on(dev):
                    code = new.rpt_project(
                        x.data_ptr(), 128, r.data_ptr(), out.data_ptr(), None,
                        nn, t * nl, 128, tile, lt, _cuda.raw_stream(dev))
                if check:
                    _cuda.check(code, "project_rows")

            k11 = {"call": hu(lambda: bd.project_rows(x, r)),
                   "alloc": hu(lambda: torch.empty((t * nl, b),
                                                   dtype=torch.float32,
                                                   device=dev)),
                   "launch": hu(project_launch),
                   "ctypes": hu(lambda: project_launch(0, False))}
            k11["rest"] = k11["call"] - k11["alloc"] - k11["launch"]
            line["project_rows"] = k11
        print(json.dumps(line), flush=True)
        del table, projq


def descent_base_turns(lib, on_card=True):
    """Kernels 7 and 8 of ``15c5dfb`` (or whichever earlier build sits in
    ``_checkout/base``) against this tree's: at every ``DESCENTS`` shape
    of ``chip_smoke.py``, then on the cells' own first chunks (the
    clustered 1M chunk of 65,536 and its per-pair chunk of 2,048, the iid
    100k chunk of 32,768, the bracket's 32 queries on 32 trees), each with
    the traversal + probe stage as the path runs it (``descent_turns``)."""
    import rptree_tpu_torch as rp
    from rptree_tpu_torch.models import forest as fm

    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    same = True
    for i, (label, n, min_leaf, trees, b, budget, probes) in enumerate(
            cs.DESCENTS):
        plan, table, projq = cs.descent_inputs(n, min_leaf, trees, b, dev,
                                               seed=11 + i)
        lens = torch.as_tensor(np.tile(plan.leaf_len, trees), device=dev)
        same &= kernel_pair_turns(lib, label, plan, table, projq, budget,
                                  probes, lens)
        del table, projq
    for cell, (x, q), min_leaf, trees, chunks in (
            ("clustered", cs.clustered_data(1_000_000, 128, 4_000, 0.15,
                                            65_536), 128, 8,
             (("clustered_chunk", 65_536, 1, 8),
              ("per_pair_chunk", 2048, 1, 8))),
            ("iid", cs.iid_data(100_000, 128, 32_768), 64, 8,
             (("iid_chunk", 32_768, 2, 10),)),
            ("bracket", cs.iid_data(100_000, 128, 32), 4096, 32,
             (("bracket_chunk", 32, 2, 32),))):
        cfg = rp.rp_tree_cfg(min_leaf, *x.shape)
        f = rp.forest_batch(cs.SEED, cfg.max_depth, min_leaf, trees,
                            cfg.proj_nz_density, torch.as_tensor(x, device=dev),
                            device=dev)
        qd = torch.as_tensor(q, device=dev)
        del x, q
        for label, chunk, budget, probes in chunks:
            qc = qd[:chunk]
            nl = f.plan.n_levels
            projq = fm.project_queries(qc, f.arrays.r, nl)
            same &= kernel_pair_turns(lib, label, f.plan, f._table(), projq,
                                      budget, probes, f._leaf_lens())
            # kernel 11's wrapper on the same chunk, the host-time yardstick
            print(json.dumps({"host_us_yardstick": label,
                              "project_queries_us": cs.host_us(
                                  lambda: fm.project_queries(qc, f.arrays.r,
                                                             nl))}),
                  flush=True)
            descent_turns(label, f, fm, qc, budget, probes, sync, on_card)
        del f, qd
        torch.cuda.empty_cache()
    if not same:
        raise AssertionError("kernel 7 or 8 differs from the earlier build's "
                             "bits")


def descent_turns(label, f, fm, qc, budget, probes, sync, on_card, calls=4):
    """The traversal + probe stage of the chunk ``qc`` as the path runs it
    (``_select_probes``: the projections, kernels 7 and 8) against its
    plain form (the same projections, then the plain twins), in turns
    plain, kernels, kernels, plain, ... ``calls`` times each, each turn
    the median of 7 synchronised runs on the host clock; the results
    must be equal.  Prints every turn's time (the spread over calls), the
    kernels alone, and on the card the stage's device time (``graph_ms``)."""
    from rptree_tpu_torch.ops import traverse as tv

    lens, table = f._lens_global(), f._table()
    nl = f.plan.n_levels

    def kernels():
        return fm._select_probes(f.plan, f.arrays, qc, budget, probes, k=K,
                                 block_len=lens, table=table)

    def plain():
        pq = tv.project_queries(qc, f.arrays.r, nl)
        leaf, pri = tv.traverse_tree_reference(f.plan, table, pq, budget)
        return tv.select_probes_reference(leaf, pri, f.plan.n_leaves, probes,
                                          lens, K)

    if not all(torch.equal(a, b) for a, b in zip(kernels(), plain())):
        raise AssertionError(f"{label}: kernels 7 and 8 differ from the "
                             "plain form")
    ks, ps = [], []
    for i in range(calls):
        for fn in ((plain, kernels) if i % 2 == 0 else (kernels, plain)):
            (ps if fn is plain else ks).append(timed(fn, sync)[1])
    pq, proj_ms = timed(lambda: tv.project_queries(qc, f.arrays.r, nl), sync)
    (leaf, pri), k7_ms = timed(lambda: tv.traverse_kernel(f.plan, table, pq,
                                                          budget), sync)
    _, k8_ms = timed(lambda: tv.select_probes(leaf, pri, f.plan.n_leaves,
                                              probes, lens, K), sync)
    rec = {"descent_turns": label, "queries": qc.shape[0], "budget": budget,
           "probes": probes, "trees": f.n_trees, "levels": nl,
           "kernels_ms": float(np.median(ks)), "plain_ms": float(np.median(ps)),
           "speedup": float(np.median(ps) / np.median(ks)),
           "kernels_turns_ms": ks, "plain_turns_ms": ps,
           "projections_ms": proj_ms, "kernel7_ms": k7_ms, "kernel8_ms": k8_ms}
    if on_card:
        rec["kernels_device_ms"] = cs.graph_ms(kernels)
        rec["kernel7_device_ms"] = cs.graph_ms(
            lambda: tv.traverse_kernel(f.plan, table, pq, budget))
        rec["kernel8_device_ms"] = cs.graph_ms(
            lambda: tv.select_probes(leaf, pri, f.plan.n_leaves, probes, lens,
                                     K))
    print(json.dumps(rec), flush=True)


def tables_turns(label, f, fm, og, qc, budget, probes, cap, sync, on_card,
                 calls=4):
    """The tile-table stage of the chunk ``qc`` at capacity ``cap`` as the
    path runs it (kernel 9, ``tile_tables``) against its plain twin
    (``tile_tables_reference``) on the same pairs, in turns plain, kernel,
    kernel, plain, ... ``calls`` times each, each turn the median of 7
    synchronised runs on the host clock; all five outputs must be equal.
    On the card also the kernel's device time (``graph_ms``) and a stable
    ``torch.sort`` of the flat keys, the twin's first step."""
    lens = f._lens_global()
    gsel, lsel = fm._select_probes(f.plan, f.arrays, qc, budget, probes, k=K,
                                   block_len=lens, table=f._table())
    args = (gsel, lsel, lens, TILE_M, cap)

    def kernel():
        return og.tile_tables(*args)

    def plain():
        return og.tile_tables_reference(*args)

    if not all(torch.equal(a, b) for a, b in zip(kernel(), plain())):
        raise AssertionError(f"{label}: kernel 9 differs from its twin")
    ks, ps = [], []
    for i in range(calls):
        for fn in ((plain, kernel) if i % 2 == 0 else (kernel, plain)):
            (ps if fn is plain else ks).append(timed(fn, sync)[1])
    keys = torch.where(lsel >= 0, gsel.long(), og._BIG).reshape(-1)
    rec = {"tables_turns": label, "pairs": gsel.numel(), "cap": cap,
           "kernel_ms": float(np.median(ks)), "plain_ms": float(np.median(ps)),
           "speedup": float(np.median(ps) / np.median(ks)),
           "kernel_turns_ms": ks, "plain_turns_ms": ps,
           "stable_sort_ms": timed(lambda: torch.sort(keys, stable=True),
                                   sync)[1]}
    if on_card:
        rec["kernel_device_ms"] = cs.graph_ms(kernel)
        rec["plain_device_ms"] = cs.graph_ms(plain)
    print(json.dumps(rec), flush=True)


TABLES_BASE = ("tile_tables.cu", "gather_score.cu", "common.cuh")


def base_tables_lib(src):
    """An earlier commit's kernels 9 and 6 (``git show
    d31cc2c:rptree_tpu_torch/csrc/<name>`` for each of ``TABLES_BASE``
    into ``src``; ``gather_score.cu`` includes this tree's
    ``grouped_tile.cuh``) built into one library under other symbol
    names."""
    import ctypes

    from rptree_tpu_torch import _cuda

    out = os.path.join(src, "libbase_tables.so")
    names = ("rpt_tile_tables", "rpt_pair_runs", "rpt_gather_score_f32",
             "rpt_gather_score_bf16", "rpt_gather_score_shared_f32",
             "rpt_gather_score_shared_bf16")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS,
                    *[f"-D{n}={n}_base" for n in names], "-I", src, "-I",
                    str(_cuda._CSRC), "-shared", "-o", out,
                    os.path.join(src, "tile_tables.cu"),
                    os.path.join(src, "gather_score.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    p, i, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.rpt_tile_tables_base.argtypes = [p] * 9 + [l_, l_, i, l_, i, p]
    lib.rpt_pair_runs_base.argtypes = [p, l_, i, p, p, p, l_, p]
    for name in ("rpt_gather_score_shared_f32_base",
                 "rpt_gather_score_shared_bf16_base"):
        getattr(lib, name).argtypes = [p, p, l_] + [p] * 5 + [i] * 5 + [p]
    return lib


def base_tile_tables(lib, gsel, lsel, lens, tile_m, nt):
    """The earlier kernel 9 behind the earlier wrapper's host work (its
    checks, five outputs and a scratch allocated apart, 15 ``ctypes``
    arguments, ``torch.cuda.device``, the stream object)."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import grouped as og

    og._check_tables(gsel, lsel, lens, tile_m, nt)
    _base_check("tile_tables", gsel.device, gsel=(gsel, torch.int32),
                lsel=(lsel, torch.int32), lens=(lens, torch.int32))
    dev = gsel.device
    e, g = gsel.numel(), lens.shape[0]
    tb = torch.empty(nt, dtype=torch.int32, device=dev)
    tp = torch.empty((nt, tile_m), dtype=torch.int32, device=dev)
    needed = torch.empty((), dtype=torch.int32, device=dev)
    slot = torch.empty(e, dtype=torch.int64, device=dev)
    lens_t = torch.empty(nt, dtype=torch.int32, device=dev)
    chunks = max(1, -(-e // 2048))
    segs = -(-g // 1024)
    scratch = torch.empty(3 * g + 257 * (chunks + 1) + 4 * e + 2 * segs + 1,
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.rpt_tile_tables_base(
            *map(_cuda.ptr, (gsel, lsel, lens, tb, tp, slot, lens_t, needed,
                             scratch)),
            scratch.numel(), e, g, nt, tile_m, _cuda.stream_of(gsel))
    assert code == 0, code
    return tb, tp, needed, slot, lens_t


def tables_pair_turns(lib, label, gsel, lsel, lens, tile_m, nt):
    """Kernel 9 of the earlier build against this tree's on one chunk's
    pairs: all five outputs of both and of the twin compared
    (``same_bits``), in turns by CUDA events and by device time, each
    wrapper's host time a call, the grids each launches; and this tree's
    kernel at the other digit plan (8 bits beside 11, or 11 beside 8)
    where it has another number of passes (device time in turns).
    One JSON line; returns whether every output matched."""
    from rptree_tpu_torch.ops import grouped as og

    args = (gsel, lsel, lens, tile_m, nt)
    new, old = og.tile_tables(*args), base_tile_tables(lib, *args)
    want = og.tile_tables_reference(*args)
    same = all(same_bits(a, b) for a, b in zip(new, old)) and all(
        same_bits(a, b) for a, b in zip(new, want))
    fns = (lambda: base_tile_tables(lib, *args), lambda: og.tile_tables(*args))
    o, n, raw = turns(*fns)
    do, dn, draw = device_turns(*fns)
    e, g = gsel.numel(), lens.shape[0]
    bits = og.table_digit_bits(e)
    other = 11 if bits == 8 else 8  # the other digit plan
    plan, plan_o = og.tile_tables_plan(e, g), og.tile_tables_plan(e, g, other)
    rec = {
        "base_vs_tree": "tile_tables", "shape": label, "pairs": e, "G": g,
        "tile_m": tile_m, "nt": nt, "needed": int(want[2]),
        "base_ms": o, "tree_ms": n, "turns_ms": raw, "base_device_ms": do,
        "tree_device_ms": dn, "device_turns_ms": draw, "speedup": o / n,
        "device_speedup": do / dn,
        "host_us": {"base": cs.host_us(fns[0]), "tree": cs.host_us(fns[1])},
        "grids": {"base": grid_count(fns[0]),
                  "tree": grid_count(fns[1])},
        "digit_bits": {str(bits): list(plan.bits),
                       str(other): list(plan_o.bits)},
        "same_bits": same,
        **cs.bound(8 * e + 4 * g + 4 * nt * (tile_m + 2) + 4 + 8 * e, e,
                   "int8")}
    if plan_o.passes != plan.passes:
        got_o = og._tables_on_card(*args, max_bits=other)
        rec["same_bits"] = same = same and all(
            same_bits(a, b) for a, b in zip(got_o, want))
        _, d_o, draw_o = device_turns(
            fns[1], lambda: og._tables_on_card(*args, max_bits=other))
        rec.update({f"tree_device_ms_{other}_bits": d_o,
                    "bits_turns_ms": draw_o})
    print(json.dumps(rec), flush=True)
    return same


def base_gather_shared(lib, xs, sq, q, sel):
    """The earlier kernel 6's shared-row mode behind the earlier wrapper:
    the card's pair runs (``rpt_pair_runs``, which also rounds a bf16
    store's queries), then the blocked route's items over the id tables."""
    from rptree_tpu_torch import _cuda

    g, lmax, d = xs.shape
    b, p = sel.shape
    bf16 = xs.dtype == torch.bfloat16
    dots = torch.empty((b, p, lmax), device=q.device)
    sqx = torch.empty((b, p, lmax), device=q.device)
    flat = sel.reshape(-1)
    n = flat.numel()
    runs = torch.empty(3 * g + 4 * n + 1, dtype=torch.int32, device=q.device)
    qr = torch.empty_like(q) if bf16 else None
    with torch.cuda.device(q.device):
        code = lib.rpt_pair_runs_base(
            _cuda.ptr(flat), n, g, _cuda.ptr(runs),
            _cuda.ptr(q) if bf16 else None, _cuda.ptr(qr) if bf16 else None,
            q.numel() if bf16 else 0, _cuda.stream_of(q))
        assert code == 0, code
        fn = (lib.rpt_gather_score_shared_bf16_base if bf16
              else lib.rpt_gather_score_shared_f32_base)
        code = fn(_cuda.ptr(xs.rows), _cuda.ptr(xs.ids), xs.rows.shape[0],
                  _cuda.ptr(sq), _cuda.ptr(q if qr is None else qr),
                  _cuda.ptr(runs), _cuda.ptr(dots), _cuda.ptr(sqx), b, p, g,
                  lmax, d, _cuda.stream_of(q))
    assert code == 0, code
    return dots, sqx


def gather_pair_turns(lib, label, xs, sq, q, sel):
    """Kernel 6's shared-row mode of the earlier build against this
    tree's query route and its block route on one chunk's pairs: dots and
    norms of all three compared bit for bit (``same_bits``) and against
    the plain twin within 1e-4; in turns by CUDA events and device time;
    the earlier build's pair runs alone; what each route reads and the
    bytes the query route moves.  One JSON line; returns whether every
    output matched."""
    from rptree_tpu_torch.ops import fused_gather as fg

    g, lmax, d = xs.shape
    b, p = sel.shape
    args = (xs, sq, q, sel)
    got = fg._gather_score(*args, route="query")
    blk = fg._gather_score(*args, route="block")
    old = base_gather_shared(lib, *args)
    same = all(same_bits(a, c) for a, c in zip(got, old)) and all(
        same_bits(a, c) for a, c in zip(got, blk))
    want_d, want_s = fg.gather_score_reference(*args)
    abs_err, rel_err = cs._rel_err(got[0], want_d)
    same &= rel_err <= cs.DIST_RTOL and torch.equal(got[1], want_s)
    del want_d, want_s
    fns = (lambda: base_gather_shared(lib, *args),
           lambda: fg._gather_score(*args, route="query"),
           lambda: fg._gather_score(*args, route="block"))
    o, nq, nb, raw = turns(*fns)
    do, dq, db, draw = device_turns(*fns)
    flat = sel.reshape(-1)
    runs = torch.empty(3 * g + 4 * flat.numel() + 1, dtype=torch.int32,
                       device=q.device)

    def pair_runs():
        from rptree_tpu_torch import _cuda

        lib.rpt_pair_runs_base(_cuda.ptr(flat), flat.numel(), g,
                               _cuda.ptr(runs), None, None, 0,
                               _cuda.stream_of(q))

    elem = xs.rows.element_size()
    print(json.dumps({
        "base_vs_tree": "gather_score_shared", "shape": label, "B": b, "P": p,
        "G": g, "lmax": lmax, "D": d, "rows": xs.rows.shape[0],
        "dtype": str(xs.dtype), "route": fg.shared_route(p, lmax, d, elem),
        "base_ms": o, "tree_query_ms": nq, "tree_block_ms": nb,
        "turns_ms": raw, "base_device_ms": do, "tree_query_device_ms": dq,
        "tree_block_device_ms": db, "device_turns_ms": draw,
        "device_speedup": do / dq, "base_pair_runs_device_ms":
            cs.graph_ms(pair_runs),
        "max_abs_err": abs_err, "max_rel_err": rel_err, "same_bits": same,
        **(bound := cs.gather_shared_bound(xs, sel, b, p)),
        "query_route_tb_per_s": bound["moved_bytes"]["query"] / (dq * 1e-3)
        / 1e12}), flush=True)
    return same


def shared_base_turns(lib):
    """Kernels 9 and 6 of ``d31cc2c`` (or whichever earlier build sits in
    ``_checkout/base``) against this tree's: kernel 9 at every ``TABLES``
    shape, on the clustered 1M and iid 100k chunks' own pairs and on the
    10M grouped chunk's (G 524,288, tile_m 16); kernel 6's shared-row mode
    at phase 2's shape (f32 and bf16), on (n)'s per-pair chunk of 2,048
    (the clustered 1M forest, shared rows) and on the 10M chunk of 8,192
    (``examples/scale_10m.py``'s cell)."""
    import rptree_tpu_torch as rp
    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops.shared import SharedRows

    dev = torch.device("cuda", 0)
    same = True
    for i, (name, g, trees, b, p, tile_m, hot, masked, share) in enumerate(
            cs.TABLES):
        gsel, lsel, lens = cs.table_pairs(g, trees, b, p, hot, masked, dev,
                                          seed=21 + i)
        need = int(og.tile_tables_reference(gsel, lsel, lens, tile_m, 1)[2])
        nt = max(1, need + need // 8 if share is None else int(need * share))
        same &= tables_pair_turns(lib, name, gsel, lsel, lens, tile_m, nt)
    xs, sq, q, sel = cs.shared_inputs(1_000_000, 65_536, 128, 128, 2048, 8,
                                      dev, seed=17)
    same &= gather_pair_turns(lib, "phase2_f32", xs, sq, q, sel)
    xs = SharedRows(xs.rows.bfloat16(), xs.ids)
    same &= gather_pair_turns(lib, "phase2_bf16", xs, sq, q, sel)
    del xs, sq, q, sel

    def chunk_tables(label, f, qc, budget, probes, tile_m):
        lens = f._lens_global()
        gsel, lsel = fm._probe_pairs(f, qc, budget, probes, K)
        need = int(og.tile_tables_reference(gsel, lsel, lens, tile_m, 1)[2])
        return tables_pair_turns(lib, label, gsel, lsel, lens, tile_m,
                                 need + need // 8)

    x, q = cs.clustered_data(1_000_000, 128, 4_000, 0.15, 65_536)
    cfg = rp.rp_tree_cfg(128, *x.shape)
    f = rp.forest_batch(cs.SEED, cfg.max_depth, 128, 8, cfg.proj_nz_density,
                        torch.as_tensor(x, device=dev), device=dev)
    qd = torch.as_tensor(q, device=dev)
    del x, q
    f.pack_leaves()
    same &= chunk_tables("clustered_chunk_own_pairs", f, qd, 1, 8, TILE_M)
    f.pack_leaves(store="shared")
    rows, sq_leaf, _ = f._packed
    sel, _ = fm._probe_pairs(f, qd[:2048], 1, 8, K)
    same &= gather_pair_turns(lib, "n_chunk", rows, sq_leaf, qd[:2048], sel)
    del f, qd, rows, sq_leaf
    torch.cuda.empty_cache()
    x, q = cs.iid_data(100_000, 128, 32_768)
    cfg = rp.rp_tree_cfg(64, *x.shape)
    f = rp.forest_batch(cs.SEED, cfg.max_depth, 64, 8, cfg.proj_nz_density,
                        torch.as_tensor(x, device=dev), device=dev)
    f.pack_leaves(dtype=torch.int8, slack=8)
    same &= chunk_tables("iid_chunk_own_pairs", f,
                         torch.as_tensor(q, device=dev), IID_BUDGET,
                         IID_PROBES, TILE_M)
    del f, x, q
    torch.cuda.empty_cache()
    x, q = cs.clustered_on_card(10_000_000, 128, 40_000, 0.15, 65_536, dev)
    q = q[:8192]
    cfg = rp.rp_tree_cfg_clustered(10_000_000, 128, centers=40_000)
    f = rp.forest_batch(cs.SEED, cfg.max_depth, cfg.min_leaf, 8,
                        cfg.proj_nz_density, x, device=dev)
    f.pack_leaves(store="shared")
    same &= chunk_tables("shared_10m_grouped_chunk", f, q, 1, 8, 16)
    rows, sq_leaf, _ = f._packed
    sel, _ = fm._probe_pairs(f, q, 1, 8, K)
    same &= gather_pair_turns(lib, "shared_10m_chunk", rows, sq_leaf, q, sel)
    del f, x, q, rows, sq_leaf, sel
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError("kernel 9 or kernel 6's shared-row mode differs "
                             "from the earlier build's bits or its twin")


def kernel_device_us(fn, calls=10):
    """Device microseconds and launches a call of ``fn`` spends in each
    kernel, by name (``torch.profiler``, ``calls`` calls after a warm-up):
    ``{name: [us, launches]}``."""
    def self_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:70]: [self_us(e) / calls, e.count / calls]
            for e in prof.key_averages() if self_us(e) > 0}


def grid_count(fn, calls=4):
    """The grids (kernels, memsets) one call of ``fn`` runs on the card:
    the device events of a ``torch.profiler`` trace of ``calls`` calls
    after a warm-up, over ``calls``; None where the trace holds no device
    event.  (Kernel 9's own count is ``chip_smoke.tables_grids``; this
    one also counts an earlier build's.)"""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    return round(n / calls) if n else None


def query_route_sweep(label, xs, sq, q, sel, plans):
    """Kernel 6's query route on one chunk's pairs at other ring plans
    (rows a stage of its two): device ms of each (``graph_ms``), bit-equal
    to the wrapper's plan; an ``index_select`` of the rows the route reads
    (each query's distinct rows) as the gather's yardstick; the kernel's
    and the earlier build's device time by kernel."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import fused_gather as fg

    g, lmax, d = xs.shape
    b, p = sel.shape
    bf16 = xs.dtype == torch.bfloat16
    lib = _cuda.lib()
    fn = (lib.rpt_gather_score_shared_query_bf16 if bf16
          else lib.rpt_gather_score_shared_query_f32)
    _, (rs0, hbits) = fg.shared_route(p, lmax, d, xs.rows.element_size())
    want = fg._gather_score(xs, sq, q, sel, route="query")
    dots = torch.empty_like(want[0])
    sqx = torch.empty_like(want[1])

    def run(rs):
        code = fn(_cuda.ptr(xs.rows), _cuda.ptr(xs.ids), xs.rows.shape[0],
                  _cuda.ptr(sq), _cuda.ptr(q), _cuda.ptr(sel),
                  _cuda.ptr(dots), _cuda.ptr(sqx), b, p, g, lmax, d, rs,
                  hbits, _cuda.stream_of(q))
        assert code == 0, (rs, code)

    rec = {"query_route_sweep": label, "plan": [rs0, hbits], "device_ms": {}}
    for rs in plans:
        run(rs)
        torch.cuda.synchronize()
        if not same_bits(dots, want[0]):
            raise AssertionError(f"{label}: {rs} rows a stage differ")
        rec["device_ms"][f"2x{rs}"] = cs.graph_ms(lambda: run(rs))
    ids = xs.ids[sel.long().clamp(0, g - 1)].reshape(b, -1)
    ids = torch.where(ids >= 0, ids.clamp_max(xs.rows.shape[0] - 1), -1)
    srt = torch.sort(ids, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    union = srt[first & (srt >= 0)].long()
    rec["union_rows"] = union.numel()
    rec["index_select_device_ms"] = cs.graph_ms(
        lambda: xs.rows.index_select(0, union))
    shuffled = union[torch.randperm(union.numel(), device=union.device)]
    rec["index_select_shuffled_device_ms"] = cs.graph_ms(
        lambda: xs.rows.index_select(0, shuffled))
    rec["index_select_tb_per_s"] = (union.numel() * d * xs.rows.element_size()
                                    / rec["index_select_device_ms"] / 1e9)
    rec["kernels_us"] = kernel_device_us(
        lambda: fg._gather_score(xs, sq, q, sel, route="query"))
    print(json.dumps(rec), flush=True)


def tune(lib):
    """Design readings for kernels 9 and 6 (``--tune``): kernel 9's device
    time by kernel, this tree's (its digit plan, and digits of at most 8
    and 11 bits) and the
    earlier build's, at the clustered chunk's, the iid chunk's and the hot
    block's ``TABLES`` shapes, at G 524,288 (the 10M grouped chunk's G) and
    at the sub-block chunks' pairs (32 and 64 a query);
    kernel
    6's query route at other ring plans at phase 2's shape and on the 10M
    chunk, beside an ``index_select`` of the same rows."""
    import rptree_tpu_torch as rp
    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import grouped as og

    dev = torch.device("cuda", 0)
    shapes = {name: row for name, *row in cs.TABLES}
    shapes["g_524288"] = (524_288, 8, 8192, 8, 16, True, 0.0, None)
    # the pairs of sub-blocks of 4 and 8 on the clustered 1M forest's
    # chunk ((j) and (m) of phase 8): 32 and 64 a query
    shapes["g_262144_p32"] = (262_144, 8, 65_536, 32, 8, False, 0.0, None)
    shapes["g_524288_p64"] = (524_288, 8, 65_536, 64, 8, False, 0.0, None)
    for name in ("clustered_chunk", "iid_chunk", "hot_block", "g_524288",
                 "g_262144_p32", "g_524288_p64"):
        g, trees, b, p, tile_m, hot, masked, share = shapes[name]
        gsel, lsel, lens = cs.table_pairs(g, trees, b, p, hot, masked, dev,
                                          seed=21)
        need = int(og.tile_tables_reference(gsel, lsel, lens, tile_m, 1)[2])
        nt = need + need // 8
        args = (gsel, lsel, lens, tile_m, nt)
        print(json.dumps({
            "kernel9_by_kernel_us": name, "pairs": gsel.numel(), "G": g,
            "tree": kernel_device_us(lambda: og.tile_tables(*args)),
            "tree_8_bits": kernel_device_us(
                lambda: og._tables_on_card(*args, max_bits=8)),
            "tree_11_bits": kernel_device_us(
                lambda: og._tables_on_card(*args, max_bits=11)),
            "base": kernel_device_us(lambda: base_tile_tables(lib, *args)),
            "tree_device_ms": cs.graph_ms(lambda: og.tile_tables(*args)),
            "base_device_ms": cs.graph_ms(
                lambda: base_tile_tables(lib, *args))}), flush=True)
    if "--tables-only" in sys.argv[1:]:
        return
    plans = [24, 28, 32, 40, 48]
    xs, sq, q, sel = cs.shared_inputs(1_000_000, 65_536, 128, 128, 2048, 8,
                                      dev, seed=17)
    query_route_sweep("phase2_f32", xs, sq, q, sel, plans)
    del xs, sq, q, sel
    x, q = cs.clustered_data(1_000_000, 128, 4_000, 0.15, 2048)
    cfg = rp.rp_tree_cfg(128, *x.shape)
    f = rp.forest_batch(cs.SEED, cfg.max_depth, 128, 8, cfg.proj_nz_density,
                        torch.as_tensor(x, device=dev), device=dev)
    f.pack_leaves(store="shared")
    rows, sq_leaf, _ = f._packed
    q = torch.as_tensor(q, device=dev)
    sel, _ = fm._probe_pairs(f, q, 1, 8, K)
    query_route_sweep("n_chunk", rows, sq_leaf, q, sel.contiguous(), plans)
    del f, x, q, rows, sq_leaf, sel
    torch.cuda.empty_cache()
    x, q = cs.clustered_on_card(10_000_000, 128, 40_000, 0.15, 65_536, dev)
    q = q[:8192]
    cfg = rp.rp_tree_cfg_clustered(10_000_000, 128, centers=40_000)
    f = rp.forest_batch(cs.SEED, cfg.max_depth, cfg.min_leaf, 8,
                        cfg.proj_nz_density, x, device=dev)
    f.pack_leaves(store="shared")
    rows, sq_leaf, _ = f._packed
    sel, _ = fm._probe_pairs(f, q, 1, 8, K)
    query_route_sweep("shared_10m_chunk", rows, sq_leaf, q, sel.contiguous(),
                      plans)
    print(json.dumps({"base_kernel6_by_kernel_us": "shared_10m_chunk",
                      "base": kernel_device_us(lambda: base_gather_shared(
                          lib, rows, sq_leaf, q, sel.contiguous()))}),
          flush=True)


def tables_host_breakdown(lib):
    """Kernel 9's wrapper's host time a call (``cs.host_us``), item by item,
    at the iid and clustered chunks' ``TABLES`` shapes, beside the earlier
    build's wrapper and kernel 11's (``project_rows`` at the iid chunk's
    projections): ``checks``, ``alloc`` (the five outputs from one
    allocation cut by one ``split``, the scratch apart), in turns with
    ``alloc_six`` (the scratch and five outputs apart) and ``alloc_one``
    (the scratch and the outputs from one allocation), ``launch`` (the
    packed ``ctypes`` call, the launches included), ``ctypes`` (the same
    call refused before any launch: the conversion floor) and ``rest``.
    Each the median of 9 batches of 100 calls."""
    from rptree_tpu_torch import _cuda
    from rptree_tpu_torch.ops import build as bd
    from rptree_tpu_torch.ops import grouped as og

    dev = torch.device("cuda", 0)
    new = _cuda.lib()

    def hu(fn):
        return cs.host_us(fn, calls=100, batches=9)

    for i, (name, g, trees, b, p, tile_m, hot, masked, share) in enumerate(
            cs.TABLES):
        if name not in ("iid_chunk", "clustered_chunk"):
            continue
        gsel, lsel, lens = cs.table_pairs(g, trees, b, p, hot, masked, dev,
                                          seed=21 + i)
        need = int(og.tile_tables_reference(gsel, lsel, lens, tile_m, 1)[2])
        nt = need + need // 8
        e = gsel.numel()
        bits = og.table_digit_bits(e)
        length = og._tables_scratch(e, g, bits)
        tb, tp, needed, slot, lens_t = og._tables_buffers(dev, e, nt, tile_m)
        scratch = torch.empty(length, dtype=torch.int32, device=dev)

        def launch(gg=g, check=True):
            with _cuda.on(dev):
                code = new.rpt_tile_tables(og._TABLES_ARGS.pack(
                    gsel.data_ptr(), lsel.data_ptr(), lens.data_ptr(),
                    tb.data_ptr(), tp.data_ptr(), slot.data_ptr(),
                    lens_t.data_ptr(), needed.data_ptr(), 0,
                    scratch.data_ptr(), length, e, gg, nt, tile_m, bits,
                    _cuda.raw_stream(dev)))
            if check:
                _cuda.check(code, "tile_tables")

        def six():
            return (torch.empty(length, dtype=torch.int32, device=dev),
                    torch.empty(nt, dtype=torch.int32, device=dev),
                    torch.empty((nt, tile_m), dtype=torch.int32, device=dev),
                    torch.empty((), dtype=torch.int32, device=dev),
                    torch.empty(e, dtype=torch.int64, device=dev),
                    torch.empty(nt, dtype=torch.int32, device=dev))

        def one():
            at = length + (length & 1)
            sc, sl, t_b, l_t, t_p, nd = torch.empty(
                at + 2 * e + nt * (tile_m + 2) + 1, dtype=torch.int32,
                device=dev).split([at, 2 * e, nt, nt, nt * tile_m, 1])
            return (sc, t_b, t_p.view(nt, tile_m), nd.view(()),
                    sl.view(torch.int64), l_t)

        rec = {"call": hu(lambda: og.tile_tables(gsel, lsel, lens, tile_m,
                                                 nt)),
               "checks": hu(lambda: (
                   og._check_tables(gsel, lsel, lens, tile_m, nt),
                   _cuda.check_operands("tile_tables", dev,
                                        ("gsel", gsel, torch.int32),
                                        ("lsel", lsel, torch.int32),
                                        ("lens_of_block", lens,
                                         torch.int32)))),
               "launch": hu(launch),
               "ctypes": hu(lambda: launch(0, False))}
        forms = (lambda: (og._tables_buffers(dev, e, nt, tile_m),
                          torch.empty(length, dtype=torch.int32,
                                      device=dev)),
                 six, one)
        first = [hu(fn) for fn in forms]
        last = [hu(fn) for fn in reversed(forms)][::-1]
        rec["alloc"] = (first[0] + last[0]) / 2
        rec["alloc_six"] = (first[1] + last[1]) / 2
        rec["alloc_one"] = (first[2] + last[2]) / 2
        rec["rest"] = rec["call"] - rec["checks"] - rec["alloc"] - rec["launch"]
        x = torch.randn(32_768, 128, device=dev)
        r = torch.randn(640, 128, device=dev)
        print(json.dumps({
            "host_breakdown_us": "tile_tables", "shape": name, "pairs": e,
            "G": g, "nt": nt, "tile_tables": rec,
            "base": {"call": hu(lambda: base_tile_tables(
                lib, gsel, lsel, lens, tile_m, nt))},
            "project_rows_iid_chunk": hu(lambda: bd.project_rows(x, r)),
            "units": {"empty": hu(lambda: torch.empty(
                nt, dtype=torch.int32, device=dev)),
                "view": hu(lambda: gsel[0])}}), flush=True)


def stages(f, fm, og, gk, tk, rr, qc, cap, sync, budget, probes, base=None):
    """Stage times of one chunk ``qc`` at tile capacity ``cap``, probed
    with ``budget`` and ``probes``.  The scoring stage is named by the
    kernel the blocks take: kernel 1 (f32, bf16) or kernel 2 (int8).  On
    int8 blocks, ``base`` (the earlier build's library) adds that build's
    kernel 2 as two stages, its plain-torch operands and its launch, and
    its kernel-tail sum; kernel 4 serves no int8 blocks."""
    x_leaf, sq_leaf, id_leaf = f._packed
    lens = f._lens_global()
    int8 = x_leaf.dtype == torch.int8
    st = {}
    (gsel, lsel), st["traversal_probes"] = timed(lambda: fm._select_probes(
        f.plan, f.arrays, qc, budget, probes, k=K, block_len=lens,
        table=f._table()), sync)
    b, p = gsel.shape
    (tb, tp, needed, inv, lens_t), st["tile_tables"] = timed(
        lambda: og.tile_tables(gsel, lsel, lens, TILE_M, cap), sync)
    qt, st["query_gather"] = timed(
        lambda: qc[torch.where(tp >= 0, tp // p, 0).reshape(-1).long()], sync)
    if int8:
        score = "kernel2_tiles_int8"
        d_all, st[score] = timed(lambda: gk.grouped_score_tiles_int8(
            x_leaf, sq_leaf, f._block_scale, tb, lens_t, qt, "l2", TILE_M),
            sync)
        if base is not None:
            ops, st["base_int8_operands"] = timed(lambda: gk._int8_operands(
                f._block_scale, tb, qt), sync)
            _, st["base_kernel2_launch"] = timed(lambda: base_int8_tiles(
                base, x_leaf, sq_leaf, f._block_scale, tb, lens_t, qt, TILE_M,
                ops), sync)
            del ops
    else:
        score = "kernel1_tiles"
        d_all, st[score] = timed(lambda: gk.grouped_score_tiles(
            x_leaf, sq_leaf, tb, lens_t, qt, "l2", TILE_M), sync)
    d, st["pair_reorder"] = timed(lambda: og._pair_rows(
        d_all, inv, float("inf"), b, p).reshape(b, -1), sync)
    ids, st["id_gather"] = timed(
        lambda: id_leaf[gsel.long()].reshape(b, -1), sync)
    _, st["kernel3_topk_tail"] = timed(
        lambda: tk.topk_dedup_kernel(d, ids, K), sync)
    (ds, order), st["sort_tail_sort"] = timed(
        lambda: torch.sort(d, dim=1, stable=True), sync)
    kk = K * f.n_trees
    (d_kk, i_kk), st["sort_tail_take_kk"] = timed(lambda: (
        ds[:, :kk], torch.where(torch.isinf(ds[:, :kk]), -1,
                                ids.gather(1, order[:, :kk]))), sync)
    _, st["sort_tail_merge"] = timed(lambda: rr.merge_top_k(d_kk, i_kk, K),
                                     sync)
    head = st["traversal_probes"] + st["tile_tables"] + st["query_gather"]
    rest = st["pair_reorder"] + st["id_gather"]
    scored = head + st[score] + rest
    st["sum_kernel_tail"] = scored + st["kernel3_topk_tail"]
    st["sum_sort_tail"] = (scored + st["sort_tail_sort"]
                           + st["sort_tail_take_kk"] + st["sort_tail_merge"])
    if "base_kernel2_launch" in st:
        st["sum_kernel_tail_base"] = (
            head + st["base_int8_operands"] + st["base_kernel2_launch"] + rest
            + st["kernel3_topk_tail"])
    kp = -(-max(K, 8) // 8) * 8
    if not int8:
        (dk, ik), st["kernel4_tiles_topk"] = timed(
            lambda: gk.grouped_score_topk(x_leaf, sq_leaf, id_leaf, tb, lens_t,
                                          qt, "l2", TILE_M, kp), sync)
        (dp, ip), st["kp_pair_reorder"] = timed(lambda: (
            og._pair_rows(dk, inv, float("inf"), b, p).reshape(b, -1),
            og._pair_rows(ik, inv, -1, b, p).reshape(b, -1)), sync)
        _, st["kp_sort_tail"] = timed(lambda: fm._selection_tail_ids(
            dp, ip, K, min(kk, p * kp), True), sync)
        st["sum_kernel_topk"] = (head + st["kernel4_tiles_topk"]
                                 + st["kp_pair_reorder"] + st["kp_sort_tail"])
    for metric in ("l2", "cosine"):
        _, st[f"xla_form_{metric}"] = timed(lambda: og.grouped_distances(
            x_leaf, sq_leaf, lens, gsel, lsel, qc, metric, TILE_M, cap, 2048,
            block_scale=f._block_scale), sync)
    ops = {"tb": tb, "lens": lens_t, "qt": qt, "d": d, "ids": ids, "kp": kp}
    return st, int(needed), ops


def iid_cell(rp, fm, og, gk, tk, rr, dev, sync, on_card, base):
    """The iid 100k cell as ``chip_smoke.py``'s phase 4 builds and serves
    it (seed, T 8, ``min_leaf`` 64, int8 blocks with slack 8, budget 2,
    probes 10, tile_m 8, chunks of 32,768, the kernel tail): the stages of
    its first chunk, and with ``base`` the earlier kernel 2 against this
    tree's on that chunk's own tiles."""
    n, nq, chunk = ((100_000, 65_536, 32_768) if on_card
                    else (4_000, 1_024, 512))
    x, q = cs.iid_data(n, 128, nq)
    cfg = rp.rp_tree_cfg(64, n, 128)
    f = rp.forest_batch(cs.SEED, cfg.max_depth, 64, 8, cfg.proj_nz_density,
                        torch.as_tensor(x, device=dev), device=dev)
    qd = torch.as_tensor(q, device=dev)
    del x, q
    f.pack_leaves(dtype=torch.int8, slack=8)
    serve = dict(budget=IID_BUDGET, probes=IID_PROBES, tile_m=TILE_M,
                 chunk=chunk)
    f.knn_grouped(qd, K, selection="kernel", **serve)  # learn the capacity
    (cap,) = f._grouped_nt.values()
    st, needed, ops = stages(f, fm, og, gk, tk, rr, qd[:chunk], cap, sync,
                             IID_BUDGET, IID_PROBES, base)
    print(json.dumps({"stages_ms": "iid_int8", "chunk": chunk,
                      "needed": needed, "cap": cap,
                      "lmax": int(f._packed[0].shape[1]), **st}), flush=True)
    descent_turns("iid_int8", f, fm, qd[:chunk], IID_BUDGET, IID_PROBES, sync,
                  on_card)
    tables_turns("iid_int8", f, fm, og, qd[:chunk], IID_BUDGET, IID_PROBES,
                 cap, sync, on_card)
    if base is not None:
        x_leaf, sq_leaf, _ = f._packed
        int8_turns(base, "iid_chunk", x_leaf, sq_leaf, f._block_scale,
                   ops["tb"], ops["lens"], ops["qt"])
    print(json.dumps({"profile": "iid_int8", "selection": "kernel",
                      "impl": "kernel", **device_times(f, qd, serve, "kernel",
                                                       "kernel", on_card)}),
          flush=True)


def pair_stages(f, fm, fg, rr, qc, sync):
    """Stage times of one per-pair chunk ``qc`` on f32 blocks, as
    ``_knn_packed`` runs it: probe selection, kernel 6, distances and
    occupancy mask, the sort tail; then the whole call."""
    x_leaf, sq_leaf, id_leaf = f._packed
    lens = f._lens_global()
    lmax = x_leaf.shape[1]
    st = {}
    (gsel, lsel), st["traversal_probes"] = timed(lambda: fm._select_probes(
        f.plan, f.arrays, qc, BUDGET, PROBES, k=K, block_len=lens,
        table=f._table()), sync)
    b = gsel.shape[0]
    (dots, sqx), st["kernel6_gather_score"] = timed(
        lambda: fg.gather_score(x_leaf, sq_leaf, qc, gsel.contiguous()), sync)
    col = torch.arange(lmax, device=qc.device)
    d, st["distances_mask"] = timed(lambda: torch.where(
        (lsel >= 0)[..., None] & (col < lens[gsel.long()][..., None]),
        rr.distances_from_dots(dots, sqx, qc[:, None], "l2"),
        float("inf")).reshape(b, -1), sync)
    _, st["sort_tail"] = timed(lambda: fm._selection_tail(
        d, id_leaf, gsel, K, K * f.n_trees, True), sync)
    st["sum"] = sum(st.values())
    _, st["whole_call"] = timed(
        lambda: f.knn(qc, K, budget=BUDGET, probes=PROBES), sync)
    return st


def shared_10m_stages(rp, fm, fg, og, rr, tk, dev, sync, on_card):
    """The 10M shared-row cell (``chip_smoke.py`` phase 8b's): build and
    pack times, the peak device memory, the shared tables' bytes beside the
    blocked T=8 layout's rows; stage times of one per-pair chunk of 8,192
    (kernels 7-8, kernel 6's shared-row mode, distances and mask, the sort
    tail or kernel 3) and one grouped chunk of 8,192 at tile_m 16 (kernels
    7-8, kernel 9, the XLA form through the id tables, the sort tail),
    each beside its whole call."""
    n, nq, centers, chunk = ((10_000_000, 65_536, 40_000, 8192) if on_card
                             else (40_000, 2048, 160, 512))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    x, q = cs.clustered_on_card(n, 128, centers, 0.15, nq, dev)
    cfg = rp.rp_tree_cfg_clustered(n, 128, centers=centers)
    f, build_ms = timed(lambda: rp.forest_batch(
        cs.SEED, cfg.max_depth, cfg.min_leaf, 8, cfg.proj_nz_density, x,
        device=dev), sync, reps=1)
    _, pack_ms = timed(lambda: f.pack_leaves(store="shared"), sync, reps=1)
    rows, sq_leaf, id_leaf = f._packed
    g, lmax, _ = rows.shape
    qc = q[:chunk]
    lens = f._lens_global()
    st = {}
    (gsel, lsel), st["traversal_probes"] = timed(
        lambda: fm._probe_pairs(f, qc, 1, 8, K), sync)
    (dots, sqx), st["kernel6_gather_score_shared"] = timed(
        lambda: fg.gather_score(rows, sq_leaf, qc, gsel.contiguous()), sync)
    col = torch.arange(lmax, device=dev)
    d, st["distances_mask"] = timed(lambda: torch.where(
        (lsel >= 0)[..., None] & (col < lens[gsel.long()][..., None]),
        rr.distances_from_dots(dots, sqx, qc[:, None], "l2"),
        float("inf")).reshape(chunk, -1), sync)
    ids = id_leaf[gsel.long()].reshape(chunk, -1)
    _, st["sort_tail"] = timed(lambda: fm._selection_tail_ids(
        d, ids, K, K * f.n_trees, True), sync)
    _, st["kernel3_tail"] = timed(lambda: tk.topk_dedup_kernel(d, ids, K),
                                  sync)
    st["sum_sort_tail"] = (st["traversal_probes"]
                           + st["kernel6_gather_score_shared"]
                           + st["distances_mask"] + st["sort_tail"])
    _, st["whole_call"] = timed(lambda: f.knn_batched(
        qc, K, budget=1, probes=8, precision="default", chunk=chunk), sync)
    del dots, sqx, d, ids
    print(json.dumps({"shared_10m_pair_stages_ms": chunk, **st}), flush=True)
    serve = dict(budget=1, probes=8, precision="default", chunk=chunk,
                 tile_m=16)
    f.knn_grouped(q, K, **serve)  # learn the capacity
    cap = max(f._grouped_nt.values())
    gt = {}
    _, gt["traversal_probes"] = timed(
        lambda: fm._probe_pairs(f, qc, 1, 8, K), sync)
    _, gt["tile_tables"] = timed(
        lambda: og.tile_tables(gsel, lsel, lens, 16, cap), sync)
    (dg, _), gt["xla_form_with_tables_and_reorder"] = timed(
        lambda: og.grouped_distances(rows, sq_leaf, lens, gsel, lsel, qc,
                                     "l2", 16, cap, 2048), sync)
    _, gt["sort_tail"] = timed(lambda: fm._selection_tail(
        dg.reshape(chunk, -1), id_leaf, gsel, K, K * f.n_trees, True), sync)
    gt["sum"] = (gt["traversal_probes"] + gt["xla_form_with_tables_and_reorder"]
                 + gt["sort_tail"])
    _, gt["whole_call"] = timed(lambda: f.knn_grouped(
        qc, K, check=False, **serve), sync)
    print(json.dumps({"shared_10m_grouped_stages_ms": chunk, "cap": cap,
                      **gt}), flush=True)
    print(json.dumps({
        "shared_10m": n, "build_ms": build_ms, "pack_ms": pack_ms,
        "blocks": g, "lmax": lmax,
        "shared_tables_bytes": id_leaf.numel() * 4 + sq_leaf.numel() * 4,
        "row_store_bytes": rows.rows.numel() * rows.rows.element_size(),
        "blocked_t8_rows_bytes": g * lmax * 128 * 4,
        "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated()
                                       if on_card else None)}), flush=True)


def sparse_stages(rp, fm, og, tk, dev, sync, on_card):
    """The bag-of-words cell (``chip_smoke.py`` phase 9's): build and pack
    times, then the stages of one grouped chunk of 4,096 queries with the
    kernel tail, (s2) dense and (s3) sparse: densify (s3), traversal +
    probes (kernels 11, 7, 8; the projections also apart), tile tables
    (kernel 9), the queries' norms, kernel 10, pair reorder, id gather,
    kernel 3; and of one per-pair chunk of 512 (s1): traversal + probes,
    kernel 10 as tiles of one, the sort tail; each beside its whole call,
    and the same chunk as sparse queries (s4), its densify apart."""
    from rptree_tpu_torch.ops import ell_kernel as ek
    from rptree_tpu_torch.ops import traverse as tv
    from rptree_tpu_torch.ops.sparse import EllMatrix, ell_take, ell_to_dense

    n, nq, chunk, pchunk = ((cs.SPARSE_N, 8192, 4096, 512) if on_card
                            else (20_000, 1024, 512, 128))
    cols, vals = cs.sparse_rows(n, cs.SEED)
    cfg = rp.rp_tree_cfg(128, n, cs.SPARSE_V)
    f, build_ms = timed(lambda: rp.forest_batch(
        cs.SEED, cfg.max_depth, 128, 8, cfg.proj_nz_density,
        EllMatrix(cs.SPARSE_V, cols, vals), device=dev), sync, reps=1)
    _, pack_ms = timed(f.pack_leaves, sync, reps=1)
    print(json.dumps({"sparse_cell": n, "build_ms": build_ms,
                      "pack_ms": pack_ms, "depth": cfg.max_depth,
                      "blocks": list(f._packed[0].shape)}), flush=True)
    qi = np.random.default_rng(cs.SEED + 11).integers(0, n, size=nq)
    qe = ell_take(f.x, torch.as_tensor(qi, device=dev))
    serve = dict(cs.SPARSE_GROUPED, chunk=chunk)
    f.knn_grouped(qe, K, **serve)  # learn the capacity
    cap = max(f._grouped_nt.values())
    blocks, sq_leaf, id_leaf = f._packed
    lens = f._lens_global()
    budget, p = serve["budget"], cs.SPARSE_PROBES
    qs = ell_take(qe, slice(0, chunk))
    for label in ("s2_dense_queries", "s3_sparse_queries"):
        st = {}
        if label.startswith("s3"):
            qc, st["densify"] = timed(lambda: ell_to_dense(qs, torch.float32),
                                      sync)
        else:
            qc = ell_to_dense(qs, torch.float32)
        _, proj_ms = timed(lambda: tv.project_queries(qc, f.arrays.r,
                                                      f.plan.n_levels), sync)
        (gsel, lsel), st["traversal_probes"] = timed(
            lambda: fm._probe_pairs(f, qc, budget, p, K), sync)
        (tb, tp, _, inv, lens_t), st["kernel9_tile_tables"] = timed(
            lambda: og.tile_tables(gsel, lsel, lens, serve["tile_m"], cap),
            sync)
        qq, st["query_norms"] = timed(lambda: (qc * qc).sum(-1), sync)
        d_all, st["kernel10_ell_score_tiles"] = timed(
            lambda: ek.ell_score_tiles(blocks, sq_leaf, tb, tp, lens_t, qc,
                                       qq, p, "l2"), sync)
        d, st["pair_reorder"] = timed(lambda: og._pair_rows(
            d_all, inv, float("inf"), chunk, p).reshape(chunk, -1), sync)
        ids, st["id_gather"] = timed(
            lambda: id_leaf[gsel.long()].reshape(chunk, -1), sync)
        _, st["kernel3_tail"] = timed(
            lambda: tk.topk_dedup_kernel(d, ids, K), sync)
        st["sum"] = sum(st.values())
        st["kernel11_projections_within_traversal"] = proj_ms
        whole = qs if label.startswith("s3") else qc
        _, st["whole_call"] = timed(lambda: f.knn_grouped(
            whole, K, check=False, **serve), sync)
        print(json.dumps({"sparse_grouped_stages_ms": label, "chunk": chunk,
                          "cap": cap, **st}), flush=True)
        del d_all, d, ids
    qc = ell_to_dense(ell_take(qe, slice(0, pchunk)), torch.float32)
    st = {}
    (gsel, lsel), st["traversal_probes"] = timed(
        lambda: fm._probe_pairs(f, qc, budget, p, K), sync)
    d, st["kernel10_tiles_of_one"] = timed(
        lambda: fm._score_ell_pairs(f, gsel, lsel, qc, "l2"), sync)
    _, st["sort_tail"] = timed(lambda: fm._selection_tail(
        d, id_leaf, gsel, K, K * f.n_trees, True), sync)
    st["sum"] = sum(st.values())
    _, st["whole_call"] = timed(lambda: f.knn_batched(
        qc, K, **dict(cs.SPARSE_PAIR, chunk=pchunk)), sync)
    # (s4): the same chunk as an EllMatrix, densified inside the call
    qs = ell_take(qe, slice(0, pchunk))
    _, st["s4_densify"] = timed(lambda: ell_to_dense(qs, torch.float32), sync)
    _, st["s4_whole_call"] = timed(lambda: f.knn_batched(
        qs, K, **dict(cs.SPARSE_PAIR, chunk=pchunk)), sync)
    print(json.dumps({"sparse_pair_stages_ms": "s1_dense_queries",
                      "chunk": pchunk, **st}), flush=True)


def device_times(f, qd, serve, sel, impl, on_card, metric="l2"):
    """Wall ms of one whole call under ``torch.profiler`` and its kernels'
    device ms, the largest eight by name."""
    def self_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    f.knn_grouped(qd, K, metric, selection=sel, impl=impl, check=False,
                  **serve)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize()
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        f.knn_grouped(qd, K, metric, selection=sel, impl=impl, check=False,
                      **serve)
        if on_card:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = sorted(prof.key_averages(), key=lambda e: -self_ms(e))
    return {"wall_ms_under_profiler": wall,
            "device_ms": sum(self_ms(e) for e in ka),
            "top": [(e.key[:60], self_ms(e)) for e in ka[:8]]}


def main():
    import rptree_tpu_torch as rp
    from rptree_tpu_torch.models import forest as fm
    from rptree_tpu_torch.ops import fused_gather as fg
    from rptree_tpu_torch.ops import grouped as og
    from rptree_tpu_torch.ops import grouped_kernel as gk
    from rptree_tpu_torch.ops import rerank as rr
    from rptree_tpu_torch.ops import topk_kernel as tk

    on_card = "--cpu" not in sys.argv[1:]
    if on_card and not torch.cuda.is_available():
        raise SystemExit("chip_stages: no CUDA device (use --cpu to rehearse)")
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    grouped_lib = None
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        print(smi.strip().splitlines()[0], flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
    if "--sparse" in sys.argv[1:]:  # phase 9's cell alone
        return sparse_stages(rp, fm, og, tk, dev, sync, on_card)
    if "--turns" in sys.argv[1:]:  # kernels 6-11 against a base's
        src = "_checkout/base"
        has = [all(os.path.exists(os.path.join(src, n)) for n in names)
               for names in (DESCENT_BASE, SPARSE_BASE, TABLES_BASE)]
        if not on_card or not any(has):
            raise SystemExit(f"chip_stages --turns: needs the card and "
                             f"{DESCENT_BASE}, {SPARSE_BASE} or {TABLES_BASE} "
                             f"of an earlier commit in {src}")
        if has[2] and "--tune" in sys.argv[1:]:
            tune(base_tables_lib(src))
            return None
        if has[2]:
            lib = base_tables_lib(src)
            tables_host_breakdown(lib)
            shared_base_turns(lib)
        if has[0]:
            lib = base_descent_lib(src)
            descent_base_turns(lib)
            host_breakdown(lib)
        if has[1]:
            sparse_turns(base_sparse_lib(src))
        return None
    if "--shared-10m" in sys.argv[1:]:  # phase 8b's cell alone
        from rptree_tpu_torch.ops import fused_gather as fg
        return shared_10m_stages(rp, fm, fg, og, rr, tk, dev, sync, on_card)
    if on_card:
        print(json.dumps({"build": build_times()}), flush=True)
        src = "_checkout/base"
        if all(os.path.exists(os.path.join(src, n)) for n in GROUPED_BASE):
            print(json.dumps({"build_base_vs_tree": build_turns(src)}),
                  flush=True)
            grouped_lib = base_grouped_lib(src)
            compare_grouped_base(grouped_lib)
        if os.path.exists(os.path.join(src, "scan_topk.cu")):
            compare_base(src)
        if grouped_lib is None:
            print(json.dumps({"base_vs_tree": f"skipped: no earlier sources in "
                              f"{src}"}), flush=True)
    iid_cell(rp, fm, og, gk, tk, rr, dev, sync, on_card, grouped_lib)
    if on_card:
        torch.cuda.empty_cache()
    n, nq, centers, chunk = ((1_000_000, 131_072, 4_000, 65_536) if on_card
                             else (20_000, 1_024, 80, 512))
    x, q = cs.clustered_data(n, 128, centers, 0.15, nq)
    cfg = rp.rp_tree_cfg(128, *x.shape)
    f = rp.forest_batch(cs.SEED, cfg.max_depth, 128, 8, cfg.proj_nz_density,
                        torch.as_tensor(x, device=dev), device=dev)
    qd = torch.as_tensor(q, device=dev)
    del x, q
    serve = dict(budget=BUDGET, probes=PROBES, tile_m=TILE_M, chunk=chunk)
    for dtype, name in ((None, "f32"), (torch.bfloat16, "bf16")):
        f.pack_leaves(dtype=dtype)
        f.knn_grouped(qd, K, selection="sort", **serve)  # learn the capacity
        (cap,) = f._grouped_nt.values()
        st, needed, ops = stages(f, fm, og, gk, tk, rr, qd[:chunk], cap,
                                 sync, BUDGET, PROBES)
        print(json.dumps({"stages_ms": name, "chunk": chunk, "needed": needed,
                          "cap": cap, **st}), flush=True)
        if dtype is None:
            descent_turns("clustered", f, fm, qd[:chunk], BUDGET, PROBES, sync,
                          on_card)
            descent_turns("per_pair", f, fm, qd[:min(2048, chunk)], BUDGET,
                          PROBES, sync, on_card)
            tables_turns("clustered", f, fm, og, qd[:chunk], BUDGET, PROBES,
                         cap, sync, on_card)
        if on_card and grouped_lib is not None:  # the chunk's own operands
            x_leaf, sq_leaf, id_leaf = f._packed
            grouped_turns(grouped_lib, "clustered_chunk", x_leaf, sq_leaf,
                          id_leaf, ops["tb"], ops["lens"], ops["qt"],
                          ops["kp"])
            if dtype is None:
                topk_turns(grouped_lib, "clustered_chunk", ops["d"],
                           ops["ids"])
        del ops
        for sel, impl, metric in (("kernel", "kernel", "l2"),
                                  ("sort", "kernel", "l2"),
                                  ("sort", "kernel_topk", "l2"),
                                  ("kernel", "auto", "cosine")):
            print(json.dumps({"profile": name, "selection": sel, "impl": impl,
                              "metric": metric, **device_times(
                                  f, qd, serve, sel, impl, on_card, metric)}),
                  flush=True)
        if dtype is None:
            pc = min(2048, chunk)
            print(json.dumps({"pair_stages_ms": name, "chunk": pc,
                              **pair_stages(f, fm, fg, rr, qd[:pc], sync)}),
                  flush=True)
    from rptree_tpu_torch.ops import scan as sc

    _, scan_ms = timed(lambda: f.brute_force_knn(
        qd[:2048], K, precision="fastest"), sync)
    rows, cast_ms = timed(lambda: sc.scan_rows(f.x, f.sq_norms), sync)
    _, kernel_ms = timed(lambda: sc.scan_topk(f.x, f.sq_norms, qd[:2048], K,
                                              rows=rows), sync)
    print(json.dumps({"scan_chunk_ms": scan_ms, "row_copy_ms": cast_ms,
                      "scan_with_copy_made_ms": kernel_ms,
                      "queries": min(2048, len(qd)), "rows": f.n_points}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
