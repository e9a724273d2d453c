"""Build and load the port's CUDA kernels.

The sources in ``csrc/*.cu`` are compiled on first use by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, and linked into ONE shared library with a plain C interface,
which is loaded with ``ctypes``.  No PyTorch header is compiled, so a
build takes seconds.  The library lands in ``_build/`` beside this file,
named by a hash of the sources and flags, so an edited source is never
served by a stale build.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a nonzero code.  Pointers and the stream are
passed as ``ctypes.c_void_p`` or plain ints; the descent's, the probe
selection's, the tile tables' and kernel 1's entry points take their
arguments packed as int64 in one buffer (``ops/traverse.py``,
``ops/grouped.py``, ``ops/grouped_kernel.py``).
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["build", "lib", "check", "check_operands", "ptr", "stream_of",
           "raw_stream", "on", "resolve_device"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    # the arguments packed as int64 (ops/grouped_kernel.py _SCORE_ARGS)
    "rpt_grouped_score": [ctypes.c_char_p],
    # x, sq, scale, tb, lens, qt, out, nt, g, tile_m, lmax, d, l2, stream
    "rpt_grouped_score_i8": [_P] * 7 + [_I] * 6 + [_P],
    # d, ids, rows (or null), nb, od, oi, b, p, lmax, k, dedup, regs, paths,
    # stream
    "rpt_topk_pairs": [_P] * 3 + [_L, _P, _P, _L] + [_I] * 5 + [_P, _P],
    # x, sq, ids, tb, lens, qt, od, oi, nt, g, tile_m, lmax, d, l2, kp, stream
    "rpt_grouped_topk_f32": [_P] * 8 + [_I] * 7 + [_P],
    "rpt_grouped_topk_bf16": [_P] * 8 + [_I] * 7 + [_P],
    # sel, n, g, runs, q, qr, nq, stream
    "rpt_pair_runs": [_P, _L, _I, _P, _P, _P, _L, _P],
    # x, sq, q, runs, dots, sqx, b, p, g, lmax, d, stream
    "rpt_gather_score_f32": [_P] * 6 + [_I] * 5 + [_P],
    "rpt_gather_score_bf16": [_P] * 6 + [_I] * 5 + [_P],
    # rows, ids, n, sq, q, runs, dots, sqx, b, p, g, lmax, d, stream
    "rpt_gather_score_shared_f32": [_P, _P, _L] + [_P] * 5 + [_I] * 5 + [_P],
    "rpt_gather_score_shared_bf16": [_P, _P, _L] + [_P] * 5 + [_I] * 5 + [_P],
    # rows, ids, n, sq, q, sel, dots, sqx, b, p, g, lmax, d, rs, hbits,
    # stream
    "rpt_gather_score_shared_query_f32": [_P, _P, _L] + [_P] * 5 + [_I] * 7
    + [_P],
    "rpt_gather_score_shared_query_bf16": [_P, _P, _L] + [_P] * 5 + [_I] * 7
    + [_P],
    # np, dp, b, k, out[3]
    "rpt_scan_plan": [_L, _I, _I, _I, ctypes.POINTER(_I)],
    # xb, sq, qb, pd, pi, od, oi, np, dp, b, k, dot, splits, tps, stream
    "rpt_scan_topk": [_P] * 7 + [_L] + [_I] * 6 + [_P],
    # the arguments packed as int64 (ops/traverse.py _TRAVERSE_ARGS,
    # _PROBES_ARGS)
    "rpt_traverse": [ctypes.c_char_p],
    "rpt_select_probes": [ctypes.c_char_p],
    # the arguments packed as int64 (ops/grouped.py _TABLES_ARGS)
    "rpt_tile_tables": [ctypes.c_char_p],
    # cols, vals, sq, tb, tp, lens, q, qq, bits, out, nt, g, tile_m, lmax,
    # k, v, b, p, metric, routes, stream
    "rpt_ell_score_f32": [_P] * 10 + [_I] * 9 + [_P, _P],
    "rpt_ell_score_bf16": [_P] * 10 + [_I] * 9 + [_P, _P],
    # q, b, v, bits, stream
    "rpt_ell_support": [_P, _L, _I, _P, _P],
    # x, ldx, r, out, scratch, n, l, d, tile, lt, stream
    "rpt_project": [_P, _L, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "rpt_project_segments": [_I],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return cand


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _run_all(cmds):
    """Run the commands at once; raise with the first failure's output.
    Returns the combined compiler output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{o}")
    return "".join(outs)


def build(verbose: bool = False):
    """Compile ``csrc/*.cu`` into the kernel library unless a build of the
    same sources exists.  Returns ``(path, seconds, compiler_output)``;
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) and always rebuilds."""
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = _BUILD / f"librptree_kernels_{h.hexdigest()[:16]}.so"
    if out.exists() and not verbose:
        return out, 0.0, ""
    _BUILD.mkdir(parents=True, exist_ok=True)
    flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs = [os.path.join(tmp, f"{p.stem}.o") for p in cus]
        log = _run_all([[_nvcc(), *flags, "-c", str(p), "-o", o]
                        for p, o in zip(cus, objs)])
        lib_tmp = os.path.join(tmp, out.name)
        log += _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]])
        os.replace(lib_tmp, out)
    return out, time.perf_counter() - t0, log


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        handle = ctypes.CDLL(str(path))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        handle.rpt_tile_tables_scratch.argtypes = [_L, _I, _I]
        handle.rpt_tile_tables_scratch.restype = _L
        handle.rpt_tile_tables_grids.argtypes = []
        handle.rpt_tile_tables_grids.restype = ctypes.c_longlong
        handle.rpt_error_string.argtypes = [ctypes.c_int]
        handle.rpt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = lib().rpt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")


def check_operands(name, device, *tensors):
    """Raise unless each ``(key, tensor, dtype)`` is a contiguous tensor of
    that dtype on ``device``: one test an operand, which a wrapper of a
    short kernel pays on every call, and the reason only on failure."""
    for key, t, dtype in tensors:
        if t.device == device and t.dtype == dtype and t.is_contiguous():
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        raise ValueError(f"{name}: {key} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def resolve_device(device) -> torch.device:
    """The device an entry point builds on: the card unless the caller
    names another.  ``None`` is the current CUDA device and raises where
    CUDA is absent; the CPU is used only when asked for (``"cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds on the card by "
                           "default; pass device='cpu' to use the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raw_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, by the call
    that skips building a ``torch.cuda.Stream`` (a few microseconds a
    launch, which a wrapper of a short kernel pays on every call)."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is None:
        return torch.cuda.current_stream(device).cuda_stream
    return get(device.index if device.index is not None
               else torch.cuda.current_device())


def on(device: torch.device):
    """A context that makes ``device`` current for a launch, and does
    nothing where it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
