"""Dataset ingest: fvecs / bvecs / ivecs (SIFT, GIST) and MNIST idx, a copy
of ``rptree_tpu/utils/ingest.py`` with its own build of the native reader.

The chunk producers here feed :class:`rptree_tpu_torch.streaming.
ForestBuilder` -- the role of the reference's conduit sources
(``mnist-idx-conduit`` in ``bench/time/Main.hs:113-121``, ``dataSource`` in
``Conduit.hs:179-188``).  Readers return numpy arrays on the host, as the
JAX package's do; the builders copy each chunk to their device.  The
writers take numpy arrays or tensors on any device.

Parsing runs in the native reader (``rptree_tpu_torch/csrc/ingest.cpp``,
the port's copy of ``native/ingest.cpp``), compiled with ``g++`` on first
use into ``rptree_tpu_torch/_build/`` (named by a hash of the source) and
loaded via ctypes.  Processes that start at once never load a half-written
library: each build goes to a temporary name and is renamed into place
under a file lock.  Where no toolchain is available a numpy fallback with
identical semantics takes over (:func:`native_available` says which);
tests compare the two byte for byte.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "read_fvecs", "read_bvecs", "read_ivecs", "read_idx",
    "fvecs_meta", "bvecs_meta", "ivecs_meta", "idx_meta",
    "fvecs_source", "bvecs_source", "idx_source", "native_available",
    "write_fvecs", "write_ivecs",
]

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ingest.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def build_library(build_dir=_BUILD) -> Path:
    """Compile the native reader into ``build_dir`` unless a build of the
    same source and flags is there; returns its path.  ``g++`` (or
    ``$CXX``) writes a temporary file that is renamed into place under an
    exclusive lock on ``build_dir/ingest.lock``, so concurrent callers
    wait for one build and never see a partial library.  Raises where the
    compiler is missing or fails."""
    build_dir = Path(build_dir)
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    out = build_dir / f"libingest_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: install g++ or set CXX")
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "ingest.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():  # another process built it meanwhile
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
                os.close(fd)
                try:
                    subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(_SOURCE)],
                                   check=True, capture_output=True,
                                   timeout=120)
                    os.replace(tmp, out)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i64, f32p, i32p, cp = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p)
    lib.xvecs_meta.argtypes = [cp, i64, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.fvecs_read.argtypes = [cp, i64, i64, i64, f32p]
    lib.bvecs_read.argtypes = [cp, i64, i64, i64, f32p]
    lib.ivecs_read.argtypes = [cp, i64, i64, i64, i32p]
    lib.idx_meta.argtypes = [cp, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.idx_read.argtypes = [cp, i64, i64, i64, ctypes.c_float, f32p]
    for fn in (lib.xvecs_meta, lib.fvecs_read, lib.bvecs_read,
               lib.ivecs_read, lib.idx_meta, lib.idx_read):
        fn.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native reader; None -> numpy fallback."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        _lib = _bind(build_library())
    except (OSError, RuntimeError, subprocess.SubprocessError):
        _lib = None
    return _lib


def native_available() -> bool:
    """True when the native reader is loaded (vs the numpy fallback)."""
    return _load() is not None


def _check(rc: int, path: str):
    if rc != 0:
        raise ValueError(f"ingest failed on {path!r} (error {rc}: "
                         f"{'open/format/bounds/io'.split('/')[-rc - 1]})")


# ---- metadata -------------------------------------------------------------

def _xvecs_meta(path: str, value_size: int) -> Tuple[int, int]:
    lib = _load()
    if lib is not None:
        rows, dim = ctypes.c_int64(), ctypes.c_int64()
        _check(lib.xvecs_meta(path.encode(), value_size,
                              ctypes.byref(rows), ctypes.byref(dim)), path)
        return rows.value, dim.value
    with open(path, "rb") as fh:
        d = int(np.fromfile(fh, np.int32, 1)[0])
    row_bytes = 4 + d * value_size
    size = os.path.getsize(path)
    if d <= 0 or size % row_bytes:
        raise ValueError(f"ingest failed on {path!r} (error -2: format)")
    return size // row_bytes, d


def fvecs_meta(path: str) -> Tuple[int, int]:
    """(rows, dim) of an .fvecs file."""
    return _xvecs_meta(path, 4)


def ivecs_meta(path: str) -> Tuple[int, int]:
    return _xvecs_meta(path, 4)


def bvecs_meta(path: str) -> Tuple[int, int]:
    return _xvecs_meta(path, 1)


def idx_meta(path: str) -> Tuple[int, int]:
    """(rows, flattened dim) of an MNIST idx file."""
    lib = _load()
    if lib is not None:
        rows, dim = ctypes.c_int64(), ctypes.c_int64()
        _check(lib.idx_meta(path.encode(), ctypes.byref(rows),
                            ctypes.byref(dim)), path)
        return rows.value, dim.value
    with open(path, "rb") as fh:
        hdr = fh.read(4)
        if len(hdr) != 4 or hdr[0] or hdr[1] or hdr[2] != 0x08:
            raise ValueError(f"ingest failed on {path!r} (error -2: format)")
        ndims = hdr[3]
        sizes = np.frombuffer(fh.read(4 * ndims), ">u4")
    return int(sizes[0]), int(np.prod(sizes[1:])) if ndims > 1 else 1


# ---- bulk / ranged reads --------------------------------------------------

def read_fvecs(path: str, start: int = 0, count: Optional[int] = None) -> np.ndarray:
    """``f32[count, dim]`` rows of an .fvecs file (SIFT/GIST base/query)."""
    rows, dim = fvecs_meta(path)
    count = rows - start if count is None else min(count, rows - start)
    lib = _load()
    out = np.empty((count, dim), np.float32)
    if lib is not None:
        _check(lib.fvecs_read(path.encode(), start, count, dim,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))),
               path)
        return out
    raw = np.fromfile(path, np.int32, offset=start * (4 + dim * 4),
                      count=count * (1 + dim)).reshape(count, 1 + dim)
    if not (raw[:, 0] == dim).all():
        raise ValueError(f"ingest failed on {path!r} (error -2: format)")
    return raw[:, 1:].view(np.float32).copy()


def read_ivecs(path: str, start: int = 0, count: Optional[int] = None) -> np.ndarray:
    """``i32[count, dim]`` rows (e.g. ground-truth neighbour id files)."""
    rows, dim = ivecs_meta(path)
    count = rows - start if count is None else min(count, rows - start)
    lib = _load()
    out = np.empty((count, dim), np.int32)
    if lib is not None:
        _check(lib.ivecs_read(path.encode(), start, count, dim,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))),
               path)
        return out
    raw = np.fromfile(path, np.int32, offset=start * (4 + dim * 4),
                      count=count * (1 + dim)).reshape(count, 1 + dim)
    if not (raw[:, 0] == dim).all():
        raise ValueError(f"ingest failed on {path!r} (error -2: format)")
    return raw[:, 1:].copy()


def read_bvecs(path: str, start: int = 0, count: Optional[int] = None) -> np.ndarray:
    """``f32[count, dim]`` rows of a .bvecs file (u8 widened to f32)."""
    rows, dim = bvecs_meta(path)
    count = rows - start if count is None else min(count, rows - start)
    lib = _load()
    out = np.empty((count, dim), np.float32)
    if lib is not None:
        _check(lib.bvecs_read(path.encode(), start, count, dim,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))),
               path)
        return out
    row_bytes = 4 + dim
    raw = np.fromfile(path, np.uint8, offset=start * row_bytes,
                      count=count * row_bytes).reshape(count, row_bytes)
    return raw[:, 4:].astype(np.float32)


def read_idx(path: str, start: int = 0, count: Optional[int] = None,
             scale: float = 1.0) -> np.ndarray:
    """``f32[count, dim]`` rows of an MNIST idx u8 file, scaled."""
    rows, dim = idx_meta(path)
    count = rows - start if count is None else min(count, rows - start)
    lib = _load()
    out = np.empty((count, dim), np.float32)
    if lib is not None:
        _check(lib.idx_read(path.encode(), start, count, dim, scale,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))),
               path)
        return out
    with open(path, "rb") as fh:
        ndims = fh.read(4)[3]
        header = 4 + 4 * ndims
    raw = np.fromfile(path, np.uint8, offset=header + start * dim,
                      count=count * dim).reshape(count, dim)
    return raw.astype(np.float32) * scale


# ---- writers (dataset export; the inverse of the readers above) -----------

def _host(a) -> np.ndarray:
    """A numpy view of ``a``; a tensor is copied to the host first (a
    floating one as f32, which holds bf16 and f16 values exactly)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        return (a.float() if a.dtype.is_floating_point else a).numpy()
    return np.asarray(a)


def write_fvecs(path: str, x) -> None:
    """Write ``f32[n, dim]`` rows as an .fvecs file (the SIFT/GIST layout:
    each row is an int32 dim header followed by ``dim`` f32 values)."""
    x = np.ascontiguousarray(_host(x).astype(np.float32, copy=False))
    n, dim = x.shape
    out = np.empty((n, 1 + dim), np.int32)
    out[:, 0] = dim
    out[:, 1:] = x.view(np.int32)
    out.tofile(path)


def write_ivecs(path: str, ids) -> None:
    """Write ``i32[n, k]`` rows as an .ivecs file (ground-truth layout)."""
    ids = np.ascontiguousarray(_host(ids).astype(np.int32, copy=False))
    n, k = ids.shape
    out = np.empty((n, 1 + k), np.int32)
    out[:, 0] = k
    out[:, 1:] = ids
    out.tofile(path)


# ---- chunked sources (streaming-builder feeds) ----------------------------

def _chunks(meta, read, path: str, chunk_size: int,
            limit: Optional[int]) -> Iterator[np.ndarray]:
    rows, _ = meta(path)
    n = rows if limit is None else min(limit, rows)
    for s in range(0, n, chunk_size):
        yield read(path, s, min(chunk_size, n - s))


def fvecs_source(path: str, chunk_size: int = 10_000,
                 limit: Optional[int] = None) -> Iterator[np.ndarray]:
    """Chunked .fvecs stream for ``rptree_tpu_torch.forest`` / ``tree``."""
    return _chunks(fvecs_meta, read_fvecs, path, chunk_size, limit)


def bvecs_source(path: str, chunk_size: int = 10_000,
                 limit: Optional[int] = None) -> Iterator[np.ndarray]:
    return _chunks(bvecs_meta, read_bvecs, path, chunk_size, limit)


def idx_source(path: str, chunk_size: int = 10_000,
               limit: Optional[int] = None,
               scale: float = 1.0) -> Iterator[np.ndarray]:
    """Chunked MNIST idx stream (the reference bench's data source,
    bench/time/Main.hs:113-121)."""
    rows, _ = idx_meta(path)
    n = rows if limit is None else min(limit, rows)
    for s in range(0, n, chunk_size):
        yield read_idx(path, s, min(chunk_size, n - s), scale=scale)
