"""Index serialization / checkpointing (``rptree_tpu/utils/io.py``).

Checkpoints are the JAX package's: npz archives of the forest's arrays
(``r``, ``thr``, ``mgl``, ``mgh``, ``perm``, and the dataset: ``x``, or for
a sparse one, header ``"sparse"``, its ELL tables ``x_cols`` and
``x_vals``) plus a JSON header with the plan parameters
(``format_version`` 1).  A checkpoint either package writes, the other
reads.

Two surfaces, as in the JAX package:

* :func:`save_forest` / :func:`load_forest` -- one file for the whole
  forest (the dataset is stored once);
* :func:`serialise_rp_forest` / :func:`deserialise_rp_forest` -- the
  reference's per-tree blobs (``src/Data/RPTree/Internal.hs:185-196``),
  each embedding the dataset, restored in any order with trees re-keyed
  ``0..T-1``.

:func:`forest_from_numpy` builds the port's forest from a header and
arrays, so a forest built once by the JAX package serves through the port
with no JAX at run time.

Payloads are written as the JAX package writes them (``payloads``, a
pickled list), so that it reads them back; the port never unpickles
(``allow_pickle=False``): its readers take ``payloads=`` from the caller.
The learned grouped tile capacities (the JAX package's optional
``grouped_nt`` header) are neither written nor read: their key omits
``tile_chunk`` (ROADMAP.md queue 3).

A data-parallel forest (:class:`..parallel.DataParallelForest`) also
checkpoints a shard at a time (:func:`save_forest_sharded` /
:func:`load_forest_sharded`, the JAX package's layout: ``common.npz`` and
``shard_<i>.npz``), so that no host buffer ever holds its whole dataset;
a tree-sharded forest saves as one forest.
"""

from __future__ import annotations

import io
import json
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import os

import numpy as np
import torch

from .._cuda import resolve_device
from ..config import ForestConfig
from ..models.forest import RPForest, _sq_norms
from ..models.plan import make_plan
from ..ops.build import TreeArrays
from ..ops.sparse import EllMatrix, ell_sq_norms

__all__ = ["save_forest", "load_forest", "serialise_rp_forest",
           "deserialise_rp_forest", "save_forest_sharded",
           "load_forest_sharded", "forest_from_numpy"]

_FORMAT_VERSION = 1
_ARRAYS = ("r", "thr", "mgl", "mgh", "perm")


def _check_clean(forest: RPForest):
    if (getattr(forest, "_pending", None) or getattr(forest, "n_deleted", 0)
            or getattr(forest, "n_folded", 0)):
        raise ValueError(
            "forest has pending inserts or tombstoned deletions; call "
            "rebuild() before serialising so the checkpoint is complete"
        )
    forest._require_x("a checkpoint")


def _header(forest: RPForest) -> dict:
    """The JAX package's header, less its optional ``grouped_nt``."""
    return {
        "format_version": _FORMAT_VERSION,
        "n": forest.plan.n,
        "max_depth": forest.plan.max_depth,
        "min_leaf": forest.plan.min_leaf,
        "n_levels": forest.plan.n_levels,
        "n_trees": forest.n_trees,
        "dim": forest.dim,
        "sparse": isinstance(forest.x, EllMatrix),
        "config": {
            "n_trees": forest.config.n_trees,
            "max_depth": forest.config.max_depth,
            "min_leaf": forest.config.min_leaf,
            "proj_nz_density": forest.config.proj_nz_density,
            "dim": forest.config.dim,
            "chunk_size": forest.config.chunk_size,
            "dtype": forest.config.dtype,
        },
        "seed": forest.seed if isinstance(forest.seed, int) else None,
    }


def _host(t) -> np.ndarray:
    """``t`` on the host (a :class:`Sharded` table gathered there a part
    at a time); bf16 values as the JAX package's ``np.savez`` writes them:
    their 16-bit patterns in a ``|V2`` array (numpy has no bf16 type)."""
    if not torch.is_tensor(t):  # a parallel.collectives.Sharded table
        t._whole_table("a host copy")
        t = torch.cat([p.detach().cpu() for p in t.parts])
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _values(a, device) -> torch.Tensor:
    """A checkpoint's dataset values on ``device`` in their own type: a
    2-byte void array (``|V2``, as ``np.savez`` writes bf16) or an
    ``ml_dtypes`` bfloat16 array as bf16 bits, float16 as f16, anything
    else cast to f32."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                  or a.dtype.name == "bfloat16"):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    dt = torch.float16 if a.dtype == np.float16 else torch.float32
    return torch.as_tensor(a, dtype=dt, device=device)


def _arrays(forest: RPForest) -> dict:
    """The forest's arrays, ``[T, ...]`` each, on the host."""
    return {k: _host(getattr(forest.arrays, k)) for k in _ARRAYS}


def _payload_bytes(payloads) -> np.ndarray:
    """Payloads as the JAX package stores them: a pickled list, as bytes."""
    return np.frombuffer(pickle.dumps(list(payloads)), dtype=np.uint8)


def _dataset(forest: RPForest) -> dict:
    """The dataset's arrays and the pickled payloads, as npz entries."""
    if isinstance(forest.x, EllMatrix):
        arrs = {"x_cols": _host(forest.x.cols), "x_vals": _host(forest.x.vals)}
    else:
        arrs = {"x": _host(forest.x)}
    if forest.payloads is not None:
        arrs["payloads"] = _payload_bytes(forest.payloads)
    return arrs


def _with_header(arrs: dict, header: dict) -> dict:
    return {**arrs, "header": np.frombuffer(json.dumps(header).encode(),
                                            dtype=np.uint8)}


def forest_from_numpy(header: dict, arrays: dict, device=None,
                      payloads=None) -> RPForest:
    """Build an :class:`RPForest` on ``device`` (default: the card; the CPU
    only with ``device="cpu"``) from a forest's header (as
    :func:`save_forest` writes it) and its arrays ``r, thr, mgl, mgh,
    perm, x`` as numpy arrays (a sparse forest, header ``"sparse"``:
    ``x_cols`` and ``x_vals`` for ``x``).  ``payloads``: the forest's
    per-point payloads, a list the caller holds (a checkpoint stores them
    pickled, which this module never reads).  The seed is the header's.
    The dataset keeps its type: bf16 (a ``|V2`` array of bf16 bits, as the
    JAX package writes it, or an ``ml_dtypes`` bfloat16 array), f16 or
    f32 (any other type is cast to f32); its squared norms are summed in
    f32 and stored in that type, as :func:`..models.forest.forest_batch`
    stores them."""
    device = resolve_device(device)
    plan = make_plan(header["n"], header["max_depth"], header["min_leaf"])
    if plan.n_levels != header["n_levels"]:
        raise ValueError("checkpoint plan mismatch: "
                         f"{plan.n_levels} != {header['n_levels']}")
    if payloads is not None and len(payloads) != header["n"]:
        raise ValueError(f"{len(payloads)} payloads for {header['n']} points")
    dt = {"perm": torch.int32}
    tree = TreeArrays(**{
        k: torch.as_tensor(np.asarray(arrays[k]), dtype=dt.get(k, torch.float32),
                           device=device)
        for k in _ARRAYS})
    if header.get("sparse"):
        x = EllMatrix(header["dim"], np.asarray(arrays["x_cols"]),
                      _values(arrays["x_vals"], "cpu")).to(device)
        sq = ell_sq_norms(x).to(x.vals.dtype)
    else:
        x = _values(arrays["x"], device).contiguous()
        sq = _sq_norms(x)
    cfg = ForestConfig(**header["config"])
    return RPForest(plan, tree, x, sq, cfg, payloads=payloads,
                    seed=header.get("seed"))


def save_forest(path: str, forest: RPForest) -> None:
    """Save the whole forest index (arrays + dataset + payloads) to one
    npz file with a JSON header, in the JAX package's format.  Refuses a
    forest with pending, folded or removed points: ``rebuild()`` first."""
    _check_clean(forest)
    arrs = _with_header({**_arrays(forest), **_dataset(forest)},
                        _header(forest))
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrs)


def load_forest(path: str, device=None, payloads=None) -> RPForest:
    """Restore a forest saved by :func:`save_forest` (or by the JAX
    package's) onto ``device`` (default: the card, as
    :func:`forest_from_numpy`), with the seed its header names.  Reads no
    pickled payloads (``allow_pickle=False``): a caller that has them
    passes ``payloads``."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(z["header"].tobytes().decode())
        data = ("x_cols", "x_vals") if header.get("sparse") else ("x",)
        return forest_from_numpy(header, {k: z[k] for k in (*_ARRAYS, *data)},
                                 device=device, payloads=payloads)


def serialise_rp_forest(forest: RPForest) -> List[bytes]:
    """One standalone blob per tree (reference ``serialiseRPForest``,
    Internal.hs:185-188).  Each blob embeds the dataset, mirroring the
    reference where leaf data lives inside every serialized tree; prefer
    :func:`save_forest` to store the dataset once.  The blobs compress
    in parallel threads (zlib runs outside the interpreter lock)."""
    _check_clean(forest)
    header = {**_header(forest), "n_trees": 1}
    arrays, data = _arrays(forest), _dataset(forest)

    def blob(t: int) -> bytes:
        arrs = {k: v[t:t + 1] for k, v in arrays.items()}
        buf = io.BytesIO()
        np.savez_compressed(buf, **_with_header({**arrs, **data}, header))
        return buf.getvalue()

    with ThreadPoolExecutor() as ex:
        return list(ex.map(blob, range(forest.n_trees)))


def deserialise_rp_forest(blobs: Sequence[bytes], payloads=None, *,
                          device=None) -> RPForest:
    """Reassemble a forest from per-tree blobs in any order (reference
    ``deserialiseRPForest``, Internal.hs:191-196: trees are re-keyed
    ``[0..]``) onto ``device`` (default: the card).  Raises ``ValueError``
    on malformed or inconsistent blobs (the reference's ``Either String``
    surface).  Reads no pickled payloads: ``payloads`` comes from the
    caller, as in :func:`load_forest`."""
    if not blobs:
        raise ValueError("no blobs to deserialise")
    headers, parts = [], []
    for blob in blobs:
        try:
            with np.load(io.BytesIO(blob), allow_pickle=False) as z:
                header = json.loads(z["header"].tobytes().decode())
                data = ("x_cols", "x_vals") if header.get("sparse") else ("x",)
                parts.append({k: z[k] for k in (*_ARRAYS, *data)})
        except Exception as e:  # noqa: BLE001 - every read failure, as JAX's
            raise ValueError(f"deserialise failed: {e}") from e
        headers.append(header)
    h0 = headers[0]
    key = ("n", "max_depth", "min_leaf", "dim", "sparse")
    if any(tuple(h.get(k) for k in key) != tuple(h0.get(k) for k in key)
           for h in headers[1:]):
        raise ValueError("inconsistent tree blobs")
    merged = {k: np.concatenate([p[k] for p in parts]) for k in _ARRAYS}
    merged.update({k: v for k, v in parts[0].items() if k not in _ARRAYS})
    header = {**h0, "n_trees": len(parts),
              "config": {**h0["config"], "n_trees": len(parts)}}
    return forest_from_numpy(header, merged, device=device, payloads=payloads)


def save_forest_sharded(dirpath: str, forest) -> None:
    """Checkpoint a :class:`..parallel.DataParallelForest` (dense or ELL
    rows) as one npz a data shard plus a common file, the JAX package's
    layout: ``<dirpath>/common.npz`` (the header, ``kind
    "data_parallel"`` and ``n_shards``, the structure arrays and the
    pickled payloads) and ``<dirpath>/shard_<i>.npz`` (shard ``i``'s rows,
    ``x`` or ``x_cols`` / ``x_vals``, and their first row ``row_start``).
    The host buffers one shard's rows at a time.  Refuses other forests
    (a tree-sharded one saves with :func:`save_forest`), and pending,
    folded or removed points (``rebuild()`` first).  Restore with
    :func:`load_forest_sharded`."""
    from ..parallel.data_parallel import DataParallelForest
    from ..parallel.mesh import DATA_AXIS

    if not isinstance(forest, DataParallelForest):
        raise ValueError("save_forest_sharded checkpoints DataParallelForest; "
                         "use save_forest (+ distribute() on restore) for "
                         "other forests")
    _check_clean(forest)
    os.makedirs(dirpath, exist_ok=True)
    header = {**_header(forest), "kind": "data_parallel",
              "n_shards": int(forest.mesh.shape[DATA_AXIS])}
    sparse = isinstance(forest.x, EllMatrix)
    rows = forest.x.cols if sparse else forest.x
    if rows.first == 0:  # the process of shard 0 writes the common part
        common = _with_header(_arrays(forest), header)
        if forest.payloads is not None:
            common["payloads"] = _payload_bytes(forest.payloads)
        with open(os.path.join(dirpath, "common.npz"), "wb") as fh:
            np.savez_compressed(fh, **common)
    per = rows.part_rows
    for j, i in enumerate(range(rows.first, rows.first + len(rows.parts))):
        arrs = {"row_start": np.asarray([i * per], np.int64)}
        if sparse:
            arrs["x_cols"] = _host(forest.x.cols.parts[j])
            arrs["x_vals"] = _host(forest.x.vals.parts[j])
        else:
            arrs["x"] = _host(forest.x.parts[j])
        with open(os.path.join(dirpath, f"shard_{i}.npz"), "wb") as fh:
            np.savez_compressed(fh, **arrs)


def load_forest_sharded(dirpath: str, mesh=None, *, payloads=None):
    """Restore a :func:`save_forest_sharded` checkpoint (the port's or the
    JAX package's) into a :class:`..parallel.DataParallelForest` on
    ``mesh`` (default :func:`..parallel.data_mesh`), resharded to its
    shard count where that differs: the files are read one at a time and
    each shard's rows go straight to its device, so no host or device
    buffer holds the whole dataset.  Reads no pickled payloads
    (``allow_pickle=False``): a caller that has them passes ``payloads``
    (the port's own, keyword-only)."""
    from ..parallel.data_parallel import (DataParallelForest, _sharded_ell,
                                          _sq_norms_sharded, data_mesh)
    from ..parallel.mesh import DATA_AXIS

    with np.load(os.path.join(dirpath, "common.npz"),
                 allow_pickle=False) as z:
        header = json.loads(z["header"].tobytes().decode())
        common = {k: z[k] for k in _ARRAYS}
    if header.get("kind") != "data_parallel":
        raise ValueError("not a sharded checkpoint (kind != data_parallel)")
    if mesh is None:
        mesh = data_mesh()
    n, s_all = header["n"], mesh.shape[DATA_AXIS]
    if n % s_all:
        raise ValueError(f"checkpoint rows ({n}) do not divide the target "
                         f"mesh ({s_all} shards)")
    if payloads is not None and len(payloads) != n:
        raise ValueError(f"{len(payloads)} payloads for {n} points")
    per = n // s_all
    keys = ("x_cols", "x_vals") if header.get("sparse") else ("x",)
    blocks = {key: {i: [] for i in mesh.local} for key in keys}
    for f in range(header["n_shards"]):
        with np.load(os.path.join(dirpath, f"shard_{f}.npz"),
                     allow_pickle=False) as z:
            start = int(z["row_start"][0])
            for key in keys:
                rows = z[key]
                for i in mesh.local:
                    lo, hi = max(start, i * per), min(start + rows.shape[0],
                                                      (i + 1) * per)
                    if lo < hi:
                        blocks[key][i].append(_values(
                            rows[lo - start:hi - start], mesh.device(i))
                            if key != "x_cols" else torch.as_tensor(
                                rows[lo - start:hi - start],
                                device=mesh.device(i)))

    def sharded(key):
        from ..parallel.collectives import Sharded

        return Sharded([torch.cat(blocks[key][i]).contiguous()
                        for i in mesh.local], mesh.local.start, s_all)

    if header.get("sparse"):
        x = _sharded_ell(header["dim"], sharded("x_cols"), sharded("x_vals"))
    else:
        x = sharded("x")
    plan = make_plan(n, header["max_depth"], header["min_leaf"])
    if plan.n_levels != header["n_levels"]:
        raise ValueError("checkpoint plan mismatch: "
                         f"{plan.n_levels} != {header['n_levels']}")
    dt = {"perm": torch.int32}
    arrays = TreeArrays(**{
        k: torch.as_tensor(common[k], dtype=dt.get(k, torch.float32),
                           device=mesh.first) for k in _ARRAYS})
    return DataParallelForest(plan, arrays, x, _sq_norms_sharded(x),
                              ForestConfig(**header["config"]), mesh,
                              payloads=payloads, seed=header.get("seed"))
