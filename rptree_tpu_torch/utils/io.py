"""Loading a forest built by the JAX package (``rptree_tpu/utils/io.py``,
``_unpack`` and ``load_forest``).

A JAX checkpoint is an npz archive of the forest's arrays (``r``, ``thr``,
``mgl``, ``mgh``, ``perm``, and the dataset: ``x``, or for a sparse one,
header ``"sparse"``, its ELL tables ``x_cols`` and ``x_vals``) plus a JSON
header with the plan parameters.  Both functions here rebuild the port's :class:`RPForest`
from those arrays on a chosen device, so a forest built once by the JAX
package serves through the port with no JAX at run time.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .._cuda import resolve_device
from ..config import ForestConfig
from ..models.forest import RPForest
from ..models.plan import make_plan
from ..ops.build import TreeArrays
from ..ops.sparse import EllMatrix, ell_sq_norms

__all__ = ["forest_from_numpy", "load_forest"]

_ARRAYS = ("r", "thr", "mgl", "mgh", "perm")


def forest_from_numpy(header: dict, arrays: dict, device=None,
                      payloads=None) -> RPForest:
    """Build an :class:`RPForest` on ``device`` (default: the card; the CPU
    only with ``device="cpu"``) from a JAX forest's header (as
    ``save_forest`` writes it) and its arrays ``r, thr, mgl, mgh, perm, x``
    as numpy arrays (a sparse forest, header ``"sparse"``: ``x_cols`` and
    ``x_vals`` for ``x``).  ``payloads``: the forest's per-point payloads,
    a list the caller holds (a checkpoint stores them pickled, which this
    module never reads).  The seed is the header's."""
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
                      np.asarray(arrays["x_vals"])).to(device)
        sq = ell_sq_norms(x)
    else:
        x = torch.as_tensor(np.asarray(arrays["x"]), dtype=torch.float32,
                            device=device).contiguous()
        sq = (x * x).sum(-1)
    cfg = ForestConfig(**header["config"])
    return RPForest(plan, tree, x, sq, cfg, payloads=payloads,
                    seed=header.get("seed"))


def load_forest(path: str, device=None, payloads=None) -> RPForest:
    """Restore a forest saved by the JAX package's ``save_forest`` onto
    ``device`` (default: the card, as :func:`forest_from_numpy`), with
    the seed its header names.  Reads no pickled payloads
    (``allow_pickle=False``): a caller that has them passes
    ``payloads``."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(z["header"].tobytes().decode())
        data = ("x_cols", "x_vals") if header.get("sparse") else ("x",)
        return forest_from_numpy(header, {k: z[k] for k in (*_ARRAYS, *data)},
                                 device=device, payloads=payloads)
