"""Sparse vectors (the reference's ``SVector``, ``Internal.hs:92-119``):
:class:`SVec` and :func:`to_dense`, copied from ``rptree_tpu/ops/vector.py``,
which is numpy only (importing it from ``rptree_tpu`` would import JAX).
The port's ELL tables are built from ``SVec`` rows and densify single sparse
queries through ``to_dense``; the rest of that module (``inner*``,
``metric_*_l2``, ``add``, ``sub``, ``scale``, ``norm2``, ``normalize``,
``from_list_*``) is copied when the facade exports it.

Representation:

* a dense vector is a 1-D ``numpy`` array (the reference's
  ``DVector``, ``Internal.hs:122-133``);
* a sparse vector is an :class:`SVec` -- dimension + sorted coordinate list.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SVec", "to_dense"]


@dataclasses.dataclass(frozen=True)
class SVec:
    """Sparse vector: dimension + (index, value) coordinate list sorted by
    index (same invariants as the reference ``SVector``,
    ``Internal.hs:101-105``; checked here at construction, unlike there)."""

    dim: int
    idx: np.ndarray  # int64[nnz], strictly increasing
    val: np.ndarray  # float[nnz]

    def __post_init__(self):
        idx = np.asarray(self.idx, dtype=np.int64)
        val = np.asarray(self.val)
        object.__setattr__(self, "idx", idx)
        object.__setattr__(self, "val", val)
        if idx.shape != val.shape or idx.ndim != 1:
            raise ValueError("SVec idx/val must be 1-D and equal length")
        if idx.size and (np.any(np.diff(idx) <= 0) or idx[0] < 0 or idx[-1] >= self.dim):
            raise ValueError("SVec indices must be strictly increasing in [0, dim)")

    @property
    def nnz(self) -> int:
        return int(self.idx.size)

    def __repr__(self):
        return f"SVec {self.dim} {list(zip(self.idx.tolist(), self.val.tolist()))}"


def to_dense(v) -> np.ndarray:
    """Densify a vector of either representation."""
    if isinstance(v, SVec):
        out = np.zeros(v.dim, dtype=np.float64)
        out[v.idx] = v.val
        return out
    return np.asarray(v)
