"""Single-vector linear-algebra ops (the reference's ``Inner``/``Scale``
layer, ``src/Data/RPTree/Internal.hs:304-470``), a copy of
``rptree_tpu/ops/vector.py``, which is numpy only (importing it from
``rptree_tpu`` would import JAX): inner products and L2 distances over
every sparse/dense pairing, elementwise sum/difference, scaling and
normalization, the convenience ops the reference exposes so users can
interface their own vector types (``Internal.hs:315``).  The batched hot
paths are :mod:`.sparse` and :mod:`.rerank`; the port's ELL tables are
built from ``SVec`` rows and densify single sparse queries through
``to_dense``.

Representation:

* a dense vector is a 1-D ``numpy`` array (the reference's
  ``DVector``, ``Internal.hs:122-133``);
* a sparse vector is an :class:`SVec` -- dimension + sorted coordinate list
  (the reference's ``SVector``, ``Internal.hs:92-119``).

Semantic divergences from the reference, the JAX package's own (kept):

* ``binSDD``/``binSS`` in the reference stop at the shorter operand and
  silently truncate the tail (``Internal.hs:437-470``, FIXME at
  ``Internal.hs:553``).  Here sum/difference use exact elementwise
  semantics over the full dimension.
* the reference's ``normalize`` divides by ``metricL2 v v`` which is
  identically zero (``Internal.hs:346-347``, not exported from the facade);
  here :func:`normalize` divides by the L2 *norm*.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "SVec",
    "from_list_sv",
    "from_vector_sv",
    "from_list_dv",
    "to_dense",
    "inner_ss",
    "inner_sd",
    "inner_dd",
    "inner",
    "metric_ss_l2",
    "metric_sd_l2",
    "metric_dd_l2",
    "metric_l2",
    "add",
    "sub",
    "scale",
    "normalize",
    "norm2",
]


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


def from_list_sv(dim: int, pairs) -> SVec:
    """Pack an :class:`SVec` from (index, value) pairs
    (reference ``fromListSv``, ``Internal.hs:106-107``)."""
    if len(pairs) == 0:
        return SVec(dim, np.zeros(0, np.int64), np.zeros(0, np.float64))
    idx, val = zip(*pairs)
    return SVec(dim, np.asarray(idx, np.int64), np.asarray(val, np.float64))


def from_vector_sv(dim: int, idx, val) -> SVec:
    """Pack an :class:`SVec` from index/value arrays
    (reference ``fromVectorSv``, ``Internal.hs:116-119``)."""
    return SVec(dim, np.asarray(idx, np.int64), np.asarray(val))


def from_list_dv(xs) -> np.ndarray:
    """Dense vector from a list (reference ``fromListDv``, ``Internal.hs:128-129``)."""
    return np.asarray(xs, dtype=np.float64)


def to_dense(v) -> np.ndarray:
    """Densify a vector of either representation."""
    if isinstance(v, SVec):
        out = np.zeros(v.dim, dtype=np.float64)
        out[v.idx] = v.val
        return out
    return np.asarray(v)


def _is_sparse(v) -> bool:
    return isinstance(v, SVec)


# ---------------------------------------------------------------------------
# inner products  (reference innerSS/innerSD/innerDD, Internal.hs:351-385)
# ---------------------------------------------------------------------------

def inner_ss(u: SVec, v: SVec) -> float:
    """Sparse-sparse inner product (two-pointer merge in the reference,
    ``Internal.hs:351-366``; here an index intersection)."""
    _, iu, iv = np.intersect1d(u.idx, v.idx, assume_unique=True, return_indices=True)
    return float(np.dot(u.val[iu], v.val[iv]))


def inner_sd(u: SVec, v) -> float:
    """Sparse-dense inner product (gather-multiply-accumulate,
    reference ``Internal.hs:369-382``)."""
    v = np.asarray(v)
    return float(np.dot(u.val, v[u.idx]))


def inner_dd(u, v) -> float:
    """Dense-dense inner product (reference ``Internal.hs:384-385``)."""
    return float(np.dot(np.asarray(u), np.asarray(v)))


def inner(u, v) -> float:
    """Polymorphic inner product over all four sparse/dense pairings
    (the reference's ``Inner`` instances, ``Internal.hs:322-341``)."""
    if _is_sparse(u) and _is_sparse(v):
        return inner_ss(u, v)
    if _is_sparse(u):
        return inner_sd(u, v)
    if _is_sparse(v):
        return inner_sd(v, u)
    return inner_dd(u, v)


# ---------------------------------------------------------------------------
# L2 distances  (reference metric*L2, Internal.hs:389-406)
# ---------------------------------------------------------------------------

def metric_ss_l2(u: SVec, v: SVec) -> float:
    d = to_dense(u) - to_dense(v)
    return float(np.sqrt(np.dot(d, d)))


def metric_sd_l2(u: SVec, v) -> float:
    d = to_dense(u) - np.asarray(v)
    return float(np.sqrt(np.dot(d, d)))


def metric_dd_l2(u, v) -> float:
    d = np.asarray(u) - np.asarray(v)
    return float(np.sqrt(np.dot(d, d)))


def metric_l2(u, v) -> float:
    """Polymorphic L2 distance (the reference's ``metricL2`` method)."""
    d = to_dense(u) - to_dense(v)
    return float(np.sqrt(np.dot(d, d)))


# ---------------------------------------------------------------------------
# elementwise ops  (reference (^+^)/(^-^)/(.*), Internal.hs:304-341,415-470)
# ---------------------------------------------------------------------------

def _merge_sparse(op, u: SVec, v: SVec) -> SVec:
    """Union merge of two sparse coordinate lists (exact semantics; the
    reference's ``binSS`` truncates at the shorter operand instead)."""
    dim = max(u.dim, v.dim)
    idx = np.union1d(u.idx, v.idx)
    du = np.zeros(idx.size)
    dv = np.zeros(idx.size)
    du[np.searchsorted(idx, u.idx)] = u.val
    dv[np.searchsorted(idx, v.idx)] = v.val
    return SVec(dim, idx, op(du, dv))


def add(u, v):
    """Vector sum over any pairing.  sparse+sparse -> sparse,
    anything+dense -> dense (reference ``(^+^)``)."""
    if _is_sparse(u) and _is_sparse(v):
        return _merge_sparse(np.add, u, v)
    return to_dense(u) + to_dense(v)


def sub(u, v):
    """Vector difference over any pairing (reference ``(^-^)``)."""
    if _is_sparse(u) and _is_sparse(v):
        return _merge_sparse(np.subtract, u, v)
    return to_dense(u) - to_dense(v)


def scale(a: float, v):
    """Scalar * vector (reference ``Scale``/``(.*)``, ``Internal.hs:304-311``)."""
    if _is_sparse(v):
        return SVec(v.dim, v.idx, a * v.val)
    return a * np.asarray(v)


def norm2(v) -> float:
    """L2 norm."""
    dv = to_dense(v)
    return float(np.sqrt(np.dot(dv, dv)))


def normalize(v):
    """Unit-normalize.  (The reference's ``normalize`` divides by
    ``metricL2 v v`` = 0, ``Internal.hs:346-347``; fixed here.)"""
    n = norm2(v)
    if n == 0.0:
        return v
    return scale(1.0 / n, v)
