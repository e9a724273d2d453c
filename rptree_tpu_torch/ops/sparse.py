"""Sparse datasets and query batches in padded ELL form
(``rptree_tpu/ops/sparse.py``, the reference's ``SVector`` datasets).

Every row holds exactly ``K`` (the most nonzeros of any row)
column / value slots; padding is ``col 0, val 0``, so it adds nothing to
an inner product, a projection or a squared norm.  Duplicate columns in a
row add, as a coordinate list does.

Every sum over a row's slots runs in slot order, one slot at a time
(:func:`_slot_sum`), and so gives the same bits on the CPU and on the
card: ``ell_to_dense`` adds one slot a pass, each pass touching one entry
per row, where an accumulating ``index_put_`` over all slots at once
promises no order on the card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .vector import SVec

__all__ = ["EllMatrix", "EllBlocks", "ell_from_svecs", "ell_from_scipy_like",
           "ell_project", "ell_sq_norms", "ell_to_dense", "ell_rows_to_svecs",
           "ell_take"]


def _cols(cols) -> torch.Tensor:
    cols = torch.as_tensor(cols)
    return cols if cols.dtype == torch.int32 else cols.to(torch.int32)


class EllMatrix:
    """Padded ELL sparse matrix: ``cols int32[N, K]``, ``vals [N, K]``
    (f32, or bf16 for packed values), torch tensors on one device.  ``dim``
    is the dense column count (the reference ``svDim``)."""

    def __init__(self, dim: int, cols, vals):
        self.dim = int(dim)
        self.cols = _cols(cols)
        self.vals = torch.as_tensor(vals, device=self.cols.device)

    @property
    def shape(self):
        return (self.cols.shape[0], self.dim)

    @property
    def n(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.cols.device

    def to(self, device, dtype=None) -> "EllMatrix":
        """This matrix on ``device``, its values cast to ``dtype`` where
        given."""
        return EllMatrix(self.dim, self.cols.to(device),
                         self.vals.to(device=device, dtype=dtype))

    def __repr__(self):
        return f"EllMatrix(n={self.n}, dim={self.dim}, k={self.k})"


class EllBlocks:
    """Leaf-blocked ELL rows of the packed serving path: ``cols int32[G,
    lmax, K]`` and ``vals f32 or bf16 [G, lmax, K]`` hold each leaf's
    sparse points contiguously (the counterpart of dense ``x_leaf``
    blocks); empty slots are all padding."""

    def __init__(self, dim: int, cols, vals):
        self.dim = int(dim)
        self.cols = cols
        self.vals = vals

    @property
    def shape(self):
        return tuple(self.cols.shape)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.cols.device

    def __repr__(self):
        g, lmax, k = self.shape
        return (f"EllBlocks(blocks={g}, lmax={lmax}, k={k}, dim={self.dim}, "
                f"{self.dtype})")


def ell_from_svecs(svs: Sequence[SVec], dtype=np.float32) -> EllMatrix:
    """Pack single sparse vectors into a padded ELL matrix (on the CPU)."""
    if len(svs) == 0:
        raise ValueError("empty sparse dataset")
    dim = svs[0].dim
    k = max(1, max(sv.nnz for sv in svs))
    n = len(svs)
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=dtype)
    for i, sv in enumerate(svs):
        if sv.dim != dim:
            raise ValueError("inconsistent sparse dimensions")
        cols[i, : sv.nnz] = sv.idx
        vals[i, : sv.nnz] = sv.val
    return EllMatrix(dim, cols, vals)


def ell_from_scipy_like(indptr, indices, data, dim: int,
                        dtype=np.float32) -> EllMatrix:
    """Pack CSR triplets (e.g. from scipy) into padded ELL (on the CPU)."""
    indptr = np.asarray(indptr)
    n = indptr.size - 1
    row_nnz = np.diff(indptr)
    k = max(1, int(row_nnz.max()))
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=dtype)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols[i, : e - s] = indices[s:e]
        vals[i, : e - s] = data[s:e]
    return EllMatrix(dim, cols, vals)


def _slot_sum(term, k: int) -> torch.Tensor:
    """``term(0) + term(1) + ... + term(k - 1)``, added in that order."""
    acc = term(0)
    for j in range(1, k):
        acc = acc + term(j)
    return acc


def ell_project(x: EllMatrix, r: torch.Tensor) -> torch.Tensor:
    """Project every sparse row onto dense vectors, ``X @ R.T``: ``r [D]``
    or ``[L, D]`` gives ``[N]`` or ``[N, L]``.  A gather of ``r`` at each
    slot's column times the slot's value, summed over the slots in
    order (the reference's ``innerSD`` walk, batched)."""
    cols, vals = x.cols.long(), x.vals.float()
    out = _slot_sum(lambda j: r[..., cols[:, j]] * vals[:, j], x.k)
    return out if r.dim() == 1 else out.T


def ell_sq_norms(x: EllMatrix) -> torch.Tensor:
    """Squared L2 norm ``f32[N]`` of every row, summed over the slots in
    order (padding slots are zero)."""
    vals = x.vals.float()
    return _slot_sum(lambda j: vals[:, j] * vals[:, j], x.k)


def ell_to_dense(x: EllMatrix, dtype=None) -> torch.Tensor:
    """Densify to ``[N, dim]`` in ``dtype`` (default: the values' type),
    on the rows' device.  Slots add in slot order, one slot a pass, so
    duplicate columns sum to the same bits on every device."""
    dtype = x.vals.dtype if dtype is None else dtype
    out = torch.zeros((x.n, x.dim), dtype=dtype, device=x.device)
    cols, vals = x.cols.long(), x.vals.to(dtype)
    for j in range(x.k):
        out.scatter_add_(1, cols[:, j:j + 1], vals[:, j:j + 1])
    return out


def ell_take(x: EllMatrix, rows) -> EllMatrix:
    """The rows ``rows`` (a slice or an index tensor) of ``x``."""
    return EllMatrix(x.dim, x.cols[rows], x.vals[rows])


def ell_rows_to_svecs(x: EllMatrix, rows: Sequence[int]) -> list:
    """Unpack selected rows back into :class:`SVec` values (host-side)."""
    cols = x.cols.cpu().numpy()
    vals = x.vals.float().cpu().numpy()
    out = []
    for i in rows:
        mask = ~((cols[i] == 0) & (vals[i] == 0.0))
        idx = cols[i][mask].astype(np.int64)
        order = np.argsort(idx, kind="stable")
        out.append(SVec(x.dim, idx[order],
                        vals[i][mask][order].astype(np.float64)))
    return out
