"""Peaks of one NVIDIA H100 SXM and the least time of a layer's work.

The peaks and the bound are ``chip_smoke.py``'s (``HBM_BPS``,
``PEAK_OPS``, ``bound``): the least time is the larger of the bytes
over the memory bandwidth and the operations over the float32 peak.
The work is counted from the plain reference's (query, leaf) pairs, so
the count is the same whatever implements the layer: each distinct
probed leaf's filled rows and norms once a chunk (or, for shared rows,
each distinct row that a filled slot names plus the leaves' ids and
norms), each query row once, ``k`` results a query; ``2 * D``
operations for each (query, filled candidate row) pair.
"""

from __future__ import annotations

import subprocess

import torch

HBM_BPS = 3.35e12      # bytes/s, HBM3
PEAK_F32 = 67e12       # FLOP/s, float32 outside the tensor cores


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BPS, ops / PEAK_F32)


def chunk_work(tree: torch.Tensor, leaf: torch.Tensor, leaf_len: torch.Tensor,
               leaf_table: torch.Tensor, n_rows: int, dim: int, k: int,
               itemsize: int, shared: bool) -> tuple:
    """``(bytes, operations)`` one chunk needs: ``tree, leaf int64[B, P]``
    are its queries' probed leaves (leaf -1: masked), ``leaf_len`` each
    leaf's size and ``leaf_table int64[T, leaves, width]`` their point
    ids (-1 pad)."""
    b = tree.shape[0]
    live = leaf >= 0
    n_leaves = leaf_len.numel()
    lens = torch.where(live, leaf_len[leaf.clamp(min=0)], 0)
    ops = 2.0 * dim * float(lens.sum())
    blocks = torch.unique((tree * n_leaves + leaf)[live])
    filled = float(leaf_len[blocks % n_leaves].sum())
    if shared:
        ids = leaf_table[blocks // n_leaves, blocks % n_leaves].reshape(-1)
        seen = torch.zeros(n_rows, dtype=torch.bool, device=ids.device)
        seen[ids[ids >= 0]] = True
        data = float(seen.sum()) * dim * itemsize + filled * 8
    else:
        data = filled * (dim * itemsize + 4)
    return data + b * dim * 4.0 + b * k * 8.0, ops


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them (an
    empty dict where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    name, limit = (s.strip() for s in out.split(",")[:2])
    try:
        return {"smi_name": name, "power_limit_w": float(limit)}
    except ValueError:
        return {"smi_name": name}
