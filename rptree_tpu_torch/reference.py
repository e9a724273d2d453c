"""Numpy re-execution of the reference algorithm's semantics, a copy of
``rptree_tpu/reference.py`` (numpy only; importing it from ``rptree_tpu``
would import JAX).

A deliberately direct, pointer-tree implementation of ocramz/rp-tree's
build and query logic, used as (a) the parity oracle in tests and (b) the
CPU baseline the bench compares against (BASELINE.md: baselines must be
self-generated).  This is *not* the engine -- see
:mod:`rptree_tpu_torch.models.forest` for that -- and it is written from
the behavioural spec in SURVEY.md, not translated code.

Semantics reproduced (with reference locations):

* median split with ``nh = n // 2`` over stably-sorted projections, and the
  margin = projection values adjacent to the median, with the degenerate
  n==2 / n==1 cases (``Internal.hs:484-505``);
* batch build stop conditions ``level >= max_depth or size <= min_leaf``
  (``Internal.hs:287-297``);
* streaming insert: per-chunk re-partition at the *chunk's* median at
  existing branch nodes, running-average thresholds
  ``thr' = (thr0 + thr)/2`` and monoid-merged margins
  ``(max lo, min hi)`` (``Internal.hs:274-285``), tip concat-then-split
  (``Internal.hs:287-297``), including the max-depth chunk-drop quirk
  (``Internal.hs:275-276``);
* the query decision table with both-branch descent on narrow margins
  (``RPTree.hs:309-314``) and the margin-priority of ``candidatesH``
  (``RPTree.hs:317-346``);
* ``knn`` concatenating union + stable sort + take k (``RPTree.hs:159-176``)
  and ``knnH`` priority-bucket collection (``RPTree.hs:196-217``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np

__all__ = ["RefTree", "RefForest", "ref_build_batch", "ref_build_stream",
           "ref_forest_batch", "ref_forest_stream", "ref_candidates",
           "ref_candidates_h", "ref_knn", "ref_knn_h", "ref_recall_with"]


@dataclasses.dataclass
class Bin:
    thr: float
    mgl: float  # margin low (Max side)
    mgh: float  # margin high (Min side)
    left: "Node"
    right: "Node"


@dataclasses.dataclass
class Tip:
    ids: np.ndarray  # int64[...] point ids in this leaf


Node = Union[Bin, Tip]


@dataclasses.dataclass
class RefTree:
    r: np.ndarray  # [max_depth, D] projection vectors (dense)
    root: Node


RefForest = List[RefTree]


def _partition_at_median(proj: np.ndarray, ids: np.ndarray):
    """partitionAtMedian (Internal.hs:484-505): stable sort by projection,
    split at n//2; returns (thr, mgl, mgh, left_ids, right_ids) or None."""
    n = ids.size
    if n < 1:
        return None
    order = np.argsort(proj, kind="stable")
    inns = proj[order]
    ids_s = ids[order]
    nh = n // 2
    if n >= 3:
        mgl, mgh = inns[nh - 1], inns[nh + 1]
    elif n == 2:
        mgl, mgh = inns[0], inns[1]
    else:
        mgl = mgh = inns[0]
    return float(inns[nh]), float(mgl), float(mgh), ids_s[:nh], ids_s[nh:]


def ref_build_batch(x: np.ndarray, r: np.ndarray, max_depth: int,
                    min_leaf: int) -> RefTree:
    """Batch build (create/insert into empty tip, Internal.hs:216-225)."""
    x = np.asarray(x)

    def go(ids, level):
        if level >= max_depth or ids.size <= min_leaf:
            return Tip(ids)
        res = _partition_at_median(x[ids] @ r[level], ids)
        if res is None:
            return Tip(np.zeros(0, np.int64))
        thr, mgl, mgh, li, ri = res
        return Bin(thr, mgl, mgh, go(li, level + 1), go(ri, level + 1))

    return RefTree(r, go(np.arange(x.shape[0], dtype=np.int64), 0))


def _insert(x, r, max_depth, min_leaf, node: Node, ids: np.ndarray,
            level: int) -> Node:
    """Streaming insert of one chunk (Internal.hs:257-297), all quirks
    included: chunk dropped at a Bin when level >= max_depth
    (Internal.hs:275-276); empty-median maps to an *empty* tip
    (Internal.hs:279,293)."""
    if isinstance(node, Bin):
        if level >= max_depth:
            return node  # chunk dropped (reference quirk)
        res = _partition_at_median(x[ids] @ r[level], ids)
        if res is None:
            return Tip(np.zeros(0, np.int64))
        thr, mgl, mgh, li, ri = res
        return Bin(
            (node.thr + thr) / 2.0,        # running-average threshold
            max(node.mgl, mgl),            # Margin semigroup: Max lo
            min(node.mgh, mgh),            # Min hi
            _insert(x, r, max_depth, min_leaf, node.left, li, level + 1),
            _insert(x, r, max_depth, min_leaf, node.right, ri, level + 1),
        )
    # Tip: concat then split if oversized
    merged = np.concatenate([ids, node.ids])
    if level >= max_depth or merged.size <= min_leaf:
        return Tip(merged)
    res = _partition_at_median(x[merged] @ r[level], merged)
    if res is None:
        return Tip(np.zeros(0, np.int64))
    thr, mgl, mgh, li, ri = res
    empty = Tip(np.zeros(0, np.int64))
    return Bin(
        thr, mgl, mgh,
        _insert(x, r, max_depth, min_leaf, empty, li, level + 1),
        _insert(x, r, max_depth, min_leaf, empty, ri, level + 1),
    )


def ref_build_stream(x: np.ndarray, r: np.ndarray, max_depth: int,
                     min_leaf: int, chunk_size: int) -> RefTree:
    """Streaming build: left-fold insert over chunks (Conduit.hs:79-91,
    169-176)."""
    x = np.asarray(x)
    node: Node = Tip(np.zeros(0, np.int64))
    for s in range(0, x.shape[0], chunk_size):
        ids = np.arange(s, min(s + chunk_size, x.shape[0]), dtype=np.int64)
        node = _insert(x, r, max_depth, min_leaf, node, ids, 0)
    return RefTree(r, node)


def ref_forest_batch(x, rs: np.ndarray, max_depth, min_leaf) -> RefForest:
    """rs: [T, max_depth, D] -> list of trees (Batch.hs:48-63)."""
    return [ref_build_batch(x, rs[t], max_depth, min_leaf)
            for t in range(rs.shape[0])]


def ref_forest_stream(x, rs, max_depth, min_leaf, chunk_size) -> RefForest:
    return [ref_build_stream(x, rs[t], max_depth, min_leaf, chunk_size)
            for t in range(rs.shape[0])]


def ref_candidates(tree: RefTree, q: np.ndarray) -> np.ndarray:
    """Exact decision-table descent (RPTree.hs:289-314); returns candidate
    point ids in the reference's concatenation order."""
    out: List[np.ndarray] = []

    def go(node, level):
        if isinstance(node, Tip):
            out.append(node.ids)
            return
        proj = float(tree.r[level] @ q)
        dl = abs(node.mgl - proj)
        dr = abs(node.mgh - proj)
        if proj < node.thr and dl > dr:
            go(node.left, level + 1)
            go(node.right, level + 1)
        elif proj < node.thr:
            go(node.left, level + 1)
        elif proj > node.thr and dl < dr:
            go(node.left, level + 1)
            go(node.right, level + 1)
        else:
            go(node.right, level + 1)

    go(tree.root, 0)
    return (np.concatenate(out) if out else np.zeros(0, np.int64))


def ref_candidates_h(tree: RefTree, q: np.ndarray):
    """candidatesH (RPTree.hs:317-346): leaf buckets with margin priority
    (running min of margin distances along the path)."""
    out = []

    def go(node, level, p):
        if isinstance(node, Tip):
            out.append((p, node.ids))
            return
        proj = float(tree.r[level] @ q)
        dl = abs(node.mgl - proj)
        dr = abs(node.mgh - proj)
        pl = min(p, dl)
        pr = min(p, dr)
        if proj < node.thr and dl > dr:
            go(node.left, level + 1, pl)
            go(node.right, level + 1, pr)
        elif proj < node.thr:
            go(node.left, level + 1, pl)
        elif proj > node.thr and dl < dr:
            go(node.left, level + 1, pl)
            go(node.right, level + 1, pr)
        else:
            go(node.right, level + 1, pr)

    go(tree.root, 0, np.inf)
    return out


def _l2(a, b):
    d = a - b
    return np.sqrt(np.sum(d * d, axis=-1))


def ref_knn(forest: RefForest, x: np.ndarray, q: np.ndarray, k: int,
            dedup: bool = False):
    """knn (RPTree.hs:159-176): concatenating union over trees, exact
    distances, stable sort, take k.  ``dedup=True`` gives knnPQ semantics
    (RPTree.hs:178-194)."""
    cand = np.concatenate([ref_candidates(t, q) for t in forest])
    if dedup:
        cand = np.unique(cand)
    if cand.size == 0:
        return np.zeros(0), np.zeros(0, np.int64)
    d = _l2(x[cand], q)
    order = np.argsort(d, kind="stable")[:k]
    return d[order], cand[order]


def ref_knn_h(forest: RefForest, x: np.ndarray, q: np.ndarray, k: int):
    """knnH (RPTree.hs:196-217): pop buckets in ascending margin priority
    until > k points collected (always >= 1 bucket), then exact distances.
    The reference neither sorts nor truncates; here the collected points
    are distance-sorted for usability (superset contract preserved)."""
    entries = []
    for t in forest:
        entries.extend(ref_candidates_h(t, q))
    entries.sort(key=lambda e: e[0])
    acc = []
    n = 0
    for p, ids in entries:
        ntot = n + ids.size
        if ntot > k and acc:
            break
        acc.append(ids)
        n = ntot
    cand = np.concatenate(acc) if acc else np.zeros(0, np.int64)
    d = _l2(x[cand], q) if cand.size else np.zeros(0)
    order = np.argsort(d, kind="stable")
    return d[order], cand[order]


def ref_recall_with(forest: RefForest, x: np.ndarray, q: np.ndarray,
                    k: int) -> float:
    """recallWith (RPTree.hs:250-285): per tree |cands . exact-k| / k,
    averaged over trees."""
    d = _l2(x, q)
    exact = set(np.argsort(d, kind="stable")[:k].tolist())
    rs = []
    for t in forest:
        cset = set(ref_candidates(t, q).tolist())
        rs.append(len(cset & exact) / k)
    return float(np.mean(rs))


def tree_size(tree: RefTree) -> int:
    def go(node):
        if isinstance(node, Tip):
            return node.ids.size
        return go(node.left) + go(node.right)

    return go(tree.root)


def leaf_spans(tree: RefTree) -> list:
    """Leaf id-sets in left-to-right order."""
    out = []

    def go(node):
        if isinstance(node, Tip):
            out.append(node.ids)
        else:
            go(node.left)
            go(node.right)

    go(tree.root)
    return out
