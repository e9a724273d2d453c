"""Rendering / export (``rptree_tpu/utils/draw.py``; the reference's
``Data.RPTree.Draw``, ``src/Data/RPTree/Draw.hs``): CSV scatter dumps for
plotting, GraphViz dot export of the tree structure, and an ASCII tree
rendering for debugging.

These walk the *logical* tree reconstructed host-side from the static plan
plus the built threshold arrays -- the array index has no pointers to walk.
Each call copies the tree's ``perm`` (and ``thr``) row to the host once;
points and labels may be numpy arrays or tensors on any device.  The text
is the JAX package's, byte for byte, on the same forest.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.forest import RPForest
from ..models.plan import TreePlan

__all__ = ["leaf_label_of_points", "write_csv", "knn_write_csv", "write_dot",
           "to_dot", "draw", "tree_to_string"]


def _host(a) -> np.ndarray:
    """``a`` as a numpy array; a tensor is copied to the host first (a
    bf16 or f16 one as f32)."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.is_floating_point() and a.dtype != torch.float64:
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def _tree_row(forest: RPForest, name: str, tree: int) -> np.ndarray:
    """One tree's row of ``forest.arrays.<name>`` on the host."""
    return getattr(forest.arrays, name)[tree].cpu().numpy()


def leaf_label_of_points(forest: RPForest, tree: int = 0) -> np.ndarray:
    """Leaf id per point (in dataset order) for one tree -- the leaf-coloring
    the reference demo paints its scatter plot with (app/Main.hs:79-99)."""
    plan = forest.plan
    perm = _tree_row(forest, "perm", tree)
    labels = np.empty(plan.n, dtype=np.int64)
    for lid, (s, m) in enumerate(zip(plan.leaf_start, plan.leaf_len)):
        labels[perm[s : s + m]] = lid
    return labels


def write_csv(path: str, points, labels) -> None:
    """Dump 2-D points + integer label as ``x,y,i`` rows (reference
    ``writeCsv``/``toCsvRow``, Draw.hs:55-77; consumed by r/scatter.r)."""
    points = _host(points)
    labels = _host(labels)
    with open(path, "w") as fh:
        for (row, lab) in zip(points, labels):
            fh.write(f"{row[0]},{row[1]},{lab}\n")


def knn_write_csv(path: str, points, labels, knn_points,
                  knn_label=-1) -> None:
    """Dataset rows followed by kNN-hit rows with a distinguishing label
    (reference ``knnWriteCsv``, Draw.hs:43-52)."""
    points = _host(points)
    labels = _host(labels)
    knn_points = _host(knn_points)
    with open(path, "w") as fh:
        for (row, lab) in zip(points, labels):
            fh.write(f"{row[0]},{row[1]},{lab}\n")
        for row in knn_points:
            fh.write(f"{row[0]},{row[1]},{knn_label}\n")


def _walk(plan: TreePlan, visit_bin: Callable, visit_leaf: Callable):
    """In-order walk of the static structure.  ``visit_bin(level, seg_idx,
    node_id, left_result, right_result)``; ``visit_leaf(leaf_id, node_id)``.
    Node ids number branches then leaves breadth-independently (stable)."""
    counter = [0]

    def node_id():
        counter[0] += 1
        return counter[0] - 1

    def go(enc: int, level: int):
        if enc < 0:
            return visit_leaf(-(enc + 1), node_id())
        nid = node_id()
        lp = plan.levels[level]
        left = go(int(lp.child_enc[enc, 0]), level + 1)
        right = go(int(lp.child_enc[enc, 1]), level + 1)
        return visit_bin(level, enc, nid, left, right)

    return go(plan.root_enc, 0)


def to_dot(forest: RPForest, name: str = "rptree", tree: int = 0,
           leaf_label: Optional[Callable[[int, np.ndarray], str]] = None) -> str:
    """GraphViz dot text of one tree (reference ``toDot``, Draw.hs:93-108):
    branch nodes are points, leaves are labelled by ``leaf_label(leaf_id,
    point_ids)`` (default: bucket size, as in app/Main.hs:74); ``point_ids``
    is a numpy array."""
    plan = forest.plan
    perm = _tree_row(forest, "perm", tree)
    if leaf_label is None:
        leaf_label = lambda lid, ids: str(len(ids))  # noqa: E731
    lines = [f"digraph {name} {{"]

    def visit_leaf(lid, nid):
        s, m = plan.leaf_start[lid], plan.leaf_len[lid]
        lab = leaf_label(lid, perm[s : s + m])
        lines.append(f'{nid} [ label=" {lab} " ]')
        return nid

    def visit_bin(level, seg, nid, left, right):
        lines.append(f"{nid} [ shape=point ]")
        lines.append(f"{nid} -> {left}")
        lines.append(f"{nid} -> {right}")
        return nid

    _walk(plan, visit_bin, visit_leaf)
    lines.append("}")
    return "\n".join(lines) + "\n"


def write_dot(path: str, forest: RPForest, name: str = "rptree",
              tree: int = 0, leaf_label=None) -> None:
    """Write GraphViz dot to a file (reference ``writeDot``, Draw.hs:85-91)."""
    with open(path, "w") as fh:
        fh.write(to_dot(forest, name=name, tree=tree, leaf_label=leaf_label))


def tree_to_string(forest: RPForest, tree: int = 0, max_leaf_items: int = 4) -> str:
    """ASCII rendering of one tree (reference ``draw``/``toBox``,
    Draw.hs:181-216; thresholds rounded to two decimals).  Indented
    left/right layout instead of side-by-side boxes."""
    plan = forest.plan
    perm = _tree_row(forest, "perm", tree)
    thr = _tree_row(forest, "thr", tree)  # [L, S_max]
    out: list = []

    def go(enc: int, level: int, prefix: str, tag: str):
        if enc < 0:
            lid = -(enc + 1)
            s, m = plan.leaf_start[lid], plan.leaf_len[lid]
            ids = perm[s : s + m].tolist()
            shown = ids[:max_leaf_items]
            suffix = ", ..." if m > max_leaf_items else ""
            out.append(f"{prefix}{tag}leaf#{lid} ({m}): {shown}{suffix}")
            return
        lp = plan.levels[level]
        out.append(f"{prefix}{tag}{thr[level][enc]:5.2f}")
        go(int(lp.child_enc[enc, 0]), level + 1, prefix + "  ", "L ")
        go(int(lp.child_enc[enc, 1]), level + 1, prefix + "  ", "R ")

    go(plan.root_enc, 0, "", "")
    return "\n".join(out)


def draw(forest: RPForest, tree: int = 0) -> None:
    """Print an ASCII tree to stdout (debugging; small trees only, as the
    reference warns, Draw.hs:174-179)."""
    print(tree_to_string(forest, tree))
