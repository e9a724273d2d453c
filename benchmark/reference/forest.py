"""The plain reference of an RP forest's served answers, in plain PyTorch.

It works the served answers out again from the benchmark's own inputs
(the rows ``x``, the projections ``r`` and the queries) and imports
nothing of the program under test.  The semantics are those of the
reference library the program ports (ocramz/rp-tree): a median split of
each segment's stably sorted projections at ``m // 2``, the margins the
values beside the median, the stop rule ``level >= max_depth or size <=
min_leaf``; a query descends each tree keeping its ``budget`` nodes of
lowest running margin priority, forking where the margins say it lies
close to the cut (``RPTree.hs:309-314``), and keeps its ``probes``
lowest-priority leaves over all trees; the answer is the ``k`` nearest
distinct candidates by exact distance.

Arithmetic: projections are the exact (float64) dot products rounded
once to float32, where the program sums in float32 and rounds at every
step; decisions then compare float32 values as the program does.  Exact
distances are float64.  Matrix products run with TF32 off.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

INVALID = -(2 ** 31)      # an empty frontier slot
PRIO_CAP = 3.0e38         # a live entry's starting priority (finite)


def no_tf32() -> None:
    """Turn TF32 off for float32 matrix products (the reference's scan)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Plan:
    """A tree's shape, a function of ``(n, max_depth, min_leaf)`` alone.

    ``levels[l]`` holds the split segments of level ``l``: ``start``,
    ``size`` (int64[S]) and ``child`` (int64[S, 2]: a segment index of
    level ``l + 1``, or ``-(leaf + 1)``).  Leaves are numbered by start
    position: ``leaf_start``, ``leaf_len``."""

    levels: List[dict]
    leaf_start: torch.Tensor
    leaf_len: torch.Tensor

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_start.numel())

    @property
    def root(self) -> int:
        return 0 if self.levels else -1


def make_plan(n: int, max_depth: int, min_leaf: int) -> Plan:
    def splits(m, level):
        return level < max_depth and m > min_leaf

    raw, leaves = [], []
    cur = [(0, n)] if splits(n, 0) else []
    if not cur:
        leaves.append((0, n))
    level = 0
    while cur:
        nxt, child = [], []
        for s, m in cur:
            nh = m // 2
            pair = []
            for cs, cm in ((s, nh), (s + nh, m - nh)):
                if splits(cm, level + 1):
                    pair.append(len(nxt))
                    nxt.append((cs, cm))
                else:
                    pair.append(("leaf", cs))
                    leaves.append((cs, cm))
            child.append(pair)
        raw.append((cur, child))
        cur, level = nxt, level + 1
    leaves.sort()
    leaf_of = {s: i for i, (s, _) in enumerate(leaves)}
    levels = []
    for segs, child in raw:
        enc = [[-(leaf_of[c[1]] + 1) if isinstance(c, tuple) else c
                for c in pair] for pair in child]
        levels.append(dict(
            start=torch.tensor([s for s, _ in segs], dtype=torch.int64),
            size=torch.tensor([m for _, m in segs], dtype=torch.int64),
            child=torch.tensor(enc, dtype=torch.int64).reshape(-1, 2)))
    return Plan(levels,
                torch.tensor([s for s, _ in leaves], dtype=torch.int64),
                torch.tensor([m for _, m in leaves], dtype=torch.int64))


def project(x: torch.Tensor, r: torch.Tensor, rows: int = 1 << 20
            ) -> torch.Tensor:
    """``f32[n, L]``: each row of ``x f32[n, D]`` dotted with each row of
    ``r f32[L, D]`` in float64, rounded once to float32."""
    r64 = r.to(torch.float64)
    out = torch.empty((x.shape[0], r.shape[0]), dtype=torch.float32,
                      device=x.device)
    for s in range(0, x.shape[0], rows):
        out[s:s + rows] = (x[s:s + rows].to(torch.float64) @ r64.T).float()
    return out


@dataclasses.dataclass
class Tree:
    perm: torch.Tensor       # int64[n]: point ids in leaf order
    thr: List[torch.Tensor]  # per level, f32[S_l]
    mgl: List[torch.Tensor]
    mgh: List[torch.Tensor]


def _segment_positions(start, size):
    """Every position of the segments, in order, and its segment index."""
    seg = torch.repeat_interleave(torch.arange(start.numel(),
                                               device=start.device), size)
    first = torch.cumsum(size, 0) - size
    pos = start[seg] + torch.arange(seg.numel(), device=start.device) \
        - first[seg]
    return pos, seg


def build_tree(plan: Plan, proj: torch.Tensor) -> Tree:
    """One tree from its projections ``f32[n, L]`` (column ``l`` is level
    ``l``'s): each split segment's points stably sorted by projection,
    the first half going left."""
    n = proj.shape[0]
    dev = proj.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    thr, mgl, mgh = [], [], []
    for l, lv in enumerate(plan.levels):
        start, size = lv["start"].to(dev), lv["size"].to(dev)
        pos, seg = _segment_positions(start, size)
        sub = ids[pos]
        p = proj[sub, l]
        order = torch.sort(p, stable=True).indices
        order = order[torch.sort(seg[order], stable=True).indices]
        sub = sub[order]
        ids[pos] = sub
        p = p[order]
        # position of each segment's first point within ``pos``
        first = torch.cumsum(size, 0) - size
        nh = size // 2
        big = size >= 3
        at_thr = first + nh
        at_lo = torch.where(big, first + nh - 1, first)
        at_hi = torch.where(big, first + nh + 1, first + 1)
        thr.append(p[at_thr])
        mgl.append(p[at_lo])
        mgh.append(p[at_hi])
    return Tree(ids, thr, mgl, mgh)


@dataclasses.dataclass
class Forest:
    plan: Plan
    r: torch.Tensor          # f32[T, depth, D]
    trees: List[Tree]
    leaf_table: torch.Tensor  # int64[T, n_leaves, max_leaf]: ids, -1 pad


def build_forest(x: torch.Tensor, r: torch.Tensor, max_depth: int,
                 min_leaf: int) -> Forest:
    plan = make_plan(x.shape[0], max_depth, min_leaf)
    nl = len(plan.levels)
    dev = x.device
    t_count = r.shape[0]
    trees = []
    for t in range(t_count):
        trees.append(build_tree(plan, project(x, r[t, :nl])))
    width = int(plan.leaf_len.max())
    start, length = plan.leaf_start.to(dev), plan.leaf_len.to(dev)
    col = torch.arange(width, device=dev)
    idx = (start[:, None] + col).clamp(max=x.shape[0] - 1)
    inside = col < length[:, None]
    table = torch.stack([torch.where(inside, tr.perm[idx], -1)
                         for tr in trees])
    return Forest(plan, r, trees, table)


def descend(forest: Forest, q: torch.Tensor, budget: int) -> tuple:
    """Each (tree, query)'s ``budget`` lowest ``(priority, encoding)``
    frontier entries at the leaves: ``(leaf int64[T, B, F] (-1 where
    empty), priority f32[T, B, F])``."""
    plan = forest.plan
    t_count = forest.r.shape[0]
    b, f = q.shape[0], int(budget)
    dev = q.device
    inf = float("inf")
    nl = len(plan.levels)
    enc = torch.full((t_count, b, f), INVALID, dtype=torch.int64, device=dev)
    pri = torch.full((t_count, b, f), inf, dtype=torch.float32, device=dev)
    enc[..., 0] = plan.root
    pri[..., 0] = PRIO_CAP
    if nl:
        projq = torch.stack([project(q, forest.r[t, :nl])
                             for t in range(t_count)])  # [T, B, L]
    for l, lv in enumerate(plan.levels):
        tr = forest.trees
        th_l = torch.stack([t.thr[l] for t in tr])     # [T, S]
        lo_l = torch.stack([t.mgl[l] for t in tr])
        hi_l = torch.stack([t.mgh[l] for t in tr])
        child = lv["child"].to(dev)
        is_seg = enc >= 0
        seg = enc.clamp(0, th_l.shape[1] - 1).reshape(t_count, b * f)
        th, lo, hi = (a.gather(1, seg).reshape(t_count, b, f)
                      for a in (th_l, lo_l, hi_l))
        lc, rc = child[seg.reshape(-1), 0].reshape(enc.shape), \
            child[seg.reshape(-1), 1].reshape(enc.shape)
        p = projq[:, :, l, None]
        dl, dr = (lo - p).abs(), (hi - p).abs()
        lt, gt = p < th, p > th
        both = (lt & (dl > dr)) | (gt & (dl < dr))
        go_left, go_right = lt | both, ~lt | both
        pl, pr = torch.minimum(pri, dl), torch.minimum(pri, dr)
        enc1 = torch.where(is_seg, torch.where(go_left, lc, INVALID), enc)
        pri1 = torch.where(is_seg, torch.where(go_left, pl, inf), pri)
        take = is_seg & go_right
        enc2 = torch.where(take, rc, INVALID)
        pri2 = torch.where(take, pr, inf)
        e = torch.cat([enc1, enc2], -1)
        pr_all = torch.where(e == INVALID, inf, torch.cat([pri1, pri2], -1))
        order = torch.sort(e, dim=-1, stable=True).indices
        order = order.gather(-1, torch.sort(pr_all.gather(-1, order), dim=-1,
                                            stable=True).indices)
        enc = e.gather(-1, order)[..., :f]
        pri = pr_all.gather(-1, order)[..., :f]
    leaf = torch.where(enc == INVALID, -1, -(enc + 1))
    return leaf, pri


def probes(forest: Forest, q: torch.Tensor, budget: int, n_probes: int
           ) -> tuple:
    """The query's ``n_probes`` lowest-priority leaves over all trees, in
    (priority, tree, slot) order: ``(tree int64[B, P], leaf int64[B, P])``,
    leaf -1 where masked."""
    leaf, pri = descend(forest, q, budget)
    t_count, b, f = leaf.shape
    tree = torch.arange(t_count, device=q.device)[:, None, None].expand(
        t_count, b, f)
    leaf_bt = leaf.transpose(0, 1).reshape(b, t_count * f)
    tree_bt = tree.transpose(0, 1).reshape(b, t_count * f)
    pri_bt = torch.where(leaf_bt >= 0,
                         pri.transpose(0, 1).reshape(b, t_count * f),
                         float("inf"))
    p = min(int(n_probes), t_count * f)
    pri_s, order = torch.sort(pri_bt, dim=1, stable=True)
    order = order[:, :p]
    leaf_s = torch.where(torch.isinf(pri_s[:, :p]), -1,
                         leaf_bt.gather(1, order))
    return tree_bt.gather(1, order), leaf_s


def candidates(forest: Forest, tree: torch.Tensor, leaf: torch.Tensor
               ) -> torch.Tensor:
    """Point ids ``int64[B, P * max_leaf]`` of the probed leaves, -1 pad."""
    ids = forest.leaf_table[tree, leaf.clamp(min=0)]
    ids = torch.where((leaf >= 0)[..., None], ids, -1)
    return ids.reshape(leaf.shape[0], -1)


def exact_l2(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor
             ) -> torch.Tensor:
    """Exact l2 distances ``f64[B, C]`` of ``q f32[B, D]`` to the rows
    ``ids int64[B, C]`` of ``x`` (+inf where an id is -1)."""
    rows = x[ids.clamp(min=0)].to(torch.float64)
    d = (rows - q.to(torch.float64)[:, None, :]).square().sum(-1).sqrt()
    return torch.where(ids >= 0, d, float("inf"))


def distinct(ids: torch.Tensor) -> torch.Tensor:
    """``ids`` with every repeat of an id within its row set to -1."""
    s, order = torch.sort(ids, dim=1)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    out = torch.empty_like(ids)
    out.scatter_(1, order, torch.where(dup, -1, s))
    return out


def answers(forest: Forest, x: torch.Tensor, q: torch.Tensor, k: int,
            budget: int, n_probes: int, rows: int = 256) -> torch.Tensor:
    """The reference's answers: the exact distances ``f64[B, k]`` of each
    query's k nearest distinct candidates, ascending (+inf pad)."""
    out = []
    for s in range(0, q.shape[0], rows):
        qc = q[s:s + rows]
        tree, leaf = probes(forest, qc, budget, n_probes)
        ids = distinct(candidates(forest, tree, leaf))
        d = exact_l2(x, qc, ids)
        kk = min(k, d.shape[1])
        top = torch.topk(d, kk, dim=1, largest=False).values
        if kk < k:
            top = torch.cat([top, top.new_full((top.shape[0], k - kk),
                                               float("inf"))], 1)
        out.append(top)
    return torch.cat(out)


def scan_topk(x: torch.Tensor, q: torch.Tensor, k: int, q_rows: int = 1024,
              x_rows: int = 1 << 20) -> torch.Tensor:
    """Exact global nearest neighbours by a float32 scan with TF32 off:
    ids ``int64[B, k]`` (the ground truth of recall)."""
    no_tf32()
    sq = (x * x).sum(-1)
    out = []
    for s in range(0, q.shape[0], q_rows):
        qc = q[s:s + q_rows]
        best_d = best_i = None
        for r0 in range(0, x.shape[0], x_rows):
            xc = x[r0:r0 + x_rows]
            d = sq[r0:r0 + x_rows][None, :] - 2.0 * (qc @ xc.T)
            kk = min(k, d.shape[1])
            dv, di = torch.topk(d, kk, dim=1, largest=False)
            di = di + r0
            if best_d is None:
                best_d, best_i = dv, di
            else:
                cd = torch.cat([best_d, dv], 1)
                ci = torch.cat([best_i, di], 1)
                dv, pos = torch.topk(cd, min(k, cd.shape[1]), dim=1,
                                     largest=False)
                best_d, best_i = dv, ci.gather(1, pos)
        out.append(best_i)
    return torch.cat(out)
