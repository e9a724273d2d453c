"""Batched level-synchronous query traversal and probe selection
(``rptree_tpu/ops/traverse.py`` ``traverse_tree``; the probe selection of
``rptree_tpu/models/forest.py`` ``_select_probes``): kernels 7 and 8 of
the port, CUDA in ``csrc/traverse.cu``.

The whole query batch advances one level at a time over a frontier of at
most ``budget`` tree nodes per (tree, query).  A node whose margins say
the query lies close to its cut plane forks into both children (the
reference's decision table, ``src/Data/RPTree.hs:309-314``):

    proj < thr && dl > dr  -> BOTH
    proj < thr             -> LEFT
    proj > thr && dl < dr  -> BOTH
    otherwise              -> RIGHT

with ``dl = |margin_lo - proj|`` and ``dr = |margin_hi - proj|``.  When the
``2F`` children overflow the frontier, the entries with the largest
running margin priority are dropped: the frontier keeps the F lowest
``(priority, encoding)`` pairs in ascending order.  Priority ties are
common (forked siblings inherit one running minimum), and the encoding
breaks them.  Live entries are distinct nodes, so ``(priority, encoding)``
is a strict total order on them, and every empty slot is the same
``(+inf, INVALID_ENC)``: any exact compaction gives the same frontier.

The JAX package has three forms of this descent: the frontier form with
a bitonic network (any budget), and superlevel fast paths for budgets 1
and 2-8 (``_traverse_b1``, ``_traverse_fk``) that fetch a subtree's
table row once per ~6 levels, for the TPU's gather costs; they are
bit-equal to the frontier form.  Here all three are one kernel (kernel
7, :func:`traverse_kernel`) that keeps each (tree, query) frontier on
chip for the whole descent and reads one 32-byte node record per live
slot and level from the forest's node table (:func:`node_table`).  Its
plain twin, :func:`traverse_tree_reference`, is the frontier form with
the JAX package's bitonic network over the same table.

Probe selection (kernel 8, :func:`select_probes`) keeps each query's
``probes`` lowest-priority leaves over all trees: a stable sort by
priority over ``[B, T * F]`` in (tree, slot) order, then the reference
``knnH`` bucket stop.  Each tree's list is already in ascending
priority, so the kernel merges the T lists; its plain twin,
:func:`select_probes_reference`, sorts.

Encoding: an entry ``>= 0`` is a split-segment index at the current level,
``< 0`` (but not ``INVALID_ENC``) is the leaf ``-(enc + 1)``, and
``INVALID_ENC`` (int32 min) is an empty slot.

The wrappers take the plain version for tensors on the CPU and launch the
kernel for CUDA tensors, or raise there; ``traverse_kernel.launches`` and
``select_probes.launches`` count launches.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _cuda
from ..models.plan import TreePlan
from .build import project_rows

__all__ = ["traverse_tree", "traverse_tree_reference", "traverse_kernel",
           "traverse_route", "node_table", "NodeTable", "project_queries",
           "select_probes", "select_probes_reference",
           "bitonic_sort_kv", "INVALID_ENC", "VALID_PRIO_CAP"]

INVALID_ENC = -(2 ** 31)
# live priorities are capped at a large finite value so that empty
# (infinite-priority) slots always lose the compaction
VALID_PRIO_CAP = 3.0e38
# frontier in registers up to this budget: the JAX package's
# _FK_MAX_BUDGET, which covers budgets 1 and 2 of the served cells
_REG_MAX_BUDGET = 8
# the shared-memory route holds next_pow2(2F) entries of 8 bytes per
# (tree, query); past this many, the frontier lives in global scratch
SMEM_MAX_ENTRIES = 16384
# thread blocks of the global-scratch route (each with its own scratch)
_GLOBAL_BLOCKS = 264


def project_queries(q: torch.Tensor, r: torch.Tensor,
                    n_levels: int) -> torch.Tensor:
    """Query projections ``f32[T, L, B]`` (``R[T * L, D] @ q.T``, in IEEE
    fp32, by :func:`.build.project_rows`: kernel 11 on the card, the
    build's order of summation): laid out so that one level's values of
    neighbouring queries are neighbours in memory.  ``r`` is ``[T, depth,
    D]``."""
    t, _, d = r.shape
    rl = r[:, :n_levels].reshape(t * n_levels, d).contiguous()
    return project_rows(q, rl).reshape(t, n_levels, q.shape[0])


class NodeTable(NamedTuple):
    """A forest's split nodes as 32-byte records ``int32[T, N, 8]``:
    ``(thr, mgl, mgh)`` as f32 bits, then the left and right child
    encodings, then three words of padding; level ``l``'s segment ``s``
    is row ``offsets[l] + s``.  ``level_off`` is ``offsets`` on the
    table's device.  Built once per forest from its arrays; rebuild it
    whenever they change."""

    rec: torch.Tensor
    level_off: torch.Tensor
    offsets: Tuple[int, ...]


def node_table(plan: TreePlan, thr: torch.Tensor, mgl: torch.Tensor,
               mgh: torch.Tensor) -> NodeTable:
    """The node table of ``thr / mgl / mgh f32[T, L, S_max]`` (or ``[L,
    S_max]`` for one tree) with the plan's child encodings."""
    if thr.dim() == 2:
        thr, mgl, mgh = (a.unsqueeze(0) for a in (thr, mgl, mgh))
    dev = thr.device
    counts = [lp.n_segs for lp in plan.levels]
    offsets = (0, *(int(o) for o in np.cumsum(counts, dtype=np.int64)))
    n = offsets[-1]
    rec = torch.zeros((thr.shape[0], max(n, 1), 8), dtype=torch.int32,
                      device=dev)
    if n:
        lvl = torch.as_tensor(np.repeat(np.arange(len(counts)), counts),
                              device=dev)
        seg = torch.as_tensor(np.concatenate([np.arange(c) for c in counts]),
                              device=dev)
        vals = torch.stack([a[:, lvl, seg] for a in (thr, mgl, mgh)], dim=-1)
        rec[:, :n, :3] = vals.float().view(torch.int32)
        rec[:, :n, 3:5] = torch.as_tensor(
            np.concatenate([lp.child_enc for lp in plan.levels]), device=dev)
    return NodeTable(rec, torch.as_tensor(offsets, dtype=torch.int32,
                                          device=dev), offsets)


def _next_pow2(m: int) -> int:
    p = 1
    while p < m:
        p *= 2
    return p


def _bitonic_stages(m: int, device) -> List[Tuple[int, torch.Tensor]]:
    """The network's stages for length ``m``: ``(j, keep_min)`` with the
    partner distance ``j`` and which positions keep the pair's minimum."""
    idx = torch.arange(m, device=device)
    stages = []
    k = 2
    while k <= m:
        j = k // 2
        while j >= 1:
            stages.append((j, ((idx & k) == 0) == (idx < (idx ^ j))))
            j //= 2
        k *= 2
    return stages


def bitonic_sort_kv(pri: torch.Tensor, enc: torch.Tensor, stages=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort ``(pri, enc)`` ascending along the last axis, whose length M
    is a power of two: the JAX package's bitonic network, stage by stage,
    as elementwise compare and select over the whole batch.  ``stages`` is
    :func:`_bitonic_stages` output, for callers that sort many times.

    Entries compare lexicographically by ``(pri, enc)``: a plain ``<``
    would make both entries of a tied pair pick the same side, duplicating
    one and losing the other."""
    m = pri.shape[-1]
    if m & (m - 1):
        raise ValueError(f"M must be a power of two, got {m}")
    if stages is None:
        stages = _bitonic_stages(m, pri.device)
    lead = pri.shape[:-1]
    for j, keep_min in stages:
        # partner index is idx ^ j: swap j-sized blocks pairwise
        shape = lead + (m // (2 * j), 2, j)
        p_o = pri.reshape(shape).flip(-2).reshape(pri.shape)
        e_o = enc.reshape(shape).flip(-2).reshape(enc.shape)
        other_is_min = (p_o < pri) | ((p_o == pri) & (e_o < enc))
        take_other = other_is_min == keep_min
        pri = torch.where(take_other, p_o, pri)
        enc = torch.where(take_other, e_o, enc)
    return pri, enc


def _check_traverse_args(plan, table, projq, budget):
    if projq.dim() != 3 or projq.shape[1] != plan.n_levels:
        raise ValueError(f"projq must be [T, L={plan.n_levels}, B], got "
                         f"{tuple(projq.shape)}")
    if table.rec.dim() != 3 or table.rec.shape[0] != projq.shape[0] \
            or table.rec.shape[2] != 8:
        raise ValueError(f"node table {tuple(table.rec.shape)} does not "
                         f"match projq {tuple(projq.shape)}")
    if int(budget) < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")


@torch.no_grad()
def traverse_tree_reference(plan: TreePlan, table: NodeTable,
                            projq: torch.Tensor, budget: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`traverse_kernel`: the JAX package's
    frontier form, one gather of node records and one bitonic compaction
    per level over the whole ``[T, B, F]`` state."""
    _check_traverse_args(plan, table, projq, budget)
    t, _, b = projq.shape
    f = int(budget)
    dev = projq.device
    inf = float("inf")
    fenc = torch.full((t, b, f), INVALID_ENC, dtype=torch.int32, device=dev)
    fpri = torch.full((t, b, f), inf, dtype=torch.float32, device=dev)
    fenc[..., 0] = plan.root_enc
    # the reference's candidatesH starts the path priority at infinity
    # (RPTree.hs:322-324); capped finite so live entries beat empty slots
    fpri[..., 0] = VALID_PRIO_CAP
    m = _next_pow2(2 * f)
    pad_enc = torch.full((t, b, m - 2 * f), INVALID_ENC, dtype=torch.int32,
                         device=dev)
    pad_pri = torch.full((t, b, m - 2 * f), inf, device=dev)
    stages = _bitonic_stages(m, dev)

    for l, lp in enumerate(plan.levels):
        ns = lp.n_segs
        is_seg = fenc >= 0
        seg = fenc.clamp(0, ns - 1).long().reshape(t, b * f, 1)
        rows = table.rec[:, table.offsets[l]:table.offsets[l] + ns, :5]
        vals = rows.gather(1, seg.expand(t, b * f, 5)).reshape(t, b, f, 5)
        th, lo, hi = vals[..., :3].view(torch.float32).unbind(-1)
        lc, rc = vals[..., 3], vals[..., 4]
        proj = projq[:, l, :, None]  # [T, B, 1]
        dl = (lo - proj).abs()
        dr = (hi - proj).abs()
        lt = proj < th
        gt = proj > th
        go_both = (lt & (dl > dr)) | (gt & (dl < dr))
        go_left = lt | go_both
        go_right = ~lt | go_both
        pl = torch.minimum(fpri, dl)
        pr = torch.minimum(fpri, dr)
        # slot bank 1: descend-left entries, or pass-through (leaf / empty)
        enc_l = torch.where(is_seg, torch.where(go_left, lc, INVALID_ENC),
                            fenc)
        pri_l = torch.where(is_seg, torch.where(go_left, pl, inf), fpri)
        # slot bank 2: descend-right entries
        take_r = is_seg & go_right
        enc_r = torch.where(take_r, rc, INVALID_ENC)
        pri_r = torch.where(take_r, pr, inf)
        # [T, B, M]: both banks, padded with empty slots to a power of two
        enc2 = torch.cat([enc_l, enc_r, pad_enc], dim=-1)
        pri2 = torch.where(enc2 == INVALID_ENC, inf,
                           torch.cat([pri_l, pri_r, pad_pri], dim=-1))
        # compact 2F -> F keeping the lowest (priority, encoding) entries
        pri_s, enc_s = bitonic_sort_kv(pri2, enc2, stages)
        fenc = enc_s[..., :f].contiguous()
        fpri = pri_s[..., :f].contiguous()

    leaf_ids = torch.where(fenc == INVALID_ENC, -1, -(fenc + 1))
    return leaf_ids, fpri


def traverse_route(budget: int) -> Tuple[str, int]:
    """Kernel 7's route for frontier width ``budget`` and the entries it
    sorts per level: ``("registers", F)`` for ``F <= 8`` (one thread per
    (tree, query)); ``("shared", M)`` with ``M = next_pow2(2F)`` while
    ``M <= SMEM_MAX_ENTRIES`` (a warp or more per (tree, query), the
    frontier in shared memory); else ``("global", M)``, the frontier in
    global scratch."""
    f = int(budget)
    if f <= _REG_MAX_BUDGET:
        return "registers", f
    m = _next_pow2(2 * f)
    return ("shared" if m <= SMEM_MAX_ENTRIES else "global"), m


_ROUTES = {"registers": 0, "shared": 1, "global": 2}


def _check_cuda(name, device, **tensors):
    for key, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def traverse_kernel(plan: TreePlan, table: NodeTable, projq: torch.Tensor,
                    budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traverse T trees with a batch of B queries at frontier width F =
    ``budget`` (any ``F >= 1``; ``F >= plan.n_leaves`` is exact).

    Args:
      plan: static tree shape.
      table: the forest's :func:`node_table`.
      projq: ``f32[T, L, B]`` query projections (:func:`project_queries`).

    Returns ``(leaf_ids int32[T, B, F]`` with ``-1`` for empty slots,
    ``prio f32[T, B, F])``, each (tree, query) in ascending ``(priority,
    encoding)`` order: the reference's ``candidatesH`` margin priority.
    """
    if projq.device.type == "cpu":
        return traverse_tree_reference(plan, table, projq, budget)
    _check_traverse_args(plan, table, projq, budget)
    name = "traverse_kernel"
    _check_cuda(name, projq.device, projq=(projq, torch.float32),
                rec=(table.rec, torch.int32),
                level_off=(table.level_off, torch.int32))
    t, nl, b = projq.shape
    f = int(budget)
    leaf = torch.empty((t, b, f), dtype=torch.int32, device=projq.device)
    pri = torch.empty((t, b, f), dtype=torch.float32, device=projq.device)
    if t * b == 0:
        return leaf, pri
    route, m = traverse_route(f)
    grid = 0
    scratch = None
    if route == "global":
        grid = min(t * b, _GLOBAL_BLOCKS)
        scratch = torch.empty((grid, m, 2), dtype=torch.int32,
                              device=projq.device)
    lib = _cuda.lib()
    with torch.cuda.device(projq.device):
        code = lib.rpt_traverse(
            _cuda.ptr(projq), _cuda.ptr(table.rec), _cuda.ptr(table.level_off),
            _cuda.ptr(leaf), _cuda.ptr(pri),
            None if scratch is None else _cuda.ptr(scratch),
            plan.root_enc, t, b, nl, table.rec.shape[1], f, m, _ROUTES[route],
            grid, _cuda.stream_of(projq))
    _cuda.check(code, name)
    traverse_kernel.launches += 1
    return leaf, pri


traverse_kernel.launches = 0


def traverse_tree(plan: TreePlan, thr: torch.Tensor, mgl: torch.Tensor,
                  mgh: torch.Tensor, projq: torch.Tensor, budget: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traverse with the JAX package's arguments: ``thr / mgl / mgh f32[L,
    S_max]`` of one tree and ``projq f32[B, L]``, or ``[T, L, S_max]`` and
    ``[T, B, L]`` for several trees.  Builds the node table and runs
    :func:`traverse_kernel`; returns ``[B, F]`` (``[T, B, F]``) leaves and
    priorities.  Serving paths keep the table and call the kernel."""
    single = thr.dim() == 2
    if single:
        projq = projq.unsqueeze(0)
    table = node_table(plan, thr, mgl, mgh)
    leaf, pri = traverse_kernel(plan, table,
                                projq.transpose(1, 2).contiguous(), budget)
    return (leaf[0], pri[0]) if single else (leaf, pri)


def _check_probe_args(leaf_ids, prio, n_leaves, lens, k, bucket_stop):
    if leaf_ids.dim() != 3 or tuple(prio.shape) != tuple(leaf_ids.shape):
        raise ValueError(f"leaf_ids and prio must be [T, B, F] alike, got "
                         f"{tuple(leaf_ids.shape)} and {tuple(prio.shape)}")
    if lens.dim() != 1 or lens.shape[0] != leaf_ids.shape[0] * n_leaves:
        raise ValueError(f"lens must be [T * n_leaves] = "
                         f"[{leaf_ids.shape[0] * n_leaves}], got "
                         f"{tuple(lens.shape)}")
    if bucket_stop and k is None:
        raise ValueError("bucket_stop needs k")


@torch.no_grad()
def select_probes_reference(leaf_ids, prio, n_leaves: int, probes: int,
                            lens, k: Optional[int] = None,
                            bucket_stop: bool = False):
    """Plain torch version of :func:`select_probes`: the JAX package's
    stable sort over ``[B, T * F]``."""
    _check_probe_args(leaf_ids, prio, n_leaves, lens, k, bucket_stop)
    t, b, f = leaf_ids.shape
    nl = int(n_leaves)
    dev = leaf_ids.device
    gid = leaf_ids + torch.arange(t, dtype=torch.int32,
                                  device=dev)[:, None, None] * nl
    gid_bt = gid.transpose(0, 1).reshape(b, t * f)
    prio_bt = prio.transpose(0, 1).reshape(b, t * f)
    live = (leaf_ids >= 0).transpose(0, 1).reshape(b, t * f)
    prio_bt = torch.where(live, prio_bt, float("inf"))
    probes = min(int(probes), t * f)
    prio_s, order = torch.sort(prio_bt, dim=1, stable=True)
    prio_s = prio_s[:, :probes]
    gid_s = gid_bt.gather(1, order[:, :probes])
    lsel = torch.where(torch.isinf(prio_s), -1,
                       gid_s % nl if t > 1 else gid_s)
    gsel = gid_s
    if bucket_stop:
        # knn_h semantics (RPTree.hs:208-217): consume buckets in
        # ascending priority while the cumulative size stays <= k, always
        # keeping the first
        sz = lens[gsel.clamp(0, lens.shape[0] - 1).long()]
        sizes = torch.where(lsel >= 0, sz.to(torch.int64), 0)
        csum = torch.cumsum(sizes, dim=-1)
        first = torch.arange(probes, device=dev)[None, :] == 0
        lsel = torch.where((csum <= k) | first, lsel, -1)
    gsel = torch.where(lsel >= 0, gsel, 0)
    return gsel.to(torch.int32), lsel.to(torch.int32)


def select_probes(leaf_ids, prio, n_leaves: int, probes: int, lens,
                  k: Optional[int] = None, bucket_stop: bool = False):
    """Each query's ``probes`` lowest-priority leaves over all trees.

    Args:
      leaf_ids / prio: ``[T, B, F]``, each (tree, query) in ascending
        priority, as :func:`traverse_kernel` returns them.
      n_leaves: leaves per tree.
      lens: ``int32[T * n_leaves]`` occupancy of each global block (the
        plan's leaf lengths tiled over trees, or the packed blocks').
      k / bucket_stop: with ``bucket_stop`` the reference ``knnH`` rule
        masks buckets past the first ``k`` collected points.

    Returns ``(gsel int32[B, P], lsel int32[B, P])``, ``P = min(probes, T
    * F)``: global block index (tree * n_leaves + leaf; masked entries
    point at block 0) and leaf id (-1 where masked)."""
    if leaf_ids.device.type == "cpu":
        return select_probes_reference(leaf_ids, prio, n_leaves, probes,
                                       lens, k, bucket_stop)
    _check_probe_args(leaf_ids, prio, n_leaves, lens, k, bucket_stop)
    name = "select_probes"
    _check_cuda(name, leaf_ids.device, leaf_ids=(leaf_ids, torch.int32),
                prio=(prio, torch.float32), lens=(lens, torch.int32))
    t, b, f = leaf_ids.shape
    p = min(int(probes), t * f)
    gsel = torch.empty((b, p), dtype=torch.int32, device=leaf_ids.device)
    lsel = torch.empty((b, p), dtype=torch.int32, device=leaf_ids.device)
    if b * p == 0:
        return gsel, lsel
    lib = _cuda.lib()
    with torch.cuda.device(leaf_ids.device):
        code = lib.rpt_select_probes(
            _cuda.ptr(leaf_ids), _cuda.ptr(prio), _cuda.ptr(lens),
            _cuda.ptr(gsel), _cuda.ptr(lsel), t, b, f, p, int(n_leaves),
            int(k) if bucket_stop else 0, int(bool(bucket_stop)),
            _cuda.stream_of(leaf_ids))
    _cuda.check(code, name)
    select_probes.launches += 1
    return gsel, lsel


select_probes.launches = 0
