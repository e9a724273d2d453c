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
``knnH`` bucket stop.  The kernel places each entry at its rank, the
count of entries before it in (key, tree, slot) order
(:func:`select_probes_by_rank` is that rule in plain torch); its plain
twin, :func:`select_probes_reference`, sorts.

Encoding: an entry ``>= 0`` is a split-segment index at the current level,
``< 0`` (but not ``INVALID_ENC``) is the leaf ``-(enc + 1)``, and
``INVALID_ENC`` (int32 min) is an empty slot.

The wrappers take the plain version for tensors on the CPU and launch the
kernel for CUDA tensors, or raise there; ``traverse_kernel.launches`` and
``select_probes.launches`` count launches.
"""

from __future__ import annotations

import functools
import struct
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _cuda
from .._cuda import check_operands as _check_cuda
from ..models.plan import TreePlan
from .build import project_rows

__all__ = ["traverse_tree", "traverse_tree_reference", "traverse_kernel",
           "traverse_route", "node_table", "NodeTable", "project_queries",
           "select_probes", "select_probes_reference", "select_probes_by_rank",
           "probe_route", "probe_keys",
           "bitonic_sort_kv", "INVALID_ENC", "VALID_PRIO_CAP"]

INVALID_ENC = -(2 ** 31)
# live priorities are capped at a large finite value so that empty
# (infinite-priority) slots always lose the compaction
VALID_PRIO_CAP = 3.0e38
# frontier in registers up to this budget: the JAX package's
# _FK_MAX_BUDGET, which covers budgets 1 and 2 of the served cells
_REG_MAX_BUDGET = 8
# the next_pow2(2F) entries of a (tree, query) in a warp's registers (two
# a lane) up to this many
WARP_MAX_ENTRIES = 64
# the shared-memory route holds next_pow2(2F) entries of 8 bytes per
# (tree, query); past this many, the frontier lives in global scratch
SMEM_MAX_ENTRIES = 16384
# thread blocks of the global-scratch route (each with its own scratch)
_GLOBAL_BLOCKS = 264
# kernel 8: a group of next_pow2(T * F) lanes a query up to this many
# entries, one warp (ceil(T * F / 32) entries a lane) up to PROBE_WARP_MAX
PROBE_LANES_MAX = 32
PROBE_WARP_MAX = 1024


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


@functools.lru_cache(maxsize=None)
def traverse_route(budget: int) -> Tuple[str, int]:
    """Kernel 7's route for frontier width ``budget`` and the entries it
    sorts per level: ``("registers", F)`` for ``F <= 8`` (one thread per
    (tree, query)); with ``M = next_pow2(2F)``, ``("warp", M)`` while ``M
    <= WARP_MAX_ENTRIES`` (one warp per (tree, query), a lane a frontier
    slot, the entries in registers, sorted by shuffles); ``("shared", M)``
    while ``M <= SMEM_MAX_ENTRIES`` (a group of M / 2 threads, the entries
    in shared memory); else ``("global", M)``, the entries in global
    scratch."""
    f = int(budget)
    if f <= _REG_MAX_BUDGET:
        return "registers", f
    m = _next_pow2(2 * f)
    if m <= WARP_MAX_ENTRIES:
        return "warp", m
    return ("shared" if m <= SMEM_MAX_ENTRIES else "global"), m


_ROUTES = {"registers": 0, "shared": 1, "global": 2, "warp": 3}


# The C entry points' arguments, an int64 each in their order
# (csrc/traverse.cu rpt_traverse, rpt_select_probes): one packed argument
# costs the host a fraction of what ctypes takes to convert fifteen.
# projq, rec, off, leaf, pri, scratch, root, t, b, l, n, f, m, route, grid,
# stream
_TRAVERSE_ARGS = struct.Struct("16q")
# leaf, pri, lens, gsel, lsel, t, b, f, p, nl, k, bucket_stop, route,
# width, stream
_PROBES_ARGS = struct.Struct("15q")


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
    dev = projq.device
    if dev.type == "cpu":
        return traverse_tree_reference(plan, table, projq, budget)
    _check_traverse_args(plan, table, projq, budget)
    rec, off = table.rec, table.level_off
    _check_cuda("traverse_kernel", dev, ("projq", projq, torch.float32),
                ("rec", rec, torch.int32), ("level_off", off, torch.int32))
    t, nl, b = projq.shape
    f = int(budget)
    leaf = projq.new_empty((t, b, f), dtype=torch.int32)
    pri = projq.new_empty((t, b, f))
    if t * b == 0:
        return leaf, pri
    route, m = traverse_route(f)
    grid, scratch = 0, None
    if route == "global":
        grid = min(t * b, _GLOBAL_BLOCKS)
        scratch = torch.empty((grid, m, 2), dtype=torch.int32, device=dev)
    with _cuda.on(dev):
        code = _cuda.lib().rpt_traverse(_TRAVERSE_ARGS.pack(
            projq.data_ptr(), rec.data_ptr(), off.data_ptr(), leaf.data_ptr(),
            pri.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            plan.root_enc, t, b, nl, rec.shape[1], f, m, _ROUTES[route], grid,
            _cuda.raw_stream(dev)))
    _cuda.check(code, "traverse_kernel")
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


def probe_keys(leaf_ids, prio) -> torch.Tensor:
    """Kernel 8's sort keys ``int64[B, T * F]`` in (tree, slot) order: the
    priority (+inf where a slot holds no leaf) as orderable bits, unsigned
    order being float order, -0 as +0 and every NaN last (after +inf, as
    ``torch.sort`` puts it)."""
    t, b, f = leaf_ids.shape
    p = torch.where(leaf_ids >= 0, prio, float("inf"))
    p = p.transpose(0, 1).reshape(b, t * f)
    bits = (p + 0.0).view(torch.int32).to(torch.int64)
    key = (bits & 0xFFFFFFFF) ^ torch.where(bits < 0, 0xFFFFFFFF, 0x80000000)
    return torch.where(torch.isnan(p), 0xFFFFFFFF, key)


@torch.no_grad()
def select_probes_by_rank(leaf_ids, prio, n_leaves: int, probes: int, lens,
                          k: Optional[int] = None, bucket_stop: bool = False):
    """Kernel 8's rule in plain torch, the same function as
    :func:`select_probes_reference`: each entry goes to its rank, the
    count of entries before it in (key, tree, slot) order (:func:`probe_keys`;
    the stable sort's place), if that is below ``P``; entries of infinite
    priority are masked; then the bucket stop's running 64-bit size over
    the ranks.  An ``[B, T * F, T * F]`` comparison: for tests."""
    _check_probe_args(leaf_ids, prio, n_leaves, lens, k, bucket_stop)
    t, b, f = leaf_ids.shape
    n, nl, dev = t * f, int(n_leaves), leaf_ids.device
    p = min(int(probes), n)
    key = probe_keys(leaf_ids, prio)
    idx = torch.arange(n, device=dev)
    before = (key[:, None, :] < key[:, :, None]) | (
        (key[:, None, :] == key[:, :, None]) & (idx[None, :] < idx[:, None]))
    rank = before.sum(-1)  # [B, n]: entry i's place
    lf = leaf_ids.transpose(0, 1).reshape(b, n).long()
    inf = torch.isinf(torch.where(leaf_ids >= 0, prio, float("inf"))
                      ).transpose(0, 1).reshape(b, n)
    lf = torch.where(inf, -1, lf)
    gid = torch.where(lf >= 0, (idx // f)[None, :] * nl + lf, 0)
    gsel = torch.zeros((b, n), dtype=torch.int64, device=dev)
    lsel = torch.zeros((b, n), dtype=torch.int64, device=dev)
    gsel.scatter_(1, rank, gid)
    lsel.scatter_(1, rank, lf)
    gsel, lsel = gsel[:, :p], lsel[:, :p]
    if bucket_stop:
        sizes = torch.where(lsel >= 0, lens.long()[gsel], 0)
        keep = (torch.cumsum(sizes, -1) <= k) | (
            torch.arange(p, device=dev) == 0)
        lsel = torch.where(keep, lsel, -1)
        gsel = torch.where(keep, gsel, 0)
    return gsel.to(torch.int32), lsel.to(torch.int32)


@functools.lru_cache(maxsize=None)
def probe_route(n_trees: int, budget: int) -> Tuple[str, int]:
    """Kernel 8's lanes for ``n = n_trees * budget`` entries a query:
    ``("lanes", G)``, a group of ``G = next_pow2(n)`` lanes a query (32 / G
    queries a warp), while ``n <= PROBE_LANES_MAX``; ``("warp", E)``, one
    warp a query with ``E = next_pow2(ceil(n / 32))`` entries a lane, while
    ``n <= PROBE_WARP_MAX``; else ``("merge", 0)``, a merge of the trees'
    ascending lists (a lane an entry, binary searches in global memory)."""
    n = int(n_trees) * int(budget)
    if n <= PROBE_LANES_MAX:
        return "lanes", _next_pow2(n)
    if n <= PROBE_WARP_MAX:
        return "warp", _next_pow2(-(-n // 32))
    return "merge", 0


_PROBE_ROUTES = {"lanes": 0, "warp": 1, "merge": 2}


def select_probes(leaf_ids, prio, n_leaves: int, probes: int, lens,
                  k: Optional[int] = None, bucket_stop: bool = False):
    """Each query's ``probes`` lowest-priority leaves over all trees.

    Args:
      leaf_ids / prio: ``[T, B, F]``, each (tree, query) in ascending
        priority, as :func:`traverse_kernel` returns them (the merge route,
        past ``PROBE_WARP_MAX`` entries a query, relies on it).
      n_leaves: leaves per tree.
      lens: ``int32[T * n_leaves]`` occupancy of each global block (the
        plan's leaf lengths tiled over trees, or the packed blocks').
      k / bucket_stop: with ``bucket_stop`` the reference ``knnH`` rule
        masks buckets past the first ``k`` collected points.

    Returns ``(gsel int32[B, P], lsel int32[B, P])``, ``P = min(probes, T
    * F)``: global block index (tree * n_leaves + leaf; masked entries
    point at block 0) and leaf id (-1 where masked)."""
    dev = leaf_ids.device
    if dev.type == "cpu":
        return select_probes_reference(leaf_ids, prio, n_leaves, probes,
                                       lens, k, bucket_stop)
    _check_probe_args(leaf_ids, prio, n_leaves, lens, k, bucket_stop)
    _check_cuda("select_probes", dev, ("leaf_ids", leaf_ids, torch.int32),
                ("prio", prio, torch.float32), ("lens", lens, torch.int32))
    t, b, f = leaf_ids.shape
    p = min(int(probes), t * f)
    gsel, lsel = leaf_ids.new_empty((b, p)), leaf_ids.new_empty((b, p))
    if b * p == 0:
        return gsel, lsel
    route, width = probe_route(t, f)
    with _cuda.on(dev):
        code = _cuda.lib().rpt_select_probes(_PROBES_ARGS.pack(
            leaf_ids.data_ptr(), prio.data_ptr(), lens.data_ptr(),
            gsel.data_ptr(), lsel.data_ptr(), t, b, f, p, int(n_leaves),
            int(k) if bucket_stop else 0, int(bool(bucket_stop)),
            _PROBE_ROUTES[route], width, _cuda.raw_stream(dev)))
    _cuda.check(code, "select_probes")
    select_probes.launches += 1
    return gsel, lsel


select_probes.launches = 0
