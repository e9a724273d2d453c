"""Per-row top-k with duplicate-id masking (``rptree_tpu/ops/topk_kernel.py``):
kernel 3 of the serving path, the selection tail, CUDA in
``csrc/topk_dedup.cu``.

Serving needs only the k smallest DISTINCT ids of each query's
``W = probes * lmax`` scored slots, and k is small (10).  The kernel
extracts them with k serial passes: the smallest distance still in play,
the lowest position holding it, and its id; with ``dedup`` every slot
carrying that id then leaves play, so a duplicated id keeps its
lowest-distance copy and no id is returned twice.  Rows with fewer than k
live (finite) candidates pad with ``(+inf, -1)``.  These semantics are
pinned by ``tests/test_topk_kernel.py`` for the JAX kernel and by
``tests/test_torch_topk_kernel.py`` for this port.

The wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a tensor on a CUDA device, or raises there.  On the card a
row of ``W <= 1024`` is read once into registers (:func:`topk_route`
gives the registers per lane); a wider row takes the wide-row kernel,
which sweeps it once per pass.  ``topk_dedup_kernel.launches`` counts
kernel launches of either route.
"""

from __future__ import annotations

import torch

from .. import _cuda

__all__ = ["topk_dedup_kernel", "topk_dedup_kernel_reference",
           "topk_kernel_ok", "topk_route"]

_MAX_K = 128
_MAX_REGS = 32      # the register route's distances per lane: W <= 32 * 32


def topk_route(w: int) -> int:
    """The kernel's route for rows of width ``w``: the distances each lane
    of a warp holds in registers (a multiple of 4, so that 16-byte loads
    fill them), or 0 for the wide-row route past ``32 * 32``."""
    regs = 4 * -(-w // 128)
    return regs if regs <= _MAX_REGS else 0


def topk_kernel_ok(w: int, k: int, min_votes: int = 1) -> bool:
    """Gate: k within the kernel's winner list, a non-empty candidate
    width, and no vote counting (which needs the full candidate lists)."""
    return min_votes == 1 and 1 <= k <= _MAX_K and w >= 1


def _check_args(d, ids, k):
    if d.dim() != 2 or tuple(ids.shape) != tuple(d.shape):
        raise ValueError(f"d and ids must be [B, W] alike, got "
                         f"{tuple(d.shape)} and {tuple(ids.shape)}")
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k must be in [1, {_MAX_K}], got {k}")
    if d.shape[1] < 1:
        raise ValueError("topk over an empty candidate width")


@torch.no_grad()
def topk_dedup_kernel_reference(d, ids, k: int, dedup: bool = True):
    """Plain torch version of :func:`topk_dedup_kernel`: the same k
    passes over the whole ``[B, W]`` state."""
    _check_args(d, ids, k)
    b, w = d.shape
    dv = d.clone()
    ids = ids.to(torch.int32)
    pos = torch.arange(w, device=d.device)
    od = torch.empty((b, k), dtype=torch.float32, device=d.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=d.device)
    for j in range(k):
        m = dv.amin(dim=1, keepdim=True)
        # first slot at the minimum (ties -> lowest position)
        p = torch.where(dv == m, pos, w).amin(dim=1, keepdim=True)
        live = ~torch.isinf(m)
        wid = torch.where(live, ids.gather(1, p.clamp(max=w - 1)), -1)
        od[:, j] = m[:, 0]
        oi[:, j] = wid[:, 0]
        kill = (ids == wid) if dedup else (pos == p)
        dv = torch.where(kill & live, float("inf"), dv)
    return od, oi


def topk_dedup_kernel(d, ids, k: int, dedup: bool = True):
    """Per-row k smallest ``(distance, id)`` of ``d f32[B, W]`` /
    ``ids int32[B, W]``; with ``dedup`` the k winners have distinct ids.
    Returns ``(dk f32[B, k], ik int32[B, k])``.  Any ``B`` and ``W``."""
    if d.device.type == "cpu":
        return topk_dedup_kernel_reference(d, ids, k, dedup=dedup)
    _check_args(d, ids, k)
    name = "topk_dedup_kernel"
    for key, t, dtype in (("d", d, torch.float32), ("ids", ids, torch.int32)):
        if t.device.type != "cuda" or t.device != d.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {d.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    b, w = d.shape
    od = torch.empty((b, k), dtype=torch.float32, device=d.device)
    oi = torch.empty((b, k), dtype=torch.int32, device=d.device)
    if b == 0:
        return od, oi
    lib = _cuda.lib()
    with _cuda.on(d.device):
        code = lib.rpt_topk_dedup(_cuda.ptr(d), _cuda.ptr(ids), _cuda.ptr(od),
                                  _cuda.ptr(oi), b, w, k, int(bool(dedup)),
                                  topk_route(w), _cuda.stream_of(d))
    _cuda.check(code, name)
    topk_dedup_kernel.launches += 1
    return od, oi


topk_dedup_kernel.launches = 0
