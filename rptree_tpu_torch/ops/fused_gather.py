"""Fused block gather and dot (``rptree_tpu/ops/fused_gather.py``): kernel
6, the block fetch of the per-pair rerank, CUDA in ``csrc/gather_score.cu``.

For every query ``b`` and probe ``p`` it returns the dots of the leaf block
``x_leaf[rows_sel[b, p]]`` with ``q[b]`` and the block's stored slot norms:
``(dots f32[B, P, lmax], sqx f32[B, P, lmax])``, the two intermediates the
JAX package's per-pair scorer builds (``models/forest.py``
``_score_blocks_body``).  Distances, the occupancy mask and the selection
stay in plain torch, as they stay in XLA there.

f32 blocks are multiplied in full fp32, never TF32; with bf16 blocks the
query is rounded to bf16 (nearest even) first, as the JAX package's
``q.astype(x_leaf.dtype)`` does, so each product of two bf16 values is
exact and the sums are fp32.

The wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a tensor on a CUDA device, or raises there: it never falls
back.  ``gather_score.launches`` counts f32 launches and
``gather_score.launches_bf16`` bf16 ones.
"""

from __future__ import annotations

import torch

from .. import _cuda

__all__ = ["gather_score", "gather_score_reference", "gather_score_ok"]

_FLOAT_BLOCKS = (torch.float32, torch.bfloat16)
# (query, probe) pairs per step of the plain version (bounds its gathered
# block buffer)
_REF_PAIRS = 1 << 14


def gather_score_ok(x_leaf, probes: int) -> bool:
    """Whether the kernel serves this packed layout: dense 3-D f32 or bf16
    blocks and at least one probe.  The Pallas kernel's TPU tiling rules
    (``lmax`` a multiple of 8 or 16, ``D`` of 128) do not apply here."""
    return (isinstance(x_leaf, torch.Tensor) and x_leaf.dim() == 3
            and x_leaf.dtype in _FLOAT_BLOCKS and int(probes) >= 1)


def _check_shapes(x_leaf, sq_leaf, q, rows_sel):
    if x_leaf.dtype not in _FLOAT_BLOCKS:
        raise TypeError(f"gather_score: x_leaf must be float32 or bfloat16, "
                        f"got {x_leaf.dtype}")
    if x_leaf.dim() != 3 or x_leaf.shape[0] < 1:
        raise ValueError(f"x_leaf must be [G >= 1, lmax, D], got "
                         f"{tuple(x_leaf.shape)}")
    g, lmax, d = x_leaf.shape
    if tuple(sq_leaf.shape) != (g, lmax):
        raise ValueError(f"sq_leaf {tuple(sq_leaf.shape)} != {(g, lmax)}")
    if q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"q must be [B, {d}], got {tuple(q.shape)}")
    if rows_sel.dim() != 2 or rows_sel.shape[0] != q.shape[0] or \
            rows_sel.shape[1] < 1:
        raise ValueError(f"rows_sel must be [{q.shape[0]}, P >= 1], got "
                         f"{tuple(rows_sel.shape)}")


@torch.no_grad()
def gather_score_reference(x_leaf, sq_leaf, q, rows_sel):
    """Plain torch version of :func:`gather_score`: the gathered blocks
    ``x_leaf[rows_sel]`` times the query rounded to the block type, as an
    fp32 product, and the gathered slot norms."""
    _check_shapes(x_leaf, sq_leaf, q, rows_sel)
    b, p = rows_sel.shape
    sel = rows_sel.long().clamp(0, x_leaf.shape[0] - 1)
    qr = q.to(x_leaf.dtype).float()
    dots = torch.empty((b, p, x_leaf.shape[1]), dtype=torch.float32,
                       device=x_leaf.device)
    step = max(1, _REF_PAIRS // p)
    for s in range(0, b, step):
        blk = x_leaf[sel[s:s + step]].float()              # [c, P, lmax, D]
        dots[s:s + step] = torch.einsum("bpld,bd->bpl", blk, qr[s:s + step])
    return dots, sq_leaf[sel]


def gather_score(x_leaf, sq_leaf, q, rows_sel):
    """``dots[b, p, :] = x_leaf[rows_sel[b, p]] @ q[b]`` and ``sqx[b, p, :]
    = sq_leaf[rows_sel[b, p]]``.

    ``x_leaf f32 or bf16 [G, lmax, D]`` packed blocks, ``sq_leaf f32[G,
    lmax]`` slot norms, ``q f32[B, D]``, ``rows_sel int32[B, P]`` block
    rows (clamped into ``[0, G)``).  Returns two ``f32[B, P, lmax]``."""
    if x_leaf.device.type == "cpu":
        return gather_score_reference(x_leaf, sq_leaf, q, rows_sel)
    name = "gather_score"
    _check_shapes(x_leaf, sq_leaf, q, rows_sel)
    for key, t, dtype in (("x_leaf", x_leaf, x_leaf.dtype),
                          ("sq_leaf", sq_leaf, torch.float32),
                          ("q", q, torch.float32),
                          ("rows_sel", rows_sel, torch.int32)):
        if t.device != x_leaf.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{x_leaf.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    g, lmax, d = x_leaf.shape
    b, p = rows_sel.shape
    dots = torch.empty((b, p, lmax), dtype=torch.float32, device=q.device)
    sqx = torch.empty((b, p, lmax), dtype=torch.float32, device=q.device)
    if b == 0:
        return dots, sqx
    bf16 = x_leaf.dtype == torch.bfloat16
    lib = _cuda.lib()
    fn = lib.rpt_gather_score_bf16 if bf16 else lib.rpt_gather_score_f32
    with torch.cuda.device(x_leaf.device):
        code = fn(_cuda.ptr(x_leaf), _cuda.ptr(sq_leaf), _cuda.ptr(q),
                  _cuda.ptr(rows_sel), _cuda.ptr(dots), _cuda.ptr(sqx), b, p,
                  g, lmax, d, _cuda.stream_of(x_leaf))
    _cuda.check(code, name)
    if bf16:
        gather_score.launches_bf16 += 1
    else:
        gather_score.launches += 1
    return dots, sqx


gather_score.launches = 0
gather_score.launches_bf16 = 0
