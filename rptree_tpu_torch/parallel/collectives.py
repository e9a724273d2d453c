"""The mesh's collectives as plain functions over per-shard tensors.

The JAX package runs each sharded pipeline as one ``jax.shard_map`` body
with ``lax`` collectives inside it.  Here that body is a Python loop over
the mesh's shards, each shard's work a call on its own device, and a
collective is a function of the list of the shards' tensors:
``lax.all_gather`` is a stack on the receiving device, ``lax.psum`` and
``lax.pmax`` are reductions there, and ``lax.axis_index`` is the loop's
index.  A body that calls a collective in its middle becomes two passes
over the shards, one on each side of it.  Nothing here reads a value back
to the host, so the shards' launches on separate cards overlap.

Where a mesh spans the processes of a ``torch.distributed`` group
(``span``, a :class:`.mesh.ProcessSpan`), ``parts`` are this process's
shards' and a collective takes two steps: the reduction over them, then
one call over the group (``all_reduce`` for :func:`psum` and
:func:`pmax`, ``all_gather`` for :func:`all_gather`), every process
receiving the result.  The gloo backend takes host tensors, so a card's
payload is staged through the host there; NCCL takes them on the card.

:class:`Sharded` is a global tensor as the shards hold it: contiguous
parts along its first axis, each on its own shard's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

__all__ = ["all_gather", "psum", "pmax", "Sharded"]


def _over_group(t: torch.Tensor, span, op) -> torch.Tensor:
    """``op(tensor)`` of ``torch.distributed`` over ``span``'s group on a
    copy of ``t`` (on the host for gloo), returned on ``t``'s device."""
    staged = t.cpu() if span.backend == "gloo" else t.contiguous().clone()
    return op(staged).to(t.device)


def all_gather(parts: Sequence[torch.Tensor], device, span=None
               ) -> torch.Tensor:
    """``lax.all_gather``: the shards' tensors stacked ``[S, ...]`` on
    ``device`` (the receiving shard's; a shard already there is not
    copied), across ``span``'s processes in rank order where given (every
    process's parts of one shape)."""
    local = torch.stack([p.to(device, non_blocking=True) for p in parts])
    if span is None:
        return local
    import torch.distributed as dist

    def gather(t):
        out = [torch.empty_like(t) for _ in range(span.world)]
        dist.all_gather(out, t)
        return torch.cat(out)

    return _over_group(local, span, gather)


def _reduce(local: torch.Tensor, span, op: str) -> torch.Tensor:
    """``local`` reduced by ``op`` ("SUM" or "MAX") over ``span``'s
    processes (itself without a span)."""
    if span is None:
        return local
    import torch.distributed as dist

    def reduce(t):
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        return t

    return _over_group(local, span, reduce)


def psum(parts: Sequence[torch.Tensor], device, span=None) -> torch.Tensor:
    """``lax.psum``: the shards' tensors summed, in shard order, on
    ``device`` (then over ``span``'s processes)."""
    return _reduce(all_gather(parts, device).sum(0), span, "SUM")


def pmax(parts: Sequence[torch.Tensor], device, span=None) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over the shards, on
    ``device`` (then over ``span``'s processes)."""
    return _reduce(all_gather(parts, device).amax(0), span, "MAX")


class Sharded:
    """A global ``[S * R, ...]`` tensor held as ``S`` parts of ``R`` rows,
    part ``s`` (rows ``s * R`` to ``(s + 1) * R``) on shard ``s``'s device:
    the leaf blocks and their tables of a sharded forest.  It has the
    global tensor's ``shape``, ``dtype`` and ``device`` (the first part's)
    and the two operations that the single-device code applies to a
    whole table (:meth:`__getitem__` by a tensor of global rows and
    :meth:`index_put_`), so that an update written for one device writes
    through to the shards; the serving paths read the parts directly.

    On a mesh that spans processes a process holds its own shards' parts
    only: ``first`` is the global index of its first, ``n_parts`` the
    global count; the whole-table operations then raise."""

    def __init__(self, parts: Sequence[torch.Tensor], first: int = 0,
                 n_parts: Optional[int] = None):
        self.parts: List[torch.Tensor] = list(parts)
        self.first = int(first)
        self.n_parts = len(self.parts) if n_parts is None else int(n_parts)

    def part(self, i: int) -> torch.Tensor:
        """The part of global shard ``i`` (one this process holds)."""
        return self.parts[i - self.first]

    def _whole_table(self, what: str) -> None:
        if len(self.parts) != self.n_parts:
            raise ValueError(f"{what} needs every shard's part in this "
                             "process; the mesh spans processes")

    @property
    def part_rows(self) -> int:
        """Rows a part."""
        return int(self.parts[0].shape[0])

    @property
    def shape(self) -> torch.Size:
        p = self.parts[0]
        return torch.Size((self.n_parts * self.part_rows, *p.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def whole(self) -> torch.Tensor:
        """The global tensor gathered on the first part's device."""
        self._whole_table("whole()")
        return torch.cat([p.to(self.device) for p in self.parts])

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (an integer tensor of global rows, any shape) on
        ``idx``'s device: each part gathers the rows it holds."""
        self._whole_table("a row gather")
        idx = idx.long()
        r = self.part_rows
        out = None
        for s, p in enumerate(self.parts):
            local = idx - s * r
            mine = (local >= 0) & (local < r)
            got = p[local.clamp(0, r - 1).to(p.device)].to(idx.device)
            mine = mine.reshape(mine.shape + (1,) * (got.dim() - mine.dim()))
            out = got if out is None else torch.where(mine, got, out)
        return out

    def index_put_(self, indices, values) -> "Sharded":
        """``tensor.index_put_`` with ``indices[0]`` global rows: each
        part takes the writes to its rows."""
        self._whole_table("a row write")
        rows = indices[0].long()
        r = self.part_rows
        for s, p in enumerate(self.parts):
            mine = (rows >= s * r) & (rows < (s + 1) * r)
            if bool(mine.any()):
                at = tuple(i[mine].to(p.device) for i in indices[1:])
                p.index_put_(((rows[mine] - s * r).to(p.device), *at),
                             values[mine].to(p.device))
        return self
