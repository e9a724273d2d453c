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

:class:`Sharded` is a global tensor as the shards hold it: contiguous
parts along its first axis, each on its own shard's device.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["all_gather", "psum", "pmax", "Sharded"]


def all_gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """``lax.all_gather``: the shards' tensors stacked ``[S, ...]`` on
    ``device`` (the receiving shard's; a shard already there is not
    copied)."""
    return torch.stack([p.to(device, non_blocking=True) for p in parts])


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """``lax.psum``: the shards' tensors summed, in shard order, on
    ``device``."""
    return all_gather(parts, device).sum(0)


def pmax(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over the shards, on
    ``device``."""
    return all_gather(parts, device).amax(0)


class Sharded:
    """A global ``[S * R, ...]`` tensor held as ``S`` parts of ``R`` rows,
    part ``s`` (rows ``s * R`` to ``(s + 1) * R``) on shard ``s``'s device:
    the leaf blocks and their tables of a sharded forest.  It has the
    global tensor's ``shape``, ``dtype`` and ``device`` (the first part's)
    and the two operations that the single-device code applies to a
    whole table (:meth:`__getitem__` by a tensor of global rows and
    :meth:`index_put_`), so that an update written for one device writes
    through to the shards; the serving paths read the parts directly."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts: List[torch.Tensor] = list(parts)

    @property
    def part_rows(self) -> int:
        """Rows a part."""
        return int(self.parts[0].shape[0])

    @property
    def shape(self) -> torch.Size:
        p = self.parts[0]
        return torch.Size((len(self.parts) * self.part_rows, *p.shape[1:]))

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
        return torch.cat([p.to(self.device) for p in self.parts])

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (an integer tensor of global rows, any shape) on
        ``idx``'s device: each part gathers the rows it holds."""
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
        rows = indices[0].long()
        r = self.part_rows
        for s, p in enumerate(self.parts):
            mine = (rows >= s * r) & (rows < (s + 1) * r)
            if bool(mine.any()):
                at = tuple(i[mine].to(p.device) for i in indices[1:])
                p.index_put_(((rows[mine] - s * r).to(p.device), *at),
                             values[mine].to(p.device))
        return self
