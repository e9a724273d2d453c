"""Streaming (chunked-ingest) forest construction
(``rptree_tpu/streaming.py``).

The reference builds incrementally from a conduit stream: chunks are folded
into the tree, re-partitioning each branch at the *chunk's* median and
refining thresholds by running average / margins by monoid merge
(``src/Data/RPTree/Conduit.hs:58-121``, ``Internal.hs:257-297``).  Its
documented contract (Conduit.hs:49-57): the source is non-empty,
*stationary*, and bounded -- the result is only produced at end-of-stream.

The JAX package's design, kept here: each chunk is put on the builder's
device as it arrives (a ``non_blocking`` copy), and the index is (re)built with the exact level-synchronous
builder (:func:`..models.forest.forest_batch`) at finalize time, so its
thresholds are the exact medians of all data seen and the end-of-stream
forest equals the batch build over the concatenated chunks.

``periodic_rebuild_every`` trades build cost for queryability of the
partial index mid-stream; ``anytime_slack > 0`` keeps a queryable partial
index that absorbs every chunk online (:meth:`RPForest.add` then
:meth:`RPForest.fold` into the leaves' slack slots).

In the data-parallel mode (``mesh=``, a :func:`..parallel.data_mesh`, or
``data_parallel=True``) the chunks go round-robin over the mesh's devices,
the finalize re-chunks them into the shards' contiguous ``N / S`` rows in
ingest order and runs :func:`..parallel.forest_batch_data_parallel`, and
the anytime index is a :class:`..parallel.DataParallelForest` with
leaf-sharded slack blocks: no device holds more than its share.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from ._cuda import resolve_device
from .config import ForestConfig
from .models.forest import RPForest, forest_batch

__all__ = ["ForestBuilder", "tree", "forest"]


class ForestBuilder:
    """Incremental forest construction (the reference's
    ``insert``/``insertMulti`` accumulation, ``Internal.hs:244-297``).

    Usage::

        b = ForestBuilder(seed, max_depth=10, min_leaf=20, n_trees=8,
                          pnz=0.5, dim=784)
        for chunk in source:       # chunk: [m, dim] numpy array or tensor
            b.insert_chunk(chunk)
        index = b.build()

    The parameters are the JAX package's, in its order.  ``device`` (the
    port's own, keyword-only) is where the chunks and the index live:
    the card unless the caller names the CPU; without a card and without
    ``device="cpu"`` it raises.  ``mesh`` (a data mesh) or
    ``data_parallel=True`` (default mesh :func:`..parallel.data_mesh`)
    builds a :class:`..parallel.DataParallelForest` instead, the chunks
    on the mesh's devices; the streamed rows must then be divisible by the
    shard count (and, with ``anytime_slack``, the first chunk's)."""

    def __init__(self, seed, max_depth: int, min_leaf: int, n_trees: int,
                 pnz: float, dim: int, chunk_size: int = 0,
                 periodic_rebuild_every: int = 0, mesh=None,
                 data_parallel: bool = False, anytime_slack: int = 0, *,
                 device=None):
        self.data_parallel = bool(data_parallel) or mesh is not None
        if self.data_parallel:
            from .parallel.data_parallel import data_mesh

            self.mesh = mesh if mesh is not None else data_mesh()
            if self.mesh.span is not None:
                raise ValueError("streaming onto a mesh of several processes "
                                 "is not supported: build each process's "
                                 "rows with parallel.data_parallel."
                                 "process_local_rows")
            self.device = self.mesh.first
        else:
            self.mesh = None
            self.device = resolve_device(device)
        # produce-anytime refinement: with anytime_slack > 0 a queryable
        # partial index absorbs every chunk online (fold into the leaves'
        # slack slots, no mid-stream rebuilds); build() is still the exact
        # batch build over everything seen
        self.anytime_slack = int(anytime_slack)
        self._anytime: Optional[RPForest] = None
        self.seed = seed
        self.max_depth = int(max_depth)
        self.min_leaf = int(min_leaf)
        self.n_trees = int(n_trees)
        self.pnz = float(pnz)
        self.dim = int(dim)
        self.chunk_size = int(chunk_size)
        self.periodic = int(periodic_rebuild_every)
        self._chunks: list = []
        self._payloads: list = []
        self._n = 0
        self._index: Optional[RPForest] = None
        self._chunks_since_rebuild = 0

    @property
    def n_points(self) -> int:
        return self._n

    @property
    def partial_index(self) -> Optional[RPForest]:
        """Anytime view of the stream (``anytime_slack > 0``): a
        queryable index reflecting every chunk inserted so far, updated
        online at O(chunk x depth) per chunk (folded into leaf slack
        slots; overflow stays in its exact pending merge).  The final
        :meth:`build` remains the exact batch build."""
        return self._anytime

    def _batch(self, x, payloads) -> RPForest:
        if self.data_parallel:
            from .parallel.data_parallel import forest_batch_data_parallel

            return forest_batch_data_parallel(
                self.seed, self.max_depth, self.min_leaf, self.n_trees,
                self.pnz, x, mesh=self.mesh, payloads=payloads)
        return forest_batch(self.seed, self.max_depth, self.min_leaf,
                            self.n_trees, self.pnz, x, payloads=payloads,
                            device=self.device)

    def _chunk_device(self) -> torch.device:
        """Where the next chunk goes: this ``ForestBuilder``'s device, or
        round-robin over the mesh's devices."""
        if not self.data_parallel:
            return self.device
        devs = list(self.mesh.devices.flatten())
        return devs[len(self._chunks) % len(devs)]

    def _to_device(self, chunk) -> torch.Tensor:
        """``chunk`` as f32 rows on its device (:meth:`_chunk_device`),
        always a copy (a caller may reuse its buffer for the next chunk).
        A host chunk is copied by a ``non_blocking`` copy from its own
        (pageable) memory, which returns once the host buffer has been
        read."""
        if torch.is_tensor(chunk):
            c = chunk.to(dtype=torch.float32)
        else:
            c = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
        if c.dim() == 1:
            c = c[None, :]
        if c.dim() != 2 or c.shape[1] != self.dim:
            raise ValueError(f"chunk dim {c.shape[-1]} != builder dim "
                             f"{self.dim}")
        return c.to(self._chunk_device(), non_blocking=True,
                    copy=True).contiguous()

    def insert_chunk(self, chunk, payloads: Optional[Sequence] = None):
        """Fold one data chunk into the builder (reference ``insertC``,
        Conduit.hs:79-91): the chunk goes to the builder's device at once
        (see :meth:`_to_device`), and :meth:`build` concatenates them."""
        c = self._to_device(chunk)
        if payloads is not None and len(payloads) != c.shape[0]:
            raise ValueError("payloads length != chunk length")
        self._chunks.append(c)
        self._payloads.append(list(payloads) if payloads is not None else None)
        self._n += c.shape[0]
        self._index = None
        self._chunks_since_rebuild += 1
        if self.anytime_slack:
            if self._anytime is None:
                # seed the partial index from the first chunk; slack slots
                # absorb later chunks without rebuild (leaf-sharded ones in
                # the data-parallel mode)
                if self.data_parallel:
                    from .parallel.mesh import DATA_AXIS

                    s = self.mesh.shape[DATA_AXIS]
                    if c.shape[0] % s:
                        raise ValueError(
                            f"anytime_slack with data_parallel needs the "
                            f"first chunk ({c.shape[0]} rows) to divide the "
                            f"{s} data shards")
                self._anytime = self._batch(
                    c, list(payloads) if payloads is not None else None)
                self._anytime.pack_leaves(slack=self.anytime_slack)
            else:
                self._anytime.add(c, payloads=payloads)
                self._anytime.fold()
        if self.periodic and self._chunks_since_rebuild >= self.periodic:
            self.build()

    def _all_payloads(self) -> Optional[list]:
        if all(p is None for p in self._payloads):
            return None
        out = []
        for c, p in zip(self._chunks, self._payloads):
            out.extend(p if p is not None else [None] * c.shape[0])
        return out

    def _sharded_rows(self):
        """The streamed chunks re-chunked into the mesh's contiguous shards
        in ingest order (each part assembled on its shard's device from
        slices of the chunks), as the data-parallel build takes them."""
        from .parallel.collectives import Sharded
        from .parallel.mesh import DATA_AXIS

        s = self.mesh.shape[DATA_AXIS]
        if self._n % s:
            raise ValueError(f"streamed rows ({self._n}) must divide the "
                             f"data-shard count ({s}) for the sharded "
                             f"finalize")
        per = self._n // s
        parts = [[] for _ in range(s)]
        off = 0
        for c in self._chunks:
            a = off
            while a < off + c.shape[0]:
                d = a // per
                e = min(off + c.shape[0], (d + 1) * per)
                parts[d].append(c[a - off:e - off].to(self.mesh.device(d)))
                a = e
            off += c.shape[0]
        return Sharded([torch.cat(p) for p in parts])

    def build(self) -> RPForest:
        """Finalize: exact level-synchronous rebuild over everything seen."""
        if self._n == 0:
            raise ValueError("streaming source was empty (the reference "
                             "requires a non-empty source, Conduit.hs:52)")
        if self._index is None:
            self._index = self._batch(
                self._sharded_rows() if self.data_parallel
                else torch.cat(self._chunks), self._all_payloads())
            self._index.config = ForestConfig(
                n_trees=self.n_trees, max_depth=self.max_depth,
                min_leaf=self.min_leaf, proj_nz_density=self.pnz,
                dim=self.dim, chunk_size=self.chunk_size)
            self._chunks_since_rebuild = 0
        return self._index


def _drive(builder: ForestBuilder, source: Union[Iterable, Iterator],
           chunk_size: int) -> RPForest:
    """Feed a source of rows or chunks through the builder, re-chunking
    single rows to ``chunk_size`` (semantics of ``chunksOf``,
    Conduit.hs:174)."""
    buf: list = []
    for item in source:
        a = item if torch.is_tensor(item) else np.asarray(item, np.float32)
        if a.ndim == 2:
            builder.insert_chunk(a)
        else:
            buf.append(a.cpu().numpy() if torch.is_tensor(a) else a)
            if len(buf) >= chunk_size:
                builder.insert_chunk(np.stack(buf))
                buf = []
    if buf:
        builder.insert_chunk(np.stack(buf))
    return builder.build()


def tree(seed, max_depth: int, min_leaf: int, chunk_size: int, pnz: float,
         dim: int, source, *, device=None) -> RPForest:
    """Populate a single tree from a data stream (reference ``tree``,
    Conduit.hs:58-72).  ``source`` yields rows ``[dim]`` or chunks
    ``[m, dim]``; ``device`` as in :class:`ForestBuilder`."""
    b = ForestBuilder(seed, max_depth, min_leaf, 1, pnz, dim,
                      chunk_size=chunk_size, device=device)
    return _drive(b, source, chunk_size)


def forest(seed, max_depth: int, min_leaf: int, n_trees: int,
           chunk_size: int, pnz: float, dim: int, source, *,
           device=None) -> RPForest:
    """Populate a forest from a data stream (reference ``forest``,
    Conduit.hs:104-121); ``device`` as in :class:`ForestBuilder`."""
    b = ForestBuilder(seed, max_depth, min_leaf, n_trees, pnz, dim,
                      chunk_size=chunk_size, device=device)
    return _drive(b, source, chunk_size)
