"""Projection sampling (the counterpart of ``rptree_tpu/utils/gen.py``).

The JAX package draws projections from threefry keys; this module draws
them from an explicit ``torch.Generator``.  The two streams differ bit for
bit from the same seed, so parity tests hand the JAX forest's projections
to the port (``forest_batch(..., r=...)`` or :func:`..utils.io.
forest_from_numpy`) instead of comparing samplers.
"""

from __future__ import annotations

import torch

from .._cuda import resolve_device

__all__ = ["sample_projections"]


def sample_projections(seed, n_trees: int, depth: int, dim: int, pnz: float,
                       dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Sample the forest's projection tensor ``R: [n_trees, depth, dim]``
    in ``dtype``: N(0, 1) components under a Bernoulli(``pnz``) support
    mask, zeros where the mask is off (the reference's sparse Gaussian
    vectors, materialized dense).  The parameters are the JAX package's,
    in its order; ``device`` is the port's own.  Drawn in f32 on the CPU
    from ``seed`` so that the same seed gives the same projections on
    every device, then cast and moved to ``device`` (default: the card;
    the CPU only with ``device="cpu"``)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    shape = (int(n_trees), int(depth), int(dim))
    r = torch.randn(shape, generator=g, dtype=torch.float32)
    if pnz < 1.0:
        mask = torch.rand(shape, generator=g) < pnz
        r = torch.where(mask, r, torch.zeros((), dtype=r.dtype))
    return r.to(device=resolve_device(device), dtype=dtype)
