"""Random generation: projection sampling, synthetic datasets, reservoir
sampling (the counterpart of ``rptree_tpu/utils/gen.py``, the reference's
L1 layer, ``src/Data/RPTree/Gen.hs``).

The JAX package draws from threefry keys; this module draws from an
explicit ``torch.Generator``, which :func:`key_from_seed` makes from a
seed on the target device (the card unless the caller names the CPU).  A
generator here has JAX's signature with the ``torch.Generator`` in the
key's place, ``gen(key, n) -> f32[n, d]`` on the key's device, and the
same distributions, mixtures and parameters, in JAX's order.

The streams differ from the JAX package's bit for bit from the same seed
(the sampler divergence ROADMAP.md records): parity tests hand the JAX
forest's projections to the port (``forest_batch(..., r=...)``) and hold
the data generators to their distributions, not to JAX's draws.  Where JAX
splits its key for each chunk of :func:`data_source`, the port's stream
runs on through one generator, so chunk ``i`` follows from the seed and
the chunks before it.  :func:`sample_wor` is the JAX package's numpy
Algorithm L, copied, and gives its bits.
"""

from __future__ import annotations

import math
import secrets
from typing import Callable, Iterator

import numpy as np
import torch

from .._cuda import resolve_device

__all__ = [
    "rand_seed",
    "key_from_seed",
    "sample_projections",
    "sparse",
    "dense",
    "normal2",
    "normal_dense2",
    "normal_sparse2",
    "circle2d",
    "circle2d2",
    "mixture",
    "mixture2",
    "data_batch",
    "data_source",
    "sample_wor",
]


def rand_seed() -> int:
    """Fresh random seed from OS entropy (reference ``randSeed``,
    ``src/Data/RPTree/Internal/Testing.hs:33-34``)."""
    return secrets.randbits(63)


def key_from_seed(seed, *, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (default: the card; the CPU
    only with ``device="cpu"``) seeded from the uint64 ``seed``; a
    generator passes through as it is."""
    if isinstance(seed, torch.Generator):
        return seed
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return g


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


# ---------------------------------------------------------------------------
# synthetic data generators (reference Gen.hs:100-195)
#
# Each generator has signature gen(key, n) -> tensor [n, d] on the key's
# device; `data_batch` / `data_source` drive them.
# ---------------------------------------------------------------------------

def _normal(key, shape) -> torch.Tensor:
    return torch.randn(shape, generator=key, device=key.device)


def _uniform(key, shape) -> torch.Tensor:
    return torch.rand(shape, generator=key, device=key.device)


def dense(key, n: int, dim: int, mu: float = 0.0, sigma: float = 1.0,
          sampler: Callable = None) -> torch.Tensor:
    """Dense random vectors (reference ``dense``/``denseVG``,
    Gen.hs:156-175).  Components are N(mu, sigma) by default; a
    ``sampler(key, shape) -> tensor`` callable overrides the component
    distribution entirely (the reference's caller-supplied sampler
    argument), ignoring mu/sigma."""
    if sampler is not None:
        return sampler(key, (n, dim))
    return mu + sigma * _normal(key, (n, dim))


def sparse(key, n: int, dim: int, pnz: float, mu: float = 0.0,
           sigma: float = 1.0, sampler: Callable = None) -> torch.Tensor:
    """Sparse random vectors with Bernoulli(pnz) support, materialized
    dense (reference ``sparse``/``sparseVG``, Gen.hs:148-195).  As with
    :func:`dense`, ``sampler(key, shape)`` substitutes any component
    distribution for the default N(mu, sigma)."""
    if sampler is not None:
        vals = sampler(key, (n, dim))
    else:
        vals = mu + sigma * _normal(key, (n, dim))
    mask = _uniform(key, (n, dim)) < pnz
    return torch.where(mask, vals, torch.zeros((), dtype=vals.dtype,
                                               device=vals.device))


def mixture(gens, probs=None) -> Callable:
    """N-component mixture: per-vector categorical choice between
    generators (reference ``mixtureN``, Gen.hs:102-108).  ``probs``
    defaults to uniform."""
    gens = list(gens)
    if probs is None:
        probs = [1.0 / len(gens)] * len(gens)

    def gen(key, n: int) -> torch.Tensor:
        p = torch.as_tensor(probs, dtype=torch.float32, device=key.device)
        choice = torch.multinomial(p, n, replacement=True, generator=key)
        outs = torch.stack([g(key, n) for g in gens])
        return torch.take_along_dim(outs, choice[None, :, None], dim=0)[0]

    return gen


def mixture2(gen_a: Callable, gen_b: Callable, p: float = 0.5) -> Callable:
    """Binary mixture: per-vector Bernoulli(p) choice between two generators
    (reference ``mixtureN`` specialization, Gen.hs:102-113)."""

    def gen(key, n: int) -> torch.Tensor:
        choose_a = _uniform(key, (n,)) < p
        xa = gen_a(key, n)
        xb = gen_b(key, n)
        return torch.where(choose_a[:, None], xa, xb)

    return gen


def normal2(key, n: int) -> torch.Tensor:
    """2-D binary Gaussian mixture: N(0, 0.5) vs N(2, 0.5) per vector
    (reference ``normal2``, Gen.hs:139-144)."""
    return mixture2(
        lambda k, m: dense(k, m, 2, 0.0, 0.5),
        lambda k, m: dense(k, m, 2, 2.0, 0.5),
    )(key, n)


def normal_dense2(key, n: int, dim: int) -> torch.Tensor:
    """d-dim binary Gaussian mixture (reference ``normalDense2``,
    Gen.hs:132-137)."""
    return mixture2(
        lambda k, m: dense(k, m, dim, 0.0, 0.5),
        lambda k, m: dense(k, m, dim, 2.0, 0.5),
    )(key, n)


def normal_sparse2(key, n: int, dim: int, pnz: float) -> torch.Tensor:
    """Sparse binary Gaussian mixture (reference ``normalSparse2``,
    Gen.hs:125-130), materialized dense."""
    return mixture2(
        lambda k, m: sparse(k, m, dim, pnz, 0.0, 0.5),
        lambda k, m: sparse(k, m, dim, pnz, 2.0, 0.5),
    )(key, n)


def circle2d(key, n: int, r: float = 1.0) -> torch.Tensor:
    """Uniform points on the disk of radius ``r`` (reference ``circle2d``,
    Gen.hs:115-123, which rejection-samples; here polar sampling, as in
    the JAX package -- same distribution at r=1, and exact for any r: the
    reference's accept test uses ``x^2+y^2 <= r`` rather than ``r^2``, a
    quirk not reproduced)."""
    rad = r * torch.sqrt(_uniform(key, (n,)))
    ang = 2.0 * math.pi * _uniform(key, (n,))
    return torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)], dim=-1)


def circle2d2(key, n: int) -> torch.Tensor:
    """Binary mixture of two unit disks centered (0,0) and (2,3) -- the
    reference test-suite dataset (``test/Data/RPTreeSpec.hs:112-120``)."""
    return mixture2(
        lambda k, m: circle2d(k, m, 1.0),
        lambda k, m: circle2d(k, m, 1.0) + torch.tensor([2.0, 3.0],
                                                        device=k.device),
    )(key, n)


def data_batch(seed, n: int, gen: Callable, *, device=None) -> torch.Tensor:
    """Sample a full batch dataset (reference ``dataBatch``,
    Batch.hs:66-75): ``gen(key, n)`` on ``device`` (default: the card;
    the CPU only with ``device="cpu"``).  ``seed`` may be a
    ``torch.Generator``, which then sets the device."""
    return gen(key_from_seed(seed, device=device), n)


def data_source(seed, n: int, chunk_size: int, gen: Callable, *,
                device=None) -> Iterator[np.ndarray]:
    """Chunked stream of random data points (reference ``dataSource``,
    Conduit.hs:179-188, chunked per ``chunkedAccum`` Conduit.hs:169-176).

    Yields numpy chunks of ``chunk_size`` rows (the last may be short),
    as the JAX package does: the host input pipeline feeding the
    streaming builder.  Each chunk is drawn on ``device`` (default: the
    card; the CPU only with ``device="cpu"``) and copied to the host."""
    key = key_from_seed(seed, device=device)

    def chunks():
        off = 0
        while off < n:
            m = min(chunk_size, n - off)
            yield gen(key, m).cpu().numpy()
            off += m

    return chunks()


def sample_wor(seed, k: int, xs) -> list:
    """Sample ``k`` items without replacement in one pass (reservoir
    sampling; the reference implements Algorithm L, Gen.hs:29-92).  Works on
    any iterable; returns a list of at most ``k`` items.  The JAX
    package's numpy code, copied: the same seed gives its sample."""
    rng = np.random.default_rng(seed & 0xFFFFFFFFFFFFFFFF if isinstance(seed, int) else seed)
    reservoir = []
    w = 1.0
    next_i = None
    for i, x in enumerate(xs):
        if len(reservoir) < k:
            reservoir.append(x)
            if len(reservoir) == k:
                w = float(np.exp(np.log(rng.random()) / k))
                next_i = i + int(np.floor(np.log(rng.random()) / np.log1p(-w))) + 1
        elif i == next_i:
            reservoir[rng.integers(0, k)] = x
            w *= float(np.exp(np.log(rng.random()) / k))
            next_i = i + int(np.floor(np.log(rng.random()) / np.log1p(-w))) + 1
    return reservoir
