"""Inputs made from the seed: the rows, the query pool and the projections
on the device, the sampled pool positions and the arrival schedule on
the host.

The rows and queries follow ``examples/torch_clustered_1m.py``
``make_clustered`` (a Gaussian mixture: unit-normal centers, each row a
center plus ``sigma`` noise, each query a row plus ``query_noise *
sigma`` noise), drawn here a block of rows at a time so that no
temporary of the whole dataset's size exists.  The projections follow
the port's ``sample_projections``: N(0, 1) components kept with
probability ``pnz``.  Everything is drawn from one ``torch.Generator``
on the device, so a seed gives the same inputs on every run.
"""

from __future__ import annotations

import torch

ROWS_A_STEP = 1 << 20


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def mixture(g: torch.Generator, n: int, dim: int, centers: int,
            sigma: float, pool: int, query_noise: float):
    """``(x f32[n, dim], q f32[pool, dim])`` on ``g``'s device."""
    dev = g.device
    c = torch.randn(centers, dim, generator=g, device=dev)
    x = torch.empty((n, dim), dtype=torch.float32, device=dev)
    for s in range(0, n, ROWS_A_STEP):
        m = min(ROWS_A_STEP, n - s)
        a = torch.randint(0, centers, (m,), generator=g, device=dev)
        x[s:s + m] = c[a]
        x[s:s + m].add_(torch.randn(m, dim, generator=g, device=dev),
                        alpha=sigma)
    qi = torch.randint(0, n, (pool,), generator=g, device=dev)
    q = x[qi] + (query_noise * sigma) * torch.randn(
        pool, dim, generator=g, device=dev)
    return x, q


def projections(g: torch.Generator, n_trees: int, depth: int, dim: int,
                pnz: float) -> torch.Tensor:
    """``R f32[n_trees, depth, dim]``: N(0, 1) under a Bernoulli(pnz)
    support mask."""
    shape = (n_trees, depth, dim)
    r = torch.randn(shape, generator=g, device=g.device)
    if pnz < 1.0:
        keep = torch.rand(shape, generator=g, device=g.device) < pnz
        r = torch.where(keep, r, torch.zeros((), device=g.device))
    return r


def host_generator(seed: int, stream: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def sample_positions(seed: int, pool: int, count: int) -> torch.Tensor:
    """``count`` distinct pool positions drawn from the seed, ascending."""
    g = host_generator(seed, 1)
    return torch.randperm(pool, generator=g)[:min(count, pool)].sort().values


ARRIVAL_BLOCK = 64


def arrival_times(seed: int, rate: float, seconds: float) -> torch.Tensor:
    """Due times (s, from the window's start) of ``round(rate * seconds)``
    Poisson arrivals, stratified: each block of ``ARRIVAL_BLOCK``
    requests takes the same quantiles of the exponential law, in an order
    drawn from the seed, and the gaps are scaled to fill ``seconds``.  So
    a seed changes the order of the load within a block and never its
    amount, in the window or in any block of it."""
    count = max(1, round(rate * seconds))
    g = host_generator(seed, 2)
    gaps = []
    for s in range(0, count, ARRIVAL_BLOCK):
        m = min(ARRIVAL_BLOCK, count - s)
        u = (torch.arange(m, dtype=torch.float64) + 0.5) / m
        gaps.append((-torch.log1p(-u))[torch.randperm(m, generator=g)])
    gaps = torch.cat(gaps)
    return torch.cumsum(gaps, 0) * (seconds / float(gaps.sum()))
