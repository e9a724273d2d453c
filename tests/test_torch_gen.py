"""The port's generators (``utils/gen.py``) against the JAX package's.

The two draw from different generators (``torch.Generator`` against
threefry keys), so their streams differ bit for bit; what must agree is
the distribution.  Each generator of both packages is held to the same
moment and mixture-share bounds (5 standard errors), ``data_source`` to
JAX's chunk shapes and types, and ``sample_wor`` -- numpy in both -- to
JAX's bits, with a chi-square pin on its subsets and inclusion
frequencies over both packages."""

import itertools
import math

import jax
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from rptree_tpu.utils import gen as jg
from rptree_tpu_torch.utils import gen as tg

from torch_parity import one_torch_thread  # noqa: F401

PACKAGES = ("jax", "port")
N = 20_000


def draw(pkg, gen, n=N, seed=7):
    """``n`` rows of ``gen`` (looked up in the package by name, or a
    function of the package module) as float64 numpy."""
    mod = jg if pkg == "jax" else tg
    fn = getattr(mod, gen) if isinstance(gen, str) else gen(mod)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return np.asarray(mod.data_batch(seed, n, fn, **kw), np.float64)


def within(value, expect, se, what=""):
    assert abs(value - expect) <= 5 * se, (what, value, expect, se)


def share_within(hits, n, p, what=""):
    within(hits / n, p, math.sqrt(p * (1 - p) / n), what)


def moments(x, mu, sigma, what=""):
    """Mean and variance of i.i.d. normal draws within 5 standard
    errors."""
    n = x.size
    within(x.mean(), mu, sigma / math.sqrt(n), what + " mean")
    within(x.var(), sigma ** 2, sigma ** 2 * math.sqrt(2 / (n - 1)),
           what + " var")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_dense(pkg):
    x = draw(pkg, lambda m: lambda k, n: m.dense(k, n, 4, 1.5, 0.25))
    assert x.shape == (N, 4)
    moments(x, 1.5, 0.25, "dense")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sparse(pkg):
    x = draw(pkg, lambda m: lambda k, n: m.sparse(k, n, 5, 0.3, 2.0, 0.5))
    nz = x[x != 0.0]
    share_within(nz.size, x.size, 0.3, "support")
    moments(nz, 2.0, 0.5, "sparse values")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_component_samplers(pkg):
    """A caller's sampler replaces the component distribution (the
    reference's ``sparse pnz dim <sampler>``)."""
    unif = (jax.random.uniform if pkg == "jax" else
            lambda k, shape: torch.rand(shape, generator=k, device=k.device))
    u = draw(pkg, lambda m: lambda k, n: m.dense(k, n, 3, sampler=unif))
    assert ((u >= 0.0) & (u < 1.0)).all()
    within(u.mean(), 0.5, math.sqrt(1 / 12 / u.size), "uniform mean")
    s = draw(pkg, lambda m: lambda k, n: m.sparse(k, n, 4, 0.5, sampler=unif))
    nz = s[s != 0.0]
    assert ((nz > 0.0) & (nz < 1.0)).all()
    share_within(nz.size, s.size, 0.5, "support")


def _split(x, lo_mean, hi_mean):
    """Rows of a two-component mixture by the nearer component mean."""
    m = x.mean(axis=1)
    return x[np.abs(m - hi_mean) < np.abs(m - lo_mean)], \
        x[np.abs(m - hi_mean) >= np.abs(m - lo_mean)]


@pytest.mark.parametrize("gen,dim", [("normal2", 2), ("normal_dense2", 32)])
@pytest.mark.parametrize("pkg", PACKAGES)
def test_normal_mixtures(pkg, gen, dim):
    """N(0, 0.5) and N(2, 0.5) per vector, each with probability 1/2."""
    fn = (lambda m: getattr(m, gen)) if dim == 2 else \
        (lambda m: lambda k, n: m.normal_dense2(k, n, dim))
    x = draw(pkg, fn)
    assert x.shape == (N, dim)
    hi, lo = _split(x, 0.0, 2.0)
    share_within(len(lo), N, 0.5, "mixture share")
    if dim > 2:  # rows of 32 values never stray to the other mean
        moments(lo, 0.0, 0.5, "low")
        moments(hi, 2.0, 0.5, "high")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_normal_sparse2(pkg):
    x = draw(pkg, lambda m: lambda k, n: m.normal_sparse2(k, n, 64, 0.25))
    share_within(int((x != 0).sum()), x.size, 0.25, "support")
    nz_mean = np.array([r[r != 0].mean() if (r != 0).any() else np.nan
                        for r in x])
    hi = np.nan_to_num(nz_mean, nan=0.0) > 1.0
    share_within(int(hi.sum()), N, 0.5, "mixture share")
    moments(x[hi][x[hi] != 0], 2.0, 0.5, "high values")


@pytest.mark.parametrize("probs", [None, (0.2, 0.3, 0.5)])
@pytest.mark.parametrize("pkg", PACKAGES)
def test_mixture_shares(pkg, probs):
    """Each component chosen with its probability, rows whole."""
    def gen(m):
        comps = [lambda k, n, c=c: m.dense(k, n, 2, float(10 * c), 0.1)
                 for c in range(3)]
        return m.mixture(comps, probs)

    x = draw(pkg, gen)
    comp = np.rint(x[:, 0] / 10).astype(int)
    assert (comp == np.rint(x[:, 1] / 10)).all()
    for c, p in enumerate(probs or (1 / 3,) * 3):
        share_within(int((comp == c).sum()), N, p, f"component {c}")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_mixture2_share(pkg):
    x = draw(pkg, lambda m: m.mixture2(lambda k, n: m.dense(k, n, 2, 0., .1),
                                       lambda k, n: m.dense(k, n, 2, 5., .1),
                                       0.3))
    share_within(int((x[:, 0] < 2.5).sum()), N, 0.3, "share a")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_circle2d(pkg):
    """Uniform on the disk of radius r (polar sampling, the JAX package's
    departure from the reference's rejection test): radius <= r, the
    squared radius uniform on [0, r^2], the angle uniform."""
    r = 2.0
    x = draw(pkg, lambda m: lambda k, n: m.circle2d(k, n, r))
    rad2 = (x ** 2).sum(1) / r ** 2
    assert rad2.max() <= 1.0 + 1e-6
    within(rad2.mean(), 0.5, math.sqrt(1 / 12 / N), "r^2 mean")
    ang = np.arctan2(x[:, 1], x[:, 0])
    within(ang.mean(), 0.0, math.pi / math.sqrt(3 * N), "angle mean")
    share_within(int((x[:, 0] > 0).sum()), N, 0.5, "right half")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_circle2d2(pkg):
    x = draw(pkg, "circle2d2")
    d0 = np.linalg.norm(x, axis=1)
    d1 = np.linalg.norm(x - [2.0, 3.0], axis=1)
    assert np.minimum(d0, d1).max() <= 1.0 + 1e-6
    share_within(int((d0 <= 1.0 + 1e-6).sum()), N, 0.5, "first disk")


@pytest.mark.parametrize("n,chunk", [(1000, 300), (900, 300), (5, 10)])
def test_data_source_chunks_like_jax(n, chunk):
    """The same chunk shapes and type as JAX's, numpy on the host; the
    rows together are the stream."""
    want = list(jg.data_source(3, n, chunk, jg.circle2d2))
    got = list(tg.data_source(3, n, chunk, tg.circle2d2, device="cpu"))
    assert [(type(c), c.shape, c.dtype) for c in got] == \
        [(type(c), c.shape, c.dtype) for c in want]
    again = np.concatenate(list(tg.data_source(3, n, chunk, tg.circle2d2,
                                               device="cpu")))
    np.testing.assert_array_equal(np.concatenate(got), again)


def test_keys_and_devices(monkeypatch):
    """A seed gives the same stream each time; a generator passes
    through; without a card the default device raises."""
    a = tg.data_batch(5, 50, tg.normal2, device="cpu")
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(a, tg.data_batch(5, 50, tg.normal2, device="cpu"))
    assert not torch.equal(a, tg.data_batch(6, 50, tg.normal2, device="cpu"))
    g = tg.key_from_seed(5, device="cpu")
    assert tg.key_from_seed(g) is g
    assert torch.equal(tg.normal2(g, 50), a)
    s = tg.rand_seed()
    assert isinstance(s, int) and 0 <= s < 2 ** 63
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.data_batch(5, 50, tg.normal2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.data_source(5, 50, 10, tg.normal2)


# -- sample_wor ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2 ** 40 + 3])
@pytest.mark.parametrize("k,n", [(1, 10), (3, 3), (5, 2), (4, 50), (16, 1000)])
def test_sample_wor_bit_equal_to_jax(seed, k, n):
    items = [f"item{i}" for i in range(n)]
    assert tg.sample_wor(seed, k, iter(items)) == jg.sample_wor(seed, k, items)
    rng = np.random.default_rng(seed)
    assert tg.sample_wor(rng, k, range(n)) == jg.sample_wor(
        np.random.default_rng(seed), k, range(n))


def test_sample_wor_small_cases():
    """A stream no longer than ``k`` comes back whole and in order; a
    sample holds distinct items of the stream."""
    assert tg.sample_wor(1, 5, range(3)) == [0, 1, 2]
    assert tg.sample_wor(1, 3, range(3)) == [0, 1, 2]
    assert tg.sample_wor(1, 0, range(3)) == []
    s = tg.sample_wor(9, 7, range(100))
    assert len(set(s)) == 7 and all(0 <= v < 100 for v in s)


@pytest.mark.parametrize("n,k", [(6, 2), (7, 3), (8, 1)])
@pytest.mark.parametrize("pkg", PACKAGES)
def test_sample_wor_subsets_equiprobable(pkg, n, k):
    """Every k-subset of a small universe equally likely over many seeds
    (chi-square, p > 0.001)."""
    sample = jg.sample_wor if pkg == "jax" else tg.sample_wor
    subsets = {s: i for i, s in
               enumerate(itertools.combinations(range(n), k))}
    counts = np.zeros(len(subsets))
    for seed in range(300 * len(subsets) // max(k, 1)):
        counts[subsets[tuple(sorted(sample(seed, k, range(n))))]] += 1
    assert chisquare(counts).pvalue > 1e-3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sample_wor_inclusion_frequencies(pkg):
    """Each item of a 40-item stream is in a 5-sample with probability
    1/8, late items (past the skips) as often as early ones (chi-square
    on the inclusion counts, p > 0.001)."""
    sample = jg.sample_wor if pkg == "jax" else tg.sample_wor
    n, k, seeds = 40, 5, 4000
    counts = np.zeros(n)
    for seed in range(seeds):
        counts[sample(seed, k, range(n))] += 1
    assert counts.sum() == k * seeds
    assert chisquare(counts).pvalue > 1e-3
    share_within(counts[-10:].sum(), 10 * seeds, k / n, "last ten items")
