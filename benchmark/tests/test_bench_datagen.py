"""The inputs repeat for a seed, and the arrivals' amount does not
depend on it."""

import torch

from benchmark import datagen

BIG = 2 ** 40 + 3


def _draw(seed):
    g = datagen.generator(seed, "cpu")
    x, q = datagen.mixture(g, 3000, 16, 7, 0.15, 256, 0.5)
    r = datagen.projections(g, 3, 5, 16, 0.5)
    return x, q, r


def test_inputs_repeat_for_a_seed():
    a, b, c = _draw(BIG), _draw(BIG), _draw(BIG + 1)
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v)
        assert not torch.equal(u, w)


def test_projections_are_sparse_gaussian():
    r = datagen.projections(datagen.generator(5, "cpu"), 8, 16, 128, 0.47)
    nz = (r != 0).double().mean()
    assert 0.42 < nz < 0.52


def test_blocks_of_rows_do_not_change_the_law(monkeypatch):
    monkeypatch.setattr(datagen, "ROWS_A_STEP", 700)
    x, q, _ = _draw(11)
    assert x.shape == (3000, 16) and q.shape == (256, 16)
    assert torch.isfinite(x).all()


def test_samples_repeat_and_are_distinct():
    a = datagen.sample_positions(BIG, 5000, 300)
    assert torch.equal(a, datagen.sample_positions(BIG, 5000, 300))
    assert a.unique().numel() == 300 and bool((a[1:] > a[:-1]).all())


def test_arrivals_same_amount_any_seed():
    a = datagen.arrival_times(BIG, 400.0, 10.0)
    b = datagen.arrival_times(BIG + 9, 400.0, 10.0)
    assert a.numel() == b.numel() == 4000
    assert abs(float(a[-1]) - 10.0) < 1e-9 and abs(float(b[-1]) - 10.0) < 1e-9
    ga = torch.diff(a, prepend=a.new_zeros(1)).sort().values
    gb = torch.diff(b, prepend=b.new_zeros(1)).sort().values
    assert torch.allclose(ga, gb)
    assert not torch.equal(a, b)
    assert torch.equal(a, datagen.arrival_times(BIG, 400.0, 10.0))
