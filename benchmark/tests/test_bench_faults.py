"""A run whose timed path is broken underneath comes out not correct:
half of each batch left out, an answer altered where it is made, the
learned tile capacity too small (overflow masks candidates), a few
answers masked."""

import torch

from benchmark import harness
from benchmark.tests.helpers import SEED, tiny

NAME = "sift1m.grouped.b131072"


def _half_left_out(entry):
    def served(q, k, **kw):
        h = q.shape[0] // 2
        d, ids = entry(q[:h], k, **kw)
        return torch.cat([d, d]), torch.cat([ids, ids])
    return served


def _answer_altered(entry):
    def served(q, k, **kw):
        d, ids = entry(q, k, **kw)
        ids = ids.clone()
        ids[:, 0] = ids[:, 1]
        return d, ids
    return served


def _capacity_cut(entry):
    """The tile capacity learned by the checked warm call, cut to a
    quarter before the first unchecked call: overflowing pairs then come
    back masked, as they would where a batch needs more tiles than its
    shape's learned capacity."""
    forest = entry.__self__
    cut = []

    def served(q, k, **kw):
        if kw.get("check") is False and not cut:
            for key, cap in forest._grouped_nt.items():
                forest._grouped_nt[key] = max(1, cap // 4)
            cut.append(True)
        return entry(q, k, **kw)
    return served


def _answers_masked(entry):
    """The last three ranks of one query in 32 masked (+inf, -1), as
    pairs lost to an overflow would leave them."""
    def served(q, k, **kw):
        d, ids = entry(q, k, **kw)
        d, ids = d.clone(), ids.clone()
        d[::32, -3:] = float("inf")
        ids[::32, -3:] = -1
        return d, ids
    return served


def test_sound_run_is_correct():
    out = harness.run(NAME, SEED, 0.3, False, device="cpu", cell=tiny(NAME))
    assert out["correct"], out["checks"]


def test_half_of_the_batch_left_out():
    out = harness.run(NAME, SEED, 0.3, False, device="cpu", cell=tiny(NAME),
                      wrap=_half_left_out)
    assert not out["correct"]


def test_answer_altered():
    out = harness.run(NAME, SEED, 0.3, False, device="cpu", cell=tiny(NAME),
                      wrap=_answer_altered)
    assert not out["correct"]


def test_open_loop_run_is_correct():
    name = "sift1m.online.q8192"
    out = harness.run(name, SEED, 0.5, False, device="cpu", cell=tiny(name))
    assert out["correct"], out["checks"]
    assert out["metrics"]["p95_request_ms"]["value"] > 0


def test_capacity_overflow():
    out = harness.run(NAME, SEED, 0.3, False, device="cpu", cell=tiny(NAME),
                      wrap=_capacity_cut)
    assert out["checks"]["overflow_tiles"]["value"] > 0
    assert not out["correct"]


def test_answers_masked():
    out = harness.run(NAME, SEED, 0.3, False, device="cpu", cell=tiny(NAME),
                      wrap=_answers_masked)
    assert out["checks"]["holes"]["value"] > 0
    # the share of misses alone stays under its limit: the holes decide
    ms = out["checks"]["miss_share"]
    assert ms["value"] <= ms["limit"]
    assert not out["correct"]
