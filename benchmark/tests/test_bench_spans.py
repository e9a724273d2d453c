"""The metrics read from the program's own spans and counters: a tiny
traced run of each cell that lists them reports each as a number, and a
cell's host times add up to its entry's total a call.  Device times need
the card: there the same runs report every new metric."""

import pytest

from benchmark import harness, spec
from benchmark.tests.helpers import SEED, tiny
from rptree_tpu_torch.utils import profiling

BENCH = spec.benchmark()
NEW = {"host_us.entry.batch", "host_us.candidates.batch",
       "host_us.rerank.batch", "host_us.topk_tail.batch",
       "host_us.entry.online", "host_us.candidates.online",
       "host_us.grouped.online", "host_us.topk_tail.online",
       "project_us_per_kq", "grouped_slot_use_pct.batch",
       "grouped_slot_use_pct.online"}
CELLS = {"sift1m.perpair.b16384": "rpt_knn_batched",
         "sift1m.online.q8192": "rpt_knn_grouped",
         "sift1m.grouped.b131072": None}
SECONDS = {"sift1m.online.q8192": 1.0}


def _new_metrics(name, device_too):
    return {m["name"] for m in spec.cell(name).per_layer
            if m["name"] in NEW
            and (device_too or m["source"] != "device_trace")}


def _traced(name, device):
    return harness.run(name, SEED, SECONDS.get(name, 0.4), True,
                       device=device, cell=tiny(name))


def test_every_new_metric_has_its_cells():
    listed = {w for m in BENCH["per_layer"] if m["name"] in NEW
              for w in m["workloads"]}
    assert {m["name"] for m in BENCH["per_layer"]} >= NEW
    assert listed == set(CELLS) | {"bigann10m.perpair.b65536"}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_run_reports_the_new_metrics(name):
    out = _traced(name, "cpu")
    assert out["correct"], out["checks"]
    want = _new_metrics(name, False)
    assert want
    _check(name, out, want)


def _check(name, out, want):
    """Each metric of ``want`` is a number, and the cell's host times add
    up to its entry's total a call within 1%."""
    for m in want:
        assert out["metrics"][m]["value"] >= 0, m
    entry = CELLS[name]
    if entry is None:
        return
    host = [m for m in want if m.startswith("host_us.")]
    assert len(host) == 4
    s = profiling.stats()
    total_us = s[entry]["total_ns"] / (s[entry]["calls"] * 1e3)
    summed = sum(out["metrics"][m]["value"] for m in host)
    assert abs(summed - total_us) <= 0.01 * total_us


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_traced_run_on_the_card_reports_the_new_metrics(card, name):
    out = _traced(name, card)
    assert out["correct"], out["checks"]
    _check(name, out, _new_metrics(name, True))
    ops = [op for op, _ in out["breakdown"]["device_ops"]]
    assert not any(op.startswith("unranged:project") for op in ops), ops
