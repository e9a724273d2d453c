"""``grouped_stage_tbps.batch``: kernel 1's staged bytes over the device
seconds under ``rpt_grouped_score``.  It reads None where the program
does not count its staged bytes (a program before the counter), where
the run was not traced, and where the trace holds no device time (the
CPU); a tiny traced run on the CPU counts the bytes."""

import types

import pytest

from benchmark import harness, spec
from benchmark.tests.helpers import SEED, tiny
from rptree_tpu_torch.utils import profiling

NAME = "grouped_stage_tbps.batch"
CELLS = ["sift1m.grouped.b131072", "gist1m.grouped.b131072"]


def _run(range_s):
    trace = types.SimpleNamespace(range_s=range_s)
    run = harness.Run(None)
    run.trace = trace
    return run


def test_listed_for_the_grouped_batch_cells():
    (m,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == CELLS and m["moves"] == "qps"
    for name in CELLS:
        assert NAME in {x["name"] for x in spec.cell(name).per_layer}


def test_reads_none_without_the_counter(monkeypatch):
    read = spec.reader(NAME)
    stats = {"grouped.pairs": 10, "grouped.block_reads": 2}
    monkeypatch.setattr(profiling, "stats", lambda: dict(stats))
    assert read(_run({"rpt_grouped_score": 0.5})) is None
    assert read(harness.Run(None)) is None          # not traced
    stats["grouped.staged_bytes"] = 3_000_000_000_000
    assert read(_run({})) is None                   # no device time
    assert read(_run({"rpt_grouped_score": 0.5})) == pytest.approx(6.0)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_counts_the_staged_bytes(name):
    """On the CPU the plain version adds the bytes, and the trace holds no
    device time under the range, so the metric reads None; the counter is
    what a card's run divides."""
    out = harness.run(name, SEED, 0.4, True, device="cpu", cell=tiny(name))
    assert out["correct"], out["checks"]
    assert profiling.stats()["grouped.staged_bytes"] > 0
    assert NAME not in out["metrics"]
