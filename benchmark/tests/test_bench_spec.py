"""Every cell, configuration, traffic mix, limit and metric of
BENCHMARK.json loads by name, and a cell added as new files alone runs."""

import json
import shutil

import pytest

from benchmark import harness, spec
from benchmark.tests.helpers import SEED, tiny

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    c = spec.cell(name)
    assert c.config["n"] > 0 and c.traffic["batch"] > 0
    assert c.config["data"]["pool"] % c.traffic["batch"] == 0
    want = {"miss_share", "dist_err", "holes"}
    if c.traffic["entry"] == "knn_grouped":
        want.add("overflow_tiles")
    assert set(c.limits) == want
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads(name):
    assert callable(spec.reader(name))


def test_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert moved
        for w in m.get("workloads", []):
            assert w in CELLS
            assert "workloads" not in moved[0] or w in moved[0]["workloads"]


@pytest.mark.parametrize("group,key,value", [("data", "kind", "sift"),
                                             ("index", "metric", "cosine")])
def test_config_beyond_what_is_served_is_refused(tmp_path, group, key,
                                                 value):
    """A configuration that states data or a metric that the generator
    and the reference do not serve fails when it loads."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    path = root / "benchmark/configs/sift1m.json"
    conf = json.loads(path.read_text())
    conf[group][key] = value
    path.write_text(json.dumps(conf))
    with pytest.raises(ValueError, match=f"{group}.{key}"):
        spec.cell("sift1m.grouped.b131072", root=root)


def test_cell_added_by_files_alone(tmp_path):
    """A later change adds a configuration, a mix, limits and a metric as
    new files and entries; the harness runs the new cell unedited."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    base = tiny("sift1m.grouped.b131072")
    conf = dict(base.config, n=8000)
    (root / "benchmark/configs/dummy.json").write_text(json.dumps(conf))
    mix = dict(base.traffic, entry="knn_batched", kwargs={"chunk": 128})
    mix.pop("warm")
    (root / "benchmark/traffic/dummy.mix.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/dummy.cell.json").write_text(
        json.dumps({"miss_share": 0.01, "dist_err": 0.001}))
    (root / "benchmark/metrics/dummy_calls.py").write_text(
        "def read(run):\n    return float(len(run.dispatch_s))\n")
    bench["configs"].append({"name": "dummy", "source": "a test",
                             "file": "benchmark/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy",
                               "traffic": "dummy.mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "qps",
                               "workloads": ["dummy.cell"]})
    bench["end_to_end"][0]["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("dummy.cell", root=root)
    out = harness.run("dummy.cell", SEED, 0.3, False, device="cpu",
                      cell=cell)
    assert out["correct"], out["checks"]
    assert {"qps", "recall_at_10", "setup_s"} <= set(out["metrics"])
    out = harness.run("dummy.cell", SEED, 0.4, True, device="cpu", cell=cell)
    assert out["metrics"]["dummy_calls"]["value"] >= 1
    assert list(out)[-1] == "checks"
