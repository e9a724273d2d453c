"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py`` under this folder.
Nothing here names a cell, a mix or a metric: a new one is new files and
entries."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# What the data generator and the reference serve, by a configuration's
# group and key: a configuration that states anything else is refused
# when it loads.
SERVED = {("data", "kind"): "gaussian_mixture", ("index", "metric"): "l2"}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # BENCHMARK.json metric entries the cell reports
    per_layer: list
    root: Path = ROOT


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, bench: dict = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench or benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    here = root / HERE.name
    config = _json(root / conf["file"])
    for (group, key), served in SERVED.items():
        if config[group][key] != served:
            raise ValueError(f"{conf['file']}: {group}.{key} "
                             f"{config[group][key]!r}; the benchmark serves "
                             f"{served!r} only")
    return Cell(name, config,
                _json(here / "traffic" / f"{w['traffic']}.json"),
                _json(here / "limits" / f"{name}.json"), e2e, layer, root)


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
