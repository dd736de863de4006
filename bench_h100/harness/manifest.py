"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs`` entry, its
``file``) and a traffic mix (``bench_h100/traffic/<traffic>.json``); the
mix names its driver kind (``bench_h100/drivers/<driver>.py``); each
per-layer metric has its reader (``bench_h100/metrics/<name>.py``); each
cell has its limits of ``correct`` (``bench_h100/limits/<workload>.json``).
Adding a cell, a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, manifest_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(manifest_path)
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in {manifest_path}; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def driver(kind: str):
    return importlib.import_module(f"bench_h100.drivers.{kind}")


def reader(metric: str):
    """The per-layer metric's reader module: ``read(ctx) -> float | None``."""
    return load_module(BENCH / "metrics" / f"{metric}.py",
                       "bench_h100_metric_" + metric.replace(".", "_"))
