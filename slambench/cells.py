"""Discovery: everything that belongs to one configuration, traffic mix,
cell or per-layer metric sits in a file of its own, found by its name.

- ``BENCHMARK.json`` at the root names the cells, metrics and bounds;
- ``slambench/configs/<config>.json``: a deployment's settings;
- ``slambench/traffic/<traffic>.json``: a traffic mix's parameters;
- ``slambench/limits/<cell>.json``: the limit of each number ``correct``
  compares in that cell, with the readings it was set from;
- ``slambench/metrics/<metric>.py``: a reader with ``read(run) -> float |
  None`` for each per-layer metric.

A later change adds a cell, a mix, a configuration or a metric by adding
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict  # compared number -> limit
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _read_json(Path(root) / "BENCHMARK.json")


def load_config(name: str, base: Path = BENCH_DIR) -> dict:
    return _read_json(Path(base) / "configs" / f"{name}.json")


def load_traffic(name: str, base: Path = BENCH_DIR) -> dict:
    return _read_json(Path(base) / "traffic" / f"{name}.json")


def load_limits(cell: str, base: Path = BENCH_DIR) -> dict:
    """``{number: limit}`` of the cell's limits file."""
    return {k: float(v["limit"]) for k, v in _read_json(Path(base) / "limits" / f"{cell}.json").items()}


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, base: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench`` with its files; KeyError if absent."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[name]
    return Cell(
        name=name, chips=int(w["chips"]), config=load_config(w["config"], base),
        traffic=load_traffic(w["traffic"], base), limits=load_limits(name, base),
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)],
    )


def metric_reader(name: str, package: str = "slambench.metrics"):
    """The ``read`` function of ``<package>/<name>.py``."""
    return importlib.import_module(f"{package}.{name}").read
