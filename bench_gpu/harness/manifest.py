"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A cell ``<config>.<traffic>`` is run from ``configs/<config>.json`` (the
model, its widths and dtype, the pipeline settings, the limits of the
output check), ``traffic/<traffic>.json`` (the mix's parameters and the
name of the driver module under ``drivers/`` that runs it) and, in a
traced run, one reader ``metrics/<metric>.py`` for each per-layer metric
the cell reports. Adding a cell, a configuration, a mix or a metric adds
files and entries; no code here names any of them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config_name: str
    traffic_name: str
    config: Dict
    traffic: Dict
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_cell(name: str, bench: Dict = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its files read from
    ``root``."""
    root = Path(root)
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as fh:
        config = json.load(fh)
    with open(root / BENCH_DIR.name / "traffic" / f"{w['traffic']}.json") \
            as fh:
        traffic = json.load(fh)
    return Cell(name=name, root=root, chips=int(w["chips"]),
                config_name=w["config"],
                traffic_name=w["traffic"], config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``metrics/<metric>.py``'s ``read(record)``."""
    path = Path(root) / BENCH_DIR.name / "metrics" / f"{metric}.py"
    return _load_file(path, "bench_metric_" + metric.replace(".", "_")).read


def cost(name: str, root: Path = ROOT):
    """``costs/<name>.py`` (a kernel's or a configuration's counts)."""
    path = Path(root) / BENCH_DIR.name / "costs" / f"{name}.py"
    return _load_file(path, "bench_cost_" + name.replace(".", "_"))


def driver(cell: Cell):
    return importlib.import_module(f"bench_gpu.drivers.{cell.traffic['driver']}")
