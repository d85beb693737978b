"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A cell ``<config>.<traffic>`` is run from ``configs/<config>.json`` (the
model, its widths and dtype, the pipeline settings, the limits of the
output check), ``traffic/<traffic>.json`` (the mix's parameters and the
name of the driver module under ``drivers/`` that runs it) and, in a
traced run, one reader ``metrics/<metric>.py`` for each per-layer metric
the cell reports. Every module a cell brings (its driver, its reference
under ``reference/``, its readers, its kernels' and model's counts under
``costs/``) is loaded by path from the cell's own root, so adding a cell,
a configuration, a mix, a driver, a reference, a kernel or a metric adds
files and entries; no code here names any of them.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
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


_LOADED: Dict[Path, object] = {}


def load(kind: str, name: str, root: Path = ROOT):
    """``<root>/bench_gpu/<kind>/<name>.py``, executed once a process
    under a module name made from its resolved path, so that two
    checkouts' files of one name never stand for each other."""
    path = (Path(root) / BENCH_DIR.name / kind / f"{name}.py").resolve()
    if path not in _LOADED:
        tag = hashlib.sha1(str(path).encode()).hexdigest()[:12]
        module_name = f"bench_{kind}_{tag}"
        spec = importlib.util.spec_from_file_location(module_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = mod  # as an import has it while it runs
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[module_name]
            raise
        _LOADED[path] = mod
    return _LOADED[path]


def names(kind: str, root: Path = ROOT) -> List[str]:
    """The modules of ``<root>/bench_gpu/<kind>/``, by name."""
    return sorted(p.stem for p in (Path(root) / BENCH_DIR.name / kind)
                  .glob("*.py") if p.stem != "__init__")


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``metrics/<metric>.py``'s ``read(record)``."""
    return load("metrics", metric, root).read


def cost(name: str, root: Path = ROOT):
    """``costs/<name>.py`` (a kernel's or a configuration's counts)."""
    return load("costs", name, root)


def driver_module(name: str, root: Path = ROOT):
    """``drivers/<name>.py``: ``run(...)`` and ``TINY``, the overrides
    that cut its cells to a CPU test's size."""
    return load("drivers", name, root)


def driver(cell: Cell):
    """The driver the cell's traffic file names, from the cell's root."""
    return driver_module(cell.traffic["driver"], cell.root)
