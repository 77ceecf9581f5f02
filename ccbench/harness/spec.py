"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
configuration's file is the one its ``configs`` entry gives; a traffic mix
``<mix>`` is ``traffic/<mix>.json`` and names the kind of request it sends,
whose requests are made by ``kinds/<kind>.py``; a per-layer metric ``<name>`` is read by
``metrics/<name>.py``.  All of them lie in the benchmark's directory, beside
this package, so that a later change adds a configuration, a mix, a kind or a
metric as files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Metric:
    name: str
    unit: str
    entry: dict


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names loaded."""

    name: str
    chips: int
    config: dict                  # the configuration's file
    traffic: dict                 # the traffic mix's file
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path                    # the checkout's root
    bench_dir: Path

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _in_cell(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` belongs to the cells it lists; one
    without to every cell that reports what it ``moves`` (end-to-end
    metrics without the key belong to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(root: Path, workload: str, bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    root = Path(root)
    bench_dir = Path(bench_dir) if bench_dir is not None else root / BENCH_DIR.name
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are: {', '.join(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [Metric(m["name"], m["unit"], m) for m in spec["end_to_end"]
           if _in_cell(m, workload, set())]
    names = {m.name for m in e2e}
    per_layer = [Metric(m["name"], m["unit"], m) for m in spec["per_layer"]
                 if _in_cell(m, workload, names)]
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, root=root, bench_dir=bench_dir)


def kind_module(cell: Cell):
    """The module of the cell's kind of request (``kinds/<kind>.py``), with its ``Workload``."""
    return _load_module(cell.bench_dir / "kinds" / f"{cell.kind}.py",
                        f"ccbench_kind_{cell.kind}")


def metric_reader(cell: Cell, name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    module = _load_module(cell.bench_dir / "metrics" / f"{name}.py",
                          "ccbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return module.read


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m.name: metric_reader(cell, m.name) for m in cell.per_layer}
