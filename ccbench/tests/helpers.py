"""A benchmark root of small cells for the CPU tests: the repository's
``BENCHMARK.json`` with a tiny configuration and its cells added, written to
a temporary directory; the benchmark's own files are used where they are."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

from ccbench.harness import runner, spec

REPO = spec.BENCH_DIR.parent

TINY = dict(num_brokers=16, num_racks=4, num_topics=20, num_replicas=600, mean_cpu=0.006,
            mean_disk=90.0, mean_nw_in=90.0, mean_nw_out=90.0, seed=3140)


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def tiny_root(tmp: Path, cluster: dict = TINY) -> Path:
    """A root whose BENCHMARK.json also holds ``tiny.remove_lanes`` on a
    16-broker cluster."""
    tmp = Path(tmp)
    spec_doc = benchmark()
    cfg = json.loads((REPO / "ccbench/configs/randomcluster_40b_50k.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["name"] = "tiny"
    cfg["cluster"] = dict(cfg["cluster"], **cluster)
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "configs/tiny.json").write_text(json.dumps(cfg))
    spec_doc["configs"].append({"name": "tiny", "source": "a test", "file": "configs/tiny.json",
                                "reduced": [], "why": "a test"})
    spec_doc["workloads"].append({"name": "tiny.remove_lanes", "config": "tiny",
                                  "traffic": "remove_lanes", "chips": 1, "why": "a test"})
    for m in spec_doc["end_to_end"] + spec_doc["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.remove_lanes")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec_doc))
    return tmp


def run_cpu(root: Path, workload: str, seed: int = 7, seconds: float = 1.0, trace: bool = False,
            bench_dir: Path = spec.BENCH_DIR):
    """Run a cell on the CPU past the look for a card: (exit code, result
    dict, standard error)."""
    import io
    cell = spec.load_cell(root, workload, bench_dir=bench_dir)
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run(cell, seed, seconds, trace, "cpu", time.monotonic(), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
