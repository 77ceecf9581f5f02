"""``BENCHMARK.json`` keeps to the contract's characters and shapes, names
only files that exist, and a configuration, a traffic mix and a per-layer
metric added as files and entries alone are found by name."""

import json
import re
import shutil

import pytest

from ccbench.harness import spec
from ccbench.tests import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_names_units_and_lines():
    doc = helpers.benchmark()
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len(json.dumps(doc)) < 64 * 1024
    assert 1 <= doc["run_seconds"] <= 51 and isinstance(doc["run_seconds"], int)
    for p in doc["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert all(LINE.match(w) for w in doc["command"]) and len(doc["command"]) <= 32
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(doc["paths"][0] + "/")
    pairs = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in doc["workloads"]}
    for m in doc["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in doc["end_to_end"]}
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    names = [x["name"] for x in doc["configs"] + doc["workloads"]] + \
        [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in doc["end_to_end"])


def test_every_cell_loads_with_its_files():
    doc = helpers.benchmark()
    for w in doc["workloads"]:
        cell = spec.load_cell(helpers.REPO, w["name"])
        e2e = {m.name for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m.entry["moves"] in e2e
        assert callable(spec.kind_module(cell).Workload)
        assert set(spec.readers(cell)) == {m.name for m in cell.per_layer}
    for c in doc["configs"]:
        cfg = json.loads((helpers.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_added_files_are_found_by_name(tmp_path):
    """A new configuration, traffic mix and per-layer metric, as new files and
    new entries only, in a copy of the benchmark's directory."""
    bench = tmp_path / "ccbench"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    root = helpers.tiny_root(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs/tiny.json").read_text())
    cfg["name"] = "tiny2"
    cfg["cluster"]["num_racks"] = 8
    (bench / "configs/tiny2.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic/remove_lanes.json").read_text())
    mix["lanes_per_request"] = 2
    (bench / "traffic/remove_pairs.json").write_text(json.dumps(mix))
    (bench / "metrics/lanes_a_request.whatif.py").write_text(
        "def read(run):\n"
        "    return sum(r['lanes'] for r in run.requests) / len(run.requests)\n")
    doc["configs"].append({"name": "tiny2", "source": "a test", "why": "a test",
                           "file": "ccbench/configs/tiny2.json", "reduced": []})
    doc["workloads"].append({"name": "tiny2.remove_pairs", "config": "tiny2",
                             "traffic": "remove_pairs", "chips": 1, "why": "a test"})
    doc["per_layer"].append({"name": "lanes_a_request.whatif", "unit": "lanes",
                             "better": "higher", "source": "program_counter",
                             "layer": "analyzer/optimizer.py", "moves": "whatif_lanes_per_s",
                             "workloads": ["tiny2.remove_pairs"]})
    for m in doc["end_to_end"]:
        if m["name"].startswith("whatif_"):
            m["workloads"].append("tiny2.remove_pairs")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = spec.load_cell(root, "tiny2.remove_pairs", bench_dir=bench)
    assert cell.config["cluster"]["num_racks"] == 8
    assert cell.traffic["lanes_per_request"] == 2
    assert [m.name for m in cell.per_layer][-1] == "lanes_a_request.whatif"
    rc, result, err = helpers.run_cpu(root, "tiny2.remove_pairs", trace=True, bench_dir=bench)
    assert rc == 0 and result["correct"], err[-2000:]
    assert result["metrics"]["lanes_a_request.whatif"]["value"] == 2.0


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell(helpers.REPO, "no_such.cell")
