"""Whole runs on the CPU past the look for a card: the result line, the
modules a run loads, the exit without a card, and the trace's arithmetic.
The one test that needs the card runs a cell there."""

import json
import os
import subprocess
import sys

import pytest

from ccbench.harness import runner, trace
from ccbench.tests import helpers

FORBIDDEN = ("jax", "jaxlib", "flax", "cruise_control_tpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return helpers.tiny_root(tmp_path_factory.mktemp("bench"))


def test_a_sound_run_is_correct(root):
    rc, result, err = helpers.run_cpu(root, "tiny.remove_lanes", seed=2 ** 31 + 7)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 3
    assert list(result)[-1] == "checks"
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in last)


def test_a_traced_run_reports_per_layer_metrics(root):
    rc, result, err = helpers.run_cpu(root, "tiny.remove_lanes", trace=True)
    assert rc == 0 and result["correct"], err[-3000:]
    got = set(result["metrics"])
    assert got == {"solver_rounds.whatif"}
    # No card: the device metrics stay out rather than read 0 or 100.
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_run_loads_no_jax_and_the_reference_no_port(tmp_path, root):
    code = (
        "import sys, json\n"
        "from pathlib import Path\n"
        "import ccbench.reference.checks, ccbench.harness.cluster\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0].startswith('cruise_control'))\n"
        "from ccbench.tests import helpers\n"
        f"rc, result, err = helpers.run_cpu(Path({str(root)!r}), 'tiny.remove_lanes')\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'ref': ref, 'tops': tops, 'correct': result['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=helpers.REPO, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(helpers.REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ref"] == []
    assert got["correct"] is True
    assert "cruise_control_tpu_torch" in got["tops"]
    assert not set(got["tops"]) & set(FORBIDDEN)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cruise_control_tpu_torch_extra", object())
    assert "cruise_control_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in runner.forbidden_modules()


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "ccbench/run.py", "--workload",
                          "randomcluster_40b_50k.remove_lanes", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=helpers.REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    import shutil
    shutil.copy(helpers.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(helpers.REPO / "ccbench", tmp_path / "ccbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "ccbench/run.py", "--workload",
                          "randomcluster_40b_50k.remove_lanes", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_trace_union_and_gap_names():
    device = [(10, 20, "k1"), (15, 30, "k2"), (50, 60, "k1"), (95, 120, "k3")]
    host = [(0, 100, trace.REQUEST_SPAN), (30, 45, "aten::nonzero"),
            (31, 44, "cudaStreamSynchronize"), (61, 90, "aten::index")]
    s = trace.summarize(device, host, (0, 100), requests=1)
    assert s.busy_s == pytest.approx(35e-9)
    assert s.idle_pct == pytest.approx(65.0)
    assert s.device_ops == 4
    assert s.kernel_times("k1") == (pytest.approx(20e-9), 2)
    assert s.idle_by_host_op == pytest.approx({trace.REQUEST_SPAN: 10e-9,
                                               "aten::nonzero > cudaStreamSynchronize": 20e-9,
                                               "aten::index": 35e-9})
    assert s.top_idle(1) == [["aten::index", pytest.approx(35e-9)]]


@pytest.mark.cuda
def test_a_cell_on_the_card(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs the hand-written aggregate kernel")
    out = subprocess.run([sys.executable, "ccbench/run.py", "--workload",
                          "randomcluster_40b_50k.remove_lanes", "--seed", "5", "--seconds", "3",
                          "--trace", "1"], cwd=helpers.REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["aggregate_roofline_pct.whatif"]["value"] <= 100
