"""The per-layer metrics that read the program's spans: their arithmetic on a
hand-built span tree, their silence without the trees or without the card,
and a traced run on the CPU in a copy of the benchmark that finds them by
name and reads the spans the program recorded under the profiler."""

import json
import math
import shutil
from types import SimpleNamespace

import pytest

from cruise_control_tpu_torch.obsvc.tracer import tracer
from ccbench.harness import runner, spec, spans
from ccbench.tests import helpers

READERS = ("lane_setup_pct.whatif", "goal_fixed_pct.whatif", "round_ms.whatif")


def _span(name, wall_ms, *children, **attrs):
    d = {"name": name, "wall_ms": wall_ms}
    if attrs:
        d["attrs"] = attrs
    if children:
        d["children"] = list(children)
    return d


def _goal(lane, enter, rounds, exit_):
    return _span("goal.RackAwareGoal", enter + sum(rounds) + exit_ + 0.1,
                 _span("solve.enter", enter),
                 *[_span("solve.round", r, _span("phase.replica", r - 0.5),
                         _span("round.stats", 0.4), round=i) for i, r in enumerate(rounds)],
                 _span("solve.exit", exit_), lane=lane, rounds=len(rounds))


def _request(wall, setup, plan, context, goals):
    return _span("batch_optimize", wall, _span("lanes.setup", setup),
                 _span("lanes.plan", plan),
                 _span("lanes.block", wall - setup - plan - 1.0, _span("lanes.context", context),
                       *goals),
                 _span("lanes.result", 0.5), lanes=len(goals))


TREES = [
    _request(100.0, 4.0, 1.0, 5.0, [_goal(0, 2.0, [6.0, 4.0], 3.0), _goal(1, 1.0, [], 1.5)]),
    _request(50.0, 2.0, 0.5, 2.5, [_goal(0, 1.0, [5.0], 1.0)]),
]


def _run(device_ops=10, requests=2):
    trace = SimpleNamespace(device_ops=device_ops, requests=requests)
    return runner.RunRecord(requests=[], trace=trace, shapes={})


@pytest.fixture
def readers():
    cell = spec.load_cell(helpers.REPO, "randomcluster_40b_50k.remove_lanes")
    got = spec.readers(cell)
    assert set(READERS) <= set(got)
    return got


@pytest.fixture
def ring(monkeypatch):
    """The program's tracer ring, holding what a test puts in it."""
    held = []
    monkeypatch.setattr(tracer(), "traces", lambda: list(held))
    return held


def test_readers_arithmetic_on_a_hand_built_tree(readers, ring):
    ring.extend([_span("optimize", 999.0)] + TREES)
    run = _run()
    assert readers["lane_setup_pct.whatif"](run) == pytest.approx(
        100.0 * (4.0 + 1.0 + 5.0 + 2.0 + 0.5 + 2.5) / 150.0)
    assert readers["goal_fixed_pct.whatif"](run) == pytest.approx(
        100.0 * (2.0 + 3.0 + 1.0 + 1.5 + 1.0 + 1.0) / 150.0)
    assert readers["round_ms.whatif"](run) == pytest.approx((6.0 + 4.0 + 5.0) / 3)
    # Only the traced requests' roots count: the last ``requests`` of them.
    assert readers["round_ms.whatif"](_run(requests=1)) == pytest.approx(5.0)
    assert spans.roots(_run(requests=1)) == TREES[-1:]


@pytest.mark.parametrize("case", ["no roots", "other roots", "no device ops", "no trace"])
def test_readers_are_silent_without_spans_or_card(readers, ring, case):
    if case == "other roots":
        ring.append(_span("optimize", 5.0, _span("solve.round", 1.0)))
    elif case != "no roots":
        ring.extend(TREES)
    run = {"no device ops": _run(device_ops=0),
           "no trace": runner.RunRecord(requests=[], trace=None, shapes={})}.get(case, _run())
    for name in READERS:
        assert readers[name](run) is None, name


def test_a_traced_run_in_a_copy_reads_the_programs_spans(tmp_path, monkeypatch):
    """The readers are found by name in a copy of the benchmark, and read the
    spans the program records under the profiler with its tracing off.  The
    CPU has no card, so the trace is told it holds device operations."""
    bench = tmp_path / "ccbench"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    root = helpers.tiny_root(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    assert [m["name"] for m in doc["per_layer"]][-3:] == list(READERS)
    profile = runner.profile_requests

    def with_device_ops(*args, **kwargs):
        summary = profile(*args, **kwargs)
        summary.device_ops = max(summary.device_ops, 1)
        return summary

    monkeypatch.setattr(runner, "profile_requests", with_device_ops)
    tr = tracer()
    assert not tr.enabled
    tr.reset()
    try:
        rc, result, err = helpers.run_cpu(root, "tiny.remove_lanes", trace=True, bench_dir=bench)
    finally:
        tr.reset()
    assert rc == 0 and result["correct"], err[-3000:]
    got = {name: result["metrics"][name]["value"] for name in READERS}
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got
    assert got["lane_setup_pct.whatif"] + got["goal_fixed_pct.whatif"] <= 100.0
    assert [result["metrics"][n]["unit"] for n in READERS] == ["%", "%", "ms"]
