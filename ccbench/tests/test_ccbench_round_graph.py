"""``round_graph_pct.whatif``, the share of solver rounds that replayed their
round's CUDA graph: its arithmetic on hand-built span trees of replayed,
eager and mixed rounds, its silence without the trees, without the card or
without the ``graph`` attribute, and a traced run on the CPU in a copy of the
benchmark, where every round runs eagerly."""

import json
import shutil

import pytest

from cruise_control_tpu_torch.obsvc.tracer import tracer
from ccbench.harness import runner, spec
from ccbench.tests import helpers
from ccbench.tests.test_ccbench_spans import _request, _run, _span

NAME = "round_graph_pct.whatif"


def _goal(lane, rounds, how):
    """A goal solve whose rounds took ``rounds`` ms, each run as ``how``
    says (its ``graph`` attribute; none where ``how`` is None)."""
    marks = [{} if how is None else {"graph": h} for h in (how or rounds)]
    return _span("goal.RackAwareGoal", 2.0 + sum(rounds),
                 _span("solve.enter", 1.0),
                 *[_span("solve.round", r, round=i, **m)
                   for i, (r, m) in enumerate(zip(rounds, marks))],
                 _span("solve.exit", 0.9), lane=lane, rounds=len(rounds))


@pytest.fixture
def read():
    cell = spec.load_cell(helpers.REPO, "randomcluster_40b_50k.remove_lanes")
    return spec.readers(cell)[NAME]


@pytest.fixture
def ring(monkeypatch):
    """The program's tracer ring, holding what a test puts in it."""
    held = []
    monkeypatch.setattr(tracer(), "traces", lambda: list(held))
    return held


def test_share_over_the_traced_requests_rounds(read, ring):
    ring.extend([_span("optimize", 99.0),
                 _request(100.0, 4.0, 1.0, 5.0, [_goal(0, [6.0, 4.0], ["capture", "replay"]),
                                                 _goal(1, [], None)]),
                 _request(50.0, 2.0, 0.5, 2.5, [_goal(0, [5.0], ["replay"])])])
    assert read(_run()) == pytest.approx(100.0 * 2 / 3)
    # Only the traced requests' roots count: the last ``requests`` of them.
    assert read(_run(requests=1)) == pytest.approx(100.0)


@pytest.mark.parametrize("how,want", [
    (["replay", "replay", "replay"], 100.0),
    (["eager:cpu", "eager:cpu", "eager:cpu"], 0.0),
    (["capture", "replay", "eager:busy"], 100.0 / 3),
    (["eager:first", "replay", "replay"], 200.0 / 3),
    (None, None)])
def test_replayed_eager_and_mixed_rounds(read, ring, how, want):
    """Rounds with no ``graph`` attribute (a program without round graphs)
    give none."""
    ring.append(_request(40.0, 1.0, 0.5, 1.0, [_goal(0, [3.0, 2.0], how and how[:2]),
                                              _goal(1, [4.0], how and how[2:])]))
    got = read(_run(requests=1))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("case", ["no roots", "other roots", "no device ops", "no trace",
                                  "no rounds"])
def test_silent_without_spans_card_or_rounds(read, ring, case):
    if case == "other roots":
        ring.append(_span("optimize", 5.0, _span("solve.round", 1.0, graph="replay")))
    elif case == "no rounds":
        ring.append(_request(40.0, 1.0, 0.5, 1.0, [_goal(0, [], None)]))
    elif case != "no roots":
        ring.append(_request(40.0, 1.0, 0.5, 1.0, [_goal(0, [3.0], ["replay"])]))
    run = {"no device ops": _run(device_ops=0),
           "no trace": runner.RunRecord(requests=[], trace=None, shapes={})}.get(case, _run())
    assert read(run) is None


def test_a_traced_run_in_a_copy_reads_no_replays_on_the_cpu(tmp_path, monkeypatch):
    """The reader is found by name in a copy of the benchmark and reads the
    ``graph`` attribute the program records: the CPU runs every round
    eagerly, so no round replays a graph.  The CPU has no card, so the trace
    is told it holds device operations."""
    bench = tmp_path / "ccbench"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    root = helpers.tiny_root(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    assert doc["per_layer"][-1]["name"] == NAME
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
    got = result["metrics"][NAME]
    assert (got["value"], got["unit"]) == (0.0, "%")
