"""The add-broker kind (``kinds/add_lanes.py``) on a small cluster of the
new configuration's shape, 16 brokers and 4 provisioned ones, in a copy of
the benchmark: a sound whole run reads correct, five planted faults read
not correct, the reference's verdicts of the 15 goals agree with the port's
on seeded clusters with brokers added, and the three per-layer metrics of
the cell read the program's spans, or nothing where the spans lack what
they read."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import shutil

import numpy as np
import pytest

from ccbench.harness import cluster, program, runner, spec
from ccbench.kinds import add_lanes
from ccbench.reference import add_checks
from ccbench.reference import goals as rg
from ccbench.tests import helpers
from ccbench.tests.test_ccbench_spans import _run, _span

CELL = "tiny_new4.add_lanes"
CONFIG = "ccbench/configs/randomcluster_40b_50k_new8.json"
METRICS = ("soft_goal_pct.addlanes", "soft_actions_per_round.addlanes",
           "soft_stopped_short_pct.addlanes")
PROVISIONED = dict(broker_ids=[16, 17, 18, 19], racks=[1, 2, 3, 0],
                   capacity=dict(cpu=100.0, nw_in=300000.0, nw_out=200000.0, disk=300000.0),
                   disks=1, alive=False, replicas=0)
# The cell's mix at a size the CPU runs in seconds: two lanes a request
# cover the pool of four.
MIX = dict(kind="add_lanes", goals="default", lanes_per_request=2, brokers_per_lane=2,
           num_candidates=64, warmup_requests=1, trace_requests=1, check_requests=3)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A benchmark root with the tiny cells and ``tiny_new4.add_lanes``, and
    a copy of the benchmark's directory holding its traffic mix:
    (root, bench_dir)."""
    tmp = tmp_path_factory.mktemp("bench")
    bench = tmp / "ccbench"
    shutil.copytree(spec.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "traffic/tiny_add.json").write_text(json.dumps(MIX))
    root = helpers.tiny_root(tmp)
    cfg = copy.deepcopy(json.loads((helpers.REPO / CONFIG).read_text()))
    cfg["name"] = "tiny_new4"
    cfg["cluster"] = dict(cfg["cluster"], **helpers.TINY)
    cfg["provisioned"] = PROVISIONED
    (root / "configs/tiny_new4.json").write_text(json.dumps(cfg))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny_new4", "source": "a test", "why": "a test",
                           "file": "configs/tiny_new4.json", "reduced": []})
    doc["workloads"].append({"name": CELL, "config": "tiny_new4", "traffic": "tiny_add",
                             "chips": 1, "why": "a test"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "randomcluster_40b_50k_new8.add_lanes" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root, bench


def _run_cell(root, trace=False, seed=2 ** 31 + 11):
    return helpers.run_cpu(root[0], CELL, seed=seed, trace=trace, bench_dir=root[1])


# ------------------------------------------------------------ planted faults

@contextlib.contextmanager
def _patched_lanes(after):
    """``GoalOptimizer._run_lanes`` with ``after(self, out, gctx, seed,
    goals, alive_s, excl_move_s, excl_lead_s, n_real)`` applied to what it
    returns."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    run = GoalOptimizer._run_lanes

    def run_lanes(self, gctx, seed, goals, num_candidates, alive_s, excl_move_s, excl_lead_s,
                  budget, n_real):
        out = run(self, gctx, seed, goals, num_candidates, alive_s, excl_move_s, excl_lead_s,
                  budget, n_real)
        return after(self, out, gctx, seed, goals, alive_s, excl_move_s, excl_lead_s, n_real)

    GoalOptimizer._run_lanes = run_lanes
    try:
        yield
    finally:
        GoalOptimizer._run_lanes = run


def _seed_lanes():
    """Every lane returns its seed placement: the arrivals stay empty, and
    the program's counts are those of its solve."""
    def after(self, out, gctx, seed, goals, *rest):
        n = out[4].broker.shape[0]
        return out[:4] + (type(seed)(broker=seed.broker.expand(n, -1).clone(),
                                     disk=seed.disk.expand(n, -1).clone(),
                                     is_leader=seed.is_leader.expand(n, -1).clone()),)
    return _patched_lanes(after)


def _unadded_broker():
    """The first lane puts one replica on a provisioned broker it does not
    add."""
    def after(self, out, gctx, seed, goals, alive_s, *rest):
        dead = int((~alive_s[0] & gctx.state.broker_valid).nonzero()[0, 0])
        broker = out[4].broker.clone()
        broker[0, 0] = dead
        return out[:4] + (dataclasses.replace(out[4], broker=broker),)
    return _patched_lanes(after)


@contextlib.contextmanager
def _goals_only(pick):
    """The lanes solve only the goals ``pick(goals)`` (their indices), and report
    every other goal as unrun, with its violated brokers counted honestly on
    the lane's final placement: only the quality guards can tell."""
    import torch
    from cruise_control_tpu_torch.analyzer.context import compute_aggregates, scenario_context
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.model.state import Placement
    run = GoalOptimizer._run_lanes

    def run_lanes(self, gctx, seed, goals, num_candidates, alive_s, excl_move_s, excl_lead_s,
                  budget, n_real):
        picked = pick(goals)
        rounds, moves, violated, stranded, stacked = run(
            self, gctx, seed, [goals[k] for k in picked], num_candidates, alive_s, excl_move_s,
            excl_lead_s, budget, n_real)
        full = [np.zeros((n_real, len(goals)), np.int32) for _ in range(3)]
        for s in range(n_real):
            lctx = scenario_context(gctx, alive_s[s], excl_move_s[s], excl_lead_s[s])
            pl = Placement(broker=stacked.broker[s], disk=stacked.disk[s],
                           is_leader=stacked.is_leader[s])
            agg = compute_aggregates(lctx, pl)
            for k, g in enumerate(goals):
                if k in picked:
                    for a, b in zip(full, (rounds, moves, violated)):
                        a[s, k] = b[s, picked.index(k)]
                else:
                    full[2][s, k] = int(torch.as_tensor(g.violated_brokers(lctx, pl, agg)).sum())
        return (*full, stranded, stacked)

    GoalOptimizer._run_lanes = run_lanes
    try:
        yield
    finally:
        GoalOptimizer._run_lanes = run


def _hard_only():
    """The lanes solve the hard goals alone."""
    return _goals_only(lambda goals: [k for k, g in enumerate(goals) if g.is_hard])


def _to_cpu():
    """The lanes solve the goals up to CpuUsageDistributionGoal and skip the
    last three: TopicReplica, LeaderReplica and LeaderBytesIn."""
    return _goals_only(lambda goals: list(range(
        [g.name for g in goals].index("CpuUsageDistributionGoal") + 1)))


@contextlib.contextmanager
def _no_leadership():
    """Every solve skips its leadership phase: the goals that move only
    leaderships (LeaderBytesIn) apply nothing, and the others move replicas
    alone."""
    from cruise_control_tpu_torch.analyzer.solver import GoalSolver
    phases = GoalSolver._phases

    def without(self, goal, priors, c):
        return [(n, f) for n, f in phases(self, goal, priors, c) if n != "phase.leadership"]

    GoalSolver._phases = without
    try:
        yield
    finally:
        GoalSolver._phases = phases


PLANTS = {"seed_lanes": _seed_lanes, "unadded_broker": _unadded_broker,
          "hard_only": _hard_only, "to_cpu": _to_cpu, "no_leadership": _no_leadership}


# --------------------------------------------------------------------- runs

def test_a_sound_run_is_correct(root):
    rc, result, err = _run_cell(root)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True and result["failed"] == 0, err[-3000:]
    assert set(result["metrics"]) == {"whatif_lanes_per_s", "whatif_p90_s", "setup_s"}
    checks = result["checks"]
    assert set(checks) == {"wrong_lanes", "wrong_healthy", "count_mismatches", "sums_gap",
                           "unbalanced_lanes", *add_lanes.PER_LANE}
    limit = checks["unbalanced_lanes"]["limit"]
    judged = round(limit / add_lanes.UNBALANCED_SHARE)
    assert judged >= MIX["lanes_per_request"] * 2
    assert limit == pytest.approx(add_lanes.UNBALANCED_SHARE * judged)
    for number, per_lane in add_lanes.PER_LANE.items():
        assert checks[number]["limit"] == pytest.approx(per_lane * judged)
    assert "lanes leave a soft goal violated" in err


# The numbers each plant takes over their limits at this size.  On the card
# (PERF.md section 2) ``to_cpu`` takes ``spread_brokers`` over too.
QUALITY = {"unbalanced_lanes", *add_lanes.PER_LANE}


@pytest.mark.parametrize("plant,numbers", [
    ("seed_lanes", {"wrong_lanes"}), ("unadded_broker", {"wrong_lanes"}),
    ("hard_only", QUALITY), ("to_cpu", {"leader_bytes_in_brokers"}),
    ("no_leadership", {"leader_bytes_in_brokers"})])
def test_a_planted_fault_reads_not_correct(root, plant, numbers):
    with PLANTS[plant]():
        rc, result, err = _run_cell(root, seed=7)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, err[-3000:]
    checks = result["checks"]
    over = {n for n, c in checks.items() if c["value"] > c["limit"]}
    assert numbers <= over, checks
    if plant not in ("seed_lanes", "unadded_broker"):
        # Honest counts on valid placements: the quality guards alone fail.
        assert over <= QUALITY, checks


def test_a_traced_run_reads_the_soft_goal_spans(root, monkeypatch):
    """The three readers are found by name in the copy and read the spans
    the program records under the profiler.  The CPU has no card, so the
    trace is told it holds device operations."""
    from cruise_control_tpu_torch.obsvc.tracer import tracer
    profile = runner.profile_requests

    def with_device_ops(*args, **kwargs):
        summary = profile(*args, **kwargs)
        summary.device_ops = max(summary.device_ops, 1)
        return summary

    monkeypatch.setattr(runner, "profile_requests", with_device_ops)
    tracer().reset()
    try:
        rc, result, err = _run_cell(root, trace=True)
    finally:
        tracer().reset()
    assert rc == 0 and result["correct"], err[-3000:]
    got = {n: result["metrics"][n]["value"] for n in METRICS}
    assert all(math.isfinite(v) for v in got.values()), got
    assert 0 < got["soft_goal_pct.addlanes"] <= 100
    assert 0 <= got["soft_stopped_short_pct.addlanes"] <= 100
    assert got["soft_actions_per_round.addlanes"] > 0
    assert [result["metrics"][n]["unit"] for n in METRICS] == ["%", "actions", "%"]


# ------------------------------------------------------------------ readers

def _goal(name, wall, rounds, moves, **attrs):
    return _span(f"goal.{name}", wall, rounds=rounds, moves=moves, **attrs)


def _tree(goals, wall=100.0):
    return _span("batch_optimize", wall, _span("lanes.setup", 2.0),
                 _span("lanes.block", wall - 3.0, *goals), lanes=2)


@pytest.fixture
def readers():
    cell = spec.load_cell(helpers.REPO, "randomcluster_40b_50k_new8.add_lanes")
    got = spec.readers(cell)
    assert set(METRICS) <= set(got)
    return got


@pytest.fixture
def ring(monkeypatch):
    from cruise_control_tpu_torch.obsvc.tracer import tracer
    held = []
    monkeypatch.setattr(tracer(), "traces", lambda: list(held))
    return held


def test_readers_arithmetic_on_a_hand_built_tree(readers, ring):
    def attrs(hard, end, swaps, leads):
        return dict(hard=hard, end=end, swaps=swaps, leader_moves=leads)
    ring.append(_tree([_goal("RackAwareGoal", 5.0, 0, 0, **attrs(True, "satisfied", 0, 0)),
                       _goal("ReplicaDistributionGoal", 30.0, 4, 400,
                             **attrs(False, "satisfied", 0, 0)),
                       _goal("CpuUsageDistributionGoal", 20.0, 6, 90,
                             **attrs(False, "stalled", 30, 20)),
                       _goal("LeaderBytesInDistributionGoal", 10.0, 2, 10,
                             **attrs(False, "no_move", 0, 10))]))
    ring.append(_tree([_goal("ReplicaDistributionGoal", 15.0, 0, 0,
                             **attrs(False, "satisfied", 0, 0))], wall=50.0))
    run = _run()
    assert readers["soft_goal_pct.addlanes"](run) == pytest.approx(100.0 * 75.0 / 150.0)
    assert readers["soft_actions_per_round.addlanes"](run) == pytest.approx(500.0 / 12)
    assert readers["soft_stopped_short_pct.addlanes"](run) == pytest.approx(100.0 * 2 / 4)
    # Only the traced requests' roots count: the last ``requests`` of them.
    one = _run(requests=1)
    assert readers["soft_goal_pct.addlanes"](one) == pytest.approx(30.0)
    assert readers["soft_actions_per_round.addlanes"](one) is None     # no round ran
    assert readers["soft_stopped_short_pct.addlanes"](one) == 0.0


@pytest.mark.parametrize("case", ["parent spans", "no roots", "no device ops", "no trace"])
def test_readers_are_silent_without_the_new_attributes_or_card(readers, ring, case):
    """A program whose goal spans carry only ``rounds`` and ``moves`` (the
    parent's) gives none, and so does a run without roots or card."""
    if case != "no roots":
        ring.append(_tree([_goal("ReplicaDistributionGoal", 30.0, 4, 400),
                           _goal("RackAwareGoal", 5.0, 1, 3)]))
    run = {"no device ops": _run(device_ops=0),
           "no trace": runner.RunRecord(requests=[], trace=None, shapes={})}.get(case, _run())
    for name in METRICS:
        assert readers[name](run) is None, name


# ---------------------------------------------------------------- reference

def _port_counts(state, placement, meta, alive, names):
    import torch
    from cruise_control_tpu_torch.analyzer.context import (
        build_context, compute_aggregates, scenario_context)
    from cruise_control_tpu_torch.analyzer.goals.registry import get_goals_by_priority
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions

    gctx = build_context(state, placement, meta, program.constraint({}), OptimizationOptions())
    lctx = scenario_context(gctx, torch.as_tensor(alive), gctx.excluded_for_replica_move,
                            gctx.excluded_for_leadership)
    agg = compute_aggregates(lctx, placement)
    return {g.name: int(g.violated_brokers(lctx, placement, agg).sum())
            for g in get_goals_by_priority(names)}


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_reference_verdicts_agree_with_the_port_with_brokers_added(seed):
    """On a seeded cluster with four provisioned brokers, two of them added
    and one replica of every fourth partition moved onto them, each of the
    15 goals is broken
    for the reference where the port counts violated brokers, and every
    decided count agrees."""
    props = dict(num_brokers=20, num_racks=4, num_topics=30, num_replicas=900,
                 mean_cpu=0.006, mean_disk=90.0, mean_nw_in=90.0, mean_nw_out=90.0, seed=seed)
    block = dict(PROVISIONED, broker_ids=[20, 21, 22, 23])
    snap = add_lanes.provision(cluster.generate(props), block)
    packed = snap.packed
    rng = np.random.default_rng(seed)
    added = sorted(rng.choice([20, 21, 22, 23], 2, replace=False).tolist())
    broker = packed["assignment"].copy()
    cl = rg.Cluster(packed)
    parts = rng.choice(cl.num_partitions, cl.num_partitions // 4, replace=False)
    rows = cl.rows[parts, rng.integers(0, 3, parts.size)]
    broker[rows] = rng.choice(added, rows.size)
    pl = dict(broker=broker, is_leader=packed["is_leader"])
    alive = cl.alive.copy()
    alive[added] = True
    state, placement, meta = program.snapshot(dict(packed, assignment=broker),
                                              snap.meta_kwargs(), "cpu")
    port = _port_counts(state, placement, meta, alive, rg.DEFAULT_GOALS)
    agg = rg.aggregate(cl, packed["leader_load"], packed["follower_load"], broker,
                       packed["is_leader"], alive=alive)
    ref = rg.verdicts(cl, agg, pl, rg.DEFAULT_GOALS, rg.Constraint())
    decided = 0
    for name, (state_, n) in ref.items():
        if state_ == rg.UNDECIDED:
            continue
        decided += 1
        assert (state_ == rg.VIOLATED) == (port[name] > 0), name
        assert n == port[name], name
    assert decided >= 12
    # The lane's judgement finds what the reference found, and no fault in
    # the port's own counts of the placement as the last goal's.
    answer = dict(broker=broker, is_leader=packed["is_leader"], sums=None,
                  succeeded=not any(port.values()), violated=port)
    j = add_checks.judge_add_lane(cl, packed, added, rg.DEFAULT_GOALS, rg.Constraint(), answer)
    broken_hard = [n for n in rg.HARD_GOALS if ref[n][0] == rg.VIOLATED]
    assert j.wrong == bool(broken_hard), j.faults
    assert j.unbalanced == any(ref[n][0] == rg.VIOLATED for n in rg.DEFAULT_GOALS
                               if not rg.GOALS[n].hard)


def test_provision_appends_dead_empty_brokers():
    snap = cluster.generate(helpers.TINY)
    got = add_lanes.provision(snap, PROVISIONED)
    p = got.packed
    assert got.num_brokers == 20 and got.num_replicas == snap.num_replicas
    assert got.broker_ids == list(range(20)) and got.hosts[16:] == ["h16", "h17", "h18", "h19"]
    assert not p["alive"][16:].any() and p["alive"][:16].all() and p["new_broker"][16:].all()
    assert p["rack"][16:].tolist() == [1, 2, 3, 0]
    assert len(set(p["host"].tolist())) == 20
    assert np.array_equal(p["capacity"][16:], np.tile(p["capacity"][0], (4, 1)))
    assert (p["assignment"] < 16).all()
    for key in ("leader_load", "partition", "assignment", "is_leader"):
        assert p[key] is snap.packed[key]
    with pytest.raises(ValueError):
        add_lanes.provision(snap, dict(PROVISIONED, broker_ids=[17, 18, 19, 20]))
    with pytest.raises(ValueError):
        add_lanes.provision(snap, dict(PROVISIONED, racks=[1, 2, 3, 4]))
