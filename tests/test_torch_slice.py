"""The whole slice: the port's propose path against the JAX package's.

The same random cluster goes through both GoalOptimizers with the slice
stack.  Placements are not expected to be identical (the jitter hash and the
order of float sums differ), so the port's final placement is judged by the
JAX package's own verifier, its violated-goal count must be no higher than
JAX's, and its proposals must equal the JAX diff of the same two placements.
Both start from the same arrays, so they agree on which goals the initial
placement violates.
"""

import io
import json

import jax.numpy as jnp
import pytest

from cruise_control_tpu.analyzer import relax as jrelax
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer.proposals import diff_proposals as jdiff
from cruise_control_tpu.model.state import Placement as JPlacement
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu.testing.verifier import verify_placement
from cruise_control_tpu_torch.analyzer.goals.registry import (
    DEFAULT_GOALS,
    SUPPORTED_GOALS,
    goal_by_name,
)
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.client.propose import parse_args, run_propose
from cruise_control_tpu_torch.common.exceptions import OptimizationFailureError
from cruise_control_tpu_torch.model.snapshot import save_npz
from cruise_control_tpu_torch.testing import random_cluster as trc

PROPS = dict(num_brokers=20, num_racks=5, num_topics=50, num_replicas=2000,
             mean_cpu=0.005, mean_disk=2100.0, mean_nw_in=2000.0,
             mean_nw_out=2000.0, seed=11)
HARD = {"RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
        "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal", "CpuCapacityGoal"}


@pytest.fixture(scope="module")
def solved():
    js, jp, jm = jrc.generate(jrc.ClusterProperties(**PROPS))
    # The reference is the JAX package's greedy solve.  Its relaxation switch
    # is process-wide, and a test that boots the service may leave it on.
    was_on = jrelax.relaxation_enabled()
    jrelax.set_relaxation(False)
    try:
        jres = JOptimizer(goal_names=DEFAULT_GOALS).optimizations(js, jp, jm)
    finally:
        jrelax.set_relaxation(was_on)
    ts, tp, tm = trc.generate(trc.ClusterProperties(**PROPS), device="cpu")
    tres = GoalOptimizer().optimizations(ts, tp, tm)
    return (js, jp, jm, jres), (ts, tp, tm, tres)


@pytest.fixture(scope="module")
def snapshot_path(tmp_path_factory):
    ts, tp, tm = trc.generate(trc.ClusterProperties(**PROPS), device="cpu")
    path = str(tmp_path_factory.mktemp("snap") / "snap.npz")
    save_npz(path, ts, tp, tm)
    return path


def _jax_placement(p):
    return JPlacement(broker=jnp.asarray(p.broker.numpy()), disk=jnp.asarray(p.disk.numpy()),
                      is_leader=jnp.asarray(p.is_leader.numpy()))


def _propose(path, *extra):
    out = io.StringIO()
    rc = run_propose(parse_args(["--snapshot", path, "--device", "cpu", "--verbose",
                                 *extra]), out)
    assert rc == 0
    doc = json.loads(out.getvalue())
    for p in doc["proposals"]:
        assert set(p) == {"topicPartition", "oldLeader", "oldReplicas", "newReplicas"}
        assert len(set(p["newReplicas"])) == len(p["newReplicas"]) == len(p["oldReplicas"])
        assert p["oldLeader"] in p["oldReplicas"]
    return doc


def test_slice_stack_is_the_default_hard_and_count_goals():
    assert set(DEFAULT_GOALS) == HARD | {"ReplicaDistributionGoal",
                                         "TopicReplicaDistributionGoal",
                                         "LeaderReplicaDistributionGoal"}


def test_port_placement_passes_jax_verifier(solved):
    (js, jp, jm, jres), (_, _, _, tres) = solved
    assert tres.violated_goals_before, "fixture must start unbalanced"
    failures = verify_placement(js, jp, jm, _jax_placement(tres.final_placement),
                                goal_names=DEFAULT_GOALS, goal_infos=tres.goal_infos)
    assert failures == []
    assert len(tres.violated_goals_after) <= len(jres.violated_goals_after)
    assert tres.balancedness_score >= jres.balancedness_score
    assert not set(tres.violated_goals_after) & HARD


@pytest.mark.parametrize("goal", DEFAULT_GOALS)
def test_goal_violated_before_the_stack_matches_jax(solved, goal):
    """Judged on the initial placement, before any goal moved a replica."""
    (_, _, _, jres), (_, _, _, tres) = solved
    assert (goal in tres.violated_goals_before) == (goal in jres.violated_goals_before)


@pytest.mark.parametrize("dead", [(3,), (4, 17)])
def test_dead_brokers_evacuated_per_jax_verifier(dead):
    """Replicas on dead brokers all leave, with every hard goal still met."""
    props = dict(PROPS, dead_broker_ids=dead)
    js, jp, jm = jrc.generate(jrc.ClusterProperties(**props))
    ts, tp, tm = trc.generate(trc.ClusterProperties(**props), device="cpu")
    assert bool(ts.offline.any())
    tres = GoalOptimizer().optimizations(ts, tp, tm)
    failures = verify_placement(js, jp, jm, _jax_placement(tres.final_placement),
                                goal_names=DEFAULT_GOALS,
                                verifications=("GOAL_VIOLATION", "DEAD_BROKERS"))
    assert failures == []
    assert not set(tres.violated_goals_after) & HARD


def test_infeasible_evacuation_raises():
    """Three dead brokers of twenty leave too little disk: the solve fails
    loudly instead of returning a placement that breaks DiskCapacityGoal."""
    ts, tp, tm = trc.generate(trc.ClusterProperties(**PROPS, dead_broker_ids=(0, 9, 18)),
                              device="cpu")
    with pytest.raises(OptimizationFailureError, match="DiskCapacityGoal"):
        GoalOptimizer().optimizations(ts, tp, tm)


def test_proposals_equal_jax_diff_of_same_placements(solved):
    (js, jp, jm, _), (_, tp, _, tres) = solved
    want = jdiff(js, jp, _jax_placement(tres.final_placement), jm)
    got = tres.proposals
    assert len(got) > 0
    assert [p.to_dict() for p in got] == [p.to_dict() for p in want]
    assert [p.partition_size for p in got] == [p.partition_size for p in want]


def test_run_propose_emits_proposal_json(snapshot_path):
    doc = _propose(snapshot_path)
    assert doc["proposals"] and doc["elapsedSeconds"] > 0
    summary = doc["summary"]
    assert [g["goal"] for g in summary["goals"]] == DEFAULT_GOALS
    assert not set(summary["violatedGoalsAfter"]) & HARD
    assert summary["numInterBrokerReplicaMovements"] > 0


@pytest.mark.parametrize("goal", SUPPORTED_GOALS)
def test_run_propose_each_goal_alone(snapshot_path, goal):
    """``--goals`` with one goal, by its fully-qualified reference name: the
    stack is that goal alone, and a hard goal ends satisfied."""
    doc = _propose(snapshot_path, "--goals",
                   f"com.linkedin.kafka.cruisecontrol.analyzer.goals.{goal}")
    summary = doc["summary"]
    assert [g["goal"] for g in summary["goals"]] == [goal]
    if goal_by_name(goal).is_hard:
        assert goal not in summary["violatedGoalsAfter"]


def test_run_propose_rejects_other_formats(tmp_path, capsys):
    assert run_propose(parse_args(["--snapshot", str(tmp_path / "x.json"),
                                   "--device", "cpu"])) == 1
    assert "npz" in capsys.readouterr().err


def test_run_propose_rejects_unported_goal(snapshot_path):
    with pytest.raises(ValueError, match="not yet ported"):
        _propose(snapshot_path, "--goals", "DiskUsageDistributionGoal")
