"""Why each goal solve of the port ended, and what it applied: the
``goal.<Goal>`` spans' ``hard``, ``end``, ``swaps`` and ``leader_moves``
attributes, the ``Solver.goal-end.*`` counters (one count a solve), the loop
condition's reasons, and ``Solver.round-graph.evictions``.  CPU only, on a
tiny cluster; nothing here runs the JAX package."""

import gc
from types import SimpleNamespace

import pytest
import torch

from cruise_control_tpu_torch.analyzer import solver as tsolver
from cruise_control_tpu_torch.analyzer.budget import SolveBudget
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.obsvc.tracer import tracer
from cruise_control_tpu_torch.testing.random_cluster import ClusterProperties, generate

PROPS = dict(num_brokers=12, num_racks=4, num_topics=10, num_replicas=300, mean_cpu=0.006,
             seed=5)
# A hard goal, a count goal, a resource goal with swap and leadership
# phases, and a leadership goal.
GOALS = ["RackAwareGoal", "ReplicaDistributionGoal", "NetworkOutboundUsageDistributionGoal",
         "LeaderReplicaDistributionGoal"]
ATTRS = ("hard", "end", "swaps", "leader_moves")


def _counts(names):
    return [registry().counter(n).count for n in names]


def _walk(tree):
    yield tree
    for child in tree.get("children", ()):
        yield from _walk(child)


def test_goal_spans_say_how_each_solve_ended():
    st, pl, mt = generate(ClusterProperties(**PROPS), device="cpu")
    opt = GoalOptimizer(constraint=BalancingConstraint(max_candidates_per_round=128),
                        goal_names=GOALS)
    tr = tracer()
    was = tr.enabled
    tr.configure(enabled=True, ring_size=32)
    tr.reset()
    before = _counts(tsolver.GOAL_END_SENSORS)
    gc.disable()
    try:
        res = opt.optimizations(st, pl, mt)
        tree = tr.traces()[-1]
    finally:
        gc.enable()
        tr.configure(enabled=was, ring_size=32)
        tr.reset()
    ends = dict(zip(tsolver.GOAL_ENDS, (a - b for a, b in zip(
        _counts(tsolver.GOAL_END_SENSORS), before))))
    spans = list(_walk(tree))
    goals = [s for s in spans if s["name"].startswith("goal.")]
    polished = {s["name"].split(".", 1)[1] for s in spans if s["name"].startswith("polish.")}
    # One count a solve: every goal and polish solve opens one solve.enter.
    assert sum(ends.values()) == sum(s["name"] == "solve.enter" for s in spans) >= len(GOALS)
    assert [s["name"] for s in goals] == [f"goal.{g}" for g in GOALS]
    for span, info in zip(goals, res.goal_infos):
        a = span["attrs"]
        name = info.goal_name
        assert set(ATTRS) <= set(a), name
        assert a["hard"] is goal_by_name(name).is_hard
        assert a["end"] in tsolver.GOAL_ENDS and ends[a["end"]] >= 1
        assert 0 <= a["swaps"] + a["leader_moves"] <= a["moves"]
        if a["rounds"] == 0:
            assert (a["end"], a["moves"]) == ("satisfied", 0)
        if not goal_by_name(name).has_swap_phase:
            assert a["swaps"] == 0
        if not goal_by_name(name).uses_leadership_moves:
            assert a["leader_moves"] == 0
        if name not in polished:
            assert (a["swaps"], a["leader_moves"], a["end"]) == \
                (info.swaps_applied, info.leader_moves_applied, info.end)
    assert any(s["attrs"]["swaps"] > 0 for s in goals)
    assert any(s["attrs"]["leader_moves"] > 0 for s in goals)


def _cond(violated, stranded, applied, stall):
    return torch.tensor([violated, stranded, applied, stall], dtype=torch.int64)


def _cancelled():
    b = SolveBudget(segmented=True)
    b.cancel("user")
    return b


@pytest.mark.parametrize("rounds,cond,hard,budget,want", [
    (0, (0, 0, 1, 0), False, None, (False, None, "satisfied")),
    (3, (2, 0, 0, 0), True, None, (False, None, "no_move")),
    (3, (2, 0, 5, 8), False, None, (False, None, "stalled")),
    (3, (2, 0, 5, 8), True, None, (True, None, None)),
    (96, (2, 0, 5, 0), False, None, (False, None, "round_cap")),
    (8, (2, 0, 5, 0), False, "cancelled", (False, "user", "budget")),
])
def test_the_loop_condition_names_why_it_stops(rounds, cond, hard, budget, want):
    """``_go_on``'s verdict for each reason; the stall cutoff holds soft
    goals only."""
    solver = tsolver.GoalSolver()
    got = solver._go_on(SimpleNamespace(shard=None), rounds, not hard,
                        _cancelled() if budget else None, _cond(*cond))
    assert got == want


def test_round_graph_evictions_count_lru_drops():
    """A key past ``ROUND_GRAPH_SLOTS`` drops the least recently used entry
    and counts it; an entry a solve holds is kept."""
    solver = tsolver.GoalSolver()
    name = tsolver.GRAPH_EVICTIONS_SENSOR
    slots = tsolver.ROUND_GRAPH_SLOTS
    before = registry().counter(name).count
    for k in range(slots):
        assert solver._hold_graph(("key", k)) == (None, "first")
    assert registry().counter(name).count == before
    held, why = solver._hold_graph(("key", 0))
    assert held is not None and why is None
    solver._hold_graph(("key", slots))
    solver._hold_graph(("key", slots + 1))
    assert registry().counter(name).count == before + 2
    assert len(solver._graphs) == slots
    assert ("key", 0) in solver._graphs and ("key", 1) not in solver._graphs
    held.lock.release()
