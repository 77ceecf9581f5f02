"""What-if lanes (remove and add brokers): the port against the JAX
package, and each lane against the port's own sequential solve.

With destination jitter off on both sides, a lane's per-goal outcome
(stranded replicas, violated brokers, success) must equal the JAX lane's
exactly; on these two fixtures its rounds, moves and placement do too.  With jitter on, the JAX package's ``hash01`` draws differ from
the port's for some ids, so each lane is held, bit for bit, to the port's
sequential solve of its scenario instead: a state with the lane's liveness
and exclusions, solved goal by goal by ``optimize_goal`` at the lane width.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import relax as jrelax
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer.solver import GoalSolver as JSolver
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer.budget import SolveBudget
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
from cruise_control_tpu_torch.analyzer.goals.registry import get_goals_by_priority
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.analyzer.solver import GoalSolver
from cruise_control_tpu_torch.testing import random_cluster as trc

# tests/test_analyzer.py::test_batch_remove_scenarios and ::test_batch_add_scenarios.
REMOVE = dict(props=dict(num_brokers=8, num_racks=4, num_topics=12, num_replicas=256,
                         seed=11),
              goals=["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
                     "ReplicaDistributionGoal"],
              sets=[[0], [1], [2], [3]])
ADD = dict(props=dict(REMOVE["props"], seed=13),
           goals=["RackAwareGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal"],
           sets=[[6], [7], [6, 7]], candidates=[6, 7])
WIDTH = 64


def _add_base(opt, state, placement, meta, provision_dead):
    """The add fixture's base: the candidates' replicas re-homed by a remove
    lane, then the candidates provisioned dead."""
    base = opt.batch_remove_scenarios(state, placement, meta, [ADD["candidates"]],
                                      num_candidates=WIDTH)
    assert int(base.stranded_after[0]) == 0
    return provision_dead(state), base.placement_for(0)


def _jax_dead(state):
    alive = np.asarray(state.alive).copy()
    alive[ADD["candidates"]] = False
    return state.replace(alive=jnp.asarray(alive))


def _port_dead(state):
    alive = state.alive.clone()
    alive[ADD["candidates"]] = False
    return dataclasses.replace(state, alive=alive)


def _run(kind, port, jitter):
    spec = REMOVE if kind == "remove" else ADD
    if port:
        st, pl, mt = trc.generate(trc.ClusterProperties(**spec["props"]), device="cpu")
        opt = GoalOptimizer(goal_names=spec["goals"],
                            solver=GoalSolver(dst_jitter_frac=jitter))
        dead = _port_dead
    else:
        st, pl, mt = jrc.generate(jrc.ClusterProperties(**spec["props"]))
        opt = JOptimizer(goal_names=spec["goals"], solver=JSolver(dst_jitter_frac=jitter))
        dead = _jax_dead
    if kind == "remove":
        return st, pl, mt, opt.batch_remove_scenarios(st, pl, mt, spec["sets"],
                                                      num_candidates=WIDTH)
    st, pl = _add_base(opt, st, pl, mt, dead)
    return st, pl, mt, opt.batch_add_scenarios(st, pl, mt, spec["sets"],
                                               num_candidates=WIDTH)


@pytest.fixture(scope="module")
def jax_lanes():
    """The JAX package's lanes with jitter off, both fixtures.  Its
    relaxation switch is process-wide, and a test that boots the service
    may leave it on."""
    was_on = jrelax.relaxation_enabled()
    jrelax.set_relaxation(False)
    try:
        return {kind: _run(kind, port=False, jitter=0.0)[3] for kind in ("remove", "add")}
    finally:
        jrelax.set_relaxation(was_on)


def _invariants(kind, state, res):
    spec = REMOVE if kind == "remove" else ADD
    valid = state.valid.numpy()
    for s, ids in enumerate(spec["sets"]):
        brokers = res.placement_for(s).broker.numpy()[valid]
        if kind == "remove":
            assert int(res.stranded_after[s]) == 0, (s, res.stranded_after)
            assert not np.isin(brokers, ids).any(), f"lane {s}: {ids} not evacuated"
        else:
            for bid in ids:
                assert (brokers == bid).any(), f"lane {s}: broker {bid} got nothing"
            for bid in set(spec["candidates"]) - set(ids):
                assert (brokers != bid).all(), f"lane {s}: dead candidate {bid} used"


@pytest.mark.parametrize("kind", ["remove", "add"])
def test_lanes_match_jax_with_jitter_off(jax_lanes, kind):
    state, _, _, res = _run(kind, port=True, jitter=0.0)
    ref = jax_lanes[kind]
    assert res.goal_names == ref.goal_names
    assert res.stranded_after.tolist() == np.asarray(ref.stranded_after).tolist()
    assert res.violated_after.tolist() == np.asarray(ref.violated_after).tolist()
    assert [res.succeeded(s) for s in range(res.num_scenarios)] == \
        [ref.succeeded(s) for s in range(ref.num_scenarios)]
    assert [res.quality(s) for s in range(res.num_scenarios)] == \
        [ref.quality(s) for s in range(ref.num_scenarios)]
    assert res.rounds.shape == (len(res.scenario_sets), len(res.goal_names))
    assert not res.preempted and not res.memory_refused
    _invariants(kind, state, res)
    # On these fixtures the lanes keep the same moves as JAX's, too.
    assert res.rounds.tolist() == np.asarray(ref.rounds).tolist()
    assert res.moves.tolist() == np.asarray(ref.moves).tolist()
    for s in range(res.num_scenarios):
        for f in ("broker", "disk", "is_leader"):
            assert np.array_equal(getattr(res.placement_for(s), f).numpy(),
                                  np.asarray(getattr(ref.placement_for(s), f))), (s, f)


@pytest.mark.parametrize("kind", ["remove", "add"])
def test_each_lane_is_its_sequential_solve(kind):
    """Jitter on: every lane equals, bit for bit, the sequential solve of its
    scenario from a context built afresh (liveness in the state, the
    exclusions as options, host capacity from build_context)."""
    spec = REMOVE if kind == "remove" else ADD
    state, seed, meta, res = _run(kind, port=True, jitter=1.0)
    solver = GoalSolver()
    goals = get_goals_by_priority(spec["goals"])
    for s, ids in enumerate(spec["sets"]):
        alive = state.alive.clone()
        alive[ids] = kind == "add"
        lane_state = dataclasses.replace(state, alive=alive)
        options = (OptimizationOptions(excluded_brokers_for_replica_move=frozenset(ids),
                                       excluded_brokers_for_leadership=frozenset(ids))
                   if kind == "remove" else OptimizationOptions())
        gctx = build_context(lane_state, seed, meta, BalancingConstraint(), options)
        pl = seed
        for g, goal in enumerate(goals):
            pl, _, info = solver.optimize_goal(goal, goals[:g], gctx, pl,
                                               compute_aggregates(gctx, pl), width=WIDTH)
            assert (info.rounds, info.moves_applied, info.violated_brokers_after) == \
                (res.rounds[s, g], res.moves[s, g], res.violated_after[s, g]), (s, goal.name)
        assert info.stranded_after == res.stranded_after[s]
        lane = res.placement_for(s)
        for f in ("broker", "disk", "is_leader"):
            assert torch.equal(getattr(pl, f), getattr(lane, f)), (s, f)
    _invariants(kind, state, res)


def test_unknown_broker_id_raises():
    st, pl, mt = trc.generate(trc.ClusterProperties(**REMOVE["props"]), device="cpu")
    opt = GoalOptimizer(goal_names=REMOVE["goals"])
    with pytest.raises(ValueError, match=r"unknown broker id\(s\) \[42\]"):
        opt.batch_remove_scenarios(st, pl, mt, [[0], [42]], num_candidates=WIDTH)
    with pytest.raises(ValueError, match="unknown broker id"):
        opt.batch_add_scenarios(st, pl, mt, [[99]], num_candidates=WIDTH)


def test_budget_cuts_every_lane_after_the_first_goal():
    st, pl, mt = trc.generate(trc.ClusterProperties(**REMOVE["props"]), device="cpu")
    budget = SolveBudget()
    budget.cancel("user")
    opt = GoalOptimizer(goal_names=REMOVE["goals"])
    res = opt.batch_remove_scenarios(st, pl, mt, REMOVE["sets"], num_candidates=WIDTH,
                                     budget=budget)
    assert res.preempted and res.goal_names == REMOVE["goals"][:1]
    for a in (res.rounds, res.moves, res.violated_after):
        assert a.shape == (len(REMOVE["sets"]), 1)
    assert res.final_placements.broker.shape == (len(REMOVE["sets"]),
                                                 st.num_replicas_padded)
    # The one goal that ran (RackAware, hard) evacuated every lane.
    assert res.stranded_after.tolist() == [0] * len(REMOVE["sets"])


def test_warm_start_seeds_every_lane():
    """Lanes seeded from a solved placement only repair their own scenario:
    a removal of no broker leaves the warm placement as it is."""
    st, pl, mt = trc.generate(trc.ClusterProperties(**REMOVE["props"]), device="cpu")
    opt = GoalOptimizer(goal_names=REMOVE["goals"])
    warm = opt.optimizations(st, pl, mt).final_placement
    res = opt.batch_remove_scenarios(st, pl, mt, [[], [5]], num_candidates=WIDTH,
                                     warm_start=warm)
    assert torch.equal(res.placement_for(0).broker, warm.broker)
    assert int(res.moves[0].sum()) == 0 and res.succeeded(0)
    assert int(res.stranded_after[1]) == 0
