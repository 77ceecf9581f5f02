"""The convex-relaxation path: the eligibility registry, results with it
off, the relax + round + repair pass (hard goals, no-worsen, the fallback),
lanes with it on — the analyzer tests of ``tests/test_relax.py`` — and the
fractional mass after mirror descent against the JAX package's
``_relax_body`` on the same inputs (``rtol=1e-5, atol=1e-6``: the two sum
the float32 matvec in different orders over 48 iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import relax as jrelax
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JConstraint
from cruise_control_tpu.analyzer.context import build_context as jbuild_context
from cruise_control_tpu.analyzer.context import compute_aggregates as jaggregates
from cruise_control_tpu.analyzer.goals import registry as jregistry
from cruise_control_tpu.analyzer.options import OptimizationOptions as JOptions
from cruise_control_tpu.model.state import Placement as JPlacement
from cruise_control_tpu.testing import deterministic as jdet
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu.testing.verifier import verify_placement
from cruise_control_tpu_torch.analyzer import relax
from cruise_control_tpu_torch.analyzer.budget import SolveBudget
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
from cruise_control_tpu_torch.analyzer.goals.registry import (
    RELAX_ELIGIBLE_GOALS,
    goal_by_name,
    is_relax_eligible,
)
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.testing import deterministic as tdet
from cruise_control_tpu_torch.testing import random_cluster as trc

GOALS = ["ReplicaCapacityGoal", "ReplicaDistributionGoal"]
PADS = dict(pad_replicas_to=64, pad_brokers_to=8)
ON = relax.RelaxationConfig()
SMALL = dict(num_brokers=8, num_racks=4, num_topics=12, num_replicas=256, seed=11)
MD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def snapshot():
    return tdet.unbalanced2().freeze(device="cpu", **PADS)


def _same(a, b):
    for f in ("broker", "disk", "is_leader"):
        assert torch.equal(getattr(a.final_placement, f), getattr(b.final_placement, f)), f
    assert [(i.rounds, i.moves_applied, i.violated_brokers_after) for i in a.goal_infos] == \
        [(i.rounds, i.moves_applied, i.violated_brokers_after) for i in b.goal_infos]


def test_eligibility_registry_is_the_jax_packages():
    assert RELAX_ELIGIBLE_GOALS == jregistry.RELAX_ELIGIBLE_GOALS
    assert set(RELAX_ELIGIBLE_GOALS) == {
        "ReplicaDistributionGoal", "DiskUsageDistributionGoal",
        "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
        "CpuUsageDistributionGoal", "LeaderReplicaDistributionGoal"}
    assert is_relax_eligible("com.linkedin.kafka.cruisecontrol.analyzer."
                             "goals.ReplicaDistributionGoal")
    assert not is_relax_eligible("RackAwareGoal")
    assert not is_relax_eligible("KafkaAssignerDiskUsageDistributionGoal")
    assert not is_relax_eligible("NoSuchGoal")
    with pytest.raises(ValueError):
        relax.RelaxationConfig(iterations=0)


def test_off_is_bitwise_the_greedy_solve(snapshot):
    """Off (no config) the optimizer takes the greedy path bit for bit; on,
    only the eligible goal is relaxed, and a run with it off again
    reproduces the first."""
    state, placement, meta = snapshot
    off = GoalOptimizer(goal_names=GOALS)
    on = GoalOptimizer(goal_names=GOALS, relaxation=ON)
    res_off = off.optimizations(state, placement, meta, model_generation=1)
    res_on = on.optimizations(state, placement, meta, model_generation=1)
    assert not any(i.relaxed for i in res_off.goal_infos)
    assert not res_on.goal_infos[0].relaxed          # capacity goal: ineligible
    assert res_on.goal_infos[1].relaxed
    _same(GoalOptimizer(goal_names=GOALS).optimizations(state, placement, meta), res_off)
    # A cancel-only budget takes the path; a deadline (segmented) does not.
    cancel_only = on.optimizations(state, placement, meta, budget=SolveBudget())
    assert cancel_only.goal_infos[1].relaxed
    deadline = on.optimizations(state, placement, meta,
                                budget=SolveBudget(deadline_ms=600_000.0))
    assert not any(i.relaxed for i in deadline.goal_infos)
    _same(deadline, res_off)


def test_ineligible_stack_untouched_when_on(snapshot):
    state, placement, meta = snapshot
    names = ["RackAwareGoal", "ReplicaCapacityGoal"]
    res_off = GoalOptimizer(goal_names=names).optimizations(state, placement, meta)
    res_on = GoalOptimizer(goal_names=names, relaxation=ON).optimizations(
        state, placement, meta)
    assert not any(i.relaxed for i in res_on.goal_infos)
    _same(res_on, res_off)


def _jax_placement(p):
    return JPlacement(broker=jnp.asarray(p.broker.numpy()), disk=jnp.asarray(p.disk.numpy()),
                      is_leader=jnp.asarray(p.is_leader.numpy()))


def test_relax_repair_is_sound(snapshot):
    """The pass is a drop-in: hard goals met, the goal's metric not worse,
    the info re-anchored at the pre-relax state, and the placement passes
    the JAX package's verifier."""
    state, placement, meta = snapshot
    js, jp, jm = jdet.unbalanced2().freeze(**PADS)
    res = GoalOptimizer(goal_names=GOALS, relaxation=ON).optimizations(state, placement, meta)
    info = res.goal_infos[1]
    assert info.relaxed and not info.relax_fallback
    assert info.relax_ms >= 0.0 and info.repair_rounds == info.rounds
    assert info.metric_after <= info.metric_before * (1 + 1e-5) + 1e-9
    assert "ReplicaCapacityGoal" not in res.violated_goals_after
    fails = verify_placement(js, jp, jm, _jax_placement(res.final_placement),
                             goal_infos=res.goal_infos)
    assert not fails, [str(f) for f in fails]


def test_regressed_relaxation_falls_back_to_greedy(snapshot, monkeypatch):
    """A relaxed result worse than the original placement is discarded: the
    goal is solved by plain greedy from the original placement."""
    state, placement, meta = snapshot
    greedy = GoalOptimizer(goal_names=GOALS).optimizations(state, placement, meta)
    real = relax.relax_round

    def worse(*args, **kw):
        pl, agg, moves, violated0, metric0 = real(*args, **kw)
        # Report a "before" no repair can match: the result regressed.
        return pl, agg, moves, violated0 * 0, metric0 * 0 - 1.0
    monkeypatch.setattr(relax, "relax_round", worse)
    res = GoalOptimizer(goal_names=GOALS, relaxation=ON).optimizations(state, placement, meta)
    assert res.goal_infos[1].relaxed and res.goal_infos[1].relax_fallback
    _same(res, greedy)


def test_lanes_with_relaxation_meet_the_lane_invariants(snapshot):
    state, placement, meta = snapshot
    sets = [[0], [1]]
    res_off = GoalOptimizer(goal_names=GOALS).batch_remove_scenarios(
        state, placement, meta, sets, num_candidates=16)
    res_on = GoalOptimizer(goal_names=GOALS, relaxation=ON).batch_remove_scenarios(
        state, placement, meta, sets, num_candidates=16)
    assert int(res_on.stranded_after.sum()) == 0
    assert int(res_on.violated_after.sum()) <= int(res_off.violated_after.sum())
    valid = state.valid.numpy()
    for s, ids in enumerate(sets):
        assert res_on.balancedness(s) >= res_off.balancedness(s) - 1e-6
        assert not np.isin(res_on.placement_for(s).broker.numpy()[valid], ids).any()


def _jax_mirror_descent(goal_name, k, iters):
    """The logits after mirror descent in the JAX package's ``_relax_body``
    (read from its ``lax.while_loop``), and its rounded placement."""
    js, jp, jm = jrc.generate(jrc.ClusterProperties(**SMALL))
    jctx = jbuild_context(js, jp, jm, JConstraint(), JOptions())
    captured = {}
    real = jax.lax.while_loop

    def spy(cond, body, init):
        out = real(cond, body, init)
        captured["z"] = np.asarray(out[1])
        return out
    jax.lax.while_loop = spy
    try:
        out = jrelax._relax_body(jregistry.goal_by_name(goal_name), (), k, 4)(
            jctx, jp, jaggregates(jctx, jp), jnp.int32(iters))
    finally:
        jax.lax.while_loop = real
    return captured["z"], out


@pytest.mark.parametrize("goal_name", ["ReplicaDistributionGoal",
                                       "DiskUsageDistributionGoal",
                                       "LeaderReplicaDistributionGoal"])
def test_fractional_mass_matches_jax(goal_name):
    k, iters = 64, 48
    jz, jout = _jax_mirror_descent(goal_name, k, iters)
    ts, tp, tm = trc.generate(trc.ClusterProperties(**SMALL), device="cpu")
    gctx = build_context(ts, tp, tm, BalancingConstraint(), OptimizationOptions())
    agg = compute_aggregates(gctx, tp)
    goal = goal_by_name(goal_name)
    tile = relax.relax_tile(goal, gctx, tp, agg, k)
    z = relax.mirror_descent(tile, iters)
    assert torch.isfinite(torch.softmax(z, dim=-1)).all()
    np.testing.assert_allclose(torch.softmax(z, dim=-1).numpy(),
                               np.asarray(jax.nn.softmax(jz, axis=-1)), **MD_TOL)
    # The rounding waves keep the same moves.
    pl, _, moves, violated0, metric0 = relax.relax_round(goal, [], gctx, tp, agg, k, 4, iters)
    assert int(moves) == int(jout[2]) and int(violated0) == int(jout[3])
    assert np.array_equal(pl.broker.numpy(), np.asarray(jout[0].broker))
