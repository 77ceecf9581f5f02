"""The port's swap body against the JAX package's swap phase, on one tile.

The swap tiles are drawn with a full-scale jitter hash, whose ``sin`` of a
large float32 argument rounds differently in XLA and in torch for about 1.5%
of replica ids, so whole swap rounds cannot be compared.  The test takes the
tile the JAX phase takes (its own ``_top_candidates`` over the goal's swap
scores, exact, at the round's salt), runs the whole JAX swap phase, and feeds
that tile to the port's module-level ``swap_body``.  Both run with
``dst_jitter_frac=0.0``: the placements after must be identical and the
applied counts equal.

The JAX phase runs op by op (``jax.disable_jit``).  Compiled, XLA fuses the
jitter hash into the cost and evaluates it with other rounding: on case (a)
at round 0, 3,622 of the tile's 1,048,576 jittered costs differ from the
op-by-op values, enough to reorder near-tied partners, so the compiled JAX
phase keeps 5 swaps where the op-by-op one keeps 6.  The port, which runs op
by op, keeps the op-by-op JAX phase's swaps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import solver as jsolver
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JConstraint
from cruise_control_tpu.analyzer.context import build_context as jbuild
from cruise_control_tpu.analyzer.context import compute_aggregates as jaggregates
from cruise_control_tpu.analyzer.goals.registry import goal_by_name as jgoal
from cruise_control_tpu.analyzer.options import OptimizationOptions as JOptions
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer import solver as tsolver
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_HARD_GOALS, goal_by_name
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.model.state import state_from_packed

PROPS = dict(num_brokers=20, num_racks=5, num_topics=40, num_replicas=2000,
             mean_cpu=0.02, mean_disk=2300.0, mean_nw_in=2300.0,
             mean_nw_out=5000.0, seed=5)
LIMITS = dict(max_replicas_per_broker=108, topic_replica_balance_threshold=1.5,
              topic_replica_balance_min_gap=1)
CASES = {
    # (a) multi-swap with (topic, broker) groups.
    "multi_swap_topic_groups": (
        "NetworkOutboundUsageDistributionGoal",
        DEFAULT_HARD_GOALS + ["TopicReplicaDistributionGoal"], PROPS),
    # (b) the at-most-once fallback: the kafka-assigner even goal is not
    # multi-swap safe.
    "fallback": ("KafkaAssignerDiskUsageDistributionGoal",
                 ["KafkaAssignerEvenRackAwareGoal"], PROPS),
    # (c) two logdirs a broker: the JBOD fill guard.
    "jbod_fill_guard": ("DiskUsageDistributionGoal", DEFAULT_HARD_GOALS,
                        dict(PROPS, num_disks=2)),
}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ridx", [0, 3])
def test_swap_body_keeps_jax_swaps(case, ridx):
    name, priors, props = CASES[case]
    js, jp, meta = jrc.generate(jrc.ClusterProperties(**props), 64, 8)
    jg = jbuild(js, jp, meta, JConstraint(**LIMITS), JOptions())
    ja = jaggregates(jg, jp)
    packed = {k: np.asarray(getattr(js, k)) for k in js.__dataclass_fields__}
    packed.update(assignment=np.asarray(jp.broker), disk=np.asarray(jp.disk),
                  is_leader=np.asarray(jp.is_leader))
    ts, tp = state_from_packed(packed, device="cpu")
    tg = build_context(ts, tp, meta, BalancingConstraint(**LIMITS), OptimizationOptions())
    goal, tgoal = jgoal(name), goal_by_name(name)
    jpri = tuple(jgoal(n) for n in priors)
    tsol = tsolver.GoalSolver(dst_jitter_frac=0.0)
    c = min(tsol.max_swap_candidates, tsol._width(tgoal, ts.num_replicas_padded))
    assert c == min(jsolver.GoalSolver().max_swap_candidates,
                    jsolver.GoalSolver()._width(goal, ts.num_replicas_padded))

    # The JAX phase's tile, then the JAX phase itself (exact top-k).
    salt = jnp.int32(ridx)
    out_top, out_c = jsolver._top_candidates(goal.swap_out_score(jg, jp, ja, salt), c,
                                             exact=True)
    in_top, in_c = jsolver._top_candidates(goal.swap_in_score(jg, jp, ja, salt), c,
                                           exact=True)
    phase = jsolver._swap_phase(goal, jpri, c, jitter_frac=0.0)
    with jax.disable_jit():
        jpl, _, japplied = phase(jg, jp, ja, salt, force_exact=jnp.bool_(True))

    tpl, tag, tapplied = tsolver.swap_body(
        tgoal, [goal_by_name(n) for n in priors], tg, tp, compute_aggregates(tg, tp),
        ridx, _t(out_top), _t(out_c).long(), _t(in_top), _t(in_c).long(),
        jitter_frac=0.0)
    assert int(japplied) > 0
    assert int(tapplied) == int(japplied)
    np.testing.assert_array_equal(tpl.broker.numpy(), np.asarray(jpl.broker))
    np.testing.assert_array_equal(tpl.disk.numpy(), np.asarray(jpl.disk))
    np.testing.assert_array_equal(tpl.is_leader.numpy(), np.asarray(jpl.is_leader))
    # The incremental aggregates after the swaps equal a fresh recompute.
    fresh = compute_aggregates(tg, tpl)
    for f in ("replica_counts", "leader_counts", "topic_counts", "topic_leader_counts"):
        assert torch.equal(getattr(tag, f), getattr(fresh, f)), f
    for f in ("broker_load", "host_load", "disk_load", "potential_nw_out", "leader_bytes_in"):
        torch.testing.assert_close(getattr(tag, f), getattr(fresh, f), rtol=1e-6, atol=1e-4)
