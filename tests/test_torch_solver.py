"""The port's solver against the JAX package's.

The helpers (group winners, cumulative group slack, rack-stratified
destination tiles) and the batched applies must agree exactly on integer
outputs; aggregates after an apply use rtol=1e-6, atol=1e-4 (same f32 deltas,
summed in another order).  One solver round with ``dst_jitter_frac=0.0``
must keep the same moves as the JAX round: with jitter off the remaining
jitter term (1e-6 of a hash) only breaks exact cost ties, which this random
fixture does not rely on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import solver as jsolver
from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JConstraint
from cruise_control_tpu.analyzer.context import apply_leadership_moves_batch as japply_lead
from cruise_control_tpu.analyzer.context import apply_replica_moves_batch as japply
from cruise_control_tpu.analyzer.context import build_context as jbuild
from cruise_control_tpu.analyzer.context import compute_aggregates as jaggregates
from cruise_control_tpu.analyzer.goals.registry import goal_by_name as jgoal
from cruise_control_tpu.analyzer.options import OptimizationOptions as JOptions
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer import solver as tsolver
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import (
    apply_leadership_moves_batch,
    apply_replica_moves_batch,
    build_context,
    compute_aggregates,
)
from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.model.state import state_from_packed

TOL = dict(rtol=1e-6, atol=1e-4)
PROPS = dict(num_brokers=20, num_racks=5, num_topics=40, num_replicas=2000,
             mean_cpu=0.02, mean_disk=2300.0, mean_nw_in=2300.0,
             mean_nw_out=5000.0, seed=5)
LIMITS = dict(max_replicas_per_broker=108, topic_replica_balance_threshold=1.5,
              topic_replica_balance_min_gap=1)
HARD = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
        "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal", "CpuCapacityGoal"]


@pytest.fixture(scope="module")
def pair():
    js, jp, meta = jrc.generate(jrc.ClusterProperties(**PROPS), 64, 8)
    jg = jbuild(js, jp, meta, JConstraint(**LIMITS), JOptions())
    packed = {k: np.asarray(getattr(js, k)) for k in js.__dataclass_fields__}
    packed.update(assignment=np.asarray(jp.broker), disk=np.asarray(jp.disk),
                  is_leader=np.asarray(jp.is_leader))
    ts, tp = state_from_packed(packed, device="cpu")
    tg = build_context(ts, tp, meta, BalancingConstraint(**LIMITS), OptimizationOptions())
    return (jg, jp), (tg, tp)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_group_winners():
    rng = np.random.default_rng(0)
    c = 300
    order = np.where(rng.random(c) < 0.8, np.arange(c), c).astype(np.int32)
    group = rng.integers(0, 40, size=c).astype(np.int32)
    want = jsolver._group_winners(jnp.asarray(order), jnp.asarray(group), 40)
    got = tsolver._group_winners(_t(order).long(), _t(group), 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cumulative_group_ok(seed):
    rng = np.random.default_rng(seed)
    c, g = 400, 25
    order = rng.permutation(c).astype(np.int32)
    group = rng.integers(0, g, size=c).astype(np.int32)
    active = rng.random(c) < 0.7
    cons = [(rng.integers(0, 4, size=c).astype(np.float32),
             rng.integers(-2, 12, size=c).astype(np.float32)) for _ in range(2)]
    want = jsolver._cumulative_group_ok(
        jnp.asarray(order), jnp.asarray(group), jnp.asarray(active),
        [(jnp.asarray(w), jnp.asarray(s)) for w, s in cons], c)
    got = tsolver._cumulative_group_ok(_t(order).long(), _t(group), _t(active),
                                       [(_t(w), _t(s)) for w, s in cons], c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stratified_top_dst(pair):
    (jg, _), (tg, _) = pair
    pscore = np.random.default_rng(4).normal(size=tg.state.num_brokers_padded).astype(np.float32)
    pscore[-3:] = -np.inf
    want = jsolver._stratified_top_dst(jg, jnp.asarray(pscore), 12)
    got = tsolver._stratified_top_dst(tg, _t(pscore), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_batches_match(pair):
    (jg, jp), (tg, tp) = pair
    rng = np.random.default_rng(3)
    c = 128
    r = rng.choice(tp.broker.shape[0] - 64, c, replace=False).astype(np.int32)
    dst = rng.integers(0, 20, size=c).astype(np.int32)
    disk = np.zeros(c, np.int32)
    keep = rng.random(c) < 0.6
    jpl, jag = japply(jg, jp, jaggregates(jg, jp), jnp.asarray(r), jnp.asarray(dst),
                      jnp.asarray(disk), keep=jnp.asarray(keep))
    tpl, tag = apply_replica_moves_batch(tg, tp, compute_aggregates(tg, tp), _t(r),
                                         _t(dst), _t(disk), keep=_t(keep))
    np.testing.assert_array_equal(tpl.broker.numpy(), np.asarray(jpl.broker))
    for name in ("replica_counts", "leader_counts", "topic_counts", "topic_leader_counts"):
        np.testing.assert_array_equal(getattr(tag, name).numpy(),
                                      np.asarray(getattr(jag, name)), err_msg=name)
    for name in ("broker_load", "host_load", "disk_load", "potential_nw_out",
                 "leader_bytes_in"):
        np.testing.assert_allclose(getattr(tag, name).numpy(),
                                   np.asarray(getattr(jag, name)), err_msg=name, **TOL)
    # Promotions: followers of distinct partitions, demoting their leaders.
    pos = tg.state.pos.numpy()
    part = tg.state.partition.numpy()
    valid = tg.state.valid.numpy()
    f = np.nonzero((pos == 1) & valid)[0][:c].astype(np.int32)
    old = np.array([np.nonzero((part == part[i]) & (pos == 0))[0][0] for i in f], np.int32)
    keep = rng.random(f.shape[0]) < 0.5
    jag2 = japply_lead(jg, jp, jag, jnp.asarray(f), jnp.asarray(old), jnp.asarray(keep))
    tag2 = apply_leadership_moves_batch(tg, tp, tag, _t(f), _t(old), _t(keep))
    for name in ("leader_counts", "topic_leader_counts"):
        np.testing.assert_array_equal(getattr(tag2, name).numpy(),
                                      np.asarray(getattr(jag2, name)), err_msg=name)
    for name in ("broker_load", "host_load", "leader_bytes_in"):
        np.testing.assert_allclose(getattr(tag2, name).numpy(),
                                   np.asarray(getattr(jag2, name)), err_msg=name, **TOL)


@pytest.mark.parametrize("name,priors", [
    ("RackAwareGoal", []),
    ("DiskCapacityGoal", HARD[:2]),
    ("ReplicaDistributionGoal", HARD),
    ("TopicReplicaDistributionGoal", HARD + ["ReplicaDistributionGoal"]),
    ("LeaderReplicaDistributionGoal", HARD + ["ReplicaDistributionGoal"]),
])
def test_one_round_keeps_same_moves(pair, name, priors):
    (jg, jp), (tg, tp) = pair
    jpri = tuple(jgoal(n) for n in priors)
    jfn = jsolver.GoalSolver(dst_jitter_frac=0.0)._round_fn(
        jgoal(name), jpri, tp.broker.shape[0])
    jpl, japplied, jviol, _, _ = jfn(jg, jp, jnp.int32(0))
    tpl, tapplied, tviol, _, _ = tsolver.GoalSolver(dst_jitter_frac=0.0).run_round(
        goal_by_name(name), [goal_by_name(n) for n in priors], tg, tp, 0)
    assert int(japplied) > 0
    assert int(tapplied) == int(japplied)
    np.testing.assert_array_equal(tpl.broker.numpy(), np.asarray(jpl.broker))
    np.testing.assert_array_equal(tpl.is_leader.numpy(), np.asarray(jpl.is_leader))
    assert int(tviol) == int(jviol)
    jax.clear_caches()
