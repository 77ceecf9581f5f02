"""The port's solver against the JAX package's.

The helpers (group winners, cumulative group slack, rack-stratified
destination tiles) and the batched applies must agree exactly on integer
outputs; aggregates after an apply use rtol=1e-6, atol=1e-4 (same f32 deltas,
summed in another order).  One solver round with ``dst_jitter_frac=0.0``
must keep the same moves as the JAX round: with jitter off the remaining
jitter term (1e-6 of a hash) only breaks exact cost ties, which this random
fixture does not rely on.  The one-round cases draw no full-scale hash (the
swap phase does: ``tests/test_torch_swap.py`` feeds both packages one tile).
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
from cruise_control_tpu.model.state import Placement as JPlacement
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


def _pair(props, move_leaders=False):
    js, jp, meta = jrc.generate(jrc.ClusterProperties(**props), 64, 8)
    if move_leaders:
        # Leadership off the preferred replica of every third partition
        # (rows of a partition are adjacent, the leader first).
        lead = np.asarray(jp.is_leader).copy()
        rows = np.nonzero(lead)[0][::3]
        lead[rows] = False
        lead[rows + 1] = True
        jp = JPlacement(broker=jp.broker, disk=jp.disk, is_leader=jnp.asarray(lead))
    jg = jbuild(js, jp, meta, JConstraint(**LIMITS), JOptions())
    packed = {k: np.asarray(getattr(js, k)) for k in js.__dataclass_fields__}
    packed.update(assignment=np.asarray(jp.broker), disk=np.asarray(jp.disk),
                  is_leader=np.asarray(jp.is_leader))
    ts, tp = state_from_packed(packed, device="cpu")
    tg = build_context(ts, tp, meta, BalancingConstraint(**LIMITS), OptimizationOptions())
    return (jg, jp), (tg, tp)


@pytest.fixture(scope="module")
def pair():
    return _pair(PROPS)


@pytest.fixture(scope="module")
def other():
    """Three logdirs a broker, one of them dead; and leadership off the
    preferred replica of every third partition."""
    return {"jbod": _pair(dict(PROPS, num_disks=3, dead_disk_ids=((2, 1),))),
            "shuffled": _pair(PROPS, move_leaders=True)}


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


def test_both_roles_winner():
    """The swap phase's at-most-once rule over two keys a candidate, against
    the JAX body's segment_min over both roles."""
    rng = np.random.default_rng(6)
    c, g = 300, 50
    order = np.where(rng.random(c) < 0.8, np.arange(c), c).astype(np.int32)
    ka, kb = (rng.integers(0, g, size=c).astype(np.int32) for _ in range(2))
    keys, order2 = np.concatenate([ka, kb]), np.concatenate([order, order])
    best = np.asarray(jax.ops.segment_min(jnp.asarray(order2), jnp.asarray(keys),
                                          num_segments=g))
    want = (best[ka] == order) & (best[kb] == order)
    got = tsolver._both_roles_winner(_t(order).long(), _t(ka), _t(kb), g)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["PotentialNwOutGoal", "LeaderBytesInDistributionGoal",
                                  "NetworkOutboundCapacityGoal"])
def test_weight_markers(pair, name):
    """A marker weight becomes the candidates' potential NW-out or leader
    bytes-in, as the JAX solver substitutes it."""
    (jg, jp), (tg, tp) = pair
    rng = np.random.default_rng(8)
    cand = rng.choice(tg.state.num_replicas_padded - 64, 64, replace=False).astype(np.int32)
    lead = np.asarray(jp.is_leader)[cand]
    load = np.asarray(jp.broker)[cand][:, None].repeat(4, 1).astype(np.float32)
    ja = jaggregates(jg, jp)
    for axis in ("dst", "src", "host"):
        want = jsolver._multi_accept_constraints(
            jgoal(name), (), jg, jp, ja, jnp.asarray(cand), jnp.asarray(load),
            jnp.asarray(lead), axis)
        got = tsolver._multi_accept_constraints(
            goal_by_name(name), (), tg, tp, compute_aggregates(tg, tp), _t(cand).long(),
            _t(load), _t(lead), axis)
        assert len(got) == len(want)
        for (gw, gs), (ww, ws) in zip(got, want):
            np.testing.assert_allclose(gw.numpy(), np.asarray(ww), **TOL)
            assert not isinstance(gs, str)


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


@pytest.mark.parametrize("name,priors,fixture", [
    ("RackAwareGoal", [], "pair"),
    ("DiskCapacityGoal", HARD[:2], "pair"),
    ("ReplicaDistributionGoal", HARD, "pair"),
    ("TopicReplicaDistributionGoal", HARD + ["ReplicaDistributionGoal"], "pair"),
    ("LeaderReplicaDistributionGoal", HARD + ["ReplicaDistributionGoal"], "pair"),
    ("IntraBrokerDiskCapacityGoal", HARD, "jbod"),
    ("PreferredLeaderElectionGoal", HARD, "shuffled"),
    ("KafkaAssignerEvenRackAwareGoal", [], "pair"),
    ("LeaderBytesInDistributionGoal", HARD + ["LeaderReplicaDistributionGoal"], "pair"),
])
def test_one_round_keeps_same_moves(pair, other, name, priors, fixture):
    (jg, jp), (tg, tp) = pair if fixture == "pair" else other[fixture]
    jpri = tuple(jgoal(n) for n in priors)
    jfn = jsolver.GoalSolver(dst_jitter_frac=0.0)._round_fn(
        jgoal(name), jpri, tp.broker.shape[0])
    jpl, japplied, jviol, _, _ = jfn(jg, jp, jnp.int32(0))
    tpl, tapplied, tviol, _, _ = tsolver.GoalSolver(dst_jitter_frac=0.0).run_round(
        goal_by_name(name), [goal_by_name(n) for n in priors], tg, tp, 0)
    assert int(japplied) > 0
    assert int(tapplied) == int(japplied)
    np.testing.assert_array_equal(tpl.broker.numpy(), np.asarray(jpl.broker))
    np.testing.assert_array_equal(tpl.disk.numpy(), np.asarray(jpl.disk))
    np.testing.assert_array_equal(tpl.is_leader.numpy(), np.asarray(jpl.is_leader))
    assert int(tviol) == int(jviol)
    jax.clear_caches()


# ------------------------------------------------------ the round as one step
#
# A round is one step on buffers it writes back into, with the round index
# a device scalar; on the card it is captured as a CUDA graph, and on the CPU
# it runs eagerly (tests/test_torch_cuda.py holds the graph against it).

ROUND_GRAPH = ("Solver.round-graph.captures", "Solver.round-graph.replays",
               "Solver.round-graph.eager-rounds", "Solver.round-graph.capture-failures")


def _graph_counts():
    from cruise_control_tpu_torch.common.metrics import registry
    return [registry().counter(n).count for n in ROUND_GRAPH]


@pytest.mark.parametrize("b", [1.0, 0.3, 7, -2.5])
def test_hash01_of_a_host_number_equals_its_tensor_form(b):
    """A host number is folded in without a copy to the device, and draws
    the very floats its device tensor gives."""
    from cruise_control_tpu_torch.analyzer.context import hash01
    a = torch.arange(-5000, 60000, 7)
    want = hash01(a, torch.tensor(b, dtype=torch.float32))
    assert torch.equal(hash01(a, b), want)


def test_round_step_with_a_device_round_index_keeps_the_same_moves(pair):
    """The step's first round, its round index a tensor, keeps what
    :meth:`GoalSolver.run_round` keeps at round 0 (a Python int), and the
    solve leaves the caller's placement and aggregates as they were."""
    _, (tg, tp) = pair
    goal, priors = goal_by_name("ReplicaDistributionGoal"), [goal_by_name(n) for n in HARD]
    solver = tsolver.GoalSolver()
    want, applied, *_ = solver.run_round(goal, priors, tg, tp, 0)
    agg = compute_aggregates(tg, tp)
    kept = [t.clone() for t in (tp.broker, tp.disk, tp.is_leader, agg.broker_load)]
    c = solver._width(goal, tp.broker.shape[0])
    runner = solver._phases_runner(goal, tuple(priors), c)
    zero = torch.zeros((), dtype=torch.int64)
    carry = tsolver._Carry(placement=tp, agg=agg, moves=zero, swaps=zero, leader_moves=zero,
                           stall=zero, best_work=zero, best_metric=goal.stats_metric(tg, tp, agg),
                           cond=torch.zeros(4, dtype=torch.int64))
    rs = solver._start_rounds(goal, priors, c, runner, tg, carry, None)
    assert rs.run(0) == "eager:cpu"
    assert int(applied) > 0 and int(rs.carry.moves) == int(applied)
    assert int(rs.carry.cond[2]) == int(applied)
    for name in ("broker", "disk", "is_leader"):
        assert torch.equal(getattr(rs.placement(), name), getattr(want, name)), name
    for before, now in zip(kept, (tp.broker, tp.disk, tp.is_leader, agg.broker_load)):
        assert torch.equal(before, now)
    rs.close()


def test_cpu_rounds_run_eagerly_and_are_counted(pair):
    """On the CPU every ``solve.round`` reads ``graph`` = ``eager:cpu``,
    and ``Solver.round-graph.eager-rounds`` counts each of them."""
    from cruise_control_tpu_torch.obsvc.tracer import tracer
    _, (tg, tp) = pair
    tr = tracer()
    was = tr.enabled
    tr.configure(enabled=True, ring_size=32)
    tr.reset()
    before = _graph_counts()
    try:
        with tr.span("solve"):
            _, _, info = tsolver.GoalSolver().optimize_goal(goal_by_name("RackAwareGoal"), [],
                                                            tg, tp)
        rounds = [s for s in tr.traces()[0]["children"] if s["name"] == "solve.round"]
    finally:
        tr.configure(enabled=was, ring_size=32)
        tr.reset()
    assert info.rounds >= 1 and len(rounds) == info.rounds
    assert [r["attrs"]["graph"] for r in rounds] == ["eager:cpu"] * info.rounds
    assert [a - b for a, b in zip(_graph_counts(), before)] == [0, 0, info.rounds, 0]


def test_priors_aware_ranking_matches_jax(pair):
    """The priors-aware receiver ranking, its columns taken one by one,
    against the JAX package's gather."""
    (jg, jp), (tg, tp) = pair
    names = ["DiskUsageDistributionGoal", "NetworkInboundUsageDistributionGoal"]
    goal = "NetworkOutboundUsageDistributionGoal"
    got = goal_by_name(goal).dst_prune_score_vs(tg, tp, compute_aggregates(tg, tp),
                                                [goal_by_name(n) for n in names])
    want = jgoal(goal).dst_prune_score_vs(jg, jp, jaggregates(jg, jp), [jgoal(n) for n in names])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
