"""The port's goals against the JAX package's, on the same packed state.

For each goal of the slice stack (and RackAwareDistributionGoal): the
violated-broker mask, the full R×B replica-move acceptance and self_ok masks,
and the leadership acceptance must match exactly.  Scores, costs, slacks and
stats metrics are f32 and use rtol=1e-6, atol=1e-4 (the same f32 inputs,
reduced in another order); -inf marks match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JConstraint
from cruise_control_tpu.analyzer.context import build_context as jbuild
from cruise_control_tpu.analyzer.context import compute_aggregates as jaggregates
from cruise_control_tpu.analyzer.goals.registry import goal_by_name as jgoal
from cruise_control_tpu.analyzer.options import OptimizationOptions as JOptions
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS, goal_by_name
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.model.state import state_from_packed

TOL = dict(rtol=1e-6, atol=1e-4)
GOALS = DEFAULT_GOALS + ["RackAwareDistributionGoal"]
# Tight enough that every goal but CPU capacity has violated brokers.
PROPS = dict(num_brokers=20, num_racks=5, num_topics=40, num_replicas=2000,
             mean_cpu=0.02, mean_disk=2300.0, mean_nw_in=2300.0,
             mean_nw_out=5000.0, seed=5)
LIMITS = dict(max_replicas_per_broker=108, topic_replica_balance_threshold=1.5,
              topic_replica_balance_min_gap=1)


@pytest.fixture(scope="module")
def pair():
    js, jp, meta = jrc.generate(jrc.ClusterProperties(**PROPS), 64, 8)
    jg = jbuild(js, jp, meta, JConstraint(**LIMITS), JOptions())
    packed = {k: np.asarray(getattr(js, k)) for k in js.__dataclass_fields__}
    packed.update(assignment=np.asarray(jp.broker), disk=np.asarray(jp.disk),
                  is_leader=np.asarray(jp.is_leader))
    ts, tp = state_from_packed(packed, device="cpu")
    tg = build_context(ts, tp, meta, BalancingConstraint(**LIMITS), OptimizationOptions())
    return ((jg, jp, jaggregates(jg, jp)), (tg, tp, compute_aggregates(tg, tp)))


def _eq(got, want, what):
    want = np.broadcast_to(np.asarray(want), tuple(got.shape))
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


def test_fixture_has_violations(pair):
    (jg, jp, ja), _ = pair
    counts = {n: int(np.asarray(jgoal(n).violated_brokers(jg, jp, ja)).sum())
              for n in GOALS}
    assert sum(v > 0 for v in counts.values()) >= 8, counts


@pytest.mark.parametrize("name", GOALS)
def test_violated_brokers_and_metric(pair, name):
    (jg, jp, ja), (tg, tp, ta) = pair
    jgl, tgl = jgoal(name), goal_by_name(name)
    _eq(tgl.violated_brokers(tg, tp, ta), jgl.violated_brokers(jg, jp, ja), "violated")
    _close(tgl.stats_metric(tg, tp, ta), jgl.stats_metric(jg, jp, ja), "metric")
    _close(tgl.candidate_score(tg, tp, ta), jgl.candidate_score(jg, jp, ja), "score")


@pytest.mark.parametrize("name", GOALS)
def test_replica_move_masks(pair, name):
    (jg, jp, ja), (tg, tp, ta) = pair
    jgl, tgl = jgoal(name), goal_by_name(name)
    r_n, b_n = tp.broker.shape[0], tg.state.num_brokers_padded
    jr, jd = jnp.arange(r_n)[:, None], jnp.arange(b_n)[None, :]
    tr, td = torch.arange(r_n)[:, None], torch.arange(b_n)[None, :]
    _eq(tgl.accept_replica_move(tg, tp, ta, tr, td),
        jgl.accept_replica_move(jg, jp, ja, jr, jd), "accept_replica_move")
    _eq(tgl.self_ok(tg, tp, ta, tr, td), jgl.self_ok(jg, jp, ja, jr, jd), "self_ok")
    cost_t = tgl.dst_cost(tg, tp, ta, tr, td)
    cost_j = np.broadcast_to(np.asarray(jgl.dst_cost(jg, jp, ja, jr, jd)), tuple(cost_t.shape))
    _close(cost_t, cost_j, "dst_cost")


@pytest.mark.parametrize("name", GOALS)
def test_leadership_masks(pair, name):
    (jg, jp, ja), (tg, tp, ta) = pair
    jgl, tgl = jgoal(name), goal_by_name(name)
    r_n = tp.broker.shape[0]
    _eq(tgl.accept_leadership_move(tg, tp, ta, torch.arange(r_n)),
        jgl.accept_leadership_move(jg, jp, ja, jnp.arange(r_n)), "accept_leadership")
    _eq(tgl.leadership_self_ok(tg, tp, ta, torch.arange(r_n)),
        jgl.leadership_self_ok(jg, jp, ja, jnp.arange(r_n)), "leadership_self_ok")
    _close(tgl.leadership_candidate_score(tg, tp, ta),
           jgl.leadership_candidate_score(jg, jp, ja), "leadership score")
    _eq(tgl.pull_dst_mask(tg, tp, ta), jgl.pull_dst_mask(jg, jp, ja), "pull mask")
    _close(tgl.pull_candidate_score(tg, tp, ta),
           jgl.pull_candidate_score(jg, jp, ja), "pull score")


@pytest.mark.parametrize("name", GOALS)
def test_cumulative_slacks(pair, name):
    (jg, jp, ja), (tg, tp, ta) = pair
    jgl, tgl = jgoal(name), goal_by_name(name)
    rng = np.random.default_rng(1)
    c = 64
    cand = rng.choice(tp.broker.shape[0], c, replace=False)
    old = rng.choice(tp.broker.shape[0], c, replace=False)
    load = rng.uniform(0, 100, size=(c, 4)).astype(np.float32)
    lead = rng.integers(0, 2, size=c).astype(bool)
    for axis in ("dst", "src", "host"):
        jfn = getattr(jgl, f"{axis}_cumulative_slack", lambda *a: None)
        want = jfn(jg, jp, ja, jnp.asarray(load), jnp.asarray(lead))
        got = getattr(tgl, f"{axis}_cumulative_slack")(
            tg, tp, ta, torch.from_numpy(load), torch.from_numpy(lead))
        assert (got is None) == (want is None), axis
        if got is not None:
            for g, w in zip(got, want):
                _close(g, w, axis)
    want = jgl.leadership_cumulative_slack(jg, jp, ja, jnp.asarray(cand), jnp.asarray(old))
    got = tgl.leadership_cumulative_slack(tg, tp, ta, torch.from_numpy(cand),
                                          torch.from_numpy(old))
    assert (got is None) == (want is None)
    if got is not None:
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                _close(g, w, "leadership slack")
