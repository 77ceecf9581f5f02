"""The port's goals against the JAX package's, on the same packed state.

For every registered goal: the violated-broker mask, the full R×B
replica-move acceptance and self_ok masks, the leadership acceptance, and
every swap predicate on a C×C pair tile must match exactly.  Scores, costs,
slacks and stats metrics are f32 and use rtol=1e-6, atol=1e-4 (the same f32
inputs, reduced in another order); -inf marks match exactly.  Weight markers
("potential_nw_out", "leader_nw_in") must be the same strings.

Swap scores draw a full-scale jitter hash (``hash01``), whose ``sin`` of a
large float32 argument rounds differently in XLA and in torch for about
1.5% of replica ids: those entries are left out of the value comparison.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JConstraint
from cruise_control_tpu.analyzer.context import build_context as jbuild
from cruise_control_tpu.analyzer.context import compute_aggregates as jaggregates
from cruise_control_tpu.analyzer.context import hash01 as jhash01
from cruise_control_tpu.analyzer.goals.registry import goal_by_name as jgoal
from cruise_control_tpu.analyzer.options import OptimizationOptions as JOptions
from cruise_control_tpu.model.state import Placement as JPlacement
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates, hash01
from cruise_control_tpu_torch.analyzer.goals.registry import (
    DEFAULT_INTRA_BROKER_GOALS,
    SUPPORTED_GOALS,
    goal_by_name,
)
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.model.state import state_from_packed

TOL = dict(rtol=1e-6, atol=1e-4)
GOALS = SUPPORTED_GOALS
# Tight enough that every goal but CPU capacity has violated brokers.
PROPS = dict(num_brokers=20, num_racks=5, num_topics=40, num_replicas=2000,
             mean_cpu=0.02, mean_disk=2300.0, mean_nw_in=2300.0,
             mean_nw_out=5000.0, seed=5)
LIMITS = dict(max_replicas_per_broker=108, topic_replica_balance_threshold=1.5,
              topic_replica_balance_min_gap=1,
              min_leader_topic_names=("topic0", "topic3", "topic7"))
SWAP_C = 96


def _pair(props, jp=None):
    """The same cluster as (JAX gctx, placement, agg) and (port ...)."""
    js, jp0, meta = jrc.generate(jrc.ClusterProperties(**props), 64, 8)
    jp = jp0 if jp is None else jp(jp0)
    jg = jbuild(js, jp, meta, JConstraint(**LIMITS), JOptions())
    packed = {k: np.asarray(getattr(js, k)) for k in js.__dataclass_fields__}
    packed.update(assignment=np.asarray(jp.broker), disk=np.asarray(jp.disk),
                  is_leader=np.asarray(jp.is_leader))
    ts, tp = state_from_packed(packed, device="cpu")
    tg = build_context(ts, tp, meta, BalancingConstraint(**LIMITS), OptimizationOptions())
    return ((jg, jp, jaggregates(jg, jp)), (tg, tp, compute_aggregates(tg, tp)))


@pytest.fixture(scope="module")
def pair():
    return _pair(PROPS)


@pytest.fixture(scope="module")
def jbod():
    """Three logdirs a broker, one of them dead."""
    return _pair(dict(PROPS, num_disks=3, dead_disk_ids=((2, 1),)))


@pytest.fixture(scope="module")
def shuffled():
    """Leadership moved off the preferred replica of every third partition."""
    def move(jp):
        lead = np.asarray(jp.is_leader).copy()
        rows = np.nonzero(lead)[0][::3]
        lead[rows] = False
        lead[rows + 1] = True           # rows of a partition are adjacent
        return JPlacement(broker=jp.broker, disk=jp.disk, is_leader=jnp.asarray(lead))
    return _pair(PROPS, move)


def _eq(got, want, what):
    want = np.broadcast_to(np.asarray(want), tuple(got.shape))
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def _close(got, want, what):
    want = np.broadcast_to(np.asarray(want), tuple(got.shape))
    np.testing.assert_allclose(got.numpy(), want, err_msg=what, **TOL)


# Goals whose slack is a cluster-wide mean limit minus a per-broker sum.
# Both packages hold the same per-broker sums bit for bit, but their f32 sums
# over brokers may differ by an ulp (XLA's is not the correctly rounded one
# at the fixture), and the slack cancels the limit down to values ~100x
# smaller: its rounding is relative to the limit, so these slacks are held
# to rtol=1e-6 of the vector's largest value.
MEAN_LIMIT_SLACKS = {"LeaderBytesInDistributionGoal"}


def _slack_match(got, want, what, name):
    """None-ness, marker strings and f32 values of a slack tuple."""
    assert (got is None) == (want is None), what
    if got is None:
        return
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert (g is None) == (w is None), what
        if isinstance(w, str) or isinstance(g, str):
            assert g == w, what
        elif g is not None and name in MEAN_LIMIT_SLACKS:
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, err_msg=what, rtol=TOL["rtol"],
                                       atol=TOL["atol"] + TOL["rtol"] * np.abs(w).max())
        elif g is not None:
            _close(g, w, what)


def test_fixture_has_violations(pair):
    (jg, jp, ja), _ = pair
    counts = {n: int(np.asarray(jgoal(n).violated_brokers(jg, jp, ja)).sum())
              for n in GOALS}
    assert sum(v > 0 for v in counts.values()) >= 8, counts


@pytest.mark.parametrize("name", GOALS)
def test_flags_match(name):
    jgl, tgl = jgoal(name), goal_by_name(name)
    for flag in ("is_hard", "uses_replica_moves", "uses_leadership_moves",
                 "has_pull_phase", "has_swap_phase", "src_sensitive_accept",
                 "multi_accept_safe", "needs_topic_group", "multi_swap_safe",
                 "swap_topic_group", "multi_leadership_safe", "leadership_topic_group",
                 "dst_slack_exempt", "candidate_width_hint"):
        assert getattr(tgl, flag) == getattr(jgl, flag), flag
    for flag in ("is_direct", "intra_disk"):
        assert getattr(tgl, flag) == getattr(jgl, flag, False), flag
    assert hasattr(tgl, "dst_prune_score_vs") == hasattr(jgl, "dst_prune_score_vs")


@pytest.mark.parametrize("name", GOALS)
def test_violated_brokers_and_metric(pair, name):
    (jg, jp, ja), (tg, tp, ta) = pair
    jgl, tgl = jgoal(name), goal_by_name(name)
    _eq(tgl.violated_brokers(tg, tp, ta), jgl.violated_brokers(jg, jp, ja), "violated")
    _close(tgl.stats_metric(tg, tp, ta), jgl.stats_metric(jg, jp, ja), "metric")
    _close(tgl.candidate_score(tg, tp, ta), jgl.candidate_score(jg, jp, ja), "score")
    for fn in ("dst_prune_score", "pull_dst_prune_score"):
        got, want = getattr(tgl, fn)(tg, tp, ta), getattr(jgl, fn)(jg, jp, ja)
        assert (got is None) == (want is None), fn
        if got is not None:
            _close(got, want, fn)
    if hasattr(jgl, "dst_prune_score_vs"):
        priors = [n for n in GOALS if n != name and "UsageDistribution" in n]
        _close(tgl.dst_prune_score_vs(tg, tp, ta, [goal_by_name(n) for n in priors]),
               jgl.dst_prune_score_vs(jg, jp, ja, [jgoal(n) for n in priors]),
               "dst_prune_score_vs")


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
    _close(tgl.dst_cost(tg, tp, ta, tr, td), jgl.dst_cost(jg, jp, ja, jr, jd), "dst_cost")


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
        _slack_match(got, want, axis, name)
    want = jgl.leadership_cumulative_slack(jg, jp, ja, jnp.asarray(cand), jnp.asarray(old))
    got = tgl.leadership_cumulative_slack(tg, tp, ta, torch.from_numpy(cand),
                                          torch.from_numpy(old))
    _slack_match(got, want, "leadership slack", name)


def _tile(tg, seed):
    """C out-rows and C in-columns of valid replicas (numpy-seeded)."""
    rng = np.random.default_rng(seed)
    valid = np.nonzero(tg.state.valid.numpy())[0]
    out_c = rng.choice(valid, SWAP_C, replace=False)
    in_c = rng.choice(valid, SWAP_C, replace=False)
    return out_c, in_c


@pytest.mark.parametrize("name", GOALS)
def test_swap_predicates(pair, name):
    """swap_ok, swap_cost and accept_swap over one C×C pair tile, and the
    cumulative swap slacks on random deltas."""
    (jg, jp, ja), (tg, tp, ta) = pair
    jgl, tgl = jgoal(name), goal_by_name(name)
    out_c, in_c = _tile(tg, 7)
    jo, ji = jnp.asarray(out_c)[:, None], jnp.asarray(in_c)[None, :]
    to, ti = torch.from_numpy(out_c)[:, None], torch.from_numpy(in_c)[None, :]
    jbo, jbi = jp.broker[jo], jp.broker[ji]
    tbo, tbi = tp.broker[to], tp.broker[ti]
    _eq(tgl.swap_ok(tg, tp, ta, to, ti), jgl.swap_ok(jg, jp, ja, jo, ji), "swap_ok")
    _close(tgl.swap_cost(tg, tp, ta, to, ti), jgl.swap_cost(jg, jp, ja, jo, ji), "swap_cost")
    _eq(tgl.accept_swap(tg, tp, ta, to, ti, tbo, tbi),
        jgl.accept_swap(jg, jp, ja, jo, ji, jbo, jbi), "accept_swap")

    rng = np.random.default_rng(2)
    d_load = rng.normal(0, 50, size=(SWAP_C, 4)).astype(np.float32)
    d_pot, d_lbi = (rng.normal(0, 50, size=SWAP_C).astype(np.float32) for _ in range(2))
    d_lead = rng.integers(-1, 2, size=SWAP_C).astype(np.float32)
    want = jgl.swap_cumulative_slack(jg, jp, ja, *map(jnp.asarray, (d_load, d_pot, d_lbi, d_lead)))
    got = tgl.swap_cumulative_slack(tg, tp, ta, *map(torch.from_numpy,
                                                     (d_load, d_pot, d_lbi, d_lead)))
    _slack_match(got, want, "swap slack", name)
    _slack_match(tgl.swap_host_cumulative_slack(tg, tp, ta, torch.from_numpy(d_load)),
                 jgl.swap_host_cumulative_slack(jg, jp, ja, jnp.asarray(d_load)),
                 "swap host slack", name)


@pytest.mark.parametrize("salt", [0, 5])
@pytest.mark.parametrize("name", GOALS)
def test_swap_scores(pair, name, salt):
    """Which replicas are swap candidates matches exactly; their scores
    match wherever the two packages' hash draws agree."""
    (jg, jp, ja), (tg, tp, ta) = pair
    jgl, tgl = jgoal(name), goal_by_name(name)
    r = np.arange(tp.broker.shape[0])
    agree = np.isclose(np.asarray(jhash01(jnp.asarray(r) + salt * 7919, 1.0)),
                       hash01(torch.from_numpy(r) + salt * 7919, 1.0).numpy(),
                       rtol=0, atol=1e-6)
    assert agree.mean() > 0.95
    for fn in ("swap_out_score", "swap_in_score"):
        want = np.asarray(getattr(jgl, fn)(jg, jp, ja, salt))
        got = getattr(tgl, fn)(tg, tp, ta, salt).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=fn)
        keep = agree & ~np.isneginf(want)
        np.testing.assert_allclose(got[keep], want[keep], err_msg=fn, **TOL)


@pytest.mark.parametrize("name", DEFAULT_INTRA_BROKER_GOALS)
def test_intra_disk_masks(jbod, name):
    """On a three-logdir cluster with a dead disk: violated disks, disk
    candidates, the R×D move mask and the metric."""
    (jg, jp, ja), (tg, tp, ta) = jbod
    jgl, tgl = jgoal(name), goal_by_name(name)
    _eq(tgl.violated_disks(tg, tp, ta), jgl.violated_disks(jg, jp, ja), "violated disks")
    _eq(tgl.violated_brokers(tg, tp, ta), jgl.violated_brokers(jg, jp, ja), "violated")
    _close(tgl.disk_candidate_score(tg, tp, ta), jgl.disk_candidate_score(jg, jp, ja), "score")
    r_n, d_n = tp.broker.shape[0], tg.state.num_disks_per_broker
    _eq(tgl.disk_move_ok(tg, tp, ta, torch.arange(r_n)[:, None], torch.arange(d_n)[None, :]),
        jgl.disk_move_ok(jg, jp, ja, jnp.arange(r_n)[:, None], jnp.arange(d_n)[None, :]),
        "disk_move_ok")
    _close(tgl.stats_metric(tg, tp, ta), jgl.stats_metric(jg, jp, ja), "metric")
    assert bool(np.asarray(jgl.disk_candidate_score(jg, jp, ja) > -np.inf).any())


def test_preferred_leader_election_direct_apply(shuffled):
    (jg, jp, ja), (tg, tp, ta) = shuffled
    jgl, tgl = jgoal("PreferredLeaderElectionGoal"), goal_by_name("PreferredLeaderElectionGoal")
    want_v = np.asarray(jgl.violated_brokers(jg, jp, ja))
    _eq(tgl.violated_brokers(tg, tp, ta), want_v, "violated")
    assert want_v.any()
    got = tgl.direct_apply(tg, tp, ta)
    want = jgl.direct_apply(jg, jp, ja)
    _eq(got.is_leader, want.is_leader, "is_leader")
    _eq(got.broker, want.broker, "broker")
