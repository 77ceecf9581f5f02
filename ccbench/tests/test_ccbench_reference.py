"""The reference's goal verdicts and per-broker sums equal the port's on small
clusters, and its lane check finds nothing wrong in the port's own what-if
lanes and each planted fault in them."""

import numpy as np
import pytest

from ccbench.harness import cluster, program
from ccbench.reference import checks, goals as rg

SMALL = [
    dict(num_brokers=20, num_racks=4, num_topics=30, num_replicas=900, mean_cpu=0.006,
         mean_disk=90.0, mean_nw_in=90.0, mean_nw_out=90.0, seed=11),
    dict(num_brokers=26, num_racks=5, num_topics=40, num_replicas=1200, mean_cpu=0.0035,
         mean_disk=90.0, mean_nw_in=90.0, mean_nw_out=90.0, seed=12),
]


def _port_violations(state, placement, meta, names):
    from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
    from cruise_control_tpu_torch.analyzer.goals.registry import get_goals_by_priority
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions

    gctx = build_context(state, placement, meta, program.constraint({}),
                         OptimizationOptions())
    agg = compute_aggregates(gctx, placement)
    return {g.name: int(g.violated_brokers(gctx, placement, agg).sum())
            for g in get_goals_by_priority(names)}


def _agree(cl, packed, placement_np, port):
    agg = rg.aggregate(cl, packed["leader_load"], packed["follower_load"],
                       placement_np["broker"], placement_np["is_leader"])
    ref = rg.verdicts(cl, agg, placement_np, rg.DEFAULT_GOALS, rg.Constraint())
    for name, (state, n) in ref.items():
        if state == rg.UNDECIDED:
            continue
        assert (state == rg.VIOLATED) == (port[name] > 0), name
        if rg.GOALS[name].hard:
            assert n == port[name], name
    return ref


@pytest.fixture(scope="module", params=range(len(SMALL)))
def solved(request):
    props = SMALL[request.param]
    snap = cluster.generate(props)
    packed = snap.packed
    state, placement, meta = program.snapshot(packed, snap.meta_kwargs(), "cpu")
    result = program.optimizer({}, rg.DEFAULT_GOALS).optimizations(state, placement, meta)
    return snap, packed, state, placement, meta, result


def test_verdicts_match_the_port_on_the_snapshot(solved):
    snap, packed, state, placement, meta, _ = solved
    port = _port_violations(state, placement, meta, rg.DEFAULT_GOALS)
    ref = _agree(rg.Cluster(packed), packed, dict(broker=packed["assignment"],
                                                   is_leader=packed["is_leader"]), port)
    assert ref["RackAwareGoal"][0] == rg.VIOLATED     # the random placement breaks racks


def test_verdicts_match_the_port_after_a_solve(solved):
    snap, packed, state, placement, meta, result = solved
    fp = result.final_placement
    port = _port_violations(state, fp, meta, rg.DEFAULT_GOALS)
    place = dict(broker=program.host(fp.broker), is_leader=program.host(fp.is_leader))
    ref = _agree(rg.Cluster(packed), packed, place, port)
    assert all(ref[n][0] != rg.VIOLATED for n in rg.HARD_GOALS)
    assert {n for n, (s, _) in ref.items() if s == rg.VIOLATED} <= set(result.violated_goals_after)


@pytest.fixture(scope="module")
def lanes(solved):
    """Four single-broker what-if lanes of the hard goals from the solved
    placement, with the program's per-broker sums of each."""
    snap, packed, state, placement, meta, result = solved
    opt = program.optimizer({}, rg.HARD_GOALS)
    healthy = opt.optimizations(state, placement, meta).final_placement
    sets = [[0], [3], [5], [snap.num_brokers - 1]]
    res = opt.batch_remove_scenarios(state, placement, meta, sets, num_candidates=64,
                                     warm_start=healthy)
    broker = program.host(res.final_placements.broker)
    lead = program.host(res.final_placements.is_leader)
    sums = program.broker_sums(state, placement, meta, {}, broker, lead)
    return [dict(removed=removed, broker=broker[s], is_leader=lead[s],
                 succeeded=bool(res.succeeded(s)), sums=sums[s],
                 violated=dict(zip(res.goal_names, res.violated_after[s].tolist())))
            for s, removed in enumerate(sets)]


def test_the_ports_lanes_are_judged_right(solved, lanes):
    packed = solved[1]
    cl = rg.Cluster(packed)
    for lane in lanes:
        j = checks.judge_lane(cl, packed, lane["removed"], rg.HARD_GOALS, rg.Constraint(), lane)
        assert not j.faults, j.faults
        assert j.sums_gap < 1e-5 and j.count_mismatches == 0
        assert lane["succeeded"]


def test_the_lane_check_finds_each_fault(solved, lanes):
    packed = solved[1]
    cl = rg.Cluster(packed)
    lane = lanes[0]

    def judge(**change):
        return checks.judge_lane(cl, packed, lane["removed"], rg.HARD_GOALS, rg.Constraint(),
                                 dict(lane, **change))

    sums = lane["sums"].copy()
    sums[2, 0] *= 1.01                                       # a load off by 1e-2
    assert judge(sums=sums).sums_gap > checks.SUMS_RTOL
    sums = lane["sums"].copy()
    sums[2, 4] += 1                                          # one replica miscounted
    assert judge(sums=sums).count_mismatches == 1
    last = rg.HARD_GOALS[-1]
    assert judge(violated=dict(lane["violated"], **{last: 2})).wrong
    first = rg.HARD_GOALS[0]
    assert not judge(violated=dict(lane["violated"], **{first: 2})).wrong   # a later goal may lower it
    assert judge(succeeded=False).wrong


def test_bf16_sums_fail_the_limit(solved, lanes):
    """The control's precision, on the CPU: per-broker sums in bfloat16."""
    import torch
    packed = solved[1]
    cl = rg.Cluster(packed)
    lane = lanes[0]
    bf16 = torch.bfloat16
    lead = torch.as_tensor(lane["is_leader"])
    load = torch.where(lead[:, None], torch.as_tensor(packed["leader_load"]).to(bf16),
                       torch.as_tensor(packed["follower_load"]).to(bf16))
    sums = torch.zeros((cl.num_brokers, 4), dtype=bf16).index_add_(
        0, torch.as_tensor(lane["broker"]).long(), load).float().numpy()
    got = lane["sums"].copy()
    got[:, :4] = sums
    assert judge_gap(cl, packed, lane, got) > checks.SUMS_RTOL


def judge_gap(cl, packed, lane, sums):
    return checks.judge_lane(cl, packed, lane["removed"], rg.HARD_GOALS, rg.Constraint(),
                             dict(lane, sums=sums)).sums_gap


def test_structure_and_lane_faults():
    props = SMALL[0]
    snap = cluster.generate(props)
    packed = snap.packed
    cl = rg.Cluster(packed)
    broker = packed["assignment"].copy()
    lead = packed["is_leader"].copy()
    assert rg.structure(cl, broker, lead).faults == 0
    rows = cl.rows[0]
    dup = broker.copy()
    dup[rows[1]] = dup[rows[0]]
    assert rg.structure(cl, dup, lead).duplicate_partitions == 1
    two = lead.copy()
    two[rows[1]] = True
    assert rg.structure(cl, broker, two).leaderless_or_multi_leader == 1
    removed = int(broker[0])
    j = checks.judge_lane(cl, packed, [removed], rg.HARD_GOALS, rg.Constraint(),
                          dict(broker=broker, is_leader=lead, succeeded=True))
    assert any("left on removed" in f for f in j.faults)


def test_load_margin():
    alive = np.array([True, True, False])
    upper = np.array([100.0, 100.0, 100.0])
    assert rg._load_verdict(np.array([99.0, 99.0, 500.0]), upper, alive) == (rg.SATISFIED, 0)
    assert rg._load_verdict(np.array([100.005, 99.0, 0.0]), upper, alive)[0] == rg.UNDECIDED
    assert rg._load_verdict(np.array([100.02, 99.0, 0.0]), upper, alive) == (rg.VIOLATED, 1)


def test_capacity_counts_a_broker_once_for_itself_and_its_host():
    """A capacity goal counts the brokers past the bound or on a host past it,
    as the port does, not broker and host apart."""
    snap = cluster.generate(SMALL[0])
    cl = rg.Cluster(snap.packed)
    agg = rg.aggregate(cl, snap.packed["leader_load"], snap.packed["follower_load"],
                       snap.packed["assignment"], snap.packed["is_leader"])
    agg.broker_load[:, rg.NW_IN] = 0.0
    agg.host_load[:, rg.NW_IN] = 0.0
    agg.broker_load[3, rg.NW_IN] = agg.host_load[cl.host[3], rg.NW_IN] = 1e9
    got = rg.GOALS["NetworkInboundCapacityGoal"].verdict(cl, agg, {}, rg.Constraint())
    assert got == (rg.VIOLATED, 1)
