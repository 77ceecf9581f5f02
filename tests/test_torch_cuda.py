"""The port on the card: the CUDA kernel against its plain version, and the
propose path launching it.  Imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test here needs a CUDA GPU and nvcc (the kernel has no CPU mode) and
skips without one.  Floats use rtol=1e-6, atol=1e-4 on normal-distributed
channels (tests/test_ops.py's bar: the same f32 values summed in another
order) and lie within min(n - 1, 4 sqrt(n)) * 2^-24 * sum |x| of the
float64 sum (chip_smoke.py's zero-mean bar); count channels must be exact.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.ops import aggregate

TOL = dict(rtol=1e-6, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(r, k, b, kind, device):
    """Normal channels (channel 4 a count when K > 4) and brokers in [-2,
    B + 2); "skewed" puts half of the rows on 26 brokers, "offset" passes
    channels as a contiguous view 4 bytes into its storage."""
    rng = np.random.default_rng(r)
    pad = 1 if kind == "offset" else 0
    flat = torch.from_numpy(rng.normal(size=r * k + pad).astype(np.float32)).to(device)
    ch = flat[pad:].view(r, k)
    if k > 4:
        ch[:, 4] = 1.0
    br = rng.integers(-2, b + 2, size=r).astype(np.int32)
    if kind == "skewed":
        hot = rng.random(r) < 0.5
        br[hot] = rng.integers(0, 26, size=int(hot.sum()))
    return ch, torch.from_numpy(br).to(device)


def _holds(got, ch, br, b, kind):
    """Counts exact; within min(n - 1, 4 sqrt(n)) * 2^-24 * sum |x| of the
    float64 sum (the worst-case rounding of an n-term sum where n is small,
    four times the typical one of a zero-mean sum where it is large; a lost
    row of a hot broker moves its sum by far more); and the rtol/atol bar
    against the plain version, except for skewed brokers (~19K rows a sum,
    where the plain version's own f32 rounding exceeds that bar)."""
    want = aggregate.broker_channel_sums_plain(ch, br, b)
    if ch.shape[1] > 4:
        assert torch.equal(got[:, 4], want[:, 4])
    if kind != "skewed":
        torch.testing.assert_close(got, want, **TOL)
    want64 = aggregate.broker_channel_sums_plain(ch.double(), br, b)
    n = aggregate.broker_channel_sums_plain(
        torch.ones(ch.shape[0], 1, dtype=torch.float64, device=ch.device), br, b)
    mag = aggregate.broker_channel_sums_plain(ch.double().abs(), br, b)
    bar = torch.minimum((n - 1).clamp(min=0), 4 * n.sqrt()) * 2.0 ** -24 * mag
    assert ((got.double() - want64).abs() <= bar + 1e-9).all()


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,b,kind", [
    (1613, 8, 37, "uniform"), (50_000, 8, 200, "uniform"), (200_000, 8, 8192, "uniform"),
    (1_000_000, 8, 2600, "skewed"), (50_000, 4, 200, "uniform"), (50_000, 13, 200, "offset"),
    (50_000, 8, 200, "offset"), (0, 8, 200, "uniform"), (200_000, 64, 8192, "uniform")])
def test_kernel_matches_plain(cuda, r, k, b, kind):
    ch, br = _inputs(r, k, b, kind, cuda)
    before = aggregate.LAUNCHES
    got = aggregate.broker_channel_sums(ch, br, b)
    torch.cuda.synchronize()
    assert aggregate.LAUNCHES == before + (1 if r else 0)
    _holds(got, ch, br, b, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [aggregate.BLOCK, aggregate.GLOBAL], ids=["BLOCK", "GLOBAL"])
@pytest.mark.parametrize("r,k,b", [(2_000, 8, 200), (50_000, 8, 200), (100_000, 8, 8192),
                                   (50_000, 13, 300)])
def test_every_variant_matches_plain(cuda, r, k, b, mode, monkeypatch):
    """Either variant, forced through the row threshold, writes every
    broker (out comes from torch.empty: nothing is left unwritten)."""
    monkeypatch.setattr(aggregate, "GLOBAL_MAX_ROWS", -1 if mode == aggregate.BLOCK else r)
    monkeypatch.setattr(aggregate, "_plans", {})
    ch, br = _inputs(r, k, b, "uniform", cuda)
    assert aggregate.plan_for(r, k, b, ch.device).mode == mode
    torch.full((b, k), float("nan"), device=cuda)  # freed at once: out may reuse it
    got = aggregate.broker_channel_sums(ch, br, b)
    torch.cuda.synchronize()
    _holds(got, ch, br, b, "uniform")


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    ch = torch.ones(64, 8, device=cuda)
    br = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        aggregate.broker_channel_sums(ch.double(), br, 4)
    with pytest.raises(TypeError):
        aggregate.broker_channel_sums(ch, br.long(), 4)
    with pytest.raises(ValueError):
        aggregate.broker_channel_sums(ch.t(), br[:8], 4)


SMALL = dict(num_brokers=20, num_racks=5, num_topics=50, num_replicas=2000,
             mean_cpu=0.005, mean_disk=2100.0, mean_nw_in=2000.0, mean_nw_out=2000.0,
             seed=11)


@pytest.mark.cuda
def test_propose_path_launches_kernel(cuda):
    """The full 15-goal default stack on the card: the kernel launches and
    every hard goal is met."""
    from cruise_control_tpu_torch.analyzer.goals.registry import (
        DEFAULT_GOALS, DEFAULT_HARD_GOALS)
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing import random_cluster as rc

    state, placement, meta = rc.generate(rc.ClusterProperties(**SMALL), device=cuda)
    aggregate.LAUNCHES = 0
    res = GoalOptimizer().optimizations(state, placement, meta)
    assert aggregate.LAUNCHES > 0
    assert res.final_placement.broker.is_cuda
    assert res.proposals
    assert [i.goal_name for i in res.goal_infos] == DEFAULT_GOALS
    assert not set(res.violated_goals_after) & set(DEFAULT_HARD_GOALS)


@pytest.mark.cuda
def test_swap_body_keeps_the_same_swaps_on_cpu_and_card(cuda):
    """One NetworkOutboundUsageDistributionGoal swap tile, taken on the
    card, behind the default stack's first seven goals: the card and the
    CPU keep the same swaps with the same partners from the same inputs."""
    import dataclasses

    from cruise_control_tpu_torch.analyzer import solver
    from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS, goal_by_name
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
    from cruise_control_tpu_torch.testing import random_cluster as rc

    goal = goal_by_name("NetworkOutboundUsageDistributionGoal")
    priors = [goal_by_name(n) for n in DEFAULT_GOALS[:7]]
    kept = {}
    st, pl, mt = rc.generate(rc.ClusterProperties(**SMALL), device=cuda)
    gctx = build_context(st, pl, mt, BalancingConstraint(), OptimizationOptions())
    agg = compute_aggregates(gctx, pl)
    c = solver.GoalSolver().swap_width(goal, st.num_replicas_padded)
    tile = solver.swap_tile(goal, gctx, pl, agg, 0, c)
    for dev in ("cuda", "cpu"):
        s, p, m = rc.generate(rc.ClusterProperties(**SMALL), device=dev)
        g = build_context(s, p, m, BalancingConstraint(), OptimizationOptions())
        a = dataclasses.replace(agg, **{f.name: getattr(agg, f.name).to(dev)
                                        for f in dataclasses.fields(agg)})
        keep, r_in, _, _ = solver.swap_select(goal, priors, g, p, a, 0,
                                              *(t.to(dev) for t in tile), jitter_frac=0.0)
        kept[dev] = (keep.cpu(), r_in.cpu())
    assert int(kept["cpu"][0].sum()) > 0
    assert torch.equal(kept["cuda"][0], kept["cpu"][0])
    k = kept["cpu"][0]
    assert torch.equal(kept["cuda"][1][k], kept["cpu"][1][k])


def _resident_chain(device):
    """The resident service on ``device`` through a delta chain (loads, a
    killed broker, a structural edit): each request's packed arrays, and
    the first snapshot's tensors, pinned across the later applies."""
    from cruise_control_tpu_torch.model.resident import ResidentModelService
    from cruise_control_tpu_torch.model.state import state_to_numpy
    from cruise_control_tpu_torch.testing import deterministic as det

    svc = ResidentModelService(device=device)
    cm = det.small_cluster_model()
    pads = lambda r, b: (16, 4)  # noqa: E731
    pinned = svc.snapshot(cm, pads, pin=True)
    seen = [state_to_numpy(*pinned[:2])]
    svc.release()
    edits = [lambda: cm.set_replica_load("T1", 0, 0, det.load(33.0, 101.5, 77.25, 13.0)),
             lambda: cm.set_broker_state(2, alive=False),
             lambda: (cm.delete_replica("T2", 0, 2),
                      cm.create_replica("T2", 3, broker_id=1, index=0, is_leader=True))]
    for edit in edits:
        edit()
        s, p, _ = svc.snapshot(cm, pads)
        assert s.device.type == torch.device(device).type
        seen.append(state_to_numpy(s, p))
    assert svc.stats()["deltaApplies"] >= 3
    fresh, _ = cm.freeze_packed(pad_replicas_to=16, pad_brokers_to=4)
    return seen, pinned, fresh


@pytest.mark.cuda
def test_resident_delta_chain_on_the_card_equals_the_cpu(cuda):
    """Every request of the chain gives the same arrays, bit for bit, on the
    card and on the CPU, and the last equals a fresh freeze."""
    card, _, fresh = _resident_chain(cuda)
    cpu, _, _ = _resident_chain("cpu")
    for got, want in zip(card, cpu):
        assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    assert all(card[-1][k].tobytes() == fresh[k].tobytes() for k in fresh)


@pytest.mark.cuda
def test_pinned_snapshot_unchanged_by_later_applies(cuda):
    """The applies write into copies: the first snapshot's tensors on the
    card still hold what they held when it was pinned."""
    from cruise_control_tpu_torch.model.state import state_to_numpy

    seen, pinned, _ = _resident_chain(cuda)
    now = state_to_numpy(*pinned[:2])
    assert all(now[k].tobytes() == seen[0][k].tobytes() for k in now)
    assert any(now[k].tobytes() != seen[-1][k].tobytes() for k in now)


def _metadata_backend(state, placement, meta):
    """The port's fake metadata backend for a generated snapshot."""
    from cruise_control_tpu_torch.model.builder import builder_from_snapshot
    from cruise_control_tpu_torch.monitor.metadata import (BrokerInfo, FakeMetadataBackend,
                                                           PartitionInfo)
    builder = builder_from_snapshot(state, placement, meta)
    parts = []
    for (t, p), reps in builder.partitions().items():
        ids = tuple(r.broker_id for r in reps)
        leader = next((r.broker_id for r in reps if r.is_leader), None)
        parts.append(PartitionInfo(topic=t, partition=p, leader=leader, replicas=ids,
                                   in_sync=ids))
    return FakeMetadataBackend([BrokerInfo(b.broker_id, rack=b.rack, host=b.host,
                                           alive=b.alive) for b in builder.brokers()], parts)


@pytest.mark.cuda
def test_verifier_on_the_card_equals_the_cpu(cuda):
    """verify_placement on the card (the aggregate kernel launches) gives the
    same failures as on the CPU: none for the hard goals' solve of a cluster
    with a dead broker, and the same (check, detail) list for the input
    placement, which strands that broker's replicas."""
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_HARD_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing import random_cluster as rc
    from cruise_control_tpu_torch.testing.verifier import verify_placement

    props = rc.ClusterProperties(**SMALL, dead_broker_ids=(3,))
    st, pl, mt = rc.generate(props, device=cuda)
    fin = GoalOptimizer(goal_names=DEFAULT_HARD_GOALS).optimizations(st, pl, mt).final_placement
    cs, cp, cm = rc.generate(props, device="cpu")
    fin_cpu = type(fin)(**{f: getattr(fin, f).cpu() for f in ("broker", "disk", "is_leader")})
    for final, final_cpu in ((fin, fin_cpu), (pl, cp)):
        aggregate.LAUNCHES = 0
        card = verify_placement(st, pl, mt, final, goal_names=DEFAULT_HARD_GOALS)
        torch.cuda.synchronize()
        assert aggregate.LAUNCHES > 0
        cpu = verify_placement(cs, cp, cm, final_cpu, goal_names=DEFAULT_HARD_GOALS)
        assert [(f.check, f.detail) for f in card] == [(f.check, f.detail) for f in cpu]
    assert verify_placement(st, pl, mt, fin, goal_names=DEFAULT_HARD_GOALS) == []
    assert "DEAD_BROKERS" in [f.check for f in verify_placement(st, pl, mt, pl)]


@pytest.mark.cuda
def test_card_solve_executed_through_fake_backend(cuda):
    """The hard goals solved on the card, every proposal executed through
    FakeClusterBackend: each partition ends on the solve's replica set, led
    by its final leader, and every task completes."""
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_HARD_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.executor.backend import FakeClusterBackend
    from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
    from cruise_control_tpu_torch.testing import random_cluster as rc

    st, pl, mt = rc.generate(rc.ClusterProperties(**SMALL, dead_broker_ids=(3,)), device=cuda)
    metadata = _metadata_backend(st, pl, mt)
    aggregate.LAUNCHES = 0
    res = GoalOptimizer(goal_names=DEFAULT_HARD_GOALS).optimizations(st, pl, mt)
    assert aggregate.LAUNCHES > 0 and res.proposals
    ex = Executor(FakeClusterBackend(metadata, polls_to_finish=2),
                  ExecutorConfig(progress_check_interval_s=0.001,
                                 max_num_cluster_movements=len(res.proposals)))
    ex.execute_proposals(res.proposals, wait=False)
    ex._thread.join(timeout=60)
    assert not ex._thread.is_alive()
    summary = ex.tracker.summary()
    assert all(set(by_state) == {"completed"} for by_state in summary.values() if by_state)
    n = mt.num_replicas
    broker = res.final_placement.broker.cpu().numpy()[:n]
    leader = res.final_placement.is_leader.cpu().numpy()[:n]
    part = st.partition.cpu().numpy()[:n]
    want = {}
    for r in range(n):
        t, p = mt.partitions[part[r]]
        reps, lead = want.setdefault((mt.topics[t], p), (set(), []))
        reps.add(mt.broker_ids[broker[r]])
        if leader[r]:
            lead.append(mt.broker_ids[broker[r]])
    got = {(p.topic, p.partition): p for p in metadata.fetch().partitions}
    assert set(got) == set(want)
    for tp, (reps, lead) in want.items():
        assert set(got[tp].replicas) == reps
        assert [got[tp].leader] == lead
    assert not any(3 in p.replicas for p in got.values())


def _facade_stack(device):
    """A small monitored cluster behind the port's facade on ``device``:
    6 brokers on 2 racks, 24 partitions at RF 2, six windows of synthetic
    samples."""
    from cruise_control_tpu_torch.executor.backend import FakeClusterBackend
    from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
    from cruise_control_tpu_torch.monitor.metadata import (
        BrokerInfo, FakeMetadataBackend, MetadataClient, PartitionInfo)
    from cruise_control_tpu_torch.monitor.sampler import SyntheticWorkloadSampler
    from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner

    brokers = [BrokerInfo(i, rack=str(i % 2), host=f"h{i}") for i in range(6)]
    parts = [PartitionInfo("T", p, leader=p % 3, replicas=(p % 3, (p % 3) + 1 + p % 2),
                           in_sync=(p % 3,)) for p in range(24)]
    backend = FakeMetadataBackend(brokers, parts)
    lm = LoadMonitor(MetadataClient(backend, ttl_ms=0), num_windows=5, window_ms=1000,
                     min_samples_per_window=1)
    runner = LoadMonitorTaskRunner(lm, SyntheticWorkloadSampler(), sampling_interval_ms=1000)
    runner.bootstrap(0, 6000)
    ex = Executor(FakeClusterBackend(backend, polls_to_finish=1),
                  ExecutorConfig(progress_check_interval_s=0.001))
    return CruiseControl(lm, ex, task_runner=runner, device=device,
                         default_goals=["RackAwareGoal", "ReplicaCapacityGoal",
                                        "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal"])


@pytest.mark.cuda
def test_facade_proposals_on_the_card_equal_the_cpu(cuda):
    """CruiseControl.proposals() on the card launches the kernel and gives
    the port's CPU run's answer on the same monitored cluster."""
    card = _facade_stack(cuda)
    freezes = card.resident.stats()["fullFreezes"]      # a process-wide sensor
    aggregate.LAUNCHES = 0
    got = card.proposals()
    assert aggregate.LAUNCHES > 0
    assert got.optimizer_result.final_placement.broker.is_cuda
    assert card.resident.stats()["fullFreezes"] == freezes + 1
    want = _facade_stack("cpu").proposals()
    g, w = got.optimizer_result, want.optimizer_result
    assert g.violated_goals_before == w.violated_goals_before
    assert g.violated_goals_after == w.violated_goals_after
    assert g.balancedness_score == w.balancedness_score
    assert set(g.proposals) == set(w.proposals)
    assert [i.rounds for i in g.goal_infos] == [i.rounds for i in w.goal_infos]


@pytest.mark.cuda
def test_servlet_explained_rebalance_on_the_card(cuda):
    """A ``CruiseControlApp`` over a facade on the card answers
    ``POST /rebalance?dryrun=true&explain=true`` with every proposal's
    provenance, and the request launched the kernel."""
    import json
    import urllib.request

    from cruise_control_tpu_torch.obsvc.execution import PATHS, execution
    from cruise_control_tpu_torch.servlet.server import USER_TASK_HEADER, CruiseControlApp

    execution().configure(enabled=True)
    cc = _facade_stack(cuda)
    app = CruiseControlApp(cc, port=0)
    app.start()
    try:
        url = f"http://127.0.0.1:{app.port}/kafkacruisecontrol/rebalance?dryrun=true&explain=true"
        aggregate.LAUNCHES = 0
        task_id = None
        for _ in range(600):
            req = urllib.request.Request(url, method="POST")
            if task_id:
                req.add_header(USER_TASK_HEADER, task_id)
            with urllib.request.urlopen(req) as r:
                status, task_id = r.status, r.headers[USER_TASK_HEADER]
                body = json.load(r)
            if status == 200:
                break
        assert status == 200 and aggregate.LAUNCHES > 0
        result = body["result"]
        assert result["proposals"]
        assert sum(result["provenancePaths"].values()) == len(result["proposals"])
        assert all(p["provenance"]["path"] in PATHS for p in result["proposals"])
    finally:
        app.stop()
        cc.shutdown()
