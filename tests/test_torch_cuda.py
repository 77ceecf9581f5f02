"""The port on the card: the CUDA kernel against its plain version, and the
propose path launching it.  Imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test here needs a CUDA GPU and nvcc (the kernel has no CPU mode) and
skips without one.  Floats use rtol=1e-6, atol=1e-4 on normal-distributed
channels (tests/test_ops.py's bar: the same f32 values summed in another
order) and lie within min(n - 1, 4 sqrt(n)) * 2^-24 * sum |x| of the
float64 sum (chip_smoke.py's zero-mean bar); count channels must be exact.
"""

import gc

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


@pytest.mark.cuda
def test_reporter_mode_service_to_a_model_on_the_card(cuda, tmp_path):
    """``main.build_app`` in reporter mode with a store directory: the
    reporters' records go over the segment-file bus to the consuming
    sampler, windows form on an explicit clock, the monitor's model lands on
    the card, and the service's proposals launch the kernel; a second
    service on the same directory replays the log store to the same
    windows."""
    from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
    from cruise_control_tpu_torch.main import build_app

    props = {"metric.sampler.mode": "reporter", "sample.store.dir": str(tmp_path),
             "num.metric.fetchers": "4", "metric.sampling.interval.ms": "3600000",
             "partition.metrics.window.ms": "400", "broker.metrics.window.ms": "400",
             "num.partition.metrics.windows": "3", "num.broker.metrics.windows": "3",
             "min.samples.per.partition.metrics.window": "1", "obs.history.enabled": "false",
             "default.goals": "RackAwareGoal,ReplicaCapacityGoal,ReplicaDistributionGoal"}
    states = []
    for restart in range(2):
        app = build_app(CruiseControlConfig(props), port=0, device="cuda")
        runner = app.cc.task_runner
        now = [0.0]
        runner._clock = lambda: now[0] / 1000.0
        runner.start()
        try:
            for w in range(0 if restart else 5):
                now[0] = w * 400 + 200
                for rep in runner.reporters:
                    rep.report_once(time_ms=now[0])
                runner.run_sampling_once(now[0])
            st = app.cc.load_monitor.state()
            states.append((st.num_valid_windows, st.monitored_partitions_percentage))
            state, placement, _ = app.cc.load_monitor.cluster_model(device=cuda)
            assert state.leader_load.is_cuda and placement.broker.is_cuda
            aggregate.LAUNCHES = 0
            result = app.cc.proposals()
            assert aggregate.LAUNCHES > 0
            assert result.optimizer_result.final_placement.broker.is_cuda
        finally:
            app.user_tasks.shutdown()
            app.server.server_close()
            app.cc.shutdown()
    assert states[0][0] >= 2 and states[1] == states[0]


@pytest.mark.cuda
def test_memory_ledger_reconciles_with_the_card(cuda, monkeypatch):
    """The resident model's posts on the card: the tracked bytes lie within
    what ``torch.cuda.memory_stats`` says is allocated (``verify_balanced``),
    the drift is that difference, and the budget is the card's memory."""
    from cruise_control_tpu_torch.model.resident import ResidentModelService
    from cruise_control_tpu_torch.obsvc import memory
    from cruise_control_tpu_torch.testing import deterministic as det

    ledger = memory.DeviceMemoryLedger()
    ledger.configure(enabled=True)
    monkeypatch.setattr(memory, "_LEDGER", ledger)
    svc = ResidentModelService(device=cuda)
    cm = det.small_cluster_model()
    svc.snapshot(cm, lambda r, b: (16, 4))
    cm.set_replica_load("T1", 0, 0, det.load(9.0, 9.0, 9.0, 9.0))
    state, placement, _ = svc.snapshot(cm, lambda r, b: (16, 4), pin=True)
    svc.release()
    tracked = ledger.live_bytes(memory.SUBSYS_RESIDENT)
    assert tracked == memory.measure_bytes((state, placement)) > 0
    rec = ledger.reconcile()
    assert rec["backend"]["bytes_in_use"] >= tracked
    assert rec["driftBytes"] == rec["backend"]["bytes_in_use"] - tracked >= 0
    assert ledger.verify_balanced() == []
    assert ledger.device_budget_bytes() == torch.cuda.mem_get_info()[1]


@pytest.mark.cuda
def test_full_mode_cost_row_on_the_card(cuda, monkeypatch):
    """``memory.analysis.mode=full``: each family's first run at a bucket on
    the card records its temporaries from the peak-memory counters, and the
    peak is arguments + outputs + temporaries."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.obsvc import memory
    from cruise_control_tpu_torch.testing import random_cluster as rc

    ledger = memory.DeviceMemoryLedger()
    ledger.configure(enabled=True, analysis_mode="full")
    monkeypatch.setattr(memory, "_LEDGER", ledger)
    state, placement, meta = rc.generate(rc.ClusterProperties(**SMALL), device=cuda)
    GoalOptimizer(goal_names=["RackAwareGoal", "ReplicaDistributionGoal"]).optimizations(
        state, placement, meta)
    rows = ledger.costs.rows()
    assert sum(row["count"] for row in rows.values()) == 2
    for row in rows.values():
        assert row["mode"] == "full" and row["temp_bytes"] is not None
        assert row["temp_bytes"] >= 0 and row["arg_bytes"] > 0
        assert row["peak_bytes"] == row["arg_bytes"] + row["out_bytes"] + row["temp_bytes"]
    assert any(row["temp_bytes"] > 0 for row in rows.values())


# ------------------------------------------------------------ round graphs
#
# The benchmark's configuration (``ccbench``'s ``randomcluster_40b_50k``: 40
# brokers in 10 racks, 47,172 replicas, seed 3140) on the card, solved once
# for the hard goals; each lane removes one broker from that placement, and
# RackAwareGoal moves its ~1,180 replicas in three rounds.  The graph path
# must give bit for bit what the eager step gives on the same inputs.

LANE_BROKERS = (3, 17, 28)
# Two eager solves of one lane differ by up to ~2e-6 of a per-broker sum on
# the card (the sums' float adds have no fixed order).
SUM_ORDER_TOL = dict(rtol=1e-5, atol=1e-3)
LANE_WIDTH = 512
GRAPH_SENSORS = ("Solver.round-graph.captures", "Solver.round-graph.replays",
                 "Solver.round-graph.eager-rounds", "Solver.round-graph.capture-failures")


@pytest.fixture(scope="module")
def bench_cluster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: round graphs are captured on the card")
    import json
    from pathlib import Path
    from types import SimpleNamespace

    from ccbench.harness import cluster, program
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer

    cfg = json.loads((Path(__file__).resolve().parents[1]
                      / "ccbench/configs/randomcluster_40b_50k.json").read_text())
    snap = cluster.generate(cfg["cluster"])
    state, placement, meta = program.snapshot(snap.packed, snap.meta_kwargs(), "cuda")
    constraint = program.constraint(cfg["balancing"])
    healthy = GoalOptimizer(constraint=constraint, goal_names=cfg["goals"]["hard"]).optimizations(
        state, placement, meta).final_placement
    return SimpleNamespace(state=state, meta=meta, constraint=constraint, healthy=healthy)


def _lane_contexts(b, brokers=LANE_BROKERS):
    """One lane context a removed broker, from a fresh ``build_context``
    (each request builds its own)."""
    from cruise_control_tpu_torch.analyzer.context import build_context, scenario_context
    from cruise_control_tpu_torch.analyzer.optimizer import _scenario_masks
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions

    gctx = build_context(b.state, b.healthy, b.meta, b.constraint, OptimizationOptions())
    masks = _scenario_masks(gctx, b.state, b.meta, [[b.meta.broker_ids[i]] for i in brokers],
                            False)
    return [scenario_context(gctx, *(m[s] for m in masks)) for s in range(len(brokers))]


def _solve(solver, b, lctx, goal=None):
    from cruise_control_tpu_torch.analyzer.goals.rack import RackAwareGoal
    return solver.optimize_goal(goal or RackAwareGoal(), [], lctx, b.healthy, width=LANE_WIDTH)


def _eager(fn):
    """``fn()`` with every round run eagerly on the card, as when another
    thread holds the key's graph."""
    from cruise_control_tpu_torch.analyzer.solver import GoalSolver
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GoalSolver, "_hold_graph", lambda self, key: (None, "busy"))
        return fn()


def _graph_counts():
    from cruise_control_tpu_torch.common.metrics import registry
    return np.array([registry().counter(n).count for n in GRAPH_SENSORS])


def _bit_equal(got, want):
    """Placements, counts and the goal's numbers, bit for bit.  The float
    aggregates come from the exit's recompute of equal placements, whose
    float adds have no fixed order on the card (two eager solves differ
    alike): they hold to :data:`SUM_ORDER_TOL`."""
    (pl, ag, info), (pl0, ag0, info0) = got, want
    for name in ("broker", "disk", "is_leader"):
        assert torch.equal(getattr(pl, name), getattr(pl0, name)), name
    for name in ag.__dataclass_fields__:
        a, a0 = getattr(ag, name), getattr(ag0, name)
        if a.is_floating_point():
            torch.testing.assert_close(a, a0, **SUM_ORDER_TOL)
        else:
            assert torch.equal(a, a0), name
    for name in ("rounds", "moves_applied", "violated_brokers_before", "violated_brokers_after",
                 "stranded_after", "metric_before", "metric_after"):
        assert getattr(info, name) == getattr(info0, name), name
    assert info.rounds >= 2 and info.moves_applied > 0


@pytest.mark.cuda
def test_round_graph_lanes_back_to_back_equal_eager(bench_cluster):
    """The first lane, the key's first solve, runs eagerly; the second
    captures its first round and replays the rest; the third replays every
    round.  A returned placement is the solve's own: the later lanes'
    copies into the static buffers leave it as it was."""
    from cruise_control_tpu_torch.analyzer.solver import GoalSolver
    from cruise_control_tpu_torch.obsvc.tracer import tracer

    from cruise_control_tpu_torch.obsvc import memory

    lanes = _lane_contexts(bench_cluster)
    want = _eager(lambda: [_solve(GoalSolver(), bench_cluster, l) for l in lanes])
    solver = GoalSolver()
    before = _graph_counts()
    tr = tracer()
    tr.configure(enabled=True, ring_size=32)
    tr.reset()
    was = memory.memory_ledger()
    ledger = memory.DeviceMemoryLedger()
    ledger.configure(enabled=True)
    memory.set_memory_ledger(ledger)
    try:
        got = []
        for lctx in lanes:
            with tr.span("lane"):
                got.append(_solve(solver, bench_cluster, lctx))
        trees = tr.traces()
        # The graph's static buffers are posted; the ledger stays within its
        # bound of the allocator's in-use bytes.
        g, = solver._graphs.values()
        assert ledger.live_bytes("solver.graphs") == g.nbytes == memory.measure_bytes(
            (g.gctx, g.carry, g.ridx)) > 0
        assert ledger.verify_balanced() == []
    finally:
        memory.set_memory_ledger(was)
        tr.configure(enabled=False, ring_size=32)
        tr.reset()
    r0, r1, r2 = (info.rounds for _, _, info in got)
    assert (_graph_counts() - before).tolist() == [1, r1 - 1 + r2, r0, 0]
    how = [[r["attrs"]["graph"] for r in t["children"] if r["name"] == "solve.round"]
           for t in trees]
    assert how == [["eager:first"] * r0, ["capture"] + ["replay"] * (r1 - 1), ["replay"] * r2]
    # A replayed round opens no phase span; eager and captured ones run
    # their phases.
    for t, h in zip(trees, how):
        for r, g in zip([r for r in t["children"] if r["name"] == "solve.round"], h):
            assert ("children" in r) == (g != "replay"), g
            if g != "replay":
                assert r["children"][-1]["name"] == "round.stats"
    statics = {t.data_ptr() for g in solver._graphs.values() for t in (
        g.carry.placement.broker, g.carry.placement.disk, g.carry.placement.is_leader)}
    for (pl, ag, info), w in zip(got, want):
        assert pl.broker.data_ptr() not in statics
        _bit_equal((pl, ag, info), w)


@pytest.mark.cuda
def test_round_graph_replayed_for_the_next_request(bench_cluster):
    """A new request builds a new context and new goal objects: its solves
    replay the graph captured before (on the key's second solve), and
    capture none."""
    from cruise_control_tpu_torch.analyzer.solver import GoalSolver

    solver = GoalSolver()
    for lctx in _lane_contexts(bench_cluster)[:2]:
        _solve(solver, bench_cluster, lctx)
    lctx = _lane_contexts(bench_cluster, brokers=(31,))[0]
    before = _graph_counts()
    got = _solve(solver, bench_cluster, lctx)
    assert (_graph_counts() - before).tolist() == [0, got[2].rounds, 0, 0]
    _bit_equal(got, _eager(lambda: _solve(GoalSolver(), bench_cluster, lctx)))


@pytest.mark.cuda
def test_round_graph_resync_rounds_stay_eager(bench_cluster):
    """A resync every round: the aggregates are recomputed eagerly (the
    aggregate kernel refuses a capture) and copied in before each replay."""
    from cruise_control_tpu_torch.analyzer.solver import GoalSolver

    def resyncing():
        s = GoalSolver()
        s.AGG_RESYNC_ROUNDS = 1
        return s

    lanes = _lane_contexts(bench_cluster)
    want = _eager(lambda: [_solve(resyncing(), bench_cluster, l) for l in lanes])
    solver = resyncing()
    before = _graph_counts()
    launches = aggregate.LAUNCHES
    got = [_solve(solver, bench_cluster, l) for l in lanes]
    r0, r1, r2 = (info.rounds for _, _, info in got)
    rounds = r0 + r1 + r2
    assert (_graph_counts() - before).tolist() == [1, r1 - 1 + r2, r0, 0]
    # Each lane: its entry and exit recomputes, and a resync before every
    # round but its first.
    assert aggregate.LAUNCHES - launches == rounds + len(lanes)
    for g, w in zip(got, want):
        _bit_equal(g, w)


@pytest.mark.cuda
def test_round_graph_capture_failure_falls_back_to_eager(bench_cluster):
    """A goal that reads a device value in its round cannot be captured: the
    failure on the key's second solve is counted once, the key's rounds run
    eagerly from then on, and the answers are the eager step's.  The
    allocator is left as it was."""
    from cruise_control_tpu_torch.analyzer.goals.rack import RackAwareGoal
    from cruise_control_tpu_torch.analyzer.solver import GoalSolver

    class HostReadRackAware(RackAwareGoal):
        def candidate_score(self, gctx, placement, agg):
            score = super().candidate_score(gctx, placement, agg)
            score.sum().item()           # a read back to the host
            return score

    lanes = _lane_contexts(bench_cluster)[:2]
    want = _eager(lambda: [_solve(GoalSolver(), bench_cluster, l, HostReadRackAware())
                           for l in lanes])
    solver = GoalSolver()
    before = _graph_counts()
    got = [_solve(solver, bench_cluster, l, HostReadRackAware()) for l in lanes]
    rounds = sum(info.rounds for _, _, info in got)
    assert (_graph_counts() - before).tolist() == [0, 0, rounds, 1]
    for g, w in zip(got, want):
        _bit_equal(g, w)
    # The caching allocator left capture mode: it empties its cache (which
    # it refuses while a capture is underway), and eager solves give back
    # every byte they take.
    del got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert not torch.cuda.is_current_stream_capturing()

    def allocated_after_solve():
        _solve(solver, bench_cluster, lanes[1], HostReadRackAware())
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    base = allocated_after_solve()
    assert [allocated_after_solve() for _ in range(3)] == [base] * 3
    torch.cuda.empty_cache()
    # The card still takes captures of other keys.
    before = _graph_counts()
    (_, _, first), (_, _, second) = (_solve(solver, bench_cluster, l) for l in lanes)
    assert (_graph_counts() - before).tolist() == [1, second.rounds - 1, first.rounds, 0]


def _two_rounds(solver, goal, lctx, pl):
    """How rounds 0 and 1 of one solve of ``goal`` from ``pl`` ran, and the
    placement they left (cloned out of any static buffers)."""
    from cruise_control_tpu_torch.analyzer.context import compute_aggregates
    from cruise_control_tpu_torch.analyzer.solver import _Carry

    agg = compute_aggregates(lctx, pl)
    c = solver._width(goal, pl.broker.shape[0])
    zero = torch.zeros((), dtype=torch.int64, device=pl.broker.device)
    carry = _Carry(placement=pl, agg=agg, moves=zero, swaps=zero, leader_moves=zero, stall=zero,
                   best_work=zero, best_metric=goal.stats_metric(lctx, pl, agg), cond=zero.repeat(4))
    rs = solver._start_rounds(goal, [], c, solver._phases_runner(goal, (), c), lctx, carry, None)
    try:
        return [rs.run(0), rs.run(1)], rs.placement()
    finally:
        rs.close()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
                                  "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
                                  "CpuCapacityGoal", "ReplicaDistributionGoal",
                                  "PotentialNwOutGoal", "DiskUsageDistributionGoal",
                                  "NetworkInboundUsageDistributionGoal",
                                  "NetworkOutboundUsageDistributionGoal",
                                  "CpuUsageDistributionGoal", "TopicReplicaDistributionGoal",
                                  "LeaderReplicaDistributionGoal",
                                  "LeaderBytesInDistributionGoal",
                                  "KafkaAssignerEvenRackAwareGoal",
                                  "KafkaAssignerDiskUsageDistributionGoal"])
def test_round_graph_every_goal_captures_and_replays_as_eager(bench_cluster, name):
    """Every goal with rounds is capture-safe: its key's second solve
    captures round 0 and replays round 1, no capture fails, and the two
    rounds keep the placement two eager rounds keep."""
    from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name
    from cruise_control_tpu_torch.analyzer.solver import GoalSolver

    lctx = _lane_contexts(bench_cluster)[0]
    pl = bench_cluster.healthy
    solver = GoalSolver()
    before = _graph_counts()
    first, _ = _two_rounds(solver, goal_by_name(name), lctx, pl)
    how, got = _two_rounds(solver, goal_by_name(name), lctx, pl)
    assert (first, how) == (["eager:first"] * 2, ["capture", "replay"])
    assert (_graph_counts() - before).tolist() == [1, 1, 2, 0]
    _, want = _eager(lambda: _two_rounds(GoalSolver(), goal_by_name(name), lctx, pl))
    for field in ("broker", "disk", "is_leader"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


@pytest.mark.cuda
def test_round_graph_direct_goal_runs_eagerly_without_a_capture(bench_cluster):
    """A goal solved by one transform recomputes the aggregates in its round,
    which the aggregate kernel refuses under a capture: its rounds run
    eagerly from the start (``eager:direct``), with no capture tried and
    none counted as failed."""
    from cruise_control_tpu_torch.analyzer.goals.leadership import PreferredLeaderElectionGoal
    from cruise_control_tpu_torch.analyzer.solver import GoalSolver

    lctx = _lane_contexts(bench_cluster)[0]
    solver = GoalSolver()
    before = _graph_counts()
    for _ in range(2):
        how, _ = _two_rounds(solver, PreferredLeaderElectionGoal(), lctx, bench_cluster.healthy)
        assert how == ["eager:direct"] * 2
    assert (_graph_counts() - before).tolist() == [0, 0, 4, 0]
    assert not solver._graphs
