"""The port's monitor layer against the JAX package's.

The first half holds the port to the JAX package's own monitor tests
(``tests/test_monitor.py``), one counterpart each, on the port's classes.
The second half sends the same numpy-seeded samples and the same fake
topology through both packages in this process and compares the outputs:
the aggregator's values, extrapolations and completeness exactly (both are
float64 numpy, so ``atol=0``), and ``LoadMonitor.cluster_model``'s frozen
arrays bit for bit.  The synthetic sampler's jitter hashes a
``(topic, partition)`` tuple with Python's salted ``hash``, so the two
packages agree only within one process, which is why they run side by side.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from cruise_control_tpu.compilesvc.buckets import ShapeBucketPolicy as JBuckets
from cruise_control_tpu.monitor import aggregator as jagg
from cruise_control_tpu.monitor import capacity as jcap
from cruise_control_tpu.monitor import load_monitor as jlm
from cruise_control_tpu.monitor import metadata as jmeta
from cruise_control_tpu.monitor import metric_def as jmd
from cruise_control_tpu.monitor import sampler as jsampler
from cruise_control_tpu.monitor import samples as jsamples
from cruise_control_tpu.monitor import task_runner as jrunner
from cruise_control_tpu_torch.common.exceptions import NotEnoughValidWindowsError
from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
from cruise_control_tpu_torch.model import cpu_model
from cruise_control_tpu_torch.model import ops
from cruise_control_tpu_torch.model.state import state_to_numpy
from cruise_control_tpu_torch.monitor import aggregator as tagg
from cruise_control_tpu_torch.monitor import capacity as tcap
from cruise_control_tpu_torch.monitor import load_monitor as tlm
from cruise_control_tpu_torch.monitor import metadata as tmeta
from cruise_control_tpu_torch.monitor import metric_def as md
from cruise_control_tpu_torch.monitor import sampler as tsampler
from cruise_control_tpu_torch.monitor import samples as tsamples
from cruise_control_tpu_torch.monitor import task_runner as trunner
from cruise_control_tpu_torch.monitor.aggregator import (
    AggregationOptions,
    Extrapolation,
    MetricSampleAggregator,
)
from cruise_control_tpu_torch.monitor.load_monitor import (
    LoadMonitor,
    ModelCompletenessRequirements,
)
from cruise_control_tpu_torch.monitor.metadata import MetadataClient
from cruise_control_tpu_torch.monitor.sample_store import FileSampleStore, NoopSampleStore
from cruise_control_tpu_torch.monitor.sampler import SyntheticWorkloadSampler
from cruise_control_tpu_torch.monitor.samples import BrokerMetricSample, PartitionMetricSample
from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner, RunnerState

W = 1000  # small window, as in tests/test_monitor.py
PACKED_FIELDS = ("leader_load", "follower_load", "partition", "topic", "pos",
                 "orig_broker", "offline", "valid", "capacity", "host", "rack",
                 "alive", "new_broker", "broker_valid", "disk_capacity", "disk_alive")


def _agg(**kw):
    defaults = dict(num_windows=5, window_ms=W, min_samples_per_window=2)
    defaults.update(kw)
    return MetricSampleAggregator(md.COMMON_METRIC_DEF, **defaults)


def _metrics(cpu=1.0, nw_in=10.0, nw_out=5.0, disk=100.0):
    m = np.zeros(md.COMMON_METRIC_DEF.size)
    m[md.CPU_USAGE] = cpu
    m[md.LEADER_BYTES_IN] = nw_in
    m[md.LEADER_BYTES_OUT] = nw_out
    m[md.DISK_USAGE] = disk
    return m


def fill(agg, entity, windows, per_window=2, cpu=1.0, disk=100.0):
    for w in windows:
        for i in range(per_window):
            agg.add_sample(entity, w * W + 10 * (i + 1), _metrics(cpu=cpu, disk=disk))


# ----------------------------------------------- the JAX monitor tests, ported


def test_avg_and_latest_strategies():
    agg = _agg()
    e = ("t", 0)
    agg.add_sample(e, 100, _metrics(cpu=1.0, disk=50.0))
    agg.add_sample(e, 200, _metrics(cpu=3.0, disk=70.0))
    fill(agg, e, [1, 2, 3, 4, 5])
    vae = agg.aggregate(0, 6 * W).values_and_extrapolations[e]
    w0 = vae.windows.index(0)
    assert vae.values[md.CPU_USAGE, w0] == pytest.approx(2.0)
    assert vae.values[md.DISK_USAGE, w0] == pytest.approx(70.0)


def test_avg_available_extrapolation():
    agg = _agg()
    e = ("t", 0)
    fill(agg, e, [0, 1, 2, 3], per_window=2)
    agg.add_sample(e, 4 * W + 10, _metrics())
    fill(agg, e, [5], per_window=1)
    vae = agg.aggregate(0, 6 * W).values_and_extrapolations[e]
    assert vae.extrapolations[vae.windows.index(4)] is Extrapolation.AVG_AVAILABLE


def test_avg_adjacent_extrapolation():
    agg = _agg()
    e = ("t", 0)
    fill(agg, e, [0, 1, 3, 4])
    fill(agg, e, [5], per_window=1)
    vae = agg.aggregate(0, 6 * W).values_and_extrapolations[e]
    w2 = vae.windows.index(2)
    assert vae.extrapolations[w2] is Extrapolation.AVG_ADJACENT
    assert vae.values[md.CPU_USAGE, w2] == pytest.approx(1.0)


def test_forecast_extrapolation_trailing_gap():
    agg = _agg()
    e = ("t", 0)
    fill(agg, e, [0, 1, 2], cpu=2.0)
    fill(agg, ("other", 1), [5], per_window=1)
    vae = agg.aggregate(0, 6 * W).values_and_extrapolations[e]
    w4 = vae.windows.index(4)
    assert vae.extrapolations[w4] in (Extrapolation.FORECAST, Extrapolation.AVG_ADJACENT)
    assert vae.values[md.CPU_USAGE, w4] == pytest.approx(2.0)


def test_entity_invalid_when_leading_windows_empty():
    agg = _agg()
    good, bad = ("t", 0), ("t", 1)
    fill(agg, good, [0, 1, 2, 3, 4])
    fill(agg, bad, [3, 4])
    fill(agg, good, [5], per_window=1)
    res = agg.aggregate(0, 6 * W)
    assert good in res.values_and_extrapolations
    assert bad not in res.values_and_extrapolations
    assert res.completeness.valid_entity_ratio == pytest.approx(0.5)


def test_completeness_gate_raises():
    agg = _agg()
    fill(agg, ("t", 0), [3, 4])
    fill(agg, ("t", 1), [0, 1, 2, 3, 4])
    fill(agg, ("t", 1), [5], per_window=1)
    with pytest.raises(NotEnoughValidWindowsError):
        agg.aggregate(0, 6 * W, AggregationOptions(min_valid_entity_ratio=0.9))


def test_window_rollout_drops_old_samples():
    agg = _agg()
    e = ("t", 0)
    fill(agg, e, [0])
    fill(agg, e, [10])
    assert agg.add_sample(e, 50, _metrics()) is False
    assert agg.num_available_windows() == 5


def test_retain_entities():
    agg = _agg()
    fill(agg, ("t", 0), [0, 1])
    fill(agg, ("t", 1), [0, 1])
    agg.retain_entities({("t", 0)})
    assert agg.all_entities() == [("t", 0)]


def test_out_of_order_samples_dropped_with_counter():
    ctr = registry().counter("Monitor.out-of-order-samples")
    agg = _agg()
    e = ("t", 0)
    fill(agg, e, [0, 1, 2, 3])
    before = ctr.count
    assert agg.add_sample(e, 1 * W + 500, _metrics()) is False
    assert ctr.count == before + 1
    assert agg.add_sample(e, 3 * W + 500, _metrics()) is True
    assert ctr.count == before + 1
    n = agg.add_samples([e, e], np.array([3 * W + 600.0, 4 * W + 10.0]),
                        np.stack([_metrics(), _metrics()]))
    assert n == 2 and ctr.count == before + 1


def test_first_batch_ingest_exempt_from_out_of_order_drop():
    ctr = registry().counter("Monitor.out-of-order-samples")
    before = ctr.count
    agg = _agg()
    e = ("t", 0)
    n = agg.add_samples([e] * 3, np.array([10.0, W + 10.0, 2 * W + 10.0]),
                        np.stack([_metrics()] * 3))
    assert n == 3
    assert ctr.count == before


def test_no_valid_extrapolation_invalidates_entity():
    agg = _agg()
    good, bad = ("t", 0), ("t", 1)
    fill(agg, good, [0, 1, 2, 3, 4])
    fill(agg, bad, [2, 3, 4])
    fill(agg, good, [5], per_window=1)
    res = agg.aggregate(0, 6 * W)
    assert bad not in res.values_and_extrapolations
    comp = res.completeness
    assert comp.num_valid_entities == 1
    assert (comp.num_windows_avg_available + comp.num_windows_avg_adjacent
            + comp.num_windows_forecast) == 0
    assert comp.num_entity_windows == len(comp.valid_windows)


def test_max_extrapolations_overflow_flips_entity_invalid():
    def build(cap):
        agg = _agg(max_allowed_extrapolations_per_entity=cap)
        e = ("t", 0)
        fill(agg, e, [0, 1, 2])
        agg.add_sample(e, 3 * W + 10, _metrics())
        agg.add_sample(e, 4 * W + 10, _metrics())
        fill(agg, e, [5], per_window=1)
        return e, agg.aggregate(0, 6 * W)

    e, res = build(cap=2)
    assert e in res.values_and_extrapolations
    assert res.completeness.num_windows_avg_available == 2
    e, res = build(cap=1)
    assert e not in res.values_and_extrapolations
    assert res.completeness.num_valid_entities == 0
    assert res.completeness.num_windows_avg_available == 0


def test_completeness_by_kind_counts_match_recount():
    agg = _agg(max_allowed_extrapolations_per_entity=4)
    a, b = ("t", 0), ("t", 1)
    fill(agg, a, [0, 1, 3, 4])
    agg.add_sample(a, 2 * W + 10, _metrics())
    fill(agg, b, [0, 1, 2])
    fill(agg, a, [5], per_window=1)
    res = agg.aggregate(0, 6 * W)
    recount = {k: 0 for k in (Extrapolation.AVG_AVAILABLE, Extrapolation.AVG_ADJACENT,
                              Extrapolation.FORECAST)}
    for vae in res.values_and_extrapolations.values():
        for kind in vae.extrapolations.values():
            recount[kind] += 1
    comp = res.completeness
    assert comp.num_windows_avg_available == recount[Extrapolation.AVG_AVAILABLE]
    assert comp.num_windows_avg_adjacent == recount[Extrapolation.AVG_ADJACENT]
    assert comp.num_windows_forecast == recount[Extrapolation.FORECAST]
    assert comp.num_entity_windows == comp.num_valid_entities * len(comp.valid_windows)


def _fake_cluster(num_brokers=3, partitions_per_topic=4, rf=2, pkg=tmeta):
    brokers = [pkg.BrokerInfo(i, rack=str(i % 2), host=f"h{i}") for i in range(num_brokers)]
    parts = []
    for t in ("A", "B"):
        for p in range(partitions_per_topic):
            reps = tuple((p + i) % num_brokers for i in range(rf))
            parts.append(pkg.PartitionInfo(topic=t, partition=p, leader=reps[0],
                                           replicas=reps, in_sync=reps))
    return pkg.FakeMetadataBackend(brokers, parts)


def _monitored(backend, windows=5):
    lm = LoadMonitor(MetadataClient(backend, ttl_ms=0), num_windows=windows, window_ms=W,
                     min_samples_per_window=1)
    runner = LoadMonitorTaskRunner(lm, SyntheticWorkloadSampler(), sampling_interval_ms=W)
    return lm, runner


def test_load_monitor_end_to_end():
    backend = _fake_cluster()
    lm, runner = _monitored(backend)
    runner.bootstrap(0, 6 * W)
    assert lm.meet_completeness_requirements(
        ModelCompletenessRequirements(min_required_num_windows=3,
                                      min_monitored_partitions_percentage=0.9))
    state, placement, meta = lm.cluster_model(0, 6 * W, device="cpu")
    assert meta.num_brokers == 3
    assert meta.num_replicas == 16
    bl = ops.broker_load(state, placement).numpy()
    assert bl[:, 0].sum() > 0 and bl[:, 3].sum() > 0


def test_load_monitor_feeds_optimizer():
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    backend = _fake_cluster()
    lm, runner = _monitored(backend)
    runner.bootstrap(0, 6 * W)
    backend.kill_broker(2)
    state, placement, meta = lm.cluster_model(0, 6 * W, pad_replicas_to=64,
                                              pad_brokers_to=8, device="cpu")
    res = GoalOptimizer(goal_names=["ReplicaCapacityGoal"]).optimizations(
        state, placement, meta, model_generation=lm.model_generation)
    assert len(res.proposals) > 0
    final = res.final_placement.broker[:meta.num_replicas]
    assert bool(state.alive[final].all())


def test_sample_store_roundtrip(tmp_path):
    store = FileSampleStore(str(tmp_path))
    s = PartitionMetricSample(broker_id=1, topic="t", partition=0, time_ms=123.0)
    s.record(md.CPU_USAGE, 0.5)
    stored = registry().counter("Monitor.stored-samples")
    before = stored.count
    store.store_samples([s], [])
    assert stored.count == before + 1
    got = []
    store.load_samples(lambda x: got.append(x), lambda x: None)
    assert len(got) == 1
    assert got[0].topic == "t"
    assert got[0].metrics[md.CPU_USAGE] == pytest.approx(0.5)


def test_file_sample_store_bounded_retention_and_broker_samples(tmp_path):
    """The file store trims to half its cap once over it (newest kept), and
    replays broker samples through their own callback."""
    store = FileSampleStore(str(tmp_path), max_records=10)
    for i in range(25):
        s = PartitionMetricSample(broker_id=0, topic="t", partition=0, time_ms=float(i))
        store.store_samples([s], [BrokerMetricSample(broker_id=i % 3, time_ms=float(i))])
    got_p, got_b = [], []
    n = FileSampleStore(str(tmp_path)).load_samples(got_p.append, got_b.append)
    assert n == len(got_p) + len(got_b) and len(got_p) <= 10 and len(got_b) <= 10
    assert max(s.time_ms for s in got_p) == 24.0 == max(s.time_ms for s in got_b)
    assert NoopSampleStore().load_samples(got_p.append, got_b.append) == 0


def test_task_runner_states_and_pause():
    backend = _fake_cluster()
    lm, runner = _monitored(backend)
    assert runner.state is RunnerState.NOT_STARTED
    runner.start()
    assert runner.state is RunnerState.RUNNING
    runner.pause_sampling("test")
    assert runner.state is RunnerState.PAUSED
    assert runner.paused_reason == "test"
    assert runner.run_sampling_once() == 0
    runner.resume_sampling()
    assert runner.run_sampling_once() > 0
    runner.shutdown()


def test_task_runner_sampling_at_injected_times(tmp_path):
    """Ticks at explicit times fill windows as the bootstrap does, persist
    to the store, and a fresh runner replays the store on start."""
    backend = _fake_cluster()
    lm = LoadMonitor(MetadataClient(backend, ttl_ms=0), num_windows=5, window_ms=W,
                     min_samples_per_window=1)
    runner = LoadMonitorTaskRunner(lm, SyntheticWorkloadSampler(),
                                   sample_store=FileSampleStore(str(tmp_path)),
                                   sampling_interval_ms=W, clock=lambda: 0.0)
    # The sampling thread reads the injected clock, which never reaches a
    # tick: every sample below comes from an explicit time.
    runner.start()
    timer = registry().timer("MetricFetcherManager.partition-samples-fetcher-timer")
    before = timer.stats()["count"]
    for w in range(7):
        assert runner.run_sampling_once(now_ms=w * W + 500) == 8 + 3
    assert timer.stats()["count"] == before + 7
    assert lm.partition_aggregator.num_available_windows() == 5
    runner.shutdown()
    lm2 = LoadMonitor(MetadataClient(backend, ttl_ms=0), num_windows=5, window_ms=W,
                      min_samples_per_window=1)
    replay = LoadMonitorTaskRunner(lm2, SyntheticWorkloadSampler(),
                                   sample_store=FileSampleStore(str(tmp_path)),
                                   clock=lambda: 0.0)
    replay.start()
    replay.shutdown()
    assert lm2.partition_aggregator.generation == 7 * 8
    assert lm2.state().num_valid_windows == lm.state().num_valid_windows == 5


def test_metadata_generation_tracks_changes():
    backend = _fake_cluster()
    client = MetadataClient(backend, ttl_ms=0)
    g0 = client.refresh_metadata().generation
    client.refresh_metadata()
    assert client.generation == g0
    backend.kill_broker(1)
    client.refresh_metadata()
    assert client.generation == g0 + 1


def test_metadata_ttl_and_reassignment():
    """Within the TTL the cached metadata stands; a reassignment shows after
    a forced refresh and bumps the generation."""
    backend = _fake_cluster()
    now = {"t": 0.0}
    client = MetadataClient(backend, ttl_ms=5_000, clock=lambda: now["t"])
    g0 = client.cluster().generation
    backend.apply_reassignment("A", 0, (2, 1))
    assert client.cluster().partitions_of("A")[0].replicas == (0, 1)
    now["t"] = 6.0
    md_ = client.cluster()
    assert md_.partitions_of("A")[0].replicas == (2, 1)
    assert md_.partitions_of("A")[0].leader == 2 and md_.generation == g0 + 1
    backend.set_partitions(md_.partitions[:3])
    assert client.refresh_metadata(force=True).partition_count("A") == 3
    assert client.cluster().topics() == ["A"]


def test_follower_replicas_have_load():
    backend = _fake_cluster()
    lm, runner = _monitored(backend)
    runner.bootstrap(0, 6 * W)
    state, placement, meta = lm.cluster_model(0, 6 * W, device="cpu")
    bl = ops.broker_load(state, placement).numpy()[:meta.num_brokers]
    assert (bl[:, 3] > 0).all()
    assert state.follower_load[:meta.num_replicas, 3].sum() > 0


def test_num_available_windows_epoch_timestamps():
    agg = _agg()
    e = ("t", 0)
    base = 1_700_000
    fill(agg, e, [base // W])
    assert agg.num_available_windows() == 0
    fill(agg, e, [base // W + 1])
    assert agg.num_available_windows() == 1


def test_first_batch_ingest_counts_all_windows():
    agg = _agg()
    e = ("t", 0)
    base = 1_700_000 // W
    fill(agg, e, [base + i for i in range(5)])
    fill(agg, e, [base + 5], per_window=1)
    assert agg.num_available_windows() == 5
    res = agg.aggregate(-np.inf, np.inf)
    assert res.completeness.valid_windows == [base + i for i in range(5)]


def test_completeness_empty_before_first_completed_window():
    agg = _agg()
    fill(agg, ("t", 0), [1_700_000 // W], per_window=1)
    assert agg.completeness(-np.inf, np.inf).valid_windows == []


def test_forecast_is_linear_fit():
    agg = _agg()
    e = ("t", 0)
    for w, cpu in zip([0, 1, 2], [1.0, 2.0, 3.0]):
        fill(agg, e, [w], cpu=cpu)
    fill(agg, ("other", 1), [3, 4], per_window=2)
    fill(agg, ("other", 1), [5], per_window=1)
    vae = agg.aggregate(0, 6 * W).values_and_extrapolations[e]
    w3, w4 = vae.windows.index(3), vae.windows.index(4)
    assert vae.extrapolations[w3] is Extrapolation.FORECAST
    assert vae.values[md.CPU_USAGE, w3] == pytest.approx(4.0, abs=1e-3)
    assert vae.values[md.CPU_USAGE, w4] == pytest.approx(5.0, abs=1e-3)


def test_forecast_far_gap_carries_forward():
    agg = _agg(num_windows=12, max_allowed_extrapolations_per_entity=11)
    e = ("t", 0)
    fill(agg, e, [0], cpu=5.0)
    fill(agg, ("other", 1), list(range(1, 12)))
    fill(agg, ("other", 1), [12], per_window=1)
    vae = agg.aggregate(0, 13 * W).values_and_extrapolations[e]
    for w in (7, 9, 10):
        assert vae.values[md.CPU_USAGE, vae.windows.index(w)] == pytest.approx(5.0, abs=1e-3), w


def test_env_and_topic_config_capacity_resolvers():
    env = {"BROKER_CPU_CAPACITY": "64", "BROKER_NW_IN_CAPACITY": "1e5",
           "BROKER_NW_OUT_CAPACITY": "1e5", "BROKER_DISK_CAPACITY": "5e5",
           "BROKER_NUM_CORES": "8"}
    info = tcap.BrokerEnvCapacityResolver(env=env).capacity_for_broker("r", "h", 3)
    assert info.capacity[Resource.CPU] == 64.0 and info.num_cores == 8
    with pytest.raises(ValueError):
        tcap.BrokerEnvCapacityResolver(env={})
    base = tcap.FixedBrokerCapacityResolver({Resource.CPU: 100.0, Resource.NW_IN: 1e5,
                                             Resource.NW_OUT: 1e5, Resource.DISK: 1e5})
    t = tcap.TopicConfigDiskCapacityResolver(base, {0: 2e5}, headroom_factor=1.5)
    assert t.capacity_for_broker("r", "h", 0).capacity[Resource.DISK] == 3e5
    assert t.capacity_for_broker("r", "h", 1).capacity[Resource.DISK] == 1e5


# ------------------------------------------------- the same inputs, both packages


def _capacity_file(tmp_path):
    doc = {"brokerCapacities": [
        {"brokerId": -1, "capacity": {"CPU": "100", "NW_IN": "50000", "NW_OUT": "40000",
                                      "DISK": "90000"}},
        {"brokerId": 1, "capacity": {"CPU": "50", "NW_IN": "50000", "NW_OUT": "40000",
                                     "DISK": {"/d0": "30000", "/d1": "45000"}},
         "numCores": 8}]}
    path = tmp_path / "capacity.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("kind", ["file", "env", "topic_config", "fixed_jbod"])
def test_capacity_resolvers_equal_jax(kind, tmp_path):
    env = {"BROKER_CPU_CAPACITY": "64", "BROKER_NW_IN_CAPACITY": "1e5",
           "BROKER_NW_OUT_CAPACITY": "2e5", "BROKER_DISK_CAPACITY": "5e5"}

    def make(pkg, res_pkg):
        if kind == "file":
            return pkg.BrokerCapacityConfigFileResolver(_capacity_file(tmp_path))
        if kind == "env":
            return pkg.BrokerEnvCapacityResolver(env=env)
        fixed = pkg.FixedBrokerCapacityResolver(
            {res_pkg.CPU: 10.0, res_pkg.DISK: 200.0}, disk_capacities=[80.0, 120.0])
        if kind == "fixed_jbod":
            return fixed
        return pkg.TopicConfigDiskCapacityResolver(fixed, {0: 300.0, 2: 10.0}, 1.5)

    from cruise_control_tpu.common.resources import Resource as JResource
    j, t = make(jcap, JResource), make(tcap, Resource)
    def ask(resolver, bid, est):
        try:
            info = resolver.capacity_for_broker("r", "h", bid, allow_estimation=est)
        except ValueError as e:
            return str(e)
        return (info.capacity.tolist(), info.disk_capacities, info.num_cores,
                info.estimated, info.estimation_info)

    for bid in range(4):
        for est in (True, False):
            assert ask(j, bid, est) == ask(t, bid, est)


def test_metric_defs_equal_jax():
    for jd, td in ((jmd.COMMON_METRIC_DEF, md.COMMON_METRIC_DEF),
                   (jmd.BROKER_METRIC_DEF, md.BROKER_METRIC_DEF)):
        assert [m.name for m in jd.all_metric_infos()] == [m.name for m in td.all_metric_infos()]
        np.testing.assert_array_equal(jd.strategy_vector(), td.strategy_vector())
        np.testing.assert_array_equal(jd.resource_matrix(), td.resource_matrix())
    assert [t.value for t in jsamples.RawMetricType] == [t.value for t in tsamples.RawMetricType]
    for v in (3, 4, 5):
        assert ([t.name for t in jsamples.broker_metric_types_for_version(v)]
                == [t.name for t in tsamples.broker_metric_types_for_version(v)])


def test_samples_round_trip_like_jax():
    rng = np.random.default_rng(3)
    p = PartitionMetricSample(broker_id=2, topic="T", partition=7, time_ms=11.0,
                              metrics=rng.random(md.COMMON_METRIC_DEF.size))
    b = BrokerMetricSample(broker_id=2, time_ms=12.0, metrics=rng.random(md.BROKER_METRIC_DEF.size))
    for s, jcls in ((p, jsamples.PartitionMetricSample), (b, jsamples.BrokerMetricSample)):
        d = s.to_dict()
        assert jcls.from_dict(d).to_dict() == d == type(s).from_dict(d).to_dict()


def test_synthetic_jitter_and_samples_equal_jax():
    """The same process, so the same salted hash: the two packages' jitter
    and synthetic samples agree exactly."""
    for key in [("A", 0), ("B", 3), ("topic-17", 123), 5]:
        assert tsampler.synthetic_jitter(key) == jsampler.synthetic_jitter(key)
        assert tsampler.synthetic_jitter(key, 11) == jsampler.synthetic_jitter(key, 11)
    jres = jsampler.SyntheticWorkloadSampler().get_samples(
        _fake_cluster(pkg=jmeta).fetch(), 0, W)
    tres = tsampler.SyntheticWorkloadSampler().get_samples(_fake_cluster().fetch(), 0, W)
    assert [s.to_dict() for s in jres.partition_samples] == \
        [s.to_dict() for s in tres.partition_samples]
    assert [s.to_dict() for s in jres.broker_samples] == \
        [s.to_dict() for s in tres.broker_samples]


def test_metrics_processor_equal_jax():
    """Raw reporter metrics through both processors, one partition's rates
    inconsistent with its broker's (dropped and counted)."""
    def raw(pkg):
        T = pkg.RawMetricType
        out = []
        for b, (cpu, bin_, bout) in enumerate([(0.6, 900.0, 700.0), (0.3, 5.0, 400.0),
                                               (0.9, 2000.0, 1500.0)]):
            out += [pkg.CruiseControlMetric(T.BROKER_CPU_UTIL, 1.0, b, value=cpu),
                    pkg.CruiseControlMetric(T.ALL_TOPIC_BYTES_IN, 1.0, b, value=bin_),
                    pkg.CruiseControlMetric(T.ALL_TOPIC_BYTES_OUT, 1.0, b, value=bout),
                    pkg.CruiseControlMetric(T.ALL_TOPIC_REPLICATION_BYTES_IN, 1.0, b,
                                            value=bin_ / 3),
                    pkg.CruiseControlMetric(T.BROKER_LOG_FLUSH_RATE, 1.0, b, value=2.0)]
            # Broker 2's topic rates exceed its own totals: its leaders'
            # samples are inconsistent.
            scale = 3.0 if b == 2 else 0.5
            for t in ("A", "B"):
                out += [pkg.CruiseControlMetric(T.TOPIC_BYTES_IN, 1.0, b, t, value=bin_ * scale),
                        pkg.CruiseControlMetric(T.TOPIC_BYTES_OUT, 1.0, b, t,
                                                value=bout * scale)]
                for p in range(4):
                    out.append(pkg.CruiseControlMetric(T.PARTITION_SIZE, 1.0, b, t, p,
                                                       value=100.0 * p + b))
        return out

    ctr = registry().counter(tsampler.DROPPED_INCONSISTENT_SENSOR)
    before = ctr.count
    jres = jsampler.CruiseControlMetricsProcessor().process(
        _fake_cluster(pkg=jmeta).fetch(), raw(jsamples), 42.0)
    tres = tsampler.CruiseControlMetricsProcessor().process(
        _fake_cluster().fetch(), raw(tsamples), 42.0)
    assert [s.to_dict() for s in jres.partition_samples] == \
        [s.to_dict() for s in tres.partition_samples]
    assert [s.to_dict() for s in jres.broker_samples] == \
        [s.to_dict() for s in tres.broker_samples]
    dropped = ctr.count - before
    assert dropped == 2
    assert len(tres.partition_samples) + dropped == 8


def test_cpu_model_equal_jax():
    from cruise_control_tpu.model import cpu_model as jcpu
    rng = np.random.default_rng(5)
    lin_j, lin_t = jcpu.LinearRegressionCpuModel(min_samples=20), \
        cpu_model.LinearRegressionCpuModel(min_samples=20)
    for _ in range(40):
        a, b, c, d, e = (float(x) for x in rng.uniform(0, 100, 5))
        args = (rng.uniform(0, 1), a, b, c, d * 0.01, e * 0.01)
        assert jcpu.estimate_leader_cpu_util_per_core(*args) == \
            cpu_model.estimate_leader_cpu_util_per_core(*args)
        lin_j.add_sample(a, b, c, 0.01 * a + 0.02 * b + 0.005 * c)
        lin_t.add_sample(a, b, c, 0.01 * a + 0.02 * b + 0.005 * c)
    np.testing.assert_array_equal(lin_j.fit(), lin_t.fit())
    assert lin_t.training_completeness() == 1.0
    fitted_j = jcpu.CpuModelParams(coefficients=lin_j.fit())
    fitted_t = cpu_model.CpuModelParams(coefficients=lin_t.fit())
    assert jcpu.follower_cpu_from_leader_load(5.0, 2.0, 1.0, fitted_j) == \
        cpu_model.follower_cpu_from_leader_load(5.0, 2.0, 1.0, fitted_t)
    assert cpu_model.estimate_leader_cpu_util_per_core(1, 1, 1, 1, 4.0, 2.0, fitted_t) == \
        jcpu.estimate_leader_cpu_util_per_core(1, 1, 1, 1, 4.0, 2.0, fitted_j)


def _stream(seed, common=True):
    """A seeded ingest script: per window, a random number of samples per
    entity (gaps included), jittered times, late samples for windows that
    already closed, and a jump over the ring once in a while."""
    rng = np.random.default_rng(seed)
    size = (md.COMMON_METRIC_DEF if common else md.BROKER_METRIC_DEF).size
    entities = ([("T%d" % (i % 3), i) for i in range(9)] if common else list(range(6)))
    base = int(rng.integers(0, 3)) * 1_700_000 // W
    steps, w = [], base
    for _ in range(14):
        w += 1 if rng.random() > 0.1 else int(rng.integers(2, 9))
        ents, times = [], []
        for e in entities:
            for _ in range(int(rng.choice([0, 1, 1, 2, 3]))):
                ents.append(e)
                times.append(w * W + float(rng.integers(0, W)))
        for _ in range(int(rng.integers(0, 3))):   # late, possibly out of order
            ents.append(entities[int(rng.integers(len(entities)))])
            times.append((w - int(rng.integers(1, 4))) * W + float(rng.integers(0, W)))
        order = rng.permutation(len(ents))
        steps.append(([ents[i] for i in order], np.asarray(times)[order],
                      rng.uniform(0, 100, size=(len(ents), size))))
    return steps


def _equal_results(jres, tres):
    jv, tv = jres.values_and_extrapolations, tres.values_and_extrapolations
    assert list(jv) == list(tv)
    for e in jv:
        assert jv[e].windows == tv[e].windows
        assert {k: v.value for k, v in jv[e].extrapolations.items()} == \
            {k: v.value for k, v in tv[e].extrapolations.items()}
        assert jv[e].values.dtype == tv[e].values.dtype
        np.testing.assert_array_equal(jv[e].values, tv[e].values)
    assert dataclasses.asdict(jres.completeness) == dataclasses.asdict(tres.completeness)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("common", [True, False], ids=["partition", "broker"])
def test_aggregator_equals_jax_on_seeded_streams(seed, common):
    """Values, extrapolation kinds and completeness exactly (atol=0) after
    every batch of a seeded stream with gaps, late and out-of-order
    samples; the accepted counts and generations too."""
    defs = (jmd.COMMON_METRIC_DEF, md.COMMON_METRIC_DEF) if common else \
        (jmd.BROKER_METRIC_DEF, md.BROKER_METRIC_DEF)
    kw = dict(num_windows=4 + seed % 3, window_ms=W, min_samples_per_window=1 + seed % 3,
              max_allowed_extrapolations_per_entity=2 + seed % 2,
              group_of=(lambda e: e[0]) if common else None)
    j = jagg.MetricSampleAggregator(defs[0], **kw)
    t = tagg.MetricSampleAggregator(defs[1], **kw)
    options = [None, AggregationOptions(min_valid_windows=2),
               AggregationOptions(min_valid_entity_ratio=0.6, min_valid_entity_group_ratio=0.3)]
    for ents, times, vals in _stream(seed, common):
        assert j.add_samples(ents, times, vals) == t.add_samples(ents, times, vals)
        assert (j.generation, j.current_window, j.num_available_windows()) == \
            (t.generation, t.current_window, t.num_available_windows())
        for opt in options:
            jopt = None if opt is None else jagg.AggregationOptions(**dataclasses.asdict(opt))
            try:
                jres = j.aggregate(-np.inf, np.inf, jopt)
            except Exception as err:   # noqa: BLE001 — the port must raise alike
                with pytest.raises(NotEnoughValidWindowsError, match=str(err)):
                    t.aggregate(-np.inf, np.inf, opt)
                continue
            _equal_results(jres, t.aggregate(-np.inf, np.inf, opt))
        assert dataclasses.asdict(j.completeness(0, np.inf)) == \
            dataclasses.asdict(t.completeness(0, np.inf))
    keep = set(t.all_entities()[::2])
    j.retain_entities(keep)
    t.retain_entities(keep)
    assert j.all_entities() == t.all_entities()
    assert j.generation == t.generation
    if j.num_available_windows():
        _equal_results(j.aggregate(-np.inf, np.inf), t.aggregate(-np.inf, np.inf))


def _random_topology(pkg, seed, brokers=7, partitions=30, rf=3, leaderless=0):
    rng = np.random.default_rng(seed)
    infos = [pkg.BrokerInfo(i, rack=f"r{i % 3}", host=f"h{i // 2}") for i in range(brokers)]
    parts = []
    for p in range(partitions):
        reps = tuple(int(b) for b in rng.choice(brokers, size=rf, replace=False))
        leader = None if p < leaderless else reps[int(rng.integers(rf))]
        parts.append(pkg.PartitionInfo(topic=f"T{p % 4}", partition=p, leader=leader,
                                       replicas=reps, in_sync=reps))
    return pkg.FakeMetadataBackend(infos, parts)


def _jax_packed(state, placement):
    out = {k: np.asarray(getattr(state, k)) for k in PACKED_FIELDS}
    out["assignment"] = np.asarray(placement.broker)
    out["disk"] = np.asarray(placement.disk)
    out["is_leader"] = np.asarray(placement.is_leader)
    return out


def assert_packed_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), f"{k} differs"


def _same_meta(jm, tm):
    for f in ("broker_ids", "topics", "partitions", "racks", "hosts"):
        assert list(getattr(jm, f)) == list(getattr(tm, f)), f
    assert (jm.num_replicas, jm.num_brokers) == (tm.num_replicas, tm.num_brokers)


def _both_monitors(case, tmp_path):
    """(JAX, port) monitors on the same topology, bootstrapped alike."""
    out = []
    for pkg, lmod, cmod, smod, rmod in ((jmeta, jlm, jcap, jsampler, jrunner),
                                        (tmeta, tlm, tcap, tsampler, trunner)):
        backend = _random_topology(pkg, seed=case["seed"], leaderless=case.get("leaderless", 0))
        resolver = (cmod.BrokerCapacityConfigFileResolver(_capacity_file(tmp_path))
                    if case.get("jbod") else None)
        lm = lmod.LoadMonitor(pkg.MetadataClient(backend, ttl_ms=0), capacity_resolver=resolver,
                              num_windows=5, window_ms=W, min_samples_per_window=1)
        runner = rmod.LoadMonitorTaskRunner(lm, smod.SyntheticWorkloadSampler(seed=case["seed"]),
                                            sampling_interval_ms=W)
        runner.bootstrap(0, case.get("windows", 6) * W)
        for b in case.get("dead", ()):
            backend.kill_broker(b)
        out.append(lm)
    return out


CASES = {"plain": dict(seed=1), "dead_broker": dict(seed=2, dead=(3,)),
         "leaderless": dict(seed=3, leaderless=4), "jbod_capacity": dict(seed=4, jbod=True),
         "two_dead": dict(seed=5, dead=(0, 6), windows=4)}


@pytest.mark.parametrize("case", list(CASES))
def test_cluster_model_equals_jax_bit_for_bit(case, tmp_path):
    """``cluster_model`` (bucket pad targets, and pad-to-multiple) and
    ``cluster_model_builder``'s freeze give the JAX package's arrays."""
    jmon, tmon = _both_monitors(CASES[case], tmp_path)
    assert jmon.model_generation == tmon.model_generation
    js, jp, jm = jmon.cluster_model(pad_fn=JBuckets().pad_targets)
    ts, tp, tm = tmon.cluster_model(pad_fn=ShapeBucketPolicy().pad_targets, device="cpu")
    assert_packed_equal(state_to_numpy(ts, tp), _jax_packed(js, jp))
    _same_meta(jm, tm)
    js, jp, jm = jmon.cluster_model(pad_replicas_to=16, pad_brokers_to=4)
    ts, tp, tm = tmon.cluster_model(pad_replicas_to=16, pad_brokers_to=4, device="cpu")
    assert_packed_equal(state_to_numpy(ts, tp), _jax_packed(js, jp))
    jpk, _ = jmon.cluster_model_builder().freeze_packed(pad_replicas_to=64, pad_brokers_to=8)
    tpk, _ = tmon.cluster_model_builder().freeze_packed(pad_replicas_to=64, pad_brokers_to=8)
    assert_packed_equal(tpk, jpk)
    assert jmon.state().to_dict() == tmon.state().to_dict()
    req = ModelCompletenessRequirements(3, 0.9)
    assert tmon.meet_completeness_requirements(req) == jmon.meet_completeness_requirements(
        jlm.ModelCompletenessRequirements(3, 0.9))


def test_cluster_model_lands_on_the_requested_device(tmp_path):
    """The entry point defaults to the card; the tests pass the CPU."""
    import inspect
    assert inspect.signature(LoadMonitor.cluster_model).parameters["device"].default == "cuda"
    _, tmon = _both_monitors(CASES["plain"], tmp_path)
    ts, tp, _ = tmon.cluster_model(device="cpu")
    assert ts.device == torch.device("cpu") and tp.broker.device == torch.device("cpu")


def test_completeness_requirements_and_sensors():
    """Requirement merging, the monitor's gauges and the generation pair."""
    a = ModelCompletenessRequirements(2, 0.5, False)
    b = ModelCompletenessRequirements(4, 0.2, True)
    assert a.stronger(b) == ModelCompletenessRequirements(4, 0.5, True)
    backend = _fake_cluster()
    lm, runner = _monitored(backend)
    gen0 = lm.model_generation
    runner.bootstrap(0, 6 * W)
    assert lm.model_generation[1] > gen0[1]
    snap = registry().snapshot()
    assert snap["LoadMonitor.num-topics"]["value"] == 2
    assert snap["LoadMonitor.total-monitored-windows"]["value"] == 5
    with pytest.raises(NotEnoughValidWindowsError):
        lm.cluster_model(requirements=ModelCompletenessRequirements(min_required_num_windows=9),
                         device="cpu")



def _monitor_verdicts():
    """scripts/ is not a package; load the verdict script by path."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "monitor_verdicts.py"
    spec = importlib.util.spec_from_file_location("monitor_verdicts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sampler_seed, port, jax", [
    (None, "NetworkOutboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal"),
    (34, "ok", "CpuUsageDistributionGoal")])
def test_default_stack_verdict_on_the_monitor_model_equals_jax(monkeypatch, sampler_seed,
                                                               port, jax):
    """``chip_smoke.py``'s monitor phase accepts the default stack's
    no-worsen verdict on ``MONITOR_NO_WORSEN_GOALS`` only.  Here both
    packages' monitors freeze that phase's model (BASELINE #3 through the
    fake backend, the smoke's windows and capacities) from the same samples,
    equal bit for bit, and each package's default stack gives the outcome
    named: at the sampler's own seed both give the NW_OUT verdict; at seed
    34 the JAX package gives the CPU one and the port completes.  With the
    salted jitter the model, and so the verdict, varies from process to
    process; the salt-free jitter makes it one model."""
    import chip_smoke as smoke
    verdicts = _monitor_verdicts()
    verdicts.use_salt_free_jitter(monkeypatch.setattr)
    res = verdicts.monitor_model_verdicts(sampler_seed)
    assert res["freezes_equal"]
    assert (verdicts.label(res["port"]), verdicts.label(res["jax"])) == (port, jax), res
    for pkg, goal in (("port", port), ("jax", jax)):
        if goal != "ok":
            assert goal in smoke.MONITOR_NO_WORSEN_GOALS
            assert res[pkg]["raised"].startswith(f"[{goal}] optimized result is worse than before")
