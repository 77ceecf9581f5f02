"""The port's anomaly detectors, notifier and manager against the JAX
package's.

The first half holds the port to ``tests/test_detector.py``, one
counterpart each (the maintenance-plan reader is not ported yet).  The
second half runs both packages side by side on the same inputs: the
notifier's decisions under one injected clock, ``BrokerFailureDetector``'s
persisted file, ``GoalViolationDetector``'s fixable and unfixable goals and
balancedness score with both packages' ``LoadMonitor`` over the same fake
topology and samples (the port's solves on the CPU), and the manager's
``state_summary`` with a recording fixer.  The synthetic sampler's jitter
uses Python's salted ``hash``, so the two monitors agree only within one
process, which is why they run in this one.  Everything is compared exactly
apart from wall-clock times and process-wide id counters; the balancedness
score is the same float expression of the same counts in both packages.
"""

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

from cruise_control_tpu_torch.detector.anomalies import (
    AnomalyType,
    BrokerFailures,
    GoalViolations,
    MaintenanceEvent,
    SloViolationAnomaly,
)
from cruise_control_tpu_torch.detector.detectors import (
    BrokerFailureDetector,
    DiskFailureDetector,
    GoalViolationDetector,
    MaintenanceEventDetector,
    MetricAnomalyDetector,
    TopicAnomalyDetector,
)
from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager
from cruise_control_tpu_torch.detector.notifier import (
    AnomalyNotificationResult,
    SelfHealingNotifier,
    WebhookSelfHealingNotifier,
)
from cruise_control_tpu_torch.monitor import metric_def as md
from cruise_control_tpu_torch.monitor.aggregator import MetricSampleAggregator
from cruise_control_tpu_torch.monitor.metadata import MetadataClient
from cruise_control_tpu_torch.obsvc.audit import audit_log

W = 1000
PKGS = {"jax": "cruise_control_tpu", "torch": "cruise_control_tpu_torch"}
VOLATILE = {"detectionMs", "anomalyId", "timestampMs", "id"}


def _mods(root):
    names = dict(anomalies="detector.anomalies", detectors="detector.detectors",
                 manager="detector.manager", notifier="detector.notifier",
                 audit="obsvc.audit", metadata="monitor.metadata",
                 load_monitor="monitor.load_monitor", sampler="monitor.sampler",
                 task_runner="monitor.task_runner")
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                              for k, v in names.items()})


def _cluster(num_brokers=4, mod=None, num_racks=2, rf=2, partitions=8):
    m = (mod or _mods(PKGS["torch"])).metadata
    brokers = [m.BrokerInfo(i, rack=str(i % num_racks), host=f"h{i}")
               for i in range(num_brokers)]
    parts = [m.PartitionInfo("T", p, leader=p % num_brokers,
                             replicas=tuple((p + k) % num_brokers for k in range(rf)),
                             in_sync=(p % num_brokers,))
             for p in range(partitions)]
    return m.FakeMetadataBackend(brokers, parts)


def _monitored(backend, mod=None):
    mod = mod or _mods(PKGS["torch"])
    lm = mod.load_monitor.LoadMonitor(mod.metadata.MetadataClient(backend, ttl_ms=0),
                                      num_windows=5, window_ms=W, min_samples_per_window=1)
    mod.task_runner.LoadMonitorTaskRunner(lm, mod.sampler.SyntheticWorkloadSampler(),
                                          sampling_interval_ms=W).bootstrap(0, 6 * W)
    return lm


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


class StubDetector:
    def __init__(self, anomaly):
        self.anomaly = anomaly
        self.fired = False

    def detect(self):
        if self.fired:
            return []
        self.fired = True
        return [self.anomaly]


# ------------------------------------------- the JAX detector tests, ported


def test_broker_failure_detector_tracks_and_persists(tmp_path):
    backend = _cluster()
    client = MetadataClient(backend, ttl_ms=0)
    path = str(tmp_path / "failed.json")
    clock = {"now": 1_000.0}
    det = BrokerFailureDetector(client, persist_path=path, clock=lambda: clock["now"])
    assert det.detect() == []
    backend.kill_broker(2)
    found = det.detect()
    assert len(found) == 1 and isinstance(found[0], BrokerFailures)
    assert found[0].failed_brokers == {2: 1_000.0}
    clock["now"] = 9_999.0
    det2 = BrokerFailureDetector(client, persist_path=path, clock=lambda: clock["now"])
    assert det2.detect()[0].failed_brokers == {2: 1_000.0}


def test_goal_violation_detector_flags_and_skips_same_generation():
    backend = _cluster()
    lm = _monitored(backend)
    backend.kill_broker(3)
    det = GoalViolationDetector(lm, goal_names=["ReplicaCapacityGoal"], device="cpu")
    found = det.detect()
    assert len(found) == 1
    assert found[0].fixable_violated_goals == ["ReplicaCapacityGoal"]
    assert det.detect() == []


def test_disk_failure_detector():
    assert DiskFailureDetector(lambda: {1: [0]}).detect()[0].failed_disks == {1: [0]}
    assert DiskFailureDetector(lambda: {}).detect() == []


def test_metric_anomaly_detector_flags_slow_broker():
    agg = MetricSampleAggregator(md.BROKER_METRIC_DEF, num_windows=5, window_ms=W,
                                 min_samples_per_window=1)
    flush = md.BROKER_METRIC_DEF.metric_id("BROKER_LOG_FLUSH_TIME_MS_MEAN")
    for w in range(6):
        for b in range(4):
            m = np.zeros(md.BROKER_METRIC_DEF.size)
            m[flush] = 100.0 if (b == 3 and w == 4) else 1.0
            agg.add_sample(b, w * W + 10, m)
    found = MetricAnomalyDetector(agg, percentile=90, margin=1.5,
                                  slow_broker_demotion_score=1).detect()
    assert any(a.broker_id == 3 for a in found)


def test_topic_anomaly_detector_rf():
    found = TopicAnomalyDetector(MetadataClient(_cluster(), ttl_ms=0),
                                 target_replication_factor=3).detect()
    assert len(found) == 1 and found[0].topic == "T"
    assert found[0].target_replication_factor == 3


def test_maintenance_event_idempotence():
    det = MaintenanceEventDetector(idempotence_ttl_ms=1e9)
    assert det.submit(MaintenanceEvent(plan="rebalance")) is True
    assert det.submit(MaintenanceEvent(plan="rebalance")) is False
    assert det.submit(MaintenanceEvent(plan="remove_broker", broker_ids=(1,)))
    assert len(det.detect()) == 2
    assert det.detect() == []


def test_self_healing_notifier_broker_failure_grace_periods():
    clock = {"now": 0.0}
    alerts = []
    notifier = SelfHealingNotifier(
        self_healing_enabled=True, alert_callback=lambda a, fix: alerts.append(fix),
        clock=lambda: clock["now"], broker_failure_alert_threshold_ms=100,
        broker_failure_self_healing_threshold_ms=200)
    a = BrokerFailures(failed_brokers={1: 0.0})
    assert notifier.on_anomaly(a).result is AnomalyNotificationResult.CHECK
    clock["now"] = 150.0
    assert notifier.on_anomaly(a).result is AnomalyNotificationResult.CHECK
    assert len(alerts) == 1
    clock["now"] = 250.0
    assert notifier.on_anomaly(a).result is AnomalyNotificationResult.FIX


def test_manager_priority_and_fix_dispatch():
    fixed = []
    notifier = SelfHealingNotifier(self_healing_enabled=True, clock=lambda: 1e12,
                                   broker_failure_alert_threshold_ms=0,
                                   broker_failure_self_healing_threshold_ms=0)
    mgr = AnomalyDetectorManager(
        {AnomalyType.GOAL_VIOLATION: StubDetector(
            GoalViolations(fixable=["ReplicaDistributionGoal"])),
         AnomalyType.BROKER_FAILURE: StubDetector(BrokerFailures(failed_brokers={1: 0.0}))},
        notifier=notifier, fixer=lambda a: fixed.append(a.anomaly_type) or True)
    mgr.run_detection_once()
    assert fixed == [AnomalyType.BROKER_FAILURE, AnomalyType.GOAL_VIOLATION]
    assert mgr.state_summary()["metrics"]["FIX_STARTED"] == 2


def test_manager_threads_stop_within_bounded_joins():
    mgr = AnomalyDetectorManager({AnomalyType.DISK_FAILURE: DiskFailureDetector(dict)},
                                 detection_interval_s=0.01)
    mgr.start_detection()
    mgr.shutdown()
    assert not any(t.is_alive() for t in mgr._threads)


def test_webhook_notifier_posts_and_survives_failure():
    posts = []
    n = WebhookSelfHealingNotifier("http://hook.invalid/x", channel="#alerts",
                                   post_fn=posts.append, self_healing_enabled=False)
    a = GoalViolations(fixable=["RackAwareGoal"])
    assert n.on_anomaly(a).result.name == "IGNORE"
    assert posts and "GOAL_VIOLATION" in posts[0]["text"] and posts[0]["channel"] == "#alerts"

    def boom(payload):
        raise OSError("webhook down")
    WebhookSelfHealingNotifier("http://hook.invalid/x", post_fn=boom,
                               self_healing_enabled=False).on_anomaly(a)


def test_slo_violation_flows_to_audit_as_ignored():
    fixed = []
    notifier = SelfHealingNotifier(self_healing_enabled=True, clock=lambda: 1e12,
                                   broker_failure_alert_threshold_ms=0,
                                   broker_failure_self_healing_threshold_ms=0)
    mgr = AnomalyDetectorManager(
        {AnomalyType.SLO_VIOLATION: StubDetector(SloViolationAnomaly(
            objective="solve-time", sensor="GoalOptimizer.x", threshold=100.0,
            worst_value=250.0, burn_rate_short=3.0, burn_rate_long=2.0))},
        notifier=notifier, fixer=lambda a: fixed.append(a.anomaly_type) or True)
    audit_log().clear()
    try:
        mgr.run_detection_once()
        assert fixed == []
        entries = [e for e in audit_log().entries() if e["anomalyType"] == "SLO_VIOLATION"]
        assert entries and entries[-1]["decision"] == "IGNORED"
        assert entries[-1]["description"]["objective"] == "solve-time"
        assert entries[-1]["description"]["burnRateShort"] == 3.0
        assert mgr.state_summary()["metrics"].get("FIX_STARTED", 0) == 0
    finally:
        audit_log().clear()


# -------------------------------------- both packages on the same inputs


@pytest.mark.parametrize("enabled,alert_ms,fix_ms", [(True, 100, 200), (False, 100, 200),
                                                    (True, 0, 0), (True, 300, 150)])
def test_notifier_decisions_equal_jax(enabled, alert_ms, fix_ms):
    """One injected clock, the same anomalies in the same order: the same
    decisions, delays and alert callbacks."""
    got = {}
    for root in PKGS:
        mod = _mods(PKGS[root])
        a = mod.anomalies
        clock = {"now": 0.0}
        alerts = []
        n = mod.notifier.SelfHealingNotifier(
            self_healing_enabled=enabled, clock=lambda: clock["now"],
            alert_callback=lambda an, fix: alerts.append((an.anomaly_type.name, fix)),
            broker_failure_alert_threshold_ms=alert_ms,
            broker_failure_self_healing_threshold_ms=fix_ms)
        n.set_self_healing_for(a.AnomalyType.TOPIC_ANOMALY, False)
        bf = a.BrokerFailures(failed_brokers={1: 0.0, 2: 40.0})
        seq = [bf, a.GoalViolations(fixable=["RackAwareGoal"]),
               a.DiskFailures(failed_disks={1: [0]}), a.TopicAnomaly(topic="T", reason="rf"),
               a.BrokerFailures(failed_brokers={})]
        out = []
        for now in (0.0, 99.0, 150.0, 199.0, 250.0, 400.0):
            clock["now"] = now
            for an in seq:
                act = n.on_anomaly(an)
                out.append((now, an.anomaly_type.name, act.result.name, act.delay_ms))
        slo = a.SloViolationAnomaly(objective="x")
        out.append(("slo", n.on_anomaly(slo).result.name))
        got[root] = (out, alerts, {t.name: v for t, v in n.self_healing_enabled().items()})
    assert got["torch"] == got["jax"]


def test_broker_failure_persisted_file_equals_jax(tmp_path):
    files = {}
    for root in PKGS:
        mod = _mods(PKGS[root])
        backend = _cluster(6, mod=mod)
        client = mod.metadata.MetadataClient(backend, ttl_ms=0)
        path = tmp_path / f"{root}.json"
        clock = {"now": 1_000.0}
        det = mod.detectors.BrokerFailureDetector(client, persist_path=str(path),
                                                  clock=lambda: clock["now"])
        seen = [det.detect()]
        for now, kill in ((2_000.0, 4), (3_000.0, 1), (4_000.0, None)):
            clock["now"] = now
            if kill is not None:
                backend.kill_broker(kill)
            seen.append([a.failed_brokers for a in det.detect()])
        files[root] = (path.read_text(), seen, det.failed_brokers)
        restarted = mod.detectors.BrokerFailureDetector(client, persist_path=str(path),
                                                        clock=lambda: 9e9)
        files[root] += (restarted.detect()[0].failed_brokers,)
    assert files["torch"] == files["jax"]
    assert json.loads(files["torch"][0]) == {"4": 2000.0, "1": 3000.0}


@pytest.mark.parametrize("case", ["dead-broker", "rack-unfixable", "healthy-subset"])
def test_goal_violation_detector_equals_jax(case):
    """Both packages' monitors over the same topology and samples, the
    detector's six hard goals (or a subset) solved once each: the same
    fixable and unfixable lists and balancedness score."""
    kw = dict(num_brokers=6, num_racks=3, rf=3, partitions=24)
    goals = None
    if case == "rack-unfixable":
        kw.update(num_racks=2)
        goals = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal"]
    elif case == "healthy-subset":
        goals = ["RackAwareGoal", "ReplicaCapacityGoal"]
    got = {}
    for root in PKGS:
        mod = _mods(PKGS[root])
        backend = _cluster(mod=mod, **kw)
        lm = _monitored(backend, mod=mod)
        if case == "dead-broker":
            backend.kill_broker(3)
        extra = {"device": "cpu"} if root == "torch" else {}
        det = mod.detectors.GoalViolationDetector(lm, goal_names=goals, **extra)
        found = det.detect()
        got[root] = ([(a.anomaly_type.name, a.fixable_violated_goals,
                       a.unfixable_violated_goals) for a in found],
                     det.last_balancedness_score, det.goal_names, det.detect())
    assert got["torch"] == got["jax"]
    found, score, names, again = got["torch"]
    assert again == []
    if case == "dead-broker":
        assert found and found[0][1] == names and score == 0.0
    elif case == "rack-unfixable":
        assert found and "RackAwareGoal" in found[0][2]
    else:
        assert found == [] and score == 100.0


def _manager_run(root):
    mod = _mods(PKGS[root])
    a = mod.anomalies
    fixed = []

    def fixer(anomaly):
        fixed.append(anomaly.anomaly_type.name)
        if anomaly.anomaly_type is a.AnomalyType.DISK_FAILURE:
            raise RuntimeError("fix blew up")
        return anomaly.anomaly_type is not a.AnomalyType.METRIC_ANOMALY

    class Broken:
        def detect(self):
            raise RuntimeError("detector down")

    clock = {"now": 0.0}
    notifier = mod.notifier.SelfHealingNotifier(
        self_healing_enabled=True, clock=lambda: clock["now"] * 1000.0,
        broker_failure_alert_threshold_ms=1000, broker_failure_self_healing_threshold_ms=2000)
    notifier.set_self_healing_for(a.AnomalyType.TOPIC_ANOMALY, False)
    mgr = mod.manager.AnomalyDetectorManager(
        {a.AnomalyType.BROKER_FAILURE: StubDetector(
            a.BrokerFailures(failed_brokers={3: 0.0}, detection_time_ms=0.0)),
         a.AnomalyType.GOAL_VIOLATION: StubDetector(a.GoalViolations(
             fixable=["RackAwareGoal"], unfixable=["DiskCapacityGoal"], detection_time_ms=1.0)),
         a.AnomalyType.DISK_FAILURE: StubDetector(a.DiskFailures(failed_disks={1: [0]},
                                                                 detection_time_ms=2.0)),
         a.AnomalyType.METRIC_ANOMALY: StubDetector(a.MetricAnomaly(
             broker_id=2, metric_name="m", current_value=5.0, threshold=1.0,
             detection_time_ms=3.0)),
         a.AnomalyType.TOPIC_ANOMALY: StubDetector(a.TopicAnomaly(topic="T", reason="rf",
                                                                  detection_time_ms=4.0)),
         a.AnomalyType.MAINTENANCE_EVENT: Broken()},
        notifier=notifier, fixer=fixer, clock=lambda: clock["now"])
    mod.audit.audit_log().clear()
    try:
        steps = [mgr.run_detection_once()]
        for now in (0.5, 1.5, 2.5):
            clock["now"] = now
            steps.append(mgr.handle_pending())
        summary = mgr.state_summary()
    finally:
        mod.audit.audit_log().clear()
    return _scrub(summary), fixed, steps


def test_manager_state_summary_equals_jax():
    got = {root: _manager_run(root) for root in PKGS}
    assert got["torch"] == got["jax"]
    summary, fixed, steps = got["torch"]
    assert fixed == ["DISK_FAILURE", "METRIC_ANOMALY", "GOAL_VIOLATION", "BROKER_FAILURE"]
    assert summary["metrics"]["FIX_STARTED"] == 2
    assert summary["metrics"]["FIX_FAILED_TO_START"] == 2
    assert [e["decision"] for e in summary["selfHealingAudit"]].count("FIX") == 4


# The optimizer's gauges under the same prefix, registered by whichever solve
# ran earlier in the process (tests/test_torch_sensors.py holds those).
OPTIMIZER_SENSORS = {"AnomalyDetector.under-provisioned", "AnomalyDetector.right-sized",
                     "AnomalyDetector.over-provisioned", "AnomalyDetector.balancedness-score"}


def test_sensor_names_equal_jax():
    """The manager's, the executor's and the flight recorder's sensors carry
    the JAX package's names in the port's registry."""
    names = {}
    for root in PKGS:
        mod = _mods(PKGS[root])
        ex = importlib.import_module(f"{PKGS[root]}.executor.executor")
        backend = importlib.import_module(f"{PKGS[root]}.executor.backend")
        importlib.import_module(f"{PKGS[root]}.obsvc.execution")
        a = mod.anomalies.AnomalyType
        mod.manager.AnomalyDetectorManager({t: StubDetector(None) for t in a})
        ex.Executor(backend.FakeClusterBackend(_cluster(mod=mod)))
        snap = importlib.import_module(f"{PKGS[root]}.common.metrics").registry().snapshot()
        names[root] = sorted(k for k in snap if k.startswith(("Executor.", "AnomalyDetector."))
                             and k not in OPTIMIZER_SENSORS)
    assert names["torch"] == names["jax"]
    assert "AnomalyDetector.broker_failure-rate" in names["torch"]
    assert "Executor.execution-started" in names["torch"]
    assert "Executor.moves-per-second" in names["torch"]
