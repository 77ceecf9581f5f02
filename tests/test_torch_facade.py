"""The port's facade (``CruiseControl``) against the JAX package's.

Counterparts of ``tests/test_facade.py``'s nine tests, plus the facade's
staleness gate (``tests/test_fidelity.py``), its ``/health`` rollup
(``tests/test_resilience.py``), budgets and the shutdown drain.  Each test
builds both packages' stacks with ``build_stack`` (the same metadata and the
synthetic sampler's samples, which depend only on the seed and the process's
string hash, so both packages see equal loads) and runs the same operations
on both; the port runs on the CPU.  Equal between the two:

- the frozen model each solve saw, the proposal counts, and the JAX
  package's ``verify_placement`` verdict on each final placement (the port's
  failures never more than JAX's);
- the executor's task states and the cluster's final replicas;
- the audit and operation-log records, with clocks and ids scrubbed;
- the keys of ``state()`` (``memoryState`` included), and the resident
  model's freeze and apply counts.

Stacks default to a short goal list, so the JAX side compiles a few goals,
not the 15-goal stack.
"""

from __future__ import annotations

import importlib
import logging
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = {"jax": "cruise_control_tpu", "torch": "cruise_control_tpu_torch"}
W = 1000
GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal"]
CLOCK_KEYS = {"id", "timestampMs", "ageMs", "frozenAtMs", "startedMs", "durationMs",
              "movesPerSecond", "executionId", "atMs", "closedAtMs", "ingestCommitMs",
              "detectionMs", "anomalyId"}
# A fix's execution outcome is attached to its audit entry only if the manager
# marked the entry FIX_STARTED before the execution ended; a four-task
# execution can end first, in either package (ROADMAP Queue 3).
RACY_KEYS = {"executionOutcome"}


def _mods(root):
    names = dict(
        anomalies="detector.anomalies", notifier="detector.notifier",
        backend="executor.backend", executor="executor.executor", facade="facade",
        load_monitor="load_monitor", metadata="monitor.metadata", sampler="monitor.sampler",
        task_runner="monitor.task_runner", exceptions="common.exceptions",
        audit="obsvc.audit", oplog="obsvc.oplog", fidelity="obsvc.fidelity",
        metrics="common.metrics", optimizer="analyzer.optimizer", resilience="resilience",
        circuit="resilience.circuit")
    out = {}
    for k, v in names.items():
        mod = "monitor.load_monitor" if v == "load_monitor" else v
        out[k] = importlib.import_module(f"{root}.{mod}")
    out["root"] = root
    return SimpleNamespace(**out)


def build_stack(m, num_brokers=4, partitions=8, rf=2, self_healing=False, **cc_kwargs):
    """tests/test_facade.py's stack, in package ``m``."""
    md = m.metadata
    brokers = [md.BrokerInfo(i, rack=str(i % 2), host=f"h{i}") for i in range(num_brokers)]
    parts = [md.PartitionInfo("T", p, leader=p % num_brokers,
                              replicas=tuple((p + i) % num_brokers for i in range(rf)),
                              in_sync=(p % num_brokers,))
             for p in range(partitions)]
    backend = md.FakeMetadataBackend(brokers, parts)
    lm = m.load_monitor.LoadMonitor(md.MetadataClient(backend, ttl_ms=0), num_windows=5,
                                    window_ms=W, min_samples_per_window=1)
    runner = m.task_runner.LoadMonitorTaskRunner(lm, m.sampler.SyntheticWorkloadSampler(),
                                                 sampling_interval_ms=W)
    runner.bootstrap(0, 6 * W)
    cluster = m.backend.FakeClusterBackend(backend, polls_to_finish=1)
    ex = m.executor.Executor(cluster, m.executor.ExecutorConfig(progress_check_interval_s=0.001))
    notifier = m.notifier.SelfHealingNotifier(
        self_healing_enabled=self_healing, clock=lambda: time.time() * 1000,
        broker_failure_alert_threshold_ms=0, broker_failure_self_healing_threshold_ms=0)
    kwargs = dict(default_goals=GOALS, self_healing_goals=["RackAwareGoal"])
    kwargs.update(cc_kwargs)
    if m.root == PKGS["torch"]:
        kwargs["device"] = "cpu"
    cc = m.facade.CruiseControl(lm, ex, task_runner=runner, notifier=notifier, **kwargs)
    return cc, backend, cluster


def _wait_executor_idle(cc, timeout=60.0):
    """Wait for the execution itself: join the executor's thread (the
    batch's audit outcome and operation-log line come at its end, after the
    state goes idle), then check the executor is idle."""
    thread = cc.executor._thread
    if thread is not None:
        thread.join(timeout)
        assert not thread.is_alive(), f"the execution did not end within {timeout} s"
    assert not cc.executor.has_ongoing_execution


def _hold_execution(cluster):
    """An event that holds the admin backend's first reassignment until it is
    set, so an execution started by a fix cannot end before the fixer and
    the manager have recorded the fix (their operation-log and audit lines
    then come in one order in both packages)."""
    gate = threading.Event()
    reassign = cluster.execute_replica_reassignments

    def held(tasks):
        assert gate.wait(60.0), "the held execution was never released"
        return reassign(tasks)

    cluster.execute_replica_reassignments = held
    return gate


class _Solves:
    """Records every (state, placement, meta, result) the package's optimizer
    solved, by wrapping ``GoalOptimizer.optimizations``."""

    def __init__(self, m, monkeypatch):
        self.calls = []
        orig = m.optimizer.GoalOptimizer.optimizations

        def wrapped(opt, state, placement, meta, *args, **kwargs):
            result = orig(opt, state, placement, meta, *args, **kwargs)
            self.calls.append((state, placement, meta, result))
            return result

        monkeypatch.setattr(m.optimizer.GoalOptimizer, "optimizations", wrapped)


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _check_solves(jsolves, tsolves, goals):
    """The same frozen inputs, equal proposal counts, and the JAX verifier's
    verdict on the port's placement no worse than on the JAX package's."""
    import jax.numpy as jnp

    from cruise_control_tpu.model.state import Placement as JPlacement
    from cruise_control_tpu.testing.verifier import verify_placement

    assert len(tsolves.calls) == len(jsolves.calls) > 0
    for (js, jp, jm, jres), (ts, tp, tm, tres) in zip(jsolves.calls, tsolves.calls):
        for name in js.__dataclass_fields__:
            np.testing.assert_array_equal(_np(getattr(ts, name)), _np(getattr(js, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(_np(tp.broker), _np(jp.broker))
        np.testing.assert_array_equal(_np(tp.is_leader), _np(jp.is_leader))
        assert tm.broker_ids == jm.broker_ids
        assert len(tres.proposals) == len(jres.proposals)
        assert tres.violated_goals_after == jres.violated_goals_after
        tfinal = JPlacement(*(jnp.asarray(_np(getattr(tres.final_placement, f)))
                              for f in ("broker", "disk", "is_leader")))
        names = [i.goal_name for i in jres.goal_infos]
        jfail = verify_placement(js, jp, jm, jres.final_placement, goal_names=names)
        tfail = verify_placement(js, jp, jm, tfinal, goal_names=names)
        assert len(tfail) <= len(jfail), (tfail, jfail)


def _task_states(cc):
    return cc.executor.tracker.summary()


def _replicas(backend):
    return {(p.topic, p.partition): (p.leader, tuple(p.replicas)) for p in backend.fetch().partitions}


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: sorted(v) if k == "failedBrokers" else _scrub(v)   # broker -> failure time
                for k, v in obj.items()
                if k not in CLOCK_KEYS and k not in RACY_KEYS}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    return obj


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def both(monkeypatch):
    """Both packages' modules, their solves recorded, their audit logs and
    operation logs cleared and captured."""
    out = {}
    for name, root in PKGS.items():
        m = _mods(root)
        m.solves = _Solves(m, monkeypatch)
        m.audit.audit_log().clear()
        m.oplog_lines = _Capture()
        m.oplog.OPLOG.addHandler(m.oplog_lines)
        # A test earlier in the process may have configured logging: enable
        # the operation log at INFO (setLevel also clears the logger's cache).
        m.oplog_level = m.oplog.OPLOG.level
        m.oplog.OPLOG.setLevel(logging.INFO)
        monkeypatch.setattr(m.oplog.OPLOG, "disabled", False)
        out[name] = m
    yield out
    for m in out.values():
        m.oplog.OPLOG.removeHandler(m.oplog_lines)
        m.oplog.OPLOG.setLevel(m.oplog_level)
        m.audit.audit_log().clear()


def _oplog(m):
    """The operation log's ``key=value`` lines as scrubbed dicts."""
    import shlex
    return [_scrub(dict(tok.split("=", 1) for tok in shlex.split(line)))
            for line in m.oplog_lines.lines]


# ------------------------------------------------ tests/test_facade.py, ported


def test_rebalance_dryrun_and_state(both):
    got = {}
    for name, m in both.items():
        cc, backend, cluster = build_stack(m)
        before = cc.resident.stats()
        r = cc.rebalance(goals=["ReplicaDistributionGoal"], dryrun=True)
        assert r.dryrun and not r.executed
        s = cc.state()
        # The resident sensors are process-wide: compare this stack's share.
        resident = s["AnalyzerState"]["residentModel"]
        for k in ("fullFreezes", "deltaApplies", "invalidations"):
            resident[k] -= before[k]
        assert s["MonitorState"]["numValidWindows"] == 5
        assert s["ExecutorState"]["state"] == "NO_TASK_IN_PROGRESS"
        got[name] = (r, s, cc.broker_stats(), cc.partition_load(max_entries=5), cc.health())
    _check_solves(both["jax"].solves, both["torch"].solves, ["ReplicaDistributionGoal"])
    (jr, js, jstats, jload, jhealth), (tr, ts, tstats, tload, thealth) = got["jax"], got["torch"]
    assert _keys(ts) == _keys(js)
    assert ts["MonitorState"] == {**js["MonitorState"],
                                  "modelQualityState": ts["MonitorState"]["modelQualityState"]}
    assert ts["AnalyzerState"]["residentModel"] == js["AnalyzerState"]["residentModel"]
    assert ts["AnalyzerState"]["residentModel"]["fullFreezes"] == 1
    assert _scrub(tr.to_dict()) == _scrub(jr.to_dict())
    assert _keys(tstats, 1) == _keys(jstats, 1)
    assert [e["topic"] for e in tload] == [e["topic"] for e in jload] and len(tload) == 5
    for te, je in zip(tload, jload):
        assert te == pytest.approx(je, rel=1e-6)
    assert thealth == jhealth and thealth["status"] == "ready"


def test_remove_broker_executes_against_cluster(both):
    got = {}
    for name, m in both.items():
        cc, backend, cluster = build_stack(m)
        r = cc.remove_brokers([3], goals=["RackAwareGoal", "ReplicaCapacityGoal"], dryrun=False)
        assert r.executed
        _wait_executor_idle(cc)
        md = backend.fetch()
        assert all(3 not in p.replicas for p in md.partitions)
        assert len(cluster.reassignment_log) == len(r.optimizer_result.proposals)
        got[name] = (_task_states(cc), cc.executor.state_summary())
    _check_solves(both["jax"].solves, both["torch"].solves, None)
    assert got["torch"][0] == got["jax"][0]
    assert _scrub(got["torch"][1]) == _scrub(got["jax"][1])
    assert _oplog(both["torch"]) == _oplog(both["jax"])


def test_demote_broker_moves_leadership(both):
    got = {}
    for name, m in both.items():
        cc, backend, cluster = build_stack(m)
        r = cc.demote_brokers([0], dryrun=False)
        if r.executed:
            _wait_executor_idle(cc)
            assert all(p.leader != 0 for p in backend.fetch().partitions)
        got[name] = (r.executed, _task_states(cc), _replicas(backend))
    _check_solves(both["jax"].solves, both["torch"].solves, None)
    assert got["torch"] == got["jax"]


def test_topic_rf_change(both):
    got = {}
    for name, m in both.items():
        cc, backend, cluster = build_stack(m)
        r = cc.change_topic_replication_factor(
            "T", 3, goals=["RackAwareDistributionGoal", "ReplicaCapacityGoal"], dryrun=False)
        assert r.optimizer_result is not None
        if r.executed:
            _wait_executor_idle(cc)
            assert all(len(p.replicas) == 3 for p in backend.fetch().partitions)
        got[name] = (r.executed, _task_states(cc))
    _check_solves(both["jax"].solves, both["torch"].solves, None)
    assert got["torch"] == got["jax"]


def test_concurrent_operation_guard(both):
    for m in both.values():
        cc, backend, cluster = build_stack(m)
        cluster.polls_to_finish = 500
        r = cc.remove_brokers([3], goals=["ReplicaCapacityGoal"], dryrun=False)
        assert r.executed
        with pytest.raises(m.exceptions.OngoingExecutionError):
            cc.rebalance(dryrun=False)
        cc.stop_execution()
        _wait_executor_idle(cc)
    assert _oplog(both["torch"]) == _oplog(both["jax"])


def test_self_healing_broker_failure_end_to_end(both):
    got = {}
    for name, m in both.items():
        cc, backend, cluster = build_stack(m, self_healing=True)
        # The dead broker also violates rack awareness; whether that fix starts
        # depends on whether the broker's execution has ended, so it is off.
        cc.set_self_healing(m.anomalies.AnomalyType.GOAL_VIOLATION, False)
        backend.kill_broker(2)
        n = cc.anomaly_detector.run_detection_once()
        assert n >= 1
        _wait_executor_idle(cc)
        assert all(2 not in p.replicas for p in backend.fetch().partitions)
        summary = cc.anomaly_detector.state_summary()
        assert summary["metrics"].get("FIX_STARTED", 0) >= 1
        got[name] = (n, summary["metrics"], _task_states(cc),
                     m.audit.audit_log().entries())
    _check_solves(both["jax"].solves, both["torch"].solves, None)
    assert got["torch"][:3] == got["jax"][:3]
    assert _scrub(got["torch"][3]) == _scrub(got["jax"][3])
    fix = [e for e in got["torch"][3] if e["anomalyType"] == "BROKER_FAILURE"][-1]
    assert fix["decision"] == "FIX" and fix["action"] == "remove_broker"
    assert fix["outcome"] == "FIX_STARTED"
    assert _fix_finish_first(_oplog(both["torch"])) == _fix_finish_first(_oplog(both["jax"]))


def _fix_finish_first(lines):
    """The fix's "finish" line (the manager's thread) and its execution's
    batch "finish" line (the executor's thread) race: a four-task execution
    can end first, in either package.  Put that one pair in a fixed order;
    every other line keeps its place."""
    out = list(lines)
    for i in range(len(out) - 1):
        a, b = out[i], out[i + 1]
        if (a["op"], a["endpoint"]) == ("finish", "executor.batch") and \
                b["op"] == "finish" and b["endpoint"].startswith("self-healing:"):
            out[i], out[i + 1] = b, a
    return out


def test_maintenance_event_routes_through_fixer(both):
    got = {}
    for name, m in both.items():
        cc, backend, cluster = build_stack(m, self_healing=True)
        # The manager's fixer is the facade's own; record what reaches it.
        assert cc.anomaly_detector._fixer == cc._fix_anomaly
        calls = []
        cc.anomaly_detector._fixer = lambda a: calls.append(a.anomaly_type.name) or cc._fix_anomaly(a)
        det = cc.anomaly_detector.detectors[m.anomalies.AnomalyType.MAINTENANCE_EVENT]
        det.submit(m.anomalies.MaintenanceEvent(plan="remove_broker", broker_ids=(1,)))
        gate = _hold_execution(cluster)
        cc.anomaly_detector.run_detection_once()
        gate.set()
        _wait_executor_idle(cc)
        assert "MAINTENANCE_EVENT" in calls
        assert all(1 not in p.replicas for p in backend.fetch().partitions)
        got[name] = (calls, _task_states(cc), m.audit.audit_log().entries())
    _check_solves(both["jax"].solves, both["torch"].solves, None)
    assert got["torch"][:2] == got["jax"][:2]
    assert _scrub(got["torch"][2]) == _scrub(got["jax"][2])
    assert _oplog(both["torch"]) == _oplog(both["jax"])


def test_add_brokers_and_fix_offline_replicas_dryrun(both):
    """The other two solve operations, dry run: the same frozen models and
    proposal counts; nothing executes."""
    for m in both.values():
        cc, *_ = build_stack(m, num_brokers=6)
        r = cc.add_brokers([4, 5], goals=["RackAwareGoal", "ReplicaDistributionGoal"])
        assert r.dryrun and not r.executed and r.optimizer_result.proposals
        r = cc.fix_offline_replicas(goals=["RackAwareGoal"])
        assert r.dryrun and not r.executed
    _check_solves(both["jax"].solves, both["torch"].solves, None)


def test_remove_brokers_batch_lanes():
    """One what-if lane per removal set; each evacuates its brokers."""
    m = _mods(PKGS["torch"])
    cc, *_ = build_stack(m, num_brokers=6)
    res = cc.remove_brokers_batch([[0], [1], [2, 3]], goals=["RackAwareGoal",
                                                            "ReplicaCapacityGoal"])
    assert res.num_scenarios == 3 and res.goal_names == ["RackAwareGoal", "ReplicaCapacityGoal"]
    assert [int(x) for x in res.stranded_after] == [0, 0, 0]
    assert cc.active_solves() == 0


def test_self_healing_toggle(both):
    for m in both.values():
        cc, *_ = build_stack(m, self_healing=False)
        assert cc.set_self_healing(m.anomalies.AnomalyType.BROKER_FAILURE, True) is False
        assert cc.notifier.self_healing_enabled()[m.anomalies.AnomalyType.BROKER_FAILURE] is True


def test_background_proposal_precompute_warms_cache():
    """The precompute daemon refreshes the generation-keyed proposal cache
    so a later proposals() is a hit; shutdown() stops every thread the
    facade started."""
    from cruise_control_tpu_torch.facade import CruiseControl  # noqa: F401 — port only

    m = _mods(PKGS["torch"])
    before = set(threading.enumerate())
    cc, backend, cluster = build_stack(m)
    cc._precompute_interval_s = 0.05
    cc.start_up()
    try:
        deadline = time.time() + 120.0
        while cc._precomputed_generation is None and time.time() < deadline:
            time.sleep(0.02)
        assert cc._precomputed_generation is not None
        assert cc.optimizer._cached, "precompute left no cached result"
        cc.task_runner.pause_sampling("test")
        settle_deadline = time.time() + 30.0
        g = cc.load_monitor.model_generation
        while time.time() < settle_deadline:
            time.sleep(0.1)
            g2 = cc.load_monitor.model_generation
            if g2 == g:
                break
            g = g2
        r1 = cc.proposals()
        r2 = cc.proposals()
        assert r2.optimizer_result is r1.optimizer_result
        assert cc.resident.stats()["fullFreezes"] >= 1
    finally:
        cc.shutdown()
    leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not leaked, leaked


# --------------------------------------- the facade's gates, budgets, health


def _completeness(generation):
    return SimpleNamespace(generation=generation, valid_windows=[0, 1, 2, 3, 4],
                           num_entity_windows=50, num_windows_avg_available=3,
                           num_windows_avg_adjacent=1, num_windows_forecast=1,
                           valid_entity_ratio=0.5)


def test_stale_gate_vetoes_self_healing_but_not_propose_traffic(both):
    got = {}
    for name, m in both.items():
        cc, backend, cluster = build_stack(m)
        rec = m.fidelity.fidelity()
        prev = (rec.enabled, rec.min_valid_partition_ratio, rec.max_age_ms)
        gates = m.metrics.registry().counter("Monitor.stale-model-gates")
        base = gates.count
        try:
            rec.configure(enabled=True, min_valid_partition_ratio=0.0, max_age_ms=1)
            rec.record_fingerprint(_completeness(11), window_ms=1000)
            fixed = cc._fix_anomaly(m.anomalies.GoalViolations(
                fixable=["ReplicaDistributionGoal"]))
            assert fixed is False and not cc.executor.has_ongoing_execution
            assert gates.count == base + 1
            entry = m.audit.audit_log().entries()[-1]
            assert entry["decision"] == "IGNORED"
            assert entry["description"]["reason"] == "stale_model"
            assert entry["description"]["fingerprint"]["generation"] == 11
            # The SLO anomaly is exempt from the gate.
            cc._fix_anomaly(m.anomalies.SloViolationAnomaly(
                objective="solve-time", sensor="GoalOptimizer.x", threshold=100.0,
                worst_value=250.0, burn_rate_short=3.0, burn_rate_long=2.0))
            assert gates.count == base + 1
            r = cc.rebalance(goals=["ReplicaDistributionGoal"], dryrun=True)
            assert r.model_stale is True and r.to_dict()["modelStale"] is True
            assert r.optimizer_result.fingerprint is not None
            mq = cc.state()["MonitorState"]["modelQualityState"]
            assert mq["enabled"] and mq["stale"] is not None
            got[name] = (m.audit.audit_log().entries(), _scrub(r.to_dict()))
        finally:
            rec.configure(enabled=prev[0], min_valid_partition_ratio=prev[1],
                          max_age_ms=prev[2])
            rec.reset()
    entries = {k: [{**_scrub(e), "description": {
        dk: dv for dk, dv in e["description"].items() if dk not in ("detail", "fingerprint")}}
        for e in v[0]] for k, v in got.items()}
    assert entries["torch"] == entries["jax"]
    assert got["torch"][1] == got["jax"][1]
    assert _oplog(both["torch"]) == _oplog(both["jax"])


def test_health_rollup_with_published_circuit(both):
    got = {}
    for name, m in both.items():
        cc, *_ = build_stack(m)
        cb = m.circuit.CircuitBreaker("backend", failure_threshold=1)
        cb.record_failure()
        m.resilience.set_backend_circuit(cb)
        try:
            got[name] = cc.health()
        finally:
            m.resilience.set_backend_circuit(None)
        assert got[name]["status"] == "unhealthy"
        assert cc.health()["status"] == "ready"
    assert got["torch"] == got["jax"]


def test_budgets_cancel_and_drain():
    m = _mods(PKGS["torch"])
    cc, *_ = build_stack(m)
    cancel = threading.Event()
    cancel.set()
    r = cc.rebalance(goals=GOALS, dryrun=True, cancel_event=cancel)
    assert r.partial and r.optimizer_result.preempt_reason is not None
    assert r.optimizer_result.proposals == []
    assert cc.active_solves() == 0
    assert cc._make_budget(None, None) is None
    budget = cc._make_budget(50.0, None)
    cc._register_budget(budget)
    assert cc.active_solves() == 1
    assert cc.cancel_active_solves("test") == 1 and budget.cancelled()
    t = threading.Timer(0.05, cc._unregister_budget, args=(budget,))
    t.start()
    assert cc._drain_solves(2000.0) is True
    t.join()
    assert cc.active_solves() == 0 and cc._drain_solves(10.0) is True


def test_shutdown_drains_an_inflight_solve():
    """shutdown() cancels a solve in flight on another thread and returns
    within the grace budget; the solve returns partial."""
    m = _mods(PKGS["torch"])
    cc, *_ = build_stack(m, shutdown_grace_ms=5000.0)
    started, out = threading.Event(), {}
    orig = cc.optimizer.solver.optimize_goal

    def slow_goal(*args, **kwargs):
        started.set()
        time.sleep(0.2)
        return orig(*args, **kwargs)

    cc.optimizer.solver.optimize_goal = slow_goal
    th = threading.Thread(target=lambda: out.setdefault(
        "r", cc.proposals(deadline_ms=60_000.0)))
    th.start()
    assert started.wait(30)
    t0 = time.monotonic()
    cc.shutdown()
    th.join(30)
    assert time.monotonic() - t0 < 5.0
    assert out["r"].partial and out["r"].optimizer_result.preempt_reason == "shutdown"
    assert cc.active_solves() == 0


def test_port_facade_defaults_to_the_card_and_never_reruns_on_cpu():
    import inspect

    import torch

    from cruise_control_tpu_torch import facade

    sig = inspect.signature(facade.CruiseControl.__init__)
    assert sig.parameters["device"].default == "cuda"
    # The one CPU rerun is the counted device failover, and a fault of the
    # port's own code (an illegal address) is not device loss: it raises.
    src = inspect.getsource(facade)
    assert src.count("cpu_fallback()") == 1 and src.count("optimizations(") == 2
    m = _mods(PKGS["torch"])
    failovers = m.metrics.registry().counter("Resilience.solver-cpu-failovers").count
    cc, *_ = build_stack(m)
    assert cc.device == torch.device("cpu") and cc.resident.device == torch.device("cpu")

    from tests.test_torch_resilience import CUDA_KERNEL_FAULTS, torch_cuda_error

    def boom(*args, **kwargs):
        raise torch_cuda_error(*CUDA_KERNEL_FAULTS[0])

    cc.optimizer.optimizations = boom
    with pytest.raises(RuntimeError, match="CUDA error"):
        cc.proposals()
    assert cc.health()["probes"]["device"] == {"status": "ready"}
    assert m.metrics.registry().counter("Resilience.solver-cpu-failovers").count == failovers
