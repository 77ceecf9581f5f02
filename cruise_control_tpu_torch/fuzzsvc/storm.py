"""Chaos storm runner: continuous detector → self-healing → executor cycles
(the JAX package's ``fuzzsvc/storm.py``, on the port's modules).

Drives the REAL pipeline — LoadMonitor, anomaly detectors, façade fixer,
Executor — against :class:`~cruise_control_tpu_torch.executor.broker_simulator.
BrokerSimulator` held in-process behind the production
``SubprocessClusterBackend`` translation layer (only the pipe transport is
replaced, so every admin op crosses the exact wire-shape code the
subprocess/socket backends use).  Each cycle injects faults (broker deaths,
dead disks, stuck movements, maintenance plans, mid-flight aborts), runs one
detection sweep, and waits for the executor to converge or degrade; at the
end the obsvc audit ring must tell a coherent detector→action→outcome story.
The fixer's solves run on ``device``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from cruise_control_tpu_torch.detector.anomalies import AnomalyType, MaintenanceEvent
from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
from cruise_control_tpu_torch.executor.broker_simulator import BrokerSimulator
from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
from cruise_control_tpu_torch.executor.subprocess_backend import (
    BackendTransportError,
    SubprocessClusterBackend,
)
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.fuzzsvc.scenario import Scenario, StormEvent
from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
from cruise_control_tpu_torch.monitor.metadata import (
    BrokerInfo,
    FakeMetadataBackend,
    MetadataClient,
    PartitionInfo,
)
from cruise_control_tpu_torch.monitor.sampler import SyntheticWorkloadSampler
from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner
from cruise_control_tpu_torch.obsvc.audit import audit_log

_W = 1000  # monitor window ms

EVENT_KINDS = ("fail_broker", "fail_disk", "stuck_broker", "maintenance",
               "stop_mid_flight")


class InProcessSimBackend(SubprocessClusterBackend):
    """The production admin driver with the pipe replaced by a direct
    :meth:`BrokerSimulator.handle` call — every protocol translation
    (reassignments, logdir moves, elections, throttles) still runs."""

    def __init__(self, sim: BrokerSimulator):
        super().__init__(None)
        self.sim = sim

    def request(self, op: str, **kwargs) -> Dict:
        with self._lock:
            self._next_id += 1
            resp = self.sim.handle({"id": self._next_id, "op": op, **kwargs})
        if not resp.get("ok"):
            raise BackendTransportError(resp.get("error", "sim error"))
        return resp

    def close(self) -> None:
        pass


@dataclass
class StormStack:
    cc: CruiseControl
    metadata: FakeMetadataBackend
    # In-process transport only; None when the simulator runs out-of-process.
    sim: Optional[BrokerSimulator]
    # InProcessSimBackend, or a ReconnectingBackend over the real socket
    # transport (transport="socket") — both expose request()/describe_topics.
    backend: object
    num_brokers: int
    transport: str = "inprocess"
    proc: Optional[subprocess.Popen] = None
    # Simulator admin port (socket transport only) — lets a test open a raw
    # side-channel to steer chaos when the primary backend's circuit is open.
    port: Optional[int] = None

    def sim_op(self, op: str, **kwargs) -> Dict:
        """Route a simulator control op (fault injection, stats) through
        whichever transport this stack uses."""
        if self.sim is not None:
            return self.sim.handle({"op": op, **kwargs})
        return self.backend.request(op, **kwargs)


@dataclass
class StormReport:
    scenario: str
    cycles_run: int = 0
    anomalies_detected: int = 0
    fixes_started: int = 0
    dead_tasks: int = 0
    aborted_tasks: int = 0
    problems: List[str] = field(default_factory=list)
    audit: List[Dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems


def spawn_simulator(polls_to_finish: int = 2,
                    extra_args: Optional[List[str]] = None
                    ) -> "tuple[subprocess.Popen, int]":
    """Launch the broker simulator as a real child process in TCP mode and
    return (proc, bound_port) once its listening banner arrives."""
    cmd = [sys.executable, "-m",
           "cruise_control_tpu_torch.executor.broker_simulator",
           "--listen", "0", "--polls-to-finish", str(polls_to_finish)]
    cmd += list(extra_args or ())
    proc = subprocess.Popen(cmd, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    banner = proc.stdout.readline()
    try:
        port = int(json.loads(banner)["listening"])
    except (ValueError, KeyError, TypeError):
        proc.kill()
        raise RuntimeError(
            f"simulator failed to start (banner: {banner!r})") from None
    return proc, port


def build_storm_stack(scenario: Scenario, num_brokers: int = 6,
                      partitions: int = 16, rf: int = 2,
                      polls_to_finish: int = 2,
                      transport: str = "inprocess",
                      chaos: Optional[Dict] = None,
                      device="cuda") -> StormStack:
    """A small live stack seeded from the scenario: the storm fuzzes the
    control loop, not the solver, so its topology stays executor-sized
    while the scenario's seed decides leader/replica spread.  Its facade
    solves on ``device``."""
    rng = np.random.default_rng(scenario.seed)
    brokers = [BrokerInfo(i, rack=str(i % 3), host=f"h{i}")
               for i in range(num_brokers)]
    parts = []
    for p in range(partitions):
        first = int(rng.integers(0, num_brokers))
        replicas = tuple((first + i) % num_brokers for i in range(rf))
        parts.append(PartitionInfo("ST", p, leader=replicas[0],
                                   replicas=replicas,
                                   in_sync=replicas))
    metadata = FakeMetadataBackend(brokers, parts)
    client = MetadataClient(metadata, ttl_ms=0)
    lm = LoadMonitor(client, num_windows=5, window_ms=_W,
                     min_samples_per_window=1)
    runner = LoadMonitorTaskRunner(lm, SyntheticWorkloadSampler(),
                                   sampling_interval_ms=_W)
    runner.bootstrap(0, 6 * _W)

    proc = None
    if transport == "socket":
        # Real process boundary + real socket framing: transport faults
        # (chaos resets/drops, a killed child) hit the reconnecting wrapper
        # exactly as they would in production.
        from cruise_control_tpu_torch.executor.subprocess_backend import (
            SocketClusterBackend,
        )
        from cruise_control_tpu_torch.resilience import (
            CircuitBreaker,
            ReconnectingBackend,
            RetryPolicy,
        )
        proc, sim_port = spawn_simulator(polls_to_finish=polls_to_finish)

        def factory():
            # proc stays None on the transport: poisoning a connection must
            # drop the socket, not kill the shared simulator child.
            return SocketClusterBackend("127.0.0.1", sim_port,
                                        request_timeout_s=2.0)

        backend = ReconnectingBackend(
            factory,
            policy=RetryPolicy(max_attempts=6, base_delay_s=0.02,
                               max_delay_s=0.2, deadline_s=15.0),
            circuit=CircuitBreaker("storm-backend", failure_threshold=8,
                                   reset_timeout_s=0.2),
            name="storm-backend")
        sim = None
        port = sim_port
    elif transport == "inprocess":
        sim = BrokerSimulator(polls_to_finish=polls_to_finish)
        backend = InProcessSimBackend(sim)
        port = None
    else:
        raise ValueError(f"unknown storm transport {transport!r}")
    backend.request("bootstrap", partitions=[
        {"topic": p.topic, "partition": p.partition,
         "replicas": list(p.replicas), "leader": p.leader,
         "logdirs": {str(b): 0 for b in p.replicas}}
        for p in parts])
    if chaos:
        backend.request("chaos", **chaos)

    ex = Executor(backend, ExecutorConfig(
        progress_check_interval_s=0.001,
        task_execution_alert_timeout_s=0.4))
    notifier = SelfHealingNotifier(
        self_healing_enabled=True, clock=lambda: time.time() * 1000,
        broker_failure_alert_threshold_ms=0,
        broker_failure_self_healing_threshold_ms=0)
    cc = CruiseControl(lm, ex, task_runner=runner, notifier=notifier,
                       default_goals=list(scenario.goal_names),
                       self_healing_goals=list(scenario.goal_names),
                       anomaly_detection_interval_s=3600.0, device=device)
    return StormStack(cc=cc, metadata=metadata, sim=sim, backend=backend,
                      num_brokers=num_brokers, transport=transport,
                      proc=proc, port=port)


def default_storm_events(scenario: Scenario, cycles: int) -> List[StormEvent]:
    """One injected fault per cycle, seed-deterministic, cycling through
    every fault kind so even a 1-cycle smoke exercises an injection."""
    rng = np.random.default_rng(scenario.seed ^ 0x570B)
    out = []
    for c in range(cycles):
        kind = EVENT_KINDS[c % len(EVENT_KINDS)]
        out.append(StormEvent(kind=kind, at_cycle=c,
                              broker=int(rng.integers(1, 6)),
                              plan="remove_broker"))
    return out


def _wait_idle(cc: CruiseControl, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while cc.executor.has_ongoing_execution:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _inject(stack: StormStack, ev: StormEvent) -> bool:
    """Apply one event; returns True when a mid-flight stop is pending."""
    b = ev.broker % stack.num_brokers if ev.broker >= 0 else 1
    if ev.kind == "fail_broker":
        stack.metadata.kill_broker(b)
    elif ev.kind == "fail_disk":
        stack.sim_op("fail_logdir", broker=b, logdir=ev.disk)
    elif ev.kind == "stuck_broker":
        # The sim-side failure only: movements touching b retro-stick, so the
        # executor's task-alert timeout (not an exception) must resolve them.
        stack.sim_op("fail_broker", broker=b)
    elif ev.kind == "maintenance":
        det = stack.cc.anomaly_detector.detectors[AnomalyType.MAINTENANCE_EVENT]
        det.submit(MaintenanceEvent(plan=ev.plan or "remove_broker",
                                    broker_ids=(b,)))
    elif ev.kind == "stop_mid_flight":
        stack.metadata.kill_broker(b)
        return True
    return False


def audit_coherence(entries: List[Dict]) -> List[str]:
    """The detector→action→outcome chain must be internally consistent."""
    problems: List[str] = []
    last_id = 0
    for e in entries:
        tag = f"audit #{e.get('id')}"
        if e["id"] <= last_id:
            problems.append(f"{tag}: ids not strictly increasing")
        last_id = e["id"]
        if e["decision"] not in ("IGNORED", "CHECK_WITH_DELAY", "FIX"):
            problems.append(f"{tag}: unknown decision {e['decision']!r}")
        if e["decision"] == "FIX":
            if e["outcome"] not in ("FIX_STARTED", "FIX_FAILED_TO_START"):
                problems.append(f"{tag}: FIX entry with outcome "
                                f"{e['outcome']!r}")
        else:
            if e["outcome"] is not None:
                problems.append(f"{tag}: {e['decision']} entry has outcome")
            if e["action"] is not None:
                problems.append(f"{tag}: {e['decision']} entry has action")
        exo = e.get("executionOutcome")
        if exo is not None:
            if e["outcome"] != "FIX_STARTED":
                problems.append(f"{tag}: executionOutcome without FIX_STARTED")
            if min(exo["completed"], exo["dead"], exo["aborted"]) < 0 \
                    or exo["completed"] + exo["dead"] + exo["aborted"] == 0:
                problems.append(f"{tag}: implausible execution counts {exo}")
    return problems


def run_storm(scenario: Scenario, cycles: int = 1,
              idle_timeout_s: float = 60.0,
              stack: Optional[StormStack] = None,
              device="cuda") -> StormReport:
    """Run ``cycles`` inject→detect→heal→converge rounds and audit the ring
    (on a stack built on ``device`` unless one is given)."""
    owns_stack = stack is None
    stack = stack or build_storm_stack(scenario, device=device)
    report = StormReport(scenario=scenario.name)
    events = scenario.events or default_storm_events(scenario, cycles)
    audit_log().clear()
    stuck: List[int] = []
    try:
        for c in range(cycles):
            stop_pending = False
            for ev in events:
                if ev.at_cycle == c:
                    stop_pending |= _inject(stack, ev)
                    if ev.kind == "stuck_broker":
                        stuck.append(ev.broker % stack.num_brokers)
            report.anomalies_detected += \
                stack.cc.anomaly_detector.run_detection_once(handle=True)
            if stop_pending and stack.cc.executor.has_ongoing_execution:
                stack.cc.stop_execution()
            if not _wait_idle(stack.cc, idle_timeout_s):
                report.problems.append(
                    f"cycle {c}: executor still running after "
                    f"{idle_timeout_s}s (neither converged nor degraded)")
                break
            # Heal the sim-side stuck brokers so later cycles can move again
            # (the reference operator restarting a wedged broker).
            for b in stuck:
                stack.sim_op("restore_broker", broker=b)
            stuck.clear()
            # Mirror the executed assignment back into the monitor's
            # metadata so the next cycle models the post-heal cluster.
            for p in stack.backend.describe_topics():
                stack.metadata.apply_reassignment(
                    p["topic"], int(p["partition"]),
                    tuple(int(x) for x in p["replicas"]),
                    new_leader=int(p["leader"]))
            report.cycles_run += 1
    finally:
        stack.cc.anomaly_detector.shutdown()
        if owns_stack and stack.transport == "socket":
            try:
                stack.backend.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
            if stack.proc is not None:
                stack.proc.kill()
                stack.proc.wait(timeout=5)
    report.audit = audit_log().entries()
    report.problems.extend(audit_coherence(report.audit))
    for e in report.audit:
        if e["outcome"] == "FIX_STARTED":
            report.fixes_started += 1
        exo = e.get("executionOutcome")
        if exo:
            report.dead_tasks += exo["dead"]
            report.aborted_tasks += exo["aborted"]
    if not report.audit:
        report.problems.append("storm produced no audit entries "
                               "(detectors saw nothing?)")
    return report
