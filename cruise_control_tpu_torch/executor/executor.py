"""The executor state machine.

Reference: ``executor/Executor.java:73-1545`` — states NO_TASK →
STARTING_EXECUTION → INTER_BROKER_REPLICA_MOVEMENT → INTRA_BROKER_REPLICA_
MOVEMENT → LEADER_MOVEMENT → STOPPING; batched movements under per-broker
caps with progress polling (:1163-1330), task-dead/abort handling
(:1457-1540), user-triggered stop (:782), AIMD concurrency auto-tuning
(ConcurrencyAdjuster :313-375), and replication throttling around an
execution (ReplicationThrottleHelper.java:29-321).
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

from cruise_control_tpu_torch.common.actions import ExecutionProposal
from cruise_control_tpu_torch.common.exceptions import OngoingExecutionError
from cruise_control_tpu_torch.executor.backend import ClusterAdminBackend
from cruise_control_tpu_torch.executor.journal import ExecutionJournal
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.subprocess_backend import (
    BackendCircuitOpenError,
    BackendTransportError,
)
from cruise_control_tpu_torch.executor.strategies import AbstractReplicaMovementStrategy
from cruise_control_tpu_torch.executor.tasks import (
    ExecutionTask,
    ExecutionTaskState,
    ExecutionTaskTracker,
    TaskType,
)
from cruise_control_tpu_torch.obsvc import oplog as _oplog
from cruise_control_tpu_torch.obsvc.audit import audit_log
from cruise_control_tpu_torch.obsvc.execution import execution as _execution
from cruise_control_tpu_torch.obsvc.tracer import tracer as _obsvc_tracer

LOG = logging.getLogger(__name__)
# Dedicated operation audit log (reference OPERATION_LOGGER,
# KafkaCruiseControlUtils / Executor.java:945): execution lifecycle events on
# their own logger name so deployments can route them to an audit sink.
OPERATION_LOG = logging.getLogger("cruisecontrol.operation")

# Floor for poll loops that spin against an UNAVAILABLE backend (paused
# circuit, journal adoption): storms tune progress_check_interval_s down to
# sub-millisecond for throughput, but a dead-peer probe at that cadence is a
# busy-wait.  The movement hot loops deliberately poll unfloored.
_POLL_FLOOR_S = 0.01


class ExecutorState(enum.Enum):
    NO_TASK_IN_PROGRESS = "NO_TASK_IN_PROGRESS"
    STARTING_EXECUTION = "STARTING_EXECUTION"
    INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = "INTER_BROKER_REPLICA_MOVEMENT"
    INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = "INTRA_BROKER_REPLICA_MOVEMENT"
    LEADER_MOVEMENT_TASK_IN_PROGRESS = "LEADER_MOVEMENT"
    # Admin-backend circuit open: in-flight work is held (not rotted to the
    # alert timeout) while the reconnecting backend probes for recovery.
    PAUSED_BACKEND_DOWN = "PAUSED_BACKEND_DOWN"
    STOPPING_EXECUTION = "STOPPING_EXECUTION"


@dataclass
class ConcurrencyAdjuster:
    """AIMD per-broker concurrency tuning (Executor.java:313-375): additive
    increase while the cluster looks healthy, multiplicative decrease on
    distress signals."""

    min_concurrency: int = 1
    max_concurrency: int = 12
    current: int = 5
    increase_step: int = 1
    decrease_factor: float = 2.0

    def on_healthy(self) -> int:
        self.current = min(self.max_concurrency, self.current + self.increase_step)
        return self.current

    def on_distress(self) -> int:
        self.current = max(self.min_concurrency,
                           int(self.current / self.decrease_factor))
        return self.current


@dataclass
class ExecutorConfig:
    concurrent_partition_movements_per_broker: int = 5
    concurrent_intra_broker_partition_movements: int = 2
    concurrent_leader_movements: int = 1000
    max_num_cluster_movements: int = 1250
    progress_check_interval_s: float = 0.01
    replication_throttle_bytes_per_s: Optional[int] = None
    task_execution_alert_timeout_s: float = 90.0
    auto_adjust_concurrency: bool = False


class Executor:
    """Applies proposal batches via the admin backend."""

    def __init__(self, backend: ClusterAdminBackend,
                 config: Optional[ExecutorConfig] = None,
                 strategy: Optional[AbstractReplicaMovementStrategy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.backend = backend
        self.config = config or ExecutorConfig()
        self._strategy = strategy
        self._clock = clock
        self._state = ExecutorState.NO_TASK_IN_PROGRESS
        self._lock = threading.RLock()
        self._stop_requested = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tracker = ExecutionTaskTracker()
        self._planner: Optional[ExecutionTaskPlanner] = None
        self.adjuster = ConcurrencyAdjuster(
            max_concurrency=self.config.concurrent_partition_movements_per_broker * 2,
            current=self.config.concurrent_partition_movements_per_broker)
        self._on_finish: List[Callable[[], None]] = []
        self._pause_sampling: Optional[Callable[[], None]] = None
        self._resume_sampling: Optional[Callable[[], None]] = None
        self._generating_proposals_for_execution = False
        self.journal: Optional[ExecutionJournal] = None
        self.recovering = False
        self.last_journal_recovery: Optional[Dict] = None
        self._batch_meta: Dict = {"principal": None, "requestId": None}
        self._register_sensors()

    def _register_sensors(self) -> None:
        """Executor sensors (Sensors.md; Executor.java:259-275 caps)."""
        from cruise_control_tpu_torch.common.metrics import registry
        from cruise_control_tpu_torch.executor.tasks import (
            ExecutionTaskState as S,
            TaskType as T,
        )
        reg = registry()

        def task_count(task_type, state):
            def read():
                # Stale-gauge guard: the tracker is lifetime-cumulative, so a
                # finished batch's terminal states (aborted/dead) would stick
                # forever — the action gauges report the live batch only.
                if not self.has_ongoing_execution:
                    return 0
                return self.tracker.summary().get(task_type.value, {}).get(
                    state.value, 0)
            return read

        for kind, t in (("replica", T.INTER_BROKER_REPLICA_ACTION),
                        ("leadership", T.LEADER_ACTION)):
            for sname, s in (("in-progress", S.IN_PROGRESS),
                             ("pending", S.PENDING),
                             ("aborting", S.ABORTING),
                             ("aborted", S.ABORTED),
                             ("dead", S.DEAD)):
                reg.gauge(f"Executor.{kind}-action-{sname}", task_count(t, s))
        reg.gauge("Executor.ongoing-execution",
                  lambda: int(self.has_ongoing_execution))
        reg.gauge("Executor.inter-broker-partition-movements-per-broker-cap",
                  lambda: self.adjuster.current)
        reg.gauge("Executor.intra-broker-partition-movements-per-broker-cap",
                  lambda: self.config.concurrent_intra_broker_partition_movements)
        reg.gauge("Executor.leadership-movements-global-cap",
                  lambda: self.config.concurrent_leader_movements)
        self._sensor_started = reg.counter("Executor.execution-started")
        self._sensor_stopped = reg.counter("Executor.execution-stopped")
        self._sensor_stopped_by_user = reg.counter(
            "Executor.execution-stopped-by-user")
        # Materialized backend-failure visibility: every backend exception
        # the executor absorbs lands here, long before the alert timeout
        # would have made the damage visible as DEAD tasks.
        self._sensor_backend_errors = reg.counter("Executor.backend-errors")

    # ------------------------------------------------------------- wiring

    def set_sampling_hooks(self, pause: Callable[[], None],
                           resume: Callable[[], None]) -> None:
        """LoadMonitor pause/resume around executions (Executor :959-975)."""
        self._pause_sampling = pause
        self._resume_sampling = resume

    def add_finish_listener(self, fn: Callable[[], None]) -> None:
        self._on_finish.append(fn)

    # -------------------------------------------------------------- state

    @property
    def state(self) -> ExecutorState:
        with self._lock:
            return self._state

    @property
    def has_ongoing_execution(self) -> bool:
        return self.state is not ExecutorState.NO_TASK_IN_PROGRESS

    def set_generating_proposals_for_execution(self, flag: bool = True) -> None:
        """Reference Executor.setGeneratingProposalsForExecution :737 — blocks
        competing executions while proposals are being computed."""
        with self._lock:
            if flag and (self.has_ongoing_execution
                         or self._generating_proposals_for_execution):
                raise OngoingExecutionError("an execution is already in progress")
            self._generating_proposals_for_execution = flag

    def state_summary(self) -> Dict:
        out = {
            "state": self.state.value,
            "tasks": self.tracker.summary(),
            "finishedDataMovementMB": round(self.tracker.finished_data_movement_mb, 3),
            "concurrency": self.adjuster.current,
        }
        if self.recovering:
            out["journalRecovery"] = {"status": "recovering"}
        elif self.last_journal_recovery is not None:
            out["journalRecovery"] = self.last_journal_recovery
        return out

    # ------------------------------------------------------------ execute

    def execute_proposals(self, proposals: Sequence[ExecutionProposal],
                          wait: bool = True) -> None:
        """Start executing proposals (Executor.executeProposals :500)."""
        with self._lock:
            if self.has_ongoing_execution:
                raise OngoingExecutionError("an execution is already in progress")
            external = self.backend.in_progress_reassignments()
            if external:
                raise OngoingExecutionError(
                    f"{len(external)} reassignments already in progress "
                    "(externally initiated?)")
            self._generating_proposals_for_execution = False
            self._state = ExecutorState.STARTING_EXECUTION
            self._stop_requested.clear()
            self._planner = ExecutionTaskPlanner(self._strategy)
            total = min(len(proposals), self.config.max_num_cluster_movements)
            accepted = list(self._planner.add_proposals(list(proposals)[:total]))
            for t in accepted:
                self.tracker.add(t)
            # Per-tenant attribution: the requesting principal / correlation
            # id ride the request contextvars into this call (the servlet's
            # UserTaskManager copies the request context), and from here
            # into the journal batch_start line, the executor.batch span,
            # and the flight recorder's batch record.
            # Model lineage: the fingerprint the accepted proposals were
            # solved from (first stamped proposal wins — one batch, one
            # solve, one model generation).  Rides the journal batch_start
            # line and the oplog so a crash-recovered batch still knows
            # what data quality it was decided on.
            fp = next((f for f in (getattr(t.proposal, "fingerprint", None)
                                   for t in accepted) if f is not None), None)
            self._batch_meta = {"principal": _oplog.current_principal(),
                                "requestId": _oplog.current_request_id(),
                                "modelGeneration":
                                    fp.get("generation") if fp else None}
            if self.journal is not None:
                try:
                    self.journal.begin_batch(accepted, meta=self._batch_meta)
                except OSError:
                    LOG.exception("journal begin_batch failed; executing "
                                  "without crash protection")
            # Audit-log deltas are against this execution's start (the
            # tracker itself is lifetime-cumulative).
            self._exec_baseline = (
                {st: sum(self.tracker.count(t, st) for t in TaskType)
                 for st in (ExecutionTaskState.COMPLETED,
                            ExecutionTaskState.DEAD,
                            ExecutionTaskState.ABORTED)},
                self.tracker.finished_data_movement_mb)
        _execution().begin_batch(
            accepted, principal=self._batch_meta["principal"],
            request_id=self._batch_meta["requestId"])
        self._sensor_started.inc()
        OPERATION_LOG.info(
            "execution started: %d tasks (%d proposals requested, cap %d)",
            total, len(proposals), self.config.max_num_cluster_movements)
        _oplog.record("start", endpoint="executor.batch",
                      tasks=total, proposals=len(proposals),
                      request_id=self._batch_meta["requestId"],
                      generation=self._batch_meta.get("modelGeneration"))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="proposal-execution")
        self._thread.start()
        if wait:
            self._thread.join()

    def user_triggered_stop_execution(self, user: bool = True) -> None:
        """Executor.userTriggeredStopExecution :782 (``user=False`` for
        service-initiated stops, e.g. self-healing preemption — the
        execution-stopped / execution-stopped-by-user sensors diverge)."""
        with self._lock:
            if self.has_ongoing_execution:
                self._state = ExecutorState.STOPPING_EXECUTION
                self._stop_requested.set()
                self._sensor_stopped.inc()
                OPERATION_LOG.info("execution stop requested (user=%s)", user)
                if user:
                    self._sensor_stopped_by_user.inc()

    # ---------------------------------------------------------- internals

    def _set_state(self, s: ExecutorState) -> None:
        with self._lock:
            if self._state is not ExecutorState.STOPPING_EXECUTION:
                self._state = s

    def _transition(self, task: ExecutionTask, to: ExecutionTaskState) -> None:
        """Tracker transition + write-ahead journal record (when enabled).
        The flight recorder observes BEFORE the tracker mutates task.state,
        so it sees both ends of the transition."""
        _execution().on_transition(task, to, self._now_ms())
        self.tracker.transition(task, to, self._now_ms())
        if self.journal is not None:
            try:
                self.journal.record_transition(task, to)
            except OSError:
                LOG.exception("journal transition write failed")

    def _backend_error(self, seam: str, exc: BaseException) -> None:
        """Materialize an absorbed backend failure (Executor.backend-errors)
        so peers dying is visible on /metrics before any alert timeout."""
        self._sensor_backend_errors.inc()
        LOG.debug("backend error at %s: %s", seam, exc, exc_info=exc)

    def _paused_wait(self, resume_state: ExecutorState) -> bool:
        """Hold the execution in PAUSED_BACKEND_DOWN while the reconnecting
        backend's circuit is open, probing for recovery.  True: backend is
        back, state restored to ``resume_state``.  False: a stop was
        requested while paused."""
        probe = getattr(self.backend, "probe", None)
        self._set_state(ExecutorState.PAUSED_BACKEND_DOWN)
        OPERATION_LOG.info("execution paused: admin backend circuit open")
        while not self._stop_requested.is_set():
            if probe is None or probe():
                self._set_state(resume_state)
                OPERATION_LOG.info(
                    "execution resumed: admin backend recovered")
                return True
            self._poll_sleep(floored=True)
        return False

    # ----------------------------------------------------- journal recovery

    def set_journal(self, journal: Optional[ExecutionJournal]) -> None:
        self.journal = journal

    def recover_from_journal(self, adoption_timeout_s: float = 30.0
                             ) -> Optional[Dict]:
        """Replay the write-ahead journal against the live backend: tasks
        the crashed process left non-terminal are re-adopted (still moving
        on the cluster — watch them drain), completed (no longer in
        progress: they finished while we were down), or rolled back (never
        submitted).  The summary is surfaced in /state as
        ``journalRecovery``; the journal file is retired unless the backend
        was unreachable (then it is kept for the next restart)."""
        if self.journal is None:
            return None
        replay = self.journal.replay()
        if replay is None:
            return None
        self.recovering = True
        summary: Dict = {"batchId": replay.batch_id,
                         "journaledTasks": len(replay.tasks),
                         "reAdopted": 0, "completed": 0, "rolledBack": 0,
                         "stillInFlight": 0}
        try:
            orphans = replay.orphans()
            if replay.complete or not orphans:
                summary["status"] = "clean"
                return summary
            try:
                in_prog = set(self.backend.in_progress_reassignments())
            except Exception as exc:  # noqa: BLE001 — backend down at boot
                self._backend_error("journal-recovery", exc)
                summary["status"] = "backend-unavailable"
                LOG.warning("journal recovery: backend unavailable; keeping "
                            "the journal for the next restart")
                return summary
            adopted = [t for t in orphans
                       if t.last_state == ExecutionTaskState.IN_PROGRESS.value
                       and t.topic_partition in in_prog]
            for t in orphans:
                if t in adopted:
                    continue
                if t.last_state == ExecutionTaskState.PENDING.value:
                    summary["rolledBack"] += 1
                else:
                    # Submitted but no longer on the cluster: it finished
                    # while we were down.
                    summary["completed"] += 1
            # Rebuild live tasks for the adopted set: real transports only
            # advance a reassignment when it is polled with finished(), so
            # the adoption loop must actively drive them, not just watch
            # in_progress_reassignments shrink.
            live = {t.execution_id: t.to_execution_task() for t in adopted}
            deadline = self._clock() + adoption_timeout_s
            while (adopted and self._clock() < deadline
                   and not self._stop_requested.is_set()):
                self._poll_sleep(floored=True)
                try:
                    for t in adopted:
                        self.backend.finished(live[t.execution_id])
                    in_prog = set(self.backend.in_progress_reassignments())
                except Exception as exc:  # noqa: BLE001 — peer flapping
                    self._backend_error("journal-recovery", exc)
                    break
                drained = [t for t in adopted
                           if t.topic_partition not in in_prog]
                summary["reAdopted"] += len(drained)
                adopted = [t for t in adopted if t.topic_partition in in_prog]
            summary["stillInFlight"] = len(adopted)
            summary["status"] = "reconciled"
            OPERATION_LOG.info(
                "journal recovery: batch %d — reAdopted=%d completed=%d "
                "rolledBack=%d stillInFlight=%d", replay.batch_id,
                summary["reAdopted"], summary["completed"],
                summary["rolledBack"], summary["stillInFlight"])
            return summary
        finally:
            self.recovering = False
            self.last_journal_recovery = summary
            if summary.get("status") != "backend-unavailable":
                try:
                    self.journal.mark_recovered()
                except OSError:
                    LOG.exception("failed to retire the recovered journal")

    def _run(self) -> None:
        # Root span: the execution thread has no request context, so each
        # batch is its own trace (phases + outcome counts as attrs); the
        # requesting principal / correlation id captured at accept time are
        # re-attached here for cross-referencing with the http.* span.
        attrs = {k: v for k, v in (("principal", self._batch_meta["principal"]),
                                   ("request_id", self._batch_meta["requestId"]))
                 if v is not None}
        with _obsvc_tracer().span("executor.batch", **attrs):
            self._run_impl()

    def _run_impl(self) -> None:
        try:
            if self._pause_sampling:
                self._pause_sampling()
            inter = self._planner.remaining_inter_broker_tasks
            throttled = [
                (t.proposal.topic_partition.topic, t.proposal.topic_partition.partition)
                for t in inter]
            if self.config.replication_throttle_bytes_per_s and throttled:
                throttled_brokers = sorted(
                    {b for t in inter for b in t.brokers_involved})
                try:
                    self.backend.set_throttles(
                        self.config.replication_throttle_bytes_per_s, throttled,
                        throttled_brokers,
                        proposals=[t.proposal for t in inter])
                except Exception as exc:  # noqa: BLE001 — same dead-peer
                    # policy as the movement submits: abort the execution
                    # with the planned tasks marked DEAD, not a dead thread
                    # with every task stuck PENDING.
                    self._backend_error("set-throttles", exc)
                    LOG.exception("throttle setup failed; aborting execution")
                    for t in self._planner.clear():
                        if t.state is ExecutionTaskState.PENDING:
                            self._transition(t, ExecutionTaskState.IN_PROGRESS)
                            self._transition(t, ExecutionTaskState.DEAD)
                    return
            tr = _obsvc_tracer()
            self._set_state(
                ExecutorState.INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS)
            with tr.span("executor.inter-broker"):
                self._move_replicas(
                    TaskType.INTER_BROKER_REPLICA_ACTION,
                    self._planner.inter_broker_tasks,
                    self.backend.execute_replica_reassignments,
                    self.config.concurrent_partition_movements_per_broker)
            self._set_state(
                ExecutorState.INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS)
            with tr.span("executor.intra-broker"):
                self._move_replicas(
                    TaskType.INTRA_BROKER_REPLICA_ACTION,
                    self._planner.intra_broker_tasks,
                    self.backend.execute_logdir_moves,
                    self.config.concurrent_intra_broker_partition_movements)
            self._set_state(ExecutorState.LEADER_MOVEMENT_TASK_IN_PROGRESS)
            with tr.span("executor.leadership"):
                self._move_leaderships()
        finally:
            if self._stop_requested.is_set() and self._planner is not None:
                for t in self._planner.clear():
                    if t.state is ExecutionTaskState.PENDING:
                        self._transition(t, ExecutionTaskState.IN_PROGRESS)
                        self._transition(t, ExecutionTaskState.DEAD)
            if self.config.replication_throttle_bytes_per_s:
                try:
                    self.backend.clear_throttles()
                except Exception as exc:  # noqa: BLE001 — finally must finish
                    self._backend_error("clear-throttles", exc)
                    LOG.exception("failed to clear replication throttles")
            if self._resume_sampling:
                self._resume_sampling()
            with self._lock:
                self._state = ExecutorState.NO_TASK_IN_PROGRESS
            base_counts, base_mb = self._exec_baseline
            counts = {st: sum(self.tracker.count(t, st) for t in TaskType)
                      - base_counts[st]
                      for st in (ExecutionTaskState.COMPLETED,
                                 ExecutionTaskState.DEAD,
                                 ExecutionTaskState.ABORTED)}
            moved_mb = self.tracker.finished_data_movement_mb - base_mb
            # Close the flight recorder's batch: throughput summary + the
            # provenance-path histogram roll into the oplog line, the batch
            # span, and the self-healing audit entry below.
            exec_summary = _execution().end_batch(
                completed=counts[ExecutionTaskState.COMPLETED],
                dead=counts[ExecutionTaskState.DEAD],
                aborted=counts[ExecutionTaskState.ABORTED],
                moved_mb=moved_mb) or {}
            paths = exec_summary.get("pathHistogram") or {}
            OPERATION_LOG.info(
                "execution finished: completed=%d dead=%d aborted=%d "
                "moved=%.1fMB",
                counts[ExecutionTaskState.COMPLETED],
                counts[ExecutionTaskState.DEAD],
                counts[ExecutionTaskState.ABORTED],
                moved_mb)
            _oplog.record(
                "abort" if self._stop_requested.is_set() else "finish",
                endpoint="executor.batch",
                completed=counts[ExecutionTaskState.COMPLETED],
                dead=counts[ExecutionTaskState.DEAD],
                aborted=counts[ExecutionTaskState.ABORTED],
                moved_mb=round(moved_mb, 1),
                moves=exec_summary.get("moves"),
                request_id=self._batch_meta["requestId"],
                **paths)
            span = _obsvc_tracer().current()
            if span is not None:
                span.set("completed", counts[ExecutionTaskState.COMPLETED])
                span.set("dead", counts[ExecutionTaskState.DEAD])
                span.set("aborted", counts[ExecutionTaskState.ABORTED])
                span.set("moved_mb", round(moved_mb, 1))
                if paths:
                    span.set("provenance_paths", dict(paths))
            # Stage 3 of the self-healing audit: attach this batch's outcome
            # to the entry whose fix started it (no-op for user-triggered
            # executions with no pending entry).
            audit_log().attach_execution_outcome(
                completed=counts[ExecutionTaskState.COMPLETED],
                dead=counts[ExecutionTaskState.DEAD],
                aborted=counts[ExecutionTaskState.ABORTED],
                moved_mb=moved_mb,
                provenance_paths=paths or None)
            if self.journal is not None:
                try:
                    self.journal.end_batch(
                        {"completed": counts[ExecutionTaskState.COMPLETED],
                         "dead": counts[ExecutionTaskState.DEAD],
                         "aborted": counts[ExecutionTaskState.ABORTED]})
                except OSError:
                    LOG.exception("journal end_batch failed")
            for fn in self._on_finish:
                try:
                    fn()
                except Exception:       # noqa: BLE001 — listeners must not kill us
                    LOG.exception("execution finish listener failed")

    def _now_ms(self) -> float:
        return self._clock() * 1000.0

    def _poll_sleep(self, floored: bool = False) -> None:
        """One progress-poll interval; ``floored`` clamps to
        :data:`_POLL_FLOOR_S` for loops probing an unavailable backend."""
        interval = self.config.progress_check_interval_s
        time.sleep(max(interval, _POLL_FLOOR_S) if floored else interval)

    def _concurrency(self) -> int:
        return (self.adjuster.current if self.config.auto_adjust_concurrency
                else self.config.concurrent_partition_movements_per_broker)

    def _submit_batch(self, batch: List[ExecutionTask], submit_fn,
                      resume_state: ExecutorState) -> bool:
        """Submit one movement batch.  An open backend circuit pauses the
        execution and retries the same batch after recovery; any other
        failure marks the batch DEAD (the reference's task-dead handling,
        Executor.java:1457-1540).  False: the batch did not go out."""
        while not self._stop_requested.is_set():
            try:
                submit_fn(batch)
                return True
            except BackendCircuitOpenError as exc:
                self._backend_error("submit", exc)
                if not self._paused_wait(resume_state):
                    break              # stop requested while paused
            except Exception as exc:  # noqa: BLE001 — backend/peer failure
                self._backend_error("submit", exc)
                LOG.exception("movement submission failed; marking %d "
                              "tasks dead", len(batch))
                for t in batch:
                    self._transition(t, ExecutionTaskState.IN_PROGRESS)
                    self._transition(t, ExecutionTaskState.DEAD)
                if self.config.auto_adjust_concurrency:
                    _execution().record_tuner(
                        "decrease", "submit-failure",
                        self.adjuster.on_distress())
                return False
        # Stop requested before the batch went out: it is no longer in the
        # planner (batch_fn popped it), so account for it here.
        for t in batch:
            if t.state is ExecutionTaskState.PENDING:
                self._transition(t, ExecutionTaskState.IN_PROGRESS)
                self._transition(t, ExecutionTaskState.DEAD)
        return False

    def _extend_alert_windows(self, tasks: Sequence[ExecutionTask]) -> None:
        """A backend outage must not count against in-flight tasks' alert
        timeout — restart their clocks at resume."""
        now = self._now_ms()
        for t in tasks:
            if t.state is ExecutionTaskState.IN_PROGRESS:
                t.start_time_ms = now

    def _move_replicas(self, task_type: TaskType, batch_fn, submit_fn,
                       per_broker_cap: int) -> None:
        """Batched movement loop (interBrokerMoveReplicas :1163-1225)."""
        in_flight: Dict[int, int] = {}
        active: List[ExecutionTask] = []
        resume_state = self.state
        while not self._stop_requested.is_set():
            cap = (self._concurrency()
                   if task_type is TaskType.INTER_BROKER_REPLICA_ACTION
                   else per_broker_cap)
            ready = {b: cap for t in self._all_brokers(task_type) for b in [t]}
            batch = batch_fn(ready, in_flight)
            if batch:
                if not self._submit_batch(batch, submit_fn, resume_state):
                    continue
                for t in batch:
                    self._transition(t, ExecutionTaskState.IN_PROGRESS)
                    for b in t.brokers_involved:
                        in_flight[b] = in_flight.get(b, 0) + 1
                active.extend(batch)
            if not active:
                if not batch and self._planner_queue_empty(task_type):
                    break
                continue
            self._poll_sleep()
            still_active: List[ExecutionTask] = []
            paused = False
            for idx, t in enumerate(active):
                try:
                    fin = self.backend.finished(t)
                except BackendCircuitOpenError as exc:
                    self._backend_error("progress-poll", exc)
                    if self._paused_wait(resume_state):
                        self._extend_alert_windows(active)
                    # This task and everything unprocessed stay active; the
                    # outer loop re-polls (or aborts on stop).
                    still_active.extend(active[idx:])
                    paused = True
                    break
                except BackendTransportError as exc:
                    self._backend_error("progress-poll", exc)
                    fin = False
                if fin:
                    self._transition(t, ExecutionTaskState.COMPLETED)
                    for b in t.brokers_involved:
                        in_flight[b] = max(in_flight.get(b, 0) - 1, 0)
                elif (self._now_ms() - t.start_time_ms
                      > self.config.task_execution_alert_timeout_s * 1000):
                    self._transition(t, ExecutionTaskState.DEAD)
                    for b in t.brokers_involved:
                        in_flight[b] = max(in_flight.get(b, 0) - 1, 0)
                    if self.config.auto_adjust_concurrency:
                        _execution().record_tuner(
                            "decrease", "task-dead",
                            self.adjuster.on_distress())
                else:
                    still_active.append(t)
            if (not paused and self.config.auto_adjust_concurrency
                    and not still_active):
                _execution().record_tuner("increase", "batch-drained",
                                          self.adjuster.on_healthy())
            active = still_active
        # Stop requested: abort whatever is in flight.
        for t in active:
            self._transition(t, ExecutionTaskState.ABORTING)
            self._transition(t, ExecutionTaskState.ABORTED)

    def _planner_queue_empty(self, task_type: TaskType) -> bool:
        if task_type is TaskType.INTER_BROKER_REPLICA_ACTION:
            return not self._planner.remaining_inter_broker_tasks
        return not self._planner.remaining_intra_broker_tasks

    def _all_brokers(self, task_type: TaskType) -> Set[int]:
        tasks = (self._planner.remaining_inter_broker_tasks
                 if task_type is TaskType.INTER_BROKER_REPLICA_ACTION
                 else self._planner.remaining_intra_broker_tasks)
        out: Set[int] = set()
        for t in tasks:
            out.update(t.brokers_involved)
        return out

    def _move_leaderships(self) -> None:
        """Leadership batches (moveLeaderships :1281-1330)."""
        while not self._stop_requested.is_set():
            batch = self._planner.leadership_tasks(
                self.config.concurrent_leader_movements)
            if not batch:
                break
            if not self._submit_batch(
                    batch, self.backend.execute_preferred_leader_election,
                    ExecutorState.LEADER_MOVEMENT_TASK_IN_PROGRESS):
                continue
            for t in batch:
                self._transition(t, ExecutionTaskState.IN_PROGRESS)
            pending = list(batch)
            while pending and not self._stop_requested.is_set():
                self._poll_sleep()
                still = []
                for idx, t in enumerate(pending):
                    try:
                        if self._maybe_complete(t):
                            continue
                    except BackendCircuitOpenError as exc:
                        self._backend_error("progress-poll", exc)
                        if self._paused_wait(
                                ExecutorState.LEADER_MOVEMENT_TASK_IN_PROGRESS):
                            self._extend_alert_windows(pending)
                        still.extend(pending[idx:])
                        break
                    except BackendTransportError as exc:
                        self._backend_error("progress-poll", exc)
                    # Same dead-task timeout as the replica loops: a peer
                    # that dies after a successful election submit reads as
                    # finished()=False forever, and without this branch the
                    # executor would stay in LEADER_MOVEMENT for good.
                    if (self._now_ms() - t.start_time_ms
                            > self.config.task_execution_alert_timeout_s * 1000):
                        self._transition(t, ExecutionTaskState.DEAD)
                    else:
                        still.append(t)
                pending = still

    def _maybe_complete(self, t: ExecutionTask) -> bool:
        if self.backend.finished(t):
            self._transition(t, ExecutionTaskState.COMPLETED)
            return True
        return False
