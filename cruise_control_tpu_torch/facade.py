"""Orchestration façade.

Reference: ``KafkaCruiseControl.java:73-856`` — the single object wiring
LoadMonitor + GoalOptimizer + Executor + AnomalyDetectorManager and exposing
every operation the API layer serves: cluster model queries, proposals,
rebalance, add/remove/demote brokers, fix offline replicas, topic RF change,
pause/resume sampling, self-healing toggles, stop execution.  Operations
follow the GoalBasedOperationRunnable template
(``servlet/handler/async/runnable/GoalBasedOperationRunnable.java:100-211``):
sanity checks → reserve execution → compute on a fresh snapshot → optionally
execute.

The JAX package's ``facade.py``, with every solve on the facade's ``device``
(the card unless the caller asks for the CPU).  Snapshots pad to the compile
service's shape buckets; ``start_up`` starts its warmup daemon when
``compile_service().warmup_enabled``.  The one solve that may leave the card
is the counted device failover (:meth:`CruiseControl._solve_with_failover`):
on a device-loss error it reruns on the CPU, tagged ``degraded``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from cruise_control_tpu_torch import resilience as _resilience
from cruise_control_tpu_torch.analyzer.budget import SolveBudget
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer, OptimizerResult
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.common.exceptions import OngoingExecutionError, UserRequestError
from cruise_control_tpu_torch.common.metrics import registry as _metric_registry
from cruise_control_tpu_torch.compilesvc.service import compile_service
from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    AnomalyType,
    BrokerFailures,
    DiskFailures,
    GoalViolations,
    MaintenanceEvent,
    MetricAnomaly,
    SloViolationAnomaly,
    TopicAnomaly,
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
from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
from cruise_control_tpu_torch.executor.executor import Executor, ExecutorState
from cruise_control_tpu_torch.model import ops
from cruise_control_tpu_torch.model.builder import ClusterModel
from cruise_control_tpu_torch.model.resident import ResidentModelService
from cruise_control_tpu_torch.model.stats import compute_stats
from cruise_control_tpu_torch.monitor.load_monitor import (
    LoadMonitor,
    ModelCompletenessRequirements,
)
from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner
from cruise_control_tpu_torch.obsvc import oplog as _oplog
from cruise_control_tpu_torch.obsvc.audit import audit_log
from cruise_control_tpu_torch.obsvc.convergence import convergence as _convergence
from cruise_control_tpu_torch.obsvc.execution import execution as _execution
from cruise_control_tpu_torch.obsvc.fidelity import fidelity as _fidelity
from cruise_control_tpu_torch.obsvc.tracer import tracer as _obsvc_tracer

LOG = logging.getLogger(__name__)


def _on_device(x, device):
    """A copy of a tensor dataclass (``ClusterState``, ``Placement``) with
    every tensor field on ``device``; None stays None."""
    if x is None:
        return None
    return dataclasses.replace(x, **{
        f.name: getattr(x, f.name).to(device) for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})


class _SloPreemptDetector:
    """Wraps the SLO burn-rate detector when ``slo.preempt.enabled`` is on:
    solve-time violations come out *fixable* so the notifier routes them to
    the facade's fixer (which preempts the offending solve) instead of
    IGNOREing them as audit-only."""

    def __init__(self, inner):
        self.inner = inner

    def detect(self):
        anomalies = self.inner.detect()
        for a in anomalies:
            if getattr(a, "objective", "") == "solve-time":
                a.fixable = True
        return anomalies

    def __getattr__(self, name):
        return getattr(self.inner, name)


@dataclass
class OperationResult:
    """What every operation returns to the API layer."""

    optimizer_result: Optional[OptimizerResult]
    dryrun: bool
    executed: bool
    info: str = ""
    # True when the solve reran on the CPU after the card was lost — the
    # answer is correct but slower-path; operators alert on it.
    degraded: bool = False
    # True when the solve was preempted (deadline / cancel / shutdown / SLO)
    # and returned the best placement found so far instead of converging.
    partial: bool = False
    # Advisory (never blocks the request): the model fingerprint violated a
    # configured anomaly.model.* staleness threshold at solve time.
    model_stale: bool = False

    def to_dict(self, explain: bool = False) -> Dict:
        d = {"dryrun": self.dryrun, "executed": self.executed, "info": self.info}
        if self.degraded:
            d["degraded"] = True
        if self.partial:
            d["partial"] = True
        if self.model_stale:
            d["modelStale"] = True
        if self.optimizer_result is not None:
            d["result"] = self.optimizer_result.to_dict(explain=explain)
        return d


class CruiseControl:
    """The façade. All cross-component calls route through here."""

    def __init__(
        self,
        load_monitor: LoadMonitor,
        executor: Executor,
        task_runner: Optional[LoadMonitorTaskRunner] = None,
        constraint: Optional[BalancingConstraint] = None,
        default_goals: Optional[Sequence[str]] = None,
        notifier=None,
        self_healing_goals: Optional[Sequence[str]] = None,
        anomaly_detection_interval_s: float = 300.0,
        proposal_precompute_interval_s: float = 0.0,
        default_completeness: Optional[ModelCompletenessRequirements] = None,
        topic_anomaly_target_rf: Optional[int] = None,
        resident_service: Optional[ResidentModelService] = None,
        slo_detector=None,
        default_deadline_ms: Optional[float] = None,
        shutdown_grace_ms: float = 5000.0,
        slo_preempt_enabled: bool = False,
        device="cuda",
    ):
        self.load_monitor = load_monitor
        self.executor = executor
        # Every freeze, solve and detector solve runs here.
        self.device = torch.device(device)
        # Device-resident cluster model: frozen tensors stay on the device
        # across requests and the monitor's changes arrive as deltas applied
        # there instead of full re-freezes.
        self.resident = resident_service or ResidentModelService(device=self.device)
        if self.resident.device != self.device:
            raise ValueError(f"resident service on {self.resident.device}, "
                             f"facade on {self.device}")
        # Offline-logdir key of the last resident build: a flip means disk
        # deaths changed, which the delta journal does not express — rebuild.
        self._offline_key: Optional[tuple] = None
        # (model_generation, Placement) of the last default-goal full solve;
        # seeds what-if lanes so they polish a near-balanced placement
        # instead of re-deriving it from scratch.
        self._base_solution: Optional[tuple] = None
        self.task_runner = task_runner
        # Baseline completeness gate for every goal-based operation
        # (min.valid.partition.ratio; requests may pass stricter ones).
        self.default_completeness = default_completeness
        self.constraint = constraint or BalancingConstraint()
        self.default_goals = list(default_goals or DEFAULT_GOALS)
        self.optimizer = GoalOptimizer(constraint=self.constraint,
                                       goal_names=self.default_goals)
        self.notifier = notifier or SelfHealingNotifier()
        if task_runner is not None:
            executor.set_sampling_hooks(
                lambda: task_runner.pause_sampling("executor"),
                lambda: task_runner.resume_sampling("executor"))
        self.topic_anomaly_target_rf = topic_anomaly_target_rf
        # Deadline/cancellation plumbing (SolveBudget): every operation may
        # carry a budget; the registry lets /cancel_user_task, the SLO
        # escalation and shutdown's grace-drain reach in-flight solves.
        self.default_deadline_ms = default_deadline_ms
        self.shutdown_grace_ms = shutdown_grace_ms
        self.slo_preempt_enabled = slo_preempt_enabled
        self._active_budgets: Set[SolveBudget] = set()
        self._budget_lock = threading.Lock()
        # Optional SLO burn-rate detector (obsvc/slo.py), assembled by the
        # bootstrap from slo.* keys; rides the same manager as the rest.
        self.slo_detector = slo_detector
        self.anomaly_detector = self._build_anomaly_detector(
            self_healing_goals, anomaly_detection_interval_s)
        # Background proposal precompute (GoalOptimizer.java:137-188): a
        # daemon refreshing the generation-keyed proposal cache whenever the
        # model generation moves, so GET /proposals is a cache hit instead of
        # paying cold-solve latency.  0 disables (tests/offline use).
        self._precompute_interval_s = proposal_precompute_interval_s
        self._precompute_stop = threading.Event()
        self._precompute_thread: Optional[threading.Thread] = None
        self._precomputed_generation = None
        # Optional bus consumer feeding the MaintenanceEventDetector
        # (MaintenanceEventTopicReader analog) — assembled by the bootstrap
        # when maintenance.event.transport.* is configured; owned here so its
        # lifecycle rides start_up/shutdown like the reference's reader rides
        # the AnomalyDetectorManager's.
        self.maintenance_reader = None
        # Background warmup (compilesvc): runs the configured goal stack's
        # bucket set right after start_up so the first operator request
        # starts warm.  Built in start_up only when the compile service has
        # warmup enabled.
        self.warmup_daemon = None
        # Wall-clock of the last solve that needed the CPU failover; cleared
        # by the next clean solve.  Feeds the /health device probe.
        self._solver_degraded_at: Optional[float] = None
        self._journal_recovery_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start_up(self) -> None:
        """KafkaCruiseControl.startUp :201-232."""
        if self.task_runner is not None:
            self.task_runner.start()
        self.anomaly_detector.start_detection()
        if self.maintenance_reader is not None:
            self.maintenance_reader.start()
        if self._precompute_interval_s > 0:
            # Non-daemon: a daemon thread killed inside a device call at
            # interpreter exit can abort the process; a non-daemon thread
            # makes exit wait for the in-flight solve (bounded), then stop
            # cleanly.
            # The loop also watches main-thread liveness (atexit is no help:
            # CPython joins non-daemon threads BEFORE atexit callbacks run),
            # so exit paths that never call shutdown() cannot hang the
            # interpreter for more than ~a second past the in-flight solve.
            self._precompute_thread = threading.Thread(
                target=self._precompute_loop, name="proposal-precompute",
                daemon=False)
            self._precompute_thread.start()
        if compile_service().warmup_enabled:
            self.warmup_daemon = self._build_warmup_daemon()
            self.warmup_daemon.start()
        if getattr(self.executor, "journal", None) is not None:
            # Reconcile the crash journal off the startup path: the admin
            # peer may itself be down, and /health reports the in-progress
            # recovery as degraded until it lands.
            timeout_s = (_resilience.settings().journal_adoption_timeout_ms
                         / 1000.0)
            self._journal_recovery_thread = threading.Thread(
                target=self._recover_journal, args=(timeout_s,),
                name="journal-recovery", daemon=True)
            self._journal_recovery_thread.start()

    def _recover_journal(self, timeout_s: float) -> None:
        try:
            self.executor.recover_from_journal(adoption_timeout_s=timeout_s)
        except Exception:  # noqa: BLE001 — recovery must never kill startup
            LOG.exception("journal recovery failed")

    def shutdown(self) -> None:
        # Grace-drain first: cancel every in-flight solve and give it one
        # grace window to unwind through its next segment boundary, so the
        # teardown below never yanks components out from under a dispatch.
        self._drain_solves(self.shutdown_grace_ms)
        if self.warmup_daemon is not None:
            self.warmup_daemon.stop()
        if self.maintenance_reader is not None:
            self.maintenance_reader.stop()
        self._precompute_stop.set()
        if self._precompute_thread is not None:
            self._precompute_thread.join(timeout=5.0)
            if self._precompute_thread.is_alive():
                LOG.warning("proposal precompute still solving; it will stop "
                            "after the in-flight solve completes")
        self.anomaly_detector.shutdown()
        if self.task_runner is not None:
            self.task_runner.shutdown()
        # A self-healing fix may still be executing (the detector tick that
        # started it is fire-and-forget); stop it, or its paused-backend
        # probe loop outlives the app and keeps failing against a peer that
        # is being torn down with us.
        self.executor.user_triggered_stop_execution(user=False)
        # Network-facing admin drivers (SocketClusterBackend) hold a live
        # connection; close it so embedders cycling apps don't leak sockets.
        close = getattr(self.executor.backend, "close", None)
        if close is not None:
            close()
        # Un-publish this app's breaker: the process-global circuit outlives
        # the app, and health() in a later-built app (tests rebuild apps
        # in-process) would otherwise read a dead backend's OPEN state and
        # shed its proposal traffic.
        circuit = getattr(self.executor.backend, "circuit", None)
        if circuit is not None and circuit is _resilience.backend_circuit():
            _resilience.set_backend_circuit(None)

    def _interruptible_wait(self) -> bool:
        """True = stop.  Waits the precompute interval in <=1 s slices,
        stopping early when the stop event fires or the main thread is gone
        (interpreter finalization joins non-daemon threads before atexit, so
        liveness polling is the only reliable unattended-exit signal)."""
        remaining = self._precompute_interval_s
        while remaining > 0:
            slice_s = min(1.0, remaining)
            if self._precompute_stop.wait(slice_s):
                return True
            if not threading.main_thread().is_alive():
                return True
            remaining -= slice_s
        return False

    def _precompute_loop(self) -> None:
        """ProposalCandidateComputer analog (GoalOptimizer.java:545-592): on
        each tick, if the model generation advanced and completeness holds,
        run the default-goal dryrun solve so the cache is warm for readers."""
        while not self._interruptible_wait():
            try:
                generation = self.load_monitor.model_generation
                if generation == self._precomputed_generation:
                    continue
                if not self.load_monitor.meet_completeness_requirements(
                        self.default_completeness
                        or ModelCompletenessRequirements()):
                    # Too early for the proposal solve, but not for the model:
                    # fold the monitor's pending journal into the resident
                    # entry now, on the daemon's clock, so the first request
                    # after the window completes starts from current device
                    # tensors instead of paying the accumulated delta (or an
                    # overflow-forced full freeze).
                    self._pre_apply_resident_deltas(generation)
                    continue
                # Root span: the daemon thread has no request context, so
                # each precompute tick is its own trace in the ring.
                with _obsvc_tracer().span("precompute", generation=generation):
                    self.proposals()
                self._precomputed_generation = generation
            except Exception as e:          # noqa: BLE001 — keep the daemon up
                LOG.warning("proposal precompute failed: %s", e)

    def _pre_apply_resident_deltas(self, generation) -> None:
        """Resident-model follow-on (docs/RESIDENT.md): a precompute tick
        that cannot run the full solve yet still advances the device model.
        The snapshot path applies whatever delta the journal holds (or
        no-ops when nothing is pending); the pin is released immediately —
        nothing solves here, the point is moving the scatter off the first
        request's critical path."""
        if not self.resident.enabled:
            return
        try:
            with _obsvc_tracer().span("precompute.delta_preapply",
                                      generation=generation):
                self._resident_snapshot()
        except Exception as e:   # noqa: BLE001 — monitor may still be booting
            LOG.debug("resident delta pre-apply skipped: %s", e)
        else:
            self.resident.release()

    # ------------------------------------------------------- snapshots

    def _freeze_bucketed(self, builder, device=None):
        """Freeze a model builder onto ``device`` (default the facade's) at
        the compile service's canonical shape buckets, so every snapshot of
        a similar-sized cluster lands on the same padded shape."""
        pad_r, pad_b = compile_service().pad_targets(*builder.counts())
        return builder.freeze(pad_replicas_to=pad_r, pad_brokers_to=pad_b,
                              device=self.device if device is None else device)

    def _resident_snapshot(self, requirements=None):
        """Device tensors for the monitor's current model via the resident
        service: the monitor diffs its long-lived builder, the service turns
        the journal into a scatter-applied delta, and only bucket changes /
        inexpressible edits pay a full freeze.  Returned tensors are PINNED —
        callers must :meth:`ResidentModelService.release` after the solve."""

        def build() -> ClusterModel:
            # Runs under the resident service lock, so the monitor diff and
            # the delta collection cannot interleave with another request.
            try:
                offline = self._offline_logdirs() or {}
            except Exception as e:   # noqa: BLE001 — network seam
                LOG.warning("offline-logdir query failed (%s); building the "
                            "model without dead-disk enrichment", e)
                offline = {}
            key = tuple(sorted((int(b), tuple(sorted(int(d) for d in ds)))
                               for b, ds in offline.items()))
            if key != self._offline_key:
                # A recovered disk has no mark_disk_alive analog, so any
                # flip in the offline set forces a rebuild + full freeze
                # rather than trying to express it as a delta.
                self.load_monitor.reset_resident_builder()
                self.resident.invalidate("offline-logdirs-changed")
                self._offline_key = key
            builder, fresh = self.load_monitor.resident_model_builder(
                requirements=requirements)
            if fresh:
                for b_id, disks in offline.items():
                    for d in disks:
                        try:
                            builder.mark_disk_dead(int(b_id), int(d))
                        except (KeyError, IndexError):
                            pass
            return builder

        return self.resident.snapshot(build, compile_service().pad_targets, pin=True)

    def _build_warmup_daemon(self):
        """Warm tasks run REAL solves at the bucket shapes: the proposals,
        a remove-broker what-if per ladder width, the resident model's delta
        applies, and the relaxation's round per eligible goal (a no-op while
        relaxation is off).  Task keys make re-warming idempotent; failures
        (e.g. load monitor not yet complete) are logged by the daemon and
        never fatal."""
        from cruise_control_tpu_torch.analyzer import relax
        from cruise_control_tpu_torch.analyzer.context import build_context
        from cruise_control_tpu_torch.analyzer.goals.registry import get_goals_by_priority
        from cruise_control_tpu_torch.compilesvc import WarmupDaemon

        svc = compile_service()
        daemon = WarmupDaemon()

        def wait_model_ready(timeout_s: float = 600.0) -> None:
            # start_up launches the warmer before the monitor has completed
            # its first aggregation window; a warm task solving immediately
            # would fail on "0 completed windows".  Poll completeness (and
            # the daemon's abort probe, so shutdown is never blocked) until
            # a model can actually be built.
            req = (self.default_completeness
                   or ModelCompletenessRequirements())
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                if daemon.should_abort():
                    raise RuntimeError("warmup aborted before model ready")
                try:
                    if self.load_monitor.meet_completeness_requirements(req):
                        return
                except Exception:   # noqa: BLE001 — monitor still booting
                    pass
                time.sleep(0.25)
            raise TimeoutError(
                f"load monitor produced no complete window in {timeout_s:.0f}s")

        def _warm_snapshot():
            """Bucketed tensors for warm tasks — through the resident service
            when enabled, so the warmup ALSO seeds the resident entry and the
            first operator request starts on the delta path."""
            if self.resident.enabled:
                return self._resident_snapshot(), True
            builder = self.load_monitor.cluster_model_builder()
            return self._freeze_bucketed(builder), False

        def warm_proposals():
            wait_model_ready()
            self.proposals()

        def _warm_whatif(width: int):
            wait_model_ready()
            (state, placement, meta), pinned = _warm_snapshot()
            try:
                first = [int(meta.broker_ids[0])]
                self.optimizer.batch_remove_scenarios(
                    state, placement, meta,
                    [list(first) for _ in range(width)])
            finally:
                if pinned:
                    self.resident.release()

        def warm_delta():
            # Run the delta applies' index kernels at the model's bucket so
            # the first steady-state delta does not pay their first launch.
            wait_model_ready()
            if not self.resident.enabled:
                return
            (state, placement, meta), pinned = _warm_snapshot()
            try:
                self.resident.warm_scatter(
                    int(state.leader_load.shape[0]),
                    int(state.capacity.shape[0]),
                    int(state.disk_capacity.shape[1]))
            finally:
                if pinned:
                    self.resident.release()

        def warm_relax():
            # The relaxation path: one relax round per eligible goal at the
            # bucket shape, with the same priority-ordered priors chain the
            # optimizer will use.  No-op (and no relax family) when the path
            # is off.
            config = self.optimizer.relaxation
            if config is None:
                return
            wait_model_ready()
            (state, placement, meta), pinned = _warm_snapshot()
            try:
                solver = self.optimizer.solver
                gctx = build_context(state, placement, meta, self.optimizer.constraint,
                                     OptimizationOptions())
                gctx, placement = solver.shard_inputs(gctx, placement)
                agg = solver.aggregates(gctx, placement)
                priors = []
                for goal in get_goals_by_priority(self.default_goals):
                    if daemon.should_abort():
                        return
                    if goal.relax_eligible:
                        relax.relax_dispatch(solver, goal, priors, gctx, placement, agg,
                                             config)
                    priors.append(goal)
            finally:
                if pinned:
                    self.resident.release()

        daemon.add_task(("proposals", tuple(self.default_goals)),
                        warm_proposals)
        # The lane ladder is a LIST: each width warms its own lane family,
        # so chunked wide batches find every block width warm.
        for width in svc.warmup_lane_ladder:
            w = max(1, int(width))
            daemon.add_task(("whatif", tuple(self.default_goals), w),
                            lambda w=w: _warm_whatif(w))
        daemon.add_task(("warm_delta", tuple(self.default_goals)), warm_delta)
        daemon.add_task(("relax", tuple(self.default_goals)), warm_relax)
        return daemon

    def _offline_logdirs(self):
        """Disk-failure source: the executor's cluster backend answers the
        describeLogDirs-shaped query (DiskFailureDetector.java:1-118);
        backends without the query report no failures rather than breaking
        detection wholesale."""
        backend = getattr(self.executor, "backend", None)
        query = getattr(backend, "offline_logdirs", None)
        if query is None:
            return {}
        return query()

    def _build_anomaly_detector(self, self_healing_goals,
                                interval_s) -> AnomalyDetectorManager:
        detectors = {
            AnomalyType.GOAL_VIOLATION: GoalViolationDetector(
                self.load_monitor, goal_names=self_healing_goals,
                device=self.device),
            AnomalyType.BROKER_FAILURE: BrokerFailureDetector(
                self.load_monitor.metadata_client),
            AnomalyType.DISK_FAILURE: DiskFailureDetector(
                self._offline_logdirs),
            AnomalyType.METRIC_ANOMALY: MetricAnomalyDetector(
                self.load_monitor.broker_aggregator),
            AnomalyType.TOPIC_ANOMALY: TopicAnomalyDetector(
                self.load_monitor.metadata_client,
                target_replication_factor=self.topic_anomaly_target_rf),
            AnomalyType.MAINTENANCE_EVENT: MaintenanceEventDetector(),
        }
        if self.slo_detector is not None:
            slo = self.slo_detector
            if self.slo_preempt_enabled:
                # Escalation: a burning solve-time SLO becomes FIXABLE, and
                # the fix is "preempt the offending solve" (the notifier
                # IGNOREs unfixable anomalies before the fixer ever runs).
                slo = _SloPreemptDetector(slo)
            detectors[AnomalyType.SLO_VIOLATION] = slo
        return AnomalyDetectorManager(
            detectors, notifier=self.notifier, fixer=self._fix_anomaly,
            detection_interval_s=interval_s)

    # ---------------------------------------------------------- model views

    def cluster_model_snapshot(self, allow_capacity_estimation: bool = True):
        return self.load_monitor.cluster_model(
            allow_capacity_estimation=allow_capacity_estimation,
            pad_fn=compile_service().pad_targets, device=self.device)

    def broker_stats(self) -> Dict:
        """GET /load (KafkaCruiseControl.clusterModel + brokerStats)."""
        state, placement, meta = self.cluster_model_snapshot()
        stats = compute_stats(state, placement, self.constraint.balance_threshold)
        return stats.to_dict()

    def partition_load(self, max_entries: int = 100) -> List[Dict]:
        """GET /partition_load: per-partition loads sorted by utilization."""
        state, placement, meta = self.cluster_model_snapshot()
        load = ops.effective_load(state, placement)[:meta.num_replicas].cpu().numpy()
        lead = placement.is_leader[:meta.num_replicas].cpu().numpy()
        part = state.partition[:meta.num_replicas].cpu().numpy()
        out = []
        leaders = np.nonzero(lead)[0]
        order = leaders[np.argsort(-load[leaders].sum(axis=1))]
        for r in order[:max_entries]:
            t_idx, p_num = meta.partitions[part[r]]
            out.append({
                "topic": meta.topics[t_idx], "partition": int(p_num),
                "cpu": float(load[r][0]), "networkInbound": float(load[r][1]),
                "networkOutbound": float(load[r][2]), "disk": float(load[r][3]),
            })
        return out

    # ------------------------------------------------------ solve budgets

    def _make_budget(self, deadline_ms, cancel_event) -> Optional[SolveBudget]:
        """Build the operation's :class:`SolveBudget`, or ``None`` when no
        deadline (request param or ``solver.default.deadline.ms``) and no
        cancellation token apply — the ``None`` path is byte-identical to
        the pre-budget solver."""
        deadline = (deadline_ms if deadline_ms is not None
                    else self.default_deadline_ms)
        if (deadline is None or deadline <= 0) and cancel_event is None:
            return None
        return SolveBudget(deadline, cancel_event=cancel_event)

    def _register_budget(self, budget: Optional[SolveBudget]) -> None:
        if budget is None:
            return
        with self._budget_lock:
            self._active_budgets.add(budget)

    def _unregister_budget(self, budget: Optional[SolveBudget]) -> None:
        if budget is None:
            return
        with self._budget_lock:
            self._active_budgets.discard(budget)

    def active_solves(self) -> int:
        """Number of budget-carrying solves currently in flight."""
        with self._budget_lock:
            return len(self._active_budgets)

    def cancel_active_solves(self, reason: str = "cancelled") -> int:
        """Cancel every in-flight budget-carrying solve; returns how many
        tokens were signalled.  Each solve stops at its next segment / goal
        boundary and returns its current placement tagged partial."""
        with self._budget_lock:
            budgets = list(self._active_budgets)
        for b in budgets:
            b.cancel(reason)
        if budgets:
            LOG.info("cancelled %d in-flight solve(s): %s",
                     len(budgets), reason)
        return len(budgets)

    def _drain_solves(self, grace_ms: float) -> bool:
        """Grace-drain: cancel in-flight solves and wait (bounded) for them
        to unwind through their segment boundaries.  True = drained."""
        if not self.cancel_active_solves("shutdown"):
            return True
        deadline = time.monotonic() + max(0.0, grace_ms) / 1000.0
        while time.monotonic() < deadline:
            with self._budget_lock:
                if not self._active_budgets:
                    return True
            time.sleep(0.05)
        with self._budget_lock:
            leftover = len(self._active_budgets)
        if leftover:
            LOG.warning("%d solve(s) still draining past the %.0fms grace "
                        "budget", leftover, grace_ms)
        return leftover == 0

    # ------------------------------------------------------------ operations

    def _run_operation(
        self,
        goals: Optional[Sequence[str]],
        options: OptimizationOptions,
        dryrun: bool,
        model_mutator=None,
        requirements: Optional[ModelCompletenessRequirements] = None,
        use_cached: bool = False,
        deadline_ms: Optional[float] = None,
        cancel_event: Optional[threading.Event] = None,
    ) -> OperationResult:
        tr = _obsvc_tracer()
        if not tr.enabled:
            return self._run_operation_impl(goals, options, dryrun,
                                            model_mutator, requirements,
                                            use_cached, deadline_ms,
                                            cancel_event)
        with tr.span("operation", dryrun=dryrun,
                     num_goals=len(goals or self.default_goals)):
            return self._run_operation_impl(goals, options, dryrun,
                                            model_mutator, requirements,
                                            use_cached, deadline_ms,
                                            cancel_event)

    def _run_operation_impl(
        self,
        goals: Optional[Sequence[str]],
        options: OptimizationOptions,
        dryrun: bool,
        model_mutator=None,
        requirements: Optional[ModelCompletenessRequirements] = None,
        use_cached: bool = False,
        deadline_ms: Optional[float] = None,
        cancel_event: Optional[threading.Event] = None,
    ) -> OperationResult:
        goals = list(goals or self.default_goals)
        if self.default_completeness is not None:
            # The operator's min.valid.partition.ratio is a FLOOR: explicit
            # per-request requirements may only strengthen it.
            requirements = (self.default_completeness if requirements is None
                            else requirements.stronger(
                                self.default_completeness))
        budget = self._make_budget(deadline_ms, cancel_event)
        self._register_budget(budget)
        if not dryrun:
            self.executor.set_generating_proposals_for_execution(True)
        pinned = False
        try:
            # Mutator-free operations ride the resident model: on-device
            # tensors updated by scatter-applied monitor deltas.  Mutators
            # (add/remove/demote, RF change) edit a THROWAWAY builder, so
            # they keep the classic build-enrich-freeze path.
            if model_mutator is None and self.resident.enabled:
                state, placement, meta = self._resident_snapshot(requirements)
                pinned = True
            else:
                state, placement, meta = self._freeze_bucketed(
                    self._build_enriched(requirements, model_mutator))

            def refreeze(device):
                # The tensors (and the resident entry's) may live on the lost
                # card: drop the entry and rebuild from the monitor onto the
                # failover's device.
                self.resident.invalidate("device-failover")
                self.load_monitor.reset_resident_builder()
                return self._freeze_bucketed(
                    self._build_enriched(requirements, model_mutator), device)

            # A request's own goal list gets its own optimizer on the shared
            # solver and relaxation settings (the JAX package's process-wide
            # default solver and relaxation switch).
            optimizer = (self.optimizer if goals == self.default_goals
                         else GoalOptimizer(constraint=self.constraint,
                                            goal_names=goals,
                                            solver=self.optimizer.solver,
                                            relaxation=self.optimizer.relaxation))
            generation = (self.load_monitor.model_generation
                          if use_cached and model_mutator is None else None)
            result, degraded = self._solve_with_failover(
                optimizer, state, placement, meta, options, generation,
                refreeze=refreeze, budget=budget)
            if (model_mutator is None and not degraded and not result.partial
                    and goals == self.default_goals
                    and result.final_placement is not None):
                # Remember the balanced answer: what-if lanes warm-start
                # from it while the generation (and thus the shape) holds.
                # A partial answer never seeds warm starts — it would bake
                # an unconverged placement into every later lane.
                self._base_solution = (self.load_monitor.model_generation,
                                       result.final_placement)
            executed = False
            # A deadline-preempted answer is anytime-safe (every round's
            # placement is feasible and hard-goal-safe), so it executes.
            # Cancellation (user / SLO preempt / shutdown) means "stop",
            # not "act on what you have" — those never execute.
            may_execute = (not result.partial
                           or result.preempt_reason == "deadline")
            if not dryrun and result.proposals and may_execute:
                self.executor.execute_proposals(result.proposals, wait=False)
                executed = True
            elif not dryrun:
                self.executor.set_generating_proposals_for_execution(False)
            # Advisory staleness tag: the verdict gates self-healing, but
            # user-requested proposal traffic still serves — flagged so the
            # caller knows the data quality behind the answer.
            stale = _fidelity().staleness_reason() is not None
            return OperationResult(result, dryrun=dryrun, executed=executed,
                                   degraded=degraded,
                                   partial=bool(result.partial),
                                   model_stale=stale)
        except Exception:
            if not dryrun:
                try:
                    self.executor.set_generating_proposals_for_execution(False)
                except OngoingExecutionError:
                    pass
            raise
        finally:
            self._unregister_budget(budget)
            if pinned:
                self.resident.release()

    def _build_enriched(self, requirements=None, model_mutator=None
                        ) -> ClusterModel:
        """Fresh builder + dead-logdir enrichment + optional mutator.

        Dead logdirs are the ADMIN backend's knowledge (AdminClient
        describeLogDirs in the reference), not the metadata sampler's:
        fold them into the model so their replicas solve as offline —
        without this, fix_offline_replicas would "fix" a healthy model
        and never evacuate the failed disk.  Logdir ids map to the
        broker's disk indices (the JBOD contract the capacity resolver
        uses).  A transient admin-socket failure must not take down
        every optimization operation (the query is an enrichment, and
        the anomaly cycle retries) — log it and build without."""
        builder = self.load_monitor.cluster_model_builder(
            requirements=requirements)
        try:
            offline = self._offline_logdirs() or {}
        except Exception as e:   # noqa: BLE001 — network seam
            LOG.warning("offline-logdir query failed (%s); building the "
                        "model without dead-disk enrichment", e)
            offline = {}
        for b_id, disks in offline.items():
            for d in disks:
                try:
                    builder.mark_disk_dead(int(b_id), int(d))
                except (KeyError, IndexError):
                    # Broker/disk absent from current metadata (e.g.
                    # already decommissioned) — nothing to mark.
                    pass
        if model_mutator is not None:
            model_mutator(builder)
        return builder

    def _solve_with_failover(self, optimizer, state, placement, meta,
                             options, generation, *, refreeze=None,
                             budget=None):
        """Dispatch the solve; on device loss, fail over to the CPU.

        The card can be lost mid-flight.  A rebalance answer computed on the
        CPU is the same solve, just slower, so device-loss-shaped errors
        (:func:`~cruise_control_tpu_torch.resilience.is_device_failure`) are
        caught at this one seam: ``Resilience.solver-cpu-failovers`` counts
        them, the solve reruns on the CPU, and the response and trace span
        are tagged ``degraded`` (the ``/health`` device probe too, until the
        next clean solve).  A fault of the port's own code raises.  The
        cache generation is dropped for the retry: the cached entry may
        itself be poisoned.

        ``refreeze(device)`` (when given) rebuilds (state, placement, meta)
        on the CPU: the originals, and the resident entry they may have come
        from, live on the lost card, so the retry must not read them.  The
        callable invalidates the resident entry so later requests
        full-freeze on a live card.  Without it the given tensors are copied
        to the CPU."""
        try:
            result = optimizer.optimizations(
                state, placement, meta, options=options,
                model_generation=generation, budget=budget)
            self._solver_degraded_at = None
            return result, False
        except Exception as exc:  # noqa: BLE001 — classified below
            if not _resilience.is_device_failure(exc):
                raise
            _metric_registry().counter(_resilience.SOLVER_FAILOVER_SENSOR).inc()
            LOG.error("device failure during solve (%s: %s); retrying on the CPU",
                      type(exc).__name__, exc)
        span = _obsvc_tracer().current()
        if span is not None:
            span.set("degraded", True)
        with _resilience.cpu_fallback() as cpu:
            if refreeze is not None:
                state, placement, meta = refreeze(cpu)
            else:
                state, placement = _on_device(state, cpu), _on_device(placement, cpu)
            result = optimizer.optimizations(
                state, placement, meta, options=options,
                model_generation=None, budget=budget)
        self._solver_degraded_at = time.time()
        return result, True

    def proposals(self, goals: Optional[Sequence[str]] = None,
                  options: Optional[OptimizationOptions] = None,
                  deadline_ms: Optional[float] = None,
                  cancel_event: Optional[threading.Event] = None
                  ) -> OperationResult:
        """GET /proposals — always dryrun, uses the proposal cache."""
        return self._run_operation(goals, options or OptimizationOptions(),
                                   dryrun=True, use_cached=True,
                                   deadline_ms=deadline_ms,
                                   cancel_event=cancel_event)

    def rebalance(self, goals: Optional[Sequence[str]] = None,
                  dryrun: bool = True,
                  options: Optional[OptimizationOptions] = None,
                  deadline_ms: Optional[float] = None,
                  cancel_event: Optional[threading.Event] = None
                  ) -> OperationResult:
        """POST /rebalance (RebalanceRunnable)."""
        return self._run_operation(goals, options or OptimizationOptions(),
                                   dryrun=dryrun, deadline_ms=deadline_ms,
                                   cancel_event=cancel_event)

    def add_brokers(self, broker_ids: Sequence[int],
                    goals: Optional[Sequence[str]] = None,
                    dryrun: bool = True,
                    deadline_ms: Optional[float] = None,
                    cancel_event: Optional[threading.Event] = None
                    ) -> OperationResult:
        """POST /add_broker (AddBrokersRunnable): mark brokers as new and let
        distribution goals pull load onto them."""
        ids = set(broker_ids)

        def mutate(cm: ClusterModel):
            for b in cm.brokers():
                if b.broker_id in ids:
                    b.new_broker = True

        return self._run_operation(goals, OptimizationOptions(), dryrun,
                                   model_mutator=mutate,
                                   deadline_ms=deadline_ms,
                                   cancel_event=cancel_event)

    def remove_brokers(self, broker_ids: Sequence[int],
                       goals: Optional[Sequence[str]] = None,
                       dryrun: bool = True,
                       deadline_ms: Optional[float] = None,
                       cancel_event: Optional[threading.Event] = None
                       ) -> OperationResult:
        """POST /remove_broker (RemoveBrokersRunnable): decommission — mark
        dead so every goal must evacuate them, and exclude them as
        destinations."""
        ids = set(broker_ids)

        def mutate(cm: ClusterModel):
            for b in ids:
                cm.set_broker_state(b, alive=False)

        options = OptimizationOptions(
            excluded_brokers_for_replica_move=frozenset(ids),
            excluded_brokers_for_leadership=frozenset(ids))
        return self._run_operation(goals, options, dryrun, model_mutator=mutate,
                                   deadline_ms=deadline_ms,
                                   cancel_event=cancel_event)

    def remove_brokers_batch(self, removal_sets: Sequence[Sequence[int]],
                             goals: Optional[Sequence[str]] = None,
                             num_candidates: int = 512,
                             deadline_ms: Optional[float] = None,
                             cancel_event: Optional[threading.Event] = None):
        """Batch decommission study: solve every removal set as a what-if
        lane (BASELINE config #5).  The reference would run
        ``RemoveBrokersRunnable`` once per set; this shares the model build
        across all scenarios."""
        budget = self._make_budget(deadline_ms, cancel_event)
        self._register_budget(budget)
        pinned = False
        if self.resident.enabled:
            state, placement, meta = self._resident_snapshot()
            pinned = True
        else:
            builder = self.load_monitor.cluster_model_builder()
            state, placement, meta = self._freeze_bucketed(builder)
        try:
            goal_names = list(goals or self.default_goals)
            optimizer = (self.optimizer if goal_names == self.default_goals
                         else GoalOptimizer(constraint=self.constraint,
                                            goal_names=goal_names,
                                            solver=self.optimizer.solver,
                                            relaxation=self.optimizer.relaxation))
            # Warm start: when the base cluster was already solved this
            # generation, lanes begin from that balanced placement instead of
            # the raw snapshot — each lane only repairs its own removal's
            # damage, and the batched while_loop's per-lane progress guard
            # exits those lanes in a handful of rounds.
            warm = None
            base = self._base_solution
            if (base is not None
                    and base[0] == self.load_monitor.model_generation
                    and base[1].broker.shape == placement.broker.shape):
                warm = base[1]
            return optimizer.batch_remove_scenarios(
                state, placement, meta, removal_sets,
                num_candidates=num_candidates, warm_start=warm,
                budget=budget)
        finally:
            self._unregister_budget(budget)
            if pinned:
                self.resident.release()

    def demote_brokers(self, broker_ids: Sequence[int],
                       dryrun: bool = True,
                       deadline_ms: Optional[float] = None,
                       cancel_event: Optional[threading.Event] = None
                       ) -> OperationResult:
        """POST /demote_broker (DemoteBrokerRunnable): move leadership off
        the brokers via preferred-leader election with them excluded."""
        options = OptimizationOptions(
            excluded_brokers_for_leadership=frozenset(broker_ids))
        return self._run_operation(["PreferredLeaderElectionGoal"], options,
                                   dryrun, deadline_ms=deadline_ms,
                                   cancel_event=cancel_event)

    def fix_offline_replicas(self, goals: Optional[Sequence[str]] = None,
                             dryrun: bool = True,
                             deadline_ms: Optional[float] = None,
                             cancel_event: Optional[threading.Event] = None
                             ) -> OperationResult:
        """POST /fix_offline_replicas (FixOfflineReplicasRunnable)."""
        return self._run_operation(goals, OptimizationOptions(), dryrun,
                                   deadline_ms=deadline_ms,
                                   cancel_event=cancel_event)

    def change_topic_replication_factor(self, topic: str, target_rf: int,
                                        goals: Optional[Sequence[str]] = None,
                                        dryrun: bool = True,
                                        deadline_ms: Optional[float] = None,
                                        cancel_event: Optional[threading.Event] = None
                                        ) -> OperationResult:
        """POST /topic_configuration (TopicConfigurationRunnable →
        ClusterModel.createOrDeleteReplicas :962-1027)."""

        def mutate(cm: ClusterModel):
            cm.create_or_delete_replicas(topic, target_rf)

        return self._run_operation(goals, OptimizationOptions(), dryrun,
                                   model_mutator=mutate,
                                   deadline_ms=deadline_ms,
                                   cancel_event=cancel_event)

    def stop_execution(self) -> None:
        self.executor.user_triggered_stop_execution()

    # ------------------------------------------------------- sampling admin

    def pause_sampling(self, reason: str = "user requested") -> None:
        if self.task_runner is None:
            raise UserRequestError("no sampling task runner configured")
        self.task_runner.pause_sampling(reason)

    def resume_sampling(self, reason: str = "user requested") -> None:
        if self.task_runner is None:
            raise UserRequestError("no sampling task runner configured")
        self.task_runner.resume_sampling(reason)

    # ----------------------------------------------------------- self-healing

    def set_self_healing(self, anomaly_type: AnomalyType, enabled: bool) -> bool:
        return self.notifier.set_self_healing_for(anomaly_type, enabled)

    def _fix_anomaly(self, anomaly: Anomaly) -> bool:
        """Self-healing dispatch (§3.5): every fix is a normal operation."""
        # Stage 2 of the self-healing audit: annotate the detector's entry
        # with the concrete operation chosen for this anomaly; the chosen
        # action also lands in the operation audit log (nobody asked for a
        # self-healing fix, so its trail matters most).
        def note(action: str) -> None:
            audit_log().set_action(anomaly.anomaly_type.name, action)
            _oplog.record("start", endpoint=f"self-healing:{action}",
                          principal="self-healing",
                          anomaly=anomaly.anomaly_type.name)

        # Staleness gate (anomaly.model.* thresholds): never self-heal on a
        # model the fidelity observatory says is stale or heavily invalid —
        # a fix computed from bad data can move replicas the wrong way.
        # SLO-violation anomalies are exempt: preempting a runaway solve
        # depends on no model data.  User-requested proposal traffic is
        # unaffected (it serves with an advisory modelStale=true tag).
        if not isinstance(anomaly, SloViolationAnomaly):
            stale = _fidelity().staleness_reason()
            if stale is not None:
                _fidelity().record_stale_gate()
                fp = _fidelity().current_fingerprint()
                audit_log().record(
                    anomaly.anomaly_type.name,
                    {"reason": "stale_model", "detail": stale,
                     "fingerprint": fp},
                    "IGNORED")
                _oplog.record("abort",
                              endpoint=f"self-healing:"
                                       f"{anomaly.anomaly_type.name}",
                              principal="self-healing", reason="stale_model",
                              generation=(fp or {}).get("generation"))
                LOG.warning("self-healing fix for %s IGNORED: %s",
                            anomaly.anomaly_type.name, stale)
                return False

        try:
            if isinstance(anomaly, BrokerFailures):
                note("remove_broker")
                r = self.remove_brokers(sorted(anomaly.failed_brokers), dryrun=False)
            elif isinstance(anomaly, DiskFailures):
                note("fix_offline_replicas")
                r = self.fix_offline_replicas(dryrun=False)
            elif isinstance(anomaly, GoalViolations):
                note("rebalance")
                r = self.rebalance(anomaly.fixable_violated_goals or None,
                                   dryrun=False)
            elif isinstance(anomaly, MetricAnomaly):
                if anomaly.suggested_action == "remove":
                    note("remove_broker")
                    r = self.remove_brokers([anomaly.broker_id], dryrun=False)
                elif anomaly.suggested_action == "demote":
                    note("demote_broker")
                    r = self.demote_brokers([anomaly.broker_id], dryrun=False)
                else:
                    return False
            elif isinstance(anomaly, TopicAnomaly):
                if anomaly.target_replication_factor is None:
                    return False
                note("topic_replication_factor")
                r = self.change_topic_replication_factor(
                    anomaly.topic, anomaly.target_replication_factor, dryrun=False)
            elif isinstance(anomaly, SloViolationAnomaly):
                # Escalated solve-time SLO burn: actively preempt the
                # offending in-flight solve(s) via their cancellation
                # tokens.  No proposals to execute — success is "the solve
                # was told to stop"; each preempted operation returns its
                # anytime-safe partial placement to its own caller.
                if not (self.slo_preempt_enabled
                        and anomaly.objective == "solve-time"):
                    return False
                note("preempt_solve")
                preempted = self.cancel_active_solves("slo-preempt")
                _oplog.record("preempted" if preempted else "finish",
                              endpoint="self-healing:preempt_solve",
                              principal="self-healing", solves=preempted)
                return preempted > 0
            elif isinstance(anomaly, MaintenanceEvent):
                note(f"maintenance:{anomaly.plan}")
                r = self._run_maintenance(anomaly)
            else:
                return False
            ok = r.executed or bool(r.optimizer_result
                                    and not r.optimizer_result.proposals)
            _oplog.record("finish" if ok else "abort",
                          endpoint=f"self-healing:{anomaly.anomaly_type.name}",
                          principal="self-healing", executed=r.executed,
                          partial=r.partial or None)
            return ok
        except OngoingExecutionError:
            LOG.info("fix deferred: execution already in progress")
            _oplog.record("abort",
                          endpoint=f"self-healing:{anomaly.anomaly_type.name}",
                          principal="self-healing",
                          reason="ongoing-execution")
            return False

    def _run_maintenance(self, event: MaintenanceEvent) -> OperationResult:
        if event.plan == "add_broker":
            return self.add_brokers(event.broker_ids, dryrun=False)
        if event.plan == "remove_broker":
            return self.remove_brokers(event.broker_ids, dryrun=False)
        if event.plan == "demote_broker":
            return self.demote_brokers(event.broker_ids, dryrun=False)
        if event.plan == "fix_offline_replicas":
            return self.fix_offline_replicas(dryrun=False)
        if event.plan == "topic_replication_factor":
            return self.change_topic_replication_factor(
                event.topic, event.replication_factor, dryrun=False)
        return self.rebalance(dryrun=False)

    # ---------------------------------------------------------------- state

    def state(self) -> Dict:
        """GET /state aggregation (CruiseControlState.java)."""
        runner_state = (self.task_runner.state.value
                        if self.task_runner is not None else "NOT_STARTED")
        from cruise_control_tpu_torch.obsvc.memory import memory_ledger
        return {
            "MonitorState": {
                **self.load_monitor.state(runner_state).to_dict(),
                "modelQualityState": _fidelity().state_summary(),
            },
            "ExecutorState": {
                **self.executor.state_summary(),
                "executionState": _execution().state_summary(),
            },
            "AnomalyDetectorState": self.anomaly_detector.state_summary(),
            "AnalyzerState": {
                "isProposalReady": True,
                "goalReadiness": [
                    {"name": g, "status": "ready"} for g in self.default_goals],
                "residentModel": self.resident.stats(),
                "convergence": _convergence().state_summary(),
                "activeSolves": self.active_solves(),
                "memoryState": memory_ledger().state_summary(),
            },
        }

    def health(self) -> Dict:
        """GET /health — per-component probes with a ready/degraded/unhealthy
        rollup.  Cheap by construction (no solve, no model build): a load
        balancer polls this every few seconds.

        Probe semantics:
          * ``model``     — completeness floor met → ready; else degraded
            (goal operations would be rejected, reads still serve).
          * ``backend``   — admin circuit CLOSED → ready, HALF_OPEN →
            degraded, OPEN or executor in PAUSED_BACKEND_DOWN → unhealthy.
          * ``device``    — last solve needed the CPU failover → degraded.
          * ``journal``   — startup reconciliation running or un-reconciled
            orphans on disk → degraded.
        """
        probes: Dict[str, Dict] = {}

        # -- model freshness
        model_status, detail = "ready", {}
        try:
            if self.default_completeness is not None:
                if not self.load_monitor.meet_completeness_requirements(
                        self.default_completeness):
                    model_status = "degraded"
                    detail["reason"] = "completeness requirements not met"
        except Exception as e:  # noqa: BLE001 — a probe never raises
            model_status, detail = "degraded", {"reason": str(e)}
        probes["model"] = {"status": model_status, **detail}

        # -- admin backend circuit
        circuit = (getattr(self.executor.backend, "circuit", None)
                   or _resilience.backend_circuit())
        backend_status, detail = "ready", {}
        if circuit is not None:
            snap = circuit.snapshot()
            detail = {"circuit": snap}
            if snap["state"] == "open":
                backend_status = "unhealthy"
            elif snap["state"] == "half_open":
                backend_status = "degraded"
        if self.executor.state is ExecutorState.PAUSED_BACKEND_DOWN:
            backend_status = "unhealthy"
            detail["reason"] = "executor paused: backend down"
        probes["backend"] = {"status": backend_status, **detail}

        # -- accelerator liveness (observed, not probed: poking the device
        # from the health path could itself wedge on a dead card)
        if self._solver_degraded_at is not None:
            probes["device"] = {
                "status": "degraded",
                "reason": "solver on CPU fallback",
                "sinceMs": int(self._solver_degraded_at * 1000)}
        else:
            probes["device"] = {"status": "ready"}

        # -- crash journal
        journal_status, detail = "ready", {}
        if self.executor.recovering:
            journal_status = "degraded"
            detail["reason"] = "journal reconciliation in progress"
        else:
            journal = getattr(self.executor, "journal", None)
            if journal is not None:
                try:
                    lag = journal.lag()
                except OSError as e:
                    lag, detail = 0, {"reason": str(e)}
                if lag:
                    journal_status = "degraded"
                    detail = {"reason": "un-reconciled journaled tasks",
                              "lag": lag}
        probes["journal"] = {"status": journal_status, **detail}

        order = {"ready": 0, "degraded": 1, "unhealthy": 2}
        worst = max((p["status"] for p in probes.values()),
                    key=lambda s: order[s])
        return {"status": worst, "probes": probes}
