"""REST API server.

Reference: ``servlet/KafkaCruiseControlServlet.java:107-219`` dispatch over
the endpoint enum (``CruiseControlEndPoint.java:17-36``), parameter parsing
(``servlet/parameters/ParameterUtils.java``), async 202-until-done responses
via UserTaskManager, and two-step verification through the Purgatory.

Implementation: stdlib ThreadingHTTPServer — the service is control-plane
(tens of requests/min), so a dependency-free server keeps the runtime
hermetic; the layering (app → façade → components) mirrors
``KafkaCruiseControlApp``.

Endpoint inventory note: the mounted reference tree has no ``rightsize``
endpoint (it post-dates this version; ``CruiseControlEndPoint.java`` lists
20 endpoints without it), so it is intentionally absent here; the provision
signals it would act on are exported as the AnomalyDetector
under/over/right-sized gauges.

The JAX package's server over the port's facade: every solving endpoint
solves on the facade's device, and the endpoint tables are the JAX
package's.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import inspect
import json
import logging
import threading
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.common.exceptions import (
    CruiseControlError,
    OngoingExecutionError,
    UserRequestError,
)
from cruise_control_tpu_torch.detector.anomalies import AnomalyType
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.obsvc import oplog as _oplog
from cruise_control_tpu_torch.obsvc.tracer import tracer as _obsvc_tracer
from cruise_control_tpu_torch.servlet.purgatory import Purgatory
from cruise_control_tpu_torch.servlet.user_tasks import TaskState, UserTaskManager

LOG = logging.getLogger(__name__)

USER_TASK_HEADER = "User-Task-ID"
REQUEST_ID_HEADER = "X-Request-ID"

GET_ENDPOINTS = {"bootstrap", "train", "load", "partition_load", "proposals",
                 "state", "kafka_cluster_state", "user_tasks", "review_board",
                 "metrics", "compile_cache", "trace", "health",
                 "solver_stats", "metrics/history", "memory", "profile",
                 "execution_progress", "model_quality"}
POST_ENDPOINTS = {"add_broker", "remove_broker", "fix_offline_replicas",
                  "rebalance", "stop_proposal_execution", "pause_sampling",
                  "resume_sampling", "demote_broker", "admin", "review",
                  "topic_configuration", "profile", "cancel_user_task"}
# POSTs subject to two-step verification (mutating cluster state).
REVIEWABLE = {"add_broker", "remove_broker", "fix_offline_replicas", "rebalance",
              "demote_broker", "topic_configuration"}
# Endpoints that generate/execute proposals: refused with 503 + Retry-After
# while /health reports unhealthy (degraded still serves — a stale model is
# conservative, not wrong; the port never reruns a solve on the CPU).  Reads and the
# stop/pause controls always pass: an operator must be able to stop an
# execution precisely when things are on fire.
PROPOSE_ENDPOINTS = {"proposals", "rebalance", "add_broker", "remove_broker",
                     "demote_broker", "fix_offline_replicas",
                     "topic_configuration"}


def _parse_params(query: str) -> Dict[str, str]:
    return {k.lower(): v[-1] for k, v in urllib.parse.parse_qs(query).items()}


def _bool(params: Dict[str, str], name: str, default: bool) -> bool:
    raw = params.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("true", "1", "yes")


def _ints(params: Dict[str, str], name: str) -> List[int]:
    raw = params.get(name, "")
    return [int(x) for x in raw.split(",") if x.strip()]


def _restricted_goals(names: List[str], allowed: List[str],
                      label: str) -> List[str]:
    """Empty request → the full allowed list; otherwise reject names outside
    it and keep the allowed list's canonical order."""
    if not names:
        return list(allowed)
    bad = [n for n in names if n not in allowed]
    if bad:
        raise UserRequestError(
            f"goals {bad} are not {label} goals (allowed: {allowed})")
    return [g for g in allowed if g in names]


def _goals(params: Dict[str, str],
           allow_rebalance_disk: bool = False) -> Optional[List[str]]:
    """Requested goal list; ``kafka_assigner=true`` swaps in the assigner
    pair (reference RunnableUtils.java isKafkaAssignerMode) and — on the
    rebalance endpoint only, as in RebalanceParameters —
    ``rebalance_disk=true`` swaps in the intra-broker goal list; explicit
    subsets are validated against the mode's allowed set (the reference's
    sanityCheckOptimizationOptions)."""
    raw = params.get("goals", "")
    names = [g.strip().rsplit(".", 1)[-1] for g in raw.split(",") if g.strip()]
    if allow_rebalance_disk and _bool(params, "rebalance_disk", False):
        from cruise_control_tpu_torch.analyzer.goals.registry import (
            DEFAULT_INTRA_BROKER_GOALS,
        )
        if _bool(params, "kafka_assigner", False):
            raise UserRequestError(
                "rebalance_disk and kafka_assigner are mutually exclusive")
        return _restricted_goals(names, DEFAULT_INTRA_BROKER_GOALS,
                                 "intra-broker")
    if _bool(params, "kafka_assigner", False):
        from cruise_control_tpu_torch.analyzer.goals.registry import KAFKA_ASSIGNER_GOALS
        # Canonical order: the even goal must run before the disk goal (it
        # assumes no prior optimized goals).
        return _restricted_goals(names, KAFKA_ASSIGNER_GOALS, "kafka_assigner")
    return names or None


def _deadline_ms(params: Dict[str, str]) -> Optional[float]:
    """``?deadline_ms=`` — wall-clock budget for this operation's solve.
    Absent → None (the facade falls back to solver.default.deadline.ms)."""
    raw = params.get("deadline_ms")
    if raw is None:
        return None
    try:
        value = float(raw)
    except ValueError:
        raise UserRequestError("deadline_ms must be a number")
    if value <= 0:
        raise UserRequestError("deadline_ms must be positive")
    return value


def _options(params: Dict[str, str]) -> OptimizationOptions:
    return OptimizationOptions(
        excluded_topics=frozenset(
            t for t in params.get("excluded_topics", "").split(",") if t),
        requested_destination_broker_ids=frozenset(
            _ints(params, "destination_broker_ids")),
        only_move_immigrant_replicas=_bool(
            params, "only_move_immigrant_replicas", False),
    )


class CruiseControlApp:
    """HTTP front over the façade (KafkaCruiseControlApp.java:36-68)."""

    def __init__(self, cc: CruiseControl, host: str = "127.0.0.1", port: int = 0,
                 two_step_verification: bool = False,
                 max_active_user_tasks: int = 25,
                 security=None,
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None,
                 ssl_keyfile_password: Optional[str] = None,
                 ui_diskpath: Optional[str] = None,
                 ui_urlprefix: str = "/*",
                 api_urlprefix: str = "/kafkacruisecontrol/*",
                 user_task_retention_ms: float = 86_400_000,
                 user_task_timeout_ms: Optional[float] = None):
        self.cc = cc
        self.user_tasks = UserTaskManager(
            max_active_tasks=max_active_user_tasks,
            completed_retention_ms=user_task_retention_ms,
            task_timeout_ms=user_task_timeout_ms)
        # webserver.api.urlprefix (WebServerConfig): the mount point of the
        # REST API, normalized to a trailing-slash prefix for dispatch.  A
        # root mount ("/*" or "/") is honored — the API then owns every
        # path and any configured UI is unreachable, which is the
        # operator's explicit choice, not a fallback.
        self.api_prefix = api_urlprefix.rstrip("*").rstrip("/") + "/"
        self.purgatory = Purgatory() if two_step_verification else None
        # Static frontend serving (KafkaCruiseControlApp.setupWebUi + Jetty
        # DefaultServlet; WebServerConfig webserver.ui.diskpath/.urlprefix):
        # GETs outside the API prefix serve files from ``ui_diskpath``.
        self.ui_diskpath = ui_diskpath
        self.ui_urlprefix = ui_urlprefix
        # Optional servlet security provider (servlet/security.py): when set,
        # every request is authenticated and role-checked before dispatch.
        self.security = security
        handler = _make_handler(self)
        self.server = ThreadingHTTPServer((host, port), handler)
        # TLS listener (KafkaCruiseControlApp.java:100-120 SSL connector):
        # PEM cert/key via config; requests then ride https.
        if ssl_certfile:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(ssl_certfile, keyfile=ssl_keyfile,
                                password=ssl_keyfile_password)
            # Defer the handshake to the per-request handler thread: with
            # do_handshake_on_connect=True the accept loop performs the full
            # handshake synchronously, so one stalled client would block
            # every other connection.
            self.server.socket = ctx.wrap_socket(
                self.server.socket, server_side=True,
                do_handshake_on_connect=False)
        self.ssl_enabled = bool(ssl_certfile)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="http-server")
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.user_tasks.shutdown()

    # ------------------------------------------------------------ endpoints

    def handle(self, method: str, endpoint: str, params: Dict[str, str],
               task_id: Optional[str]) -> Tuple[int, Dict, Dict[str, str]]:
        """(status, body, extra_headers)."""
        if method == "GET" and endpoint not in GET_ENDPOINTS:
            return 404, {"error": f"unknown GET endpoint {endpoint}"}, {}
        if method == "POST" and endpoint not in POST_ENDPOINTS:
            return 404, {"error": f"unknown POST endpoint {endpoint}"}, {}

        # Degraded-mode admission: while the service is unhealthy, proposing
        # new work would either fail (backend down) or act on a broken view
        # of the cluster — shed it up front instead of queueing doomed tasks.
        if endpoint in PROPOSE_ENDPOINTS:
            rejected = self._admission_check()
            if rejected is not None:
                return rejected

        # Two-step verification: park reviewable POSTs without approval.
        if (method == "POST" and self.purgatory is not None
                and endpoint in REVIEWABLE):
            review_id = params.get("review_id")
            if review_id is None:
                info = self.purgatory.add(
                    endpoint, urllib.parse.urlencode(params))
                return 202, {"reviewResult": info.to_dict(),
                             "message": "pending review"}, {}
            self.purgatory.take_approved(int(review_id))

        # Slash endpoints (metrics/history) dispatch to underscore methods.
        # A verb-specific handler (``_ep_get_profile``) wins over the shared
        # one for routes served under both verbs.
        ep_name = endpoint.replace("/", "_")
        handler = (getattr(self, f"_ep_{method.lower()}_{ep_name}", None)
                   or getattr(self, f"_ep_{ep_name}", None))
        if handler is None:
            return 501, {"error": f"{endpoint} not implemented"}, {}
        # Per-endpoint servlet sensors (Sensors.md: <endpoint>-request-rate,
        # <endpoint>-successful-request-execution-timer).
        from cruise_control_tpu_torch.common.metrics import registry
        reg = registry()
        reg.counter(f"KafkaCruiseControlServlet.{endpoint}-request-rate").inc()
        import time as _time
        t0 = _time.monotonic()
        try:
            status, body, headers = handler(params, task_id)
        except UserRequestError as e:
            return 400, {"error": str(e)}, {}
        if status < 400:
            reg.timer(
                f"KafkaCruiseControlServlet.{endpoint}"
                "-successful-request-execution-timer"
            ).update_ms((_time.monotonic() - t0) * 1000.0)
        return status, body, headers

    def _admission_check(self) -> Optional[Tuple[int, Dict, Dict[str, str]]]:
        """503 + Retry-After for propose traffic while unhealthy, else None.
        A broken probe must never turn into a request failure — admission
        fails open."""
        from cruise_control_tpu_torch import resilience
        try:
            health = self.cc.health()
        except Exception:  # noqa: BLE001 — probes must not break admission
            LOG.exception("health probe failed during admission; admitting")
            return None
        if health.get("status") != "unhealthy":
            return None
        from cruise_control_tpu_torch.common.metrics import registry
        registry().counter(resilience.ADMISSION_REJECTIONS_SENSOR).inc()
        retry_after = resilience.settings().health_retry_after_s
        unhealthy = sorted(name for name, p in health["probes"].items()
                           if p["status"] == "unhealthy")
        return 503, {
            "error": "ServiceUnhealthy",
            "message": ("service unhealthy "
                        f"({', '.join(unhealthy) or 'unknown'}); "
                        "proposal traffic is shed until it recovers"),
            "health": health,
        }, {"Retry-After": str(retry_after)}

    # ---- sync GETs

    def _ep_health(self, params, task_id):
        """Component probes + rollup; 503 while unhealthy so plain HTTP
        checks (load balancers, k8s) need no body parsing."""
        body = self.cc.health()
        if body["status"] == "unhealthy":
            from cruise_control_tpu_torch import resilience
            return 503, body, {
                "Retry-After": str(resilience.settings().health_retry_after_s)}
        return 200, body, {}

    def _ep_state(self, params, task_id):
        body = self.cc.state()
        if not _bool(params, "verbose", False):
            body["AnalyzerState"].pop("goalReadiness", None)
        return 200, body, {}

    def _ep_load(self, params, task_id):
        return 200, self.cc.broker_stats(), {}

    def _ep_metrics(self, params, task_id):
        """Sensor surface: JSON snapshot (?json=true) or Prometheus text."""
        from cruise_control_tpu_torch.common.metrics import registry
        if _bool(params, "json", False):
            return 200, {"sensors": registry().snapshot()}, {}
        return 200, registry().prometheus_text(), {}

    def _ep_trace(self, params, task_id):
        """Recent root span trees + per-phase rollup (obsvc tracer)."""
        tr = _obsvc_tracer()
        return 200, {"enabled": tr.enabled, "traces": tr.traces(),
                     "rollup": tr.rollup()}, {}

    def _ep_solver_stats(self, params, task_id):
        """Convergence observatory: the flight-recorder ring of per-solve
        per-goal round curves (trace.solver.rounds) plus derived stats."""
        from cruise_control_tpu_torch.obsvc.convergence import convergence
        rec = convergence()
        records = rec.records()
        try:
            limit = int(params.get("limit", "0"))
        except ValueError:
            return 400, {"error": "limit must be an integer"}, {}
        if limit > 0:
            records = records[-limit:]
        summary = rec.state_summary()
        return 200, {"enabled": summary["enabled"],
                     "recorded": summary["recorded"],
                     "ringSize": summary["ringSize"],
                     "records": records}, {}

    def _ep_metrics_history(self, params, task_id):
        """Sensor time-series rings sampled by the obsvc history thread.
        ``sensor`` accepts an exact name or an fnmatch glob (prefix queries
        like ``Memory.*``); the response is bounded to ``limit`` series
        (default 64, capped) with a ``truncated`` flag."""
        from cruise_control_tpu_torch.obsvc import history
        hist = history()
        since_raw = params.get("since_ms")
        try:
            since_ms = float(since_raw) if since_raw is not None else None
        except ValueError:
            return 400, {"error": "since_ms must be a number"}, {}
        try:
            limit = int(params.get("limit", str(hist.DEFAULT_SERIES_LIMIT)))
        except ValueError:
            return 400, {"error": "limit must be an integer"}, {}
        if limit <= 0:
            return 400, {"error": "limit must be positive"}, {}
        series, truncated = hist.history_bounded(
            pattern=params.get("sensor"), since_ms=since_ms, limit=limit)
        from cruise_control_tpu_torch.obsvc.history import SAMPLES_SENSOR
        from cruise_control_tpu_torch.common.metrics import registry
        return 200, {"enabled": hist.running,
                     "intervalMs": hist.interval_s * 1000.0,
                     "ringSize": hist.ring_size,
                     "samples": registry().counter(SAMPLES_SENSOR).count,
                     "truncated": truncated,
                     "series": series}, {}

    def _ep_compile_cache(self, params, task_id):
        """Compile-service admin view: bucket policy, lane widths already
        run, persistent-cache state, warmup progress, per-bucket
        hit/miss/compile counters (the raw sensors also ride /metrics)."""
        from cruise_control_tpu_torch.compilesvc import compile_service
        body = compile_service().snapshot()
        daemon = getattr(self.cc, "warmup_daemon", None)
        body["warmup"] = daemon.snapshot() if daemon is not None else None
        return 200, body, {}

    def _ep_partition_load(self, params, task_id):
        n = int(params.get("entries", "100"))
        return 200, {"records": self.cc.partition_load(max_entries=n)}, {}

    def _ep_kafka_cluster_state(self, params, task_id):
        md = self.cc.load_monitor.metadata_client.refresh_metadata()
        return 200, {
            "KafkaBrokerState": {
                "Summary": {"brokers": len(md.brokers),
                            "alive": len(md.alive_broker_ids())},
                "brokers": [{"id": b.broker_id, "rack": b.rack, "host": b.host,
                             "alive": b.alive} for b in md.brokers],
            },
            "KafkaPartitionState": {
                "offline": [f"{p.topic}-{p.partition}" for p in md.partitions
                            if p.leader is None],
                "urp": [f"{p.topic}-{p.partition}" for p in md.partitions
                        if len(p.in_sync) < len(p.replicas)],
            },
        }, {}

    def _ep_user_tasks(self, params, task_id):
        return 200, {"userTasks": [t.to_dict()
                                   for t in self.user_tasks.all_tasks()]}, {}

    def _ep_review_board(self, params, task_id):
        if self.purgatory is None:
            return 400, {"error": "two-step verification disabled"}, {}
        return 200, {"RequestInfo": self.purgatory.board()}, {}

    def _ep_bootstrap(self, params, task_id):
        if self.cc.task_runner is None:
            return 400, {"error": "no task runner"}, {}
        start = float(params.get("start", 0))
        end = float(params.get("end", 0))
        n = self.cc.task_runner.bootstrap(start, end)
        return 200, {"message": f"bootstrapped {n} samples"}, {}

    def _ep_train(self, params, task_id):
        from cruise_control_tpu_torch.model.cpu_model import LinearRegressionCpuModel
        model = LinearRegressionCpuModel(min_samples=1)
        from cruise_control_tpu_torch.monitor import metric_def as md
        try:
            result = self.cc.load_monitor.broker_aggregator.aggregate(
                float(params.get("start", 0)), float(params.get("end", 1e18)))
        except CruiseControlError as e:
            return 400, {"error": str(e)}, {}
        bdef = md.BROKER_METRIC_DEF
        for _, vae in result.values_and_extrapolations.items():
            for w in range(vae.values.shape[1]):
                model.add_sample(
                    vae.values[bdef.metric_id("LEADER_BYTES_IN"), w],
                    vae.values[bdef.metric_id("LEADER_BYTES_OUT"), w],
                    vae.values[bdef.metric_id("REPLICATION_BYTES_IN_RATE"), w],
                    vae.values[bdef.metric_id("CPU_USAGE"), w])
        coef = model.fit()
        return 200, {"message": "training done",
                     "coefficients": None if coef is None else coef.tolist()}, {}

    def _ep_profile(self, params, task_id):
        """Admin: open a ``torch.profiler`` capture window for
        ``duration_s`` seconds on a background thread and answer 202
        immediately — poll ``GET /profile`` for busy/done/trace_dir.  A
        second POST while a window is open (sync or async) answers 409."""
        from cruise_control_tpu_torch.obsvc import profiler
        try:
            duration_s = float(params.get("duration_s", "2.0"))
        except ValueError:
            return 400, {"error": "duration_s must be a number"}, {}
        try:
            out = profiler.start_async(duration_s)
        except ValueError as e:
            return 400, {"error": str(e)}, {}
        except profiler.ProfileInProgress as e:
            return 409, {"error": str(e)}, {}
        except Exception as e:   # noqa: BLE001 — profiler backend seam
            LOG.exception("profile capture failed to start")
            return 500, {"error": type(e).__name__, "message": str(e)}, {}
        return 202, {"message": "profile capture started",
                     "status": "started", **out}, {}

    def _ep_get_profile(self, params, task_id):
        """Pollable capture status: busy while a window is open, done +
        trace_dir once the last async capture landed."""
        from cruise_control_tpu_torch.obsvc import profiler
        return 200, profiler.status(), {}

    def _ep_memory(self, params, task_id):
        """Device-memory observatory: per-subsystem live-bytes ledger,
        reconciliation against the card's allocator, headroom-guard counters,
        and the per-family cost rows (404 while memory.enabled=false)."""
        from cruise_control_tpu_torch.obsvc.memory import memory_ledger
        ledger = memory_ledger()
        if not ledger.enabled:
            return 404, {"error": "memory ledger disabled "
                                  "(memory.enabled=false)"}, {}
        return 200, ledger.snapshot(), {}

    def _ep_model_quality(self, params, task_id):
        """Fidelity observatory: the current model fingerprint with its
        staleness verdict, the per-window quality ring, broker-liveness
        flaps and the last fetch summary (404 while
        monitor.fidelity.enabled=false)."""
        from cruise_control_tpu_torch.obsvc.fidelity import fidelity
        rec = fidelity()
        if not rec.enabled:
            return 404, {"error": "fidelity observatory disabled "
                                  "(monitor.fidelity.enabled=false)"}, {}
        return 200, rec.quality(), {}

    def _ep_execution_progress(self, params, task_id):
        """Execution observatory: the active batch's per-task state joined
        with each move's provenance record, per-broker inflight counts, the
        EWMA throughput/ETA estimate, recent batch summaries and AIMD tuner
        events (404 while execution.observatory.enabled=false)."""
        from cruise_control_tpu_torch.obsvc.execution import execution
        rec = execution()
        if not rec.enabled:
            return 404, {"error": "execution observatory disabled "
                                  "(execution.observatory.enabled=false)"}, {}
        return 200, rec.progress(), {}

    # ---- async operations (202-until-done)

    def _async(self, endpoint: str, params: Dict[str, str], task_id: Optional[str],
               op: Callable) -> Tuple[int, Dict, Dict[str, str]]:
        """``op`` takes the task's cancellation token (a threading.Event the
        façade folds into the operation's SolveBudget) and returns the
        OperationResult."""
        query = urllib.parse.urlencode(params)
        existing = self.user_tasks.get(task_id) if task_id else None
        if existing is not None:
            task = existing
        else:
            # Snapshot this request's context (most importantly the active
            # trace span) so the user-task worker thread parents its spans
            # under the request's root instead of starting orphan traces.
            ctx = contextvars.copy_context()
            cancel_token = threading.Event()
            task = self.user_tasks.get_or_create(
                task_id, endpoint, query,
                lambda progress: ctx.run(op, cancel_token),
                cancel_token=cancel_token)
            _oplog.record("start", task_id=task.task_id, endpoint=endpoint,
                          params=query)
            task.future.add_done_callback(
                lambda f, t=task, e=endpoint, q=query, p=_oplog.current_principal():
                self._oplog_outcome(t, e, q, p))
        headers = {USER_TASK_HEADER: task.task_id}
        # ?explain=true is a render-time flag, not part of the operation:
        # re-polling a cached task with a different explain value re-renders
        # the same result, it never re-runs the solve.
        explain = _bool(params, "explain", False)
        if task.state is TaskState.ACTIVE:
            try:
                result = task.future.result(timeout=5.0)
                return 200, self._render(result, explain), headers
            except concurrent.futures.TimeoutError:
                # On 3.11+ this is the builtin TimeoutError; on 3.10 it is a
                # distinct class, and catching only the builtin returned 500
                # instead of the 202-in-progress contract.
                return 202, {"progress": task.progress.to_list(),
                             "message": "operation in progress"}, headers
            except CruiseControlError as e:
                return 500, {"error": type(e).__name__, "message": str(e)}, headers
        if task.state is TaskState.COMPLETED_WITH_ERROR:
            e = task.future.exception()
            code = 409 if isinstance(e, OngoingExecutionError) else 500
            return code, {"error": type(e).__name__, "message": str(e)}, headers
        return 200, self._render(task.future.result(), explain), headers

    @staticmethod
    def _oplog_outcome(task, endpoint: str, query: str,
                       principal: str) -> None:
        """Terminal oplog event for a finished user task.  Runs on the
        worker thread via the future's done callback — the request context
        is gone, so the captured principal is passed explicitly."""
        try:
            if task.future.exception() is not None:
                _oplog.record("abort", task_id=task.task_id,
                              endpoint=endpoint, params=query,
                              principal=principal,
                              reason=type(task.future.exception()).__name__)
                return
            result = task.future.result()
            if getattr(result, "partial", False):
                _oplog.record("preempted", task_id=task.task_id,
                              endpoint=endpoint, params=query,
                              principal=principal,
                              reason=task.cancel_reason or "deadline",
                              executed=getattr(result, "executed", None))
            else:
                _oplog.record("finish", task_id=task.task_id,
                              endpoint=endpoint, params=query,
                              principal=principal,
                              executed=getattr(result, "executed", None))
        except Exception:   # noqa: BLE001 — audit must never break a task
            LOG.exception("operation log emit failed")

    @staticmethod
    def _render(result, explain: bool = False) -> Dict:
        if not hasattr(result, "to_dict"):
            return {"result": result}
        if "explain" in inspect.signature(result.to_dict).parameters:
            return result.to_dict(explain=explain)
        return result.to_dict()   # result types without an explain view

    def _ep_proposals(self, params, task_id):
        goals = _goals(params)
        options = _options(params)
        dl = _deadline_ms(params)
        return self._async("proposals", params, task_id,
                           lambda ev: self.cc.proposals(
                               goals, options, deadline_ms=dl,
                               cancel_event=ev))

    def _ep_rebalance(self, params, task_id):
        goals = _goals(params, allow_rebalance_disk=True)
        dryrun = _bool(params, "dryrun", True)
        options = _options(params)
        dl = _deadline_ms(params)
        return self._async("rebalance", params, task_id,
                           lambda ev: self.cc.rebalance(
                               goals, dryrun, options, deadline_ms=dl,
                               cancel_event=ev))

    def _ep_add_broker(self, params, task_id):
        ids = _ints(params, "brokerid")
        if not ids:
            return 400, {"error": "brokerid parameter required"}, {}
        dl = _deadline_ms(params)
        return self._async("add_broker", params, task_id,
                           lambda ev: self.cc.add_brokers(
                               ids, _goals(params), _bool(params, "dryrun", True),
                               deadline_ms=dl, cancel_event=ev))

    def _ep_remove_broker(self, params, task_id):
        ids = _ints(params, "brokerid")
        if not ids:
            return 400, {"error": "brokerid parameter required"}, {}
        dl = _deadline_ms(params)
        return self._async("remove_broker", params, task_id,
                           lambda ev: self.cc.remove_brokers(
                               ids, _goals(params), _bool(params, "dryrun", True),
                               deadline_ms=dl, cancel_event=ev))

    def _ep_demote_broker(self, params, task_id):
        ids = _ints(params, "brokerid")
        if not ids:
            return 400, {"error": "brokerid parameter required"}, {}
        dl = _deadline_ms(params)
        return self._async("demote_broker", params, task_id,
                           lambda ev: self.cc.demote_brokers(
                               ids, _bool(params, "dryrun", True),
                               deadline_ms=dl, cancel_event=ev))

    def _ep_fix_offline_replicas(self, params, task_id):
        dl = _deadline_ms(params)
        return self._async("fix_offline_replicas", params, task_id,
                           lambda ev: self.cc.fix_offline_replicas(
                               _goals(params), _bool(params, "dryrun", True),
                               deadline_ms=dl, cancel_event=ev))

    def _ep_topic_configuration(self, params, task_id):
        topic = params.get("topic")
        rf = params.get("replication_factor")
        if not topic or rf is None:
            return 400, {"error": "topic and replication_factor required"}, {}
        dl = _deadline_ms(params)
        return self._async("topic_configuration", params, task_id,
                           lambda ev: self.cc.change_topic_replication_factor(
                               topic, int(rf), _goals(params),
                               _bool(params, "dryrun", True),
                               deadline_ms=dl, cancel_event=ev))

    # ---- sync POSTs

    def _ep_cancel_user_task(self, params, task_id):
        """POST /cancel_user_task — abort an in-flight 202 operation at its
        next budget checkpoint (segment or goal boundary).  The task then
        completes with its anytime-safe partial result, never executed."""
        tid = params.get("user_task_id") or task_id
        if not tid:
            return 400, {"error": "user_task_id parameter (or User-Task-ID "
                                  "header) required"}, {}
        task = self.user_tasks.get(tid)
        if task is None:
            return 404, {"error": f"unknown user task {tid}"}, {}
        if task.state is not TaskState.ACTIVE:
            return 400, {"error": f"task {tid} is not active "
                                  f"({task.state.value})"}, {}
        if not task.cancel("user"):
            return 400, {"error": f"task {tid} carries no cancellation "
                                  "token"}, {}
        _oplog.record("abort", task_id=tid, endpoint=task.endpoint,
                      params=task.query, reason="user-cancel-requested")
        return 200, {"message": "cancellation requested; the operation "
                                "stops at its next segment boundary",
                     "UserTaskId": tid}, {USER_TASK_HEADER: tid}

    def _ep_stop_proposal_execution(self, params, task_id):
        self.cc.stop_execution()
        return 200, {"message": "execution stop requested"}, {}

    def _ep_pause_sampling(self, params, task_id):
        try:
            self.cc.pause_sampling(params.get("reason", "via API"))
        except UserRequestError as e:
            return 400, {"error": str(e)}, {}
        return 200, {"message": "sampling paused"}, {}

    def _ep_resume_sampling(self, params, task_id):
        try:
            self.cc.resume_sampling(params.get("reason", "via API"))
        except UserRequestError as e:
            return 400, {"error": str(e)}, {}
        return 200, {"message": "sampling resumed"}, {}

    def _ep_admin(self, params, task_id):
        out: Dict[str, Any] = {}
        if "enable_self_healing_for" in params:
            for name in params["enable_self_healing_for"].split(","):
                t = AnomalyType[name.strip().upper()]
                out.setdefault("selfHealingEnabledBefore", {})[t.name] = \
                    self.cc.set_self_healing(t, True)
        if "disable_self_healing_for" in params:
            for name in params["disable_self_healing_for"].split(","):
                t = AnomalyType[name.strip().upper()]
                out.setdefault("selfHealingEnabledBefore", {})[t.name] = \
                    self.cc.set_self_healing(t, False)
        if "concurrent_partition_movements_per_broker" in params:
            n = int(params["concurrent_partition_movements_per_broker"])
            self.cc.executor.config.concurrent_partition_movements_per_broker = n
            out["concurrency"] = n
        return 200, out or {"message": "no-op"}, {}

    def _ep_review(self, params, task_id):
        if self.purgatory is None:
            return 400, {"error": "two-step verification disabled"}, {}
        approve = _ints(params, "approve")
        discard = _ints(params, "discard")
        results = []
        for rid in approve:
            results.append(self.purgatory.review(
                rid, True, params.get("reason", "")).to_dict())
        for rid in discard:
            results.append(self.purgatory.review(
                rid, False, params.get("reason", "")).to_dict())
        return 200, {"RequestInfo": results}, {}


def _make_handler(app: CruiseControlApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # NCSA log → logger, not stderr
            LOG.debug("http: " + fmt, *args)

        def _dispatch(self, method: str):
            parsed = urllib.parse.urlparse(self.path)
            if not parsed.path.startswith(app.api_prefix):
                # The API prefix always wins; anything else is the static
                # frontend when one is configured (Jetty DefaultServlet
                # semantics: GET only, index.html for the root).  The
                # security handler covers the UI exactly as it covers the
                # API (the reference mounts both in one secured context):
                # any authenticated principal may fetch frontend assets.
                if method == "GET" and app.ui_diskpath:
                    if app.security is not None \
                            and self._authenticate_or_401() is None:
                        return
                    self._serve_ui(parsed.path)
                else:
                    self._send(404, {"error": "not found"})
                return
            endpoint = parsed.path[len(app.api_prefix):].strip("/").lower()
            if app.security is not None:
                from cruise_control_tpu_torch.servlet.security import (
                    permits,
                    required_role,
                )
                principal = self._authenticate_or_401()
                if principal is None:
                    return
                # Bind the authenticated identity for the operation audit
                # log; user-task workers inherit it via the copied context.
                _oplog.set_principal(principal.name)
                need = required_role(method, endpoint)
                if not permits(principal.role, need):
                    self._send(403, {
                        "error": f"role {principal.role.value} may not access "
                                 f"{method} {endpoint} (requires {need.value})",
                        "version": 1}, {})
                    return
            params = _parse_params(parsed.query)
            if method == "POST" and self.headers.get("Content-Length"):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                ctype = self.headers.get("Content-Type", "")
                if "application/x-www-form-urlencoded" in ctype:
                    params.update(_parse_params(body.decode()))
            task_id = self.headers.get(USER_TASK_HEADER)
            # Request id in/out: honor a caller-supplied X-Request-ID (so
            # operators can correlate across proxies), mint one otherwise;
            # the root span carries it into /trace.
            request_id = self.headers.get(REQUEST_ID_HEADER) or uuid.uuid4().hex[:16]
            # Bind it alongside the principal so user-task workers (copied
            # context) stamp executor batches with the originating request.
            _oplog.set_request_id(request_id)
            with _obsvc_tracer().span(f"http.{endpoint}", method=method,
                                      request_id=request_id):
                try:
                    status, payload, headers = app.handle(method, endpoint,
                                                          params, task_id)
                except OngoingExecutionError as e:
                    status, payload, headers = 409, {"error": str(e)}, {}
                except CruiseControlError as e:
                    status, payload, headers = 500, {
                        "error": type(e).__name__, "message": str(e)}, {}
                except Exception as e:   # noqa: BLE001 — never kill the server
                    LOG.exception("request failed")
                    status, payload, headers = 500, {
                        "error": type(e).__name__, "message": str(e)}, {}
            if isinstance(payload, dict):
                payload.setdefault("version", 1)
            headers = {**(headers or {}), REQUEST_ID_HEADER: request_id,
                       **self._mutual_auth_headers()}
            self._send(status, payload, headers)

        def _authenticate_or_401(self):
            """Shared auth gate for API and UI requests: returns the
            Principal, or sends the 401 challenge and returns None."""
            try:
                principal = app.security.authenticate(
                    dict(self.headers), self.client_address[0])
            except Exception:   # noqa: BLE001 — provider bug reads as 401
                LOG.exception("security provider failed")
                principal = None
            if principal is None:
                self._send(401, {"error": "authentication required",
                                 "version": 1},
                           app.security.challenge())
            return principal

        def _mutual_auth_headers(self) -> Dict[str, str]:
            """SPNEGO mutual auth: the provider may carry a GSS reply token
            for this thread's successful exchange (RFC 4559 §4.2); every
            authenticated response — API or UI asset — must return it."""
            mutual = getattr(app.security, "mutual_auth_header", None)
            return mutual() if mutual is not None else {}

        def _serve_ui(self, raw_path: str):
            import mimetypes
            import os
            # Everything filesystem-touching sits inside one guard: a
            # null-byte path (realpath raises ValueError), an unreadable
            # file, or a delete between the isfile check and open() must
            # surface as an HTTP 404, not a dropped connection.
            # Every response of an authenticated exchange carries the
            # mutual-auth reply token, 404s included (RFC 4559 §4.2).
            mutual = self._mutual_auth_headers()
            try:
                prefix = app.ui_urlprefix.rstrip("*").rstrip("/")  # "/*" → ""
                path = urllib.parse.unquote(raw_path)
                if prefix and not (path == prefix
                                   or path.startswith(prefix + "/")):
                    self._send(404, {"error": "not found"}, mutual)
                    return
                rel = path[len(prefix):].lstrip("/") or "index.html"
                root = os.path.realpath(app.ui_diskpath)
                full = os.path.realpath(os.path.join(root, rel))
                # realpath + prefix check: symlinks and ../ cannot escape
                # the configured frontend directory.
                inside = full == root or full.startswith(root + os.sep)
                if not inside or not os.path.isfile(full):
                    self._send(404, {"error": "not found"}, mutual)
                    return
                with open(full, "rb") as f:
                    body = f.read()
            except (OSError, ValueError):
                self._send(404, {"error": "not found"}, mutual)
                return
            ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in mutual.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send(self, status: int, payload: Dict,
                  headers: Optional[Dict[str, str]] = None):
            if isinstance(payload, str):      # text endpoints (/metrics)
                body = payload.encode()
                ctype = "text/plain; version=0.0.4"
            else:
                body = json.dumps(payload).encode()
                ctype = "application/json"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

    return Handler
