"""Observability service: span tracing, the self-healing audit log, the
operation log, solver convergence recording, the execution flight recorder,
model-fidelity recording and sensor history rings.

Public surface (the JAX package's ``obsvc``, for the parts the port has):

* :func:`tracer` — the process :class:`~cruise_control_tpu_torch.obsvc.tracer.Tracer`
  singleton (disabled by default; ``span()`` is a shared no-op until
  ``trace.enabled=true``).
* :func:`audit_log` — the bounded self-healing audit log.
* :func:`convergence` — the solver convergence flight recorder (per-round
  curves; disabled until ``trace.solver.rounds=true``).
* :func:`execution` — the execution flight recorder
  (``execution.observatory.enabled``).
* :func:`fidelity` — the model-fidelity recorder (``monitor.fidelity.enabled``).
* :func:`history` — the sensor history sampler (``obs.history.enabled``).
* :mod:`~cruise_control_tpu_torch.obsvc.slo` — burn-rate SLO evaluation over
  the history rings (``slo.*``, read by ``main.build_app``).
* :mod:`~cruise_control_tpu_torch.obsvc.profiler` — ``POST /profile``
  captures on ``torch.profiler``.
* :func:`configure` — apply ``trace.*`` / ``obs.*`` / ``execution.*`` /
  ``monitor.fidelity.*`` config keys at service build time.

The JAX package's device-memory ledger waits for the port's platform layers
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from cruise_control_tpu_torch.obsvc.audit import AuditLog, audit_log
from cruise_control_tpu_torch.obsvc.convergence import ConvergenceRecorder, convergence
from cruise_control_tpu_torch.obsvc.execution import ExecutionFlightRecorder, execution
from cruise_control_tpu_torch.obsvc.fidelity import ModelFidelityRecorder, fidelity
from cruise_control_tpu_torch.obsvc.history import HistoryRecorder, history
from cruise_control_tpu_torch.obsvc.tracer import Span, Tracer, tracer

__all__ = ["AuditLog", "ConvergenceRecorder", "ExecutionFlightRecorder",
           "HistoryRecorder", "ModelFidelityRecorder", "Span", "Tracer",
           "audit_log", "configure", "convergence", "execution", "fidelity",
           "history", "tracer"]


def configure(config) -> Tracer:
    """Wire ``trace.*`` / ``obs.*`` keys into the obsvc singletons.

    Safe to call repeatedly (tests rebuild services in-process)."""
    # Lazy: the solver imports obsvc.convergence, so obsvc cannot import the
    # solver at module level without closing the cycle.
    from cruise_control_tpu_torch.analyzer import solver as _solver
    from cruise_control_tpu_torch.obsvc import profiler

    tr = tracer()
    tr.configure(enabled=bool(config.get("trace.enabled")),
                 ring_size=int(config.get("trace.ring.size")))
    audit_log().configure(maxlen=int(config.get("trace.audit.log.size")))
    profiler.configure(str(config.get("trace.profile.dir") or ""))

    record_rounds = bool(config.get("trace.solver.rounds"))
    _solver.set_round_recording(record_rounds)
    convergence().configure(enabled=record_rounds,
                            ring_size=int(config.get("trace.solver.ring.size")))

    execution().configure(
        enabled=bool(config.get("execution.observatory.enabled")),
        ring_size=int(config.get("execution.history.ring.size")),
        alpha=float(config.get("execution.throughput.ewma.alpha")))

    fidelity().configure(
        enabled=bool(config.get("monitor.fidelity.enabled")),
        ring_size=int(config.get("monitor.fidelity.ring.size")),
        min_valid_partition_ratio=float(
            config.get("anomaly.model.min.valid.partition.ratio")),
        max_age_ms=int(config.get("anomaly.model.max.age.ms")))

    hist = history()
    hist.configure(
        interval_s=float(config.get("obs.history.interval.ms")) / 1000.0,
        ring_size=int(config.get("obs.history.ring.size")))
    if bool(config.get("obs.history.enabled")):
        hist.start()
    else:
        hist.stop()
    return tr
