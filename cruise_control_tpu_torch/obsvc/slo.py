"""SLO burn-rate evaluation over sensor history rings (slo.*).

The detector pipeline reacts to cluster anomalies (broker failure, goal
violation) but not to the service degrading itself — a solve suddenly taking
50 rounds, an endpoint's p99 creeping past its budget.  This module closes
that loop: per-endpoint latency and per-solve round/time objectives are
evaluated over the :mod:`~cruise_control_tpu_torch.obsvc.history` rings with
multi-window burn rates (Google SRE-workbook style):

- a window's *burn rate* is the fraction of its samples violating the
  threshold, divided by the error budget (``slo.error.budget``).  Burn 1.0
  means the budget is being consumed exactly as provisioned; >1.0 burns
  faster;
- an objective alerts only when BOTH the short window (fast signal) and the
  long window (sustained, de-flaps single spikes) are at or above
  ``slo.burn.rate.threshold``;
- an empty ring is no violation — absence of evidence is not burn;
- samples timestamped in the future (clock skew between the sampler and the
  evaluator) are clamped to "now" so they land in the short window instead
  of being silently dropped.

Violations surface as :class:`SloViolationAnomaly` through the existing
detector → notifier → self-healing-audit path (unfixable, so the notifier
IGNOREs them into the audit ring and alert log).
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from cruise_control_tpu_torch.detector.anomalies import SloViolationAnomaly
from cruise_control_tpu_torch.obsvc.history import HistoryRecorder, history


@dataclass(frozen=True)
class SloObjective:
    """One objective: sensors matching ``pattern`` must keep their history
    scalar at or under ``threshold`` (history stores timers as p99_ms)."""

    name: str
    pattern: str
    threshold: float

    def matches(self, sensor: str) -> bool:
        return fnmatch.fnmatch(sensor, self.pattern)


def objectives_from_config(config) -> List[SloObjective]:
    """The seven built-in objectives, thresholds from ``slo.*`` keys."""
    return [
        SloObjective(
            name="memory-headroom",
            pattern="Memory.device-utilization",
            threshold=float(config.get("slo.memory.utilization.max"))),
        SloObjective(
            name="endpoint-latency-p99",
            pattern="KafkaCruiseControlServlet.*-successful-request-execution-timer",
            threshold=float(config.get("slo.endpoint.latency.p99.ms"))),
        SloObjective(
            name="solve-time",
            pattern="GoalOptimizer.proposal-computation-timer",
            threshold=float(config.get("slo.solve.time.ms"))),
        SloObjective(
            name="solve-rounds",
            pattern="Solver.*.rounds",
            threshold=float(config.get("slo.solve.rounds.max"))),
        SloObjective(
            # Execution throughput, inverted so "bad" is ABOVE threshold:
            # the gauge is the flight recorder's EWMA seconds-per-move,
            # which reads 0.0 while no batch is live — idle never burns.
            name="execution-throughput",
            pattern="Executor.seconds-per-move",
            threshold=float(config.get("slo.execution.seconds.per.move.max"))),
        SloObjective(
            # Model freshness: age of the fidelity fingerprint's newest
            # valid window.  The gauge reads 0.0 before the first
            # fingerprint, so cold boot never burns.
            name="model-freshness",
            pattern="Monitor.fingerprint-age-ms",
            threshold=float(config.get("slo.model.age.max.ms"))),
        SloObjective(
            # Model validity, inverted so "bad" is ABOVE threshold: the
            # gauge is 1 - valid-partition-ratio (0.0 with no fingerprint).
            name="model-validity",
            pattern="Monitor.invalid-partition-ratio",
            threshold=1.0 - float(
                config.get("slo.model.valid.partition.ratio.min"))),
    ]


class SloEvaluator:
    """Evaluates objectives over the history rings with two burn windows."""

    def __init__(self, objectives: List[SloObjective],
                 error_budget: float = 0.1,
                 short_window_s: float = 300.0,
                 long_window_s: float = 3_600.0,
                 burn_threshold: float = 1.0,
                 recorder: Optional[HistoryRecorder] = None,
                 clock=time.time):
        self.objectives = list(objectives)
        self.error_budget = max(float(error_budget), 1e-9)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.burn_threshold = float(burn_threshold)
        self._recorder = recorder
        self._clock = clock

    def _history(self) -> HistoryRecorder:
        return self._recorder if self._recorder is not None else history()

    def _burn(self, points: List[List[float]], threshold: float,
              window_s: float, now_ms: float) -> Optional[float]:
        """Burn rate over one window, or None when the window holds no
        samples (no evidence → no verdict)."""
        cutoff = now_ms - window_s * 1000.0
        # Clock skew: future-stamped samples count as "now", not never.
        windowed = [min(ts, now_ms) for ts, _ in points]
        in_window = [v for (ts, v), wts in zip(points, windowed)
                     if wts >= cutoff]
        if not in_window:
            return None
        bad = sum(1 for v in in_window if v > threshold)
        return (bad / len(in_window)) / self.error_budget

    def evaluate(self) -> List[Dict[str, Any]]:
        """All (objective, sensor) burn verdicts; ``violating`` only when
        both windows meet the burn threshold."""
        now_ms = self._clock() * 1000.0
        hist = self._history()
        out: List[Dict[str, Any]] = []
        for obj in self.objectives:
            for sensor, points in hist.history(pattern=obj.pattern).items():
                if not points:
                    continue
                short = self._burn(points, obj.threshold,
                                   self.short_window_s, now_ms)
                long_ = self._burn(points, obj.threshold,
                                   self.long_window_s, now_ms)
                violating = (short is not None and long_ is not None
                             and short >= self.burn_threshold
                             and long_ >= self.burn_threshold)
                out.append({
                    "objective": obj.name,
                    "sensor": sensor,
                    "threshold": obj.threshold,
                    "worstValue": max(v for _, v in points),
                    "burnShort": round(short, 4) if short is not None else None,
                    "burnLong": round(long_, 4) if long_ is not None else None,
                    "violating": violating,
                })
        return out

    def violations(self) -> List[Dict[str, Any]]:
        return [v for v in self.evaluate() if v["violating"]]


class SloViolationDetector:
    """Detector-manager plugin: maps burn verdicts to anomalies."""

    def __init__(self, evaluator: SloEvaluator):
        self.evaluator = evaluator

    def detect(self) -> List[SloViolationAnomaly]:
        return [
            SloViolationAnomaly(
                objective=v["objective"],
                sensor=v["sensor"],
                threshold=v["threshold"],
                worst_value=v["worstValue"],
                burn_rate_short=v["burnShort"],
                burn_rate_long=v["burnLong"],
            )
            for v in self.evaluator.violations()
        ]


def evaluator_from_config(config, recorder: Optional[HistoryRecorder] = None,
                          clock=time.time) -> SloEvaluator:
    return SloEvaluator(
        objectives_from_config(config),
        error_budget=float(config.get("slo.error.budget")),
        short_window_s=float(config.get("slo.burn.window.short.s")),
        long_window_s=float(config.get("slo.burn.window.long.s")),
        burn_threshold=float(config.get("slo.burn.rate.threshold")),
        recorder=recorder,
        clock=clock,
    )
