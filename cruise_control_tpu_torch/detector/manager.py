"""Anomaly detector manager.

Reference: ``detector/AnomalyDetectorManager.java:50-572`` — owns the
detectors, a priority queue of anomalies, and a single handler task consuming
it; the notifier decides FIX / CHECK / IGNORE; FIX routes through the façade's
propose+execute path (anomaly.fix wired by the façade).  Detection runs on
per-type schedules; here a single scheduler thread ticks each detector at its
interval, and ``run_detection_once`` drives everything synchronously for
tests.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from cruise_control_tpu_torch.detector.anomalies import Anomaly, AnomalyType
from cruise_control_tpu_torch.detector.notifier import (
    AnomalyNotificationResult,
    NoopNotifier,
)
from cruise_control_tpu_torch.obsvc.audit import audit_log
from cruise_control_tpu_torch.obsvc.tracer import tracer as _obsvc_tracer

LOG = logging.getLogger(__name__)


@dataclass
class AnomalyState:
    """Recent-anomaly bookkeeping surfaced via GET /state."""

    recent: Dict[str, List[Dict]] = field(default_factory=dict)
    metrics: Dict[str, int] = field(default_factory=dict)
    ongoing_self_healing: Optional[str] = None

    def record(self, anomaly: Anomaly, status: str) -> None:
        lst = self.recent.setdefault(anomaly.anomaly_type.name, [])
        entry = anomaly.describe()
        entry["status"] = status
        lst.append(entry)
        del lst[:-10]
        self.metrics[status] = self.metrics.get(status, 0) + 1


class AnomalyDetectorManager:
    def __init__(
        self,
        detectors: Dict[AnomalyType, object],
        notifier=None,
        fixer: Optional[Callable[[Anomaly], bool]] = None,
        detection_interval_s: float = 300.0,
        clock=time.monotonic,
    ):
        self.detectors = dict(detectors)
        self.notifier = notifier or NoopNotifier()
        self._fixer = fixer
        self.interval_s = detection_interval_s
        self._clock = clock
        self._queue: List[Anomaly] = []
        self._qlock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.state = AnomalyState()
        self._check_later: List[tuple] = []   # (due_monotonic_s, anomaly)
        self._anomaly_detected_s: Dict[int, float] = {}
        self._register_sensors()

    def _register_sensors(self) -> None:
        """AnomalyDetector sensors (Sensors.md;
        AnomalyDetectorManager.java:173-192)."""
        from cruise_control_tpu_torch.common.metrics import registry
        reg = registry()
        self._rate_counters = {
            t: reg.counter(f"AnomalyDetector.{t.name.lower()}-rate")
            for t in self.detectors
        }
        self._self_healing_started = reg.counter(
            "AnomalyDetector.number-of-self-healing-started")
        self._fix_start_timer = reg.timer(
            "AnomalyDetector.mean-time-to-start-fix-ms")
        for t in self.detectors:
            reg.gauge(
                f"AnomalyDetector.{t.name.lower()}-self-healing-enabled",
                (lambda tt: lambda: int(bool(
                    self.notifier.self_healing_enabled().get(tt, False)
                    if hasattr(self.notifier, "self_healing_enabled") else False)))(t))
        reg.gauge("AnomalyDetector.has-ongoing-self-healing",
                  lambda: int(self.state.ongoing_self_healing is not None))
        reg.gauge("AnomalyDetector.anomaly-queue-size",
                  lambda: len(self._queue))

    # ------------------------------------------------------------ lifecycle

    def start_detection(self) -> None:
        """AnomalyDetectorManager.startDetection :215-226."""
        t = threading.Thread(target=self._detection_loop, daemon=True,
                             name="anomaly-detector")
        t.start()
        self._threads.append(t)
        h = threading.Thread(target=self._handler_loop, daemon=True,
                             name="anomaly-handler")
        h.start()
        self._threads.append(h)

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)

    # ------------------------------------------------------------ detection

    def _detection_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.run_detection_once(handle=False)

    def run_detection_once(self, handle: bool = True) -> int:
        """Run every detector; enqueue anomalies; optionally drain the queue
        synchronously (test mode)."""
        n = 0
        for anomaly_type, detector in self.detectors.items():
            try:
                found = detector.detect()
            except Exception:      # noqa: BLE001 — a broken detector must not stop others
                LOG.exception("detector %s failed", anomaly_type.name)
                continue
            for a in found:
                self._enqueue(a)
                n += 1
        if handle:
            self.handle_pending()
        return n

    def _enqueue(self, anomaly: Anomaly) -> None:
        with self._qlock:
            heapq.heappush(self._queue, anomaly)
        # Count only first-time detections: CHECK-delayed anomalies re-enter
        # through this path and must not inflate the detection-rate sensor.
        first_time = id(anomaly) not in self._anomaly_detected_s
        self._anomaly_detected_s.setdefault(id(anomaly), self._clock())
        if first_time:
            counter = self._rate_counters.get(anomaly.anomaly_type)
            if counter is not None:
                counter.inc()
        self.state.record(anomaly, "DETECTED")

    # ------------------------------------------------------------- handling

    def _handler_loop(self) -> None:
        while not self._stop.wait(0.2):
            self.handle_pending()

    def handle_pending(self) -> int:
        """AnomalyHandlerTask :326-440: pop by priority, consult notifier."""
        handled = 0
        now_s = self._clock()
        with self._qlock:
            due = [a for t, a in self._check_later if t <= now_s]
            self._check_later = [(t, a) for t, a in self._check_later if t > now_s]
        for a in due:
            self._enqueue(a)
        while True:
            with self._qlock:
                if not self._queue:
                    break
                anomaly = heapq.heappop(self._queue)
            self._handle(anomaly)
            handled += 1
        return handled

    def _handle(self, anomaly: Anomaly) -> None:
        type_name = anomaly.anomaly_type.name
        action = self.notifier.on_anomaly(anomaly)
        if action.result is AnomalyNotificationResult.IGNORE:
            # Drop the detection timestamp too: id() can be reused after GC
            # and a stale entry would poison mean-time-to-start-fix.
            self._anomaly_detected_s.pop(id(anomaly), None)
            self.state.record(anomaly, "IGNORED")
            audit_log().record(type_name, anomaly.describe(), "IGNORED")
            return
        if action.result is AnomalyNotificationResult.CHECK:
            with self._qlock:
                self._check_later.append(
                    (self._clock() + action.delay_ms / 1000.0, anomaly))
            self.state.record(anomaly, "CHECK_WITH_DELAY")
            audit_log().record(type_name, anomaly.describe(),
                               "CHECK_WITH_DELAY")
            return
        # FIX
        entry_id = audit_log().record(type_name, anomaly.describe(), "FIX")
        self.state.ongoing_self_healing = type_name
        self._self_healing_started.inc()
        detected = self._anomaly_detected_s.pop(id(anomaly), None)
        if detected is not None:
            self._fix_start_timer.update_ms((self._clock() - detected) * 1000.0)
        try:
            ok = False
            with _obsvc_tracer().span(f"selfheal.{type_name.lower()}"):
                if anomaly.fix is not None:
                    ok = bool(anomaly.fix())
                elif self._fixer is not None:
                    ok = bool(self._fixer(anomaly))
            outcome = "FIX_STARTED" if ok else "FIX_FAILED_TO_START"
            self.state.record(anomaly, outcome)
            audit_log().set_outcome(entry_id, outcome)
        except Exception:          # noqa: BLE001 — keep the handler alive
            LOG.exception("fix for %s failed", type_name)
            self.state.record(anomaly, "FIX_FAILED_TO_START")
            audit_log().set_outcome(entry_id, "FIX_FAILED_TO_START")
        finally:
            self.state.ongoing_self_healing = None

    # ---------------------------------------------------------------- state

    def state_summary(self) -> Dict:
        return {
            "selfHealingEnabled": {t.name: v for t, v in
                                   self.notifier.self_healing_enabled().items()},
            "recentAnomalies": self.state.recent,
            "metrics": self.state.metrics,
            "ongoingSelfHealing": self.state.ongoing_self_healing,
            "selfHealingAudit": audit_log().entries(),
        }
