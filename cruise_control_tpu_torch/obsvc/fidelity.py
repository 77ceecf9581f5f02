"""Model-fidelity observatory: ingest telemetry + fingerprint flight recorder.

The solver/executor side is deeply instrumented (convergence recorder,
memory ledger, execution observatory) but the load monitor that *feeds*
them was a black box: completeness existed as point-in-time gauges with no
history and no lineage from a proposal back to the data quality it was
decided on.  This module closes the loop from the ingest side:

- **Fingerprint** — :meth:`ModelFidelityRecorder.record_fingerprint` runs
  at every model freeze / resident delta-apply and condenses the
  aggregator's completeness output into a ``ModelFingerprint`` dict:
  ``{generation, windowEndMs, ageMs, validWindows, validPartitionRatio,
  extrapolatedFraction (by kind), deadBrokers, capacitySource, kind}``.
  The optimizer stamps it onto every ``OptimizerResult`` / proposal, the
  executor journal and oplog carry its generation, and
  ``GET /execution_progress`` joins it into the live batch — so any
  executed move traces back to the model quality it was solved from.

- **Ingest telemetry** — the fetch/sample/aggregate pipeline reports
  per-fetch sample counts, dropped samples by cause (undecodable /
  inconsistent / out-of-order), window-close events with ingest→commit
  latency, and broker-liveness flaps.  Surfaced as ``Monitor.*`` sensors
  on ``/metrics`` (and thus the history rings), a bounded per-window
  quality ring on ``GET /model_quality``, and ``modelQualityState`` in
  ``GET /state``.

- **Staleness verdict** — :meth:`staleness_reason` checks the current
  fingerprint against ``anomaly.model.min.valid.partition.ratio`` /
  ``anomaly.model.max.age.ms``; the anomaly-fix dispatch IGNOREs fixes
  (audit reason ``stale_model``) and proposal responses carry an advisory
  ``modelStale`` flag when the verdict is non-None.

Everything is host-side bookkeeping over already-materialized numpy
completeness output: the solve and the proposal cache keys are the same with
the recorder on or off.  The port's copy of the JAX package's module (standard
library only); the fetcher's undecodable-sample call waits for the port's
``monitor/fetcher.py``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Sequence

from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.obsvc.history import history

LOG = logging.getLogger(__name__)

# Extrapolation kinds a fingerprint breaks its fraction down by (matches
# monitor.aggregator.Extrapolation members that fill values).
EXTRAPOLATION_KINDS = ("AVG_AVAILABLE", "AVG_ADJACENT", "FORECAST")

# Dropped-sample causes with a dedicated counter (Monitor.dropped-samples-*
# plus Monitor.out-of-order-samples).
DROP_CAUSES = ("undecodable", "inconsistent", "out_of_order")

_DROP_SENSOR = {
    "undecodable": "Monitor.dropped-samples-undecodable",
    "inconsistent": "Monitor.dropped-samples-inconsistent",
    "out_of_order": "Monitor.out-of-order-samples",
}


class ModelFidelityRecorder:
    """Bounded flight recorder of model fidelity: the per-window quality
    ring, the current/recent fingerprints, and the staleness verdict.

    Thresholds default to "gate disabled" (ratio 0.0, max age 0) so the
    recorder never vetoes self-healing unless ``anomaly.model.*`` keys are
    configured; the advisory ``modelStale`` flag follows the same verdict.
    """

    def __init__(self, enabled: bool = True, ring_size: int = 64,
                 min_valid_partition_ratio: float = 0.0,
                 max_age_ms: int = 0, clock=time.time):
        self.enabled = enabled
        self.min_valid_partition_ratio = float(min_valid_partition_ratio)
        self.max_age_ms = int(max_age_ms)
        self._clock = clock
        self._lock = threading.Lock()
        self._fingerprint: Optional[Dict[str, Any]] = None
        self._fingerprints: deque = deque(maxlen=ring_size)  # freeze history
        self._windows: deque = deque(maxlen=ring_size)       # window closes
        self._flaps: deque = deque(maxlen=ring_size)         # liveness flips
        self._alive: Dict[int, bool] = {}
        self._freezes = 0
        self._delta_applies = 0
        self._last_fetch = {"partitionSamples": 0, "brokerSamples": 0,
                            "atMs": None}

    def configure(self, enabled: bool, ring_size: Optional[int] = None,
                  min_valid_partition_ratio: Optional[float] = None,
                  max_age_ms: Optional[int] = None) -> None:
        """Reconfigure in place (the singleton is referenced widely)."""
        with self._lock:
            self.enabled = enabled
            if ring_size is not None and ring_size != self._fingerprints.maxlen:
                self._fingerprints = deque(self._fingerprints,
                                           maxlen=ring_size)
                self._windows = deque(self._windows, maxlen=ring_size)
                self._flaps = deque(self._flaps, maxlen=ring_size)
            if min_valid_partition_ratio is not None:
                self.min_valid_partition_ratio = float(
                    min_valid_partition_ratio)
            if max_age_ms is not None:
                self.max_age_ms = int(max_age_ms)

    # -- ingest side -------------------------------------------------------

    def on_fetch(self, n_partition: int, n_broker: int) -> None:
        """One sampler fetch round's accepted sample counts."""
        registry().counter("Monitor.fetched-samples").inc(
            int(n_partition) + int(n_broker))
        if not self.enabled:
            return
        with self._lock:
            self._last_fetch = {"partitionSamples": int(n_partition),
                                "brokerSamples": int(n_broker),
                                "atMs": round(self._clock() * 1000.0, 1)}

    def on_dropped(self, cause: str, count: int = 1) -> None:
        """A sample dropped before aggregation, by cause (always counted —
        the drop is pipeline behavior, not observatory bookkeeping)."""
        sensor = _DROP_SENSOR.get(cause)
        if sensor is None:
            raise ValueError(f"unknown drop cause {cause!r}")
        registry().counter(sensor).inc(int(count))

    def on_window_close(self, window: int, window_ms: int,
                        now_ms: Optional[float] = None) -> None:
        """A completed window rolled out of "active": bump the close
        counter, record ingest→commit latency (wall time from the window's
        end to the roll that committed it), ring the event, and push an
        event-driven history sample so ``/metrics/history`` captures every
        transition even when windows close faster than the sampler
        interval (bounded by the history ring's own cap)."""
        reg = registry()
        now_ms = self._clock() * 1000.0 if now_ms is None else float(now_ms)
        window_end_ms = (int(window) + 1) * int(window_ms)
        latency_ms = max(now_ms - window_end_ms, 0.0)
        reg.counter("Monitor.window-closes").inc()
        reg.timer("Monitor.ingest-commit-latency-ms").update_ms(latency_ms)
        history().record_event("Monitor.window-closes",
                               float(reg.counter("Monitor.window-closes").count),
                               ts_ms=now_ms)
        if not self.enabled:
            return
        with self._lock:
            self._windows.append({
                "window": int(window),
                "windowEndMs": window_end_ms,
                "closedAtMs": round(now_ms, 1),
                "ingestCommitMs": round(latency_ms, 1),
            })

    def record_liveness(self, alive: Dict[int, bool],
                        now_ms: Optional[float] = None) -> None:
        """Broker-liveness flap detector: every alive-bit flip against the
        last observed state counts as one flap."""
        now_ms = self._clock() * 1000.0 if now_ms is None else float(now_ms)
        with self._lock:
            flips = [(b, a) for b, a in alive.items()
                     if b in self._alive and self._alive[b] != bool(a)]
            self._alive = {b: bool(a) for b, a in alive.items()}
            if self.enabled:
                for broker, now_alive in flips:
                    self._flaps.append({"broker": int(broker),
                                        "alive": bool(now_alive),
                                        "atMs": round(now_ms, 1)})
        if flips:
            registry().counter("Monitor.broker-liveness-flaps").inc(len(flips))

    # -- fingerprint side --------------------------------------------------

    def record_fingerprint(self, completeness, window_ms: int,
                           dead_brokers: Sequence[int] = (),
                           capacity_source: str = "",
                           kind: str = "freeze",
                           now_ms: Optional[float] = None
                           ) -> Optional[Dict[str, Any]]:
        """Condense one aggregation's completeness into a fingerprint and
        make it current.  ``kind`` is ``freeze`` (full model build) or
        ``delta`` (resident builder delta-apply).  Returns the fingerprint
        (a plain dict — safe to stamp onto results), or None when off."""
        if not self.enabled:
            return None
        now_ms = self._clock() * 1000.0 if now_ms is None else float(now_ms)
        valid_windows = list(getattr(completeness, "valid_windows", []) or [])
        window_end_ms = ((max(valid_windows) + 1) * int(window_ms)
                         if valid_windows else None)
        denom = max(int(getattr(completeness, "num_entity_windows", 0)), 1)
        by_kind = {
            "AVG_AVAILABLE": getattr(completeness,
                                     "num_windows_avg_available", 0) / denom,
            "AVG_ADJACENT": getattr(completeness,
                                    "num_windows_avg_adjacent", 0) / denom,
            "FORECAST": getattr(completeness,
                                "num_windows_forecast", 0) / denom,
        }
        fp = {
            "generation": int(getattr(completeness, "generation", 0)),
            "windowEndMs": window_end_ms,
            "ageMs": (round(max(now_ms - window_end_ms, 0.0), 1)
                      if window_end_ms is not None else None),
            "validWindows": len(valid_windows),
            "validPartitionRatio": round(
                float(getattr(completeness, "valid_entity_ratio", 0.0)), 6),
            "extrapolatedFraction": {k: round(v, 6)
                                     for k, v in by_kind.items()},
            "deadBrokers": sorted(int(b) for b in dead_brokers),
            "capacitySource": capacity_source,
            "kind": kind,
            "frozenAtMs": round(now_ms, 1),
        }
        with self._lock:
            self._fingerprint = fp
            self._fingerprints.append(fp)
            if kind == "delta":
                self._delta_applies += 1
            else:
                self._freezes += 1
        registry().counter("Monitor.model-delta-applies" if kind == "delta"
                           else "Monitor.model-freezes").inc()
        return fp

    def current_fingerprint(self, now_ms: Optional[float] = None
                            ) -> Optional[Dict[str, Any]]:
        """The latest fingerprint with ``ageMs`` recomputed at read time."""
        with self._lock:
            fp = self._fingerprint
        if fp is None:
            return None
        now_ms = self._clock() * 1000.0 if now_ms is None else float(now_ms)
        out = dict(fp)
        if out.get("windowEndMs") is not None:
            out["ageMs"] = round(max(now_ms - out["windowEndMs"], 0.0), 1)
        return out

    def fingerprint_age_ms(self) -> float:
        """Gauge read: age of the current fingerprint's newest window; 0.0
        before the first fingerprint (no evidence is not staleness)."""
        fp = self.current_fingerprint()
        if fp is None or fp.get("ageMs") is None:
            return 0.0
        return float(fp["ageMs"])

    def valid_partition_ratio(self) -> float:
        fp = self.current_fingerprint()
        return float(fp["validPartitionRatio"]) if fp else 0.0

    def invalid_partition_ratio(self) -> float:
        """Inverted validity for the model-validity SLO objective ("bad" is
        ABOVE threshold); 0.0 before the first fingerprint, so cold boot
        and fidelity-off runs never burn."""
        fp = self.current_fingerprint()
        if fp is None:
            return 0.0
        return max(1.0 - float(fp["validPartitionRatio"]), 0.0)

    def extrapolated_fraction(self) -> float:
        fp = self.current_fingerprint()
        if fp is None:
            return 0.0
        return float(sum(fp["extrapolatedFraction"].values()))

    def staleness_reason(self, now_ms: Optional[float] = None
                         ) -> Optional[str]:
        """Non-None when the current fingerprint violates a configured
        ``anomaly.model.*`` threshold.  Returns a short reason string for
        audit entries; None when fresh, when thresholds are unset (their
        defaults), or when no fingerprint exists yet (the completeness
        gate upstream already covers the cold-start case)."""
        fp = self.current_fingerprint(now_ms)
        if fp is None:
            return None
        if (self.min_valid_partition_ratio > 0.0
                and fp["validPartitionRatio"] < self.min_valid_partition_ratio):
            return (f"valid-partition-ratio {fp['validPartitionRatio']:.3f} "
                    f"< {self.min_valid_partition_ratio}")
        if (self.max_age_ms > 0 and fp.get("ageMs") is not None
                and fp["ageMs"] > self.max_age_ms):
            return f"fingerprint-age {fp['ageMs']:.0f}ms > {self.max_age_ms}ms"
        return None

    def record_stale_gate(self) -> None:
        """One self-healing fix vetoed on a stale model."""
        registry().counter("Monitor.stale-model-gates").inc()

    # -- read side ---------------------------------------------------------

    def quality(self) -> Dict[str, Any]:
        """The ``GET /model_quality`` payload."""
        with self._lock:
            windows = list(self._windows)
            fps = list(self._fingerprints)
            flaps = list(self._flaps)
            last_fetch = dict(self._last_fetch)
        return {
            "enabled": self.enabled,
            "fingerprint": self.current_fingerprint(),
            "stale": self.staleness_reason(),
            "thresholds": {
                "minValidPartitionRatio": self.min_valid_partition_ratio,
                "maxAgeMs": self.max_age_ms,
            },
            "windowQuality": windows,
            "recentFingerprints": fps,
            "livenessFlaps": flaps,
            "lastFetch": last_fetch,
        }

    def state_summary(self) -> Dict[str, Any]:
        """The ``modelQualityState`` section of GET /state."""
        with self._lock:
            freezes = self._freezes
            deltas = self._delta_applies
            retained = len(self._windows)
            maxlen = self._windows.maxlen
        fp = self.current_fingerprint()
        return {
            "enabled": self.enabled,
            "fingerprint": fp,
            "stale": self.staleness_reason(),
            "modelFreezes": freezes,
            "modelDeltaApplies": deltas,
            "windowsRetained": retained,
            "ringSize": maxlen,
        }

    def reset(self) -> None:
        with self._lock:
            self._fingerprint = None
            self._fingerprints.clear()
            self._windows.clear()
            self._flaps.clear()
            self._alive = {}
            self._freezes = 0
            self._delta_applies = 0
            self._last_fetch = {"partitionSamples": 0, "brokerSamples": 0,
                                "atMs": None}


_RECORDER = ModelFidelityRecorder()


def fidelity() -> ModelFidelityRecorder:
    return _RECORDER


def register_sensors() -> None:
    """Idempotently (re-)register the Monitor.* fidelity family on the
    process registry.  Gauges exist recorder-on or -off (they read 0.0
    before the first fingerprint), and the counters are materialized
    eagerly so the sensor-drift guard sees them on a fresh boot."""
    reg = registry()
    reg.gauge("Monitor.fingerprint-age-ms",
              lambda: fidelity().fingerprint_age_ms())
    reg.gauge("Monitor.valid-partition-ratio",
              lambda: fidelity().valid_partition_ratio())
    reg.gauge("Monitor.invalid-partition-ratio",
              lambda: fidelity().invalid_partition_ratio())
    reg.gauge("Monitor.extrapolated-fraction",
              lambda: fidelity().extrapolated_fraction())
    reg.counter("Monitor.fetched-samples")
    reg.counter("Monitor.stored-samples")
    for sensor in _DROP_SENSOR.values():
        reg.counter(sensor)
    reg.counter("Monitor.window-closes")
    reg.timer("Monitor.ingest-commit-latency-ms")
    reg.counter("Monitor.broker-liveness-flaps")
    reg.counter("Monitor.model-freezes")
    reg.counter("Monitor.model-delta-applies")
    reg.counter("Monitor.stale-model-gates")


register_sensors()
