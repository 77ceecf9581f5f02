"""Sensor history rings (obs.history.*).

Sensors were point-in-time snapshots: a scrape sees the current value and
nothing evaluates trends, so latency/solve-time regressions were only
visible by rerunning bench.  This module runs an interval sampler thread
that snapshots the :class:`~cruise_control_tpu_torch.common.metrics.MetricRegistry`
into bounded per-sensor time-series rings:

- one scalar per sensor per sample — counters record ``count``, timers
  record ``p99_ms`` and gauges their value — keeping a ring entry tiny;
- each timer additionally feeds ``<name>.p50_ms`` / ``<name>.max_ms``
  sibling rings (the bare name stays p99 — burn-rate windows and existing
  dashboards read it unchanged);
- rings are bounded (``obs.history.ring.size``), oldest samples evicted;
- the sampler's own liveness is observable: every snapshot bumps the
  ``Obs.history-samples`` counter.

Read via ``GET /metrics/history``; the SLO evaluator (obsvc/slo.py) runs
its burn-rate windows over these rings.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from cruise_control_tpu_torch.common.metrics import registry

SAMPLES_SENSOR = "Obs.history-samples"

# Extra per-timer quantile rings recorded under dotted sibling names —
# ring names, not registry sensors, so they stay invisible to the
# sensor-drift guard and to SLO patterns anchored on ``*-timer``.
TIMER_SIBLING_STATS = ("p50_ms", "max_ms")


def _scalar(record: Dict[str, Any]) -> Optional[float]:
    """The one number a history ring keeps per sensor per sample."""
    kind = record.get("type")
    if kind == "counter":
        return float(record.get("count", 0))
    if kind == "timer":
        return float(record.get("p99_ms", record.get("mean_ms", 0.0)))
    value = record.get("value")
    if isinstance(value, bool):
        return float(int(value))
    if isinstance(value, (int, float)):
        return float(value)
    return None     # errored gauge / non-numeric value: no sample


class HistoryRecorder:
    """Interval sampler thread snapshotting the registry into bounded
    per-sensor time-series rings."""

    def __init__(self, interval_s: float = 10.0, ring_size: int = 360,
                 clock=time.time):
        self.interval_s = interval_s
        self.ring_size = ring_size
        self._clock = clock
        self._series: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Materialized at construction so the sensor-drift guard sees the
        # self-sensor on a fresh boot, before the first interval elapses.
        self._samples_counter = registry().counter(SAMPLES_SENSOR)

    def configure(self, interval_s: float, ring_size: int) -> None:
        """Reconfigure in place (the singleton is referenced widely).  A
        shrunk ring size applies to existing rings on their next append."""
        with self._lock:
            self.interval_s = interval_s
            if ring_size != self.ring_size:
                self.ring_size = ring_size
                self._series = {name: deque(ring, maxlen=ring_size)
                                for name, ring in self._series.items()}

    # -- sampling ----------------------------------------------------------

    def sample_once(self) -> int:
        """Take one registry snapshot into the rings; returns sensors
        sampled.  Also the test seam — no thread required."""
        snap = registry().snapshot()
        ts_ms = round(self._clock() * 1000.0, 1)
        n = 0
        with self._lock:
            for name, record in snap.items():
                value = _scalar(record)
                if value is None:
                    continue
                self._append(name, ts_ms, value)
                n += 1
                if record.get("type") == "timer":
                    for stat in TIMER_SIBLING_STATS:
                        v = record.get(stat)
                        if isinstance(v, (int, float)):
                            self._append(f"{name}.{stat}", ts_ms, float(v))
        self._samples_counter.inc()
        return n

    def _append(self, name: str, ts_ms: float, value: float) -> None:
        """Caller holds ``self._lock``."""
        ring = self._series.get(name)
        if ring is None:
            ring = self._series[name] = deque(maxlen=self.ring_size)
        ring.append((ts_ms, value))

    def record_event(self, name: str, value: float,
                     ts_ms: Optional[float] = None) -> None:
        """Event-driven sample hook: push one point into ``name``'s ring
        outside the interval sampler, so transitions faster than the
        sampling interval (e.g. monitor window closes) still land in
        ``/metrics/history``.  Bounded by the ring's existing cap."""
        if ts_ms is None:
            ts_ms = round(self._clock() * 1000.0, 1)
        with self._lock:
            self._append(name, float(ts_ms), float(value))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:   # noqa: BLE001 — sampler must never die silently
                import logging
                logging.getLogger(__name__).exception("history sample failed")

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="sensor-history")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- read side ---------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def series(self, name: str) -> List[List[float]]:
        """[[ts_ms, value], ...] oldest first; empty for unknown sensors."""
        with self._lock:
            ring = self._series.get(name)
            return [list(p) for p in ring] if ring else []

    def history(self, pattern: Optional[str] = None,
                since_ms: Optional[float] = None) -> Dict[str, List]:
        """Rings matching an fnmatch ``pattern`` (all when None), optionally
        truncated to samples at/after ``since_ms``."""
        with self._lock:
            names = [n for n in self._series
                     if pattern is None or fnmatch.fnmatch(n, pattern)]
            out = {n: [list(p) for p in self._series[n]] for n in names}
        if since_ms is not None:
            out = {n: [p for p in pts if p[0] >= since_ms]
                   for n, pts in out.items()}
        return out

    # Bound on glob-query responses: a ``sensor=*`` against a service with
    # hundreds of rings must not serialize them all by default.
    DEFAULT_SERIES_LIMIT = 64
    MAX_SERIES_LIMIT = 1024

    def history_bounded(self, pattern: Optional[str] = None,
                        since_ms: Optional[float] = None,
                        limit: int = DEFAULT_SERIES_LIMIT):
        """:meth:`history` with a bounded series count: at most ``limit``
        rings (name-sorted, capped at ``MAX_SERIES_LIMIT``); the second
        return value flags whether matches were dropped."""
        limit = max(1, min(int(limit), self.MAX_SERIES_LIMIT))
        out = self.history(pattern=pattern, since_ms=since_ms)
        if len(out) <= limit:
            return out, False
        kept = sorted(out)[:limit]
        return {n: out[n] for n in kept}, True

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


_HISTORY = HistoryRecorder()


def history() -> HistoryRecorder:
    return _HISTORY
