"""Self-observability sensor registry.

Reference: the Dropwizard ``MetricRegistry`` wired through every component
(``docs/wiki/User Guide/Sensors.md`` lists ~40 sensors across Executor,
LoadMonitor, UserTaskManager, AnomalyDetector, GoalOptimizer,
MetricFetcherManager and the servlet;
``detector/AnomalyDetectorManager.java:173-192`` registers the
balancedness/provision gauges, ``executor/Executor.java:259-275`` the caps).

One process-wide registry with four instrument kinds:
- Counter   — monotone count (+ rate over a sliding window, the reference's
  Meter one-minute-rate analog);
- Gauge     — callback sampled at read time;
- Timer     — count / mean / max / p50 / p999 over a bounded reservoir;
- SettableGauge — last-written value (for components without a callback).

``snapshot()`` feeds the ``/state`` JSON; ``prometheus_text()`` renders the
``/metrics`` exposition format.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

_RATE_WINDOW_S = 60.0

SCRAPE_ERRORS_SENSOR = "MetricRegistry.sensor-scrape-errors"


def _sanitize(name: str) -> str:
    """The Prometheus-name mapping used by ``prometheus_text``'s clean()."""
    return "".join(ch if ch.isalnum() else "_" for ch in name)


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._events: deque = deque()
        self._first_ts: Optional[float] = None

    def inc(self, n: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            if self._first_ts is None:
                self._first_ts = now
            self._count += n
            self._events.append((now, n))
            self._trim(now)

    def _trim(self, now: float) -> None:
        while self._events and self._events[0][0] < now - _RATE_WINDOW_S:
            self._events.popleft()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def rate(self) -> float:
        """Events per second over the trailing minute.

        Young counters divide by the observed lifetime (floored at 1 s so
        a same-millisecond burst doesn't explode), not the full window —
        dividing N first-second events by 60 under-reported early rates
        60x and made fresh-boot scrapes look idle.
        """
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            if self._first_ts is None:
                return 0.0
            window = min(_RATE_WINDOW_S, max(now - self._first_ts, 1.0))
            return sum(n for _, n in self._events) / window


class SettableGauge:
    def __init__(self, initial: float = 0.0):
        self.value = initial

    def set(self, value: float) -> None:
        self.value = value


class Timer:
    def __init__(self, reservoir: int = 1024):
        self._lock = threading.Lock()
        self._values: deque = deque(maxlen=reservoir)
        self._count = 0

    def update_ms(self, elapsed_ms: float) -> None:
        with self._lock:
            self._values.append(elapsed_ms)
            self._count += 1

    def time(self):
        timer = self

        class _Ctx:
            def __enter__(self):
                self._t0 = time.monotonic()
                return self

            def __exit__(self, *exc):
                timer.update_ms((time.monotonic() - self._t0) * 1000.0)
                return False

        return _Ctx()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._values)
            n = self._count
        if not vals:
            return {"count": n, "mean_ms": 0.0, "max_ms": 0.0,
                    "p50_ms": 0.0, "p99_ms": 0.0, "p999_ms": 0.0}
        def pct(q):
            return vals[min(int(q * (len(vals) - 1)), len(vals) - 1)]
        return {"count": n, "mean_ms": sum(vals) / len(vals),
                "max_ms": vals[-1], "p50_ms": pct(0.5), "p99_ms": pct(0.99),
                "p999_ms": pct(0.999)}


class MetricRegistry:
    """Thread-safe named-instrument registry (get-or-create semantics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._timers: Dict[str, Timer] = {}
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._settable: Dict[str, SettableGauge] = {}
        # sanitized prometheus name → (sensor name, kind): two sensors that
        # collapse to one series after clean() would silently shadow each
        # other in /metrics, so collisions fail loudly at registration.
        self._prom_names: Dict[str, tuple] = {}

    def _register_guard(self, name: str, kind: str) -> None:
        # Caller holds self._lock.
        key = _sanitize(name)
        prior = self._prom_names.get(key)
        if prior is None:
            self._prom_names[key] = (name, kind)
            return
        prior_name, prior_kind = prior
        if prior_name != name:
            raise ValueError(
                f"sensor name {name!r} collides with {prior_name!r}: both "
                f"sanitize to Prometheus series {key!r}")
        if prior_kind != kind:
            raise ValueError(
                f"sensor {name!r} already registered as a {prior_kind}, "
                f"cannot re-register as a {kind}")

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                self._register_guard(name, "counter")
                c = self._counters[name] = Counter()
            return c

    def timer(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                self._register_guard(name, "timer")
                t = self._timers[name] = Timer()
            return t

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            if name not in self._gauges:
                self._register_guard(name, "gauge")
            self._gauges[name] = fn

    def settable_gauge(self, name: str, initial: float = 0.0) -> SettableGauge:
        with self._lock:
            g = self._settable.get(name)
            if g is None:
                self._register_guard(name, "settable_gauge")
                g = self._settable[name] = SettableGauge(initial)
            return g

    def names(self) -> List[str]:
        with self._lock:
            return sorted({*self._counters, *self._timers, *self._gauges,
                           *self._settable})

    # ------------------------------------------------------------- exports

    def snapshot(self) -> Dict[str, Dict]:
        """name → {type, ...values}; gauge callbacks are sampled now."""
        out: Dict[str, Dict] = {}
        # Gauges sample first: a raising callback bumps the scrape-errors
        # counter, and copying counters afterwards means the bump is
        # visible in this same snapshot rather than the next one.
        with self._lock:
            gauges = dict(self._gauges)
        gauge_records: Dict[str, Dict] = {}
        scrape_errors = 0
        for name, fn in gauges.items():
            try:
                gauge_records[name] = {"type": "gauge", "value": fn()}
            except Exception as e:   # noqa: BLE001 — one bad gauge ≠ no metrics
                gauge_records[name] = {"type": "gauge", "error": str(e)}
                scrape_errors += 1
        err_counter = self.counter(SCRAPE_ERRORS_SENSOR)
        if scrape_errors:
            err_counter.inc(scrape_errors)
        with self._lock:
            counters = dict(self._counters)
            timers = dict(self._timers)
            settable = dict(self._settable)
        for name, c in counters.items():
            out[name] = {"type": "counter", "count": c.count,
                         "one_min_rate": round(c.rate(), 6)}
        for name, t in timers.items():
            out[name] = {"type": "timer", **{k: round(v, 4)
                                             for k, v in t.stats().items()}}
        out.update(gauge_records)
        for name, g in settable.items():
            out[name] = {"type": "gauge", "value": g.value}
        return out

    def prometheus_text(self, prefix: str = "kafka_cruisecontrol") -> str:
        """Prometheus exposition format for the /metrics endpoint."""
        lines: List[str] = []

        def clean(name: str) -> str:
            return f"{prefix}_{_sanitize(name)}"

        for name, record in sorted(self.snapshot().items()):
            base = clean(name)
            if record["type"] == "counter":
                lines.append(f"# TYPE {base} counter")
                lines.append(f"{base} {record['count']}")
                lines.append(f"{base}_one_min_rate {record['one_min_rate']}")
            elif record["type"] == "timer":
                lines.append(f"# TYPE {base} summary")
                lines.append(f"{base}_count {record['count']}")
                for k in ("mean_ms", "max_ms", "p50_ms", "p99_ms",
                          "p999_ms"):
                    lines.append(f"{base}_{k} {record[k]}")
            else:
                value = record.get("value")
                if value is None:
                    continue
                lines.append(f"# TYPE {base} gauge")
                if isinstance(value, bool):
                    value = int(value)
                lines.append(f"{base} {value}")
        return "\n".join(lines) + "\n"


_GLOBAL: Optional[MetricRegistry] = None


def registry() -> MetricRegistry:
    """Process-wide registry (components grab their sensors from here)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MetricRegistry()
    return _GLOBAL
