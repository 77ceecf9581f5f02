"""Compile telemetry: per-bucket compile/hit/miss sensors.

Instruments live in the process-wide ``common.metrics`` registry, so they
surface on ``/metrics`` (Prometheus + JSON) exactly like every other
component's sensors, plus the ``compile_cache`` admin view:

- ``CompileService.compile-count`` / ``.cache-hit-count`` /
  ``.cache-miss-count`` — totals across buckets;
- ``CompileService.<bucket>.{compile,cache-hit,cache-miss}-count`` — the
  per-bucket split (bucket labels come from ShapeBucketPolicy.bucket_label);
- ``CompileService.compile-timer`` — wall time of each detected compile
  (measured around the first run of a family at a new input shape, so it
  includes that run's execution).

The port compiles no XLA executable, so it keeps the JAX package's counts
over its own definition, set where the solver dispatches a goal
(``analyzer/solver.GoalSolver.dispatch``).  An *executable family* is keyed
as the JAX solver keys its ``_round_cache`` (goal, priors, candidate width
and the executable's kind); a *miss* is the first solve of a family, a
*hit* every later one, and a *compile* the first solve of a family at a new
input shape (the shapes of every tensor it is given), timed by that solve's
wall.  After the same solves both packages then hold the same bucket table,
and a warm solve adds no compile in either.  "Zero recompiles" in tests
means the compile counters did not move.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from cruise_control_tpu_torch.common.metrics import MetricRegistry, registry

_PREFIX = "CompileService"


class CompileTelemetry:
    """Thin facade over the metric registry plus a per-bucket tally the
    ``compile_cache`` admin view renders without scraping sensor names."""

    def __init__(self, metric_registry: Optional[MetricRegistry] = None):
        self._registry = metric_registry
        self._lock = threading.Lock()
        # bucket -> {"compiles": n, "hits": n, "misses": n}
        self._buckets: Dict[str, Dict[str, int]] = {}
        # Cumulative compile wall-clock: a goal span's compile share is the
        # delta of this across the solve (the compile-timer's reservoir
        # can't give a reliable delta).
        self._compile_seconds = 0.0

    @property
    def registry(self) -> MetricRegistry:
        return self._registry if self._registry is not None else registry()

    def _bump(self, bucket: str, kind: str) -> None:
        with self._lock:
            row = self._buckets.setdefault(
                bucket, {"compiles": 0, "hits": 0, "misses": 0})
            row[kind] += 1

    def record_hit(self, bucket: str) -> None:
        self.registry.counter(f"{_PREFIX}.cache-hit-count").inc()
        self.registry.counter(f"{_PREFIX}.{bucket}.cache-hit-count").inc()
        self._bump(bucket, "hits")

    def record_miss(self, bucket: str) -> None:
        self.registry.counter(f"{_PREFIX}.cache-miss-count").inc()
        self.registry.counter(f"{_PREFIX}.{bucket}.cache-miss-count").inc()
        self._bump(bucket, "misses")

    def record_compile(self, bucket: str, seconds: float) -> None:
        self.registry.counter(f"{_PREFIX}.compile-count").inc()
        self.registry.counter(f"{_PREFIX}.{bucket}.compile-count").inc()
        self.registry.timer(f"{_PREFIX}.compile-timer").update_ms(
            seconds * 1000.0)
        with self._lock:
            self._compile_seconds += seconds
        self._bump(bucket, "compiles")

    # ------------------------------------------------------------- reads

    def compile_count(self) -> int:
        return self.registry.counter(f"{_PREFIX}.compile-count").count

    def hit_count(self) -> int:
        return self.registry.counter(f"{_PREFIX}.cache-hit-count").count

    def miss_count(self) -> int:
        return self.registry.counter(f"{_PREFIX}.cache-miss-count").count

    def compile_seconds_total(self) -> float:
        with self._lock:
            return self._compile_seconds

    def bucket_table(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._buckets.items())}

    def snapshot(self) -> Dict:
        return {
            "compiles": self.compile_count(),
            "hits": self.hit_count(),
            "misses": self.miss_count(),
            "compile_timer": self.registry.timer(
                f"{_PREFIX}.compile-timer").stats(),
            "buckets": self.bucket_table(),
        }


_GLOBAL: Optional[CompileTelemetry] = None


def telemetry() -> CompileTelemetry:
    """Process-wide compile telemetry (sensors land in the global metric
    registry; solver instances pick this up by default)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = CompileTelemetry()
    return _GLOBAL
