"""Three-state circuit breaker (closed → open → half-open → closed).

Counts consecutive failures; at ``failure_threshold`` the circuit opens and
``allow()`` refuses calls until ``reset_timeout_s`` has elapsed, after which
a bounded number of half-open probes may pass.  One probe success re-closes
the circuit; one probe failure re-opens it and restarts the timeout.

The breaker is pure mechanism — it does not raise.  Callers (the
reconnecting backend) gate on ``allow()`` and translate a refused call into
their own error type so the executor can distinguish "backend is down,
pause" from "this one call failed, mark dead".
"""

from __future__ import annotations

import threading
import time
from enum import Enum
from typing import Callable, Dict, Optional


class CircuitState(Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


#: Gauge encoding for /metrics: higher is worse.
STATE_VALUE = {CircuitState.CLOSED: 0,
               CircuitState.HALF_OPEN: 1,
               CircuitState.OPEN: 2}


class CircuitBreaker:
    def __init__(self, name: str = "circuit", *,
                 failure_threshold: int = 5,
                 reset_timeout_s: float = 10.0,
                 half_open_max_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_max_probes = max(1, int(half_open_max_probes))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CircuitState.CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probes_granted = 0
        self.open_count = 0          # times the circuit tripped open
        self.reclose_count = 0       # times a half-open probe healed it

    # -- state ------------------------------------------------------------

    @property
    def state(self) -> CircuitState:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def state_value(self) -> int:
        return STATE_VALUE[self.state]

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            self._maybe_half_open_locked()
            return {"state": self._state.value,
                    "consecutiveFailures": self._consecutive_failures,
                    "failureThreshold": self.failure_threshold,
                    "openCount": self.open_count,
                    "recloseCount": self.reclose_count}

    def _maybe_half_open_locked(self) -> None:
        if (self._state is CircuitState.OPEN
                and self._opened_at is not None
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._state = CircuitState.HALF_OPEN
            self._probes_granted = 0

    # -- gate + outcome reporting -----------------------------------------

    def allow(self) -> bool:
        """May a call proceed right now?  In half-open state, grants at most
        ``half_open_max_probes`` in-flight probes until an outcome lands."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state is CircuitState.CLOSED:
                return True
            if self._state is CircuitState.HALF_OPEN:
                if self._probes_granted < self.half_open_max_probes:
                    self._probes_granted += 1
                    return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state is not CircuitState.CLOSED:
                self.reclose_count += 1
            self._state = CircuitState.CLOSED
            self._consecutive_failures = 0
            self._opened_at = None
            self._probes_granted = 0

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            trip = (self._state is CircuitState.HALF_OPEN
                    or self._consecutive_failures >= self.failure_threshold)
            if trip:
                if self._state is not CircuitState.OPEN:
                    self.open_count += 1
                self._state = CircuitState.OPEN
                self._opened_at = self._clock()
                self._probes_granted = 0
