"""Solve budgets: deadlines + cancellation tokens for anytime solves.

A :class:`SolveBudget` rides a request into the optimizer and solver (in the
JAX package from the servlet through the facade).  It carries two
independent stop signals:

- an optional wall-clock **deadline** (monotonic, fixed at construction from
  ``deadline_ms``), and
- a **cancellation token** (a ``threading.Event``) any thread may set —
  ``POST /cancel_user_task``, the user-task wall-clock cap, the SLO
  solve-time escalation, and ``facade.shutdown``'s grace-drain all route
  through it.

The solver checks ``stop_reason()`` at every segment boundary (every
``segment_rounds``-th round of a goal's loop) and the optimizer between
goals.  The greedy solve is *anytime* — every round's placement is feasible
and hard-goal-safe — so stopping simply returns the best placement found so
far, tagged ``partial``.

``segmented`` controls whether a goal's loop is checked at its segment
boundaries: a deadline implies it, while a cancel-only budget is honored at
goal boundaries only (as in the JAX package, where the fused solve cannot
observe a clock).  Callers wanting segment-granular cancellation without a
deadline pass ``segmented=True`` explicitly.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class SolveBudget:
    """Deadline + cancellation token threaded through one optimization."""

    def __init__(self, deadline_ms: Optional[float] = None,
                 cancel_event: Optional[threading.Event] = None,
                 segmented: Optional[bool] = None,
                 clock=time.monotonic):
        self._clock = clock
        deadline_ms = None if not deadline_ms or deadline_ms <= 0 \
            else float(deadline_ms)
        self.deadline_ms = deadline_ms
        self._deadline = (clock() + deadline_ms / 1000.0
                          if deadline_ms is not None else None)
        self.cancel_event = (cancel_event if cancel_event is not None
                             else threading.Event())
        self.segmented = (deadline_ms is not None if segmented is None
                          else bool(segmented))
        self._cancel_reason: Optional[str] = None
        self._lock = threading.Lock()

    def cancel(self, reason: str = "cancelled") -> None:
        """Set the token; first reason wins (later cancels are no-ops).
        The reason is ALSO pinned on the event itself, so the servlet's
        view of a task token and the facade's budget wrapping the same
        event agree on why the solve stopped."""
        with self._lock:
            if self._cancel_reason is None:
                self._cancel_reason = reason
        if getattr(self.cancel_event, "cancel_reason", None) is None:
            self.cancel_event.cancel_reason = reason
        self.cancel_event.set()

    def cancelled(self) -> bool:
        return self.cancel_event.is_set()

    @property
    def cancel_reason(self) -> Optional[str]:
        if not self.cancel_event.is_set():
            return None
        return (self._cancel_reason
                or getattr(self.cancel_event, "cancel_reason", None)
                or "cancelled")

    def expired(self) -> bool:
        return self._deadline is not None and self._clock() >= self._deadline

    def remaining_ms(self) -> Optional[float]:
        """Milliseconds to the deadline (clamped at 0), None without one."""
        if self._deadline is None:
            return None
        return max(0.0, (self._deadline - self._clock()) * 1000.0)

    def stop_reason(self) -> Optional[str]:
        """Why the solve should stop now, or None to keep going.
        Cancellation outranks the deadline (it carries operator intent)."""
        if self.cancel_event.is_set():
            return self.cancel_reason
        if self.expired():
            return "deadline"
        return None

    def should_stop(self) -> bool:
        return self.stop_reason() is not None
