"""Contextvar-propagated span tracer (the JAX package's
``obsvc/tracer.py``).

A tree of spans per logical operation (a request, a propose, a what-if
batch, a resident snapshot), propagated across threads with
:mod:`contextvars` so work started under a span inherits it as parent.

* **Near-zero overhead when off.**  ``Tracer.span()`` returns a shared
  no-op context manager when tracing is off and no ``torch.profiler``
  window is collecting: no allocation, no contextvar traffic, no locking.
  The check is one attribute read of the profiler's own flag.
* **On the profiler's clock.**  While a ``torch.profiler`` window collects
  (``POST /profile``, a benchmark's traced requests), every span is
  recorded whether or not tracing is on, and is mirrored into the
  profiler as a ``cc.<span name>`` host range, opened and closed with the
  span on the same thread: each span sits in the Chrome trace beside the
  operations and kernels it launched, and the capture fills ``GET /trace``.
* **Late children render.**  Root spans are appended to the ring when
  *they* close; children mutate the tree in place afterwards, so a reader
  always sees the latest picture (open spans render with ``wall_ms: null``).
* **Rollups ride the flat registry.**  Every completed span also updates a
  ``Trace.<name>`` timer in the process registry
  (:func:`~cruise_control_tpu_torch.common.metrics.registry`) and a phase
  accumulator that :meth:`Tracer.rollup` drains.
* **Device work.**  CUDA launches return before the card has done the
  work, so a span's wall is host time: the time to launch its work, plus
  whatever host reads of device values it makes.  Only the resident
  model's ``model.transfer`` and ``model.delta_apply`` synchronise the
  device before they close, so that they time the copy and the apply
  themselves.  The analyzer's spans (``optimize``, ``batch_optimize``,
  ``lanes.*``, ``goal.*``, ``polish.*``, ``solve.*``, ``phase.*``,
  ``round.stats``) add no synchronisation: a fence per span would change
  the timing it measures, and the device's own time comes from the
  profiler's trace, where each kernel falls inside the ``cc.*`` range
  that launched it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from cruise_control_tpu_torch.common.metrics import registry

#: The prefix of a span's range in a ``torch.profiler`` trace.
PROFILER_PREFIX = "cc."

_CURRENT: ContextVar[Optional["Span"]] = ContextVar("cc_trace_span",
                                                    default=None)
_IDS = itertools.count(1)


class Span:
    """One timed phase.  Mutable in place until ``wall_ms`` is set."""

    __slots__ = ("span_id", "parent_id", "name", "attrs", "children",
                 "start_ms", "wall_ms", "_t0")

    def __init__(self, name: str, parent: Optional["Span"],
                 attrs: Dict[str, Any]):
        self.span_id = next(_IDS)
        self.parent_id = parent.span_id if parent is not None else None
        self.name = name
        self.attrs = attrs
        self.children: List["Span"] = []
        self.start_ms = time.time() * 1000.0
        self.wall_ms: Optional[float] = None
        self._t0 = time.monotonic()

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ms": round(self.start_ms, 3),
            "wall_ms": None if self.wall_ms is None else round(
                self.wall_ms, 3),
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class _NoopSpan:
    __slots__ = ()

    def set(self, key: str, value: Any) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class _NoopCtx:
    __slots__ = ()

    def __enter__(self) -> _NoopSpan:
        return _NOOP_SPAN

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP_CTX = _NoopCtx()


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_attrs", "_span", "_token", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> Span:
        parent = _CURRENT.get()
        span = Span(self._name, parent, self._attrs)
        if parent is not None:
            parent.children.append(span)
        self._span = span
        self._token = _CURRENT.set(span)
        # The profiler's range opens after the span's clock starts and
        # closes before it stops, so it nests inside the span's wall.  It is
        # the C++ range behind ``record_function``'s fast path, a small
        # fraction of the cost of the ``_record_function_enter_new`` /
        # ``_exit`` ops, each of which is dispatched and profiled itself.
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(PROFILER_PREFIX + self._name)
            self._range.__enter__()
        return span

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _CURRENT.reset(self._token)
        span = self._span
        span.wall_ms = (time.monotonic() - span._t0) * 1000.0
        if exc_type is not None:
            span.attrs["error"] = exc_type.__name__
        self._tracer._on_end(span, self._range is not None)
        return False


class Tracer:
    """Process tracer: span factory + bounded ring of root traces."""

    def __init__(self, enabled: bool = False, ring_size: int = 32):
        self.enabled = enabled
        self._ring: deque = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        self._rollup: Dict[str, Dict[str, float]] = {}

    def configure(self, enabled: bool, ring_size: int) -> None:
        """Reconfigure in place (the singleton is referenced widely)."""
        with self._lock:
            self.enabled = enabled
            if ring_size != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=ring_size)

    # -- span creation -----------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Context manager for a timed phase; no-op when tracing is off and
        no profiler window is collecting."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _NOOP_CTX
        return _SpanCtx(self, name, attrs)

    def current(self) -> Optional[Span]:
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return None
        return _CURRENT.get()

    # -- completion / read side -------------------------------------------
    def _on_end(self, span: Span, profiled: bool) -> None:
        # A span that was opened while tracing was on but closes after it
        # was switched off (a straggling background thread) records
        # nothing — disable means stop collecting, immediately.  A span
        # opened in a profiler window is recorded: its range is in the
        # profiler's trace, and its tree is what ``GET /trace`` shows of it.
        if not (self.enabled or profiled):
            return
        wall = span.wall_ms or 0.0
        with self._lock:
            row = self._rollup.setdefault(
                span.name, {"count": 0, "total_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += wall
            if span.parent_id is None:
                self._ring.append(span)
        registry().timer(f"Trace.{span.name}").update_ms(wall)

    def traces(self) -> List[Dict[str, Any]]:
        """Recent root span trees, oldest first (children may still run)."""
        with self._lock:
            roots = list(self._ring)
        return [r.to_dict() for r in roots]

    def rollup(self, reset: bool = False) -> Dict[str, Dict[str, float]]:
        """Per-phase {count, total_ms, mean_ms} since start (or last reset)."""
        with self._lock:
            rows = {k: dict(v) for k, v in self._rollup.items()}
            if reset:
                self._rollup.clear()
        for v in rows.values():
            v["total_ms"] = round(v["total_ms"], 3)
            v["mean_ms"] = round(v["total_ms"] / max(v["count"], 1), 3)
        return rows

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._rollup.clear()


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER
