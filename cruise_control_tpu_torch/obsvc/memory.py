"""Device-memory & executable-cost observatory (``memory.*``; the JAX
package's ``obsvc/memory.py``).

Two host-side ledgers plus a dispatch guard; nothing here changes what runs
on the device:

* :class:`DeviceMemoryLedger` — per-subsystem live-bytes accounting.
  Subsystems post alloc/free/donate/pin/release events (resident model
  freezes and delta applies, lane-batch mask/placement blocks); totals are
  reconciled against ``torch.cuda.memory_stats()`` on the card (None on the
  CPU, as XLA:CPU gives none).
* :class:`ExecutableCostLedger` — per-executable-family cost rows keyed by
  the compilesvc bucket labels (``R…-C…[-L…]``).  Populated from the
  solver's dispatch seam (``analyzer/solver.GoalSolver.dispatch``) when a
  family first runs at a bucket: ``lowered`` mode (service default) records
  the argument and output bytes of the port's own tensors (``flops`` and
  ``bytes_accessed`` are 0.0, what the JAX package records when
  ``cost_analysis()`` gives nothing); ``full`` mode, on the card, also
  records the peak of ``torch.cuda.max_memory_allocated`` over that run
  (reset just before it) and the temporary bytes (peak minus arguments and
  outputs).  ``peak_bytes`` is arguments + outputs (+ temporaries).
* the **headroom guard** — the lane-chunk planner consults projected
  peak bytes per lane width and shrinks a what-if batch onto narrower
  chunks (or refuses the dispatch outright, degraded-style, never a
  crash) when the projection exceeds ``memory.headroom.fraction`` of
  the device budget.

Surfaces: ``GET /memory``, ``memoryState`` in ``/state``, ``Memory.*``
sensors (and thereby the ``/metrics/history`` rings).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.common.metrics import registry as _metric_registry

LOG = logging.getLogger(__name__)

# Canonical subsystem names (free-form strings are accepted; these are the
# ones the stack posts).
SUBSYS_RESIDENT = "resident-model"
SUBSYS_LANES = "lane-batch"
SUBSYS_WARMUP = "warmup"

LIVE_BYTES_SENSOR = "Memory.live-bytes"
UTILIZATION_SENSOR = "Memory.device-utilization"
DRIFT_SENSOR = "Memory.reconcile-drift-bytes"
POSTS_SENSOR = "Memory.posts"
IMBALANCE_SENSOR = "Memory.post-imbalances"
SHRINKS_SENSOR = "Memory.headroom-shrinks"
REFUSALS_SENSOR = "Memory.headroom-refusals"
COST_ROWS_SENSOR = "Memory.cost-rows"
ANALYSIS_FAILURES_SENSOR = "Memory.analysis-failures"

ANALYSIS_MODES = ("off", "lowered", "full")


def measure_bytes(tree: Any) -> int:
    """Total device-relevant bytes of a tree of tensors: the ``nbytes`` sum
    over tensor and numpy-array leaves, walking dataclasses, tuples, lists
    and dict values (scalars and None are free).  Shape and dtype are all it
    reads, so it works on any tensor the caller still names."""
    import dataclasses

    import numpy as np
    import torch

    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, np.ndarray):
            total += int(x.nbytes)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


class ExecutableCostLedger:
    """Per-executable-family cost rows, keyed by compilesvc bucket label.

    ``observe_compile`` is called from the solver's dispatch seam after a
    family's first run at a new bucket; it is exception-safe and strictly
    host-side.  Each unique label is recorded once per mode (later first
    runs of the same label only bump ``count``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[str, Dict[str, Any]] = {}
        self._failures = _metric_registry().counter(ANALYSIS_FAILURES_SENSOR)
        _metric_registry().settable_gauge(COST_ROWS_SENSOR).set(0)

    # -- write side --------------------------------------------------------

    def observe_compile(self, label: str, args: Any, outs: Any, mode: str,
                        run_peak_bytes: Optional[int] = None) -> None:
        """One family's first run at ``label``: ``args`` and ``outs`` are the
        tensors it was given and returned; ``run_peak_bytes`` (``full`` mode
        on the card) the most bytes that run allocated above what was
        allocated before it."""
        if mode == "off":
            return
        with self._lock:
            row = self._rows.get(label)
            if row is not None and row.get("mode") == mode:
                row["count"] += 1
                return
        try:
            row = self._analyze(label, args, outs, mode, run_peak_bytes)
        except Exception:   # noqa: BLE001 — observability must never break a solve
            self._failures.inc()
            LOG.debug("cost analysis failed for %s", label, exc_info=True)
            return
        with self._lock:
            prev = self._rows.get(label)
            if prev is not None:
                row["count"] = prev["count"] + 1
            self._rows[label] = row
            _metric_registry().settable_gauge(COST_ROWS_SENSOR).set(
                len(self._rows))

    @staticmethod
    def _analyze(label: str, args: Any, outs: Any, mode: str,
                 run_peak_bytes: Optional[int]) -> Dict[str, Any]:
        arg_bytes = measure_bytes(args)
        out_bytes = measure_bytes(outs)
        row: Dict[str, Any] = {
            "label": label,
            "mode": mode,
            "count": 1,
            # Eager torch has no cost analysis: what the JAX package records
            # when cost_analysis() gives nothing.
            "flops": 0.0,
            "bytes_accessed": 0.0,
            "arg_bytes": int(arg_bytes),
            "out_bytes": int(out_bytes),
            "temp_bytes": None,
            # No code is generated per family (one kernel library serves all).
            "generated_code_bytes": None,
            "peak_bytes": int(arg_bytes + out_bytes),
        }
        if mode == "full" and run_peak_bytes is not None:
            # The run's allocations above its starting point hold its
            # outputs and its temporaries; the arguments were there before.
            temp = max(0, int(run_peak_bytes) - int(out_bytes))
            row.update(temp_bytes=temp, peak_bytes=int(arg_bytes + out_bytes + temp))
        return row

    def ingest(self, label: str, row: Dict[str, Any]) -> None:
        """Direct row insert (tests / replay of captured artifacts)."""
        with self._lock:
            self._rows[label] = dict(row, label=label)
            _metric_registry().settable_gauge(COST_ROWS_SENSOR).set(
                len(self._rows))

    # -- read side ---------------------------------------------------------

    def rows(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._rows.items())}

    def row(self, label: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            r = self._rows.get(label)
            return dict(r) if r is not None else None

    def peak_for_lanes(self, base_label: str, lanes: int) -> Optional[int]:
        """Projected peak bytes of ``<base_label>-L<lanes>``: the recorded
        row when one exists, otherwise a linear rescale from the nearest
        recorded width of the same family (lane peak is dominated by the
        per-lane masks/placements/temps, all ∝ lanes).  None with no data —
        the guard then has no basis to refuse."""
        exact = self.row(f"{base_label}-L{int(lanes)}")
        if exact is not None and exact.get("peak_bytes"):
            return int(exact["peak_bytes"])
        best: Optional[Tuple[int, int]] = None
        prefix = f"{base_label}-L"
        with self._lock:
            for label, r in self._rows.items():
                if not label.startswith(prefix) or not r.get("peak_bytes"):
                    continue
                tail = label[len(prefix):]
                if not tail.isdigit():
                    continue
                w = int(tail)
                if best is None or abs(w - lanes) < abs(best[0] - lanes):
                    best = (w, int(r["peak_bytes"]))
        if best is None:
            return None
        w, peak = best
        return int(peak * (int(lanes) / max(w, 1)))

    def maxima(self) -> Dict[str, int]:
        """Worst-case columns across all rows — what a bench row reports
        (``peak_bytes``/``temp_bytes``) for the executables it exercised."""
        with self._lock:
            peaks = [r.get("peak_bytes") or 0 for r in self._rows.values()]
            temps = [r.get("temp_bytes") or 0 for r in self._rows.values()]
        return {"peak_bytes": max(peaks, default=0),
                "temp_bytes": max(temps, default=0)}

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()
            _metric_registry().settable_gauge(COST_ROWS_SENSOR).set(0)


class DeviceMemoryLedger:
    """Process-wide device-buffer ledger + dispatch headroom guard.

    Host-side bookkeeping only: subsystems post signed byte events and the
    ledger maintains per-subsystem live totals (clamped at zero — a free
    exceeding the tracked allocation bumps ``Memory.post-imbalances``
    instead of going negative), pin/release balance, and gauges for the
    history rings.  Disabled (the module default until ``configure`` runs)
    every entry point is a cheap no-op."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self.analysis_mode = "lowered"
        self.headroom_fraction = 0.9
        self.budget_override_bytes = 0
        self.costs = ExecutableCostLedger()
        self._live: Dict[str, int] = {}
        self._peak: Dict[str, int] = {}
        self._pins: Dict[str, int] = {}
        self._events: Dict[str, int] = {}
        reg = _metric_registry()
        self._posts = reg.counter(POSTS_SENSOR)
        self._imbalances = reg.counter(IMBALANCE_SENSOR)
        self._shrinks = reg.counter(SHRINKS_SENSOR)
        self._refusals = reg.counter(REFUSALS_SENSOR)
        self._live_gauge = reg.settable_gauge(LIVE_BYTES_SENSOR)
        self._util_gauge = reg.settable_gauge(UTILIZATION_SENSOR)
        self._drift_gauge = reg.settable_gauge(DRIFT_SENSOR)
        self._subsys_gauges: Dict[str, Any] = {}
        self._live_gauge.set(0)
        self._util_gauge.set(0.0)
        self._drift_gauge.set(0)

    # -- configuration -----------------------------------------------------

    def configure(self, enabled: bool, headroom_fraction: float = 0.9,
                  budget_bytes: int = 0,
                  analysis_mode: str = "lowered") -> None:
        if analysis_mode not in ANALYSIS_MODES:
            raise ValueError(f"memory.analysis.mode must be one of "
                             f"{ANALYSIS_MODES}, got {analysis_mode!r}")
        with self._lock:
            self.enabled = bool(enabled)
            self.headroom_fraction = float(headroom_fraction)
            self.budget_override_bytes = int(budget_bytes)
            self.analysis_mode = analysis_mode
        if self.enabled:
            # Materialize the canonical subsystem gauges so the sensor-drift
            # guard sees Memory.* on a fresh boot, before the first post.
            for subsys in (SUBSYS_RESIDENT, SUBSYS_LANES, SUBSYS_WARMUP):
                self._gauge(subsys)

    def _gauge(self, subsystem: str):
        g = self._subsys_gauges.get(subsystem)
        if g is None:
            g = _metric_registry().settable_gauge(
                f"Memory.{subsystem}.live-bytes")
            g.set(self._live.get(subsystem, 0))
            self._subsys_gauges[subsystem] = g
        return g

    # -- write side --------------------------------------------------------

    def post(self, subsystem: str, nbytes: int, kind: str = "alloc",
             note: str = "") -> None:
        """One ledger event.  ``alloc`` adds ``nbytes`` to the subsystem's
        live total, ``free`` subtracts, ``donate`` records an in-place
        buffer swap (old freed, equal-size new allocated: net zero by
        construction), ``pin``/``release`` track refcounts only."""
        del note
        if not self.enabled:
            return
        nbytes = int(nbytes)
        with self._lock:
            self._posts.inc()
            self._events[kind] = self._events.get(kind, 0) + 1
            if kind == "pin":
                self._pins[subsystem] = self._pins.get(subsystem, 0) + 1
                return
            if kind == "release":
                pins = self._pins.get(subsystem, 0) - 1
                if pins < 0:
                    pins = 0
                    self._imbalances.inc()
                self._pins[subsystem] = pins
                return
            if kind == "donate":
                return      # net-zero by contract; counted, not summed
            live = self._live.get(subsystem, 0)
            if kind == "free":
                nbytes = -nbytes
            live += nbytes
            if live < 0:
                live = 0
                self._imbalances.inc()
            self._live[subsystem] = live
            self._peak[subsystem] = max(self._peak.get(subsystem, 0), live)
            total = sum(self._live.values())
        self._gauge(subsystem).set(live)
        self._live_gauge.set(total)
        budget = self.device_budget_bytes()
        if budget:
            self._util_gauge.set(round(total / budget, 6))

    def observe_compile(self, label: str, args: Any, outs: Any,
                        run_peak_bytes: Optional[int] = None) -> None:
        """Cost hook, called by the solver's dispatch seam on each family's
        first run at a bucket.  No-op while disabled."""
        if not self.enabled:
            return
        self.costs.observe_compile(label, args, outs, self.analysis_mode,
                                   run_peak_bytes)

    def wants_run_peak(self, device) -> bool:
        """True when a first run on ``device`` should be bracketed by the
        card's peak-memory counters (``full`` mode on a CUDA device)."""
        return (self.enabled and self.analysis_mode == "full"
                and getattr(device, "type", None) == "cuda")

    # -- read side ---------------------------------------------------------

    def live_bytes(self, subsystem: Optional[str] = None) -> int:
        with self._lock:
            if subsystem is not None:
                return self._live.get(subsystem, 0)
            return sum(self._live.values())

    def pins(self, subsystem: Optional[str] = None) -> int:
        with self._lock:
            if subsystem is not None:
                return self._pins.get(subsystem, 0)
            return sum(self._pins.values())

    @property
    def imbalance_count(self) -> int:
        """Process-lifetime imbalance events (the counter is a registry
        sensor shared across ledger instances — diff around a scenario)."""
        return int(self._imbalances.count)

    def events(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._events)

    @staticmethod
    def backend_memory_stats() -> Optional[Dict[str, int]]:
        """The card's allocator counters under the JAX package's
        ``memory_stats()`` names (``bytes_in_use``, ``peak_bytes_in_use``,
        ``bytes_reserved``, ``bytes_limit``), from ``torch.cuda.memory_stats``
        and ``torch.cuda.mem_get_info`` of the current device; None where
        there is no card (the CPU gives none, as XLA:CPU does)."""
        try:
            import torch
            if not torch.cuda.is_available():
                return None
            stats = torch.cuda.memory_stats()
            free, total = torch.cuda.mem_get_info()
        except Exception:   # noqa: BLE001 — probing must never raise
            return None
        return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
                "bytes_free": int(free),
                "bytes_limit": int(total)}

    def device_budget_bytes(self) -> Optional[int]:
        """The guard's denominator: the configured override when set,
        otherwise the backend-reported limit, otherwise None (no basis to
        guard — every dispatch admits)."""
        if self.budget_override_bytes > 0:
            return self.budget_override_bytes
        stats = self.backend_memory_stats()
        if stats:
            for key in ("bytes_limit", "bytes_reservable_limit"):
                if stats.get(key):
                    return int(stats[key])
        return None

    def reconcile(self) -> Dict[str, Any]:
        """Tracked totals vs backend-reported stats.  ``driftBytes`` is
        backend in-use minus tracked (None without backend stats): the
        untracked remainder — executables, constants, anything a subsystem
        does not post — not an error unless it trends."""
        tracked = self.live_bytes()
        stats = self.backend_memory_stats()
        drift = None
        if stats and "bytes_in_use" in stats:
            drift = int(stats["bytes_in_use"]) - tracked
        self._drift_gauge.set(drift if drift is not None else 0)
        return {"trackedBytes": tracked, "backend": stats,
                "driftBytes": drift}

    # -- dispatch headroom guard -------------------------------------------

    def guard_lane_plan(self, plan: List, s_n: int, base_label: str,
                        ladder, compiled_widths=()) -> Tuple[List, bool]:
        """Shrink-or-refuse a lane-chunk plan against projected peak bytes.

        Returns ``(plan, refused)``.  For the widest chunk in ``plan``, the
        cost ledger projects peak bytes (recorded row, or a rescale from
        the nearest recorded width); when the projection exceeds
        ``headroom_fraction × device budget`` the plan is re-chunked at the
        widest ladder width that fits (``Memory.headroom-shrinks``).  When
        even the narrowest width does not fit the dispatch is refused
        (``Memory.headroom-refusals``) — the caller degrades, never
        crashes.  With no budget, no projection, or the ledger disabled the
        plan passes through untouched: no evidence, no refusal."""
        if not self.enabled or not plan:
            return plan, False
        budget = self.device_budget_bytes()
        if not budget:
            return plan, False
        limit = self.headroom_fraction * budget
        width = max(c.size for c in plan)
        projected = self.costs.peak_for_lanes(base_label, width)
        if projected is None or projected <= limit:
            return plan, False
        widths = sorted({int(w) for w in ladder if int(w) >= 1})
        fit = None
        for w in reversed([w for w in widths if w < width]):
            p = self.costs.peak_for_lanes(base_label, w)
            if p is not None and p <= limit:
                fit = w
                break
        if fit is None:
            self._refusals.inc()
            LOG.warning(
                "memory headroom guard REFUSED a %d-lane dispatch: projected "
                "peak %d B > %.0f%% of %d B at every ladder width",
                s_n, projected, self.headroom_fraction * 100.0, budget)
            return plan, True
        from cruise_control_tpu_torch.compilesvc.chunking import plan_lane_chunks
        self._shrinks.inc()
        LOG.info(
            "memory headroom guard shrank a %d-lane dispatch to %d-wide "
            "chunks (projected peak %d B > %.0f%% of %d B)",
            s_n, fit, projected, self.headroom_fraction * 100.0, budget)
        return plan_lane_chunks(s_n, widths, compiled=compiled_widths,
                                max_chunk=fit), False

    # -- surfaces ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /memory`` body (also ``memoryState`` minus the cost
        table in ``/state``)."""
        with self._lock:
            subsystems = {
                name: {"liveBytes": self._live.get(name, 0),
                       "peakBytes": self._peak.get(name, 0),
                       "pins": self._pins.get(name, 0)}
                for name in sorted(set(self._live) | set(self._pins)
                                   | set(self._peak)
                                   | set(self._subsys_gauges))}
            events = dict(sorted(self._events.items()))
        return {
            "enabled": self.enabled,
            "analysisMode": self.analysis_mode,
            "headroomFraction": self.headroom_fraction,
            "deviceBudgetBytes": self.device_budget_bytes(),
            "liveBytes": self.live_bytes(),
            "subsystems": subsystems,
            "events": events,
            "guard": {"shrinks": int(self._shrinks.count),
                      "refusals": int(self._refusals.count)},
            "reconcile": self.reconcile(),
            "costs": self.costs.rows(),
        }

    def state_summary(self) -> Dict[str, Any]:
        """The compact ``memoryState`` block for ``GET /state``."""
        snap = self.snapshot()
        snap.pop("costs", None)
        snap["costRows"] = len(self.costs.rows())
        return snap

    def verify_balanced(self, drift_tolerance_fraction: float = 0.5,
                        ) -> List[str]:
        """Invariant checks (the JAX package's fuzz invariant
        ``memory_ledger_balanced``): no
        negative live totals (structurally impossible — an imbalance
        counter bump is the violation signal), pins drained, and tracked
        total within tolerance of the backend's in-use bytes when the
        backend reports them."""
        problems: List[str] = []
        with self._lock:
            for name, live in self._live.items():
                if live < 0:
                    problems.append(f"negative live bytes for {name}: {live}")
            for name, pins in self._pins.items():
                if pins != 0:
                    problems.append(f"undrained pins for {name}: {pins}")
        rec = self.reconcile()
        stats = rec["backend"]
        if stats and stats.get("bytes_in_use") and rec["trackedBytes"]:
            in_use = int(stats["bytes_in_use"])
            if rec["trackedBytes"] > in_use * (1.0 + drift_tolerance_fraction):
                problems.append(
                    f"tracked {rec['trackedBytes']} B exceeds backend "
                    f"in-use {in_use} B beyond tolerance")
        return problems

    def reset(self) -> None:
        """Drop all accounting (tests / hermeticity).  Keeps configuration."""
        with self._lock:
            self._live.clear()
            self._peak.clear()
            self._pins.clear()
            self._events.clear()
        for g in self._subsys_gauges.values():
            g.set(0)
        self._live_gauge.set(0)
        self._util_gauge.set(0.0)
        self._drift_gauge.set(0)
        self.costs.reset()


_LEDGER: Optional[DeviceMemoryLedger] = None
_LEDGER_LOCK = threading.Lock()


def memory_ledger() -> DeviceMemoryLedger:
    """Process-wide ledger singleton (disabled until ``configure``)."""
    global _LEDGER
    if _LEDGER is None:
        with _LEDGER_LOCK:
            if _LEDGER is None:
                _LEDGER = DeviceMemoryLedger()
    return _LEDGER


def set_memory_ledger(ledger: Optional[DeviceMemoryLedger]) -> None:
    """Test seam: swap (or with None, lazily rebuild) the singleton."""
    global _LEDGER
    _LEDGER = ledger


def cost_ledger() -> ExecutableCostLedger:
    return memory_ledger().costs


def configure(config) -> DeviceMemoryLedger:
    """Wire ``memory.*`` config keys into the ledger singleton."""
    ledger = memory_ledger()
    ledger.configure(
        enabled=bool(config.get("memory.enabled")),
        headroom_fraction=float(config.get("memory.headroom.fraction")),
        budget_bytes=int(config.get("memory.device.budget.bytes")),
        analysis_mode=str(config.get("memory.analysis.mode")))
    return ledger
