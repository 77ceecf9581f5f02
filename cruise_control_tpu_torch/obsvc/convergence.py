"""Solver convergence flight recorder (trace.solver.rounds).

Each goal's convergence loop runs up to 96 rounds and reports only the final
rounds/moves/violated numbers.  With ``trace.solver.rounds`` on, the solver
writes one stats row a round into a preallocated device buffer and copies it
to the host once, at the goal's end (analyzer/solver.py); this module keeps a
bounded ring of the resulting per-solve, per-goal curves plus derived
statistics:

- ``rounds_to_90pct`` — first round reaching 90% of the solve's total
  metric improvement (where greedy convergence flattens);
- ``acceptance_rate`` — mean per-round accepted moves over the peak round
  (how quickly the batch acceptance decays);
- ``stall_rounds`` — rounds that improved neither the violation count nor
  the stats metric;
- per-lane early-exit rounds for warm/cold what-if batches.

Read via ``GET /solver_stats``; a summary rides the ``convergence`` section
of ``GET /state``.  The port's copy of the JAX package's module.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

# Canonical round-stats buffer layout.  analyzer/solver.py stacks its
# per-round row in exactly this column order; this module stays
# dependency-free so the solver can import it without a cycle.
ROUND_COL_APPLIED = 0     # replica+leadership moves accepted this round
ROUND_COL_VIOLATED = 1    # violated-broker count after the round
ROUND_COL_STRANDED = 2    # offline replicas still stranded
ROUND_COL_METRIC = 3      # goal stats metric after the round
ROUND_COL_RESYNC = 4      # 1.0 when this round re-synced carried aggregates
ROUND_COL_STALL = 5       # consecutive non-improving rounds, post-update
ROUND_STATS_COLS = 6

_IDS = itertools.count(1)


def curve_stats(curve, metric_before: float) -> Dict[str, Any]:
    """Derived statistics for one goal's (rounds, cols) round-stats array."""
    rounds_total = len(curve)
    if rounds_total == 0:
        return {"rounds_total": 0, "stall_rounds": 0, "rounds_to_90pct": 0,
                "acceptance_rate": 0.0, "moves_total": 0}
    applied = [float(r[ROUND_COL_APPLIED]) for r in curve]
    metric = [float(r[ROUND_COL_METRIC]) for r in curve]
    stall_rounds = sum(1 for r in curve if float(r[ROUND_COL_STALL]) > 0)
    peak = max(applied)
    acceptance = (sum(applied) / (rounds_total * peak)) if peak > 0 else 0.0
    # First round reaching 90% of the total metric improvement; a solve with
    # no metric improvement (pure violation repair) converges "at the end".
    total_gain = metric_before - metric[-1]
    rounds_to_90 = rounds_total
    if total_gain > 0:
        for i, m in enumerate(metric):
            if metric_before - m >= 0.9 * total_gain:
                rounds_to_90 = i + 1
                break
    return {
        "rounds_total": rounds_total,
        "stall_rounds": stall_rounds,
        "rounds_to_90pct": rounds_to_90,
        "acceptance_rate": round(acceptance, 4),
        "moves_total": int(sum(applied)),
    }


def _curve_rows(curve) -> List[Dict[str, float]]:
    return [{
        "applied": int(r[ROUND_COL_APPLIED]),
        "violated": int(r[ROUND_COL_VIOLATED]),
        "stranded": int(r[ROUND_COL_STRANDED]),
        "metric": round(float(r[ROUND_COL_METRIC]), 6),
        "resync": bool(r[ROUND_COL_RESYNC]),
        "stall": int(r[ROUND_COL_STALL]),
    } for r in curve]


class ConvergenceRecorder:
    """Bounded flight-recorder ring of per-solve convergence records."""

    def __init__(self, enabled: bool = False, ring_size: int = 64):
        self.enabled = enabled
        self._ring: deque = deque(maxlen=ring_size)
        self._pending: List[Dict[str, Any]] = []   # drained by bench rows
        self._lock = threading.Lock()
        self._recorded = 0

    def configure(self, enabled: bool, ring_size: int) -> None:
        """Reconfigure in place (the singleton is referenced widely)."""
        with self._lock:
            self.enabled = enabled
            if ring_size != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=ring_size)

    # -- write side --------------------------------------------------------

    def record_solve(self, goal_curves: Sequence[Dict[str, Any]],
                     kind: str = "propose",
                     attrs: Optional[Dict[str, Any]] = None) -> Optional[int]:
        """One sequential optimization run.  ``goal_curves`` entries carry
        {goal, curve (np array), metric_before, rounds, moves} — curves come
        from ``GoalOptimizationInfo.round_curve``."""
        if not self.enabled:
            return None
        goals = []
        for gc in goal_curves:
            curve = gc.get("curve")
            entry = {
                "goal": gc["goal"],
                "rounds": int(gc.get("rounds", 0)),
                "moves": int(gc.get("moves", 0)),
            }
            # Relax-vs-greedy telemetry: solves that took the convex-
            # relaxation fast path report its wall time and how many greedy
            # repair rounds the rounded warm start still needed.
            if "relax_ms" in gc:
                entry["relax_ms"] = float(gc["relax_ms"])
                entry["repair_rounds"] = int(gc.get("repair_rounds", 0))
                if gc.get("relax_fallback"):
                    entry["relax_fallback"] = True
            if curve is not None:
                entry["stats"] = curve_stats(curve,
                                             float(gc.get("metric_before", 0.0)))
                entry["curve"] = _curve_rows(curve)
            goals.append(entry)
        rec = {
            "id": next(_IDS),
            "timestampMs": round(time.time() * 1000.0, 1),
            "kind": kind,
            "goals": goals,
        }
        if attrs:
            rec.update(attrs)
        with self._lock:
            self._ring.append(rec)
            self._pending.append(rec)
            self._recorded += 1
        return rec["id"]

    def record_batch(self, goal_names: Sequence[str], rounds_matrix,
                     warm_start: bool = False,
                     attrs: Optional[Dict[str, Any]] = None) -> Optional[int]:
        """One what-if batch: per-lane early-exit rounds per goal.
        ``rounds_matrix`` is the i32[S, G] per-lane/per-goal round counts the
        batch solve already returns."""
        if not self.enabled:
            return None
        lane_rounds = {
            name: [int(rounds_matrix[s][g])
                   for s in range(len(rounds_matrix))]
            for g, name in enumerate(goal_names)
        }
        rec = {
            "id": next(_IDS),
            "timestampMs": round(time.time() * 1000.0, 1),
            "kind": "what_if",
            "lanes": len(rounds_matrix),
            "warmStart": bool(warm_start),
            "laneRounds": lane_rounds,
        }
        if attrs:
            rec.update(attrs)
        with self._lock:
            self._ring.append(rec)
            self._pending.append(rec)
            self._recorded += 1
        return rec["id"]

    # -- read side ---------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        """Ring contents, oldest first."""
        with self._lock:
            return list(self._ring)

    def drain(self) -> List[Dict[str, Any]]:
        """Records added since the last drain (per-row attribution in a
        bench); the ring itself is untouched."""
        with self._lock:
            out, self._pending = self._pending, []
        return out

    def state_summary(self) -> Dict[str, Any]:
        """The ``convergence`` section of GET /state."""
        with self._lock:
            ring = list(self._ring)
            recorded = self._recorded
            maxlen = self._ring.maxlen
        last = None
        for rec in reversed(ring):
            if rec.get("goals"):
                last = {
                    "id": rec["id"],
                    "kind": rec["kind"],
                    "goals": {g["goal"]: g.get("stats", {"rounds_total":
                                                         g["rounds"]})
                              for g in rec["goals"]},
                }
                break
        return {"enabled": self.enabled, "recorded": recorded,
                "retained": len(ring), "ringSize": maxlen,
                "lastSolve": last}

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self._recorded = 0


_RECORDER = ConvergenceRecorder()


def convergence() -> ConvergenceRecorder:
    return _RECORDER
