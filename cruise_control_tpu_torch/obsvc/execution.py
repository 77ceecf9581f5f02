"""Execution observatory: move provenance + data-plane flight recorder (the
JAX package's ``obsvc/execution.py``).

Closes the decision→data-plane loop the solver-side observability (the
convergence recorder, the memory ledger) left open.  Two halves share one
recorder:

- **Analyzer half** — the optimizer stamps every ``ExecutionProposal`` with
  a provenance record: the goal that proposed it, the solve id from the
  convergence recorder, the path the placement change took
  (``relax`` / ``rounding`` / ``repair`` / ``greedy``), the goal's round
  count, and the per-move cost delta.  The relax fast path hands its
  post-rounding placement to its own solve on the goal's info, so the
  optimizer can split relax-stage moves from greedy-repair moves with a
  three-way diff.

- **Executor half** — a bounded flight recorder of the batch actually
  hitting the cluster: per-broker inflight moves, an EWMA of move-completion
  throughput (seconds-per-move), batch ETA, and the AIMD concurrency
  tuner's decisions with the signal that triggered each.

Everything is host-side bookkeeping over already-materialized numpy
snapshots and executor task state: the solver does the same device work with
the recorder on or off.

Read via ``GET /execution_progress``; a summary rides the
``executionState`` section of ``GET /state``; throughput surfaces as
``Executor.*`` gauges on ``/metrics`` (and thus the history rings).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

# Canonical provenance path labels, in pipeline order.  ``relax`` = changed
# by the fractional solve + rounding only; ``rounding`` = changed by the
# relax stage AND again by greedy repair; ``repair`` = changed by greedy
# repair of a rounded placement only; ``greedy`` = changed by a pure greedy
# solve (no relax fast path, fallback, or polish pass).
PATHS = ("relax", "rounding", "repair", "greedy")

_IDS = itertools.count(1)


def path_histogram(proposals: Sequence[Any]) -> Dict[str, int]:
    """Provenance-path counts for a proposal set; moves whose provenance is
    missing (recorder was off at solve time) count under ``unknown``."""
    hist: Dict[str, int] = {}
    for p in proposals:
        prov = getattr(p, "provenance", None)
        path = (prov or {}).get("path") or "unknown"
        hist[path] = hist.get(path, 0) + 1
    return hist


class ExecutionFlightRecorder:
    """Bounded flight recorder joining move provenance with live execution.

    The executor reports transitions through :meth:`on_transition` (its
    ``_transition`` choke point), so the recorder sees every task exactly
    once per state change; throughput and per-broker inflight counts are
    derived from those events, never from polling.
    """

    def __init__(self, enabled: bool = True, ring_size: int = 64,
                 alpha: float = 0.3):
        self.enabled = enabled
        self.alpha = float(alpha)
        self._ring: deque = deque(maxlen=ring_size)   # finished batches
        self._pending: List[Dict[str, Any]] = []      # drained by bench.py
        self._tuner: deque = deque(maxlen=ring_size)  # AIMD tuner events
        self._lock = threading.Lock()
        self._recorded = 0
        # Live batch state (executor side).
        self._batch: Optional[Dict[str, Any]] = None
        self._inflight: Dict[int, int] = {}   # broker id -> inflight moves
        self._in_progress = 0
        self._completed = 0
        self._ewma_spm: Optional[float] = None  # EWMA seconds-per-move
        self._last_completion_s: Optional[float] = None

    def configure(self, enabled: bool, ring_size: Optional[int] = None,
                  alpha: Optional[float] = None) -> None:
        """Reconfigure in place (the singleton is referenced widely)."""
        with self._lock:
            self.enabled = enabled
            if ring_size is not None and ring_size != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=ring_size)
                self._tuner = deque(self._tuner, maxlen=ring_size)
            if alpha is not None:
                self.alpha = float(alpha)

    # -- executor side: batch lifecycle -----------------------------------

    def begin_batch(self, tasks: Sequence[Any],
                    principal: Optional[str] = None,
                    request_id: Optional[str] = None,
                    execution_id: Optional[int] = None) -> None:
        """Adopt a live task list at execution start.  ``tasks`` are the
        executor's ``ExecutionTask`` objects — the recorder keeps the refs
        and reads their ``state`` when asked for progress."""
        if not self.enabled:
            return
        hist = path_histogram([t.proposal for t in tasks])
        # The batch's model fingerprint: the first stamped proposal wins —
        # all tasks of one batch come from one solve (and thus one model
        # generation); None when the fidelity recorder was off at solve time.
        fingerprint = next((fp for fp in
                            (getattr(t.proposal, "fingerprint", None)
                             for t in tasks) if fp is not None), None)
        with self._lock:
            self._batch = {
                "executionId": (execution_id if execution_id is not None
                                else next(_IDS)),
                "startedMs": round(time.time() * 1000.0, 1),
                "principal": principal,
                "requestId": request_id,
                "total": len(tasks),
                "pathHistogram": hist,
                "tasks": list(tasks),
                "tunerIncreases": 0,
                "tunerDecreases": 0,
                "fingerprint": fingerprint,
            }
            self._inflight = {}
            self._in_progress = 0
            self._completed = 0
            self._ewma_spm = None
            self._last_completion_s = None

    def on_transition(self, task, to_state, now_ms: float) -> None:
        """One task state change (called from the executor's ``_transition``
        choke point, BEFORE the tracker mutates ``task.state`` — so
        ``task.state`` is still the from-state here).  Updates per-broker
        inflight counts and, on completion, the seconds-per-move EWMA."""
        if not self.enabled:
            return
        to_name = getattr(to_state, "name", str(to_state))
        from_name = getattr(task.state, "name", str(task.state))
        with self._lock:
            if self._batch is None:
                return
            brokers = task.brokers_involved
            if to_name == "IN_PROGRESS":
                self._in_progress += 1
                for b in brokers:
                    self._inflight[b] = self._inflight.get(b, 0) + 1
            elif from_name == "IN_PROGRESS":
                # Leaving IN_PROGRESS (completed / aborting / dead).
                self._in_progress = max(0, self._in_progress - 1)
                for b in brokers:
                    left = self._inflight.get(b, 0) - 1
                    if left > 0:
                        self._inflight[b] = left
                    else:
                        self._inflight.pop(b, None)
            if to_name == "COMPLETED":
                self._completed += 1
                now_s = now_ms / 1000.0
                if self._last_completion_s is not None:
                    dt = max(now_s - self._last_completion_s, 1e-6)
                    if self._ewma_spm is None:
                        self._ewma_spm = dt
                    else:
                        self._ewma_spm = (self.alpha * dt
                                          + (1.0 - self.alpha) * self._ewma_spm)
                self._last_completion_s = now_s

    def record_tuner(self, direction: str, signal: str, cap: int) -> None:
        """One AIMD concurrency-tuner decision (``increase`` on a healthy
        probe round, ``decrease`` on distress) with the triggering signal."""
        if not self.enabled:
            return
        from cruise_control_tpu_torch.common.metrics import registry
        event = {
            "timestampMs": round(time.time() * 1000.0, 1),
            "direction": direction,
            "signal": signal,
            "cap": int(cap),
        }
        with self._lock:
            self._tuner.append(event)
            if self._batch is not None:
                key = ("tunerIncreases" if direction == "increase"
                       else "tunerDecreases")
                self._batch[key] += 1
        registry().counter(f"Executor.tuner-{direction}s").inc()

    def end_batch(self, completed: int, dead: int, aborted: int,
                  moved_mb: float) -> Optional[Dict[str, Any]]:
        """Close the live batch; returns (and rings) its summary."""
        if not self.enabled:
            return None
        with self._lock:
            b = self._batch
            if b is None:
                return None
            self._batch = None
            self._inflight = {}
            self._in_progress = 0
            now_ms = round(time.time() * 1000.0, 1)
            duration_ms = max(now_ms - b["startedMs"], 0.0)
            mps = (completed / (duration_ms / 1000.0)
                   if duration_ms > 0 and completed else 0.0)
            summary = {
                "id": next(_IDS),
                "executionId": b["executionId"],
                "timestampMs": now_ms,
                "durationMs": round(duration_ms, 1),
                "moves": b["total"],
                "completed": int(completed),
                "dead": int(dead),
                "aborted": int(aborted),
                "movedMb": round(float(moved_mb), 3),
                "movesPerSecond": round(mps, 4),
                "pathHistogram": b["pathHistogram"],
                "principal": b["principal"],
                "requestId": b["requestId"],
                "tunerIncreases": b["tunerIncreases"],
                "tunerDecreases": b["tunerDecreases"],
            }
            if b.get("fingerprint") is not None:
                summary["modelGeneration"] = b["fingerprint"].get("generation")
            self._ring.append(summary)
            self._pending.append(summary)
            self._recorded += 1
        return summary

    # -- read side ---------------------------------------------------------

    def seconds_per_move(self) -> float:
        """EWMA seconds-per-move of the live batch; 0.0 while idle, so the
        execution-throughput SLO objective never burns between batches."""
        with self._lock:
            if self._batch is None or self._ewma_spm is None:
                return 0.0
            return self._ewma_spm

    def moves_per_second(self) -> float:
        spm = self.seconds_per_move()
        return 1.0 / spm if spm > 0 else 0.0

    def eta_seconds(self) -> float:
        """Remaining-move count × EWMA seconds-per-move; 0.0 while idle or
        before the first two completions (no rate estimate yet)."""
        with self._lock:
            b = self._batch
            if b is None or self._ewma_spm is None:
                return 0.0
            remaining = max(b["total"] - self._completed, 0)
            return remaining * self._ewma_spm

    def inflight_moves(self) -> int:
        with self._lock:
            return self._in_progress

    def progress(self) -> Dict[str, Any]:
        """The ``GET /execution_progress`` payload: batch metadata joined
        with per-task provenance + live state, the throughput estimate, and
        recent tuner events / batch summaries."""
        with self._lock:
            ring = list(self._ring)
            tuner = list(self._tuner)
            b = self._batch
            out: Dict[str, Any] = {
                "enabled": self.enabled,
                "active": b is not None,
                "tunerEvents": tuner,
                "recentBatches": ring,
            }
            if b is None:
                return out
            tasks = []
            for t in b["tasks"]:
                p = t.proposal
                tasks.append({
                    "topicPartition": str(p.topic_partition),
                    "type": t.task_type.value,
                    "state": t.state.value,
                    "provenance": p.provenance,
                })
            remaining = max(b["total"] - self._completed, 0)
            spm = self._ewma_spm
            out["batch"] = {
                "executionId": b["executionId"],
                "startedMs": b["startedMs"],
                "principal": b["principal"],
                "requestId": b["requestId"],
                "total": b["total"],
                "pathHistogram": b["pathHistogram"],
                "tunerIncreases": b["tunerIncreases"],
                "tunerDecreases": b["tunerDecreases"],
            }
            if b.get("fingerprint") is not None:
                out["batch"]["modelFingerprint"] = b["fingerprint"]
            out["tasks"] = tasks
            out["throughput"] = {
                "completed": self._completed,
                "remaining": remaining,
                "inflight": self._in_progress,
                "secondsPerMove": round(spm, 4) if spm else None,
                "movesPerSecond": round(1.0 / spm, 4) if spm else None,
                "etaSeconds": round(remaining * spm, 2) if spm else None,
            }
            out["inflightPerBroker"] = {str(k): v
                                        for k, v in self._inflight.items()}
            return out

    def drain(self) -> List[Dict[str, Any]]:
        """Batch summaries added since the last drain (bench.py storm rows);
        the ring itself is untouched."""
        with self._lock:
            out, self._pending = self._pending, []
        return out

    def state_summary(self) -> Dict[str, Any]:
        """The ``executionState`` section of GET /state."""
        with self._lock:
            ring = list(self._ring)
            recorded = self._recorded
            maxlen = self._ring.maxlen
            active = self._batch is not None
            inflight = self._in_progress
        return {
            "enabled": self.enabled,
            "active": active,
            "inflight": inflight,
            "recorded": recorded,
            "retained": len(ring),
            "ringSize": maxlen,
            "lastBatch": ring[-1] if ring else None,
        }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self._tuner.clear()
            self._batch = None
            self._inflight = {}
            self._in_progress = 0
            self._completed = 0
            self._ewma_spm = None
            self._last_completion_s = None
            self._recorded = 0


_RECORDER = ExecutionFlightRecorder()


def execution() -> ExecutionFlightRecorder:
    return _RECORDER


def register_sensors() -> None:
    """Idempotently (re-)register the throughput gauges on the process
    metric registry.  Gauges exist recorder-on or -off (they read 0.0 while
    idle/disabled), so ``/metrics`` and the history sampler always export
    the ``Executor.`` throughput family."""
    from cruise_control_tpu_torch.common.metrics import registry
    reg = registry()
    reg.gauge("Executor.seconds-per-move",
              lambda: execution().seconds_per_move())
    reg.gauge("Executor.moves-per-second",
              lambda: execution().moves_per_second())
    reg.gauge("Executor.eta-seconds", lambda: execution().eta_seconds())
    reg.gauge("Executor.inflight-moves",
              lambda: float(execution().inflight_moves()))
    reg.counter("Executor.tuner-increases")
    reg.counter("Executor.tuner-decreases")


register_sensors()
