"""Self-healing audit log: detector decision → facade action → execution outcome.

The reference scatters the self-healing story across the operation logger
(``cruisecontrol.operation``), per-type anomaly rates, and executor state;
reconstructing "what did the detector decide, what did it run, and how did
that execution end" means grepping logs.  This bounded in-memory log keeps
the three stages of each self-healing attempt in one queryable record,
surfaced as ``selfHealingAudit`` inside the ``AnomalyDetectorState``
substate of ``GET /state``.

Stages (all best-effort, never raising into the caller):

1. :meth:`AuditLog.record` — the detector manager logs every resolved
   anomaly with its decision (``IGNORED`` / ``CHECK`` / ``FIX``).
2. :meth:`AuditLog.set_action` — the facade's ``_fix_anomaly`` dispatcher
   annotates the newest open entry of that anomaly type with the concrete
   operation it started (``rebalance``, ``remove_broker``, ...).
3. :meth:`AuditLog.attach_execution_outcome` — the executor's batch
   teardown attaches completed/dead/aborted counts to the newest entry
   still waiting on an execution (entries whose fix never started an
   execution simply keep ``executionOutcome: null``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

_IDS = itertools.count(1)


class AuditLog:
    def __init__(self, maxlen: int = 256):
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=maxlen)

    def configure(self, maxlen: int) -> None:
        with self._lock:
            if maxlen != self._entries.maxlen:
                self._entries = deque(self._entries, maxlen=maxlen)

    def record(self, anomaly_type: str, description: Any,
               decision: str) -> int:
        entry = {
            "id": next(_IDS),
            "timestampMs": int(time.time() * 1000),
            "anomalyType": anomaly_type,
            "description": description,
            "decision": decision,
            "action": None,
            "outcome": None,
            "executionOutcome": None,
        }
        with self._lock:
            self._entries.append(entry)
        return entry["id"]

    def set_action(self, anomaly_type: str, action: str) -> None:
        """Annotate the newest action-less entry of this type (stage 2)."""
        with self._lock:
            for entry in reversed(self._entries):
                if (entry["anomalyType"] == anomaly_type
                        and entry["action"] is None):
                    entry["action"] = action
                    return

    def set_outcome(self, entry_id: int, outcome: str) -> None:
        with self._lock:
            for entry in reversed(self._entries):
                if entry["id"] == entry_id:
                    entry["outcome"] = outcome
                    return

    def attach_execution_outcome(self, completed: int, dead: int,
                                 aborted: int, moved_mb: float,
                                 provenance_paths: Optional[Dict[str, int]]
                                 = None) -> None:
        """Stage 3: executor batch finished.  Attach to the newest entry
        whose fix started an execution and has no outcome yet; executions
        started directly by users (no pending audit entry) are dropped.
        ``provenance_paths`` (execution observatory) is the batch's
        relax/rounding/repair/greedy move histogram — how the fix's moves
        were derived, joined to how they landed."""
        with self._lock:
            for entry in reversed(self._entries):
                if (entry["outcome"] == "FIX_STARTED"
                        and entry["executionOutcome"] is None):
                    entry["executionOutcome"] = {
                        "completed": completed,
                        "dead": dead,
                        "aborted": aborted,
                        "movedMB": round(moved_mb, 1),
                        "timestampMs": int(time.time() * 1000),
                    }
                    if provenance_paths:
                        entry["executionOutcome"]["provenancePaths"] = dict(
                            provenance_paths)
                    return

    def entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._entries]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_AUDIT = AuditLog()


def audit_log() -> AuditLog:
    return _AUDIT
