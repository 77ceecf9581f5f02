"""Operation progress tracking.

Reference: ``servlet/handler/async/progress/OperationProgress.java:1-129`` —
explicit step-tracing of async operations, surfaced live to clients polling
an unfinished task.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class ProgressStep:
    description: str
    started_ms: float
    completed_ms: float = 0.0

    def to_dict(self) -> Dict:
        pct = 100.0 if self.completed_ms else 0.0
        return {"step": self.description, "completionPercentage": pct,
                "time-in-ms": round((self.completed_ms or time.time() * 1000)
                                    - self.started_ms, 1)}


class OperationProgress:
    def __init__(self):
        self._lock = threading.Lock()
        self._steps: List[ProgressStep] = []

    def add_step(self, description: str) -> None:
        with self._lock:
            now = time.time() * 1000
            if self._steps and not self._steps[-1].completed_ms:
                self._steps[-1].completed_ms = now
            self._steps.append(ProgressStep(description, now))

    def finish(self) -> None:
        with self._lock:
            if self._steps and not self._steps[-1].completed_ms:
                self._steps[-1].completed_ms = time.time() * 1000

    def to_list(self) -> List[Dict]:
        with self._lock:
            return [s.to_dict() for s in self._steps]

    def refer(self, other: "OperationProgress") -> None:
        """Share another operation's steps (GoalOptimizer :318)."""
        with self._lock:
            self._steps = other._steps
