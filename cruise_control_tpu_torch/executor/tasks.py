"""Execution tasks and state tracking.

Reference: ``executor/ExecutionTask.java`` (state machine PENDING →
IN_PROGRESS → {COMPLETED, ABORTING → ABORTED, DEAD}), and
``executor/ExecutionTaskTracker.java`` (per-type per-state counters).
"""

from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cruise_control_tpu_torch.common.actions import ExecutionProposal


class TaskType(enum.Enum):
    INTER_BROKER_REPLICA_ACTION = "inter_broker_replica"
    INTRA_BROKER_REPLICA_ACTION = "intra_broker_replica"
    LEADER_ACTION = "leadership"


class ExecutionTaskState(enum.Enum):
    PENDING = "pending"
    IN_PROGRESS = "in_progress"
    ABORTING = "aborting"
    ABORTED = "aborted"
    DEAD = "dead"
    COMPLETED = "completed"


_VALID_TRANSITIONS = {
    ExecutionTaskState.PENDING: {ExecutionTaskState.IN_PROGRESS},
    ExecutionTaskState.IN_PROGRESS: {ExecutionTaskState.ABORTING,
                                     ExecutionTaskState.DEAD,
                                     ExecutionTaskState.COMPLETED},
    ExecutionTaskState.ABORTING: {ExecutionTaskState.ABORTED,
                                  ExecutionTaskState.DEAD},
}

_ids = itertools.count()


@dataclass
class ExecutionTask:
    proposal: ExecutionProposal
    task_type: TaskType
    execution_id: int = field(default_factory=lambda: next(_ids))
    state: ExecutionTaskState = ExecutionTaskState.PENDING
    start_time_ms: float = 0.0
    end_time_ms: float = 0.0
    alert_time_ms: float = 0.0

    def transition(self, to: ExecutionTaskState, now_ms: float = 0.0) -> None:
        allowed = _VALID_TRANSITIONS.get(self.state, set())
        if to not in allowed:
            raise ValueError(f"illegal transition {self.state} -> {to}")
        self.state = to
        if to is ExecutionTaskState.IN_PROGRESS:
            self.start_time_ms = now_ms
        elif to in (ExecutionTaskState.COMPLETED, ExecutionTaskState.ABORTED,
                    ExecutionTaskState.DEAD):
            self.end_time_ms = now_ms

    @property
    def done(self) -> bool:
        return self.state in (ExecutionTaskState.COMPLETED,
                              ExecutionTaskState.ABORTED, ExecutionTaskState.DEAD)

    @property
    def brokers_involved(self) -> List[int]:
        p = self.proposal
        out = {r.broker_id for r in p.old_replicas} | {r.broker_id for r in p.new_replicas}
        return sorted(out)


class ExecutionTaskTracker:
    """Per-type, per-state counters + data-movement progress
    (ExecutionTaskTracker.java:1-390)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: Dict[TaskType, Dict[ExecutionTaskState, List[ExecutionTask]]] = {
            t: {s: [] for s in ExecutionTaskState} for t in TaskType}
        self.finished_data_movement_mb: float = 0.0

    def add(self, task: ExecutionTask) -> None:
        with self._lock:
            self._tasks[task.task_type][task.state].append(task)

    def transition(self, task: ExecutionTask, to: ExecutionTaskState,
                   now_ms: float = 0.0) -> None:
        with self._lock:
            self._tasks[task.task_type][task.state].remove(task)
            task.transition(to, now_ms)
            self._tasks[task.task_type][task.state].append(task)
            if (to is ExecutionTaskState.COMPLETED
                    and task.task_type is TaskType.INTER_BROKER_REPLICA_ACTION):
                self.finished_data_movement_mb += (
                    task.proposal.inter_broker_data_to_move / 1e6)

    def count(self, task_type: TaskType, state: ExecutionTaskState) -> int:
        with self._lock:
            return len(self._tasks[task_type][state])

    def tasks_in(self, task_type: TaskType, state: ExecutionTaskState
                 ) -> List[ExecutionTask]:
        with self._lock:
            return list(self._tasks[task_type][state])

    def summary(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {t.value: {s.value: len(lst) for s, lst in by_state.items() if lst}
                    for t, by_state in self._tasks.items()}

    @property
    def all_done(self) -> bool:
        with self._lock:
            for by_state in self._tasks.values():
                for s in (ExecutionTaskState.PENDING, ExecutionTaskState.IN_PROGRESS,
                          ExecutionTaskState.ABORTING):
                    if by_state[s]:
                        return False
            return True
