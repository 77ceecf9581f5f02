"""Async user-task machinery.

Reference: ``servlet/UserTaskManager.java:66-835`` (session → UUID mapping,
active/completed task rings, per-endpoint retention, 202-until-done
semantics) and ``servlet/handler/async/runnable/OperationFuture.java``.
"""

from __future__ import annotations

import enum
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.servlet.progress import OperationProgress


class TaskState(enum.Enum):
    ACTIVE = "Active"
    COMPLETED = "Completed"
    COMPLETED_WITH_ERROR = "CompletedWithError"
    # Terminal: the servlet.user.task.timeout.ms wall-clock cap fired and
    # cancelled the operation's solve budget before it finished on its own.
    TIMED_OUT = "TimedOut"


@dataclass
class UserTask:
    task_id: str
    endpoint: str
    query: str
    future: Future
    progress: OperationProgress
    start_ms: float = field(default_factory=lambda: time.time() * 1000)
    end_ms: float = 0.0
    # Cancellation token shared with the operation's SolveBudget: setting it
    # stops the solve at its next segment / goal boundary.
    cancel_token: Optional[threading.Event] = None
    # Set by the manager's timeout timer IF it fired while still active.
    timed_out: bool = False

    @property
    def state(self) -> TaskState:
        if not self.future.done():
            return TaskState.ACTIVE
        if self.timed_out:
            return TaskState.TIMED_OUT
        return (TaskState.COMPLETED_WITH_ERROR if self.future.exception()
                else TaskState.COMPLETED)

    def cancel(self, reason: str = "user") -> bool:
        """Request cancellation; the operation observes it at its next
        budget checkpoint.  False when the task carries no token (purely
        synchronous or pre-budget tasks)."""
        if self.cancel_token is None:
            return False
        # First reason wins — mirrors SolveBudget.cancel's contract so both
        # wrappers of the shared event report the same reason.
        if getattr(self.cancel_token, "cancel_reason", None) is None:
            self.cancel_token.cancel_reason = reason
        self.cancel_token.set()
        return True

    @property
    def cancel_reason(self) -> Optional[str]:
        if self.cancel_token is None or not self.cancel_token.is_set():
            return None
        return getattr(self.cancel_token, "cancel_reason", "cancelled")

    def to_dict(self) -> Dict:
        d = {
            "UserTaskId": self.task_id,
            "RequestURL": f"{self.endpoint}?{self.query}" if self.query else self.endpoint,
            "Status": self.state.value,
            "StartMs": int(self.start_ms),
        }
        reason = self.cancel_reason
        if reason is not None:
            d["CancelReason"] = reason
        return d


class UserTaskManager:
    """Runs operations on a pool; serves results/progress by task id."""

    def __init__(self, max_active_tasks: int = 25,
                 completed_retention_ms: float = 86_400_000,
                 num_threads: int = 4,
                 task_timeout_ms: Optional[float] = None):
        self._pool = ThreadPoolExecutor(max_workers=num_threads,
                                        thread_name_prefix="user-task")
        # Wall-clock cap on background tasks (servlet.user.task.timeout.ms):
        # when a task outlives it, its cancel token fires with reason
        # "timeout" and the task lands in the TIMED_OUT terminal state.
        # None/<=0 disables.
        self.task_timeout_ms = (task_timeout_ms
                                if task_timeout_ms and task_timeout_ms > 0
                                else None)
        self._tasks: Dict[str, UserTask] = {}
        self._lock = threading.Lock()
        self.max_active = max_active_tasks
        self.retention_ms = completed_retention_ms
        from cruise_control_tpu_torch.common.metrics import registry

        def _active():
            with self._lock:
                return sum(1 for t in self._tasks.values()
                           if t.state is TaskState.ACTIVE)

        def _total():
            with self._lock:
                return len(self._tasks)

        registry().gauge("UserTaskManager.num-active-user-tasks", _active)
        registry().gauge("UserTaskManager.num-user-tasks", _total)

    def submit(self, endpoint: str, query: str,
               operation: Callable[[OperationProgress], Any],
               task_id: Optional[str] = None,
               cancel_token: Optional[threading.Event] = None) -> UserTask:
        with self._lock:
            self._expire_locked()
            active = sum(1 for t in self._tasks.values()
                         if t.state is TaskState.ACTIVE)
            if active >= self.max_active:
                raise RuntimeError(
                    f"too many active user tasks ({active} >= {self.max_active})")
            tid = task_id or str(uuid.uuid4())
            progress = OperationProgress()
            fut = self._pool.submit(self._run, operation, progress)
            task = UserTask(tid, endpoint, query, fut, progress,
                            cancel_token=cancel_token)
            timer: Optional[threading.Timer] = None
            if self.task_timeout_ms is not None and cancel_token is not None:
                def _timeout(t=task):
                    # Benign race with completion: only flag TIMED_OUT when
                    # the operation was actually still running.
                    if not t.future.done():
                        t.timed_out = True
                        t.cancel("timeout")
                timer = threading.Timer(self.task_timeout_ms / 1000.0,
                                        _timeout)
                timer.daemon = True
                timer.start()

            def _done(f, t=task, timer=timer):
                t.end_ms = time.time() * 1000
                if timer is not None:
                    timer.cancel()
            fut.add_done_callback(_done)
            self._tasks[tid] = task
            return task

    @staticmethod
    def _run(operation, progress):
        try:
            return operation(progress)
        finally:
            progress.finish()

    def get(self, task_id: str) -> Optional[UserTask]:
        with self._lock:
            return self._tasks.get(task_id)

    def get_or_create(self, task_id: Optional[str], endpoint: str, query: str,
                      operation,
                      cancel_token: Optional[threading.Event] = None
                      ) -> UserTask:
        """202-until-done semantics: an existing id returns the SAME task."""
        if task_id:
            existing = self.get(task_id)
            if existing is not None:
                return existing
        return self.submit(endpoint, query, operation, task_id=task_id,
                           cancel_token=cancel_token)

    def all_tasks(self) -> List[UserTask]:
        with self._lock:
            self._expire_locked()
            return sorted(self._tasks.values(), key=lambda t: -t.start_ms)

    def _expire_locked(self) -> None:
        now = time.time() * 1000
        for tid, t in list(self._tasks.items()):
            if (t.state is not TaskState.ACTIVE and t.end_ms
                    and now - t.end_ms > self.retention_ms):
                del self._tasks[tid]

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)
