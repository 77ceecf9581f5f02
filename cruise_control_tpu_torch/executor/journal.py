"""Crash-safe execution journal: a write-ahead record of accepted proposal
batches and per-task state transitions.

Layout: one JSON object per line in a single file —

    {"event": "batch_start", "batchId": ..., "tasks": [...]}
    {"event": "transition", "tid": ..., "to": "in_progress", "tsMs": ...}
    ...
    {"event": "batch_end", "batchId": ..., "outcome": {...}}

A new batch truncates the file (the previous batch either ended or was
already reconciled at startup), so the journal is bounded by one execution.
``batch_start`` and ``batch_end`` are fsynced; per-transition records are
flushed to the OS (sufficient for kill -9 / process crash — fsync-per-move
would put a disk round-trip on the movement hot loop for power-loss
protection the reference doesn't offer either).

``replay()`` tolerates a torn final line (the crash can land mid-write) and
returns the last batch with each task's final journaled state;
``Executor.recover_from_journal`` reconciles that against the live
``in_progress_reassignments()`` to re-adopt, complete, or roll back.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

LOG = logging.getLogger(__name__)

_TERMINAL = frozenset({"completed", "aborted", "dead"})


@dataclass
class JournaledTask:
    execution_id: int
    task_type: str               # TaskType.value
    topic: str
    partition: int
    old_replicas: List[List[Optional[int]]]
    new_replicas: List[List[Optional[int]]]
    last_state: str = "pending"  # ExecutionTaskState.value

    @property
    def terminal(self) -> bool:
        return self.last_state in _TERMINAL

    @property
    def topic_partition(self):
        return (self.topic, self.partition)

    def to_execution_task(self):
        """Rebuild a live ExecutionTask so re-adoption can actively drive
        the backend: real transports only advance a reassignment when it is
        polled with ``finished()``, so watching ``in_progress_reassignments``
        alone would never drain an adopted task."""
        from cruise_control_tpu_torch.common.actions import (
            ExecutionProposal,
            ReplicaPlacementInfo,
            TopicPartition,
        )
        from cruise_control_tpu_torch.executor.tasks import (
            ExecutionTask,
            ExecutionTaskState,
            TaskType,
        )

        old = tuple(ReplicaPlacementInfo(int(b), d)
                    for b, d in self.old_replicas)
        new = tuple(ReplicaPlacementInfo(int(b), d)
                    for b, d in self.new_replicas)
        proposal = ExecutionProposal(
            topic_partition=TopicPartition(self.topic, self.partition),
            partition_size=0.0, old_leader=old[0],
            old_replicas=old, new_replicas=new)
        return ExecutionTask(proposal, TaskType(self.task_type),
                             execution_id=self.execution_id,
                             state=ExecutionTaskState(self.last_state))


@dataclass
class JournalReplay:
    batch_id: int
    complete: bool               # batch_end record present
    tasks: Dict[int, JournaledTask] = field(default_factory=dict)
    outcome: Optional[dict] = None

    def orphans(self) -> List[JournaledTask]:
        """Tasks the crashed process never drove to a terminal state."""
        return [t for t in self.tasks.values() if not t.terminal]


class ExecutionJournal:
    """Append-only, single-writer (the executor thread holds the batch)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._f = None
        self._batch_id: Optional[int] = None
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    # -- write side --------------------------------------------------------

    def begin_batch(self, tasks, meta: Optional[dict] = None) -> int:
        """Record batch acceptance BEFORE the first backend submission.
        ``meta`` (e.g. the requesting principal / X-Request-ID) merges into
        the batch_start record; ``replay()`` readers use ``.get`` so older
        journals without it stay readable."""
        with self._lock:
            self._close_locked()
            batch_id = int(time.time() * 1000)
            self._batch_id = batch_id
            self._f = open(self.path, "w", encoding="utf-8")
            record = {
                "event": "batch_start",
                "batchId": batch_id,
                "tsMs": batch_id,
                **{k: v for k, v in (meta or {}).items() if v is not None},
                "tasks": [self._task_record(t) for t in tasks],
            }
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            return batch_id

    @staticmethod
    def _task_record(task) -> dict:
        p = task.proposal
        rec = {
            "tid": task.execution_id,
            "type": task.task_type.value,
            "topic": p.topic_partition.topic,
            "partition": p.topic_partition.partition,
            "oldReplicas": [[r.broker_id, r.logdir] for r in p.old_replicas],
            "newReplicas": [[r.broker_id, r.logdir] for r in p.new_replicas],
            "state": task.state.value,
        }
        if getattr(p, "provenance", None) is not None:
            # Move provenance rides the journal line so a crash-recovered
            # batch keeps its decision lineage (replay tolerates absence).
            rec["provenance"] = p.provenance
        return rec

    def record_transition(self, task, to_state) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.write(json.dumps({
                "event": "transition",
                "tid": task.execution_id,
                "to": to_state.value,
                "tsMs": int(time.time() * 1000),
            }) + "\n")
            self._f.flush()

    def end_batch(self, outcome: Optional[dict] = None) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.write(json.dumps({
                "event": "batch_end",
                "batchId": self._batch_id,
                "outcome": outcome or {},
            }) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            self._close_locked()

    def _close_locked(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
            self._batch_id = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    # -- read side ---------------------------------------------------------

    def replay(self) -> Optional[JournalReplay]:
        """Parse the journal; None when absent/empty.  A torn trailing line
        (crash mid-write) is dropped, not fatal."""
        try:
            with open(self.path, encoding="utf-8") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        replay: Optional[JournalReplay] = None
        for lineno, line in enumerate(raw.splitlines(), 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                LOG.warning("journal %s: dropping torn record at line %d",
                            self.path, lineno)
                continue
            event = rec.get("event")
            if event == "batch_start":
                replay = JournalReplay(batch_id=int(rec.get("batchId", 0)),
                                       complete=False)
                for t in rec.get("tasks", ()):
                    jt = JournaledTask(
                        execution_id=int(t["tid"]),
                        task_type=str(t["type"]),
                        topic=str(t["topic"]),
                        partition=int(t["partition"]),
                        old_replicas=t.get("oldReplicas", []),
                        new_replicas=t.get("newReplicas", []),
                        last_state=str(t.get("state", "pending")),
                    )
                    replay.tasks[jt.execution_id] = jt
            elif event == "transition" and replay is not None:
                jt = replay.tasks.get(int(rec.get("tid", -1)))
                if jt is not None:
                    jt.last_state = str(rec.get("to", jt.last_state))
            elif event == "batch_end" and replay is not None:
                replay.complete = True
                replay.outcome = rec.get("outcome") or {}
        if replay is None or not replay.tasks:
            return None
        return replay

    def lag(self) -> int:
        """Journaled tasks of the last batch not yet terminal — 0 for a
        cleanly ended (or absent) journal.  The /health journal probe."""
        replay = self.replay()
        if replay is None or replay.complete:
            return 0
        return len(replay.orphans())

    def mark_recovered(self) -> None:
        """Startup reconciliation finished: retire the journal file."""
        with self._lock:
            self._close_locked()
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass
