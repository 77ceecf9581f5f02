"""Cluster admin backend — the seam to the managed cluster.

Reference split: ``executor/ExecutorUtils.scala:31-114`` (reassignment znode
writes, preferred-leader election, in-flight queries),
``ExecutorAdminUtils.java`` (logdir moves), ``ReplicationThrottleHelper.java``
(throttle configs).  Here one protocol covers all three; the fake
implementation drives a ``FakeMetadataBackend`` and completes movements after
a configurable number of progress polls — the in-process stand-in for the
reference's embedded-broker integration harness.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Protocol, Sequence, Set, Tuple

from cruise_control_tpu_torch.executor.tasks import ExecutionTask
from cruise_control_tpu_torch.monitor.metadata import FakeMetadataBackend

TP = Tuple[str, int]


class ClusterAdminBackend(Protocol):
    def execute_replica_reassignments(self, tasks: Sequence[ExecutionTask]) -> None: ...

    def execute_logdir_moves(self, tasks: Sequence[ExecutionTask]) -> None: ...

    def execute_preferred_leader_election(self, tasks: Sequence[ExecutionTask]) -> None: ...

    def in_progress_reassignments(self) -> Set[TP]: ...

    def finished(self, task: ExecutionTask) -> bool: ...

    def offline_logdirs(self) -> Dict[int, List[int]]:
        """broker id → offline logdir ids (reference:
        ``AdminClient.describeLogDirs`` as used by
        ``DiskFailureDetector.java:1-118``); the disk-failure detector polls
        this through the executor's backend."""
        ...

    def set_throttles(self, rate_bytes_per_s: Optional[int],
                      partitions: Sequence[TP],
                      brokers: Sequence[int] = (),
                      proposals: Sequence = ()) -> None:
        """``brokers`` = every broker involved in the movements (old ∪ new
        replicas) and ``proposals`` the ExecutionProposals themselves —
        ReplicationThrottleHelper derives everything from the proposals:
        destinations that hold nothing yet still get rate configs, and the
        ADDING replicas go into the follower throttled-replicas lists."""
        ...

    def clear_throttles(self) -> None: ...


class FakeClusterBackend:
    """Applies movements to a FakeMetadataBackend after N polls per task."""

    def __init__(self, metadata_backend: FakeMetadataBackend, polls_to_finish: int = 2):
        self.metadata = metadata_backend
        self.polls_to_finish = polls_to_finish
        self._lock = threading.Lock()
        self._in_flight: Dict[int, int] = {}       # execution_id -> polls left
        self._tasks: Dict[int, ExecutionTask] = {}
        self.throttle_rate: Optional[int] = None
        self.throttled_partitions: List[TP] = []
        self.throttled_brokers: List[int] = []
        self.reassignment_log: List[TP] = []
        # Fault injection for disk-failure tests: broker → offline dir ids.
        self.offline_disks: Dict[int, List[int]] = {}

    # ------------------------------------------------------------- execute

    def execute_replica_reassignments(self, tasks) -> None:
        with self._lock:
            for t in tasks:
                self._in_flight[t.execution_id] = self.polls_to_finish
                self._tasks[t.execution_id] = t
                tp = t.proposal.topic_partition
                self.reassignment_log.append((tp.topic, tp.partition))

    def execute_logdir_moves(self, tasks) -> None:
        self.execute_replica_reassignments(tasks)

    def execute_preferred_leader_election(self, tasks) -> None:
        with self._lock:
            for t in tasks:
                self._in_flight[t.execution_id] = 1
                self._tasks[t.execution_id] = t

    # ------------------------------------------------------------ progress

    def in_progress_reassignments(self) -> Set[TP]:
        with self._lock:
            out = set()
            for tid in self._in_flight:
                tp = self._tasks[tid].proposal.topic_partition
                out.add((tp.topic, tp.partition))
            return out

    def finished(self, task: ExecutionTask) -> bool:
        with self._lock:
            left = self._in_flight.get(task.execution_id)
            if left is None:
                return True
            left -= 1
            if left <= 0:
                self._apply(task)
                del self._in_flight[task.execution_id]
                del self._tasks[task.execution_id]
                return True
            self._in_flight[task.execution_id] = left
            return False

    def _apply(self, task: ExecutionTask) -> None:
        p = task.proposal
        tp = p.topic_partition
        new = tuple(r.broker_id for r in p.new_replicas)
        self.metadata.apply_reassignment(tp.topic, tp.partition, new, new[0])

    # ----------------------------------------------------------- throttles

    def set_throttles(self, rate_bytes_per_s, partitions, brokers=(),
                      proposals=()) -> None:
        self.throttle_rate = rate_bytes_per_s
        self.throttled_partitions = list(partitions)
        self.throttled_brokers = list(brokers)

    def offline_logdirs(self) -> Dict[int, List[int]]:
        return {b: list(d) for b, d in self.offline_disks.items() if d}

    def clear_throttles(self) -> None:
        self.throttle_rate = None
        self.throttled_partitions = []
