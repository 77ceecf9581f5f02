"""Proposal → task translation and concurrency-aware batching.

Reference: ``executor/ExecutionTaskPlanner.java:63-446`` — splits proposals
into inter-broker / intra-broker / leadership tasks, keeps strategy-ordered
pending queues, and hands out batches that respect per-broker in-flight caps
(``getInterBrokerReplicaMovementTasks`` :317-389 round-robins over ready
brokers).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.common.actions import ExecutionProposal
from cruise_control_tpu_torch.executor.strategies import (
    AbstractReplicaMovementStrategy,
    BaseReplicaMovementStrategy,
)
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskType


class ExecutionTaskPlanner:
    def __init__(self, strategy: Optional[AbstractReplicaMovementStrategy] = None):
        self._strategy = strategy or BaseReplicaMovementStrategy()
        self._inter: List[ExecutionTask] = []
        self._intra: List[ExecutionTask] = []
        self._leadership: List[ExecutionTask] = []

    def add_proposals(self, proposals: Sequence[ExecutionProposal]) -> List[ExecutionTask]:
        created: List[ExecutionTask] = []
        for p in proposals:
            if p.has_replica_action:
                created.append(ExecutionTask(p, TaskType.INTER_BROKER_REPLICA_ACTION))
            if p.replicas_to_move_between_disks:
                created.append(ExecutionTask(p, TaskType.INTRA_BROKER_REPLICA_ACTION))
            if p.has_leader_action and not p.has_replica_action:
                # Leadership embedded in a replica move happens with it.
                created.append(ExecutionTask(p, TaskType.LEADER_ACTION))
        for t in created:
            if t.task_type is TaskType.INTER_BROKER_REPLICA_ACTION:
                self._inter.append(t)
            elif t.task_type is TaskType.INTRA_BROKER_REPLICA_ACTION:
                self._intra.append(t)
            else:
                self._leadership.append(t)
        self._inter = self._strategy.order(self._inter)
        return created

    # ------------------------------------------------------------- queries

    @property
    def remaining_inter_broker_tasks(self) -> List[ExecutionTask]:
        return list(self._inter)

    @property
    def remaining_intra_broker_tasks(self) -> List[ExecutionTask]:
        return list(self._intra)

    @property
    def remaining_leadership_tasks(self) -> List[ExecutionTask]:
        return list(self._leadership)

    # ------------------------------------------------------------- batches

    def inter_broker_tasks(self, ready_brokers: Dict[int, int],
                           in_flight: Dict[int, int],
                           max_total: int = 2 ** 31) -> List[ExecutionTask]:
        """Next batch honoring per-broker caps (planner :317-389).

        ``ready_brokers``: broker -> max concurrent movements;
        ``in_flight``: broker -> currently executing movements.
        """
        out: List[ExecutionTask] = []
        counts = dict(in_flight)
        for task in list(self._inter):
            if len(out) >= max_total:
                break
            involved = task.brokers_involved
            if all(counts.get(b, 0) < ready_brokers.get(b, 0) for b in involved):
                for b in involved:
                    counts[b] = counts.get(b, 0) + 1
                out.append(task)
                self._inter.remove(task)
        return out

    def intra_broker_tasks(self, ready_brokers: Dict[int, int],
                           in_flight: Dict[int, int]) -> List[ExecutionTask]:
        out: List[ExecutionTask] = []
        counts = dict(in_flight)
        for task in list(self._intra):
            b = task.proposal.old_leader.broker_id
            involved = {r.broker_id for r in task.proposal.old_replicas}
            if all(counts.get(x, 0) < ready_brokers.get(x, 0) for x in involved):
                for x in involved:
                    counts[x] = counts.get(x, 0) + 1
                out.append(task)
                self._intra.remove(task)
        return out

    def leadership_tasks(self, max_batch: int) -> List[ExecutionTask]:
        batch = self._leadership[:max_batch]
        self._leadership = self._leadership[max_batch:]
        return batch

    @property
    def empty(self) -> bool:
        return not (self._inter or self._intra or self._leadership)

    def clear(self) -> List[ExecutionTask]:
        dropped = self._inter + self._intra + self._leadership
        self._inter, self._intra, self._leadership = [], [], []
        return dropped
