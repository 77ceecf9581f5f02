"""Execution proposals: the per-partition placement diff the optimizer emits.

Reference: ``executor/ExecutionProposal.java:25-301``.  Host-side boundary
types used by proposals and the CLI output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class TopicPartition:
    topic: str
    partition: int

    def __str__(self) -> str:
        return f"{self.topic}-{self.partition}"


@dataclass(frozen=True)
class ReplicaPlacementInfo:
    """Broker (+ optional logdir) holding one replica (reference: ReplicaPlacementInfo.java)."""

    broker_id: int
    logdir: Optional[int] = None


@dataclass(frozen=True)
class ExecutionProposal:
    """Per-partition placement diff (reference: ExecutionProposal.java:25-301).

    ``old_replicas``/``new_replicas`` are ordered; index 0 is the (old/new) leader.
    """

    topic_partition: TopicPartition
    partition_size: float  # bytes; used by movement strategies & throttling
    old_leader: ReplicaPlacementInfo
    old_replicas: Tuple[ReplicaPlacementInfo, ...]
    new_replicas: Tuple[ReplicaPlacementInfo, ...]

    @property
    def replicas_to_add(self) -> Tuple[ReplicaPlacementInfo, ...]:
        old = {r.broker_id for r in self.old_replicas}
        return tuple(r for r in self.new_replicas if r.broker_id not in old)

    @property
    def replicas_to_move_between_disks(self) -> Tuple[Tuple[ReplicaPlacementInfo, ReplicaPlacementInfo], ...]:
        """(old, new) pairs where the broker stays but the logdir changes."""
        new_by_broker = {r.broker_id: r for r in self.new_replicas}
        out = []
        for old in self.old_replicas:
            new = new_by_broker.get(old.broker_id)
            if new is not None and old.logdir is not None and new.logdir is not None and old.logdir != new.logdir:
                out.append((old, new))
        return tuple(out)

    @property
    def has_leader_action(self) -> bool:
        return self.old_leader.broker_id != self.new_replicas[0].broker_id

    @property
    def has_replica_action(self) -> bool:
        return {r.broker_id for r in self.old_replicas} != {r.broker_id for r in self.new_replicas}

    @property
    def inter_broker_data_to_move(self) -> float:
        return self.partition_size * len(self.replicas_to_add)

    def to_dict(self) -> dict:
        return {
            "topicPartition": str(self.topic_partition),
            "oldLeader": self.old_leader.broker_id,
            "oldReplicas": [r.broker_id for r in self.old_replicas],
            "newReplicas": [r.broker_id for r in self.new_replicas],
        }


@dataclass
class ProposalSummary:
    """Aggregate movement stats for a proposal set (used in responses)."""

    num_inter_broker_replica_movements: int = 0
    num_intra_broker_replica_movements: int = 0
    num_leadership_movements: int = 0
    inter_broker_data_to_move_mb: float = 0.0
    intra_broker_data_to_move_mb: float = 0.0

    @classmethod
    def of(cls, proposals) -> "ProposalSummary":
        s = cls()
        for p in proposals:
            if p.has_replica_action:
                s.num_inter_broker_replica_movements += len(p.replicas_to_add)
                s.inter_broker_data_to_move_mb += p.inter_broker_data_to_move / 1e6
            moved = p.replicas_to_move_between_disks
            if moved:
                s.num_intra_broker_replica_movements += len(moved)
                s.intra_broker_data_to_move_mb += p.partition_size * len(moved) / 1e6
            if p.has_leader_action:
                s.num_leadership_movements += 1
        return s
