"""Balancing actions and execution proposals (the JAX package's
``common/actions.py``).

Reference: ``analyzer/BalancingAction.java:20-287``, ``analyzer/ActionType.java``,
``analyzer/ActionAcceptance.java``, ``executor/ExecutionProposal.java:25-301``.

A ``BalancingAction`` is the atomic unit the analyzer reasons about; an
``ExecutionProposal`` is the per-partition diff (old vs new replica list) the
executor applies.  Inside the solver actions live as int tensors (see
``analyzer.solver``); these dataclasses are the host-side boundary types used
by proposals, the executor and the responses.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


class ActionType(enum.IntEnum):
    """Reference: ActionType.java:25-29."""

    INTER_BROKER_REPLICA_MOVEMENT = 0
    INTRA_BROKER_REPLICA_MOVEMENT = 1
    LEADERSHIP_MOVEMENT = 2
    INTER_BROKER_REPLICA_SWAP = 3
    INTRA_BROKER_REPLICA_SWAP = 4


class ActionAcceptance(enum.IntEnum):
    """Reference: ActionAcceptance.java — veto granularity for goal acceptance."""

    ACCEPT = 0
    REPLICA_REJECT = 1  # this replica may not take part in this action
    BROKER_REJECT = 2   # the broker pair may not take part in any such action


@dataclass(frozen=True)
class TopicPartition:
    topic: str
    partition: int

    def __str__(self) -> str:
        return f"{self.topic}-{self.partition}"


@dataclass(frozen=True)
class BalancingAction:
    """One atomic move (reference: BalancingAction.java:20-287)."""

    topic_partition: TopicPartition
    source_broker: Optional[int]
    destination_broker: Optional[int]
    action_type: ActionType
    # For swaps: the partner partition on the destination.
    destination_topic_partition: Optional[TopicPartition] = None
    # For intra-broker moves: logdir (disk) ids.
    source_disk: Optional[int] = None
    destination_disk: Optional[int] = None

    def to_dict(self) -> dict:
        d = {
            "topicPartition": str(self.topic_partition),
            "sourceBrokerId": self.source_broker,
            "destinationBrokerId": self.destination_broker,
            "actionType": self.action_type.name,
        }
        if self.destination_topic_partition is not None:
            d["destinationTopicPartition"] = str(self.destination_topic_partition)
        if self.source_disk is not None:
            d["sourceDisk"] = self.source_disk
        if self.destination_disk is not None:
            d["destinationDisk"] = self.destination_disk
        return d


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
    # Move provenance (execution observatory): {goal, path, round, solveId,
    # costDelta} stamped by the optimizer when the recorder is on; None when
    # it was off at solve time.  Excluded from eq/hash — two proposals that
    # move the same replicas the same way are the same proposal regardless
    # of which solve produced them.
    provenance: Optional[dict] = field(default=None, compare=False)
    # Model-fidelity fingerprint (fidelity observatory): the quality of the
    # monitor snapshot this proposal was solved from, stamped by the
    # optimizer when the recorder is on.  Excluded from eq/hash for the
    # same reason as provenance.
    fingerprint: Optional[dict] = field(default=None, compare=False)

    @property
    def new_leader(self) -> ReplicaPlacementInfo:
        return self.new_replicas[0]

    @property
    def replicas_to_add(self) -> Tuple[ReplicaPlacementInfo, ...]:
        old = {r.broker_id for r in self.old_replicas}
        return tuple(r for r in self.new_replicas if r.broker_id not in old)

    @property
    def replicas_to_remove(self) -> Tuple[ReplicaPlacementInfo, ...]:
        new = {r.broker_id for r in self.new_replicas}
        return tuple(r for r in self.old_replicas if r.broker_id not in new)

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

    def to_dict(self, explain: bool = False) -> dict:
        d = {
            "topicPartition": str(self.topic_partition),
            "oldLeader": self.old_leader.broker_id,
            "oldReplicas": [r.broker_id for r in self.old_replicas],
            "newReplicas": [r.broker_id for r in self.new_replicas],
        }
        if explain and self.provenance is not None:
            d["provenance"] = self.provenance
        if explain and self.fingerprint is not None:
            d["modelFingerprint"] = self.fingerprint
        return d


@dataclass
class ProposalSummary:
    """Aggregate movement stats for a proposal set (used in REST responses)."""

    num_inter_broker_replica_movements: int = 0
    num_intra_broker_replica_movements: int = 0
    num_leadership_movements: int = 0
    inter_broker_data_to_move_mb: float = 0.0
    intra_broker_data_to_move_mb: float = 0.0
    num_recent_windows: int = 0
    excluded_topics: Sequence[str] = field(default_factory=list)

    @classmethod
    def of(cls, proposals: Sequence[ExecutionProposal]) -> "ProposalSummary":
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
