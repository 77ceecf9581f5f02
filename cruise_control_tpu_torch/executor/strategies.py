"""Replica-movement ordering strategies.

Reference: ``executor/strategy/*`` — ``ReplicaMovementStrategy`` SPI with
chainable orderings: ``BaseReplicaMovementStrategy`` (execution-id order),
postpone-URP (under-replicated partitions last... reference: Postpone =
prioritize moves of partitions that are NOT under-replicated),
prioritize-large / prioritize-small replica movements.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Protocol, Set, Tuple

from cruise_control_tpu_torch.executor.tasks import ExecutionTask


class ReplicaMovementStrategy(Protocol):
    def order(self, tasks: List[ExecutionTask]) -> List[ExecutionTask]: ...


class AbstractReplicaMovementStrategy:
    """Chainable comparator strategy (AbstractReplicaMovementStrategy.java)."""

    def __init__(self, key: Optional[Callable[[ExecutionTask], Tuple]] = None):
        self._keys: List[Callable[[ExecutionTask], Tuple]] = [key] if key else []

    def chain(self, other: "AbstractReplicaMovementStrategy"
              ) -> "AbstractReplicaMovementStrategy":
        s = AbstractReplicaMovementStrategy()
        s._keys = self._keys + other._keys
        return s

    def order(self, tasks: List[ExecutionTask]) -> List[ExecutionTask]:
        def sort_key(t: ExecutionTask):
            return tuple(k(t) for k in self._keys) + (t.execution_id,)
        return sorted(tasks, key=sort_key)


class BaseReplicaMovementStrategy(AbstractReplicaMovementStrategy):
    """Execution-id (creation) order — the default tie-breaker."""


class PrioritizeLargeReplicaMovementStrategy(AbstractReplicaMovementStrategy):
    def __init__(self):
        super().__init__(lambda t: (-t.proposal.partition_size,))


class PrioritizeSmallReplicaMovementStrategy(AbstractReplicaMovementStrategy):
    def __init__(self):
        super().__init__(lambda t: (t.proposal.partition_size,))


class PostponeUrpReplicaMovementStrategy(AbstractReplicaMovementStrategy):
    """Move healthy partitions first; URP set supplied per execution."""

    def __init__(self, urp: Optional[Set[Tuple[str, int]]] = None):
        urp = urp or set()
        super().__init__(lambda t: (
            1 if (t.proposal.topic_partition.topic,
                  t.proposal.topic_partition.partition) in urp else 0,))


def strategy_by_name(name: str, urp=None) -> AbstractReplicaMovementStrategy:
    bare = name.rsplit(".", 1)[-1]
    table = {
        "BaseReplicaMovementStrategy": BaseReplicaMovementStrategy,
        "PrioritizeLargeReplicaMovementStrategy": PrioritizeLargeReplicaMovementStrategy,
        "PrioritizeSmallReplicaMovementStrategy": PrioritizeSmallReplicaMovementStrategy,
        "PostponeUrpReplicaMovementStrategy":
            lambda: PostponeUrpReplicaMovementStrategy(urp),
    }
    try:
        return table[bare]()
    except KeyError:
        raise ValueError(f"unknown replica movement strategy: {name}") from None
