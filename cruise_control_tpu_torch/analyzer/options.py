"""Per-optimization options.

Reference: ``analyzer/OptimizationOptions.java:16-129`` — excluded topics,
brokers excluded from receiving leadership / replicas, goal-violation trigger
flag, requested destination brokers, and the only-move-immigrant-replicas
restriction used by the goal-violation detector.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import FrozenSet, Optional

import numpy as np

from cruise_control_tpu_torch.model.state import ClusterMeta


@dataclass(frozen=True)
class OptimizationOptions:
    excluded_topics: FrozenSet[str] = frozenset()
    excluded_topics_pattern: Optional[str] = None
    excluded_brokers_for_leadership: FrozenSet[int] = frozenset()
    excluded_brokers_for_replica_move: FrozenSet[int] = frozenset()
    # Empty = any alive broker may receive replicas.
    requested_destination_broker_ids: FrozenSet[int] = frozenset()
    is_triggered_by_goal_violation: bool = False
    only_move_immigrant_replicas: bool = False
    fast_mode: bool = False

    def excluded_topic_mask(self, meta: ClusterMeta) -> np.ndarray:
        """bool[T] (true = excluded) from the explicit set + regex pattern."""
        mask = np.zeros(meta.num_topics, dtype=bool)
        pat = re.compile(self.excluded_topics_pattern) if self.excluded_topics_pattern else None
        for i, t in enumerate(meta.topics):
            if t in self.excluded_topics or (pat is not None and pat.fullmatch(t)):
                mask[i] = True
        return mask

    def _broker_mask(self, meta: ClusterMeta, ids: FrozenSet[int], padded: int) -> np.ndarray:
        mask = np.zeros(padded, dtype=bool)
        for b in ids:
            if b in meta.broker_index:
                mask[meta.broker_index[b]] = True
        return mask

    def leadership_exclusion_mask(self, meta: ClusterMeta, padded: int) -> np.ndarray:
        return self._broker_mask(meta, self.excluded_brokers_for_leadership, padded)

    def replica_move_exclusion_mask(self, meta: ClusterMeta, padded: int) -> np.ndarray:
        return self._broker_mask(meta, self.excluded_brokers_for_replica_move, padded)

    def destination_mask(self, meta: ClusterMeta, padded: int) -> np.ndarray:
        """bool[B] of allowed destinations; all-true when no explicit request."""
        if not self.requested_destination_broker_ids:
            return np.ones(padded, dtype=bool)
        return self._broker_mask(meta, self.requested_destination_broker_ids, padded)

