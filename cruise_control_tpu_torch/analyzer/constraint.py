"""Numeric balancing thresholds.

Reference: ``analyzer/BalancingConstraint.java:20-100`` — the single holder of
every tunable the goals consult: per-resource balance percentages, capacity
thresholds, low-utilization floors, replica-count limits, topic-replica gap
factors, and overprovisioning parameters.  Defaults mirror
``config/cruisecontrol.properties:114-138`` and the AnalyzerConfig defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource


def _per_resource(cpu: float, nw_in: float, nw_out: float, disk: float) -> np.ndarray:
    return np.array([cpu, nw_in, nw_out, disk], dtype=np.float32)


@dataclass
class BalancingConstraint:
    """All numeric thresholds used by the goals.

    ``balance_threshold[r]`` ≥ 1: a broker is balanced for resource r when its
    utilization is within ``[avg*(2-T), avg*T]`` (ResourceDistributionGoal
    :236-263).  ``capacity_threshold[r]`` ≤ 1: hard cap fraction of capacity
    (CapacityGoal).  ``low_utilization_threshold[r]``: below this cluster-avg
    utilization a resource is not worth balancing.
    """

    balance_threshold: np.ndarray = field(
        default_factory=lambda: _per_resource(1.1, 1.1, 1.1, 1.1))
    capacity_threshold: np.ndarray = field(
        default_factory=lambda: _per_resource(0.7, 0.8, 0.8, 0.8))
    low_utilization_threshold: np.ndarray = field(
        default_factory=lambda: _per_resource(0.0, 0.0, 0.0, 0.0))
    # ReplicaCapacityGoal: max replicas per (alive) broker.
    max_replicas_per_broker: int = 10_000
    # ReplicaDistributionGoal / LeaderReplicaDistributionGoal band factor.
    replica_balance_threshold: float = 1.1
    leader_replica_balance_threshold: float = 1.1
    # TopicReplicaDistributionGoal: gap factor + minimum absolute gap.
    topic_replica_balance_threshold: float = 3.0
    topic_replica_balance_min_gap: int = 2
    # MinTopicLeadersPerBrokerGoal: topics that must keep >= N leaders on every
    # alive broker (reference: topic.names.with.min.leaders.per.broker).
    min_topic_leaders_per_broker: int = 1
    min_leader_topic_names: tuple = ()
    # Goal-violation-triggered runs widen the balance band by this multiplier
    # (AnalyzerConfig goal.violation.distribution.threshold.multiplier).
    goal_violation_distribution_threshold_multiplier: float = 1.0
    # Overprovisioning detection (OptimizerResult provision status).
    overprovisioned_max_replicas_per_broker: int = 1500
    # Solver knobs (no reference equivalent: kernel batch sizing).
    max_candidates_per_round: int = 4096
    max_rounds_per_goal: int = 96

    def balance_band(self, triggered_by_goal_violation: bool = False) -> np.ndarray:
        t = self.balance_threshold.astype(np.float32)
        if triggered_by_goal_violation:
            t = 1.0 + (t - 1.0) * self.goal_violation_distribution_threshold_multiplier
        return t

    def to_dict(self) -> Dict:
        return {
            "balanceThreshold": {r.resource: float(self.balance_threshold[r]) for r in Resource},
            "capacityThreshold": {r.resource: float(self.capacity_threshold[r]) for r in Resource},
            "lowUtilizationThreshold": {
                r.resource: float(self.low_utilization_threshold[r]) for r in Resource},
            "maxReplicasPerBroker": self.max_replicas_per_broker,
            "replicaBalanceThreshold": self.replica_balance_threshold,
            "topicReplicaBalanceThreshold": self.topic_replica_balance_threshold,
        }
