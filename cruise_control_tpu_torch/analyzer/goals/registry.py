"""Goal registry: reference class names → goal factories.

Reference: goal instantiation by priority in ``analyzer/AnalyzerUtils.java``
``getGoalsByPriority`` :200 and the config lists in
``config/cruisecontrol.properties:99-108`` (``goals`` / ``default.goals`` /
``hard.goals`` / ``anomaly.detection.goals`` / ``intra.broker.goals``).
Both bare names and fully-qualified Java class names resolve.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.analyzer.goals.capacity import (
    CpuCapacityGoal,
    DiskCapacityGoal,
    IntraBrokerDiskCapacityGoal,
    NetworkInboundCapacityGoal,
    NetworkOutboundCapacityGoal,
    ReplicaCapacityGoal,
)
from cruise_control_tpu_torch.analyzer.goals.counts import (
    LeaderReplicaDistributionGoal,
    ReplicaDistributionGoal,
    TopicReplicaDistributionGoal,
)
from cruise_control_tpu_torch.analyzer.goals.disk import IntraBrokerDiskUsageDistributionGoal
from cruise_control_tpu_torch.analyzer.goals.distribution import (
    CpuUsageDistributionGoal,
    DiskUsageDistributionGoal,
    LeaderBytesInDistributionGoal,
    NetworkInboundUsageDistributionGoal,
    NetworkOutboundUsageDistributionGoal,
    PotentialNwOutGoal,
)
from cruise_control_tpu_torch.analyzer.goals.kafka_assigner import (
    KafkaAssignerDiskUsageDistributionGoal,
    KafkaAssignerEvenRackAwareGoal,
)
from cruise_control_tpu_torch.analyzer.goals.leadership import (
    MinTopicLeadersPerBrokerGoal,
    PreferredLeaderElectionGoal,
)
from cruise_control_tpu_torch.analyzer.goals.rack import (
    RackAwareDistributionGoal,
    RackAwareGoal,
)

_FACTORIES: Dict[str, Callable[[], Goal]] = {
    "RackAwareGoal": RackAwareGoal,
    "RackAwareDistributionGoal": RackAwareDistributionGoal,
    "MinTopicLeadersPerBrokerGoal": MinTopicLeadersPerBrokerGoal,
    "ReplicaCapacityGoal": ReplicaCapacityGoal,
    "DiskCapacityGoal": DiskCapacityGoal,
    "NetworkInboundCapacityGoal": NetworkInboundCapacityGoal,
    "NetworkOutboundCapacityGoal": NetworkOutboundCapacityGoal,
    "CpuCapacityGoal": CpuCapacityGoal,
    "ReplicaDistributionGoal": ReplicaDistributionGoal,
    "PotentialNwOutGoal": PotentialNwOutGoal,
    "DiskUsageDistributionGoal": DiskUsageDistributionGoal,
    "NetworkInboundUsageDistributionGoal": NetworkInboundUsageDistributionGoal,
    "NetworkOutboundUsageDistributionGoal": NetworkOutboundUsageDistributionGoal,
    "CpuUsageDistributionGoal": CpuUsageDistributionGoal,
    "TopicReplicaDistributionGoal": TopicReplicaDistributionGoal,
    "LeaderReplicaDistributionGoal": LeaderReplicaDistributionGoal,
    "LeaderBytesInDistributionGoal": LeaderBytesInDistributionGoal,
    "PreferredLeaderElectionGoal": PreferredLeaderElectionGoal,
    "IntraBrokerDiskCapacityGoal": IntraBrokerDiskCapacityGoal,
    "IntraBrokerDiskUsageDistributionGoal": IntraBrokerDiskUsageDistributionGoal,
    "KafkaAssignerEvenRackAwareGoal": KafkaAssignerEvenRackAwareGoal,
    "KafkaAssignerDiskUsageDistributionGoal": KafkaAssignerDiskUsageDistributionGoal,
}

# Priority order per config/cruisecontrol.properties:99 (default.goals).
DEFAULT_GOALS: List[str] = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal",
]

# config/cruisecontrol.properties:108.
DEFAULT_HARD_GOALS: List[str] = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
]

# config/cruisecontrol.properties:214.
DEFAULT_ANOMALY_DETECTION_GOALS: List[str] = list(DEFAULT_HARD_GOALS)

# RunnableUtils.java isKafkaAssignerMode: the pair swapped in when a request
# carries kafka_assigner=true (the even goal runs first — it assumes no prior
# optimized goals, KafkaAssignerEvenRackAwareGoal.java:108-111).
KAFKA_ASSIGNER_GOALS: List[str] = [
    "KafkaAssignerEvenRackAwareGoal",
    "KafkaAssignerDiskUsageDistributionGoal",
]

# config/cruisecontrol.properties:105.
DEFAULT_INTRA_BROKER_GOALS: List[str] = [
    "IntraBrokerDiskCapacityGoal",
    "IntraBrokerDiskUsageDistributionGoal",
]

# The full supported list (config/cruisecontrol.properties:102 `goals`).
SUPPORTED_GOALS: List[str] = list(_FACTORIES)


# Goals the convex-relaxation path (analyzer/relax.py) may lower to a
# fractional solve: the resource- and count-distribution families, whose
# objective is one scalar channel per broker.  Derived from the goal
# classes' ``relax_eligible`` attribute, as in the JAX package.
RELAX_ELIGIBLE_GOALS: List[str] = [
    name for name, factory in _FACTORIES.items()
    if getattr(factory, "relax_eligible", False)
]


def _bare(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def is_relax_eligible(name: str) -> bool:
    """True when the (bare or fully-qualified) goal name may take the
    relax→repair path; unknown names are simply ineligible."""
    factory = _FACTORIES.get(_bare(name))
    return bool(factory is not None and getattr(factory, "relax_eligible", False))


def goal_by_name(name: str) -> Goal:
    try:
        return _FACTORIES[_bare(name)]()
    except KeyError:
        raise ValueError(f"unknown goal: {name!r} (known: {sorted(_FACTORIES)})") from None


def get_goals_by_priority(names: Sequence[str] | None = None) -> List[Goal]:
    """Instantiate goals in priority order (AnalyzerUtils.getGoalsByPriority)."""
    return [goal_by_name(n) for n in (names or DEFAULT_GOALS)]
