"""Goal registry: reference class names → goal factories.

Reference: goal instantiation by priority in ``analyzer/AnalyzerUtils.java``
``getGoalsByPriority`` :200.  Both bare names and fully-qualified Java class
names resolve.  Only the goals ported so far are registered; any other name
raises ``ValueError`` naming it as not yet ported.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.analyzer.goals.capacity import (
    CpuCapacityGoal,
    DiskCapacityGoal,
    NetworkInboundCapacityGoal,
    NetworkOutboundCapacityGoal,
    ReplicaCapacityGoal,
)
from cruise_control_tpu_torch.analyzer.goals.counts import (
    LeaderReplicaDistributionGoal,
    ReplicaDistributionGoal,
    TopicReplicaDistributionGoal,
)
from cruise_control_tpu_torch.analyzer.goals.rack import (
    RackAwareDistributionGoal,
    RackAwareGoal,
)

_FACTORIES: Dict[str, Callable[[], Goal]] = {
    "RackAwareGoal": RackAwareGoal,
    "RackAwareDistributionGoal": RackAwareDistributionGoal,
    "ReplicaCapacityGoal": ReplicaCapacityGoal,
    "DiskCapacityGoal": DiskCapacityGoal,
    "NetworkInboundCapacityGoal": NetworkInboundCapacityGoal,
    "NetworkOutboundCapacityGoal": NetworkOutboundCapacityGoal,
    "CpuCapacityGoal": CpuCapacityGoal,
    "ReplicaDistributionGoal": ReplicaDistributionGoal,
    "TopicReplicaDistributionGoal": TopicReplicaDistributionGoal,
    "LeaderReplicaDistributionGoal": LeaderReplicaDistributionGoal,
}

# The default stack's six hard goals and three count goals, in default
# priority order (config/cruisecontrol.properties:99 `default.goals`).
DEFAULT_GOALS: List[str] = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
]

SUPPORTED_GOALS: List[str] = list(_FACTORIES)


def _bare(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def goal_by_name(name: str) -> Goal:
    try:
        return _FACTORIES[_bare(name)]()
    except KeyError:
        raise ValueError(f"goal {name!r} is not yet ported to "
                         f"cruise_control_tpu_torch (ported: {SUPPORTED_GOALS})") from None


def get_goals_by_priority(names: Sequence[str] | None = None) -> List[Goal]:
    """Instantiate goals in priority order (AnalyzerUtils.getGoalsByPriority)."""
    return [goal_by_name(n) for n in (names or DEFAULT_GOALS)]
