"""Anomaly types.

Reference: core ``detector/Anomaly.java`` / ``AnomalyType.java`` and the main
module's concrete anomalies (``GoalViolations``, ``BrokerFailures``,
``DiskFailures``, ``KafkaMetricAnomaly``, ``TopicAnomaly``,
``MaintenanceEvent``).  Priority order mirrors
``KafkaAnomalyType.java`` (broker failure heals before goal violations).
"""

from __future__ import annotations

import enum
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class AnomalyType(enum.IntEnum):
    """Lower value = higher handling priority (KafkaAnomalyType.java)."""

    BROKER_FAILURE = 0
    DISK_FAILURE = 1
    METRIC_ANOMALY = 2
    GOAL_VIOLATION = 3
    TOPIC_ANOMALY = 4
    MAINTENANCE_EVENT = 5
    # Service-level-objective burn (no reference analog): an observability
    # signal — a latency or solve objective burning its error budget — fed
    # into the same detector→notifier→audit loop the reference uses for
    # goal violations.  Lowest priority: cluster-health anomalies heal first.
    SLO_VIOLATION = 6


_ids = itertools.count()


@dataclass
class Anomaly:
    anomaly_type: AnomalyType
    detection_time_ms: float = field(default_factory=lambda: time.time() * 1000)
    anomaly_id: int = field(default_factory=lambda: next(_ids))
    # Filled by the manager: callable that performs the fix via the façade.
    fix: Optional[Callable[[], bool]] = None
    fixable: bool = True

    def __lt__(self, other: "Anomaly") -> bool:
        return ((self.anomaly_type, self.detection_time_ms)
                < (other.anomaly_type, other.detection_time_ms))

    def describe(self) -> Dict:
        return {"type": self.anomaly_type.name,
                "detectionMs": self.detection_time_ms,
                "anomalyId": self.anomaly_id}


@dataclass
class GoalViolations(Anomaly):
    """Goals whose detection run produced proposals (= violated)."""

    fixable_violated_goals: List[str] = field(default_factory=list)
    unfixable_violated_goals: List[str] = field(default_factory=list)

    def __init__(self, fixable=None, unfixable=None, **kw):
        super().__init__(AnomalyType.GOAL_VIOLATION, **kw)
        self.fixable_violated_goals = list(fixable or [])
        self.unfixable_violated_goals = list(unfixable or [])
        self.fixable = bool(self.fixable_violated_goals)

    def describe(self) -> Dict:
        d = super().describe()
        d["fixableViolatedGoals"] = self.fixable_violated_goals
        d["unfixableViolatedGoals"] = self.unfixable_violated_goals
        return d


@dataclass
class BrokerFailures(Anomaly):
    failed_brokers: Dict[int, float] = field(default_factory=dict)  # id -> failed at ms

    def __init__(self, failed_brokers=None, **kw):
        super().__init__(AnomalyType.BROKER_FAILURE, **kw)
        self.failed_brokers = dict(failed_brokers or {})

    def describe(self) -> Dict:
        d = super().describe()
        d["failedBrokers"] = self.failed_brokers
        return d


@dataclass
class DiskFailures(Anomaly):
    failed_disks: Dict[int, List[int]] = field(default_factory=dict)  # broker -> disks

    def __init__(self, failed_disks=None, **kw):
        super().__init__(AnomalyType.DISK_FAILURE, **kw)
        self.failed_disks = dict(failed_disks or {})

    def describe(self) -> Dict:
        d = super().describe()
        d["failedDisks"] = self.failed_disks
        return d


@dataclass
class MetricAnomaly(Anomaly):
    """A broker metric outside its historical percentile bounds."""

    broker_id: int = -1
    metric_name: str = ""
    current_value: float = 0.0
    threshold: float = 0.0
    # SlowBrokerFinder escalation: demote or remove the broker.
    suggested_action: str = "check"       # check | demote | remove

    def __init__(self, broker_id=-1, metric_name="", current_value=0.0,
                 threshold=0.0, suggested_action="check", **kw):
        super().__init__(AnomalyType.METRIC_ANOMALY, **kw)
        self.broker_id = broker_id
        self.metric_name = metric_name
        self.current_value = current_value
        self.threshold = threshold
        self.suggested_action = suggested_action

    def describe(self) -> Dict:
        d = super().describe()
        d.update({"brokerId": self.broker_id, "metric": self.metric_name,
                  "value": self.current_value, "threshold": self.threshold,
                  "suggestedAction": self.suggested_action})
        return d


@dataclass
class TopicAnomaly(Anomaly):
    """Topic property violations (replication factor / partition size)."""

    topic: str = ""
    reason: str = ""
    target_replication_factor: Optional[int] = None

    def __init__(self, topic="", reason="", target_replication_factor=None, **kw):
        super().__init__(AnomalyType.TOPIC_ANOMALY, **kw)
        self.topic = topic
        self.reason = reason
        self.target_replication_factor = target_replication_factor

    def describe(self) -> Dict:
        d = super().describe()
        d.update({"topic": self.topic, "reason": self.reason})
        return d


@dataclass
class SloViolationAnomaly(Anomaly):
    """A service-level objective burning its error budget in BOTH burn-rate
    windows (obsvc/slo.py evaluates the objectives over the sensor-history
    rings).  Not self-fixable — the point is the audit/alert trail."""

    objective: str = ""
    sensor: str = ""
    threshold: float = 0.0
    worst_value: float = 0.0
    burn_rate_short: float = 0.0
    burn_rate_long: float = 0.0

    def __init__(self, objective="", sensor="", threshold=0.0,
                 worst_value=0.0, burn_rate_short=0.0, burn_rate_long=0.0,
                 **kw):
        super().__init__(AnomalyType.SLO_VIOLATION, **kw)
        self.objective = objective
        self.sensor = sensor
        self.threshold = threshold
        self.worst_value = worst_value
        self.burn_rate_short = burn_rate_short
        self.burn_rate_long = burn_rate_long
        self.fixable = False

    def describe(self) -> Dict:
        d = super().describe()
        d.update({"objective": self.objective, "sensor": self.sensor,
                  "threshold": self.threshold, "worstValue": self.worst_value,
                  "burnRateShort": self.burn_rate_short,
                  "burnRateLong": self.burn_rate_long})
        return d


@dataclass
class MaintenanceEvent(Anomaly):
    """User-submitted maintenance plan (MaintenanceEventDetector).

    plan: one of add_broker / remove_broker / demote_broker / rebalance /
    fix_offline_replicas / topic_replication_factor.
    """

    plan: str = "rebalance"
    broker_ids: Tuple[int, ...] = ()
    topic: Optional[str] = None
    replication_factor: Optional[int] = None

    def __init__(self, plan="rebalance", broker_ids=(), topic=None,
                 replication_factor=None, **kw):
        super().__init__(AnomalyType.MAINTENANCE_EVENT, **kw)
        self.plan = plan
        self.broker_ids = tuple(broker_ids)
        self.topic = topic
        self.replication_factor = replication_factor

    def key(self) -> Tuple:
        """Idempotence key (IdempotenceCache semantics)."""
        return (self.plan, self.broker_ids, self.topic, self.replication_factor)

    def describe(self) -> Dict:
        d = super().describe()
        d.update({"plan": self.plan, "brokers": list(self.broker_ids)})
        return d
