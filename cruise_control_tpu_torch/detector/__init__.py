"""Anomaly detection and self-healing (the JAX package's ``detector/``).

Reference: ``detector/AnomalyDetectorManager.java`` + the six detectors and
the notifier SPI (``detector/notifier/*``).  Detection consumes the same
frozen snapshots the analyzer uses.  The manager takes its fixer as a
callable: the façade that routes fixes through the normal propose→execute
path, as the reference's self-healing does (SURVEY.md §3.5), is not ported
yet.  The maintenance-event reader is not ported yet either.
"""

from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    AnomalyType,
    BrokerFailures,
    DiskFailures,
    GoalViolations,
    MetricAnomaly,
    SloViolationAnomaly,
    TopicAnomaly,
)
from cruise_control_tpu_torch.detector.notifier import (
    AnomalyNotificationResult,
    NoopNotifier,
    SelfHealingNotifier,
)
from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager

__all__ = [
    "Anomaly",
    "AnomalyType",
    "GoalViolations",
    "BrokerFailures",
    "DiskFailures",
    "MetricAnomaly",
    "SloViolationAnomaly",
    "TopicAnomaly",
    "AnomalyNotificationResult",
    "SelfHealingNotifier",
    "NoopNotifier",
    "AnomalyDetectorManager",
]
