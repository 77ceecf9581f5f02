"""Metric samples — the monitor's unit of ingest.

Reference: ``monitor/sampling/holder/PartitionMetricSample.java`` and
``BrokerMetricSample.java`` (typed per-entity metric records with a close()
timestamp), plus the raw wire types from the metrics-reporter module
(``cruise-control-metrics-reporter/.../RawMetricType.java:27-120`` — 94 raw
broker/topic/partition metric types with BROKER/TOPIC/PARTITION scopes).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.monitor import metric_def as md


class RawMetricScope(enum.Enum):
    BROKER = "broker"
    TOPIC = "topic"
    PARTITION = "partition"


class RawMetricType(enum.Enum):
    """The reporter's full raw-type inventory with the reference's wire ids
    and supported-since version bytes (RawMetricType.java:27-99 — 63 typed
    broker/topic/partition metrics; -1 = present since the first version)."""

    ALL_TOPIC_BYTES_IN = ("broker", 0, 4)
    ALL_TOPIC_BYTES_OUT = ("broker", 1, 4)
    TOPIC_BYTES_IN = ("topic", 2, -1)
    TOPIC_BYTES_OUT = ("topic", 3, -1)
    PARTITION_SIZE = ("partition", 4, -1)
    BROKER_CPU_UTIL = ("broker", 5, 4)
    ALL_TOPIC_REPLICATION_BYTES_IN = ("broker", 6, 4)
    ALL_TOPIC_REPLICATION_BYTES_OUT = ("broker", 7, 4)
    ALL_TOPIC_PRODUCE_REQUEST_RATE = ("broker", 8, 4)
    ALL_TOPIC_FETCH_REQUEST_RATE = ("broker", 9, 4)
    ALL_TOPIC_MESSAGES_IN_PER_SEC = ("broker", 10, 4)
    TOPIC_REPLICATION_BYTES_IN = ("topic", 11, -1)
    TOPIC_REPLICATION_BYTES_OUT = ("topic", 12, -1)
    TOPIC_PRODUCE_REQUEST_RATE = ("topic", 13, -1)
    TOPIC_FETCH_REQUEST_RATE = ("topic", 14, -1)
    TOPIC_MESSAGES_IN_PER_SEC = ("topic", 15, -1)
    BROKER_PRODUCE_REQUEST_RATE = ("broker", 16, 4)
    BROKER_CONSUMER_FETCH_REQUEST_RATE = ("broker", 17, 4)
    BROKER_FOLLOWER_FETCH_REQUEST_RATE = ("broker", 18, 4)
    BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT = ("broker", 19, 4)
    BROKER_REQUEST_QUEUE_SIZE = ("broker", 20, 4)
    BROKER_RESPONSE_QUEUE_SIZE = ("broker", 21, 4)
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX = ("broker", 22, 4)
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN = ("broker", 23, 4)
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = ("broker", 24, 4)
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = ("broker", 25, 4)
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX = ("broker", 26, 4)
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN = ("broker", 27, 4)
    BROKER_PRODUCE_TOTAL_TIME_MS_MAX = ("broker", 28, 4)
    BROKER_PRODUCE_TOTAL_TIME_MS_MEAN = ("broker", 29, 4)
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MAX = ("broker", 30, 4)
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MEAN = ("broker", 31, 4)
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MAX = ("broker", 32, 4)
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MEAN = ("broker", 33, 4)
    BROKER_PRODUCE_LOCAL_TIME_MS_MAX = ("broker", 34, 4)
    BROKER_PRODUCE_LOCAL_TIME_MS_MEAN = ("broker", 35, 4)
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MAX = ("broker", 36, 4)
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN = ("broker", 37, 4)
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MAX = ("broker", 38, 4)
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN = ("broker", 39, 4)
    BROKER_LOG_FLUSH_RATE = ("broker", 40, 4)
    BROKER_LOG_FLUSH_TIME_MS_MAX = ("broker", 41, 4)
    BROKER_LOG_FLUSH_TIME_MS_MEAN = ("broker", 42, 4)
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_50TH = ("broker", 43, 5)
    BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_999TH = ("broker", 44, 5)
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_50TH = ("broker", 45, 5)
    BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_999TH = ("broker", 46, 5)
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_50TH = ("broker", 47, 5)
    BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_999TH = ("broker", 48, 5)
    BROKER_PRODUCE_TOTAL_TIME_MS_50TH = ("broker", 49, 5)
    BROKER_PRODUCE_TOTAL_TIME_MS_999TH = ("broker", 50, 5)
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_50TH = ("broker", 51, 5)
    BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_999TH = ("broker", 52, 5)
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_50TH = ("broker", 53, 5)
    BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_999TH = ("broker", 54, 5)
    BROKER_PRODUCE_LOCAL_TIME_MS_50TH = ("broker", 55, 5)
    BROKER_PRODUCE_LOCAL_TIME_MS_999TH = ("broker", 56, 5)
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_50TH = ("broker", 57, 5)
    BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_999TH = ("broker", 58, 5)
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_50TH = ("broker", 59, 5)
    BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_999TH = ("broker", 60, 5)
    BROKER_LOG_FLUSH_TIME_MS_50TH = ("broker", 61, 5)
    BROKER_LOG_FLUSH_TIME_MS_999TH = ("broker", 62, 5)

    @property
    def scope(self) -> RawMetricScope:
        return RawMetricScope(self.value[0])

    @property
    def wire_id(self) -> int:
        return self.value[1]

    @property
    def supported_since(self) -> int:
        """Version byte this type first appeared in (-1 = always)."""
        return self.value[2]


_BY_WIRE_ID: Dict[int, "RawMetricType"] = {t.wire_id: t for t in RawMetricType}


def raw_type_by_id(wire_id: int) -> "RawMetricType":
    return _BY_WIRE_ID[wire_id]


def broker_metric_types_for_version(version: int) -> Tuple["RawMetricType", ...]:
    """Broker-scope types available at a wire version
    (RawMetricType.brokerMetricTypesDiffForVersion semantics)."""
    return tuple(t for t in RawMetricType
                 if t.scope is RawMetricScope.BROKER
                 and (t.supported_since == -1 or t.supported_since <= version))


@dataclass
class CruiseControlMetric:
    """One raw metric record off the wire (metrics-reporter types)."""

    raw_type: RawMetricType
    time_ms: float
    broker_id: int
    topic: Optional[str] = None
    partition: Optional[int] = None
    value: float = 0.0


@dataclass
class PartitionMetricSample:
    """Per-partition model sample (PartitionMetricSample.java)."""

    broker_id: int
    topic: str
    partition: int
    time_ms: float = 0.0
    metrics: np.ndarray = field(
        default_factory=lambda: np.zeros(md.COMMON_METRIC_DEF.size))

    @property
    def entity(self) -> Tuple[str, int]:
        return (self.topic, self.partition)

    def record(self, metric_id: int, value: float) -> None:
        self.metrics[metric_id] = value

    def close(self, time_ms: float) -> None:
        self.time_ms = time_ms

    def to_dict(self) -> Dict:
        return {
            "brokerId": self.broker_id, "topic": self.topic,
            "partition": self.partition, "time": self.time_ms,
            "metrics": self.metrics.tolist(),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "PartitionMetricSample":
        s = cls(broker_id=d["brokerId"], topic=d["topic"], partition=d["partition"],
                time_ms=d["time"])
        s.metrics = np.asarray(d["metrics"], dtype=np.float64)
        return s


@dataclass
class BrokerMetricSample:
    """Per-broker model sample (BrokerMetricSample.java)."""

    broker_id: int
    time_ms: float = 0.0
    metrics: np.ndarray = field(
        default_factory=lambda: np.zeros(md.BROKER_METRIC_DEF.size))

    @property
    def entity(self) -> int:
        return self.broker_id

    def record(self, metric_id: int, value: float) -> None:
        self.metrics[metric_id] = value

    def to_dict(self) -> Dict:
        return {"brokerId": self.broker_id, "time": self.time_ms,
                "metrics": self.metrics.tolist()}

    @classmethod
    def from_dict(cls, d: Dict) -> "BrokerMetricSample":
        s = cls(broker_id=d["brokerId"], time_ms=d["time"])
        s.metrics = np.asarray(d["metrics"], dtype=np.float64)
        return s
