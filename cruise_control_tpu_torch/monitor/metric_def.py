"""Metric definitions.

Reference: core ``metricdef/MetricDef.java:30-157`` (name→id registry, per-
metric value-computing strategy, resource grouping) and the Kafka-typed
``monitor/metricdefinition/KafkaMetricDef.java:42-298`` (the ~50 model
metrics with AVG/MAX/LATEST strategies, COMMON vs BROKER_ONLY scope, and the
resource↔metric-id mapping that ``Load.expectedUtilizationFor`` uses).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource


class ValueComputingStrategy(enum.Enum):
    """How windowed samples collapse to one value (MetricDef.java)."""

    AVG = "avg"
    MAX = "max"
    LATEST = "latest"


class DefScope(enum.Enum):
    COMMON = "common"          # partitions and brokers
    BROKER_ONLY = "broker"     # broker entities only


@dataclass(frozen=True)
class MetricInfo:
    name: str
    metric_id: int
    strategy: ValueComputingStrategy
    scope: DefScope
    group: Optional[Resource]      # resource this metric contributes to
    to_predict: bool = False       # used by the CPU linear model


class MetricDef:
    """Immutable metric registry (core MetricDef semantics)."""

    def __init__(self, infos: Sequence[MetricInfo]):
        self._infos = list(infos)
        self._by_name = {m.name: m for m in infos}
        assert [m.metric_id for m in infos] == list(range(len(infos)))

    def metric_info(self, name: str) -> MetricInfo:
        return self._by_name[name]

    def metric_id(self, name: str) -> int:
        return self._by_name[name].metric_id

    def all_metric_infos(self) -> List[MetricInfo]:
        return list(self._infos)

    @property
    def size(self) -> int:
        return len(self._infos)

    def strategy_vector(self) -> np.ndarray:
        """i8[M]: 0=AVG 1=MAX 2=LATEST — drives vectorized window collapse."""
        order = [ValueComputingStrategy.AVG, ValueComputingStrategy.MAX,
                 ValueComputingStrategy.LATEST]
        return np.array([order.index(m.strategy) for m in self._infos], dtype=np.int8)

    def resource_metric_ids(self, resource: Resource) -> List[int]:
        return [m.metric_id for m in self._infos if m.group == resource]

    def resource_matrix(self) -> np.ndarray:
        """f32[4, M]: selector matrix — resource utilization = matrix @ values
        (a metric contributes to at most one resource)."""
        mat = np.zeros((4, self.size), dtype=np.float32)
        for m in self._infos:
            if m.group is not None:
                mat[int(m.group), m.metric_id] = 1.0
        return mat


def _common(name: str, strategy: ValueComputingStrategy,
            group: Optional[Resource], predict: bool = False) -> Tuple:
    return (name, strategy, DefScope.COMMON, group, predict)


def _broker(name: str, strategy: ValueComputingStrategy = ValueComputingStrategy.AVG,
            group: Optional[Resource] = None) -> Tuple:
    return (name, strategy, DefScope.BROKER_ONLY, group, False)


# KafkaMetricDef.java:44-101 — COMMON metrics first (shared id space for
# partition entities), then BROKER_ONLY.
_A, _M, _L = (ValueComputingStrategy.AVG, ValueComputingStrategy.MAX,
              ValueComputingStrategy.LATEST)
_DEFS = [
    _common("CPU_USAGE", _A, Resource.CPU, True),
    _common("DISK_USAGE", _L, Resource.DISK),
    _common("LEADER_BYTES_IN", _A, Resource.NW_IN),
    _common("LEADER_BYTES_OUT", _A, Resource.NW_OUT),
    _common("PRODUCE_RATE", _A, None),
    _common("FETCH_RATE", _A, None),
    _common("MESSAGE_IN_RATE", _A, None),
    _common("REPLICATION_BYTES_IN_RATE", _A, Resource.NW_IN),
    _common("REPLICATION_BYTES_OUT_RATE", _A, Resource.NW_OUT),
    _broker("BROKER_PRODUCE_REQUEST_RATE"),
    _broker("BROKER_CONSUMER_FETCH_REQUEST_RATE"),
    _broker("BROKER_FOLLOWER_FETCH_REQUEST_RATE"),
    _broker("BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT"),
    _broker("BROKER_REQUEST_QUEUE_SIZE"),
    _broker("BROKER_RESPONSE_QUEUE_SIZE"),
    _broker("BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX", _M),
    _broker("BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN"),
    _broker("BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX", _M),
    _broker("BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN"),
    _broker("BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX", _M),
    _broker("BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN"),
    _broker("BROKER_PRODUCE_TOTAL_TIME_MS_MAX", _M),
    _broker("BROKER_PRODUCE_TOTAL_TIME_MS_MEAN"),
    _broker("BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MAX", _M),
    _broker("BROKER_CONSUMER_FETCH_TOTAL_TIME_MS_MEAN"),
    _broker("BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MAX", _M),
    _broker("BROKER_FOLLOWER_FETCH_TOTAL_TIME_MS_MEAN"),
    _broker("BROKER_PRODUCE_LOCAL_TIME_MS_MAX", _M),
    _broker("BROKER_PRODUCE_LOCAL_TIME_MS_MEAN"),
    _broker("BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MAX", _M),
    _broker("BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN"),
    _broker("BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MAX", _M),
    _broker("BROKER_FOLLOWER_FETCH_LOCAL_TIME_MS_MEAN"),
    _broker("BROKER_LOG_FLUSH_RATE"),
    _broker("BROKER_LOG_FLUSH_TIME_MS_MAX", _M),
    _broker("BROKER_LOG_FLUSH_TIME_MS_MEAN"),
]


def _build(defs) -> MetricDef:
    infos = [MetricInfo(name=n, metric_id=i, strategy=s, scope=sc, group=g,
                        to_predict=p)
             for i, (n, s, sc, g, p) in enumerate(defs)]
    return MetricDef(infos)


# Partition entities use only the COMMON prefix; broker entities use all.
COMMON_METRIC_DEF = _build([d for d in _DEFS if d[2] is DefScope.COMMON])
BROKER_METRIC_DEF = _build(_DEFS)

CPU_USAGE = COMMON_METRIC_DEF.metric_id("CPU_USAGE")
DISK_USAGE = COMMON_METRIC_DEF.metric_id("DISK_USAGE")
LEADER_BYTES_IN = COMMON_METRIC_DEF.metric_id("LEADER_BYTES_IN")
LEADER_BYTES_OUT = COMMON_METRIC_DEF.metric_id("LEADER_BYTES_OUT")
