"""Prometheus-backed metric sampler (the JAX package's ``monitor/prometheus.py``).

Reference: ``monitor/sampling/prometheus/PrometheusMetricSampler.java:54-289``
(+ ``DefaultPrometheusQuerySupplier``, ``PrometheusAdapter``): for every raw
metric type, run a PromQL range query, map each series back to a broker /
topic / partition via its labels, average the series values over the window,
and hand the typed batch to the metrics processor.

The HTTP layer is injectable (``query_fn``) so deployments plug their client
and tests feed canned series; the default uses stdlib urllib against
``<endpoint>/api/v1/query_range``.
"""

from __future__ import annotations

import json
import logging
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.common.exceptions import CruiseControlError
from cruise_control_tpu_torch.monitor.samples import CruiseControlMetric, RawMetricScope, RawMetricType
from cruise_control_tpu_torch.monitor.sampler import (
    CruiseControlMetricsProcessor,
    SamplerResult,
)

LOG = logging.getLogger(__name__)


class InvalidPrometheusResultError(CruiseControlError):
    """Series whose labels cannot be mapped to this cluster — skipped."""


@dataclass
class PrometheusSeries:
    labels: Dict[str, str]
    values: List[Tuple[float, float]]     # (time_s, value)


def default_query_map() -> Dict[RawMetricType, str]:
    """RawMetricType → PromQL (DefaultPrometheusQuerySupplier.java:22-120,
    node-exporter + JMX-exporter naming)."""
    q: Dict[RawMetricType, str] = {
        RawMetricType.BROKER_CPU_UTIL:
            "1 - avg by (instance) (irate(node_cpu_seconds_total{mode='idle'}[1m]))",
        RawMetricType.ALL_TOPIC_BYTES_IN:
            "sum by (instance) (irate(kafka_server_BrokerTopicMetrics_BytesInPerSec[1m]))",
        RawMetricType.ALL_TOPIC_BYTES_OUT:
            "sum by (instance) (irate(kafka_server_BrokerTopicMetrics_BytesOutPerSec[1m]))",
        RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN:
            "sum by (instance) (irate(kafka_server_BrokerTopicMetrics_ReplicationBytesInPerSec[1m]))",
        RawMetricType.ALL_TOPIC_REPLICATION_BYTES_OUT:
            "sum by (instance) (irate(kafka_server_BrokerTopicMetrics_ReplicationBytesOutPerSec[1m]))",
        RawMetricType.ALL_TOPIC_FETCH_REQUEST_RATE:
            "sum by (instance) (irate(kafka_server_BrokerTopicMetrics_TotalFetchRequestsPerSec[1m]))",
        RawMetricType.ALL_TOPIC_PRODUCE_REQUEST_RATE:
            "sum by (instance) (irate(kafka_server_BrokerTopicMetrics_TotalProduceRequestsPerSec[1m]))",
        RawMetricType.ALL_TOPIC_MESSAGES_IN_PER_SEC:
            "sum by (instance) (irate(kafka_server_BrokerTopicMetrics_MessagesInPerSec[1m]))",
        RawMetricType.TOPIC_BYTES_IN:
            "sum by (instance, topic) (irate(kafka_server_BrokerTopicMetrics_BytesInPerSec{topic!=''}[1m]))",
        RawMetricType.TOPIC_BYTES_OUT:
            "sum by (instance, topic) (irate(kafka_server_BrokerTopicMetrics_BytesOutPerSec{topic!=''}[1m]))",
        RawMetricType.PARTITION_SIZE:
            "sum by (instance, topic, partition) (kafka_log_Log_Size)",
    }
    return q


class PrometheusMetricSampler:
    """MetricSampler SPI impl querying a Prometheus server."""

    def __init__(self, endpoint: Optional[str] = None,
                 query_map: Optional[Dict[RawMetricType, str]] = None,
                 query_fn: Optional[Callable[[str, float, float], List[PrometheusSeries]]] = None,
                 resolution_step_ms: float = 60_000.0,
                 processor: Optional[CruiseControlMetricsProcessor] = None):
        if not endpoint and query_fn is None:
            # Fail at construction (startup), not at the first sampling tick.
            raise ValueError(
                "PrometheusMetricSampler needs a prometheus.server.endpoint "
                "or an injected query_fn")
        self.endpoint = endpoint
        self.query_map = query_map or default_query_map()
        self.step_ms = resolution_step_ms
        self.processor = processor or CruiseControlMetricsProcessor()
        self._query_fn = query_fn or self._http_query

    # ---------------------------------------------------------- http adapter

    def _http_query(self, promql: str, start_ms: float,
                    end_ms: float) -> List[PrometheusSeries]:
        """PrometheusAdapter.queryMetric — /api/v1/query_range."""
        params = urllib.parse.urlencode({
            "query": promql,
            "start": start_ms / 1000.0,
            "end": end_ms / 1000.0,
            "step": max(self.step_ms / 1000.0, 1.0),
        })
        url = f"{self.endpoint}/api/v1/query_range?{params}"
        with urllib.request.urlopen(url, timeout=30) as resp:
            payload = json.load(resp)
        if payload.get("status") != "success":
            raise CruiseControlError(f"prometheus query failed: {payload}")
        out = []
        for series in payload["data"]["result"]:
            values = [(float(t), float(v)) for t, v in series.get("values", [])]
            out.append(PrometheusSeries(labels=series.get("metric", {}),
                                        values=values))
        return out

    # ------------------------------------------------------------- mapping

    @staticmethod
    def _host_of(labels: Dict[str, str]) -> str:
        instance = labels.get("instance", "")
        return instance.split(":", 1)[0]

    def _broker_for(self, labels: Dict[str, str], host_map: Dict[str, int]) -> int:
        host = self._host_of(labels)
        if host not in host_map:
            raise InvalidPrometheusResultError(f"unknown instance host {host!r}")
        return host_map[host]

    def _series_value(self, series: PrometheusSeries) -> float:
        if not series.values:
            raise InvalidPrometheusResultError("empty series")
        return sum(v for _, v in series.values) / len(series.values)

    def get_samples(self, metadata, start_ms: float, end_ms: float) -> SamplerResult:
        host_map = {b.host: b.broker_id for b in metadata.brokers}
        raw: List[CruiseControlMetric] = []
        skipped = 0
        for raw_type, promql in self.query_map.items():
            try:
                results = self._query_fn(promql, start_ms, end_ms)
            except CruiseControlError:
                raise
            except Exception as e:
                raise CruiseControlError(
                    f"could not query prometheus for {raw_type.name}: {e}") from e
            for series in results:
                try:
                    broker_id = self._broker_for(series.labels, host_map)
                    value = self._series_value(series)
                    topic = series.labels.get("topic")
                    partition = series.labels.get("partition")
                    if raw_type.scope is not RawMetricScope.BROKER and not topic:
                        raise InvalidPrometheusResultError("missing topic label")
                    raw.append(CruiseControlMetric(
                        raw_type=raw_type, time_ms=end_ms, broker_id=broker_id,
                        topic=topic,
                        partition=int(partition) if partition is not None else None,
                        value=value))
                except InvalidPrometheusResultError:
                    # Frequent and legitimate (e.g. a shared Prometheus server
                    # carrying other clusters' series) — trace-level skip.
                    skipped += 1
        LOG.debug("prometheus sampler: %d metrics, %d series skipped",
                  len(raw), skipped)
        if not raw:
            return SamplerResult()
        return self.processor.process(metadata, raw, end_ms)
