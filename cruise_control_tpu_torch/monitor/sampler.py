"""Metric sampling: SPI, raw-metric processor, and built-in samplers.

Reference: ``monitor/sampling/MetricSampler.java:26`` (SPI),
``CruiseControlMetricsProcessor.java:36-239`` (raw broker/topic/partition
metrics → Partition/BrokerMetricSample with derived NW/disk rates and CPU
estimation) and ``NoopSampler``.  The Kafka-consumer and Prometheus samplers
are deployment plugins behind the same SPI; tests and the demo server use the
synthetic sampler.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Protocol

import numpy as np

from cruise_control_tpu_torch.model import cpu_model
from cruise_control_tpu_torch.monitor import metric_def as md
from cruise_control_tpu_torch.monitor.metadata import ClusterMetadata
from cruise_control_tpu_torch.monitor.samples import (
    BrokerMetricSample,
    CruiseControlMetric,
    PartitionMetricSample,
    RawMetricType,
)
from cruise_control_tpu_torch.obsvc.fidelity import fidelity


@dataclass
class SamplerResult:
    partition_samples: List[PartitionMetricSample] = field(default_factory=list)
    broker_samples: List[BrokerMetricSample] = field(default_factory=list)


class MetricSampler(Protocol):
    """Reference: MetricSampler.java — pluggable sample source."""

    def get_samples(self, metadata: ClusterMetadata, start_ms: float,
                    end_ms: float) -> SamplerResult: ...


class NoopSampler:
    def get_samples(self, metadata: ClusterMetadata, start_ms: float,
                    end_ms: float) -> SamplerResult:
        return SamplerResult()


# --------------------------------------------------------------- processor


class CruiseControlMetricsProcessor:
    """Raw reporter metrics → model samples (CruiseControlMetricsProcessor).

    Derivations mirror the reference: per-partition NW rates = topic rate /
    #partitions of that topic on the broker; DISK = reported partition size;
    partition CPU via ``ModelUtils.estimateLeaderCpuUtilPerCore``.
    """

    def process(self, metadata: ClusterMetadata,
                raw_metrics: Iterable[CruiseControlMetric],
                time_ms: float) -> SamplerResult:
        by_broker: Dict[int, Dict] = {}
        for m in raw_metrics:
            b = by_broker.setdefault(m.broker_id, {
                "broker": {}, "topic": {}, "partition_size": {}})
            if m.raw_type.scope.value == "broker":
                b["broker"][m.raw_type] = m.value
            elif m.raw_type.scope.value == "topic":
                b["topic"].setdefault(m.topic, {})[m.raw_type] = m.value
            elif m.raw_type == RawMetricType.PARTITION_SIZE:
                b["partition_size"][(m.topic, m.partition)] = m.value

        result = SamplerResult()
        leaders_on_broker: Dict[int, Dict[str, int]] = {}
        for p in metadata.partitions:
            if p.leader is not None:
                leaders_on_broker.setdefault(p.leader, {}).setdefault(p.topic, 0)
                leaders_on_broker[p.leader][p.topic] += 1

        for broker_id, data in by_broker.items():
            bm = data["broker"]
            bs = BrokerMetricSample(broker_id=broker_id, time_ms=time_ms)
            self._fill_broker_sample(bs, bm)
            result.broker_samples.append(bs)

            for p in metadata.partitions:
                if p.leader != broker_id:
                    continue
                topic_metrics = data["topic"].get(p.topic, {})
                n_lead = leaders_on_broker.get(broker_id, {}).get(p.topic, 1)
                bytes_in = topic_metrics.get(RawMetricType.TOPIC_BYTES_IN, 0.0) / n_lead
                bytes_out = topic_metrics.get(RawMetricType.TOPIC_BYTES_OUT, 0.0) / n_lead
                size = data["partition_size"].get((p.topic, p.partition), 0.0)
                cpu = cpu_model.estimate_leader_cpu_util_per_core(
                    bm.get(RawMetricType.BROKER_CPU_UTIL, 0.0),
                    bm.get(RawMetricType.ALL_TOPIC_BYTES_IN, 0.0),
                    bm.get(RawMetricType.ALL_TOPIC_BYTES_OUT, 0.0),
                    bm.get(RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN, 0.0),
                    bytes_in, bytes_out)
                if cpu is None:
                    # Inconsistent sample — dropped, as in reference.
                    fidelity().on_dropped("inconsistent")
                    continue
                ps = PartitionMetricSample(broker_id=broker_id, topic=p.topic,
                                           partition=p.partition)
                ps.record(md.CPU_USAGE, cpu)
                ps.record(md.LEADER_BYTES_IN, bytes_in)
                ps.record(md.LEADER_BYTES_OUT, bytes_out)
                ps.record(md.DISK_USAGE, size)
                ps.close(time_ms)
                result.partition_samples.append(ps)
        return result

    @staticmethod
    def _fill_broker_sample(bs: BrokerMetricSample, bm: Dict) -> None:
        bdef = md.BROKER_METRIC_DEF
        mapping = {
            "CPU_USAGE": RawMetricType.BROKER_CPU_UTIL,
            "LEADER_BYTES_IN": RawMetricType.ALL_TOPIC_BYTES_IN,
            "LEADER_BYTES_OUT": RawMetricType.ALL_TOPIC_BYTES_OUT,
            "REPLICATION_BYTES_IN_RATE": RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN,
            "REPLICATION_BYTES_OUT_RATE": RawMetricType.ALL_TOPIC_REPLICATION_BYTES_OUT,
            "PRODUCE_RATE": RawMetricType.ALL_TOPIC_PRODUCE_REQUEST_RATE,
            "FETCH_RATE": RawMetricType.ALL_TOPIC_FETCH_REQUEST_RATE,
            "MESSAGE_IN_RATE": RawMetricType.ALL_TOPIC_MESSAGES_IN_PER_SEC,
            "BROKER_PRODUCE_REQUEST_RATE": RawMetricType.BROKER_PRODUCE_REQUEST_RATE,
            "BROKER_CONSUMER_FETCH_REQUEST_RATE":
                RawMetricType.BROKER_CONSUMER_FETCH_REQUEST_RATE,
            "BROKER_FOLLOWER_FETCH_REQUEST_RATE":
                RawMetricType.BROKER_FOLLOWER_FETCH_REQUEST_RATE,
            "BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT":
                RawMetricType.BROKER_REQUEST_HANDLER_AVG_IDLE_PERCENT,
            "BROKER_REQUEST_QUEUE_SIZE": RawMetricType.BROKER_REQUEST_QUEUE_SIZE,
            "BROKER_RESPONSE_QUEUE_SIZE": RawMetricType.BROKER_RESPONSE_QUEUE_SIZE,
            "BROKER_LOG_FLUSH_RATE": RawMetricType.BROKER_LOG_FLUSH_RATE,
            "BROKER_LOG_FLUSH_TIME_MS_MEAN": RawMetricType.BROKER_LOG_FLUSH_TIME_MS_MEAN,
            "BROKER_LOG_FLUSH_TIME_MS_MAX": RawMetricType.BROKER_LOG_FLUSH_TIME_MS_MAX,
        }
        for name, raw in mapping.items():
            if raw in bm:
                bs.record(bdef.metric_id(name), bm[raw])


# ---------------------------------------------------------- synthetic source

# Shared demo-workload constants + jitter, used by BOTH the synthetic sampler
# and the reporter pipeline's DemoBrokerMetricsSource so the two demo modes
# produce comparable load shapes.
DEMO_MEAN_BYTES_IN = 1000.0
DEMO_MEAN_BYTES_OUT = 800.0
DEMO_MEAN_SIZE = 5000.0
DEMO_CPU_PER_LEADER = 0.4
DEMO_SEED = 7


def synthetic_jitter(key, seed: int = DEMO_SEED) -> float:
    """Deterministic per-entity workload jitter in [0.8, 1.2)."""
    rng = np.random.default_rng((hash(key) ^ seed) & 0x7FFFFFFF)
    return 0.8 + 0.4 * rng.random()


class SyntheticWorkloadSampler:
    """Deterministic workload generator behind the MetricSampler SPI —
    the in-process stand-in for the metrics-reporter + Kafka pipeline
    (plays the role the embedded-broker harness plays in reference tests)."""

    def __init__(self, mean_bytes_in: float = DEMO_MEAN_BYTES_IN,
                 mean_bytes_out: float = DEMO_MEAN_BYTES_OUT,
                 mean_size: float = DEMO_MEAN_SIZE,
                 cpu_per_partition: float = DEMO_CPU_PER_LEADER,
                 seed: int = DEMO_SEED):
        self.mean_bytes_in = mean_bytes_in
        self.mean_bytes_out = mean_bytes_out
        self.mean_size = mean_size
        self.cpu_per_partition = cpu_per_partition
        self.seed = seed

    def get_samples(self, metadata: ClusterMetadata, start_ms: float,
                    end_ms: float) -> SamplerResult:
        result = SamplerResult()
        t = end_ms
        for p in metadata.partitions:
            if p.leader is None:
                continue
            jitter = synthetic_jitter((p.topic, p.partition), self.seed)
            ps = PartitionMetricSample(broker_id=p.leader, topic=p.topic,
                                       partition=p.partition)
            ps.record(md.CPU_USAGE, self.cpu_per_partition * jitter)
            ps.record(md.LEADER_BYTES_IN, self.mean_bytes_in * jitter)
            ps.record(md.LEADER_BYTES_OUT, self.mean_bytes_out * jitter)
            ps.record(md.DISK_USAGE, self.mean_size * jitter)
            ps.close(t)
            result.partition_samples.append(ps)
        bdef = md.BROKER_METRIC_DEF
        for b in metadata.brokers:
            if not b.alive:
                continue
            bs = BrokerMetricSample(broker_id=b.broker_id, time_ms=t)
            leaders = [p for p in metadata.partitions if p.leader == b.broker_id]
            bs.record(bdef.metric_id("CPU_USAGE"),
                      self.cpu_per_partition * max(len(leaders), 1))
            bs.record(bdef.metric_id("LEADER_BYTES_IN"),
                      self.mean_bytes_in * len(leaders))
            bs.record(bdef.metric_id("LEADER_BYTES_OUT"),
                      self.mean_bytes_out * len(leaders))
            result.broker_samples.append(bs)
        return result
