"""Broker-side metrics-reporter agent (the JAX package's ``reporter/agent.py``;
the demo source emits the same records in the same order).

Reference: ``CruiseControlMetricsReporter.java:61-392`` — a per-broker agent
that snapshots the broker's metric registry every reporting interval,
converts it to typed raw metrics (``YammerMetricProcessor``/
``MetricsUtils``), serializes them and publishes to the metrics topic.  Here
the registry is a ``BrokerMetricsSource`` SPI (a real deployment adapts its
metrics system; the demo source derives a full 63-type payload from the
in-process fake cluster), and publishing goes through the ``Transport`` SPI
partitioned by broker id.
"""

from __future__ import annotations

import threading
from typing import Iterable, List, Protocol

from cruise_control_tpu_torch.monitor.samples import (
    CruiseControlMetric,
    RawMetricScope,
    RawMetricType,
)
from cruise_control_tpu_torch.reporter.serde import serialize_metric
from cruise_control_tpu_torch.reporter.transport import Transport


class BrokerMetricsSource(Protocol):
    """Adapts a broker's local metric registry to typed raw metrics."""

    def collect(self, broker_id: int, time_ms: float) -> Iterable[CruiseControlMetric]: ...


class MetricsReporter:
    """One broker's reporting loop (start()/stop(); report_once() for tests
    and for in-process demo clusters driven by the task runner's clock)."""

    def __init__(self, broker_id: int, source: BrokerMetricsSource,
                 transport: Transport, reporting_interval_ms: float = 60_000.0,
                 clock=None):
        import time as _time
        self.broker_id = broker_id
        self.source = source
        self.transport = transport
        self.interval_ms = reporting_interval_ms
        self._clock = clock or (lambda: _time.time() * 1000.0)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.records_reported = 0

    def report_once(self, time_ms: float | None = None) -> int:
        now = self._clock() if time_ms is None else time_ms
        n = 0
        for metric in self.source.collect(self.broker_id, now):
            self.transport.append(self.broker_id % self.transport.num_partitions,
                                  serialize_metric(metric))
            n += 1
        self.records_reported += n
        return n

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_ms / 1000.0):
                self.report_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"metrics-reporter-{self.broker_id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class DemoBrokerMetricsSource:
    """Derives the full 63-type payload from the in-process fake cluster
    (plays the role of YammerMetricProcessor over a real broker registry)."""

    def __init__(self, metadata_backend, mean_bytes_in: float | None = None,
                 mean_bytes_out: float | None = None,
                 mean_size: float | None = None,
                 cpu_per_leader: float | None = None, seed: int | None = None):
        from cruise_control_tpu_torch.monitor import sampler as _s
        self.backend = metadata_backend
        self.mean_bytes_in = _s.DEMO_MEAN_BYTES_IN if mean_bytes_in is None else mean_bytes_in
        self.mean_bytes_out = _s.DEMO_MEAN_BYTES_OUT if mean_bytes_out is None else mean_bytes_out
        self.mean_size = _s.DEMO_MEAN_SIZE if mean_size is None else mean_size
        self.cpu_per_leader = _s.DEMO_CPU_PER_LEADER if cpu_per_leader is None else cpu_per_leader
        self.seed = _s.DEMO_SEED if seed is None else seed

    def collect(self, broker_id: int, time_ms: float) -> List[CruiseControlMetric]:
        from cruise_control_tpu_torch.monitor.sampler import synthetic_jitter
        meta = self.backend.fetch()
        out: List[CruiseControlMetric] = []

        def emit(t, value, topic=None, partition=None):
            out.append(CruiseControlMetric(raw_type=t, time_ms=time_ms,
                                           broker_id=broker_id, topic=topic,
                                           partition=partition, value=value))

        led = [p for p in meta.partitions if p.leader == broker_id]
        followed = [p for p in meta.partitions
                    if broker_id in p.replicas and p.leader != broker_id]
        by_topic = {}
        for p in led:
            by_topic.setdefault(p.topic, []).append(p)

        def jitter(key):
            return synthetic_jitter(key, self.seed)

        total_in = total_out = 0.0
        for topic, parts in by_topic.items():
            t_in = sum(self.mean_bytes_in * jitter((t.topic, t.partition))
                       for t in parts)
            t_out = sum(self.mean_bytes_out * jitter((t.topic, t.partition))
                        for t in parts)
            total_in += t_in
            total_out += t_out
            emit(RawMetricType.TOPIC_BYTES_IN, t_in, topic=topic)
            emit(RawMetricType.TOPIC_BYTES_OUT, t_out, topic=topic)
            emit(RawMetricType.TOPIC_REPLICATION_BYTES_IN, t_in * 0.5, topic=topic)
            emit(RawMetricType.TOPIC_REPLICATION_BYTES_OUT, t_out * 0.5, topic=topic)
            emit(RawMetricType.TOPIC_PRODUCE_REQUEST_RATE, len(parts) * 5.0, topic=topic)
            emit(RawMetricType.TOPIC_FETCH_REQUEST_RATE, len(parts) * 8.0, topic=topic)
            emit(RawMetricType.TOPIC_MESSAGES_IN_PER_SEC, t_in / 100.0, topic=topic)

        for p in led + followed:
            emit(RawMetricType.PARTITION_SIZE,
                 self.mean_size * jitter((p.topic, p.partition)),
                 topic=p.topic, partition=p.partition)

        repl_in = self.mean_bytes_in * len(followed)
        emit(RawMetricType.ALL_TOPIC_BYTES_IN, total_in)
        emit(RawMetricType.ALL_TOPIC_BYTES_OUT, total_out)
        emit(RawMetricType.ALL_TOPIC_REPLICATION_BYTES_IN, repl_in)
        emit(RawMetricType.ALL_TOPIC_REPLICATION_BYTES_OUT, repl_in)
        emit(RawMetricType.BROKER_CPU_UTIL, self.cpu_per_leader * max(len(led), 1))
        emit(RawMetricType.ALL_TOPIC_PRODUCE_REQUEST_RATE, len(led) * 5.0)
        emit(RawMetricType.ALL_TOPIC_FETCH_REQUEST_RATE, len(led) * 8.0)
        emit(RawMetricType.ALL_TOPIC_MESSAGES_IN_PER_SEC, total_in / 100.0)

        # The remaining broker-health gauges: emit every type in the
        # inventory so the wire carries the reporter's complete schema.
        emitted = {m.raw_type for m in out}
        for t in RawMetricType:
            if t in emitted or t.scope is not RawMetricScope.BROKER:
                continue
            base = 10.0 if "QUEUE" in t.name else 1.0
            emit(t, base * jitter((t.name,)))
        return out
