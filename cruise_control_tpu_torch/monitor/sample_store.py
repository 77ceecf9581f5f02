"""Sample persistence (checkpoint/resume of monitor state).

Reference: ``monitor/sampling/SampleStore.java:19`` SPI and
``KafkaSampleStore.java:82-504`` — the reference persists accepted samples to
two Kafka topics and replays them on startup.  ``FileSampleStore`` keeps flat
JSONL per sample type with bounded retention.  The JAX package's
``LogSampleStore`` (the KafkaSampleStore shape, over the reporter's
partitioned-log transport) waits for the port's reporter.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, List, Protocol

from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.monitor.samples import BrokerMetricSample, PartitionMetricSample


def _count_stored(n: int) -> None:
    """Ingest telemetry: samples persisted to the store."""
    if n:
        registry().counter("Monitor.stored-samples").inc(n)


class SampleStore(Protocol):
    def store_samples(self, partition_samples: List[PartitionMetricSample],
                      broker_samples: List[BrokerMetricSample]) -> None: ...

    def load_samples(self,
                     on_partition: Callable[[PartitionMetricSample], None],
                     on_broker: Callable[[BrokerMetricSample], None]) -> int: ...

    def close(self) -> None: ...


class NoopSampleStore:
    def store_samples(self, partition_samples, broker_samples) -> None:
        pass

    def load_samples(self, on_partition, on_broker) -> int:
        return 0

    def close(self) -> None:
        pass


class FileSampleStore:
    """JSONL segment files: ``partition_samples.jsonl`` + ``broker_samples.jsonl``.

    Mirrors KafkaSampleStore behavior: append on store, full replay on load,
    bounded retention by rewriting when the file exceeds ``max_records``.
    """

    def __init__(self, directory: str, max_records: int = 1_000_000):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._ppath = os.path.join(directory, "partition_samples.jsonl")
        self._bpath = os.path.join(directory, "broker_samples.jsonl")
        self._lock = threading.Lock()
        self._max_records = max_records
        self._pcount = self._count_lines(self._ppath)
        self._bcount = self._count_lines(self._bpath)

    @staticmethod
    def _count_lines(path: str) -> int:
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            return sum(1 for _ in f)

    def store_samples(self, partition_samples, broker_samples) -> None:
        with self._lock:
            if partition_samples:
                with open(self._ppath, "a") as f:
                    for s in partition_samples:
                        f.write(json.dumps(s.to_dict()) + "\n")
                self._pcount += len(partition_samples)
            if broker_samples:
                with open(self._bpath, "a") as f:
                    for s in broker_samples:
                        f.write(json.dumps(s.to_dict()) + "\n")
                self._bcount += len(broker_samples)
            if self._pcount > self._max_records:
                self._truncate(self._ppath, self._max_records // 2)
                self._pcount = self._count_lines(self._ppath)
            if self._bcount > self._max_records:
                self._truncate(self._bpath, self._max_records // 2)
                self._bcount = self._count_lines(self._bpath)
        _count_stored(len(partition_samples) + len(broker_samples))

    @staticmethod
    def _truncate(path: str, keep: int) -> None:
        with open(path) as f:
            lines = f.readlines()
        with open(path, "w") as f:
            f.writelines(lines[-keep:])

    def load_samples(self, on_partition, on_broker) -> int:
        n = 0
        with self._lock:
            if os.path.exists(self._ppath):
                with open(self._ppath) as f:
                    for line in f:
                        if line.strip():
                            on_partition(PartitionMetricSample.from_dict(
                                json.loads(line)))
                            n += 1
            if os.path.exists(self._bpath):
                with open(self._bpath) as f:
                    for line in f:
                        if line.strip():
                            on_broker(BrokerMetricSample.from_dict(json.loads(line)))
                            n += 1
        return n

    def close(self) -> None:
        pass
