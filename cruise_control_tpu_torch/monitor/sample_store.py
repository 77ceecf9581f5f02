"""Sample persistence (checkpoint/resume of monitor state).

Reference: ``monitor/sampling/SampleStore.java:19`` SPI and
``KafkaSampleStore.java:82-504`` — the reference persists accepted samples to
two Kafka topics and replays them on startup.  Two built-in implementations,
the JAX package's: ``FileSampleStore`` (flat JSONL per sample type, bounded
retention) and ``LogSampleStore`` (the KafkaSampleStore shape — two
partitioned-log ``Transport`` topics with an N-consumer reload pool; the
service wires it whenever ``sample.store.dir`` + reporter mode are both set).
Both write the JAX package's files, so either package replays the other's
store directory.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Callable, Dict, List, Protocol, Tuple

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


class LogSampleStore:
    """Sample store over the partitioned-log ``Transport`` SPI — the
    KafkaSampleStore shape (``KafkaSampleStore.java:82-504``).

    The reference persists accepted samples to TWO Kafka topics (partition
    samples + broker/model-training samples), partitioned by entity hash,
    and on startup replays both with a pool of N consumers, each owning a
    round-robin slice of the partitions.  Here the two topics are two
    ``Transport`` logs (same SPI the metrics reporter publishes over, so a
    FileTransport directory gives durable restart/resume), the partitioner
    is the same entity hash, and the reload pool is ``num_loaders`` threads
    polling their partition slice — applies are serialized through one lock,
    in time order (``load_samples``), because unlike the reference's
    aggregator ours makes no thread-safety promise and drops samples of
    windows it has closed.  Retention: a partition past
    ``max_records_per_partition`` is trimmed to half of it (Kafka topic
    retention in the reference).
    """

    def __init__(self, partition_transport, broker_transport,
                 num_loaders: int = 8,
                 max_records_per_partition: int = 100_000):
        self._pt = partition_transport
        self._bt = broker_transport
        self.num_loaders = max(1, num_loaders)
        self._apply_lock = threading.Lock()
        # Retention (the role Kafka topic retention plays for the
        # reference's sample topics): without it the logs — and every
        # restart's replay — grow linearly with service age.  Counts are
        # tracked in memory after a lazy initial scan; partitions are
        # trimmed to half the cap when they exceed it.
        self.max_records_per_partition = max_records_per_partition
        self._counts: Dict[Tuple[int, int], int] = {}

    def store_samples(self, partition_samples, broker_samples) -> None:
        for s in partition_samples:
            # Stable entity hash (NOT the salted builtin hash(), which moves
            # every entity to a new partition each process generation and
            # breaks the per-entity single-partition ordering on replay).
            key = zlib.crc32(f"{s.topic}-{s.partition}".encode("utf-8"))
            self._append(self._pt, 0, key % self._pt.num_partitions,
                         json.dumps(s.to_dict()).encode("utf-8"))
        for s in broker_samples:
            self._append(self._bt, 1, s.broker_id % self._bt.num_partitions,
                         json.dumps(s.to_dict()).encode("utf-8"))
        _count_stored(len(partition_samples) + len(broker_samples))

    def _append(self, transport, tid: int, partition: int, record: bytes) -> None:
        transport.append(partition, record)
        if not hasattr(transport, "truncate_tail"):
            return
        key = (tid, partition)
        with self._apply_lock:
            n = self._counts.get(key)
            if n is None:
                # Lazy scan AFTER the append above — already includes it.
                n = transport.record_count(partition)
            else:
                n += 1
            if n > self.max_records_per_partition:
                transport.truncate_tail(partition,
                                        self.max_records_per_partition // 2)
                n = self.max_records_per_partition // 2
            self._counts[key] = n

    def load_samples(self, on_partition, on_broker) -> int:
        """Replay both logs: ``num_loaders`` threads per log poll and parse
        their round-robin slice of its partitions, then the applies run
        under one lock in time order.

        Each log partition is in time order, so the time-ordered merge is
        one of the interleavings the JAX package's loader threads (which
        apply as they parse) may take, and the one in which the aggregator
        drops nothing: it closes a window once a newer sample arrives, and
        rejects later samples of closed windows, so a loader that ran ahead
        would have the other loaders' older samples dropped as out of
        order."""
        from cruise_control_tpu_torch.monitor.fetcher import (
            DefaultMetricSamplerPartitionAssignor as assignor,
        )

        def drain(transport, partitions, parse, out):
            for p in partitions:
                offset = 0
                while True:
                    records, offset = transport.poll(p, offset)
                    if not records:
                        break
                    out.extend(parse(json.loads(rec.decode("utf-8"))) for rec in records)

        threads = []
        streams = []
        for transport, parse, apply in (
                (self._pt, PartitionMetricSample.from_dict, on_partition),
                (self._bt, BrokerMetricSample.from_dict, on_broker)):
            parsed: List[list] = []
            for part_set in assignor.assign(transport.num_partitions,
                                            self.num_loaders):
                if not part_set:
                    continue
                parsed.append([])
                t = threading.Thread(target=drain,
                                     args=(transport, part_set, parse, parsed[-1]),
                                     daemon=True)
                t.start()
                threads.append(t)
            streams.append((parsed, apply))
        for t in threads:
            t.join()
        total = 0
        with self._apply_lock:
            for parsed, apply in streams:
                # A stable sort keeps each partition's own order among equal times.
                for sample in sorted((s for part in parsed for s in part),
                                     key=lambda s: s.time_ms):
                    apply(sample)
                    total += 1
        return total

    def close(self) -> None:
        pass
