"""Cluster topology metadata.

Reference: ``common/MetadataClient.java:1-177`` — cached cluster metadata with
TTL and a generation counter that drives model staleness.  The Kafka
``Cluster`` object becomes plain dataclasses; the network client becomes a
pluggable backend (a fake in tests, a real Kafka admin driver in production
deployments — same seam the executor uses).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Tuple


@dataclass(frozen=True)
class BrokerInfo:
    broker_id: int
    rack: str
    host: str
    alive: bool = True


@dataclass(frozen=True)
class PartitionInfo:
    topic: str
    partition: int
    leader: Optional[int]            # broker id, None if leaderless
    replicas: Tuple[int, ...]        # replica-list order (index 0 = preferred)
    in_sync: Tuple[int, ...] = ()
    offline: Tuple[int, ...] = ()


@dataclass
class ClusterMetadata:
    brokers: List[BrokerInfo]
    partitions: List[PartitionInfo]
    generation: int = 0

    def broker_ids(self) -> List[int]:
        return [b.broker_id for b in self.brokers]

    def alive_broker_ids(self) -> List[int]:
        return [b.broker_id for b in self.brokers if b.alive]

    def partitions_of(self, topic: str) -> List[PartitionInfo]:
        return [p for p in self.partitions if p.topic == topic]

    def topics(self) -> List[str]:
        seen, out = set(), []
        for p in self.partitions:
            if p.topic not in seen:
                seen.add(p.topic)
                out.append(p.topic)
        return out

    def partition_count(self, topic: str) -> int:
        return sum(1 for p in self.partitions if p.topic == topic)


class MetadataBackend(Protocol):
    """Where metadata comes from (fake in tests; Kafka driver in prod)."""

    def fetch(self) -> ClusterMetadata: ...


class MetadataClient:
    """TTL cache + generation counter over a MetadataBackend."""

    def __init__(self, backend: MetadataBackend, ttl_ms: int = 5_000,
                 clock=time.monotonic):
        self._backend = backend
        self._ttl_s = ttl_ms / 1000.0
        self._clock = clock
        self._lock = threading.Lock()
        self._cached: Optional[ClusterMetadata] = None
        self._fetched_at = -float("inf")
        self._generation = 0

    @property
    def generation(self) -> int:
        return self._generation

    def refresh_metadata(self, force: bool = False) -> ClusterMetadata:
        with self._lock:
            now = self._clock()
            if force or self._cached is None or now - self._fetched_at > self._ttl_s:
                fresh = self._backend.fetch()
                if self._cached is None or _changed(self._cached, fresh):
                    self._generation += 1
                fresh.generation = self._generation
                self._cached = fresh
                self._fetched_at = now
            return self._cached

    def cluster(self) -> ClusterMetadata:
        return self.refresh_metadata()


def _changed(old: ClusterMetadata, new: ClusterMetadata) -> bool:
    return (old.brokers != new.brokers) or (old.partitions != new.partitions)


class FakeMetadataBackend:
    """Mutable in-process topology for tests (plays the embedded-broker role
    from the reference's CCKafkaIntegrationTestHarness)."""

    def __init__(self, brokers: List[BrokerInfo], partitions: List[PartitionInfo]):
        self.brokers = list(brokers)
        self.partitions = list(partitions)
        self._lock = threading.Lock()
        # (topic, partition) -> positions in ``partitions``, for the list it
        # was built from: a reassignment then replaces its rows in O(1)
        # Python steps where a scan would take O(partitions) (an executor
        # applies thousands of them against tens of thousands of partitions).
        self._index: Dict[Tuple[str, int], List[int]] = {}
        self._indexed: Optional[List[PartitionInfo]] = None

    def fetch(self) -> ClusterMetadata:
        with self._lock:
            return ClusterMetadata(brokers=list(self.brokers),
                                   partitions=list(self.partitions))

    def kill_broker(self, broker_id: int) -> None:
        with self._lock:
            self.brokers = [
                BrokerInfo(b.broker_id, b.rack, b.host, alive=False)
                if b.broker_id == broker_id else b for b in self.brokers]

    def set_partitions(self, partitions: List[PartitionInfo]) -> None:
        with self._lock:
            self.partitions = list(partitions)

    def apply_reassignment(self, topic: str, partition: int,
                           new_replicas: Tuple[int, ...],
                           new_leader: Optional[int] = None) -> None:
        with self._lock:
            if self._indexed is not self.partitions:
                self._index = {}
                for i, p in enumerate(self.partitions):
                    self._index.setdefault((p.topic, p.partition), []).append(i)
            out = list(self.partitions)
            for i in self._index.get((topic, partition), ()):
                out[i] = PartitionInfo(
                    topic=topic, partition=partition,
                    leader=new_leader if new_leader is not None else new_replicas[0],
                    replicas=tuple(new_replicas),
                    in_sync=tuple(new_replicas))
            self.partitions = self._indexed = out
