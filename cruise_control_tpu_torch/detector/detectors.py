"""The six anomaly detectors.

Reference classes, mapped one-to-one:
- ``GoalViolationDetector.java:51-290``  — fresh model per completeness tier,
  violated = detection goal produces proposals; balancedness score.
- ``BrokerFailureDetector.java:44-233``  — liveness watch + persisted
  failed-broker list with first-failure timestamps.
- ``DiskFailureDetector.java:1-118``     — offline-logdir scan.
- ``MetricAnomalyDetector.java`` + ``SlowBrokerFinder.java:1-478`` —
  percentile history checks; slow brokers vs peers and own history.
- ``TopicAnomalyDetector.java`` + RF/partition-size finders.
- ``MaintenanceEventDetector.java`` + idempotence cache.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_ANOMALY_DETECTION_GOALS
from cruise_control_tpu_torch.common.exceptions import (
    NotEnoughValidWindowsError,
    OptimizationFailureError,
)
from cruise_control_tpu_torch.detector.anomalies import (
    Anomaly,
    BrokerFailures,
    DiskFailures,
    GoalViolations,
    MaintenanceEvent,
    MetricAnomaly,
    TopicAnomaly,
)
from cruise_control_tpu_torch.monitor import metric_def as md
from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor

LOG = logging.getLogger(__name__)


class GoalViolationDetector:
    """Runs the anomaly-detection goals over a fresh snapshot, frozen onto
    ``device`` (the card unless the caller asks for another); each goal is
    one solve there."""

    def __init__(self, load_monitor: LoadMonitor,
                 goal_names: Optional[Sequence[str]] = None,
                 excluded_topics: Optional[Set[str]] = None,
                 device="cuda"):
        self.load_monitor = load_monitor
        self.device = device
        self.goal_names = list(goal_names or DEFAULT_ANOMALY_DETECTION_GOALS)
        self.excluded_topics = frozenset(excluded_topics or ())
        self._last_generation = None
        self.last_balancedness_score: float = 100.0

    def detect(self) -> List[Anomaly]:
        # Refresh first so the recorded generation reflects current topology.
        self.load_monitor.metadata_client.refresh_metadata()
        generation = self.load_monitor.model_generation
        if generation == self._last_generation:
            return []     # :114-121 — skip unchanged models
        self._last_generation = generation
        try:
            state, placement, meta = self.load_monitor.cluster_model(
                pad_replicas_to=64, pad_brokers_to=8, device=self.device)
        except NotEnoughValidWindowsError:
            return []
        fixable: List[str] = []
        unfixable: List[str] = []
        options = OptimizationOptions(
            excluded_topics=self.excluded_topics,
            is_triggered_by_goal_violation=True,
            only_move_immigrant_replicas=False)
        for name in self.goal_names:
            optimizer = GoalOptimizer(goal_names=[name])
            try:
                result = optimizer.optimizations(state, placement, meta,
                                                 options=options)
            except OptimizationFailureError:
                unfixable.append(name)
                continue
            if result.proposals:
                fixable.append(name)
        if not fixable and not unfixable:
            self.last_balancedness_score = 100.0
            return []
        total = len(self.goal_names) or 1
        self.last_balancedness_score = 100.0 * (
            1 - (len(fixable) + len(unfixable)) / total)
        return [GoalViolations(fixable=fixable, unfixable=unfixable)]


class BrokerFailureDetector:
    """Liveness diff + durable failed-broker record (the reference persists
    to a ZK znode :118; here a JSON file plays that role)."""

    def __init__(self, metadata_client, persist_path: Optional[str] = None,
                 clock=lambda: time.time() * 1000):
        self.metadata_client = metadata_client
        self.persist_path = persist_path
        self._clock = clock
        self._failed: Dict[int, float] = {}
        if persist_path and os.path.exists(persist_path):
            try:
                with open(persist_path) as f:
                    self._failed = {int(k): v for k, v in json.load(f).items()}
            except (ValueError, OSError):
                LOG.warning("could not load failed-broker record", exc_info=True)

    def detect(self) -> List[Anomaly]:
        metadata = self.metadata_client.refresh_metadata(force=True)
        now = self._clock()
        dead = {b.broker_id for b in metadata.brokers if not b.alive}
        changed = False
        for b in dead:
            if b not in self._failed:
                self._failed[b] = now
                changed = True
        for b in list(self._failed):
            if b not in dead:
                del self._failed[b]
                changed = True
        if changed:
            self._persist()
        if not self._failed:
            return []
        return [BrokerFailures(failed_brokers=dict(self._failed))]

    def _persist(self) -> None:
        if not self.persist_path:
            return
        with open(self.persist_path, "w") as f:
            json.dump({str(k): v for k, v in self._failed.items()}, f)

    @property
    def failed_brokers(self) -> Dict[int, float]:
        return dict(self._failed)


class DiskFailureDetector:
    """Offline-logdir scan via an injectable provider (the reference queries
    AdminClient.describeLogDirs)."""

    def __init__(self, offline_disks_provider: Callable[[], Dict[int, List[int]]]):
        self.provider = offline_disks_provider

    def detect(self) -> List[Anomaly]:
        offline = {b: list(d) for b, d in (self.provider() or {}).items() if d}
        if not offline:
            return []
        return [DiskFailures(failed_disks=offline)]


class MetricAnomalyDetector:
    """Percentile-based broker metric anomalies + SlowBrokerFinder.

    SlowBrokerFinder.java:40-80: a broker is slow when its log-flush time is
    high vs its own history AND vs its peers; repeated slowness escalates
    from check to demote to remove.
    """

    def __init__(self, broker_aggregator, percentile: float = 95.0,
                 margin: float = 1.5,
                 metric_names: Sequence[str] = ("BROKER_LOG_FLUSH_TIME_MS_MEAN",),
                 slow_broker_demotion_score: int = 2,
                 slow_broker_removal_score: int = 5):
        self.agg = broker_aggregator
        self.percentile = percentile
        self.margin = margin
        self.metric_ids = [md.BROKER_METRIC_DEF.metric_id(n) for n in metric_names]
        self.metric_names = list(metric_names)
        self._slow_scores: Dict[int, int] = {}
        self.demotion_score = slow_broker_demotion_score
        self.removal_score = slow_broker_removal_score

    def detect(self) -> List[Anomaly]:
        try:
            result = self.agg.aggregate(-float("inf"), float("inf"))
        except NotEnoughValidWindowsError:
            return []
        vae = result.values_and_extrapolations
        if len(vae) < 2:
            return []
        out: List[Anomaly] = []
        for mid, name in zip(self.metric_ids, self.metric_names):
            latest = {b: v.values[mid, -1] for b, v in vae.items()}
            history = {b: v.values[mid, :-1] for b, v in vae.items()
                       if v.values.shape[1] > 1}
            peer_median = float(np.median(list(latest.values())))
            slow_now: Set[int] = set()
            for b, value in latest.items():
                hist = history.get(b)
                own_thresh = (np.percentile(hist, self.percentile) * self.margin
                              if hist is not None and hist.size else np.inf)
                peer_thresh = peer_median * self.margin
                if value > peer_thresh and (hist is None or value > own_thresh
                                            or not hist.size):
                    slow_now.add(b)
                    score = self._slow_scores.get(b, 0) + 1
                    self._slow_scores[b] = score
                    action = ("remove" if score >= self.removal_score
                              else "demote" if score >= self.demotion_score
                              else "check")
                    out.append(MetricAnomaly(
                        broker_id=b, metric_name=name, current_value=float(value),
                        threshold=float(min(own_thresh, peer_thresh)),
                        suggested_action=action))
            for b in list(self._slow_scores):
                if b not in slow_now:
                    self._slow_scores[b] = max(self._slow_scores[b] - 1, 0)
        return out


class TopicAnomalyDetector:
    """RF and partition-size violations (TopicReplicationFactorAnomalyFinder
    :283, PartitionSizeAnomalyFinder :129)."""

    def __init__(self, metadata_client, partition_aggregator=None,
                 target_replication_factor: Optional[int] = None,
                 max_partition_size_bytes: Optional[float] = None):
        self.metadata_client = metadata_client
        self.partition_aggregator = partition_aggregator
        self.target_rf = target_replication_factor
        self.max_partition_size = max_partition_size_bytes

    def detect(self) -> List[Anomaly]:
        out: List[Anomaly] = []
        metadata = self.metadata_client.refresh_metadata()
        if self.target_rf is not None:
            bad_topics: Dict[str, int] = {}
            for p in metadata.partitions:
                if len(p.replicas) != self.target_rf:
                    bad_topics[p.topic] = len(p.replicas)
            for topic, rf in bad_topics.items():
                out.append(TopicAnomaly(
                    topic=topic,
                    reason=f"replication factor {rf} != target {self.target_rf}",
                    target_replication_factor=self.target_rf))
        if self.max_partition_size is not None and self.partition_aggregator:
            try:
                result = self.partition_aggregator.aggregate(-float("inf"),
                                                             float("inf"))
            except NotEnoughValidWindowsError:
                return out
            for (topic, part), vae in result.values_and_extrapolations.items():
                size = float(vae.values[md.DISK_USAGE, -1])
                if size > self.max_partition_size:
                    out.append(TopicAnomaly(
                        topic=topic,
                        reason=f"partition {part} size {size:.0f} exceeds "
                               f"{self.max_partition_size:.0f}"))
        return out


class MaintenanceEventDetector:
    """User-submitted plans with idempotence (MaintenanceEventTopicReader +
    IdempotenceCache; the Kafka topic becomes an in-process queue that a REST
    endpoint or file watcher feeds)."""

    def __init__(self, idempotence_ttl_ms: float = 60_000,
                 clock=lambda: time.time() * 1000):
        self._queue: List[MaintenanceEvent] = []
        self._lock = threading.Lock()
        self._seen: Dict[Tuple, float] = {}
        self._ttl = idempotence_ttl_ms
        self._clock = clock

    def submit(self, event: MaintenanceEvent) -> bool:
        with self._lock:
            now = self._clock()
            for k, t in list(self._seen.items()):
                if now - t > self._ttl:
                    del self._seen[k]
            if event.key() in self._seen:
                return False
            self._seen[event.key()] = now
            self._queue.append(event)
            return True

    def detect(self) -> List[Anomaly]:
        with self._lock:
            out, self._queue = self._queue, []
            return list(out)
