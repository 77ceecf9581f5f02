"""LoadMonitor: samples + metadata → frozen cluster snapshots on demand
(the JAX package's ``monitor/load_monitor.py``; the freeze lands on the
caller's device, the card by default).

Reference: ``monitor/LoadMonitor.java:78-796`` — wiring of aggregators,
metadata client and capacity resolver (ctor :124-191), the
``clusterModel(from, to, requirements, …)`` path :530-582 (aggregate →
populate capacities :477-514 → per-partition load population via
``MonitorUtils.populatePartitionLoad`` :382-447), completeness gating
:630-643, and the fair semaphore bounding concurrent model generations
:378-389.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.builder import ClusterModel
from cruise_control_tpu_torch.model.state import ClusterMeta, ClusterState, Placement
from cruise_control_tpu_torch.monitor import metric_def as md
from cruise_control_tpu_torch.monitor.aggregator import (
    AggregationOptions,
    MetricSampleAggregator,
)
from cruise_control_tpu_torch.monitor.capacity import (
    BrokerCapacityConfigResolver,
    FixedBrokerCapacityResolver,
)
from cruise_control_tpu_torch.monitor.metadata import ClusterMetadata, MetadataClient


@dataclass(frozen=True)
class ModelCompletenessRequirements:
    """Reference: monitor/ModelCompletenessRequirements.java."""

    min_required_num_windows: int = 1
    min_monitored_partitions_percentage: float = 0.0
    include_all_topics: bool = False

    def stronger(self, other: "ModelCompletenessRequirements"
                 ) -> "ModelCompletenessRequirements":
        return ModelCompletenessRequirements(
            max(self.min_required_num_windows, other.min_required_num_windows),
            max(self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage),
            self.include_all_topics or other.include_all_topics)


@dataclass
class LoadMonitorState:
    state: str
    num_valid_windows: int
    monitored_partitions_percentage: float
    total_num_partitions: int
    generation: int

    def to_dict(self) -> Dict:
        return {
            "state": self.state,
            "numValidWindows": self.num_valid_windows,
            "monitoredPartitionsPercentage":
                round(self.monitored_partitions_percentage * 100.0, 3),
            "totalNumPartitions": self.total_num_partitions,
            "generation": self.generation,
        }


class LoadMonitor:
    """Turns windowed samples + metadata into analyzer-ready snapshots."""

    def __init__(
        self,
        metadata_client: MetadataClient,
        capacity_resolver: Optional[BrokerCapacityConfigResolver] = None,
        num_windows: int = 5,
        window_ms: int = 300_000,
        min_samples_per_window: int = 1,
        max_concurrent_model_generations: int = 2,
        num_broker_windows: int = 20,
        broker_window_ms: Optional[int] = None,
    ):
        self.metadata_client = metadata_client
        self.capacity_resolver = capacity_resolver or FixedBrokerCapacityResolver(
            {Resource.CPU: 100.0, Resource.NW_IN: 300_000.0,
             Resource.NW_OUT: 200_000.0, Resource.DISK: 300_000.0})
        self.partition_aggregator = MetricSampleAggregator(
            md.COMMON_METRIC_DEF, num_windows=num_windows, window_ms=window_ms,
            min_samples_per_window=min_samples_per_window,
            group_of=lambda e: e[0])     # group = topic
        self.broker_aggregator = MetricSampleAggregator(
            md.BROKER_METRIC_DEF, num_windows=num_broker_windows,
            window_ms=broker_window_ms or window_ms,
            min_samples_per_window=min_samples_per_window)
        # Fair semaphore bounding concurrent model generations (:163-166).
        self._model_semaphore = threading.BoundedSemaphore(
            max_concurrent_model_generations)
        self._resource_matrix = md.COMMON_METRIC_DEF.resource_matrix()
        # Resident-builder bookkeeping (resident_model_builder): one kept
        # ClusterModel that is *updated in place* between requests so the
        # resident model service can ingest deltas instead of re-freezing.
        self._resident_builder: Optional[ClusterModel] = None
        self._resident_fp = None
        self._resident_loads: Dict[Tuple[str, int], np.ndarray] = {}
        self._resident_alive: Dict[int, bool] = {}
        self._register_sensors()

    def _register_sensors(self) -> None:
        """LoadMonitor sensors (Sensors.md: valid-windows,
        total-monitored-windows, monitored-partitions-percentage, num-topics,
        num-partitions-with-extrapolations, cluster-model-creation-timer).

        Completeness runs one full aggregation pass — a scrape samples five
        gauges, so the result is cached for a few seconds instead of being
        recomputed per gauge."""
        reg = registry()
        cache = {"at": 0.0, "value": None}
        cache_lock = threading.Lock()

        def completeness():
            now = time.monotonic()
            with cache_lock:
                if cache["value"] is None or now - cache["at"] > 5.0:
                    cache["value"] = self.partition_aggregator.completeness(
                        -float("inf"), time.time() * 1000)
                    cache["at"] = now
                return cache["value"]

        reg.gauge("LoadMonitor.valid-windows",
                  lambda: len(completeness().valid_windows))
        reg.gauge("LoadMonitor.total-monitored-windows",
                  lambda: self.partition_aggregator.num_available_windows())
        reg.gauge("LoadMonitor.monitored-partitions-percentage",
                  lambda: round(completeness().valid_entity_ratio * 100.0, 3))
        reg.gauge("LoadMonitor.num-valid-partitions",
                  lambda: completeness().num_valid_entities)
        reg.gauge("LoadMonitor.num-partitions-with-extrapolations",
                  lambda: completeness().num_valid_entities_with_extrapolations)
        reg.gauge("LoadMonitor.num-topics",
                  lambda: len({p.topic for p in
                               self.metadata_client.cluster().partitions}))
        self._model_timer = reg.timer("LoadMonitor.cluster-model-creation-timer")

    # ---------------------------------------------------------- generation

    @property
    def model_generation(self) -> Tuple[int, int]:
        return (self.metadata_client.generation, self.partition_aggregator.generation)

    def acquire_for_model_generation(self):
        """Context manager bounding concurrent snapshot builds."""
        sem = self._model_semaphore

        class _Ctx:
            def __enter__(self):
                sem.acquire()
                return self

            def __exit__(self, *exc):
                sem.release()
                return False

        return _Ctx()

    # -------------------------------------------------------- completeness

    def meet_completeness_requirements(
            self, requirements: ModelCompletenessRequirements) -> bool:
        """Reference: LoadMonitor.meetCompletenessRequirements :630-643."""
        now = time.time() * 1000
        completeness = self.partition_aggregator.completeness(-float("inf"), now)
        if len(completeness.valid_windows) < requirements.min_required_num_windows:
            return False
        return (completeness.valid_entity_ratio
                >= requirements.min_monitored_partitions_percentage)

    def monitored_partitions_percentage(self) -> float:
        now = time.time() * 1000
        completeness = self.partition_aggregator.completeness(-float("inf"), now)
        return completeness.valid_entity_ratio

    # ------------------------------------------------------- cluster model

    def cluster_model(
        self,
        from_ms: float = -float("inf"),
        to_ms: Optional[float] = None,
        requirements: Optional[ModelCompletenessRequirements] = None,
        allow_capacity_estimation: bool = True,
        pad_replicas_to: int = 1,
        pad_brokers_to: int = 1,
        pad_fn=None,
        device="cuda",
    ) -> Tuple[ClusterState, Placement, ClusterMeta]:
        """Build a frozen snapshot on ``device`` (LoadMonitor.clusterModel
        :530-582).

        ``pad_fn(n_replicas, n_brokers) -> (pad_replicas_to, pad_brokers_to)``
        lets the caller pick pad targets from the RAW model counts — the
        shape-bucket policy needs the counts before the freeze, and only this
        method sees the populated model under the generation lock."""
        requirements = requirements or ModelCompletenessRequirements()
        to_ms = time.time() * 1000 if to_ms is None else to_ms
        with self.acquire_for_model_generation(), self._model_timer.time():
            metadata = self.metadata_client.refresh_metadata()
            options = AggregationOptions(
                min_valid_entity_ratio=requirements.min_monitored_partitions_percentage,
                min_valid_windows=requirements.min_required_num_windows,
                group_granularity=requirements.include_all_topics)
            result = self.partition_aggregator.aggregate(from_ms, to_ms, options)
            cm = self._populate(metadata, result, allow_capacity_estimation)
            if pad_fn is not None:
                pad_replicas_to, pad_brokers_to = pad_fn(
                    sum(len(rs) for rs in cm.partitions().values()),
                    len(cm.brokers()))
            return cm.freeze(pad_replicas_to=pad_replicas_to,
                             pad_brokers_to=pad_brokers_to, device=device)

    def cluster_model_builder(self, *args, **kwargs) -> ClusterModel:
        """As above but returns the mutable builder (RF-change flows)."""
        requirements = kwargs.get("requirements") or ModelCompletenessRequirements()
        to_ms = time.time() * 1000
        metadata = self.metadata_client.refresh_metadata()
        options = AggregationOptions(
            min_valid_entity_ratio=requirements.min_monitored_partitions_percentage,
            min_valid_windows=requirements.min_required_num_windows)
        result = self.partition_aggregator.aggregate(-float("inf"), to_ms, options)
        return self._populate(metadata, result,
                              kwargs.get("allow_capacity_estimation", True))

    # ------------------------------------------------------ resident builder

    def _metadata_fingerprint(self, metadata: ClusterMetadata,
                              allow_capacity_estimation: bool):
        """Structural identity of the cluster as _populate would build it.
        Order-sensitive on purpose: broker/partition iteration order decides
        dense indices, so a reordering is a different model.  Broker liveness
        is deliberately excluded — alive flips are expressible as deltas."""
        return (
            tuple((b.broker_id, b.rack, b.host) for b in metadata.brokers),
            tuple((p.topic, p.partition, p.leader, tuple(p.replicas))
                  for p in metadata.partitions),
            bool(allow_capacity_estimation),
        )

    def reset_resident_builder(self) -> None:
        """Drop the kept builder; the next resident request rebuilds fresh
        (used when out-of-band state the diff cannot see changed, e.g. the
        set of offline logdirs, or after a device failover)."""
        self._resident_builder = None

    def resident_model_builder(
        self,
        requirements: Optional[ModelCompletenessRequirements] = None,
        allow_capacity_estimation: bool = True,
    ) -> Tuple[ClusterModel, bool]:
        """Return ``(builder, fresh)`` where ``builder`` is the *kept*
        delta-tracking ClusterModel updated in place from the latest metadata
        + aggregates, and ``fresh`` says it was rebuilt from scratch (the
        structural fingerprint changed or no builder existed).

        The steady-state path touches only partitions whose aggregated load
        vector actually changed and brokers whose liveness flipped, so the
        builder's journal — and therefore the device delta — stays sparse.
        Callers must serialize calls (the facade holds the resident-service
        lock across update + snapshot).
        """
        requirements = requirements or ModelCompletenessRequirements()
        to_ms = time.time() * 1000
        metadata = self.metadata_client.refresh_metadata()
        options = AggregationOptions(
            min_valid_entity_ratio=requirements.min_monitored_partitions_percentage,
            min_valid_windows=requirements.min_required_num_windows)
        result = self.partition_aggregator.aggregate(-float("inf"), to_ms, options)
        fp = self._metadata_fingerprint(metadata, allow_capacity_estimation)
        if self._resident_builder is None or fp != self._resident_fp:
            cm = self._populate(metadata, result, allow_capacity_estimation)
            cm.enable_delta_tracking()
            self._resident_builder = cm
            self._resident_fp = fp
            self._resident_loads = self._partition_loads(metadata, result)
            self._resident_alive = {b.broker_id: bool(b.alive)
                                    for b in metadata.brokers}
            return cm, True

        cm = self._resident_builder
        loads = self._partition_loads(metadata, result)
        prev = self._resident_loads
        parts = cm.partitions()
        for tp, load in loads.items():
            pl = prev.get(tp)
            if pl is not None and np.array_equal(pl, load):
                continue
            for r in list(parts.get(tp, ())):
                cm.set_replica_load(tp[0], tp[1], r.broker_id, load)
        for tp in prev.keys() - loads.keys():
            # Partition dropped out of the monitored set: a fresh _populate
            # would leave its load at zero.
            zero = np.zeros_like(prev[tp])
            for r in list(parts.get(tp, ())):
                cm.set_replica_load(tp[0], tp[1], r.broker_id, zero)
        self._resident_loads = loads
        for b in metadata.brokers:
            if bool(b.alive) != self._resident_alive.get(b.broker_id, True):
                cm.set_broker_state(b.broker_id, alive=bool(b.alive))
                self._resident_alive[b.broker_id] = bool(b.alive)
        return cm, False

    def _partition_loads(self, metadata: ClusterMetadata, agg_result,
                         ) -> Dict[Tuple[str, int], np.ndarray]:
        """Per-partition aggregated load vectors (f64[4]) — the same numbers
        _populate assigns via set_replica_load."""
        values = agg_result.values_and_extrapolations
        mat = self._resource_matrix
        out: Dict[Tuple[str, int], np.ndarray] = {}
        for p in metadata.partitions:
            if not p.replicas:
                continue
            vae = values.get((p.topic, p.partition))
            if vae is None:
                continue
            per_metric = vae.values.mean(axis=1)       # f32[M]
            out[(p.topic, p.partition)] = mat @ per_metric
        return out

    def _populate(self, metadata: ClusterMetadata, agg_result,
                  allow_capacity_estimation: bool) -> ClusterModel:
        cm = ClusterModel()
        broker_info = {b.broker_id: b for b in metadata.brokers}
        for b in metadata.brokers:
            cap = self.capacity_resolver.capacity_for_broker(
                b.rack, b.host, b.broker_id,
                allow_estimation=allow_capacity_estimation)
            cm.create_broker(rack=b.rack, host=b.host, broker_id=b.broker_id,
                             capacity={r: float(cap.capacity[int(r)])
                                       for r in Resource},
                             disk_capacities=cap.disk_capacities)
        # Collapse windows per metric strategy then map to resources
        # (Load.expectedUtilizationFor :84-98 over the window axis); shared
        # with the resident diff path so both see identical numbers.
        loads = self._partition_loads(metadata, agg_result)
        for p in metadata.partitions:
            if not p.replicas:
                continue
            for i, broker_id in enumerate(p.replicas):
                if broker_id not in broker_info:
                    continue
                cm.create_replica(p.topic, p.partition, broker_id=broker_id,
                                  index=i, is_leader=(broker_id == p.leader))
            load = loads.get((p.topic, p.partition))
            if load is None:
                continue  # not monitored; include_all_topics gate decides upstream
            # Every replica gets the aggregated leader metrics (reference:
            # MonitorUtils.populatePartitionLoad :382-447 sets load per
            # replica); the two-role model derives the follower-role load via
            # effective_follower_load(), so followers are NOT zero.
            for r in cm.partition(p.topic, p.partition):
                cm.set_replica_load(p.topic, p.partition, r.broker_id, load)
        # Dead brokers last so offline flags land on populated replicas.
        for b in metadata.brokers:
            if not b.alive:
                cm.set_broker_state(b.broker_id, alive=False)
        return cm

    # ---------------------------------------------------------------- state

    def state(self, runner_state: str = "RUNNING") -> LoadMonitorState:
        now = time.time() * 1000
        completeness = self.partition_aggregator.completeness(-float("inf"), now)
        return LoadMonitorState(
            state=runner_state,
            num_valid_windows=len(completeness.valid_windows),
            monitored_partitions_percentage=completeness.valid_entity_ratio,
            total_num_partitions=completeness.num_entities,
            generation=self.partition_aggregator.generation,
        )
