"""Deterministic test clusters.

Port of the reference fixture generator
``cruise-control/src/test/java/com/linkedin/kafka/cruisecontrol/common/
DeterministicCluster.java`` (and the constants it pulls from
``TestConstants.java:40-135``).  These hand-built models drive the analyzer
parity tests (reference: ``analyzer/DeterministicClusterTest.java``) and are
BASELINE config #1.  The JAX package's ``testing/deterministic.py``, kept as
the port's own copy: each fixture freezes to the same packed arrays in both
packages.

Loads are given as (cpu, nw_in, nw_out, disk) per the reference's
``getAggregatedMetricValues`` argument order.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.builder import ClusterModel

TYPICAL_CPU_CAPACITY = 100.0
LARGE_BROKER_CAPACITY = 300_000.0
MEDIUM_BROKER_CAPACITY = 200_000.0
SMALL_BROKER_CAPACITY = 10.0

BROKER_CAPACITY = {
    Resource.CPU: TYPICAL_CPU_CAPACITY,
    Resource.NW_IN: LARGE_BROKER_CAPACITY,
    Resource.NW_OUT: MEDIUM_BROKER_CAPACITY,
    Resource.DISK: LARGE_BROKER_CAPACITY,
}
# Two logdirs per broker, half the disk capacity each (TestConstants.DISK_CAPACITY).
JBOD_DISK_CAPACITIES = [LARGE_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2]

# Broker id -> rack id maps (DeterministicCluster.RACK_BY_BROKER{,2,3}).
RACK_BY_BROKER = {0: 0, 1: 0, 2: 1}
RACK_BY_BROKER2 = {0: 0, 1: 1, 2: 1}
RACK_BY_BROKER3 = {0: 0, 1: 1, 2: 1, 3: 1}

T1, T2 = "T1", "T2"


def load(cpu: float, nw_in: float, nw_out: float, disk: float) -> np.ndarray:
    return np.array([cpu, nw_in, nw_out, disk], dtype=np.float64)


def homogeneous_cluster(rack_by_broker: Dict[int, int],
                        capacity: Optional[Dict[Resource, float]] = None,
                        jbod: bool = False) -> ClusterModel:
    """DeterministicCluster.getHomogeneousCluster: one host per broker."""
    capacity = capacity or BROKER_CAPACITY
    cm = ClusterModel()
    for broker_id, rack in sorted(rack_by_broker.items()):
        cm.create_broker(rack=str(rack), host=f"h{broker_id}", broker_id=broker_id,
                         capacity=dict(capacity),
                         disk_capacities=JBOD_DISK_CAPACITIES if jbod else None)
    return cm


def unbalanced() -> ClusterModel:
    """Two racks, three brokers, two partitions (1 replica each), all on broker 0."""
    cm = homogeneous_cluster(RACK_BY_BROKER)
    half = load(TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
                MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2)
    for topic in (T1, T2):
        cm.create_replica(topic, 0, broker_id=0, index=0, is_leader=True)
        cm.set_replica_load(topic, 0, 0, half)
    return cm


def unbalanced2() -> ClusterModel:
    """unbalanced() + four more 1-replica partitions (broker 1 gets one, broker 0 three)."""
    cm = unbalanced()
    half = load(TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
                MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2)
    for topic, part, broker in ((T1, 1, 1), (T2, 1, 0), (T1, 2, 0), (T2, 2, 0)):
        cm.create_replica(topic, part, broker_id=broker, index=0, is_leader=True)
        cm.set_replica_load(topic, part, broker, half)
    return cm


def unbalanced3() -> ClusterModel:
    """Two racks, three brokers, two partitions × two replicas; leaders at index 1."""
    cm = homogeneous_cluster(RACK_BY_BROKER)
    half = load(TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
                MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2)
    for topic in (T1, T2):
        cm.create_replica(topic, 0, broker_id=1, index=0, is_leader=False)
        cm.create_replica(topic, 0, broker_id=0, index=1, is_leader=True)
        cm.set_replica_load(topic, 0, 0, half)
        cm.set_replica_load(topic, 0, 1, half)
    return cm


def unbalanced_with_a_follower() -> ClusterModel:
    """unbalanced() + a follower of T1-0 on broker 2."""
    cm = unbalanced()
    cm.create_replica(T1, 0, broker_id=2, index=1, is_leader=False)
    cm.set_replica_load(T1, 0, 2, load(TYPICAL_CPU_CAPACITY / 8, LARGE_BROKER_CAPACITY / 2,
                                       0.0, LARGE_BROKER_CAPACITY / 2))
    return cm


def _create_unbalanced(topics, num_partitions: int) -> ClusterModel:
    """DeterministicCluster.createUnbalanced: 2 brokers / 2 racks / 2 disks each."""
    cm = homogeneous_cluster({0: 0, 1: 1}, jbod=True)
    for topic in topics:
        for i in range(num_partitions):
            broker_id = 1 if i > 3 else 0
            logdir = 0 if i % 4 < 2 else 1
            cm.create_replica(topic, i, broker_id=broker_id, index=0, is_leader=True,
                              disk=logdir)
            cm.set_replica_load(topic, i, broker_id, load(
                TYPICAL_CPU_CAPACITY / 5 + TYPICAL_CPU_CAPACITY / 50 * (i / 2.0 - 1.5),
                LARGE_BROKER_CAPACITY / 5 + LARGE_BROKER_CAPACITY / 50 * (i / 2.0 - 1.5),
                MEDIUM_BROKER_CAPACITY / 5 + MEDIUM_BROKER_CAPACITY / 50 * (i / 2.0 - 1.5),
                LARGE_BROKER_CAPACITY / 5 + LARGE_BROKER_CAPACITY / 50 * (i / 2.0 - 1.5)))
    return cm


def unbalanced4() -> ClusterModel:
    """Two JBOD brokers on two racks; one topic × 8 single-replica partitions."""
    return _create_unbalanced((T1,), 8)


def unbalanced5() -> ClusterModel:
    """unbalanced4 shape with two topics × 14 partitions."""
    return _create_unbalanced((T1, T2), 14)


def swap_only_balanceable() -> ClusterModel:
    """Two brokers where NO single replica move can stay inside the NW_IN
    balance band — the hot broker's lightest replica still overshoots the cold
    broker's upper bound — but one swap balances both exactly.

    b0 holds NW_IN loads {10, 8} (util 18/20), b1 holds {4, 2} (util 6/20);
    avg util 0.6, band [10.8, 13.2].  Moving 8 → b1 gives 14 > 13.2 (reject);
    swapping 10 ↔ 4 gives 12 / 12 (in band).  Exercises the solver's swap
    phase (reference mechanism: ResourceDistributionGoal.java:543-725).
    """
    capacity = {Resource.CPU: TYPICAL_CPU_CAPACITY, Resource.NW_IN: 20.0,
                Resource.NW_OUT: MEDIUM_BROKER_CAPACITY,
                Resource.DISK: LARGE_BROKER_CAPACITY}
    cm = homogeneous_cluster({0: 0, 1: 1}, capacity=capacity)
    nw_in = {(T1, 0): (0, 10.0), (T1, 1): (0, 8.0),
             (T2, 0): (1, 4.0), (T2, 1): (1, 2.0)}
    for (topic, part), (broker, value) in nw_in.items():
        cm.create_replica(topic, part, broker_id=broker, index=0, is_leader=True)
        cm.set_replica_load(topic, part, broker, load(1.0, value, 0.0, 1.0))
    return cm


def rack_aware_satisfiable() -> ClusterModel:
    """Two racks, three brokers, one partition × 2 replicas on brokers 0,1 (same rack)."""
    cm = homogeneous_cluster(RACK_BY_BROKER)
    cm.create_replica(T1, 0, broker_id=0, index=0, is_leader=True)
    cm.create_replica(T1, 0, broker_id=1, index=1, is_leader=False)
    cm.set_replica_load(T1, 0, 0, load(40.0, 100.0, 130.0, 75.0))
    cm.set_replica_load(T1, 0, 1, load(5.0, 100.0, 0.0, 75.0))
    return cm


def rack_aware_satisfiable2() -> ClusterModel:
    """Replicas on brokers 0,2 with RACK_BY_BROKER2 (already rack-aware)."""
    cm = homogeneous_cluster(RACK_BY_BROKER2)
    cm.create_replica(T1, 0, broker_id=0, index=0, is_leader=True)
    cm.create_replica(T1, 0, broker_id=2, index=1, is_leader=False)
    cm.set_replica_load(T1, 0, 0, load(40.0, 100.0, 130.0, 75.0))
    cm.set_replica_load(T1, 0, 2, load(5.0, 100.0, 0.0, 75.0))
    return cm


def rack_aware_unsatisfiable() -> ClusterModel:
    """rack_aware_satisfiable + a third replica: 3 replicas, only 2 racks."""
    cm = rack_aware_satisfiable()
    cm.create_replica(T1, 0, broker_id=2, index=2, is_leader=False)
    cm.set_replica_load(T1, 0, 2, load(60.0, 100.0, 130.0, 75.0))
    return cm


# ---------------------------------------------------------------- deck models
# (DeterministicCluster.smallClusterModel / mediumClusterModel — the models
# DeterministicClusterTest.java:137-199 sweeps across balance percentages,
# capacity thresholds and broker capacities.)

TOPIC_A, TOPIC_B, TOPIC_C, TOPIC_D = "A", "B", "C", "D"
# TestConstants.TOPIC_MUST_HAVE_LEADER_REPLICAS_ON_BROKERS
TOPIC_L = "must_have_leader_replica_on_broker_topic"
TOPIC0, TOPIC1 = "topic0", "topic1"

# TestConstants.java:36-42 sweep values.
ZERO_BALANCE_PERCENTAGE = 1.00
LOW_BALANCE_PERCENTAGE = 1.05
MEDIUM_BALANCE_PERCENTAGE = 1.25
HIGH_BALANCE_PERCENTAGE = 1.65
HIGH_CAPACITY_THRESHOLD = 0.9
MEDIUM_CAPACITY_THRESHOLD = 0.8
LOW_CAPACITY_THRESHOLD = 0.7


def small_cluster_model(capacity: Optional[Dict[Resource, float]] = None) -> ClusterModel:
    """DeterministicCluster.smallClusterModel:678-714 — 3 brokers / 2 racks,
    5 partitions x RF2 over topics T1, T2."""
    cm = homogeneous_cluster(RACK_BY_BROKER, capacity=capacity)
    deck = [
        # (topic, partition, leader broker, leader load, follower broker, follower load)
        (T1, 0, 0, (20.0, 100.0, 130.0, 75.0), 2, (5.0, 100.0, 0.0, 75.0)),
        (T1, 1, 1, (15.0, 90.0, 110.0, 55.0), 0, (4.5, 90.0, 0.0, 55.0)),
        (T2, 0, 1, (5.0, 5.0, 6.0, 5.0), 2, (4.0, 5.0, 0.0, 5.0)),
        (T2, 1, 0, (25.0, 25.0, 45.0, 55.0), 2, (10.5, 25.0, 0.0, 55.0)),
        (T2, 2, 0, (20.0, 45.0, 120.0, 95.0), 1, (8.0, 45.0, 0.0, 95.0)),
    ]
    for topic, part, lb, lload, fb, fload in deck:
        cm.create_replica(topic, part, broker_id=lb, index=0, is_leader=True)
        cm.create_replica(topic, part, broker_id=fb, index=1, is_leader=False)
        cm.set_replica_load(topic, part, lb, load(*lload))
        cm.set_replica_load(topic, part, fb, load(*fload))
    return cm


def medium_cluster_model(capacity: Optional[Dict[Resource, float]] = None) -> ClusterModel:
    """DeterministicCluster.mediumClusterModel:799-842 — 3 brokers / 2 racks,
    6 partitions x RF2 over topics A, B, C, D."""
    cm = homogeneous_cluster(RACK_BY_BROKER, capacity=capacity)
    deck = [
        (TOPIC_A, 0, 1, (5.0, 4.0, 10.0, 10.0), 0, (5.0, 5.0, 0.0, 4.0)),
        (TOPIC_A, 1, 0, (5.0, 3.0, 10.0, 8.0), 2, (3.0, 4.0, 0.0, 6.0)),
        (TOPIC_A, 2, 0, (5.0, 2.0, 10.0, 6.0), 2, (4.0, 5.0, 0.0, 3.0)),
        (TOPIC_B, 0, 1, (5.0, 4.0, 10.0, 7.0), 2, (2.0, 2.0, 0.0, 5.0)),
        (TOPIC_C, 0, 2, (1.0, 8.0, 10.0, 4.0), 1, (5.0, 6.0, 0.0, 4.0)),
        (TOPIC_D, 0, 1, (5.0, 5.0, 10.0, 6.0), 2, (2.0, 8.0, 0.0, 7.0)),
    ]
    for topic, part, lb, lload, fb, fload in deck:
        cm.create_replica(topic, part, broker_id=lb, index=0, is_leader=True)
        cm.create_replica(topic, part, broker_id=fb, index=1, is_leader=False)
        cm.set_replica_load(topic, part, lb, load(*lload))
        cm.set_replica_load(topic, part, fb, load(*fload))
    return cm


# ------------------------------------------------- min-topic-leaders fixtures
# (DeterministicCluster.minLeaderReplicaPerBroker*:300-545; the goal must fix
# them with leadership moves where possible and replica moves where not.)

_HALF = (TYPICAL_CPU_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2,
         MEDIUM_BROKER_CAPACITY / 2, LARGE_BROKER_CAPACITY / 2)


def _leader_topic_cluster(assignments) -> ClusterModel:
    """assignments: iterable of (topic, partition, [(broker, is_leader), ...])."""
    cm = homogeneous_cluster(RACK_BY_BROKER2)
    for topic, part, replicas in assignments:
        for idx, (broker, is_leader) in enumerate(replicas):
            cm.create_replica(topic, part, broker_id=broker, index=idx,
                              is_leader=is_leader)
            cm.set_replica_load(topic, part, broker, load(*_HALF))
    return cm


def min_leader_satisfiable() -> ClusterModel:
    """B0: P0_l, P1_l; B1: P2_l, P0_f; B2: P2_f, P1_f (:347-380)."""
    return _leader_topic_cluster([
        (TOPIC_L, 0, [(0, True), (1, False)]),
        (TOPIC_L, 1, [(0, True), (2, False)]),
        (TOPIC_L, 2, [(1, True), (2, False)]),
    ])


def min_leader_satisfiable2() -> ClusterModel:
    """B0 leads everything; B1/B2 hold followers (:392-430)."""
    return _leader_topic_cluster([
        (TOPIC_L, 0, [(0, True), (2, False)]),
        (TOPIC_L, 1, [(0, True), (1, False)]),
        (TOPIC_L, 2, [(0, True), (2, False)]),
    ])


def min_leader_satisfiable3() -> ClusterModel:
    """Four brokers (B0 EMPTY), 16 partitions x RF2; min 4 leaders/broker
    forces replica MOVES onto B0 — promotions alone cannot reach it
    (:496-545)."""
    cm = ClusterModel()
    for broker_id, rack in sorted(RACK_BY_BROKER3.items()):
        cm.create_broker(rack=str(rack), host=f"h{broker_id}", broker_id=broker_id,
                         capacity=dict(BROKER_CAPACITY))
    placement = {i: (1, 3) for i in range(4)}        # leader B1, follower B3
    placement.update({i: (2, 1) for i in range(4, 10)})   # leader B2, follower B1
    placement.update({i: (3, 2) for i in range(10, 16)})  # leader B3, follower B2
    for part, (lb, fb) in placement.items():
        cm.create_replica(TOPIC_L, part, broker_id=lb, index=0, is_leader=True)
        cm.create_replica(TOPIC_L, part, broker_id=fb, index=1, is_leader=False)
        cm.set_replica_load(TOPIC_L, part, lb, load(*_HALF))
        cm.set_replica_load(TOPIC_L, part, fb, load(*_HALF))
    return cm


def min_leader_satisfiable4() -> ClusterModel:
    """Two topics x 3 partitions, all leaders on B0, all followers on B1,
    B2 empty (:439-492) — needs both promotions and replica moves."""
    return _leader_topic_cluster([
        (topic, part, [(0, True), (1, False)])
        for topic in (TOPIC0, TOPIC1) for part in range(3)
    ])


def min_leader_unsatisfiable() -> ClusterModel:
    """Two leader replicas, three brokers: pigeonhole failure (:314-334,
    DeterministicClusterTest.java:229-232 expects OptimizationFailureException)."""
    return _leader_topic_cluster([
        (TOPIC_L, 0, [(0, True), (2, False)]),
        (TOPIC_L, 1, [(0, True), (1, False)]),
    ])
