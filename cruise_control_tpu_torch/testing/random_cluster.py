"""Random cluster generator (vectorized).

Port of the reference's parameterized random model generator
``cruise-control/src/test/java/com/linkedin/kafka/cruisecontrol/model/
RandomCluster.java`` (:55 generate, :104-121 populate) with the property set
from ``common/TestConstants.java`` (BASE_PROPERTIES: 10 racks / 40 brokers /
50001 replicas / 3000 topics / RF 3, resource means, UNIFORM / LINEAR /
EXPONENTIAL distributions).  Unlike the reference's per-replica object
construction, everything here is numpy so BASELINE configs #4-#5
(2.6K brokers / 1M replicas) generate in seconds.  The same properties give
the same arrays, bit for bit, as ``cruise_control_tpu.testing.random_cluster``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.model import cpu_model
from cruise_control_tpu_torch.model.state import (
    ClusterMeta,
    ClusterState,
    Placement,
    pack_state_arrays,
    state_from_packed,
)

TYPICAL_CPU_CAPACITY = 100.0
LARGE_BROKER_CAPACITY = 300_000.0
MEDIUM_BROKER_CAPACITY = 200_000.0


class Distribution(enum.Enum):
    UNIFORM = "uniform"
    LINEAR = "linear"
    EXPONENTIAL = "exponential"


@dataclass
class ClusterProperties:
    """Reference: TestConstants.BASE_PROPERTIES."""

    num_racks: int = 10
    num_brokers: int = 40
    num_dead_brokers: int = 0
    num_brokers_with_bad_disk: int = 0
    num_replicas: int = 50_001
    num_topics: int = 3_000
    min_replication: int = 3
    max_replication: int = 3
    mean_cpu: float = 0.01       # utilization fraction of capacity
    mean_disk: float = 100.0
    mean_nw_in: float = 100.0
    mean_nw_out: float = 100.0
    num_disks: int = 1
    distribution: Distribution = Distribution.UNIFORM
    seed: int = 3140             # TestConstants.SEED_BASE
    # ---- fuzzsvc extensions (defaults reproduce the reference layout) ----
    # 0.0 = reference round-robin racks; > 0 skews broker counts across
    # racks exponentially (rack 0 largest), so rack-aware goals face
    # heterogeneous domains instead of perfectly even ones.
    rack_skew: float = 0.0
    # 1 = homogeneous capacity; k > 1 assigns brokers round-robin to k
    # capacity tiers spanning 0.5x..1.5x of the reference capacity.
    capacity_tiers: int = 1
    # Explicit fault sets for deterministic scenario replay.  When given
    # they take precedence over the sampled num_dead_brokers /
    # num_brokers_with_bad_disk counts; dead_disk_ids works at any
    # num_disks (the sampled path needs num_disks > 1).
    dead_broker_ids: Optional[Tuple[int, ...]] = None
    dead_disk_ids: Optional[Tuple[Tuple[int, int], ...]] = None


def _apportion(weights: np.ndarray, total: int, min_each: int = 0) -> np.ndarray:
    """Integer counts summing to ``total``, proportional to ``weights``
    (largest-remainder), each at least ``min_each`` when feasible."""
    n = weights.shape[0]
    min_each = min(min_each, total // n) if n else 0
    spread = total - min_each * n
    share = weights / weights.sum() * spread
    counts = np.floor(share).astype(np.int64)
    remainder = spread - int(counts.sum())
    if remainder > 0:
        order = np.argsort(-(share - counts), kind="stable")
        counts[order[:remainder]] += 1
    return counts + min_each


def _sample(rng: np.random.Generator, dist: Distribution, mean: float,
            n: int) -> np.ndarray:
    if dist is Distribution.UNIFORM:
        return rng.uniform(0.0, 2.0 * mean, n)
    if dist is Distribution.LINEAR:
        # Triangular ramp: density increasing linearly with value.
        return 2.0 * mean * np.sqrt(rng.uniform(0.0, 1.0, n))
    return rng.exponential(mean, n)


def generate(props: Optional[ClusterProperties] = None,
             pad_replicas_to: int = 1, pad_brokers_to: int = 1,
             device="cuda") -> Tuple[ClusterState, Placement, ClusterMeta]:
    """Build a random (state, placement, meta) snapshot on ``device``."""
    p = props or ClusterProperties()
    rng = np.random.default_rng(p.seed)

    # ---- topics / partitions: popularity-weighted partition counts.
    rf = rng.integers(p.min_replication, p.max_replication + 1, p.num_topics)
    popularity = rng.exponential(1.0, p.num_topics) + 1e-3
    weights = popularity / popularity.sum()
    # partitions per topic so that sum(partitions * rf) ≈ num_replicas.
    target = np.maximum((weights * p.num_replicas / rf).astype(np.int64), 1)
    num_partitions_per_topic = target
    pid_topic = np.repeat(np.arange(p.num_topics), num_partitions_per_topic)
    num_partitions = pid_topic.shape[0]
    part_rf = rf[pid_topic]                              # [P]
    r_n = int(part_rf.sum())

    # ---- replica rows: partition / topic / pos.
    part_of_replica = np.repeat(np.arange(num_partitions), part_rf)
    offsets = np.concatenate([[0], np.cumsum(part_rf)])[:-1]
    pos = np.arange(r_n) - offsets[part_of_replica]
    topic_of_replica = pid_topic[part_of_replica]

    # ---- placement: RF distinct brokers per partition (re-roll collisions).
    max_rf = int(part_rf.max())
    picks = rng.integers(0, p.num_brokers, (num_partitions, max_rf))
    for _ in range(64):
        dup = np.zeros((num_partitions, max_rf), dtype=bool)
        for j in range(1, max_rf):
            dup[:, j] = (picks[:, :j] == picks[:, j:j + 1]).any(axis=1)
        n_dup = int(dup.sum())
        if n_dup == 0:
            break
        picks[dup] = rng.integers(0, p.num_brokers, n_dup)
    slot = pos  # replica's column in picks
    assignment = picks[part_of_replica, slot]
    is_leader = pos == 0

    # ---- loads.
    cpu_cap = TYPICAL_CPU_CAPACITY
    leader_load = np.zeros((r_n, NUM_RESOURCES))
    leader_load[:, Resource.CPU] = _sample(rng, p.distribution,
                                           p.mean_cpu * cpu_cap, r_n)
    leader_load[:, Resource.DISK] = _sample(rng, p.distribution, p.mean_disk, r_n)
    leader_load[:, Resource.NW_IN] = _sample(rng, p.distribution, p.mean_nw_in, r_n)
    leader_load[:, Resource.NW_OUT] = _sample(rng, p.distribution, p.mean_nw_out, r_n)
    # Per-partition identical disk/NW_IN across replicas (same data replicated).
    first_row = offsets[part_of_replica]
    for res in (Resource.DISK, Resource.NW_IN, Resource.NW_OUT, Resource.CPU):
        leader_load[:, res] = leader_load[first_row, res]

    follower_load = leader_load.copy()
    follower_load[:, Resource.NW_OUT] = 0.0
    follower_load[:, Resource.CPU] = cpu_model.follower_cpu_from_leader_load_vec(
        leader_load[:, Resource.NW_IN], leader_load[:, Resource.NW_OUT],
        leader_load[:, Resource.CPU])

    # ---- brokers: racks (round-robin, or skewed per rack_skew), one host
    # per broker, capacity homogeneous or tiered per capacity_tiers.
    capacity = np.tile(np.array([
        TYPICAL_CPU_CAPACITY, LARGE_BROKER_CAPACITY,
        MEDIUM_BROKER_CAPACITY, LARGE_BROKER_CAPACITY]), (p.num_brokers, 1))
    if p.rack_skew > 0.0:
        w = np.exp(-p.rack_skew * np.arange(p.num_racks)
                   / max(p.num_racks - 1, 1))
        counts = _apportion(w, p.num_brokers, min_each=1)
        rack = np.repeat(np.arange(p.num_racks), counts)
    else:
        rack = np.arange(p.num_brokers) % p.num_racks
    tier_mult = np.ones(p.num_brokers)
    if p.capacity_tiers > 1:
        tier = np.arange(p.num_brokers) % p.capacity_tiers
        tier_mult = 0.5 + tier / (p.capacity_tiers - 1)
        capacity = capacity * tier_mult[:, None]
    host = np.arange(p.num_brokers)
    alive = np.ones(p.num_brokers, dtype=bool)
    if p.dead_broker_ids is not None:
        alive[list(p.dead_broker_ids)] = False
    elif p.num_dead_brokers > 0:
        dead = rng.choice(p.num_brokers, p.num_dead_brokers, replace=False)
        alive[dead] = False

    d_n = max(p.num_disks, 1)
    disk_capacity = (np.full((p.num_brokers, d_n), LARGE_BROKER_CAPACITY / d_n)
                     * tier_mult[:, None])
    disk_alive = np.ones((p.num_brokers, d_n), dtype=bool)
    if p.dead_disk_ids is not None:
        for b, d in p.dead_disk_ids:
            disk_alive[int(b), int(d)] = False
    elif p.num_brokers_with_bad_disk > 0 and d_n > 1:
        bad = rng.choice(np.nonzero(alive)[0],
                         min(p.num_brokers_with_bad_disk, int(alive.sum())),
                         replace=False)
        disk_alive[bad, 0] = False
    disk = (rng.integers(0, d_n, r_n) if d_n > 1
            else np.zeros(r_n, dtype=np.int64))

    offline = ~alive[assignment] | ~disk_alive[assignment, disk]

    state, placement = state_from_packed(pack_state_arrays(
        dict(leader_load=leader_load, follower_load=follower_load,
             partition=part_of_replica, topic=topic_of_replica, pos=pos,
             orig_broker=assignment, offline=offline, assignment=assignment,
             disk=disk, is_leader=is_leader, capacity=capacity, host=host,
             rack=rack, alive=alive,
             new_broker=np.zeros(p.num_brokers, dtype=bool),
             disk_capacity=disk_capacity, disk_alive=disk_alive),
        pad_replicas_to=pad_replicas_to, pad_brokers_to=pad_brokers_to),
        device)
    first_of_topic = np.searchsorted(pid_topic, np.arange(p.num_topics), side="left")
    pnum = np.arange(num_partitions) - first_of_topic[pid_topic]
    meta = ClusterMeta(
        broker_ids=list(range(p.num_brokers)),
        topics=[f"topic{t}" for t in range(p.num_topics)],
        partitions=list(zip(pid_topic.tolist(), pnum.tolist())),
        racks=[str(k) for k in range(p.num_racks)],
        hosts=[f"h{i}" for i in range(p.num_brokers)],
        num_replicas=r_n, num_brokers=p.num_brokers,
    )
    return state, placement, meta
