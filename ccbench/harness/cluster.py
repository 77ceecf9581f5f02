"""Seeded cluster snapshots as packed numpy arrays.

A frozen copy of the port's random-cluster generator
(``cruise_control_tpu_torch/testing/random_cluster.generate``, itself a port
of cruise-control's ``RandomCluster.java:55-121``) and of its packing
(``model/state.pack_state_arrays``), so that the yardstick cannot move with
the program.  It imports nothing of the port: the same properties give the
port's arrays bit for bit (``ccbench/tests/test_ccbench_cluster.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

# Resource columns, in the port's order (common/resources.py).
CPU, NW_IN, NW_OUT, DISK = 0, 1, 2, 3
NUM_RESOURCES = 4

TYPICAL_CPU_CAPACITY = 100.0
LARGE_BROKER_CAPACITY = 300_000.0
MEDIUM_BROKER_CAPACITY = 200_000.0

# ModelUtils.getFollowerCpuUtilFromLeaderLoad weights (model/cpu_model.py).
CPU_WEIGHT_LEADER_BYTES_IN = 0.7
CPU_WEIGHT_LEADER_BYTES_OUT = 0.15
CPU_WEIGHT_FOLLOWER_BYTES_IN = 0.15

#: The generator properties a configuration may set, with the defaults of
#: TestConstants.BASE_PROPERTIES.
PROPERTIES = dict(num_racks=10, num_brokers=40, num_replicas=50_001, num_topics=3_000,
                  min_replication=3, max_replication=3, mean_cpu=0.01, mean_disk=100.0,
                  mean_nw_in=100.0, mean_nw_out=100.0, distribution="uniform", seed=3140)


@dataclass
class Snapshot:
    """A generated cluster: the packed 19-array dict the port's
    ``state_from_packed`` takes, and the identity lists of its ClusterMeta."""

    packed: Dict[str, np.ndarray]
    broker_ids: List[int]
    topics: List[str]
    partitions: List[Tuple[int, int]]
    racks: List[str]
    hosts: List[str]
    first_of_topic: np.ndarray       # i64[T]: dense id of each topic's partition 0

    @property
    def num_replicas(self) -> int:
        return int(self.packed["partition"].shape[0])

    @property
    def num_brokers(self) -> int:
        return int(self.packed["capacity"].shape[0])

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def meta_kwargs(self) -> dict:
        """The keyword arguments of the port's ``ClusterMeta``."""
        return dict(broker_ids=self.broker_ids, topics=self.topics,
                    partitions=self.partitions, racks=self.racks, hosts=self.hosts,
                    num_replicas=self.num_replicas, num_brokers=self.num_brokers)


def properties(cfg: dict) -> dict:
    """The generator properties of a configuration's ``cluster`` block,
    defaults filled in; an unknown key is refused."""
    unknown = sorted(set(cfg) - set(PROPERTIES))
    if unknown:
        raise ValueError(f"unknown cluster properties: {unknown}")
    return {**PROPERTIES, **cfg}


def _sample(rng: np.random.Generator, dist: str, mean: float, n: int) -> np.ndarray:
    if dist == "uniform":
        return rng.uniform(0.0, 2.0 * mean, n)
    if dist == "linear":
        return 2.0 * mean * np.sqrt(rng.uniform(0.0, 1.0, n))
    if dist == "exponential":
        return rng.exponential(mean, n)
    raise ValueError(f"unknown distribution {dist!r}")


def follower_cpu(nw_in: np.ndarray, nw_out: np.ndarray, leader_cpu: np.ndarray) -> np.ndarray:
    """CPU a replica would use as follower, from its leader-role load."""
    denom = CPU_WEIGHT_LEADER_BYTES_IN * nw_in + CPU_WEIGHT_LEADER_BYTES_OUT * nw_out
    out = leader_cpu * (CPU_WEIGHT_FOLLOWER_BYTES_IN * nw_in) / np.maximum(denom, 1e-12)
    return np.where((nw_in == 0.0) & (nw_out == 0.0), 0.0, out)


def pack(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The unpadded per-replica / per-broker arrays in their device dtypes:
    the 19-array packed dict (``pack_state_arrays`` with no padding)."""
    r = arrays["leader_load"].shape[0]
    b = arrays["capacity"].shape[0]
    return dict(
        leader_load=arrays["leader_load"].astype(np.float32),
        follower_load=arrays["follower_load"].astype(np.float32),
        partition=arrays["partition"].astype(np.int32),
        topic=arrays["topic"].astype(np.int32),
        pos=arrays["pos"].astype(np.int32),
        orig_broker=arrays["orig_broker"].astype(np.int32),
        offline=arrays["offline"].astype(bool),
        valid=np.ones(r, dtype=bool),
        capacity=arrays["capacity"].astype(np.float32),
        host=arrays["host"].astype(np.int32),
        rack=arrays["rack"].astype(np.int32),
        alive=arrays["alive"].astype(bool),
        new_broker=arrays["new_broker"].astype(bool),
        broker_valid=np.ones(b, dtype=bool),
        disk_capacity=arrays["disk_capacity"].astype(np.float32),
        disk_alive=arrays["disk_alive"].astype(bool),
        assignment=arrays["assignment"].astype(np.int32),
        disk=arrays["disk"].astype(np.int32),
        is_leader=arrays["is_leader"].astype(bool),
    )


def generate(props: dict) -> Snapshot:
    """The snapshot ``RandomCluster`` generates from ``props`` (see
    :func:`properties`): every broker alive, one disk a broker, one host a
    broker, racks round-robin."""
    p = properties(props)
    rng = np.random.default_rng(p["seed"])

    # Topics and partitions: popularity-weighted partition counts.
    rf = rng.integers(p["min_replication"], p["max_replication"] + 1, p["num_topics"])
    popularity = rng.exponential(1.0, p["num_topics"]) + 1e-3
    weights = popularity / popularity.sum()
    parts_per_topic = np.maximum((weights * p["num_replicas"] / rf).astype(np.int64), 1)
    pid_topic = np.repeat(np.arange(p["num_topics"]), parts_per_topic)
    num_partitions = pid_topic.shape[0]
    part_rf = rf[pid_topic]
    r_n = int(part_rf.sum())

    # Replica rows: partition, topic, position in the replica list.
    part_of_replica = np.repeat(np.arange(num_partitions), part_rf)
    offsets = np.concatenate([[0], np.cumsum(part_rf)])[:-1]
    pos = np.arange(r_n) - offsets[part_of_replica]
    topic_of_replica = pid_topic[part_of_replica]

    # Placement: RF distinct brokers per partition (collisions re-rolled).
    num_brokers = p["num_brokers"]
    max_rf = int(part_rf.max())
    picks = rng.integers(0, num_brokers, (num_partitions, max_rf))
    for _ in range(64):
        dup = np.zeros((num_partitions, max_rf), dtype=bool)
        for j in range(1, max_rf):
            dup[:, j] = (picks[:, :j] == picks[:, j:j + 1]).any(axis=1)
        n_dup = int(dup.sum())
        if n_dup == 0:
            break
        picks[dup] = rng.integers(0, num_brokers, n_dup)
    assignment = picks[part_of_replica, pos]
    is_leader = pos == 0

    # Loads: one draw a replica, then every replica takes its partition's
    # first row (the same data is replicated).
    dist = p["distribution"]
    leader_load = np.zeros((r_n, NUM_RESOURCES))
    leader_load[:, CPU] = _sample(rng, dist, p["mean_cpu"] * TYPICAL_CPU_CAPACITY, r_n)
    leader_load[:, DISK] = _sample(rng, dist, p["mean_disk"], r_n)
    leader_load[:, NW_IN] = _sample(rng, dist, p["mean_nw_in"], r_n)
    leader_load[:, NW_OUT] = _sample(rng, dist, p["mean_nw_out"], r_n)
    first_row = offsets[part_of_replica]
    for res in (DISK, NW_IN, NW_OUT, CPU):
        leader_load[:, res] = leader_load[first_row, res]
    follower_load = leader_load.copy()
    follower_load[:, NW_OUT] = 0.0
    follower_load[:, CPU] = follower_cpu(leader_load[:, NW_IN], leader_load[:, NW_OUT],
                                         leader_load[:, CPU])

    capacity = np.tile(np.array([TYPICAL_CPU_CAPACITY, LARGE_BROKER_CAPACITY,
                                 MEDIUM_BROKER_CAPACITY, LARGE_BROKER_CAPACITY]),
                       (num_brokers, 1))
    rack = np.arange(num_brokers) % p["num_racks"]
    packed = pack(dict(
        leader_load=leader_load, follower_load=follower_load, partition=part_of_replica,
        topic=topic_of_replica, pos=pos, orig_broker=assignment,
        offline=np.zeros(r_n, dtype=bool), assignment=assignment,
        disk=np.zeros(r_n, dtype=np.int64), is_leader=is_leader, capacity=capacity,
        host=np.arange(num_brokers), rack=rack, alive=np.ones(num_brokers, dtype=bool),
        new_broker=np.zeros(num_brokers, dtype=bool),
        disk_capacity=np.full((num_brokers, 1), LARGE_BROKER_CAPACITY),
        disk_alive=np.ones((num_brokers, 1), dtype=bool)))

    first_of_topic = np.searchsorted(pid_topic, np.arange(p["num_topics"]), side="left")
    pnum = np.arange(num_partitions) - first_of_topic[pid_topic]
    return Snapshot(
        packed=packed,
        broker_ids=list(range(num_brokers)),
        topics=[f"topic{t}" for t in range(p["num_topics"])],
        partitions=list(zip(pid_topic.tolist(), pnum.tolist())),
        racks=[str(k) for k in range(p["num_racks"])],
        hosts=[f"h{i}" for i in range(num_brokers)],
        first_of_topic=first_of_topic,
    )


def seed_words(*words: int) -> list:
    """A numpy seed sequence entropy from whole numbers of any sign and size."""
    return [int(w) % (1 << 64) for w in words]
