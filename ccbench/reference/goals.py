"""Plain NumPy verdicts of Cruise Control's goals on one placement.

A rewrite, from the goals' definitions, of the thresholds that the port's
goals hold (cruise-control ``analyzer/goals/*.java`` with the defaults of
``config/cruisecontrol.properties``).  It imports nothing of the program and
works from the inputs the benchmark made: the packed snapshot arrays and a
placement (broker and leadership of every replica row).

Loads are summed in float64.  The port sums float32 loads on the card in no
fixed order, so a broker whose load lies within a hair of a bound can read
inside it there and outside it here.  A load bound is therefore judged with a
margin of ``EPS`` of the bound: a broker beyond it by more breaks the goal,
one within it leaves the goal undecided.  A float32 sum of n terms is off by
at most n * 2**-24 of it in any order (7.0e-5 at the ~1,180 replicas a broker
of the 40-broker configuration holds), so the margin lies above that.  Counts are
exact, and a count goal's band is worked out as the port states it, in
float32 (``analyzer/goals/counts.py``), so its verdict is exact too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

CPU, NW_IN, NW_OUT, DISK = 0, 1, 2, 3
HOST_RESOURCES = (CPU, NW_IN, NW_OUT)

#: Relative margin on a load bound (see the module docstring).
EPS = 1e-4

VIOLATED, SATISFIED, UNDECIDED = "violated", "satisfied", "undecided"

@dataclass(frozen=True)
class Constraint:
    """The configuration's balancing thresholds (BalancingConstraint)."""

    capacity_threshold: Tuple[float, float, float, float] = (0.7, 0.8, 0.8, 0.8)
    balance_threshold: Tuple[float, float, float, float] = (1.1, 1.1, 1.1, 1.1)
    low_utilization_threshold: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    max_replicas_per_broker: int = 10_000
    replica_balance_threshold: float = 1.1
    leader_replica_balance_threshold: float = 1.1
    topic_replica_balance_threshold: float = 3.0
    topic_replica_balance_min_gap: int = 2

    @classmethod
    def from_config(cls, block: dict) -> "Constraint":
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in block.items()})


class Cluster:
    """The placement-independent part of a snapshot, from its packed arrays."""

    def __init__(self, packed: Dict[str, np.ndarray]):
        self.partition = packed["partition"].astype(np.int64)
        self.pos = packed["pos"].astype(np.int64)
        self.topic = packed["topic"].astype(np.int64)
        self.capacity = packed["capacity"].astype(np.float64)
        self.host = packed["host"].astype(np.int64)
        self.rack = packed["rack"].astype(np.int64)
        self.alive = packed["alive"].astype(bool)
        self.num_brokers = self.capacity.shape[0]
        self.num_hosts = int(self.host.max()) + 1
        self.num_racks = int(self.rack.max()) + 1
        self.num_topics = int(self.topic.max()) + 1
        self.num_partitions = int(self.partition.max()) + 1
        # Replica rows of each partition by position, -1 padded: [P, RF].
        order = np.lexsort((self.pos, self.partition))
        counts = np.bincount(self.partition, minlength=self.num_partitions)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(order.size) - starts[self.partition[order]]
        self.rows = np.full((self.num_partitions, int(counts.max())), -1, dtype=np.int64)
        self.rows[self.partition[order], slot] = order


@dataclass
class Aggregates:
    broker_load: np.ndarray        # f64[B, 4]
    host_load: np.ndarray          # f64[H, 4]
    host_capacity: np.ndarray      # f64[H, 4] of alive brokers
    replica_counts: np.ndarray     # i64[B]
    leader_counts: np.ndarray      # i64[B]
    topic_counts: np.ndarray       # i64[T, B]
    potential_nw_out: np.ndarray   # f64[B]
    leader_bytes_in: np.ndarray    # f64[B]
    alive: np.ndarray              # bool[B]


def aggregate(cl: Cluster, leader_load: np.ndarray, follower_load: np.ndarray,
              broker: np.ndarray, is_leader: np.ndarray,
              alive: Optional[np.ndarray] = None) -> Aggregates:
    """Per-broker sums of a placement, in float64."""
    alive = cl.alive if alive is None else alive
    b_n = cl.num_brokers
    broker = broker.astype(np.int64)
    lead = is_leader.astype(bool)
    ll = leader_load.astype(np.float64)
    load = np.where(lead[:, None], ll, follower_load.astype(np.float64))
    broker_load = np.stack([np.bincount(broker, load[:, k], b_n) for k in range(4)], axis=1)
    host_load = np.stack([np.bincount(cl.host, broker_load[:, k], cl.num_hosts)
                          for k in range(4)], axis=1)
    host_cap = np.stack([np.bincount(cl.host, np.where(alive, cl.capacity[:, k], 0.0),
                                     cl.num_hosts) for k in range(4)], axis=1)
    topic_counts = np.bincount(cl.topic * b_n + broker,
                               minlength=cl.num_topics * b_n).reshape(cl.num_topics, b_n)
    return Aggregates(
        broker_load=broker_load, host_load=host_load, host_capacity=host_cap,
        replica_counts=np.bincount(broker, minlength=b_n),
        leader_counts=np.bincount(broker, lead.astype(np.int64), b_n).astype(np.int64),
        topic_counts=topic_counts,
        potential_nw_out=np.bincount(broker, ll[:, NW_OUT], b_n),
        leader_bytes_in=np.bincount(broker, np.where(lead, ll[:, NW_IN], 0.0), b_n),
        alive=alive.astype(bool))


# ----------------------------------------------------------------- verdicts

Verdict = Tuple[str, int]          # (VIOLATED | SATISFIED | UNDECIDED, brokers beyond the margin)


def _beyond(value: np.ndarray, upper: np.ndarray,
            lower: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(beyond, near): the brokers past a load band by more than the margin
    EPS, and those within the margin of an edge."""
    tol = EPS * np.maximum(np.abs(upper), 1e-9)
    beyond = value - upper > tol
    near = np.abs(value - upper) <= tol
    if lower is not None:
        ltol = EPS * np.maximum(np.abs(lower), 1e-9)
        beyond |= lower - value > ltol
        near |= np.abs(lower - value) <= ltol
    return beyond, near


def _banded(beyond: np.ndarray, near: np.ndarray, alive: np.ndarray) -> Verdict:
    n = int((beyond & alive).sum())
    if n:
        return VIOLATED, n
    return (UNDECIDED if (near & alive).any() else SATISFIED), 0


def _load_verdict(value: np.ndarray, upper: np.ndarray, alive: np.ndarray,
                  lower: Optional[np.ndarray] = None) -> Verdict:
    """A load band over the alive brokers, judged with the margin EPS."""
    return _banded(*_beyond(value, upper, lower), alive)


def _exact(violated_brokers: np.ndarray) -> Verdict:
    n = int(violated_brokers.sum())
    return (VIOLATED if n else SATISFIED), n


def rack_violating_replicas(cl: Cluster, broker: np.ndarray) -> np.ndarray:
    """bool[R]: the replica shares its rack with another replica of its
    partition."""
    key = cl.partition * cl.num_racks + cl.rack[broker.astype(np.int64)]
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    return counts[inv] > 1


def rack_aware(cl, agg, pl, c) -> Verdict:
    viol = rack_violating_replicas(cl, pl["broker"])
    per_broker = np.bincount(pl["broker"].astype(np.int64), viol, cl.num_brokers) > 0
    return _exact(per_broker)


def replica_capacity(cl, agg, pl, c) -> Verdict:
    rc = agg.replica_counts
    return _exact((rc > c.max_replicas_per_broker) & agg.alive | ~agg.alive & (rc > 0))


def _capacity(res: int) -> Callable:
    def verdict(cl, agg, pl, c) -> Verdict:
        """The alive brokers past the bound, or on a host past it (a host
        resource is judged on the broker and on its host), as the port counts
        a capacity goal's violated brokers."""
        thr = c.capacity_threshold[res]
        beyond, near = _beyond(agg.broker_load[:, res], thr * cl.capacity[:, res])
        if res in HOST_RESOURCES:
            h = cl.host
            hb, hn = _beyond(agg.host_load[h, res], thr * agg.host_capacity[h, res])
            beyond, near = beyond | hb, near | hn
        return _banded(beyond, near, agg.alive)
    return verdict


def _f32_count_band(counts: np.ndarray, alive: np.ndarray, threshold: float):
    """(upper, lower) of a count goal, in float32 as the port states it."""
    n = np.float32(max(int(alive.sum()), 1))
    avg = np.float32(int(counts[alive].sum())) / n
    t = np.float32(threshold)
    upper = max(int(np.ceil(avg * t)), 1)
    lower = max(int(np.floor(avg * (np.float32(2.0) - t))), 0)
    return upper, lower


def _count_goal(counts: np.ndarray, alive: np.ndarray, threshold: float) -> Verdict:
    upper, lower = _f32_count_band(counts, alive, threshold)
    return _exact(((counts > upper) | (counts < lower)) & alive | ~alive & (counts > 0))


def replica_distribution(cl, agg, pl, c) -> Verdict:
    return _count_goal(agg.replica_counts, agg.alive, c.replica_balance_threshold)


def leader_replica_distribution(cl, agg, pl, c) -> Verdict:
    return _count_goal(agg.leader_counts, agg.alive, c.leader_replica_balance_threshold)


def topic_replica_distribution(cl, agg, pl, c) -> Verdict:
    alive = agg.alive
    n = np.float32(max(int(alive.sum()), 1))
    totals = agg.topic_counts[:, alive].sum(axis=1)
    avg = totals.astype(np.float32) / n
    t = np.float32(c.topic_replica_balance_threshold)
    upper = np.maximum(np.ceil(avg * t),
                       np.ceil(avg) + np.float32(c.topic_replica_balance_min_gap))
    lower = np.maximum(np.floor(avg * (np.float32(2.0) - t)), np.float32(0.0))
    tc = agg.topic_counts
    bad = ((tc > upper[:, None]) | (tc < lower[:, None])).any(axis=0)
    return _exact(bad & alive)


def _distribution(res: int) -> Callable:
    def verdict(cl, agg, pl, c) -> Verdict:
        alive = agg.alive
        avg = (agg.broker_load[alive, res].sum()
               / max(cl.capacity[alive, res].sum(), 1e-9))
        t = c.balance_threshold[res]
        cap = cl.capacity[:, res]
        lower = avg * (2.0 - t) * cap if avg >= c.low_utilization_threshold[res] else None
        return _load_verdict(agg.broker_load[:, res], avg * t * cap, alive, lower)
    return verdict


def potential_nw_out(cl, agg, pl, c) -> Verdict:
    limit = c.capacity_threshold[NW_OUT] * cl.capacity[:, NW_OUT]
    return _load_verdict(agg.potential_nw_out, limit, agg.alive)


def leader_bytes_in_distribution(cl, agg, pl, c) -> Verdict:
    alive = agg.alive
    mean = agg.leader_bytes_in[alive].sum() / max(int(alive.sum()), 1)
    limit = np.full(cl.num_brokers, mean * c.balance_threshold[NW_IN])
    return _load_verdict(agg.leader_bytes_in, limit, alive)


@dataclass(frozen=True)
class GoalDef:
    hard: bool
    verdict: Callable


#: The goals of cruise-control's ``default.goals``, by name.
GOALS: Dict[str, GoalDef] = {
    "RackAwareGoal": GoalDef(True, rack_aware),
    "ReplicaCapacityGoal": GoalDef(True, replica_capacity),
    "DiskCapacityGoal": GoalDef(True, _capacity(DISK)),
    "NetworkInboundCapacityGoal": GoalDef(True, _capacity(NW_IN)),
    "NetworkOutboundCapacityGoal": GoalDef(True, _capacity(NW_OUT)),
    "CpuCapacityGoal": GoalDef(True, _capacity(CPU)),
    "ReplicaDistributionGoal": GoalDef(False, replica_distribution),
    "PotentialNwOutGoal": GoalDef(False, potential_nw_out),
    "DiskUsageDistributionGoal": GoalDef(False, _distribution(DISK)),
    "NetworkInboundUsageDistributionGoal": GoalDef(False, _distribution(NW_IN)),
    "NetworkOutboundUsageDistributionGoal": GoalDef(False, _distribution(NW_OUT)),
    "CpuUsageDistributionGoal": GoalDef(False, _distribution(CPU)),
    "TopicReplicaDistributionGoal": GoalDef(False, topic_replica_distribution),
    "LeaderReplicaDistributionGoal": GoalDef(False, leader_replica_distribution),
    "LeaderBytesInDistributionGoal": GoalDef(False, leader_bytes_in_distribution),
}

DEFAULT_GOALS: List[str] = list(GOALS)
HARD_GOALS: List[str] = [n for n, g in GOALS.items() if g.hard]


def verdicts(cl: Cluster, agg: Aggregates, placement: Dict[str, np.ndarray],
             goal_names: List[str], constraint: Constraint) -> Dict[str, Verdict]:
    return {name: GOALS[name].verdict(cl, agg, placement, constraint) for name in goal_names}


@dataclass
class Structure:
    """Structural faults of a placement: a partition with two replicas on one
    broker, a partition without exactly one leader."""

    duplicate_partitions: int = 0
    leaderless_or_multi_leader: int = 0
    notes: List[str] = field(default_factory=list)

    @property
    def faults(self) -> int:
        return self.duplicate_partitions + self.leaderless_or_multi_leader


def structure(cl: Cluster, broker: np.ndarray, is_leader: np.ndarray) -> Structure:
    b = broker.astype(np.int64)
    if b.min() < 0 or b.max() >= cl.num_brokers:
        return Structure(duplicate_partitions=cl.num_partitions, notes=["broker out of range"])
    key = cl.partition * cl.num_brokers + b
    _, counts = np.unique(key, return_counts=True)
    leaders = np.bincount(cl.partition, is_leader.astype(np.int64), cl.num_partitions)
    return Structure(duplicate_partitions=int((counts > 1).sum()),
                     leaderless_or_multi_leader=int((leaders != 1).sum()))
