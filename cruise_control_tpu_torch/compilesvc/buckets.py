"""Shape-bucket policy: canonical padded shapes for every solver axis (the
JAX package's ``compilesvc/buckets.py``).

The JAX package pads to these buckets so that clusters of nearby sizes share
one compiled executable.  Torch compiles nothing per shape, but the port
keeps the same buckets: they decide when the resident model must fully
re-freeze (a cluster that crosses a bucket boundary changes its padded
shape), and they keep the port's padded arrays equal to the JAX package's.
The policy maps replicas R, brokers B, candidate width C and what-if lanes
L onto a geometric ladder.

``pad_targets`` feeds ``ClusterModel.freeze``'s ``pad_replicas_to`` /
``pad_brokers_to``, which are pad-to-MULTIPLE floors: a bucket value that is
>= the raw count pads to exactly that bucket.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

#: Default lane ladder for what-if batches; anything above
#: ``max_lane_bucket`` is chunked by the JAX package's lane planner.
DEFAULT_LANE_LADDER: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


def geometric_bucket(n: int, floor: int, growth: float = 2.0) -> int:
    """Smallest ``floor * growth**k`` (k >= 0, integer-rounded) >= ``n``."""
    if floor < 1:
        raise ValueError(f"bucket floor must be >= 1, got {floor}")
    if growth <= 1.0:
        raise ValueError(f"bucket growth must be > 1, got {growth}")
    bucket = floor
    n = max(int(n), 1)
    while bucket < n:
        bucket = max(bucket + 1, int(round(bucket * growth)))
    return bucket


def ladder_bucket(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder entry >= ``n`` (the top entry when ``n`` overshoots —
    callers chunk anything beyond the ladder)."""
    if not ladder:
        raise ValueError("empty lane ladder")
    n = max(int(n), 1)
    for step in sorted(ladder):
        if step >= n:
            return int(step)
    return int(max(ladder))


@dataclass(frozen=True)
class ShapeBucketPolicy:
    """Canonical pad targets for (R, B, C, L).

    ``replica_floor``/``broker_floor`` are the facade's floors (64 replicas,
    8 brokers), the smallest buckets.
    """

    replica_floor: int = 64
    broker_floor: int = 8
    growth: float = 2.0
    lane_ladder: Tuple[int, ...] = DEFAULT_LANE_LADDER
    #: Largest lane bucket; wider batches are chunked through it (64 -> 4x16).
    max_lane_bucket: int = 16

    def __post_init__(self):
        if self.max_lane_bucket not in self.lane_ladder:
            raise ValueError(
                f"max_lane_bucket {self.max_lane_bucket} not on the lane "
                f"ladder {self.lane_ladder}")

    def replica_bucket(self, n_replicas: int) -> int:
        return geometric_bucket(n_replicas, self.replica_floor, self.growth)

    def broker_bucket(self, n_brokers: int) -> int:
        return geometric_bucket(n_brokers, self.broker_floor, self.growth)

    def lane_bucket(self, n_lanes: int) -> int:
        return min(ladder_bucket(n_lanes, self.lane_ladder),
                   self.max_lane_bucket)

    def pad_targets(self, n_replicas: int, n_brokers: int) -> Tuple[int, int]:
        """(pad_replicas_to, pad_brokers_to) for ``ClusterModel.freeze`` —
        bucket values >= the raw counts, so pad-to-multiple pads to exactly
        the bucket."""
        return self.replica_bucket(n_replicas), self.broker_bucket(n_brokers)

    def bucket_label(self, num_replicas_padded: int, num_candidates: int,
                     lanes: int | None = None) -> str:
        """Stable per-bucket sensor label, e.g. ``R65536-C512`` or
        ``R65536-C512-L16``."""
        label = f"R{int(num_replicas_padded)}-C{int(num_candidates)}"
        if lanes is not None:
            label += f"-L{int(lanes)}"
        return label
