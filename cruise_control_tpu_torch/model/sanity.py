"""Vectorized model invariants (reference: ClusterModel.sanityCheck :1137-1287).

The reference walks the object tree asserting load sums are consistent
replica -> broker -> host -> rack -> cluster; with segment-sum aggregation that
consistency holds by construction, so the checks that remain meaningful are the
structural ones.  The JAX package's ``model/sanity.py``: the tensors are
copied to the host and checked there with numpy, on any device.
"""

from __future__ import annotations

from typing import List

import numpy as np

from cruise_control_tpu_torch.model.state import ClusterMeta, ClusterState, Placement


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def sanity_check(state: ClusterState, placement: Placement, meta: ClusterMeta,
                 allow_offline: bool = False) -> List[str]:
    """Return a list of violated-invariant descriptions (empty == healthy)."""
    problems: List[str] = []
    valid = _np(state.valid)
    bvalid = _np(state.broker_valid)
    alive = _np(state.alive)
    broker = _np(placement.broker)
    disk = _np(placement.disk)
    is_leader = _np(placement.is_leader)
    partition = _np(state.partition)

    r = valid.sum()
    if r != meta.num_replicas:
        problems.append(f"valid replica count {r} != meta.num_replicas {meta.num_replicas}")
    if bvalid.sum() != meta.num_brokers:
        problems.append(f"valid broker count {bvalid.sum()} != meta.num_brokers {meta.num_brokers}")

    # Replicas sit on valid brokers.
    vb = broker[valid]
    if vb.size and (vb.min() < 0 or vb.max() >= len(bvalid) or not bvalid[vb].all()):
        problems.append("replica assigned to invalid broker index")
        return problems

    # Exactly one leader per partition.
    leaders_per_p = np.bincount(partition[valid & is_leader], minlength=meta.num_partitions)
    missing = np.where(leaders_per_p == 0)[0]
    multi = np.where(leaders_per_p > 1)[0]
    if missing.size:
        problems.append(f"{missing.size} partitions without a leader, e.g. {meta.tp_name(int(missing[0]))}")
    if multi.size:
        problems.append(f"{multi.size} partitions with multiple leaders, e.g. {meta.tp_name(int(multi[0]))}")

    # No two replicas of one partition on the same broker.
    pb = partition[valid].astype(np.int64) * len(bvalid) + broker[valid]
    uniq, counts = np.unique(pb, return_counts=True)
    if (counts > 1).any():
        pid = int(uniq[counts > 1][0] // len(bvalid))
        problems.append(f"partition {meta.tp_name(pid)} has >1 replica on one broker")

    # Replicas on dead brokers / dead disks must be flagged offline.
    if not allow_offline:
        dead_broker = ~alive[np.clip(broker, 0, len(alive) - 1)]
        disk_alive = _np(state.disk_alive)
        dead_disk = ~disk_alive[np.clip(broker, 0, len(alive) - 1),
                                np.clip(disk, 0, state.num_disks_per_broker - 1)]
        bad = valid & (dead_broker | dead_disk)
        if bad.any():
            problems.append(f"{bad.sum()} replicas placed on dead brokers/disks")

    # Disk index bounds.
    if valid.any() and (disk[valid].min() < 0 or disk[valid].max() >= state.num_disks_per_broker):
        problems.append("replica disk index out of range")

    # Loads must be non-negative and finite.
    ll = _np(state.leader_load)[valid]
    fl = _np(state.follower_load)[valid]
    if not (np.isfinite(ll).all() and np.isfinite(fl).all()):
        problems.append("non-finite replica load")
    elif (ll < -1e-6).any() or (fl < -1e-6).any():
        problems.append("negative replica load")

    return problems
