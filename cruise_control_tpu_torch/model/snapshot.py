"""Cluster snapshot serialization: the NPZ codec.

The file layout is the JAX package's (``cruise_control_tpu/model/snapshot.py``
``save_npz`` / ``load_npz``), so one snapshot file feeds both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from cruise_control_tpu_torch.model.state import (
    ClusterMeta,
    ClusterState,
    Placement,
    pack_state_arrays,
    state_from_packed,
    state_to_numpy,
)

_REPLICA_KEYS = ("leader_load", "follower_load", "partition", "topic", "pos",
                 "orig_broker", "offline", "assignment", "disk", "is_leader")
_BROKER_KEYS = ("capacity", "host", "rack", "alive", "new_broker",
                "disk_capacity", "disk_alive")


def save_npz(path: str, state: ClusterState, placement: Placement,
             meta: ClusterMeta) -> None:
    np.savez_compressed(
        path,
        **state_to_numpy(state, placement),
        meta_broker_ids=np.asarray(meta.broker_ids),
        meta_topics=np.asarray(meta.topics),
        meta_partitions=np.asarray(meta.partitions),
        meta_racks=np.asarray(meta.racks),
        meta_hosts=np.asarray(meta.hosts),
        meta_counts=np.asarray([meta.num_replicas, meta.num_brokers]),
    )


def load_npz(path: str, device="cuda") -> Tuple[ClusterState, Placement, ClusterMeta]:
    """Read a snapshot (saved padded) and trim it to its true counts."""
    with np.load(path, allow_pickle=False) as z:
        n_r, n_b = (int(x) for x in z["meta_counts"])
        arrays = {k: np.asarray(z[k])[:n_r] for k in _REPLICA_KEYS}
        arrays.update({k: np.asarray(z[k])[:n_b] for k in _BROKER_KEYS})
        meta = ClusterMeta(
            broker_ids=[int(x) for x in z["meta_broker_ids"]],
            topics=[str(x) for x in z["meta_topics"]],
            partitions=[(int(a), int(b)) for a, b in z["meta_partitions"]],
            racks=[str(x) for x in z["meta_racks"]],
            hosts=[str(x) for x in z["meta_hosts"]],
            num_replicas=n_r, num_brokers=n_b,
        )
    state, placement = state_from_packed(pack_state_arrays(arrays), device)
    return state, placement, meta
