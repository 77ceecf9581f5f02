"""Cluster snapshot serialization.

Two codecs, with the JAX package's file formats
(``cruise_control_tpu/model/snapshot.py``), so one snapshot file feeds both
packages:

- JSON: human-readable, brokers and partitions with per-resource loads (the
  schema of the reference's ``load`` endpoint); read into a
  :class:`ClusterModel`, which ``freeze`` turns into tensors.
- NPZ: the packed arrays, for large snapshots.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.builder import ClusterModel
from cruise_control_tpu_torch.model.state import (
    ClusterMeta,
    ClusterState,
    Placement,
    pack_state_arrays,
    state_from_packed,
    state_to_numpy,
)

_RES_KEYS = ("cpu", "networkInbound", "networkOutbound", "disk")


def model_to_json_dict(cm: ClusterModel) -> Dict:
    brokers = []
    for b in cm.brokers():
        brokers.append({
            "brokerId": b.broker_id,
            "rack": b.rack,
            "host": b.host,
            "alive": b.alive,
            "newBroker": b.new_broker,
            "capacity": {k: float(b.capacity[i]) for i, k in enumerate(_RES_KEYS)},
            "diskCapacities": [float(x) for x in b.disk_capacities],
            "diskAlive": [bool(x) for x in b.disk_alive],
        })
    partitions = []
    for (topic, part), replicas in cm.partitions().items():
        partitions.append({
            "topic": topic,
            "partition": part,
            "replicas": [{
                "brokerId": r.broker_id,
                "isLeader": r.is_leader,
                "disk": r.disk,
                "load": {k: float(r.leader_load[i]) for i, k in enumerate(_RES_KEYS)},
                "followerLoad": (None if r.follower_load is None else
                                 {k: float(r.follower_load[i])
                                  for i, k in enumerate(_RES_KEYS)}),
            } for r in replicas],
        })
    return {"version": 1, "brokers": brokers, "partitions": partitions}


def model_from_json_dict(doc: Dict) -> ClusterModel:
    cm = ClusterModel()
    for b in doc["brokers"]:
        cap = {Resource.from_name(k): v for k, v in b["capacity"].items()}
        disks = b.get("diskCapacities")
        cm.create_broker(rack=b["rack"], host=b.get("host", f"h{b['brokerId']}"),
                         broker_id=b["brokerId"], capacity=cap,
                         disk_capacities=disks if disks and len(disks) > 1 else None,
                         new_broker=b.get("newBroker", False))
    for p in doc["partitions"]:
        for i, r in enumerate(p["replicas"]):
            cm.create_replica(p["topic"], p["partition"], broker_id=r["brokerId"],
                              index=i, is_leader=r["isLeader"], disk=r.get("disk", 0))
            load = [r["load"][k] for k in _RES_KEYS]
            fl = r.get("followerLoad")
            cm.set_replica_load(p["topic"], p["partition"], r["brokerId"], load,
                                follower_load=None if fl is None
                                else [fl[k] for k in _RES_KEYS])
    # Dead brokers and dead disks: applied after the replicas exist, so the
    # offline flags propagate to them.
    for b in doc["brokers"]:
        if not b.get("alive", True):
            cm.set_broker_state(b["brokerId"], alive=False)
        for d, ok in enumerate(b.get("diskAlive", [])):
            if not ok:
                cm.mark_disk_dead(b["brokerId"], d)
    return cm


def save_json(cm: ClusterModel, path: str) -> None:
    with open(path, "w") as f:
        json.dump(model_to_json_dict(cm), f)


def load_json(path: str) -> ClusterModel:
    with open(path) as f:
        return model_from_json_dict(json.load(f))


# ------------------------------------------------------------------ NPZ codec

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
