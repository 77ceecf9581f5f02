"""Host-side mutable cluster model builder (the JAX package's
``model/builder.py``, line for line where the packed arrays are concerned).

This is the boundary between the outside world (metadata + metric samples, or
test fixtures) and the tensor model.  It mirrors the reference ClusterModel's
mutation API — ``createBroker`` :923-940, ``createReplica`` :802-883,
``setReplicaLoad`` :740-764, ``relocateReplica`` :375-389,
``relocateLeadership`` :402-434, ``setBrokerState`` :292-331,
``createOrDeleteReplicas`` :962-1027 — but exists only to *construct* snapshots:
``freeze()`` emits the (ClusterState, Placement, ClusterMeta) triple and all
optimization happens on those tensors, never on this object graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from cruise_control_tpu_torch.common.resources import Resource, NUM_RESOURCES
from cruise_control_tpu_torch.model import cpu_model
from cruise_control_tpu_torch.model.state import (
    BROKER_DELTA_FIELDS,
    ClusterDelta,
    ClusterMeta,
    ClusterState,
    Placement,
    REPLICA_DELTA_FIELDS,
    pack_state_arrays,
    state_from_packed,
    state_to_numpy,
)

LoadLike = Union[Dict[Resource, float], Sequence[float], np.ndarray]


def _load_array(load: LoadLike) -> np.ndarray:
    if isinstance(load, dict):
        arr = np.zeros(NUM_RESOURCES, dtype=np.float64)
        for k, v in load.items():
            arr[int(k)] = v
        return arr
    arr = np.asarray(load, dtype=np.float64)
    if arr.shape != (NUM_RESOURCES,):
        raise ValueError(f"load must have {NUM_RESOURCES} entries, got {arr.shape}")
    return arr.copy()


@dataclass
class Replica:
    topic: str
    partition: int
    broker_id: int
    is_leader: bool
    disk: int = 0
    leader_load: np.ndarray = field(default_factory=lambda: np.zeros(NUM_RESOURCES))
    follower_load: Optional[np.ndarray] = None  # derived from leader_load if None
    offline: bool = False
    orig_broker: Optional[int] = None

    def effective_follower_load(self) -> np.ndarray:
        if self.follower_load is not None:
            return self.follower_load
        fl = self.leader_load.copy()
        fl[Resource.NW_OUT] = 0.0
        fl[Resource.CPU] = cpu_model.follower_cpu_from_leader_load(
            self.leader_load[Resource.NW_IN], self.leader_load[Resource.NW_OUT],
            self.leader_load[Resource.CPU])
        return fl


@dataclass
class Broker:
    broker_id: int
    rack: str
    host: str
    capacity: np.ndarray                      # f64[4]
    disk_capacities: np.ndarray               # f64[D>=1]
    alive: bool = True
    new_broker: bool = False
    demoted: bool = False
    disk_alive: Optional[np.ndarray] = None   # bool[D]

    def __post_init__(self):
        if self.disk_alive is None:
            self.disk_alive = np.ones(len(self.disk_capacities), dtype=bool)


class ClusterModel:
    """Mutable cluster under construction; ``freeze()`` emits tensors."""

    def __init__(self):
        self._brokers: Dict[int, Broker] = {}
        # (topic, partition) -> ordered replica list (index 0 need not be leader;
        # ``pos`` order is the Kafka replica-list order; exactly one is_leader).
        self._partitions: Dict[Tuple[str, int], List[Replica]] = {}
        self._rack_order: List[str] = []
        self._host_order: List[str] = []
        # Incrementally-maintained counts so hot paths never re-walk the
        # partition map just to size a padding bucket.
        self._num_replicas = 0
        # Monotone mutation version; stamped into ClusterMeta.extra at freeze
        # so consumers can tell which builder state a snapshot reflects.
        self._version = 0
        # --- delta journal (see enable_delta_tracking) ---
        self._track = False
        self._touched: List[Replica] = []
        self._touched_brokers: set = set()
        self._structural = False
        self._full_refreeze_reason: Optional[str] = None
        self._frozen: Optional[dict] = None   # row bookkeeping from last freeze
        self._frozen_version = -1
        self._walk_token = 0

    # ----------------------------------------------------------- counts/version

    def counts(self) -> Tuple[int, int]:
        """(num_replicas, num_brokers) — O(1), maintained incrementally."""
        return self._num_replicas, len(self._brokers)

    @property
    def version(self) -> int:
        return self._version

    # ------------------------------------------------------------ delta journal

    def enable_delta_tracking(self) -> None:
        """Start journalling mutations so :meth:`collect_delta` can emit a
        sparse :class:`ClusterDelta` instead of forcing a full re-freeze.
        Row bookkeeping is (re)established by the next :meth:`freeze`."""
        self._track = True
        self._reset_journal()

    @property
    def delta_tracking(self) -> bool:
        return self._track

    def _reset_journal(self) -> None:
        self._touched = []
        self._touched_brokers = set()
        self._structural = False
        self._full_refreeze_reason = None

    # ------------------------------------------------------------------ brokers

    def create_broker(self, rack: str, host: str, broker_id: int, capacity: LoadLike,
                      disk_capacities: Optional[Sequence[float]] = None,
                      new_broker: bool = False) -> Broker:
        if broker_id in self._brokers:
            raise ValueError(f"broker {broker_id} already exists")
        cap = _load_array(capacity)
        if disk_capacities is None:
            disks = np.array([cap[Resource.DISK]], dtype=np.float64)
        else:
            disks = np.asarray(disk_capacities, dtype=np.float64)
            cap[Resource.DISK] = disks.sum()
        b = Broker(broker_id, rack, host, cap, disks, new_broker=new_broker)
        self._brokers[broker_id] = b
        if rack not in self._rack_order:
            self._rack_order.append(rack)
        if host not in self._host_order:
            self._host_order.append(host)
        self._version += 1
        if self._track:
            # A new broker changes the broker-axis identity (and possibly the
            # disk-axis width); deltas cannot express that.
            self._full_refreeze_reason = "broker-created"
        return b

    def broker(self, broker_id: int) -> Broker:
        return self._brokers[broker_id]

    def brokers(self) -> List[Broker]:
        return list(self._brokers.values())

    def _placement_offline(self, broker_id: int, disk: int) -> bool:
        """A replica is offline when its broker or its logdir is dead."""
        b = self._brokers[broker_id]
        return (not b.alive) or disk >= len(b.disk_alive) or not bool(b.disk_alive[disk])

    def set_broker_state(self, broker_id: int, alive: bool) -> None:
        """Reference ClusterModel.setBrokerState :292-331: killing a broker marks
        its replicas offline (they must be moved off)."""
        self._brokers[broker_id].alive = alive
        self._version += 1
        if self._track:
            self._touched_brokers.add(broker_id)
        for replicas in self._partitions.values():
            for r in replicas:
                if r.broker_id == broker_id:
                    r.offline = self._placement_offline(broker_id, r.disk)
                    if self._track:
                        self._touched.append(r)

    def mark_disk_dead(self, broker_id: int, disk: int) -> None:
        """Reference ClusterModel.markDiskDead :340."""
        b = self._brokers[broker_id]
        b.disk_alive[disk] = False
        b.capacity[Resource.DISK] = b.disk_capacities[b.disk_alive].sum()
        self._version += 1
        if self._track:
            self._touched_brokers.add(broker_id)
        for replicas in self._partitions.values():
            for r in replicas:
                if r.broker_id == broker_id and r.disk == disk:
                    r.offline = True
                    if self._track:
                        self._touched.append(r)

    # ----------------------------------------------------------------- replicas

    def create_replica(self, topic: str, partition: int, broker_id: int, index: int,
                       is_leader: bool, disk: int = 0) -> Replica:
        if broker_id not in self._brokers:
            raise ValueError(f"unknown broker {broker_id}")
        key = (topic, partition)
        replicas = self._partitions.setdefault(key, [])
        if any(r.broker_id == broker_id for r in replicas):
            raise ValueError(f"partition {key} already has a replica on broker {broker_id}")
        if is_leader and any(r.is_leader for r in replicas):
            raise ValueError(f"partition {key} already has a leader")
        if index < 0:
            raise ValueError(f"replica-list index must be >= 0, got {index}")
        r = Replica(topic, partition, broker_id, is_leader,
                    disk=disk, orig_broker=broker_id,
                    offline=self._placement_offline(broker_id, disk))
        replicas.insert(min(index, len(replicas)), r)
        self._num_replicas += 1
        self._version += 1
        if self._track:
            self._structural = True
        return r

    def replica(self, topic: str, partition: int, broker_id: int) -> Replica:
        for r in self._partitions[(topic, partition)]:
            if r.broker_id == broker_id:
                return r
        raise KeyError(f"no replica of {topic}-{partition} on broker {broker_id}")

    def partition(self, topic: str, partition: int) -> List[Replica]:
        return self._partitions[(topic, partition)]

    def partitions(self) -> Dict[Tuple[str, int], List[Replica]]:
        return self._partitions

    def set_replica_load(self, topic: str, partition: int, broker_id: int,
                         load: LoadLike, follower_load: Optional[LoadLike] = None) -> None:
        """Set a replica's leader-role load; follower-role load is derived via
        the CPU model unless given explicitly (reference: setReplicaLoad
        :740-764 + MonitorUtils.populatePartitionLoad :382-447)."""
        r = self.replica(topic, partition, broker_id)
        r.leader_load = _load_array(load)
        r.follower_load = None if follower_load is None else _load_array(follower_load)
        self._version += 1
        if self._track:
            self._touched.append(r)

    def delete_replica(self, topic: str, partition: int, broker_id: int) -> None:
        replicas = self._partitions[(topic, partition)]
        r = self.replica(topic, partition, broker_id)
        if r.is_leader and len(replicas) > 1:
            raise ValueError("cannot delete the leader while followers exist")
        replicas.remove(r)
        if not replicas:
            del self._partitions[(topic, partition)]
        self._num_replicas -= 1
        self._version += 1
        if self._track:
            self._structural = True

    def relocate_replica(self, topic: str, partition: int, src_broker: int, dst_broker: int,
                         dst_disk: int = 0) -> None:
        r = self.replica(topic, partition, src_broker)
        if any(x.broker_id == dst_broker for x in self._partitions[(topic, partition)]):
            raise ValueError(f"{topic}-{partition} already on broker {dst_broker}")
        r.broker_id = dst_broker
        r.disk = dst_disk
        r.offline = self._placement_offline(dst_broker, dst_disk)
        self._version += 1
        if self._track:
            self._touched.append(r)

    def relocate_leadership(self, topic: str, partition: int, src_broker: int,
                            dst_broker: int) -> bool:
        src = self.replica(topic, partition, src_broker)
        if not src.is_leader:
            return False
        dst = self.replica(topic, partition, dst_broker)
        if dst.is_leader:
            raise ValueError("destination is already the leader")
        src.is_leader = False
        dst.is_leader = True
        self._version += 1
        if self._track:
            self._touched.append(src)
            self._touched.append(dst)
        return True

    def create_or_delete_replicas(self, topic: str, target_rf: int,
                                  broker_order: Optional[List[int]] = None) -> None:
        """Change replication factor of a topic (reference: ClusterModel.
        createOrDeleteReplicas :962-1027).  New replicas are placed round-robin
        over alive brokers not already holding the partition; deletions drop
        the last non-leader replicas."""
        order = broker_order or sorted(b.broker_id for b in self._brokers.values() if b.alive)
        cursor = 0
        for (t, p), replicas in list(self._partitions.items()):
            if t != topic:
                continue
            while len(replicas) > target_rf:
                victim = next((r for r in reversed(replicas) if not r.is_leader), None)
                if victim is None:
                    raise ValueError(
                        f"cannot reduce {t}-{p} to rf={target_rf}: only the leader remains")
                replicas.remove(victim)
                self._num_replicas -= 1
                self._version += 1
                if self._track:
                    self._structural = True
            holders = {r.broker_id for r in replicas}
            while len(replicas) < target_rf:
                for _ in range(len(order)):
                    cand = order[cursor % len(order)]
                    cursor += 1
                    if cand not in holders:
                        break
                else:
                    raise ValueError(f"not enough brokers for rf={target_rf}")
                r = Replica(t, p, cand, is_leader=False, orig_broker=cand)
                # Followers inherit the partition's follower-role load profile.
                leader = next(x for x in replicas if x.is_leader)
                r.leader_load = leader.leader_load.copy()
                replicas.append(r)
                holders.add(cand)
                self._num_replicas += 1
                self._version += 1
                if self._track:
                    self._structural = True

    # ------------------------------------------------------------------- freeze

    def freeze(self, pad_replicas_to: int = 1, pad_brokers_to: int = 1,
               device="cuda") -> Tuple[ClusterState, Placement, ClusterMeta]:
        packed, meta = self.freeze_packed(pad_replicas_to=pad_replicas_to,
                                          pad_brokers_to=pad_brokers_to)
        state, placement = state_from_packed(packed, device)
        return state, placement, meta

    def freeze_packed(self, pad_replicas_to: int = 1, pad_brokers_to: int = 1,
                      ) -> Tuple[Dict[str, np.ndarray], ClusterMeta]:
        """Host half of :meth:`freeze`: walk the object graph into padded,
        dtype-final numpy arrays (see ``pack_state_arrays``) without touching
        the device.  ``state_from_packed`` turns the result into tensors."""
        broker_ids = list(self._brokers.keys())
        broker_index = {b: i for i, b in enumerate(broker_ids)}
        racks = list(self._rack_order)
        hosts = list(self._host_order)
        rack_index = {r: i for i, r in enumerate(racks)}
        host_index = {h: i for i, h in enumerate(hosts)}

        topics: List[str] = []
        topic_index: Dict[str, int] = {}
        partitions: List[Tuple[int, int]] = []
        replica_rows: List[Replica] = []
        part_of_replica: List[int] = []
        pos_of_replica: List[int] = []
        for (t, p), replicas in self._partitions.items():
            if t not in topic_index:
                topic_index[t] = len(topics)
                topics.append(t)
            pid = len(partitions)
            partitions.append((topic_index[t], p))
            for pos, r in enumerate(replicas):
                replica_rows.append(r)
                part_of_replica.append(pid)
                pos_of_replica.append(pos)

        r_n = len(replica_rows)
        b_n = len(broker_ids)
        d_n = max((len(b.disk_capacities) for b in self._brokers.values()), default=1)

        leader_load = np.zeros((r_n, NUM_RESOURCES))
        follower_load = np.zeros((r_n, NUM_RESOURCES))
        assignment = np.zeros(r_n, dtype=np.int64)
        disk = np.zeros(r_n, dtype=np.int64)
        is_leader = np.zeros(r_n, dtype=bool)
        topic_arr = np.zeros(r_n, dtype=np.int64)
        orig_broker = np.zeros(r_n, dtype=np.int64)
        offline = np.zeros(r_n, dtype=bool)
        for i, r in enumerate(replica_rows):
            leader_load[i] = r.leader_load
            follower_load[i] = r.effective_follower_load()
            assignment[i] = broker_index[r.broker_id]
            disk[i] = r.disk
            is_leader[i] = r.is_leader
            topic_arr[i] = topic_index[r.topic]
            orig_broker[i] = broker_index.get(r.orig_broker, broker_index[r.broker_id])
            offline[i] = r.offline

        capacity = np.zeros((b_n, NUM_RESOURCES))
        host_arr = np.zeros(b_n, dtype=np.int64)
        rack_arr = np.zeros(b_n, dtype=np.int64)
        alive = np.zeros(b_n, dtype=bool)
        new_broker = np.zeros(b_n, dtype=bool)
        disk_capacity = np.zeros((b_n, d_n))
        disk_alive = np.zeros((b_n, d_n), dtype=bool)
        for i, bid in enumerate(broker_ids):
            b = self._brokers[bid]
            capacity[i] = b.capacity
            host_arr[i] = host_index[b.host]
            rack_arr[i] = rack_index[b.rack]
            alive[i] = b.alive
            new_broker[i] = b.new_broker
            nd = len(b.disk_capacities)
            disk_capacity[i, :nd] = b.disk_capacities
            disk_alive[i, :nd] = b.disk_alive

        packed = pack_state_arrays(
            dict(leader_load=leader_load, follower_load=follower_load,
                 partition=np.asarray(part_of_replica), topic=topic_arr,
                 pos=np.asarray(pos_of_replica), orig_broker=orig_broker,
                 offline=offline, assignment=assignment, disk=disk,
                 is_leader=is_leader, capacity=capacity, host=host_arr,
                 rack=rack_arr, alive=alive, new_broker=new_broker,
                 disk_capacity=disk_capacity, disk_alive=disk_alive),
            pad_replicas_to=pad_replicas_to, pad_brokers_to=pad_brokers_to,
        )
        meta = ClusterMeta(broker_ids=broker_ids, topics=topics, partitions=partitions,
                           racks=racks, hosts=hosts, num_replicas=r_n, num_brokers=b_n,
                           extra={"model_version": self._version})
        if self._track:
            self._note_frozen(packed, replica_rows, broker_ids, broker_index,
                              np.asarray(part_of_replica, dtype=np.int32),
                              topic_arr.astype(np.int32),
                              np.asarray(pos_of_replica, dtype=np.int32))
        return packed, meta

    def _note_frozen(self, packed: Dict[str, np.ndarray],
                     replica_rows: List[Replica],
                     broker_ids: List[int], broker_index: Dict[int, int],
                     part_arr: np.ndarray, topic_arr: np.ndarray,
                     pos_arr: np.ndarray) -> None:
        """Record the row layout of the snapshot just frozen so later
        mutations can be resolved to dense rows by :meth:`collect_delta`."""
        pad_r = packed["leader_load"].shape[0]
        r_n = len(replica_rows)

        def padded(a: np.ndarray) -> np.ndarray:
            out = np.zeros(pad_r, dtype=np.int32)
            out[:r_n] = a
            return out

        for i, r in enumerate(replica_rows):
            r._row = i
        self._frozen = dict(
            pad_r=pad_r, pad_b=packed["capacity"].shape[0],
            d_n=packed["disk_capacity"].shape[1], count=r_n,
            broker_ids=list(broker_ids), broker_index=dict(broker_index),
            partition=padded(part_arr), topic=padded(topic_arr),
            pos=padded(pos_arr),
        )
        self._frozen_version = self._version
        self._reset_journal()

    # ------------------------------------------------------------ delta collect

    def collect_delta(self, max_updates: int = 1 << 20) -> Optional[ClusterDelta]:
        """Drain the mutation journal into a :class:`ClusterDelta` against the
        last frozen snapshot, or return ``None`` when the accumulated edits
        cannot be expressed as a bounded delta (new broker, too many touched
        rows, no prior freeze) and the caller must full-freeze instead.

        On success the journal is reset and the internal row bookkeeping is
        advanced, so the returned delta must be applied (the builder now
        believes the snapshot matches its current state).
        """
        if not self._track or self._frozen is None:
            return None
        if self._full_refreeze_reason is not None:
            return None
        if self._structural:
            delta = self._collect_structural(max_updates)
        else:
            delta = self._collect_sparse(max_updates)
        if delta is not None:
            delta.from_version = self._frozen_version
            delta.to_version = self._version
            self._frozen_version = self._version
            self._reset_journal()
        return delta

    def _replica_update_rows(self, pairs: List[Tuple[int, Optional[Replica]]],
                             part_arr: np.ndarray, topic_arr: np.ndarray,
                             pos_arr: np.ndarray,
                             broker_index: Dict[int, int],
                             ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Build the replica-axis update arrays for ``(row, replica)`` pairs
        (replica ``None`` ⇒ zero the row out: it was freed by deletions).
        Field dtypes/derivations mirror freeze() exactly so a delta-applied
        snapshot stays bitwise-identical to a fresh freeze."""
        u = len(pairs)
        upd = {k: np.zeros((u,) + shp, dtype=dt)
               for k, dt, shp in REPLICA_DELTA_FIELDS}
        idx = np.zeros(u, dtype=np.int32)
        for j, (row, r) in enumerate(pairs):
            idx[j] = row
            if r is None:
                continue
            upd["leader_load"][j] = r.leader_load.astype(np.float32)
            upd["follower_load"][j] = r.effective_follower_load().astype(np.float32)
            upd["partition"][j] = part_arr[row]
            upd["topic"][j] = topic_arr[row]
            upd["pos"][j] = pos_arr[row]
            upd["orig_broker"][j] = broker_index.get(
                r.orig_broker, broker_index[r.broker_id])
            upd["offline"][j] = r.offline
            upd["valid"][j] = True
            upd["broker"][j] = broker_index[r.broker_id]
            upd["disk"][j] = r.disk
            upd["is_leader"][j] = r.is_leader
        return idx, upd

    def _broker_update_rows(self) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        fz = self._frozen
        d_n = fz["d_n"]
        rows = sorted(fz["broker_index"][bid] for bid in self._touched_brokers)
        v = len(rows)
        if not v:
            return np.zeros(0, dtype=np.int32), {}
        idx = np.asarray(rows, dtype=np.int32)
        upd = {k: np.zeros((v, d_n) if k.startswith("disk_") else
                           ((v, NUM_RESOURCES) if k == "capacity" else (v,)),
                           dtype=dt)
               for k, dt in BROKER_DELTA_FIELDS}
        inv = {i: bid for bid, i in fz["broker_index"].items()}
        for j, row in enumerate(rows):
            b = self._brokers[inv[row]]
            upd["capacity"][j] = b.capacity.astype(np.float32)
            upd["alive"][j] = b.alive
            upd["new_broker"][j] = b.new_broker
            nd = len(b.disk_capacities)
            upd["disk_capacity"][j, :nd] = b.disk_capacities.astype(np.float32)
            upd["disk_alive"][j, :nd] = b.disk_alive
        return idx, upd

    def _collect_sparse(self, max_updates: int) -> Optional[ClusterDelta]:
        """No replicas were created/deleted: every touched replica still sits
        in its frozen row, so the delta is a plain scatter."""
        fz = self._frozen
        rows: Dict[int, Replica] = {}
        for r in self._touched:
            row = getattr(r, "_row", None)
            if row is None:
                return None   # mutated replica unknown to the last freeze
            rows[row] = r
        b_idx, b_upd = self._broker_update_rows()
        if len(rows) + len(b_idx) > max_updates:
            return None
        pairs = [(row, rows[row]) for row in sorted(rows)]
        idx, upd = self._replica_update_rows(
            pairs, fz["partition"], fz["topic"], fz["pos"], fz["broker_index"])
        return ClusterDelta(replica_idx=idx, replica_updates=upd,
                            broker_idx=b_idx, broker_updates=b_upd)

    def _collect_structural(self, max_updates: int) -> Optional[ClusterDelta]:
        """Replicas were created/deleted: dense partition ids and row order
        shift.  Re-walk the partition map exactly like freeze() (list
        structure only — no per-row field packing), derive the old→new row
        permutation, and emit updates only for rows whose identity fields
        moved plus journalled load/liveness touches and freed tail rows."""
        fz = self._frozen
        pad_r = fz["pad_r"]
        broker_index = fz["broker_index"]
        self._walk_token += 1
        token = self._walk_token

        topics: List[str] = []
        topic_index: Dict[str, int] = {}
        partitions: List[Tuple[int, int]] = []
        new_rows: List[Replica] = []
        part_of: List[int] = []
        pos_of: List[int] = []
        for (t, p), replicas in self._partitions.items():
            if t not in topic_index:
                topic_index[t] = len(topics)
                topics.append(t)
            pid = len(partitions)
            partitions.append((topic_index[t], p))
            for pos, r in enumerate(replicas):
                r._wtok = token
                r._new_row = len(new_rows)
                new_rows.append(r)
                part_of.append(pid)
                pos_of.append(pos)

        new_count = len(new_rows)
        old_count = fz["count"]
        if new_count > pad_r:
            return None   # outgrew the bucket — caller re-freezes (re-buckets)

        old_row = np.fromiter((getattr(r, "_row", -1) for r in new_rows),
                              dtype=np.int64, count=new_count)
        new_part = np.asarray(part_of, dtype=np.int32)
        new_pos = np.asarray(pos_of, dtype=np.int32)
        new_topic = np.fromiter((topic_index[r.topic] for r in new_rows),
                                dtype=np.int32, count=new_count)
        g = np.clip(old_row, 0, pad_r - 1)
        changed = (old_row < 0)
        changed |= fz["partition"][g] != new_part
        changed |= fz["pos"][g] != new_pos
        changed |= fz["topic"][g] != new_topic
        changed_set = {int(i) for i in np.nonzero(changed)[0]}
        for r in self._touched:
            if getattr(r, "_wtok", 0) == token:
                changed_set.add(r._new_row)
            # touched replicas absent from the walk were deleted; their old
            # rows are handled by the permutation + freed-tail updates.
        freed = range(new_count, old_count)
        b_idx, b_upd = self._broker_update_rows()
        if len(changed_set) + len(freed) + len(b_idx) > max_updates:
            return None

        pairs: List[Tuple[int, Optional[Replica]]] = (
            [(i, new_rows[i]) for i in sorted(changed_set)]
            + [(i, None) for i in freed])
        idx, upd = self._replica_update_rows(
            pairs, new_part, new_topic, new_pos, broker_index)

        perm = np.arange(pad_r, dtype=np.int32)
        perm[:new_count] = old_row
        meta = ClusterMeta(
            broker_ids=list(fz["broker_ids"]), topics=topics,
            partitions=partitions, racks=list(self._rack_order),
            hosts=list(self._host_order), num_replicas=new_count,
            num_brokers=len(fz["broker_ids"]),
            extra={"model_version": self._version})

        # Commit the new row layout.
        for i, r in enumerate(new_rows):
            r._row = i
        def padded(a: np.ndarray) -> np.ndarray:
            out = np.zeros(pad_r, dtype=np.int32)
            out[:new_count] = a
            return out
        fz["partition"] = padded(new_part)
        fz["topic"] = padded(new_topic)
        fz["pos"] = padded(new_pos)
        fz["count"] = new_count
        return ClusterDelta(replica_idx=idx, replica_updates=upd,
                            broker_idx=b_idx, broker_updates=b_upd,
                            perm=perm, meta=meta)

    # ---------------------------------------------------------------- apply-back

    def apply_placement(self, placement: Placement, meta: ClusterMeta) -> None:
        """Mutate this model to match an optimized placement (used by tests and
        by multi-goal host orchestration when a goal runs on the builder)."""
        broker = placement.broker.cpu().numpy()
        disk = placement.disk.cpu().numpy()
        is_leader = placement.is_leader.cpu().numpy()
        total = sum(len(rs) for rs in self._partitions.values())
        if total != meta.num_replicas:
            raise ValueError(
                f"placement holds {meta.num_replicas} replicas but model has {total}; "
                "was the model edited after freeze()?")
        i = 0
        for (t, p), replicas in self._partitions.items():
            for r in replicas:
                r.broker_id = meta.broker_ids[int(broker[i])]
                r.disk = int(disk[i])
                r.is_leader = bool(is_leader[i])
                r.offline = self._placement_offline(r.broker_id, r.disk)
                i += 1
        self._version += 1
        if self._track:
            # Rewrites every replica; cheaper to re-freeze than to delta.
            self._full_refreeze_reason = "apply-placement"


def builder_from_snapshot(state: ClusterState, placement: Placement,
                          meta: ClusterMeta) -> ClusterModel:
    """Reconstruct a mutable ClusterModel from frozen tensors.

    Inverse of :meth:`ClusterModel.freeze` up to rack/host *ordering* (which
    is rebuilt first-seen over broker order): re-freezing the returned builder
    yields tensors bitwise-identical to re-freezing any builder that produced
    the snapshot, making it the seam for delta-equivalence fuzzing and for
    benching the resident path from generated (builder-less) clusters.
    """
    cm = ClusterModel()
    arr = state_to_numpy(state, placement)
    cap = arr["capacity"].astype(np.float64)
    host = arr["host"]
    rack = arr["rack"]
    alive = arr["alive"]
    newb = arr["new_broker"]
    dcap = arr["disk_capacity"].astype(np.float64)
    dalive = arr["disk_alive"]
    for i, bid in enumerate(meta.broker_ids):
        b = cm.create_broker(meta.racks[int(rack[i])], meta.hosts[int(host[i])],
                             int(bid), cap[i], disk_capacities=dcap[i],
                             new_broker=bool(newb[i]))
        b.alive = bool(alive[i])
        b.disk_alive = dalive[i].copy()
        # Restore the exact (possibly dead-disk-reduced) capacity vector.
        b.capacity = cap[i].copy()

    n = meta.num_replicas
    part = arr["partition"][:n]
    pos = arr["pos"][:n]
    offline = arr["offline"][:n]
    orig = arr["orig_broker"][:n]
    ll = arr["leader_load"].astype(np.float64)[:n]
    fl = arr["follower_load"].astype(np.float64)[:n]
    broker = arr["assignment"][:n]
    disk = arr["disk"][:n]
    lead = arr["is_leader"][:n]
    order = np.lexsort((pos, part))
    for row in order:
        row = int(row)
        t_i, p_num = meta.partitions[int(part[row])]
        r = cm.create_replica(meta.topics[t_i], int(p_num),
                              meta.broker_ids[int(broker[row])],
                              index=int(pos[row]), is_leader=bool(lead[row]),
                              disk=int(disk[row]))
        r.leader_load = ll[row]
        # Keep the frozen follower load verbatim (the CPU-model derivation
        # would re-round through float32 differently).
        r.follower_load = fl[row]
        r.offline = bool(offline[row])
        r.orig_broker = meta.broker_ids[int(orig[row])]
    return cm
