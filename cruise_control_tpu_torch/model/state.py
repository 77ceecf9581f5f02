"""Frozen structure-of-arrays cluster model, as dataclasses of torch tensors.

- ``ClusterState``  — immutable per-replica / per-broker tensors (the "what is").
- ``Placement``     — the three arrays the optimizer changes: replica->broker
  assignment, replica->disk assignment, and leadership.
- ``ClusterMeta``   — static host-side identity info (names, id maps, sizes).

Every array is padded to a static size; ``valid`` / ``broker_valid`` masks
gate padding.  Each replica stores both potential roles' load
(``leader_load`` / ``follower_load``); the effective load is selected by the
leadership mask, so a leadership transfer is a mask flip.

Dtypes follow the packed host arrays exactly: f32 loads and capacities, i32
ids, bool masks.  Index tensors stay int32 in storage and are widened to
int64 only where a scatter needs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES


@dataclasses.dataclass
class Placement:
    """The optimizer-mutable part of the cluster: where replicas sit and who leads.

    Shapes: ``broker``/``disk``/``is_leader`` are [R]; padded entries hold
    broker 0 / disk 0 / False and are masked out by ``ClusterState.valid``.
    """

    broker: torch.Tensor     # i32[R] dense broker index
    disk: torch.Tensor       # i32[R] disk index within broker (0 if non-JBOD)
    is_leader: torch.Tensor  # bool[R]

    def replace(self, **kw) -> "Placement":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class ClusterState:
    """Immutable cluster tensors (padded, static-shaped)."""

    # --- replica axis [R] ---
    leader_load: torch.Tensor    # f32[R, 4] load if this replica leads
    follower_load: torch.Tensor  # f32[R, 4] load if it follows (NW_OUT=0, reduced CPU)
    partition: torch.Tensor      # i32[R] dense partition id in [0, P)
    topic: torch.Tensor          # i32[R] dense topic id in [0, T)
    pos: torch.Tensor            # i32[R] index in the partition's replica list (0 = preferred leader)
    orig_broker: torch.Tensor    # i32[R] broker at snapshot time (immigrant tracking)
    offline: torch.Tensor        # bool[R] replica currently on a dead broker/disk
    valid: torch.Tensor          # bool[R] padding mask

    # --- broker axis [B] ---
    capacity: torch.Tensor       # f32[B, 4]
    host: torch.Tensor           # i32[B] dense host id in [0, H)
    rack: torch.Tensor           # i32[B] dense rack id in [0, K)
    alive: torch.Tensor          # bool[B]
    new_broker: torch.Tensor     # bool[B] recently-added broker
    broker_valid: torch.Tensor   # bool[B] padding mask

    # --- disk axis [B, D] (D = max logdirs per broker; 1 when non-JBOD) ---
    disk_capacity: torch.Tensor  # f32[B, D]
    disk_alive: torch.Tensor     # bool[B, D]

    @property
    def device(self) -> torch.device:
        return self.leader_load.device

    @property
    def num_replicas_padded(self) -> int:
        return self.leader_load.shape[0]

    @property
    def num_brokers_padded(self) -> int:
        return self.capacity.shape[0]

    @property
    def num_disks_per_broker(self) -> int:
        return self.disk_capacity.shape[1]


class ClusterMeta:
    """Static, host-side identity info for a snapshot.

    Maps dense indices used in ``ClusterState`` back to external identities
    (Kafka broker ids, topic names, rack/host names, topic-partitions).
    """

    def __init__(
        self,
        broker_ids: List[int],
        topics: List[str],
        partitions: List[Tuple[int, int]],   # dense pid -> (dense topic id, partition number)
        racks: List[str],
        hosts: List[str],
        num_replicas: int,
        num_brokers: int,
        extra: Optional[Dict[str, Any]] = None,
    ):
        self.broker_ids = broker_ids
        self.topics = topics
        self.partitions = partitions
        self.racks = racks
        self.hosts = hosts
        self.num_replicas = num_replicas      # true (unpadded) counts
        self.num_brokers = num_brokers
        self.extra = extra or {}
        self.broker_index = {b: i for i, b in enumerate(broker_ids)}

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    @property
    def num_topics(self) -> int:
        return len(self.topics)

    @property
    def num_racks(self) -> int:
        return len(self.racks)

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    def tp_name(self, pid: int) -> str:
        t, p = self.partitions[pid]
        return f"{self.topics[t]}-{p}"


def _pad_to(n: int, multiple: int) -> int:
    if multiple <= 1:
        return max(n, 1)
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


def pack_state_arrays(
    arrays: Dict[str, np.ndarray],
    pad_replicas_to: int = 1,
    pad_brokers_to: int = 1,
) -> Dict[str, np.ndarray]:
    """Pad and coerce the unpadded per-replica / per-broker numpy arrays to
    their final device dtypes: the 19-array packed dict that
    :func:`state_from_packed` turns into tensors."""
    r = arrays["leader_load"].shape[0]
    b = arrays["capacity"].shape[0]
    rp = _pad_to(r, pad_replicas_to)
    bp = _pad_to(b, pad_brokers_to)

    def pad(x: np.ndarray, n: int, fill) -> np.ndarray:
        if x.shape[0] == n:
            return x
        return np.pad(x, [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1),
                      constant_values=fill)

    def padr(x: np.ndarray, fill=0) -> np.ndarray:
        return pad(x, rp, fill)

    def padb(x: np.ndarray, fill=0) -> np.ndarray:
        return pad(x, bp, fill)

    return dict(
        leader_load=padr(arrays["leader_load"].astype(np.float32)),
        follower_load=padr(arrays["follower_load"].astype(np.float32)),
        partition=padr(arrays["partition"].astype(np.int32)),
        topic=padr(arrays["topic"].astype(np.int32)),
        pos=padr(arrays["pos"].astype(np.int32)),
        orig_broker=padr(arrays["orig_broker"].astype(np.int32)),
        offline=padr(arrays.get("offline", np.zeros(r, dtype=bool)).astype(bool)),
        valid=padr(np.ones(r, dtype=bool), False),
        capacity=padb(arrays["capacity"].astype(np.float32)),
        host=padb(arrays["host"].astype(np.int32)),
        rack=padb(arrays["rack"].astype(np.int32)),
        alive=padb(arrays.get("alive", np.ones(b, dtype=bool)), False),
        new_broker=padb(arrays.get("new_broker", np.zeros(b, dtype=bool)), False),
        broker_valid=padb(np.ones(b, dtype=bool), False),
        disk_capacity=padb(arrays["disk_capacity"].astype(np.float32)),
        disk_alive=padb(arrays["disk_alive"].astype(bool), False),
        assignment=padr(arrays["assignment"].astype(np.int32)),
        disk=padr(arrays.get("disk", np.zeros(r, dtype=np.int32)).astype(np.int32)),
        is_leader=padr(arrays["is_leader"].astype(bool)),
    )


_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(ClusterState))
_PACKED_DTYPES = (np.dtype(np.float32), np.dtype(np.int32), np.dtype(bool))


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype not in _PACKED_DTYPES:
        raise TypeError(f"packed array of dtype {x.dtype} (expected f32, i32 or bool)")
    return torch.tensor(x, device=device)


def state_from_packed(packed: Dict[str, np.ndarray],
                      device="cuda") -> Tuple[ClusterState, Placement]:
    """The packed 19-array dict (:func:`pack_state_arrays`, or the JAX
    package's ``freeze_packed``) as ``(ClusterState, Placement)`` on
    ``device``, keeping every dtype."""
    device = torch.device(device)
    state = ClusterState(**{k: _tensor(packed[k], device) for k in _STATE_FIELDS})
    placement = Placement(
        broker=_tensor(packed["assignment"], device),
        disk=_tensor(packed["disk"], device),
        is_leader=_tensor(packed["is_leader"], device),
    )
    return state, placement


def state_to_numpy(state: ClusterState,
                   placement: Placement) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_from_packed`: the packed dict of host arrays."""
    out = {k: getattr(state, k).cpu().numpy() for k in _STATE_FIELDS}
    out["assignment"] = placement.broker.cpu().numpy()
    out["disk"] = placement.disk.cpu().numpy()
    out["is_leader"] = placement.is_leader.cpu().numpy()
    return out


# --------------------------------------------------------------------- deltas

# Replica-axis fields a delta may rewrite, with the per-row dtype and shape
# each update array carries.  ``broker``/``disk``/``is_leader`` live on
# Placement; everything else on ClusterState.
REPLICA_DELTA_FIELDS: Tuple[Tuple[str, Any, Tuple[int, ...]], ...] = (
    ("leader_load", np.float32, (NUM_RESOURCES,)),
    ("follower_load", np.float32, (NUM_RESOURCES,)),
    ("partition", np.int32, ()),
    ("topic", np.int32, ()),
    ("pos", np.int32, ()),
    ("orig_broker", np.int32, ()),
    ("offline", np.bool_, ()),
    ("valid", np.bool_, ()),
    ("broker", np.int32, ()),
    ("disk", np.int32, ()),
    ("is_leader", np.bool_, ()),
)

BROKER_DELTA_FIELDS: Tuple[Tuple[str, Any], ...] = (
    ("capacity", np.float32),
    ("alive", np.bool_),
    ("new_broker", np.bool_),
    ("disk_capacity", np.float32),
    ("disk_alive", np.bool_),
)

_PLACEMENT_DELTA = frozenset({"broker", "disk", "is_leader"})


@dataclasses.dataclass
class ClusterDelta:
    """A sparse host-side edit script against a frozen snapshot.

    ``replica_idx``/``broker_idx`` name the rows to rewrite; the update dicts
    carry one array per rewritten field (same dtypes as the frozen tensors).
    ``perm`` (when set) is a full row permutation applied *before* the
    scatter: ``new_row i <- old_row perm[i]``; it carries surviving rows to
    their new positions after replica creation or deletion shifted the dense
    partition ids, and fresh and freed rows are always also in
    ``replica_idx``, so their gathered content is overwritten.  ``meta``
    replaces the snapshot's ClusterMeta when the partition table changed.
    """

    replica_idx: np.ndarray                  # i32[U]
    replica_updates: Dict[str, np.ndarray]   # REPLICA_DELTA_FIELDS arrays, [U,...]
    broker_idx: np.ndarray                   # i32[V]
    broker_updates: Dict[str, np.ndarray]    # BROKER_DELTA_FIELDS arrays, [V,...]
    perm: Optional[np.ndarray] = None        # i32[R_pad]
    meta: Optional[ClusterMeta] = None
    from_version: int = 0
    to_version: int = 0

    @property
    def num_updates(self) -> int:
        return int(self.replica_idx.shape[0]) + int(self.broker_idx.shape[0])

    @property
    def is_empty(self) -> bool:
        return self.num_updates == 0 and self.perm is None


def empty_delta(from_version: int = 0, to_version: int = 0) -> ClusterDelta:
    z = np.zeros(0, dtype=np.int32)
    return ClusterDelta(
        replica_idx=z,
        replica_updates={k: np.zeros((0,) + shp, dtype=dt)
                         for k, dt, shp in REPLICA_DELTA_FIELDS},
        broker_idx=z.copy(),
        broker_updates={},
        from_version=from_version, to_version=to_version)


def _scatter(x: torch.Tensor, idx: np.ndarray, upd: np.ndarray) -> torch.Tensor:
    """A copy of ``x`` with rows ``idx`` set to ``upd`` (an index write)."""
    out = x.clone()
    out[torch.as_tensor(idx, dtype=torch.int64, device=x.device)] = torch.as_tensor(
        upd, device=x.device)
    return out


def apply_deltas(state: ClusterState, placement: Placement,
                 delta: ClusterDelta) -> Tuple[ClusterState, Placement]:
    """``(state, placement)`` with ``delta`` applied: the permutation gather
    (when set), then the replica-row and broker-row index writes.  Returns
    new tensors and leaves the inputs as they were; equal, bit for bit, to a
    fresh freeze of the builder that emitted the delta."""
    rows = {k: getattr(placement if k in _PLACEMENT_DELTA else state, k)
            for k, _, _ in REPLICA_DELTA_FIELDS}
    if delta.perm is not None:
        perm = torch.as_tensor(delta.perm.astype(np.int64), device=state.device)
        # Fresh rows carry a negative perm entry: the clip makes the gather
        # well defined, and the scatter below overwrites what it fetched.
        cl = perm.clamp(0, state.num_replicas_padded - 1)
        rows = {k: v[cl] for k, v in rows.items()}
    if delta.replica_idx.shape[0]:
        rows = {k: _scatter(v, delta.replica_idx, delta.replica_updates[k])
                for k, v in rows.items()}
    brokers = {}
    if delta.broker_idx.shape[0] and delta.broker_updates:
        brokers = {k: _scatter(getattr(state, k), delta.broker_idx, delta.broker_updates[k])
                   for k, _ in BROKER_DELTA_FIELDS}
    state = dataclasses.replace(
        state, **{k: v for k, v in rows.items() if k not in _PLACEMENT_DELTA}, **brokers)
    return state, placement.replace(**{k: rows[k] for k in _PLACEMENT_DELTA})
