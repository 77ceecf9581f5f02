"""Device-resident cluster model: keep frozen tensors on the card across
requests and apply builder deltas instead of re-freezing (the JAX package's
``model/resident.py``).

Every propose/what-if request would otherwise pay a full O(cluster) host
pack plus a host→device transfer (``builder.freeze``) before the solver
starts.  The :class:`ResidentModelService` keeps the last (ClusterState,
Placement, ClusterMeta) triple on its device, keyed by its shape bucket, and
on the next request asks the builder for a
:class:`~cruise_control_tpu_torch.model.state.ClusterDelta` — a sparse edit
script of a few KB that :func:`~cruise_control_tpu_torch.model.state.
apply_deltas` writes into copies of the resident tensors on the device.  A
full freeze happens only when the delta contract cannot hold:

- no resident entry yet, or a different builder object (monitor rebuilt);
- the shape bucket changed (cluster outgrew / shrank past a pad boundary);
- the builder journalled an inexpressible edit (new broker, apply_placement);
- the delta overflowed ``max_delta_slots`` touched rows;
- ``max_delta_chain`` consecutive applies since the last full freeze;
- an explicit :meth:`invalidate`.

The JAX package's apply donates (deletes) the resident buffers, so an apply
waits for pinned solves to drain.  The port's apply never writes into the
tensors it was given (it copies each field on the device, then writes the
rows), so a pinned solve's tensors stay valid either way.  The service
keeps the JAX pin contract all the same (wait up to ``pin_wait_s``, then a
full freeze), so the two packages count the same freezes and applies for
the same requests; in the port that wait is a stall, not a safety need.  A
failed apply raises: the service never carries on on another device.

Sensors: ``Model.full-freezes``, ``Model.delta-applies``,
``Model.resident-invalidations``.  Spans: ``model.freeze`` (host pack),
``model.transfer`` (host→device), ``model.delta_apply``; the last two
synchronise the device before they close, so they time the work, not its
enqueue.

Memory ledger (``resident-model`` subsystem): a full freeze posts the new
tensors' alloc (and the replaced entry's free), an invalidation the entry's
free, a pin and a release their events.  Where the JAX package posts a
donation (its apply writes into the old buffers), the port's apply made
copies, so it posts the copy's alloc and the old tensors' free.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.common.metrics import registry as _metric_registry
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES
from cruise_control_tpu_torch.compilesvc.buckets import geometric_bucket
from cruise_control_tpu_torch.model.builder import ClusterModel
from cruise_control_tpu_torch.model.state import (
    BROKER_DELTA_FIELDS,
    REPLICA_DELTA_FIELDS,
    ClusterDelta,
    ClusterMeta,
    ClusterState,
    Placement,
    apply_deltas,
    empty_delta,
    state_from_packed,
)
from cruise_control_tpu_torch.obsvc.memory import SUBSYS_RESIDENT, measure_bytes, memory_ledger
from cruise_control_tpu_torch.obsvc.tracer import tracer as _tracer

LOG = logging.getLogger(__name__)

FULL_FREEZE_SENSOR = "Model.full-freezes"
DELTA_APPLY_SENSOR = "Model.delta-applies"
INVALIDATION_SENSOR = "Model.resident-invalidations"

# Update-slot ladder floor: the JAX package pads a delta to a geometric slot
# bucket so its scatter executable keeps one shape.  Torch needs no padding;
# the bucket is kept as the apply span's ``slots`` attribute, so traces of
# the two packages line up.
DELTA_SLOT_FLOOR = 64
DELTA_SLOT_GROWTH = 2.0


def _tensors(state: ClusterState, placement: Placement) -> list:
    return [getattr(x, f.name) for x in (state, placement) for f in dataclasses.fields(x)]


def _missing_from(tensors: list, others: list) -> list:
    """The tensors of ``tensors`` that are not (as objects) in ``others``."""
    ids = {id(t) for t in others}
    return [t for t in tensors if id(t) not in ids]


def _synchronize(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (a no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class ResidentModelService:
    """Owns the device-resident (state, placement, meta) triple.

    All access is serialized by :attr:`lock`; a caller holds it across the
    monitor's builder update + snapshot (pass a callable to :meth:`snapshot`)
    so delta collection never races a concurrent request's apply.
    """

    def __init__(self, enabled: bool = True, max_delta_slots: int = 8192,
                 max_delta_chain: int = 512,
                 pin_wait_s: float = 0.5,
                 device="cuda"):
        self.enabled = bool(enabled)
        self.max_delta_slots = int(max_delta_slots)
        self.max_delta_chain = int(max_delta_chain)
        # How long a delta apply waits for pinned solves to drain before
        # taking a full freeze instead.
        self.pin_wait_s = float(pin_wait_s)
        self.device = torch.device(device)
        self.lock = threading.RLock()
        # Requests "pin" the tensors they received while their solve is in
        # flight; a delta apply waits for the pin count to drain first.
        self._cond = threading.Condition(self.lock)
        self._pins = 0
        self._entry: Optional[dict] = None
        self._invalidation_reasons: Dict[str, int] = {}
        # Materialize the counters at construction so a scrape sees them
        # before the first request.
        reg = _metric_registry()
        self._full_freezes = reg.counter(FULL_FREEZE_SENSOR)
        self._delta_applies = reg.counter(DELTA_APPLY_SENSOR)
        self._invalidations = reg.counter(INVALIDATION_SENSOR)

    # ------------------------------------------------------------------ public

    def delta_slots(self, n: int) -> int:
        """An update count's geometric slot bucket (capped at
        ``max_delta_slots`` — collect already refused anything larger)."""
        return min(geometric_bucket(max(n, 1), DELTA_SLOT_FLOOR, DELTA_SLOT_GROWTH),
                   max(self.max_delta_slots, DELTA_SLOT_FLOOR))

    def invalidate(self, reason: str) -> None:
        """Drop the resident entry (config reload, a device fault); the next
        snapshot will full-freeze."""
        with self.lock:
            if self._entry is None:
                return
            memory_ledger().post(SUBSYS_RESIDENT, self._entry.get("nbytes", 0), kind="free")
            self._entry = None
            self._invalidations.inc()
            self._invalidation_reasons[reason] = (
                self._invalidation_reasons.get(reason, 0) + 1)
            LOG.info("resident model invalidated: %s", reason)

    def snapshot(self, builder_or_fn,
                 pad_fn: Callable[[int, int], Tuple[int, int]],
                 pin: bool = False,
                 ) -> Tuple[ClusterState, Placement, ClusterMeta]:
        """Tensors on :attr:`device` for the builder's current state — via a
        delta apply onto the resident tensors when possible, via a full
        freeze otherwise.  ``pad_fn`` maps true (replicas, brokers) counts to
        the padded bucket (``ShapeBucketPolicy().pad_targets``).

        ``builder_or_fn`` is a ClusterModel or a zero-arg callable returning
        one; callables run under :attr:`lock` so monitor-side builder updates
        cannot race a concurrent request's delta collection.  With
        ``pin=True`` the returned tensors are pinned until the caller
        invokes :meth:`release` (wrap the solve in try/finally).
        """
        with self.lock:
            builder = builder_or_fn() if callable(builder_or_fn) \
                else builder_or_fn
            n_r, n_b = builder.counts()
            bucket = pad_fn(n_r, n_b)
            e = self._entry
            delta: Optional[ClusterDelta] = None
            if (self.enabled and e is not None and e["builder"] is builder
                    and e["bucket"] == bucket and builder.delta_tracking):
                if builder.version == e["version"]:
                    delta = empty_delta(e["version"], e["version"])
                elif e["chain"] < self.max_delta_chain:
                    delta = builder.collect_delta(
                        max_updates=self.max_delta_slots)
            if delta is not None:
                if delta.is_empty and builder.version == e["version"]:
                    out = e["state"], e["placement"], e["meta"]
                elif self._wait_unpinned(self.pin_wait_s):
                    out = self._apply(e, builder, delta)
                else:
                    # A pin leaked or a solve is wedged; a full freeze is
                    # always safe.
                    LOG.warning("resident pins did not drain; falling back "
                                "to full freeze")
                    out = self._full_freeze(builder, bucket)
            else:
                out = self._full_freeze(builder, bucket)
            if pin:
                self._pins += 1
                memory_ledger().post(SUBSYS_RESIDENT, 0, kind="pin")
            return out

    def release(self) -> None:
        """Drop a ``pin=True`` snapshot's pin; lets pending deltas apply."""
        with self._cond:
            if self._pins > 0:
                memory_ledger().post(SUBSYS_RESIDENT, 0, kind="release")
            self._pins = max(0, self._pins - 1)
            self._cond.notify_all()

    def stats(self) -> dict:
        with self.lock:
            e = self._entry
            return {
                "enabled": self.enabled,
                "resident": e is not None,
                "bucket": list(e["bucket"]) if e else None,
                "deltaChain": e["chain"] if e else 0,
                "modelVersion": e["version"] if e else None,
                "fullFreezes": int(self._full_freezes.count),
                "deltaApplies": int(self._delta_applies.count),
                "invalidations": int(self._invalidations.count),
                "invalidationReasons": dict(self._invalidation_reasons),
            }

    def warm_scatter(self, pad_r: int, pad_b: int, num_disks: int = 1) -> None:
        """Run each kind of delta apply once at boot over zeroed tensors of
        a shape bucket on :attr:`device`: a one-row replica delta, the same
        with a row permutation, and a one-row broker delta.  Torch compiles
        nothing per shape; this loads the index kernels the applies launch,
        so the first request does not pay for it."""
        def zeros():
            d = self.device
            z = lambda *shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device=d)  # noqa: E731
            state = ClusterState(
                leader_load=z(pad_r, NUM_RESOURCES, dtype=torch.float32),
                follower_load=z(pad_r, NUM_RESOURCES, dtype=torch.float32),
                partition=z(pad_r), topic=z(pad_r), pos=z(pad_r), orig_broker=z(pad_r),
                offline=z(pad_r, dtype=torch.bool), valid=z(pad_r, dtype=torch.bool),
                capacity=z(pad_b, NUM_RESOURCES, dtype=torch.float32),
                host=z(pad_b), rack=z(pad_b),
                alive=z(pad_b, dtype=torch.bool), new_broker=z(pad_b, dtype=torch.bool),
                broker_valid=z(pad_b, dtype=torch.bool),
                disk_capacity=z(pad_b, num_disks, dtype=torch.float32),
                disk_alive=z(pad_b, num_disks, dtype=torch.bool))
            placement = Placement(broker=z(pad_r), disk=z(pad_r),
                                  is_leader=z(pad_r, dtype=torch.bool))
            return state, placement

        for perm in (None, np.arange(pad_r, dtype=np.int32)):
            d = empty_delta()
            d.replica_idx = np.zeros(1, dtype=np.int32)
            d.replica_updates = {k: np.zeros((1,) + shp, dtype=dt)
                                 for k, dt, shp in REPLICA_DELTA_FIELDS}
            d.perm = perm
            st, _ = apply_deltas(*zeros(), d)
            _synchronize(st.valid)
        shapes = {"capacity": (1, NUM_RESOURCES),
                  "disk_capacity": (1, num_disks), "disk_alive": (1, num_disks)}
        d = empty_delta()
        d.broker_idx = np.zeros(1, dtype=np.int32)
        d.broker_updates = {name: np.zeros(shapes.get(name, (1,)), dtype)
                            for name, dtype in BROKER_DELTA_FIELDS}
        st, _ = apply_deltas(*zeros(), d)
        _synchronize(st.valid)

    # ----------------------------------------------------------------- private

    def _wait_unpinned(self, timeout: float) -> bool:
        """Wait for pinned solves to drain.  The condition shares
        :attr:`lock`, so waiting releases it and pinned requests can finish
        and call :meth:`release`."""
        deadline = time.monotonic() + timeout
        while self._pins > 0:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self._cond.wait(timeout=min(remaining, 1.0))
        return True

    def _apply(self, entry: dict, builder: ClusterModel, delta: ClusterDelta,
               ) -> Tuple[ClusterState, Placement, ClusterMeta]:
        with _tracer().span("model.delta_apply", updates=delta.num_updates,
                            slots=self.delta_slots(int(delta.replica_idx.shape[0])),
                            structural=delta.perm is not None):
            state, placement = apply_deltas(entry["state"], entry["placement"], delta)
            _synchronize(state.valid)
        meta = delta.meta if delta.meta is not None else entry["meta"]
        old = _tensors(entry["state"], entry["placement"])
        new = _tensors(state, placement)
        entry.update(state=state, placement=placement, meta=meta,
                     version=builder.version, chain=entry["chain"] + 1,
                     nbytes=measure_bytes(new))
        self._delta_applies.inc()
        # The apply wrote into copies of the fields it changed: those copies
        # are allocated and the tensors they replace freed (the JAX package
        # posts one net-zero donation here).
        memory_ledger().post(SUBSYS_RESIDENT, measure_bytes(_missing_from(new, old)),
                             kind="alloc")
        memory_ledger().post(SUBSYS_RESIDENT, measure_bytes(_missing_from(old, new)),
                             kind="free")
        return state, placement, meta

    def _full_freeze(self, builder: ClusterModel, bucket: Tuple[int, int],
                     ) -> Tuple[ClusterState, Placement, ClusterMeta]:
        n_r, n_b = builder.counts()
        if self.enabled and not builder.delta_tracking:
            builder.enable_delta_tracking()
        with _tracer().span("model.freeze", replicas=n_r, brokers=n_b):
            packed, meta = builder.freeze_packed(pad_replicas_to=bucket[0],
                                                 pad_brokers_to=bucket[1])
        with _tracer().span("model.transfer"):
            state, placement = state_from_packed(packed, self.device)
            _synchronize(state.valid)
        self._full_freezes.inc()
        if self.enabled:
            nbytes = measure_bytes((state, placement))
            if self._entry is not None:
                # Replacing the entry: the old tensors are unreferenced once
                # in-flight pinned solves drain.
                memory_ledger().post(SUBSYS_RESIDENT, self._entry.get("nbytes", 0),
                                     kind="free")
            memory_ledger().post(SUBSYS_RESIDENT, nbytes, kind="alloc")
            self._entry = dict(builder=builder, bucket=bucket, state=state,
                               placement=placement, meta=meta,
                               version=builder.version, chain=0, nbytes=nbytes)
        return state, placement, meta
