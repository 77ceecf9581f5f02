"""Optimization context and incremental aggregates.

The reference pushes load deltas up the replica→broker→host→rack tree on
every action (``model/ClusterModel.java:375-434``).  Here the same
bookkeeping is a small set of dense tensors (``Aggregates``): applying a
batch of moves is a handful of scatter-adds, and every goal predicate is a
broadcastable function of (context, aggregates, replica index, destination)
used for the batched C×B feasibility matrices.

Partition membership never changes during optimization, so
``partition_replicas: i32[P, RF_max]`` (replica rows per partition, -1 pad)
is precomputed once per snapshot: "does broker b hold partition p" is an
RF-wide gather, never a P×B matrix.

Tensors are never updated in place: every update returns new tensors, so an
``Aggregates`` handed from one goal to the next stays valid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.model.ops import segment_sum
from cruise_control_tpu_torch.model.state import ClusterMeta, ClusterState, Placement
from cruise_control_tpu_torch.ops.aggregate import broker_channel_sums


def hash01(a: torch.Tensor, b) -> torch.Tensor:
    """Deterministic pseudo-uniform [0,1) from two index/seed tensors
    (broadcast): the solver's tie-breaking jitter.

    The reference's float32 formula, but for ``sin``, which is taken in
    float64 and rounded to float32: the correctly rounded sine on every
    device.  float32 ``sin`` of a large argument rounds differently on the
    card and on the CPU (16% of one swap tile's draws), and the draws break
    near-ties between candidates, so the same inputs would keep different
    moves on the two."""
    b = torch.as_tensor(b, device=a.device)
    arg = a.to(torch.float32) * 12.9898 + b.to(torch.float32) * 78.233
    v = torch.sin(arg.to(torch.float64)).to(torch.float32) * 43758.5453
    return v - torch.floor(v)


@dataclasses.dataclass
class GoalContext:
    """Per-optimization constants (never change across rounds)."""

    state: ClusterState
    partition_replicas: torch.Tensor       # i32[P, RF_max], -1 padded
    host_capacity: torch.Tensor            # f32[H, 4] sum of alive member broker capacity
    balance_threshold: torch.Tensor        # f32[4] (>= 1)
    capacity_threshold: torch.Tensor       # f32[4] (<= 1)
    low_utilization_threshold: torch.Tensor  # f32[4]
    max_replicas_per_broker: torch.Tensor  # i32 scalar
    excluded_topics: torch.Tensor          # bool[T]
    excluded_for_leadership: torch.Tensor  # bool[B]
    excluded_for_replica_move: torch.Tensor  # bool[B]
    requested_dst: torch.Tensor            # bool[B]
    only_move_immigrants: torch.Tensor     # bool scalar
    replica_excluded: torch.Tensor         # bool[R]: topic excluded
    replica_balance_threshold: torch.Tensor         # f32 scalar
    leader_replica_balance_threshold: torch.Tensor  # f32 scalar
    topic_replica_balance_threshold: torch.Tensor   # f32 scalar
    topic_replica_balance_min_gap: torch.Tensor     # i32 scalar
    min_topic_leaders: torch.Tensor                 # i32 scalar
    min_leader_topic_mask: torch.Tensor             # bool[T]
    num_racks: int = 1
    # This rank's part of a replica-sharded solve
    # (:class:`~cruise_control_tpu_torch.parallel.mesh.ReplicaShard`, set by
    # ``GoalSolver.shard_inputs``); None solves unsharded.
    shard: Optional[object] = None

    @property
    def num_partitions(self) -> int:
        return self.partition_replicas.shape[0]

    @property
    def max_rf(self) -> int:
        return self.partition_replicas.shape[1]

    @property
    def num_hosts(self) -> int:
        return self.host_capacity.shape[0]

    @property
    def num_topics(self) -> int:
        return self.excluded_topics.shape[0]


@dataclasses.dataclass
class Aggregates:
    """Incrementally-maintained cluster aggregates, O(B)+O(H)+O(T·B), so
    per-move updates are scatter-adds, never O(R) recomputes."""

    broker_load: torch.Tensor      # f32[B, 4]
    host_load: torch.Tensor        # f32[H, 4]
    replica_counts: torch.Tensor   # i32[B]
    leader_counts: torch.Tensor    # i32[B]
    topic_counts: torch.Tensor     # i32[T, B]
    topic_leader_counts: torch.Tensor  # i32[T, B]
    disk_load: torch.Tensor        # f32[B, D]
    potential_nw_out: torch.Tensor  # f32[B]
    leader_bytes_in: torch.Tensor  # f32[B]

    def replace(self, **kw) -> "Aggregates":
        return dataclasses.replace(self, **kw)


def _pad2(n: int, floor: int = 8) -> int:
    """Round up to a power-of-two size class (min ``floor``), as the JAX
    package does, so both packages see the same padded shapes."""
    n = max(n, 1)
    p = floor
    while p < n:
        p *= 2
    return p


def build_context(
    state: ClusterState,
    placement: Placement,
    meta: ClusterMeta,
    constraint: BalancingConstraint,
    options: OptimizationOptions,
) -> GoalContext:
    """Host-side packing of constraint/option tensors for one optimization,
    placed on the state's device.  Thresholds are float32 throughout."""
    dev = state.device
    b_pad = state.num_brokers_padded

    part = state.partition.cpu().numpy()
    valid = state.valid.cpu().numpy()
    num_p = _pad2(meta.num_partitions)
    order = np.argsort(part[valid], kind="stable")
    valid_idx = np.nonzero(valid)[0][order]
    max_rf = 1
    if valid_idx.size:
        counts = np.bincount(part[valid_idx], minlength=num_p)
        max_rf = max(int(counts.max()), 1)
    max_rf = _pad2(max_rf, floor=2)
    pr = np.full((num_p, max_rf), -1, dtype=np.int64)
    # Slot within partition = running index among same-partition rows
    # (valid_idx is sorted by partition, stable).
    pp = part[valid_idx]
    if len(pp):
        firsts = np.searchsorted(pp, pp, side="left")
        slot = np.arange(len(pp)) - firsts
        pr[pp, slot] = valid_idx

    host = state.host.cpu().numpy()
    alive = (state.alive & state.broker_valid).cpu().numpy()
    cap = state.capacity.cpu().numpy()
    num_h = _pad2(meta.num_hosts)
    host_cap = np.zeros((num_h, NUM_RESOURCES), dtype=np.float32)
    np.add.at(host_cap, host[alive], cap[alive])

    num_t = _pad2(meta.num_topics)
    excluded_topics = np.zeros(num_t, dtype=bool)
    excluded_topics[:meta.num_topics] = options.excluded_topic_mask(meta)
    topic_arr = state.topic.cpu().numpy()
    replica_excluded = excluded_topics[np.clip(topic_arr, 0, num_t - 1)] & valid

    min_leader_topics = np.zeros(num_t, dtype=bool)
    for i, t in enumerate(meta.topics):
        if t in constraint.min_leader_topic_names:
            min_leader_topics[i] = True

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    def i32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int32), device=dev)

    def bool_(x):
        return torch.as_tensor(np.asarray(x, dtype=bool), device=dev)

    return GoalContext(
        state=state,
        partition_replicas=i32(pr),
        host_capacity=f32(host_cap),
        balance_threshold=f32(constraint.balance_band(options.is_triggered_by_goal_violation)),
        capacity_threshold=f32(constraint.capacity_threshold),
        low_utilization_threshold=f32(constraint.low_utilization_threshold),
        max_replicas_per_broker=i32(constraint.max_replicas_per_broker),
        excluded_topics=bool_(excluded_topics),
        excluded_for_leadership=bool_(options.leadership_exclusion_mask(meta, b_pad)),
        excluded_for_replica_move=bool_(options.replica_move_exclusion_mask(meta, b_pad)),
        requested_dst=bool_(options.destination_mask(meta, b_pad)),
        only_move_immigrants=bool_(options.only_move_immigrant_replicas),
        replica_excluded=bool_(replica_excluded),
        replica_balance_threshold=f32(constraint.replica_balance_threshold),
        leader_replica_balance_threshold=f32(constraint.leader_replica_balance_threshold),
        topic_replica_balance_threshold=f32(constraint.topic_replica_balance_threshold),
        topic_replica_balance_min_gap=i32(constraint.topic_replica_balance_min_gap),
        min_topic_leaders=i32(constraint.min_topic_leaders_per_broker),
        min_leader_topic_mask=bool_(min_leader_topics),
        num_racks=_pad2(meta.num_racks),
    )


def scenario_context(gctx: GoalContext, alive: torch.Tensor,
                     excluded_for_replica_move: torch.Tensor,
                     excluded_for_leadership: torch.Tensor) -> GoalContext:
    """The context of one what-if lane: the base context with the lane's
    broker liveness and exclusion masks, and each host's capacity summed
    anew over the lane's alive brokers (the JAX package builds the same
    context inside ``_batch_solve_fn`` and ``_relax_batch_fn``)."""
    state = dataclasses.replace(gctx.state, alive=alive)
    ok = alive & state.broker_valid
    host_cap = segment_sum(torch.where(ok[:, None], state.capacity, 0.0),
                           state.host, gctx.num_hosts)
    return dataclasses.replace(
        gctx, state=state, host_capacity=host_cap,
        excluded_for_replica_move=excluded_for_replica_move,
        excluded_for_leadership=excluded_for_leadership)


# --------------------------------------------------------------------- loads


def replica_role_load(gctx: GoalContext, placement: Placement, r) -> torch.Tensor:
    """f32[..., 4]: effective load of replica r in its current role."""
    return torch.where(placement.is_leader[r][..., None],
                       gctx.state.leader_load[r], gctx.state.follower_load[r])


def aggregate_channels(state: ClusterState, placement: Placement,
                       rows: slice = slice(None)) -> torch.Tensor:
    """f32[R, 8]: the broker-axis channels of the aggregate recompute — 4
    resource loads in the current role, valid, leader, potential NW-out and
    leader bytes-in — zero on padded rows; only ``rows`` of R when given."""
    valid = state.valid[rows]
    is_leader = placement.is_leader[rows]
    leader_load = state.leader_load[rows]
    load = torch.where(is_leader[:, None], leader_load,
                       state.follower_load[rows]) * valid[:, None]
    leader = (valid & is_leader).to(torch.float32)
    return torch.cat([
        load,
        valid[:, None].to(torch.float32),
        leader[:, None],
        (leader_load[:, Resource.NW_OUT] * valid)[:, None],
        (leader_load[:, Resource.NW_IN] * leader)[:, None],
    ], dim=1)


def compute_aggregates(gctx: GoalContext, placement: Placement) -> Aggregates:
    """Full recompute (round boundaries); phases update incrementally.

    The eight broker-axis channels (:func:`aggregate_channels`) are reduced
    in ONE pass over the replica axis by :func:`broker_channel_sums` — the
    hand-written kernel on CUDA, its plain version on the CPU.  In a
    replica-sharded solve (``gctx.shard``) every sum runs on the rank's rows
    only and one all-reduce over the replica group completes them all."""
    state = gctx.state
    b = state.num_brokers_padded
    t = gctx.num_topics
    d = state.num_disks_per_broker
    shard = gctx.shard
    rows = slice(None) if shard is None else shard.rows
    channels = aggregate_channels(state, placement, rows)
    broker = placement.broker[rows]
    sums = broker_channel_sums(channels, broker, b)
    valid = state.valid[rows]
    valid_i = valid.to(torch.int32)
    leader_i = (valid & placement.is_leader[rows]).to(torch.int32)
    flat = state.topic[rows] * b + broker
    topic_counts = segment_sum(valid_i, flat, t * b)
    topic_leader_counts = segment_sum(leader_i, flat, t * b)
    dflat = broker * d + placement.disk[rows]
    disk_load = segment_sum(channels[:, Resource.DISK].contiguous(), dflat, b * d)
    if shard is not None:
        # One all-reduce for all four partial sums; counts ride in f32,
        # exact up to 2^24 rows.
        packed = shard.sum(torch.cat([sums.reshape(-1), topic_counts.to(torch.float32),
                                      topic_leader_counts.to(torch.float32), disk_load]))
        sums, topic_counts, topic_leader_counts, disk_load = torch.split(
            packed, [sums.numel(), t * b, t * b, b * d])
        sums = sums.reshape(b, -1)
        topic_counts = topic_counts.to(torch.int32)
        topic_leader_counts = topic_leader_counts.to(torch.int32)
    broker_load = sums[:, :4].contiguous()
    # Counts are exact in f32 up to 2^24 — far beyond padded R.
    replica_counts = sums[:, 4].to(torch.int32)
    leader_counts = sums[:, 5].to(torch.int32)
    potential = sums[:, 6].contiguous()
    leader_bytes_in = sums[:, 7].contiguous()
    host_load = segment_sum(broker_load, state.host, gctx.num_hosts)
    return Aggregates(
        broker_load=broker_load, host_load=host_load,
        replica_counts=replica_counts, leader_counts=leader_counts,
        topic_counts=topic_counts.reshape(t, b),
        topic_leader_counts=topic_leader_counts.reshape(t, b),
        disk_load=disk_load.reshape(b, d), potential_nw_out=potential,
        leader_bytes_in=leader_bytes_in,
    )


def currently_offline(gctx: GoalContext, placement: Placement, r=None):
    """bool: replica sits on a dead broker or dead logdir *under the current
    placement* (unlike ``state.offline``, which is snapshot-time truth)."""
    state = gctx.state
    if r is None:
        b = placement.broker
        return state.valid & (~state.alive[b] | ~state.disk_alive[b, placement.disk])
    b = placement.broker[r]
    return state.valid[r] & (~state.alive[b] | ~state.disk_alive[b, placement.disk[r]])


# ----------------------------------------------------------- move application


def _add(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].add(v)``: a new tensor (duplicate indices accumulate)."""
    return x.index_add(0, idx.long(), v)


def _add2(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
          v: torch.Tensor) -> torch.Tensor:
    """``x.at[i, j].add(v)`` for a 2-D ``x``."""
    flat = i.long() * x.shape[1] + j.long()
    return x.reshape(-1).index_add(0, flat, v).reshape(x.shape)


def set_rows(x: torch.Tensor, idx: torch.Tensor, val,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` with rows ``idx`` set to ``val``, as a new tensor.

    With ``keep``, only kept rows are written: the others go to a dummy slot
    past the end, which is then cut off.  That is the duplicate-safe form of
    JAX's ``x.at[where(keep, idx, n)].set(val, mode="drop")`` — an
    out-of-range write raises on CUDA, and ``index_put_`` with duplicate
    indices picks no defined winner.  Kept rows must be distinct."""
    n = x.shape[0]
    if keep is None:
        out = x.clone()
        out[idx.long()] = val
        return out
    buf = torch.cat([x, x[:1]])
    buf[torch.where(keep, idx, n).long()] = val
    return buf[:n]


def apply_replica_moves_batch(gctx: GoalContext, placement: Placement,
                              agg: Aggregates, r: torch.Tensor,
                              dst: torch.Tensor, dst_disk: torch.Tensor,
                              keep: Optional[torch.Tensor] = None):
    """Apply a conflict-free BATCH of inter-broker moves incrementally.

    ``r/dst/dst_disk`` are [C]; rows whose ``dst`` equals the replica's
    current broker are no-ops.  O(C) scatter-adds instead of the O(R)
    ``compute_aggregates`` recompute.  ``keep`` (bool[C], optional) zeroes
    non-kept rows' deltas and drops their placement writes; it is REQUIRED
    when ``r`` can hold duplicate rows.  Returns (placement, agg).
    """
    state = gctx.state
    src = placement.broker[r]
    src_disk = placement.disk[r]
    load = replica_role_load(gctx, placement, r)          # [C,4]
    is_lead = placement.is_leader[r]
    topic = state.topic[r]
    pot = state.leader_load[r, Resource.NW_OUT]
    lbi = torch.where(is_lead, state.leader_load[r, Resource.NW_IN], 0.0)
    inc = is_lead.to(torch.int32)
    one = torch.ones_like(r, dtype=torch.int32)
    if keep is not None:
        load = load * keep[:, None]
        pot = pot * keep
        lbi = lbi * keep
        inc = inc * keep
        one = one * keep

    broker_load = _add(_add(agg.broker_load, src, -load), dst, load)
    host_load = _add(_add(agg.host_load, state.host[src], -load), state.host[dst], load)
    replica_counts = _add(_add(agg.replica_counts, src, -one), dst, one)
    leader_counts = _add(_add(agg.leader_counts, src, -inc), dst, inc)
    topic_counts = _add2(_add2(agg.topic_counts, topic, src, -one), topic, dst, one)
    topic_leader_counts = _add2(_add2(agg.topic_leader_counts, topic, src, -inc),
                                topic, dst, inc)
    disk_load = _add2(_add2(agg.disk_load, src, src_disk, -load[:, Resource.DISK]),
                      dst, dst_disk, load[:, Resource.DISK])
    potential = _add(_add(agg.potential_nw_out, src, -pot), dst, pot)
    leader_bytes_in = _add(_add(agg.leader_bytes_in, src, -lbi), dst, lbi)

    placement = placement.replace(
        broker=set_rows(placement.broker, r, dst.to(torch.int32), keep),
        disk=set_rows(placement.disk, r, dst_disk.to(torch.int32), keep),
    )
    agg = Aggregates(
        broker_load=broker_load, host_load=host_load,
        replica_counts=replica_counts, leader_counts=leader_counts,
        topic_counts=topic_counts, topic_leader_counts=topic_leader_counts,
        disk_load=disk_load, potential_nw_out=potential,
        leader_bytes_in=leader_bytes_in,
    )
    return placement, agg


def apply_leadership_moves_batch(gctx: GoalContext, placement: Placement,
                                 agg: Aggregates, f: torch.Tensor,
                                 old: torch.Tensor, keep: torch.Tensor,
                                 demote: Optional[torch.Tensor] = None):
    """Apply a conflict-free batch of promotions (f gains, old loses), gated
    by ``keep`` — non-kept rows contribute zero deltas.  ``demote``
    separately gates the old-leader side (default: same as ``keep``).  The
    caller has already flipped ``placement.is_leader``; this updates only the
    aggregates, O(C)."""
    state = gctx.state
    demote = keep if demote is None else demote
    k = keep[:, None]
    kd = demote[:, None]
    f_b = placement.broker[f]
    o_b = placement.broker[old]
    d_new = torch.where(k, state.leader_load[f] - state.follower_load[f], 0.0)
    d_old = torch.where(kd, state.follower_load[old] - state.leader_load[old], 0.0)
    inc = keep.to(torch.int32)
    dec = demote.to(torch.int32)

    broker_load = _add(_add(agg.broker_load, f_b, d_new), o_b, d_old)
    host_load = _add(_add(agg.host_load, state.host[f_b], d_new), state.host[o_b], d_old)
    leader_counts = _add(_add(agg.leader_counts, f_b, inc), o_b, -dec)
    topic_leader_counts = _add2(_add2(agg.topic_leader_counts, state.topic[f], f_b, inc),
                                state.topic[old], o_b, -dec)
    disk_load = _add2(_add2(agg.disk_load, f_b, placement.disk[f], d_new[:, Resource.DISK]),
                      o_b, placement.disk[old], d_old[:, Resource.DISK])
    lbi_gain = torch.where(keep, state.leader_load[f, Resource.NW_IN], 0.0)
    lbi_lose = torch.where(demote, -state.leader_load[old, Resource.NW_IN], 0.0)
    leader_bytes_in = _add(_add(agg.leader_bytes_in, f_b, lbi_gain), o_b, lbi_lose)
    return agg.replace(
        broker_load=broker_load, host_load=host_load,
        leader_counts=leader_counts, topic_leader_counts=topic_leader_counts,
        disk_load=disk_load, leader_bytes_in=leader_bytes_in,
    )


def current_leader_of(gctx: GoalContext, placement: Placement, p):
    """i32[...]: replica row of partition p's current leader (-1 if none)."""
    sibs = gctx.partition_replicas[p]                        # [..., RF]
    ok = (sibs >= 0) & placement.is_leader[torch.clamp(sibs, min=0)]
    any_leader = ok.any(dim=-1)
    idx = torch.argmax(ok.to(torch.uint8), dim=-1)
    got = torch.gather(sibs, -1, idx[..., None])[..., 0]
    return torch.where(any_leader, got, -1)


# --------------------------------------------------------- base feasibility


def sibling_on_broker(gctx: GoalContext, placement: Placement, r, b):
    """bool[...]: does broker b already hold another replica of r's partition.

    r, b broadcast (e.g. r:[C,1], b:[1,B] for the feasibility matrix).
    RF-wide gather, never P×B."""
    p = gctx.state.partition[r]                      # [...]
    sibs = gctx.partition_replicas[p]                # [..., RF]
    sib_b = placement.broker[torch.clamp(sibs, min=0)]
    is_sib = (sibs >= 0) & (sibs != r[..., None])
    return (is_sib & (sib_b == b[..., None])).any(dim=-1)


def base_replica_move_ok(gctx: GoalContext, placement: Placement, r, dst):
    """The ``legitMove`` equivalent (GoalUtils): structural feasibility of
    moving replica r to broker dst, independent of any goal."""
    state = gctx.state
    src = placement.broker[r]
    dst_ok = (state.alive[dst] & state.broker_valid[dst]
              & ~gctx.excluded_for_replica_move[dst]
              & gctx.requested_dst[dst]
              & state.disk_alive[dst].any(dim=-1))
    offline = currently_offline(gctx, placement, r)
    r_ok = state.valid[r] & ~gctx.replica_excluded[r]
    immigrant = (src != state.orig_broker[r]) | offline
    r_ok = r_ok & (~gctx.only_move_immigrants | immigrant)
    # Excluded-topic replicas still must leave dead brokers (reference
    # GoalUtils: offline replicas of excluded topics are movable).
    r_ok = r_ok | offline
    return (r_ok & dst_ok & (dst != src)
            & ~sibling_on_broker(gctx, placement, r, dst))


def base_leadership_ok(gctx: GoalContext, placement: Placement, f):
    """Can follower f be promoted to leader (structurally)."""
    state = gctx.state
    b = placement.broker[f]
    return (state.valid[f] & ~placement.is_leader[f] & ~state.offline[f]
            & state.alive[b] & ~gctx.excluded_for_leadership[b]
            & ~gctx.replica_excluded[f])
