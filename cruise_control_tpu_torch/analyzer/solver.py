"""The batched greedy solver.

Replaces the reference's per-goal greedy search (``AbstractGoal.optimize``
:78-130 — ``while !finished: for broker: rebalanceForBroker`` with every
candidate action re-checked against all previously-optimized goals at
``AbstractGoal.maybeApplyBalancingAction`` :214-256) with rounds that are
each one batch of tensor work:

 1. score all R replicas; exact top-k picks ≤C candidates             (O(R))
 2. build the C×B feasibility mask: structural legitMove ∧ this goal's
    self-condition ∧ every prior goal's actionAcceptance               (O(C·B))
 3. per-candidate destination by goal cost (rank matching, argmin)     (O(C·B))
 4. conflict-free selection: one move per partition always; per
    destination/host/source, EITHER at most one move (fallback) OR —
    when every in-play goal declares cumulative slacks — as many moves
    as the group's headroom fits, checked by within-group cumulative
    sums in priority order (multi-accept)                     (O(C log C))
 5. apply ALL kept moves with O(C) incremental scatter deltas
    (full aggregate recompute only at resync)                           (O(C))

Besides replica moves (the move and pull phases), a round may promote
followers (leadership phase), exchange replica pairs between brokers (swap
phase, a C×C pair tile), move replicas between a broker's own logdirs
(intra-disk phase), or apply one direct transform (direct phase).

Every predicate in step 2 is evaluated against the round-start state;
bounding each group's CUMULATIVE consumption by the tightest in-play
headroom means no subset of kept moves can invalidate another kept move's
checks.  Anything skipped is picked up next round against fresh aggregates.

The per-goal convergence loop runs on the host and syncs once per round, on
the loop condition.  Its spans (``solve.enter``, one ``solve.round`` a round
with a ``phase.<name>`` per phase and ``round.stats``, ``solve.exit``)
partition it, and add no sync of their own.  With round recording on
(``trace.solver.rounds``), each round writes one ``ROUND_STATS_COLS`` row
into a preallocated device buffer, copied to the host with the goal's final
numbers.  A phase with no candidate
runs its tile anyway, fully masked (nothing is kept), instead of syncing to
skip it.  Top-k is exact and
breaks ties by index, as ``lax.top_k`` does.

A round is one step (:meth:`GoalSolver._round_step`) that reads one set of
buffers (the lane's context, the carried placement, aggregates and
bookkeeping, and the round index as a device scalar) and writes its results
back into them, with no host read.  On a CUDA device a key (goals, width,
shapes) runs eagerly on its first solve; the first round of its second solve
captures the step as a CUDA graph, and every later round of that key, in that
solve or the next, is one replay: the card then runs the round's few hundred
small kernels without waiting on the host to launch them one by one.  A
replayed round opens no ``phase.*`` or ``round.stats`` span; each
``solve.round`` says in its ``graph`` attribute whether it captured, replayed
or ran eagerly, and why.  The step runs eagerly on the CPU, in a sharded
solve, under round recording, for a goal solved by one transform (its phase
recomputes the aggregates), on a key's first solve, when another thread holds
the key's graph, and for a key whose capture failed.

Every goal solve goes through :meth:`GoalSolver.dispatch`, the compile
service's seam: its executable families are keyed as the JAX solver keys its
``_round_cache``, and it feeds compile telemetry and the cost ledger.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.context import (
    Aggregates,
    GoalContext,
    apply_leadership_moves_batch,
    apply_replica_moves_batch,
    base_leadership_ok,
    base_replica_move_ok,
    compute_aggregates,
    current_leader_of,
    currently_offline,
    hash01,
    replica_role_load,
    set_rows,
)
from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.common.exceptions import OptimizationFailureError
from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.compilesvc.telemetry import telemetry as _compile_telemetry
from cruise_control_tpu_torch.model.state import Placement
from cruise_control_tpu_torch.obsvc.convergence import ROUND_STATS_COLS
from cruise_control_tpu_torch.obsvc.memory import measure_bytes
from cruise_control_tpu_torch.obsvc.memory import memory_ledger as _memory_ledger
from cruise_control_tpu_torch.obsvc.tracer import tracer as _tracer

LOG = logging.getLogger(__name__)

_SCORE_FLOOR = -1e29  # candidate scores below this are "not a candidate"
_INF_COST = 3.4e38

# Round graphs a solver keeps, least recently used first out.
ROUND_GRAPH_SLOTS = 16
# The device-memory ledger's subsystem for their static buffers.
GRAPH_SUBSYSTEM = "solver.graphs"
# What became of each round: captured, replayed, run eagerly; and the
# captures that failed.
GRAPH_CAPTURES_SENSOR = "Solver.round-graph.captures"
GRAPH_REPLAYS_SENSOR = "Solver.round-graph.replays"
GRAPH_EAGER_SENSOR = "Solver.round-graph.eager-rounds"
GRAPH_FAILURES_SENSOR = "Solver.round-graph.capture-failures"
# Graphs dropped to keep a solver within ROUND_GRAPH_SLOTS.
GRAPH_EVICTIONS_SENSOR = "Solver.round-graph.evictions"
ROUND_GRAPH_SENSORS = (GRAPH_CAPTURES_SENSOR, GRAPH_REPLAYS_SENSOR, GRAPH_EAGER_SENSOR,
                       GRAPH_FAILURES_SENSOR, GRAPH_EVICTIONS_SENSOR)
# Why a goal's loop ended (``GoalOptimizationInfo.end``): its work was done,
# a round applied nothing, the stall cutoff, the round cap, or the budget.
GOAL_ENDS = ("satisfied", "no_move", "stalled", "round_cap", "budget")
GOAL_END_SENSORS = tuple(f"Solver.goal-end.{end}" for end in GOAL_ENDS)


def round_graph_sensors() -> None:
    """Materialize the Solver.round-graph.* and Solver.goal-end.* counters
    (at 0) so a scrape sees them before the first round."""
    reg = registry()
    for name in ROUND_GRAPH_SENSORS + GOAL_END_SENSORS:
        reg.counter(name)

# Round-level convergence recording (trace.solver.rounds); the column layout
# is owned by obsvc/convergence.py.
_RECORD_ROUNDS = False


def set_round_recording(enabled: bool) -> None:
    """Process-wide trace.solver.rounds switch (wired by obsvc.configure)."""
    global _RECORD_ROUNDS
    _RECORD_ROUNDS = bool(enabled)


def round_recording_enabled() -> bool:
    return _RECORD_ROUNDS


def shape_signature(tree) -> tuple:
    """The input shapes a dispatch runs at: each tensor's shape and dtype and
    each int field (static in the JAX package's pytrees), in walk order over
    dataclasses, tuples and lists.  A new signature in a family is where
    the JAX package's jit retraces and compiles."""
    sig = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), x.dtype))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, int):
            sig.append(x)
    return tuple(sig)


def _tensor_leaves(tree) -> list:
    """The tensors of ``tree`` in one fixed walk order over dataclass fields,
    tuples and lists (the order :func:`_copy_into` pairs them in)."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(tree)
    return out


def _cloned(tree):
    """``tree`` with every tensor cloned (dataclasses rebuilt field by field)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _cloned(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def _copy_into(dst, src) -> None:
    """Copy each tensor of ``src`` into its place in ``dst``, a tree of the
    same structure: one ``torch._foreach_copy_`` per dtype, since its fused
    kernel takes one dtype a call."""
    groups: Dict[torch.dtype, Tuple[list, list]] = {}
    for d, x in zip(_tensor_leaves(dst), _tensor_leaves(src)):
        ds, xs = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        xs.append(x)
    for ds, xs in groups.values():
        torch._foreach_copy_(ds, xs)


def _goal_key(goal: Goal) -> tuple:
    """A goal as a round graph's key holds it: its class and attributes
    (a resource, a name), so the fresh goal objects of each request find
    the graph again."""
    return (type(goal), tuple(sorted(vars(goal).items())))


class Dispatch:
    """What the body of :meth:`GoalSolver.dispatch` reports back: its
    outputs (for the cost ledger) and the families it did not run."""

    __slots__ = ("outputs", "skipped")

    def __init__(self):
        self.outputs = None
        self.skipped: set = set()


def _top_candidates(score: torch.Tensor, k: int, shard=None):
    """(values, indices) of the k best-scoring rows, descending, ties to the
    lower index (``lax.top_k``'s order); over the replica group when the
    solve is sharded (``ReplicaShard.top_candidates``, the same rows)."""
    if shard is not None:
        return shard.top_candidates(score, k)
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:k], idx[:k]


def _agree(gctx: GoalContext, *tensors: torch.Tensor):
    """``tensors`` as the replica group's first rank holds them in a sharded
    solve (``ReplicaShard.agree``: each phase's kept moves, a goal's loop
    condition and its verdicts); unchanged otherwise."""
    return tensors if gctx.shard is None else gctx.shard.agree(*tensors)


@dataclass
class GoalOptimizationInfo:
    """Host-side result of optimizing one goal."""

    goal_name: str
    rounds: int = 0
    moves_applied: int = 0
    violated_brokers_before: int = 0
    violated_brokers_after: int = 0
    # Offline (dead-broker) replicas still stranded when the goal's loop
    # exited — consumed by the optimizer's hard-goal evacuation check.
    stranded_after: int = 0
    # The parts of moves_applied that the swap and leadership phases applied
    # (a swap counts once).
    swaps_applied: int = 0
    leader_moves_applied: int = 0
    # Why the loop ended: one of GOAL_ENDS (None for a goal never started).
    end: Optional[str] = None
    metric_before: float = 0.0
    metric_after: float = 0.0
    # Per-round convergence curve, shape (rounds, ROUND_STATS_COLS) —
    # present only when trace.solver.rounds recorded this solve.
    round_curve: Optional[np.ndarray] = None
    # The solve's budget expired or was cancelled before this goal
    # converged (anytime result: the placement is the best found so far,
    # still feasible and prior-goal-safe; see SolveBudget).
    preempted: bool = False
    # Why the solve stopped early ("deadline", "cancelled", operator reason).
    preempt_reason: Optional[str] = None
    # Convex-relaxation path (analyzer/relax.py).  When relaxed=True the
    # info covers the whole relax+round+repair pass: metric/violated
    # "before" are re-anchored at the pre-relax placement, moves_applied
    # includes the rounding waves' moves, and rounds is the greedy repair's
    # round count (mirrored in repair_rounds).  relax_fallback marks a pass
    # whose relaxed result regressed and was discarded for pure greedy.
    relaxed: bool = False
    relax_ms: float = 0.0
    repair_rounds: int = 0
    relax_fallback: bool = False
    # Moves the rounding waves kept (the JAX package's
    # Solver.relax.fractional-moves gauge).
    relax_moves: int = 0
    # The post-rounding placement of a relaxed pass that kept its result
    # (None otherwise): the optimizer's provenance diff splits relax from
    # repair moves through it, and drops it after the goal.  It belongs to
    # this solve alone, so concurrent solves cannot mix their placements.
    rounded: Optional[Placement] = None

    @property
    def succeeded(self) -> bool:
        return self.violated_brokers_after == 0


def _no_span(name: str):
    return nullcontext()


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def _chain_accept_replica(priors: Sequence[Goal]):
    def accept(gctx, placement, agg, r, dst):
        ok = base_replica_move_ok(gctx, placement, r, dst)
        for g in priors:
            ok = ok & g.accept_replica_move(gctx, placement, agg, r, dst)
        return ok
    return accept


def _chain_accept_leadership(priors: Sequence[Goal]):
    def accept(gctx, placement, agg, f):
        ok = base_leadership_ok(gctx, placement, f)
        for g in priors:
            ok = ok & g.accept_leadership_move(gctx, placement, agg, f)
        return ok
    return accept


def _chain_accept_swap(priors: Sequence[Goal]):
    """Both directional moves must be structurally legit, and every prior
    goal must accept the SWAP (AbstractGoal.java:271-322; goals may override
    accept_swap with an exact pairwise predicate)."""
    def accept(gctx, placement, agg, r_out, r_in, b_out, b_in):
        ok = (base_replica_move_ok(gctx, placement, r_out, b_in)
              & base_replica_move_ok(gctx, placement, r_in, b_out))
        for g in priors:
            ok = ok & g.accept_swap(gctx, placement, agg, r_out, r_in, b_out, b_in)
        return ok
    return accept


def _pick_dst_disk(gctx: GoalContext, agg: Aggregates, dst):
    """Emptiest alive logdir of dst (disk chosen at move-apply time)."""
    frac = agg.disk_load[dst] / torch.clamp(gctx.state.disk_capacity[dst], min=1e-9)
    frac = torch.where(gctx.state.disk_alive[dst], frac, torch.inf)
    return torch.argmin(frac, dim=-1).to(torch.int32)


def _group_winners(order_key: torch.Tensor, group: torch.Tensor,
                   num_groups: int) -> torch.Tensor:
    """bool[C]: is this candidate the best (smallest order_key) in its group.

    order_key carries C (out of range) for non-candidates so they never win.
    """
    best = torch.zeros(num_groups, dtype=order_key.dtype, device=order_key.device)
    best = best.scatter_reduce(0, group.long(), order_key, "amin",
                               include_self=False)
    return best[group] == order_key


def _both_roles_winner(order: torch.Tensor, key_a: torch.Tensor,
                       key_b: torch.Tensor, num_groups: int) -> torch.Tensor:
    """bool[C]: the candidate is the best (smallest order) in BOTH of its
    groups, where a group's members are the candidates holding its key in
    either role (an action touching two brokers, partitions or hosts)."""
    keys = torch.cat([key_a, key_b]).long()
    best = torch.zeros(num_groups, dtype=order.dtype, device=order.device)
    best = best.scatter_reduce(0, keys, torch.cat([order, order]), "amin",
                               include_self=False)
    return (best[key_a.long()] == order) & (best[key_b.long()] == order)


def _jittered(cost: torch.Tensor, ok: torch.Tensor, cand: torch.Tensor,
              d2: torch.Tensor, ridx: int, frac: float = 1.0) -> torch.Tensor:
    """Add per-(candidate, dst) jitter scaled to each candidate's feasible
    cost range so the batch spreads over every acceptable destination instead
    of piling onto the single argmin.  ``ridx`` (round index) reseeds the
    draw each round so an unlucky draw is never permanent."""
    lo = torch.where(ok, cost, torch.inf).amin(dim=1, keepdim=True)
    hi = torch.where(ok, cost, -torch.inf).amax(dim=1, keepdim=True)
    span = torch.where(hi > lo, hi - lo, 0.0)
    scale = frac * span + 1e-6
    return cost + hash01(cand[:, None] + ridx * 7919, d2) * scale


def _src_sensitive(goal: Goal, priors: Sequence[Goal]) -> bool:
    """Does any acceptance predicate in play depend on the SOURCE broker's
    state?  If not, multiple moves may leave one source in a single batch."""
    return any(g.src_sensitive_accept for g in (goal, *priors))


def _cumulative_group_ok(order: torch.Tensor, group: torch.Tensor,
                         active: torch.Tensor, constraints, c: int) -> torch.Tensor:
    """bool[C]: does each active candidate fit its group's CUMULATIVE slacks.

    Candidates are processed in priority ``order`` within each ``group``; a
    candidate passes iff, for every (weight[C], slack_of_row[C]) constraint,
    the running sum of weights of the ACTIVE candidates ahead of it in its
    group (including itself) stays within the group's slack.  One argsort +
    K cumsums — O(C log C).
    """
    key = group.long() * (c + 1) + torch.where(active, order, c)
    perm = torch.argsort(key, stable=True)
    g_s = group[perm]
    active_s = active[perm]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=group.device),
                          g_s[1:] != g_s[:-1]])
    ok_s = torch.ones(c, dtype=torch.bool, device=group.device)
    for weight, slack_row in constraints:
        w_s = torch.where(active_s, weight[perm], 0.0)
        cum = torch.cumsum(w_s, dim=0)
        excl = cum - w_s
        # Group base = exclusive cumsum at the group's first element;
        # weights are >= 0 so excl is non-decreasing and cummax broadcasts it.
        base = torch.cummax(torch.where(is_start, excl, -torch.inf), dim=0).values
        within = cum - base
        # Zero-weight candidates never consume slack and must not be vetoed
        # by an already-negative group slack.
        ok_s = ok_s & ((within <= slack_row[perm] + 1e-6) | (w_s <= 0.0))
    out = torch.zeros(c, dtype=torch.bool, device=group.device)
    out[perm] = ok_s
    return out | ~active


def _multi_accept_constraints(goal: Goal, priors: Sequence[Goal], gctx,
                              placement, agg, cand, cand_load, is_lead_cand,
                              axis: str):
    """(weight[C], slack[B or H]) cumulative constraints for one axis
    ('dst', 'src' or 'host') from the goal and its priors.  A goal may name
    its weight by a marker string, which becomes the candidates' potential
    NW-out or the leader bytes-in that leader candidates carry."""
    fn = f"{axis}_cumulative_slack"
    state = gctx.state
    out = []
    for g in (goal, *priors):
        got = getattr(g, fn)(gctx, placement, agg, cand_load, is_lead_cand)
        if got is None:
            continue
        weight, slack = got
        if isinstance(weight, str):
            if weight == "potential_nw_out":
                weight = state.leader_load[cand, Resource.NW_OUT]
            elif weight == "leader_nw_in":
                weight = is_lead_cand * state.leader_load[cand, Resource.NW_IN]
            else:
                raise ValueError(f"unknown weight marker {weight!r}")
        out.append((weight, slack))
    return out


def _check_dst_slack_invariant(goal: Goal, priors: Sequence[Goal]) -> None:
    """Uncapped multi-accept arrivals are safe only if every in-play goal
    whose replica acceptance reads destination aggregate state bounds those
    arrivals — via a dst slack, the (topic, broker) group rule, or an
    explicit exemption."""
    for g in (goal, *priors):
        overrides_accept = (type(g).accept_replica_move
                            is not Goal.accept_replica_move)
        declares_slack = (type(g).dst_cumulative_slack
                          is not Goal.dst_cumulative_slack)
        if (overrides_accept and not declares_slack
                and not g.needs_topic_group and not g.dst_slack_exempt):
            raise ValueError(
                f"{g.name}: multi_accept_safe goals overriding "
                "accept_replica_move must declare dst_cumulative_slack, set "
                "needs_topic_group, or mark dst_slack_exempt (acceptance "
                "reads no destination aggregates)")


def _stratified_top_dst(gctx: GoalContext, pscore: torch.Tensor,
                        d: int) -> torch.Tensor:
    """The d most attractive destination brokers, round-robin across racks
    by within-rack rank, so a hot rack can never prune every destination of
    a rack-constrained move out of the tile."""
    order = torch.argsort(-pscore, stable=True)               # best first
    rack_sorted = gctx.state.rack[order]
    onehot = rack_sorted[:, None] == _arange(gctx.num_racks, pscore)[None, :]
    cnt = torch.cumsum(onehot.to(torch.int32), dim=0)
    rank = torch.gather(cnt, 1, rack_sorted[:, None].long())[:, 0] - 1
    # Stable sort keeps global score order within equal ranks.
    stratified = order[torch.argsort(rank, stable=True)]
    return stratified[:d]


def _replica_phase(goal: Goal, priors: Sequence[Goal], num_candidates: int,
                   score_fn: Callable, self_ok_fn: Callable,
                   dst_mask_fn: Optional[Callable] = None,
                   jitter_frac: float = 1.0,
                   prune_fn: Optional[Callable] = None,
                   max_dst: int = 0):
    """One conflict-free batched replica-move phase:
    (gctx, placement, agg, ridx) -> (placement, agg, applied).

    ``prune_fn`` + ``max_dst`` tile the DESTINATION axis to the best
    ``max_dst`` brokers when the cluster has more."""
    accept = _chain_accept_replica(priors)
    need_src_cap = _src_sensitive(goal, priors)
    multi_accept = all(g.multi_accept_safe for g in (goal, *priors))
    if multi_accept:
        _check_dst_slack_invariant(goal, priors)
    needs_topic_group = any(g.needs_topic_group for g in (goal, *priors))

    def phase(gctx: GoalContext, placement: Placement, agg: Aggregates, ridx: int):
        state = gctx.state
        b = state.num_brokers_padded
        c = num_candidates
        top_score, cand = _top_candidates(score_fn(gctx, placement, agg), c, gctx.shard)
        is_cand = top_score > _SCORE_FLOOR
        r2 = cand[:, None]
        pscore = (prune_fn(gctx, placement, agg)
                  if prune_fn is not None and 0 < max_dst < b else None)
        if pscore is not None:
            dst_ids = _stratified_top_dst(gctx, pscore, max_dst)
            d2 = dst_ids[None, :]
            nd = max_dst
        else:
            dst_ids = None
            d2 = _arange(b, cand)[None, :]
            nd = b
        ok = accept(gctx, placement, agg, r2, d2)
        ok = ok & self_ok_fn(gctx, placement, agg, r2, d2)
        if dst_mask_fn is not None:
            # Pull phases: only the mask's (under-band) brokers receive.
            dst_mask = dst_mask_fn(gctx, placement, agg)
            ok = ok & (dst_mask if dst_ids is None else dst_mask[dst_ids])[None, :]
        cost_raw = goal.dst_cost(gctx, placement, agg, r2, d2)
        cost = torch.where(ok, cost_raw, _INF_COST)
        # Rank matching: the i-th candidate (priority order) gets the i-th
        # cheapest destination — distinct destinations by construction.
        # Infeasible pairs fall back to the candidate's own jittered argmin.
        # Indices here live in the (possibly pruned) tile space.
        proxy = cost.amin(dim=0)                                 # f32[nd]
        ranked = torch.argsort(proxy, stable=True)
        assign = ranked[_arange(c, cand) % nd]
        ok_assign = torch.gather(ok, 1, assign[:, None])[:, 0]
        jcost = torch.where(ok, _jittered(cost_raw, ok, cand, d2, ridx,
                                          frac=jitter_frac), _INF_COST)
        fallback = torch.argmin(jcost, dim=1)
        dst = torch.where(ok_assign, assign, fallback)
        if dst_ids is not None:
            dst = dst_ids[dst]
        feasible = ok.any(dim=1) & is_cand

        # Conflict-free batch, candidate-priority order.
        order = torch.where(feasible, _arange(c, cand), c)
        part = state.partition[cand]
        host = state.host[dst]
        src = placement.broker[cand]
        keep = feasible & _group_winners(order, part, gctx.num_partitions)
        if multi_accept:
            # A destination/host/source may take SEVERAL candidates in one
            # round as long as their cumulative consumption fits every
            # in-play goal's headroom.
            cand_load = replica_role_load(gctx, placement, cand)    # [C,4]
            is_lead_c = placement.is_leader[cand]
            if needs_topic_group:
                topic = state.topic[cand].long()
                nseg = gctx.num_topics * b
                keep = (keep
                        & _group_winners(order, topic * b + dst, nseg)
                        & _group_winners(order, topic * b + src, nseg))
            dst_cons = _multi_accept_constraints(
                goal, priors, gctx, placement, agg, cand, cand_load, is_lead_c, "dst")
            if dst_cons:
                keep = keep & _cumulative_group_ok(
                    order, dst, keep, [(w, s[dst]) for w, s in dst_cons], c)
            # else: arrivals are UNCAPPED — safe by _check_dst_slack_invariant.
            # Physical per-logdir fill guard (JBOD): every arrival a broker
            # takes this round gets the SAME pre-round argmin disk.
            d_n = state.num_disks_per_broker
            if d_n > 1:
                dd = _pick_dst_disk(gctx, agg, dst)
                disk_limit = (gctx.capacity_threshold[Resource.DISK]
                              * state.disk_capacity)
                disk_slack = (disk_limit - agg.disk_load)[dst, dd]
                keep = keep & _cumulative_group_ok(
                    order, dst * d_n + dd, keep,
                    [(cand_load[:, Resource.DISK], disk_slack)], c)
            # Host-level constraints (same-host moves are host-neutral).
            same_host = state.host[src] == host
            host_cons = [
                (torch.where(same_host, 0.0, w), s[host])
                for w, s in _multi_accept_constraints(
                    goal, priors, gctx, placement, agg, cand, cand_load, is_lead_c, "host")
            ]
            if host_cons:
                keep = keep & _cumulative_group_ok(order, host, keep, host_cons, c)
            src_cons = _multi_accept_constraints(
                goal, priors, gctx, placement, agg, cand, cand_load, is_lead_c, "src")
            if src_cons:
                # Dead/offline sources are exempt: evacuation must proceed.
                src_dead = ~state.alive[src] | currently_offline(gctx, placement, cand)
                src_rows = [(w, torch.where(src_dead, torch.inf, s[src]))
                            for w, s in src_cons]
                keep = keep & _cumulative_group_ok(order, src, keep, src_rows, c)
        else:
            keep = (keep
                    & _group_winners(order, dst, b)
                    & _group_winners(order, host, gctx.num_hosts))
            if need_src_cap:
                keep = keep & _group_winners(order, src, b)

        dst_disk = _pick_dst_disk(gctx, agg, dst)
        cand, dst, dst_disk, keep = _agree(gctx, cand, dst, dst_disk, keep)
        placement, agg = apply_replica_moves_batch(gctx, placement, agg, cand,
                                                   dst, dst_disk, keep=keep)
        return placement, agg, keep.sum()

    return phase


def _leadership_phase(goal: Goal, priors: Sequence[Goal], num_candidates: int):
    accept = _chain_accept_leadership(priors)
    multi = all(g.multi_leadership_safe for g in (goal, *priors))
    # Only goals with per-topic LEADER-count acceptance need the (topic,
    # broker) single-touch rule here.
    topic_group = any(g.leadership_topic_group for g in (goal, *priors))

    def phase(gctx: GoalContext, placement: Placement, agg: Aggregates, ridx: int):
        state = gctx.state
        c = num_candidates
        top_score, cand = _top_candidates(
            goal.leadership_candidate_score(gctx, placement, agg), c, gctx.shard)
        is_cand = top_score > _SCORE_FLOOR
        ok = (is_cand & accept(gctx, placement, agg, cand)
              & goal.leadership_self_ok(gctx, placement, agg, cand))
        old = current_leader_of(gctx, placement, state.partition[cand])  # [C]
        ok = ok & (old >= 0)
        old_safe = torch.clamp(old, min=0)

        # One promotion per partition always; per gaining/losing broker,
        # EITHER at most one promotion (fallback) OR — when every in-play
        # goal composes — as many as the brokers' cumulative headroom fits
        # (one check over both roles' streams).
        order = torch.where(ok, _arange(c, cand), c)
        gain_b = placement.broker[cand]
        lose_b = placement.broker[old_safe]
        b = state.num_brokers_padded
        keep = ok & _group_winners(order, state.partition[cand], gctx.num_partitions)
        if multi:
            if topic_group:
                # Promoted follower and demoted leader share the topic: one
                # touch per (topic, broker) per round.
                t = state.topic[cand].long()
                keep = keep & _both_roles_winner(order, t * b + gain_b, t * b + lose_b,
                                                 gctx.num_topics * b)
            rows = []
            h_rows = []
            group2 = torch.cat([gain_b, lose_b])
            h_group2 = torch.cat([state.host[gain_b], state.host[lose_b]])
            for g in (goal, *priors):
                got = g.leadership_cumulative_slack(gctx, placement, agg,
                                                    cand, old_safe)
                if got is None:
                    continue
                dg, dl, up, low, up_h = got
                d2 = torch.cat([dg, dl])
                pos2 = torch.clamp(d2, min=0.0)
                rows.append((pos2, up[group2]))
                if low is not None:
                    rows.append((torch.clamp(-d2, min=0.0), low[group2]))
                if up_h is not None:
                    h_rows.append((pos2, up_h[h_group2]))
            order2 = torch.cat([order * 2, order * 2 + 1])
            if rows:
                ok2 = _cumulative_group_ok(order2, group2, torch.cat([keep, keep]),
                                           rows, 2 * c)
                keep = keep & ok2[:c] & ok2[c:]
            if h_rows:
                ok2h = _cumulative_group_ok(order2, h_group2, torch.cat([keep, keep]),
                                            h_rows, 2 * c)
                keep = keep & ok2h[:c] & ok2h[c:]
        else:
            keep = (keep
                    & _group_winners(order, gain_b, b)
                    & _group_winners(order, lose_b, b))

        cand, old_safe, keep = _agree(gctx, cand, old_safe, keep)
        # Non-kept rows write nothing: their old_safe values repeat across
        # rows, and a stale write would clobber a kept row's demotion.
        is_leader = set_rows(placement.is_leader, cand, True, keep)
        is_leader = set_rows(is_leader, old_safe, False, keep)
        placement = placement.replace(is_leader=is_leader)
        agg = apply_leadership_moves_batch(gctx, placement, agg, cand, old_safe, keep)
        return placement, agg, keep.sum()

    return phase


def swap_select(goal: Goal, priors: Sequence[Goal], gctx: GoalContext,
                placement: Placement, agg: Aggregates, ridx: int,
                out_top: torch.Tensor, out_c: torch.Tensor,
                in_top: torch.Tensor, in_c: torch.Tensor,
                jitter_frac: float = 1.0):
    """Which swaps one batched SWAP round keeps on a given tile
    (ResourceDistributionGoal.java:543-725): (keep bool[C], r_in_sel[C],
    disk_for_out[C], disk_for_in[C]) — row i exchanges ``out_c[i]`` with
    ``r_in_sel[i]`` where ``keep[i]``, each landing on the other's broker
    at the given logdir.

    ``out_c``/``in_c`` are the C out- and in-candidates, ``out_top``/
    ``in_top`` their scores (-inf-like = no candidate).  C×C pair
    feasibility (both directions structurally legit ∧ every prior accepts
    the swap ∧ this goal's band maths says it helps) → per-row partner by
    rank matching on residual imbalance → conflict-free selection.  Each
    partition and in-partner is used once; brokers and hosts take EITHER at
    most one kept swap (fallback) OR — when every in-play goal composes over
    swaps — as many as their cumulative transferred deltas fit."""
    accept = _chain_accept_swap(priors)
    in_play = (goal, *priors)
    multi_swap = all(g.multi_swap_safe for g in in_play)
    topic_group = any(g.needs_topic_group or g.swap_topic_group for g in in_play)
    state = gctx.state
    c = out_c.shape[0]
    b = state.num_brokers_padded

    ro = out_c[:, None]                      # [C,1]
    ri = in_c[None, :]                       # [1,C]
    bo = placement.broker[ro]
    bi = placement.broker[ri]
    ok = ((out_top[:, None] > _SCORE_FLOOR) & (in_top[None, :] > _SCORE_FLOOR)
          & (bo != bi)
          & (state.partition[ro] != state.partition[ri])
          & goal.swap_ok(gctx, placement, agg, ro, ri)
          & accept(gctx, placement, agg, ro, ri, bo, bi))
    cost_raw = goal.swap_cost(gctx, placement, agg, ro, ri)
    # Partner jitter spreads rows over distinct in-partners.
    pos = _arange(c, out_c)[None, :]
    cost = torch.where(ok, _jittered(cost_raw, ok, out_c, pos, ridx,
                                     frac=jitter_frac), _INF_COST)
    # Rank matching: the i-th out-candidate gets the i-th cheapest partner
    # COLUMN — distinct partners by construction; rows whose assigned pair
    # is infeasible fall back to their own argmin.
    proxy = cost.amin(dim=0)                                 # f32[C] per partner
    assign = torch.argsort(proxy, stable=True)
    ok_assign = torch.gather(ok, 1, assign[:, None])[:, 0]
    fallback = torch.argmin(cost, dim=1)
    sel = torch.where(ok_assign, assign, fallback)
    feasible = torch.gather(ok, 1, sel[:, None])[:, 0]

    r_in_sel = in_c[sel]
    b_out_row = placement.broker[out_c]
    b_in_sel = placement.broker[r_in_sel]
    order = torch.where(feasible, _arange(c, out_c), c)

    # A kept swap touches 2 brokers, 2 hosts, 2 partitions: the at-most-once
    # rules run over both roles' keys.  Every in-partner serves one row.
    keep = (feasible
            & _both_roles_winner(order, state.partition[out_c],
                                 state.partition[r_in_sel], gctx.num_partitions)
            & _group_winners(order, r_in_sel, state.num_replicas_padded))

    disk_for_out = _pick_dst_disk(gctx, agg, b_in_sel)   # r_out lands on b_in
    disk_for_in = _pick_dst_disk(gctx, agg, b_out_row)   # r_in lands on b_out
    order2 = torch.cat([order * 2, order * 2 + 1])

    def both_streams_ok(keep, group2, rows):
        """Kept rows whose two role streams fit every cumulative row."""
        ok2 = _cumulative_group_ok(order2, group2, torch.cat([keep, keep]),
                                   rows, 2 * c)
        return keep & ok2[:c] & ok2[c:]

    if multi_swap:
        if topic_group:
            # One swap per (topic, broker) TOUCH per round.
            t_out = state.topic[out_c].long()
            t_in = state.topic[r_in_sel].long()
            nseg = gctx.num_topics * b
            keep = (keep
                    & _both_roles_winner(order, t_out * b + b_out_row,
                                         t_out * b + b_in_sel, nseg)
                    & _both_roles_winner(order, t_in * b + b_out_row,
                                         t_in * b + b_in_sel, nseg))
        # Cumulative per-broker bounds on the transferred deltas; both role
        # streams share ONE check per broker, so a broker in both streams
        # does not spend its slack once per role.
        load_out = replica_role_load(gctx, placement, out_c)
        load_in = replica_role_load(gctx, placement, r_in_sel)
        d_load = load_out - load_in                                   # [C,4]
        lnwout = state.leader_load[:, Resource.NW_OUT]
        d_pot = lnwout[out_c] - lnwout[r_in_sel]
        lnwin = state.leader_load[:, Resource.NW_IN]
        lead_out = placement.is_leader[out_c]
        lead_in = placement.is_leader[r_in_sel]
        d_lbi = lead_out * lnwin[out_c] - lead_in * lnwin[r_in_sel]
        d_lead = lead_out.to(torch.float32) - lead_in.to(torch.float32)
        b_rows = []
        b_group2 = torch.cat([b_in_sel, b_out_row])
        for g in in_play:
            got = g.swap_cumulative_slack(gctx, placement, agg, d_load, d_pot, d_lbi, d_lead)
            if got is None:
                continue
            delta, up, low = got
            p_w = torch.clamp(delta, min=0.0)
            n_w = torch.clamp(-delta, min=0.0)
            b_rows.append((torch.cat([p_w, n_w]), up[b_group2]))
            if low is not None:
                b_rows.append((torch.cat([n_w, p_w]), low[b_group2]))
        if b_rows:
            keep = both_streams_ok(keep, b_group2, b_rows)
        # Host-scoped bounds (upper only; same-host swaps are neutral).
        h_in = state.host[b_in_sel]
        h_out = state.host[b_out_row]
        same_h = h_in == h_out
        h_rows = []
        h_group2 = torch.cat([h_in, h_out])
        for g in in_play:
            got = g.swap_host_cumulative_slack(gctx, placement, agg, d_load)
            if got is None:
                continue
            delta, up_h = got
            p_w = torch.where(same_h, 0.0, torch.clamp(delta, min=0.0))
            n_w = torch.where(same_h, 0.0, torch.clamp(-delta, min=0.0))
            h_rows.append((torch.cat([p_w, n_w]), up_h[h_group2]))
        if h_rows:
            keep = both_streams_ok(keep, h_group2, h_rows)
        # JBOD fill guard: both arrival streams (r_out→b_in's logdir,
        # r_in→b_out's logdir) must cumulatively fit their target disks.
        d_n = state.num_disks_per_broker
        if d_n > 1:
            group2 = torch.cat([b_in_sel * d_n + disk_for_out,
                                b_out_row * d_n + disk_for_in])
            disk_limit = gctx.capacity_threshold[Resource.DISK] * state.disk_capacity
            disk_slack = (disk_limit - agg.disk_load).reshape(-1)
            w2 = torch.cat([load_out[:, Resource.DISK], load_in[:, Resource.DISK]])
            keep = both_streams_ok(keep, group2, [(w2, disk_slack[group2])])
    else:
        keep = (keep
                & _both_roles_winner(order, b_out_row, b_in_sel, b)
                & _both_roles_winner(order, state.host[b_out_row],
                                     state.host[b_in_sel], gctx.num_hosts))

    return keep, r_in_sel, disk_for_out, disk_for_in


def swap_body(goal: Goal, priors: Sequence[Goal], gctx: GoalContext,
              placement: Placement, agg: Aggregates, ridx: int,
              out_top: torch.Tensor, out_c: torch.Tensor,
              in_top: torch.Tensor, in_c: torch.Tensor,
              jitter_frac: float = 1.0):
    """One batched SWAP round on a given tile: :func:`swap_select`, then
    the kept swaps applied — (placement, agg, applied)."""
    keep, r_in_sel, disk_for_out, disk_for_in = swap_select(
        goal, priors, gctx, placement, agg, ridx, out_top, out_c, in_top, in_c,
        jitter_frac)
    out_c, keep, r_in_sel, disk_for_out, disk_for_in = _agree(
        gctx, out_c, keep, r_in_sel, disk_for_out, disk_for_in)
    b_out_row = placement.broker[out_c]
    b_in_sel = placement.broker[r_in_sel]
    # A swap is two conflict-free moves, out-moves first; r_in rows may
    # repeat across non-kept rows, so both applies are keep-masked.
    placement, agg = apply_replica_moves_batch(gctx, placement, agg, out_c,
                                               b_in_sel, disk_for_out, keep=keep)
    placement, agg = apply_replica_moves_batch(gctx, placement, agg, r_in_sel,
                                               b_out_row, disk_for_in, keep=keep)
    return placement, agg, keep.sum()


def swap_tile(goal: Goal, gctx: GoalContext, placement: Placement,
              agg: Aggregates, ridx: int, num_candidates: int):
    """The swap phase's tile: the goal's top-C out- and in-candidates,
    salted by the round index — (out_top, out_c, in_top, in_c)."""
    return (*_top_candidates(goal.swap_out_score(gctx, placement, agg, ridx),
                             num_candidates, gctx.shard),
            *_top_candidates(goal.swap_in_score(gctx, placement, agg, ridx),
                             num_candidates, gctx.shard))


def _swap_phase(goal: Goal, priors: Sequence[Goal], num_candidates: int,
                jitter_frac: float = 1.0):
    """The swap phase: :func:`swap_body` on the round's :func:`swap_tile`."""
    def phase(gctx: GoalContext, placement: Placement, agg: Aggregates, ridx: int):
        tile = swap_tile(goal, gctx, placement, agg, ridx, num_candidates)
        return swap_body(goal, priors, gctx, placement, agg, ridx, *tile, jitter_frac)

    return phase


def _intra_disk_phase(goal: Goal, num_candidates: int):
    """Moves between a broker's own logdirs: each candidate goes to its
    cheapest feasible sibling disk, one move per source and per destination
    logdir per round."""
    def phase(gctx: GoalContext, placement: Placement, agg: Aggregates, ridx: int):
        state = gctx.state
        d_n = state.num_disks_per_broker
        c = num_candidates
        top_score, cand = _top_candidates(
            goal.disk_candidate_score(gctx, placement, agg), c, gctx.shard)
        is_cand = top_score > _SCORE_FLOOR
        r2 = cand[:, None]
        d2 = _arange(d_n, cand)[None, :]
        ok = goal.disk_move_ok(gctx, placement, agg, r2, d2)
        b_of = placement.broker[cand]
        b2 = b_of[:, None]
        frac = ((agg.disk_load[b2, d2] + state.leader_load[r2, Resource.DISK])
                / torch.clamp(state.disk_capacity[b2, d2], min=1e-9))
        best = torch.argmin(torch.where(ok, frac, _INF_COST), dim=1)
        feasible = ok.any(dim=1) & is_cand

        order = torch.where(feasible, _arange(c, cand), c)
        src_disk = placement.disk[cand]
        nseg = state.num_brokers_padded * d_n
        keep = (feasible
                & _group_winners(order, b_of * d_n + src_disk, nseg)
                & _group_winners(order, b_of * d_n + best, nseg))
        cand, best, keep = _agree(gctx, cand, best, keep)
        b_of = placement.broker[cand]
        src_disk = placement.disk[cand]

        new_disk = torch.where(keep, best, src_disk)
        # Only disk_load changes; the ROLE-based disk size is what the
        # aggregate holds for the replica.
        size = torch.where(keep, replica_role_load(gctx, placement, cand)[:, Resource.DISK],
                           0.0)
        flat = agg.disk_load.reshape(-1)
        flat = flat.index_add(0, (b_of * d_n + src_disk).long(), -size)
        flat = flat.index_add(0, (b_of * d_n + new_disk).long(), size)
        placement = placement.replace(
            disk=set_rows(placement.disk, cand, new_disk.to(torch.int32)))
        return (placement, agg.replace(disk_load=flat.reshape(agg.disk_load.shape)),
                keep.sum())

    return phase


def _direct_phase(goal: Goal):
    """A goal solved by one transform (``direct_apply``), then a full
    aggregate recompute."""
    def phase(gctx: GoalContext, placement: Placement, agg: Aggregates, ridx: int):
        new_pl = goal.direct_apply(gctx, placement, agg)
        new_pl = Placement(*_agree(gctx, new_pl.broker, new_pl.disk, new_pl.is_leader))
        changed = (new_pl.is_leader != placement.is_leader).sum() // 2
        return new_pl, compute_aggregates(gctx, new_pl), changed

    return phase


@dataclass
class _Carry:
    """What one round hands the next: the placement, the aggregates, the
    actions applied so far (all, and the swaps and leadership moves among
    them), the stall and best-work bookkeeping, and the loop condition's
    four values (violated, stranded, applied, stall), i64[4]."""

    placement: Placement
    agg: Aggregates
    moves: torch.Tensor
    swaps: torch.Tensor
    leader_moves: torch.Tensor
    stall: torch.Tensor
    best_work: torch.Tensor
    best_metric: torch.Tensor
    cond: torch.Tensor


def _end_failed_capture(device: torch.device, pool) -> None:
    """Give the caching allocator its normal state back after a capture that
    ``capture_end`` did not end: the CUDA runtime invalidated it (a host read
    or sync inside the round), or it never began.  Until the allocator stops
    routing the stream's allocations to the graph's private pool, it defers
    frees across streams, skips its event processing and refuses to empty
    its cache; and the graph object never releases a pool whose capture did
    not end.  Where ``capture_end`` got as far as ending the routing, the
    graph object releases the pool itself."""
    index = torch.cuda._get_device_index(device, optional=True)
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:
        return
    torch._C._cuda_releasePool(index, pool)


class _RoundGraph:
    """One key's entry, made on its first solve, and from its second the
    captured round: the CUDA graph, the static buffers it reads and writes
    (a lane's context, the carry, the round index), their bytes as posted
    to the memory ledger, and the lock a solve holds while it uses them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.gctx: Optional[GoalContext] = None
        self.carry: Optional[_Carry] = None
        self.ridx: Optional[torch.Tensor] = None
        self.nbytes = 0
        self.failed = False

    def drop(self) -> None:
        """Free the graph and its buffers, and take them off the ledger."""
        if self.graph is not None:
            _memory_ledger().post(GRAPH_SUBSYSTEM, self.nbytes, kind="free")
        self.graph = self.gctx = self.carry = self.ridx = None


class _Rounds:
    """The rounds of one solve.  :meth:`run` fills the round index, resyncs
    the aggregates eagerly where one is due (so the aggregate kernel's
    cooperative launch never enters a graph), then replays the key's round
    graph, captures it, or runs :meth:`GoalSolver._round_step` eagerly, and
    says which: the ``solve.round`` span's ``graph`` attribute."""

    def __init__(self, solver: "GoalSolver", runner, gctx: GoalContext, carry: _Carry,
                 curve: Optional[torch.Tensor], held: Optional[_RoundGraph],
                 reason: Optional[str]):
        self.solver, self.runner, self.curve = solver, runner, curve
        self.held = held          # the key's graph entry, locked by this solve
        self.reason = reason      # why the rounds run eagerly (None: a graph)
        if held is None:
            # The solve's own copies: the caller's tensors are never written.
            self.gctx, self.carry = gctx, _cloned(carry)
            self.ridx = torch.zeros((), dtype=torch.int64, device=gctx.state.device)
            return
        if held.graph is None:
            held.gctx, held.carry = _cloned(gctx), _cloned(carry)
            held.ridx = torch.zeros((), dtype=torch.int64, device=gctx.state.device)
        else:
            _copy_into((held.gctx, held.carry), (gctx, carry))
        self.gctx, self.carry, self.ridx = held.gctx, held.carry, held.ridx

    def run(self, rounds: int) -> str:
        self.ridx.fill_(rounds)
        if rounds > 0 and rounds % self.solver.AGG_RESYNC_ROUNDS == 0:
            _copy_into(self.carry.agg, compute_aggregates(self.gctx, self.carry.placement))
        if self.reason is None:
            if self.held.graph is None:
                return self._capture()
            self.held.graph.replay()
            registry().counter(GRAPH_REPLAYS_SENSOR).inc()
            return "replay"
        self.solver._round_step(self.runner, self.gctx, self.carry, self.ridx, self.curve)
        registry().counter(GRAPH_EAGER_SENSOR).inc()
        return f"eager:{self.reason}"

    def _capture(self) -> str:
        """The key's first round: run eagerly on a side stream (the warm-up,
        and this round's work), then captured from the buffers it left.
        The capture takes the CUDA graph API directly: ``torch.cuda.graph``
        would synchronize the device, collect garbage and empty the cache at
        every capture, and leave its stream current when a capture fails."""
        held = self.held
        dev = self.gctx.state.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        try:
            with torch.cuda.stream(side):
                self.solver._round_step(self.runner, self.gctx, self.carry, self.ridx)
                ended = False
                try:
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        self.solver._round_step(self.runner, self.gctx, self.carry, self.ridx,
                                                spans=False)
                    finally:
                        graph.capture_end()
                        ended = True
                except Exception as e:  # noqa: BLE001 — any failure falls back to eager rounds
                    if not ended:
                        _end_failed_capture(dev, pool)
                    held.failed = True
                    self.reason = "capture_failed"
                    registry().counter(GRAPH_FAILURES_SENSOR).inc()
                    registry().counter(GRAPH_EAGER_SENSOR).inc()
                    LOG.warning("solver round graph: capture failed, the key's rounds run "
                                "eagerly: %r", e, exc_info=True)
                    return "eager:capture_failed"
        finally:
            main.wait_stream(side)
        held.graph = graph
        # The static buffers, which the allocator counts in use.  The graph's
        # private pool is reserved, not in use, between replays: the ledger
        # mirrors in-use bytes and is held to the allocator's count of them.
        held.nbytes = measure_bytes((held.gctx, held.carry, held.ridx))
        _memory_ledger().post(GRAPH_SUBSYSTEM, held.nbytes)
        registry().counter(GRAPH_CAPTURES_SENSOR).inc()
        return "capture"

    def placement(self) -> Placement:
        """The solve's placement, cloned out of a graph's static buffers,
        which the next solve's copy-in overwrites."""
        pl = self.carry.placement
        return pl if self.held is None else _cloned(pl)

    def close(self) -> None:
        if self.held is not None:
            if self.held.failed:
                self.held.drop()
            self.held.lock.release()
            self.held = None


class GoalSolver:
    """Runs one goal's convergence loop of batched rounds."""

    # Aggregates carried across rounds are re-synced from a full O(R)
    # recompute every this-many rounds, bounding incremental scatter-drift.
    AGG_RESYNC_ROUNDS = 4

    def __init__(self, max_candidates_per_round: int = 4096,
                 max_rounds_per_goal: int = 96,
                 # Swap tiles are C'×C' pair matrices.
                 max_swap_candidates: int = 1024,
                 dst_jitter_frac: float = 1.0,
                 stall_limit: int = 8,
                 # Destination-axis tile for goals declaring dst_prune_score
                 # (0 disables): band/count goals only ever send load to the
                 # top few hundred headroom brokers in one round.
                 max_dst_candidates: int = 1024,
                 # Rounds between budget checks in a segmented solve.
                 segment_rounds: int = 8,
                 mesh=None):
        self.max_candidates = max_candidates_per_round
        self.segment_rounds = max(1, int(segment_rounds))
        self.max_rounds = max_rounds_per_goal
        self.max_swap_candidates = max_swap_candidates
        self.max_dst_candidates = max_dst_candidates
        # Soft-goal churn cutoff: stop a goal's loop after this many
        # consecutive rounds with neither a violation-count drop nor a
        # relative stats-metric improvement (>1e-4).
        self.stall_limit = stall_limit
        # Destination-jitter span as a fraction of each candidate's feasible
        # cost range.  1.0 maximizes batch width; 0.0 is greedy argmin.
        self.dst_jitter_frac = dst_jitter_frac
        # Executable families (the JAX package's ``_round_cache`` keys) ->
        # the input shape signatures each has run at.
        self._families: Dict[tuple, set] = {}
        self._families_lock = threading.Lock()
        # Optional :class:`~cruise_control_tpu_torch.parallel.mesh.SolverMesh`:
        # :meth:`shard_inputs` gives each solve this rank's replica shard.
        self.mesh = mesh
        # Round graphs by key (:meth:`_start_rounds`), least recently used first.
        self._graphs: "OrderedDict[tuple, _RoundGraph]" = OrderedDict()
        self._graphs_lock = threading.Lock()
        round_graph_sensors()

    def shard_inputs(self, gctx: GoalContext, placement: Placement):
        """(gctx, placement) committed to this solver's mesh: the context
        carries this rank's replica shard, and the placement stays whole on
        every rank.  Unchanged without a mesh.  Call once per optimization."""
        if self.mesh is None:
            return gctx, placement
        shard = self.mesh.replica_shard(gctx.state.num_replicas_padded)
        return dataclasses.replace(gctx, shard=shard), placement

    @contextmanager
    def dispatch(self, bucket: str, keys: Sequence[tuple], args, device,
                 label: Optional[str] = None):
        """Account one goal dispatch through the executable families
        ``keys`` (the JAX package's ``_cached_executable`` and
        ``_CompileTracked``).

        Each family is looked up now: a *hit* when it ran before, else a
        *miss* (``CompileService.<bucket>.cache-{hit,miss}-count``).  A family
        the body runs at an input shape (:func:`shape_signature` of ``args``)
        new to it is a *compile*, recorded under ``label`` (default
        ``bucket``) after the body with the body's wall, and its first run
        gives the cost ledger a row from ``args`` and the outputs the body
        puts on the yielded :class:`Dispatch` (with the card's peak over the
        run in ``full`` mode).  The body names the families it did not run in
        ``Dispatch.skipped``.  Nothing is recorded when the body raises."""
        shape = shape_signature(args)
        tel = _compile_telemetry()
        fresh = []
        with self._families_lock:
            for key in keys:
                seen = self._families.get(key)
                if seen is None:
                    seen = self._families[key] = set()
                    tel.record_miss(bucket)
                else:
                    tel.record_hit(bucket)
                if shape not in seen:
                    fresh.append(key)
        ledger = _memory_ledger()
        peak_base = None
        if fresh and ledger.wants_run_peak(device):
            torch.cuda.synchronize(device)
            peak_base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        d = Dispatch()
        t0 = time.monotonic()
        yield d
        fresh = [k for k in fresh if k not in d.skipped]
        if not fresh:
            return
        elapsed = time.monotonic() - t0
        run_peak = None
        if peak_base is not None:
            torch.cuda.synchronize(device)
            run_peak = torch.cuda.max_memory_allocated(device) - peak_base
        with self._families_lock:
            for key in fresh:
                self._families[key].add(shape)
        for _ in fresh:
            tel.record_compile(label or bucket, elapsed / len(fresh))
            ledger.observe_compile(label or bucket, args, d.outputs, run_peak)

    def _width(self, goal: Goal, num_replicas_padded: int) -> int:
        # Narrowing hints always win.  WIDENING hints (rack) are honored
        # only when this goal's destination axis is tiled, bounded so the
        # pair-tile area stays within what the configured cap implies.
        cap = self.max_candidates
        hint = goal.candidate_width_hint
        if hint is None:
            return min(cap, num_replicas_padded)
        if hint > cap:
            prunes = (self.max_dst_candidates > 0
                      and type(goal).dst_prune_score is not Goal.dst_prune_score)
            if not prunes:
                hint = cap
            else:
                hint = min(hint, cap * max(1, cap // self.max_dst_candidates))
        return min(hint, num_replicas_padded)

    def swap_width(self, goal: Goal, num_replicas_padded: int) -> int:
        """C of the goal's C×C swap tile."""
        return min(self.max_swap_candidates, self._width(goal, num_replicas_padded))

    def _phases(self, goal: Goal, priors: Tuple[Goal, ...], c: int):
        """(span name, phase function) pairs in execution order."""
        phases = []
        if goal.is_direct:
            phases.append(("phase.direct", _direct_phase(goal)))
        if goal.uses_leadership_moves:
            phases.append(("phase.leadership", _leadership_phase(goal, priors, c)))
        if goal.uses_replica_moves:
            # Priors-aware receiver ranking where the goal offers it (an
            # ORDER heuristic: acceptance stays exact either way).
            prune = goal.dst_prune_score
            if hasattr(goal, "dst_prune_score_vs"):
                def prune(gctx, pl, ag, _f=goal.dst_prune_score_vs):
                    return _f(gctx, pl, ag, priors)
            phases.append(("phase.replica", _replica_phase(
                goal, priors, c, goal.candidate_score, goal.self_ok,
                jitter_frac=self.dst_jitter_frac, prune_fn=prune,
                max_dst=self.max_dst_candidates)))
        if goal.has_pull_phase:
            phases.append(("phase.pull", _replica_phase(
                goal, priors, c, goal.pull_candidate_score, goal.self_ok,
                dst_mask_fn=goal.pull_dst_mask, jitter_frac=self.dst_jitter_frac,
                prune_fn=goal.pull_dst_prune_score, max_dst=self.max_dst_candidates)))
        if goal.has_swap_phase:
            phases.append(("phase.swap", _swap_phase(
                goal, priors, min(self.max_swap_candidates, c),
                jitter_frac=self.dst_jitter_frac)))
        if goal.intra_disk:
            phases.append(("phase.intra_disk", _intra_disk_phase(goal, c)))
        return phases

    def _phases_runner(self, goal: Goal, priors: Tuple[Goal, ...], c: int):
        """One round given the caller's aggregates; returns the updated
        aggregates so the loop can carry them across rounds, and the
        actions the round applied: all of them, then those of the swap and
        of the leadership phase."""
        phases = self._phases(goal, priors, c)
        tr = _tracer()

        def run(gctx: GoalContext, placement: Placement, agg: Aggregates, ridx,
                spans: bool = True):
            span = tr.span if spans else _no_span
            applied = swaps = leads = torch.zeros((), dtype=torch.int64,
                                                  device=gctx.state.device)
            for name, phase in phases:
                with span(name):
                    placement, agg, n = phase(gctx, placement, agg, ridx)
                    applied = applied + n
                if name == "phase.swap":
                    swaps = n
                elif name == "phase.leadership":
                    leads = n
            with span("round.stats"):
                violated = goal.violated_brokers(gctx, placement, agg).sum()
                stranded = currently_offline(gctx, placement).sum()
                metric = goal.stats_metric(gctx, placement, agg)
            return placement, agg, applied, violated, stranded, metric, swaps, leads

        return run

    def run_round(self, goal: Goal, priors: Sequence[Goal], gctx: GoalContext,
                  placement: Placement, ridx: int = 0):
        """One round from fresh aggregates: (placement, applied, violated,
        stranded, metric) — the JAX package's ``_round_fn`` body."""
        c = self._width(goal, gctx.state.num_replicas_padded)
        runner = self._phases_runner(goal, tuple(priors), c)
        placement, _, applied, violated, stranded, metric, *_ = runner(
            gctx, placement, compute_aggregates(gctx, placement), ridx)
        return placement, applied, violated, stranded, metric

    def optimize_goal(self, goal: Goal, priors: Sequence[Goal], gctx: GoalContext,
                      placement: Placement, agg: Optional[Aggregates] = None,
                      budget=None, width: Optional[int] = None,
                      ) -> Tuple[Placement, Aggregates, GoalOptimizationInfo]:
        """Run rounds until converged (the reference's per-goal
        ``while !finished`` loop, GoalOptimizer.java:437-462).

        ``agg`` lets the caller thread one goal's exact final aggregates into
        the next goal's solve (without it the solve computes them, inside
        its ``solve.enter`` at a given ``width``); the returned aggregates
        are a fresh full recompute, or the entry aggregates when no round
        ran.

        ``budget`` (a :class:`~cruise_control_tpu_torch.analyzer.budget.SolveBudget`
        with ``segmented`` set) is checked before the first round and at
        every ``segment_rounds``-th round boundary where the loop would go
        on; when it stops the solve, the placement so far is returned with
        ``preempted`` set.  The rounds are the same either way, so a
        segmented solve run to convergence equals an unbudgeted one.
        ``width`` replaces the goal's candidate width: what-if lanes run
        every goal at one width, and their lane block's dispatch accounts
        for them (``GoalOptimizer._run_lanes``).

        The solve is one :meth:`dispatch` through the JAX package's family:
        ``("solve", goal, priors, C)`` at bucket ``R<R>-C<C>``, or the three
        ``("segment", …)`` families (init, step, finalize) at ``R<R>-C<C>-S``
        under a segmented budget (step unrun when the budget stops the
        solve before its first round); round recording adds ``rounds`` to
        the key and ``-T`` to the bucket."""
        segmented = budget is not None and budget.segmented
        # The JAX package checks a segmented budget once before the first
        # segment, then after each segment that left the loop unfinished.
        stop = budget.stop_reason() if segmented else None
        if width is not None:
            return self._converge(goal, priors, gctx, placement, agg, budget, width, stop)
        if agg is None:
            agg = self.aggregates(gctx, placement)
        c = self._width(goal, gctx.state.num_replicas_padded)
        prior_keys = tuple(g.name for g in priors)
        bucket = f"R{gctx.state.num_replicas_padded}-C{c}"
        if segmented:
            base, bucket = ("segment", goal.name, prior_keys, c), bucket + "-S"
        else:
            base = ("solve", goal.name, prior_keys, c)
        if _RECORD_ROUNDS:
            base, bucket = base + ("rounds",), bucket + "-T"
        keys = [base + (part,) for part in ("init", "step", "fin")] if segmented else [base]
        with self.dispatch(bucket, keys, (gctx, placement, agg), gctx.state.device) as d:
            if stop is not None:
                d.skipped.add(keys[1])
            out = self._converge(goal, priors, gctx, placement, agg, budget, c, stop)
            d.outputs = out[:2]
        return out

    def _round_step(self, runner, gctx: GoalContext, carry: _Carry, ridx: torch.Tensor,
                    curve: Optional[torch.Tensor] = None, spans: bool = True) -> None:
        """One round on ``carry``, written back into it: the phases and
        ``round.stats`` (``runner``), the stall and best-work bookkeeping,
        the loop condition's values, and with ``curve`` the round's
        ``ROUND_STATS_COLS`` row.  ``ridx`` is the round index, an i64
        device scalar.  It reads nothing back to the host, so a CUDA graph
        can capture it, and it is the same step where none does."""
        pl, ag, applied, violated, stranded, metric, swaps, leads = runner(
            gctx, carry.placement, carry.agg, ridx, spans)
        work_now = violated + stranded
        improved = ((work_now < carry.best_work)
                    | (metric < carry.best_metric - 1e-4 * carry.best_metric.abs() - 1e-12))
        stall = torch.where(improved, 0, carry.stall + 1)
        if curve is not None:
            resync = (ridx > 0) & (ridx % self.AGG_RESYNC_ROUNDS == 0)
            # A 1-d index: a 0-d tensor index is read back to the host.
            curve.index_copy_(0, ridx.reshape(1), torch.stack([x.to(torch.float32) for x in (
                applied, violated, stranded, metric, resync, stall)])[None])
        _copy_into(carry, _Carry(
            placement=pl, agg=ag, moves=carry.moves + applied, swaps=carry.swaps + swaps,
            leader_moves=carry.leader_moves + leads, stall=stall,
            best_work=torch.minimum(carry.best_work, work_now),
            best_metric=torch.minimum(carry.best_metric, metric),
            cond=torch.stack([violated, stranded, applied, stall])))

    def _start_rounds(self, goal: Goal, priors: Sequence[Goal], c: int, runner,
                      gctx: GoalContext, carry: _Carry,
                      curve: Optional[torch.Tensor]) -> _Rounds:
        """The rounds of a solve, from its first: on the round graph of its
        key (goals, width, the solver's tile settings, the input shapes),
        held by this solve until :meth:`_Rounds.close`; or eager, for the
        reason its inputs give, on the key's first solve, or where the key's
        graph is unusable."""
        if gctx.state.device.type != "cuda":
            reason = "cpu"
        elif gctx.shard is not None:
            reason = "shard"       # the rounds' collectives (``_agree``) stay eager
        elif curve is not None:
            reason = "recording"
        elif goal.is_direct:
            # Its phase recomputes the aggregates, whose kernel's cooperative
            # launch refuses a capture.
            reason = "direct"
        else:
            key = (gctx.state.device, _goal_key(goal), tuple(_goal_key(g) for g in priors),
                   c, self.dst_jitter_frac, self.max_dst_candidates, self.max_swap_candidates,
                   shape_signature((gctx, carry.placement, carry.agg)))
            held, reason = self._hold_graph(key)
            if held is not None:
                return _Rounds(self, runner, gctx, carry, curve, held, None)
        return _Rounds(self, runner, gctx, carry, curve, None, reason)

    def _hold_graph(self, key) -> Tuple[Optional[_RoundGraph], Optional[str]]:
        """(``key``'s graph entry, locked; None) or (None, why not: ``first``
        on the key's first solve, which only makes its entry;
        ``capture_failed``; or ``busy`` when another thread's solve holds
        it).  A key is captured on its second solve: a capture costs more
        host time than the eager round it stands for, and the graph keeps a
        copy of the context, so a key solved once, as each goal of a
        one-shot proposal is, would pay both and replay little.  A miss
        past :data:`ROUND_GRAPH_SLOTS` entries drops the least recently used
        ones no solve holds."""
        with self._graphs_lock:
            held = self._graphs.get(key)
            if held is None:
                self._graphs[key] = _RoundGraph()
                for old in list(self._graphs)[:-1]:
                    if len(self._graphs) <= ROUND_GRAPH_SLOTS:
                        break
                    entry = self._graphs[old]
                    if entry.lock.acquire(blocking=False):
                        del self._graphs[old]
                        entry.drop()
                        entry.lock.release()
                        registry().counter(GRAPH_EVICTIONS_SENSOR).inc()
                return None, "first"
            self._graphs.move_to_end(key)
        if held.failed:
            return None, "capture_failed"
        if not held.lock.acquire(blocking=False):
            return None, "busy"
        if held.failed:
            held.lock.release()
            return None, "capture_failed"
        return held, None

    def _go_on(self, gctx: GoalContext, rounds: int, use_stall_cutoff: bool, budget,
               cond: torch.Tensor) -> Tuple[bool, Optional[str], Optional[str]]:
        """The loop condition before round ``rounds``: (run it, the
        segmented budget's stop reason, why the loop ends: one of
        :data:`GOAL_ENDS`, None while it goes on) from ``cond`` (violated,
        stranded, applied last round, stall).  Its read of the device values
        is the one host sync of each round."""
        if rounds >= self.max_rounds:
            return False, None, "round_cap"
        cond, = _agree(gctx, cond)
        v, s, a, st = cond.tolist()
        if not (v > 0 or s > 0):
            return False, None, "satisfied"
        if not (rounds == 0 or a > 0):
            return False, None, "no_move"
        if use_stall_cutoff and st >= self.stall_limit:
            return False, None, "stalled"
        if (budget is not None and budget.segmented and rounds > 0
                and rounds % self.segment_rounds == 0):
            stop = budget.stop_reason()
            return stop is None, stop, None if stop is None else "budget"
        return True, None, None

    def _converge(self, goal: Goal, priors: Sequence[Goal], gctx: GoalContext,
                  placement: Placement, agg: Optional[Aggregates], budget, c: int,
                  stop: Optional[str]) -> Tuple[Placement, Aggregates, GoalOptimizationInfo]:
        """:meth:`optimize_goal`'s loop at candidate width ``c``; ``stop`` is
        the segmented budget's verdict before the first round.

        Its spans partition it: ``solve.enter`` (the entry aggregates where
        ``agg`` is None, the entry residuals and the loop condition before
        the first round), one ``solve.round`` a round
        (its resync, the round itself and the loop condition after it,
        with ``graph`` saying how the round ran; under
        a segmented budget, grouped ``segment_rounds`` at a time into
        ``solve.segment`` spans) and ``solve.exit`` (the fresh recompute
        and the one read of the goal's numbers)."""
        tr = _tracer()
        with tr.span("solve.enter"):
            # Soft goals only: a hard goal must exhaust its round budget
            # before the hard-goal check declares failure.
            use_stall_cutoff = not goal.is_hard
            segmented = budget is not None and budget.segmented
            runner = self._phases_runner(goal, tuple(priors), c)
            dev = gctx.state.device
            if agg is None:
                agg = compute_aggregates(gctx, placement)
            violated0 = goal.violated_brokers(gctx, placement, agg).sum()
            stranded0 = currently_offline(gctx, placement).sum()
            metric0 = goal.stats_metric(gctx, placement, agg)

            rounds = 0
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            carry = _Carry(placement=placement, agg=agg, moves=zero, swaps=zero,
                           leader_moves=zero, stall=zero,
                           best_work=violated0 + stranded0, best_metric=metric0,
                           cond=torch.stack([violated0, stranded0, zero + 1, zero]))
            # Round recording: one row a round into a preallocated device
            # buffer, in the ROUND_COL_* order; no sync of its own.
            curve_buf = (torch.zeros((self.max_rounds, ROUND_STATS_COLS), dtype=torch.float32,
                                     device=dev) if _RECORD_ROUNDS else None)
            go_on, end = False, "budget"
            if stop is None:
                go_on, stop, end = self._go_on(gctx, rounds, use_stall_cutoff, budget,
                                               carry.cond)
        segment = 0
        rs: Optional[_Rounds] = None
        try:
            while go_on:
                seg_end = min(rounds + self.segment_rounds, self.max_rounds)
                with (tr.span("solve.segment", goal=goal.name, segment=segment,
                              seg_end=seg_end)
                      if segmented else nullcontext()) as seg_span:
                    while go_on and (not segmented or rounds < seg_end):
                        with tr.span("solve.round", round=rounds) as round_span:
                            if rs is None:
                                rs = self._start_rounds(goal, priors, c, runner, gctx, carry,
                                                        curve_buf)
                            round_span.set("graph", rs.run(rounds))
                            rounds += 1
                            go_on, stop, end = self._go_on(gctx, rounds, use_stall_cutoff,
                                                           budget, rs.carry.cond)
                    if seg_span is not None:
                        seg_span.set("rounds", rounds)
                segment += 1

            with tr.span("solve.exit"):
                pl, ag, done = placement, agg, carry
                violated, stranded, metric = violated0, stranded0, metric0
                if rounds > 0:
                    # The returned residuals come from one fresh recompute:
                    # the in-loop values ride the carried aggregates (exact
                    # up to float scatter-drift between resyncs).
                    pl, done = rs.placement(), rs.carry
                    ag = compute_aggregates(gctx, pl)
                    violated = goal.violated_brokers(gctx, pl, ag).sum()
                    stranded = currently_offline(gctx, pl).sum()
                    metric = goal.stats_metric(gctx, pl, ag)
                vals, = _agree(gctx, torch.stack([x.to(torch.float64) for x in (
                    done.moves, violated0, violated, stranded, metric0, metric, done.swaps,
                    done.leader_moves)]))
                n_vals = vals.shape[0]
                curve = None
                if curve_buf is None:
                    vals = vals.tolist()
                else:
                    # The goal's one copy of its curve, in the same transfer
                    # as its final numbers.
                    host = torch.cat([vals, curve_buf[:rounds].reshape(-1).to(torch.float64)]).cpu()
                    curve = host[n_vals:].numpy().astype(np.float32).reshape(
                        rounds, ROUND_STATS_COLS)
                    vals = host[:n_vals].tolist()
                if end == "round_cap" and vals[2] == 0 and vals[3] == 0:
                    # The cap is checked before the condition is read: a goal
                    # whose last round finished its work ended satisfied.
                    end = "satisfied"
                registry().counter(f"Solver.goal-end.{end}").inc()
                return pl, ag, GoalOptimizationInfo(
                    goal_name=goal.name,
                    rounds=rounds,
                    moves_applied=int(vals[0]),
                    violated_brokers_before=int(vals[1]),
                    violated_brokers_after=int(vals[2]),
                    stranded_after=int(vals[3]),
                    swaps_applied=int(vals[6]),
                    leader_moves_applied=int(vals[7]),
                    end=end,
                    metric_before=vals[4],
                    metric_after=vals[5],
                    round_curve=curve,
                    preempted=stop is not None,
                    preempt_reason=stop,
                )
        finally:
            if rs is not None:
                rs.close()

    def aggregates(self, gctx: GoalContext, placement: Placement) -> Aggregates:
        return compute_aggregates(gctx, placement)

    def violations(self, goals: Sequence[Goal], gctx: GoalContext,
                   placement: Placement, agg: Aggregates) -> np.ndarray:
        """Per-goal violated-broker counts (i32[G]) in one host transfer."""
        if not goals:
            return np.zeros(0, dtype=np.int32)
        counts, = _agree(gctx, torch.stack([g.violated_brokers(gctx, placement, agg).sum()
                                            for g in goals]).to(torch.int32))
        return counts.cpu().numpy()


def check_hard_goal(goal: Goal, info: GoalOptimizationInfo,
                    stranded_offline: int) -> None:
    """Hard-goal failure aborts the optimization (reference:
    OptimizationFailureError thrown from goal.optimize)."""
    if goal.is_hard and info.violated_brokers_after > 0:
        raise OptimizationFailureError(
            f"[{goal.name}] Violated {info.violated_brokers_after} brokers remain "
            f"after {info.rounds} rounds / {info.moves_applied} moves.")
    if goal.is_hard and stranded_offline > 0:
        raise OptimizationFailureError(
            f"[{goal.name}] {stranded_offline} offline replicas could not be "
            "relocated to alive brokers.")
