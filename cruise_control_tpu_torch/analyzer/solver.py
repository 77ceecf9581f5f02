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
the loop condition.  A phase with no candidate runs its tile anyway, fully
masked (nothing is kept), instead of syncing to skip it.  Top-k is exact and
breaks ties by index, as ``lax.top_k`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

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
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.state import Placement

_SCORE_FLOOR = -1e29  # candidate scores below this are "not a candidate"
_INF_COST = 3.4e38


def _top_candidates(score: torch.Tensor, k: int):
    """(values, indices) of the k best-scoring rows, descending, ties to the
    lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:k], idx[:k]


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
    metric_before: float = 0.0
    metric_after: float = 0.0
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

    @property
    def succeeded(self) -> bool:
        return self.violated_brokers_after == 0


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
        top_score, cand = _top_candidates(score_fn(gctx, placement, agg), c)
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
            goal.leadership_candidate_score(gctx, placement, agg), c)
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
                             num_candidates),
            *_top_candidates(goal.swap_in_score(gctx, placement, agg, ridx),
                             num_candidates))


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
            goal.disk_candidate_score(gctx, placement, agg), c)
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
        changed = (new_pl.is_leader != placement.is_leader).sum() // 2
        return new_pl, compute_aggregates(gctx, new_pl), changed

    return phase


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
                 segment_rounds: int = 8):
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
        """Phase functions in execution order."""
        phases = []
        if goal.is_direct:
            phases.append(_direct_phase(goal))
        if goal.uses_leadership_moves:
            phases.append(_leadership_phase(goal, priors, c))
        if goal.uses_replica_moves:
            # Priors-aware receiver ranking where the goal offers it (an
            # ORDER heuristic: acceptance stays exact either way).
            prune = goal.dst_prune_score
            if hasattr(goal, "dst_prune_score_vs"):
                def prune(gctx, pl, ag, _f=goal.dst_prune_score_vs):
                    return _f(gctx, pl, ag, priors)
            phases.append(_replica_phase(goal, priors, c,
                                         goal.candidate_score, goal.self_ok,
                                         jitter_frac=self.dst_jitter_frac,
                                         prune_fn=prune,
                                         max_dst=self.max_dst_candidates))
        if goal.has_pull_phase:
            phases.append(_replica_phase(goal, priors, c,
                                         goal.pull_candidate_score, goal.self_ok,
                                         dst_mask_fn=goal.pull_dst_mask,
                                         jitter_frac=self.dst_jitter_frac,
                                         prune_fn=goal.pull_dst_prune_score,
                                         max_dst=self.max_dst_candidates))
        if goal.has_swap_phase:
            phases.append(_swap_phase(goal, priors, min(self.max_swap_candidates, c),
                                      jitter_frac=self.dst_jitter_frac))
        if goal.intra_disk:
            phases.append(_intra_disk_phase(goal, c))
        return phases

    def _phases_runner(self, goal: Goal, priors: Tuple[Goal, ...], c: int):
        """One round given the caller's aggregates; returns the updated
        aggregates so the loop can carry them across rounds."""
        phases = self._phases(goal, priors, c)

        def run(gctx: GoalContext, placement: Placement, agg: Aggregates, ridx: int):
            applied = torch.zeros((), dtype=torch.int64, device=gctx.state.device)
            for phase in phases:
                placement, agg, n = phase(gctx, placement, agg, ridx)
                applied = applied + n
            violated = goal.violated_brokers(gctx, placement, agg).sum()
            stranded = currently_offline(gctx, placement).sum()
            metric = goal.stats_metric(gctx, placement, agg)
            return placement, agg, applied, violated, stranded, metric

        return run

    def run_round(self, goal: Goal, priors: Sequence[Goal], gctx: GoalContext,
                  placement: Placement, ridx: int = 0):
        """One round from fresh aggregates: (placement, applied, violated,
        stranded, metric) — the JAX package's ``_round_fn`` body."""
        c = self._width(goal, gctx.state.num_replicas_padded)
        runner = self._phases_runner(goal, tuple(priors), c)
        placement, _, applied, violated, stranded, metric = runner(
            gctx, placement, compute_aggregates(gctx, placement), ridx)
        return placement, applied, violated, stranded, metric

    def optimize_goal(self, goal: Goal, priors: Sequence[Goal], gctx: GoalContext,
                      placement: Placement, agg: Optional[Aggregates] = None,
                      budget=None, width: Optional[int] = None,
                      ) -> Tuple[Placement, Aggregates, GoalOptimizationInfo]:
        """Run rounds until converged (the reference's per-goal
        ``while !finished`` loop, GoalOptimizer.java:437-462).

        ``agg`` lets the caller thread one goal's exact final aggregates into
        the next goal's solve; the returned aggregates are a fresh full
        recompute, or the entry aggregates when no round ran.

        ``budget`` (a :class:`~cruise_control_tpu_torch.analyzer.budget.SolveBudget`
        with ``segmented`` set) is checked before the first round and at
        every ``segment_rounds``-th round boundary where the loop would go
        on; when it stops the solve, the placement so far is returned with
        ``preempted`` set.  The rounds are the same either way, so a
        segmented solve run to convergence equals an unbudgeted one.
        ``width`` replaces the goal's candidate width (what-if lanes run
        every goal at one width)."""
        if agg is None:
            agg = self.aggregates(gctx, placement)
        c = self._width(goal, gctx.state.num_replicas_padded) if width is None else width
        runner = self._phases_runner(goal, tuple(priors), c)
        dev = gctx.state.device
        violated0 = goal.violated_brokers(gctx, placement, agg).sum()
        stranded0 = currently_offline(gctx, placement).sum()
        metric0 = goal.stats_metric(gctx, placement, agg)

        pl, ag = placement, agg
        rounds = 0
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        applied_last, moves, stall = zero + 1, zero, zero
        violated, stranded = violated0, stranded0
        best_work, best_metric = violated0 + stranded0, metric0
        # Soft goals only: a hard goal must exhaust its round budget before
        # the hard-goal check declares failure.
        use_stall_cutoff = not goal.is_hard
        segmented = budget is not None and budget.segmented
        # The JAX package checks a segmented budget once before the first
        # segment, then after each segment that left the loop unfinished.
        stop = budget.stop_reason() if segmented else None
        while stop is None and rounds < self.max_rounds:
            # The loop condition: the one host sync of each round.
            v, s, a, st = torch.stack([violated, stranded, applied_last, stall]).tolist()
            if not ((v > 0 or s > 0) and (rounds == 0 or a > 0)):
                break
            if use_stall_cutoff and st >= self.stall_limit:
                break
            if segmented and rounds > 0 and rounds % self.segment_rounds == 0:
                stop = budget.stop_reason()
                if stop is not None:
                    break
            if rounds > 0 and rounds % self.AGG_RESYNC_ROUNDS == 0:
                ag = compute_aggregates(gctx, pl)
            pl, ag, applied, violated, stranded, metric = runner(gctx, pl, ag, rounds)
            work_now = violated + stranded
            improved = ((work_now < best_work)
                        | (metric < best_metric - 1e-4 * best_metric.abs() - 1e-12))
            stall = torch.where(improved, zero, stall + 1)
            best_work = torch.minimum(best_work, work_now)
            best_metric = torch.minimum(best_metric, metric)
            applied_last = applied
            moves = moves + applied
            rounds += 1

        if rounds > 0:
            # The returned residuals come from one fresh recompute: the
            # in-loop values ride the carried aggregates (exact up to float
            # scatter-drift between resyncs).
            ag = compute_aggregates(gctx, pl)
            violated = goal.violated_brokers(gctx, pl, ag).sum()
            stranded = currently_offline(gctx, pl).sum()
            metric = goal.stats_metric(gctx, pl, ag)
        else:
            metric = metric0
        vals = torch.stack([x.to(torch.float64) for x in (
            moves, violated0, violated, stranded, metric0, metric)]).tolist()
        info = GoalOptimizationInfo(
            goal_name=goal.name,
            rounds=rounds,
            moves_applied=int(vals[0]),
            violated_brokers_before=int(vals[1]),
            violated_brokers_after=int(vals[2]),
            stranded_after=int(vals[3]),
            metric_before=vals[4],
            metric_after=vals[5],
            preempted=stop is not None,
            preempt_reason=stop,
        )
        return pl, ag, info

    def aggregates(self, gctx: GoalContext, placement: Placement) -> Aggregates:
        return compute_aggregates(gctx, placement)

    def violations(self, goals: Sequence[Goal], gctx: GoalContext,
                   placement: Placement, agg: Aggregates) -> np.ndarray:
        """Per-goal violated-broker counts (i32[G]) in one host transfer."""
        if not goals:
            return np.zeros(0, dtype=np.int32)
        return torch.stack([g.violated_brokers(gctx, placement, agg).sum()
                            for g in goals]).to(torch.int32).cpu().numpy()


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
