"""Replica-count distribution (soft) goals.

Reference: ``analyzer/goals/ReplicaDistributionAbstractGoal.java`` and
subclasses ``ReplicaDistributionGoal.java``,
``LeaderReplicaDistributionGoal.java``, ``TopicReplicaDistributionGoal.java``.

Count bands mirror the load bands: with avg = alive replicas / alive brokers,
a broker should hold between ``floor(avg*(2-T))`` and ``ceil(avg*T)`` replicas
(leader replicas / per-topic replicas for the sibling goals).
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.context import current_leader_of, currently_offline
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal,
    NEG_INF,
    OFFLINE_BONUS,
    alive_mask,
)


def _alive_mean(counts, alive):
    """f32 scalar: mean of ``counts`` over alive brokers (at least one)."""
    n = torch.clamp(alive.sum(), min=1)
    return torch.where(alive, counts, 0).sum() / n


def _count_bounds(counts, alive, threshold):
    """(upper i32, lower i32) band around the alive-broker average count."""
    avg = _alive_mean(counts, alive)
    upper = torch.ceil(avg * threshold).to(torch.int32)
    lower = torch.floor(avg * (2.0 - threshold)).to(torch.int32)
    return torch.clamp(upper, min=1), torch.clamp(lower, min=0)


class ReplicaDistributionGoal(Goal):
    """Even replica counts across brokers (ReplicaDistributionGoal.java)."""

    name = "ReplicaDistributionGoal"
    is_hard = False
    has_pull_phase = True
    src_sensitive_accept = True
    multi_accept_safe = True
    multi_leadership_safe = True    # promotions are replica-count-neutral

    def _counts(self, gctx, agg):
        return agg.replica_counts

    def _threshold(self, gctx):
        return gctx.replica_balance_threshold

    def _bounds(self, gctx, agg):
        return _count_bounds(self._counts(gctx, agg), alive_mask(gctx),
                             self._threshold(gctx))

    def violated_brokers(self, gctx, placement, agg):
        upper, lower = self._bounds(gctx, agg)
        c = self._counts(gctx, agg)
        alive = alive_mask(gctx)
        dead_with = (~gctx.state.alive) & gctx.state.broker_valid & (c > 0)
        return ((c > upper) | (c < lower)) & alive | dead_with

    def _over_brokers(self, gctx, agg):
        upper, _ = self._bounds(gctx, agg)
        return (self._counts(gctx, agg) > upper) & alive_mask(gctx)

    def candidate_score(self, gctx, placement, agg):
        state = gctx.state
        over = self._over_brokers(gctx, agg)
        prio = self.replica_priority(gctx, placement, agg)
        cand = over[placement.broker] & state.valid & ~gctx.replica_excluded
        score = torch.where(cand, prio, NEG_INF)
        offline = currently_offline(gctx, placement)
        return torch.where(offline, prio + OFFLINE_BONUS, score)

    def replica_priority(self, gctx, placement, agg):
        # Lightest replicas first: count goals shouldn't disturb load balance.
        load = torch.where(placement.is_leader[:, None],
                           gctx.state.leader_load, gctx.state.follower_load)
        mean_cap = gctx.state.capacity.mean(dim=0, keepdim=True)
        return -(load / torch.clamp(mean_cap, min=1e-9)).sum(dim=-1)

    def self_ok(self, gctx, placement, agg, r, dst):
        return self.accept_replica_move(gctx, placement, agg, r, dst)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        upper, lower = self._bounds(gctx, agg)
        c = self._counts(gctx, agg)
        src = placement.broker[r]
        dst_ok = c[dst] + 1 <= upper
        src_ok = (c[src] - 1 >= lower) | ~gctx.state.alive[src]
        offline = currently_offline(gctx, placement, r)
        return dst_ok & (src_ok | offline)

    def dst_cost(self, gctx, placement, agg, r, dst):
        return self._counts(gctx, agg)[dst].to(torch.float32)

    def dst_prune_score(self, gctx, placement, agg):
        """Count headroom: receivers are the lowest-count brokers."""
        upper, _ = self._bounds(gctx, agg)
        head = (upper - self._counts(gctx, agg)).to(torch.float32)
        return torch.where(alive_mask(gctx), head, -torch.inf)

    def dst_cumulative_slack(self, gctx, placement, agg, cand_load, is_lead_cand):
        upper, _ = self._bounds(gctx, agg)
        w = self._count_weight(cand_load, is_lead_cand)
        return w, (upper - self._counts(gctx, agg)).to(torch.float32)

    def src_cumulative_slack(self, gctx, placement, agg, cand_load, is_lead_cand):
        _, lower = self._bounds(gctx, agg)
        w = self._count_weight(cand_load, is_lead_cand)
        return w, (self._counts(gctx, agg) - lower).to(torch.float32)

    def _count_weight(self, cand_load, is_lead_cand):
        return torch.ones(cand_load.shape[0], dtype=torch.float32,
                          device=cand_load.device)

    def pull_dst_mask(self, gctx, placement, agg):
        _, lower = self._bounds(gctx, agg)
        return (self._counts(gctx, agg) < lower) & alive_mask(gctx)

    def pull_dst_prune_score(self, gctx, placement, agg):
        """Largest count deficit first."""
        _, lower = self._bounds(gctx, agg)
        deficit = (lower - self._counts(gctx, agg)).to(torch.float32)
        return torch.where(alive_mask(gctx), deficit, -torch.inf)

    def pull_candidate_score(self, gctx, placement, agg):
        state = gctx.state
        c = self._counts(gctx, agg)
        hot = c > _alive_mean(c, alive_mask(gctx))
        prio = self.replica_priority(gctx, placement, agg)
        cand = (hot[placement.broker] & state.valid & ~currently_offline(gctx, placement)
                & ~gctx.replica_excluded)
        return torch.where(cand, prio, NEG_INF)

    def stats_metric(self, gctx, placement, agg):
        alive = alive_mask(gctx)
        c = self._counts(gctx, agg).to(torch.float32)
        n = torch.clamp(alive.sum(), min=1)
        mean = torch.where(alive, c, 0.0).sum() / n
        var = torch.where(alive, (c - mean) ** 2, 0.0).sum() / n
        return torch.sqrt(var)


class LeaderReplicaDistributionGoal(ReplicaDistributionGoal):
    """Even *leader* counts (LeaderReplicaDistributionGoal.java): leadership
    transfers first, leader-replica moves as fallback."""

    name = "LeaderReplicaDistributionGoal"
    uses_leadership_moves = True
    # Leader replicas pulled INTO under-count brokers (the reference's
    # rebalanceByMovingLeaderReplicasIn fallback).
    has_pull_phase = True
    # Count-band headroom keeps rounds narrower than the default tile, but
    # the under-fill pull needs reach.
    candidate_width_hint = 2048

    def leadership_cumulative_slack(self, gctx, placement, agg, f, old):
        upper, lower = self._bounds(gctx, agg)
        c = self._counts(gctx, agg).to(torch.float32)
        ones = torch.ones(f.shape, dtype=torch.float32, device=f.device)
        return ones, -ones, upper - c, c - lower, None

    def _count_weight(self, cand_load, is_lead_cand):
        # Only leader candidates move leader counts.
        return is_lead_cand.to(torch.float32)

    def _counts(self, gctx, agg):
        return agg.leader_counts

    def _threshold(self, gctx):
        return gctx.leader_replica_balance_threshold

    def candidate_score(self, gctx, placement, agg):
        # Only leader replicas on over-count brokers are move candidates.
        base = super().candidate_score(gctx, placement, agg)
        return torch.where(placement.is_leader, base, NEG_INF)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        """Follower moves don't change leader counts; leader moves do."""
        upper, lower = self._bounds(gctx, agg)
        c = self._counts(gctx, agg)
        is_lead = placement.is_leader[r]
        src = placement.broker[r]
        dst_ok = c[dst] + 1 <= upper
        src_ok = ((c[src] - 1 >= lower) | ~gctx.state.alive[src]
                  | currently_offline(gctx, placement, r))
        return ~is_lead | (dst_ok & src_ok)

    def leadership_candidate_score(self, gctx, placement, agg):
        """Promotions serve BOTH band ends: shed over-count brokers (promote
        their partitions' followers elsewhere) and fill under-count brokers
        (promote their own followers, demoting donors that stay above the
        lower band)."""
        state = gctx.state
        _, lower = self._bounds(gctx, agg)
        c = self._counts(gctx, agg)
        over = self._over_brokers(gctx, agg)
        under = self.pull_dst_mask(gctx, placement, agg)
        lead = current_leader_of(gctx, placement, state.partition)
        lb = placement.broker[torch.clamp(lead, min=0)]
        b = placement.broker
        base = ((lead >= 0) & ~placement.is_leader & state.valid
                & ~currently_offline(gctx, placement) & ~gctx.replica_excluded)
        cand_over = base & over[lb]
        cand_under = base & under[b] & (c[lb] - 1 >= lower)
        # Under-fill tier strictly above the over-shed tier (counts are
        # bounded by R, so the tiers stay disjoint and f32-exact), then
        # prefer promoting onto the emptiest brokers within each tier.
        rmax = float(state.num_replicas_padded)
        score = (under[b].to(torch.float32) * 2.0 * rmax
                 + (rmax - c[b].to(torch.float32)))
        return torch.where(cand_over | cand_under, score, NEG_INF)

    def pull_candidate_score(self, gctx, placement, agg):
        """Only LEADER replicas carry leader counts into an under broker."""
        base = super().pull_candidate_score(gctx, placement, agg)
        return torch.where(placement.is_leader, base, NEG_INF)

    def leadership_self_ok(self, gctx, placement, agg, f):
        upper, _ = self._bounds(gctx, agg)
        c = self._counts(gctx, agg)
        return c[placement.broker[f]] + 1 <= upper

    def accept_leadership_move(self, gctx, placement, agg, f):
        """Promotion adds one leader to f's broker — veto when that would
        reach or deepen an upper-bound violation."""
        upper, _ = self._bounds(gctx, agg)
        c = self._counts(gctx, agg)
        return c[placement.broker[f]] + 1 <= upper


class TopicReplicaDistributionGoal(Goal):
    """Even per-topic replica counts (TopicReplicaDistributionGoal.java)."""

    name = "TopicReplicaDistributionGoal"
    is_hard = False
    src_sensitive_accept = True
    multi_accept_safe = True
    needs_topic_group = True
    multi_leadership_safe = True    # promotions keep per-topic replica counts

    def _bounds(self, gctx, agg):
        """(upper i32[T], lower i32[T]) per-topic count bands."""
        alive = alive_mask(gctx)
        n = torch.clamp(alive.sum(), min=1)
        totals = torch.where(alive[None, :], agg.topic_counts, 0).sum(dim=1)  # [T]
        avg = totals / n
        t = gctx.topic_replica_balance_threshold
        gap = gctx.topic_replica_balance_min_gap
        upper = torch.maximum(torch.ceil(avg * t), torch.ceil(avg) + gap).to(torch.int32)
        lower = torch.clamp(torch.floor(avg * (2.0 - t)), min=0.0).to(torch.int32)
        return upper, lower

    def violated_brokers(self, gctx, placement, agg):
        upper, lower = self._bounds(gctx, agg)
        over = agg.topic_counts > upper[:, None]
        under = agg.topic_counts < lower[:, None]
        return (over | under).any(dim=0) & alive_mask(gctx)

    def candidate_score(self, gctx, placement, agg):
        state = gctx.state
        upper, _ = self._bounds(gctx, agg)
        c_rt = agg.topic_counts[state.topic, placement.broker]     # [R]
        over = (c_rt > upper[state.topic]) & alive_mask(gctx)[placement.broker]
        prio = c_rt.to(torch.float32)
        cand = over & state.valid & ~gctx.replica_excluded
        score = torch.where(cand, prio, NEG_INF)
        offline = currently_offline(gctx, placement)
        return torch.where(offline, prio + OFFLINE_BONUS, score)

    def self_ok(self, gctx, placement, agg, r, dst):
        return self.accept_replica_move(gctx, placement, agg, r, dst)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        upper, lower = self._bounds(gctx, agg)
        t = gctx.state.topic[r]
        src = placement.broker[r]
        dst_ok = agg.topic_counts[t, dst] + 1 <= upper[t]
        src_ok = ((agg.topic_counts[t, src] - 1 >= lower[t])
                  | ~gctx.state.alive[src] | currently_offline(gctx, placement, r))
        return dst_ok & src_ok

    def dst_cost(self, gctx, placement, agg, r, dst):
        t = gctx.state.topic[r]
        return agg.topic_counts[t, dst].to(torch.float32)

    def stats_metric(self, gctx, placement, agg):
        upper, lower = self._bounds(gctx, agg)
        over = torch.clamp(agg.topic_counts - upper[:, None], min=0)
        under = torch.clamp(lower[:, None] - agg.topic_counts, min=0)
        alive = alive_mask(gctx)
        return torch.where(alive[None, :], over + under, 0).sum().to(torch.float32)
