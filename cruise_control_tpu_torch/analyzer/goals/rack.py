"""Rack-awareness goals.

Reference: ``analyzer/goals/RackAwareGoal.java:31-221`` (strict: no two
replicas of a partition on one rack), ``RackAwareDistributionGoal.java``
(relaxed: replicas spread as evenly as possible), base
``AbstractRackAwareGoal.java``.

All checks reduce to RF-wide gathers over ``partition_replicas``: a replica's
sibling racks are ``rack[broker[sibs]]`` — never a P×B or P×K matrix.
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.context import GoalContext, currently_offline
from cruise_control_tpu_torch.analyzer.goals.base import Goal, alive_mask
from cruise_control_tpu_torch.model.state import Placement


def _sibling_info(gctx: GoalContext, placement: Placement, r):
    """(is_sib bool[...,RF], sib_rack i32[...,RF]) for replica r's partition."""
    sibs = gctx.partition_replicas[gctx.state.partition[r]]
    is_sib = (sibs >= 0) & (sibs != r[..., None])
    sib_rack = gctx.state.rack[placement.broker[torch.clamp(sibs, min=0)]]
    return is_sib, sib_rack


def _all_replicas(gctx: GoalContext) -> torch.Tensor:
    return torch.arange(gctx.state.num_replicas_padded, device=gctx.state.device)


def _per_broker_any(gctx: GoalContext, placement: Placement,
                    viol: torch.Tensor) -> torch.Tensor:
    """bool[B]: some replica on the broker has ``viol`` set."""
    b = gctx.state.num_brokers_padded
    out = torch.zeros(b, dtype=torch.int32, device=viol.device)
    return out.scatter_reduce(0, placement.broker.long(), viol.to(torch.int32),
                              "amax") > 0


def replicas_violating_rack(gctx: GoalContext, placement: Placement) -> torch.Tensor:
    """bool[R]: replica shares its rack with a sibling (strict violation)."""
    r = _all_replicas(gctx)
    is_sib, sib_rack = _sibling_info(gctx, placement, r)
    own = gctx.state.rack[placement.broker][:, None]
    return (is_sib & (sib_rack == own)).any(dim=-1) & gctx.state.valid


def num_alive_racks(gctx: GoalContext) -> torch.Tensor:
    alive = alive_mask(gctx)
    present = torch.zeros(gctx.num_racks, dtype=torch.int32,
                          device=alive.device).scatter_reduce(
        0, gctx.state.rack.long(), alive.to(torch.int32), "amax")
    return torch.clamp(present.sum(), min=1)


def _emptiest_broker_score(gctx, agg):
    """Shared rack-goal dst prune score: emptiest alive brokers first."""
    frac = agg.broker_load / torch.clamp(gctx.state.capacity, min=1e-9)
    return torch.where(alive_mask(gctx), -frac.sum(dim=-1), -torch.inf)


class RackAwareGoal(Goal):
    """Strict rack-awareness (hard)."""

    name = "RackAwareGoal"
    is_hard = True
    multi_accept_safe = True
    multi_swap_safe = True         # partition-unique swaps cannot interact rack-wise
    multi_leadership_safe = True   # leadership never changes rack placement
    dst_slack_exempt = True        # acceptance reads sibling placement, not dst aggregates
    # Wide candidate tile; affordable because the destination axis is pruned
    # to max_dst_candidates, and rack feasibility survives the pruning
    # because the dst tile is rack-stratified (solver _stratified_top_dst).
    candidate_width_hint = 8192

    def dst_prune_score(self, gctx, placement, agg):
        return _emptiest_broker_score(gctx, agg)

    def violated_brokers(self, gctx, placement, agg):
        return _per_broker_any(gctx, placement, replicas_violating_rack(gctx, placement))

    def candidate_score(self, gctx, placement, agg):
        # Only the violating replicas themselves move (not whole brokers).
        viol = replicas_violating_rack(gctx, placement)
        prio = self.replica_priority(gctx, placement, agg)
        score = torch.where(viol & ~gctx.replica_excluded, prio, -torch.inf)
        offline = currently_offline(gctx, placement)
        return torch.where(offline, prio + 1e30, score)

    def self_ok(self, gctx, placement, agg, r, dst):
        return self.accept_replica_move(gctx, placement, agg, r, dst)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        """Destination rack must hold no sibling replica."""
        is_sib, sib_rack = _sibling_info(gctx, placement, r)
        dst_rack = gctx.state.rack[dst]
        return ~(is_sib & (sib_rack == dst_rack[..., None])).any(dim=-1)

    def stats_metric(self, gctx, placement, agg):
        return replicas_violating_rack(gctx, placement).to(torch.float32).sum()


class RackAwareDistributionGoal(Goal):
    """Relaxed rack-awareness (hard): every rack holds at most
    ceil(RF / alive_racks) replicas of a partition."""

    name = "RackAwareDistributionGoal"
    is_hard = True
    multi_accept_safe = True
    multi_swap_safe = True         # partition-unique swaps cannot interact rack-wise
    multi_leadership_safe = True   # leadership never changes rack placement
    dst_slack_exempt = True        # acceptance reads sibling placement, not dst aggregates
    candidate_width_hint = 8192    # same trade as RackAwareGoal

    def dst_prune_score(self, gctx, placement, agg):
        return _emptiest_broker_score(gctx, agg)

    def _rack_cap(self, gctx, r):
        """i32[...]: max allowed replicas of r's partition per rack."""
        sibs = gctx.partition_replicas[gctx.state.partition[r]]
        rf = (sibs >= 0).sum(dim=-1)
        k = num_alive_racks(gctx)
        return -(-rf // k)  # ceil division

    def _own_rack_count(self, gctx, placement, r):
        """i32[...]: replicas of r's partition currently on r's rack (incl. r)."""
        is_sib, sib_rack = _sibling_info(gctx, placement, r)
        own = gctx.state.rack[placement.broker[r]]
        return 1 + (is_sib & (sib_rack == own[..., None])).sum(dim=-1)

    def violated_replicas(self, gctx, placement):
        r = _all_replicas(gctx)
        over = self._own_rack_count(gctx, placement, r) > self._rack_cap(gctx, r)
        return over & gctx.state.valid

    def violated_brokers(self, gctx, placement, agg):
        return _per_broker_any(gctx, placement, self.violated_replicas(gctx, placement))

    def candidate_score(self, gctx, placement, agg):
        viol = self.violated_replicas(gctx, placement)
        prio = self.replica_priority(gctx, placement, agg)
        score = torch.where(viol & ~gctx.replica_excluded, prio, -torch.inf)
        offline = currently_offline(gctx, placement)
        return torch.where(offline, prio + 1e30, score)

    def self_ok(self, gctx, placement, agg, r, dst):
        return self.accept_replica_move(gctx, placement, agg, r, dst)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        """After the move, the destination rack stays within the pigeonhole cap."""
        is_sib, sib_rack = _sibling_info(gctx, placement, r)
        dst_rack = gctx.state.rack[dst]
        dst_count = (is_sib & (sib_rack == dst_rack[..., None])).sum(dim=-1)
        return dst_count + 1 <= self._rack_cap(gctx, r)

    def stats_metric(self, gctx, placement, agg):
        return self.violated_replicas(gctx, placement).to(torch.float32).sum()
