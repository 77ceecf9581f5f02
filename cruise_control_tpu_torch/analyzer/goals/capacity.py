"""Hard capacity goals.

Reference: ``analyzer/goals/CapacityGoal.java:40-466`` (+ the four resource
subclasses) and ``ReplicaCapacityGoal.java``.

A broker (and, for host-scoped resources, its host) must stay under
``capacity_threshold[res] * capacity``: violation = load over limit;
self_ok = destination stays under limit after the move; acceptance = the
same predicate applied to later goals' actions.
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.context import GoalContext, replica_role_load
from cruise_control_tpu_torch.analyzer.goals.base import Goal, all_true, alive_mask
from cruise_control_tpu_torch.common.resources import IS_HOST_RESOURCE, Resource


class CapacityGoal(Goal):
    """One resource's hard utilization cap (CapacityGoal.java:40-466)."""

    is_hard = True
    multi_accept_safe = True
    multi_leadership_safe = True
    resource: int = Resource.DISK

    def __init__(self, resource: int, name: str):
        self.resource = int(resource)
        self.name = name

    def _limit(self, gctx: GoalContext, b):
        return gctx.capacity_threshold[self.resource] * gctx.state.capacity[b, self.resource]

    def _host_limit(self, gctx: GoalContext, h):
        return gctx.capacity_threshold[self.resource] * gctx.host_capacity[h, self.resource]

    def violated_brokers(self, gctx, placement, agg):
        res = self.resource
        over = agg.broker_load[:, res] > (gctx.capacity_threshold[res]
                                          * gctx.state.capacity[:, res])
        if IS_HOST_RESOURCE[res]:
            host_over = agg.host_load[:, res] > (
                gctx.capacity_threshold[res] * gctx.host_capacity[:, res])
            over = over | host_over[gctx.state.host]
        return over & alive_mask(gctx)

    def replica_priority(self, gctx, placement, agg):
        load = torch.where(placement.is_leader[:, None],
                           gctx.state.leader_load, gctx.state.follower_load)
        return load[:, self.resource]

    def self_ok(self, gctx, placement, agg, r, dst):
        return self.accept_replica_move(gctx, placement, agg, r, dst)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        res = self.resource
        load = replica_role_load(gctx, placement, r)[..., res]
        b_ok = agg.broker_load[dst, res] + load <= self._limit(gctx, dst)
        if not IS_HOST_RESOURCE[res]:
            return b_ok
        h = gctx.state.host[dst]
        same_host = gctx.state.host[placement.broker[r]] == h
        h_after = agg.host_load[h, res] + load * (~same_host)
        return b_ok & (h_after <= self._host_limit(gctx, h))

    def accept_leadership_move(self, gctx, placement, agg, f):
        """Promotion shifts load onto f's broker for CPU/NW_OUT."""
        res = self.resource
        if res not in (Resource.CPU, Resource.NW_OUT):
            return all_true(f)
        delta = (gctx.state.leader_load[f, res] - gctx.state.follower_load[f, res])
        b = placement.broker[f]
        b_ok = agg.broker_load[b, res] + delta <= self._limit(gctx, b)
        h = gctx.state.host[b]
        h_ok = agg.host_load[h, res] + delta <= self._host_limit(gctx, h)
        return b_ok & h_ok

    def dst_cost(self, gctx, placement, agg, r, dst):
        res = self.resource
        load = replica_role_load(gctx, placement, r)[..., res]
        after = agg.broker_load[dst, res] + load
        return after / torch.clamp(gctx.state.capacity[dst, res], min=1e-9)

    def dst_cumulative_slack(self, gctx, placement, agg, cand_load, is_lead_cand):
        res = self.resource
        limit = gctx.capacity_threshold[res] * gctx.state.capacity[:, res]
        return cand_load[:, res], limit - agg.broker_load[:, res]

    def host_cumulative_slack(self, gctx, placement, agg, cand_load, is_lead_cand):
        res = self.resource
        if not IS_HOST_RESOURCE[res]:
            return None
        limit = gctx.capacity_threshold[res] * gctx.host_capacity[:, res]
        return cand_load[:, res], limit - agg.host_load[:, res]

    def leadership_cumulative_slack(self, gctx, placement, agg, f, old):
        res = self.resource
        if res not in (Resource.CPU, Resource.NW_OUT):
            return None
        state = gctx.state
        dg = state.leader_load[f, res] - state.follower_load[f, res]
        dl = state.follower_load[old, res] - state.leader_load[old, res]
        limit = gctx.capacity_threshold[res] * state.capacity[:, res]
        up_h = (gctx.capacity_threshold[res] * gctx.host_capacity[:, res]
                - agg.host_load[:, res]) if IS_HOST_RESOURCE[res] else None
        return dg, dl, limit - agg.broker_load[:, res], None, up_h

    def stats_metric(self, gctx, placement, agg):
        """Total over-limit load (lower better, 0 == satisfied)."""
        res = self.resource
        limit = gctx.capacity_threshold[res] * gctx.state.capacity[:, res]
        excess = torch.clamp(agg.broker_load[:, res] - limit, min=0.0)
        return torch.where(alive_mask(gctx), excess, 0.0).sum()


class CpuCapacityGoal(CapacityGoal):
    def __init__(self):
        super().__init__(Resource.CPU, "CpuCapacityGoal")


class NetworkInboundCapacityGoal(CapacityGoal):
    def __init__(self):
        super().__init__(Resource.NW_IN, "NetworkInboundCapacityGoal")


class NetworkOutboundCapacityGoal(CapacityGoal):
    def __init__(self):
        super().__init__(Resource.NW_OUT, "NetworkOutboundCapacityGoal")


class DiskCapacityGoal(CapacityGoal):
    def __init__(self):
        super().__init__(Resource.DISK, "DiskCapacityGoal")


class ReplicaCapacityGoal(Goal):
    """Max replicas per broker (ReplicaCapacityGoal.java).

    Dead brokers are violated by definition (their replicas must vacate);
    alive brokers by count > ``max_replicas_per_broker``.
    """

    name = "ReplicaCapacityGoal"
    is_hard = True
    multi_accept_safe = True
    multi_leadership_safe = True    # promotions are replica-count-neutral

    def violated_brokers(self, gctx, placement, agg):
        alive = alive_mask(gctx)
        over = agg.replica_counts > gctx.max_replicas_per_broker
        dead_with_replicas = (~gctx.state.alive) & gctx.state.broker_valid & (
            agg.replica_counts > 0)
        return (over & alive) | dead_with_replicas

    def replica_priority(self, gctx, placement, agg):
        # Light replicas first: vacating over-count brokers moves minimal load.
        load = torch.where(placement.is_leader[:, None],
                           gctx.state.leader_load, gctx.state.follower_load)
        return -load.sum(dim=-1)

    def self_ok(self, gctx, placement, agg, r, dst):
        return self.accept_replica_move(gctx, placement, agg, r, dst)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        return agg.replica_counts[dst] + 1 <= gctx.max_replicas_per_broker

    def dst_cumulative_slack(self, gctx, placement, agg, cand_load, is_lead_cand):
        slack = (gctx.max_replicas_per_broker - agg.replica_counts).to(torch.float32)
        return torch.ones(cand_load.shape[0], dtype=torch.float32,
                          device=cand_load.device), slack

    def dst_cost(self, gctx, placement, agg, r, dst):
        return agg.replica_counts[dst].to(torch.float32)

    def stats_metric(self, gctx, placement, agg):
        over = torch.clamp(agg.replica_counts - gctx.max_replicas_per_broker, min=0)
        return torch.where(alive_mask(gctx), over, 0).sum().to(torch.float32)
