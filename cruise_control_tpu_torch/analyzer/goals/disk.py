"""Intra-broker disk balance (soft).

Reference: ``analyzer/goals/IntraBrokerDiskUsageDistributionGoal.java`` —
keep each JBOD broker's logdirs within a band around the broker's own mean
disk utilization, via intra-broker replica moves (``alterReplicaLogDirs`` at
execution time).
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.goals.base import Goal, NEG_INF
from cruise_control_tpu_torch.common.resources import Resource


class IntraBrokerDiskUsageDistributionGoal(Goal):
    name = "IntraBrokerDiskUsageDistributionGoal"
    is_hard = False
    uses_replica_moves = False
    intra_disk = True
    # Inter-broker swaps land on each side's emptiest logdir; the solver's
    # JBOD fill guard bounds multi-swap arrivals per logdir.
    multi_swap_safe = True
    multi_leadership_safe = True   # leadership does not move data between disks

    def _bands(self, gctx, agg):
        """(upper f32[B,D], lower f32[B,D]) absolute per-disk load bounds."""
        cap = gctx.state.disk_capacity
        alive = gctx.state.disk_alive
        total = torch.where(alive, agg.disk_load, 0.0).sum(dim=1, keepdim=True)
        tcap = torch.where(alive, cap, 0.0).sum(dim=1, keepdim=True)
        avg_frac = total / torch.clamp(tcap, min=1e-9)       # [B,1]
        t = gctx.balance_threshold[Resource.DISK]
        return avg_frac * t * cap, avg_frac * (2.0 - t) * cap

    def violated_disks(self, gctx, placement, agg):
        upper, lower = self._bands(gctx, agg)
        alive = gctx.state.disk_alive
        multi = alive.to(torch.int32).sum(dim=1, keepdim=True) > 1
        out = (agg.disk_load > upper) | (agg.disk_load < lower)
        return out & alive & multi

    def violated_brokers(self, gctx, placement, agg):
        return self.violated_disks(gctx, placement, agg).any(dim=-1)

    def disk_candidate_score(self, gctx, placement, agg):
        state = gctx.state
        upper, _ = self._bands(gctx, agg)
        over = (agg.disk_load > upper) & state.disk_alive
        on_over = over[placement.broker, placement.disk]
        dead = ~state.disk_alive[placement.broker, placement.disk]
        cand = (on_over | dead) & state.valid
        return torch.where(cand, state.leader_load[:, Resource.DISK], NEG_INF)

    def disk_move_ok(self, gctx, placement, agg, r, d):
        upper, lower = self._bands(gctx, agg)
        b = placement.broker[r]
        size = gctx.state.leader_load[r, Resource.DISK]
        src_d = placement.disk[r]
        dst_after = agg.disk_load[b, d] + size
        src_after = agg.disk_load[b, src_d] - size
        alive_d = gctx.state.disk_alive[b, d] & (d != src_d)
        ok = (dst_after <= upper[b, d]) & (src_after >= lower[b, src_d]) & alive_d
        dead_src = ~gctx.state.disk_alive[b, src_d]
        return torch.where(dead_src, alive_d, ok)

    def stats_metric(self, gctx, placement, agg):
        """Mean per-broker stdev of disk utilization fractions."""
        frac = agg.disk_load / torch.clamp(gctx.state.disk_capacity, min=1e-9)
        alive = gctx.state.disk_alive
        n = torch.clamp(alive.sum(dim=1), min=1)
        mean = torch.where(alive, frac, 0.0).sum(dim=1) / n
        var = torch.where(alive, (frac - mean[:, None]) ** 2, 0.0).sum(dim=1) / n
        return torch.sqrt(var).mean()
