"""Load-distribution (soft) goals.

Reference: ``analyzer/goals/ResourceDistributionGoal.java:54-1016`` and its
four resource subclasses, ``PotentialNwOutGoal.java``,
``LeaderBytesInDistributionGoal.java``.

ResourceDistribution semantics (initGoalState :236-263): every alive broker's
utilization for the resource must sit inside ``[avg*(2-T), avg*T]`` where avg
is the cluster-wide alive utilization fraction scaled by broker capacity.
Mechanisms (rebalanceForBroker :349-405): move replicas out of hot brokers,
pull replicas into cold ones, swap replicas between them, and move
leadership for CPU/NW_OUT.  Each mechanism is a phase of the shared solver;
the acceptance veto (``accept_*``) is the same band predicate applied to
later goals' candidate actions.
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.context import (
    current_leader_of,
    currently_offline,
    hash01,
    replica_role_load,
)
from cruise_control_tpu_torch.analyzer.goals.base import (
    Goal,
    NEG_INF,
    OFFLINE_BONUS,
    all_true,
    alive_mask,
    avg_alive_util_fraction,
)
from cruise_control_tpu_torch.common.resources import Resource


def _replicas(gctx):
    return torch.arange(gctx.state.num_replicas_padded, device=gctx.state.device)


def _brokers(gctx):
    return torch.arange(gctx.state.num_brokers_padded, device=gctx.state.device)


class ResourceDistributionGoal(Goal):
    """Keep one resource's per-broker utilization inside the balance band."""

    is_hard = False
    has_pull_phase = True
    has_swap_phase = True
    src_sensitive_accept = True
    multi_accept_safe = True
    multi_swap_safe = True
    multi_leadership_safe = True
    # Band headroom keeps per-round acceptance far below the structural
    # goals' tile width.
    candidate_width_hint = 1024
    # One scalar channel per broker (the resource's load) against one
    # target (the alive average utilization times capacity): the shape the
    # relaxation path lowers (analyzer/relax.py).
    relax_eligible = True
    resource: int = Resource.DISK

    def __init__(self, resource: int, name: str):
        self.resource = int(resource)
        self.name = name
        # Leadership shifts load only for CPU/NW_OUT (follower NW_IN ≈ leader NW_IN).
        self.uses_leadership_moves = resource in (Resource.CPU, Resource.NW_OUT)

    # ----------------------------------------------------------- band maths

    def _bounds(self, gctx, agg):
        """(upper f32[B], lower f32[B], lower_active bool): absolute load bounds."""
        res = self.resource
        avg = avg_alive_util_fraction(gctx, agg, res)
        t = gctx.balance_threshold[res]
        cap = gctx.state.capacity[:, res]
        upper = avg * t * cap
        lower = avg * (2.0 - t) * cap
        # Low-utilization guard: when the cluster barely uses this resource,
        # only the upper bound matters (reference: low.utilization.threshold).
        lower_active = avg >= gctx.low_utilization_threshold[res]
        return upper, lower, lower_active

    def violated_brokers(self, gctx, placement, agg):
        upper, lower, lower_active = self._bounds(gctx, agg)
        load = agg.broker_load[:, self.resource]
        over = load > upper
        under = (load < lower) & lower_active
        return (over | under) & alive_mask(gctx)

    def _over_brokers(self, gctx, agg):
        upper, _, _ = self._bounds(gctx, agg)
        return (agg.broker_load[:, self.resource] > upper) & alive_mask(gctx)

    # ------------------------------------------------------- move-out phase

    def candidate_score(self, gctx, placement, agg):
        """Heaviest replicas on over-band brokers first."""
        state = gctx.state
        over = self._over_brokers(gctx, agg)
        prio = self.replica_priority(gctx, placement, agg)
        cand = over[placement.broker] & state.valid & ~gctx.replica_excluded
        score = torch.where(cand, prio, NEG_INF)
        offline = currently_offline(gctx, placement)
        return torch.where(offline, prio + OFFLINE_BONUS, score)

    def replica_priority(self, gctx, placement, agg):
        load = torch.where(placement.is_leader[:, None],
                           gctx.state.leader_load, gctx.state.follower_load)
        return load[:, self.resource]

    def self_ok(self, gctx, placement, agg, r, dst):
        """Move keeps dst inside the band and does not drain the source below
        its lower bound (an offline replica only needs the first)."""
        res = self.resource
        upper, lower, lower_active = self._bounds(gctx, agg)
        load = replica_role_load(gctx, placement, r)[..., res]
        src = placement.broker[r]
        src_after = agg.broker_load[src, res] - load
        dst_after = agg.broker_load[dst, res] + load
        dst_ok = dst_after <= upper[dst]
        src_ok = torch.where(lower_active, src_after >= lower[src], True)
        offline = currently_offline(gctx, placement, r)
        return torch.where(offline, dst_ok, dst_ok & src_ok)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        """actionAcceptance (:803-871): later goals may not push dst over the
        upper bound nor drain src below the lower bound."""
        res = self.resource
        upper, lower, lower_active = self._bounds(gctx, agg)
        load = replica_role_load(gctx, placement, r)[..., res]
        src = placement.broker[r]
        src_after = agg.broker_load[src, res] - load
        dst_after = agg.broker_load[dst, res] + load
        dst_before = agg.broker_load[dst, res]
        # If dst was already over, only reject when the move makes it worse.
        dst_ok = (dst_after <= upper[dst]) | ((dst_before > upper[dst]) & (load <= 0))
        src_ok = torch.where(lower_active, (src_after >= lower[src]) | (load <= 0), True)
        return dst_ok & src_ok

    def dst_cost(self, gctx, placement, agg, r, dst):
        res = self.resource
        load = replica_role_load(gctx, placement, r)[..., res]
        after = agg.broker_load[dst, res] + load
        return after / torch.clamp(gctx.state.capacity[dst, res], min=1e-9)

    def dst_prune_score(self, gctx, placement, agg):
        """Band headroom: a round only ever fills the emptiest receivers."""
        upper, _, _ = self._bounds(gctx, agg)
        head = upper - agg.broker_load[:, self.resource]
        return torch.where(alive_mask(gctx), head, -torch.inf)

    def dst_prune_score_vs(self, gctx, placement, agg, priors):
        """Priors-aware receiver ranking: a receiver's worst normalized
        headroom across the bands in play (this goal's and each prior
        ResourceDistributionGoal's), with this resource as a tiebreak.  The
        emptiest receivers for this resource often sit ON a prior's upper
        band, and that prior would veto every arrival there."""
        resources = sorted({self.resource} | {
            g.resource for g in priors if isinstance(g, ResourceDistributionGoal)})
        if len(resources) == 1:
            return self.dst_prune_score(gctx, placement, agg)
        # Columns taken one by one: an index tensor made from the list
        # would be a copy to the device, which a CUDA graph cannot capture.
        alive = alive_mask(gctx)[:, None]
        cap_k = torch.stack([gctx.state.capacity[:, r] for r in resources], dim=1)
        caps = torch.clamp(cap_k, min=1e-9)                          # [B,K]
        load = torch.stack([agg.broker_load[:, r] for r in resources], dim=1)  # [B,K]
        total = torch.where(alive, load, 0.0).sum(dim=0)             # [K]
        cap_tot = torch.where(alive, cap_k, 0.0).sum(dim=0)
        avg = total / torch.clamp(cap_tot, min=1e-9)                 # [K]
        band = torch.stack([gctx.balance_threshold[r] for r in resources])
        upper = avg * band * caps                                    # [B,K]
        head_frac = (upper - load) / caps                            # [B,K]
        own = head_frac[:, resources.index(self.resource)]
        score = head_frac.amin(dim=-1) + 1e-3 * own
        return torch.where(alive_mask(gctx), score, -torch.inf)

    def relax_weights(self, gctx, placement):
        load = torch.where(placement.is_leader[:, None],
                           gctx.state.leader_load, gctx.state.follower_load)
        return load[:, self.resource]

    def relax_channel(self, gctx, agg):
        res = self.resource
        avg = avg_alive_util_fraction(gctx, agg, res)
        cap = gctx.state.capacity[:, res]
        return agg.broker_load[:, res], avg * cap, torch.clamp(cap, min=1e-9)

    def dst_cumulative_slack(self, gctx, placement, agg, cand_load, is_lead_cand):
        upper, _, _ = self._bounds(gctx, agg)
        return cand_load[:, self.resource], upper - agg.broker_load[:, self.resource]

    def src_cumulative_slack(self, gctx, placement, agg, cand_load, is_lead_cand):
        _, lower, lower_active = self._bounds(gctx, agg)
        load = agg.broker_load[:, self.resource]
        slack = torch.where(lower_active, load - lower, torch.inf)
        return cand_load[:, self.resource], slack

    # ------------------------------------------------------------ swap phase
    # ResourceDistributionGoal.java:543-725: when no broker has one-way
    # headroom, exchange a heavy replica on an above-average broker with a
    # lighter one on a below-average broker — only the load DELTA moves.

    def _swap_base_mask(self, gctx, placement):
        state = gctx.state
        return (state.valid & ~gctx.replica_excluded
                & ~currently_offline(gctx, placement))

    def swap_out_score(self, gctx, placement, agg, salt):
        """Shedding-side tile: replicas on above-average brokers.  Each
        replica draws height[broker] * U(0.25, 1) (reseeded per round), so a
        broker's expected tile share grows with how far above average it
        sits without the worst broker taking the whole tile; a mild
        heaviness tilt keeps the deltas meaningful."""
        res = self.resource
        avg = avg_alive_util_fraction(gctx, agg, res)
        cap = torch.clamp(gctx.state.capacity[:, res], min=1e-9)
        load = agg.broker_load[:, res]
        hot = (load > avg * cap) & alive_mask(gctx)
        height = torch.clamp(load / cap - avg, min=0.0)
        prio = self.replica_priority(gctx, placement, agg)
        b = placement.broker
        cand = hot[b] & self._swap_base_mask(gctx, placement)
        u = 0.25 + 0.75 * hash01(_replicas(gctx) + salt * 7919, 1.0)
        tilt = 1.0 + prio / torch.clamp(prio.max(), min=1e-9)
        return torch.where(cand, height[b] * u * tilt, NEG_INF)

    def swap_in_score(self, gctx, placement, agg, salt):
        """Receiving-side tile: replicas on below-average brokers, each
        broker's share proportional to how far below average it sits (the
        same randomized interleave as :meth:`swap_out_score`)."""
        res = self.resource
        avg = avg_alive_util_fraction(gctx, agg, res)
        cap = torch.clamp(gctx.state.capacity[:, res], min=1e-9)
        load = agg.broker_load[:, res]
        cold = (load < avg * cap) & alive_mask(gctx)
        depth = torch.clamp(avg - load / cap, min=0.0)
        b = placement.broker
        cand = cold[b] & self._swap_base_mask(gctx, placement)
        u = 0.25 + 0.75 * hash01(_replicas(gctx) + salt * 7919, 1.0)
        return torch.where(cand, depth[b] * u, NEG_INF)

    def _swap_after(self, gctx, placement, agg, r_out, r_in):
        """(delta, b_out, b_in, load-after both sides) for the pair tile."""
        res = self.resource
        lo = replica_role_load(gctx, placement, r_out)[..., res]
        li = replica_role_load(gctx, placement, r_in)[..., res]
        delta = lo - li
        b_out = placement.broker[r_out]
        b_in = placement.broker[r_in]
        out_after = agg.broker_load[b_out, res] - delta
        in_after = agg.broker_load[b_in, res] + delta
        return delta, b_out, b_in, out_after, in_after

    def swap_ok(self, gctx, placement, agg, r_out, r_in):
        res = self.resource
        upper, lower, lower_active = self._bounds(gctx, agg)
        delta, b_out, b_in, out_after, in_after = self._swap_after(
            gctx, placement, agg, r_out, r_in)
        over_out = agg.broker_load[b_out, res] > upper[b_out]
        under_in = (agg.broker_load[b_in, res] < lower[b_in]) & lower_active
        ok = (delta > 0) & (over_out | under_in)
        ok = ok & (in_after <= upper[b_in])
        return ok & torch.where(lower_active, out_after >= lower[b_out], True)

    def swap_cost(self, gctx, placement, agg, r_out, r_in):
        """Residual capacity-normalized deviation of both ends from the mean."""
        res = self.resource
        avg = avg_alive_util_fraction(gctx, agg, res)
        _, b_out, b_in, out_after, in_after = self._swap_after(
            gctx, placement, agg, r_out, r_in)
        cap_out = torch.clamp(gctx.state.capacity[b_out, res], min=1e-9)
        cap_in = torch.clamp(gctx.state.capacity[b_in, res], min=1e-9)
        return (out_after / cap_out - avg).abs() + (in_after / cap_in - avg).abs()

    def swap_cumulative_slack(self, gctx, placement, agg, d_load, d_pot, d_lbi, d_lead):
        res = self.resource
        upper, lower, lower_active = self._bounds(gctx, agg)
        load = agg.broker_load[:, res]
        low_slack = torch.where(lower_active, load - lower, torch.inf)
        return d_load[:, res], upper - load, low_slack

    def accept_swap(self, gctx, placement, agg, r_out, r_in, b_out, b_in):
        """Exact pairwise band check: neither end may leave the band in the
        wrong direction once the DELTA (not the full replica load) moves."""
        upper, lower, lower_active = self._bounds(gctx, agg)
        delta, _, _, out_after, in_after = self._swap_after(
            gctx, placement, agg, r_out, r_in)
        in_ok = (in_after <= upper[b_in]) | (delta <= 0)
        out_ok = torch.where(lower_active,
                             (out_after >= lower[b_out]) | (delta <= 0), True)
        # delta < 0 mirrors: load flows b_in -> b_out.
        out_ok2 = (out_after <= upper[b_out]) | (delta >= 0)
        in_ok2 = torch.where(lower_active,
                             (in_after >= lower[b_in]) | (delta >= 0), True)
        return in_ok & out_ok & out_ok2 & in_ok2

    # ------------------------------------------------------ leadership phase

    def leadership_cumulative_slack(self, gctx, placement, agg, f, old):
        """Positive deltas are held to the upper band (the pairwise check's
        only bound); DISK is leadership-neutral."""
        res = self.resource
        if not self.uses_leadership_moves and res != Resource.NW_IN:
            return None
        state = gctx.state
        dg = state.leader_load[f, res] - state.follower_load[f, res]
        dl = state.follower_load[old, res] - state.leader_load[old, res]
        upper, _, _ = self._bounds(gctx, agg)
        return dg, dl, upper - agg.broker_load[:, res], None, None

    def leadership_candidate_score(self, gctx, placement, agg):
        """Followers whose leader sits on an over-band broker."""
        res = self.resource
        state = gctx.state
        over = self._over_brokers(gctx, agg)
        lead = current_leader_of(gctx, placement, state.partition)
        lb = placement.broker[torch.clamp(lead, min=0)]
        gain = state.leader_load[:, res] - state.follower_load[:, res]
        cand = ((lead >= 0) & over[lb] & ~placement.is_leader & state.valid
                & ~currently_offline(gctx, placement) & ~gctx.replica_excluded
                & (gain > 0))
        return torch.where(cand, gain, NEG_INF)

    def leadership_self_ok(self, gctx, placement, agg, f):
        res = self.resource
        upper, _, _ = self._bounds(gctx, agg)
        delta = gctx.state.leader_load[f, res] - gctx.state.follower_load[f, res]
        b = placement.broker[f]
        return agg.broker_load[b, res] + delta <= upper[b]

    def accept_leadership_move(self, gctx, placement, agg, f):
        res = self.resource
        if not self.uses_leadership_moves and res != Resource.NW_IN:
            return all_true(f)      # DISK unaffected by leadership
        upper, _, _ = self._bounds(gctx, agg)
        delta = gctx.state.leader_load[f, res] - gctx.state.follower_load[f, res]
        b = placement.broker[f]
        return (agg.broker_load[b, res] + delta <= upper[b]) | (delta <= 0)

    # ------------------------------------------------------------ pull phase

    def pull_dst_mask(self, gctx, placement, agg):
        _, lower, lower_active = self._bounds(gctx, agg)
        under = (agg.broker_load[:, self.resource] < lower) & alive_mask(gctx)
        return under & lower_active

    def pull_dst_prune_score(self, gctx, placement, agg):
        """Neediest under-band brokers first (deficit to the lower bound)."""
        _, lower, lower_active = self._bounds(gctx, agg)
        deficit = lower - agg.broker_load[:, self.resource]
        return torch.where(alive_mask(gctx) & lower_active, deficit, -torch.inf)

    def pull_candidate_score(self, gctx, placement, agg):
        """Pull from brokers above cluster-average utilization."""
        res = self.resource
        state = gctx.state
        avg = avg_alive_util_fraction(gctx, agg, res)
        src_hot = agg.broker_load[:, res] > avg * state.capacity[:, res]
        prio = self.replica_priority(gctx, placement, agg)
        cand = (src_hot[placement.broker] & state.valid
                & ~currently_offline(gctx, placement) & ~gctx.replica_excluded)
        return torch.where(cand, prio, NEG_INF)

    # -------------------------------------------------------------- metrics

    def stats_metric(self, gctx, placement, agg):
        """Utilization-fraction stdev over alive brokers (the comparator at
        ResourceDistributionGoal.java:977-1008 compares stdev)."""
        res = self.resource
        alive = alive_mask(gctx)
        frac = agg.broker_load[:, res] / torch.clamp(gctx.state.capacity[:, res], min=1e-9)
        n = torch.clamp(alive.sum(), min=1)
        mean = torch.where(alive, frac, 0.0).sum() / n
        var = torch.where(alive, (frac - mean) ** 2, 0.0).sum() / n
        return torch.sqrt(var)


class CpuUsageDistributionGoal(ResourceDistributionGoal):
    def __init__(self):
        super().__init__(Resource.CPU, "CpuUsageDistributionGoal")


class NetworkInboundUsageDistributionGoal(ResourceDistributionGoal):
    def __init__(self):
        super().__init__(Resource.NW_IN, "NetworkInboundUsageDistributionGoal")


class NetworkOutboundUsageDistributionGoal(ResourceDistributionGoal):
    def __init__(self):
        super().__init__(Resource.NW_OUT, "NetworkOutboundUsageDistributionGoal")


class DiskUsageDistributionGoal(ResourceDistributionGoal):
    """Broker-level disk balance (DiskUsageDistributionGoal.java)."""

    def __init__(self):
        super().__init__(Resource.DISK, "DiskUsageDistributionGoal")


class PotentialNwOutGoal(Goal):
    """Cap *potential* network-out — NW_OUT if the broker led everything it
    hosts — under the hard NW_OUT capacity (PotentialNwOutGoal.java)."""

    name = "PotentialNwOutGoal"
    is_hard = False
    multi_accept_safe = True
    multi_swap_safe = True
    multi_leadership_safe = True   # potential NW-out counts every replica as-if-leader

    def _limit(self, gctx, b):
        return (gctx.capacity_threshold[Resource.NW_OUT]
                * gctx.state.capacity[b, Resource.NW_OUT])

    def violated_brokers(self, gctx, placement, agg):
        return (agg.potential_nw_out > self._limit(gctx, _brokers(gctx))) & alive_mask(gctx)

    def replica_priority(self, gctx, placement, agg):
        return gctx.state.leader_load[:, Resource.NW_OUT]

    def self_ok(self, gctx, placement, agg, r, dst):
        return self.accept_replica_move(gctx, placement, agg, r, dst)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        """Reject only when dst becomes newly violated (or a violated dst
        would gain potential)."""
        pot = gctx.state.leader_load[r, Resource.NW_OUT]
        after = agg.potential_nw_out[dst] + pot
        was_over = agg.potential_nw_out[dst] > self._limit(gctx, dst)
        return (after <= self._limit(gctx, dst)) | was_over & (pot <= 0)

    def dst_cost(self, gctx, placement, agg, r, dst):
        pot = gctx.state.leader_load[r, Resource.NW_OUT]
        return (agg.potential_nw_out[dst] + pot) / torch.clamp(
            gctx.state.capacity[dst, Resource.NW_OUT], min=1e-9)

    def dst_cumulative_slack(self, gctx, placement, agg, cand_load, is_lead_cand):
        # Marker weight: the solver substitutes the candidates' potential
        # (leader-role NW_OUT regardless of current role).
        return ("potential_nw_out",
                self._limit(gctx, _brokers(gctx)) - agg.potential_nw_out)

    def swap_cumulative_slack(self, gctx, placement, agg, d_load, d_pot, d_lbi, d_lead):
        return d_pot, self._limit(gctx, _brokers(gctx)) - agg.potential_nw_out, None

    def accept_swap(self, gctx, placement, agg, r_out, r_in, b_out, b_in):
        """Only the potential-NW-out DELTA lands on each end."""
        d = (gctx.state.leader_load[r_out, Resource.NW_OUT]
             - gctx.state.leader_load[r_in, Resource.NW_OUT])
        in_ok = (agg.potential_nw_out[b_in] + d <= self._limit(gctx, b_in)) | (d <= 0)
        out_ok = (agg.potential_nw_out[b_out] - d <= self._limit(gctx, b_out)) | (d >= 0)
        return in_ok & out_ok

    def stats_metric(self, gctx, placement, agg):
        excess = torch.clamp(agg.potential_nw_out - self._limit(gctx, _brokers(gctx)),
                             min=0.0)
        return torch.where(alive_mask(gctx), excess, 0.0).sum()


class LeaderBytesInDistributionGoal(Goal):
    """Even out leader bytes-in across brokers
    (LeaderBytesInDistributionGoal.java — balances only above the mean)."""

    name = "LeaderBytesInDistributionGoal"
    is_hard = False
    uses_replica_moves = False
    uses_leadership_moves = True
    multi_accept_safe = True
    multi_swap_safe = True
    multi_leadership_safe = True

    def _limit(self, gctx, agg):
        alive = alive_mask(gctx)
        n = torch.clamp(alive.sum(), min=1)
        avg = torch.where(alive, agg.leader_bytes_in, 0.0).sum() / n
        return avg * gctx.balance_threshold[Resource.NW_IN]

    def violated_brokers(self, gctx, placement, agg):
        return (agg.leader_bytes_in > self._limit(gctx, agg)) & alive_mask(gctx)

    def leadership_candidate_score(self, gctx, placement, agg):
        state = gctx.state
        over = self.violated_brokers(gctx, placement, agg)
        lead = current_leader_of(gctx, placement, state.partition)
        lb = placement.broker[torch.clamp(lead, min=0)]
        cand = ((lead >= 0) & over[lb] & ~placement.is_leader & state.valid
                & ~currently_offline(gctx, placement) & ~gctx.replica_excluded)
        return torch.where(cand, state.leader_load[:, Resource.NW_IN], NEG_INF)

    def leadership_self_ok(self, gctx, placement, agg, f):
        after = (agg.leader_bytes_in[placement.broker[f]]
                 + gctx.state.leader_load[f, Resource.NW_IN])
        return after <= self._limit(gctx, agg)

    def accept_leadership_move(self, gctx, placement, agg, f):
        limit = self._limit(gctx, agg)
        b = placement.broker[f]
        nw_in = gctx.state.leader_load[f, Resource.NW_IN]
        after = agg.leader_bytes_in[b] + nw_in
        was_over = agg.leader_bytes_in[b] > limit
        return (after <= limit) | was_over & (nw_in <= 0)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        """Leader replica moves carry their bytes-in to dst."""
        nw_in = torch.where(placement.is_leader[r],
                            gctx.state.leader_load[r, Resource.NW_IN], 0.0)
        limit = self._limit(gctx, agg)
        after = agg.leader_bytes_in[dst] + nw_in
        was_over = agg.leader_bytes_in[dst] > limit
        return (after <= limit) | was_over & (nw_in <= 0)

    def dst_cumulative_slack(self, gctx, placement, agg, cand_load, is_lead_cand):
        # Marker weight: the solver substitutes the leader bytes-in that
        # LEADER candidates carry.
        return ("leader_nw_in", self._limit(gctx, agg) - agg.leader_bytes_in)

    def swap_cumulative_slack(self, gctx, placement, agg, d_load, d_pot, d_lbi, d_lead):
        return d_lbi, self._limit(gctx, agg) - agg.leader_bytes_in, None

    def leadership_cumulative_slack(self, gctx, placement, agg, f, old):
        nw = gctx.state.leader_load[:, Resource.NW_IN]
        return (nw[f], -nw[old],
                self._limit(gctx, agg) - agg.leader_bytes_in, None, None)

    def accept_swap(self, gctx, placement, agg, r_out, r_in, b_out, b_in):
        """Only the leader-bytes-in DELTA lands on each end."""
        nw_in = gctx.state.leader_load[:, Resource.NW_IN]
        lbi_out = torch.where(placement.is_leader[r_out], nw_in[r_out], 0.0)
        lbi_in = torch.where(placement.is_leader[r_in], nw_in[r_in], 0.0)
        d = lbi_out - lbi_in
        limit = self._limit(gctx, agg)
        in_ok = (agg.leader_bytes_in[b_in] + d <= limit) | (d <= 0)
        out_ok = (agg.leader_bytes_in[b_out] - d <= limit) | (d >= 0)
        return in_ok & out_ok

    def stats_metric(self, gctx, placement, agg):
        excess = torch.clamp(agg.leader_bytes_in - self._limit(gctx, agg), min=0.0)
        return torch.where(alive_mask(gctx), excess, 0.0).sum()
