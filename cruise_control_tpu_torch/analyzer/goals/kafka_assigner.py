"""kafka-assigner emulation goals.

Reference: ``analyzer/kafkaassigner/KafkaAssignerEvenRackAwareGoal.java``
(position-even rack-aware placement: for every replica position p, each
partition's position-p replica sits on the alive broker with the fewest
position-p replicas among brokers whose rack holds no lower-position replica
of that partition) and ``KafkaAssignerDiskUsageDistributionGoal.java``
(disk balance across brokers by SWAPPING replicas between broker pairs, so
replica counts never change).  The pair is selected when a request carries
``kafka_assigner=true`` (``RunnableUtils.java`` isKafkaAssignerMode).

The reference's per-position TreeSet of (count, broker) becomes per-position
count planes ``i32[RF, B]`` (one segment sum) with an even band
``[floor(total_p/alive), ceil(total_p/alive)]``; rack eligibility is the
RF-wide sibling gather restricted to LOWER positions.  The disk goal is the
generic swap phase with replica moves disabled.
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
from cruise_control_tpu_torch.analyzer.goals.distribution import ResourceDistributionGoal
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.ops import segment_sum

_CONFLICT_BONUS = 1e6


class KafkaAssignerEvenRackAwareGoal(Goal):
    """Position-even, rack-aware placement (kafka-assigner mode, hard)."""

    name = "KafkaAssignerEvenRackAwareGoal"
    is_hard = True
    src_sensitive_accept = True
    # Position swaps: transferring leadership from a leader-rich broker to a
    # follower on a leader-poor one swaps the pair's positions (the
    # reference's maybeApplyMove case 2 at position 0, :192-201).
    uses_leadership_moves = True

    # ------------------------------------------------------------- plumbing

    def _eff_pos(self, gctx, placement) -> torch.Tensor:
        """i32[R] effective replica position with the leader at 0 (the
        reference's STEP1 swaps the leader into list position 0, :115-120):
        the position-0 replica, if a follower, takes the leader's old slot."""
        state = gctx.state
        lead = current_leader_of(gctx, placement, state.partition)     # [R]
        lead_pos = torch.where(lead >= 0, state.pos[torch.clamp(lead, min=0)], 0)
        eff = torch.where(placement.is_leader, 0,
                          torch.where((state.pos == 0) & (lead >= 0),
                                      lead_pos, state.pos))
        return torch.clamp(eff, 0, gctx.max_rf - 1)

    def _pos_counts(self, gctx, placement, eff) -> torch.Tensor:
        """i32[RF, B] valid-replica count per (position, broker)."""
        b = gctx.state.num_brokers_padded
        flat = eff * b + placement.broker
        return segment_sum(gctx.state.valid.to(torch.int32), flat,
                           gctx.max_rf * b).reshape(gctx.max_rf, b)

    def _counts_and_bounds(self, gctx, placement):
        eff = self._eff_pos(gctx, placement)
        counts = self._pos_counts(gctx, placement, eff)
        upper, lower = self._bounds(gctx, counts)
        return eff, counts, upper, lower

    def _bounds(self, gctx, counts):
        """(upper i32[RF], lower i32[RF]) even band per position."""
        nb = torch.clamp(alive_mask(gctx).sum(), min=1)
        total = counts.sum(dim=1)
        return -(-total // nb), total // nb

    def _sibling_racks(self, gctx, placement, r):
        """(is_sib bool[..., RF], sib_rack i32[..., RF], sibs rows) of r."""
        state = gctx.state
        sibs = gctx.partition_replicas[state.partition[r]]
        safe = torch.clamp(sibs, min=0)
        is_sib = (sibs >= 0) & (sibs != r[..., None])
        return is_sib, state.rack[placement.broker[safe]], safe

    def _rack_conflict(self, gctx, placement, eff) -> torch.Tensor:
        """bool[R]: a LOWER-position sibling occupies this replica's rack."""
        state = gctx.state
        r = torch.arange(state.num_replicas_padded, device=state.device)
        is_sib, sib_rack, safe = self._sibling_racks(gctx, placement, r)
        own = state.rack[placement.broker][:, None]
        lower_pos = eff[safe] < eff[:, None]
        return (is_sib & lower_pos & (sib_rack == own)).any(dim=-1) & state.valid

    def _rack_eligible(self, gctx, placement, eff, r, dst):
        """bool: dst's rack holds no lower-position sibling of r (the
        reference's ineligibleRackIds check, :166-172)."""
        is_sib, sib_rack, safe = self._sibling_racks(gctx, placement, r)
        lower_pos = eff[safe] < eff[r][..., None]
        dst_rack = gctx.state.rack[dst]
        return ~(is_sib & lower_pos & (sib_rack == dst_rack[..., None])).any(dim=-1)

    def _rack_eligible_strict(self, gctx, placement, r, dst):
        """bool: dst's rack holds NO sibling of r.  The acceptance vetoes over
        LATER goals' actions use this: once this goal has finished,
        placements are rack-distinct, and a later move or swap must not
        co-locate racks regardless of position."""
        is_sib, sib_rack, _ = self._sibling_racks(gctx, placement, r)
        dst_rack = gctx.state.rack[dst]
        return ~(is_sib & (sib_rack == dst_rack[..., None])).any(dim=-1)

    # --------------------------------------------------------------- rounds

    def violated_brokers(self, gctx, placement, agg):
        """Rack conflicts, dead brokers holding replicas, and FIXABLE
        count-band overflow: a surplus replica that some rack-eligible
        under-ceiling broker could absorb.  (Position-evenness itself is the
        reference's greedy heuristic, not a hard bound: a rack with fewer
        brokers holds one replica of every partition.)"""
        state = gctx.state
        eff, counts, upper, _ = self._counts_and_bounds(gctx, placement)
        k = gctx.num_racks
        r_n = state.num_replicas_padded

        # under[p, k]: rack k has an alive broker below the position-p ceiling.
        can_take = alive_mask(gctx)[None, :] & (counts + 1 <= upper[:, None])  # [RF,B]
        under = segment_sum(can_take.to(torch.int32).T, state.rack, k).T > 0  # [RF,K]

        # blocked[r, k]: a LOWER-position sibling of r occupies rack k.
        r = torch.arange(r_n, device=state.device)
        is_sib, sib_rack, safe = self._sibling_racks(gctx, placement, r)
        lower = is_sib & (eff[safe] < eff[:, None])
        sib_rack = torch.where(lower, sib_rack, k)
        blocked = torch.zeros((r_n, k + 1), dtype=torch.bool, device=state.device)
        blocked[r[:, None].expand_as(sib_rack), sib_rack.long()] = True
        blocked = blocked[:, :k]                                       # [R,K]

        over_r = (counts[eff, placement.broker] > upper[eff]) & state.valid
        fixable = over_r & (under[eff] & ~blocked).any(dim=-1)

        dead_with = (~state.alive) & state.broker_valid & (agg.replica_counts > 0)
        flag_r = (fixable | self._rack_conflict(gctx, placement, eff)).to(torch.int32)
        flagged_b = torch.zeros(state.num_brokers_padded, dtype=torch.int32,
                                device=state.device).scatter_reduce(
            0, placement.broker.long(), flag_r, "amax") > 0
        return dead_with | flagged_b

    def candidate_score(self, gctx, placement, agg):
        state = gctx.state
        eff, counts, upper, _ = self._counts_and_bounds(gctx, placement)
        over = counts[eff, placement.broker] > upper[eff]
        conflict = self._rack_conflict(gctx, placement, eff)
        cand = (over | conflict) & state.valid & ~gctx.replica_excluded
        # Leaders (position 0) first, like the reference's ascending-position
        # sweep; rack conflicts outrank plain over-counts.
        prio = -eff.to(torch.float32) + torch.where(conflict, _CONFLICT_BONUS, 0.0)
        score = torch.where(cand, prio, NEG_INF)
        return torch.where(currently_offline(gctx, placement), prio + OFFLINE_BONUS, score)

    def self_ok(self, gctx, placement, agg, r, dst):
        eff, counts, upper, _ = self._counts_and_bounds(gctx, placement)
        count_ok = counts[eff[r], dst] + 1 <= upper[eff[r]]
        # Offline/conflicted replicas may exceed the band rather than strand.
        must_move = (currently_offline(gctx, placement, r)
                     | self._rack_conflict(gctx, placement, eff)[r])
        return (count_ok | must_move) & self._rack_eligible(gctx, placement, eff, r, dst)

    def dst_cost(self, gctx, placement, agg, r, dst):
        """Fewest position-p replicas first (the reference's TreeSet order)."""
        eff, counts, _, _ = self._counts_and_bounds(gctx, placement)
        return counts[eff[r], dst].to(torch.float32)

    # ----------------------------------------------------- leadership phase

    def leadership_candidate_score(self, gctx, placement, agg):
        """Followers whose leader sits on a leader-rich broker."""
        state = gctx.state
        _, counts, upper, _ = self._counts_and_bounds(gctx, placement)
        lead = current_leader_of(gctx, placement, state.partition)
        over = counts[0, placement.broker[torch.clamp(lead, min=0)]] > upper[0]
        cand = ((lead >= 0) & over & ~placement.is_leader & state.valid
                & ~currently_offline(gctx, placement) & ~gctx.replica_excluded)
        return torch.where(cand, -counts[0, placement.broker].to(torch.float32), NEG_INF)

    def leadership_self_ok(self, gctx, placement, agg, f):
        _, counts, upper, _ = self._counts_and_bounds(gctx, placement)
        return counts[0, placement.broker[f]] + 1 <= upper[0]

    def accept_leadership_move(self, gctx, placement, agg, f):
        return self.leadership_self_ok(gctx, placement, agg, f)

    # --------------------------------------------------- acceptance (vetoes)

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        eff, counts, upper, _ = self._counts_and_bounds(gctx, placement)
        return ((counts[eff[r], dst] + 1 <= upper[eff[r]])
                & self._rack_eligible_strict(gctx, placement, r, dst))

    def accept_swap(self, gctx, placement, agg, r_out, r_in, b_out, b_in):
        """Same-position swaps are count-neutral; cross-position swaps shift
        one count each way.  Rack eligibility applies in both directions."""
        eff, counts, upper, lower = self._counts_and_bounds(gctx, placement)
        p_out, p_in = eff[r_out], eff[r_in]
        counts_ok = ((counts[p_out, b_in] + 1 <= upper[p_out])
                     & (counts[p_in, b_out] + 1 <= upper[p_in])
                     & (counts[p_out, b_out] - 1 >= lower[p_out])
                     & (counts[p_in, b_in] - 1 >= lower[p_in]))
        return (((p_out == p_in) | counts_ok)
                & self._rack_eligible_strict(gctx, placement, r_out, b_in)
                & self._rack_eligible_strict(gctx, placement, r_in, b_out))

    def stats_metric(self, gctx, placement, agg):
        eff, counts, upper, _ = self._counts_and_bounds(gctx, placement)
        excess = torch.clamp(counts - upper[:, None], min=0).sum()
        conflicts = self._rack_conflict(gctx, placement, eff).sum()
        return (excess + conflicts).to(torch.float32)


class KafkaAssignerDiskUsageDistributionGoal(ResourceDistributionGoal):
    """Disk balance via replica SWAPS only (kafka-assigner mode;
    KafkaAssignerDiskUsageDistributionGoal.java:84-233): the shared batched
    swap phase with the move, pull and leadership phases disabled."""

    uses_replica_moves = False
    has_pull_phase = False
    has_swap_phase = True
    relax_eligible = False

    def __init__(self):
        super().__init__(Resource.DISK, "KafkaAssignerDiskUsageDistributionGoal")
