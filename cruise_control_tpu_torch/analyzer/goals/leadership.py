"""Leadership-centric goals.

Reference: ``analyzer/goals/PreferredLeaderElectionGoal.java:35-208`` (move
leadership to the first eligible replica in each partition's replica list —
used by broker demotion) and ``MinTopicLeadersPerBrokerGoal.java`` (each
alive broker must lead at least N partitions of configured topics).
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.analyzer.context import (
    Aggregates,
    GoalContext,
    current_leader_of,
    currently_offline,
)
from cruise_control_tpu_torch.analyzer.goals.base import Goal, NEG_INF, alive_mask
from cruise_control_tpu_torch.model.state import Placement

_BIG = 1 << 30


def _scatter_any(n: int, idx: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """bool[n]: ``out[i]`` is True when some ``flag[j]`` with ``idx[j] == i``
    is (``zeros(n).at[idx].max(flag)``)."""
    out = torch.zeros(n, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce(0, idx.long(), flag.to(torch.int32), "amax") > 0


def _current_leaders(gctx: GoalContext, placement: Placement) -> torch.Tensor:
    """i32[P]: current leader replica row per partition (-1 if none)."""
    sibs = gctx.partition_replicas
    safe = torch.clamp(sibs, min=0)
    is_l = (sibs >= 0) & placement.is_leader[safe]
    slot = torch.argmax(is_l.to(torch.uint8), dim=-1)
    got = torch.gather(safe, 1, slot[:, None])[:, 0]
    return torch.where(is_l.any(dim=-1), got, -1)


class PreferredLeaderElectionGoal(Goal):
    """Direct transform, not a search: for every partition, leadership goes to
    the lowest-position eligible replica (alive broker, not offline, broker
    not excluded from leadership)."""

    name = "PreferredLeaderElectionGoal"
    multi_accept_safe = True
    multi_swap_safe = True         # swaps keep per-replica roles; PLE unaffected
    multi_leadership_safe = True   # PLE never vetoes (permissive accepts)
    is_hard = False
    is_direct = True
    uses_replica_moves = False

    def _preferred(self, gctx: GoalContext, placement: Placement):
        """Per partition: (chosen replica row, any eligible?, real partition?)."""
        state = gctx.state
        sibs = gctx.partition_replicas                       # [P, RF]
        safe = torch.clamp(sibs, min=0)
        sib_b = placement.broker[safe]
        off = currently_offline(gctx, placement)
        eligible = ((sibs >= 0) & state.valid[safe] & ~off[safe]
                    & state.alive[sib_b] & ~gctx.excluded_for_leadership[sib_b]
                    & ~gctx.replica_excluded[safe])
        key = torch.where(eligible, state.pos[safe], _BIG)   # [P, RF]
        choice_slot = torch.argmin(key, dim=-1)              # first minimum
        chosen = torch.gather(safe, 1, choice_slot[:, None])[:, 0]
        return chosen, eligible.any(dim=-1), (sibs >= 0).any(dim=-1)

    def direct_apply(self, gctx: GoalContext, placement: Placement,
                     agg: Aggregates) -> Placement:
        chosen, any_ok, real_p = self._preferred(gctx, placement)
        # Keep the current leader where no replica is eligible.
        cur_leader = _current_leaders(gctx, placement)        # i32[P]
        final = torch.where(any_ok, chosen, torch.clamp(cur_leader, min=0))
        has_any = any_ok | (cur_leader >= 0)
        # Padded partitions (all sibs -1) map to replica 0 — masked out.
        is_leader = _scatter_any(placement.is_leader.shape[0], final, has_any & real_p)
        return placement.replace(is_leader=is_leader)

    def violated_brokers(self, gctx, placement, agg):
        """A broker is violated while it leads a partition whose preferred
        (lowest-position eligible) replica lives elsewhere."""
        chosen, any_ok, real_p = self._preferred(gctx, placement)
        cur = _current_leaders(gctx, placement)               # i32[P]
        wrong = real_p & any_ok & (chosen != cur)             # covers cur == -1
        holder = torch.where(cur >= 0, placement.broker[torch.clamp(cur, min=0)],
                             placement.broker[chosen])
        return _scatter_any(gctx.state.num_brokers_padded, holder, wrong)


class MinTopicLeadersPerBrokerGoal(Goal):
    """Each alive broker leads ≥ N partitions of each configured topic
    (MinTopicLeadersPerBrokerGoal.java).  No configured topics → no-op.

    Two mechanisms, like the reference: promote an existing follower on a
    deficit broker (LEADERSHIP_MOVEMENT, :333), and — when the deficit
    broker holds no promotable follower — move a surplus broker's leader
    replica onto it (INTER_BROKER_REPLICA_MOVEMENT, :360,430)."""

    name = "MinTopicLeadersPerBrokerGoal"
    is_hard = True
    src_sensitive_accept = True
    # Acceptance reads only per-(topic, source) leader counts; one move,
    # swap or promotion per (topic, broker) pair per round keeps each delta
    # within the ±1 that the pairwise predicates already checked.
    multi_accept_safe = True
    needs_topic_group = True
    multi_swap_safe = True
    swap_topic_group = True
    multi_leadership_safe = True
    leadership_topic_group = True
    uses_replica_moves = True
    uses_leadership_moves = True

    def _deficit(self, gctx, agg):
        """i32[T, B]: missing leaders per (relevant topic, alive broker)."""
        need = torch.where(gctx.min_leader_topic_mask[:, None], gctx.min_topic_leaders, 0)
        deficit = torch.clamp(need - agg.topic_leader_counts, min=0)
        return torch.where(alive_mask(gctx)[None, :], deficit, 0)

    def violated_brokers(self, gctx, placement, agg):
        return (self._deficit(gctx, agg) > 0).any(dim=0)

    def leadership_candidate_score(self, gctx, placement, agg):
        """Promote followers of relevant topics sitting on deficit brokers,
        when the current leader's broker has surplus."""
        state = gctx.state
        deficit = self._deficit(gctx, agg)
        t = state.topic
        b = placement.broker
        lead = current_leader_of(gctx, placement, state.partition)
        lb = placement.broker[torch.clamp(lead, min=0)]
        donor_ok = (lead >= 0) & (
            (agg.topic_leader_counts[t, lb] - 1 >= gctx.min_topic_leaders)
            | ~gctx.min_leader_topic_mask[t])
        cand = ((deficit[t, b] > 0) & donor_ok & ~placement.is_leader & state.valid
                & ~currently_offline(gctx, placement) & ~gctx.replica_excluded
                & gctx.min_leader_topic_mask[t])
        return torch.where(cand, deficit[t, b].to(torch.float32), NEG_INF)

    def leadership_self_ok(self, gctx, placement, agg, f):
        t = gctx.state.topic[f]
        return self._deficit(gctx, agg)[t, placement.broker[f]] > 0

    def candidate_score(self, gctx, placement, agg):
        """Leader replicas of relevant topics on surplus brokers, when their
        topic still has a deficit broker somewhere — the replica-movement
        fallback for deficit brokers no promotion can reach."""
        state = gctx.state
        topic_needs = (self._deficit(gctx, agg) > 0).any(dim=1)   # bool[T]
        t = state.topic
        surplus = (agg.topic_leader_counts[t, placement.broker]
                   - gctx.min_topic_leaders)                      # i32[R]
        cand = (placement.is_leader & state.valid & ~gctx.replica_excluded
                & ~currently_offline(gctx, placement)
                & gctx.min_leader_topic_mask[t] & topic_needs[t]
                & (surplus > 0))
        # Richest sources shed first (most headroom above the minimum).
        return torch.where(cand, surplus.to(torch.float32), NEG_INF)

    def self_ok(self, gctx, placement, agg, r, dst):
        t = gctx.state.topic[r]
        src = placement.broker[r]
        donor_ok = (agg.topic_leader_counts[t, src] - 1 >= gctx.min_topic_leaders)
        return (self._deficit(gctx, agg)[t, dst] > 0) & donor_ok

    def dst_cost(self, gctx, placement, agg, r, dst):
        """Deepest deficit first; the default load tiebreak would spread a
        topic's spare leaders to already-satisfied brokers."""
        t = gctx.state.topic[r]
        return -self._deficit(gctx, agg)[t, dst].to(torch.float32)

    def accept_leadership_move(self, gctx, placement, agg, f):
        """Later goals may not demote a leader off a broker already at minimum."""
        t = gctx.state.topic[f]
        lead = current_leader_of(gctx, placement, gctx.state.partition[f])
        lb = placement.broker[torch.clamp(lead, min=0)]
        relevant = gctx.min_leader_topic_mask[t] & (lead >= 0)
        donor_ok = agg.topic_leader_counts[t, lb] - 1 >= gctx.min_topic_leaders
        return ~relevant | donor_ok

    def accept_replica_move(self, gctx, placement, agg, r, dst):
        """Moving a relevant-topic leader off a broker at minimum is vetoed."""
        t = gctx.state.topic[r]
        src = placement.broker[r]
        relevant = gctx.min_leader_topic_mask[t] & placement.is_leader[r]
        src_ok = agg.topic_leader_counts[t, src] - 1 >= gctx.min_topic_leaders
        return ~relevant | src_ok | ~gctx.state.alive[src]

    def stats_metric(self, gctx, placement, agg):
        return self._deficit(gctx, agg).sum().to(torch.float32)
