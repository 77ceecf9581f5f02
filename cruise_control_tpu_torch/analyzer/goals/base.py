"""Goal SPI: each goal is a set of pure, broadcastable tensor functions.

Reference contract: ``analyzer/goals/Goal.java:39-156`` (optimize /
actionAcceptance / ClusterModelStatsComparator / isHardGoal) and the
``AbstractGoal.optimize`` template (AbstractGoal.java:78-130).  A goal
supplies

- ``violated_brokers``            — which brokers still need work (bool[B]);
- ``candidate_score``             — which replicas to move, in what order (f32[R]);
- ``self_ok`` / ``dst_cost``      — per-(replica, destination) feasibility and
                                    preference, broadcastable to C×B;
- ``accept_replica_move`` / ``accept_leadership_move`` — the actionAcceptance
  veto this goal exercises over *later* goals' actions;
- ``stats_metric``                — scalar "lower is better" for the
                                    ClusterModelStatsComparator post-check.

All functions take (gctx, placement, agg) plus broadcast index tensors and
carry no Python state.  The swap SPI (``swap_*``, ``accept_swap``) scores
C×C pair tiles of replica exchanges for the swap phase.
"""

from __future__ import annotations

from typing import Optional

import torch

from cruise_control_tpu_torch.analyzer.context import (
    Aggregates,
    GoalContext,
    currently_offline,
    replica_role_load,
)
from cruise_control_tpu_torch.model.state import Placement

NEG_INF = -torch.inf
# Offline replicas (dead broker / dead disk) are moved before anything else —
# the reference does this at the top of every goal's optimize().
OFFLINE_BONUS = 1e30


def all_true(*idx: torch.Tensor) -> torch.Tensor:
    """bool tensor of the broadcast shape of ``idx``, all True."""
    return torch.ones(torch.broadcast_shapes(*(i.shape for i in idx)),
                      dtype=torch.bool, device=idx[0].device)


class Goal:
    """Base goal: permissive defaults; subclasses override what they constrain."""

    name: str = "Goal"
    is_hard: bool = False
    uses_replica_moves: bool = True
    uses_leadership_moves: bool = False
    has_pull_phase: bool = False
    has_swap_phase: bool = False
    # True for goals solved by one direct transform (``direct_apply``), and
    # for goals that move replicas between a broker's own logdirs
    # (``disk_candidate_score`` / ``disk_move_ok``): the solver's direct and
    # intra-disk phases.
    is_direct: bool = False
    intra_disk: bool = False
    # True when accept_replica_move depends on the SOURCE broker's state —
    # the solver then limits batches to one outbound move per source.
    src_sensitive_accept: bool = False
    # Multi-accept: True when this goal's band/capacity math is expressible
    # as CUMULATIVE per-broker slacks (dst/src_cumulative_slack below), so a
    # destination may absorb several candidates in ONE round as long as their
    # cumulative consumption fits the headroom.
    multi_accept_safe: bool = False
    # True when the goal constrains per-(topic, broker) counts — the solver
    # then keeps at most one move per (topic, destination) and (topic,
    # source) pair per round.
    needs_topic_group: bool = False
    # Multi-swap: True when this goal's swap acceptance composes over several
    # swaps per broker in one round — either the goal is swap-neutral or it
    # bounds the transferred quantity via ``swap_cumulative_slack``.  False
    # forces the swap phase back to one swap per broker and host.
    multi_swap_safe: bool = False
    # True when multi-swap safety additionally needs at most ONE swap per
    # (topic, broker) touch per round.
    swap_topic_group: bool = False
    # Multi-leadership: True when this goal's leadership acceptance composes
    # over several promotions per broker in one round — neutral, or bounded
    # via ``leadership_cumulative_slack`` below.
    multi_leadership_safe: bool = False
    # True when multi-leadership safety additionally needs at most ONE
    # promotion per (topic, broker) touch per round.
    leadership_topic_group: bool = False
    # True when this goal's accept_replica_move reads no destination
    # AGGREGATE state — exempts it from the dst-slack invariant check.
    dst_slack_exempt: bool = False
    # Optional candidate-tile width for this goal's move phases (see
    # GoalSolver._width).  None = solver default.
    candidate_width_hint: Optional[int] = None
    # Convex-relaxation path (analyzer/relax.py): True when this goal's
    # objective lowers to a single scalar channel per broker — a per-replica
    # weight plus a per-broker target — so the fractional mass solve + wave
    # rounding can warm-start the greedy loop.  Eligible goals implement
    # ``relax_weights``/``relax_channel`` below.  False (the default) means
    # the goal always takes the greedy path, bit for bit.
    relax_eligible: bool = False

    # ----------------------------------------------------- convex relaxation

    def relax_weights(self, gctx: GoalContext, placement: Placement) -> torch.Tensor:
        """f32[R]: each replica's mass in this goal's relaxation channel
        (resource load, 1.0 for counts, is_leader for leader counts).  Only
        called for ``relax_eligible`` goals."""
        raise NotImplementedError(f"{self.name} is not relax-eligible")

    def relax_channel(self, gctx: GoalContext, agg: Aggregates):
        """(load f32[B], target f32[B], scale f32[B]): the per-broker channel
        the fractional solve balances — current channel load, the band
        center each broker should sit at, and the normalization the squared
        residual divides by (capacity for resource goals, 1.0 for counts).
        Only called for ``relax_eligible`` goals."""
        raise NotImplementedError(f"{self.name} is not relax-eligible")

    # ---------------------------------------------------------------- rounds

    def violated_brokers(self, gctx: GoalContext, placement: Placement,
                         agg: Aggregates) -> torch.Tensor:
        return torch.zeros(gctx.state.num_brokers_padded, dtype=torch.bool,
                           device=gctx.state.device)

    def candidate_score(self, gctx: GoalContext, placement: Placement,
                        agg: Aggregates) -> torch.Tensor:
        """f32[R]: -inf = not a candidate; higher = move first."""
        return self.score_on_violated(gctx, placement, agg,
                                      self.replica_priority(gctx, placement, agg))

    def replica_priority(self, gctx: GoalContext, placement: Placement,
                         agg: Aggregates) -> torch.Tensor:
        """Default ordering: heaviest replicas first (total effective load)."""
        load = torch.where(placement.is_leader[:, None],
                           gctx.state.leader_load, gctx.state.follower_load)
        mean_cap = gctx.state.capacity.mean(dim=0, keepdim=True)
        return (load / torch.clamp(mean_cap, min=1e-9)).sum(dim=-1)

    def score_on_violated(self, gctx: GoalContext, placement: Placement,
                          agg: Aggregates, priority: torch.Tensor) -> torch.Tensor:
        """Candidates = valid replicas on violated brokers, plus offline
        replicas (with a bonus so they are handled first)."""
        state = gctx.state
        vb = self.violated_brokers(gctx, placement, agg)
        on_violated = vb[placement.broker] & state.valid & ~gctx.replica_excluded
        score = torch.where(on_violated, priority, NEG_INF)
        offline = currently_offline(gctx, placement)
        return torch.where(offline, priority + OFFLINE_BONUS, score)

    # ------------------------------------------------- replica-move kernels

    def self_ok(self, gctx: GoalContext, placement: Placement, agg: Aggregates,
                r, dst):
        """Would moving replica r to dst satisfy/improve THIS goal."""
        return all_true(r, dst)

    def dst_cost(self, gctx: GoalContext, placement: Placement, agg: Aggregates,
                 r, dst):
        """Lower = preferred destination. Default: emptiest broker after move."""
        load = replica_role_load(gctx, placement, r)
        after = agg.broker_load[dst] + load
        frac = after / torch.clamp(gctx.state.capacity[dst], min=1e-9)
        return frac.sum(dim=-1)

    def dst_prune_score(self, gctx: GoalContext, placement: Placement,
                        agg: Aggregates):
        """Optional f32[B], higher = more attractive destination: lets the
        solver restrict this goal's pair tile to the top-D brokers
        (rack-stratified).  None (default) = scan every broker."""
        return None

    def accept_replica_move(self, gctx: GoalContext, placement: Placement,
                            agg: Aggregates, r, dst):
        """actionAcceptance for later goals' replica moves (True = ACCEPT)."""
        return all_true(r, dst)

    # -------------------------------------------------- leadership kernels

    def leadership_candidate_score(self, gctx: GoalContext, placement: Placement,
                                   agg: Aggregates) -> torch.Tensor:
        """f32[R] over FOLLOWER replicas: promote which, in what order."""
        return torch.full((gctx.state.num_replicas_padded,), NEG_INF,
                          device=gctx.state.device)

    def leadership_self_ok(self, gctx: GoalContext, placement: Placement,
                           agg: Aggregates, f):
        return all_true(f)

    def accept_leadership_move(self, gctx: GoalContext, placement: Placement,
                               agg: Aggregates, f):
        """actionAcceptance for later goals' leadership promotions."""
        return all_true(f)

    # --------------------------------------------------- multi-accept slack

    def dst_cumulative_slack(self, gctx: GoalContext, placement: Placement,
                             agg: Aggregates, cand_load, is_lead_cand):
        """Optional (weight f32[C], slack f32[B]) arrival-side constraint:
        the cumulative ``weight`` of candidates accepted by a destination in
        one round must stay within ``slack[dst]``.  None = unconstrained."""
        return None

    def src_cumulative_slack(self, gctx: GoalContext, placement: Placement,
                             agg: Aggregates, cand_load, is_lead_cand):
        """Departure-side analog: cumulative weight leaving one source."""
        return None

    def host_cumulative_slack(self, gctx: GoalContext, placement: Placement,
                              agg: Aggregates, cand_load, is_lead_cand):
        """Host-scoped analog of :meth:`dst_cumulative_slack` (slack f32[H])."""
        return None

    def leadership_cumulative_slack(self, gctx: GoalContext, placement: Placement,
                                    agg: Aggregates, f, old):
        """Optional (delta_gain f32[C], delta_lose f32[C], up_slack f32[B],
        low_slack f32[B]|None, up_host f32[H]|None): cumulative bound on what
        each kept promotion adds to the promoted replica's broker and to the
        demoted leader's broker.  None = leadership-neutral."""
        return None

    # ----------------------------------------------------------------- swap
    # The reference's third rebalancing mechanism
    # (ResourceDistributionGoal.java:543-725): exchange a heavy replica on a
    # loaded broker with a light one on a less-loaded broker, so only the
    # load DIFFERENCE moves and replica counts stay.  Batched form: top-k
    # out-candidates × top-k in-candidates, a C×C pair feasibility matrix,
    # conflict-free selection.

    def swap_out_score(self, gctx: GoalContext, placement: Placement,
                       agg: Aggregates, salt) -> torch.Tensor:
        """f32[R]: -inf = not a swap-out candidate; higher = try first.
        ``salt`` (round index) reseeds any randomized interleave."""
        return torch.full((gctx.state.num_replicas_padded,), NEG_INF,
                          device=gctx.state.device)

    def swap_in_score(self, gctx: GoalContext, placement: Placement,
                      agg: Aggregates, salt) -> torch.Tensor:
        """f32[R]: -inf = not a swap-in candidate; higher = try first."""
        return torch.full((gctx.state.num_replicas_padded,), NEG_INF,
                          device=gctx.state.device)

    def swap_ok(self, gctx: GoalContext, placement: Placement, agg: Aggregates,
                r_out, r_in):
        """Would swapping r_out ↔ r_in satisfy/improve THIS goal (pairwise)."""
        return ~all_true(r_out, r_in)

    def swap_cost(self, gctx: GoalContext, placement: Placement, agg: Aggregates,
                  r_out, r_in):
        """Lower = preferred pair."""
        return torch.zeros(torch.broadcast_shapes(r_out.shape, r_in.shape),
                           device=r_out.device)

    def accept_swap(self, gctx: GoalContext, placement: Placement,
                    agg: Aggregates, r_out, r_in, b_out, b_in):
        """actionAcceptance for later goals' SWAP actions.  Default: accept
        iff both directional moves are individually acceptable (each checked
        against pre-swap aggregates, so vacated headroom is not credited)."""
        return (self.accept_replica_move(gctx, placement, agg, r_out, b_in)
                & self.accept_replica_move(gctx, placement, agg, r_in, b_out))

    def swap_cumulative_slack(self, gctx: GoalContext, placement: Placement,
                              agg: Aggregates, d_load, d_pot, d_lbi, d_lead):
        """Optional (delta f32[C], upper_slack f32[B], lower_slack f32[B]|None):
        cumulative bound on what each kept swap transfers b_out → b_in.
        ``d_load`` is the pairs' role-load delta f32[C,4]; ``d_pot``,
        ``d_lbi`` and ``d_lead`` the potential-NW-out, leader-bytes-in and
        leader-count deltas f32[C].  None = swap-neutral."""
        return None

    def swap_host_cumulative_slack(self, gctx: GoalContext, placement: Placement,
                                   agg: Aggregates, d_load):
        """(delta f32[C], upper_slack f32[H]) host-scoped analog (upper bound
        only).  None = no host-level constraint."""
        return None

    # ------------------------------------------------------ pull (move-in)

    def pull_dst_prune_score(self, gctx: GoalContext, placement: Placement,
                             agg: Aggregates):
        """Optional f32[B] for tiling the PULL phase's destination axis."""
        return None

    def pull_dst_mask(self, gctx: GoalContext, placement: Placement,
                      agg: Aggregates) -> torch.Tensor:
        """bool[B]: brokers that need load moved IN."""
        return torch.zeros(gctx.state.num_brokers_padded, dtype=torch.bool,
                           device=gctx.state.device)

    def pull_candidate_score(self, gctx: GoalContext, placement: Placement,
                             agg: Aggregates) -> torch.Tensor:
        return torch.full((gctx.state.num_replicas_padded,), NEG_INF,
                          device=gctx.state.device)

    # ------------------------------------------------------------- metrics

    def stats_metric(self, gctx: GoalContext, placement: Placement,
                     agg: Aggregates):
        """Scalar, lower = better (ClusterModelStatsComparator equivalent)."""
        return self.violated_brokers(gctx, placement, agg).to(torch.float32).sum()

    def __repr__(self) -> str:
        return f"<{self.name} hard={self.is_hard}>"


def alive_mask(gctx: GoalContext) -> torch.Tensor:
    return gctx.state.alive & gctx.state.broker_valid


def avg_alive_util_fraction(gctx: GoalContext, agg: Aggregates, resource: int):
    """f32 scalar: the alive brokers' load over their capacity, for one
    resource."""
    alive = alive_mask(gctx)
    total = torch.where(alive, agg.broker_load[:, resource], 0.0).sum()
    cap = torch.where(alive, gctx.state.capacity[:, resource], 0.0).sum()
    return total / torch.clamp(cap, min=1e-9)
