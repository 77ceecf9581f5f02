"""Goal-priority optimization loop.

Reference: ``analyzer/GoalOptimizer.java`` — the core loop :415-489 runs goals
by priority over one ClusterModel, collecting per-goal stats and the final
proposal diff.  Here the loop body drives the batched ``GoalSolver``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import build_context
from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.analyzer.goals.registry import (
    DEFAULT_GOALS,
    get_goals_by_priority,
)
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.analyzer.proposals import diff_proposals
from cruise_control_tpu_torch.analyzer.solver import (
    GoalOptimizationInfo,
    GoalSolver,
    check_hard_goal,
)
from cruise_control_tpu_torch.common.actions import ExecutionProposal, ProposalSummary
from cruise_control_tpu_torch.common.exceptions import OptimizationFailureError
from cruise_control_tpu_torch.model.state import ClusterMeta, ClusterState, Placement
from cruise_control_tpu_torch.model.stats import ClusterModelStats, compute_stats

LOG = logging.getLogger(__name__)

# Balancedness weights (reference: KafkaCruiseControlUtils.java:734-762 —
# goal-violation weights used for the balancedness score gauge).
_BALANCEDNESS_WEIGHT_HARD = 3.0
_BALANCEDNESS_WEIGHT_SOFT = 1.0


@dataclass
class OptimizerResult:
    """Reference: ``analyzer/OptimizerResult.java``."""

    proposals: List[ExecutionProposal]
    goal_infos: List[GoalOptimizationInfo]
    stats_before: ClusterModelStats
    stats_after: ClusterModelStats
    violated_goals_before: List[str]
    violated_goals_after: List[str]
    balancedness_score: float
    elapsed_s: float
    final_placement: Optional[Placement] = None

    @property
    def summary(self) -> ProposalSummary:
        return ProposalSummary.of(self.proposals)

    def to_dict(self) -> Dict:
        s = self.summary
        return {
            "numInterBrokerReplicaMovements": s.num_inter_broker_replica_movements,
            "numIntraBrokerReplicaMovements": s.num_intra_broker_replica_movements,
            "numLeaderMovements": s.num_leadership_movements,
            "interBrokerDataToMoveMB": s.inter_broker_data_to_move_mb,
            "intraBrokerDataToMoveMB": s.intra_broker_data_to_move_mb,
            "violatedGoalsBefore": self.violated_goals_before,
            "violatedGoalsAfter": self.violated_goals_after,
            "balancednessScore": self.balancedness_score,
            "statsBefore": self.stats_before.to_dict(),
            "statsAfter": self.stats_after.to_dict(),
            "goals": [
                {
                    "goal": g.goal_name,
                    "rounds": g.rounds,
                    "moves": g.moves_applied,
                    "violatedBrokersBefore": g.violated_brokers_before,
                    "violatedBrokersAfter": g.violated_brokers_after,
                    "metricBefore": g.metric_before,
                    "metricAfter": g.metric_after,
                }
                for g in self.goal_infos
            ],
        }


def balancedness_score(goal_infos: Sequence[GoalOptimizationInfo],
                       goals: Sequence[Goal]) -> float:
    """[0, 100]: weighted fraction of satisfied goals (hard goals weigh 3×)."""
    by_name = {g.name: g for g in goals}
    total = 0.0
    got = 0.0
    for info in goal_infos:
        goal = by_name.get(info.goal_name)
        w = _BALANCEDNESS_WEIGHT_HARD if goal is not None and goal.is_hard \
            else _BALANCEDNESS_WEIGHT_SOFT
        total += w
        if info.violated_brokers_after == 0:
            got += w
    return 100.0 * got / total if total else 100.0


class GoalOptimizer:
    """Runs a prioritized goal list over a frozen snapshot."""

    def __init__(
        self,
        constraint: Optional[BalancingConstraint] = None,
        goal_names: Optional[Sequence[str]] = None,
        solver: Optional[GoalSolver] = None,
        polish_passes: int = 1,
    ):
        self.constraint = constraint or BalancingConstraint()
        self.goal_names = list(goal_names or DEFAULT_GOALS)
        self.solver = solver or GoalSolver(
            max_candidates_per_round=self.constraint.max_candidates_per_round,
            max_rounds_per_goal=self.constraint.max_rounds_per_goal,
        )
        # Post-stack re-solve passes for re-violated soft goals (0 disables).
        self.polish_passes = polish_passes

    def optimizations(
        self,
        state: ClusterState,
        placement: Placement,
        meta: ClusterMeta,
        options: Optional[OptimizationOptions] = None,
        goals: Optional[Sequence[Goal]] = None,
    ) -> OptimizerResult:
        """The core loop (GoalOptimizer.java:415-489): per-goal optimize with
        all previously-optimized goals enforcing acceptance, then diff.  Runs
        on the device the state lives on."""
        options = options or OptimizationOptions()
        goals = list(goals) if goals is not None else get_goals_by_priority(self.goal_names)
        t0 = time.monotonic()
        gctx = build_context(state, placement, meta, self.constraint, options)
        initial = placement

        agg0 = self.solver.aggregates(gctx, placement)
        vio0 = self.solver.violations(goals, gctx, placement, agg0)
        violated_before = [g.name for g, v in zip(goals, vio0) if v > 0]
        stats_before = compute_stats(state, placement, self.constraint.balance_threshold)

        # AbstractGoal.java:108-117: the stats-must-not-worsen contract is
        # waived only when the cluster has broken brokers or excluded-for-move
        # brokers still holding replicas (evacuation may legitimately worsen
        # a soft metric).
        excl_move = gctx.excluded_for_replica_move
        has_broken = bool(((~state.alive & state.broker_valid).any()
                           | (excl_move & (agg0.replica_counts > 0)).any()).item())

        infos: List[GoalOptimizationInfo] = []
        priors: List[Goal] = []
        agg = agg0
        for goal in goals:
            placement, agg, info = self.solver.optimize_goal(
                goal, priors, gctx, placement, agg)
            infos.append(info)
            # Goals that cannot relocate replicas across brokers are not
            # responsible for dead-broker evacuation.
            stranded = info.stranded_after if goal.is_hard and goal.uses_replica_moves else 0
            check_hard_goal(goal, info, stranded)
            worsened = (info.rounds > 0 and info.metric_after
                        > info.metric_before * (1 + 1e-5) + 1e-9)
            if worsened and not has_broken:
                raise OptimizationFailureError(
                    f"[{goal.name}] optimized result is worse than before: "
                    f"{info.metric_before:.6g} -> {info.metric_after:.6g}")
            elif worsened:
                LOG.warning("goal %s metric worsened during evacuation: "
                            "%.6g -> %.6g", goal.name,
                            info.metric_before, info.metric_after)
            priors.append(goal)

        # Polish pass: a later goal's moves may RE-violate an earlier SOFT
        # goal's band (hard goals are protected by the acceptance chains).
        # Re-solve each re-violated soft goal with EVERY other goal as a
        # prior, so the fix cannot disturb anything else.  Goals that never
        # satisfied their band in their own pass are excluded.
        satisfied_own_pass = {i.goal_name for i in infos
                              if i.violated_brokers_after == 0}
        for _ in range(self.polish_passes):
            vio_p = self.solver.violations(goals, gctx, placement, agg)
            revio = [g for g, v in zip(goals, vio_p)
                     if not g.is_hard and g.name in satisfied_own_pass and v > 0]
            if not revio:
                break
            for goal in revio:
                placement, agg, pinfo = self.solver.optimize_goal(
                    goal, [p for p in goals if p is not goal], gctx, placement, agg)
                for inf in infos:
                    if inf.goal_name == goal.name:
                        inf.rounds += pinfo.rounds
                        inf.moves_applied += pinfo.moves_applied
                        inf.violated_brokers_after = pinfo.violated_brokers_after
                        inf.metric_after = pinfo.metric_after

        # `agg` is exact here: every solve returns a fresh full recompute and
        # the placement has not changed since the last one.
        vio_n = self.solver.violations(goals, gctx, placement, agg)
        violated_after = [g.name for g, v in zip(goals, vio_n) if v > 0]
        stats_after = compute_stats(state, placement, self.constraint.balance_threshold)
        proposals = diff_proposals(state, initial, placement, meta)
        return OptimizerResult(
            proposals=proposals,
            goal_infos=infos,
            stats_before=stats_before,
            stats_after=stats_after,
            violated_goals_before=violated_before,
            violated_goals_after=violated_after,
            balancedness_score=balancedness_score(infos, goals),
            elapsed_s=time.monotonic() - t0,
            final_placement=placement,
        )
