"""Goal-priority optimization loop.

Reference: ``analyzer/GoalOptimizer.java`` — the core loop :415-489 runs goals
by priority over one ClusterModel, collecting per-goal stats and the final
proposal diff; :289-337 serves cached proposals.  Here the loop body drives
the batched ``GoalSolver``, a result is cached per model generation, and
what-if studies (remove or add brokers) run as lanes, one per scenario.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer import relax
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import (
    build_context,
    compute_aggregates,
    scenario_context,
)
from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.analyzer.goals.registry import (
    DEFAULT_GOALS,
    get_goals_by_priority,
    goal_by_name,
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
    # Anytime result: the solve stopped at a budget boundary (deadline or
    # cancellation) before every goal converged.  The placement is still
    # feasible and hard-goal-safe for the goals that did run; per-goal
    # status is in goal_infos[i].preempted.
    partial: bool = False
    preempt_reason: Optional[str] = None

    @property
    def summary(self) -> ProposalSummary:
        return ProposalSummary.of(self.proposals)

    def to_dict(self) -> Dict:
        s = self.summary
        return {
            **({"partial": True, "preemptReason": self.preempt_reason}
               if self.partial else {}),
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
                    "status": "preempted" if g.preempted else "completed",
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


def _scenario_masks(gctx, state, meta, scenario_sets, revive: bool):
    """Per-lane (alive, excl_move, excl_lead) bool[S, B] masks for what-if
    batches.

    ``revive=False`` decommissions each lane's brokers (dead + excluded as
    destinations and leaders, the RemoveBrokersRunnable semantics).
    ``revive=True`` brings each lane's provisioned-but-dead brokers up —
    liveness only: operator-stated exclusions are not cleared; a dead
    broker is blocked by ``state.alive`` in the structural checks, never by
    the exclusion masks."""
    s_n = len(scenario_sets)
    unknown = sorted({int(b) for ids in scenario_sets for b in ids}
                     - meta.broker_index.keys())
    if unknown:
        # Scenario sets come from requests (remove_broker / add_broker):
        # a typo'd id must surface as a clear client error.
        raise ValueError(
            f"unknown broker id(s) {unknown} in what-if scenario: not in "
            f"this cluster model's broker set")
    alive_s = np.tile(state.alive.cpu().numpy(), (s_n, 1))
    excl_move_s = np.tile(gctx.excluded_for_replica_move.cpu().numpy(), (s_n, 1))
    excl_lead_s = np.tile(gctx.excluded_for_leadership.cpu().numpy(), (s_n, 1))
    for s, ids in enumerate(scenario_sets):
        for bid in ids:
            i = meta.broker_index[int(bid)]
            alive_s[s, i] = revive
            if not revive:
                excl_move_s[s, i] = True
                excl_lead_s[s, i] = True
    dev = state.device
    return (torch.as_tensor(alive_s, device=dev),
            torch.as_tensor(excl_move_s, device=dev),
            torch.as_tensor(excl_lead_s, device=dev))


@dataclass
class BatchScenarioResult:
    """Result of a what-if batch (one lane per scenario).

    Reference analog: ``servlet/handler/async/runnable/RemoveBrokersRunnable``
    run once per scenario."""

    scenario_sets: List[List[int]]   # per-lane broker ids (removed or added)
    goal_names: List[str]
    violated_after: np.ndarray      # i32[S, G] violated brokers per scenario/goal
    moves: np.ndarray               # i32[S, G]
    rounds: np.ndarray              # i32[S, G]
    stranded_after: np.ndarray      # i32[S] offline replicas left (last goal)
    final_placements: Placement     # stacked [S, R] tensors
    # The budget fired between goals: goal_names (and the [S, G] stats)
    # cover only the goal prefix that ran; every lane's placement is the
    # anytime result after that prefix.
    preempted: bool = False
    # The JAX package's memory guard can refuse a dispatch; the port has no
    # lane planner, so this stays False.
    memory_refused: bool = False

    @property
    def num_scenarios(self) -> int:
        return len(self.scenario_sets)

    def succeeded(self, s: int) -> bool:
        """Scenario s evacuated everything and satisfies every goal."""
        return (int(self.stranded_after[s]) == 0
                and int(self.violated_after[s].sum()) == 0)

    def placement_for(self, s: int) -> Placement:
        fp = self.final_placements
        return Placement(broker=fp.broker[s], disk=fp.disk[s], is_leader=fp.is_leader[s])

    def balancedness(self, s: int) -> float:
        """Per-lane balancedness on the hard=3.0/soft=1.0 weights of
        :func:`balancedness_score` (lane s's violated_after row stands in
        for a sequential run's goal_infos)."""
        total = 0.0
        got = 0.0
        for g, name in enumerate(self.goal_names):
            w = (_BALANCEDNESS_WEIGHT_HARD if goal_by_name(name).is_hard
                 else _BALANCEDNESS_WEIGHT_SOFT)
            total += w
            if int(self.violated_after[s, g]) == 0:
                got += w
        return 100.0 * got / total if total else 100.0

    def quality(self, s: int) -> Dict:
        """The per-lane quality fields: violated brokers over all goals and
        balancedness."""
        return {"violated_after": int(self.violated_after[s].sum()),
                "balancedness": round(self.balancedness(s), 3)}


class GoalOptimizer:
    """Runs a prioritized goal list over a frozen snapshot; caches the last
    result per model generation (GoalOptimizer.java:196-224 cache
    semantics).  ``relaxation`` turns on the convex-relaxation path for
    eligible goals (off when None)."""

    def __init__(
        self,
        constraint: Optional[BalancingConstraint] = None,
        goal_names: Optional[Sequence[str]] = None,
        solver: Optional[GoalSolver] = None,
        polish_passes: int = 1,
        relaxation: Optional[relax.RelaxationConfig] = None,
    ):
        self.constraint = constraint or BalancingConstraint()
        self.goal_names = list(goal_names or DEFAULT_GOALS)
        self.solver = solver or GoalSolver(
            max_candidates_per_round=self.constraint.max_candidates_per_round,
            max_rounds_per_goal=self.constraint.max_rounds_per_goal,
        )
        # Post-stack re-solve passes for re-violated soft goals (0 disables).
        self.polish_passes = polish_passes
        self.relaxation = relaxation
        self._cache_lock = threading.Lock()
        self._cached: Dict[Tuple, OptimizerResult] = {}

    def _use_relax(self, goal: Goal, budget) -> bool:
        """The relaxation path is taken where it is on, for eligible goals,
        and never under a segmented budget (its preemption seams have no
        relax equivalent); cancel-only budgets take it."""
        return (self.relaxation is not None and goal.relax_eligible
                and (budget is None or not budget.segmented))

    # ------------------------------------------------------------- the loop

    def optimizations(
        self,
        state: ClusterState,
        placement: Placement,
        meta: ClusterMeta,
        options: Optional[OptimizationOptions] = None,
        goals: Optional[Sequence[Goal]] = None,
        model_generation: Optional[int] = None,
        budget=None,
    ) -> OptimizerResult:
        """The core loop (GoalOptimizer.java:415-489): per-goal optimize with
        all previously-optimized goals enforcing acceptance, then diff.  Runs
        on the device the state lives on.

        ``model_generation`` keys a cache of the latest result (a converged
        one only).  ``budget`` (a
        :class:`~cruise_control_tpu_torch.analyzer.budget.SolveBudget`) makes
        the run anytime: it is checked at every goal boundary (and, when
        segmented, at segment boundaries inside each goal); on expiry or
        cancel the result is returned as it stands with ``partial=True``."""
        options = options or OptimizationOptions()
        cache_key = None
        if model_generation is not None:
            names = (tuple(g.name for g in goals) if goals is not None
                     else tuple(self.goal_names))
            cache_key = (model_generation, names, options, self.polish_passes)
            if self.relaxation is not None:
                cache_key = cache_key + (self.relaxation,)
            with self._cache_lock:
                hit = self._cached.get(cache_key)
            if hit is not None:
                return hit

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
        preempt_reason = None
        for gi, goal in enumerate(goals):
            # Goal-boundary budget check; goals never started are recorded
            # as preempted with zero rounds.
            if budget is not None:
                preempt_reason = budget.stop_reason()
                if preempt_reason is not None:
                    vio_rem = self.solver.violations(goals[gi:], gctx, placement, agg)
                    for g, v in zip(goals[gi:], vio_rem):
                        infos.append(GoalOptimizationInfo(
                            goal_name=g.name,
                            violated_brokers_before=int(v),
                            violated_brokers_after=int(v),
                            preempted=True,
                            preempt_reason=preempt_reason))
                    break
            if self._use_relax(goal, budget):
                placement, agg, info = relax.optimize_goal_relaxed(
                    self.solver, goal, priors, gctx, placement, agg, self.relaxation)
            else:
                placement, agg, info = self.solver.optimize_goal(
                    goal, priors, gctx, placement, agg, budget=budget)
            infos.append(info)
            if info.preempted:
                # A mid-goal preemption: the placement is the best found so
                # far.  The hard-goal and no-worsen verdicts judge converged
                # solves, and a partial result may carry residual violations.
                preempt_reason = info.preempt_reason
                continue
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
        partial = any(i.preempted for i in infos)

        # Polish pass: a later goal's moves may RE-violate an earlier SOFT
        # goal's band (hard goals are protected by the acceptance chains).
        # Re-solve each re-violated soft goal with EVERY other goal as a
        # prior, so the fix cannot disturb anything else.  Goals that never
        # satisfied their band in their own pass are excluded.  A partial
        # result is returned as it stands.
        satisfied_own_pass = {i.goal_name for i in infos
                              if i.violated_brokers_after == 0}
        for _ in range(self.polish_passes if not partial else 0):
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
        result = OptimizerResult(
            proposals=proposals,
            goal_infos=infos,
            stats_before=stats_before,
            stats_after=stats_after,
            violated_goals_before=violated_before,
            violated_goals_after=violated_after,
            balancedness_score=balancedness_score(infos, goals),
            elapsed_s=time.monotonic() - t0,
            final_placement=placement,
            partial=partial,
            preempt_reason=preempt_reason if partial else None,
        )
        # Partial results are never cached: a later request with more budget
        # (or none) must get the converged answer.
        if cache_key is not None and not partial:
            with self._cache_lock:
                self._cached = {cache_key: result}   # keep only the latest generation
        return result

    # --------------------------------------------------------- what-if lanes

    def batch_remove_scenarios(
        self,
        state: ClusterState,
        placement: Placement,
        meta: ClusterMeta,
        removal_sets: Sequence[Sequence[int]],
        options: Optional[OptimizationOptions] = None,
        goals: Optional[Sequence[Goal]] = None,
        num_candidates: int = 512,
        warm_start: Optional[Placement] = None,
        budget=None,
    ) -> BatchScenarioResult:
        """Solve S independent remove-broker what-ifs (BASELINE config #5),
        one lane per scenario: each lane's removed brokers are dead and
        excluded as destinations and leaders.

        ``warm_start`` seeds every lane from an already-balanced placement
        instead of the snapshot's: lanes then only repair their own
        scenario's damage."""
        return self._batch_scenarios(state, placement, meta, removal_sets, False,
                                     options, goals, num_candidates, warm_start, budget)

    def batch_add_scenarios(
        self,
        state: ClusterState,
        placement: Placement,
        meta: ClusterMeta,
        addition_sets: Sequence[Sequence[int]],
        options: Optional[OptimizationOptions] = None,
        goals: Optional[Sequence[Goal]] = None,
        num_candidates: int = 512,
        warm_start: Optional[Placement] = None,
        budget=None,
    ) -> BatchScenarioResult:
        """Add-broker what-ifs (the AddBrokersRunnable analog of
        :meth:`batch_remove_scenarios`): ``state`` carries every candidate
        broker provisioned but dead (``alive=False``, no replicas); each
        lane revives its addition set, and the count and distribution goals
        pull load onto the arrivals."""
        return self._batch_scenarios(state, placement, meta, addition_sets, True,
                                     options, goals, num_candidates, warm_start, budget)

    def _batch_scenarios(self, state, placement, meta, scenario_sets, revive,
                         options, goals, num_candidates, warm_start,
                         budget) -> BatchScenarioResult:
        options = options or OptimizationOptions()
        goals = (list(goals) if goals is not None
                 else get_goals_by_priority(self.goal_names))
        # The context is built from the BASE placement either way: it only
        # feeds placement-independent statics; every lane recomputes its
        # aggregates from its own (possibly warm-started) placement.
        gctx = build_context(state, placement, meta, self.constraint, options)
        masks = _scenario_masks(gctx, state, meta, scenario_sets, revive)
        seed = placement if warm_start is None else warm_start
        rounds, moves, violated, stranded, placements = self._run_lanes(
            gctx, seed, goals, num_candidates, *masks, budget)
        return BatchScenarioResult(
            scenario_sets=[list(map(int, ids)) for ids in scenario_sets],
            goal_names=[g.name for g in goals[:rounds.shape[1]]],
            violated_after=violated,
            moves=moves,
            rounds=rounds,
            stranded_after=stranded,
            final_placements=placements,
            preempted=rounds.shape[1] < len(goals),
        )

    def _run_lanes(self, gctx, seed: Placement, goals, num_candidates,
                   alive_s, excl_move_s, excl_lead_s, budget):
        """The lane runner (the JAX package's ``_run_lane_block_impl``), goal
        by goal: every lane finishes goal g before any lane starts goal g+1,
        so a budget cuts every lane at the same goal prefix, at least one
        goal always runs, and the [S, G] stats stay column-aligned.  Each
        lane runs its own context (:func:`scenario_context`) at candidate
        width ``min(num_candidates, R_pad)`` from fresh aggregates of its own
        placement, one lane after another.  Returns (rounds, moves,
        violated after: i32[S, G]; stranded after the last goal: i32[S];
        the stacked final placements)."""
        s_n = alive_s.shape[0]
        r_pad = gctx.state.num_replicas_padded
        c = min(num_candidates, r_pad)
        lanes = [scenario_context(gctx, alive_s[s], excl_move_s[s], excl_lead_s[s])
                 for s in range(s_n)]
        placements = [seed] * s_n
        stats = []                       # per goal: [S] rows of (rounds, moves, violated)
        stranded = np.zeros(s_n, dtype=np.int32)
        priors: List[Goal] = []
        for goal in goals:
            # Goal-boundary budget check: at least one goal always runs so
            # every lane has a solved placement to return.
            if budget is not None and priors and budget.should_stop():
                break
            use_relax = self._use_relax(goal, budget)
            if use_relax:
                k = relax.relax_width(self.relaxation, r_pad, num_candidates)
            column = []
            for s, lctx in enumerate(lanes):
                pl = placements[s]
                if use_relax:
                    # Each lane's placement becomes its rounded relaxation;
                    # the greedy solve below is the lane's repair pass.
                    pl = relax.relax_round(goal, priors, lctx, pl, compute_aggregates(lctx, pl),
                                           k, self.relaxation.waves,
                                           self.relaxation.iterations)[0]
                pl, _, info = self.solver.optimize_goal(
                    goal, priors, lctx, pl, compute_aggregates(lctx, pl), width=c)
                placements[s] = pl
                column.append((info.rounds, info.moves_applied, info.violated_brokers_after))
                stranded[s] = info.stranded_after
            stats.append(column)
            priors.append(goal)
        table = np.asarray(stats, dtype=np.int32).reshape(len(stats), s_n, 3)
        rounds, moves, violated = (np.ascontiguousarray(table[:, :, i].T) for i in range(3))
        stacked = Placement(broker=torch.stack([p.broker for p in placements]),
                            disk=torch.stack([p.disk for p in placements]),
                            is_leader=torch.stack([p.is_leader for p in placements]))
        return rounds, moves, violated, stranded, stacked
