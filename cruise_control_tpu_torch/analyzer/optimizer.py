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
from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.compilesvc.service import compile_service
from cruise_control_tpu_torch.model.state import ClusterMeta, ClusterState, Placement
from cruise_control_tpu_torch.model.stats import ClusterModelStats, compute_stats
from cruise_control_tpu_torch.obsvc.convergence import convergence as _convergence
from cruise_control_tpu_torch.obsvc.execution import execution as _execution
from cruise_control_tpu_torch.obsvc.execution import path_histogram
from cruise_control_tpu_torch.obsvc.fidelity import fidelity as _fidelity
from cruise_control_tpu_torch.obsvc.memory import SUBSYS_LANES, measure_bytes, memory_ledger
from cruise_control_tpu_torch.parallel.mesh import SCENARIO_AXIS, all_gather

LOG = logging.getLogger(__name__)

# Balancedness weights (reference: KafkaCruiseControlUtils.java:734-762 —
# goal-violation weights used for the balancedness score gauge).
_BALANCEDNESS_WEIGHT_HARD = 3.0
_BALANCEDNESS_WEIGHT_SOFT = 1.0

# Sensors of a solve cut short by its budget (the JAX package's names).
PARTIAL_SOLVES_SENSOR = "Solver.partial-solves"
PREEMPTIONS_SENSOR = "Solver.preemptions"
CANCELLATIONS_SENSOR = "Solver.cancellations"
PREEMPTION_SENSORS = (PARTIAL_SOLVES_SENSOR, PREEMPTIONS_SENSOR, CANCELLATIONS_SENSOR)


def _changed_partitions(part_ids: torch.Tensor, a: Placement, b: Placement) -> set:
    """Partition ids whose placement (broker, leadership or disk) differs
    between two placements: the execution observatory's per-goal attribution
    diff.  The mask is computed on the placements' device; only the changed
    ids come back to the host."""
    n = part_ids.shape[0]
    changed = ((a.broker[:n] != b.broker[:n]) | (a.is_leader[:n] != b.is_leader[:n])
               | (a.disk[:n] != b.disk[:n]))
    return set(torch.unique(part_ids[changed]).tolist())


def _provenance(goal_name: str, info: GoalOptimizationInfo) -> Dict:
    """One goal pass's provenance record without its path (plain Python
    numbers: the server renders it with ``json.dumps``)."""
    return {"goal": goal_name, "round": int(info.rounds),
            "costDelta": round(float(info.metric_after - info.metric_before)
                               / max(int(info.moves_applied), 1), 6)}


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
    # Model-fidelity fingerprint of the snapshot this result was solved
    # from (fidelity observatory; None when the recorder is off).  Stamped
    # after the solve, never part of the proposal cache key.
    fingerprint: Optional[Dict] = None

    @property
    def summary(self) -> ProposalSummary:
        return ProposalSummary.of(self.proposals)

    def to_dict(self, explain: bool = False) -> Dict:
        s = self.summary
        d = {
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
            "onDemandBalancednessScoreBefore": None,
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
        if explain:
            # ?explain=true: per-proposal provenance (goal / path / solve
            # round / cost delta) plus the path histogram rollup and the
            # model-fidelity fingerprint the solve was decided on.
            d["proposals"] = [p.to_dict(explain=True) for p in self.proposals]
            d["provenancePaths"] = path_histogram(self.proposals)
            d["modelFingerprint"] = self.fingerprint
        return d


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
    # The memory ledger's headroom guard refused the dispatch: no lane ran
    # (no goal columns, stranded -1, placements the seed).
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
    eligible goals (off when None).  ``mesh`` (a
    :class:`~cruise_control_tpu_torch.parallel.mesh.SolverMesh`) shards every
    solve's reductions over R across its replica groups and what-if lanes
    across its scenario groups; every rank of the mesh must make the same
    calls with the same inputs."""

    def __init__(
        self,
        constraint: Optional[BalancingConstraint] = None,
        goal_names: Optional[Sequence[str]] = None,
        solver: Optional[GoalSolver] = None,
        polish_passes: int = 1,
        relaxation: Optional[relax.RelaxationConfig] = None,
        mesh=None,
    ):
        self.constraint = constraint or BalancingConstraint()
        self.goal_names = list(goal_names or DEFAULT_GOALS)
        self.solver = solver or GoalSolver(
            max_candidates_per_round=self.constraint.max_candidates_per_round,
            max_rounds_per_goal=self.constraint.max_rounds_per_goal,
            mesh=mesh,
        )
        # Post-stack re-solve passes for re-violated soft goals (0 disables).
        self.polish_passes = polish_passes
        if relaxation is not None and self.solver.mesh is not None and self.solver.mesh.size > 1:
            # Its rounding waves keep moves from each rank's own float sums,
            # which the ranks of a mesh do not agree on.
            raise ValueError("the relaxation path takes no mesh of several ranks")
        self.relaxation = relaxation
        self._cache_lock = threading.Lock()
        self._cached: Dict[Tuple, OptimizerResult] = {}
        # Materialize the preemption sensor family (and the relaxation's,
        # where it is on) at 0: a scrape sees them before the first partial
        # or relaxed solve.
        for s in PREEMPTION_SENSORS:
            registry().counter(s)
        if relaxation is not None:
            relax.relax_sensors()

    def _use_relax(self, goal: Goal, budget) -> bool:
        """The relaxation path is taken where it is on, for eligible goals,
        and never under a segmented budget (its preemption seams have no
        relax equivalent); cancel-only budgets take it."""
        return (self.relaxation is not None and goal.relax_eligible
                and (budget is None or not budget.segmented))

    def _check_budget(self, budget) -> None:
        """A budget's verdict is read from each process's own clock, so ranks
        of one mesh could stop at different goals and then wait on each
        other's collectives: a multi-rank mesh takes no budget."""
        mesh = self.solver.mesh
        if budget is not None and mesh is not None and mesh.size > 1:
            raise ValueError("a solve on a mesh of several ranks takes no budget")

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
        reg = registry()
        proposal_timer = reg.timer("GoalOptimizer.proposal-computation-timer")
        self._check_budget(budget)
        gctx = build_context(state, placement, meta, self.constraint, options)
        gctx, placement = self.solver.shard_inputs(gctx, placement)
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

        # Provision gauges (AnomalyDetectorManager.java:173-192): a hard-goal
        # optimization failure marks the cluster under-provisioned.
        prov_under = reg.settable_gauge("AnomalyDetector.under-provisioned")
        prov_right = reg.settable_gauge("AnomalyDetector.right-sized")
        reg.settable_gauge("AnomalyDetector.over-provisioned")

        infos: List[GoalOptimizationInfo] = []
        priors: List[Goal] = []
        agg = agg0
        preempt_reason = None
        # Execution observatory: per-partition move provenance from the
        # placements bracketing each goal (and polish) pass.  Off the
        # solver's path: the same device work with the recorder on or off;
        # each pass adds one diff and one copy of the changed partition ids.
        exec_rec = _execution()
        prov_map: Optional[Dict[int, dict]] = None
        if exec_rec.enabled:
            prov_map = {}
            part_ids = state.partition[:meta.num_replicas]
            prev = placement
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
            rounded, info.rounded = info.rounded, None
            if prov_map is not None:
                # Attribute this goal's placement changes.  A relaxed pass
                # diffs three ways through its post-rounding placement:
                # changed only before it = relax, only after = greedy repair,
                # both = rounding.  Everything else (plain greedy, fallback)
                # is one greedy diff.  The last writer wins across goals.
                base = _provenance(info.goal_name, info)
                if rounded is not None:
                    pre = _changed_partitions(part_ids, prev, rounded)
                    post = _changed_partitions(part_ids, rounded, placement)
                    for p in pre | post:
                        path = ("rounding" if p in pre and p in post
                                else "relax" if p in pre else "repair")
                        prov_map[p] = dict(base, path=path)
                else:
                    for p in _changed_partitions(part_ids, prev, placement):
                        prov_map[p] = dict(base, path="greedy")
                prev = placement
            if info.preempted:
                # A mid-goal preemption: the placement is the best found so
                # far.  The hard-goal and no-worsen verdicts judge converged
                # solves, and a partial result may carry residual violations.
                preempt_reason = info.preempt_reason
                continue
            # Goals that cannot relocate replicas across brokers are not
            # responsible for dead-broker evacuation.
            stranded = info.stranded_after if goal.is_hard and goal.uses_replica_moves else 0
            try:
                check_hard_goal(goal, info, stranded)
            except OptimizationFailureError:
                prov_under.set(1)
                prov_right.set(0)
                raise
            worsened = (info.rounds > 0 and info.metric_after
                        > info.metric_before * (1 + 1e-5) + 1e-9)
            if worsened and not has_broken:
                prov_under.set(1)
                prov_right.set(0)
                raise OptimizationFailureError(
                    f"[{goal.name}] optimized result is worse than before: "
                    f"{info.metric_before:.6g} -> {info.metric_after:.6g}")
            elif worsened:
                LOG.warning("goal %s metric worsened during evacuation: "
                            "%.6g -> %.6g", goal.name,
                            info.metric_before, info.metric_after)
            priors.append(goal)
        prov_under.set(0)
        prov_right.set(1)
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
                if prov_map is not None:
                    # Polish re-solves are greedy repairs of a soft goal's
                    # band; their moves overwrite earlier attribution.
                    base = _provenance(goal.name, pinfo)
                    for p in _changed_partitions(part_ids, prev, placement):
                        prov_map[p] = dict(base, path="greedy")
                    prev = placement
                for inf in infos:
                    if inf.goal_name == goal.name:
                        inf.rounds += pinfo.rounds
                        inf.moves_applied += pinfo.moves_applied
                        inf.violated_brokers_after = pinfo.violated_brokers_after
                        inf.metric_after = pinfo.metric_after

        # Per-goal convergence sensors: final rounds and moves of each goal.
        for inf in infos:
            reg.settable_gauge(f"Solver.{inf.goal_name}.rounds").set(inf.rounds)
            reg.settable_gauge(f"Solver.{inf.goal_name}.moves").set(inf.moves_applied)
        solve_id = _convergence().record_solve(
            [{"goal": inf.goal_name, "curve": inf.round_curve,
              "metric_before": inf.metric_before, "rounds": inf.rounds,
              "moves": inf.moves_applied,
              **({"relax_ms": round(inf.relax_ms, 3),
                  "repair_rounds": inf.repair_rounds,
                  "relax_fallback": inf.relax_fallback}
                 if inf.relaxed else {})} for inf in infos],
            kind="propose" if not partial else "propose-partial",
            attrs={"generation": model_generation,
                   **({"preempted": preempt_reason} if partial else {})})
        if partial:
            reg.counter(PARTIAL_SOLVES_SENSOR).inc()
            reg.counter(PREEMPTIONS_SENSOR).inc(sum(1 for inf in infos if inf.preempted))
            if budget is not None and budget.cancelled():
                reg.counter(CANCELLATIONS_SENSOR).inc()

        # `agg` is exact here: every solve returns a fresh full recompute and
        # the placement has not changed since the last one.
        vio_n = self.solver.violations(goals, gctx, placement, agg)
        violated_after = [g.name for g, v in zip(goals, vio_n) if v > 0]
        stats_after = compute_stats(state, placement, self.constraint.balance_threshold)
        if prov_map is not None:
            # The convergence recorder's solve id exists only now (it records
            # after the goal loop), so the records back-reference it here;
            # None when round recording is off.
            for rec in prov_map.values():
                rec["solveId"] = solve_id
        proposals = diff_proposals(state, initial, placement, meta, provenance=prov_map)
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
        proposal_timer.update_ms(result.elapsed_s * 1000.0)
        # Fidelity observatory: stamp the solve-time model fingerprint onto
        # the result and every proposal (host dicts, compare=False fields,
        # never part of the proposal cache key).  Stamped before the cache
        # write so a cached result keeps the fingerprint of its own model.
        fid = _fidelity()
        if fid.enabled:
            fp = fid.current_fingerprint()
            if fp is not None:
                result.fingerprint = fp
                for p in proposals:
                    object.__setattr__(p, "fingerprint", fp)
        reg.settable_gauge("AnomalyDetector.balancedness-score").set(
            result.balancedness_score)
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
        """The lane runner behind both what-if kinds, routed through the
        compile service's lane-chunk plan (the JAX package's
        ``_run_mask_scenarios``): an S-lane batch is split into blocks at the
        lane widths already run (or canonical ladder widths), padding lanes
        duplicate the last real lane's masks and are trimmed from the
        result, and the memory ledger's headroom guard may shrink the plan
        onto narrower blocks or refuse the dispatch (``memory_refused``).  On
        a mesh the lanes split over its scenario groups instead
        (:meth:`_run_scenario_groups`)."""
        options = options or OptimizationOptions()
        goals = (list(goals) if goals is not None
                 else get_goals_by_priority(self.goal_names))
        # The context is built from the BASE placement either way: it only
        # feeds placement-independent statics; every lane recomputes its
        # aggregates from its own (possibly warm-started) placement.
        gctx = build_context(state, placement, meta, self.constraint, options)
        alive_s, excl_move_s, excl_lead_s = _scenario_masks(gctx, state, meta, scenario_sets,
                                                            revive)
        seed = placement if warm_start is None else warm_start
        s_n = len(scenario_sets)
        sets = [list(map(int, ids)) for ids in scenario_sets]
        if self.solver.mesh is not None:
            self._check_budget(budget)
            gctx, seed = self.solver.shard_inputs(gctx, seed)
            rounds, moves, violated, stranded, placements = self._run_scenario_groups(
                gctx, seed, goals, num_candidates, alive_s, excl_move_s, excl_lead_s,
                budget)
        else:
            got = self._run_planned(gctx, state, seed, goals, num_candidates, alive_s,
                                    excl_move_s, excl_lead_s, budget)
            if got is None:
                return BatchScenarioResult(
                    scenario_sets=sets, goal_names=[],
                    violated_after=np.zeros((s_n, 0), np.int32),
                    moves=np.zeros((s_n, 0), np.int32),
                    rounds=np.zeros((s_n, 0), np.int32),
                    stranded_after=np.full(s_n, -1, np.int32),
                    final_placements=Placement(
                        broker=seed.broker.expand(s_n, -1), disk=seed.disk.expand(s_n, -1),
                        is_leader=seed.is_leader.expand(s_n, -1)),
                    preempted=True, memory_refused=True)
            rounds, moves, violated, stranded, placements = got
        preempted = rounds.shape[1] < len(goals)
        if preempted:
            registry().counter(PREEMPTIONS_SENSOR).inc()
            registry().counter(PARTIAL_SOLVES_SENSOR).inc()
            if budget is not None and budget.cancelled():
                registry().counter(CANCELLATIONS_SENSOR).inc()
        # Per-lane early-exit rounds: the [S, G] rounds matrix every batch
        # returns is the per-lane convergence story the recorder keeps.
        _convergence().record_batch([g.name for g in goals[:rounds.shape[1]]], rounds,
                                    warm_start=warm_start is not None)
        return BatchScenarioResult(
            scenario_sets=sets,
            goal_names=[g.name for g in goals[:rounds.shape[1]]],
            violated_after=violated,
            moves=moves,
            rounds=rounds,
            stranded_after=stranded,
            final_placements=placements,
            preempted=preempted,
        )

    def _run_planned(self, gctx, state, seed, goals, num_candidates, alive_s,
                     excl_move_s, excl_lead_s, budget):
        """An unsharded batch through the compile service's lane-chunk plan and
        the memory ledger's headroom guard: (rounds, moves, violated,
        stranded, placements), or None when the guard refuses it."""
        s_n = alive_s.shape[0]
        svc = compile_service()
        lane_key = svc.lane_key([g.name for g in goals], state.num_replicas_padded,
                                state.num_brokers_padded, num_candidates)
        plan = svc.plan_lanes(s_n, lane_key)
        # Headroom guard: the cost ledger projects peak bytes for the plan's
        # widest lane block; a projection over the headroom fraction of the
        # device budget re-chunks onto narrower widths, and when nothing fits
        # the dispatch is refused outright.
        c = min(num_candidates, state.num_replicas_padded)
        plan, refused = memory_ledger().guard_lane_plan(
            plan, s_n, f"R{state.num_replicas_padded}-C{c}", svc.policy.lane_ladder,
            compiled_widths=svc.compiled_lane_widths(lane_key))
        if refused:
            return None
        blocks = []
        # Once the budget preempts a block mid-stack, later blocks run only
        # the same solved-goal prefix so every block's [S, G] stats stay
        # column-aligned (their lanes still need placements).
        goal_limit = len(goals)
        for chunk in plan:
            # The block's lane masks span its planned width (padding rows
            # repeat the last real lane), which keys its dispatches and cost
            # rows as the JAX package's vmapped width does; only its real
            # lanes are solved.
            idx = torch.as_tensor(np.minimum(chunk.start + np.arange(chunk.size), s_n - 1),
                                  device=alive_s.device)
            out = self._run_lane_block(gctx, seed, goals[:goal_limit], num_candidates,
                                       alive_s[idx], excl_move_s[idx], excl_lead_s[idx],
                                       budget, chunk.n_real)
            goal_limit = min(goal_limit, out[0].shape[1])
            svc.note_lanes_compiled(lane_key, chunk.size)
            blocks.append(out)
        rounds, moves, violated = (
            np.concatenate([b[i][:, :goal_limit] for b in blocks], axis=0) for i in range(3))
        stranded = np.concatenate([b[3] for b in blocks], axis=0)
        placements = Placement(**{f: torch.cat([getattr(b[4], f) for b in blocks])
                                  for f in ("broker", "disk", "is_leader")})
        return rounds, moves, violated, stranded, placements

    def _run_scenario_groups(self, gctx, seed, goals, num_candidates, alive_s,
                             excl_move_s, excl_lead_s, budget):
        """A batch on the mesh (the JAX package's ``scenario_shardings``): the
        S lanes split into contiguous groups of g = ceil(S / scenario axis),
        one per scenario coordinate; this rank's replica group solves its
        coordinate's lanes, and one all-gather over the scenario group gives
        every rank every lane (where the JAX package gathers its global
        arrays with ``_host_local_placement``).  As in the JAX package, mesh runs are never
        chunked by the lane planner, and the headroom guard judges unsharded
        runs only.  Returns what :meth:`_run_planned` does."""
        mesh = self.solver.mesh
        s_n = alive_s.shape[0]
        n_groups = mesh.shape[SCENARIO_AXIS]
        g = -(-s_n // n_groups)

        def real(k):
            return max(0, min(s_n, (k + 1) * g) - k * g)

        k = mesh.coords()[0]
        n_real = real(k)
        n_goals, r_pad = len(goals), seed.broker.shape[0]
        dev = seed.broker.device
        # This coordinate's lanes as one i32 block: per lane rounds, moves and
        # violated for every goal, stranded, then broker, disk and leadership.
        block = torch.zeros((g, 3 * n_goals + 1 + 3 * r_pad), dtype=torch.int32, device=dev)
        if n_real:
            idx = torch.as_tensor(np.minimum(k * g + np.arange(g), s_n - 1),
                                  device=alive_s.device)
            rounds, moves, violated, stranded, pl = self._run_lane_block(
                gctx, seed, goals, num_candidates, alive_s[idx], excl_move_s[idx],
                excl_lead_s[idx], budget, n_real)
            n_goals = rounds.shape[1]
            block = block[:, :3 * n_goals + 1 + 3 * r_pad].contiguous()
            stats = np.concatenate([rounds, moves, violated, stranded[:, None]], axis=1)
            block[:n_real, :3 * n_goals + 1] = torch.as_tensor(stats, device=dev)
            block[:n_real, 3 * n_goals + 1:] = torch.cat(
                [pl.broker, pl.disk, pl.is_leader.to(torch.int32)], dim=1)
        got = all_gather(block, mesh.scenario_group, n_groups)      # [groups, g, W]
        lanes = torch.cat([got[j, :real(j)] for j in range(n_groups)])
        host = lanes[:, :3 * n_goals + 1].cpu().numpy()
        rounds, moves, violated = (np.ascontiguousarray(host[:, i * n_goals:(i + 1) * n_goals])
                                   for i in range(3))
        pl = lanes[:, 3 * n_goals + 1:]
        placements = Placement(broker=pl[:, :r_pad].contiguous(),
                               disk=pl[:, r_pad:2 * r_pad].contiguous(),
                               is_leader=pl[:, 2 * r_pad:].to(torch.bool))
        return rounds, moves, violated, np.ascontiguousarray(host[:, -1]), placements

    def _run_lane_block(self, gctx, seed: Placement, goals, num_candidates,
                        alive_s, excl_move_s, excl_lead_s, budget, n_real):
        """Ledgered wrapper over :meth:`_run_lanes`: the block's lane tensors
        (per-lane masks and the real lanes' placements) are the transient
        device bill of a what-if batch, posted to the ``lane-batch``
        subsystem for the block's lifetime."""
        ledger = memory_ledger()
        lane_bytes = 0
        if ledger.enabled:
            lane_bytes = (measure_bytes((alive_s, excl_move_s, excl_lead_s))
                          + n_real * measure_bytes(seed))
            ledger.post(SUBSYS_LANES, lane_bytes, kind="alloc")
        try:
            return self._run_lanes(gctx, seed, goals, num_candidates, alive_s, excl_move_s,
                                   excl_lead_s, budget, n_real)
        finally:
            if ledger.enabled:
                ledger.post(SUBSYS_LANES, lane_bytes, kind="free")

    def _run_lanes(self, gctx, seed: Placement, goals, num_candidates,
                   alive_s, excl_move_s, excl_lead_s, budget, n_real):
        """One lane block (the JAX package's ``_run_lane_block_impl``), goal
        by goal: every lane finishes goal g before any lane starts goal g+1,
        so a budget cuts every lane at the same goal prefix, at least one
        goal always runs, and the [S, G] stats stay column-aligned.  Each
        lane runs its own context (:func:`scenario_context`) at candidate
        width ``min(num_candidates, R_pad)`` from fresh aggregates of its own
        placement, one lane after another.  Each goal is one solver dispatch
        over the block (the JAX package's vmapped ``("batch", goal, priors,
        C)`` family, labelled ``R<R>-C<C>-L<S>`` at the block's width S),
        preceded on the relaxation path by the ``("relax", "frac-batch", …)``
        one.  Only the first ``n_real`` lanes are solved: the rest are
        padding, whose seed placements stand in the dispatch's outputs.
        Returns (rounds, moves, violated after: i32[n_real, G]; stranded
        after the last goal: i32[n_real]; the stacked final placements)."""
        s_n = alive_s.shape[0]
        r_pad = gctx.state.num_replicas_padded
        c = min(num_candidates, r_pad)
        dev = gctx.state.device
        lanes = [scenario_context(gctx, alive_s[s], excl_move_s[s], excl_lead_s[s])
                 for s in range(n_real)]
        placements = [seed] * s_n
        stats = []                       # per goal: [n_real] rows of (rounds, moves, violated)
        stranded = np.zeros(n_real, dtype=np.int32)
        priors: List[Goal] = []
        for goal in goals:
            # Goal-boundary budget check: at least one goal always runs so
            # every lane has a solved placement to return.
            if budget is not None and priors and budget.should_stop():
                break
            prior_keys = tuple(g.name for g in priors)
            if self._use_relax(goal, budget):
                # Each lane's placement becomes its rounded relaxation; the
                # greedy solve below is the lane's repair pass.
                k = relax.relax_width(self.relaxation, r_pad, num_candidates)
                key = ("relax", "frac-batch", goal.name, prior_keys, k, self.relaxation.waves)
                with self.solver.dispatch(
                        f"R{r_pad}-C{k}-X", [key],
                        (gctx, alive_s, excl_move_s, excl_lead_s, placements), dev,
                        label=f"R{r_pad}-C{k}-X-L{s_n}") as d:
                    placements = [
                        relax.relax_round(goal, priors, lctx, pl, compute_aggregates(lctx, pl),
                                          k, self.relaxation.waves,
                                          self.relaxation.iterations)[0]
                        for lctx, pl in zip(lanes, placements)] + placements[n_real:]
                    d.outputs = placements
            column = []
            with self.solver.dispatch(
                    f"R{r_pad}-C{c}", [("batch", goal.name, prior_keys, c)],
                    (gctx, alive_s, excl_move_s, excl_lead_s, placements), dev,
                    label=f"R{r_pad}-C{c}-L{s_n}") as d:
                for s, lctx in enumerate(lanes):
                    pl, _, info = self.solver.optimize_goal(
                        goal, priors, lctx, placements[s],
                        compute_aggregates(lctx, placements[s]), width=c)
                    placements[s] = pl
                    column.append((info.rounds, info.moves_applied,
                                   info.violated_brokers_after))
                    stranded[s] = info.stranded_after
                d.outputs = placements
            stats.append(column)
            priors.append(goal)
        table = np.asarray(stats, dtype=np.int32).reshape(len(stats), n_real, 3)
        rounds, moves, violated = (np.ascontiguousarray(table[:, :, i].T) for i in range(3))
        solved = placements[:n_real]
        stacked = Placement(broker=torch.stack([p.broker for p in solved]),
                            disk=torch.stack([p.disk for p in solved]),
                            is_leader=torch.stack([p.is_leader for p in solved]))
        return rounds, moves, violated, stranded, stacked
