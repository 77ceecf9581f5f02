"""Optimization verifier: the parity oracle (the JAX package's
``testing/verifier.py``).

Port of ``cruise-control/src/test/java/com/linkedin/kafka/cruisecontrol/
analyzer/OptimizationVerifier.java`` (:1-345): run a goal list by priority
over a model, then verify postconditions.  The reference's Verification enums
map to the checks here:

- GOAL_VIOLATION  → every hard goal satisfied; soft goals did not regress.
- NEW_BROKERS     → (add-broker runs) original brokers keep only original replicas.
- DEAD_BROKERS    → no replica remains on a dead broker / dead disk.
- REGRESSION      → per-goal stats comparator says "not worse" (AbstractGoal:108-117).
- Load invariants → broker loads equal the segment-sums of replica loads
                    (the ClusterModel.sanityCheck analog, vectorized).

The checks run on whatever device the tensors are on (``compute_aggregates``
launches the aggregate kernel on the card); the load-consistency recompute
reads the tensors back with ``.cpu()`` and runs in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import (
    build_context,
    compute_aggregates,
    currently_offline,
)
from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer, OptimizerResult
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.model import ops
from cruise_control_tpu_torch.model.state import ClusterMeta, ClusterState, Placement


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


@dataclass
class VerificationFailure(AssertionError):
    check: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.detail}"


@dataclass
class VerifyReport:
    result: OptimizerResult
    failures: List[VerificationFailure] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


def verify_placement(
    state: ClusterState,
    placement: Placement,
    meta: ClusterMeta,
    final: Placement,
    goal_names: Sequence[str] = (),
    constraint: Optional[BalancingConstraint] = None,
    options: Optional[OptimizationOptions] = None,
    verifications: Sequence[str] = ("GOAL_VIOLATION", "DEAD_BROKERS", "REGRESSION"),
    goal_infos: Sequence = (),
) -> List[VerificationFailure]:
    """Postcondition checks over an arbitrary ``final`` placement.

    The standalone oracle behind :func:`execute_goals_for`: callers that
    already hold a solved (or deliberately broken) placement verify it
    directly without re-running the optimizer.  Every violated check is
    reported (the list accumulates; nothing short-circuits), so a multi-way
    breakage names all of its causes at once.  ``goal_infos`` feeds the
    REGRESSION comparator and may be empty when no per-goal stats exist.
    """
    constraint = constraint or BalancingConstraint()
    options = options or OptimizationOptions()
    failures: List[VerificationFailure] = []
    gctx = build_context(state, placement, meta, constraint, options)
    agg = compute_aggregates(gctx, final)

    if "GOAL_VIOLATION" in verifications:
        for name in goal_names:
            goal = goal_by_name(name)
            if goal.is_hard:
                n = int(goal.violated_brokers(gctx, final, agg).sum())
                if n:
                    failures.append(VerificationFailure(
                        "GOAL_VIOLATION", f"hard goal {name} violated on {n} brokers"))

    if "DEAD_BROKERS" in verifications:
        stranded = int(currently_offline(gctx, final).sum())
        if stranded:
            failures.append(VerificationFailure(
                "DEAD_BROKERS", f"{stranded} replicas still on dead brokers/disks"))

    if "REGRESSION" in verifications:
        for info in goal_infos:
            if info.rounds > 0 and info.metric_after > info.metric_before * (1 + 1e-5):
                failures.append(VerificationFailure(
                    "REGRESSION",
                    f"{info.goal_name} metric worsened "
                    f"{info.metric_before:.6g} -> {info.metric_after:.6g}"))

    if "NEW_BROKERS" in verifications and bool(state.new_broker.any()):
        # Replicas may only move TO new brokers; old brokers keep originals.
        # Vacuous without new brokers (OptimizationVerifier.java:188 gates on
        # !clusterModel.newBrokers().isEmpty()).
        new_broker = _np(state.new_broker)
        final_broker = _np(final.broker)
        moved = (final_broker != _np(state.orig_broker)) & _np(state.valid)
        bad = moved & ~new_broker[final_broker]
        bad &= ~_np(currently_offline(gctx, placement))  # offline replicas may go anywhere alive
        n_bad = int(bad.sum())
        if n_bad:
            failures.append(VerificationFailure(
                "NEW_BROKERS", f"{n_bad} healthy replicas moved to non-new brokers"))

    # Load-consistency invariant (ClusterModel.sanityCheck analog): the
    # segment-sum per-broker loads must match an independent numpy recompute
    # from the final placement.
    bl = _np(ops.broker_load(state, final))
    eff = np.where(_np(final.is_leader)[:, None], _np(state.leader_load),
                   _np(state.follower_load))
    eff = eff * _np(state.valid)[:, None]
    expect = np.zeros_like(bl)
    np.add.at(expect, _np(final.broker), eff)
    if not np.allclose(bl, expect, rtol=1e-4, atol=1e-3):
        failures.append(VerificationFailure(
            "LOAD_CONSISTENCY", "per-broker loads != numpy recompute from placement"))

    return failures


def execute_goals_for(
    state: ClusterState,
    placement: Placement,
    meta: ClusterMeta,
    goal_names: Sequence[str],
    constraint: Optional[BalancingConstraint] = None,
    options: Optional[OptimizationOptions] = None,
    verifications: Sequence[str] = ("GOAL_VIOLATION", "DEAD_BROKERS", "REGRESSION"),
) -> VerifyReport:
    """Run goals and verify (reference: OptimizationVerifier.executeGoalsFor)."""
    constraint = constraint or BalancingConstraint()
    options = options or OptimizationOptions()
    optimizer = GoalOptimizer(constraint=constraint, goal_names=list(goal_names))
    result = optimizer.optimizations(state, placement, meta, options=options)
    report = VerifyReport(result=result)
    report.failures.extend(verify_placement(
        state, placement, meta, result.final_placement,
        goal_names=goal_names, constraint=constraint, options=options,
        verifications=verifications, goal_infos=result.goal_infos))
    return report
