"""Convex-relaxation path: fractional solve + wave rounding, greedy demoted
to integer repair (the JAX package's ``analyzer/relax.py``).

The greedy loop converges a distribution goal by iterated batched rounds.
For the resource- and count-distribution families the objective is
analytically simple: each broker carries one scalar channel (a resource's
load, a replica count) and the goal wants every alive broker's channel near
the cluster average.  That lowers to a continuous assignment problem:

1. **Fractional solve** — pick the K highest-priority movable replicas (the
   same candidate score the greedy phase uses, ties to the lower row), give
   each a row of fractional mass ``X[k, b] >= 0, sum_b X[k, b] = 1`` over its
   structurally feasible destinations (``base_replica_move_ok`` plus its own
   broker), and minimize the capacity-normalized squared residual
   ``sum_b ((fixed_b + sum_k w_k X[k, b] - target_b) / scale_b)^2`` by entropic
   mirror descent (logits accumulate the normalized rank-1 gradient, softmax
   projects back onto the simplex).

2. **Wave rounding** — each wave sends every unsettled candidate to its
   argmax-mass destination (the first on ties), but only where the move
   passes the same acceptance chain the greedy loop enforces (structural +
   every prior goal's acceptance + this goal's self-check, against current
   aggregates) and wins its partition / destination / source / host group.
   Vetoed destinations are masked and the next wave tries the runner-up, so
   rounding never worsens a previously optimized goal.

3. **Greedy repair** — the rounded placement goes to the normal greedy
   solve as a warm start; if the result is worse for the goal than the
   original placement, the pass falls back to plain greedy from it.

The path is taken only where a :class:`RelaxationConfig` is given to the
optimizer, for ``relax_eligible`` goals, and never under a segmented budget.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from cruise_control_tpu_torch.analyzer.context import (
    Aggregates,
    GoalContext,
    apply_replica_moves_batch,
    base_replica_move_ok,
    compute_aggregates,
)
from cruise_control_tpu_torch.analyzer.goals.base import Goal
from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.analyzer.solver import (
    _SCORE_FLOOR,
    GoalOptimizationInfo,
    GoalSolver,
    _chain_accept_replica,
    _group_winners,
    _pick_dst_disk,
    _top_candidates,
)
from cruise_control_tpu_torch.model.ops import segment_sum
from cruise_control_tpu_torch.model.state import Placement
from cruise_control_tpu_torch.obsvc.tracer import tracer

# Mirror-descent step in logit space per (normalized) iteration: the
# gradient is normalized to unit max, so total logit travel is bounded by
# step * iterations.
_MD_STEP = 1.0
# Initial preference for staying home: the start sits near the current
# placement instead of uniform, so barely-over brokers shed only what the
# objective asks for.
_HOME_BIAS = 1.0
_NEG_INF = -1e30

# The relaxation's sensors (the JAX package's names).
ATTEMPTS_SENSOR = "Solver.relax.attempts"
FALLBACKS_SENSOR = "Solver.relax.fallbacks"
REPAIR_ROUNDS_SENSOR = "Solver.relax.repair-rounds"
QUALITY_DELTA_SENSOR = "Solver.relax.quality-delta"
FRACTIONAL_MOVES_SENSOR = "Solver.relax.fractional-moves"


def relax_sensors() -> None:
    """Materialize the Solver.relax.* family (at 0) so a scrape sees it
    before the first relaxed solve."""
    reg = registry()
    reg.counter(ATTEMPTS_SENSOR)
    reg.counter(FALLBACKS_SENSOR)
    reg.settable_gauge(REPAIR_ROUNDS_SENSOR)
    reg.settable_gauge(QUALITY_DELTA_SENSOR)
    reg.settable_gauge(FRACTIONAL_MOVES_SENSOR)


@dataclass(frozen=True)
class RelaxationConfig:
    """The relaxation path's parameters (the JAX package's
    ``solver.relaxation.*``, same defaults).  ``tolerance`` is carried as
    the JAX package carries it: it joins the result-cache key only."""

    iterations: int = 48
    candidates: int = 4096
    waves: int = 4
    tolerance: float = 0.05

    def __post_init__(self):
        if min(self.iterations, self.candidates, self.waves) < 1 or self.tolerance < 0:
            raise ValueError(f"invalid relaxation parameters: {self}")


@dataclass
class RelaxTile:
    """The fractional problem of one goal: K candidate rows over B brokers."""

    cand: torch.Tensor      # i64[K] replica rows, best first
    is_cand: torch.Tensor   # bool[K]
    w: torch.Tensor         # f32[K] each candidate's mass in the channel
    fixed: torch.Tensor     # f32[B] channel load without the candidates' mass
    target: torch.Tensor    # f32[B]
    inv_s2: torch.Tensor    # f32[B] 1 / scale^2
    mask: torch.Tensor      # bool[K, B] feasible destinations and home
    z0: torch.Tensor        # f32[K, B] initial logits


def relax_tile(goal: Goal, gctx: GoalContext, placement: Placement,
               agg0: Aggregates, k: int) -> RelaxTile:
    """The candidate tile (the greedy move phase's priority order), the
    channel and the feasible-destination mask of one goal."""
    state = gctx.state
    b = state.num_brokers_padded
    top_score, cand = _top_candidates(goal.candidate_score(gctx, placement, agg0), k,
                                      gctx.shard)
    is_cand = top_score > _SCORE_FLOOR
    src0 = placement.broker[cand]
    w = torch.where(is_cand, goal.relax_weights(gctx, placement)[cand], 0.0)
    load, target, scale = goal.relax_channel(gctx, agg0)
    fixed = load - segment_sum(w, src0, b)
    inv_s2 = 1.0 / torch.clamp(scale, min=1e-9) ** 2
    b_ids = torch.arange(b, dtype=torch.int32, device=cand.device)
    feas = base_replica_move_ok(gctx, placement, cand[:, None],
                                b_ids[None, :]) & is_cand[:, None]
    home = b_ids[None, :] == src0[:, None]
    mask = feas | home                     # the home column keeps softmax finite
    z0 = torch.where(mask, torch.where(home, _HOME_BIAS, 0.0), _NEG_INF)
    return RelaxTile(cand=cand, is_cand=is_cand, w=w, fixed=fixed, target=target,
                     inv_s2=inv_s2, mask=mask, z0=z0.to(torch.float32))


def mirror_descent(tile: RelaxTile, iters: int) -> torch.Tensor:
    """f32[K, B]: the logits after ``iters`` steps of entropic mirror
    descent on the row simplexes (``softmax`` of them is the fractional
    mass)."""
    w = tile.w
    w_max = torch.clamp(w.max(), min=1e-9)
    step = _MD_STEP * (w / w_max)[:, None]
    z = tile.z0
    for _ in range(iters):
        x = torch.softmax(z, dim=-1)
        chan = tile.fixed + w @ x
        g = 2.0 * (chan - tile.target) * tile.inv_s2
        g = g / torch.clamp(g.abs().max(), min=1e-12)
        z = torch.where(tile.mask, z - step * g[None, :], _NEG_INF)
    return z


def relax_round(goal: Goal, priors: Sequence[Goal], gctx: GoalContext,
                placement: Placement, agg0: Aggregates, k: int, waves: int,
                iters: int):
    """The fractional solve and its rounding waves (the JAX package's
    ``_relax_body`` but for its final recompute): (placement, aggregates
    carried through the waves, moves kept, violated brokers and stats metric
    before)."""
    state = gctx.state
    b = state.num_brokers_padded
    accept = _chain_accept_replica(priors)
    violated0 = goal.violated_brokers(gctx, placement, agg0).sum()
    metric0 = goal.stats_metric(gctx, placement, agg0)
    tile = relax_tile(goal, gctx, placement, agg0, k)
    z = mirror_descent(tile, iters)
    cand = tile.cand
    agg = agg0
    settled = ~tile.is_cand
    moves = torch.zeros((), dtype=torch.int64, device=cand.device)
    kidx = torch.arange(cand.shape[0], device=cand.device)
    b_ids = torch.arange(b, device=cand.device)
    for _ in range(waves):
        dst = torch.argmax(z, dim=-1).to(torch.int32)
        src = placement.broker[cand]
        want = ~settled & (dst != src)
        ok = (want & accept(gctx, placement, agg, cand, dst)
              & goal.self_ok(gctx, placement, agg, cand, dst))
        order = torch.where(ok, kidx, cand.shape[0])
        keep = (ok
                & _group_winners(order, state.partition[cand], gctx.num_partitions)
                & _group_winners(order, dst, b)
                & _group_winners(order, src, b)
                & _group_winners(order, state.host[dst], gctx.num_hosts))
        dd = _pick_dst_disk(gctx, agg, dst)
        dst_eff = torch.where(keep, dst, src)
        dd_eff = torch.where(keep, dd, placement.disk[cand])
        placement, agg = apply_replica_moves_batch(gctx, placement, agg, cand,
                                                   dst_eff, dd_eff)
        moves = moves + keep.sum()
        # Settled: moved, or the mass already prefers home.  A vetoed
        # destination is masked so the next wave tries the runner-up.
        settled = settled | keep | (dst == src)
        veto = want & ~keep
        z = torch.where(veto[:, None] & (b_ids[None, :] == dst[:, None]), _NEG_INF, z)
    return placement, agg, moves, violated0, metric0


def relax_width(config: RelaxationConfig, num_replicas_padded: int,
                num_candidates: Optional[int] = None) -> int:
    """K of the candidate tile: the configured count, capped by the replica
    axis and, for what-if lanes, by the lanes' candidate width."""
    k = min(config.candidates, num_replicas_padded)
    return k if num_candidates is None else min(k, num_candidates)


def relax_dispatch(solver: GoalSolver, goal: Goal, priors: Sequence[Goal],
                   gctx: GoalContext, placement: Placement, agg: Aggregates,
                   config: RelaxationConfig):
    """:func:`relax_round` at the sequential path's width, as one solver
    dispatch through the JAX package's ``("relax", "frac", …)`` family (its
    ``-X`` buckets, apart from every greedy family)."""
    r_pad = gctx.state.num_replicas_padded
    k = relax_width(config, r_pad)
    key = ("relax", "frac", goal.name, tuple(g.name for g in priors), k, config.waves)
    with solver.dispatch(f"R{r_pad}-C{k}-X", [key], (gctx, placement, agg),
                         gctx.state.device) as d:
        out = relax_round(goal, priors, gctx, placement, agg, k, config.waves,
                          config.iterations)
        d.outputs = out[:2]
    return out


def optimize_goal_relaxed(solver: GoalSolver, goal: Goal, priors: Sequence[Goal],
                          gctx: GoalContext, placement: Placement,
                          agg: Optional[Aggregates], config: RelaxationConfig,
                          ) -> Tuple[Placement, Aggregates, GoalOptimizationInfo]:
    """Relax → round → greedy repair for one eligible goal; a drop-in for
    :meth:`GoalSolver.optimize_goal` on the unsegmented path.

    The returned info reports the whole pass against the pre-relax placement
    (metric/violated "before" from the original state, moves including the
    rounding waves', ``rounds`` the repair's) so the optimizer's hard-goal
    and no-worsen verdicts keep their meaning.  If the relaxed result
    regresses the goal, the pass falls back to plain greedy from the
    original placement: the path may only ever win."""
    if agg is None:
        agg = solver.aggregates(gctx, placement)
    t0 = time.monotonic()
    with tracer().span("solve.relax", goal=goal.name,
                       candidates=relax_width(config, gctx.state.num_replicas_padded),
                       waves=config.waves, iterations=config.iterations) as sp:
        rounded_pl, _, frac_moves, violated0, metric0 = relax_dispatch(
            solver, goal, priors, gctx, placement, agg, config)
        # Fresh aggregates clear the waves' incremental scatter drift before
        # the repair reads its "before" residuals from them.
        rounded_agg = compute_aggregates(gctx, rounded_pl)
        frac_moves, violated0, metric0 = torch.stack([
            frac_moves.to(torch.float64), violated0.to(torch.float64),
            metric0.to(torch.float64)]).tolist()
        sp.set("frac_moves", int(frac_moves))
    relax_ms = (time.monotonic() - t0) * 1000.0
    registry().counter(ATTEMPTS_SENSOR).inc()

    pl2, agg2, info = solver.optimize_goal(goal, priors, gctx, rounded_pl, rounded_agg)
    regressed = (info.violated_brokers_after > int(violated0)
                 or info.metric_after > metric0 * (1 + 1e-5) + 1e-9)
    if regressed:
        # The relaxation hurt this goal: discard it (the fallback pass is
        # plain greedy, and its info carries no rounded placement).
        registry().counter(FALLBACKS_SENSOR).inc()
        pl2, agg2, info = solver.optimize_goal(goal, priors, gctx, placement, agg)
        info.relaxed = True
        info.relax_fallback = True
        info.relax_ms = relax_ms
        return pl2, agg2, info
    info.relaxed = True
    info.relax_ms = relax_ms
    info.rounded = rounded_pl
    info.repair_rounds = info.rounds
    info.relax_moves = int(frac_moves)
    info.moves_applied += int(frac_moves)
    info.violated_brokers_before = int(violated0)
    info.metric_before = metric0
    registry().settable_gauge(REPAIR_ROUNDS_SENSOR).set(info.repair_rounds)
    registry().settable_gauge(FRACTIONAL_MOVES_SENSOR).set(int(frac_moves))
    registry().settable_gauge(QUALITY_DELTA_SENSOR).set(
        (metric0 - info.metric_after) / max(abs(metric0), 1e-9))
    return pl2, agg2, info
