#!/usr/bin/env python3
"""Does the port's propose at BASELINE config #3 give the same answer twice?

    python scripts/propose_repeatability.py [--device cuda|cpu] [--runs N] \
        [--order free|fixed-applies|fixed ...]

Generates BASELINE #3's random cluster (200 brokers, 10 racks, 1,000
topics, 50K replicas, seed 3140; ``bench.py:425-428``) and runs the port's
15-goal default stack on it ``--runs`` times for each reduction order, all
in one process.  Each run prints one JSON line: the soft goals violated
after (with their brokers), balancedness, proposals, moves, rounds per
goal, wall seconds, kernel launches, a digest of the final placement, and
the trail of digests after each goal's solve (the polish pass included),
which shows at which goal two runs part.  Before the runs of an order, one
line gives how many distinct bit patterns the aggregate recompute of the
initial placement yields over 20 calls.

Reduction orders (``--order``; on the CPU every sum is in a fixed order):

- ``free``: as the port ships.  The aggregate kernel's atomic adds and
  CUDA ``index_add`` (incremental applies, host and disk sums) add in no
  fixed order.
- ``fixed-applies``: the kernel as shipped; every ``index_add`` takes its
  deterministic CUDA path (``torch.use_deterministic_algorithms``).
- ``fixed``: as ``fixed-applies``, and the broker sums taken by the
  kernel's plain version (a deterministic ``index_add``) instead of the
  kernel, so every float sum on the card is in a fixed order.

A run that ends in an error prints the error instead of the quality.
"""

import argparse
import hashlib
import json
import os
import sys
import time
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASELINE3 = dict(num_brokers=200, num_racks=10, num_topics=1000,
                 num_replicas=50_000, mean_cpu=0.006, mean_disk=90.0,
                 mean_nw_in=90.0, mean_nw_out=90.0, seed=3140)
ORDERS = ("free", "fixed-applies", "fixed")
AGG_CALLS = 20


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:12]


def set_order(order: str):
    """Put the process in ``order``'s reduction mode."""
    import torch
    from cruise_control_tpu_torch.analyzer import context
    from cruise_control_tpu_torch.ops import aggregate
    torch.use_deterministic_algorithms(order != "free", warn_only=True)
    context.broker_channel_sums = (aggregate.broker_channel_sums_plain if order == "fixed"
                                   else aggregate.broker_channel_sums)


def run_order(props, device, order, runs, emit):
    """``runs`` proposes of the default stack on ``props``'s cluster in
    ``order``'s mode, one ``emit`` call each."""
    import torch
    from cruise_control_tpu_torch.analyzer import solver as S
    from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
    from cruise_control_tpu_torch.ops import aggregate
    from cruise_control_tpu_torch.testing import random_cluster as rc

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    set_order(order)
    st, pl, mt = rc.generate(rc.ClusterProperties(**props), device=device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gctx = build_context(st, pl, mt, BalancingConstraint(), OptimizationOptions())
        patterns = {digest(*(getattr(a, f) for f in a.__dataclass_fields__))
                    for a in (compute_aggregates(gctx, pl) for _ in range(AGG_CALLS))}
        emit(order=order, device=device, aggregate_calls=AGG_CALLS,
             distinct_aggregate_results=len(patterns))

        trail = []
        solve = S.GoalSolver.optimize_goal

        def recorded(self, goal, priors, gctx, placement, agg=None):
            out = solve(self, goal, priors, gctx, placement, agg)
            trail.append(f"{goal.name}:{digest(out[0].broker, out[0].disk, out[0].is_leader)}")
            return out

        S.GoalSolver.optimize_goal = recorded
        try:
            for i in range(runs):
                trail.clear()
                aggregate.LAUNCHES = 0
                t0 = time.monotonic()
                out = dict(order=order, device=device, run=i)
                try:
                    res = GoalOptimizer(goal_names=DEFAULT_GOALS).optimizations(st, pl, mt)
                except Exception as e:  # noqa: BLE001 - reported, not hidden
                    out.update(error=f"{type(e).__name__}: {e}", trail=list(trail))
                    emit(**out)
                    continue
                sync()
                doc = res.to_dict()
                fp = res.final_placement
                out.update(
                    wall_s=time.monotonic() - t0, kernel_launches=aggregate.LAUNCHES,
                    violated_goals_after={g["goal"]: g["violatedBrokersAfter"]
                                          for g in doc["goals"]
                                          if g["goal"] in res.violated_goals_after},
                    balancedness=res.balancedness_score, proposals=len(res.proposals),
                    replica_moves=doc["numInterBrokerReplicaMovements"],
                    leader_moves=doc["numLeaderMovements"],
                    rounds=[g["rounds"] for g in doc["goals"]],
                    placement=digest(fp.broker, fp.disk, fp.is_leader),
                    trail=list(trail))
                emit(**out)
        finally:
            S.GoalSolver.optimize_goal = solve
    notes = sorted({str(w.message).splitlines()[0] for w in caught})
    emit(order=order, device=device, warnings=notes)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--order", nargs="+", default=["free"], choices=ORDERS)
    args = ap.parse_args()

    import torch
    if args.device != "cpu" and not torch.cuda.is_available():
        print("CUDA is not available; pass --device cpu", file=sys.stderr)
        return 2

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    for order in args.order:
        run_order(BASELINE3, args.device, order, args.runs, emit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
