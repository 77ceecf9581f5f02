"""``propose`` — the offline end-to-end slice on the port.

Snapshot file → tensors → GoalOptimizer → proposals printed as JSON (the
reference flow is ``POST /rebalance?dryrun=true`` via RebalanceRunnable →
GoalOptimizer).  Reads the NPZ snapshots that either package writes.

    python -m cruise_control_tpu_torch.client.propose --snapshot X.npz \\
        [--goals RackAwareGoal,...] [--device cpu] [--verbose]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence, TextIO


def run_propose(args, out: Optional[TextIO] = None) -> int:
    """Run one proposal computation; print the JSON document to ``out``
    (stdout by default).  Returns the process exit code."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.common.exceptions import OptimizationFailureError
    from cruise_control_tpu_torch.model.snapshot import load_npz

    out = out or sys.stdout
    if not args.snapshot.endswith(".npz"):
        print(json.dumps({"error": "only .npz snapshots are supported by the "
                                   "port so far"}), file=sys.stderr)
        return 1
    state, placement, meta = load_npz(args.snapshot, device=args.device)
    goal_names = args.goals.split(",") if args.goals else None
    optimizer = GoalOptimizer(goal_names=goal_names)
    try:
        result = optimizer.optimizations(state, placement, meta)
    except OptimizationFailureError as e:
        print(json.dumps({"error": str(e)}), file=sys.stderr)
        return 2

    doc = {
        "proposals": [p.to_dict() for p in result.proposals],
        "elapsedSeconds": result.elapsed_s,
    }
    if args.verbose:
        doc["summary"] = result.to_dict()
    print(json.dumps(doc, indent=2), file=out)
    return 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m cruise_control_tpu_torch.client.propose",
                                description="Compute rebalance proposals for a snapshot.")
    p.add_argument("--snapshot", required=True, help="snapshot file (.npz)")
    p.add_argument("--goals", default=None,
                   help="comma-separated goal names in priority order")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--verbose", action="store_true",
                   help="include the per-goal summary and cluster stats")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    return run_propose(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
