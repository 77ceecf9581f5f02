#!/usr/bin/env python3
"""The JAX package's solve quality at BASELINE config #3, on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_reference_quality.py [--run NAME] [--max-rounds N]

Runs one goal set of the reference package (``cruise_control_tpu``) on the
random cluster of BASELINE config #3 (200 brokers, 10 racks, 1,000 topics,
50K replicas, seed 3140; ``bench.py:425-428``) and prints one JSON line:
violated goals before and after, balancedness, proposals, replica and
leader moves, per-goal rounds, and wall seconds (a CPU time, not a device
one).  The PyTorch port generates the same snapshot bit for bit, so its
quality on the H100 (``chip_smoke.py``) is comparable with this.

Runs (``--run``): ``default`` (the 15-goal default stack), ``kafka_assigner``
(the kafka-assigner pair), ``intra_broker_jbod`` (the intra-broker pair on a
four-logdir variant), ``min_topic_leaders`` (MinTopicLeadersPerBrokerGoal,
three leaders a broker of each of the three largest topics of a 50-topic
variant).  A failed solve prints
its error instead of the quality.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASELINE3 = dict(num_brokers=200, num_racks=10, num_topics=1000,
                 num_replicas=50_000, mean_cpu=0.006, mean_disk=90.0,
                 mean_nw_in=90.0, mean_nw_out=90.0, seed=3140)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="default",
                    choices=["default", "kafka_assigner", "intra_broker_jbod",
                             "min_topic_leaders"])
    ap.add_argument("--max-rounds", type=int, default=None,
                    help="max_rounds_per_goal (default: the constraint's)")
    args = ap.parse_args()

    from cruise_control_tpu.analyzer import relax
    from cruise_control_tpu.analyzer.constraint import BalancingConstraint
    from cruise_control_tpu.analyzer.goals import registry
    from cruise_control_tpu.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu.common.exceptions import OptimizationFailureError
    from cruise_control_tpu.testing import random_cluster as rc

    relax.set_relaxation(False)      # the greedy solve the port mirrors
    props = dict(BASELINE3)
    limits = {} if args.max_rounds is None else {"max_rounds_per_goal": args.max_rounds}
    constraint = BalancingConstraint(**limits)
    goals = {"default": registry.DEFAULT_GOALS,
             "kafka_assigner": registry.KAFKA_ASSIGNER_GOALS,
             "intra_broker_jbod": registry.DEFAULT_INTRA_BROKER_GOALS,
             "min_topic_leaders": ["MinTopicLeadersPerBrokerGoal"]}[args.run]
    if args.run == "intra_broker_jbod":
        props["num_disks"] = 4
    if args.run == "min_topic_leaders":
        props["num_topics"] = 50
    state, placement, meta = rc.generate(rc.ClusterProperties(**props))
    if args.run == "min_topic_leaders":
        valid = np.asarray(state.valid)
        lead_rows = valid & (np.asarray(state.pos) == 0)
        parts = np.bincount(np.asarray(state.topic)[lead_rows], minlength=meta.num_topics)
        largest = tuple(meta.topics[i] for i in np.argsort(-parts, kind="stable")[:3])
        constraint = BalancingConstraint(min_leader_topic_names=largest,
                                         min_topic_leaders_per_broker=3, **limits)
    t0 = time.monotonic()
    out = dict(run=args.run, replicas=meta.num_replicas, brokers=meta.num_brokers,
               goals=list(goals))
    try:
        res = GoalOptimizer(constraint=constraint, goal_names=goals).optimizations(
            state, placement, meta)
    except OptimizationFailureError as e:
        out.update(error=str(e), cpu_wall_s=time.monotonic() - t0)
        print(json.dumps(out), flush=True)
        return 0
    doc = res.to_dict()
    out.update(
        cpu_wall_s=time.monotonic() - t0,
        violated_goals_before=res.violated_goals_before,
        violated_goals_after=res.violated_goals_after,
        balancedness=res.balancedness_score,
        proposals=len(res.proposals),
        replica_moves=doc["numInterBrokerReplicaMovements"],
        intra_broker_moves=doc["numIntraBrokerReplicaMovements"],
        leader_moves=doc["numLeaderMovements"],
        per_goal=[{k: g[k] for k in ("goal", "rounds", "moves", "violatedBrokersBefore",
                                     "violatedBrokersAfter")} for g in doc["goals"]])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
