"""Add-broker what-ifs: one client (an operator, a provisioner's
rightsizing) asks for a batch of dry-run lanes that each add some of the
brokers just started for a cluster's expansion, waits, and asks again.

Set-up generates the configuration's cluster and appends its ``provisioned``
brokers to the snapshot, dead and empty (``new_broker`` set), then solves
the goal list once with the pool dead (``GoalOptimizer.optimizations``,
polish included): the healthy placement a service would already have
executed before the new brokers came up, as ``testNewBrokers`` rebalances
before it adds.  Each request is one ``GoalOptimizer.batch_add_scenarios``
call of ``lanes_per_request`` lanes, each reviving ``brokers_per_lane``
brokers drawn without replacement from the pool by ``(seed, request
index)``, warm-started from the healthy placement; the state stays on the
card across requests.  A sample of the requests drawn from the seed, the
slowest one and the healthy placement are judged by
``reference/add_checks.py`` afterwards, with the program's per-broker sums
and its own count of each goal's violated brokers on each judged placement;
``unbalanced_lanes`` counts the judged lanes that leave a load goal violated
in a way no later leadership move explains; ``spread_brokers`` sums the
brokers they leave violating TopicReplica or LeaderReplica distribution, and
``leader_bytes_in_brokers`` those violating LeaderBytesIn distribution.

Traffic parameters: those of ``remove_lanes`` (``goals``,
``lanes_per_request``, ``brokers_per_lane``, ``num_candidates``,
``warmup_requests``, ``trace_requests``, ``check_requests``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np

from ccbench.harness import cluster, program
from ccbench.harness.runner import Checks, synchronize
from ccbench.kinds import remove_lanes
from ccbench.reference import add_checks
from ccbench.reference import checks as ref_checks
from ccbench.reference import goals as rg

#: The share of the judged lanes that may be unbalanced in a run: its limit
#: is this share of the lanes judged.  Sound runs on the card read 0 of
#: their 104 to 124 lanes on 8 seeds, lanes solved with the hard goals
#: alone 128 of 128 (PERF.md section 2).
UNBALANCED_SHARE = 0.1
#: number of ``add_checks.GUARDED`` -> the violated brokers a judged lane
#: may leave on average in a run: its limit is this many times the lanes
#: judged.  Each lies near the geometric middle of the largest sound reading
#: on the card over 9 seeds and the smallest of the planted fault it is
#: there to catch (PERF.md section 2): ``spread_brokers`` 1.52 against 26.2
#: for lanes that skip the goals after CpuUsageDistributionGoal,
#: ``leader_bytes_in_brokers`` 1.03 against 2.01 for solves without their
#: leadership phase.
PER_LANE = {"spread_brokers": 6.3, "leader_bytes_in_brokers": 1.4}

_RESOURCES = ("cpu", "nw_in", "nw_out", "disk")      # the generator's column order


def provision(snap: cluster.Snapshot, block: dict) -> cluster.Snapshot:
    """``snap`` with the ``provisioned`` brokers appended after its own:
    each in its rack, on a host of its own, with one disk, dead, empty and
    new."""
    ids = [int(b) for b in block["broker_ids"]]
    n = len(ids)
    if ids != list(range(snap.num_brokers, snap.num_brokers + n)):
        raise ValueError(f"provisioned ids must follow the cluster's {snap.num_brokers} "
                         f"brokers in order, not {ids}")
    if int(block.get("disks", 1)) != 1 or int(block.get("replicas", 0)) != 0 \
            or block.get("alive", False):
        raise ValueError("provisioned brokers have one disk, no replica, and are dead")
    racks = np.asarray(block["racks"], dtype=np.int32)
    if racks.shape != (n,) or racks.min() < 0 or racks.max() >= len(snap.racks):
        raise ValueError(f"provisioned racks must name the cluster's {len(snap.racks)} racks")
    p = snap.packed
    cap = np.tile(np.asarray([block["capacity"][r] for r in _RESOURCES], np.float32), (n, 1))
    host0 = int(p["host"].max()) + 1
    packed = dict(
        p,
        capacity=np.concatenate([p["capacity"], cap]),
        host=np.concatenate([p["host"], np.arange(host0, host0 + n, dtype=np.int32)]),
        rack=np.concatenate([p["rack"], racks]),
        alive=np.concatenate([p["alive"], np.zeros(n, bool)]),
        new_broker=np.concatenate([p["new_broker"], np.ones(n, bool)]),
        broker_valid=np.concatenate([p["broker_valid"], np.ones(n, bool)]),
        disk_capacity=np.concatenate([p["disk_capacity"], cap[:, 3:4]]),
        disk_alive=np.concatenate([p["disk_alive"], np.ones((n, 1), bool)]))
    return dataclasses.replace(snap, packed=packed, broker_ids=snap.broker_ids + ids,
                               hosts=snap.hosts + [f"h{b}" for b in ids])


def goal_counts(state, placement, meta, balancing: dict, goal_names: List[str],
                sets: List[List[int]], broker: np.ndarray, is_leader: np.ndarray) -> np.ndarray:
    """i64[S, G]: the program's violated brokers of each goal on each of
    ``S`` lane placements (``broker``, ``is_leader``: [S, R] host arrays of
    its answers), each in the lane's context: the base context with the
    lane's added brokers alive, as its lane runner builds it."""
    import torch
    from cruise_control_tpu_torch.analyzer.context import (
        build_context, compute_aggregates, scenario_context)
    from cruise_control_tpu_torch.analyzer.goals.registry import get_goals_by_priority
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
    from cruise_control_tpu_torch.model.state import Placement

    gctx = build_context(state, placement, meta, program.constraint(balancing),
                         OptimizationOptions())
    goals = get_goals_by_priority(goal_names)
    out = np.zeros((len(sets), len(goals)), dtype=np.int64)
    for s, added in enumerate(sets):
        alive = state.alive.clone()
        alive[[meta.broker_index[b] for b in added]] = True
        lctx = scenario_context(gctx, alive, gctx.excluded_for_replica_move,
                                gctx.excluded_for_leadership)
        pl = Placement(broker=torch.as_tensor(broker[s], device=state.device),
                       disk=placement.disk,
                       is_leader=torch.as_tensor(is_leader[s], device=state.device))
        agg = compute_aggregates(lctx, pl)
        out[s] = program.host(torch.stack([g.violated_brokers(lctx, pl, agg).sum()
                                           for g in goals]))
    return out


class Workload(remove_lanes.Workload):
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, traffic = ctx.cell.config, ctx.cell.traffic
        self.device = ctx.device
        self.seed = ctx.seed
        self.balancing = cfg["balancing"]
        self.goal_names: List[str] = cfg["goals"][traffic["goals"]]
        self.lanes = int(traffic["lanes_per_request"])
        self.per_lane = int(traffic["brokers_per_lane"])
        self.num_candidates = int(traffic["num_candidates"])
        self.check_requests = int(traffic["check_requests"])
        t0 = time.monotonic()
        base = cluster.generate(cfg["cluster"])
        self.snap = provision(base, cfg["provisioned"])
        self.pool = np.arange(base.num_brokers, self.snap.num_brokers)
        if self.lanes * self.per_lane > self.pool.size:
            raise ValueError(f"{self.lanes} lanes of {self.per_lane} brokers need more than "
                             f"the {self.pool.size} provisioned")
        self.shapes = {"rows": self.snap.num_replicas, "brokers": self.snap.num_brokers}
        self.optimizer = program.optimizer(self.balancing, self.goal_names)
        self.state, self.placement, self.meta = program.snapshot(
            self.snap.packed, self.snap.meta_kwargs(), self.device)
        t1 = time.monotonic()
        solved = self.optimizer.optimizations(self.state, self.placement, self.meta)
        self.healthy = solved.final_placement
        t2 = time.monotonic()
        self.healthy_violated = list(solved.violated_goals_after)
        for k in range(int(traffic["warmup_requests"])):
            self._what_if(self._sets(cfg["cluster"]["seed"], remove_lanes._WARMUP_STREAM + k))
        self.sample_rng = np.random.default_rng(
            cluster.seed_words(self.seed, remove_lanes._SAMPLE_STREAM))
        self.sample = []
        self.slowest = None
        self.lanes_ok = self.lanes_run = 0
        synchronize(self.device)
        ctx.log(f"{self.snap.num_replicas} replicas, {base.num_brokers} brokers and "
                f"{self.pool.size} provisioned; healthy placement with "
                f"{len(self.healthy_violated)} goals violated "
                f"({', '.join(self.healthy_violated) or 'none'}); set-up: generation and "
                f"snapshot {t1 - t0:.3f} s, healthy solve {t2 - t1:.3f} s, "
                f"warm-up {time.monotonic() - t2:.3f} s")

    def _sets(self, seed: int, index: int) -> List[List[int]]:
        rng = np.random.default_rng(cluster.seed_words(seed, index))
        ids = rng.choice(self.pool, self.lanes * self.per_lane, replace=False)
        return [sorted(int(b) for b in ids[k * self.per_lane:(k + 1) * self.per_lane])
                for k in range(self.lanes)]

    def _what_if(self, sets):
        res = self.optimizer.batch_add_scenarios(
            self.state, self.placement, self.meta, sets,
            num_candidates=self.num_candidates, warm_start=self.healthy)
        if res.memory_refused:
            raise RuntimeError("the memory guard refused the what-if batch")
        return res

    def _collect(self):
        """The parent's collection, each kept lane first given the program's
        own violated brokers per goal on its final placement (``final``)."""
        kept = self.sample + ([self.slowest[1]] if self.slowest is not None else [])
        for a in kept:
            if "final" not in a:
                a["final"] = goal_counts(self.state, self.placement, self.meta, self.balancing,
                                         self.goal_names, a["sets"], a["broker"],
                                         a["is_leader"])
        return super()._collect()

    def check(self) -> Checks:
        answers, healthy = self._collect()
        cl = rg.Cluster(self.snap.packed)
        constraint = rg.Constraint.from_config(self.balancing)
        packed = self.snap.packed
        notes: List[str] = []
        counts = dict(wrong_lanes=0, wrong_healthy=0, count_mismatches=0)
        gap = 0.0
        lanes = unbalanced = any_soft = 0
        guarded = dict.fromkeys(PER_LANE, 0)
        soft = {}          # goal -> [judged lanes that leave it violated, its brokers summed]
        for a in answers + [healthy]:
            for s, added in enumerate(a["sets"]):
                lane = dict(broker=a["broker"][s], is_leader=a["is_leader"][s],
                            succeeded=a["succeeded"][s], sums=a["sums"][s],
                            violated=None if a["violated"] is None
                            else dict(zip(a["goals"], a["violated"][s].tolist())),
                            final=None if "final" not in a
                            else dict(zip(self.goal_names, a["final"][s].tolist())))
                j = add_checks.judge_add_lane(cl, packed, added, self.goal_names, constraint,
                                              lane)
                gap = max(gap, j.sums_gap)
                counts["count_mismatches"] += j.count_mismatches
                if a is healthy:
                    counts["wrong_healthy"] += int(j.wrong)
                else:
                    counts["wrong_lanes"] += int(j.wrong)
                    unbalanced += int(j.unbalanced)
                    for number in guarded:
                        guarded[number] += j.guarded[number]
                    lanes += 1
                    any_soft += bool(j.soft)
                    for name in j.soft:
                        got = soft.setdefault(name, [0, 0])
                        got[0] += 1
                        got[1] += j.verdicts[name][1]
                if j.wrong and len(notes) < 5:
                    what = ("the healthy placement" if a is healthy else
                            f"request {a['index']} lane adding {added}")
                    notes.append(f"{what} is wrong: " + "; ".join(j.faults))
        notes.append(f"checked {lanes} lanes of {len(answers)} requests and the healthy "
                     f"placement; {any_soft} lanes leave a soft goal violated, {unbalanced} "
                     f"unbalanced; the program says {self.lanes_ok} of its {self.lanes_run} "
                     "lanes succeeded; judged lanes a soft goal leaves violated (its violated "
                     "brokers summed over them): "
                     + (", ".join(f"{n} {k} ({b})" for n, (k, b) in soft.items()) or "none"))
        numbers = {name: (value, remove_lanes.WRONG_LIMIT) for name, value in counts.items()}
        numbers["sums_gap"] = (gap, ref_checks.SUMS_RTOL)
        numbers["unbalanced_lanes"] = (unbalanced, UNBALANCED_SHARE * lanes)
        for number, value in guarded.items():
            numbers[number] = (value, PER_LANE[number] * lanes)
        return Checks(numbers=numbers, notes=notes)
