"""Remove-broker what-ifs: one client (the self-healing manager, a
decommission planner) asks for a batch of what-if lanes, waits, and asks
again.

Set-up puts the configuration's snapshot on the card and solves its goal
list once: that healthy placement is the cluster after the rebalance a
service would already have executed, and every lane starts from it.  Each
request is one ``GoalOptimizer.batch_remove_scenarios`` call of
``lanes_per_request`` lanes, each removing ``brokers_per_lane`` brokers drawn
without replacement from ``(seed, request index)``; the state stays on the
card across requests.  A sample of the requests drawn from the seed, and the
slowest one, are judged by the reference afterwards, with the healthy
placement: each lane's placement, the program's violated brokers per goal,
its word on the lane's success, and the program's per-broker sums of the
placement (the aggregate kernel), taken once the window has closed.

Traffic parameters: ``goals``, ``lanes_per_request``, ``brokers_per_lane``,
``num_candidates``, ``warmup_requests``, ``trace_requests``,
``check_requests`` (the sample's size).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ccbench.harness import cluster, program
from ccbench.harness.runner import Checks, synchronize
from ccbench.reference import checks as ref_checks
from ccbench.reference import goals as rg

#: Lanes, healthy placements and per-broker counts the reference may find
#: wrong in a run.
WRONG_LIMIT = 0

# A stream of the seed's draws kept apart from the request draws.
_SAMPLE_STREAM = 1 << 40
_WARMUP_STREAM = 1 << 41


class Workload:
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
        self.snap = cluster.generate(cfg["cluster"])
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
            self._what_if(self._sets(cfg["cluster"]["seed"], _WARMUP_STREAM + k))
        self.sample_rng = np.random.default_rng(cluster.seed_words(self.seed, _SAMPLE_STREAM))
        self.sample: List[dict] = []           # a reservoir of answers (``_answer``)
        self.slowest: Optional[tuple] = None   # (wall, answer)
        self.lanes_ok = self.lanes_run = 0
        synchronize(self.device)
        ctx.log(f"{self.snap.num_replicas} replicas, {self.snap.num_brokers} brokers; "
                f"healthy placement with {len(self.healthy_violated)} goals violated; set-up: "
                f"generation and snapshot {t1 - t0:.3f} s, healthy solve {t2 - t1:.3f} s, "
                f"warm-up {time.monotonic() - t2:.3f} s")

    def _sets(self, seed: int, index: int) -> List[List[int]]:
        rng = np.random.default_rng(cluster.seed_words(seed, index))
        ids = rng.choice(self.snap.num_brokers, self.lanes * self.per_lane, replace=False)
        return [sorted(int(b) for b in ids[k * self.per_lane:(k + 1) * self.per_lane])
                for k in range(self.lanes)]

    def _what_if(self, sets):
        res = self.optimizer.batch_remove_scenarios(
            self.state, self.placement, self.meta, sets,
            num_candidates=self.num_candidates, warm_start=self.healthy)
        if res.memory_refused:
            raise RuntimeError("the memory guard refused the what-if batch")
        return res

    def request(self, i: int) -> dict:
        sets = self._sets(self.seed, i)
        t0 = time.monotonic()
        res = self._what_if(sets)
        synchronize(self.device)
        wall = time.monotonic() - t0
        self._keep(i, sets, res, wall)
        ok = sum(res.succeeded(s) for s in range(len(sets)))
        self.lanes_ok += ok
        self.lanes_run += len(sets)
        return {"wall_s": wall, "lanes": len(sets), "rounds": int(res.rounds.sum()),
                "succeeded": ok}

    def _answer(self, i, sets, res) -> dict:
        """A request's answers as host arrays: the lanes' placements, the
        program's violated brokers per lane and goal, and its word on each
        lane's success."""
        fp = res.final_placements
        return dict(index=i, sets=sets, broker=program.host(fp.broker),
                    is_leader=program.host(fp.is_leader),
                    violated=np.asarray(res.violated_after), goals=list(res.goal_names),
                    succeeded=[bool(res.succeeded(s)) for s in range(len(sets))])

    def _keep(self, i, sets, res, wall) -> None:
        """Reservoir sampling from the seed's own stream, plus the slowest;
        only a request that enters the sample is copied to the host."""
        slot = len(self.sample) if len(self.sample) < self.check_requests else None
        if slot is None:
            j = int(self.sample_rng.integers(0, i + 1))
            slot = j if j < self.check_requests else None
        slowest = self.slowest is None or wall > self.slowest[0]
        if slot is None and not slowest:
            return
        answer = self._answer(i, sets, res)
        if slot is not None:
            if slot == len(self.sample):
                self.sample.append(answer)
            else:
                self.sample[slot] = answer
        if slowest:
            self.slowest = (wall, answer)

    def _collect(self):
        """The judged answers, each lane with the program's per-broker sums
        of its placement, and the healthy placement; then the program's
        state is freed."""
        kept = {a["index"]: a for a in self.sample}
        if self.slowest is not None:
            kept.setdefault(self.slowest[1]["index"], self.slowest[1])
        healthy = dict(index=-1, sets=[[]], broker=program.host(self.healthy.broker)[None],
                       is_leader=program.host(self.healthy.is_leader)[None],
                       violated=None, goals=self.goal_names,
                       succeeded=[not set(self.healthy_violated) & set(self.goal_names)])
        answers = [kept[i] for i in sorted(kept)] + [healthy]
        for a in answers:
            a["sums"] = program.broker_sums(self.state, self.placement, self.meta,
                                            self.balancing, a["broker"], a["is_leader"])
        self.sample, self.slowest = [], None
        self.state = self.placement = self.healthy = self.optimizer = None
        if self.device.startswith("cuda"):
            import torch
            torch.cuda.empty_cache()
        return answers[:-1], answers[-1]

    def check(self) -> Checks:
        answers, healthy = self._collect()
        cl = rg.Cluster(self.snap.packed)
        constraint = rg.Constraint.from_config(self.balancing)
        packed = self.snap.packed
        notes: List[str] = []
        counts = dict(wrong_lanes=0, wrong_healthy=0, count_mismatches=0)
        gap = 0.0
        lanes = 0
        for a in answers + [healthy]:
            for s, removed in enumerate(a["sets"]):
                lane = dict(broker=a["broker"][s], is_leader=a["is_leader"][s],
                            succeeded=a["succeeded"][s], sums=a["sums"][s],
                            violated=None if a["violated"] is None
                            else dict(zip(a["goals"], a["violated"][s].tolist())))
                j = ref_checks.judge_lane(cl, packed, removed, self.goal_names, constraint, lane)
                gap = max(gap, j.sums_gap)
                counts["count_mismatches"] += j.count_mismatches
                if a is healthy:
                    counts["wrong_healthy"] += int(j.wrong)
                    lanes -= 1
                else:
                    counts["wrong_lanes"] += int(j.wrong)
                lanes += 1
                if j.wrong and len(notes) < 5:
                    what = ("the healthy placement" if a is healthy else
                            f"request {a['index']} lane removing {removed}")
                    notes.append(f"{what} is wrong: " + "; ".join(j.faults))
        notes.append(f"checked {lanes} lanes of {len(answers)} requests and the healthy "
                     f"placement; the program says {self.lanes_ok} of its {self.lanes_run} "
                     f"lanes succeeded")
        numbers = {name: (value, WRONG_LIMIT) for name, value in counts.items()}
        numbers["sums_gap"] = (gap, ref_checks.SUMS_RTOL)
        return Checks(numbers=numbers, notes=notes)

    def end_to_end(self, records: List[dict], window_s: float) -> dict:
        if not records:
            return {}
        walls = [r["wall_s"] for r in records]
        return {"whatif_lanes_per_s": sum(r["lanes"] for r in records) / window_s,
                "whatif_p90_s": float(np.percentile(walls, 90))}
