"""The reference's judgement of the program's answers.

Each function takes what the benchmark handed the program (the packed
snapshot arrays, the brokers a what-if removes) and what the program
answered (a placement, its own verdicts, its per-broker sums of the
placement), works the answer's properties out again with
:mod:`ccbench.reference.goals`, and lists every fault it finds.  It imports
nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ccbench.reference import goals as rg

#: Relative gap allowed between the program's per-broker load sums and the
#: reference's (float64) ones, each against the larger of the broker's value
#: and the median broker's: the program's float32 sums read under 1e-6 of
#: it on the card, sums in bfloat16 0.5 (PERF.md gives the readings).
SUMS_RTOL = 1e-3

#: The eight per-broker channels of the program's aggregate, in its order:
#: four loads, replicas, leaders, potential NW-out, leader bytes-in.  The
#: counts (4 and 5) are compared exactly.
LOAD_CHANNELS = (0, 1, 2, 3, 6, 7)
COUNT_CHANNELS = (4, 5)


@dataclass
class Judgement:
    """What the reference found in one answer."""

    faults: List[str] = field(default_factory=list)
    verdicts: Dict[str, rg.Verdict] = field(default_factory=dict)
    sums_gap: float = 0.0
    count_mismatches: int = 0

    @property
    def wrong(self) -> bool:
        return bool(self.faults)


def reference_sums(agg: rg.Aggregates) -> np.ndarray:
    """f64[B, 8]: the reference's per-broker sums in the program's channel
    order."""
    return np.column_stack([agg.broker_load, agg.replica_counts, agg.leader_counts,
                            agg.potential_nw_out, agg.leader_bytes_in]).astype(np.float64)


def sums_gaps(got: np.ndarray, want: np.ndarray):
    """(largest relative gap of the load channels, number of broker counts
    that differ): each load against the larger of its own value and the
    median broker's of its channel, since a removed broker's sums are 0."""
    got = np.asarray(got, dtype=np.float64)
    loads = list(LOAD_CHANNELS)
    scale = np.maximum(np.abs(want[:, loads]),
                       np.median(np.abs(want[:, loads]), axis=0, keepdims=True))
    gap = np.abs(got[:, loads] - want[:, loads]) / np.maximum(scale, 1e-30)
    counts = list(COUNT_CHANNELS)
    return float(gap.max()), int((got[:, counts] != want[:, counts]).sum())


def violated_faults(program: Dict[str, int], verdicts: Dict[str, rg.Verdict],
                    goal_names: List[str]) -> List[str]:
    """Goals whose violated brokers the program counts otherwise than the
    reference does on the final placement.  The program counts goal g just
    after g's own solve: the last goal's count is the final placement's; a
    later goal may lower an earlier one's (its moves are checked against
    every goal before it) but not raise it.  An undecided verdict is not
    compared."""
    bad = []
    for k, name in enumerate(goal_names):
        state, n = verdicts[name]
        if state == rg.UNDECIDED or name not in program:
            continue
        got = int(program[name])
        if (n != got) if k == len(goal_names) - 1 else (n > got):
            bad.append(f"{name} (program {got}, reference {n})")
    return bad


def judge_lane(cl: rg.Cluster, packed: Dict[str, np.ndarray], removed: Sequence[int],
               goal_names: List[str], constraint: rg.Constraint, answer: dict,
               alive: Optional[np.ndarray] = None) -> Judgement:
    """One remove-broker what-if lane (or, with nothing removed, a hard-goal
    solve): ``answer`` holds the lane's placement (``broker``,
    ``is_leader``), whether the program says the lane succeeded
    (``succeeded``: every replica off a dead broker, every goal met), and
    where it has them the program's violated brokers per goal
    (``violated``: name -> count) and its per-broker sums of the placement
    (``sums``: [B, 8])."""
    j = Judgement()
    broker = np.asarray(answer["broker"]).astype(np.int64)
    is_leader = np.asarray(answer["is_leader"]).astype(bool)
    s = rg.structure(cl, broker, is_leader)
    if s.faults:
        j.faults.append(f"structure: {s.duplicate_partitions} partitions with two replicas "
                        f"on a broker, {s.leaderless_or_multi_leader} without one leader")
        return j
    alive = (cl.alive if alive is None else alive).copy()
    alive[list(removed)] = False
    agg = rg.aggregate(cl, packed["leader_load"], packed["follower_load"], broker, is_leader,
                       alive=alive)
    if answer.get("sums") is not None:
        j.sums_gap, j.count_mismatches = sums_gaps(answer["sums"], reference_sums(agg))
    j.verdicts = rg.verdicts(cl, agg, dict(broker=broker, is_leader=is_leader), goal_names,
                             constraint)
    left = int(agg.replica_counts[~alive].sum())
    broken = [n for n, (state, _) in j.verdicts.items() if state == rg.VIOLATED]
    ok = left == 0 and not broken
    undecided = any(state == rg.UNDECIDED for state, _ in j.verdicts.values())
    if left:
        j.faults.append(f"{left} replicas left on removed or dead brokers")
    if broken:
        j.faults.append("goals broken: " + ", ".join(
            f"{n} on {j.verdicts[n][1]} brokers" for n in broken))
    if bool(answer["succeeded"]) != ok and not (undecided and left == 0 and not broken):
        j.faults.append(f"the program says the lane {'succeeded' if answer['succeeded'] else 'failed'}")
    if answer.get("violated") is not None:
        differ = violated_faults(answer["violated"], j.verdicts, goal_names)
        if differ:
            j.faults.append("the program counts violated brokers otherwise: " + ", ".join(differ))
    return j
