"""The reference's judgement of an add-broker what-if lane.

A lane adds some of the provisioned brokers, which the snapshot holds dead
and empty, and solves the whole goal list from the healthy placement.  The
judgement works the lane's placement out again with
:mod:`ccbench.reference.goals` and :mod:`ccbench.reference.checks`, with the
lane's alive brokers the snapshot's plus the ones it adds, and lists every
fault it finds:

- a partition with two replicas on a broker, or without exactly one leader;
- a replica on a broker the lane leaves dead (a provisioned broker it did not
  add);
- a hard goal broken;
- a goal's violated brokers on the final placement counted otherwise than
  the reference counts them (the program's own count of the placement,
  ``final``): at least the brokers beyond a bound by more than the margin,
  at most those beyond it or within the margin of it (:func:`count_range`);
- a goal's violated brokers at its own exit (the program's ``violated``
  row) that the final placement refutes: the last goal's must lie in the
  same range, and no hard goal's below it, since every later move is
  checked against the hard goals before it.  A soft goal before the
  last is not compared: a later goal's leadership move is checked against a
  prior resource goal's upper band on the gaining broker only, so the
  demoted broker may end below the lower band (as in the JAX package);
- the program's word on the lane's success, which holds each goal at its own
  exit: a lane it calls successful must break no hard goal and not the last
  goal on the final placement, and leave nothing on a dead broker; a lane it
  calls failed must break a goal there, or name a goal before the last one
  violated at its own exit (a later goal may have repaired it).

A soft goal violated on the final placement is no fault.  The lane is
*unbalanced* where one of the goals that bound how much each broker carries
(:data:`LOAD_GOALS`: replicas, the four resources, potential NW-out) is
violated there in a way no later goal's leadership move explains: any
violation but a broker below the lower bound of a goal in
:data:`LOWER_BAND_OPEN`.  A new broker left emptier than the others breaks
the first of them.  Of the soft goals after the load goals the lane sums
the brokers it leaves violating them, in the groups :data:`GUARDED` names: a
lane that skips those goals leaves each topic's replicas unspread, and one
that skips every leadership move leaves the leaders' inbound bytes unspread.
The kind counts unbalanced lanes and each group's brokers against limits of
its own.  It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from ccbench.reference import checks
from ccbench.reference import goals as rg


#: The soft goals whose bands bound how much each broker carries.
LOAD_GOALS = ("ReplicaDistributionGoal", "PotentialNwOutGoal", "DiskUsageDistributionGoal",
              "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
              "CpuUsageDistributionGoal")
#: Those whose lower bound a later goal's leadership move may breach: their
#: leadership acceptance holds the promoted replica's broker to the upper
#: bound and leaves the demoted leader's broker unchecked, in the program
#: and in the JAX package alike.
LOWER_BAND_OPEN = {"NetworkOutboundUsageDistributionGoal": rg.NW_OUT,
                   "CpuUsageDistributionGoal": rg.CPU}
#: number -> the soft goals after the load goals whose violated brokers a
#: lane sums into it: those that spread each topic's replicas and the
#: leaderships, and the last goal, which moves leaderships alone.
GUARDED = {"spread_brokers": ("TopicReplicaDistributionGoal", "LeaderReplicaDistributionGoal"),
           "leader_bytes_in_brokers": ("LeaderBytesInDistributionGoal",)}


@dataclass
class AddJudgement(checks.Judgement):
    """What the reference found in one add-broker lane: ``soft``, the soft
    goals violated on its final placement; ``unbalanced``, one of them in a
    way no later leadership move explains; ``guarded``, the brokers it leaves
    violating each group of :data:`GUARDED`."""

    soft: List[str] = field(default_factory=list)
    unbalanced: bool = False
    guarded: Dict[str, int] = field(default_factory=dict)


def above_upper(cl: rg.Cluster, agg: rg.Aggregates, name: str,
                constraint: rg.Constraint) -> int:
    """Alive brokers above the upper bound of ``name`` (a goal of
    :data:`LOWER_BAND_OPEN`) by more than the margin, the bound as
    ``goals.py`` states it."""
    res = LOWER_BAND_OPEN[name]
    alive = agg.alive
    avg = agg.broker_load[alive, res].sum() / max(cl.capacity[alive, res].sum(), 1e-9)
    upper = avg * constraint.balance_threshold[res] * cl.capacity[:, res]
    beyond, _ = rg._beyond(agg.broker_load[:, res], upper)
    return int((beyond & alive).sum())


def count_range(cl: rg.Cluster, agg: rg.Aggregates, placement: Dict[str, np.ndarray],
                goal_names: List[str], constraint: rg.Constraint) -> Dict[str, tuple]:
    """name -> (low, high): the violated brokers of each goal counting only
    those beyond a bound by more than the margin ``goals.EPS``, and counting
    those within the margin of it too.  A float32 sum of the program may
    fall on either side of a bound within the margin; counts are exact, so
    a count goal's range is one number."""
    low = rg.verdicts(cl, agg, placement, goal_names, constraint)
    saved = rg.EPS
    rg.EPS = -saved              # a negative margin counts the brokers near a bound
    try:
        high = rg.verdicts(cl, agg, placement, goal_names, constraint)
    finally:
        rg.EPS = saved
    return {n: (low[n][1], high[n][1]) for n in goal_names}


def judge_add_lane(cl: rg.Cluster, packed: Dict[str, np.ndarray], added: Sequence[int],
                   goal_names: List[str], constraint: rg.Constraint,
                   answer: dict) -> AddJudgement:
    """One lane that adds the brokers ``added`` (dense indices), or with
    nothing added the healthy placement.  ``answer`` holds the lane's
    placement (``broker``, ``is_leader``), the program's word on its success
    (``succeeded``), and where it has them the program's violated brokers
    per goal at each goal's exit (``violated``: name -> count), on the
    final placement (``final``: name -> count) and its per-broker sums of
    the placement (``sums``: [B, 8])."""
    j = AddJudgement()
    broker = np.asarray(answer["broker"]).astype(np.int64)
    is_leader = np.asarray(answer["is_leader"]).astype(bool)
    s = rg.structure(cl, broker, is_leader)
    if s.faults:
        j.faults.append(f"structure: {s.duplicate_partitions} partitions with two replicas "
                        f"on a broker, {s.leaderless_or_multi_leader} without one leader")
        return j
    alive = cl.alive.copy()
    alive[list(added)] = True
    agg = rg.aggregate(cl, packed["leader_load"], packed["follower_load"], broker, is_leader,
                       alive=alive)
    if answer.get("sums") is not None:
        j.sums_gap, j.count_mismatches = checks.sums_gaps(answer["sums"],
                                                          checks.reference_sums(agg))
    j.verdicts = rg.verdicts(cl, agg, dict(broker=broker, is_leader=is_leader), goal_names,
                             constraint)
    broken = [n for n, (state, _) in j.verdicts.items() if state == rg.VIOLATED]
    hard = [n for n in broken if rg.GOALS[n].hard]
    j.soft = [n for n in broken if not rg.GOALS[n].hard]
    j.unbalanced = any(n in LOAD_GOALS and (n not in LOWER_BAND_OPEN
                                            or above_upper(cl, agg, n, constraint))
                       for n in j.soft)
    j.guarded = {number: sum(j.verdicts[n][1] for n in j.soft if n in names)
                 for number, names in GUARDED.items()}
    left = int(agg.replica_counts[~alive].sum())
    if left:
        j.faults.append(f"{left} replicas on provisioned brokers the lane does not add")
    if hard:
        j.faults.append("hard goals broken: " + ", ".join(
            f"{n} on {j.verdicts[n][1]} brokers" for n in hard))
    row = answer.get("violated")
    last = goal_names[-1]
    ok = left == 0 and not broken
    undecided = any(state == rg.UNDECIDED for state, _ in j.verdicts.values())
    earlier = row is not None and any(int(row.get(n, 0)) > 0 for n in goal_names[:-1])
    refuted = hard or left or j.verdicts[last][0] == rg.VIOLATED
    if answer["succeeded"] and (refuted if row is not None else not ok):
        j.faults.append("the program says the lane succeeded, and the reference finds "
                        + ", ".join(broken or ["replicas left on dead brokers"]) + " violated")
    elif not answer["succeeded"] and ok and not undecided and not earlier:
        j.faults.append("the program says the lane failed, and names no goal violated")
    differ = []
    final = answer.get("final")
    if final is not None or row is not None:
        ranges = count_range(cl, agg, dict(broker=broker, is_leader=is_leader), goal_names,
                             constraint)
        for name, (lo, hi) in ranges.items():
            shown = f"reference {lo}" if lo == hi else f"reference {lo} to {hi}"
            if final is not None and not lo <= int(final[name]) <= hi:
                differ.append(f"{name} on the final placement (program {final[name]}, {shown})")
            got = None if row is None else row.get(name)
            if got is not None and ((not lo <= got <= hi) if name == last
                                    else (rg.GOALS[name].hard and got < lo)):
                differ.append(f"{name} at its exit (program {got}, {shown})")
    if differ:
        j.faults.append("the program counts violated brokers otherwise: " + ", ".join(differ))
    return j
