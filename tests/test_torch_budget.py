"""Budgeted (anytime) solves: ``SolveBudget`` semantics, the segmented
solve, and the partial results of a cancelled or expired budget — the
analyzer tests of ``tests/test_preempt.py``, with the JAX package run on the
same inputs where the two are compared.

Cross-package comparisons run with destination jitter off (the packages'
``hash01`` draws differ for some ids), and budgets read a tick clock that
advances by a fixed step at every read, so where a budget fires depends on
how often each package reads it, not on wall time.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import relax as jrelax
from cruise_control_tpu.analyzer.budget import SolveBudget as JBudget
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer.solver import GoalSolver as JSolver
from cruise_control_tpu.model.state import Placement as JPlacement
from cruise_control_tpu.testing import deterministic as jdet
from cruise_control_tpu.testing.verifier import verify_placement
from cruise_control_tpu_torch.analyzer.budget import SolveBudget
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.solver import GoalSolver
from cruise_control_tpu_torch.testing import deterministic as tdet
from cruise_control_tpu_torch.testing import random_cluster as trc

GOALS = ["ReplicaCapacityGoal", "ReplicaDistributionGoal"]
PADS = dict(pad_replicas_to=64, pad_brokers_to=8)
RANDOM = dict(num_brokers=12, num_racks=4, num_topics=20, num_replicas=600,
              mean_cpu=0.005, mean_disk=900.0, mean_nw_in=900.0, mean_nw_out=900.0,
              seed=5)


@pytest.fixture(scope="module")
def snapshots():
    return (jdet.unbalanced2().freeze(**PADS),
            tdet.unbalanced2().freeze(device="cpu", **PADS))


@pytest.fixture(autouse=True)
def jax_greedy():
    """The JAX package's relaxation switch is process-wide; its reference
    solves here are greedy."""
    was_on = jrelax.relaxation_enabled()
    jrelax.set_relaxation(False)
    yield
    jrelax.set_relaxation(was_on)


def _tick_clock(step=0.1):
    """Deterministic monotonic clock: each read advances by ``step``."""
    t = {"v": 0.0}

    def clock():
        t["v"] += step
        return t["v"]
    return clock, t


def _narrow(package_solver, **kw):
    """One accepted move per round: multi-round convergence on the tiny
    deterministic clusters, so there are segment boundaries to preempt at."""
    return package_solver(max_candidates_per_round=1, dst_jitter_frac=0.0, **kw)


def _jax_placement(p):
    return JPlacement(broker=jnp.asarray(p.broker.numpy()), disk=jnp.asarray(p.disk.numpy()),
                      is_leader=jnp.asarray(p.is_leader.numpy()))


def _infos(res):
    return [(i.goal_name, i.rounds, i.moves_applied, i.violated_brokers_before,
             i.violated_brokers_after, i.preempted, i.preempt_reason)
            for i in res.goal_infos]


def _same_broker_counts(tres, jres, valid):
    """Equal replica and leader counts per broker.  Which of several tied
    candidates moves is not compared: on the CPU the JAX package picks a
    soft goal's candidates with ``approx_max_k``, whose tie order is not
    ``top_k``'s (the port's)."""
    t, j = tres.final_placement, jres.final_placement
    tb, jb = t.broker.numpy()[valid], np.asarray(j.broker)[valid]
    tl, jl = t.is_leader.numpy()[valid], np.asarray(j.is_leader)[valid]
    assert np.bincount(tb, minlength=8).tolist() == np.bincount(jb, minlength=8).tolist()
    assert np.bincount(tb[tl], minlength=8).tolist() == np.bincount(jb[jl], minlength=8).tolist()


def test_budget_semantics():
    b = SolveBudget()
    assert not b.should_stop() and b.stop_reason() is None
    assert b.remaining_ms() is None
    assert not b.segmented                      # cancel-only: goal boundaries only

    b = SolveBudget(deadline_ms=100, clock=_tick_clock(0.06)[0])
    assert b.segmented                          # a deadline implies segments
    assert b.stop_reason() is None              # t=0.12 < 0.16
    assert b.stop_reason() == "deadline"        # t=0.18 >= 0.16
    assert b.remaining_ms() == 0.0

    # Cancellation outranks the deadline and the first reason wins.
    b = SolveBudget(deadline_ms=1, clock=_tick_clock(10.0)[0])
    b.cancel("slo-preempt")
    b.cancel("shutdown")
    assert b.stop_reason() == "slo-preempt"
    assert b.cancel_reason == "slo-preempt"

    # The reason is pinned on the shared event: a second budget wrapping the
    # same token agrees.
    ev = threading.Event()
    first = SolveBudget(cancel_event=ev)
    first.cancel("user")
    second = SolveBudget(cancel_event=ev)
    assert second.cancelled() and second.cancel_reason == "user"

    assert SolveBudget(segmented=True).segmented
    assert not SolveBudget(deadline_ms=0).segmented   # no deadline at all


def test_cancel_before_start_returns_input_placement(snapshots):
    (js, jp, jm), (ts, tp, tm) = snapshots
    results = []
    for opt, budget, args in ((GoalOptimizer(goal_names=GOALS), SolveBudget(), (ts, tp, tm)),
                              (JOptimizer(goal_names=GOALS, solver=JSolver()), JBudget(),
                               (js, jp, jm))):
        budget.cancel("user")
        results.append(opt.optimizations(*args, budget=budget))
    res, jres = results
    assert res.partial and res.preempt_reason == "user"
    assert all(i.preempted and i.rounds == 0 for i in res.goal_infos)
    assert not res.proposals
    assert torch.equal(res.final_placement.broker, tp.broker)
    assert _infos(res) == _infos(jres)
    assert [g["status"] for g in res.to_dict()["goals"]] == ["preempted"] * 2
    assert res.to_dict()["partial"] and res.to_dict()["preemptReason"] == "user"


@pytest.mark.parametrize("case", ["unbalanced2-1", "random-1", "random-3"])
def test_segmented_to_convergence_is_the_unbudgeted_solve(snapshots, case):
    """Bitwise: the same placement and the same per-goal numbers, on the
    narrow solver over unbalanced2 and on the 15-goal default stack over a
    small random cluster (jitter on), at one and three rounds a segment."""
    name, segment_rounds = case.split("-")
    segment_rounds = int(segment_rounds)
    if name == "unbalanced2":
        _, (ts, tp, tm) = snapshots
        opt = GoalOptimizer(goal_names=GOALS, solver=_narrow(GoalSolver,
                                                             segment_rounds=segment_rounds))
    else:
        ts, tp, tm = trc.generate(trc.ClusterProperties(**RANDOM), device="cpu")
        opt = GoalOptimizer(solver=GoalSolver(segment_rounds=segment_rounds))
    plain = opt.optimizations(ts, tp, tm)
    seg = opt.optimizations(ts, tp, tm, budget=SolveBudget(segmented=True))
    assert not seg.partial and "partial" not in seg.to_dict()
    assert sum(i.rounds for i in plain.goal_infos) > segment_rounds
    for f in ("broker", "disk", "is_leader"):
        assert torch.equal(getattr(seg.final_placement, f), getattr(plain.final_placement, f))
    assert _infos(seg) == _infos(plain)
    assert [i.metric_after for i in seg.goal_infos] == \
        [i.metric_after for i in plain.goal_infos]


def test_deadline_expires_mid_goal_as_in_jax(snapshots):
    """Deadline at t=0.55 on a 0.1-step clock: the budget survives the first
    goal's checks and expires after the second goal's first one-round
    segment, in both packages."""
    (js, jp, jm), (ts, tp, tm) = snapshots
    res = GoalOptimizer(goal_names=GOALS, solver=_narrow(GoalSolver, segment_rounds=1)) \
        .optimizations(ts, tp, tm, budget=SolveBudget(
            deadline_ms=450, clock=_tick_clock(0.1)[0]))
    jres = JOptimizer(goal_names=GOALS, solver=_narrow(JSolver, segment_rounds=1)) \
        .optimizations(js, jp, jm, budget=JBudget(
            deadline_ms=450, clock=_tick_clock(0.1)[0]))
    assert res.partial and res.preempt_reason == "deadline"
    assert any(i.preempted and i.rounds > 0 for i in res.goal_infos)
    assert (jres.partial, jres.preempt_reason) == (res.partial, res.preempt_reason)
    assert _infos(res) == _infos(jres)
    _same_broker_counts(res, jres, ts.valid.numpy())
    assert res.to_dict()["goals"][-1]["status"] == "preempted"
    # The partial placement is still safe by the JAX package's verifier.
    fails = verify_placement(js, jp, jm, _jax_placement(res.final_placement),
                             goal_infos=res.goal_infos)
    assert not fails, [str(f) for f in fails]


def test_half_budget_partial_passes_verifier(snapshots):
    (js, jp, jm), (ts, tp, tm) = snapshots
    opt = GoalOptimizer(goal_names=GOALS, solver=_narrow(GoalSolver, segment_rounds=1))
    clock, cell = _tick_clock(0.1)
    full = opt.optimizations(ts, tp, tm, budget=SolveBudget(deadline_ms=1e12, clock=clock))
    assert not full.partial
    full_rounds = sum(i.rounds for i in full.goal_infos)
    assert full_rounds >= 2, "scenario converges too fast to preempt"

    clock2, _ = _tick_clock(0.1)
    res = opt.optimizations(ts, tp, tm, budget=SolveBudget(
        deadline_ms=cell["v"] * 0.5 * 1000.0, clock=clock2))
    assert res.partial and res.preempt_reason == "deadline"
    assert sum(i.rounds for i in res.goal_infos) < full_rounds
    fails = verify_placement(js, jp, jm, _jax_placement(res.final_placement),
                             goal_infos=res.goal_infos)
    assert not fails, [str(f) for f in fails]


def test_result_cache_keeps_the_latest_converged_generation(snapshots):
    _, (ts, tp, tm) = snapshots
    opt = GoalOptimizer(goal_names=GOALS)
    first = opt.optimizations(ts, tp, tm, model_generation=1)
    assert opt.optimizations(ts, tp, tm, model_generation=1) is first
    second = opt.optimizations(ts, tp, tm, model_generation=2)
    assert second is not first
    assert opt.optimizations(ts, tp, tm, model_generation=1) is not first
    # A partial result is never cached.
    cancelled = SolveBudget()
    cancelled.cancel("user")
    part = opt.optimizations(ts, tp, tm, model_generation=3, budget=cancelled)
    assert part.partial
    assert opt.optimizations(ts, tp, tm, model_generation=3) is not part
    assert not opt.optimizations(ts, tp, tm, model_generation=3).partial
