"""The port's sensor registry and tracer, and the analyzer's sensors in it.

The registry, its Prometheus-name guard and the tracer are the JAX
package's, copied; the same operations must give the same names, kinds and
counts in both.  The analyzer's sensors (proposal timer, preemption family,
provisioning and balancedness gauges, the relaxation's family) must move by
the same amounts in the two packages' registries for the same budgeted and
relaxed solves.
"""

import importlib

import numpy as np
import pytest

from cruise_control_tpu.analyzer import relax as jrelax
from cruise_control_tpu.analyzer.budget import SolveBudget as JBudget
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer.solver import GoalSolver as JSolver
from cruise_control_tpu.common import metrics as jmetrics
from cruise_control_tpu.testing import deterministic as jdet
from cruise_control_tpu_torch.analyzer import relax
from cruise_control_tpu_torch.analyzer.budget import SolveBudget
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.common import metrics
from cruise_control_tpu_torch.common.exceptions import OptimizationFailureError
from cruise_control_tpu_torch.testing import deterministic as tdet
from cruise_control_tpu_torch.testing import random_cluster as trc

PADS = dict(pad_replicas_to=64, pad_brokers_to=8)
GOALS = ["ReplicaCapacityGoal", "ReplicaDistributionGoal"]
PREEMPTION = ("Solver.partial-solves", "Solver.preemptions", "Solver.cancellations")
RELAX = ("Solver.relax.attempts", "Solver.relax.fallbacks")
# Both packages' obsvc/__init__ export a function named like the module, so
# the modules come by name.
jtracer = importlib.import_module("cruise_control_tpu.obsvc.tracer")
tracer = importlib.import_module("cruise_control_tpu_torch.obsvc.tracer")


@pytest.fixture
def jax_relaxation():
    """The JAX package's relaxation switch is process-wide: off unless a
    test turns it on, and restored after."""
    was_on = jrelax.relaxation_enabled()
    jrelax.set_relaxation(False)
    yield jrelax.set_relaxation
    jrelax.set_relaxation(was_on)


def _counts(reg, names):
    return [reg.counter(n).count for n in names]


def _delta(before, reg, names):
    return [a - b for a, b in zip(_counts(reg, names), before)]


def _both(jax_call, port_call, names):
    """Counter deltas of each package's registry over its own call."""
    jb, tb = _counts(jmetrics.registry(), names), _counts(metrics.registry(), names)
    jres, tres = jax_call(), port_call()
    return (_delta(jb, jmetrics.registry(), names), jres), \
        (_delta(tb, metrics.registry(), names), tres)


@pytest.mark.parametrize("how", ["cancelled", "deadline_passed"])
def test_budgeted_solve_moves_the_same_counters(how, jax_relaxation):
    def budget(cls):
        # A clock that moves a second a read: the 1 ms deadline has passed
        # at the first check.
        ticks = iter(range(1, 1000))
        b = (cls(deadline_ms=1.0, clock=lambda: float(next(ticks)))
             if how == "deadline_passed" else cls())
        if how == "cancelled":
            b.cancel("user")
        return b

    js, jp, jm = jdet.unbalanced2().freeze(**PADS)
    ts, tp, tm = tdet.unbalanced2().freeze(device="cpu", **PADS)
    (jd, jres), (td, tres) = _both(
        lambda: JOptimizer(goal_names=GOALS).optimizations(js, jp, jm, budget=budget(JBudget)),
        lambda: GoalOptimizer(goal_names=GOALS).optimizations(ts, tp, tm,
                                                              budget=budget(SolveBudget)),
        PREEMPTION)
    assert jres.partial and tres.partial
    assert td == jd == [1, len(GOALS), 1 if how == "cancelled" else 0]


def test_relaxed_solve_moves_the_same_counters(jax_relaxation):
    js, jp, jm = jdet.unbalanced2().freeze(**PADS)
    ts, tp, tm = tdet.unbalanced2().freeze(device="cpu", **PADS)
    goals = ["ReplicaDistributionGoal"]

    def jax_solve():
        # A solver of its own: the process-wide default_solver() would keep
        # the relaxed solve's cache keys for later files on this worker.
        jax_relaxation(True)
        try:
            return JOptimizer(goal_names=goals, solver=JSolver()).optimizations(js, jp, jm)
        finally:
            jax_relaxation(False)

    (jd, jres), (td, tres) = _both(
        jax_solve,
        lambda: GoalOptimizer(goal_names=goals, relaxation=relax.RelaxationConfig())
        .optimizations(ts, tp, tm), RELAX)
    assert td == jd and td[0] == 1
    assert [i.relaxed for i in tres.goal_infos] == [i.relaxed for i in jres.goal_infos]
    jsnap, tsnap = jmetrics.registry().snapshot(), metrics.registry().snapshot()
    for name in ("Solver.relax.fractional-moves", "Solver.relax.repair-rounds"):
        assert tsnap[name]["value"] == jsnap[name]["value"], name


def test_solve_sets_timer_and_gauges_like_jax(jax_relaxation):
    """One converged solve: the proposal timer counts it, the cluster is
    right-sized, and the balancedness and per-goal gauges hold its result."""
    js, jp, jm = jdet.unbalanced2().freeze(**PADS)
    ts, tp, tm = tdet.unbalanced2().freeze(device="cpu", **PADS)
    timer = "GoalOptimizer.proposal-computation-timer"
    jb = jmetrics.registry().timer(timer).stats()["count"]
    tb = metrics.registry().timer(timer).stats()["count"]
    jres = JOptimizer(goal_names=GOALS).optimizations(js, jp, jm)
    tres = GoalOptimizer(goal_names=GOALS).optimizations(ts, tp, tm)
    assert metrics.registry().timer(timer).stats()["count"] - tb == \
        jmetrics.registry().timer(timer).stats()["count"] - jb == 1
    jsnap, tsnap = jmetrics.registry().snapshot(), metrics.registry().snapshot()
    for name in ("AnomalyDetector.under-provisioned", "AnomalyDetector.right-sized",
                 "AnomalyDetector.over-provisioned"):
        assert tsnap[name]["value"] == jsnap[name]["value"], name
    assert tsnap["AnomalyDetector.right-sized"]["value"] == 1
    assert tsnap["AnomalyDetector.balancedness-score"]["value"] == tres.balancedness_score
    assert tres.balancedness_score == jres.balancedness_score
    for i in tres.goal_infos:
        assert tsnap[f"Solver.{i.goal_name}.rounds"]["value"] == i.rounds
        assert tsnap[f"Solver.{i.goal_name}.moves"]["value"] == i.moves_applied


def test_failed_hard_goal_marks_under_provisioned():
    """An evacuation that cannot fit raises, and the gauges say so."""
    props = dict(num_brokers=6, num_racks=3, num_topics=4, num_replicas=120,
                 dead_broker_ids=(0, 1, 2, 3), seed=2)
    st, pl, mt = trc.generate(trc.ClusterProperties(**props), device="cpu")
    with pytest.raises(OptimizationFailureError):
        GoalOptimizer(goal_names=["RackAwareGoal"]).optimizations(st, pl, mt)
    snap = metrics.registry().snapshot()
    assert snap["AnomalyDetector.under-provisioned"]["value"] == 1
    assert snap["AnomalyDetector.right-sized"]["value"] == 0


def test_lanes_cut_by_a_budget_count_a_preemption():
    st, pl, mt = tdet.unbalanced2().freeze(device="cpu", **PADS)
    b = SolveBudget()
    b.cancel("user")
    before = _counts(metrics.registry(), PREEMPTION)
    res = GoalOptimizer(goal_names=GOALS).batch_remove_scenarios(st, pl, mt, [[0]], budget=b)
    assert res.preempted
    assert _delta(before, metrics.registry(), PREEMPTION) == [1, 1, 1]


def test_sensor_families_registered_before_any_solve():
    GoalOptimizer(relaxation=relax.RelaxationConfig())
    names = set(metrics.registry().names())
    assert set(PREEMPTION) | set(RELAX) | {
        "Solver.relax.repair-rounds", "Solver.relax.quality-delta",
        "Solver.relax.fractional-moves"} <= names


def _exercise(mod):
    """The same registry operations on a fresh registry of either package:
    what it exports, and what each bad registration raises."""
    reg = mod.MetricRegistry()
    reg.counter("Executor.moves").inc(3)
    reg.timer("LoadMonitor.cluster-model-creation-timer").update_ms(5.0)
    reg.timer("LoadMonitor.cluster-model-creation-timer").update_ms(7.0)
    reg.gauge("Model.gauge", lambda: 1.5)
    reg.gauge("Model.gauge", lambda: 2.5)            # a later closure replaces it
    reg.gauge("Model.broken", lambda: 1 / 0)
    reg.settable_gauge("AnomalyDetector.right-sized").set(True)
    errors = []
    for make in (lambda: reg.counter("Executor_moves"),       # sanitizes alike
                 lambda: reg.timer("Executor.moves"),         # another kind
                 lambda: reg.settable_gauge("Model.gauge")):
        try:
            make()
        except ValueError as e:
            errors.append(str(e))
    snap = reg.snapshot()
    for rec in snap.values():
        rec.pop("one_min_rate", None)
    return snap, errors, reg.names(), reg.prometheus_text().count("\n")


def test_registry_behaves_like_jax():
    assert _exercise(metrics) == _exercise(jmetrics)
    assert metrics.registry() is metrics.registry()


def _span_tree(mod):
    t = mod.Tracer(enabled=True, ring_size=2)
    with t.span("outer", kind="propose") as outer:
        with t.span("model.freeze", replicas=3):
            pass
        with t.span("model.transfer") as sp:
            sp.set("device_ms", 0.0)
        outer.set("goals", 2)
    with pytest.raises(KeyError):
        with t.span("failing"):
            raise KeyError("x")
    rollup = t.rollup(reset=True)
    trees = t.traces()

    def shape(d):
        return (d["name"], sorted(d.get("attrs", {})), [shape(c) for c in d.get("children", [])])

    off = mod.Tracer()
    with off.span("ignored") as sp:
        sp.set("a", 1)
    return ([shape(d) for d in trees], {k: v["count"] for k, v in rollup.items()},
            t.rollup(), off.traces(), off.current())


def test_tracer_behaves_like_jax():
    assert _span_tree(tracer) == _span_tree(jtracer)
    before = metrics.registry().timer("Trace.model.freeze").stats()["count"]
    t = tracer.tracer()
    was = t.enabled
    t.configure(enabled=True, ring_size=32)
    try:
        with t.span("model.freeze"):
            pass
    finally:
        t.configure(enabled=was, ring_size=32)
    assert metrics.registry().timer("Trace.model.freeze").stats()["count"] == before + 1
    assert np.isfinite(t.rollup()["model.freeze"]["total_ms"])
