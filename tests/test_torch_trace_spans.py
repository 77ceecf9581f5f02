"""The analyzer's spans: the tree of a what-if batch and of a proposal, the
``torch.profiler`` mirror of every span, and the tracer's silence when it is
off.

A what-if batch's ``batch_optimize`` holds ``lanes.setup``, ``lanes.plan``,
one ``lanes.block`` per planned block (its ``lanes.context`` and one
``goal.<Goal>`` per real lane and goal) and ``lanes.result``; each goal solve
is partitioned into ``solve.enter``, its ``solve.round``s (each its
``phase.<name>``s and ``round.stats``) and ``solve.exit``.  A proposal's
``optimize`` holds the JAX package's ``goal.<Goal>`` and ``polish.<Goal>``.
"""

import gc
import importlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.testing import random_cluster as trc

# Both packages' obsvc/__init__ export a function named like the module, so
# the modules come by name.
jtracer = importlib.import_module("cruise_control_tpu.obsvc.tracer")
tracer = importlib.import_module("cruise_control_tpu_torch.obsvc.tracer")

PROPS = dict(num_brokers=16, num_racks=4, num_topics=20, num_replicas=600, seed=3)
GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal", "ReplicaDistributionGoal"]
SETS = [[0], [1], [2], [3]]
WIDTH = 64
PHASES = {"phase.direct", "phase.leadership", "phase.replica", "phase.pull", "phase.swap",
          "phase.intra_disk"}


@pytest.fixture(scope="module")
def cluster():
    return trc.generate(trc.ClusterProperties(**PROPS), device="cpu")


@pytest.fixture
def port_tracer():
    """The port's tracer, empty, restored to its state after the test."""
    tr = tracer.tracer()
    was = tr.enabled
    tr.reset()
    yield tr
    tr.configure(enabled=was, ring_size=32)
    tr.reset()


def _batch(cluster):
    st, pl, mt = cluster
    return GoalOptimizer(goal_names=GOALS).batch_remove_scenarios(st, pl, mt, SETS,
                                                                  num_candidates=WIDTH)


@pytest.fixture(scope="module")
def traced_batch(cluster):
    """(result, span tree) of a 4-lane batch with tracing on.  The cyclic
    collector is held off while it runs: a collection of the test process's
    heap, triggered by whichever allocation, is no part of the solve."""
    tr = tracer.tracer()
    was = tr.enabled
    tr.configure(enabled=True, ring_size=32)
    tr.reset()
    gc.collect()
    gc.disable()
    try:
        res = _batch(cluster)
        trees = tr.traces()
    finally:
        gc.enable()
        tr.configure(enabled=was, ring_size=32)
        tr.reset()
    assert len(trees) == 1
    return res, trees[0]


def _walk(d):
    yield d
    for c in d.get("children", ()):
        yield from _walk(c)


def _names(d):
    return [c["name"] for c in d.get("children", ())]


def _goal_spans(tree):
    """[(block's first lane, goal span)] in the order the batch ran them."""
    out, first = [], 0
    for block in (c for c in tree["children"] if c["name"] == "lanes.block"):
        out += [(first, g) for g in block["children"] if g["name"].startswith("goal.")]
        first += block["attrs"]["real"]
    return out


def test_batch_tree_names_and_nesting(traced_batch):
    res, tree = traced_batch
    assert tree["name"] == "batch_optimize"
    assert tree["attrs"] == {"lanes": len(SETS), "warm_start": False}
    kids = _names(tree)
    assert kids[:2] == ["lanes.setup", "lanes.plan"] and kids[-1] == "lanes.result"
    assert set(kids[2:-1]) == {"lanes.block"}
    blocks = [c for c in tree["children"] if c["name"] == "lanes.block"]
    assert len(blocks) == tree["children"][1]["attrs"]["blocks"]
    assert sum(b["attrs"]["real"] for b in blocks) == len(SETS)
    for block in blocks:
        assert block["attrs"]["width"] >= block["attrs"]["real"]
        names = _names(block)
        assert names[0] == "lanes.context"
        # Goal by goal, every real lane of the block.
        assert names[1:] == [f"goal.{g}" for g in GOALS for _ in range(block["attrs"]["real"])]
    for _, goal in _goal_spans(tree):
        names = _names(goal)
        assert names[0] == "solve.enter" and names[-1] == "solve.exit"
        assert set(names[1:-1]) <= {"solve.round"}
        for r, rnd in enumerate(goal["children"][1:-1]):
            # The CPU runs every round eagerly, and says so.
            assert rnd["attrs"] == {"round": r, "graph": "eager:cpu"}
            assert _names(rnd)[-1] == "round.stats" and set(_names(rnd)[:-1]) <= PHASES
            assert len(_names(rnd)) >= 2
    # One goal span per real lane and goal.
    assert len(_goal_spans(tree)) == len(SETS) * len(GOALS) == res.rounds.size


def test_goal_spans_carry_the_batch_rounds(traced_batch):
    res, tree = traced_batch
    assert res.goal_names == GOALS
    got = {}
    for first, goal in _goal_spans(tree):
        lane = first + goal["attrs"]["lane"]
        g = GOALS.index(goal["name"].split(".", 1)[1])
        got[lane, g] = goal["attrs"]["rounds"]
        assert _names(goal).count("solve.round") == goal["attrs"]["rounds"]
        assert goal["attrs"]["moves"] == int(res.moves[lane, g])
    assert got == {(s, g): int(res.rounds[s, g]) for s in range(len(SETS))
                   for g in range(len(GOALS))}
    assert res.rounds.sum() > 0          # the fixture runs rounds


def test_enter_rounds_and_exit_cover_each_goal(traced_batch):
    _, tree = traced_batch
    goals = [g for _, g in _goal_spans(tree)]
    covered = sum(c["wall_ms"] for g in goals for c in g["children"])
    assert covered <= sum(g["wall_ms"] for g in goals)
    assert covered >= 0.95 * sum(g["wall_ms"] for g in goals)
    # The batch's own children cover its wall too.
    assert sum(c["wall_ms"] for c in tree["children"]) >= 0.9 * tree["wall_ms"]


PORT_GOAL_ATTRS = ("hard", "end", "swaps", "leader_moves")


def test_optimize_tree_holds_the_jax_packages_names(cluster, port_tracer):
    goals = ["RackAwareGoal", "ReplicaDistributionGoal"]
    jt = jtracer.tracer()
    jwas = jt.enabled
    jt.configure(enabled=True, ring_size=32)
    jt.reset()
    port_tracer.configure(enabled=True, ring_size=32)
    try:
        st, pl, mt = jrc.generate(jrc.ClusterProperties(**PROPS))
        JOptimizer(goal_names=goals).optimizations(st, pl, mt, model_generation=5)
        jtree = jt.traces()[-1]
        GoalOptimizer(goal_names=goals).optimizations(*cluster, model_generation=5)
        tree = port_tracer.traces()[-1]
    finally:
        jt.configure(enabled=jwas, ring_size=32)
        jt.reset()
    for t in (jtree, tree):
        assert t["name"] == "optimize"
        assert t["attrs"] == {"num_goals": len(goals), "generation": 5}
        names = _names(t)
        assert [n for n in names if n.startswith("goal.")] == [f"goal.{g}" for g in goals]
        assert set(names) <= {f"{k}.{g}" for k in ("goal", "polish") for g in goals}
    jattrs = {c["name"]: c["attrs"] for c in jtree["children"]}
    for c in tree["children"]:
        # The port's goal spans also say whether the goal is hard, why its
        # loop ended, and its swaps and leadership moves.
        own = set(PORT_GOAL_ATTRS) if c["name"].startswith("goal.") else set()
        assert {"bucket", "rounds", "moves"} | own <= set(c["attrs"]) <= \
            set(jattrs.get(c["name"], ())) | own
        assert c["attrs"]["bucket"] == jattrs[c["name"]]["bucket"]
        assert _names(c)[0] == "solve.enter" and _names(c)[-1] == "solve.exit"


def test_profiler_window_records_and_mirrors_spans(cluster, port_tracer):
    assert not port_tracer.enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _batch(cluster)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("cc.")]
    roots = [e for e in events if e[0] == "cc.batch_optimize"]
    goals = [e for e in events if e[0].startswith("cc.goal.")]
    rounds = [e for e in events if e[0] == "cc.solve.round"]
    assert len(roots) == 1 and len(goals) == len(SETS) * len(GOALS) and rounds
    _, lo, hi, tid = roots[0]
    assert {e[3] for e in events} == {tid}
    assert all(lo <= s and e <= hi for _, s, e, _ in events)
    assert all(any(gs <= s and e <= ge for _, gs, ge, _ in goals) for _, s, e, _ in rounds)
    # The ring holds the same tree, recorded with tracing off.
    trees = port_tracer.traces()
    assert [t["name"] for t in trees] == ["batch_optimize"]
    spans = list(_walk(trees[0]))
    assert sum(s["name"].startswith("goal.") for s in spans) == len(goals)
    assert sum(s["name"] == "solve.round" for s in spans) == len(rounds)
    assert {f"cc.{s['name']}" for s in spans} == {e[0] for e in events}
    # Outside the window the tracer is off again.
    assert port_tracer.span("after") is tracer._NOOP_CTX


def test_off_without_profiler_allocates_no_span(cluster, port_tracer, monkeypatch):
    class NoSpan:
        def __init__(self, *args, **kwargs):
            raise AssertionError("a span was allocated with tracing off")

    monkeypatch.setattr(tracer, "Span", NoSpan)
    assert not port_tracer.enabled
    assert port_tracer.span("x", a=1) is port_tracer.span("y") is tracer._NOOP_CTX
    res = _batch(cluster)
    GoalOptimizer(goal_names=GOALS[:2]).optimizations(*cluster)
    assert res.rounds.sum() > 0
    assert port_tracer.traces() == [] and port_tracer.rollup() == {}
    assert port_tracer.current() is None


HOST_READS = ("tolist", "item", "cpu", "numpy", "__bool__")


def test_spans_add_no_host_read_or_device_sync(cluster, port_tracer, monkeypatch):
    """The same batch reads device values back as often, and synchronises the
    device as often, with tracing on as with it off."""
    counts = {}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, counted(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch.cuda, "synchronize", counted("synchronize", torch.cuda.synchronize))
    seen = []
    for enabled in (False, True, False):
        port_tracer.configure(enabled=enabled, ring_size=32)
        counts.clear()
        _batch(cluster)
        seen.append(dict(counts))
    assert port_tracer.traces()[0]["name"] == "batch_optimize"
    assert seen[0] == seen[1] == seen[2]
    assert seen[0]["tolist"] > 0 and "synchronize" not in seen[0]
