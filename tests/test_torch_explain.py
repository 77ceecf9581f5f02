"""Move provenance and ``?explain=true`` against the JAX package.

Counterpart of ``tests/test_execution_obs.py``'s provenance test: the
port's optimizer stamps every proposal with the goal, path, round and cost
delta of the pass that last changed its partition, as the JAX optimizer does
(``analyzer/optimizer.py:407-417, 480-502, 566-578, 620-627``), and
``OptimizerResult.to_dict(explain=True)`` renders them with the path
histogram and the model fingerprint.

On the BASELINE #1 DeterministicCluster fixtures named in ``FIXTURES`` both
packages give equal proposals on the CPU, greedy and with the relaxation on;
there the per-proposal provenance must equal JAX's (``solveId`` aside: each
package numbers its own solves).  On a generated cluster, where the two
packages' placements may differ (float sums in another order), the path
histogram's keys and each record's fields are compared.  With the
observatory on and off the final placement and the aggregate's calls are the
same: provenance stays off the solver's path.
"""

import json
import threading

import pytest
import torch

from cruise_control_tpu.analyzer import relax as jrelax
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer.solver import GoalSolver as JSolver
from cruise_control_tpu.obsvc.convergence import convergence as jconvergence
from cruise_control_tpu.obsvc.execution import execution as jexecution
from cruise_control_tpu.servlet.schemas import ENDPOINT_SCHEMAS as J_SCHEMAS
from cruise_control_tpu.servlet.schemas import validate as jvalidate
from cruise_control_tpu.testing import deterministic as jdet
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer import context
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.relax import RelaxationConfig
from cruise_control_tpu_torch.facade import OperationResult
from cruise_control_tpu_torch.obsvc.convergence import convergence
from cruise_control_tpu_torch.obsvc.execution import PATHS, execution
from cruise_control_tpu_torch.servlet.schemas import ENDPOINT_SCHEMAS, validate
from cruise_control_tpu_torch.testing import deterministic as tdet
from cruise_control_tpu_torch.testing import random_cluster as trc

PADS = dict(pad_replicas_to=64, pad_brokers_to=8)
GREEDY = ["RackAwareGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal"]
RELAXED = ["ReplicaCapacityGoal", "ReplicaDistributionGoal"]
# The fixtures on which both packages give equal proposals on the CPU, with
# moves to attribute: (fixture, goals, relaxation on).
FIXTURES = [("unbalanced", GREEDY, False), ("unbalanced2", GREEDY, False),
            ("unbalanced3", GREEDY, False), ("rack_aware_satisfiable", GREEDY, False),
            ("small_cluster_model", GREEDY, False), ("unbalanced", RELAXED, True),
            ("unbalanced2", RELAXED, True), ("unbalanced3", RELAXED, True)]
GENERATED = dict(num_brokers=8, num_racks=4, num_topics=12, num_replicas=256, seed=11)
GENERATED_GOALS = ["ReplicaDistributionGoal"]
RECORD_FIELDS = {"goal", "path", "round", "costDelta", "solveId"}


@pytest.fixture(autouse=True)
def observatories():
    """Both packages' execution observatories and convergence recorders on
    (the solve id comes from the latter), restored afterwards."""
    recs, convs = (execution(), jexecution()), (convergence(), jconvergence())
    saved = [r.enabled for r in recs], [(c.enabled, c._ring.maxlen) for c in convs]
    for r in recs:
        r.configure(enabled=True)
    for c in convs:
        c.configure(enabled=True, ring_size=c._ring.maxlen)
    yield
    for r, enabled in zip(recs, saved[0]):
        r.configure(enabled=enabled)
        r.reset()
    for c, (enabled, ring) in zip(convs, saved[1]):
        c.configure(enabled=enabled, ring_size=ring)
        c.reset()


@pytest.fixture(scope="module")
def jsolver():
    """This file's own JAX solver, shared by its tests so that they share its
    compiles.  The JAX optimizer's default is the process-wide
    ``default_solver()``, whose round cache would keep this file's relaxed
    solves' keys for later files on the same worker."""
    return JSolver()


def _jax_solve(cm, goals, relaxed, solver):
    """The JAX package's solve on ``solver``; its relaxation switch is
    process-wide, so it is set for this solve only."""
    state, placement, meta = cm.freeze(**PADS)
    jrelax.set_relaxation(relaxed)
    try:
        return JOptimizer(goal_names=goals, solver=solver).optimizations(state, placement, meta)
    finally:
        jrelax.set_relaxation(False)


def _port_solve(cm, goals, relaxed):
    state, placement, meta = cm.freeze(device="cpu", **PADS)
    opt = GoalOptimizer(goal_names=goals, relaxation=RelaxationConfig() if relaxed else None)
    return opt.optimizations(state, placement, meta)


def _by_partition(result):
    out = {}
    for p in result.proposals:
        prov = dict(p.provenance)
        prov.pop("solveId")
        out[str(p.topic_partition)] = (
            tuple((r.broker_id, r.logdir) for r in p.new_replicas), prov)
    return out


@pytest.mark.parametrize("name,goals,relaxed", FIXTURES,
                         ids=[f"{n}-{'relax' if r else 'greedy'}" for n, _, r in FIXTURES])
def test_provenance_equals_jax_on_deterministic_fixtures(name, goals, relaxed, jsolver):
    jres = _jax_solve(getattr(jdet, name)(), goals, relaxed, jsolver)
    tres = _port_solve(getattr(tdet, name)(), goals, relaxed)
    assert tres.proposals
    assert _by_partition(tres) == _by_partition(jres)
    solve_ids = {p.provenance["solveId"] for p in tres.proposals}
    assert len(solve_ids) == 1 and isinstance(solve_ids.pop(), int)
    expected = "repair" if relaxed else "greedy"
    assert {p.provenance["path"] for p in tres.proposals} == {expected}


def test_provenance_fields_equal_jax_on_a_generated_cluster(jsolver):
    """Where the placements may differ, the histogram's keys and every
    record's fields and types are the JAX package's.  One goal: the JAX
    side compiles anew for this cluster's shapes."""
    props = dict(GENERATED)
    js, jp, jm = jrc.generate(jrc.ClusterProperties(**props))
    ts, tp, tm = trc.generate(trc.ClusterProperties(**props), device="cpu")
    jres = JOptimizer(goal_names=GENERATED_GOALS, solver=jsolver).optimizations(js, jp, jm)
    tres = GoalOptimizer(goal_names=GENERATED_GOALS).optimizations(ts, tp, tm)
    jd, td = jres.to_dict(explain=True), tres.to_dict(explain=True)
    assert set(td["provenancePaths"]) == set(jd["provenancePaths"]) <= set(PATHS)
    assert sum(td["provenancePaths"].values()) == len(tres.proposals) > 0
    for entry in td["proposals"]:
        prov = entry["provenance"]
        assert set(prov) == RECORD_FIELDS
        assert prov["goal"] in GENERATED_GOALS and prov["path"] in PATHS
        assert type(prov["round"]) is int and type(prov["costDelta"]) is float
    jtypes = {k: type(v) for k, v in jd["proposals"][0]["provenance"].items()}
    ttypes = {k: type(v) for k, v in td["proposals"][0]["provenance"].items()}
    assert ttypes == jtypes


def _counting(monkeypatch):
    calls = []
    orig = context.broker_channel_sums

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(context, "broker_channel_sums", counted)
    return calls


@pytest.mark.parametrize("relaxed", [False, True], ids=["greedy", "relax"])
def test_observatory_on_and_off_same_placement_and_launches(monkeypatch, relaxed):
    """Acceptance (``tests/test_execution_obs.py:30``): provenance is
    bookkeeping beside the solve.  The same final placement, the same
    proposals and the same aggregate calls with the observatory on or off."""
    calls = _counting(monkeypatch)
    props = dict(GENERATED)
    state, placement, meta = trc.generate(trc.ClusterProperties(**props), device="cpu")
    goals = RELAXED if relaxed else GREEDY
    runs = {}
    for enabled in (False, True):
        execution().configure(enabled=enabled)
        opt = GoalOptimizer(goal_names=goals,
                            relaxation=RelaxationConfig() if relaxed else None)
        del calls[:]
        runs[enabled] = (opt.optimizations(state, placement, meta), len(calls))
    (off, off_calls), (on, on_calls) = runs[False], runs[True]
    for f in ("broker", "disk", "is_leader"):
        assert torch.equal(getattr(on.final_placement, f), getattr(off.final_placement, f))
    assert on_calls == off_calls > 0
    assert [p.topic_partition for p in on.proposals] == [p.topic_partition for p in off.proposals]
    assert all(p.provenance is None for p in off.proposals)
    assert all(p.provenance["path"] in PATHS for p in on.proposals)


def test_explain_rendering_is_plain_json_and_passes_both_schema_checkers(jsolver):
    """``?explain=true`` adds the proposals, the path histogram and the
    fingerprint only when asked; every number is a plain Python one (the
    server writes with ``json.dumps`` and no ``default=``), and the body
    passes both packages' response schemas."""
    res = _port_solve(tdet.unbalanced2(), GREEDY, False)
    plain = res.to_dict()
    assert "proposals" not in plain and "provenancePaths" not in plain
    op = OperationResult(res, dryrun=True, executed=False)
    for explain in (False, True):
        body = json.loads(json.dumps(op.to_dict(explain=explain)))
        body["version"] = 1
        validate(body, ENDPOINT_SCHEMAS["rebalance"])
        jvalidate(body, J_SCHEMAS["rebalance"])
    explained = op.to_dict(explain=True)["result"]
    assert explained["provenancePaths"] == {"greedy": len(res.proposals)}
    assert [e["provenance"] for e in explained["proposals"]] == \
        [p.provenance for p in res.proposals]
    assert "modelFingerprint" in explained
    jres = _jax_solve(jdet.unbalanced2(), GREEDY, False, jsolver)
    assert set(explained) == set(jres.to_dict(explain=True))


def test_a_failed_relaxation_is_plain_greedy(monkeypatch):
    """A relaxation that regresses its goal falls back to the greedy pass
    from the original placement, and its info carries no rounded placement:
    the moves count as greedy, as in the JAX package."""
    from cruise_control_tpu_torch.analyzer import relax

    orig = relax.relax_round

    def worse(goal, priors, gctx, placement, agg, *args):
        out = orig(goal, priors, gctx, placement, agg, *args)
        # Report a pre-relax metric of 0: any repair then reads as a regression.
        return out[:4] + (torch.zeros_like(out[4]),)

    monkeypatch.setattr(relax, "relax_round", worse)
    res = _port_solve(tdet.unbalanced2(), RELAXED, True)
    info = next(i for i in res.goal_infos if i.goal_name == "ReplicaDistributionGoal")
    assert info.relax_fallback
    assert {p.provenance["path"] for p in res.proposals} == {"greedy"}
    assert all(i.rounded is None for i in res.goal_infos)


def test_concurrent_relaxed_solves_keep_their_own_provenance():
    """Each relaxed pass hands its rounded placement to its own solve on the
    goal's info; nothing is process-wide.  Two relaxed solves on two threads
    at once (the server's handler and user-task threads) stamp what each
    stamps alone (five rounds, so that the two interleave)."""
    names = ("unbalanced", "unbalanced2")
    alone = {n: _by_partition(_port_solve(getattr(tdet, n)(), RELAXED, True)) for n in names}
    assert {prov["path"] for n in names for _, prov in alone[n].values()} == {"repair"}
    for _ in range(5):
        start, got = threading.Barrier(len(names)), {}

        def solve(n):
            cm = getattr(tdet, n)()
            start.wait()
            got[n] = _by_partition(_port_solve(cm, RELAXED, True))

        threads = [threading.Thread(target=solve, args=(n,)) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert got == alone
