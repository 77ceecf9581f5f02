"""The port's multi-process solves (``cruise_control_tpu_torch.parallel``)
against its own one-rank solves and the JAX package's mesh path.

No process group is ever initialized in the pytest process: a group left
behind would leak into every later file on the same worker.  Every
multi-rank case runs in two child processes over gloo on the CPU (one spawn
for all the cases that need two live ranks, one for the rank that dies),
each with a timeout.  The JAX package's 8-device mesh solve runs here, while
the children work.

The cluster is ``tests/test_multihost.py``'s: 8 brokers, 4 racks, 10 topics,
192 replicas padded to 256, seed 11, and its three goals.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest

from cruise_control_tpu.analyzer import relax as jrelax
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.model.state import Placement as JPlacement
from cruise_control_tpu.parallel import make_solver_mesh as jax_make_solver_mesh
from cruise_control_tpu.parallel import mesh as jmesh
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu.testing.verifier import verify_placement
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.parallel import make_solver_mesh, mesh
from cruise_control_tpu_torch.testing import random_cluster as trc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROPS = dict(num_brokers=8, num_racks=4, num_topics=10, num_replicas=192,
             mean_cpu=0.01, mean_disk=60.0, mean_nw_in=60.0, mean_nw_out=60.0, seed=11)
GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal"]
SETS = [[0], [1], [2], [3]]
CHILD_TIMEOUT_S = 240
# A dead peer: gloo sees the closed connection at once; the group's timeout
# (heartbeat_timeout_s) bounds a peer that hangs instead.
HEARTBEAT_S = 10
DEATH_MARGIN_S = 5

_CHILD = textwrap.dedent("""
    import hashlib, json, sys
    import numpy as np, torch
    sys.path.insert(0, __REPO__)
    pid = int(sys.argv[1])
    from cruise_control_tpu_torch.analyzer.budget import SolveBudget
    from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
    from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
    from cruise_control_tpu_torch.analyzer.solver import GoalSolver, _top_candidates
    from cruise_control_tpu_torch.fuzzsvc import Materialized, generate_scenario
    from cruise_control_tpu_torch.fuzzsvc.invariants import mesh_parity
    from cruise_control_tpu_torch.parallel import make_solver_mesh, mesh, multihost
    from cruise_control_tpu_torch.testing import random_cluster as rc
    multihost.initialize(__ADDR__, num_processes=2, process_id=pid, device="cpu")
    multihost.initialize(__ADDR__, num_processes=2, process_id=pid, device="cpu")
    out = {"pid": pid, "world": torch.distributed.get_world_size()}

    state, placement, meta = rc.generate(rc.ClusterProperties(**__PROPS__),
                                         pad_replicas_to=256, device="cpu")
    given = placement
    if pid == 1:   # garbage content: rank 0's placement is broadcast
        given = placement.replace(broker=torch.zeros_like(placement.broker))
    def n_groups():
        return len(torch.distributed.distributed_c10d._world.pg_map)
    res = multihost.propose_multihost(state, given, meta, goal_names=__GOALS__)
    out["groups"] = [n_groups()]
    for _ in range(2):    # a mesh per call; its groups are made once
        multihost.propose_multihost(state, given, meta, goal_names=__GOALS__)
        out["groups"].append(n_groups())
    digest = sorted((str(p.topic_partition), tuple(r.broker_id for r in p.new_replicas))
                    for p in res.proposals)
    out["digest"] = hashlib.sha256(json.dumps(digest).encode()).hexdigest()
    out["n_proposals"] = len(res.proposals)
    out["violated_goals_after"] = res.violated_goals_after
    out["balancedness"] = res.balancedness_score
    out["goal_violated"] = [i.violated_brokers_after for i in res.goal_infos]
    out["cv"] = res.stats_after.cv().tolist()
    out["final"] = {f: getattr(res.final_placement, f).tolist()
                    for f in ("broker", "disk", "is_leader")}
    one = GoalOptimizer(goal_names=__GOALS__).optimizations(state, placement, meta)
    out["u_goal_violated"] = [i.violated_brokers_after for i in one.goal_infos]
    out["u_cv"] = one.stats_after.cv().tolist()

    # Aggregates and one round's candidates, sharded against unsharded, on
    # the snapshot (jitter off: the top-k does not read it).
    solver = GoalSolver(mesh=make_solver_mesh(), dst_jitter_frac=0.0)
    gctx = build_context(state, placement, meta, BalancingConstraint(), OptimizationOptions())
    sctx, _ = solver.shard_inputs(gctx, placement)
    out["rows"] = [sctx.shard.lo, sctx.shard.hi]
    # Each rank offers its own decision; both take the first rank's.
    got = sctx.shard.agree(torch.tensor([pid, 7, 3 * pid]), torch.tensor([pid == 1] * 3))
    out["agreed"] = [t.tolist() for t in got] + [str(t.dtype) for t in got]
    a, b = compute_aggregates(gctx, placement), compute_aggregates(sctx, placement)
    out["counts_equal"] = all(torch.equal(getattr(a, f), getattr(b, f)) for f in (
        "replica_counts", "leader_counts", "topic_counts", "topic_leader_counts"))
    out["loads_close"] = all(torch.allclose(getattr(a, f), getattr(b, f), rtol=1e-6, atol=1e-4)
                             for f in ("broker_load", "host_load", "disk_load",
                                       "potential_nw_out", "leader_bytes_in"))
    dist_goal = goal_by_name("ReplicaDistributionGoal")
    lead_goal = goal_by_name("LeaderReplicaDistributionGoal")
    swap_goal = goal_by_name("DiskUsageDistributionGoal")
    scores = {
        "replica": dist_goal.candidate_score(gctx, placement, a),
        "pull": dist_goal.pull_candidate_score(gctx, placement, a),
        "leadership": lead_goal.leadership_candidate_score(gctx, placement, a),
        "swap_out": swap_goal.swap_out_score(gctx, placement, a, 0),
        "swap_in": swap_goal.swap_in_score(gctx, placement, a, 0),
    }
    out["topc"] = {}
    for name, score in scores.items():
        for c in (64, 256):
            uv, ui = _top_candidates(score, c)
            sv, si = _top_candidates(score, c, sctx.shard)
            out["topc"][f"{name}-{c}"] = [torch.equal(ui, si), torch.equal(uv, sv),
                                          int(torch.unique(uv).numel()) < c]
    try:
        GoalOptimizer(goal_names=__GOALS__, mesh=make_solver_mesh()).optimizations(
            state, placement, meta, budget=SolveBudget(deadline_ms=60_000))
        out["budget_refused"] = False
    except ValueError:
        out["budget_refused"] = True

    mesh.reset_calls()
    batch = multihost.batch_remove_scenarios_multihost(
        state, given, meta, __SETS__, goal_names=__GOALS__[:2],
        scenario_parallelism=2, num_candidates=64)
    out["batch_calls"] = dict(mesh.CALLS)
    plain = GoalOptimizer(goal_names=__GOALS__[:2]).batch_remove_scenarios(
        state, placement, meta, __SETS__, num_candidates=64)
    out["batch_stranded"] = batch.stranded_after.tolist()
    out["batch_violated"] = batch.violated_after.tolist()
    out["batch_equal"] = (np.array_equal(batch.stranded_after, plain.stranded_after)
                          and np.array_equal(batch.violated_after, plain.violated_after)
                          and np.array_equal(batch.moves, plain.moves)
                          and all(torch.equal(getattr(batch.final_placements, f),
                                              getattr(plain.final_placements, f))
                                  for f in ("broker", "disk", "is_leader")))
    valid = state.valid
    out["batch_removed_clear"] = all(
        not bool(torch.isin(batch.placement_for(s).broker[valid],
                            torch.tensor([meta.broker_index[b] for b in ids])).any())
        for s, ids in enumerate(__SETS__))

    m = Materialized(generate_scenario(100, kind="uniform_baseline"), device="cpu")
    out["mesh_parity"] = mesh_parity(m)
    out["groups"].append(n_groups())
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
""")

_CHILD_DEATH = textwrap.dedent("""
    import os, sys, time
    import torch
    sys.path.insert(0, __REPO__)
    pid = int(sys.argv[1])
    from cruise_control_tpu_torch.parallel import multihost
    multihost.initialize(__ADDR__, num_processes=2, process_id=pid,
                         heartbeat_timeout_s=__HEARTBEAT__, device="cpu")
    print(f"pid{pid} up", flush=True)
    if pid == 1:
        os._exit(17)          # die abruptly before the collective
    t0 = time.monotonic()
    try:
        multihost.broadcast_from_coordinator(torch.arange(8.0))
        print("pid0 unexpectedly completed", flush=True)
    except Exception as exc:  # the survivor's collective must raise
        print(f"RAISED {time.monotonic() - t0:.3f} {type(exc).__name__}", flush=True)
        os._exit(3)
""")


def _free_addr():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _spawn(tmp_path, name, template, **subs):
    script = tmp_path / name
    text = template.replace("__REPO__", repr(REPO)).replace("__ADDR__", repr(_free_addr()))
    for key, value in subs.items():
        text = text.replace(f"__{key}__", repr(value))
    script.write_text(text)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(script), str(pid)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env) for pid in (0, 1)]


def _communicate(procs, timeout):
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return outs


def _jax_mesh_solve():
    js, jp, jm = jrc.generate(jrc.ClusterProperties(**PROPS), pad_replicas_to=256)
    was_on = jrelax.relaxation_enabled()
    jrelax.set_relaxation(False)
    try:
        res = JOptimizer(goal_names=GOALS, mesh=jax_make_solver_mesh(8)).optimizations(
            js, jp, jm)
    finally:
        jrelax.set_relaxation(was_on)
    return js, jp, jm, res


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    procs = _spawn(tmp_path_factory.mktemp("ranks"), "child.py", _CHILD, PROPS=PROPS,
                   GOALS=GOALS, SETS=SETS)
    try:
        jax_side = _jax_mesh_solve()
    finally:
        outs = _communicate(procs, CHILD_TIMEOUT_S)
    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out[-3000:]
        r = json.loads(line[-1][len("RESULT "):])
        results[r["pid"]] = r
    return results, jax_side


def test_mesh_shapes_equal_jax():
    """Without a process group the mesh is a layout of the asked ranks."""
    for n, s in ((8, 1), (8, 4), (4, 2)):
        assert make_solver_mesh(n, scenario_parallelism=s).shape \
            == dict(jax_make_solver_mesh(n, scenario_parallelism=s).shape)
    with pytest.raises(ValueError):
        make_solver_mesh(8, scenario_parallelism=3)
    with pytest.raises(ValueError):
        jax_make_solver_mesh(8, scenario_parallelism=3)


def test_mesh_coords_and_row_ranges():
    m = make_solver_mesh(8, scenario_parallelism=2)
    assert [m.coords(r) for r in range(8)] == [(r // 4, r % 4) for r in range(8)]
    assert [m.row_range(256, r) for r in (0, 3, 4, 7)] == [(0, 64), (192, 256),
                                                           (0, 64), (192, 256)]
    with pytest.raises(ValueError):
        m.row_range(258, 0)       # R_pad must divide the replica axis


def test_several_ranks_need_a_process_group():
    ts, tp, tm = trc.generate(trc.ClusterProperties(**PROPS), pad_replicas_to=256,
                              device="cpu")
    with pytest.raises(RuntimeError):
        GoalOptimizer(goal_names=GOALS, mesh=make_solver_mesh(2)).optimizations(ts, tp, tm)


@pytest.mark.parametrize("lanes", [None, 4])
def test_spec_for_equal_jax(lanes):
    """The shape rule, leaf by leaf, on the same packed arrays (and their
    lane-stacked form)."""
    js, jp, _ = jrc.generate(jrc.ClusterProperties(**PROPS), pad_replicas_to=256)
    ts, tp, _ = trc.generate(trc.ClusterProperties(**PROPS), pad_replicas_to=256,
                             device="cpu")
    leaves = [(np.asarray(getattr(js, f.name)), getattr(ts, f.name))
              for f in ts.__dataclass_fields__.values()]
    leaves += [(np.asarray(getattr(jp, f)), getattr(tp, f)) for f in ("broker", "disk")]
    if lanes is not None:
        leaves = [(np.stack([j] * lanes), t.expand(lanes, *t.shape)) for j, t in leaves]
    for j, t in leaves:
        assert mesh._spec_for(t, 256, lanes) == tuple(jmesh._spec_for(j, 256, lanes))
    if lanes is None:
        assert mesh.replica_shardings(make_solver_mesh(), tp, 256).broker == ("replica",)
    else:
        stacked = tp.replace(broker=tp.broker.expand(lanes, -1))
        assert mesh.scenario_shardings(make_solver_mesh(), stacked, 256, lanes).broker \
            == ("scenario", "replica")


def test_one_rank_mesh_without_group_equals_unsharded():
    """A one-rank mesh runs every sharded pass (the row slices, the packed
    aggregate sum, the gathered top-k) as identities: the same solve."""
    ts, tp, tm = trc.generate(trc.ClusterProperties(**PROPS, dead_broker_ids=(2,)),
                              pad_replicas_to=256, device="cpu")
    goals = GOALS + ["DiskUsageDistributionGoal", "LeaderReplicaDistributionGoal"]
    a = GoalOptimizer(goal_names=goals, mesh=make_solver_mesh()).optimizations(ts, tp, tm)
    b = GoalOptimizer(goal_names=goals).optimizations(ts, tp, tm)
    for f in ("broker", "disk", "is_leader"):
        assert np.array_equal(getattr(a.final_placement, f).numpy(),
                              getattr(b.final_placement, f).numpy())
    assert [i.rounds for i in a.goal_infos] == [i.rounds for i in b.goal_infos]


def test_broadcast_gives_both_ranks_one_result(two_ranks):
    r0, r1 = two_ranks[0][0], two_ranks[0][1]
    assert r0["world"] == r1["world"] == 2
    assert r0["n_proposals"] == r1["n_proposals"] > 0
    assert r0["digest"] == r1["digest"]
    assert r0["final"] == r1["final"]
    assert r0["violated_goals_after"] == r1["violated_goals_after"] == []


def test_mesh_groups_made_once(two_ranks):
    """Every propose builds a mesh; its scenario groups ((0,) and (1,): a
    rank registers its own, beside the default group) are made by the first
    propose and reused by the next two, by the scenario-parallel batch (whose
    replica groups are the same ranks) and by mesh_parity."""
    for r in two_ranks[0].values():
        assert r["groups"] == [2] * 4


def test_ranks_own_halves_of_the_replica_axis(two_ranks):
    results = two_ranks[0]
    assert [results[0]["rows"], results[1]["rows"]] == [[0, 128], [128, 256]]


def test_agree_takes_the_first_ranks_decision(two_ranks):
    for r in two_ranks[0].values():
        assert r["agreed"] == [[0, 7, 0], [False, False, False], "torch.int64", "torch.bool"]


def test_sharded_aggregates_equal_unsharded(two_ranks):
    for r in two_ranks[0].values():
        assert r["counts_equal"] and r["loads_close"]


@pytest.mark.parametrize("phase", ["replica", "pull", "leadership", "swap_out", "swap_in"])
@pytest.mark.parametrize("c", [64, 256])
def test_sharded_top_candidates_exact(two_ranks, phase, c):
    """The gathered top-C equals one stable sort of all of R, ties to the
    lower row: ids and values exactly."""
    for r in two_ranks[0].values():
        ids_equal, vals_equal, _ = r["topc"][f"{phase}-{c}"]
        assert ids_equal and vals_equal
    if c == 256:   # the whole axis holds ties: the tie order was exercised
        assert two_ranks[0][0]["topc"][f"{phase}-{c}"][2]


def test_sharded_solve_matches_unsharded_per_goal(two_ranks):
    for r in two_ranks[0].values():
        assert r["goal_violated"] == r["u_goal_violated"]
        np.testing.assert_allclose(r["cv"], r["u_cv"], rtol=0.05, atol=5e-3)


def test_sharded_solve_no_worse_than_jax_mesh_path(two_ranks):
    """Judged by the JAX package's verifier against its own 8-device mesh
    solve of the same snapshot: violated goals and balancedness no worse."""
    results, (js, jp, jm, jres) = two_ranks
    final = results[0]["final"]
    port_pl = JPlacement(broker=jnp.asarray(final["broker"], dtype=jnp.int32),
                         disk=jnp.asarray(final["disk"], dtype=jnp.int32),
                         is_leader=jnp.asarray(final["is_leader"]))
    failures = verify_placement(js, jp, jm, port_pl, goal_names=GOALS,
                                verifications=("GOAL_VIOLATION", "DEAD_BROKERS"))
    assert failures == []
    assert len(results[0]["violated_goals_after"]) <= len(jres.violated_goals_after)
    assert results[0]["balancedness"] >= jres.balancedness_score


def test_budget_refused_on_a_multi_rank_mesh(two_ranks):
    assert all(r["budget_refused"] for r in two_ranks[0].values())


def test_scenario_parallel_batch_equals_unsharded(two_ranks):
    r0, r1 = two_ranks[0][0], two_ranks[0][1]
    assert r0["batch_stranded"] == r1["batch_stranded"] == [0, 0, 0, 0]
    assert r0["batch_violated"] == r1["batch_violated"]
    assert r0["batch_equal"] and r1["batch_equal"]
    assert r0["batch_removed_clear"] and r1["batch_removed_clear"]
    # Two lanes a scenario coordinate, one gather of the block to both.
    assert r0["batch_calls"]["all_gather"] >= 1


def test_mesh_parity_invariant_at_world_two(two_ranks):
    for r in two_ranks[0].values():
        assert r["mesh_parity"] == []


def test_dead_rank_makes_survivor_raise(tmp_path):
    """The counterpart of ``test_worker_death_terminates_survivor_crisply``:
    rank 1 exits after joining; rank 0's next collective raises (gloo sees
    the closed connection) within the group timeout plus a margin."""
    procs = _spawn(tmp_path, "death.py", _CHILD_DEATH, HEARTBEAT=HEARTBEAT_S)
    t0 = time.monotonic()
    out0, out1 = _communicate(procs, CHILD_TIMEOUT_S)
    assert procs[1].returncode == 17, out1[-2000:]
    assert procs[0].returncode == 3, out0[-3000:]
    assert "pid0 unexpectedly completed" not in out0
    raised = [ln for ln in out0.splitlines() if ln.startswith("RAISED ")]
    assert raised, out0[-3000:]
    assert float(raised[0].split()[1]) < HEARTBEAT_S + DEATH_MARGIN_S
    assert time.monotonic() - t0 < CHILD_TIMEOUT_S
