"""The port's verifier and ``model/ops.py`` helpers against the JAX package's.

Counterparts of ``tests/test_verifier_failures.py`` (each broken placement
gives the same ``(check, detail)`` list in both packages) and of
``tests/test_model.py:71-101`` (the segment-sum helpers on the
DeterministicCluster fixtures), plus every helper of the port's
``model/ops.py`` held against JAX's on fixtures and a seeded random
cluster.  Both packages generate the same cluster from the same seed (the
generators share their numpy draws), which the fixture checks first.
Integer outputs are compared exactly; float sums of the same f32 values in
another order with ``rtol=1e-6, atol=1e-4`` (tests/test_ops.py's bar).
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.model import ops as jops
from cruise_control_tpu.testing import deterministic as jdet
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu.testing import verifier as jver
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model import ops
from cruise_control_tpu_torch.model.state import state_to_numpy
from cruise_control_tpu_torch.testing import deterministic as det
from cruise_control_tpu_torch.testing import random_cluster as rc
from cruise_control_tpu_torch.testing import verifier as tver
from cruise_control_tpu_torch.testing.verifier import VerificationFailure, verify_placement

TOL = dict(rtol=1e-6, atol=1e-4)
SMALL = dict(num_brokers=6, num_racks=3, num_topics=5, num_replicas=48,
             min_replication=3, max_replication=3, mean_cpu=0.02, num_disks=1, seed=11)
PADS = dict(pad_replicas_to=64, pad_brokers_to=8)


def _pair(**extra):
    j = jrc.generate(jrc.ClusterProperties(**SMALL, **extra), **PADS)
    t = rc.generate(rc.ClusterProperties(**SMALL, **extra), device="cpu", **PADS)
    ja = {k: np.asarray(v) for k, v in dataclasses.asdict(j[0]).items()}
    ta = state_to_numpy(t[0], t[1])
    for k, v in ja.items():
        assert np.array_equal(v, ta[k]), k
    assert np.array_equal(np.asarray(j[1].broker), ta["assignment"])
    return SimpleNamespace(jax=j, torch=t)


@pytest.fixture(scope="module")
def healthy():
    return _pair()


@pytest.fixture(scope="module")
def with_dead_broker():
    return _pair(dead_broker_ids=(1,))


def _info(name="ReplicaDistributionGoal", rounds=1, before=1.0, after=1.0):
    return SimpleNamespace(goal_name=name, rounds=rounds, metric_before=before,
                           metric_after=after)


def _rack_aware(state):
    rack = np.asarray(state.rack)[:6]
    first_in_rack = np.array([int(np.flatnonzero(rack == k)[0]) for k in range(3)])
    return lambda broker, valid, pos, part: np.where(
        valid, first_in_rack[pos % 3], broker)


def _all_on_zero(broker, valid, pos, part):
    return np.where(valid, 0, broker)


def _partition0_on_zero(broker, valid, pos, part):
    return np.where(valid & (part == 0), 0, broker)


def _evacuate(broker, valid, pos, part):
    return np.where(valid & (broker == 1), 0, broker)


def _move_one_to(b):
    def f(broker, valid, pos, part):
        out = broker.copy()
        out[int(np.flatnonzero(valid & (broker != b))[0])] = b
        return out
    return f


def _shift_first(broker, valid, pos, part):
    out = broker.copy()
    r = int(np.flatnonzero(valid)[0])
    out[r] = (int(out[r]) + 1) % 6
    return out


ALL = ("GOAL_VIOLATION", "DEAD_BROKERS", "REGRESSION", "NEW_BROKERS")
CASES = {
    # name: (fixture, final placement, kwargs, new broker, broken loads, expected checks)
    "clean": ("healthy", "rack_aware", dict(goal_names=("RackAwareGoal",), verifications=ALL,
              goal_infos=(_info(before=2.0, after=1.5),)), None, False, []),
    "colocated": ("healthy", _all_on_zero, dict(goal_names=("RackAwareGoal",),
                  verifications=("GOAL_VIOLATION",)), None, False, ["GOAL_VIOLATION"]),
    "stranded": ("with_dead_broker", None, dict(verifications=("DEAD_BROKERS",)), None, False,
                 ["DEAD_BROKERS"]),
    "evacuated": ("with_dead_broker", _evacuate, dict(verifications=("DEAD_BROKERS",)), None,
                  False, []),
    "regression": ("healthy", None, dict(verifications=("REGRESSION",), goal_infos=(
        _info("GoalA", 1, 1.0, 2.0), _info("GoalB", 0, 1.0, 9.0), _info("GoalC", 3, 1.0, 1.0))),
        None, False, ["REGRESSION"]),
    "to-old-broker": ("healthy", _move_one_to(2), dict(verifications=("NEW_BROKERS",)), 4,
                      False, ["NEW_BROKERS"]),
    "to-new-broker": ("healthy", _move_one_to(4), dict(verifications=("NEW_BROKERS",)), 4,
                      False, []),
    "no-new-brokers": ("healthy", _shift_first, dict(verifications=("NEW_BROKERS",)), None,
                       False, []),
    "load-consistency": ("healthy", None, dict(verifications=()), None, True,
                         ["LOAD_CONSISTENCY"]),
    "empty-verifications": ("healthy", _all_on_zero, dict(
        goal_names=("RackAwareGoal",), verifications=(), goal_infos=(_info(after=99.0),)),
        None, False, []),
    "four-ways": ("with_dead_broker", _partition0_on_zero, dict(
        goal_names=("RackAwareGoal",), verifications=("GOAL_VIOLATION", "DEAD_BROKERS",
                                                      "REGRESSION"),
        goal_infos=(_info("GoalA", 1, 1.0, 2.0),)), None, True,
        ["GOAL_VIOLATION", "DEAD_BROKERS", "REGRESSION", "LOAD_CONSISTENCY"]),
    "all-hard-goals": ("with_dead_broker", _all_on_zero, dict(
        goal_names=("RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
                    "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
                    "CpuCapacityGoal", "ReplicaDistributionGoal"), verifications=ALL),
        None, False, ["GOAL_VIOLATION"]),
}


def _verify(pkg, cluster, final_fn, kw, new_broker, broken, monkeypatch):
    state, placement, meta = cluster
    as_np = np.asarray if pkg == "jax" else (lambda x: x.cpu().numpy())
    valid, part = as_np(state.valid), as_np(state.partition)
    if new_broker is not None:
        nb = np.zeros(as_np(state.broker_valid).shape[0], dtype=bool)
        nb[new_broker] = True
        state = dataclasses.replace(state, new_broker=jnp.asarray(nb) if pkg == "jax"
                                    else torch.from_numpy(nb))
    final = placement
    if final_fn is not None:
        if final_fn == "rack_aware":
            final_fn = _rack_aware(state)
        broker = final_fn(as_np(placement.broker).copy(), valid, as_np(state.pos), part)
        broker = broker.astype(np.int32)
        final = dataclasses.replace(placement, broker=jnp.asarray(broker) if pkg == "jax"
                                    else torch.from_numpy(broker))
    mod, ver = (jops, jver) if pkg == "jax" else (ops, tver)
    with monkeypatch.context() as m:
        if broken:
            real = mod.broker_load
            m.setattr(mod, "broker_load", lambda s, p: real(s, p) + 1.0)
        failures = ver.verify_placement(state, placement, meta, final, **kw)
    return [(f.check, f.detail) for f in failures], failures


@pytest.mark.parametrize("case", list(CASES))
def test_verify_placement_equals_jax(case, healthy, with_dead_broker, monkeypatch):
    fixture, final_fn, kw, new_broker, broken, expect = CASES[case]
    pair = healthy if fixture == "healthy" else with_dead_broker
    got = {pkg: _verify(pkg, getattr(pair, pkg), final_fn, kw, new_broker, broken,
                        monkeypatch) for pkg in ("jax", "torch")}
    assert got["torch"][0] == got["jax"][0]
    assert [c for c, _ in got["torch"][0]] == expect
    for f in got["torch"][1]:
        assert isinstance(f, VerificationFailure) and isinstance(f, AssertionError)
        assert str(f) == f"[{f.check}] {f.detail}"


def test_execute_goals_for_equals_jax(with_dead_broker):
    """The optimizer run plus its verification, in both packages: the dead
    broker is evacuated and nothing fails."""
    goals = ("RackAwareGoal", "ReplicaCapacityGoal")
    reports = {"jax": jver.execute_goals_for(*with_dead_broker.jax, goals),
               "torch": tver.execute_goals_for(*with_dead_broker.torch, goals)}
    for report in reports.values():
        assert report.ok and report.failures == []
    fin = {pkg: r.result.final_placement for pkg, r in reports.items()}
    valid = np.asarray(with_dead_broker.jax[0].valid)
    for pkg, as_np in (("jax", np.asarray), ("torch", lambda x: x.cpu().numpy())):
        assert not (as_np(fin[pkg].broker)[valid] == 1).any()
    assert (reports["torch"].result.violated_goals_after
            == reports["jax"].result.violated_goals_after == [])


# ------------------------------------------- tests/test_model.py:71-101, ported


def test_potential_leadership_load():
    state, placement, meta = det.unbalanced3().freeze(device="cpu")
    pot = ops.potential_leadership_load(state, placement).numpy()
    np.testing.assert_allclose(pot[:2], [200000.0, 200000.0], rtol=1e-5)


def test_counts_and_rack_ops():
    state, placement, meta = det.rack_aware_unsatisfiable().freeze(device="cpu")
    assert ops.replica_counts(state, placement)[:3].tolist() == [1, 1, 1]
    same = ops.replicas_on_same_rack(state, placement, meta.num_racks, meta.num_partitions)
    assert same[:3].tolist() == [1, 1, 0]
    s2, p2, m2 = det.rack_aware_satisfiable2().freeze(device="cpu")
    assert (ops.replicas_on_same_rack(s2, p2, m2.num_racks, m2.num_partitions)[:2] == 0).all()


def test_partition_leader_broker():
    state, placement, meta = det.unbalanced3().freeze(device="cpu")
    assert (ops.partition_leader_broker(state, placement, meta.num_partitions) == 0).all()


def test_disk_load_jbod():
    state, placement, meta = det.unbalanced4().freeze(device="cpu")
    assert state.num_disks_per_broker == 2
    dl = ops.disk_load(state, placement).numpy()
    bl = ops.broker_load(state, placement).numpy()
    np.testing.assert_allclose(dl.sum(axis=1), bl[:, Resource.DISK], rtol=1e-5)
    assert (dl[:2] > 0).all()


# -------------------------------------------- every ops helper against JAX


def _helpers(mod, state, placement, meta):
    return {
        "effective_load": mod.effective_load(state, placement),
        "broker_load": mod.broker_load(state, placement),
        "host_load": mod.host_load(state, placement, meta.num_hosts),
        "disk_load": mod.disk_load(state, placement),
        "potential_leadership_load": mod.potential_leadership_load(state, placement),
        "replica_counts": mod.replica_counts(state, placement),
        "leader_counts": mod.leader_counts(state, placement),
        "topic_broker_counts": mod.topic_broker_counts(state, placement, meta.num_topics),
        "topic_leader_counts": mod.topic_leader_counts(state, placement, meta.num_topics),
        "partition_rack_counts": mod.partition_rack_counts(state, placement, meta.num_racks,
                                                           meta.num_partitions),
        "partition_broker_matrix": mod.partition_broker_matrix(state, placement,
                                                               meta.num_partitions),
        "replicas_on_same_rack": mod.replicas_on_same_rack(state, placement, meta.num_racks,
                                                           meta.num_partitions),
        "partition_leader_broker": mod.partition_leader_broker(state, placement,
                                                               meta.num_partitions),
        "partition_size": mod.partition_size(state, meta.num_partitions),
        "average_alive_utilization": mod.average_alive_utilization(state, placement),
        "utilization_matrix": mod.utilization_matrix(state, placement),
    }


FIXTURES = ["unbalanced", "unbalanced2", "unbalanced3", "unbalanced4", "unbalanced5",
            "unbalanced_with_a_follower", "rack_aware_satisfiable", "rack_aware_satisfiable2",
            "rack_aware_unsatisfiable", "small_cluster_model", "min_leader_satisfiable3",
            "random", "random-dead-broker"]


@pytest.mark.parametrize("fixture", FIXTURES)
def test_ops_helpers_equal_jax(fixture, healthy, with_dead_broker):
    if fixture.startswith("random"):
        pair = with_dead_broker if fixture.endswith("broker") else healthy
        jax_in, port_in = pair.jax, pair.torch
    else:
        jax_in = getattr(jdet, fixture)().freeze(**PADS)
        port_in = getattr(det, fixture)().freeze(device="cpu", **PADS)
    want = _helpers(jops, *jax_in)
    got = _helpers(ops, *port_in)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w, g = np.asarray(w), got[name].cpu().numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)
        else:
            assert np.array_equal(g, w), name
