"""The cluster-model builder and the JSON snapshot: the port against the
JAX package.

Every comparison of packed arrays is exact (dtype, shape and bytes): both
builders keep the object graph in float64 and cast once when packing, so
the same mutations must freeze to the same bits.
"""

import io
import json

import numpy as np
import pytest

from cruise_control_tpu.model import builder as jbuilder
from cruise_control_tpu.model import snapshot as jsnap
from cruise_control_tpu.model import state as jstate
from cruise_control_tpu.testing import deterministic as jdet
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_HARD_GOALS
from cruise_control_tpu_torch.client.propose import parse_args, run_propose
from cruise_control_tpu_torch.model import builder as tbuilder
from cruise_control_tpu_torch.model import snapshot as tsnap
from cruise_control_tpu_torch.model.state import (
    Placement,
    apply_deltas,
    empty_delta,
    state_to_numpy,
)
from cruise_control_tpu_torch.testing import deterministic as tdet
from cruise_control_tpu_torch.testing import random_cluster as trc

FIXTURES = sorted(
    n for n in dir(tdet)
    if not n.startswith("_") and n not in ("load", "homogeneous_cluster")
    and callable(getattr(tdet, n))
    and getattr(getattr(tdet, n), "__module__", "") == tdet.__name__)
META_FIELDS = ("broker_ids", "topics", "partitions", "racks", "hosts",
               "num_replicas", "num_brokers", "extra")
SMALL = dict(num_brokers=8, num_racks=4, num_topics=12, num_replicas=256, seed=11)


def assert_packed_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert (x.dtype, x.shape) == (y.dtype, y.shape), k
        assert x.tobytes() == y.tobytes(), k


def assert_meta_equal(a, b):
    for f in META_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def assert_frozen_equal(jcm, tcm, **pads):
    jp, jm = jcm.freeze_packed(**pads)
    tp, tm = tcm.freeze_packed(**pads)
    assert_packed_equal(jp, tp)
    assert_meta_equal(jm, tm)
    return tp, tm


def test_fixture_list_is_the_jax_packages():
    jax_fixtures = sorted(
        n for n in dir(jdet)
        if not n.startswith("_") and n not in ("load", "homogeneous_cluster")
        and callable(getattr(jdet, n))
        and getattr(getattr(jdet, n), "__module__", "") == jdet.__name__)
    assert FIXTURES == jax_fixtures and len(FIXTURES) == 17


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_freezes_like_jax(name):
    for pads in ({}, dict(pad_replicas_to=16, pad_brokers_to=4)):
        assert_frozen_equal(getattr(jdet, name)(), getattr(tdet, name)(), **pads)


def test_scalar_follower_cpu_matches_jax():
    from cruise_control_tpu.model import cpu_model as jcpu
    from cruise_control_tpu_torch.model import cpu_model as tcpu
    rng = np.random.default_rng(5)
    cases = [(0.0, 0.0, 3.0), (0.0, 2.0, 3.0), (-4.0, 1.0, 2.0), (5.0, -40.0, 1.0)]
    cases += [tuple(rng.normal(size=3) * 100) for _ in range(50)]
    for bi, bo, cpu in cases:
        assert tcpu.follower_cpu_from_leader_load(bi, bo, cpu) == \
            jcpu.follower_cpu_from_leader_load(bi, bo, cpu)
    # The two forms part where the weighted denominator is not positive.
    assert tcpu.follower_cpu_from_leader_load(-4.0, 1.0, 2.0) == 0.0


class _Twin:
    """One mutation applied to both builders; a ValueError must come from
    both or neither."""

    def __init__(self):
        self.j = jbuilder.ClusterModel()
        self.t = tbuilder.ClusterModel()

    def __getattr__(self, op):
        def call(*args, **kw):
            errs = []
            for cm in (self.j, self.t):
                try:
                    getattr(cm, op)(*args, **kw)
                    errs.append(None)
                except (ValueError, KeyError) as e:
                    errs.append(type(e))
            assert errs[0] == errs[1], (op, args, errs)
            return errs[1] is None
        return call


def _seed_twin(twin, rng, brokers=6, disks=2):
    for b in range(brokers):
        twin.create_broker(rack=f"r{b % 3}", host=f"h{b // 2}", broker_id=10 + b,
                           capacity=rng.uniform(50, 500, size=4),
                           disk_capacities=rng.uniform(10, 100, size=disks).tolist())
    for p in range(24):
        topic = f"t{p % 5}"
        holders = rng.choice(brokers, size=3, replace=False)
        for i, b in enumerate(holders):
            twin.create_replica(topic, p, broker_id=10 + int(b), index=i,
                                is_leader=i == 0, disk=int(rng.integers(disks)))
            load = rng.uniform(0, 20, size=4)
            if rng.random() < 0.3:
                load[1] = load[2] = 0.0       # the CPU model's zero-bytes case
            follower = rng.uniform(0, 5, size=4) if rng.random() < 0.3 else None
            twin.set_replica_load(topic, p, 10 + int(b), load, follower_load=follower)


def _random_mutation(twin, rng, structural=True):
    """One seeded mutation, drawn from the port builder's current state."""
    cm = twin.t
    parts = list(cm.partitions().items())
    brokers = [b.broker_id for b in cm.brokers()]
    (topic, p), replicas = parts[int(rng.integers(len(parts)))]
    r = replicas[int(rng.integers(len(replicas)))]
    ops = ["load", "relocate", "leader", "broker_state", "disk_dead"]
    if structural:
        ops += ["create", "delete", "rf"]
    op = ops[int(rng.integers(len(ops)))]
    if op == "load":
        twin.set_replica_load(topic, p, r.broker_id, rng.uniform(0, 30, size=4))
    elif op == "relocate":
        twin.relocate_replica(topic, p, r.broker_id, int(rng.choice(brokers)),
                              dst_disk=int(rng.integers(2)))
    elif op == "leader":
        lead = next((x for x in replicas if x.is_leader), None)
        other = [x for x in replicas if not x.is_leader]
        if lead is not None and other:
            twin.relocate_leadership(topic, p, lead.broker_id, other[0].broker_id)
    elif op == "broker_state":
        twin.set_broker_state(int(rng.choice(brokers)), alive=bool(rng.random() < 0.5))
    elif op == "disk_dead":
        twin.mark_disk_dead(int(rng.choice(brokers)), int(rng.integers(2)))
    elif op == "create":
        twin.create_replica(topic, p, broker_id=int(rng.choice(brokers)),
                            index=int(rng.integers(4)), is_leader=False)
    elif op == "delete":
        twin.delete_replica(topic, p, r.broker_id)
    else:
        twin.create_or_delete_replicas(f"t{int(rng.integers(5))}", int(rng.integers(1, 4)))
    return op


def test_seeded_mutation_sequence_freezes_like_jax():
    rng = np.random.default_rng(2024)
    twin = _Twin()
    _seed_twin(twin, rng)
    assert_frozen_equal(twin.j, twin.t)
    seen = set()
    for step in range(120):
        seen.add(_random_mutation(twin, rng))
        if step % 10 == 9:
            assert_frozen_equal(twin.j, twin.t, pad_replicas_to=32, pad_brokers_to=8)
    twin.create_broker(rack="r9", host="h9", broker_id=99, capacity=[1.0, 2.0, 3.0, 4.0])
    assert_frozen_equal(twin.j, twin.t)
    assert twin.j.version == twin.t.version and twin.j.counts() == twin.t.counts()
    assert len(seen) == 8


def test_builder_from_snapshot_round_trips_exactly():
    ts, tp, tm = trc.generate(trc.ClusterProperties(**SMALL), device="cpu",
                              pad_replicas_to=64, pad_brokers_to=4)
    packed = state_to_numpy(ts, tp)
    cm = tbuilder.builder_from_snapshot(ts, tp, tm)
    again, meta = cm.freeze_packed(pad_replicas_to=64, pad_brokers_to=4)
    assert_packed_equal(packed, again)
    for f in META_FIELDS[:-1]:
        assert getattr(meta, f) == getattr(tm, f), f
    # The JAX package rebuilds the same builder from the same arrays.
    js, jp, jm = jrc.generate(jrc.ClusterProperties(**SMALL), pad_replicas_to=64,
                              pad_brokers_to=4)
    assert_frozen_equal(jbuilder.builder_from_snapshot(js, jp, jm), cm,
                        pad_replicas_to=64, pad_brokers_to=4)


def test_apply_placement_matches_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    twin = _Twin()
    _seed_twin(twin, rng)
    packed, meta = twin.t.freeze_packed()
    n = meta.num_replicas
    # A permuted placement: each replica to another broker not holding its
    # partition, leadership rotated within each partition.
    broker = packed["assignment"].copy()
    lead = packed["is_leader"].copy()
    part = packed["partition"]
    for pid in range(meta.num_partitions):
        rows = np.nonzero(part[:n] == pid)[0]
        free = [b for b in range(meta.num_brokers) if b not in broker[rows]]
        if free:
            broker[rows[-1]] = free[int(rng.integers(len(free)))]
        lead[rows] = np.roll(lead[rows], 1)
    disk = rng.integers(2, size=broker.shape).astype(np.int32)
    import torch
    twin.t.apply_placement(Placement(torch.as_tensor(broker), torch.as_tensor(disk),
                                     torch.as_tensor(lead)), meta)
    from cruise_control_tpu.model.state import Placement as JPlacement
    twin.j.apply_placement(JPlacement(jnp.asarray(broker), jnp.asarray(disk),
                                      jnp.asarray(lead)), meta)
    assert_frozen_equal(twin.j, twin.t)


@pytest.mark.parametrize("structural", [False, True], ids=["sparse", "structural"])
def test_collect_delta_applies_like_a_refreeze(structural):
    """collect_delta then apply_deltas equals a fresh freeze, bit for bit:
    in the port, in the JAX package, and the JAX delta through the port's
    apply_deltas; the two packages emit the same delta."""
    rng = np.random.default_rng(31 + structural)
    twin = _Twin()
    _seed_twin(twin, rng)
    pads = dict(pad_replicas_to=128, pad_brokers_to=8)
    for cm in (twin.j, twin.t):
        cm.enable_delta_tracking()
    ts, tp, _ = twin.t.freeze(device="cpu", **pads)
    js, jp, _ = twin.j.freeze(**pads)
    # Nothing changed: an empty delta, which applies as a no-op.
    nothing = twin.t.collect_delta()
    assert nothing.is_empty and nothing.num_updates == 0 and twin.j.collect_delta().is_empty
    assert empty_delta().is_empty
    assert_packed_equal(state_to_numpy(*apply_deltas(ts, tp, nothing)), state_to_numpy(ts, tp))
    perms = []
    for _ in range(6):
        for _ in range(5):
            _random_mutation(twin, rng, structural=structural)
        tdelta = twin.t.collect_delta()
        jdelta = twin.j.collect_delta()
        assert tdelta is not None and jdelta is not None
        assert (tdelta.perm is None) == (jdelta.perm is None)
        assert tdelta.replica_idx.tobytes() == jdelta.replica_idx.tobytes()
        assert tdelta.broker_idx.tobytes() == jdelta.broker_idx.tobytes()
        for k, v in tdelta.replica_updates.items():
            assert v.tobytes() == jdelta.replica_updates[k].tobytes(), k
        fresh, fresh_meta = twin.t.freeze_packed(**pads)
        across_s, across_p = apply_deltas(ts, tp, jdelta)
        ts, tp = apply_deltas(ts, tp, tdelta)
        assert_packed_equal(state_to_numpy(ts, tp), fresh)
        assert_packed_equal(state_to_numpy(across_s, across_p), fresh)
        js, jp = jstate.apply_deltas(js, jp, jdelta)
        jfresh, _ = twin.j.freeze_packed(**pads)
        jarr = {k: np.asarray(getattr(js, k)) for k in fresh
                if k not in ("assignment", "disk", "is_leader")}
        jarr.update(assignment=np.asarray(jp.broker), disk=np.asarray(jp.disk),
                    is_leader=np.asarray(jp.is_leader))
        assert_packed_equal(jarr, jfresh)
        if tdelta.meta is not None:
            assert_meta_equal(tdelta.meta, fresh_meta)
        perms.append(tdelta.perm is not None)
    # Structural deltas carry a permutation; sparse ones never do.
    assert any(perms) == structural


def test_json_written_by_either_package_loads_in_the_other(tmp_path):
    for fixture in ("unbalanced4", "small_cluster_model", "rack_aware_unsatisfiable"):
        jcm, tcm = getattr(jdet, fixture)(), getattr(tdet, fixture)()
        jcm.set_broker_state(jcm.brokers()[0].broker_id, alive=False)
        tcm.set_broker_state(tcm.brokers()[0].broker_id, alive=False)
        jpath, tpath = tmp_path / f"{fixture}.jax.json", tmp_path / f"{fixture}.port.json"
        jsnap.save_json(jcm, str(jpath))
        tsnap.save_json(tcm, str(tpath))
        assert json.loads(jpath.read_text()) == json.loads(tpath.read_text())
        assert_frozen_equal(jsnap.load_json(str(tpath)), tsnap.load_json(str(jpath)),
                            pad_replicas_to=16)
        # Dead brokers and disks are applied after the replicas: their
        # replicas come back offline.
        packed, _ = tsnap.load_json(str(jpath)).freeze_packed()
        assert packed["offline"].any()


def test_run_propose_reads_a_json_snapshot(tmp_path):
    ts, tp, tm = trc.generate(trc.ClusterProperties(**SMALL), device="cpu")
    path = tmp_path / "snap.json"
    tsnap.save_json(tbuilder.builder_from_snapshot(ts, tp, tm), str(path))
    out = io.StringIO()
    assert run_propose(parse_args(["--snapshot", str(path), "--device", "cpu",
                                   "--verbose"]), out) == 0
    doc = json.loads(out.getvalue())
    assert not set(doc["summary"]["violatedGoalsAfter"]) & set(DEFAULT_HARD_GOALS)
    # Frozen from the JSON, the snapshot is the generated one.
    state, placement, _ = tsnap.load_json(str(path)).freeze(device="cpu")
    assert_packed_equal(state_to_numpy(state, placement), state_to_numpy(ts, tp))
