"""The resident cluster model: the port's ``ResidentModelService`` against
the JAX package's.

The contract is BITWISE equality: resident tensors updated by delta applies
must be indistinguishable from a fresh freeze of the same builder, and here
also from the JAX service's tensors after the same requests.  The first half
holds the port to the JAX package's own resident tests
(``tests/test_resident.py``), one counterpart each; the second half runs the
same request scripts through both services (and both monitors) in this
process and compares tensors and sensor counts.  The JAX apply donates its
buffers and the port's copies them, so the pin contract is compared by its
counts, not by buffer deletion.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import relax as jrelax
from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.compilesvc.buckets import ShapeBucketPolicy as JBuckets
from cruise_control_tpu.model.resident import ResidentModelService as JService
from cruise_control_tpu.model.state import Placement as JPlacement
from cruise_control_tpu.monitor import load_monitor as jlm
from cruise_control_tpu.monitor import metadata as jmeta
from cruise_control_tpu.monitor import sampler as jsampler
from cruise_control_tpu.monitor import task_runner as jrunner
from cruise_control_tpu.testing import deterministic as jdet
from cruise_control_tpu.testing.verifier import verify_placement
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
from cruise_control_tpu_torch.model import resident as tresident
from cruise_control_tpu_torch.model.builder import builder_from_snapshot
from cruise_control_tpu_torch.model.resident import ResidentModelService
from cruise_control_tpu_torch.model.sanity import sanity_check
from cruise_control_tpu_torch.model.state import apply_deltas, state_to_numpy
from cruise_control_tpu_torch.monitor import load_monitor as tlm
from cruise_control_tpu_torch.monitor import metadata as tmeta
from cruise_control_tpu_torch.monitor import sampler as tsampler
from cruise_control_tpu_torch.monitor import task_runner as trunner
from cruise_control_tpu_torch.monitor.metadata import PartitionInfo
from cruise_control_tpu_torch.testing import deterministic as det

PAD_R, PAD_B = 16, 4
W = 1000
STATE_FIELDS = ("leader_load", "follower_load", "partition", "topic", "pos",
                "orig_broker", "offline", "valid", "capacity", "host", "rack",
                "alive", "new_broker", "broker_valid", "disk_capacity", "disk_alive")
COUNTS = ("fullFreezes", "deltaApplies", "invalidations")


def _freeze(cm):
    return cm.freeze(pad_replicas_to=PAD_R, pad_brokers_to=PAD_B, device="cpu")


def _pad_fn(n_r, n_b):
    return (PAD_R, PAD_B)


def _arrays(state, placement):
    """The packed arrays of either package's (state, placement)."""
    if isinstance(state.valid, torch.Tensor):
        return state_to_numpy(state, placement)
    out = {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}
    out.update(assignment=np.asarray(placement.broker), disk=np.asarray(placement.disk),
               is_leader=np.asarray(placement.is_leader))
    return out


def assert_bitwise_equal(got, want):
    a, b = _arrays(*got), _arrays(*want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), f"{k} diverged"


def tracked_cluster():
    cm = det.small_cluster_model()
    cm.enable_delta_tracking()
    return cm


@pytest.fixture(autouse=True)
def jax_greedy():
    """The JAX package's relaxation switch is process-wide; its reference
    solves here are greedy."""
    was_on = jrelax.relaxation_enabled()
    jrelax.set_relaxation(False)
    yield
    jrelax.set_relaxation(was_on)


# ------------------------------------------------ the JAX resident tests, ported


def test_counts_maintained_incrementally():
    cm = det.small_cluster_model()
    n_r = sum(len(rs) for rs in cm.partitions().values())
    assert cm.counts() == (n_r, len(cm.brokers()))
    cm.create_replica("T9", 0, broker_id=0, index=0, is_leader=True)
    assert cm.counts()[0] == n_r + 1
    cm.delete_replica("T9", 0, 0)
    assert cm.counts()[0] == n_r


def test_sparse_delta_bitwise_equal_to_fresh_freeze():
    cm = tracked_cluster()
    state, placement, _ = _freeze(cm)
    v0 = cm.version
    cm.set_replica_load("T1", 0, 0, det.load(33.0, 101.5, 77.25, 13.0))
    cm.set_broker_state(2, alive=False)
    cm.relocate_leadership("T2", 1, 0, 2)
    delta = cm.collect_delta()
    assert delta is not None and delta.perm is None
    assert delta.from_version == v0 and delta.to_version == cm.version
    assert delta.num_updates > 0
    got = apply_deltas(state, placement, delta)
    want_s, want_p, want_m = _freeze(cm)
    assert_bitwise_equal(got, (want_s, want_p))
    assert want_m.extra["model_version"] == cm.version


def test_structural_delta_uses_perm_and_matches():
    cm = tracked_cluster()
    state, placement, _ = _freeze(cm)
    cm.delete_replica("T2", 0, 2)
    cm.create_replica("T2", 3, broker_id=1, index=0, is_leader=True)
    cm.set_replica_load("T2", 3, 1, det.load(1.0, 2.0, 3.0, 4.0))
    delta = cm.collect_delta()
    assert delta is not None and delta.perm is not None and delta.meta is not None
    got = apply_deltas(state, placement, delta)
    want_s, want_p, want_m = _freeze(cm)
    assert_bitwise_equal(got, (want_s, want_p))
    assert delta.meta.num_replicas == want_m.num_replicas
    assert list(delta.meta.topics) == list(want_m.topics)


def test_delta_after_delta_chain():
    cm = tracked_cluster()
    state, placement, _ = _freeze(cm)
    rng = np.random.default_rng(7)
    pairs = list(cm.partitions().keys())
    for _ in range(5):
        t, p = pairs[int(rng.integers(len(pairs)))]
        for r in cm.partition(t, p):
            cm.set_replica_load(t, p, r.broker_id, rng.uniform(1.0, 50.0, size=4))
        delta = cm.collect_delta()
        assert delta is not None
        state, placement = apply_deltas(state, placement, delta)
    want_s, want_p, _ = _freeze(cm)
    assert_bitwise_equal((state, placement), (want_s, want_p))


def test_overflow_and_inexpressible_edits_refuse_delta():
    cm = tracked_cluster()
    _freeze(cm)
    for (t, p), rs in cm.partitions().items():
        for r in rs:
            cm.set_replica_load(t, p, r.broker_id, det.load(1, 1, 1, 1))
    assert cm.collect_delta(max_updates=2) is None
    cm2 = tracked_cluster()
    _freeze(cm2)
    cm2.create_broker(rack="9", host="h9", broker_id=9, capacity=dict(det.BROKER_CAPACITY))
    assert cm2.collect_delta() is None
    assert tracked_cluster().collect_delta() is None


def test_builder_from_snapshot_roundtrip():
    cm = det.small_cluster_model()
    frozen = _freeze(cm)
    rebuilt = builder_from_snapshot(*frozen)
    assert rebuilt.counts() == cm.counts()
    again = _freeze(rebuilt)
    assert_bitwise_equal((again[0], again[1]), (frozen[0], frozen[1]))


def test_resident_service_lifecycle():
    svc = ResidentModelService(device="cpu")
    cm = det.small_cluster_model()
    full0 = svc.stats()["fullFreezes"]
    s1, p1, _ = svc.snapshot(cm, _pad_fn)
    st = svc.stats()
    assert st["resident"] and st["fullFreezes"] == full0 + 1
    s2, p2, _ = svc.snapshot(cm, _pad_fn)
    assert s2 is s1 and p2 is p1
    assert svc.stats()["fullFreezes"] == full0 + 1
    cm.set_replica_load("T1", 0, 0, det.load(9.0, 9.0, 9.0, 9.0))
    s3, p3, _ = svc.snapshot(cm, _pad_fn)
    st = svc.stats()
    assert st["deltaApplies"] >= 1 and st["fullFreezes"] == full0 + 1
    want = _freeze(cm)
    assert_bitwise_equal((s3, p3), (want[0], want[1]))
    svc.invalidate("test")
    assert not svc.stats()["resident"]
    svc.snapshot(cm, _pad_fn)
    st = svc.stats()
    assert st["fullFreezes"] == full0 + 2
    assert st["invalidationReasons"].get("test") == 1


def test_resident_bucket_change_forces_full_freeze():
    svc = ResidentModelService(device="cpu")
    cm = det.small_cluster_model()
    buckets = {"pad": (PAD_R, PAD_B)}
    svc.snapshot(cm, lambda r, b: buckets["pad"])
    full = svc.stats()["fullFreezes"]
    cm.set_replica_load("T1", 0, 0, det.load(3, 3, 3, 3))
    buckets["pad"] = (PAD_R * 2, PAD_B)
    s, _, _ = svc.snapshot(cm, lambda r, b: buckets["pad"])
    assert s.valid.shape[0] == PAD_R * 2
    assert svc.stats()["fullFreezes"] == full + 1


def test_resident_pins_block_donation():
    """While a pin is held the apply waits (the JAX apply would delete the
    pinned buffers; the port keeps the contract), and the pinned tensors
    stay as they were after it runs."""
    svc = ResidentModelService(pin_wait_s=30.0, device="cpu")
    cm = det.small_cluster_model()
    s1, p1, _ = svc.snapshot(cm, _pad_fn, pin=True)
    before = _arrays(s1, p1)
    cm.set_replica_load("T1", 0, 0, det.load(2.0, 2.0, 2.0, 2.0))
    applied = threading.Event()

    def deltaing():
        svc.snapshot(cm, _pad_fn)
        applied.set()

    t = threading.Thread(target=deltaing)
    t.start()
    assert not applied.wait(timeout=0.5)
    svc.release()
    assert applied.wait(timeout=10.0)
    t.join()
    assert svc.stats()["deltaApplies"] >= 1
    after = _arrays(s1, p1)
    assert all(before[k].tobytes() == after[k].tobytes() for k in before)


def test_resident_disabled_always_freezes():
    svc = ResidentModelService(enabled=False, device="cpu")
    cm = det.small_cluster_model()
    s0 = svc.stats()
    svc.snapshot(cm, _pad_fn)
    svc.snapshot(cm, _pad_fn)
    st = svc.stats()
    assert st["fullFreezes"] == s0["fullFreezes"] + 2 and not st["resident"]
    assert st["deltaApplies"] == s0["deltaApplies"]


def test_warm_scatter_compiles_both_kernels():
    """Every delta kind runs once over zeroed tensors; torch compiles
    nothing, so this only has to run, on the service's device."""
    ResidentModelService(device="cpu").warm_scatter(PAD_R, PAD_B, num_disks=2)


def test_delta_chain_cap_forces_refreeze():
    svc = ResidentModelService(max_delta_chain=1, device="cpu")
    cm = det.small_cluster_model()
    svc.snapshot(cm, _pad_fn)
    s0 = svc.stats()
    cm.set_replica_load("T1", 0, 0, det.load(4, 4, 4, 4))
    svc.snapshot(cm, _pad_fn)
    cm.set_replica_load("T1", 0, 0, det.load(5, 5, 5, 5))
    svc.snapshot(cm, _pad_fn)
    st = svc.stats()
    assert st["deltaApplies"] == s0["deltaApplies"] + 1
    assert st["fullFreezes"] == s0["fullFreezes"] + 1


def _stack(pkg=(tmeta, tlm, tsampler, trunner), num_brokers=4, partitions=8, rf=2):
    """tests/test_facade.py's build_stack without the facade: a monitor
    bootstrapped over six windows."""
    meta, lmod, smod, rmod = pkg
    brokers = [meta.BrokerInfo(i, rack=str(i % 2), host=f"h{i}") for i in range(num_brokers)]
    parts = [meta.PartitionInfo("T", p, leader=p % num_brokers,
                                replicas=tuple((p + i) % num_brokers for i in range(rf)),
                                in_sync=(p % num_brokers,))
             for p in range(partitions)]
    backend = meta.FakeMetadataBackend(brokers, parts)
    lm = lmod.LoadMonitor(meta.MetadataClient(backend, ttl_ms=0), num_windows=5, window_ms=W,
                          min_samples_per_window=1)
    runner = rmod.LoadMonitorTaskRunner(lm, smod.SyntheticWorkloadSampler(),
                                        sampling_interval_ms=W)
    runner.bootstrap(0, 6 * W)
    return lm, runner, backend


def test_monitor_resident_builder_fresh_then_diff():
    lm, runner, backend = _stack()
    cm, fresh = lm.resident_model_builder()
    assert fresh and cm.delta_tracking
    cm2, fresh2 = lm.resident_model_builder()
    assert cm2 is cm and not fresh2
    cm.freeze(pad_replicas_to=64, pad_brokers_to=8, device="cpu")
    runner.sampler.mean_bytes_in *= 1.25
    runner.bootstrap(6_000, 12_000)
    cm3, fresh3 = lm.resident_model_builder()
    assert cm3 is cm and not fresh3
    delta = cm.collect_delta()
    assert delta is not None and delta.num_updates > 0
    md = backend.fetch()
    backend.partitions = list(md.partitions) + [
        PartitionInfo("T", 99, leader=0, replicas=(0, 1), in_sync=(0,))]
    cm4, fresh4 = lm.resident_model_builder()
    assert fresh4 and cm4 is not cm


# ---------------------------------------------- the same requests, both packages


PKGS = {"jax": (JService, jdet), "torch": (ResidentModelService, det)}


def _service(name, **kw):
    cls, _ = PKGS[name]
    return cls(**kw) if name == "jax" else cls(device="cpu", **kw)


def _scenario(name, pkg):
    """Run one request script on ``pkg``'s service and builder; return the
    sensor deltas after each request and the tensors each returned."""
    _, fixtures = PKGS[pkg]
    kw = dict(chain_cap=dict(max_delta_chain=1), disabled=dict(enabled=False),
              pins=dict(pin_wait_s=0.05)).get(name, {})
    svc = _service(pkg, **kw)
    cm = fixtures.small_cluster_model()
    start = svc.stats()
    steps = []
    pads = {"pad": (PAD_R, PAD_B)}

    def request(pin=False):
        out = svc.snapshot(cm, lambda r, b: pads["pad"], pin=pin)
        st = svc.stats()
        steps.append(([st[k] - start[k] for k in COUNTS], _arrays(out[0], out[1])))
        return out

    load = fixtures.load
    request()
    request()
    if name == "delta_chain":
        cm.set_replica_load("T1", 0, 0, load(33.0, 101.5, 77.25, 13.0))
        request()
        cm.set_broker_state(2, alive=False)
        request()
        cm.delete_replica("T2", 0, 2)
        cm.create_replica("T2", 3, broker_id=1, index=0, is_leader=True)
        cm.set_replica_load("T2", 3, 1, load(1.0, 2.0, 3.0, 4.0))
        request()
        cm.relocate_leadership("T1", 1, 1, 0)
        request()
    elif name == "lifecycle":
        cm.set_replica_load("T1", 0, 0, load(9.0, 9.0, 9.0, 9.0))
        request()
        svc.invalidate("test")
        request()
    elif name == "bucket_change":
        cm.set_replica_load("T1", 0, 0, load(3, 3, 3, 3))
        pads["pad"] = (PAD_R * 2, PAD_B)
        request()
        cm.set_replica_load("T1", 0, 0, load(4, 4, 4, 4))
        request()
    elif name == "pins":
        request(pin=True)
        cm.set_replica_load("T1", 0, 0, load(2.0, 2.0, 2.0, 2.0))
        request()                        # the pin does not drain: full freeze
        svc.release()
        cm.set_replica_load("T1", 0, 0, load(3.0, 3.0, 3.0, 3.0))
        request()                        # drained: delta
    elif name in ("disabled", "chain_cap"):
        for v in (4, 5, 6):
            cm.set_replica_load("T1", 0, 0, load(v, v, v, v))
            request()
    return steps, cm


@pytest.mark.parametrize("name", ["delta_chain", "lifecycle", "bucket_change", "pins",
                                  "disabled", "chain_cap"])
def test_service_equals_jax_service(name):
    """Each request returns the JAX service's tensors bit for bit, the same
    full-freeze, delta-apply and invalidation counts, and tensors equal to
    a fresh freeze of the builder."""
    jsteps, _ = _scenario(name, "jax")
    tsteps, tcm = _scenario(name, "torch")
    assert [c for c, _ in tsteps] == [c for c, _ in jsteps]
    for (_, t), (_, j) in zip(tsteps, jsteps):
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].tobytes() == j[k].tobytes(), k
    pads = dict(pad_replicas_to=tsteps[-1][1]["valid"].shape[0], pad_brokers_to=PAD_B)
    fresh, _ = tcm.freeze_packed(**pads)
    assert all(fresh[k].tobytes() == tsteps[-1][1][k].tobytes() for k in fresh)
    if name == "delta_chain":
        assert [c for c, _ in tsteps][-1] == [1, 4, 0]


def test_delta_slots_equal_jax():
    j, t = JService(), ResidentModelService(device="cpu")
    for n in (0, 1, 63, 64, 65, 500, 5000, 8192, 10**6):
        assert t.delta_slots(n) == j.delta_slots(n)
    j, t = JService(max_delta_slots=100), ResidentModelService(max_delta_slots=100, device="cpu")
    for n in (1, 64, 65, 100, 129, 5000):
        assert t.delta_slots(n) == j.delta_slots(n)
    buckets, jbuckets = ShapeBucketPolicy(), JBuckets()
    for r, b in ((1, 1), (48_723, 200), (996_957, 2600), (100, 9)):
        assert buckets.pad_targets(r, b) == jbuckets.pad_targets(r, b)
    assert buckets.bucket_label(65536, 512, 16) == jbuckets.bucket_label(65536, 512, 16)


def _topology(meta, brokers=12, partitions=40, rf=3, seed=5):
    rng = np.random.default_rng(seed)
    infos = [meta.BrokerInfo(i, rack=f"r{i % 3}", host=f"h{i}") for i in range(brokers)]
    parts = []
    for p in range(partitions):
        reps = tuple(int(b) for b in rng.choice(brokers, size=rf, replace=False))
        parts.append(meta.PartitionInfo(f"T{p % 5}", p, leader=reps[0], replicas=reps,
                                        in_sync=reps))
    return meta.FakeMetadataBackend(infos, parts)


SLICE_GOALS = ["ReplicaCapacityGoal", "RackAwareGoal"]
DEAD = 4


@pytest.fixture(scope="module")
def slice_runs():
    """monitor → resident service → GoalOptimizer in both packages: a full
    freeze, a broker killed, a delta-applied snapshot, a two-goal solve."""
    runs = {}
    for name, pkg, buckets in (("jax", (jmeta, jlm, jsampler, jrunner), JBuckets()),
                               ("torch", (tmeta, tlm, tsampler, trunner), ShapeBucketPolicy())):
        meta, lmod, smod, rmod = pkg
        backend = _topology(meta)
        lm = lmod.LoadMonitor(meta.MetadataClient(backend, ttl_ms=0), num_windows=5,
                              window_ms=W, min_samples_per_window=1)
        rmod.LoadMonitorTaskRunner(lm, smod.SyntheticWorkloadSampler(),
                                   sampling_interval_ms=W).bootstrap(0, 6 * W)
        svc = _service(name)
        start = svc.stats()
        cm, fresh = lm.resident_model_builder()
        svc.snapshot(cm, buckets.pad_targets)
        backend.kill_broker(DEAD)
        cm2, fresh2 = lm.resident_model_builder()
        state, placement, meta_ = svc.snapshot(cm2, buckets.pad_targets, pin=True)
        try:
            opt = (JOptimizer if name == "jax" else GoalOptimizer)(goal_names=SLICE_GOALS)
            res = opt.optimizations(state, placement, meta_, model_generation=lm.model_generation)
        finally:
            svc.release()
        st = svc.stats()
        runs[name] = dict(fresh=(fresh, fresh2, cm2 is cm), state=state, placement=placement,
                          meta=meta_, res=res, counts=[st[k] - start[k] for k in COUNTS],
                          fresh_freeze=lm.cluster_model(pad_fn=buckets.pad_targets,
                                                        **({} if name == "jax"
                                                           else {"device": "cpu"})))
    return runs


def test_slice_resident_tensors_equal_jax_and_a_fresh_freeze(slice_runs):
    j, t = slice_runs["jax"], slice_runs["torch"]
    assert t["fresh"] == j["fresh"] == (True, False, True)
    assert t["counts"] == j["counts"] == [1, 1, 0]
    assert_bitwise_equal((t["state"], t["placement"]), (j["state"], j["placement"]))
    fs, fp, _ = t["fresh_freeze"]
    assert_bitwise_equal((t["state"], t["placement"]), (fs, fp))
    assert sanity_check(t["state"], t["placement"], t["meta"], allow_offline=True) == []


def test_slice_solve_empties_the_dead_broker_no_worse_than_jax(slice_runs):
    j, t = slice_runs["jax"], slice_runs["torch"]
    row = t["meta"].broker_index[DEAD]
    n = t["meta"].num_replicas
    assert not bool((t["res"].final_placement.broker[:n] == row).any())
    assert not bool((np.asarray(j["res"].final_placement.broker)[:n] == row).any())
    final = t["res"].final_placement
    port_on_jax = JPlacement(broker=jnp.asarray(final.broker.numpy()),
                             disk=jnp.asarray(final.disk.numpy()),
                             is_leader=jnp.asarray(final.is_leader.numpy()))
    js, jp, jm = j["state"], j["placement"], j["meta"]
    mine = verify_placement(js, jp, jm, port_on_jax, goal_names=SLICE_GOALS,
                            goal_infos=t["res"].goal_infos)
    theirs = verify_placement(js, jp, jm, j["res"].final_placement, goal_names=SLICE_GOALS,
                              goal_infos=j["res"].goal_infos)
    assert len(mine) <= len(theirs)
    assert mine == []
    assert t["res"].violated_goals_after == []
    assert sanity_check(t["state"], final, t["meta"]) == []


def test_resident_service_defaults_to_the_card():
    import inspect
    assert inspect.signature(ResidentModelService).parameters["device"].default == "cuda"
    assert tresident.FULL_FREEZE_SENSOR == "Model.full-freezes"
