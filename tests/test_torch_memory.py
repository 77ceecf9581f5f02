"""The port's device-memory ledger (``obsvc/memory.py``) against the JAX
package's.

Counterparts of ``tests/test_memory.py``: byte measurement of the same
arrays; the resident model's ledger posts after the same freeze, delta
applies, pin and release (the JAX apply donates its buffers and posts one
net-zero donation, the port's writes copies and posts their alloc and the
old tensors' free); the headroom guard's shrink and refusal on ingested cost
rows and a set budget; a what-if batch the guard refuses; a batch it
shrinks onto narrower blocks; and ``configure`` from the same properties.
Each test swaps in fresh ledgers in both packages and puts the process-wide
ones back (``_fresh`` below).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.compilesvc import chunking as jchunking
from cruise_control_tpu.compilesvc import service as jservice
from cruise_control_tpu.config import CruiseControlConfig as JConfig
from cruise_control_tpu.model.resident import ResidentModelService as JService
from cruise_control_tpu.obsvc import memory as jmemory
from cruise_control_tpu.testing import deterministic as jdet
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.solver import GoalSolver
from cruise_control_tpu_torch.compilesvc import chunking, service
from cruise_control_tpu_torch.config import CruiseControlConfig
from cruise_control_tpu_torch.model.resident import ResidentModelService
from cruise_control_tpu_torch.obsvc import memory
from cruise_control_tpu_torch.servlet.schemas import MEMORY_SCHEMA, validate
from cruise_control_tpu_torch.testing import deterministic as det
from cruise_control_tpu_torch.testing import random_cluster as trc

PAD = (16, 4)
BUDGET = 10_000


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Fresh (disabled) ledgers and compile services in both packages."""
    monkeypatch.setattr(memory, "_LEDGER", memory.DeviceMemoryLedger())
    monkeypatch.setattr(jmemory, "_LEDGER", jmemory.DeviceMemoryLedger())
    monkeypatch.setattr(service, "_GLOBAL", None)
    monkeypatch.setattr(jservice, "_GLOBAL", None)
    yield


def _ledgers(**kw):
    for mod in (memory, jmemory):
        mod.memory_ledger().configure(enabled=True, **kw)
    return memory.memory_ledger(), jmemory.memory_ledger()


def test_measure_bytes_equals_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(17, 4)).astype(np.float32),
              rng.integers(0, 9, size=33).astype(np.int32), np.zeros(5, bool)]
    want = jmemory.measure_bytes((arrays[0], {"a": arrays[1]}, [arrays[2], None, 3]))
    got = memory.measure_bytes((torch.from_numpy(arrays[0]), {"a": torch.from_numpy(arrays[1])},
                                [torch.from_numpy(arrays[2]), None, 3]))
    assert got == want == 17 * 4 * 4 + 33 * 4 + 5


def _resident_script(svc, fixtures):
    """A full freeze, a replica delta, a pinned snapshot and its release, a
    broker delta, an invalidation and a full freeze again."""
    cm = fixtures.small_cluster_model()
    load = fixtures.load
    svc.snapshot(cm, lambda r, b: PAD)
    cm.set_replica_load("T1", 0, 0, load(9.0, 9.0, 9.0, 9.0))
    svc.snapshot(cm, lambda r, b: PAD)
    svc.snapshot(cm, lambda r, b: PAD, pin=True)
    svc.release()
    cm.set_broker_state(2, alive=False)
    svc.snapshot(cm, lambda r, b: PAD)
    svc.invalidate("test")
    svc.snapshot(cm, lambda r, b: PAD)


def test_resident_posts_and_balance_equal_jax():
    ledger, jledger = _ledgers()
    imbalances = (ledger.imbalance_count, jledger.imbalance_count)
    _resident_script(ResidentModelService(device="cpu"), det)
    _resident_script(JService(), jdet)
    sub = memory.SUBSYS_RESIDENT
    assert ledger.live_bytes(sub) == jledger.live_bytes(sub) > 0
    assert ledger.pins() == jledger.pins() == 0
    assert ledger.verify_balanced() == jledger.verify_balanced() == []
    assert (ledger.imbalance_count, jledger.imbalance_count) == imbalances
    ev, jev = ledger.events(), jledger.events()
    assert jev == {"alloc": 2, "donate": 2, "free": 1, "pin": 1, "release": 1}
    # Where the JAX package donates, the port allocates the copies and frees
    # what they replace.
    assert ev == {"alloc": jev["alloc"] + jev["donate"], "free": jev["free"] + jev["donate"],
                  "pin": jev["pin"], "release": jev["release"]}
    snap, jsnap = ledger.snapshot(), jledger.snapshot()
    # The port's copies and the tensors they replace coexist for a moment,
    # so its peak may pass the JAX package's.
    assert snap["subsystems"][sub]["peakBytes"] >= jsnap["subsystems"][sub]["peakBytes"]
    for s in (snap, jsnap):
        s["subsystems"][sub].pop("peakBytes")
    assert snap["subsystems"][sub] == jsnap["subsystems"][sub]
    assert set(snap) == set(jsnap) and set(ledger.state_summary()) == set(
        jledger.state_summary())
    validate(snap, MEMORY_SCHEMA)
    # Nothing on the CPU reports allocator stats, in either package.
    assert snap["reconcile"]["driftBytes"] is None and jsnap["reconcile"]["driftBytes"] is None


def test_unbalanced_pins_are_reported_equal_jax():
    ledger, jledger = _ledgers()
    for led, sub in ((ledger, memory.SUBSYS_RESIDENT), (jledger, jmemory.SUBSYS_RESIDENT)):
        led.post(sub, 0, kind="pin")
        led.post(sub, 100, kind="alloc")
        led.post(sub, 150, kind="free")
    assert ledger.verify_balanced() == jledger.verify_balanced() != []
    assert ledger.live_bytes() == jledger.live_bytes() == 0


ROWS = {"L4": 1000, "L16": 4000}


@pytest.mark.parametrize("fraction,budget,n,compiled", [
    (0.5, BUDGET, 16, ()),        # fits: untouched
    (0.3, BUDGET, 16, ()),        # shrinks to 8-wide blocks
    (0.3, BUDGET, 16, (4,)),      # shrinks, riding the width already run
    (0.15, BUDGET, 13, ()),       # shrinks to 4
    (0.02, BUDGET, 16, ()),       # refuses: not even one lane fits
    (0.02, 0, 16, ()),            # no budget on the CPU: no basis to refuse
])
def test_guard_shrinks_and_refuses_equal_jax(fraction, budget, n, compiled):
    ledger, jledger = _ledgers(headroom_fraction=fraction, budget_bytes=budget)
    base = "R256-C64"
    for led in (ledger, jledger):
        for lanes, peak in ROWS.items():
            led.costs.ingest(f"{base}-{lanes}", {"peak_bytes": peak, "mode": "lowered",
                                                 "count": 1})
    ladder = (1, 2, 4, 8, 16)
    got = {}
    for name, led, mod in (("port", ledger, chunking), ("jax", jledger, jchunking)):
        shrinks, refusals = led._shrinks.count, led._refusals.count
        plan = mod.plan_lane_chunks(n, ladder, compiled=compiled, max_chunk=16)
        out, refused = led.guard_lane_plan(plan, n, base, ladder, compiled_widths=compiled)
        got[name] = ([(c.size, c.start, c.n_real) for c in out], refused,
                     led._shrinks.count - shrinks, led._refusals.count - refusals,
                     led.costs.peak_for_lanes(base, 8))
    assert got["port"] == got["jax"]


SMALL = dict(num_brokers=8, num_racks=4, num_topics=12, num_replicas=256, seed=11)
GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal"]
SETS = [[0], [1], [2], [3]]
WIDTH = 64


def test_refused_batch_equals_jax():
    ledger, jledger = _ledgers(headroom_fraction=0.01, budget_bytes=BUDGET)
    got = {}
    for name, led in (("port", ledger), ("jax", jledger)):
        if name == "port":
            st, pl, mt = trc.generate(trc.ClusterProperties(**SMALL), device="cpu")
            opt = GoalOptimizer(goal_names=GOALS)
        else:
            st, pl, mt = jrc.generate(jrc.ClusterProperties(**SMALL))
            opt = JOptimizer(goal_names=GOALS)
        led.costs.ingest(f"R{st.num_replicas_padded}-C{WIDTH}-L4",
                         {"peak_bytes": 50_000, "mode": "lowered", "count": 1})
        refusals = led._refusals.count
        res = opt.batch_remove_scenarios(st, pl, mt, SETS, num_candidates=WIDTH)
        fp = np.asarray(res.final_placements.broker)
        got[name] = dict(refused=res.memory_refused, preempted=res.preempted,
                         goals=res.goal_names, shapes=np.asarray(res.violated_after).shape,
                         stranded=np.asarray(res.stranded_after).tolist(),
                         seeded=bool((fp == np.asarray(pl.broker)[None]).all()),
                         lanes=fp.shape[0], refusals=led._refusals.count - refusals,
                         lane_bytes=led.live_bytes(memory.SUBSYS_LANES))
    assert got["port"] == got["jax"]
    assert got["port"]["refused"] and got["port"]["stranded"] == [-1] * 4


def test_shrunk_batch_runs_narrower_blocks_with_the_same_lanes():
    """The guard re-chunks a 4-lane batch (width 4 already run) onto 2-wide
    blocks; every lane's outcome equals the unguarded batch's, the lane
    blocks' posts balance, and the shrink is counted."""
    st, pl, mt = trc.generate(trc.ClusterProperties(**SMALL), device="cpu")
    opt = GoalOptimizer(goal_names=GOALS, solver=GoalSolver(dst_jitter_frac=0.0))
    plain = opt.batch_remove_scenarios(st, pl, mt, SETS, num_candidates=WIDTH)
    ledger, _ = _ledgers(headroom_fraction=0.3, budget_bytes=BUDGET)
    ledger.costs.ingest(f"R{st.num_replicas_padded}-C{WIDTH}-L4",
                        {"peak_bytes": 5000, "mode": "lowered", "count": 1})
    shrinks = ledger._shrinks.count
    res = opt.batch_remove_scenarios(st, pl, mt, SETS, num_candidates=WIDTH)
    assert ledger._shrinks.count == shrinks + 1 and not res.memory_refused
    key = service.compile_service().lane_key(GOALS, st.num_replicas_padded,
                                             st.num_brokers_padded, WIDTH)
    assert service.compile_service().compiled_lane_widths(key) == {2, 4}
    for f in ("stranded_after", "violated_after", "moves", "rounds"):
        assert np.array_equal(getattr(res, f), getattr(plain, f)), f
    assert torch.equal(res.final_placements.broker, plain.final_placements.broker)
    assert ledger.live_bytes(memory.SUBSYS_LANES) == 0
    assert ledger.events()["alloc"] == ledger.events()["free"] == 2


@pytest.mark.parametrize("props", [
    {}, {"memory.enabled": "false"},
    {"memory.headroom.fraction": "0.5", "memory.device.budget.bytes": "123456",
     "memory.analysis.mode": "full"}], ids=["defaults", "off", "every-key"])
def test_configure_equals_jax(props):
    led = memory.configure(CruiseControlConfig(props))
    jled = jmemory.configure(JConfig(props))
    assert led is memory.memory_ledger()
    fields = ("enabled", "headroom_fraction", "budget_override_bytes", "analysis_mode")
    assert [getattr(led, f) for f in fields] == [getattr(jled, f) for f in fields]
    assert led.device_budget_bytes() == jled.device_budget_bytes()
    snap = led.snapshot()
    validate(snap, MEMORY_SCHEMA)
    assert set(snap["subsystems"]) == set(jled.snapshot()["subsystems"])
    with pytest.raises(ValueError):
        led.configure(enabled=True, analysis_mode="deep")
