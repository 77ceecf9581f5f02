"""The port's convergence recorder, sensor history rings and model-fidelity
recorder against the JAX package's.

Counterparts of ``tests/test_obsvc.py``'s convergence and history tests
and of ``tests/test_fidelity.py``'s recorder tests: each script drives both
packages' recorder with the same inputs and an injected clock, and the
records must be equal (the recorders are float arithmetic on the same inputs
in the same order).  The fidelity tests that need the facade (the staleness
gate) are in ``tests/test_torch_facade.py``; the one over HTTP waits for the
port's servlet.

The new case solves one goal on the same random cluster in both packages
with round recording on, jitter off and exact top-k (a hard goal's
candidates are exact in both), and compares the round curves: integer
columns exactly, the metric column within rtol=1e-6, atol=1e-4.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.analyzer import solver as tsolver
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.common.metrics import MetricRegistry, registry
from cruise_control_tpu_torch.obsvc.convergence import (
    ROUND_COL_APPLIED,
    ROUND_COL_METRIC,
    ROUND_COL_RESYNC,
    ROUND_COL_STALL,
    ROUND_STATS_COLS,
    ConvergenceRecorder,
    curve_stats,
)
from cruise_control_tpu_torch.obsvc.fidelity import (
    EXTRAPOLATION_KINDS,
    ModelFidelityRecorder,
    fidelity,
)
from cruise_control_tpu_torch.obsvc.history import SAMPLES_SENSOR, HistoryRecorder, history
from cruise_control_tpu_torch.testing import deterministic as det

PKGS = {"jax": "cruise_control_tpu", "torch": "cruise_control_tpu_torch"}
TOL = dict(rtol=1e-6, atol=1e-4)


def _mods(root):
    names = dict(convergence="obsvc.convergence", fidelity="obsvc.fidelity",
                 history="obsvc.history", metrics="common.metrics")
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                              for k, v in names.items()})


def _both(script, *args):
    return {root: script(_mods(PKGS[root]), *args) for root in PKGS}


def _scrub(obj, keys=("id", "timestampMs")):
    if isinstance(obj, dict):
        return {k: _scrub(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v, keys) for v in obj]
    return obj


# ------------------------------------------------------- convergence recorder


def _convergence_script(m, seed):
    rng = np.random.default_rng(seed)
    rec = m.convergence.ConvergenceRecorder(enabled=True, ring_size=3)
    out = []
    for i in range(5):
        rounds = int(rng.integers(1, 6))
        curve = np.zeros((rounds, 6), dtype=np.float32)
        curve[:, 0] = rng.integers(0, 20, rounds)
        curve[:, 1] = rng.integers(0, 5, rounds)
        curve[:, 3] = np.sort(rng.random(rounds).astype(np.float32))[::-1]
        curve[:, 4] = rng.integers(0, 2, rounds)
        curve[:, 5] = rng.integers(0, 3, rounds)
        goals = [{"goal": "G", "curve": curve, "metric_before": 1.0, "rounds": rounds,
                  "moves": int(curve[:, 0].sum())},
                 {"goal": "H", "rounds": 0, "moves": 0}]
        if i % 2:
            goals[0].update(relax_ms=1.25, repair_rounds=rounds, relax_fallback=i == 3)
        out.append(rec.record_solve(goals, kind="propose", attrs={"generation": i}) is not None)
    out.append(rec.records())
    out.append(rec.state_summary())
    out.append(rec.drain())
    out.append(rec.drain())
    rec.configure(enabled=True, ring_size=2)
    out.append(rec.records())
    rec.configure(enabled=False, ring_size=2)
    out.append(rec.record_solve([{"goal": "G", "rounds": 1, "moves": 0}]))
    rec.configure(enabled=True, ring_size=4)
    rec.record_batch(["G1", "G2"], rng.integers(0, 9, (3, 2)).tolist(), warm_start=True)
    out.append(rec.records()[-1])
    out.append(rec.state_summary())
    rec.reset()
    out.append(rec.state_summary())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_convergence_records_equal_jax(seed):
    got = _both(_convergence_script, seed)
    assert _scrub(got["torch"]) == _scrub(got["jax"])
    out = got["torch"]
    assert len(out[5]) == 3 and out[6]["recorded"] == 5 and len(out[7]) == 5 and out[8] == []
    assert len(out[9]) == 2 and out[10] is None
    assert out[11]["kind"] == "what_if" and out[11]["lanes"] == 3


def test_convergence_recorder_ring_bounds_drain_and_disable():
    rec = ConvergenceRecorder(enabled=True, ring_size=3)
    curve = np.array([[2, 1, 0, 0.5, 0, 0]], dtype=np.float32)
    for _ in range(5):
        assert rec.record_solve([{"goal": "G", "curve": curve, "metric_before": 1.0,
                                  "rounds": 1, "moves": 2}]) is not None
    recs = rec.records()
    assert len(recs) == 3 and recs[0]["id"] < recs[-1]["id"]
    assert recs[-1]["goals"][0]["stats"]["moves_total"] == 2
    assert rec.state_summary()["recorded"] == 5
    assert len(rec.drain()) == 5 and rec.drain() == []
    assert len(rec.records()) == 3
    rec.configure(enabled=True, ring_size=2)
    assert len(rec.records()) == 2
    rec.configure(enabled=False, ring_size=2)
    assert rec.record_solve([{"goal": "G", "rounds": 1, "moves": 0}]) is None
    rec.configure(enabled=True, ring_size=4)
    rec.record_batch(["G1", "G2"], [[3, 1], [2, 1]], warm_start=True)
    last = rec.records()[-1]
    assert last["kind"] == "what_if" and last["lanes"] == 2 and last["warmStart"] is True
    assert last["laneRounds"] == {"G1": [3, 2], "G2": [1, 1]}


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_curve_stats_equal_jax(seed):
    rng = np.random.default_rng(seed)
    curve = np.zeros((8, 6), dtype=np.float32)
    curve[:, ROUND_COL_APPLIED] = rng.integers(0, 30, 8)
    curve[:, ROUND_COL_METRIC] = np.sort(rng.random(8).astype(np.float32))[::-1]
    curve[:, ROUND_COL_STALL] = rng.integers(0, 2, 8)
    got = _both(lambda m: [m.convergence.curve_stats(curve, b) for b in (0.0, 1.0, 2.5)]
                + [m.convergence._curve_rows(curve)])
    assert got["torch"] == got["jax"]
    s = curve_stats(np.zeros((4, 6), dtype=np.float32), 0.0)
    assert s["rounds_to_90pct"] == 4 and s["acceptance_rate"] == 0.0


def test_curve_stats_derivations():
    curve = np.zeros((4, 6), dtype=np.float32)
    curve[:, ROUND_COL_APPLIED] = [10, 5, 1, 0]
    curve[:, ROUND_COL_METRIC] = [0.5, 0.2, 0.12, 0.1]
    curve[3, ROUND_COL_STALL] = 1
    s = curve_stats(curve, metric_before=1.0)
    assert s["rounds_total"] == 4 and s["moves_total"] == 16
    assert s["acceptance_rate"] == 0.4
    assert s["rounds_to_90pct"] == 3 and s["stall_rounds"] == 1


def test_round_recording_off_and_on():
    """Off (the default) the infos carry no curve; on, every goal's curve
    has a row a round whose applied column sums to its moves, and the
    optimizer records the solve."""
    assert not tsolver.round_recording_enabled()
    state, placement, meta = det.unbalanced2().freeze(pad_replicas_to=64, pad_brokers_to=8,
                                                     device="cpu")
    opt = GoalOptimizer(goal_names=["ReplicaDistributionGoal"])
    res_off = opt.optimizations(state, placement, meta)
    assert all(i.round_curve is None for i in res_off.goal_infos)
    from cruise_control_tpu_torch.obsvc.convergence import convergence
    rec = convergence()
    prev = (rec.enabled, rec._ring.maxlen)
    tsolver.set_round_recording(True)
    rec.configure(enabled=True, ring_size=4)
    try:
        res_on = opt.optimizations(state, placement, meta)
        last = rec.records()[-1]
    finally:
        tsolver.set_round_recording(False)
        rec.configure(enabled=prev[0], ring_size=prev[1])
    checked = 0
    for info in res_on.goal_infos:
        assert info.round_curve.shape == (info.rounds, ROUND_STATS_COLS)
        assert int(info.round_curve[:, ROUND_COL_APPLIED].sum()) == info.moves_applied
        checked += info.rounds
    assert checked > 0
    assert last["kind"] == "propose" and last["goals"][0]["goal"] == "ReplicaDistributionGoal"
    assert len(last["goals"][0]["curve"]) == res_on.goal_infos[0].rounds
    assert {p.topic_partition for p in res_on.proposals} == \
        {p.topic_partition for p in res_off.proposals}


@pytest.mark.parametrize("name,priors", [("RackAwareGoal", []),
                                         ("ReplicaCapacityGoal", ["RackAwareGoal"])])
def test_round_curves_equal_jax(name, priors):
    """One goal's solve in both packages with round recording on: the same
    rows round by round."""
    from cruise_control_tpu.analyzer import solver as jsolver
    from cruise_control_tpu.analyzer.goals.registry import goal_by_name as jgoal
    from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name
    from tests.test_torch_solver import PROPS, _pair

    (jg, jp), (tg, tp) = _pair(dict(PROPS, seed=9))
    jsolver.set_round_recording(True)
    tsolver.set_round_recording(True)
    try:
        js = jsolver.GoalSolver(dst_jitter_frac=0.0)
        assert js._width(jgoal(name), tp.broker.shape[0]) >= tp.broker.shape[0] or \
            jgoal(name).is_hard                     # exact top-k in JAX
        _, _, jinfo = js.optimize_goal(jgoal(name), tuple(jgoal(n) for n in priors), jg, jp)
        _, _, tinfo = tsolver.GoalSolver(dst_jitter_frac=0.0).optimize_goal(
            goal_by_name(name), [goal_by_name(n) for n in priors], tg, tp)
    finally:
        jsolver.set_round_recording(False)
        tsolver.set_round_recording(False)
    jc, tc = np.asarray(jinfo.round_curve), tinfo.round_curve
    assert tinfo.rounds == jinfo.rounds > 0 and tc.shape == jc.shape
    ints = [c for c in range(ROUND_STATS_COLS) if c != ROUND_COL_METRIC]
    np.testing.assert_array_equal(tc[:, ints], jc[:, ints])
    np.testing.assert_allclose(tc[:, ROUND_COL_METRIC], jc[:, ROUND_COL_METRIC], **TOL)
    assert tc.dtype == np.float32
    if tinfo.rounds > 4:
        assert tc[4, ROUND_COL_RESYNC] == 1.0
    import jax
    jax.clear_caches()


# ------------------------------------------------------------- history rings


def _history_script(m, monkeypatch):
    reg = m.metrics.MetricRegistry()
    monkeypatch.setattr(importlib.import_module(m.history.__name__), "registry", lambda: reg)
    clock = {"now": 1000.0}
    rec = m.history.HistoryRecorder(interval_s=3600.0, ring_size=3,
                                    clock=lambda: clock["now"])
    reg.settable_gauge("HistTest.value").set(1.0)
    reg.gauge("HistTest.broken", lambda: 1 / 0)
    t = reg.timer("HistTest.op-timer")
    c = reg.counter("HistTest.count")
    out = []
    for i in range(5):
        clock["now"] += 1.0
        t.update_ms(10.0 * (i + 1))
        c.inc(i)
        reg.settable_gauge("HistTest.value").set(float(i))
        out.append(rec.sample_once())
    rec.record_event("HistTest.event", 3.0, ts_ms=5.0)
    out += [rec.names(), rec.series("HistTest.value"), rec.history(pattern="HistTest.*"),
            rec.history(pattern="HistTest.*", since_ms=clock["now"] * 1000.0),
            rec.history_bounded(pattern="HistTest.*", limit=2),
            reg.counter(m.history.SAMPLES_SENSOR).count]
    rec.configure(interval_s=1.0, ring_size=2)
    out.append(rec.series("HistTest.op-timer.p50_ms"))
    rec.reset()
    out.append(rec.names())
    return out


def test_history_rings_equal_jax(monkeypatch):
    got = _both(_history_script, monkeypatch)
    assert got["torch"] == got["jax"]
    out = got["torch"]
    assert out[5] == sorted(out[5]) and "HistTest.op-timer.max_ms" in out[5]
    assert len(out[6]) == 3 and out[6][-1] == [1005000.0, 4.0]
    assert out[9][1] is True and len(out[9][0]) == 2
    assert out[10] == 5 and out[-1] == []


def test_history_recorder_ring_bounds_and_filters(monkeypatch):
    history_mod = importlib.import_module("cruise_control_tpu_torch.obsvc.history")
    reg = MetricRegistry()
    monkeypatch.setattr(history_mod, "registry", lambda: reg)
    clock = {"now": 1000.0}
    rec = HistoryRecorder(interval_s=3600.0, ring_size=2, clock=lambda: clock["now"])
    reg.settable_gauge("HistTest.value").set(1.0)
    before = reg.counter(SAMPLES_SENSOR).count
    for _ in range(3):
        clock["now"] += 1.0
        rec.sample_once()
    assert reg.counter(SAMPLES_SENSOR).count == before + 3
    series = rec.series("HistTest.value")
    assert len(series) == 2 and series[0][0] < series[1][0] and series[-1][1] == 1.0
    assert set(rec.history(pattern="HistTest.*")) == {"HistTest.value"}
    assert rec.history(pattern="HistTest.*",
                       since_ms=clock["now"] * 1000.0 + 1)["HistTest.value"] == []
    assert not rec.running


def test_history_thread_starts_and_stops():
    rec = HistoryRecorder(interval_s=0.01, ring_size=4)
    rec.start()
    try:
        assert rec.running
    finally:
        rec.stop()
    assert not rec.running


# ------------------------------------------------------- fidelity recorder


def _completeness(generation=7, valid_windows=(0, 1, 2, 3, 4), num_entities=10,
                  avg_available=3, avg_adjacent=1, forecast=1, valid_ratio=0.5):
    """A synthetic MetricSampleCompleteness (record_fingerprint reads it
    through getattr)."""
    return SimpleNamespace(
        generation=generation, valid_windows=list(valid_windows),
        num_entity_windows=num_entities * len(valid_windows),
        num_windows_avg_available=avg_available, num_windows_avg_adjacent=avg_adjacent,
        num_windows_forecast=forecast, valid_entity_ratio=valid_ratio)


def _fidelity_script(m, seed):
    """A seeded sequence of every recorder call, with an injected clock."""
    rng = np.random.default_rng(seed)
    now = [1_000.0]
    rec = m.fidelity.ModelFidelityRecorder(enabled=True, ring_size=4, clock=lambda: now[0])
    reg = m.metrics.registry()
    sensors = ("Monitor.fetched-samples", "Monitor.window-closes",
               "Monitor.broker-liveness-flaps", "Monitor.model-freezes",
               "Monitor.model-delta-applies", "Monitor.dropped-samples-inconsistent",
               "Monitor.out-of-order-samples", "Monitor.stale-model-gates")
    base = {s: reg.counter(s).count for s in sensors}
    out = [rec.staleness_reason(), rec.fingerprint_age_ms(), rec.invalid_partition_ratio()]
    alive = {b: True for b in range(6)}
    for step in range(12):
        now[0] += float(rng.integers(1, 50))
        rec.on_fetch(int(rng.integers(0, 100)), int(rng.integers(0, 10)))
        for b in rng.integers(0, 6, 2):
            alive[int(b)] = not alive[int(b)]
        rec.record_liveness(dict(alive), now_ms=now[0] * 1000.0)
        rec.on_window_close(step, 1000, now_ms=now[0] * 1000.0)
        rec.on_dropped("inconsistent", int(rng.integers(0, 3)))
        rec.on_dropped("out_of_order", int(rng.integers(0, 3)))
        n = int(rng.integers(1, 5))
        fp = rec.record_fingerprint(
            _completeness(generation=step, valid_windows=tuple(range(step, step + n)),
                          num_entities=int(rng.integers(1, 20)),
                          avg_available=int(rng.integers(0, 5)),
                          avg_adjacent=int(rng.integers(0, 5)),
                          forecast=int(rng.integers(0, 5)),
                          valid_ratio=float(rng.random())),
            window_ms=1000, dead_brokers=[b for b, a in alive.items() if not a],
            capacity_source="Fixed", kind="delta" if step % 3 else "freeze")
        rec.configure(enabled=True, min_valid_partition_ratio=float(rng.random()),
                      max_age_ms=int(rng.integers(0, 3)) * 10_000)
        out.append((fp, rec.staleness_reason(), rec.fingerprint_age_ms(),
                    rec.valid_partition_ratio(), rec.invalid_partition_ratio(),
                    rec.extrapolated_fraction()))
        if step == 6:
            rec.record_stale_gate()
            rec.configure(enabled=True, ring_size=6)
    out += [rec.quality(), rec.state_summary(),
            {s: reg.counter(s).count - base[s] for s in sensors}]
    rec.configure(enabled=False)
    out += [rec.record_fingerprint(_completeness(), window_ms=1000), rec.state_summary()]
    rec.reset()
    out.append(rec.quality())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fidelity_records_equal_jax(seed):
    got = _both(_fidelity_script, seed)
    assert got["torch"] == got["jax"]
    out = got["torch"]
    assert out[0] is None and out[1] == 0.0 and out[2] == 0.0
    quality, summary, deltas, off_fp = out[-6:-2]
    assert summary["modelFreezes"] + summary["modelDeltaApplies"] == 12
    assert len(quality["recentFingerprints"]) == 6
    assert deltas["Monitor.window-closes"] == 12 and deltas["Monitor.stale-model-gates"] == 1
    assert off_fp is None and out[-1]["fingerprint"] is None


def test_fidelity_register_sensors_equal_jax():
    from cruise_control_tpu.common.metrics import registry as jregistry

    importlib.import_module("cruise_control_tpu.obsvc.fidelity").register_sensors()
    importlib.import_module("cruise_control_tpu_torch.obsvc.fidelity").register_sensors()
    names = {n for n in registry().snapshot() if n.startswith("Monitor.")}
    jnames = {n for n in jregistry().snapshot() if n.startswith("Monitor.")}
    fid_names = {"Monitor.fingerprint-age-ms", "Monitor.valid-partition-ratio",
                 "Monitor.invalid-partition-ratio", "Monitor.extrapolated-fraction",
                 "Monitor.fetched-samples", "Monitor.stored-samples",
                 "Monitor.out-of-order-samples", "Monitor.dropped-samples-undecodable",
                 "Monitor.dropped-samples-inconsistent", "Monitor.window-closes",
                 "Monitor.broker-liveness-flaps", "Monitor.model-freezes",
                 "Monitor.model-delta-applies", "Monitor.stale-model-gates",
                 "Monitor.ingest-commit-latency-ms"}
    assert fid_names <= names and fid_names <= jnames


def test_fingerprint_fields_and_age_recompute():
    now = [1_000_000.0]
    rec = ModelFidelityRecorder(enabled=True, clock=lambda: now[0])
    comp = _completeness(generation=3, valid_windows=(2, 3, 4), num_entities=4,
                         avg_available=2, avg_adjacent=1, forecast=0, valid_ratio=0.75)
    fp = rec.record_fingerprint(comp, window_ms=1000, dead_brokers=[5, 1],
                                capacity_source="StaticCapacityResolver", kind="delta")
    assert fp["generation"] == 3 and fp["windowEndMs"] == 5000 and fp["validWindows"] == 3
    assert fp["validPartitionRatio"] == 0.75 and fp["deadBrokers"] == [1, 5]
    assert fp["extrapolatedFraction"] == {"AVG_AVAILABLE": round(2 / 12, 6),
                                          "AVG_ADJACENT": round(1 / 12, 6), "FORECAST": 0.0}
    assert set(fp["extrapolatedFraction"]) == set(EXTRAPOLATION_KINDS)
    age0 = rec.current_fingerprint()["ageMs"]
    now[0] += 7.5
    assert rec.current_fingerprint()["ageMs"] == pytest.approx(age0 + 7500.0, abs=1.0)
    assert rec.state_summary()["modelDeltaApplies"] == 1


def test_staleness_reason_strings_and_disabled_defaults():
    now = [2_000.0]
    rec = ModelFidelityRecorder(enabled=True, clock=lambda: now[0])
    rec.configure(enabled=True, min_valid_partition_ratio=0.9, max_age_ms=1)
    assert rec.staleness_reason() is None and rec.fingerprint_age_ms() == 0.0
    rec.record_fingerprint(_completeness(valid_ratio=0.5), window_ms=1000)
    assert rec.staleness_reason() == "valid-partition-ratio 0.500 < 0.9"
    rec.configure(enabled=True, min_valid_partition_ratio=0.4, max_age_ms=60_000)
    reason = rec.staleness_reason()
    assert reason.startswith("fingerprint-age ") and reason.endswith("ms > 60000ms")
    rec.configure(enabled=True, min_valid_partition_ratio=0.0, max_age_ms=0)
    assert rec.staleness_reason() is None
    assert rec.invalid_partition_ratio() == pytest.approx(0.5)


def test_on_fetch_counter_and_last_fetch():
    rec = ModelFidelityRecorder(enabled=True, clock=lambda: 12.0)
    base = registry().counter("Monitor.fetched-samples").count
    rec.on_fetch(7, 3)
    assert registry().counter("Monitor.fetched-samples").count == base + 10
    assert rec.quality()["lastFetch"] == {"partitionSamples": 7, "brokerSamples": 3,
                                          "atMs": 12000.0}
    off = ModelFidelityRecorder(enabled=False)
    off.on_fetch(4, 1)
    assert registry().counter("Monitor.fetched-samples").count == base + 15
    assert off._last_fetch["atMs"] is None


def test_on_dropped_causes_and_unknown_cause_raises():
    rec = ModelFidelityRecorder(enabled=True)
    sensors = {"undecodable": "Monitor.dropped-samples-undecodable",
               "inconsistent": "Monitor.dropped-samples-inconsistent",
               "out_of_order": "Monitor.out-of-order-samples"}
    for cause, sensor in sensors.items():
        base = registry().counter(sensor).count
        rec.on_dropped(cause, count=3)
        assert registry().counter(sensor).count == base + 3
    with pytest.raises(ValueError):
        rec.on_dropped("cosmic_rays")


def test_on_window_close_ring_latency_and_history_event():
    rec = ModelFidelityRecorder(enabled=True)
    base = registry().counter("Monitor.window-closes").count
    rec.on_window_close(4, 1000, now_ms=5250.0)
    assert registry().counter("Monitor.window-closes").count == base + 1
    assert rec.quality()["windowQuality"][-1] == {"window": 4, "windowEndMs": 5000,
                                                  "closedAtMs": 5250.0,
                                                  "ingestCommitMs": 250.0}
    assert [5250.0, float(base + 1)] in history().series("Monitor.window-closes")
    rec.on_window_close(5, 1000, now_ms=5500.0)
    assert rec.quality()["windowQuality"][-1]["ingestCommitMs"] == 0.0
    off = ModelFidelityRecorder(enabled=False)
    off.on_window_close(1, 1000, now_ms=2100.0)
    assert registry().counter("Monitor.window-closes").count == base + 3
    assert len(off._windows) == 0


def test_record_liveness_flap_detection():
    rec = ModelFidelityRecorder(enabled=True)
    counter = registry().counter("Monitor.broker-liveness-flaps")
    base = counter.count
    rec.record_liveness({0: True, 1: True}, now_ms=1.0)
    rec.record_liveness({0: True, 1: False}, now_ms=2.0)
    rec.record_liveness({0: True, 1: False}, now_ms=3.0)
    rec.record_liveness({0: False, 1: True}, now_ms=4.0)
    assert counter.count == base + 3
    flaps = rec.quality()["livenessFlaps"]
    assert flaps[0] == {"broker": 1, "alive": False, "atMs": 2.0}


def test_ring_bounds_resize_reset_and_disabled():
    rec = ModelFidelityRecorder(enabled=True, ring_size=4)
    for g in range(6):
        rec.record_fingerprint(_completeness(generation=g), window_ms=1000)
    assert [f["generation"] for f in rec.quality()["recentFingerprints"]] == [2, 3, 4, 5]
    rec.configure(enabled=True, ring_size=8)
    assert [f["generation"] for f in rec.quality()["recentFingerprints"]] == [2, 3, 4, 5]
    rec.reset()
    assert rec.current_fingerprint() is None and rec.state_summary()["modelFreezes"] == 0
    off = ModelFidelityRecorder(enabled=False)
    assert off.record_fingerprint(_completeness(), window_ms=1000) is None
    assert off.quality()["fingerprint"] is None


def test_fingerprint_with_no_valid_windows():
    rec = ModelFidelityRecorder(enabled=True, clock=lambda: 100.0)
    fp = rec.record_fingerprint(
        _completeness(valid_windows=(), num_entities=0, avg_available=0, avg_adjacent=0,
                      forecast=0, valid_ratio=0.0), window_ms=1000)
    assert fp["windowEndMs"] is None and fp["ageMs"] is None and fp["validWindows"] == 0
    assert rec.fingerprint_age_ms() == 0.0
    rec.configure(enabled=True, max_age_ms=1)
    assert rec.staleness_reason() is None
    rec.configure(enabled=True, min_valid_partition_ratio=0.5)
    assert "valid-partition-ratio" in rec.staleness_reason()


def test_fidelity_off_path_stamps_nothing_and_on_path_stamps_results():
    """Off, the optimizer stamps no fingerprint; on, the result and every
    proposal carry the current fingerprint, with the same moves."""
    rec = fidelity()
    prev = (rec.enabled, rec.min_valid_partition_ratio, rec.max_age_ms)
    state, placement, meta = det.unbalanced2().freeze(pad_replicas_to=64, pad_brokers_to=8,
                                                     device="cpu")
    opt = GoalOptimizer(goal_names=["ReplicaDistributionGoal"])
    try:
        rec.configure(enabled=False)
        res_off = opt.optimizations(state, placement, meta)
        assert res_off.fingerprint is None
        assert all(p.fingerprint is None for p in res_off.proposals)
        rec.configure(enabled=True)
        assert rec.record_fingerprint(_completeness(generation=42), window_ms=1000)
        res_on = opt.optimizations(state, placement, meta)
    finally:
        rec.configure(enabled=prev[0], min_valid_partition_ratio=prev[1], max_age_ms=prev[2])
        rec.reset()
    assert res_on.proposals
    assert {p.topic_partition for p in res_on.proposals} == \
        {p.topic_partition for p in res_off.proposals}
    assert res_on.fingerprint["generation"] == 42
    assert all(p.fingerprint["generation"] == 42 for p in res_on.proposals)
    assert isinstance(state.valid, torch.Tensor)


def test_monitor_feeds_the_recorder():
    """The port monitor's calls into the recorder (fetch counts, liveness,
    window closes, fingerprints at freeze and delta) land as in JAX."""
    from tests.test_torch_monitor import _fake_cluster
    from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
    from cruise_control_tpu_torch.monitor.metadata import MetadataClient
    from cruise_control_tpu_torch.monitor.sampler import SyntheticWorkloadSampler
    from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner

    rec = fidelity()
    rec.reset()
    reg = registry()
    base = {s: reg.counter(s).count for s in ("Monitor.fetched-samples",
                                              "Monitor.window-closes",
                                              "Monitor.model-freezes",
                                              "Monitor.model-delta-applies")}
    lm = LoadMonitor(MetadataClient(_fake_cluster(), ttl_ms=0), num_windows=3,
                     window_ms=1000, min_samples_per_window=1)
    runner = LoadMonitorTaskRunner(lm, SyntheticWorkloadSampler(), sampling_interval_ms=1000)
    runner.bootstrap(0, 4000)
    runner._state = type(runner._state).RUNNING
    for t in (4500, 5500, 6500):
        runner.run_sampling_once(now_ms=t)
    lm.cluster_model(device="cpu")
    lm.resident_model_builder()
    lm.resident_model_builder()
    d = {s: reg.counter(s).count - v for s, v in base.items()}
    assert d["Monitor.fetched-samples"] > 0
    assert d["Monitor.window-closes"] >= 2
    assert d["Monitor.model-freezes"] == 2 and d["Monitor.model-delta-applies"] == 1
    fp = rec.current_fingerprint()
    assert fp["kind"] == "delta" and fp["validWindows"] >= 1
    assert rec.quality()["lastFetch"]["partitionSamples"] > 0
    rec.reset()
