"""The port's execution observatory (flight recorder), self-healing audit log
and operation log against the JAX package's.

The first half holds the port to the flight-recorder tests of
``tests/test_execution_obs.py``, one counterpart each (the off-path and
storm tests there need the optimizer's provenance stamping and the facade,
which the port does not have yet).  The second half makes the same call
sequence on both packages' recorder, audit log and operation log and
compares the records: equal apart from wall-clock timestamps and the
process-wide id counters.  The EWMA is float arithmetic on the same
inputs in the same order, so it is compared with ``rel=1e-12``.
"""

import importlib
import itertools
import logging
import threading
from types import SimpleNamespace

import pytest

from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, ExecutionTaskState, TaskType
from cruise_control_tpu_torch.obsvc.execution import (
    ExecutionFlightRecorder,
    execution,
    path_histogram,
    register_sensors,
)
from tests.test_torch_executor import proposal

PKGS = {"jax": "cruise_control_tpu", "torch": "cruise_control_tpu_torch"}
CLOCK_KEYS = {"timestampMs", "startedMs", "durationMs", "movesPerSecond", "id",
              "executionId"}


def _mods(root):
    names = dict(actions="common.actions", execution="obsvc.execution", audit="obsvc.audit",
                 oplog="obsvc.oplog", tasks="executor.tasks", metrics="common.metrics")
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                              for k, v in names.items()})


def _task(i, old, new, mod=None):
    tasks = mod.tasks if mod else None
    et, tt = (tasks.ExecutionTask, tasks.TaskType) if tasks else (ExecutionTask, TaskType)
    return et(proposal("T", i, old, new, mod=mod), tt.INTER_BROKER_REPLICA_ACTION)


def _complete(rec, task, at_ms, states):
    rec.on_transition(task, states.IN_PROGRESS, at_ms)
    task.transition(states.IN_PROGRESS, at_ms)
    rec.on_transition(task, states.COMPLETED, at_ms)
    task.transition(states.COMPLETED, at_ms)


# ------------------------------------ the JAX flight-recorder tests, ported


def test_recorder_ewma_and_eta():
    rec = ExecutionFlightRecorder(alpha=0.5)
    tasks = [_task(i, [0, 1], [2, 1]) for i in range(4)]
    rec.begin_batch(tasks, principal="admin", request_id="req-1")
    assert rec.seconds_per_move() == 0.0
    _complete(rec, tasks[0], 1000.0, ExecutionTaskState)
    assert rec.seconds_per_move() == 0.0
    _complete(rec, tasks[1], 2000.0, ExecutionTaskState)
    assert rec.seconds_per_move() == pytest.approx(1.0)
    _complete(rec, tasks[2], 2500.0, ExecutionTaskState)
    assert rec.seconds_per_move() == pytest.approx(0.75)
    assert rec.moves_per_second() == pytest.approx(1 / 0.75)
    assert rec.eta_seconds() == pytest.approx(0.75)
    prog = rec.progress()
    assert prog["active"] and prog["throughput"]["completed"] == 3
    assert prog["throughput"]["etaSeconds"] == pytest.approx(0.75, abs=0.01)
    assert prog["batch"]["principal"] == "admin" and prog["batch"]["requestId"] == "req-1"
    summary = rec.end_batch(completed=3, dead=0, aborted=1, moved_mb=1.5)
    assert summary["completed"] == 3 and summary["aborted"] == 1
    assert summary["pathHistogram"] == {"unknown": 4}
    assert rec.seconds_per_move() == 0.0 and rec.eta_seconds() == 0.0
    assert rec.inflight_moves() == 0
    assert rec.drain() == [summary] and rec.drain() == []
    assert rec.state_summary()["lastBatch"] == summary


def test_recorder_inflight_per_broker():
    rec = ExecutionFlightRecorder()
    t1, t2 = _task(0, [0, 1], [2, 1]), _task(1, [0, 3], [3, 0])
    rec.begin_batch([t1, t2])
    for t in (t1, t2):
        rec.on_transition(t, ExecutionTaskState.IN_PROGRESS, 0.0)
        t.transition(ExecutionTaskState.IN_PROGRESS, 0.0)
    assert rec.inflight_moves() == 2
    assert rec.progress()["inflightPerBroker"] == {"0": 2, "1": 1, "2": 1, "3": 1}
    rec.on_transition(t1, ExecutionTaskState.COMPLETED, 1.0)
    t1.transition(ExecutionTaskState.COMPLETED, 1.0)
    assert rec.progress()["inflightPerBroker"] == {"0": 1, "3": 1}


def test_recorder_tuner_events_and_disabled_noop():
    rec = ExecutionFlightRecorder()
    rec.begin_batch([_task(0, [0, 1], [2, 1])])
    base = registry().counter("Executor.tuner-decreases").count
    rec.record_tuner("decrease", "task-dead", cap=2)
    rec.record_tuner("increase", "batch-drained", cap=3)
    assert registry().counter("Executor.tuner-decreases").count == base + 1
    prog = rec.progress()
    assert prog["batch"]["tunerDecreases"] == 1 and prog["batch"]["tunerIncreases"] == 1
    assert [e["signal"] for e in prog["tunerEvents"]] == ["task-dead", "batch-drained"]
    assert prog["tunerEvents"][0]["cap"] == 2
    off = ExecutionFlightRecorder(enabled=False)
    off.begin_batch([_task(0, [0, 1], [2, 1])])
    off.on_transition(_task(1, [0, 1], [2, 1]), ExecutionTaskState.IN_PROGRESS, 0.0)
    assert off.end_batch(1, 0, 0, 0.0) is None
    assert off.progress() == {"enabled": False, "active": False, "tunerEvents": [],
                              "recentBatches": []}


def test_path_histogram_counts_unknown():
    p1 = proposal("T", 0, [0, 1], [2, 1])
    p2 = proposal("T", 1, [0, 1], [3, 1])
    object.__setattr__(p2, "provenance", {"path": "relax", "goal": "G"})
    assert path_histogram([p1, p2]) == {"unknown": 1, "relax": 1}


def test_register_sensors_reads_the_recorder():
    register_sensors()
    rec = execution()
    snap = registry().snapshot()
    assert snap["Executor.seconds-per-move"]["value"] == rec.seconds_per_move()
    assert snap["Executor.moves-per-second"]["value"] == rec.moves_per_second()
    assert snap["Executor.eta-seconds"]["value"] == rec.eta_seconds()
    assert snap["Executor.inflight-moves"]["value"] == float(rec.inflight_moves())
    assert "Executor.tuner-increases" in snap and "Executor.tuner-decreases" in snap


# ------------------------------------ both packages, the same call sequence


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in CLOCK_KEYS}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _recorder_script(mod, alpha, steps):
    """Drive one recorder through a batch: ``steps`` are (task index, to
    state, ms); progress snapshots after each step, tuner events, the end
    summary and the state summary."""
    rec = mod.execution.ExecutionFlightRecorder(alpha=alpha, ring_size=4)
    tasks = [_task(i, [i % 5, (i + 1) % 5], [(i + 2) % 5, (i + 1) % 5], mod=mod)
             for i in range(6)]
    rec.begin_batch(tasks, principal="ops", request_id="r-7")
    S = mod.tasks.ExecutionTaskState
    snaps = []
    for i, to, ms in steps:
        rec.on_transition(tasks[i], getattr(S, to), ms)
        tasks[i].transition(getattr(S, to), ms)
        if to == "DEAD":
            rec.record_tuner("decrease", "task-dead", cap=1)
        snaps.append((rec.progress(), rec.seconds_per_move(), rec.eta_seconds(),
                      rec.inflight_moves()))
    rec.record_tuner("increase", "batch-drained", cap=2)
    done = [t.state.name for t in tasks]
    summary = rec.end_batch(completed=done.count("COMPLETED"), dead=done.count("DEAD"),
                            aborted=done.count("ABORTED"), moved_mb=0.123456)
    return snaps, summary, rec.progress(), rec.state_summary(), rec.drain()


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.9])
def test_flight_recorder_records_equal_jax(alpha):
    steps = [(0, "IN_PROGRESS", 10.0), (1, "IN_PROGRESS", 11.0), (0, "COMPLETED", 250.0),
             (2, "IN_PROGRESS", 260.0), (1, "COMPLETED", 900.5), (3, "IN_PROGRESS", 901.0),
             (2, "DEAD", 1500.0), (3, "ABORTING", 1600.0), (3, "ABORTED", 1601.0),
             (4, "IN_PROGRESS", 1700.0), (4, "COMPLETED", 1713.25), (5, "IN_PROGRESS", 1800.0),
             (5, "COMPLETED", 2400.0)]
    got = {root: _recorder_script(_mods(PKGS[root]), alpha, steps) for root in PKGS}
    (jsnaps, jsum, jprog, jstate, jdrain) = got["jax"]
    (tsnaps, tsum, tprog, tstate, tdrain) = got["torch"]
    assert len(tsnaps) == len(jsnaps) == len(steps)
    for (tp, tspm, teta, tin), (jp, jspm, jeta, jin) in zip(tsnaps, jsnaps):
        assert _scrub(tp) == _scrub(jp)
        assert tspm == pytest.approx(jspm, rel=1e-12)
        assert teta == pytest.approx(jeta, rel=1e-12)
        assert tin == jin
    assert _scrub(tsum) == _scrub(jsum)
    assert tsum["completed"] == 4 and tsum["dead"] == 1 and tsum["aborted"] == 1
    assert _scrub(tprog) == _scrub(jprog)
    assert _scrub(tstate) == _scrub(jstate)
    assert _scrub(tdrain) == _scrub(jdrain)


class _ThreadPrivateIds:
    """Stands in for an audit module's process-wide ``_IDS`` counter while
    one thread runs a script: that thread draws 1, 2, 3, ... of its own, and
    any other thread (a detector manager an earlier test left running) draws
    from the original counter.  Earlier tests on the same worker advance the
    JAX package's counter and not the port's, so without this the two
    scripts would start from different absolute ids."""

    def __init__(self, original):
        self._original = original
        self._owner = threading.get_ident()
        self._own = itertools.count(1)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._own if threading.get_ident() == self._owner else self._original)


def _audit_script(mod):
    log = mod.audit.AuditLog(maxlen=3)
    ids = [log.record("BROKER_FAILURE", {"failedBrokers": {"1": 0.0}}, "FIX"),
           log.record("GOAL_VIOLATION", {"fixable": ["RackAwareGoal"]}, "CHECK_WITH_DELAY")]
    log.set_action("BROKER_FAILURE", "remove_broker")
    log.set_outcome(ids[0], "FIX_STARTED")
    log.attach_execution_outcome(completed=5, dead=1, aborted=0, moved_mb=12.3456,
                                 provenance_paths={"unknown": 6})
    log.attach_execution_outcome(completed=9, dead=0, aborted=0, moved_mb=1.0)  # no entry left
    ids.append(log.record("DISK_FAILURE", {"failedDisks": {"2": [0]}}, "IGNORED"))
    ids.append(log.record("GOAL_VIOLATION", {"fixable": []}, "FIX"))
    log.set_outcome(ids[-1], "FIX_FAILED_TO_START")
    log.set_action("GOAL_VIOLATION", "rebalance")
    first = log.entries()
    log.configure(maxlen=2)
    second = log.entries()
    log.clear()
    return first, second, log.entries(), [i - ids[0] for i in ids]


def test_audit_log_records_equal_jax(monkeypatch):
    mods = {root: _mods(PKGS[root]) for root in PKGS}
    for mod in mods.values():
        monkeypatch.setattr(mod.audit, "_IDS", _ThreadPrivateIds(mod.audit._IDS))
    got = {root: _audit_script(mods[root]) for root in PKGS}
    assert _scrub(got["torch"][:3]) == _scrub(got["jax"][:3])
    assert got["torch"][3] == got["jax"][3]
    first = got["torch"][0]
    assert [e["anomalyType"] for e in first] == ["GOAL_VIOLATION", "DISK_FAILURE",
                                                 "GOAL_VIOLATION"]
    assert got["torch"][2] == []


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_oplog_lines_equal_jax():
    lines = {}
    for root in PKGS:
        mod = _mods(PKGS[root])
        handler = _Capture()
        mod.oplog.OPLOG.addHandler(handler)
        level = mod.oplog.OPLOG.level
        mod.oplog.OPLOG.setLevel(logging.INFO)
        try:
            token = mod.oplog.set_principal("alice")
            rid = mod.oplog.set_request_id("req-42")
            mod.oplog.record("start", endpoint="executor.batch", tasks=3, proposals=4,
                             request_id=mod.oplog.current_request_id(), generation=None)
            mod.oplog.record("finish", task_id="abc", endpoint="rebalance",
                             params="dryrun=false&goals=a b", executed=True,
                             reason="line\nbreak", moved_mb=1.5)
            mod.oplog.record("abort", principal="", endpoint="x", empty="")
            with pytest.raises(ValueError, match="unknown operation outcome"):
                mod.oplog.record("crashed")
            mod.oplog._principal.reset(token)
            mod.oplog._request_id.reset(rid)
            mod.oplog.record("preempted", reason="deadline")
        finally:
            mod.oplog.OPLOG.removeHandler(handler)
            mod.oplog.OPLOG.setLevel(level)
        lines[root] = handler.lines
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 4
    assert lines["torch"][0].startswith("op=start task=- principal=alice endpoint=executor.batch")
    assert lines["torch"][3].startswith("op=preempted task=- principal=anonymous")
