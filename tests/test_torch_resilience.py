"""The port's resilience layer (retry budgets, circuit breaker, reconnecting
admin backend, settings and sensors) against the JAX package's.

Counterparts of ``tests/test_resilience.py`` without its journal tests (the
port's are in ``tests/test_torch_executor.py``), its device-failover tests
(the port has no failover yet) and its HTTP health endpoint (the port's
``/health`` rollup is held in ``tests/test_torch_facade.py``).  Each
scripted case runs on both packages with an injected clock and a seeded
jitter source; the retry schedules, circuit transitions and sensor counts
must be equal.  Sleeps are float arithmetic on the same inputs in the same
order, so they are compared exactly.
"""

import importlib
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from cruise_control_tpu_torch import resilience
from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.executor.backend import FakeClusterBackend
from cruise_control_tpu_torch.executor.broker_simulator import BrokerSimulator
from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig, ExecutorState
from cruise_control_tpu_torch.executor.subprocess_backend import (
    BackendCircuitOpenError,
    BackendTransportError,
    SocketClusterBackend,
)
from cruise_control_tpu_torch.executor.tasks import ExecutionTaskState
from cruise_control_tpu_torch.resilience.circuit import CircuitBreaker, CircuitState
from cruise_control_tpu_torch.resilience.reconnect import ReconnectingBackend
from cruise_control_tpu_torch.resilience.retry import RetryPolicy, call_with_retry
from tests.test_torch_executor import _metadata, proposal

PKGS = {"jax": "cruise_control_tpu", "torch": "cruise_control_tpu_torch"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENSORS = ("Resilience.retry-attempts", "Resilience.backend.reconnects",
           "Resilience.backend.transport-errors")


def _mods(root):
    names = dict(resilience="resilience", retry="resilience.retry",
                 circuit="resilience.circuit", reconnect="resilience.reconnect",
                 sb="executor.subprocess_backend", metrics="common.metrics")
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                              for k, v in names.items()})


def _counts(m):
    return {s: m.metrics.registry().counter(s).count for s in SENSORS}


def _deltas(m, before):
    return {s: m.metrics.registry().counter(s).count - before[s] for s in SENSORS}


class _FixedRng:
    def random(self):
        return 0.5  # jitter factor exactly 1.0


# ------------------------------------------------------------------ retry

RETRY_CASES = {
    # name: (policy kwargs, failures before success (None = always), seconds
    # each attempt burns, non-retryable)
    "flaps_then_ok": (dict(max_attempts=4, base_delay_s=0.1, max_delay_s=5.0), 3, 0.0, False),
    "exhausted": (dict(max_attempts=3, base_delay_s=0.05, max_delay_s=0.2), None, 0.0, False),
    "capped_delays": (dict(max_attempts=6, base_delay_s=1.0, max_delay_s=2.5,
                           deadline_s=100.0), 5, 0.0, False),
    "deadline_cut": (dict(max_attempts=10, base_delay_s=1.0, deadline_s=30.0), None, 20.0, False),
    "non_retryable": (dict(max_attempts=5, base_delay_s=0.0), None, 0.0, True),
}


def _retry_script(m, case, seed):
    kwargs, fail_times, burn, non_retryable = RETRY_CASES[case]
    clock, sleeps, calls = [0.0], [], [0]

    def sleep(s):
        sleeps.append(s)
        clock[0] += s

    def fn():
        calls[0] += 1
        clock[0] += burn
        if non_retryable:
            raise ValueError("not a transport problem")
        if fail_times is None or calls[0] <= fail_times:
            raise m.sb.BackendTransportError("flap")
        return "ok"

    before = _counts(m)
    try:
        out = m.retry.call_with_retry(
            fn, m.retry.RetryPolicy(**kwargs), retry_on=(m.sb.BackendTransportError,),
            name="t", rng=random.Random(seed), clock=lambda: clock[0], sleep=sleep)
        cause = None
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        out = type(e).__name__
        cause = type(e.__cause__).__name__ if e.__cause__ is not None else None
    return out, cause, sleeps, calls[0], _deltas(m, before)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_retry_schedule_equal_jax(case, seed):
    got = {root: _retry_script(_mods(PKGS[root]), case, seed) for root in PKGS}
    assert got["torch"] == got["jax"]
    out, cause, sleeps, calls, deltas = got["torch"]
    if case in ("flaps_then_ok", "capped_delays"):
        fail_times = RETRY_CASES[case][1]
        assert out == "ok" and calls == fail_times + 1 and len(sleeps) == fail_times
    elif case == "non_retryable":
        assert out == "ValueError" and calls == 1 and sleeps == []
    else:
        assert out == "RetryBudgetExhausted" and cause == "BackendTransportError"
    if case == "deadline_cut":
        assert calls < 10
    if case == "capped_delays":
        assert max(sleeps) <= 2.5 * 1.5
    # Every retryable failure counts one attempt.
    failures = 0 if case == "non_retryable" else (calls - 1 if out == "ok" else calls)
    assert deltas["Resilience.retry-attempts"] == failures


def test_retry_backoff_sequence_and_success():
    sleeps, clock, calls = [], [0.0], [0]

    def sleep(s):
        sleeps.append(s)
        clock[0] += s

    def fn():
        calls[0] += 1
        if calls[0] < 4:
            raise BackendTransportError("flap")
        return "ok"

    policy = RetryPolicy(max_attempts=4, base_delay_s=0.1, max_delay_s=5.0,
                         multiplier=2.0, jitter=0.5, deadline_s=30.0)
    out = call_with_retry(fn, policy, retry_on=(BackendTransportError,), name="t",
                          rng=_FixedRng(), clock=lambda: clock[0], sleep=sleep)
    assert out == "ok" and calls[0] == 4
    assert sleeps == pytest.approx([0.1, 0.2, 0.4])


# ---------------------------------------------------------------- circuit

CIRCUIT_SCRIPTS = {
    "open_half_open_reclose": (dict(failure_threshold=2, reset_timeout_s=10.0),
                               ["allow", "fail", "fail", "allow", ("t", 10.0), "allow",
                                "allow", "ok", "allow"]),
    "half_open_failure_reopens": (dict(failure_threshold=1, reset_timeout_s=5.0),
                                  ["fail", ("t", 5.0), "allow", "fail", ("t", 6.0), "allow",
                                   ("t", 10.0), "allow", "ok"]),
    "success_resets_streak": (dict(failure_threshold=3),
                              ["fail", "fail", "ok", "fail", "fail", "allow"]),
    "two_probes": (dict(failure_threshold=2, reset_timeout_s=1.0, half_open_max_probes=2),
                   ["fail", "fail", "fail", ("t", 1.0), "allow", "allow", "allow", "fail",
                    ("t", 1.5), "allow", ("t", 2.0), "allow", "ok", "ok"]),
}


def _circuit_script(m, name):
    kwargs, ops = CIRCUIT_SCRIPTS[name]
    clock = [0.0]
    cb = m.circuit.CircuitBreaker("t", clock=lambda: clock[0], **kwargs)
    trace = []
    for op in ops:
        if isinstance(op, tuple):
            clock[0] = op[1]
            out = None
        elif op == "allow":
            out = cb.allow()
        elif op == "fail":
            out = cb.record_failure()
        else:
            out = cb.record_success()
        trace.append((op, out, cb.state.value, cb.state_value(), cb.snapshot()))
    return trace


@pytest.mark.parametrize("name", sorted(CIRCUIT_SCRIPTS))
def test_circuit_transitions_equal_jax(name):
    got = {root: _circuit_script(_mods(PKGS[root]), name) for root in PKGS}
    assert got["torch"] == got["jax"]


def test_circuit_closed_open_half_open_reclose():
    clock = [0.0]
    cb = CircuitBreaker("t", failure_threshold=2, reset_timeout_s=10.0, clock=lambda: clock[0])
    assert cb.state is CircuitState.CLOSED and cb.allow()
    cb.record_failure()
    cb.record_failure()
    assert cb.state is CircuitState.OPEN and cb.state_value() == 2
    assert not cb.allow()
    clock[0] = 10.0
    assert cb.allow()                      # half-open probe granted
    assert cb.state is CircuitState.HALF_OPEN
    assert not cb.allow()                  # probe budget is 1
    cb.record_success()
    assert cb.state is CircuitState.CLOSED and cb.reclose_count == 1


# ----------------------------------------------------- reconnecting backend


def _fake_inner(m, fail_times):
    class _FakeInner:
        """Minimal transport double with the poison/in-progress surface."""

        def __init__(self):
            self.fail_times = fail_times
            self.poisoned = None

        def in_progress_reassignments(self):
            return {("T", 1)}

        def describe_topics(self):
            if self.fail_times > 0:
                self.fail_times -= 1
                raise m.sb.BackendTransportError("mid-call death")
            return [{"topic": "T"}]

        def _poison(self, why):
            self.poisoned = why

    return _FakeInner()


def _rebuild_script(m):
    inners = []

    def factory():
        inners.append(_fake_inner(m, 1 if not inners else 0))
        return inners[-1]

    before = _counts(m)
    rb = m.reconnect.ReconnectingBackend(
        factory, policy=m.retry.RetryPolicy(max_attempts=3, base_delay_s=0.0), name="t")
    lazy = rb.inner_backend() is None
    out = rb.describe_topics()
    second = rb.describe_topics()
    return (lazy, out, second, len(inners), inners[0].poisoned is not None,
            rb.inner_backend() is inners[-1], rb.last_repoll, rb.circuit.snapshot(),
            _deltas(m, before))


def test_reconnecting_backend_rebuilds_and_repolls_equal_jax():
    got = {root: _rebuild_script(_mods(PKGS[root])) for root in PKGS}
    assert got["torch"] == got["jax"]
    lazy, out, _, n_inner, poisoned, current, repoll, _, deltas = got["torch"]
    assert lazy and out == [{"topic": "T"}] and n_inner == 2 and poisoned and current
    assert repoll == {("T", 1)}
    assert deltas == {"Resilience.retry-attempts": 1, "Resilience.backend.reconnects": 1,
                      "Resilience.backend.transport-errors": 1}


def _circuit_probe_script(m):
    clock, down = [0.0], [True]

    def factory():
        if down[0]:
            raise ConnectionError("peer down")
        return _fake_inner(m, 0)

    before = _counts(m)
    cb = m.circuit.CircuitBreaker("t", failure_threshold=2, reset_timeout_s=5.0,
                                  clock=lambda: clock[0])
    rb = m.reconnect.ReconnectingBackend(
        factory, policy=m.retry.RetryPolicy(max_attempts=2, base_delay_s=0.0),
        circuit=cb, name="t")
    trace = []
    for step in ("call", "call", "probe", "heal", "probe", "call"):
        if step == "heal":
            clock[0], down[0] = 5.0, False
            continue
        try:
            out = rb.describe_topics() if step == "call" else rb.probe()
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            out = type(e).__name__
        trace.append((step, out, cb.snapshot()))
    return trace, _deltas(m, before)


def test_reconnecting_backend_circuit_opens_and_probe_recovers_equal_jax():
    got = {root: _circuit_probe_script(_mods(PKGS[root])) for root in PKGS}
    assert got["torch"] == got["jax"]
    trace, _ = got["torch"]
    # The first call's two failed attempts trip the threshold-2 circuit, so
    # its exhausted budget surfaces as the open-circuit error too.
    assert [out for _, out, _ in trace] == ["BackendCircuitOpenError", "BackendCircuitOpenError",
                                           False, True, [{"topic": "T"}]]
    assert trace[-1][2]["state"] == "closed"


# ------------------------------------------------ settings and sensor family


def _props():
    return {"resilience.retry.max.attempts": "6", "resilience.retry.base.delay.ms": "25",
            "resilience.retry.max.delay.ms": "900", "resilience.retry.deadline.ms": "4000",
            "resilience.circuit.failure.threshold": "3",
            "resilience.circuit.reset.timeout.ms": "750",
            "resilience.backend.reconnect.enabled": "false",
            "resilience.journal.path": "/var/lib/cc/journal.jsonl",
            "resilience.journal.adoption.timeout.ms": "1234",
            "resilience.health.retry.after.s": "9"}


def test_configure_settings_and_sensors_equal_jax():
    from cruise_control_tpu import resilience as jres
    from cruise_control_tpu.common.metrics import registry as jregistry
    from cruise_control_tpu.config import CruiseControlConfig as JConfig
    from cruise_control_tpu_torch.config import CruiseControlConfig

    try:
        js = jres.configure(JConfig(_props()))
        ts = resilience.configure(CruiseControlConfig(_props()))
        assert vars(ts) == vars(js)
        assert vars(ts.retry_policy()) == vars(js.retry_policy())
        tc, jc = ts.circuit("x"), js.circuit("x")
        assert (tc.failure_threshold, tc.reset_timeout_s, tc.half_open_max_probes) == \
            (jc.failure_threshold, jc.reset_timeout_s, jc.half_open_max_probes)
        resilience.register_sensors()
        names = {n for n in registry().snapshot() if n.startswith("Resilience.")}
        jnames = {n for n in jregistry().snapshot() if n.startswith("Resilience.")}
        # The JAX package's solver failover sensor waits for the port's failover.
        assert names == jnames - {"Resilience.solver-cpu-failovers"}
        assert not {"SOLVER_FAILOVER_SENSOR", "cpu_fallback",
                    "is_device_failure"} & set(resilience.__all__)
        cb = CircuitBreaker("backend", failure_threshold=1)
        cb.record_failure()
        resilience.set_backend_circuit(cb)
        assert registry().snapshot()["Resilience.backend.circuit-state"]["value"] == 2
    finally:
        resilience.set_backend_circuit(None)
        jres.configure(JConfig())
        resilience.configure(CruiseControlConfig())
    assert resilience.settings() == resilience.ResilienceSettings()


# ------------------------------------------- the executor behind an open circuit


class _CircuitFlakyBackend(FakeClusterBackend):
    """Raises the circuit-open error on every call while ``down`` is set;
    the probe hook reports recovery once it clears."""

    def __init__(self, metadata):
        super().__init__(metadata, polls_to_finish=1)
        self.down = threading.Event()
        self.probes = 0

    def _gate(self):
        if self.down.is_set():
            raise BackendCircuitOpenError("circuit open")

    def execute_replica_reassignments(self, tasks):
        self._gate()
        super().execute_replica_reassignments(tasks)

    def finished(self, task):
        self._gate()
        return super().finished(task)

    def probe(self):
        self.probes += 1
        return not self.down.is_set()


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


def _state_count(tracker, state):
    return sum(by_state.get(state.value, 0) for by_state in tracker.summary().values())


def test_executor_pauses_on_open_circuit_and_resumes():
    backend = _CircuitFlakyBackend(_metadata())
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.001,
                                          task_execution_alert_timeout_s=0.2))
    backend.down.set()
    ex.execute_proposals([proposal("T", 0, [0, 1], [2, 1])], wait=False)
    assert _wait_for(lambda: ex.state is ExecutorState.PAUSED_BACKEND_DOWN), ex.state
    time.sleep(0.3)   # longer than the alert timeout: the pause keeps the task alive
    backend.down.clear()
    assert _wait_for(lambda: not ex.has_ongoing_execution)
    assert backend.probes > 0
    assert _state_count(ex.tracker, ExecutionTaskState.COMPLETED) == 1
    assert _state_count(ex.tracker, ExecutionTaskState.DEAD) == 0


def test_executor_stop_while_paused_marks_batch_dead():
    backend = _CircuitFlakyBackend(_metadata())
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.001))
    backend.down.set()
    ex.execute_proposals([proposal("T", 0, [0, 1], [2, 1])], wait=False)
    assert _wait_for(lambda: ex.state is ExecutorState.PAUSED_BACKEND_DOWN)
    ex.user_triggered_stop_execution()
    assert _wait_for(lambda: not ex.has_ongoing_execution)
    assert _state_count(ex.tracker, ExecutionTaskState.PENDING) == 0


def test_backend_errors_sensor_counts_absorbed_failures():
    class _FlakyPoll(FakeClusterBackend):
        def finished(self, task):
            if not hasattr(self, "_flapped"):
                self._flapped = True
                raise BackendTransportError("one-off flap")
            return super().finished(task)

    backend = _FlakyPoll(_metadata(), polls_to_finish=1)
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.001))
    before = registry().counter("Executor.backend-errors").count
    ex.execute_proposals([proposal("T", 0, [0, 1], [2, 1])], wait=True)
    assert registry().counter("Executor.backend-errors").count == before + 1
    assert _state_count(ex.tracker, ExecutionTaskState.COMPLETED) == 1


# -------------------------------------------------------- simulator chaos


def test_simulator_chaos_knobs_equal_jax():
    from cruise_control_tpu.executor.broker_simulator import BrokerSimulator as JSim

    streams = {}
    for name, cls in (("jax", JSim), ("torch", BrokerSimulator)):
        sim = cls()
        assert sim.handle({"op": "chaos", "drop_p": 1.0})["chaos"]["drop_p"] == 1.0
        assert sim.chaos_action("is_done") == "drop"
        sim.handle({"op": "chaos", "drop_p": 0.0, "reset_p": 1.0})
        assert sim.chaos_action("is_done") == "reset"
        for op in ("chaos", "auth", "shutdown", "bootstrap"):
            assert sim.chaos_action(op) is None
        sim.handle({"op": "chaos", "reset_p": 0.0})
        assert sim.chaos_action("is_done") is None
        sim.handle({"op": "chaos", "drop_p": 0.5, "reset_p": 0.25, "seed": 7})
        first = [sim.chaos_action("is_done") for _ in range(32)]
        sim.handle({"op": "chaos", "seed": 7})
        assert [sim.chaos_action("is_done") for _ in range(32)] == first
        streams[name] = first
    assert streams["torch"] == streams["jax"]


# -------------------------------------------------- socket e2e reconnect


def _spawn_simulator():
    """The port's broker simulator on a TCP port of its own."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cruise_control_tpu_torch.executor.broker_simulator",
         "--listen", "0"], stdout=subprocess.PIPE, cwd=ROOT, env=env, text=True)
    port = json.loads(proc.stdout.readline())["listening"]
    return proc, port


def test_socket_reconnect_after_simulator_kill():
    """Kill -9 the admin peer mid-session: the reconnecting wrapper rebuilds
    the transport against the respawned peer and the session keeps going."""
    proc, port = _spawn_simulator()
    box = {"port": port}

    def factory():
        return SocketClusterBackend("127.0.0.1", box["port"], request_timeout_s=2.0)

    rb = ReconnectingBackend(
        factory, policy=RetryPolicy(max_attempts=4, base_delay_s=0.01, max_delay_s=0.05,
                                    deadline_s=10.0),
        circuit=CircuitBreaker("e2e", failure_threshold=50, reset_timeout_s=0.05),
        name="e2e")
    try:
        rb.request("bootstrap", partitions=[
            {"topic": "T", "partition": 0, "replicas": [0, 1], "leader": 0}])
        assert [p["topic"] for p in rb.describe_topics()] == ["T"]
        reconnects = registry().counter("Resilience.backend.reconnects").count
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=5)
        proc, box["port"] = _spawn_simulator()
        # The first call after the kill rides the retry policy through the
        # dead socket onto the fresh peer (empty state: a new simulator).
        assert rb.describe_topics() == []
        assert registry().counter("Resilience.backend.reconnects").count > reconnects
        assert rb.last_repoll == set()
    finally:
        rb.close()
        proc.kill()
        proc.wait(timeout=5)
