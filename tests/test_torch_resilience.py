"""The port's resilience layer (retry budgets, circuit breaker, reconnecting
admin backend, settings and sensors) against the JAX package's.

Counterparts of ``tests/test_resilience.py`` without its journal tests (the
port's are in ``tests/test_torch_executor.py``) and its HTTP health endpoint
(the port's ``/health`` rollup is held in ``tests/test_torch_facade.py``).
The device failover's classifier is held to the JAX package's on its cases,
plus the CUDA runtime's: device loss fails over, a fault of the port's own
code (an illegal address, an assert, OOM, a missing kernel image, the
kernel's build or launch) never does.  Each
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
        assert names == jnames
        assert {"cpu_fallback", "is_device_failure"} <= set(resilience.__all__)
        assert set(resilience.__all__) == set(jres.__all__)
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


# ------------------------------------------------------- solver failover


class XlaRuntimeError(Exception):
    pass


def _chained(inner):
    outer = ValueError("wrapper")
    outer.__cause__ = inner
    return outer


# What torch's C10_CUDA_CHECK raises (c10/cuda/CUDAException.cpp): "CUDA
# error: " and the runtime's error string, a help line naming the cudaError
# enum (absent before torch 2.6), the asynchronous-report hint unless
# CUDA_LAUNCH_BLOCKING=1, then one of three notes on device-side assertions.
_ASYNC_HINT = ("\nCUDA kernel errors might be asynchronously reported at some other API call, "
               "so the stacktrace below might be incorrect.\n"
               "For debugging consider passing CUDA_LAUNCH_BLOCKING=1")
_DSA_NOTES = {
    "dsa-compile": "Compile with `TORCH_USE_CUDA_DSA` to enable device-side assertions.\n",
    "dsa-runtime": "Device-side assertion tracking was not enabled by user.",
    "dsa-omitted": ("Device-side assertions were explicitly omitted for this error check; "
                    "the error probably arose while initializing the DSA handlers."),
}
TORCH_FORMATS = {
    f"{'blocking' if blocking else 'async'}-{dsa}": dict(blocking=blocking, dsa=dsa)
    for blocking in (False, True) for dsa in _DSA_NOTES}
TORCH_FORMATS["no-help-line"] = dict(blocking=False, dsa="dsa-compile", help_line=False)


def torch_cuda_error(text, name, blocking=False, dsa="dsa-compile", help_line=True):
    """The exception torch raises for the CUDA runtime's ``name`` error."""
    import torch
    msg = "CUDA error: " + text
    if help_line:
        msg += (f"\nSearch for `{name}' in https://docs.nvidia.com/cuda/cuda-runtime-api/"
                "group__CUDART__TYPES.html for more information.")
    if not blocking:
        msg += _ASYNC_HINT
    msg += "\n" + _DSA_NOTES[dsa]
    return getattr(torch, "AcceleratorError", RuntimeError)(msg)


# The CUDA runtime's device-loss errors, then its errors of a fault in the
# port's own code: (error string, enum name).
CUDA_DEVICE_LOSS = [
    ("uncorrectable ECC error encountered", "cudaErrorECCUncorrectable"),
    ("CUDA-capable device(s) is/are busy or unavailable", "cudaErrorDevicesUnavailable"),
    ("no CUDA-capable device is detected", "cudaErrorNoDevice"),
]
CUDA_KERNEL_FAULTS = [
    ("an illegal memory access was encountered", "cudaErrorIllegalAddress"),
    ("misaligned address", "cudaErrorMisalignedAddress"),
    ("an illegal instruction was encountered", "cudaErrorIllegalInstruction"),
    ("device-side assert triggered", "cudaErrorAssert"),
    ("invalid argument", "cudaErrorInvalidValue"),
    ("out of memory", "cudaErrorMemoryAllocation"),
    ("no kernel image is available for execution on the device",
     "cudaErrorNoKernelImageForDevice"),
]

# The JAX package's cases (tests/test_resilience.py), then the CUDA runtime's
# device-loss errors as torch raises them and NVML's lost GPU.
DEVICE_LOSS = [
    XlaRuntimeError("anything"), RuntimeError("DEVICE_LOST: tpu gone"), OSError("Socket closed"),
    _chained(XlaRuntimeError("inner")),
    *(torch_cuda_error(text, name) for text, name in CUDA_DEVICE_LOSS),
    RuntimeError("Unable to determine the device handle for GPU0000:17:00.0: "
                 "GPU is lost.  Reboot the system to recover this GPU"),
    RuntimeError("the GPU has fallen off the bus"),
    _chained(torch_cuda_error(*CUDA_DEVICE_LOSS[0])),
]
NOT_DEVICE_LOSS = [
    ValueError("plain bad input"), RuntimeError("ordinary failure"),
    *(torch_cuda_error(text, name) for text, name in CUDA_KERNEL_FAULTS),
    RuntimeError("CUDA out of memory. Tried to allocate 20.00 GiB"),
    RuntimeError("nvcc failed (1):\naggregate.cu(12): error"),
    RuntimeError("nvcc not found (set CUDA_HOME): the aggregate kernel is built from source"),
    RuntimeError("aggregate kernel launch failed: CUDA error 46"),
    RuntimeError("aggregate kernel occupancy query failed: -1"),
    # A kernel fault anywhere in the chain wins over a device-loss marker.
    _chained(RuntimeError("UNAVAILABLE: CUDA error: an illegal memory access was encountered")),
    _chained(_chained(torch_cuda_error(*CUDA_KERNEL_FAULTS[0]))),
]


@pytest.mark.parametrize("exc", DEVICE_LOSS + NOT_DEVICE_LOSS,
                         ids=lambda e: str(e).replace("CUDA error: ", "").split("\n")[0][:40])
def test_is_device_failure_classification(exc):
    from cruise_control_tpu.resilience.failover import is_device_failure as jis_device_failure
    got = resilience.is_device_failure(exc)
    assert got == any(exc is e for e in DEVICE_LOSS)
    if any(exc is e for e in DEVICE_LOSS[:4] + NOT_DEVICE_LOSS[:2]):
        assert got == jis_device_failure(exc)       # the JAX package's own cases


@pytest.mark.parametrize("fmt", list(TORCH_FORMATS))
@pytest.mark.parametrize("error", CUDA_DEVICE_LOSS + CUDA_KERNEL_FAULTS,
                         ids=lambda e: e[1])
def test_torch_cuda_errors_classified_on_the_runtime_text(error, fmt):
    """Every line torch adds to a CUDA error, in each of its forms, leaves the
    verdict to the runtime's own error: torch's note on device-side
    assertions does not make a lost card the port's own fault."""
    exc = torch_cuda_error(*error, **TORCH_FORMATS[fmt])
    assert resilience.is_device_failure(exc) == (error in CUDA_DEVICE_LOSS)
    assert resilience.is_device_failure(_chained(exc)) == (error in CUDA_DEVICE_LOSS)


# What torch 2.11.0+cu128 raised on an H100 for a device ordinal past the
# last card (chip_smoke.py's real_cuda_error).
TORCH_INVALID_ORDINAL = (
    "CUDA error: invalid device ordinal\n"
    "GPU device may be out of range, do you have enough GPUs?" + _ASYNC_HINT + "\n"
    + _DSA_NOTES["dsa-compile"])


def test_smoke_words_its_injected_errors_as_torch_does():
    """``chip_smoke.py`` words its injected errors from a real one caught on
    the card: from torch 2.11's wording they equal :func:`torch_cuda_error`'s
    and classify as the runtime's error does."""
    import chip_smoke as smoke

    import torch

    real = getattr(torch, "AcceleratorError", RuntimeError)(TORCH_INVALID_ORDINAL)
    assert not resilience.is_device_failure(real)
    for error, loss in ((smoke.PLATFORM_DEVICE_LOSS, True), (smoke.PLATFORM_KERNEL_FAULT, False)):
        injected = smoke.like_real(real, error)
        assert type(injected) is type(real) and str(injected) == str(torch_cuda_error(*error))
        assert resilience.is_device_failure(injected) is loss


def test_torch_oom_error_type_is_not_device_loss():
    import torch
    assert not resilience.is_device_failure(torch.cuda.OutOfMemoryError("CUDA out of memory"))


def test_cpu_fallback_yields_the_cpu():
    import torch
    with resilience.cpu_fallback() as dev:
        assert dev == torch.device("cpu")


def _facade_stack():
    from tests.test_torch_facade import PKGS as FPKGS
    from tests.test_torch_facade import _mods as fmods
    from tests.test_torch_facade import build_stack
    return build_stack(fmods(FPKGS["torch"]))


def test_solver_cpu_failover_tags_degraded():
    """tests/test_resilience.py's counterpart on the port's facade."""
    cc, _, _ = _facade_stack()

    class _FlakyOptimizer:
        def __init__(self):
            self.calls = []

        def optimizations(self, state, placement, meta, options=None,
                          model_generation=None, budget=None):
            self.calls.append(model_generation)
            if len(self.calls) == 1:
                raise torch_cuda_error(*CUDA_DEVICE_LOSS[0])
            return "solved"

    opt = _FlakyOptimizer()
    before = registry().counter("Resilience.solver-cpu-failovers").count
    result, degraded = cc._solve_with_failover(opt, None, None, None, None,
                                               generation=(1, 1))
    assert result == "solved" and degraded
    # The CPU retry must not trust the (possibly poisoned) cache entry.
    assert opt.calls == [(1, 1), None]
    assert cc._solver_degraded_at is not None
    assert registry().counter("Resilience.solver-cpu-failovers").count == before + 1
    assert cc.health()["probes"]["device"]["status"] == "degraded"
    # A clean solve clears the degraded flag.
    result, degraded = cc._solve_with_failover(opt, None, None, None, None,
                                               generation=None)
    assert not degraded and cc._solver_degraded_at is None
    assert cc.health()["probes"]["device"]["status"] == "ready"

    def kernel_fault(*a, **k):
        raise torch_cuda_error(*CUDA_KERNEL_FAULTS[0])

    opt.optimizations = kernel_fault
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cc._solve_with_failover(opt, None, None, None, None, None)
    assert registry().counter("Resilience.solver-cpu-failovers").count == before + 1


def test_solver_failover_invalidates_resident_model():
    """A device failure mid-solve drops the resident tensors: the retry
    rebuilds its model on the CPU (the facade's device here is the CPU too),
    and the next request full-freezes instead of applying a delta into
    them; the response and its dict carry ``degraded``."""
    cc, _, _ = _facade_stack()
    cc.proposals()
    s0 = cc.resident.stats()
    assert s0["resident"] and s0["fullFreezes"] >= 1
    real = cc.optimizer.optimizations
    calls = {"n": 0, "devices": []}

    def flaky(state, placement, meta, options=None, model_generation=None, budget=None):
        calls["n"] += 1
        calls["devices"].append(state.leader_load.device.type)
        if calls["n"] == 1:
            raise torch_cuda_error(*CUDA_DEVICE_LOSS[0], blocking=True, dsa="dsa-runtime")
        return real(state, placement, meta, options=options,
                    model_generation=model_generation, budget=budget)

    cc.optimizer.optimizations = flaky
    r = cc.rebalance(dryrun=True)
    assert r.degraded and r.optimizer_result is not None and r.to_dict()["degraded"] is True
    assert calls["devices"] == ["cpu", "cpu"]
    s1 = cc.resident.stats()
    assert s1["invalidationReasons"].get("device-failover") == 1
    assert not s1["resident"] and s1["deltaApplies"] == s0["deltaApplies"]
    cc.optimizer.optimizations = real
    r = cc.proposals()
    assert not r.degraded and "degraded" not in r.to_dict()
    s2 = cc.resident.stats()
    assert s2["resident"] and s2["fullFreezes"] == s0["fullFreezes"] + 1
