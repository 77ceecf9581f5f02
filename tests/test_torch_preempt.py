"""The servlet, user-task and SLO parts of ``tests/test_preempt.py`` (and the
SLO evaluator tests of ``tests/test_obsvc.py``) on the port, against the JAX
package where both compute the same thing.  The budget parts are
``tests/test_torch_budget.py``'s.

User tasks: the wall-clock timeout's terminal state, completion beating it,
and first-reason-wins cancellation shared with the solve's budget.  The
servlet: ``deadline_ms`` validation, ``POST /cancel_user_task`` and a
budgeted rebalance over HTTP.  SLOs: the objectives built from config and
every burn verdict equal the JAX evaluator's over the same history rings;
violations become unfixable anomalies, and the facade's SLO-preempt wrapper
makes solve-time ones fixable.
"""

import threading
import time

import pytest

from cruise_control_tpu.config.cruise_control_config import CruiseControlConfig as JConfig
from cruise_control_tpu.obsvc import slo as jslo
from cruise_control_tpu_torch.analyzer.budget import SolveBudget
from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
from cruise_control_tpu_torch.detector.anomalies import AnomalyType, SloViolationAnomaly
from cruise_control_tpu_torch.facade import _SloPreemptDetector
from cruise_control_tpu_torch.obsvc import slo
from cruise_control_tpu_torch.servlet.server import USER_TASK_HEADER, CruiseControlApp
from cruise_control_tpu_torch.servlet.user_tasks import TaskState, UserTaskManager
from tests.test_torch_facade import PKGS, _mods, build_stack
from tests.test_torch_servlet import _request


# ------------------------------------------------------------ user tasks


def test_user_task_timeout_terminal_state():
    utm = UserTaskManager(num_threads=1, task_timeout_ms=50)
    token = threading.Event()
    t = utm.submit("rebalance", "", lambda p: token.wait(5.0), cancel_token=token)
    assert t.future.result(timeout=5.0) is True      # woken by the timeout
    assert t.state is TaskState.TIMED_OUT and t.cancel_reason == "timeout"
    assert t.to_dict()["Status"] == "TimedOut" and t.to_dict()["CancelReason"] == "timeout"
    utm.shutdown()


def test_user_task_completion_beats_timeout():
    utm = UserTaskManager(num_threads=1, task_timeout_ms=10_000)
    token = threading.Event()
    t = utm.submit("rebalance", "", lambda p: 42, cancel_token=token)
    assert t.future.result(timeout=5.0) == 42
    assert t.state is TaskState.COMPLETED and not t.timed_out
    utm.shutdown()


def test_user_task_cancel_first_reason_wins():
    utm = UserTaskManager(num_threads=1)
    token = threading.Event()
    t = utm.submit("rebalance", "", lambda p: token.wait(5.0), cancel_token=token)
    assert t.cancel("user")
    t.cancel("timeout")
    t.future.result(timeout=5.0)
    assert t.cancel_reason == "user"
    # The port's budget wrapping the same event reports the same reason.
    assert SolveBudget(cancel_event=token).cancel_reason == "user"
    assert not utm.submit("rebalance", "", lambda p: 1).cancel("user")
    utm.shutdown()


# --------------------------------------------------------------- servlet


@pytest.fixture(scope="module")
def app():
    cc, _, _ = build_stack(_mods(PKGS["torch"]))
    application = CruiseControlApp(cc, port=0)
    application.start()
    yield application
    application.stop()
    cc.shutdown()


def test_deadline_ms_param_validation(app):
    code, body, _ = _request(app, "POST", "rebalance", {"dryrun": "true", "deadline_ms": "abc"})
    assert code == 400 and "deadline_ms" in body["error"]
    code, body, _ = _request(app, "POST", "rebalance", {"dryrun": "true", "deadline_ms": "-5"})
    assert code == 400


def test_cancel_user_task_endpoint(app):
    code, _, _ = _request(app, "POST", "cancel_user_task")
    assert code == 400
    code, _, _ = _request(app, "POST", "cancel_user_task", {"user_task_id": "nope"})
    assert code == 404
    token = threading.Event()
    t = app.user_tasks.submit("rebalance", "dryrun=true", lambda p: token.wait(10.0),
                              cancel_token=token)
    code, body, headers = _request(app, "POST", "cancel_user_task", {"user_task_id": t.task_id})
    assert code == 200 and body["UserTaskId"] == t.task_id
    assert headers[USER_TASK_HEADER] == t.task_id
    assert t.future.result(timeout=5.0) is True and t.cancel_reason == "user"
    code, body, _ = _request(app, "POST", "cancel_user_task", {"user_task_id": t.task_id})
    assert code == 400 and "not active" in body["error"]


def test_rebalance_with_deadline_roundtrip(app):
    params = {"dryrun": "true", "goals": "ReplicaDistributionGoal", "deadline_ms": "600000"}
    status, body, headers = _request(app, "POST", "rebalance", params)
    task_id = headers.get(USER_TASK_HEADER)
    assert task_id
    deadline = time.time() + 30
    while status == 202 and time.time() < deadline:
        time.sleep(0.1)
        status, body, headers = _request(app, "POST", "rebalance", params,
                                         headers={USER_TASK_HEADER: task_id})
    assert status == 200
    assert "partial" not in body                 # generous budget: converged


def test_cancelled_operation_over_http_is_partial_and_not_executed(app):
    """A rebalance whose task is cancelled before its solve starts returns
    the anytime result tagged partial, never executed."""
    gate = threading.Event()
    orig = app.cc.rebalance

    def gated(*args, **kwargs):
        gate.wait(10.0)
        return orig(*args, **kwargs)

    app.cc.rebalance = gated
    try:
        params = {"dryrun": "false", "goals": "ReplicaDistributionGoal"}
        status, body, headers = _request(app, "POST", "rebalance", params)
        task_id = headers[USER_TASK_HEADER]
        code, _, _ = _request(app, "POST", "cancel_user_task", {"user_task_id": task_id})
        assert code == 200
    finally:
        gate.set()
        app.cc.rebalance = orig
    deadline = time.time() + 30
    while status == 202 and time.time() < deadline:
        time.sleep(0.1)
        status, body, _ = _request(app, "POST", "rebalance", params,
                                   headers={USER_TASK_HEADER: task_id})
    assert status == 200
    assert body["partial"] is True and body["executed"] is False
    assert app.cc.active_solves() == 0


# ------------------------------------------------------------------ SLOs


class _Rings:
    """A history recorder stand-in: fixed rings, fnmatch patterns."""

    def __init__(self, series):
        self.series = series

    def history(self, pattern=None, since_ms=None):
        import fnmatch
        return {k: v for k, v in self.series.items()
                if pattern is None or fnmatch.fnmatch(k, pattern)}


NOW_S = 10_000.0
NOW_MS = NOW_S * 1000.0
RINGS = {
    "X.empty": [],
    "X.old": [[1.0, 99.0]],
    "X.future": [[NOW_MS + 600_000.0, 99.0]],
    "X.mixed": [[NOW_MS - 500_000.0, 1.0]] * 8 + [[NOW_MS - 1_000.0, 99.0]] * 2,
    "X.bad": [[NOW_MS - 500_000.0, 99.0]] * 8 + [[NOW_MS - 1_000.0, 99.0]] * 2,
    "Y.healthy": [[NOW_MS - 1_000.0, 0.5]] * 4,
}


@pytest.mark.parametrize("budget,short,long_", [(0.5, 60, 600), (0.1, 300, 3600),
                                                (1.0, 1, 10)])
def test_slo_verdicts_equal_jax(budget, short, long_):
    objectives = [("o", "X.*", 10.0), ("p", "Y.*", 0.1), ("q", "Z.*", 1.0)]
    kwargs = dict(error_budget=budget, short_window_s=short, long_window_s=long_,
                  recorder=_Rings(RINGS), clock=lambda: NOW_S)
    ev = slo.SloEvaluator([slo.SloObjective(name=n, pattern=p, threshold=t)
                           for n, p, t in objectives], **kwargs)
    jev = jslo.SloEvaluator([jslo.SloObjective(name=n, pattern=p, threshold=t)
                             for n, p, t in objectives], **kwargs)
    assert ev.evaluate() == jev.evaluate()
    got = [a.describe() for a in slo.SloViolationDetector(ev).detect()]
    want = [a.describe() for a in jslo.SloViolationDetector(jev).detect()]
    for a in got + want:
        a.pop("anomalyId", None)
        a.pop("detectionMs", None)
    assert got == want


def test_slo_objectives_from_config_equal_jax():
    props = {"slo.enabled": "true", "slo.error.budget": "0.2",
             "slo.solve.rounds.max": "40", "slo.endpoint.latency.p99.ms": "750"}
    objs = slo.objectives_from_config(CruiseControlConfig(props))
    jobjs = jslo.objectives_from_config(JConfig(props))
    assert [(o.name, o.pattern, o.threshold) for o in objs] == \
        [(o.name, o.pattern, o.threshold) for o in jobjs]
    ev = slo.evaluator_from_config(CruiseControlConfig(props), recorder=_Rings({}))
    assert ev.error_budget == 0.2 and ev.evaluate() == []


def test_slo_anomalies_are_unfixable_and_preempt_flips_solve_time():
    ev = slo.SloEvaluator([slo.SloObjective(name="o", pattern="X.*", threshold=10.0)],
                          error_budget=0.5, short_window_s=60, long_window_s=600,
                          recorder=_Rings({"X.bad": RINGS["X.bad"]}), clock=lambda: NOW_S)
    (anomaly,) = slo.SloViolationDetector(ev).detect()
    assert anomaly.anomaly_type is AnomalyType.SLO_VIOLATION and not anomaly.fixable

    class Inner:
        def detect(self):
            return [SloViolationAnomaly(objective="solve-time", sensor="s"),
                    SloViolationAnomaly(objective="balancedness", sensor="b")]

    a, b = _SloPreemptDetector(Inner()).detect()
    assert a.fixable and not b.fixable
