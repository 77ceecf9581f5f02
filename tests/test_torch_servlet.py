"""The port's REST server against the JAX package's.

Counterparts of ``tests/test_servlet.py``: both packages' apps run on the
CPU in front of the same small stack (``tests/test_torch_facade.py``'s
``build_stack``: 4 brokers, 8 partitions, three goals, so the JAX side
compiles three goals), get the same request script over real HTTP, and must
answer the same status and the same body after scrubbing ids, timings and
wall-clock fields (floats within ``rel=1e-6``).  The port's live bodies pass
the JAX package's schema checker as well as its own; the OpenAPI specs and
endpoint tables are equal; the user-task protocol, two-step review, TLS, the
static UI and the API prefix behave as in the JAX package.

``GET /memory`` and ``GET /compile_cache`` answer 501 in the port until its
memory ledger and compile service exist (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import base64
import importlib
import json
import math
import os
import shutil
import subprocess
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest

from cruise_control_tpu.config.cruise_control_config import CruiseControlConfig as JConfig
from cruise_control_tpu.servlet import openapi as jopenapi
from cruise_control_tpu.servlet import server as jserver
from cruise_control_tpu.servlet.schemas import ENDPOINT_SCHEMAS as J_SCHEMAS
from cruise_control_tpu.servlet.schemas import validate as jvalidate
from cruise_control_tpu_torch.config.config_def import load_properties
from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
from cruise_control_tpu_torch.servlet import openapi, server
from cruise_control_tpu_torch.servlet.schemas import ENDPOINT_SCHEMAS, validate
from cruise_control_tpu_torch.servlet.server import USER_TASK_HEADER, CruiseControlApp
from cruise_control_tpu_torch.servlet.user_tasks import TaskState, UserTaskManager
from tests.test_torch_facade import CLOCK_KEYS, PKGS, _mods, build_stack

# Fields that differ by run: clocks, ids, and each package's own counters.
SCRUB = CLOCK_KEYS | {"UserTaskId", "StartMs", "solveId", "requestId", "trace_dir",
                      "started_ms", "generation", "recorded"}
# Reads a request script sends to both apps, then the operations; each
# (method, endpoint, params).  Solving endpoints are polled 202 → 200.
READS = [("GET", "state", {}), ("GET", "state", {"verbose": "true"}),
         ("GET", "load", {}), ("GET", "partition_load", {"entries": "3"}),
         ("GET", "kafka_cluster_state", {}), ("GET", "health", {}),
         ("GET", "model_quality", {}), ("GET", "solver_stats", {}),
         ("GET", "bootstrap", {"start": "0", "end": "1"}),
         ("GET", "train", {"start": "0", "end": "1e15"}),
         ("GET", "review_board", {}), ("GET", "nonsense", {})]
OPERATIONS = [
    ("GET", "proposals", {}),
    # A request's own goal list and a budget it does not reach, in one
    # request: the JAX side compiles one budgeted single-goal solve.
    ("POST", "rebalance", {"dryrun": "true", "goals": "ReplicaDistributionGoal",
                           "deadline_ms": "600000"}),
    ("POST", "rebalance", {"dryrun": "true", "explain": "true"}),
    ("POST", "remove_broker", {"brokerid": "3", "dryrun": "true", "explain": "true"}),
    ("POST", "add_broker", {"brokerid": "3", "dryrun": "true"}),
    ("POST", "demote_broker", {"brokerid": "1", "dryrun": "true"}),
    ("POST", "fix_offline_replicas", {"dryrun": "true"}),
    ("POST", "topic_configuration", {"topic": "T", "replication_factor": "3",
                                     "dryrun": "true"}),
    ("POST", "remove_broker", {"dryrun": "true"}),
    ("POST", "rebalance", {"dryrun": "true", "deadline_ms": "abc"}),
    ("POST", "rebalance", {"dryrun": "true", "rebalance_disk": "true",
                           "kafka_assigner": "true"}),
    ("POST", "cancel_user_task", {}),
    ("POST", "cancel_user_task", {"user_task_id": "nope"}),
    ("POST", "admin", {"enable_self_healing_for": "broker_failure"}),
    ("POST", "admin", {"disable_self_healing_for": "broker_failure"}),
    ("POST", "pause_sampling", {"reason": "test"}),
    ("POST", "resume_sampling", {"reason": "test"}),
    ("POST", "stop_proposal_execution", {}),
    ("POST", "nonsense", {}),
    ("GET", "execution_progress", {}),
    ("GET", "user_tasks", {}),
]


def _request(app, method, endpoint, params=None, headers=None, base=None):
    qs = urllib.parse.urlencode(params or {})
    url = f"{base or f'http://127.0.0.1:{app.port}'}/kafkacruisecontrol/{endpoint}"
    if qs:
        url += f"?{qs}"
    req = urllib.request.Request(url, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req) as r:
            raw = r.read().decode()
            status, hdrs = r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, hdrs = e.read().decode(), e.code, dict(e.headers)
    body = json.loads(raw) if hdrs.get("Content-Type", "").startswith("application/json") \
        else raw
    return status, body, hdrs


def _done(app, method, endpoint, params, timeout=120):
    """Follow the 202 protocol with the User-Task-ID header to the end."""
    status, body, hdrs = _request(app, method, endpoint, params)
    task_id = hdrs.get(USER_TASK_HEADER)
    deadline = time.time() + timeout
    while status == 202 and task_id and time.time() < deadline:
        time.sleep(0.1)
        status, body, hdrs = _request(app, method, endpoint, params,
                                      headers={USER_TASK_HEADER: task_id})
    return status, body, hdrs


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in SCRUB}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v) for v in obj]
    return obj


def _assert_same(t, j, path="$"):
    """Equal JSON values, floats within rel=1e-6."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), (path, sorted(t), sorted(j))
        for k in j:
            _assert_same(t[k], j[k], f"{path}.{k}")
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), (path, t, j)
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(j, float) and not isinstance(j, bool):
        assert isinstance(t, (int, float)) and math.isclose(t, j, rel_tol=1e-6, abs_tol=1e-9), \
            (path, t, j)
    else:
        assert t == j, (path, t, j)


# The resident service's counters are process-wide sensors: bodies carry
# them as counted since this module's stacks were built.
RESIDENT_COUNTERS = ("fullFreezes", "deltaApplies", "invalidations")


@pytest.fixture(scope="module")
def apps():
    """Both packages' apps over the same stack, started; the port's on the
    CPU.  The process-wide recorders the bodies read (model fidelity, the
    execution flight recorder, solver convergence, the audit log) start empty
    in both."""
    out = {}
    for name, root in PKGS.items():
        m = _mods(root)
        importlib.import_module(f"{root}.obsvc.execution").execution().reset()
        importlib.import_module(f"{root}.obsvc.convergence").convergence().reset()
        m.fidelity.fidelity().reset()
        m.audit.audit_log().clear()
        cc, backend, cluster = build_stack(m)
        srv = jserver if name == "jax" else server
        app = srv.CruiseControlApp(cc, port=0)
        app.resident_base = cc.resident.stats()
        app.start()
        out[name] = app
    yield out
    for app in out.values():
        app.stop()
        app.cc.shutdown()


def _scripted(app, script):
    out = []
    for method, endpoint, params in script:
        status, body, _ = _done(app, method, endpoint, params)
        out.append((method, endpoint, params, status, body))
    return out


def test_same_request_script_same_answers(apps):
    """Every read and operation of the script: the same status, and the same
    body after scrubbing; the port's 2xx bodies pass both schema checkers."""
    tres = _scripted(apps["torch"], READS + OPERATIONS)
    jres = _scripted(apps["jax"], READS + OPERATIONS)
    for (method, endpoint, params, ts, tb), (*_, js, jb) in zip(tres, jres):
        what = (method, endpoint, params)
        assert ts == js, (what, tb, jb)
        if ts < 400 and endpoint in ENDPOINT_SCHEMAS:
            validate(tb, ENDPOINT_SCHEMAS[endpoint])
            jvalidate(tb, J_SCHEMAS[endpoint])
        tb, jb = _scrub(tb), _scrub(jb)
        if endpoint == "state":
            # The JAX package's memory ledger waits for ROADMAP Queue 1 item 5.
            jb["AnalyzerState"].pop("memoryState", None)
            for body, app in ((tb, apps["torch"]), (jb, apps["jax"])):
                resident = body["AnalyzerState"]["residentModel"]
                for k in RESIDENT_COUNTERS:
                    resident[k] -= app.resident_base[k]
        _assert_same(tb, jb, f"{method} {endpoint} {params}")


def test_explained_rebalance_carries_provenance(apps):
    status, body, _ = _done(apps["torch"], "POST", "rebalance",
                            {"dryrun": "true", "explain": "true"})
    assert status == 200
    result = body["result"]
    assert sum(result["provenancePaths"].values()) == len(result["proposals"])
    assert "unknown" not in result["provenancePaths"]
    # explain is a render-time flag: the same task re-polled without it
    # renders the same result without the proposals.
    status, plain, hdrs = _request(apps["torch"], "POST", "rebalance", {"dryrun": "true"})
    assert "proposals" not in plain.get("result", {})


def test_rebalance_dryrun_roundtrip_and_user_tasks(apps):
    app = apps["torch"]
    status, body, headers = _done(app, "POST", "rebalance",
                                  {"dryrun": "true", "goals": "ReplicaDistributionGoal"})
    assert status == 200
    assert body["dryrun"] is True and body["executed"] is False
    task_id = headers[USER_TASK_HEADER]
    _, tasks, _ = _request(app, "GET", "user_tasks")
    assert any(t["UserTaskId"] == task_id for t in tasks["userTasks"])
    # The same id returns the same task (202-until-done dedup).
    status, again, _ = _request(app, "POST", "rebalance",
                                {"dryrun": "true", "goals": "ReplicaDistributionGoal"},
                                headers={USER_TASK_HEADER: task_id})
    assert status == 200 and _scrub(again) == _scrub(body)


def test_rebalance_disk_uses_intra_broker_goals(apps):
    status, body, _ = _done(apps["torch"], "POST", "rebalance",
                            {"dryrun": "true", "rebalance_disk": "true"})
    assert status == 200
    assert [g["goal"] for g in body["result"]["goals"]] == [
        "IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"]


def test_memory_and_compile_cache_are_not_implemented_yet(apps):
    for endpoint in ("memory", "compile_cache"):
        status, body, _ = _request(apps["torch"], "GET", endpoint)
        assert status == 501 and body["error"] == f"{endpoint} not implemented"


def test_metrics_json_and_text(apps):
    status, body, _ = _request(apps["torch"], "GET", "metrics", {"json": "true"})
    assert status == 200
    validate(body, ENDPOINT_SCHEMAS["metrics"])
    jvalidate(body, J_SCHEMAS["metrics"])
    assert "KafkaCruiseControlServlet.state-request-rate" in body["sensors"]
    status, text, hdrs = _request(apps["torch"], "GET", "metrics")
    assert status == 200 and hdrs["Content-Type"].startswith("text/plain")


# ---------------------------------------------------------------- tables


def test_endpoint_tables_and_openapi_spec_equal_jax():
    assert server.GET_ENDPOINTS == jserver.GET_ENDPOINTS
    assert server.POST_ENDPOINTS == jserver.POST_ENDPOINTS
    assert server.REVIEWABLE == jserver.REVIEWABLE
    assert server.PROPOSE_ENDPOINTS == jserver.PROPOSE_ENDPOINTS
    assert openapi.build_spec() == jopenapi.build_spec()
    assert ENDPOINT_SCHEMAS == J_SCHEMAS
    artifact = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "docs", "openapi.yaml")
    with open(artifact) as f:
        assert f.read() == openapi.render_yaml()


def test_cli_parser_accepts_and_rejects_what_jax_does():
    from cruise_control_tpu.client import cccli as jcccli
    from cruise_control_tpu_torch.client import cccli

    assert {n: (e.method, e.params) for n, e in cccli.ENDPOINTS.items()} == \
        {n: (e.method, e.params) for n, e in jcccli.ENDPOINTS.items()}
    assert set(cccli.PARAMETERS) == set(jcccli.PARAMETERS)
    good = [["rebalance", "--dryrun", "YES", "--destination_broker_ids", "1, 2,3"],
            ["state", "--verbose", "0"], ["partition_load", "--entries", "5"],
            ["remove_broker", "--brokerid", "1,2", "--dryrun", "false"],
            ["admin", "--enable_self_healing_for", "broker_failure,goal_violation"],
            ["topic_configuration", "--topic", "T", "--replication_factor", "2"],
            ["propose", "--snapshot", "x.npz", "--goals", "RackAwareGoal"],
            ["-a", "http://h:1", "--username", "u", "--password", "p", "load"], []]
    bad = [["rebalance", "--dryrun", "maybe"], ["partition_load", "--entries", "-3"],
           ["remove_broker", "--brokerid", "1,x"], ["admin", "--enable_self_healing_for", "bogus"],
           ["rebalance", "--explain", "true"], ["propose"], ["nonsense"],
           ["topic_configuration", "--replication_factor", "0"]]
    parser, jparser = cccli.build_parser(), jcccli.build_parser()
    for argv in good:
        got, want = vars(parser.parse_args(argv)), vars(jparser.parse_args(argv))
        got.pop("device", None)     # the port's propose runs on a torch device
        assert got == want, argv
    for argv in bad:
        for p in (parser, jparser):
            with pytest.raises(SystemExit):
                p.parse_args(argv)


# ------------------------------------------------------------ user tasks


def test_user_task_manager_dedup_and_retention():
    utm = UserTaskManager(num_threads=2, completed_retention_ms=1e9)
    t1 = utm.submit("rebalance", "dryrun=true", lambda p: 42)
    t1.future.result()
    same = utm.get_or_create(t1.task_id, "rebalance", "dryrun=true", lambda p: 43)
    assert same is t1 and same.future.result() == 42
    assert t1.state is TaskState.COMPLETED
    utm.shutdown()


def test_user_task_error_state():
    utm = UserTaskManager(num_threads=1)

    def boom(progress):
        raise ValueError("nope")

    t = utm.submit("rebalance", "", boom)
    with pytest.raises(ValueError):
        t.future.result()
    assert t.state is TaskState.COMPLETED_WITH_ERROR
    utm.shutdown()


# ------------------------------------------------------- app variations


@pytest.fixture
def port_stack():
    m = _mods(PKGS["torch"])
    cc, backend, cluster = build_stack(m)
    apps = []

    def make(**kwargs):
        app = CruiseControlApp(cc, port=0, **kwargs)
        app.start()
        apps.append(app)
        return app

    yield make
    for app in apps:
        app.stop()
    cc.shutdown()


def test_two_step_verification_flow(port_stack):
    app = port_stack(two_step_verification=True)
    code, body, _ = _request(app, "POST", "rebalance", {"dryrun": "true"})
    assert code == 202 and "reviewResult" in body
    review_id = body["reviewResult"]["Id"]
    code, board, _ = _request(app, "GET", "review_board")
    assert any(r["Id"] == review_id for r in board["RequestInfo"])
    validate(board, ENDPOINT_SCHEMAS["review_board"])
    code, body, _ = _request(app, "POST", "review", {"approve": str(review_id)})
    assert code == 200
    code, body, _ = _done(app, "POST", "rebalance",
                          {"dryrun": "true", "review_id": str(review_id),
                           "goals": "ReplicaDistributionGoal"})
    assert code == 200 and body["dryrun"] is True


@pytest.mark.skipif(shutil.which("openssl") is None, reason="openssl CLI not available")
def test_ssl_listener(tmp_path, port_stack):
    import ssl

    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                    "-keyout", str(key), "-out", str(cert), "-days", "1",
                    "-subj", "/CN=localhost"], check=True, capture_output=True)
    app = port_stack(ssl_certfile=str(cert), ssl_keyfile=str(key))
    ctx = ssl.create_default_context(cafile=str(cert))
    ctx.check_hostname = False
    url = f"https://127.0.0.1:{app.port}/kafkacruisecontrol/state"
    body = json.load(urllib.request.urlopen(url, context=ctx, timeout=10))
    assert "MonitorState" in body
    with pytest.raises(Exception):
        urllib.request.urlopen(f"http://127.0.0.1:{app.port}/kafkacruisecontrol/state",
                               timeout=5)


def test_static_ui_serving_and_prefixes(tmp_path, port_stack):
    ui = tmp_path / "dist"
    ui.mkdir()
    (ui / "index.html").write_text("<html>cc-ui</html>")
    (ui / "app.js").write_text("console.log(1)")
    (tmp_path / "secret.txt").write_text("keep out")
    app = port_stack(ui_diskpath=str(ui))
    base = f"http://127.0.0.1:{app.port}"
    with urllib.request.urlopen(f"{base}/") as r:
        assert b"cc-ui" in r.read() and "text/html" in r.headers["Content-Type"]
    with urllib.request.urlopen(f"{base}/app.js") as r:
        assert "javascript" in r.headers["Content-Type"]
    with urllib.request.urlopen(f"{base}/kafkacruisecontrol/state") as r:
        assert r.status == 200
    for bad in ("/../secret.txt", "/%2e%2e/secret.txt", "/missing.html", "/%00", "/a%00b.html"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + bad)
        assert ei.value.code == 404, bad
    # A custom UI prefix, and the API moved to another prefix.
    app2 = port_stack(ui_diskpath=str(ui), ui_urlprefix="/ui/*", api_urlprefix="/cc/*")
    base2 = f"http://127.0.0.1:{app2.port}"
    with urllib.request.urlopen(f"{base2}/ui") as r:
        assert b"cc-ui" in r.read()
    with urllib.request.urlopen(f"{base2}/cc/state") as r:
        assert r.status == 200
    for bad in ("/", "/uix", "/kafkacruisecontrol/state"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base2 + bad)
        assert ei.value.code == 404, bad


def test_static_ui_security_and_spnego_mutual_auth(tmp_path, port_stack):
    from cruise_control_tpu_torch.servlet.security import (
        BasicSecurityProvider,
        Role,
        SpnegoSecurityProvider,
    )

    ui = tmp_path / "dist"
    ui.mkdir()
    (ui / "index.html").write_text("<html>cc-ui</html>")
    app = port_stack(ui_diskpath=str(ui),
                     security=BasicSecurityProvider(users={"bob": ("pw", Role.VIEWER)}))
    base = f"http://127.0.0.1:{app.port}"
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{base}/")
    assert ei.value.code == 401
    req = urllib.request.Request(f"{base}/", headers={
        "Authorization": "Basic " + base64.b64encode(b"bob:pw").decode()})
    with urllib.request.urlopen(req) as r:
        assert b"cc-ui" in r.read()

    def validator(token):
        assert token == b"ticket"
        return "carol@EXAMPLE.COM", b"server-reply"

    app2 = port_stack(ui_diskpath=str(ui), security=SpnegoSecurityProvider(
        validator, roles_by_user={"carol": Role.ADMIN}))
    req = urllib.request.Request(f"http://127.0.0.1:{app2.port}/", headers={
        "Authorization": "Negotiate " + base64.b64encode(b"ticket").decode()})
    with urllib.request.urlopen(req) as r:
        assert b"cc-ui" in r.read()
        assert r.headers["WWW-Authenticate"] == \
            "Negotiate " + base64.b64encode(b"server-reply").decode()


# ------------------------------------------------------------------ config


# A reference-style cruisecontrol.properties (the shape of the file the
# reference ships under config/): fully qualified goal class names, Kafka
# client keys the framework ignores, comments.
REFERENCE_PROPERTIES = """\
# Copyright 2017 LinkedIn Corp. Licensed under the BSD 2-Clause License.
bootstrap.servers=localhost:9092
metadata.max.age.ms=300000
partition.metrics.window.ms=300000
num.partition.metrics.windows=5
min.samples.per.partition.metrics.window=1
broker.metrics.window.ms=300000
num.broker.metrics.windows=20
min.samples.per.broker.metrics.window=1
capacity.config.file=config/capacity.json
default.goals=com.linkedin.kafka.cruisecontrol.analyzer.goals.RackAwareGoal,com.linkedin.kafka.cruisecontrol.analyzer.goals.ReplicaCapacityGoal,com.linkedin.kafka.cruisecontrol.analyzer.goals.DiskCapacityGoal,com.linkedin.kafka.cruisecontrol.analyzer.goals.ReplicaDistributionGoal
hard.goals=com.linkedin.kafka.cruisecontrol.analyzer.goals.RackAwareGoal,com.linkedin.kafka.cruisecontrol.analyzer.goals.ReplicaCapacityGoal,com.linkedin.kafka.cruisecontrol.analyzer.goals.DiskCapacityGoal,com.linkedin.kafka.cruisecontrol.analyzer.goals.NetworkInboundCapacityGoal,com.linkedin.kafka.cruisecontrol.analyzer.goals.NetworkOutboundCapacityGoal,com.linkedin.kafka.cruisecontrol.analyzer.goals.CpuCapacityGoal
cpu.balance.threshold=1.1
disk.balance.threshold=1.1
cpu.capacity.threshold=0.7
max.replicas.per.broker=10000
num.proposal.precompute.threads=1
self.healing.enabled=false
anomaly.detection.interval.ms=10000
webserver.http.port=9090
webserver.http.address=0.0.0.0
webserver.api.urlprefix=/kafkacruisecontrol/*
webserver.ui.diskpath=./cruise-control-ui/dist/
two.step.verification.enabled=false
max.active.user.tasks=5
completed.user.task.retention.time.ms=21600000
"""


def test_reference_properties_file_parses(tmp_path):
    """A reference-style properties file parses in the port as in the JAX
    package (the repository has no copy of the reference's own file, so the
    test writes one)."""
    path = tmp_path / "cruisecontrol.properties"
    path.write_text(REFERENCE_PROPERTIES)
    props = load_properties(str(path))
    cfg, jcfg = CruiseControlConfig(props), JConfig(props)
    hard = ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
            "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal", "CpuCapacityGoal"]
    assert cfg.goal_names("hard.goals") == jcfg.goal_names("hard.goals") == hard
    assert cfg.goal_names() == jcfg.goal_names()
    for key in ("webserver.http.port", "max.active.user.tasks", "webserver.api.urlprefix",
                "completed.user.task.retention.time.ms", "two.step.verification.enabled"):
        assert cfg[key] == jcfg[key], key


def test_plugin_class_overrides_via_config():
    from cruise_control_tpu_torch.main import build_app
    from cruise_control_tpu_torch.monitor.sample_store import NoopSampleStore
    from cruise_control_tpu_torch.monitor.sampler import SyntheticWorkloadSampler

    cfg = CruiseControlConfig({
        "metric.sampler.class": "cruise_control_tpu_torch.monitor.sampler.SyntheticWorkloadSampler",
        "sample.store.class": "cruise_control_tpu_torch.monitor.sample_store.NoopSampleStore",
        "anomaly.notifier.class": "cruise_control_tpu_torch.detector.notifier.SelfHealingNotifier",
        "min.valid.partition.ratio": 0.25, "obs.history.enabled": False,
    })
    app = build_app(cfg, port=0, device="cpu")
    try:
        runner = app.cc.task_runner
        assert isinstance(runner.sampler, SyntheticWorkloadSampler)
        assert isinstance(runner.sample_store, NoopSampleStore)
        assert app.cc.default_completeness.min_monitored_partitions_percentage == 0.25
    finally:
        # Built, never started: only the task pool and the facade to stop.
        app.user_tasks.shutdown()
        app.server.server_close()
        app.cc.shutdown()
