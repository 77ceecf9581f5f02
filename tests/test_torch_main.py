"""The port's bootstrap (``main.py``), the SLO and profiler wiring it reads,
and the CLI client, against the JAX package's.

``build_app`` wires the config as the JAX package's does (compared attribute
by attribute on the same properties), the ingestion edge's paths included;
``main`` runs on
``--device cuda`` by default and exits non-zero without a card instead of
carrying on on the CPU; ``python -m cruise_control_tpu_torch.main --demo
--device cpu`` serves a rebalance to the port's CLI and exits 0 on SIGTERM.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from cruise_control_tpu.config.cruise_control_config import CruiseControlConfig as JConfig
from cruise_control_tpu.main import demo_metadata as jdemo_metadata
from cruise_control_tpu_torch import main as tmain
from cruise_control_tpu_torch.common.exceptions import ConfigError
from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
from cruise_control_tpu_torch.obsvc import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOALS = "RackAwareGoal,ReplicaCapacityGoal,ReplicaDistributionGoal"
# Small windows (the model is ready in seconds); no sensor-history thread
# left running in the test process, and no warmup daemon (these tests are
# not about warmup, and ran without one while compile.* was inert).
DEMO = {"partition.metrics.window.ms": "400", "metric.sampling.interval.ms": "150",
        "default.goals": GOALS, "obs.history.enabled": "false",
        "compile.warmup.enabled": "false"}


def _build(props, **kwargs):
    return tmain.build_app(CruiseControlConfig(dict(DEMO, **props)), port=0, device="cpu",
                           **kwargs)


def _close(app):
    """An app built and never started."""
    app.user_tasks.shutdown()
    app.server.server_close()
    app.cc.shutdown()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wiring(app):
    """What the ingestion-edge paths wire, as plain values: the sampler,
    store, reporter agents, bus listener and maintenance reader, with their
    classes, partitions, fetchers, intervals and paths."""
    runner, cc = app.cc.task_runner, app.cc
    sampler, store = runner.sampler, runner.sample_store
    out = {"sampler": type(sampler).__name__, "store": type(store).__name__,
           "reporters": sorted((type(r).__name__, getattr(r, "broker_id", None),
                                getattr(r, "interval_ms", None)) for r in runner.reporters)}
    if hasattr(sampler, "num_fetchers"):
        out.update(fetchers=sampler.num_fetchers, offsets=sampler._offsets_path,
                   bus=(type(sampler.transport).__name__, sampler.transport.num_partitions,
                        getattr(sampler.transport, "_dir", None)))
    if hasattr(sampler, "endpoint"):
        out.update(endpoint=sampler.endpoint, step_ms=sampler.step_ms,
                   queries=sorted(t.name for t in sampler.query_map))
    if hasattr(store, "num_loaders"):
        out.update(loaders=store.num_loaders, store_cap=store.max_records_per_partition,
                   store_logs=[(type(t).__name__, t.num_partitions, t._dir)
                               for t in (store._pt, store._bt)])
    for r in runner.reporters:
        if type(r).__name__ == "TransportServer":
            out["listener"] = (r.port, r.auth_secret, r._ssl_ctx is not None,
                               r.transport is sampler.transport)
    reader = cc.maintenance_reader
    if reader is not None:
        t = reader._transport
        out["maintenance"] = (type(t).__name__, t.num_partitions if hasattr(t, "_dir") else
                              t._addr, reader._offsets_path, reader._expiration_ms,
                              getattr(t, "_auth_secret", None))
    return out


@pytest.mark.parametrize("props", [
    {"metric.sampler.mode": "reporter", "num.metric.fetchers": "3"},
    {"metric.sampler.mode": "prometheus", "prometheus.server.endpoint": "http://127.0.0.1:9"},
    {"metric.sampler.mode": "reporter", "sample.store.dir": "{tmp}/store",
     "metric.sampler.class": "cruise_control_tpu_torch.monitor.sampler.SyntheticWorkloadSampler"},
    {"metric.sampler.mode": "reporter", "sample.store.dir": "{tmp}/store",
     "metrics.transport.listen.port": "{port}", "metrics.transport.auth.secret.file": "{secret}"},
    {"maintenance.event.transport.dir": "{tmp}/bus", "maintenance.plan.expiration.ms": "60000"},
    {"maintenance.event.transport.address": "127.0.0.1:19093",
     "maintenance.event.transport.auth.secret.file": "{secret}",
     "maintenance.event.offsets.path": "{tmp}/off.json"},
], ids=["reporter", "prometheus", "log-sample-store", "metrics-listener",
        "maintenance-dir", "maintenance-address"])
def test_missing_module_paths_raise_config_error(props, tmp_path):
    """The paths that raised ``ConfigError`` until the port had the
    ingestion edge (the reporter and Prometheus modes, the log sample store,
    the bus listener, both maintenance transports): each now builds, and
    wires the classes, partitions, fetchers, intervals and paths the JAX
    package's ``build_app`` wires from the same properties."""
    from cruise_control_tpu.main import build_app as jbuild_app
    secret = tmp_path / "bus.secret"
    secret.write_text("bus-secret\n")
    port = _free_port()
    props = {k: v.format(tmp=tmp_path, port=port, secret=secret) for k, v in props.items()}
    got = {}
    for name in ("torch", "jax"):
        if name == "torch":
            app = _build(props)
        else:
            jprops = {k: v.replace("cruise_control_tpu_torch.", "cruise_control_tpu.")
                      for k, v in dict(DEMO, **props).items()}
            app = jbuild_app(JConfig(jprops), port=0)
        try:
            got[name] = _wiring(app)
        finally:
            # The listener (when wired) is closed before the other package
            # binds the same port.
            _close(app)
    assert got["torch"] == got["jax"]
    wired = got["torch"]
    assert ("fetchers" in wired) == (props.get("metric.sampler.mode") == "reporter"
                                     and "metric.sampler.class" not in props)
    assert ("listener" in wired) == ("metrics.transport.listen.port" in props)
    assert ("maintenance" in wired) == any(k.startswith("maintenance.") for k in props)
    assert ("loaders" in wired) == ("sample.store.dir" in props)


def test_build_app_takes_a_cluster_and_its_monitor():
    """A given metadata backend replaces the demo cluster, and a given load
    monitor and task runner the ones the config would build; the executor
    reassigns on that backend, and the rest is wired from the config."""
    from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
    from cruise_control_tpu_torch.monitor.metadata import MetadataClient
    from cruise_control_tpu_torch.monitor.sampler import SyntheticWorkloadSampler
    from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner
    backend = tmain.demo_metadata(num_brokers=4, num_partitions=8)
    lm = LoadMonitor(MetadataClient(backend, ttl_ms=0), num_windows=2, window_ms=400)
    runner = LoadMonitorTaskRunner(lm, SyntheticWorkloadSampler(), sampling_interval_ms=150)
    app = _build({"two.step.verification.enabled": "true"}, metadata_backend=backend,
                 monitor=(lm, runner))
    try:
        assert app.cc.load_monitor is lm and app.cc.task_runner is runner
        assert app.cc.executor.backend.metadata is backend
        assert app.purgatory is not None
    finally:
        _close(app)
    app = _build({}, metadata_backend=backend)
    try:
        assert app.cc.load_monitor is not lm
        assert app.cc.load_monitor.metadata_client._backend is backend
    finally:
        _close(app)


def test_build_app_wires_like_jax(tmp_path):
    """The same properties through both packages' ``build_app``: the facade,
    executor, resident model, notifier, security and app settings agree."""
    from cruise_control_tpu.analyzer import solver as jsolver
    from cruise_control_tpu.main import build_app as jbuild_app

    creds = tmp_path / "realm.properties"
    creds.write_text("admin: pw,ADMIN\n")
    props = dict(DEMO, **{
        "anomaly.detection.interval.ms": "45000", "proposal.expiration.ms": "7000",
        "min.valid.partition.ratio": "0.5", "max.active.user.tasks": "7",
        "completed.user.task.retention.time.ms": "1234", "two.step.verification.enabled": "true",
        "servlet.user.task.timeout.ms": "9000", "webserver.api.urlprefix": "/cc/*",
        "webserver.security.enable": "true", "webserver.auth.credentials.file": str(creds),
        "model.resident.max.delta.slots": "4096", "solver.default.deadline.ms": "30000",
        "solver.shutdown.grace.ms": "2500", "solver.segment.rounds": "4",
        "self.healing.enabled": "true", "topic.anomaly.target.replication.factor": "3",
        "anomaly.notifier.webhook.url": "http://127.0.0.1:9/hook"})
    # The JAX package's build_app sets the shared default solver's segment
    # width process-wide; it is put back afterwards.
    rounds = (jsolver._SEGMENT_ROUNDS_DEFAULT, jsolver.default_solver().segment_rounds)
    app = tmain.build_app(CruiseControlConfig(props), port=0, device="cpu")
    japp = jbuild_app(JConfig(props), port=0)
    try:
        for a, b in ((app.cc, japp.cc), (app, japp)):
            for name in ("default_goals", "default_deadline_ms", "shutdown_grace_ms",
                         "topic_anomaly_target_rf", "_precompute_interval_s",
                         "api_prefix", "ui_urlprefix", "ui_diskpath", "ssl_enabled"):
                if hasattr(b, name):
                    assert getattr(a, name) == getattr(b, name), name
        assert app.cc.anomaly_detector.interval_s == \
            japp.cc.anomaly_detector.interval_s == 45.0
        assert app.cc.default_completeness.min_monitored_partitions_percentage == 0.5
        assert app.purgatory is not None and japp.purgatory is not None
        assert (app.user_tasks.max_active, app.user_tasks.retention_ms,
                app.user_tasks.task_timeout_ms) == \
            (japp.user_tasks.max_active, japp.user_tasks.retention_ms,
             japp.user_tasks.task_timeout_ms) == (7, 1234, 9000.0)
        assert type(app.security).__name__ == type(japp.security).__name__
        assert type(app.cc.notifier).__name__ == type(japp.cc.notifier).__name__ == \
            "WebhookSelfHealingNotifier"
        assert vars(app.cc.executor.config) == vars(japp.cc.executor.config)
        assert app.cc.resident.max_delta_slots == japp.cc.resident.max_delta_slots == 4096
        assert app.cc.resident.device.type == "cpu"
        assert app.cc.optimizer.solver.segment_rounds == \
            japp.cc.optimizer.solver.segment_rounds == 4
        assert app.cc.optimizer.relaxation is None
    finally:
        _close(app)
        _close(japp)
        jsolver.set_default_segment_rounds(rounds[0])
        jsolver.default_solver().segment_rounds = rounds[1]


def test_relaxation_slo_store_and_journal_wiring(tmp_path):
    app = _build({"solver.relaxation.enabled": "true", "solver.relaxation.iterations": "12",
                  "solver.relaxation.waves": "2", "slo.enabled": "true",
                  "sample.store.dir": str(tmp_path / "store"),
                  "resilience.journal.path": str(tmp_path / "journal.log"),
                  "trace.profile.dir": str(tmp_path / "profiles")})
    try:
        relax = app.cc.optimizer.relaxation
        assert (relax.iterations, relax.waves, relax.candidates) == (12, 2, 4096)
        assert type(app.cc.slo_detector).__name__ == "SloViolationDetector"
        from cruise_control_tpu_torch.detector.anomalies import AnomalyType
        assert AnomalyType.SLO_VIOLATION in app.cc.anomaly_detector.detectors
        assert type(app.cc.task_runner.sample_store).__name__ == "FileSampleStore"
        assert app.cc.executor.journal.path == str(tmp_path / "journal.log")
        assert profiler.default_dir() == str(tmp_path / "profiles")
        # A request's own goal list shares the solver and relaxation.
        app.cc.task_runner.bootstrap(0, 6 * 400)
        r = app.cc.rebalance(["ReplicaDistributionGoal"], dryrun=True)
        assert [i.relaxed for i in r.optimizer_result.goal_infos] == [True]
    finally:
        _close(app)
        profiler.configure("")


def test_socket_admin_backend_with_reconnect(tmp_path):
    """``executor.admin.backend.address`` connects to a broker simulator
    process through the reconnecting wrapper, whose circuit is published."""
    from cruise_control_tpu_torch import resilience

    sim = subprocess.Popen([sys.executable, "-m",
                            "cruise_control_tpu_torch.executor.broker_simulator",
                            "--listen", "0"], cwd=ROOT, stdout=subprocess.PIPE, text=True,
                           env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        port = json.loads(sim.stdout.readline())["listening"]
        app = _build({"executor.admin.backend.address": f"127.0.0.1:{port}"})
        try:
            backend = app.cc.executor.backend
            assert type(backend).__name__ == "ReconnectingBackend"
            assert resilience.backend_circuit() is backend.circuit
        finally:
            _close(app)
        assert resilience.backend_circuit() is None
        with pytest.raises(ConfigError, match="host:port"):
            _build({"executor.admin.backend.address": "nohost"})
    finally:
        sim.kill()
        sim.wait(timeout=10)
        sim.stdout.close()


def test_demo_metadata_equals_jax():
    ours, theirs = tmain.demo_metadata().fetch(), jdemo_metadata().fetch()
    assert [(b.broker_id, b.rack, b.host) for b in ours.brokers] == \
        [(b.broker_id, b.rack, b.host) for b in theirs.brokers]
    assert [(p.topic, p.partition, p.leader, p.replicas, p.in_sync) for p in ours.partitions] == \
        [(p.topic, p.partition, p.leader, p.replicas, p.in_sync) for p in theirs.partitions]


def test_main_needs_a_card_by_default(monkeypatch, capsys):
    """``--device cuda`` is the default, and without a visible card main
    exits 2 with a message before building anything."""
    import torch

    assert tmain.build_parser().parse_args(["--demo"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tmain, "build_app", lambda *a, **k: pytest.fail("built an app"))
    assert tmain.main(["--demo"]) == 2
    assert tmain.main(["--demo", "--device", "cuda"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tmain.main([])                        # only --demo ships a cluster
    with pytest.raises(SystemExit):
        tmain.main(["--demo", "--device", "tpu"])


def test_main_demo_serves_the_cli_and_exits_on_sigterm(tmp_path):
    props = tmp_path / "demo.properties"
    props.write_text("".join(f"{k}={v}\n" for k, v in DEMO.items()))
    proc = subprocess.Popen([sys.executable, "-m", "cruise_control_tpu_torch.main", "--demo",
                             "--device", "cpu", "--port", "0", "--config", str(props)],
                            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith(tmain.LISTENING), line
        base = re.search(r"https?://\S+", line).group(0)
        from cruise_control_tpu_torch.client import cccli
        deadline = time.time() + 60
        while True:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cccli.main(["-a", base, "rebalance", "--dryrun", "true"])
            body = json.loads(buf.getvalue())
            if body["httpStatus"] == 200 or time.time() > deadline:
                break
            time.sleep(0.3)                   # the demo windows are filling
        assert rc == 0 and body["dryrun"] is True
        assert [g["goal"] for g in body["result"]["goals"]] == GOALS.split(",")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def test_cli_propose_runs_the_ports_propose(tmp_path, capsys):
    from cruise_control_tpu_torch.client import cccli
    from cruise_control_tpu_torch.model.snapshot import save_npz
    from cruise_control_tpu_torch.testing import deterministic

    path = str(tmp_path / "snap.npz")
    save_npz(path, *deterministic.unbalanced2().freeze(device="cpu", pad_replicas_to=64,
                                                     pad_brokers_to=8))
    assert cccli.main(["propose", "--snapshot", path, "--goals", "ReplicaDistributionGoal",
                       "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["proposals"] and "elapsedSeconds" in doc
    assert cccli.build_parser().parse_args(["propose", "--snapshot", path]).device == "cuda"


def test_profiler_capture_contract(tmp_path):
    """The JAX module's contract on ``torch.profiler``: a Chrome trace per
    window, one window at a time (409 semantics), a pollable status."""
    out = profiler.capture(0.05, out_dir=str(tmp_path))
    trace = os.path.join(out["trace_dir"], profiler.TRACE_FILE)
    assert os.path.getsize(trace) > 0 and "traceEvents" in json.load(open(trace))
    with pytest.raises(ValueError):
        profiler.start_async(0.0, out_dir=str(tmp_path))
    started = profiler.start_async(0.3, out_dir=str(tmp_path))
    with pytest.raises(profiler.ProfileInProgress):
        profiler.capture(0.05, out_dir=str(tmp_path))
    assert profiler.status()["busy"]
    deadline = time.time() + 30
    while profiler.status()["busy"] and time.time() < deadline:
        time.sleep(0.05)
    st = profiler.status()
    assert st["done"] and st["error"] is None and st["trace_dir"] == started["trace_dir"]
    assert os.path.exists(os.path.join(st["trace_dir"], profiler.TRACE_FILE))
