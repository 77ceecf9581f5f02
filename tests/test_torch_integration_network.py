"""The port's service across every network face at once: the counterparts of
``tests/test_integration_network.py``'s two tests, the port's service
(``main.build_app`` on the CPU) against the port's broker simulator.

The first: a logdir failure injected into the out-of-process simulator →
the disk-failure detector reads it over the authenticated admin socket →
self-healing runs ``fix_offline_replicas`` → the executor's moves ride the
same socket back, while broker metrics keep flowing over the authenticated
TCP metrics bus.  Every hop crosses a real process or socket, so its waits
are bounded wall-clock polls, each with its own failure message.  The
second: maintenance plans over an authenticated ``TransportServer``, posted
by a second client, polled by the service's reader with an explicit call.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOALS = "RackAwareGoal,ReplicaCapacityGoal,DiskCapacityGoal,ReplicaDistributionGoal"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _release(backend):
    """Drop a SocketClusterBackend's connection without the shutdown op
    (close() would stop the simulator for everyone)."""
    backend._rstream.close()
    backend._wstream.close()
    backend._sock.close()


def _get_state(port):
    url = f"http://127.0.0.1:{port}/kafkacruisecontrol/state"
    return json.load(urllib.request.urlopen(url, timeout=10))


def _wait(cond, what, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.2)
    raise AssertionError(f"{what} within {timeout_s} s")


def test_disk_failure_self_heals_across_all_network_faces(tmp_path):
    from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
    from cruise_control_tpu_torch.executor.subprocess_backend import SocketClusterBackend
    from cruise_control_tpu_torch.main import build_app, demo_metadata
    from cruise_control_tpu_torch.reporter import SocketTransport

    admin_token = tmp_path / "admin.secret"
    admin_token.write_text("integration-admin-token\n")
    bus_secret = tmp_path / "bus.secret"
    bus_secret.write_text("integration-bus-secret\n")

    # The port's broker simulator on a TCP listener, bootstrapped to exactly
    # the demo topology (6 brokers, 48 partitions, rf=2).
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    sim = subprocess.Popen(
        [sys.executable, "-m", "cruise_control_tpu_torch.executor.broker_simulator",
         "--listen", "0", "--polls-to-finish", "1", "--auth-token-file", str(admin_token)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=ROOT, env=env)
    try:
        sim_port = int(json.loads(sim.stdout.readline())["listening"])
        parts = [{"topic": p.topic, "partition": p.partition, "replicas": list(p.replicas),
                  "leader": p.leader, "logdirs": {str(b): 0 for b in p.replicas}}
                 for p in demo_metadata().fetch().partitions]
        setup = SocketClusterBackend("127.0.0.1", sim_port,
                                     auth_secret="integration-admin-token")
        setup.request("bootstrap", partitions=parts)
        _release(setup)

        # The service: reporter-mode sampling, the TCP metrics bus and the
        # socket admin driver, both authenticated; self-healing on a short
        # detection interval; a short goal list.  The bus port must be
        # non-zero (0 turns the listener off), so one is probed.
        bus_port = _free_port()
        config = CruiseControlConfig({
            "metric.sampler.mode": "reporter",
            "metrics.transport.listen.port": str(bus_port),
            "metrics.transport.auth.secret.file": str(bus_secret),
            "executor.admin.backend.address": f"127.0.0.1:{sim_port}",
            "executor.admin.backend.auth.secret.file": str(admin_token),
            "self.healing.enabled": "true",
            "anomaly.detection.interval.ms": "1500",
            "execution.progress.check.interval.ms": "200",
            "partition.metrics.window.ms": "400",
            "broker.metrics.window.ms": "400",
            "metric.sampling.interval.ms": "150",
            "min.samples.per.partition.metrics.window": "1",
            "proposal.expiration.ms": "0",
            "default.goals": GOALS,
            "anomaly.detection.goals": GOALS,
            "obs.history.enabled": "false",
            "compile.warmup.enabled": "false",
        })
        app = build_app(config, port=0, device="cpu")
        app.cc.start_up()
        app.start()
        try:
            # Metrics flow over the authenticated TCP bus.
            bus = SocketTransport(f"127.0.0.1:{bus_port}", auth_secret="integration-bus-secret")
            _wait(lambda: sum(len(bus.poll(p, 0, 10)[0]) for p in range(bus.num_partitions)),
                  "no metrics crossed the TCP bus", 60)
            bus.close()

            # The monitor forms windows from the reporter pipeline.
            _wait(lambda: _get_state(app.port)["MonitorState"]["numValidWindows"] >= 2,
                  "the monitor formed no valid windows", 120)

            # The failure, in the simulator's process, over a second
            # authenticated admin connection.
            injector = SocketClusterBackend("127.0.0.1", sim_port,
                                            auth_secret="integration-admin-token")
            injector.request("fail_logdir", broker=0, logdir=0)
            assert injector.request("describe_log_dirs")["offline"] == {"0": [0]}
            _release(injector)

            # Detector (over the admin socket) → self-healing fix → executor
            # moves (over the same socket): broker 0's dead logdir empties.
            seen = {"fix": False}

            def evacuated():
                ad = _get_state(app.port)["AnomalyDetectorState"]
                rows = [a for v in ad.get("recentAnomalies", {}).values() for a in v]
                seen["fix"] = seen["fix"] or any(
                    a.get("type") == "DISK_FAILURE"
                    and a.get("status") in ("FIX_STARTED", "FIX_FAILED_TO_START")
                    for a in rows)
                checker = SocketClusterBackend("127.0.0.1", sim_port,
                                               auth_secret="integration-admin-token")
                final = checker.request("describe_topics")["partitions"]
                _release(checker)
                return all(0 not in d["replicas"] for d in final)

            _wait(evacuated, "broker 0's replicas were not evacuated over the admin socket",
                  300)
            assert seen["fix"], "the disk failure was never routed to the fixer"

            # The metrics bus face survived the whole loop.
            bus2 = SocketTransport(f"127.0.0.1:{bus_port}", auth_secret="integration-bus-secret")
            assert bus2.num_partitions == 8
            bus2.close()
        finally:
            app.stop()
            app.cc.shutdown()
    finally:
        sim.kill()
        sim.wait(timeout=10)


def test_maintenance_plans_over_authed_tcp_through_assembled_service(tmp_path):
    """The address-mode maintenance stream end to end: the port's service
    consumes plans from an authenticated TransportServer over TCP, posted by
    a second client connection (a JAX package client, so the wire is held
    across packages too)."""
    from cruise_control_tpu.detector.maintenance_reader import serialize_plan as jserialize
    from cruise_control_tpu.reporter import SocketTransport as JSocketTransport
    from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType
    from cruise_control_tpu_torch.detector.maintenance_reader import serialize_plan
    from cruise_control_tpu_torch.main import build_app
    from cruise_control_tpu_torch.reporter import (InProcessTransport, SocketTransport,
                                                   TransportServer)

    secret = tmp_path / "maint.secret"
    secret.write_text("maint-secret\n")
    bus = TransportServer(InProcessTransport(num_partitions=4), auth_secret="maint-secret")
    bus.start()
    reader = app = None
    try:
        config = CruiseControlConfig({
            "maintenance.event.transport.address": f"127.0.0.1:{bus.port}",
            "maintenance.event.transport.auth.secret.file": str(secret),
            "maintenance.event.offsets.path": str(tmp_path / "off.json"),
            "self.healing.enabled": "true",
            "obs.history.enabled": "false",
            "compile.warmup.enabled": "false",
        })
        app = build_app(config, port=0, device="cpu")
        reader = app.cc.maintenance_reader
        assert reader is not None
        now = time.time() * 1000
        plan = serialize_plan("remove_broker", time_ms=now, broker_ids=(3,))
        assert plan == jserialize("remove_broker", time_ms=now, broker_ids=(3,))
        # Producer side: a second authenticated client of each package.
        for Client, p in ((SocketTransport, 2), (JSocketTransport, 3)):
            producer = Client(f"127.0.0.1:{bus.port}", auth_secret="maint-secret")
            producer.append(p, serialize_plan("remove_broker", time_ms=now,
                                              broker_ids=(p + 1,)))
            producer.close()
        accepted, dropped = reader.poll_once()
        assert (accepted, dropped) == (2, 0)
        det = app.cc.anomaly_detector.detectors[AnomalyType.MAINTENANCE_EVENT]
        events = det.detect()
        assert sorted((e.plan, e.broker_ids) for e in events) == \
            [("remove_broker", (3,)), ("remove_broker", (4,))]
        with open(tmp_path / "off.json") as f:
            assert json.load(f) == {"0": 0, "1": 0, "2": 1, "3": 1}
        assert reader.poll_once() == (0, 0)
    finally:
        if reader is not None:
            reader._transport.close()
        if app is not None:
            app.user_tasks.shutdown()
            app.server.server_close()
            app.cc.shutdown()
        bus.stop()
