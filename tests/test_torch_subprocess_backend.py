"""The port's out-of-process executor driver against the JAX package's.

Light counterparts of ``tests/test_subprocess_backend.py``: the port's
executor drives the port's broker simulator as a separate process (stdio
or a TCP socket, with a shared secret or TLS), with the JAX tests' reply
budgets (``request_timeout_s`` 10 s by default) and bounded joins.  The
last test runs one rebalance with throttles through both packages'
simulators and compares the child's final state and config log exactly.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import pytest

from cruise_control_tpu_torch.common.actions import (
    ExecutionProposal,
    ReplicaPlacementInfo,
    TopicPartition,
)
from cruise_control_tpu_torch.detector.detectors import DiskFailureDetector
from cruise_control_tpu_torch.executor.broker_simulator import (
    FOLLOWER_THROTTLED_RATE,
    FOLLOWER_THROTTLED_REPLICAS,
    LEADER_THROTTLED_RATE,
    LEADER_THROTTLED_REPLICAS,
    BrokerSimulator,
)
from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
from cruise_control_tpu_torch.executor.subprocess_backend import (
    BackendTransportError,
    SocketClusterBackend,
    SubprocessClusterBackend,
)
from cruise_control_tpu_torch.executor.tasks import ExecutionTaskState, TaskType
from tests.test_torch_executor import run_to_end

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def proposal(topic, part, old, new, size=100.0, old_dirs=None, new_dirs=None, mod=None):
    tp, rpi, ep = ((mod.TopicPartition, mod.ReplicaPlacementInfo, mod.ExecutionProposal)
                   if mod else (TopicPartition, ReplicaPlacementInfo, ExecutionProposal))
    old_dirs = old_dirs or [None] * len(old)
    new_dirs = new_dirs or [None] * len(new)
    return ep(topic_partition=tp(topic, part), partition_size=size,
              old_leader=rpi(old[0], old_dirs[0]),
              old_replicas=tuple(rpi(b, d) for b, d in zip(old, old_dirs)),
              new_replicas=tuple(rpi(b, d) for b, d in zip(new, new_dirs)))


def bootstrap_partitions():
    """4 brokers; T-0..T-3 on (p%4, (p+1)%4)."""
    return [{"topic": "T", "partition": p, "replicas": [p % 4, (p + 1) % 4],
             "leader": p % 4} for p in range(4)]


@pytest.fixture
def backend():
    b = SubprocessClusterBackend.spawn(bootstrap_partitions(), polls_to_finish=2)
    yield b
    b.close()


def _final(backend):
    return {(d["topic"], d["partition"]): d for d in backend.describe_topics()}


def test_simulator_unit_roundtrip():
    sim = BrokerSimulator(polls_to_finish=2)
    sim.handle({"op": "bootstrap", "partitions": bootstrap_partitions()})
    sim.handle({"op": "alter_partition_reassignments",
                "reassignments": [{"topic": "T", "partition": 0, "replicas": [2, 1]}]})
    assert sim.handle({"op": "list_partition_reassignments"})["reassignments"] == [
        {"topic": "T", "partition": 0}]
    assert sim.handle({"op": "is_done", "topic": "T", "partition": 0})["done"] is False
    assert sim.handle({"op": "is_done", "topic": "T", "partition": 0})["done"] is True
    assert sim.partitions[("T", 0)]["replicas"] == [2, 1]
    assert sim.partitions[("T", 0)]["leader"] == 2
    resp = sim.handle({"op": "alter_partition_reassignments",
                       "reassignments": [{"topic": "X", "partition": 9, "replicas": [0]}]})
    assert not resp["ok"] and "unknown partition" in resp["error"]


def test_simulator_main_stdio_roundtrip_without_torch():
    """The __main__ stdio framing (bad json, shutdown rc=0), in a fresh
    interpreter that never imports torch."""
    code = ("import runpy, sys\n"
            "try:\n"
            "    runpy.run_module('cruise_control_tpu_torch.executor.broker_simulator',"
            " run_name='__main__')\n"
            "finally:\n"
            "    sys.stderr.write('torch' if 'torch' in sys.modules else 'no-torch')\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        proc.stdin.write("this is not json\n")
        proc.stdin.write(json.dumps({"id": 1, "op": "ping"}) + "\n")
        proc.stdin.write(json.dumps({"id": 2, "op": "shutdown"}) + "\n")
        proc.stdin.flush()
        lines = [json.loads(proc.stdout.readline()) for _ in range(3)]
        assert lines[0]["ok"] is False
        assert lines[1] == {"id": 1, "ok": True}
        assert lines[2] == {"id": 2, "ok": True}
        assert proc.wait(timeout=5) == 0
        assert proc.stderr.read().strip().endswith("no-torch")
    finally:
        if proc.poll() is None:
            proc.kill()


def test_full_rebalance_through_subprocess(backend):
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.01))
    run_to_end(ex, [
        proposal("T", 0, [0, 1], [2, 1]),
        proposal("T", 1, [1, 2], [3, 2]),
        proposal("T", 2, [2, 3], [3, 2]),        # pure leadership 2 -> 3
    ])
    final = _final(backend)
    assert final[("T", 0)]["replicas"] == [2, 1]
    assert final[("T", 1)]["replicas"] == [3, 2]
    assert final[("T", 2)]["leader"] == 3
    assert ex.tracker.count(TaskType.INTER_BROKER_REPLICA_ACTION,
                            ExecutionTaskState.COMPLETED) == 2
    assert ex.tracker.count(TaskType.LEADER_ACTION, ExecutionTaskState.COMPLETED) == 1


def _set_values(backend):
    out = {}
    for e in backend.stats()["config_log"]:
        if e.get("op", "set") != "delete":
            out.setdefault((e["entity_type"], str(e["entity"]), e["name"]), []).append(
                e.get("value"))
    return out


def test_throttles_set_and_cleared_through_subprocess(backend):
    for entity_type, entity, name, value in (
            ("broker", 3, LEADER_THROTTLED_RATE, "12345"),
            ("broker", 0, LEADER_THROTTLED_RATE, "777"),
            ("topic", "T", LEADER_THROTTLED_REPLICAS, "0:9")):
        backend.request("incremental_alter_configs", entity_type=entity_type,
                        entity=entity, ops=[{"name": name, "value": value}])
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.01,
                                          replication_throttle_bytes_per_s=1000))
    run_to_end(ex, [proposal("T", 0, [0, 1], [2, 1])])
    set_entries = _set_values(backend)
    for b in ("1", "2"):
        assert ("broker", b, LEADER_THROTTLED_RATE) in set_entries
        assert ("broker", b, FOLLOWER_THROTTLED_RATE) in set_entries
    assert ("broker", "0", FOLLOWER_THROTTLED_RATE) in set_entries
    assert "0:9,0:0,0:1" in set_entries[("topic", "T", LEADER_THROTTLED_REPLICAS)]
    assert "0:2" in set_entries[("topic", "T", FOLLOWER_THROTTLED_REPLICAS)]

    def configs(entity_type, entity):
        return backend.request("describe_configs", entity_type=entity_type,
                               entity=entity)["configs"]
    for b in (1, 2):
        assert LEADER_THROTTLED_RATE not in configs("broker", b)
    cfg0 = configs("broker", 0)
    assert cfg0[LEADER_THROTTLED_RATE] == "777" and FOLLOWER_THROTTLED_RATE not in cfg0
    assert configs("broker", 3)[LEADER_THROTTLED_RATE] == "12345"
    cfg_t = configs("topic", "T")
    assert cfg_t.get(LEADER_THROTTLED_REPLICAS) == "0:9"
    assert FOLLOWER_THROTTLED_REPLICAS not in cfg_t


def test_batching_respects_movement_cap(backend):
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.01,
                                          concurrent_partition_movements_per_broker=1))
    run_to_end(ex, [proposal("T", p, [p % 4, (p + 1) % 4], [(p + 2) % 4, (p + 1) % 4])
                    for p in range(4)])
    per_broker = backend.stats()["max_inflight_per_broker"]
    assert per_broker and all(n <= 1 for n in per_broker.values()), per_broker


def test_logdir_moves_through_subprocess():
    backend = SubprocessClusterBackend.spawn(
        [{"topic": "T", "partition": 0, "replicas": [0, 1], "leader": 0,
          "logdirs": {"0": 0, "1": 0}}], polls_to_finish=2)
    try:
        ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.01))
        run_to_end(ex, [proposal("T", 0, [0, 1], [0, 1], old_dirs=[0, 0],
                                 new_dirs=[1, 0])])
        assert backend.describe_topics()[0]["logdirs"]["0"] == 1
        assert ex.tracker.count(TaskType.INTRA_BROKER_REPLICA_ACTION,
                                ExecutionTaskState.COMPLETED) == 1
    finally:
        backend.close()


def test_dead_task_on_failed_broker(backend):
    backend.request("fail_broker", broker=3)
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.01,
                                          task_execution_alert_timeout_s=0.3))
    run_to_end(ex, [proposal("T", 0, [0, 1], [2, 1]),
                    proposal("T", 1, [1, 2], [3, 2])])
    assert ex.tracker.count(TaskType.INTER_BROKER_REPLICA_ACTION,
                            ExecutionTaskState.COMPLETED) == 1
    assert ex.tracker.count(TaskType.INTER_BROKER_REPLICA_ACTION,
                            ExecutionTaskState.DEAD) == 1
    final = _final(backend)
    assert final[("T", 0)]["replicas"] == [2, 1]
    assert final[("T", 1)]["replicas"] == [1, 2]


def test_dead_peer_surfaces_as_dead_tasks():
    backend = SubprocessClusterBackend.spawn(bootstrap_partitions(), polls_to_finish=50)
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.01,
                                          task_execution_alert_timeout_s=0.3))
    ex.execute_proposals([proposal("T", 0, [0, 1], [2, 1])], wait=False)
    backend.proc.kill()
    ex._thread.join(timeout=10)
    assert not ex._thread.is_alive()
    assert ex.tracker.count(TaskType.INTER_BROKER_REPLICA_ACTION,
                            ExecutionTaskState.DEAD) == 1
    with pytest.raises(BackendTransportError):
        backend.request("ping")


def test_dead_peer_before_start_is_caller_visible():
    backend = SubprocessClusterBackend.spawn(bootstrap_partitions())
    backend.proc.kill()
    backend.proc.wait(timeout=5)
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.01))
    with pytest.raises(BackendTransportError):
        ex.execute_proposals([proposal("T", 0, [0, 1], [2, 1])])
    assert all(ex.tracker.count(TaskType.INTER_BROKER_REPLICA_ACTION, s) == 0
               for s in ExecutionTaskState)


def test_full_rebalance_over_tcp_socket():
    backend = SocketClusterBackend.spawn_networked(bootstrap_partitions(), polls_to_finish=2)
    try:
        ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.01))
        run_to_end(ex, [proposal("T", 0, [0, 1], [2, 1]),
                        proposal("T", 2, [2, 3], [3, 2])])
        final = _final(backend)
        assert final[("T", 0)]["replicas"] == [2, 1]
        assert final[("T", 2)]["leader"] == 3
    finally:
        backend.close()


def test_offline_logdir_detection_through_subprocess(backend):
    det = DiskFailureDetector(backend.offline_logdirs)
    assert backend.offline_logdirs() == {} and det.detect() == []
    backend.request("fail_logdir", broker=2, logdir=1)
    backend.request("fail_logdir", broker=2, logdir=0)
    assert backend.offline_logdirs() == {2: [0, 1]}
    found = det.detect()
    assert len(found) == 1 and found[0].failed_disks == {2: [0, 1]}
    backend.request("restore_logdir", broker=2, logdir=0)
    backend.request("restore_logdir", broker=2, logdir=1)
    assert det.detect() == []


def _release(backend):
    """Close the client's streams and socket without shutting the serial
    listener down."""
    backend._rstream.close()
    backend._wstream.close()
    backend._sock.close()


def test_socket_backend_shared_secret_auth(tmp_path):
    token_file = tmp_path / "admin.secret"
    token_file.write_text("s3cret-token\n")
    backend = SocketClusterBackend.spawn_networked(
        bootstrap_partitions(), polls_to_finish=1, auth_token_file=str(token_file),
        auth_secret="s3cret-token")
    port = backend._sock.getpeername()[1]
    try:
        assert len(backend.describe_topics()) == 4
        _release(backend)

        def raw_exchange(payload: bytes) -> dict:
            with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
                s.sendall(payload)
                return json.loads(s.makefile("r").readline())

        resp = raw_exchange(b'{"id": 1, "op": "auth", "token": "nope"}\n')
        assert resp["ok"] is False and "auth" in resp["error"]
        resp = raw_exchange(b'{"id": 1, "op": "describe_topics"}\n')
        assert resp["ok"] is False and "auth" in resp["error"]
        again = SocketClusterBackend("127.0.0.1", port, auth_secret="s3cret-token")
        assert len(again.describe_topics()) == 4
        again.proc, backend.proc = backend.proc, None
        again.close()
    finally:
        backend.close()


@pytest.mark.skipif(shutil.which("openssl") is None, reason="openssl CLI not available")
def test_socket_backend_tls(tmp_path):
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                    "-keyout", str(key), "-out", str(cert), "-days", "1",
                    "-subj", "/CN=localhost"], check=True, capture_output=True, timeout=60)
    backend = SocketClusterBackend.spawn_networked(
        bootstrap_partitions(), polls_to_finish=1, ssl_cert=str(cert), ssl_key=str(key),
        ssl_cafile=str(cert))
    port = backend._sock.getpeername()[1]
    try:
        assert len(backend.describe_topics()) == 4
        _release(backend)
        with pytest.raises(BackendTransportError):
            SocketClusterBackend("127.0.0.1", port, request_timeout_s=5.0).describe_topics()
        again = SocketClusterBackend("127.0.0.1", port, ssl_cafile=str(cert))
        assert len(again.describe_topics()) == 4
        again.proc, backend.proc = backend.proc, None
        again.close()
    finally:
        backend.close()


def test_rebalance_through_both_simulators_equal():
    """One rebalance with throttles, batch caps and a leadership move,
    through each package's executor and simulator process: the child's final
    partitions, config log, inflight maxima and the tracker are equal."""
    from cruise_control_tpu.common import actions as jactions
    from cruise_control_tpu.executor.executor import Executor as JExecutor
    from cruise_control_tpu.executor.executor import ExecutorConfig as JConfig
    from cruise_control_tpu.executor.subprocess_backend import (
        SubprocessClusterBackend as JBackend)

    parts = [{"topic": f"t{p % 2}", "partition": p,
              "replicas": [p % 6, (p + 1) % 6, (p + 2) % 6], "leader": p % 6}
             for p in range(12)]
    moves = [(p, [p % 6, (p + 1) % 6, (p + 2) % 6],
              [(p + 3) % 6, (p + 1) % 6, (p + 2) % 6] if p % 3 else
              [(p + 1) % 6, p % 6, (p + 2) % 6]) for p in range(12)]
    got = {}
    for name, backend_cls, ex_cls, cfg_cls, mod in (
            ("jax", JBackend, JExecutor, JConfig, jactions),
            ("torch", SubprocessClusterBackend, Executor, ExecutorConfig, None)):
        backend = backend_cls.spawn(parts, polls_to_finish=2)
        try:
            ex = ex_cls(backend, cfg_cls(progress_check_interval_s=0.005,
                                         concurrent_partition_movements_per_broker=2,
                                         replication_throttle_bytes_per_s=5000))
            run_to_end(ex, [proposal(f"t{p % 2}", p, old, new, mod=mod)
                            for p, old, new in moves])
            stats = backend.stats()
            got[name] = (sorted(backend.describe_topics(), key=lambda d: d["partition"]),
                         stats["config_log"], stats["max_inflight_per_broker"],
                         ex.tracker.summary())
        finally:
            backend.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][3]["inter_broker_replica"]["completed"] == 8
    assert got["torch"][3]["leadership"]["completed"] == 4
