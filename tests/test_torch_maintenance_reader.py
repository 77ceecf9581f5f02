"""The port's maintenance-plan reader against the JAX package's.

Counterparts of ``tests/test_detector.py``'s maintenance tests (the
detector's idempotence, the plan serde, and the reader's expiry, dedup and
resume).  The reader reads any object with ``num_partitions`` and
``poll(partition, offset)``; both packages' readers are fed the JAX
package's ``reporter.FileTransport`` (the port's transports wait for its
reporter) with the same records, and must accept, drop, commit and emit the
same.  The TCP test (a second process posting plans) waits for the port's
reporter.
"""

import importlib
import json

import numpy as np
import pytest

from cruise_control_tpu.reporter import FileTransport
from cruise_control_tpu_torch.detector import maintenance_reader as mr
from cruise_control_tpu_torch.detector.anomalies import AnomalyType, MaintenanceEvent
from cruise_control_tpu_torch.detector.detectors import MaintenanceEventDetector
from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager
from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier

PKGS = {"jax": "cruise_control_tpu", "torch": "cruise_control_tpu_torch"}


def _pkg(root):
    return (importlib.import_module(f"{root}.detector.maintenance_reader"),
            importlib.import_module(f"{root}.detector.detectors"))


def test_maintenance_event_idempotence():
    det = MaintenanceEventDetector(idempotence_ttl_ms=1e9)
    assert det.submit(MaintenanceEvent(plan="rebalance")) is True
    assert det.submit(MaintenanceEvent(plan="rebalance")) is False
    assert det.submit(MaintenanceEvent(plan="remove_broker", broker_ids=(1,)))
    assert len(det.detect()) == 2
    assert det.detect() == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serde_bytes_and_verdicts_equal_jax(seed):
    rng = np.random.default_rng(seed)
    jmr, _ = _pkg(PKGS["jax"])
    plans = sorted(mr.SUPPORTED_PLANS)
    assert plans == sorted(jmr.SUPPORTED_PLANS)
    for _ in range(20):
        plan = plans[int(rng.integers(len(plans)))]
        kw = dict(time_ms=float(rng.integers(0, 10**9)),
                  broker_ids=tuple(int(b) for b in rng.integers(0, 50, int(rng.integers(0, 4)))))
        if plan == "topic_replication_factor":
            kw.update(topic=f"t{int(rng.integers(9))}", replication_factor=int(rng.integers(1, 4)))
        rec = mr.serialize_plan(plan, **kw)
        assert rec == jmr.serialize_plan(plan, **kw)
        assert mr.deserialize_plan(rec) == jmr.deserialize_plan(rec)
        # A flipped byte: both reject it, with the same kind of message.
        bad = bytearray(rec)
        bad[int(rng.integers(len(bad)))] ^= 0x5A
        verdicts = []
        for mod in (jmr, mr):
            try:
                verdicts.append(("ok", mod.deserialize_plan(bytes(bad))))
            except ValueError as e:
                verdicts.append(("error", str(e).split(":")[0][:24]))
        assert verdicts[1] == verdicts[0]


def test_maintenance_plan_serde_roundtrip_and_rejects():
    rec = mr.serialize_plan("remove_broker", time_ms=1000.0, broker_ids=(3, 1))
    plan = mr.deserialize_plan(rec)
    assert plan["planType"] == "remove_broker" and plan["brokers"] == [1, 3]
    assert plan["timeMs"] == 1000.0
    obj = json.loads(rec)
    obj["brokers"] = [1, 2]
    with pytest.raises(ValueError, match="crc"):
        mr.deserialize_plan(json.dumps(obj).encode())
    with pytest.raises(ValueError, match="unknown maintenance plan"):
        mr.serialize_plan("repartition", time_ms=0.0)
    future = json.loads(mr.serialize_plan("rebalance", time_ms=0.0))
    del future["crc"]
    future["version"] = 99
    future["crc"] = mr._content_crc(future)
    with pytest.raises(ValueError, match="latest supported"):
        mr.deserialize_plan(json.dumps({k: future[k] for k in sorted(future)}).encode())
    with pytest.raises(ValueError, match="undecodable"):
        mr.deserialize_plan(b"\xff\x00 not json")


def _bus(tmp_path, now, rng):
    bus = FileTransport(str(tmp_path / "bus"), num_partitions=3)
    records = [
        mr.serialize_plan("remove_broker", time_ms=now - 1000, broker_ids=(2,)),
        mr.serialize_plan("remove_broker", time_ms=now - 2000, broker_ids=(2,)),  # duplicate
        mr.serialize_plan("rebalance", time_ms=now - 999_999),                    # expired
        b"garbage record",
        mr.serialize_plan("demote_broker", time_ms=now - 5, broker_ids=(0, 4)),
        mr.serialize_plan("topic_replication_factor", time_ms=now, topic="T",
                          replication_factor=3),
        json.dumps({"planType": "rebalance", "timeMs": "x", "crc": 0}).encode(),
    ]
    for i in rng.permutation(len(records)):
        bus.append(int(rng.integers(3)), records[int(i)])
    return bus


def _reader_script(root, tmp_path, seed):
    now = 10_000_000.0
    rmod, dmod = _pkg(root)
    bus = _bus(tmp_path / root, now, np.random.default_rng(seed))
    offsets = tmp_path / root / "offsets.json"
    det = dmod.MaintenanceEventDetector(idempotence_ttl_ms=1e9)
    reader = rmod.MaintenanceEventReader(bus, det, offsets_path=str(offsets),
                                         expiration_ms=900_000, clock=lambda: now)
    first = reader.poll_once()
    events = sorted((e.plan, e.broker_ids, e.topic, e.replication_factor) for e in det.detect())
    committed = json.loads(offsets.read_text())
    det2 = dmod.MaintenanceEventDetector(idempotence_ttl_ms=1e9)
    reader2 = rmod.MaintenanceEventReader(bus, det2, offsets_path=str(offsets),
                                          expiration_ms=900_000, clock=lambda: now)
    resumed = reader2.poll_once()
    bus.append(1, rmod.serialize_plan("add_broker", time_ms=now, broker_ids=(7,)))
    after = reader2.poll_once()
    return first, events, committed, resumed, after, [e.plan for e in det2.detect()]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reader_on_jax_file_transport_equal_jax(tmp_path, seed):
    got = {root: _reader_script(PKGS[root], tmp_path, seed) for root in PKGS}
    assert got["torch"] == got["jax"]
    first, events, committed, resumed, after, later = got["torch"]
    assert first == (3, 4)          # fresh remove, demote, RF; dup, expired, two bad
    assert [e[0] for e in events] == ["demote_broker", "remove_broker",
                                      "topic_replication_factor"]
    assert set(committed) == {"0", "1", "2"}    # every partition committed (byte offsets)
    assert resumed == (0, 0) and after == (1, 0) and later == ["add_broker"]


def test_maintenance_reader_expires_dedups_and_resumes(tmp_path):
    now = 10_000_000.0
    bus = FileTransport(str(tmp_path / "bus"), num_partitions=2)
    bus.append(0, mr.serialize_plan("remove_broker", time_ms=now - 1000, broker_ids=(2,)))
    bus.append(1, mr.serialize_plan("remove_broker", time_ms=now - 2000, broker_ids=(2,)))
    bus.append(0, mr.serialize_plan("rebalance", time_ms=now - 999_999))
    bus.append(1, b"garbage record")
    det = MaintenanceEventDetector(idempotence_ttl_ms=1e9)
    offsets = tmp_path / "offsets.json"
    reader = mr.MaintenanceEventReader(bus, det, offsets_path=str(offsets),
                                       expiration_ms=900_000, clock=lambda: now)
    assert reader.poll_once() == (1, 3)
    events = det.detect()
    assert len(events) == 1 and events[0].broker_ids == (2,)
    reader2 = mr.MaintenanceEventReader(bus, MaintenanceEventDetector(idempotence_ttl_ms=1e9),
                                        offsets_path=str(offsets), expiration_ms=900_000,
                                        clock=lambda: now)
    assert reader2.poll_once() == (0, 0)


def test_reader_thread_feeds_the_manager(tmp_path):
    """start() polls on its own thread; the manager routes the event to the
    fixer; stop() joins the thread."""
    import time

    bus = FileTransport(str(tmp_path / "bus"), num_partitions=2)
    det = MaintenanceEventDetector(idempotence_ttl_ms=1e9)
    reader = mr.MaintenanceEventReader(bus, det, poll_interval_s=0.01)
    fixed = []
    mgr = AnomalyDetectorManager({AnomalyType.MAINTENANCE_EVENT: det},
                                 notifier=SelfHealingNotifier(self_healing_enabled=True),
                                 fixer=lambda a: fixed.append(a.plan) or True)
    reader.start()
    try:
        bus.append(0, mr.serialize_plan("rebalance", time_ms=time.time() * 1000))
        deadline = time.monotonic() + 10
        while not fixed and time.monotonic() < deadline:
            mgr.run_detection_once()
            time.sleep(0.01)
    finally:
        reader.stop()
    assert fixed == ["rebalance"]
    assert not reader._thread.is_alive()
