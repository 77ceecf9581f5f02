"""Maintenance plans consumed from the message bus.

Reference: ``detector/MaintenanceEventTopicReader.java:1-350`` — the service
reads user-submitted maintenance plans from the ``__MaintenanceEvent`` Kafka
topic (produced by operators/tooling), discards plans older than
``maintenance.plan.expiration.ms``, converts the rest to ``MaintenanceEvent``
anomalies (dedup'd by the idempotence cache), and resumes where it left off
across restarts.  ``MaintenancePlanSerde.java`` defines the wire format: JSON
with a plan type, a per-type version, and a CRC over the content.

Here the topic is a partitioned-log ``Transport`` (the same SPI the metrics
reporter publishes over — ``reporter/transport.py``): a ``FileTransport``
directory for single-box durability or a ``SocketTransport`` pointed at any
``TransportServer``, so a second process can post plans over TCP exactly the
way the reference's producer posts to Kafka.  Consumer positions are
committed to a JSON offsets file after each applied batch (the role of Kafka
committed offsets), so a restart resumes instead of replaying — replayed
plans would be dropped by expiration/idempotence anyway, but committed
offsets keep restart cost O(new plans).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

from cruise_control_tpu_torch.detector.anomalies import MaintenanceEvent

LOG = logging.getLogger(__name__)

#: Plan-type tag -> latest supported serde version (MaintenancePlanSerde's
#: verifyTypeAndVersion: unknown type or a version newer than supported is a
#: deserialization error, not a silent drop).
SUPPORTED_PLANS: Dict[str, int] = {
    "rebalance": 1,
    "add_broker": 1,
    "remove_broker": 1,
    "demote_broker": 1,
    "fix_offline_replicas": 1,
    "topic_replication_factor": 1,
}

DEFAULT_EXPIRATION_MS = 15 * 60 * 1000.0   # maintenance.plan.expiration.ms


def _content_crc(content: Dict) -> int:
    """CRC over the canonical content encoding (sorted keys, no crc field) —
    the serde's integrity check for plans that crossed a network/log hop."""
    return zlib.crc32(
        json.dumps(content, sort_keys=True, separators=(",", ":"))
        .encode("utf-8"))


def serialize_plan(plan: str, time_ms: float, broker_ids=(),
                   topic: Optional[str] = None,
                   replication_factor: Optional[int] = None,
                   version: int = 1) -> bytes:
    """Wire-encode one maintenance plan (MaintenancePlanSerde.serialize)."""
    if plan not in SUPPORTED_PLANS:
        raise ValueError(f"unknown maintenance plan type {plan!r}")
    content = {"planType": plan, "version": int(version),
               "timeMs": float(time_ms),
               "brokers": sorted(int(b) for b in broker_ids)}
    if topic is not None:
        content["topic"] = topic
    if replication_factor is not None:
        content["replicationFactor"] = int(replication_factor)
    return json.dumps({**content, "crc": _content_crc(content)},
                      sort_keys=True).encode("utf-8")


def deserialize_plan(record: bytes) -> Dict:
    """Decode + verify one plan record; raises ValueError on garbage, CRC
    mismatch, unknown type, or a version newer than supported."""
    try:
        obj = json.loads(record.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"undecodable maintenance plan record: {e}") from e
    if not isinstance(obj, dict) or "crc" not in obj:
        raise ValueError("maintenance plan record missing crc")
    stored_crc = obj.pop("crc")
    if _content_crc(obj) != stored_crc:
        raise ValueError("maintenance plan crc mismatch (corrupt record)")
    plan = obj.get("planType")
    latest = SUPPORTED_PLANS.get(plan)
    if latest is None:
        raise ValueError(f"unknown maintenance plan type {plan!r}")
    if int(obj.get("version", 0)) > latest:
        raise ValueError(
            f"cannot deserialize plan type {plan} version {obj.get('version')}"
            f"; latest supported: {latest}")
    # Shape-check the fields the reader consumes: a valid-CRC plan with a
    # missing/mistyped timeMs or brokers must be a per-record drop, not an
    # exception class that escapes the reader's bad-record handling and
    # wedges the stream behind it.
    if not isinstance(obj.get("timeMs"), (int, float)):
        raise ValueError("maintenance plan missing numeric timeMs")
    brokers = obj.get("brokers", [])
    if not (isinstance(brokers, list)
            and all(isinstance(b, int) for b in brokers)):
        raise ValueError("maintenance plan brokers must be a list of ints")
    return obj


class MaintenanceEventReader:
    """Poll a Transport log for maintenance plans and feed the detector.

    One reader instance owns all partitions (the maintenance stream is
    control-plane-rate; the reference uses a single consumer too).  Expired
    and duplicate plans are dropped (expiration here, idempotence in the
    detector); undecodable records are logged and skipped — one corrupt
    record must not wedge the stream behind it.
    """

    def __init__(self, transport, detector,
                 offsets_path: Optional[str] = None,
                 expiration_ms: float = DEFAULT_EXPIRATION_MS,
                 poll_interval_s: float = 5.0,
                 clock=lambda: time.time() * 1000):
        self._transport = transport
        self._detector = detector
        self._offsets_path = offsets_path
        self._expiration_ms = expiration_ms
        self._interval = poll_interval_s
        self._clock = clock
        self._offsets: Dict[int, int] = self._load_offsets()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- offsets

    def _load_offsets(self) -> Dict[int, int]:
        if not self._offsets_path or not os.path.exists(self._offsets_path):
            return {}
        try:
            with open(self._offsets_path) as f:
                return {int(k): int(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            LOG.warning("unreadable maintenance offsets file %s; replaying "
                        "from the log start", self._offsets_path)
            return {}

    def _commit_offsets(self) -> None:
        if not self._offsets_path:
            return
        tmp = self._offsets_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self._offsets.items()}, f)
        os.replace(tmp, self._offsets_path)

    # ---------------------------------------------------------------- poll

    def poll_once(self) -> Tuple[int, int]:
        """Drain every partition once; returns (accepted, dropped)."""
        accepted = dropped = 0
        now = self._clock()
        progressed = False
        for p in range(self._transport.num_partitions):
            offset = self._offsets.get(p, 0)
            while True:
                records, next_offset = self._transport.poll(p, offset)
                if not records:
                    break
                progressed = True
                for rec in records:
                    # The whole per-record path is guarded: any malformed
                    # field is THIS record's problem — offsets must still
                    # advance past it or the stream wedges forever.
                    try:
                        plan = deserialize_plan(rec)
                        stale = (now - float(plan["timeMs"])
                                 > self._expiration_ms)
                        event = MaintenanceEvent(
                            plan=plan["planType"],
                            broker_ids=tuple(plan.get("brokers", ())),
                            topic=plan.get("topic"),
                            replication_factor=plan.get("replicationFactor"))
                    except (ValueError, TypeError, KeyError) as e:
                        LOG.warning("dropping bad maintenance plan: %s", e)
                        dropped += 1
                        continue
                    if stale:
                        # Stale plan (producer/consumer/network delay past
                        # the validity period) — acting on it now could fight
                        # the operator's current intent.
                        dropped += 1
                    elif self._detector.submit(event):
                        accepted += 1
                    else:
                        dropped += 1          # idempotence-cache duplicate
                offset = next_offset
            self._offsets[p] = offset
        if progressed:
            self._commit_offsets()
        return accepted, dropped

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="maintenance-event-reader")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except Exception:      # noqa: BLE001 — a dead bus must not kill
                LOG.exception("maintenance event poll failed; will retry")
