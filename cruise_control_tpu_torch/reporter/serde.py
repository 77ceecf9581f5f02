"""Versioned binary wire format for raw metrics (the JAX package's
``reporter/serde.py``; the bytes are the same, so either package reads what
the other writes).

Reference: ``cruise-control-metrics-reporter/.../metric/MetricSerde.java`` +
``BrokerMetric/TopicMetric/PartitionMetric.toBuffer`` — each record is
[version u8][wire-type u8][time i64][broker i32][scope payload][value f64],
where the scope payload is empty for broker metrics, a length-prefixed UTF-8
topic for topic metrics, and topic + partition i32 for partition metrics.
Readers accept any version ≤ theirs (UnknownVersionException otherwise) and
skip type ids newer than their inventory — the rolling-upgrade contract the
reference encodes per-type via ``supportedVersionSince``.
"""

from __future__ import annotations

import struct
from typing import Optional

from cruise_control_tpu_torch.common.exceptions import CruiseControlError
from cruise_control_tpu_torch.monitor.samples import (
    CruiseControlMetric,
    RawMetricScope,
    raw_type_by_id,
)

METRIC_VERSION = 5

_HEAD = struct.Struct(">BBqi")      # version, type id, time_ms, broker_id
_F64 = struct.Struct(">d")
_I32 = struct.Struct(">i")
_U16 = struct.Struct(">H")


class UnknownVersionError(CruiseControlError):
    pass


def serialize_metric(m: CruiseControlMetric) -> bytes:
    out = bytearray(_HEAD.pack(METRIC_VERSION, m.raw_type.wire_id,
                               int(m.time_ms), m.broker_id))
    scope = m.raw_type.scope
    if scope is not RawMetricScope.BROKER:
        topic = (m.topic or "").encode("utf-8")
        out += _U16.pack(len(topic))
        out += topic
        if scope is RawMetricScope.PARTITION:
            out += _I32.pack(m.partition if m.partition is not None else -1)
    out += _F64.pack(m.value)
    return bytes(out)


def deserialize_metric(buf: bytes) -> Optional[CruiseControlMetric]:
    """None when the record's type id is newer than this reader's inventory
    (forward-compatible skip); raises on a newer VERSION byte."""
    version, wire_id, time_ms, broker_id = _HEAD.unpack_from(buf, 0)
    if version > METRIC_VERSION:
        raise UnknownVersionError(
            f"metric version {version} > supported {METRIC_VERSION}")
    try:
        raw_type = raw_type_by_id(wire_id)
    except KeyError:
        return None
    off = _HEAD.size
    topic = None
    partition = None
    if raw_type.scope is not RawMetricScope.BROKER:
        (tlen,) = _U16.unpack_from(buf, off)
        off += _U16.size
        topic = buf[off:off + tlen].decode("utf-8")
        off += tlen
        if raw_type.scope is RawMetricScope.PARTITION:
            (partition,) = _I32.unpack_from(buf, off)
            off += _I32.size
    (value,) = _F64.unpack_from(buf, off)
    return CruiseControlMetric(raw_type=raw_type, time_ms=float(time_ms),
                               broker_id=broker_id, topic=topic,
                               partition=partition, value=value)
