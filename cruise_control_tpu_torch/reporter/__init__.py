"""The metrics-reporter ingestion edge (the JAX package's ``reporter/``):
broker-side agents, the versioned wire serde, and the partitioned-log
transports (in process, segment files, TCP) they publish over."""

from cruise_control_tpu_torch.reporter.agent import (
    BrokerMetricsSource,
    DemoBrokerMetricsSource,
    MetricsReporter,
)
from cruise_control_tpu_torch.reporter.serde import (
    METRIC_VERSION,
    UnknownVersionError,
    deserialize_metric,
    serialize_metric,
)
from cruise_control_tpu_torch.reporter.transport import (
    FileTransport,
    InProcessTransport,
    SocketTransport,
    TransportServer,
    Transport,
)

__all__ = [
    "BrokerMetricsSource", "DemoBrokerMetricsSource", "MetricsReporter",
    "METRIC_VERSION", "UnknownVersionError", "deserialize_metric",
    "serialize_metric", "FileTransport", "InProcessTransport",
    "SocketTransport", "TransportServer", "Transport",
]
