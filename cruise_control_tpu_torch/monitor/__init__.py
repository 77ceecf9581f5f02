"""Monitor layer: samples → windowed aggregates → cluster model snapshots.

The JAX package's ``monitor/`` (the reference's ``monitor/LoadMonitor.java``,
``monitor/sampling/**`` and the core ``MetricSampleAggregator`` framework):
ring buffers become dense ``f64[E, W, M]`` numpy planes with count and
validity planes, extrapolations become vectorized masks, all on the host;
the output is the frozen tensor snapshot the analyzer consumes, on the
caller's device.
"""

from cruise_control_tpu_torch.monitor.metric_def import MetricDef, ValueComputingStrategy
from cruise_control_tpu_torch.monitor.aggregator import (
    AggregationOptions,
    Extrapolation,
    MetricSampleAggregator,
    MetricSampleCompleteness,
)
from cruise_control_tpu_torch.monitor.load_monitor import (
    LoadMonitor,
    ModelCompletenessRequirements,
)

__all__ = [
    "MetricDef",
    "ValueComputingStrategy",
    "MetricSampleAggregator",
    "AggregationOptions",
    "MetricSampleCompleteness",
    "Extrapolation",
    "LoadMonitor",
    "ModelCompletenessRequirements",
]
