"""CPU estimation models.

Reference: ``model/ModelUtils.java:61-133`` (static-weight model) and
``model/LinearRegressionModelParameters.java`` (trainable linear model).

The static model splits a broker's measured CPU across its partitions in
proportion to weighted byte rates (leader bytes-in 0.7, leader bytes-out 0.15,
follower bytes-in 0.15 by default — MonitorConfig.java:243-261).  The trainable
model fits CPU ~ [leader_bytes_in, leader_bytes_out, follower_bytes_in] by
least squares over the accumulated training matrix.  Everything here is
host-side numpy, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

CPU_WEIGHT_LEADER_BYTES_IN = 0.7
CPU_WEIGHT_LEADER_BYTES_OUT = 0.15
CPU_WEIGHT_FOLLOWER_BYTES_IN = 0.15


@dataclass
class CpuModelParams:
    leader_bytes_in_weight: float = CPU_WEIGHT_LEADER_BYTES_IN
    leader_bytes_out_weight: float = CPU_WEIGHT_LEADER_BYTES_OUT
    follower_bytes_in_weight: float = CPU_WEIGHT_FOLLOWER_BYTES_IN
    # When fitted, the linear model overrides the static split.
    coefficients: Optional[np.ndarray] = None  # [3]: leader_in, leader_out, follower_in


DEFAULT_PARAMS = CpuModelParams()


def follower_cpu_from_leader_load(bytes_in: float, bytes_out: float, leader_cpu: float,
                                  params: CpuModelParams = DEFAULT_PARAMS) -> float:
    """CPU a replica would use as follower, from its leader-role load
    (ModelUtils.getFollowerCpuUtilFromLeaderLoad :61-78).  The builder's
    form: a non-positive weighted denominator gives 0, where the vectorized
    form below clamps it to 1e-12."""
    if params.coefficients is not None:
        return float(params.coefficients[2] * bytes_in)
    if bytes_in == 0.0 and bytes_out == 0.0:
        return 0.0
    denom = (params.leader_bytes_in_weight * bytes_in
             + params.leader_bytes_out_weight * bytes_out)
    if denom <= 0.0:
        return 0.0
    return leader_cpu * (params.follower_bytes_in_weight * bytes_in) / denom


def follower_cpu_from_leader_load_vec(bytes_in: np.ndarray, bytes_out: np.ndarray,
                                      leader_cpu: np.ndarray,
                                      params: CpuModelParams = DEFAULT_PARAMS) -> np.ndarray:
    """CPU each replica would use as follower, from its leader-role load
    (ModelUtils.getFollowerCpuUtilFromLeaderLoad, vectorized for packing
    snapshots)."""
    if params.coefficients is not None:
        return params.coefficients[2] * bytes_in
    denom = (params.leader_bytes_in_weight * bytes_in
             + params.leader_bytes_out_weight * bytes_out)
    out = leader_cpu * (params.follower_bytes_in_weight * bytes_in) / np.maximum(denom, 1e-12)
    return np.where((bytes_in == 0.0) & (bytes_out == 0.0), 0.0, out)


ALLOWED_METRIC_ERROR_FACTOR = 1.1
UNSTABLE_METRIC_THROUGHPUT_THRESHOLD = 10.0


def estimate_leader_cpu_util_per_core(broker_cpu_util: float,
                                      broker_leader_bytes_in: float,
                                      broker_leader_bytes_out: float,
                                      broker_follower_bytes_in: float,
                                      partition_bytes_in: float,
                                      partition_bytes_out: float,
                                      params: CpuModelParams = DEFAULT_PARAMS) -> Optional[float]:
    """Split broker CPU to one leader partition (ModelUtils.estimateLeaderCpuUtilPerCore :84-133).

    Returns None when partition rates exceed broker rates beyond metric noise
    (inconsistent sample — caller drops the sample, as the reference does).
    """
    if params.coefficients is not None:
        c = params.coefficients
        return float(c[0] * partition_bytes_in + c[1] * partition_bytes_out)
    if broker_leader_bytes_in == 0 or broker_leader_bytes_out == 0:
        return 0.0
    if (broker_leader_bytes_in * ALLOWED_METRIC_ERROR_FACTOR < partition_bytes_in
            and broker_leader_bytes_in > UNSTABLE_METRIC_THROUGHPUT_THRESHOLD):
        return None
    if (broker_leader_bytes_out * ALLOWED_METRIC_ERROR_FACTOR < partition_bytes_out
            and broker_leader_bytes_out > UNSTABLE_METRIC_THROUGHPUT_THRESHOLD):
        return None
    li = params.leader_bytes_in_weight * broker_leader_bytes_in
    lo = params.leader_bytes_out_weight * broker_leader_bytes_out
    fi = params.follower_bytes_in_weight * broker_follower_bytes_in
    total = li + lo + fi
    if total <= 0:
        return 0.0
    leader_contrib = (li * min(1.0, partition_bytes_in / broker_leader_bytes_in)
                      + lo * min(1.0, partition_bytes_out / broker_leader_bytes_out))
    return (leader_contrib / total) * broker_cpu_util


@dataclass
class LinearRegressionCpuModel:
    """Trainable CPU model (reference: LinearRegressionModelParameters.java:1-376).

    Accumulates (leader_bytes_in, leader_bytes_out, follower_bytes_in, cpu)
    training rows from broker metric samples and fits by least squares.
    """

    min_samples: int = 100
    _rows: list = field(default_factory=list)

    def add_sample(self, leader_bytes_in: float, leader_bytes_out: float,
                   follower_bytes_in: float, cpu_util: float) -> None:
        self._rows.append((leader_bytes_in, leader_bytes_out, follower_bytes_in, cpu_util))

    @property
    def num_samples(self) -> int:
        return len(self._rows)

    def trained(self) -> bool:
        return self.num_samples >= self.min_samples

    def fit(self) -> Optional[np.ndarray]:
        if not self.trained():
            return None
        data = np.asarray(self._rows, dtype=np.float64)
        x, y = data[:, :3], data[:, 3]
        coef, *_ = np.linalg.lstsq(x, y, rcond=None)
        return coef

    def training_completeness(self) -> float:
        return min(1.0, self.num_samples / self.min_samples)
