"""CPU estimation: the static-weight model.

Reference: ``model/ModelUtils.java:61-78``.  The static model splits a
broker's measured CPU across its partitions in proportion to weighted byte
rates (leader bytes-in 0.7, leader bytes-out 0.15, follower bytes-in 0.15 by
default — MonitorConfig.java:243-261).  The trainable linear model and the
per-partition leader split feed the load monitor, which the port has not
reached yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CPU_WEIGHT_LEADER_BYTES_IN = 0.7
CPU_WEIGHT_LEADER_BYTES_OUT = 0.15
CPU_WEIGHT_FOLLOWER_BYTES_IN = 0.15


@dataclass
class CpuModelParams:
    leader_bytes_in_weight: float = CPU_WEIGHT_LEADER_BYTES_IN
    leader_bytes_out_weight: float = CPU_WEIGHT_LEADER_BYTES_OUT
    follower_bytes_in_weight: float = CPU_WEIGHT_FOLLOWER_BYTES_IN


DEFAULT_PARAMS = CpuModelParams()


def follower_cpu_from_leader_load(bytes_in: float, bytes_out: float, leader_cpu: float,
                                  params: CpuModelParams = DEFAULT_PARAMS) -> float:
    """CPU a replica would use as follower, from its leader-role load
    (ModelUtils.getFollowerCpuUtilFromLeaderLoad :61-78).  The builder's
    form: a non-positive weighted denominator gives 0, where the vectorized
    form below clamps it to 1e-12."""
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
    denom = (params.leader_bytes_in_weight * bytes_in
             + params.leader_bytes_out_weight * bytes_out)
    out = leader_cpu * (params.follower_bytes_in_weight * bytes_in) / np.maximum(denom, 1e-12)
    return np.where((bytes_in == 0.0) & (bytes_out == 0.0), 0.0, out)
