"""ClusterModelStats (reference: model/ClusterModelStats.java:29-496).

Per-resource avg/max/min/stdev over alive brokers, balanced-broker counts
against the balance band, and replica-count statistics, computed on the
state's device and returned as host values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.model import ops
from cruise_control_tpu_torch.model.state import ClusterState, Placement


@dataclass
class ClusterModelStats:
    """Host-side summary; produced by compute_stats()."""

    avg_util: np.ndarray       # f32[4] mean broker utilization (absolute)
    max_util: np.ndarray       # f32[4]
    min_util: np.ndarray       # f32[4]
    std_util: np.ndarray       # f32[4]
    num_balanced_brokers: np.ndarray  # i32[4] brokers inside the balance band
    avg_replicas: float
    max_replicas: int
    min_replicas: int
    std_replicas: float
    num_brokers: int
    num_replicas: int
    num_leaders: int
    num_unbalanced_brokers: np.ndarray  # i32[4]

    def cv(self) -> np.ndarray:
        """Coefficient of variation per resource — scale-free balance measure."""
        return self.std_util / np.maximum(self.avg_util, 1e-9)

    def to_dict(self) -> Dict:
        return {
            "statistics": {
                "AVG": {r.resource: float(self.avg_util[r]) for r in Resource}
                | {"replicas": self.avg_replicas},
                "MAX": {r.resource: float(self.max_util[r]) for r in Resource}
                | {"replicas": self.max_replicas},
                "MIN": {r.resource: float(self.min_util[r]) for r in Resource}
                | {"replicas": self.min_replicas},
                "STD": {r.resource: float(self.std_util[r]) for r in Resource}
                | {"replicas": self.std_replicas},
            },
            "numBalancedBrokers": {r.resource: int(self.num_balanced_brokers[r]) for r in Resource},
            "numBrokers": self.num_brokers,
            "numReplicas": self.num_replicas,
            "numLeaders": self.num_leaders,
        }


def compute_stats(state: ClusterState, placement: Placement,
                  balance_threshold: np.ndarray | None = None) -> ClusterModelStats:
    if balance_threshold is None:
        balance_threshold = np.full(NUM_RESOURCES, 1.1, dtype=np.float32)
    t = torch.as_tensor(np.asarray(balance_threshold, dtype=np.float32),
                        device=state.device)
    load = ops.broker_load(state, placement)          # [B,4]
    alive = state.alive & state.broker_valid          # [B]
    n = torch.clamp(alive.sum(), min=1)

    avg = torch.where(alive[:, None], load, 0.0).sum(dim=0) / n
    mx = torch.where(alive[:, None], load, -torch.inf).amax(dim=0)
    mn = torch.where(alive[:, None], load, torch.inf).amin(dim=0)
    var = torch.where(alive[:, None], (load - avg) ** 2, 0.0).sum(dim=0) / n
    std = torch.sqrt(var)

    # Balance band (ResourceDistributionGoal.initGoalState :236-263):
    # [avg * (2 - T), avg * T] on utilization, as absolute-load bounds.
    avg_frac = ops.average_alive_utilization(state, placement)      # [4]
    upper = avg_frac[None, :] * t[None, :] * state.capacity
    lower = avg_frac[None, :] * (2.0 - t[None, :]) * state.capacity
    in_band = (load <= upper) & (load >= lower)
    balanced = (in_band & alive[:, None]).sum(dim=0).to(torch.int32)

    rc = ops.replica_counts(state, placement)
    avg_rc = torch.where(alive, rc, 0).sum() / n
    mx_rc = torch.where(alive, rc, -1).max()
    mn_rc = torch.where(alive, rc, torch.iinfo(torch.int32).max).min()
    std_rc = torch.sqrt(torch.where(alive, (rc - avg_rc) ** 2, 0.0).sum() / n)

    num_leaders = (state.valid & placement.is_leader).sum()
    num_replicas = state.valid.sum()
    (avg, mx, mn, std, balanced) = (x.cpu().numpy() for x in (avg, mx, mn, std, balanced))
    n, avg_rc, mx_rc, mn_rc, std_rc, num_replicas, num_leaders = torch.stack([
        x.to(torch.float64) for x in (n, avg_rc, mx_rc, mn_rc, std_rc,
                                      num_replicas, num_leaders)]).tolist()
    return ClusterModelStats(
        avg_util=avg, max_util=mx, min_util=mn,
        std_util=std, num_balanced_brokers=balanced,
        avg_replicas=float(avg_rc), max_replicas=int(mx_rc), min_replicas=int(mn_rc),
        std_replicas=float(std_rc), num_brokers=int(n),
        num_replicas=int(num_replicas), num_leaders=int(num_leaders),
        num_unbalanced_brokers=np.asarray(int(n) - balanced, dtype=np.int64),
    )
