"""Tensor queries over (ClusterState, Placement).

Aggregate views are recomputed with segment sums: O(R) work per call, and
correct under any batch of simultaneous moves.
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.model.state import ClusterState, Placement


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[i] over ids[i] == s``; every id must lie in
    ``[0, num_segments)`` (callers index with in-range ids by construction)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids.long(), data)


def effective_load(state: ClusterState, placement: Placement) -> torch.Tensor:
    """f32[R, 4]: each replica's load in its current role, zeroed for padding."""
    load = torch.where(placement.is_leader[:, None], state.leader_load,
                       state.follower_load)
    return load * state.valid[:, None]


def broker_load(state: ClusterState, placement: Placement) -> torch.Tensor:
    """f32[B, 4]: per-broker utilization (sum of effective replica loads)."""
    return segment_sum(effective_load(state, placement), placement.broker,
                       state.num_brokers_padded)


def replica_counts(state: ClusterState, placement: Placement) -> torch.Tensor:
    """i32[B]: replicas per broker."""
    return segment_sum(state.valid.to(torch.int32), placement.broker,
                       state.num_brokers_padded)


def average_alive_utilization(state: ClusterState,
                              placement: Placement) -> torch.Tensor:
    """f32[4]: cluster-wide utilization / capacity over alive brokers (the
    baseline of the resource balance band)."""
    total_load = torch.sum(broker_load(state, placement)
                           * state.broker_valid[:, None], dim=0)
    alive = state.alive & state.broker_valid
    total_cap = torch.sum(state.capacity * alive[:, None], dim=0)
    return total_load / torch.clamp(total_cap, min=1e-9)
