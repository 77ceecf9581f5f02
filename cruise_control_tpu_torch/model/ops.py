"""Tensor queries over (ClusterState, Placement) (the JAX package's
``model/ops.py``).

Aggregate views are recomputed with segment sums (``index_add_``) and
segment maxima (``scatter_reduce_``): O(R) work per call, and correct under
any batch of simultaneous moves.  Every id must lie in its segment range
(callers index with in-range ids by construction).
"""

from __future__ import annotations

import torch

from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.state import ClusterState, Placement


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum of data[i] over ids[i] == s``."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids.long(), data)


def segment_max(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = max of data[i] over ids[i] == s``; an empty segment holds
    the dtype's lowest value, as ``jax.ops.segment_max`` gives it."""
    low = (-float("inf") if data.dtype.is_floating_point
           else torch.iinfo(data.dtype).min)
    out = torch.full((num_segments,), low, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, ids.long(), data, reduce="amax", include_self=True)


def effective_load(state: ClusterState, placement: Placement) -> torch.Tensor:
    """f32[R, 4]: each replica's load in its current role, zeroed for padding."""
    load = torch.where(placement.is_leader[:, None], state.leader_load,
                       state.follower_load)
    return load * state.valid[:, None]


def broker_load(state: ClusterState, placement: Placement) -> torch.Tensor:
    """f32[B, 4]: per-broker utilization (sum of effective replica loads)."""
    return segment_sum(effective_load(state, placement), placement.broker,
                       state.num_brokers_padded)


def host_load(state: ClusterState, placement: Placement, num_hosts: int) -> torch.Tensor:
    """f32[H, 4]: per-host utilization (brokers aggregated by host; CPU and
    NW are host resources, Resource.java)."""
    return segment_sum(broker_load(state, placement), state.host, num_hosts)


def disk_load(state: ClusterState, placement: Placement) -> torch.Tensor:
    """f32[B, D]: per-logdir DISK utilization for JBOD brokers."""
    d = state.num_disks_per_broker
    flat = placement.broker.long() * d + placement.disk.long()
    sums = segment_sum(effective_load(state, placement)[:, Resource.DISK], flat,
                       state.num_brokers_padded * d)
    return sums.reshape(state.num_brokers_padded, d)


def potential_leadership_load(state: ClusterState, placement: Placement) -> torch.Tensor:
    """f32[B]: NW_OUT if a broker led *all* its replicas (the reference's
    ``ClusterModel._potentialLeadershipLoadByBrokerId``, ClusterModel.java:
    740-764, consumed by PotentialNwOutGoal)."""
    pot = state.leader_load[:, Resource.NW_OUT] * state.valid
    return segment_sum(pot, placement.broker, state.num_brokers_padded)


def replica_counts(state: ClusterState, placement: Placement) -> torch.Tensor:
    """i32[B]: replicas per broker."""
    return segment_sum(state.valid.to(torch.int32), placement.broker,
                       state.num_brokers_padded)


def leader_counts(state: ClusterState, placement: Placement) -> torch.Tensor:
    """i32[B]: leader replicas per broker."""
    return segment_sum((state.valid & placement.is_leader).to(torch.int32),
                       placement.broker, state.num_brokers_padded)


def _topic_broker(state: ClusterState, placement: Placement, num_topics: int,
                  which: torch.Tensor) -> torch.Tensor:
    b = state.num_brokers_padded
    flat = state.topic.long() * b + placement.broker.long()
    return segment_sum(which.to(torch.int32), flat, num_topics * b).reshape(num_topics, b)


def topic_broker_counts(state: ClusterState, placement: Placement,
                        num_topics: int) -> torch.Tensor:
    """i32[T, B]: replicas of each topic on each broker (TopicReplicaDistributionGoal)."""
    return _topic_broker(state, placement, num_topics, state.valid)


def topic_leader_counts(state: ClusterState, placement: Placement,
                        num_topics: int) -> torch.Tensor:
    """i32[T, B]: leaders of each topic on each broker (MinTopicLeadersPerBrokerGoal)."""
    return _topic_broker(state, placement, num_topics, state.valid & placement.is_leader)


def partition_rack_counts(state: ClusterState, placement: Placement, num_racks: int,
                          num_partitions: int) -> torch.Tensor:
    """i32[P, K]: replicas of each partition on each rack (rack-awareness goals)."""
    rack_of_replica = state.rack[placement.broker.long()]
    flat = state.partition.long() * num_racks + rack_of_replica.long()
    counts = segment_sum(state.valid.to(torch.int32), flat, num_partitions * num_racks)
    return counts.reshape(num_partitions, num_racks)


def partition_broker_matrix(state: ClusterState, placement: Placement,
                            num_partitions: int) -> torch.Tensor:
    """bool[P, B]: does partition p have a replica on broker b.  Dense P×B:
    small models only (tests); goals use replica-indexed forms instead."""
    b = state.num_brokers_padded
    flat = state.partition.long() * b + placement.broker.long()
    counts = segment_sum(state.valid.to(torch.int32), flat, num_partitions * b)
    return (counts > 0).reshape(num_partitions, b)


def replicas_on_same_rack(state: ClusterState, placement: Placement,
                          num_racks: int, num_partitions: int) -> torch.Tensor:
    """i32[R]: for each replica, how many *sibling* replicas of its partition
    share its rack (0 == rack-aware ok)."""
    prc = partition_rack_counts(state, placement, num_racks, num_partitions)
    rack_of_replica = state.rack[placement.broker.long()]
    return prc[state.partition.long(), rack_of_replica.long()] - 1


def partition_leader_broker(state: ClusterState, placement: Placement,
                            num_partitions: int) -> torch.Tensor:
    """i32[P]: broker index of each partition's leader (-1 if none/invalid)."""
    contrib = torch.where(state.valid & placement.is_leader, placement.broker + 1,
                          torch.zeros_like(placement.broker))
    return segment_max(contrib, state.partition, num_partitions) - 1


def partition_size(state: ClusterState, num_partitions: int) -> torch.Tensor:
    """f32[P]: disk size of one replica of each partition (max over replicas)."""
    size = torch.where(state.valid, state.leader_load[:, Resource.DISK],
                       torch.zeros((), dtype=state.leader_load.dtype,
                                   device=state.leader_load.device))
    return segment_max(size, state.partition, num_partitions)


def average_alive_utilization(state: ClusterState,
                              placement: Placement) -> torch.Tensor:
    """f32[4]: cluster-wide utilization / capacity over alive brokers (the
    baseline of the resource balance band)."""
    total_load = torch.sum(broker_load(state, placement)
                           * state.broker_valid[:, None], dim=0)
    alive = state.alive & state.broker_valid
    total_cap = torch.sum(state.capacity * alive[:, None], dim=0)
    return total_load / torch.clamp(total_cap, min=1e-9)


def utilization_matrix(state: ClusterState, placement: Placement) -> torch.Tensor:
    """f32[4, B]: per-resource utilization fraction per broker (the
    reference's ClusterModel.utilizationMatrix :1323-1357)."""
    load = broker_load(state, placement)
    return (load / torch.clamp(state.capacity, min=1e-9)).T
