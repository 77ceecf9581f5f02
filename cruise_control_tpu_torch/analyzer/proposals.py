"""Placement diff → execution proposals.

Reference: ``analyzer/AnalyzerUtils.getDiff`` :50-117 — compare the initial
replica distribution + leadership against the optimized placement and emit
one ``ExecutionProposal`` per changed partition, new leader first.

Host-side and vectorized with numpy: one pass over the changed-partition set.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from cruise_control_tpu_torch.common.actions import (
    ExecutionProposal,
    ReplicaPlacementInfo,
    TopicPartition,
)
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.state import ClusterMeta, ClusterState, Placement


def diff_proposals(
    state: ClusterState,
    initial: Placement,
    final: Placement,
    meta: ClusterMeta,
    provenance: Optional[Dict[int, dict]] = None,
) -> List[ExecutionProposal]:
    """Proposals for every partition whose placement or leadership changed.

    ``provenance`` (execution observatory) maps partition id → the
    optimizer's per-move provenance record; when given, each proposal is
    stamped with its partition's record."""
    n = meta.num_replicas

    def host(t):
        return t.cpu().numpy()[:n]

    part = host(state.partition)
    pos = host(state.pos)
    disk_size = host(state.leader_load)[:, Resource.DISK]
    has_disks = state.disk_capacity.shape[1] > 1

    b0, b1 = host(initial.broker), host(final.broker)
    d0, d1 = host(initial.disk), host(final.disk)
    l0, l1 = host(initial.is_leader), host(final.is_leader)

    changed = (b0 != b1) | (l0 != l1) | (has_disks & (d0 != d1))
    changed_parts = np.unique(part[changed])
    if changed_parts.size == 0:
        return []

    # Group replica rows by partition, ordered by (partition, pos), and
    # compact the sorted view down to ONLY the changed partitions' rows, so
    # the Python loop below touches no unchanged partition.
    order = np.lexsort((pos, part))
    sorted_part = part[order]
    starts = np.searchsorted(sorted_part, changed_parts, side="left")
    ends = np.searchsorted(sorted_part, changed_parts, side="right")
    lengths = ends - starts
    bounds = np.zeros(part.size + 1, dtype=np.int64)
    np.add.at(bounds, starts, 1)
    np.add.at(bounds, ends, -1)
    in_seg = np.cumsum(bounds[:-1]) > 0
    sel = order[in_seg]                      # changed partitions' rows, sorted
    new_ends = np.cumsum(lengths)
    new_starts = (new_ends - lengths).tolist()
    new_ends = new_ends.tolist()

    broker_ids = np.asarray(meta.broker_ids)
    gb0 = broker_ids[b0[sel]].tolist()
    gb1 = broker_ids[b1[sel]].tolist()
    ld0 = d0[sel].tolist() if has_disks else [None] * len(sel)
    ld1 = d1[sel].tolist() if has_disks else [None] * len(sel)
    ll0 = l0[sel].tolist()
    ll1 = l1[sel].tolist()
    csize = disk_size[sel]
    pairs = np.stack([new_starts, new_ends], axis=1).ravel()
    sorted_sizes = np.append(csize, csize.dtype.type(0))
    sizes = np.maximum.reduceat(sorted_sizes, pairs)[::2].tolist()

    info_cache = {}

    def info(bid: int, dk) -> ReplicaPlacementInfo:
        key = (bid, dk)
        r = info_cache.get(key)
        if r is None:
            r = info_cache[key] = ReplicaPlacementInfo(bid, dk)
        return r

    proposals: List[ExecutionProposal] = []
    # ``rows`` below are POSITIONS into the compacted per-field lists.
    for p, s, e, size in zip(changed_parts.tolist(), new_starts, new_ends, sizes):
        rows = range(s, e)
        t_idx, p_num = meta.partitions[p]
        old_list = [info(gb0[r], ld0[r]) for r in rows]
        old_leader = next((old_list[i] for i, r in enumerate(rows) if ll0[r]),
                          old_list[0])
        lead_row = next((r for r in rows if ll1[r]), rows[0])
        new_list = ([info(gb1[lead_row], ld1[lead_row])]
                    + [info(gb1[r], ld1[r]) for r in rows if r != lead_row])
        proposals.append(ExecutionProposal(
            topic_partition=TopicPartition(meta.topics[t_idx], p_num),
            partition_size=float(size),
            old_leader=old_leader,
            old_replicas=tuple(old_list),
            new_replicas=tuple(new_list),
            provenance=provenance.get(p) if provenance else None,
        ))
    return proposals
