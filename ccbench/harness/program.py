"""The system under test: the only place, with the cache set-up in
``runner.prepare_caches``, where the benchmark calls into
``cruise_control_tpu_torch``.  It hands the program the inputs the benchmark
made and reads back the program's answers as plain numpy arrays."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def constraint(block: dict):
    """The program's ``BalancingConstraint`` from a configuration's
    ``balancing`` block (the same thresholds the reference judges by)."""
    from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
    return BalancingConstraint(**{k: np.asarray(v, dtype=np.float32) if isinstance(v, list)
                                  else v for k, v in block.items()})


def optimizer(balancing: dict, goal_names: Sequence[str]):
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    return GoalOptimizer(constraint=constraint(balancing), goal_names=list(goal_names))


def snapshot(packed: Dict[str, np.ndarray], meta_kwargs: dict, device: str):
    """(state, placement, meta) on ``device``: the packed arrays through
    ``state_from_packed`` and the identity lists into ``ClusterMeta``."""
    from cruise_control_tpu_torch.model.state import ClusterMeta, state_from_packed
    state, placement = state_from_packed(packed, device=device)
    return state, placement, ClusterMeta(**meta_kwargs)


def host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def broker_sums(state, placement, meta, balancing: dict, broker: np.ndarray,
                is_leader: np.ndarray) -> np.ndarray:
    """f64[S, B, 8]: the program's per-broker sums of each of ``S``
    placements (``broker``, ``is_leader``: [S, R] host arrays of its own
    answers), as its solver takes them at a round's start: the hand-written
    aggregate kernel's eight channels (four loads, replicas, leaders,
    potential NW-out, leader bytes-in) through ``compute_aggregates``."""
    import torch
    from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
    from cruise_control_tpu_torch.model.state import Placement

    gctx = build_context(state, placement, meta, constraint(balancing), OptimizationOptions())
    b_n = len(meta.broker_ids)
    out = np.empty((broker.shape[0], b_n, 8))
    for s in range(broker.shape[0]):
        pl = Placement(broker=torch.as_tensor(broker[s], device=state.device),
                       disk=placement.disk,
                       is_leader=torch.as_tensor(is_leader[s], device=state.device))
        agg = compute_aggregates(gctx, pl)
        sums = torch.cat([agg.broker_load, agg.replica_counts[:, None].to(torch.float32),
                          agg.leader_counts[:, None].to(torch.float32),
                          agg.potential_nw_out[:, None], agg.leader_bytes_in[:, None]], dim=1)
        out[s] = host(sums[:b_n]).astype(np.float64)
    return out
