"""Multi-process solver execution (the JAX package's ``parallel/multihost.py``).

The JAX package assembles every process's chips into one global
``jax.sharding.Mesh`` and lets XLA insert the cross-host collectives.  Here
every process is one rank of ``torch.distributed``'s default process group
(NCCL between cards, gloo on the CPU), the solver's mesh
(:mod:`~cruise_control_tpu_torch.parallel.mesh`) lays the ranks out, and
the solver issues the collectives itself.

Deployment contract (standard SPMD), as in the JAX package:

- every process runs the same program and calls :func:`propose_multihost`
  with a snapshot of the SAME padded shapes AND the same ``meta`` (names and
  ids, resolved process-locally when proposals are assembled; it is not
  broadcast);
- the coordinator's tensor content wins: (state, placement) are broadcast
  from rank 0 before the solve, so workers may pass placeholder content
  (zeros of the agreed size class);
- every process receives the identical result.

One rank per card: with NCCL, rank ``process_id`` runs on card
``process_id % torch.cuda.device_count()``.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from cruise_control_tpu_torch.parallel.mesh import broadcast, make_solver_mesh


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               heartbeat_timeout_s: Optional[float] = None,
               device="cuda") -> None:
    """Join this process to the default process group, at init method
    ``tcp://<coordinator_address>`` (``host:port`` of rank 0).  The backend
    is NCCL for a CUDA ``device`` and gloo for the CPU.  A repeat call with a
    group already up does nothing (callers may share one bootstrap path).

    ``heartbeat_timeout_s`` bounds how long a collective waits on a peer
    (the group's ``timeout``): when a process dies, a survivor's next
    collective raises instead of hanging (gloo sees the closed connection at
    once; NCCL's watchdog aborts the process after the timeout).  None keeps
    torch's default."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.index is None:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kwargs = {}
    if heartbeat_timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(heartbeat_timeout_s))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)


def global_solver_mesh(scenario_parallelism: int = 1):
    """Solver mesh over every rank of the default group (call after
    :func:`initialize`; with one process it is a one-rank mesh)."""
    return make_solver_mesh(scenario_parallelism=scenario_parallelism)


def _from_rank0(x):
    if not isinstance(x, torch.Tensor):
        return x
    if x.dtype == torch.bool:       # gloo and NCCL differ on bool: move u8
        return broadcast(x.to(torch.uint8), 0).to(torch.bool)
    return broadcast(x.clone(), 0)


def broadcast_from_coordinator(tree):
    """Every tensor of ``tree`` (dataclasses, tuples and lists of them) with
    rank 0's content, as new tensors (shapes and dtypes must already agree:
    the SPMD contract above).  The identity with one rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: broadcast_from_coordinator(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(broadcast_from_coordinator(x) for x in tree)
    return _from_rank0(tree)


def propose_multihost(state, placement, meta, goal_names: Optional[Sequence[str]] = None,
                      constraint=None, scenario_parallelism: int = 1,
                      polish_passes: int = 1):
    """One full proposal generation on the global mesh.

    All processes must call this with same-shaped (state, placement) and an
    IDENTICAL meta (see the module contract); rank 0's content is broadcast,
    the goal stack solves sharded over the replica axis, and every process
    returns the identical ``OptimizerResult``."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer

    state, placement = broadcast_from_coordinator((state, placement))
    opt = GoalOptimizer(constraint=constraint, goal_names=goal_names,
                        mesh=global_solver_mesh(scenario_parallelism),
                        polish_passes=polish_passes)
    return opt.optimizations(state, placement, meta)


def batch_remove_scenarios_multihost(state, placement, meta, scenario_sets,
                                     goal_names: Optional[Sequence[str]] = None,
                                     constraint=None,
                                     scenario_parallelism: int = 2,
                                     num_candidates: int = 512):
    """Remove-broker what-if batch on the global mesh: lanes split over the
    scenario axis, each lane's reductions over the replica axis.  Same SPMD
    contract as :func:`propose_multihost`; every process returns the
    identical ``BatchScenarioResult``."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer

    state, placement = broadcast_from_coordinator((state, placement))
    opt = GoalOptimizer(constraint=constraint, goal_names=goal_names,
                        mesh=global_solver_mesh(scenario_parallelism))
    return opt.batch_remove_scenarios(state, placement, meta, scenario_sets,
                                      num_candidates=num_candidates)
