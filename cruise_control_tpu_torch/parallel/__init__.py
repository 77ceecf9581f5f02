"""Multi-process solves: the solver's process mesh and sharding rules
(:mod:`.mesh`) and the multi-process entry points (:mod:`.multihost`)."""

from cruise_control_tpu_torch.parallel.mesh import (
    SolverMesh,
    make_solver_mesh,
    replica_shardings,
    scenario_shardings,
)

__all__ = ["SolverMesh", "make_solver_mesh", "replica_shardings", "scenario_shardings"]
