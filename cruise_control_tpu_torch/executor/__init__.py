"""Executor: applies optimization proposals to the live cluster (the JAX
package's ``executor/``).

Reference: ``executor/Executor.java:73-1545`` and its task-management
satellites.  All host-side control logic (no device work: this layer
throttles the managed cluster, not compute); the cluster-facing operations go
through a pluggable admin backend (fake in tests, a Kafka driver in
deployments) the way the reference splits Executor from
ExecutorUtils.scala/ExecutorAdminUtils.

The names below resolve on first use, so that importing a submodule alone
(``python -m cruise_control_tpu_torch.executor.broker_simulator``, a separate
process) loads neither the executor nor torch.
"""

import importlib

_EXPORTS = {
    "ExecutionTask": "tasks",
    "ExecutionTaskState": "tasks",
    "ExecutionTaskTracker": "tasks",
    "ExecutionTaskPlanner": "planner",
    "Executor": "executor",
    "ExecutorState": "executor",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
