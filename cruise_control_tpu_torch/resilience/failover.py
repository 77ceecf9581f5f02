"""Solver device failover: classify device-loss errors, rerun on the CPU (the
JAX package's ``resilience/failover.py``).

A card that is lost mid-flight (an uncorrectable ECC error, a GPU fallen off
the bus, a device taken away) surfaces as a ``RuntimeError`` with the CUDA
runtime's message at the solve.  Losing the card should degrade the propose
path, not kill it: the facade catches these, reruns the solve on the CPU,
and tags the response and trace span ``degraded``, counts
``Resilience.solver-cpu-failovers`` and reports the ``/health`` device probe
degraded until the next clean solve on the card.  That counted, tagged rerun
is the only place where the port moves a solve off its device.

A fault of the port's own code is not device loss: an illegal memory
access, a misaligned address or an illegal instruction, a device-side
assert, an invalid argument, an out-of-memory error, a missing kernel image,
an ``nvcc`` failure or anything the aggregate kernel's build or launch
raises.  Those raise as they would without this module.

A CUDA error as torch raises it is judged on the runtime's own words only:
torch follows them with lines of its own on every error (a help line, the
``CUDA_LAUNCH_BLOCKING`` hint, a note on device-side assertions) whose
wording would otherwise match the markers.
"""

from __future__ import annotations

import logging
import re
from contextlib import contextmanager

LOG = logging.getLogger(__name__)

SOLVER_FAILOVER_SENSOR = "Resilience.solver-cpu-failovers"

#: Exception type names that indicate the runtime/device died (the JAX
#: package's, matched by name).
_FAILURE_TYPE_NAMES = frozenset({
    "XlaRuntimeError", "JaxRuntimeError", "DeviceLostError",
    "PjRtError", "InternalError",
})

#: Status-message markers of device loss and runtime death: the JAX
#: package's (PJRT/XLA), then the CUDA runtime's for a lost card.
_FAILURE_MARKERS = (
    "DEVICE_LOST", "device lost", "DATA_LOSS",
    "failed to enqueue", "Unable to launch",
    "Socket closed", "Connection reset",
    "TPU initialization failed", "backend_compile_and_load",
    "ABORTED: ", "UNAVAILABLE: ",
    "uncorrectable ECC error", "cudaErrorECCUncorrectable",
    "busy or unavailable", "cudaErrorDevicesUnavailable",
    "no CUDA-capable device is detected", "cudaErrorNoDevice",
    "fallen off the bus", "GPU is lost", "GPU lost",
)

#: Markers of a fault in the port's own code (or its kernel's build): never
#: device loss, whatever else the chain says.
_OWN_FAULT_MARKERS = (
    "illegal memory access", "misaligned address", "illegal instruction",
    "device-side assert", "invalid argument", "out of memory",
    "no kernel image", "nvcc", "aggregate kernel",
)


#: torch's CUDA error: ``CUDA error: <the runtime's error string>``, then its
#: own lines, of which the help line names the ``cudaError`` enum.
_CUDA_ERROR = re.compile(r"CUDA error: ([^\n]*)")
_CUDA_ERROR_NAME = re.compile(r"`(cudaError\w+)'")


def _runtime_text(msg: str) -> str:
    """What the device runtime itself said in ``msg``: for a CUDA error as
    torch formats it, the error string after ``CUDA error: `` and the enum
    name of torch's help line; any other message whole."""
    found = _CUDA_ERROR.search(msg)
    if found is None:
        return msg
    name = _CUDA_ERROR_NAME.search(msg, found.end())
    return found.group(1) if name is None else f"{found.group(1)} {name.group(1)}"


def _chain(exc: BaseException):
    seen = set()
    cur: BaseException | None = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        yield cur
        cur = cur.__cause__ or cur.__context__


def is_device_failure(exc: BaseException) -> bool:
    """True when ``exc`` (or anything in its cause chain) looks like the
    accelerator runtime died, as opposed to an application error or a fault
    of the port's own kernel."""
    chain = [(cur, _runtime_text(str(cur))) for cur in _chain(exc)]
    for cur, text in chain:
        if type(cur).__name__ == "OutOfMemoryError" or any(
                marker in text for marker in _OWN_FAULT_MARKERS):
            return False
    for cur, text in chain:
        if type(cur).__name__ in _FAILURE_TYPE_NAMES:
            return True
        if isinstance(cur, (RuntimeError, OSError)) and any(
                marker in text for marker in _FAILURE_MARKERS):
            return True
    return False


@contextmanager
def cpu_fallback():
    """The body's solve runs on the device this yields, the CPU: the caller
    refreezes its model there (the aggregate's plain version then serves it,
    because its tensors lie on the CPU)."""
    import torch
    yield torch.device("cpu")
