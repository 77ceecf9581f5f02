"""Backend selection guards (the JAX package's ``utils/hermetic.py``).

- :func:`force_cpu` keeps a process off every card: it hides the CUDA devices
  before torch initializes CUDA (dry runs, tests on a machine with a card).
  Nothing on the service's path calls it.
- :func:`probe_cuda` asks a throwaway subprocess whether CUDA initializes, so
  a wedged CUDA stack cannot hang the caller.
- :func:`enable_persistent_compilation_cache` activates the persistent
  kernel-build cache at a root of the caller's (default per-user), so later
  processes load the aggregate kernel's library instead of running ``nvcc``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional


def force_cpu() -> None:
    """Hide every CUDA device from this process.  Must run before torch
    initializes CUDA (the first ``torch.cuda`` call that touches a device);
    raises if it already has, since hiding devices then changes nothing."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("force_cpu() after CUDA was initialized: the devices "
                           "stay visible to this process")


def probe_cuda(timeout_s: float = 180.0) -> bool:
    """True iff ``torch.cuda.is_available()`` holds in a throwaway
    subprocess within ``timeout_s``.  CUDA initialization can hang or
    raise; probing out of process with a timeout keeps the caller alive
    either way."""
    if os.environ.get("CUDA_VISIBLE_DEVICES") == "":
        return False
    try:
        probe = subprocess.run(
            [sys.executable, "-c",
             "import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)"],
            timeout=timeout_s, capture_output=True)
        return probe.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


def enable_persistent_compilation_cache(path: Optional[str] = None) -> bool:
    """Build and load the aggregate kernel's library under the persistent
    kernel-build cache rooted at ``path`` (default its per-user root, not a
    predictable shared ``/tmp`` name a co-tenant could pre-create), so
    repeat runs skip ``nvcc``.  This is the cache's own activation, with its
    versioned keys; it takes effect only before this process loads the
    library, and is off on a process without a card.  Returns True when the
    entry already holds a library ("warm") so callers can annotate timing
    artifacts."""
    from cruise_control_tpu_torch.compilesvc.cache import PersistentCompileCache

    return PersistentCompileCache(root=path, enabled=True).activate()
