"""``POST /profile`` backing: one-shot ``torch.profiler`` capture windows.

The JAX package's ``obsvc/profiler.py`` wraps ``jax.profiler``; the port
opens a ``torch.profiler.profile`` window instead (host activity, plus the
card's kernels and copies where CUDA is available) and writes a Chrome
trace of it per capture: ``<trace.profile.dir>/profile-<epoch_ms>/trace.json``.
Open it in Perfetto or ``chrome://tracing``.  The contract is the JAX
module's: a non-reentrant lock (the profiler is a process singleton —
overlapping captures abort), and two entry points sharing it:

* :func:`capture` — synchronous (scripts, tests): block through the
  window, return the trace dir.
* :func:`start_async` — ``POST /profile``: open the window on a daemon
  thread and return immediately; :func:`status` is the pollable
  busy/done/trace_dir view backing ``GET /profile``.  A second start
  while a window is open (either entry point) raises
  :class:`ProfileInProgress` — the 409 contract.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional

MAX_DURATION_S = 600.0
TRACE_FILE = "trace.json"

_LOCK = threading.Lock()
_DEFAULT_DIR: Optional[str] = None
# Last/current async capture, guarded by _STATE_LOCK: {"busy", "done",
# "trace_dir", "duration_s", "started_ms", "error"}.
_STATE_LOCK = threading.Lock()
_ASYNC_STATE: Dict[str, Any] = {}


class ProfileInProgress(RuntimeError):
    """A capture window is already open (the profiler is a singleton)."""


def configure(profile_dir: str) -> None:
    global _DEFAULT_DIR
    _DEFAULT_DIR = profile_dir or None
    with _STATE_LOCK:
        _ASYNC_STATE.clear()


def default_dir() -> str:
    if _DEFAULT_DIR:
        return _DEFAULT_DIR
    return os.path.join(tempfile.gettempdir(), "cruise_control_tpu_torch_profiles")


def _check_duration(duration_s: float) -> None:
    if not (0.0 < duration_s <= MAX_DURATION_S):
        raise ValueError(
            f"duration_s must be in (0, {MAX_DURATION_S:g}], "
            f"got {duration_s!r}")


def _capture_locked(duration_s: float, trace_dir: str) -> None:
    """Run one capture window and write its Chrome trace; caller holds
    ``_LOCK``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        time.sleep(duration_s)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


def capture(duration_s: float,
            out_dir: Optional[str] = None) -> Dict[str, Any]:
    """Block for ``duration_s`` while the profiler records host and device
    activity, then return the trace directory."""
    _check_duration(duration_s)
    if not _LOCK.acquire(blocking=False):
        raise ProfileInProgress("a profile capture is already running")
    try:
        trace_dir = os.path.join(out_dir or default_dir(),
                                 f"profile-{int(time.time() * 1000)}")
        _capture_locked(duration_s, trace_dir)
        return {"trace_dir": trace_dir, "duration_s": duration_s}
    finally:
        _LOCK.release()


def start_async(duration_s: float,
                out_dir: Optional[str] = None) -> Dict[str, Any]:
    """Open a capture window on a daemon thread and return immediately
    (the ``POST /profile`` 202 path).  Raises :class:`ProfileInProgress`
    while any window — sync or async — is open."""
    _check_duration(duration_s)
    if not _LOCK.acquire(blocking=False):
        raise ProfileInProgress("a profile capture is already running")
    # _LOCK is held from here until the worker releases it: status() and
    # further starts see busy for the whole window.
    trace_dir = os.path.join(out_dir or default_dir(),
                             f"profile-{int(time.time() * 1000)}")
    with _STATE_LOCK:
        _ASYNC_STATE.clear()
        _ASYNC_STATE.update(busy=True, done=False, trace_dir=trace_dir,
                            duration_s=duration_s,
                            started_ms=int(time.time() * 1000), error=None)

    def worker():
        error = None
        try:
            _capture_locked(duration_s, trace_dir)
        except Exception as e:   # noqa: BLE001 — surfaced via status()
            error = f"{type(e).__name__}: {e}"
        finally:
            # State first, lock second: a new start_async can only win the
            # lock after this capture's outcome is recorded.
            with _STATE_LOCK:
                _ASYNC_STATE.update(busy=False, done=error is None,
                                    error=error)
            _LOCK.release()

    threading.Thread(target=worker, name="profile-capture",
                     daemon=True).start()
    return {"trace_dir": trace_dir, "duration_s": duration_s}


def status() -> Dict[str, Any]:
    """Pollable capture state for ``GET /profile``: ``busy`` while any
    window is open, plus the last async capture's outcome."""
    with _STATE_LOCK:
        state = dict(_ASYNC_STATE)
    state.setdefault("busy", False)
    state.setdefault("done", False)
    state.setdefault("trace_dir", None)
    # A synchronous capture() also holds the singleton lock; report it.
    if not state["busy"] and _LOCK.locked():
        state["busy"] = True
    return state
