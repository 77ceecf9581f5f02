"""Warmup daemon: run the configured goal stack's bucket set at startup, in
the background (the JAX package's ``compilesvc/warmup.py``, copied as it is).

Warm tasks run real solves (dryrun proposals, a minimal what-if batch) at
exactly the canonical bucket shapes, ahead of the first user request.  In the
port they build and load the aggregate kernel, fill the solver's executable
families and the cost ledger's rows, and seed the resident model, so the
first operator request starts warm.

Threading follows the facade's precompute loop: a NON-daemon thread (a
daemon thread killed inside a device call can abort the interpreter) that
between tasks polls both its stop event and main-thread liveness, so
interpreter shutdown is never held hostage by a long warmup queue — at
worst one in-flight task finishes.

Idempotent: each task carries a key; a key already warmed is skipped, so
re-running ``start()`` (or re-adding the same bucket set) costs nothing.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Set, Tuple

LOG = logging.getLogger(__name__)


class WarmupDaemon:
    def __init__(self, name: str = "compile-warmup"):
        self._name = name
        self._lock = threading.Lock()
        self._tasks: List[Tuple[Hashable, Callable[[], None]]] = []
        self._warmed: Set[Hashable] = set()
        self._errors: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._state = "idle"            # idle -> running -> done|stopped
        self._started_at: Optional[float] = None
        self._finished_at: Optional[float] = None

    # ------------------------------------------------------------- tasks

    def add_task(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Queue one warm task.  ``key`` identifies the executable family
        (stack hash + bucket); duplicate keys run at most once ever."""
        with self._lock:
            self._tasks.append((key, fn))

    def warmed_keys(self) -> Set[Hashable]:
        with self._lock:
            return set(self._warmed)

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Start (or restart after completion) the background warmer.
        Idempotent while running; already-warmed keys never re-run."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._state = "running"
            self._started_at = time.time()
            self._finished_at = None
            self._thread = threading.Thread(
                target=self._run, name=self._name, daemon=False)
            self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def should_abort(self) -> bool:
        """Public abort probe for long-running warm tasks (e.g. a task
        waiting for the load monitor's first completed window polls this so
        shutdown is never held hostage by the wait)."""
        return self._stop.is_set() or not threading.main_thread().is_alive()

    _should_abort = should_abort

    def _run(self) -> None:
        idx = 0
        while True:
            if self._should_abort():
                with self._lock:
                    self._state = "stopped"
                    self._finished_at = time.time()
                return
            with self._lock:
                if idx >= len(self._tasks):
                    break
                key, fn = self._tasks[idx]
                skip = key in self._warmed
            idx += 1
            if skip:
                continue
            try:
                t0 = time.monotonic()
                fn()
                LOG.info("warmup %s: %s in %.2fs", self._name, key,
                         time.monotonic() - t0)
                with self._lock:
                    self._warmed.add(key)
            except Exception as e:   # noqa: BLE001 — warmup must never crash
                LOG.warning("warmup task %s failed: %s", key, e)
                with self._lock:
                    self._errors.append(f"{key}: {e}")
        with self._lock:
            self._state = "done"
            self._finished_at = time.time()

    # ------------------------------------------------------------- admin

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "state": self._state,
                "tasks": len(self._tasks),
                "warmed": len(self._warmed),
                "errors": list(self._errors),
                "started_at": self._started_at,
                "finished_at": self._finished_at,
            }
