"""Reconnecting admin backend: a poisoned transport is rebuilt, not fatal.

``SubprocessClusterBackend``/``SocketClusterBackend`` deliberately poison
themselves on any framing desync — correct for protocol safety, but it made
every transport hiccup terminal for the whole execution.  This wrapper owns
a *factory* (the transport constructors do not retain their connect
parameters) and rebuilds the inner backend under the retry policy whenever
a call raises :class:`BackendTransportError`.

Safety argument for retrying admin ops: every protocol op is idempotent at
the peer (reassignments are keyed by (topic, partition); re-submitting an
in-flight one is a no-op; ``is_done``/``list``/``describe`` are reads), and
after every reconnect the wrapper re-polls ``in_progress_reassignments()``
so the caller's view re-anchors on what the cluster is actually still
doing (exposed as ``last_repoll``).

When the circuit breaker trips, calls fail fast with
:class:`BackendCircuitOpenError` — a subclass of ``BackendTransportError``
so existing handlers still degrade gracefully, but distinct so the executor
can *pause* (``PAUSED_BACKEND_DOWN``) instead of letting tasks rot to the
alert timeout.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional, Set, Tuple

from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.executor.subprocess_backend import (
    BackendCircuitOpenError, BackendTransportError, SubprocessClusterBackend)
from cruise_control_tpu_torch.resilience.circuit import CircuitBreaker, CircuitState
from cruise_control_tpu_torch.resilience.retry import (RetryBudgetExhausted,
                                                 RetryPolicy, call_with_retry)

LOG = logging.getLogger(__name__)

RECONNECTS_SENSOR = "Resilience.backend.reconnects"
TRANSPORT_ERRORS_SENSOR = "Resilience.backend.transport-errors"


class ReconnectingBackend:
    """ClusterAdminBackend that survives transport death.

    ``factory`` must return a *connected* transport backend each call (a
    closure over host/port/auth — the transports don't store them).  The
    wrapper connects lazily: construction never touches the network, so the
    service can boot while its admin peer is down and report it via
    ``/health`` instead of crashing.
    """

    def __init__(self, factory: Callable[[], SubprocessClusterBackend], *,
                 policy: Optional[RetryPolicy] = None,
                 circuit: Optional[CircuitBreaker] = None,
                 name: str = "backend") -> None:
        self._factory = factory
        self._policy = policy or RetryPolicy()
        self.circuit = circuit or CircuitBreaker(name)
        self.name = name
        self._lock = threading.RLock()
        self._inner: Optional[SubprocessClusterBackend] = None
        self._ever_connected = False
        self.last_repoll: Optional[Set[Tuple[str, int]]] = None
        reg = registry()
        self._sensor_reconnects = reg.counter(RECONNECTS_SENSOR)
        self._sensor_transport_errors = reg.counter(TRANSPORT_ERRORS_SENSOR)

    # -- connection management --------------------------------------------

    def inner_backend(self) -> Optional[SubprocessClusterBackend]:
        """The live transport, if any (test/introspection surface)."""
        with self._lock:
            return self._inner

    def _ensure(self) -> SubprocessClusterBackend:
        with self._lock:
            if self._inner is None:
                inner = self._factory()
                # Idempotent re-anchor: what is the cluster still doing?
                self.last_repoll = set(inner.in_progress_reassignments())
                self._inner = inner
                if self._ever_connected:
                    self._sensor_reconnects.inc()
                    LOG.info("admin backend %s reconnected; %d reassignments "
                             "still in progress at the peer", self.name,
                             len(self.last_repoll))
                self._ever_connected = True
            return self._inner

    def _discard(self) -> None:
        with self._lock:
            inner, self._inner = self._inner, None
        if inner is not None:
            try:
                # _poison closes the transport without the shutdown
                # handshake close() performs (the peer outlives us).
                inner._poison("discarded by reconnecting wrapper")
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    # -- call engine -------------------------------------------------------

    def _call(self, method: str, *args, **kwargs):
        def attempt():
            if not self.circuit.allow():
                raise BackendCircuitOpenError(
                    f"admin backend '{self.name}' circuit "
                    f"{self.circuit.state.value}")
            try:
                inner = self._ensure()
            except (BackendTransportError, OSError, ConnectionError) as exc:
                self._sensor_transport_errors.inc()
                self.circuit.record_failure()
                self._discard()
                raise BackendTransportError(
                    f"reconnect to admin backend failed: {exc}") from exc
            try:
                result = getattr(inner, method)(*args, **kwargs)
            except BackendTransportError:
                self._sensor_transport_errors.inc()
                self.circuit.record_failure()
                self._discard()
                raise
            self.circuit.record_success()
            return result

        try:
            return call_with_retry(
                attempt, self._policy,
                retry_on=(BackendTransportError,),
                name=f"backend.{method}")
        except BackendCircuitOpenError:
            raise
        except RetryBudgetExhausted as exc:
            if self.circuit.state is CircuitState.OPEN:
                raise BackendCircuitOpenError(
                    f"admin backend '{self.name}' circuit open "
                    f"after retries: {exc}") from exc
            raise BackendTransportError(str(exc)) from exc

    def probe(self) -> bool:
        """One recovery attempt within the circuit's half-open budget.
        Used by the paused executor; True means the backend answered and
        the circuit re-closed."""
        if not self.circuit.allow():
            return False
        try:
            inner = self._ensure()
            self.last_repoll = set(inner.in_progress_reassignments())
        except (BackendTransportError, OSError, ConnectionError):
            self._sensor_transport_errors.inc()
            self.circuit.record_failure()
            self._discard()
            return False
        self.circuit.record_success()
        return True

    # -- ClusterAdminBackend protocol --------------------------------------

    def execute_replica_reassignments(self, tasks) -> None:
        self._call("execute_replica_reassignments", tasks)

    def execute_logdir_moves(self, tasks) -> None:
        self._call("execute_logdir_moves", tasks)

    def execute_preferred_leader_election(self, tasks) -> None:
        self._call("execute_preferred_leader_election", tasks)

    def in_progress_reassignments(self) -> Set[Tuple[str, int]]:
        return self._call("in_progress_reassignments")

    def finished(self, task) -> bool:
        # raise_transport_errors so the executor can tell "backend down"
        # (pause) apart from "not finished yet" (keep polling).
        return self._call("finished", task, raise_transport_errors=True)

    def offline_logdirs(self):
        return self._call("offline_logdirs")

    def set_throttles(self, *args, **kwargs) -> None:
        self._call("set_throttles", *args, **kwargs)

    def clear_throttles(self) -> None:
        self._call("clear_throttles")

    # -- pass-through conveniences (sim control, tests) --------------------

    def request(self, op: str, **kwargs):
        return self._call("request", op, **kwargs)

    def describe_topics(self):
        return self._call("describe_topics")

    def close(self) -> None:
        with self._lock:
            inner, self._inner = self._inner, None
        if inner is not None:
            try:
                inner.close()
            except Exception:  # noqa: BLE001 — peer may already be gone
                pass
