"""resilience: retry budgets, circuit breaking, the reconnecting admin
backend, solver device failover, and the /health probe plumbing.

``configure(config)`` is called once at service build time (mirroring
obsvc): it snapshots the ``resilience.*`` config keys into a process-wide
:class:`ResilienceSettings` and materializes every ``Resilience.*`` sensor
so a scrape sees them from boot.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.resilience.circuit import (STATE_VALUE, CircuitBreaker,
                                                   CircuitState)
from cruise_control_tpu_torch.resilience.failover import (SOLVER_FAILOVER_SENSOR,
                                                        cpu_fallback,
                                                        is_device_failure)
from cruise_control_tpu_torch.resilience.reconnect import (RECONNECTS_SENSOR,
                                                     TRANSPORT_ERRORS_SENSOR,
                                                     BackendCircuitOpenError,
                                                     ReconnectingBackend)
from cruise_control_tpu_torch.resilience.retry import (RETRY_ATTEMPTS_SENSOR,
                                                 RetryBudgetExhausted,
                                                 RetryPolicy, call_with_retry)

ADMISSION_REJECTIONS_SENSOR = "Resilience.admission-rejections"
CIRCUIT_STATE_SENSOR = "Resilience.backend.circuit-state"


@dataclass(frozen=True)
class ResilienceSettings:
    retry_max_attempts: int = 4
    retry_base_delay_ms: int = 100
    retry_max_delay_ms: int = 5_000
    retry_deadline_ms: int = 30_000
    circuit_failure_threshold: int = 5
    circuit_reset_timeout_ms: int = 10_000
    reconnect_enabled: bool = True
    journal_path: str = ""
    journal_adoption_timeout_ms: int = 30_000
    health_retry_after_s: int = 30

    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy(max_attempts=self.retry_max_attempts,
                           base_delay_s=self.retry_base_delay_ms / 1000.0,
                           max_delay_s=self.retry_max_delay_ms / 1000.0,
                           deadline_s=self.retry_deadline_ms / 1000.0)

    def circuit(self, name: str = "backend") -> CircuitBreaker:
        return CircuitBreaker(
            name,
            failure_threshold=self.circuit_failure_threshold,
            reset_timeout_s=self.circuit_reset_timeout_ms / 1000.0)


_settings = ResilienceSettings()
_backend_circuit: Optional[CircuitBreaker] = None
_lock = threading.Lock()


def settings() -> ResilienceSettings:
    return _settings


def set_backend_circuit(circuit: Optional[CircuitBreaker]) -> None:
    """Publish the executor admin backend's breaker for the circuit-state
    gauge and the /health backend probe."""
    global _backend_circuit
    with _lock:
        _backend_circuit = circuit


def backend_circuit() -> Optional[CircuitBreaker]:
    with _lock:
        return _backend_circuit


def _circuit_state_value() -> int:
    cb = backend_circuit()
    return 0 if cb is None else cb.state_value()


def register_sensors() -> None:
    """Materialize the Resilience.* sensor family (idempotent)."""
    reg = registry()
    reg.counter(RETRY_ATTEMPTS_SENSOR)
    reg.counter(RECONNECTS_SENSOR)
    reg.counter(TRANSPORT_ERRORS_SENSOR)
    reg.counter(ADMISSION_REJECTIONS_SENSOR)
    reg.counter(SOLVER_FAILOVER_SENSOR)
    reg.gauge(CIRCUIT_STATE_SENSOR, _circuit_state_value)


def configure(config) -> ResilienceSettings:
    """Snapshot ``resilience.*`` keys (CruiseControlConfig mapping access)
    into the process settings and register the sensor family."""
    global _settings
    _settings = ResilienceSettings(
        retry_max_attempts=int(config["resilience.retry.max.attempts"]),
        retry_base_delay_ms=int(config["resilience.retry.base.delay.ms"]),
        retry_max_delay_ms=int(config["resilience.retry.max.delay.ms"]),
        retry_deadline_ms=int(config["resilience.retry.deadline.ms"]),
        circuit_failure_threshold=int(
            config["resilience.circuit.failure.threshold"]),
        circuit_reset_timeout_ms=int(
            config["resilience.circuit.reset.timeout.ms"]),
        reconnect_enabled=bool(
            config["resilience.backend.reconnect.enabled"]),
        journal_path=str(config["resilience.journal.path"] or ""),
        journal_adoption_timeout_ms=int(
            config["resilience.journal.adoption.timeout.ms"]),
        health_retry_after_s=int(config["resilience.health.retry.after.s"]),
    )
    register_sensors()
    return _settings


__all__ = [
    "ADMISSION_REJECTIONS_SENSOR", "CIRCUIT_STATE_SENSOR",
    "BackendCircuitOpenError", "CircuitBreaker", "CircuitState",
    "ReconnectingBackend", "ResilienceSettings", "RetryBudgetExhausted",
    "RetryPolicy", "STATE_VALUE", "backend_circuit", "call_with_retry",
    "configure", "cpu_fallback", "is_device_failure", "register_sensors",
    "set_backend_circuit", "settings",
]
