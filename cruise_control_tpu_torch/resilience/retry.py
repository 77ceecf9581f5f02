"""Retry with jittered exponential backoff under a total deadline budget.

Reference posture: the reference Cruise Control leans on the Kafka admin
client's built-in retries; our admin protocol is a bare JSON-lines socket,
so the retry economics live here instead.  A ``RetryPolicy`` is pure data
(safe to share across threads); ``call_with_retry`` is the single execution
engine, injectable clock/sleep for deterministic tests.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type, TypeVar

from cruise_control_tpu_torch.common.metrics import registry

LOG = logging.getLogger(__name__)

T = TypeVar("T")

RETRY_ATTEMPTS_SENSOR = "Resilience.retry-attempts"


class RetryBudgetExhausted(RuntimeError):
    """Every attempt failed (count or deadline); ``__cause__`` is the last
    underlying error."""


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff bounded by attempts AND wall-clock.

    ``deadline_s`` is a *budget across the whole retry cycle*: a sleep that
    would overrun it is not taken — the cycle fails early rather than
    blocking a caller (the executor's progress loop) past its patience.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.5            # ± fraction of the computed delay
    deadline_s: float = 30.0

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        raw = min(self.max_delay_s,
                  self.base_delay_s * (self.multiplier ** attempt))
        if self.jitter > 0.0:
            raw *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, raw)


def call_with_retry(
    fn: Callable[[], T],
    policy: Optional[RetryPolicy] = None,
    *,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    name: str = "call",
    rng: Optional[random.Random] = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
) -> T:
    """Run ``fn`` under ``policy``; raise :class:`RetryBudgetExhausted` when
    the attempt count or the deadline budget runs out.

    Exceptions not listed in ``retry_on`` propagate immediately — the
    circuit breaker's open signal rides this path so a tripped circuit is
    never retried against.
    """
    policy = policy or RetryPolicy()
    rng = rng or random.Random()
    attempts_sensor = registry().counter(RETRY_ATTEMPTS_SENSOR)
    deadline = clock() + policy.deadline_s
    last: Optional[BaseException] = None
    for attempt in range(max(1, policy.max_attempts)):
        try:
            return fn()
        except retry_on as exc:          # noqa: PERF203 — retry loop
            last = exc
            attempts_sensor.inc()
            delay = policy.delay_s(attempt, rng)
            if attempt + 1 >= policy.max_attempts:
                break
            if clock() + delay > deadline:
                LOG.debug("%s: deadline budget (%.1fs) exhausted after "
                          "attempt %d", name, policy.deadline_s, attempt + 1)
                break
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            LOG.debug("%s failed (attempt %d/%d: %s); retrying in %.3fs",
                      name, attempt + 1, policy.max_attempts, exc, delay)
            sleep(delay)
    raise RetryBudgetExhausted(
        f"{name} failed after {policy.max_attempts} attempt(s) "
        f"within {policy.deadline_s:.1f}s: {last}") from last
