"""Operation audit log.

A dedicated ``cruise_control_tpu_torch.operations`` logger recording every
state-changing operation the service performs — one line per lifecycle
event, machine-grep-able ``key=value`` pairs:

    op=start task=<uuid> principal=<who> endpoint=<ep> params=<query>
    op=finish task=<uuid> ... partial=true
    op=abort task=<uuid> ... reason=user
    op=preempted task=<uuid> ... reason=deadline

Wired at the three places state changes originate:

- servlet user-task dispatch (task created / finished / aborted / preempted),
- executor batch start/finish (proposal execution actually touching the
  cluster),
- anomaly-fix dispatch (self-healing operations nobody asked for have the
  highest audit value).

Operators route it independently of the service log (it propagates to the
root handlers by default; attach a handler to ``cruise_control_tpu_torch.operations``
to split it out).  The principal rides a contextvar set by the servlet's
auth gate, so deeply nested call sites never thread it explicitly.
"""

from __future__ import annotations

import logging
from contextvars import ContextVar

OPLOG = logging.getLogger("cruise_control_tpu_torch.operations")

# Outcomes a record may carry (the contract documented in OPERATIONS.md).
OUTCOMES = ("start", "finish", "abort", "preempted")

_principal: ContextVar[str] = ContextVar("cc_operation_principal",
                                         default="anonymous")


def set_principal(name: str):
    """Bind the authenticated principal for this request context; returns
    the contextvar token (callers may reset, but request-scoped contexts
    are discarded wholesale so most never need to)."""
    return _principal.set(name or "anonymous")


def current_principal() -> str:
    return _principal.get()


# Request correlation: the servlet binds the request's X-Request-ID here
# (minted when absent), and the UserTaskManager worker inherits it via
# contextvars.copy_context() — so the executor can label its batch span,
# journal batch_start line, and flight-recorder batch with the request that
# asked for the moves (the multi-tenant attribution hook).
_request_id: ContextVar[str | None] = ContextVar("cc_operation_request_id",
                                                 default=None)


def set_request_id(request_id: str | None):
    """Bind the correlation id for this request context; returns the
    contextvar token."""
    return _request_id.set(request_id or None)


def current_request_id() -> str | None:
    return _request_id.get()


def _fmt(value) -> str:
    s = str(value)
    # One event per line is the whole point — never let a value break it.
    s = s.replace("\n", "\\n").replace("\r", "")
    if " " in s or s == "":
        return '"%s"' % s.replace('"', "'")
    return s


def record(outcome: str, *, task_id: str = "-", endpoint: str = "-",
           params: str = "", principal: str | None = None, **extra) -> None:
    """Emit one operation event.  ``outcome`` is one of :data:`OUTCOMES`;
    ``extra`` key=value pairs (reason=, executed=, anomaly=, ...) append in
    sorted order so lines diff stably."""
    if outcome not in OUTCOMES:
        raise ValueError(f"unknown operation outcome {outcome!r}")
    fields = {
        "op": outcome,
        "task": task_id or "-",
        "principal": principal if principal is not None else _principal.get(),
        "endpoint": endpoint,
        "params": params,
    }
    fields.update({k: v for k, v in sorted(extra.items()) if v is not None})
    OPLOG.info(" ".join(f"{k}={_fmt(v)}" for k, v in fields.items()))
