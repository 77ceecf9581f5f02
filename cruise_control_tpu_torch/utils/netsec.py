"""Shared TLS context construction for the framework's TCP faces.

One canonical copy of the client/server SSL setup used by the metrics bus
(``reporter/transport.py``), the admin driver (``executor/
subprocess_backend.py``) and the admin listener (``executor/
broker_simulator.py``) — a hardening change (minimum version, cipher policy,
hostname rules) lands everywhere at once instead of drifting per copy.
Import-light on purpose: the broker simulator must keep starting in
milliseconds.
"""

from __future__ import annotations

from typing import Optional


def read_secret_file(path: str, what: str = "secret") -> str:
    """One canonical read-and-strip for every shared-secret file the
    framework's faces consume (metrics bus, admin driver, maintenance bus,
    simulator listener) — a missing or empty file fails with a clear error
    instead of a raw traceback at assembly time."""
    try:
        with open(path) as f:
            secret = f.read().strip()
    except OSError as e:
        raise ValueError(f"cannot read {what} file {path!r}: {e}") from e
    if not secret:
        raise ValueError(f"{what} file {path!r} is empty")
    return secret


def client_ssl_context(cafile: Optional[str] = None):
    """TLS context for a framework client connection.

    With ``cafile`` the peer's chain is verified against it (typically the
    peer's own self-signed cert — a pin).  Hostname checking is off either
    way: these private endpoints are addressed by IP:port, not by the
    cert's DNS name, so the CA pin is the trust anchor.  Without ``cafile``
    the link is encrypted but unverified — an explicit opt-in for
    demo/test topologies.
    """
    import ssl

    if cafile:
        ctx = ssl.create_default_context(cafile=cafile)
        ctx.check_hostname = False
    else:
        # Public-API equivalent of the former ssl._create_unverified_context()
        # call: encrypted-but-unverified, built from documented knobs only
        # (the private helper's behavior is not a stable contract across
        # Python releases).
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


def server_ssl_context(certfile: str, keyfile: Optional[str] = None):
    """TLS context for a framework listener (PEM chain + key, the same
    config shape as the web server's webserver.ssl.* keys)."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile or None)
    return ctx
