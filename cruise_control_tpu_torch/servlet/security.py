"""Servlet security providers.

Reference: ``servlet/security/**`` — ``SecurityProvider`` SPI,
``DefaultRoleSecurityProvider.java:33-81`` (three roles: VIEWER →
kafka_cluster_state/user_tasks/review_board, ADMIN → bootstrap/train + every
POST, USER → the remaining GETs), ``BasicSecurityProvider`` (Jetty
HashLoginService over a ``realm.properties``-style credentials file),
``JwtSecurityProvider`` (token auth; HS256 here via stdlib hmac), and
``TrustedProxySecurityProvider`` (auth delegated to an upstream proxy that
asserts the user via header from an allow-listed address).

Everything is stdlib: the server is control-plane and must stay hermetic.

SPNEGO (``servlet/security/spnego/SpnegoSecurityProvider.java`` +
``SpnegoUserStoreAuthorizationService.java``) is implemented as Negotiate
header parsing over a PLUGGABLE ticket validator: the GSSAPI exchange itself
belongs to a Kerberos library this control plane does not vendor, so the
validator is injected (``webserver.auth.spnego.validator.class``) and the
role lookup reuses the same realm-properties user store the reference's
``UserStoreAuthorizationService`` reads.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Dict, Iterable, Optional, Protocol, Tuple


class Role(Enum):
    VIEWER = "VIEWER"
    USER = "USER"
    ADMIN = "ADMIN"


_RANK = {Role.VIEWER: 0, Role.USER: 1, Role.ADMIN: 2}

# DefaultRoleSecurityProvider.java:50-62.  compile_cache and trace ride the
# VIEWER tier like metrics: pure observability (no cluster data beyond
# shapes and phase timings).
_VIEWER_GET = {"kafka_cluster_state", "user_tasks", "review_board", "metrics",
               "compile_cache", "trace", "health", "solver_stats",
               "metrics/history", "memory", "profile"}
_ADMIN_GET = {"bootstrap", "train"}


def required_role(method: str, endpoint: str) -> Role:
    if method == "POST":
        return Role.ADMIN
    if endpoint in _ADMIN_GET:
        return Role.ADMIN
    if endpoint in _VIEWER_GET:
        return Role.VIEWER
    return Role.USER


def permits(granted: Role, required: Role) -> bool:
    return _RANK[granted] >= _RANK[required]


@dataclass
class Principal:
    name: str
    role: Role


def header_get(headers: Dict[str, str], name: str) -> Optional[str]:
    """Case-insensitive header lookup (HTTP header names are
    case-insensitive; HTTP/2 and many proxies lowercase them)."""
    lower = name.lower()
    for k, v in headers.items():
        if k.lower() == lower:
            return v
    return None


class SecurityProvider(Protocol):
    """authenticate() → Principal, or None when credentials are absent/bad."""

    def authenticate(self, headers: Dict[str, str],
                     client_ip: str) -> Optional[Principal]: ...

    def challenge(self) -> Dict[str, str]:
        """Extra headers for the 401 response."""
        ...


# ----------------------------------------------------------------- HTTP Basic


def parse_credentials_file(path: str) -> Dict[str, Tuple[str, Role]]:
    """Jetty realm.properties style: ``username: password [,ROLE]``."""
    users: Dict[str, Tuple[str, Role]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, _, rest = line.partition(":")
            parts = [p.strip() for p in rest.split(",")]
            password = parts[0]
            role = Role(parts[1].upper()) if len(parts) > 1 else Role.USER
            users[name.strip()] = (password, role)
    return users


class BasicSecurityProvider:
    """HTTP Basic over a credentials dict or realm-properties file."""

    def __init__(self, users: Optional[Dict[str, Tuple[str, Role]]] = None,
                 credentials_file: Optional[str] = None):
        if users is None and credentials_file is None:
            raise ValueError("BasicSecurityProvider needs users or a file")
        self.users = dict(users or {})
        if credentials_file:
            self.users.update(parse_credentials_file(credentials_file))

    def authenticate(self, headers: Dict[str, str],
                     client_ip: str) -> Optional[Principal]:
        auth = header_get(headers, "Authorization") or ""
        if not auth.startswith("Basic "):
            return None
        try:
            decoded = base64.b64decode(auth[6:], validate=True).decode("utf-8")
            name, _, password = decoded.partition(":")
        except (binascii.Error, UnicodeDecodeError):
            return None
        entry = self.users.get(name)
        # Compare bytes (compare_digest on str raises for non-ASCII), and
        # ALWAYS compare — an early return on unknown usernames would be a
        # timing oracle for username enumeration.
        expected = entry[0].encode() if entry else b"\x00invalid"
        ok = hmac.compare_digest(expected, password.encode())
        if entry is None or not ok:
            return None
        return Principal(name=name, role=entry[1])

    def challenge(self) -> Dict[str, str]:
        return {"WWW-Authenticate": 'Basic realm="cruise-control"'}


# ------------------------------------------------------------------------ JWT


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def make_jwt(claims: Dict, secret: str) -> str:
    """HS256 token mint (for tests and the CLI)."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


class JwtSecurityProvider:
    """Bearer-token auth (JwtSecurityProvider ~536 LoC in the reference;
    HS256-only here — the asymmetric variants belong to a deployment's
    identity provider integration)."""

    def __init__(self, secret: str, role_claim: str = "role",
                 subject_claim: str = "sub", clock=time.time):
        self.secret = secret
        self.role_claim = role_claim
        self.subject_claim = subject_claim
        self._clock = clock

    def authenticate(self, headers: Dict[str, str],
                     client_ip: str) -> Optional[Principal]:
        auth = header_get(headers, "Authorization") or ""
        if not auth.startswith("Bearer "):
            return None
        token = auth[7:].strip()
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            signing_input = f"{header_b64}.{payload_b64}".encode()
            expected = hmac.new(self.secret.encode(), signing_input,
                                hashlib.sha256).digest()
            if not hmac.compare_digest(expected, _b64url_decode(sig_b64)):
                return None
            header = json.loads(_b64url_decode(header_b64))
            if header.get("alg") != "HS256":
                return None
            claims = json.loads(_b64url_decode(payload_b64))
            # Malformed-but-signed claims (string exp from a misconfigured
            # IdP, array payload) must read as auth failure, not a crash.
            exp = claims.get("exp")
            if exp is not None and self._clock() > float(exp):
                return None
            role = Role(str(claims.get(self.role_claim, "USER")).upper())
            name = str(claims.get(self.subject_claim, "jwt-user"))
        except (ValueError, TypeError, AttributeError, binascii.Error):
            return None
        return Principal(name=name, role=role)

    def challenge(self) -> Dict[str, str]:
        return {"WWW-Authenticate": 'Bearer realm="cruise-control"'}


# -------------------------------------------------------------- trusted proxy


class TrustedProxySecurityProvider:
    """Auth asserted by an upstream proxy: the request must originate from an
    allow-listed address and carry the asserted-user header
    (TrustedProxySecurityProvider in the reference; commonly paired with
    SPNEGO at the proxy)."""

    def __init__(self, trusted_ips: Iterable[str],
                 user_header: str = "X-Forwarded-User",
                 role: Role = Role.ADMIN):
        self.trusted_ips = frozenset(trusted_ips)
        if not self.trusted_ips:
            # Fail at startup: an empty allow-list rejects every request with
            # nothing in the logs pointing at the misconfiguration.
            raise ValueError("TrustedProxySecurityProvider needs at least one "
                             "trusted ip (webserver.auth.trusted.proxy.ips)")
        self.user_header = user_header
        self.role = role

    def authenticate(self, headers: Dict[str, str],
                     client_ip: str) -> Optional[Principal]:
        if client_ip not in self.trusted_ips:
            return None
        user = header_get(headers, self.user_header)
        if not user:
            return None
        return Principal(name=user, role=self.role)

    def challenge(self) -> Dict[str, str]:
        return {}


# --------------------------------------------------------------------- SPNEGO


class SpnegoSecurityProvider:
    """Kerberos Negotiate auth (SpnegoSecurityProvider.java:36-70 +
    SpnegoUserStoreAuthorizationService.java).

    The HTTP side — ``Authorization: Negotiate <base64 GSS token>`` parsing,
    the 401 challenge, principal short-naming (``user/host@REALM`` → user,
    KerberosShortNamer's DEFAULT_TO_LOCAL rule), and user-store role lookup —
    is all here.  The cryptographic ticket validation is delegated to
    ``ticket_validator(token_bytes)``, which returns the authenticated
    principal name (optionally ``(principal, mutual_auth_token_bytes)``) or
    None/raises on a bad ticket.  Deployments supply a GSSAPI-backed
    validator; tests a fake.
    """

    def __init__(self, ticket_validator,
                 roles_by_user: Optional[Dict[str, Role]] = None,
                 credentials_file: Optional[str] = None,
                 default_role: Optional[Role] = Role.USER):
        self.ticket_validator = ticket_validator
        self.roles_by_user = dict(roles_by_user or {})
        if credentials_file:
            for name, (_pw, role) in parse_credentials_file(credentials_file).items():
                self.roles_by_user[name] = role
        # None = users absent from the store are rejected (the reference's
        # user-store authorization returns no roles → 403).
        self.default_role = default_role
        # Per-THREAD: one provider instance serves every request of a
        # ThreadingHTTPServer concurrently; a shared slot would hand one
        # request's GSS mutual-auth material to another's response.
        self._tls = threading.local()

    @staticmethod
    def short_name(principal: str) -> str:
        """``alice/admin.example.com@EXAMPLE.COM`` → ``alice``."""
        return principal.split("@", 1)[0].split("/", 1)[0]

    def authenticate(self, headers: Dict[str, str],
                     client_ip: str) -> Optional[Principal]:
        self._tls.mutual_token = None   # cleared on EVERY path, success or not
        auth = header_get(headers, "Authorization") or ""
        if not auth.startswith("Negotiate "):
            return None
        try:
            token = base64.b64decode(auth[len("Negotiate "):], validate=True)
        except binascii.Error:
            return None
        try:
            result = self.ticket_validator(token)
        except Exception:
            return None
        if isinstance(result, tuple):
            result, self._tls.mutual_token = result
        if not result:
            return None
        name = self.short_name(str(result))
        role = self.roles_by_user.get(name, self.default_role)
        if role is None:
            return None
        return Principal(name=name, role=role)

    def challenge(self) -> Dict[str, str]:
        # RFC 4559: bare challenge on 401; mutual-auth token after success is
        # attached by the caller via mutual_auth_header().
        return {"WWW-Authenticate": "Negotiate"}

    def mutual_auth_header(self) -> Dict[str, str]:
        """Success-response headers for the CURRENT thread's exchange; the
        servlet merges these into the 2xx reply (RFC 4559 §4.2)."""
        token = getattr(self._tls, "mutual_token", None)
        if token is None:
            return {}
        return {"WWW-Authenticate":
                "Negotiate " + base64.b64encode(token).decode()}
