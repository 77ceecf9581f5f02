"""Fake GSS ticket validator for SPNEGO tests.

Stands in for a deployment's GSSAPI-backed validator behind
``webserver.auth.spnego.validator.class`` (see
``servlet/security.SpnegoSecurityProvider``).  Accepts tokens of the form
``b"principal:<name>"`` and returns ``<name>``; everything else raises.
"""

from __future__ import annotations


class FakeGssValidator:
    def __call__(self, token: bytes):
        if token.startswith(b"principal:"):
            return token[len(b"principal:"):].decode("utf-8")
        raise ValueError("bad ticket")
