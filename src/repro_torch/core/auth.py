"""Globus-Auth-like identity/scope layer (paper §3: "Globus Auth is used to
authenticate all interactions with Action Providers, Actions and Flows").

In-process stand-in with real semantics: tokens carry scopes; providers
declare a required scope; the flow engine validates the token before every
action invocation and fails the action (not the whole service) on a scope
mismatch — mirroring how a mis-scoped Globus token behaves.

The port's copy of ``repro/core/auth.py``, unchanged but for its imports.
"""
from __future__ import annotations

import dataclasses
import uuid
from typing import FrozenSet, Iterable


class AuthError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class Token:
    subject: str
    scopes: FrozenSet[str]
    token_id: str

    def require(self, scope: str) -> None:
        if scope not in self.scopes:
            raise AuthError(
                f"token for {self.subject!r} lacks scope {scope!r}")


class AuthService:
    """Issues and validates tokens."""

    def __init__(self) -> None:
        self._issued: dict = {}

    def issue(self, subject: str, scopes: Iterable[str]) -> Token:
        tok = Token(subject, frozenset(scopes), uuid.uuid4().hex)
        self._issued[tok.token_id] = tok
        return tok

    def validate(self, token: Token) -> None:
        if token.token_id not in self._issued:
            raise AuthError("unknown token")


SCOPE_TRANSFER = "urn:repro:transfer"
SCOPE_COMPUTE = "urn:repro:compute"
SCOPE_FLOWS = "urn:repro:flows"
