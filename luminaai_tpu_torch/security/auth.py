"""Authentication & session management.

Covers the reference SecurityManager (ref: Src/Main_Scripts/security/
auth.py:33 — salted password hashing, session tokens with expiry,
failed-attempt lockout, per-IP auth rate limiting, permission checks).
Design here: PBKDF2-HMAC-SHA256 with per-user salt, HMAC-signed opaque
session tokens (no server-side token table needed to reject forgeries),
monotonic-clock lockout windows, constant-time comparisons throughout.

The port's copy of luminaai_tpu/security/auth.py (standard library only).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import secrets
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

PBKDF2_ITERATIONS = 600_000
SALT_BYTES = 16
TOKEN_BYTES = 32

ANON_TENANT = "anon"


def tenant_hash(identity: Optional[str]) -> str:
    """Stable, non-reversible tenant label for telemetry and wide
    events: sha256 of the authenticated identity (username / API key),
    truncated to 12 hex chars. Raw identities must never become metric
    labels or event fields — /metrics and flightrec dumps travel to
    places the user database does not. None/empty (unauthenticated
    requests) map to the shared "anon" tenant."""
    if not identity:
        return ANON_TENANT
    return hashlib.sha256(str(identity).encode()).hexdigest()[:12]


@dataclass
class User:
    """Account record (ref auth.py:16)."""

    username: str
    password_hash: str
    salt: str
    permissions: List[str] = field(default_factory=lambda: ["chat"])
    created_at: float = field(default_factory=time.time)
    failed_attempts: int = 0
    locked_until: float = 0.0
    last_login: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class Session:
    token_id: str
    username: str
    permissions: List[str]
    created_at: float
    expires_at: float
    client_ip: str = ""


class SecurityManager:
    """Users, sessions, lockout, auth-attempt rate limiting (ref auth.py:33)."""

    def __init__(
        self,
        max_failed_attempts: int = 5,
        lockout_seconds: float = 300.0,
        session_ttl_seconds: float = 3600.0,
        auth_rate_limit: int = 10,
        auth_rate_window: float = 60.0,
        min_password_length: int = 8,
        persist_path: Optional[str] = None,
        secret_key: Optional[bytes] = None,
    ):
        self.max_failed_attempts = max_failed_attempts
        self.lockout_seconds = lockout_seconds
        self.session_ttl = session_ttl_seconds
        self.auth_rate_limit = auth_rate_limit
        self.auth_rate_window = auth_rate_window
        self.min_password_length = min_password_length
        self.persist_path = Path(persist_path) if persist_path else None
        self._secret = secret_key or secrets.token_bytes(32)
        self.users: Dict[str, User] = {}
        self.sessions: Dict[str, Session] = {}
        self._auth_events: Dict[str, List[float]] = {}
        self.audit_log: List[Dict[str, Any]] = []
        if self.persist_path and self.persist_path.exists():
            self._load()

    # -- password primitives (ref auth.py:56) ------------------------------
    @staticmethod
    def _hash_password(password: str, salt: str) -> str:
        return hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(salt),
            PBKDF2_ITERATIONS,
        ).hex()

    def _validate_username(self, username: str) -> bool:
        return (
            3 <= len(username) <= 64
            and username.replace("_", "").replace("-", "").isalnum()
        )

    def _validate_password(self, password: str) -> bool:
        if len(password) < self.min_password_length:
            return False
        has_alpha = any(c.isalpha() for c in password)
        has_digit = any(c.isdigit() for c in password)
        return has_alpha and has_digit

    # -- accounts (ref auth.py:69) -----------------------------------------
    def create_user(
        self,
        username: str,
        password: str,
        permissions: Optional[List[str]] = None,
    ) -> bool:
        if not self._validate_username(username):
            self._audit("create_user_rejected", username, "bad username")
            return False
        if not self._validate_password(password):
            self._audit("create_user_rejected", username, "weak password")
            return False
        if username in self.users:
            self._audit("create_user_rejected", username, "exists")
            return False
        salt = secrets.token_bytes(SALT_BYTES).hex()
        self.users[username] = User(
            username=username,
            password_hash=self._hash_password(password, salt),
            salt=salt,
            permissions=list(permissions or ["chat"]),
        )
        self._audit("user_created", username)
        self._save()
        return True

    # -- authentication (ref auth.py:98) -----------------------------------
    def authenticate(
        self, username: str, password: str, client_ip: str = ""
    ) -> Optional[str]:
        """Returns a session token, or None. Lockout and per-IP rate limits
        apply before any hash work (cheap rejection of brute force)."""
        now = time.time()
        if not self._check_auth_rate(client_ip or username, now):
            self._audit("auth_rate_limited", username, client_ip)
            return None
        user = self.users.get(username)
        if user is None:
            # Hash anyway: identical timing for unknown vs known users.
            self._hash_password(password, "00" * SALT_BYTES)
            self._audit("auth_failed", username, "unknown user")
            return None
        if user.locked_until > now:
            self._audit("auth_locked_out", username)
            return None
        expected = user.password_hash
        got = self._hash_password(password, user.salt)
        if not hmac.compare_digest(expected, got):
            user.failed_attempts += 1
            if user.failed_attempts >= self.max_failed_attempts:
                user.locked_until = now + self.lockout_seconds
                self._audit("account_locked", username)
            else:
                self._audit("auth_failed", username)
            self._save()
            return None
        user.failed_attempts = 0
        user.locked_until = 0.0
        user.last_login = now
        token = self._issue_token(user, client_ip, now)
        self._audit("auth_ok", username, client_ip)
        self._save()
        return token

    # -- sessions (ref auth.py:155,166,191) --------------------------------
    def _issue_token(self, user: User, client_ip: str, now: float) -> str:
        token_id = secrets.token_urlsafe(TOKEN_BYTES)
        sig = hmac.new(self._secret, token_id.encode(), "sha256").hexdigest()
        token = f"{token_id}.{sig}"
        self.sessions[token_id] = Session(
            token_id=token_id,
            username=user.username,
            permissions=list(user.permissions),
            created_at=now,
            expires_at=now + self.session_ttl,
            client_ip=client_ip,
        )
        return token

    def validate_session(self, token: str) -> Optional[Dict[str, Any]]:
        try:
            token_id, sig = token.rsplit(".", 1)
        except (ValueError, AttributeError):
            return None
        want = hmac.new(self._secret, token_id.encode(), "sha256").hexdigest()
        if not hmac.compare_digest(want, sig):
            self._audit("session_forged", token_id[:8])
            return None
        sess = self.sessions.get(token_id)
        if sess is None:
            return None
        if sess.expires_at < time.time():
            del self.sessions[token_id]
            self._audit("session_expired", sess.username)
            return None
        return {
            "username": sess.username,
            "permissions": sess.permissions,
            "expires_at": sess.expires_at,
        }

    def logout(self, token: str) -> bool:
        info = self.validate_session(token)
        if info is None:
            return False
        token_id = token.rsplit(".", 1)[0]
        self.sessions.pop(token_id, None)
        self._audit("logout", info["username"])
        return True

    def check_permission(
        self, session_info: Optional[Dict[str, Any]], required: str
    ) -> bool:
        """(ref auth.py:264)"""
        if not session_info:
            return False
        perms = session_info.get("permissions", [])
        return required in perms or "admin" in perms

    # -- auth rate limiting (ref auth.py:237) ------------------------------
    def _check_auth_rate(self, identifier: str, now: float) -> bool:
        window = [
            t for t in self._auth_events.get(identifier, [])
            if now - t < self.auth_rate_window
        ]
        window.append(now)
        self._auth_events[identifier] = window
        return len(window) <= self.auth_rate_limit

    # -- audit + persistence ----------------------------------------------
    def _audit(self, event: str, *details: str) -> None:
        entry = {"event": event, "details": details, "time": time.time()}
        self.audit_log.append(entry)
        logger.info("security: %s %s", event, details)

    def get_security_status(self) -> Dict[str, Any]:
        now = time.time()
        return {
            "users": len(self.users),
            "active_sessions": sum(
                1 for s in self.sessions.values() if s.expires_at > now
            ),
            "locked_accounts": sum(
                1 for u in self.users.values() if u.locked_until > now
            ),
            "audit_events": len(self.audit_log),
        }

    def _save(self) -> None:
        if self.persist_path is None:
            return
        self.persist_path.parent.mkdir(parents=True, exist_ok=True)
        data = {u.username: u.to_dict() for u in self.users.values()}
        self.persist_path.write_text(json.dumps(data, indent=1))

    def _load(self) -> None:
        try:
            data = json.loads(self.persist_path.read_text())
            self.users = {k: User(**v) for k, v in data.items()}
        except Exception as e:  # pragma: no cover - corrupted store
            logger.warning("user store unreadable (%s); starting empty", e)
