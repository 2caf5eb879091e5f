"""Request rate limiting + the secured chat wrapper.

Covers the reference RateLimiter and SecureConversationalChat (ref:
Src/Main_Scripts/security/rate_limiter.py:8,107 — sliding-window limits
per identifier/action with remaining/reset introspection; a chat facade
that requires authentication, validates every input, rate-limits message
traffic, and audit-logs the session).

The port's copy of luminaai_tpu/security/rate_limiter.py (standard library only).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from luminaai_tpu_torch.security.auth import SecurityManager
from luminaai_tpu_torch.security.input_validator import InputValidator

logger = logging.getLogger(__name__)

# action -> (max requests, window seconds) (ref rate_limiter.py:11)
DEFAULT_LIMITS: Dict[str, Tuple[int, float]] = {
    "chat_message": (30, 60.0),
    "login": (10, 60.0),
    "generate": (20, 60.0),
}


class RateLimiter:
    """Sliding-window limiter keyed by (identifier, action) (ref :8)."""

    def __init__(
        self, limits: Optional[Dict[str, Tuple[int, float]]] = None
    ):
        self.limits = dict(DEFAULT_LIMITS)
        if limits:
            self.limits.update(limits)
        self._events: Dict[Tuple[str, str], List[float]] = {}

    def _window(self, key: Tuple[str, str], window: float, now: float):
        events = [t for t in self._events.get(key, []) if now - t < window]
        self._events[key] = events
        return events

    def is_allowed(
        self,
        identifier: str,
        action: str,
        custom_limit: Optional[Tuple[int, float]] = None,
    ) -> bool:
        """(ref :25)"""
        limit, window = custom_limit or self.limits.get(action, (60, 60.0))
        now = time.time()
        key = (identifier, action)
        events = self._window(key, window, now)
        if len(events) >= limit:
            return False
        events.append(now)
        return True

    def get_remaining_requests(self, identifier: str, action: str) -> int:
        """(ref :47)"""
        limit, window = self.limits.get(action, (60, 60.0))
        events = self._window((identifier, action), window, time.time())
        return max(0, limit - len(events))

    def get_reset_time(self, identifier: str, action: str) -> Optional[float]:
        """Seconds until a blocked identifier can act again (ref :62)."""
        limit, window = self.limits.get(action, (60, 60.0))
        events = self._window((identifier, action), window, time.time())
        if len(events) < limit:
            return None
        return max(0.0, events[0] + window - time.time())

    def cleanup_old_buckets(self) -> int:
        """Drop empty windows; returns surviving bucket count (ref :75)."""
        now = time.time()
        for key in list(self._events):
            action = key[1]
            _, window = self.limits.get(action, (60, 60.0))
            if not self._window(key, window, now):
                del self._events[key]
        return len(self._events)


class TokenBucket:
    """One tenant's token bucket: capacity `burst`, refilled continuously
    at `rate_per_s`. The clock is INJECTED (defaults to time.monotonic)
    so refill timing is testable without sleeps and immune to wall-clock
    jumps."""

    def __init__(
        self,
        rate_per_s: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self.clock()
        elapsed = max(0.0, now - self._last)
        self._last = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)

    def allow(self, cost: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def retry_after(self, cost: float = 1.0) -> float:
        """Seconds until `cost` tokens will be available (0 if now)."""
        self._refill()
        missing = cost - self.tokens
        if missing <= 0:
            return 0.0
        return missing / max(self.rate, 1e-9)


class TokenBucketLimiter:
    """Per-tenant token-bucket admission for the serving gate
    (ChatServer._gate): one bucket per tenant LABEL. Callers must pass
    HASHED tenants (security.auth.tenant_hash) — bucket keys are
    introspectable state and raw identities must never appear in them
    (tier-1 contract-tested). Thread-safe: the server gates under its
    state lock, but /stats-style readers may race emitters."""

    def __init__(
        self,
        rate_per_s: float = 10.0,
        burst: int = 20,
        clock: Callable[[], float] = time.monotonic,
        max_buckets: int = 4096,
    ):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.clock = clock
        # Bounded state, same discipline LX009 enforces on tenant metric
        # labels: rotating identities must not grow server memory
        # without bound. At the cap, idle (fully-refilled) buckets are
        # swept first — dropping one is semantically a no-op, a fresh
        # bucket starts full anyway — then oldest-touched.
        self.max_buckets = max(1, int(max_buckets))
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            if len(self._buckets) >= self.max_buckets:
                self._prune()
            b = self._buckets[tenant] = TokenBucket(
                self.rate, self.burst, clock=self.clock
            )
        return b

    def _prune(self) -> None:
        idle = [
            k for k, b in self._buckets.items()
            if b.tokens + (self.clock() - b._last) * b.rate >= b.burst
        ]
        for k in idle:
            del self._buckets[k]
        while len(self._buckets) >= self.max_buckets:
            oldest = min(self._buckets, key=lambda k: self._buckets[k]._last)
            del self._buckets[oldest]

    def allow(self, tenant: str, cost: float = 1.0) -> bool:
        with self._lock:
            return self._bucket(tenant).allow(cost)

    def retry_after(self, tenant: str, cost: float = 1.0) -> float:
        with self._lock:
            return self._bucket(tenant).retry_after(cost)

    def remaining(self, tenant: str) -> float:
        """Pure read: never allocates a bucket (an introspection call
        for an unseen tenant must not trigger the cap's prune and evict
        a live bucket). Unseen tenants report a full bucket — that is
        exactly what allow() would start them with."""
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                return self.burst
            b._refill()
            return b.tokens


class SecureChatSession:
    """Authenticated, validated, rate-limited chat facade (ref :107
    SecureConversationalChat).

    Wraps anything exposing `respond(text) -> (reply, stats)` — the
    ChatInterface, or a bare GenerationEngine adapter. All security
    decisions happen here so the inference stack stays policy-free.
    """

    def __init__(
        self,
        respond_fn: Callable[[str], Tuple[str, Dict[str, Any]]],
        security: Optional[SecurityManager] = None,
        rate_limiter: Optional[RateLimiter] = None,
        validator: Optional[InputValidator] = None,
    ):
        self.respond_fn = respond_fn
        self.security = security or SecurityManager()
        self.rate_limiter = rate_limiter or RateLimiter()
        self.validator = validator or InputValidator()
        self.stats = {"messages": 0, "rejected": 0}

    # -- account/session passthrough (ref :123,224,228) --------------------
    def create_user(self, username: str, password: str, permissions=None):
        return self.security.create_user(username, password, permissions)

    def authenticate(
        self, username: str, password: str, client_ip: str = ""
    ) -> Optional[str]:
        if not self.rate_limiter.is_allowed(client_ip or username, "login"):
            return None
        return self.security.authenticate(username, password, client_ip)

    def logout(self, token: str) -> bool:
        return self.security.logout(token)

    # -- the secured message path (ref :141) -------------------------------
    def secure_respond(
        self, user_input: str, session_token: str
    ) -> Dict[str, Any]:
        """Returns {ok, reply?, error?, stats?}. Order: session → permission
        → rate limit → validation → generate."""
        session = self.security.validate_session(session_token)
        if session is None:
            self.stats["rejected"] += 1
            return {"ok": False, "error": "invalid or expired session"}
        if not self.security.check_permission(session, "chat"):
            self.stats["rejected"] += 1
            return {"ok": False, "error": "permission denied"}
        user = session["username"]
        if not self.rate_limiter.is_allowed(user, "chat_message"):
            self.stats["rejected"] += 1
            reset = self.rate_limiter.get_reset_time(user, "chat_message")
            return {
                "ok": False,
                "error": "rate limit exceeded",
                "retry_after_sec": round(reset or 0.0, 1),
            }
        check = self.validator.validate_user_input(user_input)
        if not check.valid:
            self.stats["rejected"] += 1
            return {"ok": False, "error": "; ".join(check.errors)}
        reply, gen_stats = self.respond_fn(check.sanitized)
        self.stats["messages"] += 1
        return {
            "ok": True,
            "reply": reply,
            "stats": gen_stats,
            "warnings": check.warnings,
        }

    def get_security_status(self) -> Dict[str, Any]:
        """(ref :232)"""
        return {
            **self.security.get_security_status(),
            "session_stats": dict(self.stats),
        }
