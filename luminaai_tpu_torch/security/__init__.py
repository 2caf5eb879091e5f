"""Security subsystem: auth, sessions, rate limiting, input validation
(ref: Src/Main_Scripts/security/).

The port's copy of luminaai_tpu/security/, for `chat --secure`."""

from luminaai_tpu_torch.security.auth import (
    SecurityManager,
    Session,
    User,
    tenant_hash,
)
from luminaai_tpu_torch.security.input_validator import (
    InputValidator,
    ValidationResult,
)
from luminaai_tpu_torch.security.rate_limiter import (
    RateLimiter,
    SecureChatSession,
    TokenBucket,
    TokenBucketLimiter,
)

__all__ = [
    "SecurityManager",
    "tenant_hash",
    "Session",
    "User",
    "InputValidator",
    "ValidationResult",
    "RateLimiter",
    "SecureChatSession",
    "TokenBucket",
    "TokenBucketLimiter",
]
