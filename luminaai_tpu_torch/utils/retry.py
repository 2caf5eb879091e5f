"""Durable I/O: a reusable retry policy for flaky storage (the port's
copy of luminaai_tpu/utils/retry.py).

Transient storage faults (an `OSError` from a network filesystem, a
momentary `ConnectionError`) are routine at scale, so every durable-I/O
call site (`CheckpointManager.save`/`restore`, the manifest writes, the
data readers) routes through a `RetryPolicy`: exponential backoff with
jitter, a per-op deadline, transient-vs-permanent error classification,
and injectable clock/sleep so tests drive the whole ladder without
wall-clock sleeps.

Observability (docs/observability.md "Durable I/O"):
  - `io_retries_total{op}` — transient failures that were retried.
  - `io_failures_total{op}` — ops that exhausted the policy (or hit a
    permanent error) and raised to the caller.
  - `io_retry` flight events on the process recorder, one per retry,
    carrying op/attempt/delay/error.

Goodput: the call sites run inside the trainer's open `checkpoint` /
`data_wait` goodput regions, so backoff sleep accrues to the cause that
was already open.

Fault injection: a hook installed at this seam (`set_fault_hook`) may
raise transient errors for the first N attempts, exercising the retry
ladder through the real call sites.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "RetryPolicy",
    "TransientIOError",
    "default_classify",
    "default_policy",
    "set_default_policy",
    "set_fault_hook",
    "io_call",
]


class TransientIOError(OSError):
    """An error the caller KNOWS is transient (fault injectors raise
    this; wrappers around storage clients may too)."""


# OSError subclasses where a retry cannot change the outcome: the path
# is wrong, the file genuinely is a directory, the name already exists.
# PermissionError is permanent too — credential problems don't heal on
# a 50ms backoff, and retrying them just delays the actionable error.
_PERMANENT_OSERRORS = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    FileExistsError,
    PermissionError,
)


def default_classify(exc: BaseException) -> bool:
    """True when `exc` looks transient (worth retrying): OS-level I/O
    errors minus the permanent subclasses above. Everything else —
    corrupt-data ValueErrors, integrity failures, programming errors —
    is permanent by default: retrying a checksum mismatch just re-reads
    the same corrupt bytes."""
    if isinstance(exc, TransientIOError):
        return True
    if isinstance(exc, _PERMANENT_OSERRORS):
        return False
    # TimeoutError / ConnectionError / InterruptedError / BlockingIOError
    # are all OSError subclasses.
    return isinstance(exc, OSError)


# -- fault-injection seam ---------------------------------------------------
_fault_hook: Optional[Callable[[str], None]] = None
_hook_lock = threading.Lock()


def set_fault_hook(
    hook: Optional[Callable[[str], None]],
) -> Optional[Callable[[str], None]]:
    """Install a callable invoked with the op name at the START of every
    attempt; it may raise to simulate a storage fault. Returns the
    previous hook (restore it when done). Test-only seam."""
    global _fault_hook
    with _hook_lock:
        prev = _fault_hook
        _fault_hook = hook
    return prev


class RetryPolicy:
    """Exponential-backoff retry with jitter, deadline and classification.

    `call(fn, *args, op=..., **kwargs)` runs `fn` up to `max_attempts`
    times. A transient failure (per `classify`) sleeps
    `base_delay_s * 2**(attempt-1)` (capped at `max_delay_s`, jittered
    by ±`jitter` fraction) and tries again; a permanent failure or an
    exhausted ladder re-raises the original exception. `timeout_s`
    bounds the whole op including backoff waits: a retry whose delay
    would overrun the deadline fails immediately instead.

    Clock, sleep and the jitter RNG are injectable so tests assert the
    exact backoff sequence with zero wall-clock cost.
    """

    def __init__(
        self,
        max_attempts: int = 4,
        base_delay_s: float = 0.05,
        max_delay_s: float = 2.0,
        timeout_s: Optional[float] = None,
        jitter: float = 0.5,
        classify: Callable[[BaseException], bool] = default_classify,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        registry=None,
        recorder=None,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.timeout_s = timeout_s
        self.jitter = float(jitter)
        self.classify = classify
        self._sleep = sleep
        self._clock = clock
        self._rng = rng or random.Random()
        # None → resolve the process recorder at emit time, so a test's
        # set_recorder() swap is honored.
        self._recorder = recorder
        if registry is None:
            from luminaai_tpu_torch.monitoring.telemetry import get_registry

            registry = get_registry()
        self._m_retries = registry.counter(
            "io_retries_total",
            "Transient storage-op failures absorbed by a retry, by op",
            labelnames=("op",),
        )
        self._m_failures = registry.counter(
            "io_failures_total",
            "Storage ops that raised to the caller (permanent error or "
            "retry ladder exhausted), by op",
            labelnames=("op",),
        )

    @classmethod
    def from_config(cls, config, **overrides) -> "RetryPolicy":
        """Build from the Config durable-I/O knobs (io_retries /
        io_retry_base_s / io_retry_max_s / io_timeout_s)."""
        kw: dict = dict(
            max_attempts=getattr(config, "io_retries", 4),
            base_delay_s=getattr(config, "io_retry_base_s", 0.05),
            max_delay_s=getattr(config, "io_retry_max_s", 2.0),
            timeout_s=getattr(config, "io_timeout_s", None),
        )
        kw.update(overrides)
        return cls(**kw)

    # -- execution --------------------------------------------------------
    def delay_for_attempt(self, attempt: int) -> float:
        """Backoff before retrying after failed attempt `attempt`
        (1-based): exponential from base, capped, then jittered."""
        d = min(self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn: Callable[..., Any], *args, op: str = "io", **kwargs):
        """Run `fn(*args, **kwargs)` under this policy. `op` is the
        bounded metric/event label (call sites use a fixed small set:
        checkpoint_save / checkpoint_restore / manifest_write /
        data_open / data_read / ...)."""
        deadline = (
            self._clock() + self.timeout_s
            if self.timeout_s is not None
            else None
        )
        attempt = 0
        while True:
            attempt += 1
            try:
                hook = _fault_hook
                if hook is not None:
                    hook(op)
                return fn(*args, **kwargs)
            except Exception as e:
                try:
                    transient = bool(self.classify(e))
                except Exception:  # a broken classifier never masks `e`
                    transient = False
                if not transient or attempt >= self.max_attempts:
                    self._m_failures.labels(op=op).inc()
                    raise
                delay = self.delay_for_attempt(attempt)
                if deadline is not None and self._clock() + delay > deadline:
                    self._m_failures.labels(op=op).inc()
                    logger.warning(
                        "%s: deadline (%.2fs) exhausted after %d attempt(s)",
                        op, self.timeout_s, attempt,
                    )
                    raise
                self._m_retries.labels(op=op).inc()
                self._emit_retry(op, attempt, delay, e)
                logger.warning(
                    "transient %s failure (attempt %d/%d): %s: %s; "
                    "retrying in %.3fs",
                    op, attempt, self.max_attempts,
                    type(e).__name__, str(e)[:200], delay,
                )
                self._sleep(delay)

    def wrap(self, fn: Callable[..., Any], op: str = "io"):
        """`fn` bound to this policy: `wrap(open, "data_open")(path)`."""

        def wrapped(*args, **kwargs):
            return self.call(fn, *args, op=op, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped

    def _emit_retry(self, op, attempt, delay, exc) -> None:
        try:
            rec = self._recorder
            if rec is None:
                from luminaai_tpu_torch.monitoring.events import get_recorder

                rec = get_recorder()
            rec.emit(
                "io_retry",
                op=op,
                attempt=attempt,
                delay_s=round(delay, 4),
                error=f"{type(exc).__name__}: {str(exc)[:160]}",
            )
        except Exception:  # pragma: no cover - telemetry must not kill I/O
            logger.debug("io_retry event emit failed", exc_info=True)


# -- process default --------------------------------------------------------
_default_policy: Optional[RetryPolicy] = None
_default_lock = threading.Lock()


def default_policy() -> RetryPolicy:
    """The process-wide policy data readers fall back to when the caller
    threads none through (checkpointing builds its own from Config)."""
    global _default_policy
    with _default_lock:
        if _default_policy is None:
            _default_policy = RetryPolicy()
        return _default_policy


def set_default_policy(policy: Optional[RetryPolicy]) -> Optional[RetryPolicy]:
    """Swap the process default (config wiring / tests). Returns the
    previous policy; pass it back to restore."""
    global _default_policy
    with _default_lock:
        prev = _default_policy
        _default_policy = policy
        return prev


def io_call(
    fn: Callable[..., Any],
    *args,
    op: str = "io",
    policy: Optional[RetryPolicy] = None,
    **kwargs,
):
    """One-shot retried call: `io_call(open, path, "rb", op="data_open")`."""
    return (policy or default_policy()).call(fn, *args, op=op, **kwargs)
