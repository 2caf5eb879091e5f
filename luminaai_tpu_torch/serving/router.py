"""Resilient multi-replica serving plane: the data-plane router (the
port's copy of luminaai_tpu/serving/router.py: the same dispatch,
breakers, page index, payloads, metrics and flight events).

One ChatServer process caps out at `num_slots` concurrent decode lanes;
a fleet of them is only a serving plane if individual replica loss is
invisible to clients. This router is that tier — a thin HTTP data plane
fronting N ChatServer replicas, where robustness is the contract:

  - **Replica registry + active health probing.** `probe_all()` polls
    each replica's `/healthz` (and `/slo`, best-effort) on an injectable
    clock. Warming and draining replicas receive no new admissions, but
    their in-flight streams drain cleanly — the router never severs a
    stream it already joined. A refused/failed probe marks the replica
    down and trips its breaker immediately: probes are cheap and a dead
    TCP endpoint is unambiguous, so the breaker opens within one probe
    interval of a SIGKILL.
  - **Per-replica circuit breaker.** closed → open on a consecutive-
    failure or error-rate threshold → half-open single probe after the
    cooldown → closed on success. Transitions are booked as flight
    events (`breaker_open` / `breaker_half_open` / `breaker_close`) and
    mirrored in the `router_breaker_state{replica}` gauge (0 closed,
    1 half-open, 2 open).
  - **Prefix-hash-affine dispatch.** Requests rendezvous-hash on the
    prompt prefix so shared prompts land where their radix-cache pages
    already live; when the affine target is open/draining/shedding the
    request falls back to the least-loaded live replica.
  - **Bounded failover.** Idempotent non-stream requests retry on the
    next candidate with backoff+jitter (delays from utils/retry.py's
    RetryPolicy, sleep injectable). Streams that die pre-first-token
    fail over transparently; streams that die mid-generation surface an
    SSE error frame carrying the original `request_id` — re-dispatching
    would silently replay tokens the client already consumed.
  - **Shed as a routing signal.** A replica 503 with Retry-After puts
    that replica on shed-cooldown and the request moves to the next
    candidate; the client only sees 503 (with the max Retry-After) when
    every candidate is shedding.
  - **Hedged dispatch.** Optionally, short non-stream requests fire a
    second replica after a p95-based hedge delay; first answer wins and
    the loser's connection is cancelled. A hedge budget caps hedges to
    a fixed fraction of non-stream traffic so tail-chasing can never
    double the fleet's load.

Pure host-side Python, stdlib HTTP only: no torch, no device work. The
clock, sleep, RNG and the replica transport are all injectable, so every
failure contract above is testable with no wall-clock sleeps.

`python -m luminaai_tpu_torch route` runs this standalone; `serve
--replicas N` spawns a local fleet of `serve` replicas behind it.
"""

from __future__ import annotations

import collections
import http.client
import json
import hashlib
import logging
import queue
import random
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from luminaai_tpu_torch.monitoring.events import get_recorder
from luminaai_tpu_torch.monitoring.telemetry import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
)
from luminaai_tpu_torch.serving.server import (
    MAX_BODY_BYTES,
    REQUEST_ID_RX,
    new_request_id,
)
from luminaai_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)

__all__ = [
    "CircuitBreaker",
    "Replica",
    "Router",
    "HttpTransport",
    "wait_ready",
    "run_router",
]

# Breaker state as exported in router_breaker_state{replica}.
_BREAKER_GAUGE = {"closed": 0, "half_open": 1, "open": 2}

# Transport failures that mean "this replica, this attempt" — not the
# request. Everything here is retryable on the next candidate.
TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class CircuitBreaker:
    """Per-replica closed → open → half-open → closed state machine.

    Failures are counted two ways: `failures` consecutive failures open
    the breaker, and so does an error-rate >= `error_rate` over the
    last `window` outcomes once `min_requests` of them exist (a replica
    that alternates ok/5xx never trips the consecutive counter but is
    still unusable). After `cooldown_s` an open breaker admits exactly
    one probe request (half-open); its success closes the breaker, its
    failure re-opens it for another cooldown. `trip()` force-opens —
    the probe loop uses it when a replica's TCP endpoint is dead, which
    needs no statistical evidence.

    The clock is injectable; `on_transition(breaker, old, new, reason)`
    books the gauge + flight event without this class knowing about
    either."""

    def __init__(
        self,
        name: str,
        failures: int = 3,
        error_rate: float = 0.5,
        min_requests: int = 8,
        window: int = 16,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[..., None]] = None,
    ):
        self.name = name
        self.failures = max(1, int(failures))
        self.error_rate = float(error_rate)
        self.min_requests = max(1, int(min_requests))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self.state = "closed"
        self._consecutive = 0
        self._outcomes: collections.deque = collections.deque(
            maxlen=max(self.min_requests, int(window))
        )
        self._opened_at: Optional[float] = None
        self._probe_started: Optional[float] = None

    def _transition(self, new: str, reason: str) -> None:
        old, self.state = self.state, new
        if new == "open":
            self._opened_at = self._clock()
            self._probe_started = None
        if old != new and self._on_transition is not None:
            self._on_transition(self, old, new, reason)

    def allow(self) -> bool:
        """May a request be sent to this replica right now? Half-open
        admits ONE probe at a time; a probe lost without a verdict
        (caller died) re-arms after another cooldown."""
        with self._lock:
            if self.state == "closed":
                return True
            now = self._clock()
            if self.state == "open":
                if now - (self._opened_at or now) < self.cooldown_s:
                    return False
                self._transition("half_open", "cooldown elapsed")
                self._probe_started = now
                return True
            # half_open: one in-flight probe owns the slot.
            if (
                self._probe_started is not None
                and now - self._probe_started < self.cooldown_s
            ):
                return False
            self._probe_started = now
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._outcomes.append(1)
            if self.state != "closed":
                self._transition("closed", "probe succeeded")

    def record_failure(self, reason: str = "request failed") -> None:
        with self._lock:
            self._consecutive += 1
            self._outcomes.append(0)
            if self.state == "half_open":
                self._transition("open", f"probe failed: {reason}")
                return
            if self.state != "closed":
                return
            n = len(self._outcomes)
            rate = (n - sum(self._outcomes)) / n if n else 0.0
            if self._consecutive >= self.failures:
                self._transition(
                    "open", f"{self._consecutive} consecutive failures"
                )
            elif n >= self.min_requests and rate >= self.error_rate:
                self._transition("open", f"error rate {rate:.2f}")

    def trip(self, reason: str) -> None:
        """Force-open (dead endpoint seen by the prober): no threshold
        arithmetic, the evidence is total."""
        with self._lock:
            if self.state != "open":
                self._transition("open", reason)
            else:
                self._opened_at = self._clock()  # extend the cooldown


class Replica:
    """One ChatServer as the router sees it: identity, probed health,
    breaker, load, and the shed/latency bookkeeping routing reads."""

    def __init__(self, name: str, url: str, breaker: CircuitBreaker):
        self.name = name
        self.url = url.rstrip("/")
        self.breaker = breaker
        self.status = "unknown"  # ok|degraded|warming|draining|down|unknown
        self.health: Dict[str, Any] = {}
        self.slo: Optional[Dict[str, Any]] = None
        self.inflight = 0
        self.requests = 0
        self.failures = 0
        self.shed_until = 0.0
        self.probe_failures = 0
        self.latencies: collections.deque = collections.deque(maxlen=128)
        self.lock = threading.Lock()

    def p95_s(self) -> Optional[float]:
        if not self.latencies:
            return None
        xs = sorted(self.latencies)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]


class _Cancel:
    """Cancellation handle for a hedged attempt: closing the underlying
    connection aborts the loser's blocking read mid-flight."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None
        self.cancelled = False

    def attach(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            self._conn = conn
            if self.cancelled:
                conn.close()

    def cancel(self) -> None:
        with self._lock:
            self.cancelled = True
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:  # pragma: no cover - close is best-effort
                    pass


class HttpTransport:
    """Blocking stdlib HTTP to one replica. The Router only ever talks
    through this seam, so tests swap in an in-memory fake and drive every
    failure mode without sockets."""

    def __init__(self, connect_timeout_s: float = 5.0):
        self.connect_timeout_s = float(connect_timeout_s)

    def _connect(self, base_url: str, timeout_s: Optional[float]):
        u = urllib.parse.urlsplit(base_url)
        return http.client.HTTPConnection(
            u.hostname, u.port or 80,
            timeout=timeout_s or self.connect_timeout_s,
        )

    def request(
        self,
        base_url: str,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        headers: Optional[Dict[str, str]] = None,
        timeout_s: Optional[float] = None,
        cancel: Optional[_Cancel] = None,
    ) -> Tuple[int, Dict[str, str], Dict[str, Any]]:
        """One JSON round-trip: (status, headers, payload). Raises
        TRANSPORT_ERRORS on connect/read failure."""
        conn = self._connect(base_url, timeout_s)
        if cancel is not None:
            cancel.attach(conn)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=payload, headers={
                "Content-Type": "application/json", **(headers or {}),
            })
            resp = conn.getresponse()
            raw = resp.read()
            try:
                doc = json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                doc = {"error": raw.decode(errors="replace")[:200]}
            return resp.status, dict(resp.getheaders()), doc
        finally:
            conn.close()

    def stream(
        self,
        base_url: str,
        path: str,
        body: Dict[str, Any],
        headers: Optional[Dict[str, str]] = None,
        timeout_s: Optional[float] = None,
    ):
        """Open an SSE stream. Returns (status, headers, payload, frames):
        on a non-200, frames is None and payload is the error body; on
        200, payload is None and frames yields each `data:` payload
        string (the `[DONE]` sentinel is consumed, not yielded — the
        router's handler writes its own terminator). Closing the frames
        generator closes the connection."""
        conn = self._connect(base_url, timeout_s)
        try:
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json",
                                  **(headers or {})})
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        ctype = resp.getheader("Content-Type", "")
        if resp.status != 200 or "text/event-stream" not in ctype:
            try:
                raw = resp.read()
                try:
                    doc = json.loads(raw) if raw else {}
                except json.JSONDecodeError:
                    doc = {"error": raw.decode(errors="replace")[:200]}
                return resp.status, dict(resp.getheaders()), doc, None
            finally:
                conn.close()

        def frames() -> Iterator[str]:
            try:
                while True:
                    line = resp.readline()
                    if not line:
                        # EOF without [DONE]: the replica died mid-frame.
                        raise ConnectionError(
                            "stream ended without [DONE]"
                        )
                    line = line.strip()
                    if not line or not line.startswith(b"data: "):
                        continue
                    data = line[len(b"data: "):].decode(errors="replace")
                    if data == "[DONE]":
                        return
                    yield data
            finally:
                conn.close()

        return resp.status, dict(resp.getheaders()), None, frames()


class Router:
    """Health-aware data-plane router over N ChatServer replicas.

    Everything time-like is injectable (`clock`, `sleep`, `rng`) and all
    replica I/O goes through `transport`, so the failure contracts are
    testable with zero wall-clock cost. `probe_all()` is the prober's
    synchronous core; `start_probing()` wraps it in a background thread
    for real deployments."""

    def __init__(
        self,
        replicas,
        transport: Optional[Any] = None,
        registry: Optional[MetricsRegistry] = None,
        recorder=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        probe_interval_s: float = 2.0,
        probe_timeout_s: float = 2.0,
        breaker_failures: int = 3,
        breaker_error_rate: float = 0.5,
        breaker_min_requests: int = 8,
        breaker_cooldown_s: float = 5.0,
        max_failovers: int = 2,
        failover_base_delay_s: float = 0.05,
        failover_max_delay_s: float = 0.5,
        request_timeout_s: Optional[float] = None,
        hedge: bool = False,
        hedge_delay_s: Optional[float] = None,
        hedge_budget: float = 0.1,
        hedge_max_tokens: int = 32,
        affinity_prefix_chars: int = 256,
        flight_dir: Optional[str] = None,
        page_index_capacity: int = 65536,
    ):
        self.transport = transport or HttpTransport()
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.max_failovers = max(0, int(max_failovers))
        self.request_timeout_s = request_timeout_s
        self.hedge = bool(hedge)
        self.hedge_delay_s = hedge_delay_s
        self.hedge_budget = float(hedge_budget)
        self.hedge_max_tokens = int(hedge_max_tokens)
        self.affinity_prefix_chars = max(1, int(affinity_prefix_chars))
        self.flight_dir = flight_dir
        self._recorder = recorder
        self._probe_stop: Optional[threading.Event] = None
        self._nonstream_total = 0
        self._hedges_fired = 0
        self._stats_lock = threading.Lock()

        # Failover backoff delays come from the SAME policy durable I/O
        # uses (utils/retry.py): exponential with jitter, injectable
        # sleep. Only delay_for_attempt is used — the attempt loop here
        # owns candidate selection, which .call() can't express.
        self._backoff = RetryPolicy(
            max_attempts=self.max_failovers + 1,
            base_delay_s=failover_base_delay_s,
            max_delay_s=failover_max_delay_s,
            sleep=sleep, clock=clock, rng=self._rng,
            registry=registry or MetricsRegistry(),
        )

        self.registry = registry or MetricsRegistry()
        self._m_requests = self.registry.counter(
            "router_requests_total",
            "Requests dispatched to a replica, by outcome code "
            "('error' = transport failure)",
            labelnames=("replica", "code"),
        )
        self._m_failovers = self.registry.counter(
            "router_failovers_total",
            "Dispatch attempts moved to the next candidate after a "
            "replica failure, by kind (request | stream)",
            labelnames=("kind",),
        )
        self._m_sheds = self.registry.counter(
            "router_sheds_total",
            "Replica 503/Retry-After responses absorbed as a routing "
            "signal (failover, not client-visible)",
            labelnames=("replica",),
        )
        self._m_shed_returned = self.registry.counter(
            "router_shed_returned_total",
            "503s returned to clients because EVERY candidate was "
            "shedding",
        )
        self._m_hedges = self.registry.counter(
            "router_hedges_total",
            "Hedged dispatches fired (second replica engaged)",
        )
        self._m_hedge_wins = self.registry.counter(
            "router_hedge_wins_total",
            "Hedged dispatches won by the hedge replica",
        )
        self._m_breaker_state = self.registry.gauge(
            "router_breaker_state",
            "Per-replica circuit breaker state "
            "(0 closed, 1 half-open, 2 open)",
            labelnames=("replica",),
        )
        self._m_breaker_transitions = self.registry.counter(
            "router_breaker_transitions_total",
            "Breaker state transitions, by replica and target state",
            labelnames=("replica", "to"),
        )
        self._m_stream_errors = self.registry.counter(
            "router_stream_errors_total",
            "Streams that died mid-generation and surfaced an SSE "
            "error frame",
        )
        self._m_latency = self.registry.histogram(
            "router_request_seconds",
            "Router-side latency of successful non-stream dispatches",
            buckets=DEFAULT_LATENCY_BUCKETS,
        )
        self._m_replicas = self.registry.gauge(
            "router_replicas_total", "Registered replicas"
        )
        self._m_available = self.registry.gauge(
            "router_replicas_available",
            "Replicas currently accepting new admissions",
        )

        # Fleet page index: chain key -> owning replica URL,
        # fed by replica harvest reports (POST /pages/report) and read
        # by replica cold admissions (POST /pages/lookup). Keys and
        # URLs only — page BYTES move replica-to-replica. FIFO-bounded:
        # a lost entry costs one missed sharing opportunity, and a
        # stale one costs one failed pull that degrades to a local
        # recompute, so the index needs no consistency protocol.
        self.page_index_capacity = max(0, int(page_index_capacity))
        self._page_index: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        self._page_reports: Dict[str, int] = {}
        self._page_lock = threading.Lock()
        self._m_page_index = self.registry.gauge(
            "router_page_index_keys",
            "Chain keys currently in the fleet page index",
        )
        self._m_page_reports = self.registry.counter(
            "router_page_reports_total",
            "Chain-key ownership reports accepted into the fleet index",
        )
        self._m_page_lookups = self.registry.counter(
            "router_page_lookups_total",
            "Fleet page-index lookups, by result",
            labelnames=("result",),
        )

        self.replicas: List[Replica] = []
        for i, rep in enumerate(replicas):
            name, url = (
                rep if isinstance(rep, (tuple, list))
                else (f"r{i}", rep)
            )
            breaker = CircuitBreaker(
                name,
                failures=breaker_failures,
                error_rate=breaker_error_rate,
                min_requests=breaker_min_requests,
                cooldown_s=breaker_cooldown_s,
                clock=clock,
                on_transition=self._book_transition,
            )
            self.replicas.append(Replica(name, url, breaker))
            self._m_breaker_state.labels(replica=name).set(0)
        self._m_replicas.set(len(self.replicas))
        self._m_available.set(len(self.replicas))

    # -- bookkeeping -------------------------------------------------------
    def _emit(self, etype: str, **fields) -> None:
        rec = self._recorder or get_recorder()
        rec.emit(etype, **fields)

    def _book_transition(self, breaker: CircuitBreaker, old: str,
                         new: str, reason: str) -> None:
        self._m_breaker_state.labels(replica=breaker.name).set(
            _BREAKER_GAUGE[new]
        )
        self._m_breaker_transitions.labels(
            replica=breaker.name, to=new
        ).inc()
        event = {
            "open": "breaker_open",
            "half_open": "breaker_half_open",
            "closed": "breaker_close",
        }[new]
        self._emit(event, replica=breaker.name, from_state=old,
                   reason=reason)
        logger.warning("breaker %s: %s -> %s (%s)",
                       breaker.name, old, new, reason)

    # -- health probing ----------------------------------------------------
    def probe_once(self, replica: Replica) -> None:
        """One probe round-trip for one replica: GET /healthz (+ /slo,
        best-effort). Updates status + breaker. Synchronous so tests
        drive it on a fake clock."""
        try:
            status, _, payload = self.transport.request(
                replica.url, "GET", "/healthz",
                timeout_s=self.probe_timeout_s,
            )
        except TRANSPORT_ERRORS as e:
            replica.probe_failures += 1
            prev = replica.status
            replica.status = "down"
            replica.slo = None
            replica.breaker.trip(f"probe failed: {type(e).__name__}")
            if prev != "down":
                self._emit("replica_state", replica=replica.name,
                           from_state=prev, to_state="down",
                           reason=str(e)[:200])
            return
        replica.probe_failures = 0
        new_status = str(payload.get("status") or
                         ("warming" if status == 503 else "ok"))
        prev = replica.status
        replica.status = new_status
        replica.health = payload
        if prev != new_status:
            self._emit("replica_state", replica=replica.name,
                       from_state=prev, to_state=new_status)
        if new_status not in ("warming",) and status == 200:
            # The endpoint answered sanely: let an open breaker walk its
            # half-open → closed recovery on probe traffic, not only on
            # live requests.
            if replica.breaker.state != "closed" and replica.breaker.allow():
                replica.breaker.record_success()
        try:
            s_code, _, s_doc = self.transport.request(
                replica.url, "GET", "/slo",
                timeout_s=self.probe_timeout_s,
            )
            replica.slo = s_doc if s_code == 200 else None
        except TRANSPORT_ERRORS:
            replica.slo = None  # health already booked the failure

    def probe_all(self) -> None:
        for r in self.replicas:
            self.probe_once(r)
        self._m_available.set(
            sum(1 for r in self.replicas if self._skip_reason(r) is None)
        )

    def start_probing(self) -> threading.Thread:
        """Background prober for real deployments (tests call probe_all
        directly on a fake clock instead)."""
        self._probe_stop = threading.Event()

        def loop():
            while not self._probe_stop.wait(self.probe_interval_s):
                try:
                    self.probe_all()
                except Exception:  # pragma: no cover - belt and braces
                    logger.exception("probe round failed")

        t = threading.Thread(target=loop, daemon=True,
                             name="router-prober")
        t.start()
        return t

    def stop_probing(self) -> None:
        if self._probe_stop is not None:
            self._probe_stop.set()

    # -- fleet page index ---------------------------------------------------
    def _replica_by_url(self, url: str) -> Optional[Replica]:
        url = str(url).rstrip("/")
        for r in self.replicas:
            if r.url.rstrip("/") == url:
                return r
        return None

    def handle_page_report(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """POST /pages/report core: a replica advertises chain keys
        whose page bytes are arena-resident on it. Only registered
        replicas are indexed (an unknown URL could otherwise poison
        every lookup); last reporter wins per key."""
        url = str(body.get("replica", "")).rstrip("/")
        keys = [
            k for k in (body.get("keys") or [])
            if isinstance(k, str) and k
        ]
        if self._replica_by_url(url) is None:
            return {"indexed": 0, "known": False}
        with self._page_lock:
            for key in keys:
                self._page_index[key] = url
                self._page_index.move_to_end(key)
            while len(self._page_index) > self.page_index_capacity:
                self._page_index.popitem(last=False)
            self._page_reports[url] = (
                self._page_reports.get(url, 0) + len(keys)
            )
            self._m_page_index.set(len(self._page_index))
        if keys:
            self._m_page_reports.inc(len(keys))
        return {"indexed": len(keys), "known": True}

    def handle_page_lookup(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """POST /pages/lookup core: given a chain (and how many leading
        pages the asker already holds), name ONE live replica owning a
        contiguous run from position `have`, plus the covered prefix of
        the chain. Owners that are down, draining, breaker-open or the
        asker itself are invisible — a lookup must never send a puller
        at a replica the router would not route a request to."""
        keys = [
            k for k in (body.get("keys") or [])
            if isinstance(k, str) and k
        ]
        exclude = str(body.get("exclude", "")).rstrip("/")
        have = max(0, min(int(body.get("have", 0) or 0), len(keys)))
        if have >= len(keys):
            self._m_page_lookups.labels(result="miss").inc()
            return {"owner": None, "keys": []}
        with self._page_lock:
            owner = self._page_index.get(keys[have])
        rep = self._replica_by_url(owner) if owner else None
        if (
            owner is None
            or owner == exclude
            or rep is None
            or rep.status in ("down", "draining", "warming")
            or rep.breaker.state == "open"
        ):
            self._m_page_lookups.labels(result="miss").inc()
            return {"owner": None, "keys": []}
        matched = list(keys[:have + 1])
        with self._page_lock:
            for key in keys[have + 1:]:
                if self._page_index.get(key) != owner:
                    break
                matched.append(key)
        self._m_page_lookups.labels(result="hit").inc()
        return {"owner": owner, "keys": matched}

    def _page_index_counts(self) -> Dict[str, int]:
        with self._page_lock:
            counts: Dict[str, int] = {}
            for url in self._page_index.values():
                counts[url] = counts.get(url, 0) + 1
            return counts

    # -- candidate selection -----------------------------------------------
    def _affinity_key(self, path: str, body: Dict[str, Any]) -> str:
        """The prompt prefix is the cache identity: requests sharing a
        system prompt / few-shot template hash together, landing where
        the radix cache already holds their pages. The keying rule
        itself lives in serving/page_share.py (single source of truth,
        shared with the cache's chain ownership)."""
        from luminaai_tpu_torch.serving.page_share import affinity_key

        return affinity_key(path, body, self.affinity_prefix_chars)

    def _ordered(self, key: str) -> List[Replica]:
        """Affine target first (rendezvous hash: stable under fleet
        membership change), then the rest by ascending load."""
        def score(r: Replica) -> int:
            h = hashlib.sha1(
                (key + "\x00" + r.name).encode()
            ).digest()
            return int.from_bytes(h[:8], "big")

        ordered = sorted(self.replicas, key=score, reverse=True)
        head, rest = ordered[0], ordered[1:]
        rest.sort(key=lambda r: (r.inflight, r.name))
        return [head] + rest

    def _skip_reason(self, r: Replica,
                     now: Optional[float] = None) -> Optional[str]:
        """Why a candidate gets no NEW admissions right now (None = send).
        NOTE: a half-open breaker's allow() consumes the probe slot, so
        only call this when the caller will actually dispatch."""
        now = self._clock() if now is None else now
        if r.status in ("warming", "draining"):
            return r.status
        if now < r.shed_until:
            return "shed"
        if not r.breaker.allow():
            return "open"
        return None

    @staticmethod
    def _retry_after(headers: Dict[str, str],
                     payload: Dict[str, Any]) -> float:
        for source in (payload.get("retry_after"),
                       (headers or {}).get("Retry-After")):
            try:
                if source is not None:
                    return max(0.0, float(source))
            except (TypeError, ValueError):
                pass
        return 1.0  # shed without a hint: brief cooldown beats a hot loop

    def _fwd_headers(self, headers: Optional[Dict[str, str]],
                     request_id: str) -> Dict[str, str]:
        out = {"X-Request-Id": request_id}
        auth = (headers or {}).get("Authorization")
        if auth:
            out["Authorization"] = auth
        return out

    # -- non-stream dispatch -----------------------------------------------
    def _attempt(self, replica: Replica, path: str, body: Dict[str, Any],
                 headers: Optional[Dict[str, str]], request_id: str,
                 cancel: Optional[_Cancel] = None) -> Tuple:
        """One replica, one try. Returns one of
        ("ok", status, payload) — includes 4xx: client errors are the
        client's, retrying them elsewhere can't help;
        ("shed", retry_after_s); ("fail", reason)."""
        t0 = self._clock()
        with replica.lock:
            replica.inflight += 1
        try:
            status, hdrs, payload = self.transport.request(
                replica.url, "POST", path, body,
                headers=self._fwd_headers(headers, request_id),
                timeout_s=self.request_timeout_s, cancel=cancel,
            )
        except TRANSPORT_ERRORS as e:
            with replica.lock:
                replica.failures += 1
            replica.breaker.record_failure(type(e).__name__)
            self._m_requests.labels(replica=replica.name,
                                    code="error").inc()
            return ("fail", f"{type(e).__name__}: {e}")
        finally:
            with replica.lock:
                replica.inflight -= 1
        self._m_requests.labels(replica=replica.name,
                                code=str(status)).inc()
        if status == 503:
            retry_after = self._retry_after(hdrs, payload)
            replica.shed_until = self._clock() + retry_after
            self._m_sheds.labels(replica=replica.name).inc()
            return ("shed", retry_after)
        if status >= 500:
            with replica.lock:
                replica.failures += 1
            replica.breaker.record_failure(f"http {status}")
            return ("fail", f"http {status}")
        replica.breaker.record_success()
        dt = self._clock() - t0
        with replica.lock:
            replica.requests += 1
            replica.latencies.append(dt)
        self._m_latency.observe(dt)
        return ("ok", status, payload)

    def _hedge_delay(self) -> float:
        if self.hedge_delay_s is not None:
            return float(self.hedge_delay_s)
        p95s = [p for p in (r.p95_s() for r in self.replicas)
                if p is not None]
        return max(p95s) if p95s else 0.05

    def _hedge_eligible(self, body: Dict[str, Any]) -> bool:
        if not self.hedge or body.get("stream"):
            return False
        want = body.get("max_new_tokens")
        try:
            if want is not None and int(want) > self.hedge_max_tokens:
                return False
        except (TypeError, ValueError):
            return False
        with self._stats_lock:
            # Budget: hedges may never exceed hedge_budget of non-stream
            # traffic (+1 lets the very first request hedge).
            return (self._hedges_fired + 1) <= self.hedge_budget * (
                self._nonstream_total + 1
            )

    def _hedged(self, primary: Replica, secondary: Replica, path: str,
                body: Dict[str, Any], headers, request_id: str) -> Tuple:
        """Fire primary; if no answer within the hedge delay, fire the
        secondary; first verdict wins and the loser is cancelled. Returns
        an _attempt()-shaped tuple (plus the winner's name for events)."""
        results: "queue.Queue" = queue.Queue()
        cancels = {primary.name: _Cancel(), secondary.name: _Cancel()}

        def run(rep: Replica) -> None:
            out = self._attempt(rep, path, body, headers, request_id,
                                cancel=cancels[rep.name])
            results.put((rep, out))

        threading.Thread(target=run, args=(primary,), daemon=True).start()
        try:
            rep, out = results.get(timeout=max(1e-4, self._hedge_delay()))
            return out  # primary answered inside the delay: no hedge
        except queue.Empty:
            pass
        with self._stats_lock:
            self._hedges_fired += 1
        self._m_hedges.inc()
        self._emit("router_hedge", request_id=request_id,
                   primary=primary.name, hedge=secondary.name)
        threading.Thread(target=run, args=(secondary,),
                         daemon=True).start()
        rep, out = results.get()
        if out[0] != "ok":
            # First verdict was a failure: the slower twin may still win.
            rep, out = results.get()
        for name, c in cancels.items():
            if name != rep.name:
                c.cancel()
        if rep is secondary and out[0] == "ok":
            self._m_hedge_wins.inc()
        return out

    def dispatch(self, path: str, body: Dict[str, Any],
                 headers: Optional[Dict[str, str]] = None) -> Tuple[
                     int, Dict[str, Any]]:
        """Route one non-stream generation POST. Returns (status,
        payload); payload carries request_id (and retry_after on an
        all-shed 503) like ChatServer's contract."""
        request_id = self._inbound_request_id(headers) or new_request_id()
        with self._stats_lock:
            self._nonstream_total += 1
        order = self._ordered(self._affinity_key(path, body))
        attempts = 0
        sheds: List[float] = []
        last_fail: Optional[str] = None
        prev_name: Optional[str] = None
        for replica in order:
            if attempts > self.max_failovers:
                break
            skip = self._skip_reason(replica)
            if skip == "shed":
                sheds.append(replica.shed_until - self._clock())
                continue
            if skip is not None:
                continue
            if attempts > 0:
                self._m_failovers.labels(kind="request").inc()
                self._emit("router_failover", request_id=request_id,
                           from_replica=prev_name, to_replica=replica.name,
                           reason=last_fail or "shed", kind="request")
                self._sleep(self._backoff.delay_for_attempt(attempts))
            attempts += 1
            prev_name = replica.name
            hedge_partner = self._hedge_partner(order, replica)
            if attempts == 1 and hedge_partner is not None and \
                    self._hedge_eligible(body):
                out = self._hedged(replica, hedge_partner, path, body,
                                   headers, request_id)
            else:
                out = self._attempt(replica, path, body, headers,
                                    request_id)
            if out[0] == "ok":
                _, status, payload = out
                if isinstance(payload, dict):
                    payload.setdefault("request_id", request_id)
                return status, payload
            if out[0] == "shed":
                sheds.append(out[1])
                continue
            last_fail = out[1]
        if sheds and last_fail is None:
            retry_after = max(sheds)
            self._m_shed_returned.inc()
            self._emit("router_shed_all", request_id=request_id,
                       retry_after=round(retry_after, 3))
            return 503, {
                "error": "all replicas shedding load; retry shortly",
                "retry_after": max(1, int(round(retry_after))),
                "request_id": request_id,
            }
        self._emit("router_no_replica", request_id=request_id,
                   reason=last_fail or "no admittable replica")
        return 502, {
            "error": "no replica available"
                     + (f" (last: {last_fail})" if last_fail else ""),
            "request_id": request_id,
        }

    def _hedge_partner(self, order: List[Replica],
                       primary: Replica) -> Optional[Replica]:
        if not self.hedge:
            return None
        for r in order:
            if r is primary:
                continue
            # Peek without consuming a half-open probe slot: hedging is
            # opportunistic, never a breaker probe.
            if (r.status not in ("warming", "draining")
                    and r.breaker.state == "closed"
                    and self._clock() >= r.shed_until):
                return r
        return None

    @staticmethod
    def _inbound_request_id(
        headers: Optional[Dict[str, str]]
    ) -> Optional[str]:
        rid = (headers or {}).get("X-Request-Id", "")
        return rid if rid and REQUEST_ID_RX.fullmatch(rid) else None

    # -- stream dispatch ---------------------------------------------------
    def open_stream(self, path: str, body: Dict[str, Any],
                    headers: Optional[Dict[str, str]] = None):
        """Route one SSE generation. Returns (error_tuple | None,
        frame_iterator | None) — ChatServer.start_stream's shape, with
        frames as raw `data:` payload strings ready to forward."""
        request_id = self._inbound_request_id(headers) or new_request_id()
        order = self._ordered(self._affinity_key(path, body))
        state = {"idx": 0, "attempts": 0, "prev": None}
        sheds: List[float] = []
        fails: List[str] = []

        def next_conn():
            """Advance to the next live candidate and open its stream.
            Returns ("ok", replica, frames) | ("client_error", (code,
            payload)) | ("exhausted", None)."""
            while (state["idx"] < len(order)
                   and state["attempts"] <= self.max_failovers):
                replica = order[state["idx"]]
                state["idx"] += 1
                skip = self._skip_reason(replica)
                if skip == "shed":
                    sheds.append(replica.shed_until - self._clock())
                    continue
                if skip is not None:
                    continue
                if state["attempts"] > 0:
                    self._m_failovers.labels(kind="stream").inc()
                    self._emit(
                        "router_failover", request_id=request_id,
                        from_replica=state["prev"],
                        to_replica=replica.name,
                        reason=(fails[-1] if fails else "shed"),
                        kind="stream",
                    )
                    self._sleep(
                        self._backoff.delay_for_attempt(state["attempts"])
                    )
                state["attempts"] += 1
                state["prev"] = replica.name
                try:
                    status, hdrs, payload, frames = self.transport.stream(
                        replica.url, path, body,
                        headers=self._fwd_headers(headers, request_id),
                        timeout_s=self.request_timeout_s,
                    )
                except TRANSPORT_ERRORS as e:
                    with replica.lock:
                        replica.failures += 1
                    replica.breaker.record_failure(type(e).__name__)
                    self._m_requests.labels(replica=replica.name,
                                            code="error").inc()
                    fails.append(f"{type(e).__name__}: {e}")
                    continue
                if status == 503:
                    retry_after = self._retry_after(hdrs, payload)
                    replica.shed_until = self._clock() + retry_after
                    self._m_sheds.labels(replica=replica.name).inc()
                    sheds.append(retry_after)
                    continue
                if status >= 500:
                    with replica.lock:
                        replica.failures += 1
                    replica.breaker.record_failure(f"http {status}")
                    self._m_requests.labels(replica=replica.name,
                                            code=str(status)).inc()
                    fails.append(f"http {status}")
                    continue
                if frames is None:  # 4xx: the client's error, no retry
                    replica.breaker.record_success()
                    if isinstance(payload, dict):
                        payload.setdefault("request_id", request_id)
                    return ("client_error", (status, payload))
                return ("ok", replica, frames)
            return ("exhausted", None)

        first = next_conn()
        if first[0] == "client_error":
            return first[1], None
        if first[0] == "exhausted":
            if sheds and not fails:
                retry_after = max(sheds)
                self._m_shed_returned.inc()
                self._emit("router_shed_all", request_id=request_id,
                           retry_after=round(retry_after, 3))
                return (503, {
                    "error": "all replicas shedding load; retry shortly",
                    "retry_after": max(1, int(round(retry_after))),
                    "request_id": request_id,
                }), None
            return (502, {
                "error": "no replica available"
                         + (f" (last: {fails[-1]})" if fails else ""),
                "request_id": request_id,
            }), None

        def gen():
            _, replica, frames = first
            sent_any = False
            while True:
                try:
                    try:
                        for frame in frames:
                            sent_any = True
                            yield frame
                    finally:
                        close = getattr(frames, "close", None)
                        if close is not None:
                            close()
                    replica.breaker.record_success()
                    with replica.lock:
                        replica.requests += 1
                    self._m_requests.labels(replica=replica.name,
                                            code="200").inc()
                    return
                except TRANSPORT_ERRORS as e:
                    with replica.lock:
                        replica.failures += 1
                    replica.breaker.record_failure(type(e).__name__)
                    self._m_requests.labels(replica=replica.name,
                                            code="error").inc()
                    fails.append(f"{type(e).__name__}: {e}")
                    if sent_any:
                        # Tokens already reached the client: a replay
                        # would duplicate them. Surface the death with
                        # the original id so the client can correlate.
                        self._m_stream_errors.inc()
                        self._emit("router_stream_error",
                                   request_id=request_id,
                                   replica=replica.name,
                                   reason=str(e)[:200])
                        yield json.dumps({
                            "error": "replica failed mid-stream",
                            "replica": replica.name,
                            "request_id": request_id,
                        })
                        return
                    nxt = next_conn()
                    if nxt[0] != "ok":
                        self._m_stream_errors.inc()
                        self._emit("router_stream_error",
                                   request_id=request_id,
                                   replica=replica.name,
                                   reason="no surviving candidate")
                        yield json.dumps({
                            "error": "no replica available",
                            "request_id": request_id,
                        })
                        return
                    _, replica, frames = nxt

        return None, gen()

    # -- fleet / health surfaces -------------------------------------------
    def _replica_out(self, r: Replica) -> bool:
        return (r.breaker.state == "open"
                or r.status in ("down", "warming"))

    def health_payload(self) -> Tuple[int, Dict[str, Any]]:
        """Aggregate /healthz: degraded if ANY breaker is open, down
        (503) only when EVERY replica is out — one dead replica must not
        get the whole plane pulled from rotation."""
        out = sum(1 for r in self.replicas if self._replica_out(r))
        open_breakers = sum(
            1 for r in self.replicas if r.breaker.state != "closed"
        )
        total = len(self.replicas)
        if total and out == total:
            status, code = "down", 503
        elif out or open_breakers:
            status, code = "degraded", 200
        else:
            status, code = "ok", 200
        return code, {
            "status": status,
            "replicas": total,
            "available": total - out,
            "breakers_open": open_breakers,
        }

    def fleet_payload(self) -> Dict[str, Any]:
        """Per-replica verdict table (GET /fleet; rendered by
        `top --url <router>`)."""
        now = self._clock()
        page_counts = self._page_index_counts()
        reps = []
        for r in self.replicas:
            slo_summary = None
            if isinstance(r.slo, dict) and r.slo.get("objectives"):
                slo_summary = {
                    "alerting": list(r.slo.get("alerting") or []),
                    "objectives": {
                        name: v.get("state")
                        for name, v in r.slo["objectives"].items()
                    },
                }
            p95 = r.p95_s()
            reps.append({
                "replica": r.name,
                "url": r.url,
                "status": r.status,
                "breaker": r.breaker.state,
                "inflight": r.inflight,
                "requests": r.requests,
                "failures": r.failures,
                "shed_for_s": round(max(0.0, r.shed_until - now), 3),
                "p95_s": round(p95, 4) if p95 is not None else None,
                "slo": slo_summary,
                # Shared-index view: chain keys the fleet index credits
                # to this replica + how many it has ever reported.
                "shared_pages": page_counts.get(r.url.rstrip("/"), 0),
                "page_reports": self._page_reports.get(
                    r.url.rstrip("/"), 0
                ),
            })
        code, health = self.health_payload()
        return {**health, "http_status": code, "replicas": reps}

    # -- HTTP surface ------------------------------------------------------
    def make_handler(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.info("%s %s", self.address_string(), fmt % args)

            def _reply(self, code: int, payload: Dict[str, Any]) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                if isinstance(payload, dict):
                    if "retry_after" in payload:
                        self.send_header(
                            "Retry-After",
                            str(int(payload["retry_after"])),
                        )
                    if payload.get("request_id"):
                        self.send_header("X-Request-Id",
                                         str(payload["request_id"]))
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _headers(self) -> Dict[str, str]:
                out = {}
                for key in ("Authorization", "X-Request-Id"):
                    v = self.headers.get(key)
                    if v:
                        out[key] = v
                return out

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self._reply(*router.health_payload())
                    return
                if path == "/fleet":
                    self._reply(200, router.fleet_payload())
                    return
                if path == "/metrics":
                    data = router.registry.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self._reply(404, {"error": f"no route GET {path}"})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                if path not in ("/v1/generate", "/v1/chat",
                                "/pages/report", "/pages/lookup"):
                    self._reply(404, {"error": f"no route POST {path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > MAX_BODY_BYTES:
                        self._reply(413, {"error": "body too large"})
                        return
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                if path == "/pages/report":
                    self._reply(200, router.handle_page_report(body))
                    return
                if path == "/pages/lookup":
                    self._reply(200, router.handle_page_lookup(body))
                    return
                headers = self._headers()
                try:
                    if body.get("stream"):
                        err, frames = router.open_stream(
                            path, body, headers
                        )
                        if err is not None:
                            self._reply(*err)
                        else:
                            self._reply_sse(frames)
                        return
                    code, payload = router.dispatch(path, body, headers)
                except Exception as e:  # surface as 502, keep routing
                    logger.exception("router dispatch failed")
                    code, payload = 502, {"error": str(e)}
                self._reply(code, payload)

            def _reply_sse(self, frames) -> None:
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    for frame in frames:
                        self.wfile.write(
                            b"data: " + frame.encode() + b"\n\n"
                        )
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                except (BrokenPipeError, ConnectionResetError):
                    logger.info("stream client disconnected")
                    frames.close()  # stop the upstream pull too
                except Exception as e:
                    logger.exception("router stream failed")
                    try:
                        self.wfile.write(
                            b"data: "
                            + json.dumps({"error": str(e)}).encode()
                            + b"\n\ndata: [DONE]\n\n"
                        )
                    except OSError:
                        pass
                    frames.close()

        return Handler

    def serve_forever(self, host: str = "127.0.0.1",
                      port: int = 8000) -> None:
        httpd = ThreadingHTTPServer((host, port), self.make_handler())

        def _graceful(sig, frame):  # pragma: no cover - signal-driven
            logger.warning("signal %s: router shutting down", sig)
            threading.Thread(target=httpd.shutdown, daemon=True).start()

        import signal as _signal

        try:
            _signal.signal(_signal.SIGTERM, _graceful)
            _signal.signal(_signal.SIGINT, _graceful)
        except ValueError:  # pragma: no cover - non-main thread (tests)
            pass
        logger.info("routing on http://%s:%d over %d replica(s)",
                    host, port, len(self.replicas))
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            self.stop_probing()
            if self.flight_dir:
                rec = self._recorder or get_recorder()
                try:
                    rec.dump_to_dir(self.flight_dir, reason="router_exit")
                except OSError:  # pragma: no cover - dump best-effort
                    logger.exception("flight dump failed")


def wait_ready(urls: List[str], timeout_s: float = 120.0,
               poll_s: float = 0.25) -> None:
    """Block until every url answers /healthz with 200 (replica warmed).
    Raises TimeoutError naming the stragglers."""
    transport = HttpTransport()
    deadline = time.monotonic() + timeout_s
    pending = list(urls)
    while pending:
        still = []
        for url in pending:
            try:
                status, _, _ = transport.request(
                    url, "GET", "/healthz", timeout_s=2.0
                )
                if status != 200:
                    still.append(url)
            except TRANSPORT_ERRORS:
                still.append(url)
        pending = still
        if pending:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replicas never became ready: {pending}"
                )
            time.sleep(poll_s)


def run_router(replica_urls: List[str], host: str = "127.0.0.1",
               port: int = 8000, probing: bool = True,
               **kwargs) -> None:
    """CLI `route` entry: build, probe once so /fleet is warm
    before the first request, then serve."""
    router = Router(replica_urls, **kwargs)
    router.probe_all()
    if probing:
        router.start_probing()
    router.serve_forever(host, port)
