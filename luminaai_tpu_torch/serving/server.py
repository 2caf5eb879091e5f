"""HTTP serving for chat/completion over the port (PyTorch counterpart of
luminaai_tpu/serving/server.py, stdlib only).

A ThreadingHTTPServer wraps GenerationEngine. Generation requests ride
CONTINUOUS BATCHING: a ContinuousScheduler owns a step-wise decode loop
over a slot-paged KV pool (engine.make_stepwise) on ONE worker thread,
which sets the card as its device, so every decode step, prefill chunk and
prefix-cache page copy runs on that thread's stream in order. Each tick
frees the slots of finished lanes, admits queued requests (dequeued fair
share across tenants) into freed slots, advances one prefill chunk, and
runs one decode step for all active lanes. continuous=False runs the
legacy MicroBatcher, which groups same-parameter requests into
run-to-completion generate_batch calls. Telemetry (Prometheus /metrics,
spans under --trace-jsonl), the SLO engine over a time-series ring, the
hang watchdog, deadlines, queue-depth shedding, SIGTERM drain with a
flight-record dump, per-tenant fair queues and token buckets, and the
auth gate under secure=True wrap both.

Endpoints:
  GET  /                  the chat page (serving/webui.py)
  GET  /health            liveness + model info
  GET  /healthz           readiness: 503 while the engine warms up (and
                          after a failed warmup), 200 + scheduler state
                          once serving
  GET  /metrics           Prometheus text exposition of the registry
  GET  /metrics/history   the time-series ring (?seconds=&max_points=)
  GET  /slo               SLO burn-rate verdicts
  GET  /stats             session counters
  POST /v1/generate       {"prompt": str, "max_new_tokens"?, "temperature"?,
                           "top_p"?, "top_k"?, "repetition_penalty"?,
                           "timeout_s"?} -> {"text", "tokens", ...}
  POST /v1/chat           {"messages": [{"role","content"},...]} or
                           {"message": str} -> {"reply", ...}
  POST /v1/auth           {"user","password"} -> {"token"} (secure mode)

Both generation endpoints accept {"stream": true} and then answer as
text/event-stream: one `data: {"token", "delta"}` frame per token, a final
`data: {"done": true, <text|reply>, tokens, latency_s, stopped}` frame,
and `data: [DONE]`. {"speculative": true} composes with both on greedy
requests (generate_speculative / generate_stream_speculative).

Where the port differs from the JAX server: a failed warmup keeps /healthz
at 503 (the JAX server opens the gate anyway), since a card whose kernels
did not run must not take traffic; /stats carries the scheduler's
`decode_seconds` (host wall inside decode steps) and `tick_seconds` (host
wall of each decode tick: the step and its bookkeeping, i.e. telemetry,
events, token emits and finishes).

Fleet hooks (serving/router.py, serving/page_share.py): with
`page_share=<router url>` a replica reports the chain keys of its flushed
harvests to the router's page index, pulls pages of a cold chain from the
sibling that owns them, and serves its own cached pages raw at
`GET /pages/<key>` (the LPG1 frame of inference/kv_pool.py).
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import queue
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import torch

from luminaai_tpu_torch.monitoring.events import FlightRecorder, get_recorder
from luminaai_tpu_torch.monitoring.slo import SLOEngine, build_slo_stack
from luminaai_tpu_torch.monitoring.timeseries import (
    TimeSeriesRing,
    get_history,
    set_history,
)
from luminaai_tpu_torch.monitoring.watchdog import HangWatchdog, StepTimeSentinel
from luminaai_tpu_torch.monitoring.telemetry import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
    get_registry,
    register_build_info,
    weak_callback,
)
from luminaai_tpu_torch.monitoring.tracing import NULL_TRACER, SpanTracer
from luminaai_tpu_torch.security.auth import ANON_TENANT, tenant_hash

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 1 << 20  # 1MB request cap (input_validator also re-checks)

# Shape an inbound X-Request-Id must match to be honored (router-minted
# ids are 12 hex chars; anything else sane is fine, garbage is not).
REQUEST_ID_RX = re.compile(r"[A-Za-z0-9_-]{1,64}")

# A prefix-cache chain key (sha256 hex): the only shape GET /pages/<key>
# accepts.
PAGE_KEY_RX = re.compile(r"[0-9a-f]{64}")


def _device_index(dev) -> Optional[int]:
    """The card index a worker thread must make current for a model on
    `dev`, resolved in the constructing thread (a bare "cuda" means that
    thread's current device); None for the CPU and for engine doubles
    without a device."""
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return torch.cuda.current_device() if dev.index is None else dev.index
    return None


def _set_device(index: Optional[int]) -> None:
    if index is not None:
        torch.cuda.set_device(index)


def new_request_id() -> str:
    """Per-request correlation id: short enough for log lines and SSE
    frames, random enough to never collide within a flight record."""
    return uuid.uuid4().hex[:12]


class RequestTimeout(Exception):
    """A request's deadline passed before it finished: the scheduler
    evicted its lane (or refused admission). Blocking submits surface it
    as HTTP 504; SSE streams get an error frame (docs/resilience.md)."""


class MicroBatcher:
    """Collects concurrent generation requests into one batched decode.

    Handler threads `submit()` and block; a single worker thread pulls the
    first request, waits up to `window_ms` for more with IDENTICAL
    sampling parameters (one batch samples every lane alike), and
    runs them through `engine.generate_batch` — one card step then serves
    every stream's next token instead of one. Mismatched-parameter
    requests are requeued for the next cycle, so nothing starves.
    """

    def __init__(self, engine, max_batch: int = 8, window_ms: float = 15.0,
                 recorder: Optional[FlightRecorder] = None,
                 telemetry: bool = True):
        self.engine = engine
        self.max_batch = max(1, int(max_batch))
        self.window = max(0.0, float(window_ms)) / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        self.batches = 0
        self.max_batch_seen = 0
        self._busy = False  # a batch is being generated right now
        # Identity-aware accounting parity with the continuous path:
        # submit() strips the request_id/tenant riders the server
        # attaches (they must never reach generate_batch) and emits the
        # same admitted/completed lifecycle events, so /metrics
        # per-tenant series and the flight trail stay honest when the
        # fallback path (--no-continuous) is serving.
        self.telemetry = bool(telemetry)
        self.recorder = recorder if recorder is not None else get_recorder()
        self._device = _device_index(
            getattr(getattr(engine, "model", None), "device", None))
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def queue_depth(self) -> int:
        return self.q.qsize()

    def idle(self) -> bool:
        """Nothing queued and nothing generating (drain completion)."""
        return self.q.empty() and not self._busy

    def submit(
        self, prompt_tokens: List[int], gen_kwargs: Dict[str, Any]
    ) -> Tuple[List[int], Dict[str, Any]]:
        # Identity riders are host metadata, never engine kwargs (the
        # same strip-before-batch-key contract the continuous
        # scheduler's _make_request applies).
        gen_kwargs = dict(gen_kwargs)
        request_id = gen_kwargs.pop("request_id", None)
        tenant = gen_kwargs.pop("tenant", None) or ANON_TENANT
        gen_kwargs.pop("timeout_s", None)  # run-to-completion path
        t0 = time.time()
        if self.telemetry and request_id is not None:
            self.recorder.emit(
                "request_admitted", request_id=request_id, tenant=tenant,
                scheduler="micro_batch",
                prompt_tokens=len(prompt_tokens),
            )
        ev = threading.Event()
        slot: Dict[str, Any] = {}
        resolve = getattr(self.engine, "_resolve_gen_key", None)
        if resolve is not None:
            # Group by the RESOLVED batch key, so a request passing an
            # explicit config-default value still batches with one that
            # omitted it.
            key = resolve(
                gen_kwargs.get("max_new_tokens"),
                gen_kwargs.get("temperature"),
                gen_kwargs.get("top_p"),
                gen_kwargs.get("top_k"),
                gen_kwargs.get("repetition_penalty"),
            )
        else:  # duck-typed engines without the helper
            key = tuple(sorted(gen_kwargs.items()))
        self.q.put((prompt_tokens, key, gen_kwargs, ev, slot))
        ev.wait()
        if "error" in slot:
            raise slot["error"]
        tokens, stats = slot["result"]
        if request_id is not None:
            # The reply payload correlates on these like the continuous
            # path's stats do.
            stats = {**stats, "request_id": request_id, "tenant": tenant}
            if self.telemetry:
                self.recorder.emit(
                    "request_completed", request_id=request_id,
                    tenant=tenant, scheduler="micro_batch",
                    tokens=len(tokens),
                    seconds=round(time.time() - t0, 3),
                    stopped=stats.get("stopped"),
                )
        return tokens, stats

    def _loop(self) -> None:
        # Batched generations run on this thread: it sets the card as its
        # current device.
        _set_device(self._device)
        while True:
            first = self.q.get()
            self._busy = True
            batch = [first]
            requeue = []
            deadline = time.time() + self.window
            while len(batch) < self.max_batch:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt[1] == first[1]:
                    batch.append(nxt)
                else:
                    requeue.append(nxt)
            for item in requeue:
                self.q.put(item)
            try:
                results = self.engine.generate_batch(
                    [item[0] for item in batch], **batch[0][2]
                )
                for item, res in zip(batch, results):
                    item[4]["result"] = res
            except Exception as e:  # deliver, don't kill the worker
                logger.exception("batched generation failed")
                for item in batch:
                    item[4]["error"] = e
            finally:
                self.batches += 1
                self.max_batch_seen = max(self.max_batch_seen, len(batch))
                for item in batch:
                    item[3].set()
                self._busy = False


class _ContinuousRequest:
    """One in-flight request inside the ContinuousScheduler: its prompt,
    resolved budgets, and the sink its tokens stream into (a Queue for
    SSE streams, an Event + result for blocking submits)."""

    def __init__(self, prompt, max_new, sample_key, seed, stream,
                 deadline=None, request_id=None, tenant=ANON_TENANT):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.sample_key = sample_key
        self.seed = seed
        self.deadline = deadline  # absolute wall time; None = no limit
        # Identity for the wide-event trail and per-tenant accounting:
        # every lifecycle event this request produces carries both.
        self.request_id = request_id or new_request_id()
        self.tenant = tenant or ANON_TENANT
        self.stream = bool(stream)
        self.sink: "queue.Queue" = queue.Queue() if stream else None
        self.event = None if stream else threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.tokens: List[int] = []
        self.cancelled = False
        self.done = False
        self.slot: Optional[int] = None
        self.prompt_tokens = 0
        self.admitted_step: Optional[int] = None
        self.t0 = time.time()


class ContinuousScheduler:
    """Continuous (in-flight) batching over a slot-paged KV pool.

    Replaces the MicroBatcher's run-to-completion batches for engines
    exposing the step-wise decode API (GenerationEngine.make_stepwise):
    a single worker owns the decode loop, and EVERY step it (1) frees the
    slots of finished lanes, (2) admits queued requests into freed slots
    (prefill-then-join), and (3) advances all active lanes one token in
    one decode step. Early finishers stop costing card steps the moment
    they stop, p50 latency decouples from the slowest request in flight,
    and, because max_new is host state, mixed-length workloads share one
    decode batch instead of splitting into per-length micro-batches.

    Sampling parameters DO remain a batch key (one decode step samples
    every lane with them), so one "generation" admits only requests with an identical
    resolved sampling key; a mismatched request parks in `_pending`, new
    admissions pause, the active lanes drain, and the scheduler switches
    keys — bounded-latency FIFO across keys rather than starvation.

    Tokens stream out per-slot as they decode: `submit()` blocks like the
    MicroBatcher, `submit_stream()` returns a generator with the engine
    generate_stream contract (ints, then a stats dict) that the existing
    SSE path consumes unchanged; closing it cancels the lane at the next
    step, so a gone client stops costing decode immediately.
    """

    def __init__(
        self,
        engine,
        num_slots: int = 8,
        page_size: int = 128,
        admission_window_ms: float = 0.0,
        max_slot_tokens: Optional[int] = None,
        decoder=None,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[SpanTracer] = None,
        telemetry: bool = True,
        latency_buckets=DEFAULT_LATENCY_BUCKETS,
        request_timeout_s: Optional[float] = None,
        recorder: Optional[FlightRecorder] = None,
        max_tenants: int = 64,
        tick_every: int = 16,
        prefill_chunk_tokens: Optional[int] = None,
        prefix_cache_pages: Optional[int] = None,
        prefix_cache_tenant_quota: Optional[int] = None,
        tenant_weights: Optional[Dict[str, int]] = None,
        watchdog: Optional[HangWatchdog] = None,
        page_share=None,
    ):
        self.engine = engine
        # Hang watchdog (monitoring/watchdog.py): armed per generation,
        # beaten once per decode step — a stuck decode step fires
        # hang_suspected + serving_hangs_total and dumps forensics
        # (abort semantics are the watchdog's, not the scheduler's).
        self.watchdog = watchdog
        # Default per-request deadline; a request's own timeout_s can only
        # shorten it. None = no deadline unless the request asks for one.
        self.request_timeout_s = request_timeout_s
        if decoder is None:
            decoder = engine.make_stepwise(
                num_slots=num_slots,
                page_size=page_size,
                max_slot_tokens=max_slot_tokens,
                prefill_chunk_tokens=prefill_chunk_tokens,
                prefix_cache_pages=prefix_cache_pages,
                prefix_cache_tenant_quota=prefix_cache_tenant_quota,
            )
        self.decoder = decoder
        # Cross-replica page plane (serving/page_share.py): the client goes
        # into the decoder so cold admissions consult the fleet index; only
        # where the decoder has a prefix cache to land pulled pages in.
        self.page_share = page_share
        if page_share is not None and (
            getattr(decoder, "prefix_cache", None) is not None
        ):
            decoder.page_share = page_share
        # Fair-share admission (tenant QoS): queued requests park in
        # per-tenant FIFOs and are dequeued WEIGHTED ROUND-ROBIN across
        # tenants, so one hot tenant flooding the intake cannot starve
        # the rest. tenant_weights maps tenant LABEL (hashed identity) ->
        # dequeues per round (priority lanes: weight n tenants drain up
        # to n requests per rotation); default weight 1.
        self.tenant_weights: Dict[str, int] = {
            str(k): max(1, int(v))
            for k, v in (tenant_weights or {}).items()
        }
        self._tq: Dict[str, Any] = {}  # tenant -> deque of requests
        self._rr: List[str] = []  # round-robin rotation order
        self._credits: Dict[str, int] = {}  # WRR dequeues used this turn
        # The worker owns _tq's CONTENTS, but queue_depth() iterates it
        # from request threads (_shed) and /metrics scrapes — guard the
        # dict's shape so a new tenant's insert can never crash a
        # concurrent depth read with "dict changed size during
        # iteration".
        self._tq_lock = threading.Lock()
        # Admissions mid-prefill: slot -> (request, decoder chunk state,
        # admission timestamp). The worker advances ONE chunk per loop
        # tick, interleaved with decode steps, so a long prompt cannot
        # stall concurrent lanes for more than ~one chunk's step time.
        self._prefilling: Dict[int, Tuple[Any, Any, float, float]] = {}
        self.q: "queue.Queue" = queue.Queue()
        self.window = max(0.0, float(admission_window_ms)) / 1000.0
        # Stat names shared with MicroBatcher so /stats stays stable:
        # batches = generations (one sampling key each), max_batch_seen =
        # peak concurrent lanes.
        self.batches = 0
        self.max_batch_seen = 0
        self.requests_served = 0
        # Host wall inside decode steps (decode_step ends reading the
        # sampled tokens back, so it spans the step's device work).
        self.decode_seconds = 0.0
        # Host wall of whole decode ticks: the step plus the per-step
        # bookkeeping after it (telemetry, events, emits, finishes).
        self.tick_seconds = 0.0
        self._pending: List[_ContinuousRequest] = []
        self._busy = False  # a generation cycle is running right now
        # Submit-to-terminal request count: covers the dequeue→prefill
        # window where a request is in neither the queue nor a lane.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # Wide-event flight recorder (monitoring/events.py): request
        # lifecycle events keyed by request_id + tenant. Rides the same
        # off switch as the metrics so the overhead A/B stays honest.
        self.recorder = recorder if recorder is not None else get_recorder()
        self.max_tenants = max(1, int(max_tenants))
        self.tick_every = max(1, int(tick_every))
        # Liveness stamp for /healthz staleness: wall ts of the last
        # completed decode step. None until the first tick (an idle
        # scheduler is not stale — only a busy one that stopped ticking).
        self.last_tick_ts: Optional[float] = None
        self._closing = False
        self._device = _device_index(getattr(self.decoder, "device", None))
        self._init_telemetry(registry, tracer, telemetry, latency_buckets)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _init_telemetry(self, registry, tracer, telemetry, buckets) -> None:
        """Registry wiring: per-request latency histograms (recorded on
        the hot path only when `telemetry` — the off switch is the A/B
        for the overhead budget test) plus pull-time KV-pool gauges,
        which cost nothing until /metrics is scraped."""
        self.telemetry = bool(telemetry)
        self.registry = registry or get_registry()
        self.tracer = tracer or NULL_TRACER
        r = self.registry
        self._m_queue_wait = r.histogram(
            "serve_queue_wait_seconds",
            "Submit-to-admission wait (slot contention + key parking)",
            buckets=buckets,
        )
        self._m_prefill = r.histogram(
            "serve_prefill_seconds",
            "prefill_into_slot duration (prompt KV write + first token)",
            buckets=buckets,
        )
        self._m_ttft = r.histogram(
            "serve_ttft_seconds",
            "Submit-to-first-token latency per request",
            buckets=buckets,
        )
        self._m_step = r.histogram(
            "serve_decode_step_seconds",
            "One scheduler decode step (all active lanes, one forward)",
            buckets=buckets,
        )
        self._m_token = r.histogram(
            "serve_token_latency_seconds",
            "Per-token decode latency (step duration, one observation "
            "per lane that produced a token)",
            buckets=buckets,
        )
        # Step-time anomaly sentinel (docs/observability.md "Goodput &
        # sentinels"): robust rolling median/MAD over decode-step
        # durations — serve_decode_step_seconds_{median,mad} gauges plus
        # step_anomaly events when one step blows past the distribution.
        self._sentinel = StepTimeSentinel(
            registry=r,
            recorder=self.recorder if self.telemetry else None,
            prefix="serve_decode_step_seconds",
            program="serve",
        )
        self._m_admissions = r.counter(
            "serve_admissions_total", "Requests admitted into a KV slot"
        )
        self._m_evictions = r.counter(
            "serve_evictions_total",
            "Slots released (finished, cancelled, or failed lanes)",
        )
        self._m_generations = r.counter(
            "serve_generations_total",
            "Generations started (one sampling key each)",
        )
        self._m_decode_steps = r.counter(
            "serve_decode_steps_total", "Scheduler decode steps executed"
        )
        self._m_timeouts = r.counter(
            "serving_requests_timed_out_total",
            "Requests evicted (or refused admission) because their "
            "deadline passed before completion",
        )
        self._m_prefill_chunks = r.counter(
            "serving_prefill_chunks_total",
            "Prefill chunks executed by the scheduler (chunked prefill "
            "interleaves these with decode steps)",
        )
        # Per-tenant accounting (bounded: max_tenants distinct labels,
        # then the registry's `_overflow` bucket — a tenant label can
        # never explode /metrics).
        self._m_tenant_ttft = r.histogram(
            "tenant_ttft_seconds",
            "Submit-to-first-token latency per tenant",
            buckets=buckets,
            labelnames=("tenant",),
            max_label_values=self.max_tenants,
        )
        self._m_tenant_timeouts = r.counter(
            "tenant_requests_timed_out_total",
            "Deadline-evicted (or admission-refused) requests per tenant",
            labelnames=("tenant",),
            max_label_values=self.max_tenants,
        )
        # Callback gauges hold WEAK refs: the process registry outlives
        # any one scheduler, and a strong closure would pin a replaced
        # scheduler's whole KV pool and export its stale state forever.
        r.gauge(
            "serve_active_lanes", "Lanes currently decoding"
        ).set_function(weak_callback(self, lambda s: s._active_lanes))
        r.gauge(
            "serve_queue_depth",
            "Requests waiting for admission (queued + key-parked)",
        ).set_function(weak_callback(self, lambda s: s.queue_depth()))
        self._active_lanes = 0
        pool = getattr(self.decoder, "pool", None)
        if pool is not None and hasattr(pool, "stats"):
            def pool_gauge(name, help_text, key):
                r.gauge(name, help_text).set_function(
                    weak_callback(pool, lambda p: p.stats().get(key, 0))
                )

            pool_gauge("kv_pool_slots_in_use", "KV pool slots allocated",
                       "in_use")
            pool_gauge("kv_pool_slots_free", "KV pool slots free", "free")
            pool_gauge("kv_pool_slot_reuses_total",
                       "Times a previously-used slot was re-issued",
                       "reuses")
            pool_gauge("kv_pool_pages_in_use",
                       "Pages holding live KV rows", "pages_in_use")
            pool_gauge("kv_pool_pages_total", "Total pool pages",
                       "pages_total")
            pool_gauge(
                "kv_pool_fragmentation_rows",
                "Rows lost to page rounding (allocated but not live)",
                "fragmentation_rows",
            )
        # Prefix cache (inference/prefix_cache.py): hit/miss/savings
        # counters observed at admission, plus pull-time occupancy /
        # refcount / eviction gauges straight off the cache's stats.
        self._m_prefix_hits = r.counter(
            "serve_prefix_cache_hits_total",
            "Admissions that spliced at least one cached prefix page",
        )
        self._m_prefix_misses = r.counter(
            "serve_prefix_cache_misses_total",
            "Chunked admissions that found no cached prefix",
        )
        self._m_prefix_saved = r.counter(
            "serve_prefill_tokens_saved_total",
            "Prompt tokens whose prefill was skipped via cached prefix "
            "pages",
        )
        self._m_prefix_remote_hits = r.counter(
            "serve_prefix_remote_hits_total",
            "Admissions whose prefix hit rode pages pulled from another "
            "replica (cross-replica page sharing)",
        )
        # Tenant-keyed cache residency rides under the same label budget
        # as every other tenant series (`lumina analyze` LX009 enforces
        # the max_label_values declaration).
        self._m_tenant_prefix_pages = r.gauge(
            "tenant_prefix_cache_pages",
            "Arena pages currently cached per owning tenant",
            labelnames=("tenant",),
            max_label_values=self.max_tenants,
        )
        cache = getattr(self.decoder, "prefix_cache", None)
        if cache is not None:
            # prefix_evict flight events ride the scheduler's recorder,
            # honoring the same telemetry off switch.
            cache.recorder = self.recorder if self.telemetry else None

            def cache_gauge(name, help_text, key):
                r.gauge(name, help_text).set_function(
                    weak_callback(cache, lambda c: c.stats().get(key, 0))
                )

            cache_gauge("prefix_cache_pages_cached",
                        "Arena pages holding cached prefix KV",
                        "pages_cached")
            cache_gauge("prefix_cache_pages_free",
                        "Arena pages free for harvest", "pages_free")
            cache_gauge("prefix_cache_page_refs",
                        "Live lane references onto cached pages "
                        "(sharing fan-out)", "page_refs")
            cache_gauge("prefix_cache_evictions",
                        "Cached pages LRU-evicted since start",
                        "evictions")
            cache_gauge("prefix_cache_pages_budget",
                        "Configured arena page budget "
                        "(--prefix-cache-pages)", "capacity_pages")

    def queue_depth(self) -> int:
        with self._tq_lock:
            parked = sum(len(d) for d in self._tq.values())
        return self.q.qsize() + len(self._pending) + parked

    # -- fair-share tenant queues (worker thread only) ---------------------
    def _enqueue_tenant(self, req: "_ContinuousRequest") -> None:
        from collections import deque

        if req is None:  # close()'s wake-up
            return
        t = req.tenant or ANON_TENANT
        dq = self._tq.get(t)
        if dq is None:
            with self._tq_lock:
                dq = self._tq[t] = deque()
            self._rr.append(t)
        dq.append(req)

    def _drain_intake(self) -> None:
        """Move everything waiting on the intake queue into the
        per-tenant FIFOs (worker thread only — submit() threads touch
        only self.q)."""
        while True:
            try:
                self._enqueue_tenant(self.q.get_nowait())
            except queue.Empty:
                return

    def _next_queued(self) -> Optional["_ContinuousRequest"]:
        """Weighted round-robin dequeue across tenant queues: each
        rotation visits tenants in arrival order, draining up to
        `tenant_weights[t]` (default 1) requests before moving on —
        a tenant with 50 queued requests and a tenant with 1 alternate
        instead of the flood going first (contract-tested: the starved
        tenant's queue keeps draining under a hot-tenant flood)."""
        if not self._rr:
            return None
        # One WRR credit per call: rotate to the next tenant with work,
        # respecting per-tenant weight via a running credit counter.
        for _ in range(len(self._rr)):
            t = self._rr[0]
            dq = self._tq.get(t)
            if not dq:
                # Empty queue: drop the tenant from the rotation (it
                # re-registers on its next submit).
                self._rr.pop(0)
                with self._tq_lock:
                    self._tq.pop(t, None)
                self._credits.pop(t, None)
                continue
            used = self._credits.get(t, 0)
            if used + 1 >= self.tenant_weights.get(t, 1):
                # Weight exhausted after this dequeue: rotate.
                self._credits[t] = 0
                self._rr.append(self._rr.pop(0))
            else:
                self._credits[t] = used + 1
            return dq.popleft()
        return None

    def idle(self) -> bool:
        """No request anywhere between submit and its terminal
        finish/fail (drain completion). Counted submit-to-terminal, so
        the dequeue→prefill window — where a request is in neither the
        queue nor a lane — can never make drain() declare completion and
        shut the server down on top of the request it exists to
        protect."""
        with self._inflight_lock:
            return self._inflight == 0 and not self._busy

    def _track(self, req: _ContinuousRequest) -> _ContinuousRequest:
        with self._inflight_lock:
            self._inflight += 1
        return req

    def _untrack(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    # -- public API --------------------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker once the work already queued is done, so the
        scheduler (and the KV pool on the card it holds) can be freed by
        an embedder that cycles servers."""
        self._closing = True
        self.q.put(None)
        self._worker.join(timeout)

    def submit(
        self, prompt_tokens: List[int], gen_kwargs: Dict[str, Any]
    ) -> Tuple[List[int], Dict[str, Any]]:
        req = self._track(
            self._make_request(prompt_tokens, gen_kwargs, stream=False)
        )
        self.q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def submit_stream(
        self, prompt_tokens: List[int], gen_kwargs: Dict[str, Any]
    ):
        """Generator with the generate_stream contract: token ints as the
        lane decodes them, then one final stats dict. Closing it flags the
        request cancelled; the worker frees the slot at the next step."""
        req = self._track(
            self._make_request(prompt_tokens, gen_kwargs, stream=True)
        )
        self.q.put(req)

        def events():
            try:
                while True:
                    item = req.sink.get()
                    if isinstance(item, BaseException):
                        raise item
                    yield item
                    if isinstance(item, dict):
                        return
            finally:
                req.cancelled = True

        return events()

    def stats(self) -> Dict[str, Any]:
        out = {
            "scheduler": "continuous",
            "batches": self.batches,
            "max_batch_seen": self.max_batch_seen,
            "decode_steps": int(getattr(self.decoder, "steps", 0)),
            "active_lanes": self._active_lanes,
            "queue_depth": self.queue_depth(),
            "prefilling": len(self._prefilling),
            "decode_seconds": round(self.decode_seconds, 6),
            "tick_seconds": round(self.tick_seconds, 6),
        }
        pool = getattr(self.decoder, "pool", None)
        if pool is not None and hasattr(pool, "stats"):
            out["kv_pool"] = pool.stats()
        cache = getattr(self.decoder, "prefix_cache", None)
        if cache is not None:
            out["prefix_cache"] = cache.stats()
        return out

    # -- internals ---------------------------------------------------------
    def _make_request(self, prompt_tokens, gen_kwargs, stream):
        # Identity riders are host metadata, never batch keys: strip
        # them before sampling-key resolution so two tenants' otherwise
        # identical requests still share one decode batch.
        gen_kwargs = dict(gen_kwargs)
        request_id = gen_kwargs.pop("request_id", None)
        tenant = gen_kwargs.pop("tenant", None)
        resolve = getattr(self.engine, "_resolve_gen_key", None)
        if resolve is not None:
            key = resolve(
                gen_kwargs.get("max_new_tokens"),
                gen_kwargs.get("temperature"),
                gen_kwargs.get("top_p"),
                gen_kwargs.get("top_k"),
                gen_kwargs.get("repetition_penalty"),
            )
            max_new, sample_key = key[0], tuple(key[1:])
        else:  # duck-typed engines without the helper
            max_new = int(gen_kwargs.get("max_new_tokens") or 16)
            sample_key = tuple(
                sorted(
                    (k, v)
                    for k, v in gen_kwargs.items()
                    if k not in ("max_new_tokens", "seed", "timeout_s")
                )
            )
        cap = int(
            getattr(self.decoder, "token_capacity", 0)
            or getattr(self.decoder, "slot_tokens", 0)
        ) or None
        if cap:
            # A slot must hold prompt tail + budget; the prompt trims but
            # the budget can only clamp. token_capacity (not the page-
            # rounded slot size) keeps decode inside the engine's
            # max_context contract.
            max_new = max(1, min(max_new, cap - 1))
        timeout = gen_kwargs.get("timeout_s") or self.request_timeout_s
        if timeout and self.request_timeout_s:
            timeout = min(float(timeout), float(self.request_timeout_s))
        return _ContinuousRequest(
            prompt_tokens, max_new, sample_key,
            gen_kwargs.get("seed"), stream,
            deadline=(time.time() + float(timeout)) if timeout else None,
            request_id=request_id, tenant=tenant,
        )

    def _emit(self, req: _ContinuousRequest, token: int) -> None:
        req.tokens.append(int(token))
        if req.stream:
            req.sink.put(int(token))

    def _event(self, type: str, req: Optional[_ContinuousRequest] = None,
               **fields) -> None:
        """Append one lifecycle event to the flight recorder, stamped
        with the request's identity. Same off switch as the metrics."""
        if not self.telemetry:
            return
        if req is not None:
            fields.setdefault("request_id", req.request_id)
            fields.setdefault("tenant", req.tenant)
        self.recorder.emit(type, **fields)

    def _finish(self, req: _ContinuousRequest, stopped: str) -> None:
        if req.done:
            return  # terminal already delivered
        dt = time.time() - req.t0
        n = len(req.tokens)
        stats = {
            "tokens_generated": n,
            "seconds": round(dt, 3),
            "tokens_per_second": round(n / max(dt, 1e-9), 1),
            "prompt_tokens": req.prompt_tokens,
            "stopped": stopped,
            "slot": req.slot,
            "admitted_step": req.admitted_step,
            "finished_step": int(getattr(self.decoder, "steps", 0)),
            "scheduler": "continuous",
            "request_id": req.request_id,
            "tenant": req.tenant,
        }
        self.requests_served += 1
        req.done = True
        self._untrack()
        self._event(
            "request_completed", req,
            slot=req.slot, tokens=n, prompt_tokens=req.prompt_tokens,
            seconds=round(dt, 3), stopped=stopped,
            step=int(getattr(self.decoder, "steps", 0)),
        )
        if req.stream:
            req.sink.put(stats)
        else:
            req.result = (req.tokens, stats)
            req.event.set()

    def _fail(self, req: _ContinuousRequest, err: BaseException) -> None:
        if req.done:
            return  # terminal already delivered
        req.done = True
        self._untrack()
        self._event(
            "request_evicted", req,
            slot=req.slot, tokens=len(req.tokens),
            reason=(
                "timeout" if isinstance(err, RequestTimeout) else "error"
            ),
            error=str(err)[:200],
        )
        if req.stream:
            req.sink.put(err)
        else:
            req.error = err
            req.event.set()

    def _timeout(self, req: _ContinuousRequest, where: str) -> None:
        """Deadline enforcement: a lane past its deadline stops costing
        decode steps NOW (eviction frees the slot for queued work) and the
        client gets an explicit timeout instead of an open-ended wait."""
        if self.telemetry:
            self._m_timeouts.inc()
            self._m_tenant_timeouts.labels(tenant=req.tenant).inc()
        waited = time.time() - req.t0
        self._fail(req, RequestTimeout(
            f"deadline exceeded after {waited:.1f}s ({where}; "
            f"{len(req.tokens)} tokens generated)"
        ))

    def _release_slot(self, slot: int) -> None:
        """Single choke point for giving a slot back: the decoder free +
        the eviction count must never drift apart across the four
        release sites."""
        self.decoder.release_slot(slot)
        if self.telemetry:
            self._m_evictions.inc()

    def _release(self, req: _ContinuousRequest, active: dict) -> None:
        self._release_slot(req.slot)
        active.pop(req.slot, None)
        self._active_lanes = len(active)

    def _admit(self, req: _ContinuousRequest, active: dict) -> None:
        """Prefill-then-join: the request's prompt KV lands in a freed
        slot and its first token streams out immediately; the lane joins
        the shared decode from the next step."""
        if req.cancelled:
            self._finish(req, "cancelled")
            return
        if req.deadline is not None and time.time() > req.deadline:
            # Expired while queued (slot contention / key parking): refuse
            # admission rather than spend prefill on a dead request.
            self._timeout(req, "while queued")
            return
        with self._wd_pause():
            self._admit_paused(req, active)

    def _admit_paused(self, req: _ContinuousRequest, active: dict) -> None:
        """_admit's body, under the watchdog pause: the prefill below can
        take far longer than a decode step (a long prompt, the first build
        and load of a kernel library), which would skew the rolling
        decode-step stats. The pause lives HERE — exactly where
        prefill work happens — not per tick: pausing on a merely-nonempty
        queue would exclude every interval on a saturated server and
        starve the warmup, leaving real decode hangs undetectable."""
        slot = self.decoder.acquire_slot()
        t_admit = time.perf_counter()
        queue_wait = max(0.0, time.time() - req.t0)
        if self.telemetry:
            # Queue wait = submit to slot acquisition: covers both slot
            # contention and sampling-key parking.
            self._m_queue_wait.observe(queue_wait)
            self._m_admissions.inc()
        self._event(
            "request_admitted", req,
            slot=slot, queue_wait_s=round(queue_wait, 4),
            prompt_tokens=len(req.prompt),
            step=int(getattr(self.decoder, "steps", 0)),
        )
        start = getattr(self.decoder, "start_prefill", None)
        if start is not None and getattr(self.decoder, "prefill_chunk", 0):
            try:
                st = start(
                    slot,
                    req.prompt,
                    max_new_tokens=req.max_new,
                    sample_key=req.sample_key,
                    seed=req.seed,
                    # Tenant rider: the prefix cache attributes harvested
                    # pages per tenant (quota enforcement).
                    tenant=req.tenant,
                )
            except Exception as e:
                logger.exception("start-prefill failed")
                self._release_slot(slot)
                self._fail(req, e)
                return
            if st is not None:
                # Chunks run from the worker loop, one per tick,
                # interleaved with decode steps (_advance_prefills). The
                # trailing 0.0 accumulates per-chunk compute seconds so
                # serve_prefill_seconds stays a prefill-cost histogram
                # rather than absorbing every interleaved decode tick.
                self._prefilling[slot] = (req, st, t_admit, 0.0)
                return
        try:
            with self.tracer.span(
                "prefill", slot=slot, prompt_tokens=len(req.prompt)
            ):
                info = self.decoder.prefill_into_slot(
                    slot,
                    req.prompt,
                    max_new_tokens=req.max_new,
                    sample_key=req.sample_key,
                    seed=req.seed,
                )
        except Exception as e:
            logger.exception("prefill-into-slot failed")
            self._release_slot(slot)
            self._fail(req, e)
            return
        self._prefill_done(req, slot, info, t_admit, active)

    def _prefill_done(self, req, slot, info, t_admit, active,
                      prefill_s=None) -> None:
        """Shared prompt-prefilled tail for the whole-prompt and chunked
        admission paths: TTFT booking, first-token emission, lane
        activation (or immediate finish). `prefill_s` is the prefill
        COMPUTE time — the chunked path passes its per-chunk sum so the
        histogram keeps one meaning across both admission paths (the
        monolithic path's admission-to-done wall time IS its compute)."""
        ttft = max(0.0, time.time() - req.t0)
        if prefill_s is None:
            prefill_s = time.perf_counter() - t_admit
        if self.telemetry:
            self._m_prefill.observe(prefill_s)
            # First token is sampled inside prefill, so TTFT lands here.
            self._m_ttft.observe(ttft)
            self._m_tenant_ttft.labels(tenant=req.tenant).observe(ttft)
        self._event(
            "request_prefill", req, slot=slot,
            prefill_s=round(prefill_s, 4),
            prompt_tokens=int(info.get("prompt_tokens", 0)),
        )
        self._event("request_first_token", req, slot=slot,
                    ttft_s=round(ttft, 4))
        prefix = info.get("prefix") if isinstance(info, dict) else None
        if prefix is not None:
            if self.telemetry:
                if prefix.get("hit_pages"):
                    self._m_prefix_hits.inc()
                else:
                    self._m_prefix_misses.inc()
                saved = int(prefix.get("tokens_saved", 0))
                if saved:
                    self._m_prefix_saved.inc(saved)
                cache = getattr(self.decoder, "prefix_cache", None)
                if cache is not None:
                    t = prefix.get("tenant") or req.tenant
                    self._m_tenant_prefix_pages.labels(tenant=t).set(
                        cache.tenant_pages(t)
                    )
            if prefix.get("hit_pages"):
                self._event(
                    "prefix_hit", req, slot=slot,
                    pages=int(prefix["hit_pages"]),
                    tokens_saved=int(prefix.get("tokens_saved", 0)),
                )
            remote = prefix.get("remote")
            if isinstance(remote, dict) and remote.get("pulled"):
                if self.telemetry:
                    self._m_prefix_remote_hits.inc()
                self._event(
                    "prefix_remote_hit", req, slot=slot,
                    owner=remote.get("owner"),
                    pages=int(remote.get("pulled", 0)),
                    tokens=int(remote.get("tokens", 0)),
                    bytes=int(remote.get("bytes", 0)),
                    degraded=bool(remote.get("failed")),
                )
        req.slot = slot
        req.prompt_tokens = int(info.get("prompt_tokens", 0))
        req.admitted_step = int(getattr(self.decoder, "steps", 0))
        if info.get("is_stop"):
            self._finish(req, "eos")
            self._release_slot(slot)
            return
        self._emit(req, info["token"])
        if req.max_new <= 1:
            self._finish(req, "length")
            self._release_slot(slot)
            return
        active[slot] = req
        self._active_lanes = len(active)
        self.max_batch_seen = max(self.max_batch_seen, len(active))

    def _admit_queued(self, key, active: dict) -> None:
        """Admit queued same-key requests into free slots, dequeued
        FAIR-SHARE (weighted round-robin across tenant queues — one hot
        tenant's flood cannot starve the rest; docs/serving.md "Prefix
        cache + tenant QoS"). Once a MISMATCHED-key request is waiting,
        admission pauses so the active lanes drain and the scheduler can
        switch keys (no starvation across sampling keys either)."""
        self._drain_intake()
        while self.decoder.has_free_slot() and not self._pending:
            nxt = self._next_queued()
            if nxt is None:
                break
            if nxt.sample_key == key:
                self._admit(nxt, active)
            else:
                self._pending.append(nxt)

    def _flush_harvests(self) -> None:
        """One bulk page copy for every harvest queued this tick
        (StepwiseDecoder.flush_harvests; no-op without a prefix cache or
        an empty queue), on the worker's stream, before the next decode
        step reads. With page sharing on, the chain keys whose bytes just
        landed (this flush or a remote pull) are reported to the router's
        fleet index off the worker thread."""
        flush = getattr(self.decoder, "flush_harvests", None)
        if flush is not None:
            flush()
        if self.page_share is not None:
            drain = getattr(self.decoder, "drain_landed_keys", None)
            if drain is not None:
                keys = drain()
                if keys:
                    self.page_share.report_async(keys)

    def _advance_prefills(self, active: dict) -> None:
        """Advance ONE chunk of ONE mid-prefill admission (round-robin
        in admission order). Called once per scheduler tick, so prefill
        work interleaves with decode steps instead of stalling them —
        the chunked-prefill latency contract (docs/serving.md).

        Dedup followers parked behind an in-flight identical prefix
        (decoder `waiting` states) re-check for free but must NOT eat
        the tick's single chunk advance — otherwise K parked followers
        would slow their own leader's prefill (and every queued one)
        (K+1)x. A parked re-check cycles to the ring's tail and the
        scan moves on to the first runnable admission; only real chunk
        compute (or a resolution running its first chunk) ends the
        tick."""
        if not self._prefilling:
            return
        with self._wd_pause():
            self._advance_prefills_paused(active)

    def _advance_prefills_paused(self, active: dict) -> None:
        """_advance_prefills' body, watchdog-paused like _admit_paused:
        a chunk advance is prefill work too. Guarded
        by the `_prefilling` check above, so steady decode-only ticks
        never pause and the rolling stats keep warming."""
        for _ in range(max(1, len(self._prefilling))):
            if not self._prefilling:
                return
            slot, (req, st, t_admit, spent) = next(
                iter(self._prefilling.items())
            )
            del self._prefilling[slot]
            if req.cancelled:
                self._finish(req, "cancelled")
                self._release_slot(slot)
                return
            if req.deadline is not None and time.time() > req.deadline:
                self._timeout(req, "mid-prefill")
                self._release_slot(slot)
                return
            was_waiting = bool(st.get("waiting"))
            try:
                t_chunk = time.perf_counter()
                with self.tracer.span("prefill_chunk", slot=slot):
                    info = self.decoder.advance_prefill(st)
                spent += time.perf_counter() - t_chunk
                # A chunk advance is real progress: stamp liveness here
                # too, or a prefill-only window (huge prompt, no active
                # decode lanes) would read as stale to /healthz while
                # the scheduler is genuinely working.
                self.last_tick_ts = time.time()
            except Exception as e:
                logger.exception("chunked prefill failed")
                self._release_slot(slot)
                self._fail(req, e)
                return
            if info is None and was_waiting and st.get("waiting"):
                # Still parked: host-only bookkeeping, no chunk ran and
                # no prefill_chunk event/counter — keep scanning for
                # runnable work this tick.
                self._prefilling[slot] = (req, st, t_admit, spent)
                continue
            if self.telemetry:
                self._m_prefill_chunks.inc()
            self._event(
                "prefill_chunk", req, slot=slot,
                chunk=int(st["next"]), chunks=int(st["n_chunks"]),
                # Rows RESIDENT, spliced prefix included — must agree with
                # the decoder's own residency booking for a prefix hit.
                rows=int(min(
                    int(st.get("start_rows", 0)) + st["next"] * st["chunk"],
                    st["length"],
                )),
            )
            if info is None:
                # More chunks pending: back of the round-robin ring.
                self._prefilling[slot] = (req, st, t_admit, spent)
                return
            self._prefill_done(req, slot, info, t_admit, active,
                               prefill_s=spent)
            return

    def _loop(self) -> None:
        # The worker owns every device call of the scheduler: it sets the
        # card as its current device, so the decode steps, prefill chunks
        # and harvest copies go in order on this thread's stream.
        _set_device(self._device)
        while True:
            if self._pending:
                req = self._pending.pop(0)
            else:
                self._drain_intake()
                req = self._next_queued()
                if req is None:
                    if self._closing:
                        return
                    # Nothing parked anywhere: block for the next submit,
                    # then run it through the same fair-share path.
                    self._enqueue_tenant(self.q.get())
                    self._drain_intake()
                    req = self._next_queued()
                    if req is None:
                        continue
            self._busy = True
            try:
                self._run_generation(req)
            except Exception as e:  # never kill the worker
                logger.exception("continuous scheduler generation failed")
                if not req.done:  # the client must never hang on a bug
                    self._fail(req, e)
            finally:
                self._busy = False

    def _run_generation(self, first: _ContinuousRequest) -> None:
        self.batches += 1
        if self.telemetry:
            self._m_generations.inc()
        if self.watchdog is not None:
            # Watch only while a generation is live: an idle scheduler
            # parked on q.get() must never read as hung.
            self.watchdog.arm()
        try:
            self._run_generation_inner(first)
        finally:
            if self.watchdog is not None:
                self.watchdog.disarm()

    def _wd_pause(self):
        """Watchdog pause for the slow host work between decode steps
        (admission prefills, chunk advances): the trainer's
        skip_next guard, serving-shaped. Callers apply it
        exactly around REAL prefill work, never per tick — pausing every
        tick would exclude every beat interval and starve the rolling
        stats. No-op without a watchdog."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.pause()

    def _run_generation_inner(self, first: _ContinuousRequest) -> None:
        key = first.sample_key
        active: Dict[int, _ContinuousRequest] = {}
        self._admit(first, active)
        # Optional admission window: wait briefly for same-key peers so
        # the first step already carries a batch (a latency/throughput
        # knob, NOT required for joining — lanes join at any later step).
        # Peers are dequeued through the same fair-share WRR path as
        # steady-state admission, so requests already parked in tenant
        # queues go first and a burst inside the window cannot jump them.
        deadline = time.time() + self.window
        while (
            self.window > 0
            and self.decoder.has_free_slot()
            and not self._pending
        ):
            left = deadline - time.time()
            if left <= 0:
                break
            self._drain_intake()
            nxt = self._next_queued()
            if nxt is None:
                try:
                    self._enqueue_tenant(self.q.get(timeout=left))
                except queue.Empty:
                    break
                continue
            if nxt.sample_key == key:
                self._admit(nxt, active)
            else:
                self._pending.append(nxt)
        # Decode-tick accumulator: one SUMMARY event per tick_every steps
        # (per-step events would be all the ring buffer ever holds).
        tick_steps = tick_tokens = 0
        tick_t0 = time.perf_counter()
        while active or self._prefilling:
            self._admit_queued(key, active)
            # One prefill chunk per tick: a long admission progresses
            # without ever costing the decode batch more than one
            # chunk-sized forward between steps (_admit/_advance_prefills
            # pause the watchdog internally, exactly around real prefill
            # work — never on a merely-busy queue).
            self._advance_prefills(active)
            # Harvest batching (ROADMAP item 2): every prefix-cache
            # harvest that landed this tick rides ONE bulk page copy
            # instead of one pool copy per admission.
            self._flush_harvests()
            if not active:
                if self._prefilling:
                    continue
                break
            try:
                t_step = time.perf_counter()
                toks, produced, eos = self.decoder.decode_step(key)
                step_dt = time.perf_counter() - t_step
                self.decode_seconds += step_dt
            except Exception as e:
                logger.exception("decode step failed")
                for r in list(active.values()):
                    self._fail(r, e)
                    self._release(r, active)
                for slot, (r, *_) in list(self._prefilling.items()):
                    self._fail(r, e)
                    self._release_slot(slot)
                self._prefilling.clear()
                return
            if self.watchdog is not None:
                self.watchdog.beat()
            self.last_tick_ts = time.time()
            n_produced = sum(1 for slot in active if produced[slot])
            if self.telemetry:
                self._m_step.observe(step_dt)
                self._sentinel.observe(
                    step_dt, step=int(getattr(self.decoder, "steps", 0))
                )
                self._m_decode_steps.inc()
                # Per-token decode latency: the step IS the inter-token
                # gap for every lane that emitted this step.
                self._m_token.observe(step_dt, count=max(0, n_produced))
            tick_steps += 1
            tick_tokens += max(0, n_produced)
            if tick_steps >= self.tick_every:
                dt_tick = time.perf_counter() - tick_t0
                self._event(
                    "decode_tick",
                    step=int(getattr(self.decoder, "steps", 0)),
                    steps=tick_steps, tokens=tick_tokens,
                    active_lanes=len(active),
                    queue_depth=self.queue_depth(),
                    tokens_per_sec=round(
                        tick_tokens / max(dt_tick, 1e-9), 1
                    ),
                )
                tick_steps = tick_tokens = 0
                tick_t0 = time.perf_counter()
            now = time.time()
            for slot, r in list(active.items()):
                if r.cancelled:
                    self._finish(r, "cancelled")
                    self._release(r, active)
                    continue
                if r.deadline is not None and now > r.deadline:
                    # Overdue lane (slow/stuck decode or an oversized
                    # budget): evict so the slot serves queued work.
                    self._timeout(r, "mid-decode")
                    self._release(r, active)
                    continue
                if eos[slot]:
                    self._finish(r, "eos")
                    self._release(r, active)
                    continue
                if produced[slot]:
                    self._emit(r, int(toks[slot]))
                    full = getattr(self.decoder, "lane_full", None)
                    if len(r.tokens) >= r.max_new or (
                        full is not None and full(slot)
                    ):
                        self._finish(r, "length")
                        self._release(r, active)
            self.tick_seconds += time.perf_counter() - t_step
        # A harvest landing on the generation's last tick must not wait
        # for the next admission's defensive flush.
        self._flush_harvests()


class _SlotStream:
    """Event-stream wrapper that releases its concurrency slot exactly
    once — on exhaustion, error, or close(). A plain generator's finally
    block never runs if the generator is closed before its first next()
    (e.g. the handler's header write fails for an already-gone client),
    which would slowly leak stream slots into permanent 503s."""

    def __init__(self, inner, release):
        self._inner = inner
        self._release = release
        self._released = False

    def _release_once(self) -> None:
        if not self._released:
            self._released = True
            self._release()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._inner)
        except BaseException:
            self._release_once()  # StopIteration included
            raise

    def close(self) -> None:
        try:
            self._inner.close()
        finally:
            self._release_once()


class ChatServer:
    """Owns the engine + optional security stack; builds the handler class."""

    def __init__(
        self,
        engine,
        secure: bool = False,
        bootstrap_user: Optional[tuple] = None,
        users_path: str = "users.json",
        max_new_tokens_cap: int = 2048,
        max_batch: int = 8,
        batch_window_ms: float = 15.0,
        max_streams: int = 4,
        continuous: Any = "auto",
        num_slots: int = 8,
        page_size: int = 128,
        admission_window_ms: float = 0.0,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[SpanTracer] = None,
        telemetry: bool = True,
        latency_buckets=DEFAULT_LATENCY_BUCKETS,
        warmup: bool = False,
        request_timeout_s: Optional[float] = None,
        max_queue_depth: int = 128,
        drain_grace_s: float = 30.0,
        flight_dir: Optional[str] = None,
        max_tenants: int = 64,
        recorder: Optional[FlightRecorder] = None,
        prefill_chunk_tokens: Optional[int] = None,
        prefix_cache_pages: Optional[int] = None,
        prefix_cache_tenant_quota: Optional[int] = None,
        tenant_weights: Optional[Dict[str, int]] = None,
        tenant_rate_per_s: Optional[float] = None,
        tenant_burst: Optional[int] = None,
        watchdog: Any = "auto",
        watchdog_abort: bool = False,
        watchdog_k: Optional[float] = None,
        watchdog_floor_s: Optional[float] = None,
        slo: bool = True,
        slo_config: Optional[str] = None,
        healthz_stale_after_s: Optional[float] = None,
        page_share: Optional[str] = None,
        page_share_self_url: Optional[str] = None,
        page_pull_timeout_s: Optional[float] = None,
        page_share_max_inflight: Optional[int] = None,
    ):
        self.engine = engine
        self.telemetry = bool(telemetry)
        self.registry = registry or get_registry()
        self.tracer = tracer or NULL_TRACER
        # Wide-event trail (monitoring/events.py): request identity is
        # minted at the HTTP layer, lifecycle events come from the
        # scheduler, and drain dumps the ring into flight_dir for
        # `lumina events` (crash forensics; docs/observability.md).
        self.recorder = recorder if recorder is not None else get_recorder()
        self.flight_dir = flight_dir
        self.max_tenants = max(1, int(max_tenants))
        # Graceful degradation (docs/resilience.md): deadlines evict
        # overdue lanes, queue-depth overload sheds with 503+Retry-After,
        # and SIGTERM drains in-flight work before shutdown.
        self.request_timeout_s = request_timeout_s
        self.max_queue_depth = max(0, int(max_queue_depth))
        self.drain_grace_s = float(drain_grace_s)
        self._draining = False
        # Readiness gate for /healthz: a container probe must see 503
        # until a first generation has run through the prefill and decode
        # paths (kernels built and loaded) and flip to 200 the moment
        # requests can actually be served. warmup=True (the `serve` entrypoint)
        # drives a tiny generation through the real batcher path in the
        # background and sets the gate when it completes; in-process
        # embedders/tests default to immediately-ready.
        self._ready = threading.Event()
        # Continuous batching (step-level admission over a slot-paged KV
        # pool) whenever the engine exposes the step-wise decode API;
        # duck-typed engines without it keep the legacy MicroBatcher
        # (continuous=False forces the legacy path for A/B).
        self.continuous = bool(
            continuous is True
            or (continuous == "auto" and hasattr(engine, "make_stepwise"))
        )
        if self.continuous:
            # Serving hang watchdog: "auto" builds one over the flight
            # dir (hang forensics land next to the drain dumps); pass
            # None/False to disable, or a configured HangWatchdog to
            # control thresholds (tests do).
            if watchdog == "auto":
                wd_kw = {}
                if watchdog_k is not None:
                    wd_kw["k"] = float(watchdog_k)
                if watchdog_floor_s is not None:
                    # --watchdog-floor: on cold fleets, raise above the
                    # worst-case first kernel build before enabling abort.
                    wd_kw["floor_s"] = float(watchdog_floor_s)
                watchdog = HangWatchdog(
                    kind="serving",
                    registry=self.registry,
                    recorder=self.recorder,
                    dump_dir=flight_dir,
                    abort=watchdog_abort,
                    **wd_kw,
                )
            self.watchdog = watchdog or None
            # Operator-supplied tenant weights are keyed by RAW identity
            # (or the literal "anon"); hash them here so raw identities
            # never live in scheduler state — the same tenant_hash the
            # gate resolves request identities through.
            weights = {
                (k if k == ANON_TENANT else tenant_hash(str(k))): v
                for k, v in (tenant_weights or {}).items()
            }
            # Cross-replica page sharing: `page_share` is the ROUTER url;
            # the client reports flushed chain keys there and pulls indexed
            # pages replica to replica. self_url is how peers reach THIS
            # replica: serve() fills it from host and port; tests binding
            # port 0 set client.self_url once the listener exists. The
            # pull deadline and slot count default to the engine's Config.
            self.page_share = None
            if page_share:
                from luminaai_tpu_torch.serving.page_share import (
                    PageShareClient,
                )

                cfg = engine.config
                self.page_share = PageShareClient(
                    router_url=str(page_share),
                    self_url=page_share_self_url or "",
                    timeout_s=(cfg.page_pull_timeout_s
                               if page_pull_timeout_s is None
                               else page_pull_timeout_s),
                    max_inflight=(cfg.page_share_max_inflight
                                  if page_share_max_inflight is None
                                  else page_share_max_inflight),
                    registry=self.registry if telemetry else None,
                    recorder=self.recorder if telemetry else None,
                )
            self.batcher = ContinuousScheduler(
                engine,
                num_slots=num_slots,
                page_size=page_size,
                admission_window_ms=admission_window_ms,
                registry=self.registry,
                tracer=self.tracer,
                telemetry=telemetry,
                latency_buckets=latency_buckets,
                request_timeout_s=request_timeout_s,
                recorder=self.recorder,
                max_tenants=self.max_tenants,
                prefill_chunk_tokens=prefill_chunk_tokens,
                prefix_cache_pages=prefix_cache_pages,
                prefix_cache_tenant_quota=prefix_cache_tenant_quota,
                tenant_weights=weights,
                watchdog=self.watchdog,
                page_share=self.page_share,
            )
        else:
            self.watchdog = None
            self.page_share = None
            self.batcher = MicroBatcher(
                engine, max_batch=max_batch, window_ms=batch_window_ms,
                recorder=self.recorder, telemetry=telemetry,
            )
        # Build identity (docs/observability.md): which commit, torch/CUDA
        # and config answer this /metrics.
        register_build_info(self.registry, config=engine.config)
        # /healthz staleness: a wedged-but-alive process (decode loop
        # stuck inside a sync) keeps answering probes — with a stale
        # threshold set, a busy scheduler whose last decode tick is
        # older than this flips status to "degraded" (still 200) so
        # external probes catch it before the watchdog aborts.
        if healthz_stale_after_s is not None and not (
            float(healthz_stale_after_s) > 0
        ):
            # A falsy-zero check here would silently DISABLE the probe
            # the flag exists for; reject loudly instead.
            raise ValueError(
                "healthz_stale_after_s must be positive, got "
                f"{healthz_stale_after_s!r}"
            )
        self.healthz_stale_after_s = (
            float(healthz_stale_after_s)
            if healthz_stale_after_s is not None
            else None
        )
        # SLO layer (docs/observability.md "SLOs & burn rate"): windowed
        # registry history in a fixed-memory ring + burn-rate alerts
        # over the serve objectives (TTFT p95, decode p50, error rate),
        # targets from the engine's Config slo_* knobs (or a
        # --slo-config JSON override). GET /metrics/history and
        # GET /slo read these; `lumina top --url` draws them.
        self.history: Optional[TimeSeriesRing] = None
        self.slo: Optional[SLOEngine] = None
        cfg = engine.config
        if self.telemetry and slo and getattr(cfg, "slo", True):
            self.history, self.slo = build_slo_stack(
                cfg, registry=self.registry, recorder=self.recorder,
                program="serve", slo_config=slo_config,
            )
            self._installed_history = get_history() is None
            if self._installed_history:
                set_history(self.history)
            self.history.start()
        else:
            self._installed_history = False
        # Per-tenant token-bucket admission (rate_limiter.py): every
        # generation request costs one token from its tenant's bucket —
        # burst-tolerant, steady-state rate-bounded. Applies in _gate
        # whenever configured (secure or not; unauthenticated traffic
        # shares the anon tenant's bucket). Keys are ALWAYS hashed
        # tenants, never raw identities.
        self.tenant_bucket = None
        if tenant_rate_per_s:
            from luminaai_tpu_torch.security.rate_limiter import (
                TokenBucketLimiter,
            )

            self.tenant_bucket = TokenBucketLimiter(
                rate_per_s=float(tenant_rate_per_s),
                burst=int(tenant_burst or max(1, int(tenant_rate_per_s))),
            )
        r = self.registry
        self._m_http = r.counter(
            "serve_http_requests_total",
            "HTTP requests by route and status code",
            labelnames=("route", "code"),
        )
        self._m_request = r.histogram(
            "serve_request_seconds",
            "Non-streaming generation request latency (parse to reply)",
            buckets=latency_buckets,
        )
        self._m_stream = r.histogram(
            "serve_stream_duration_seconds",
            "SSE stream duration (first event to close/abort)",
            buckets=latency_buckets,
        )
        self._m_tokens_out = r.counter(
            "serve_tokens_out_total", "Generated tokens returned to clients"
        )
        self._m_overload = r.counter(
            "serving_overload_rejections_total",
            "Generation requests shed with 503 + Retry-After because the "
            "admission queue was at max_queue_depth",
        )
        # Per-tenant request accounting (the substrate ROADMAP item 2's
        # fair-share admission prices QoS against). Bounded cardinality:
        # max_tenants distinct labels, then `_overflow`.
        tk = dict(labelnames=("tenant",), max_label_values=self.max_tenants)
        self._m_tenant_requests = r.counter(
            "tenant_requests_total",
            "Generation requests accepted for processing, per tenant",
            **tk,
        )
        self._m_tenant_tokens_in = r.counter(
            "tenant_tokens_in_total",
            "Prompt tokens submitted, per tenant", **tk,
        )
        self._m_tenant_tokens_out = r.counter(
            "tenant_tokens_out_total",
            "Generated tokens returned, per tenant", **tk,
        )
        self._m_tenant_shed = r.counter(
            "tenant_requests_shed_total",
            "Requests rejected 503 (drain or overload), per tenant", **tk,
        )
        r.gauge(
            "serve_ready",
            "1 once the engine is warmed and serving, 0 while compiling",
        ).set_function(
            weak_callback(self, lambda s: float(s._ready.is_set()))
        )
        r.gauge(
            "serve_draining",
            "1 while the server is draining (admissions stopped, in-flight "
            "generations finishing before shutdown)",
        ).set_function(
            weak_callback(self, lambda s: float(s._draining))
        )
        if warmup:
            threading.Thread(target=self._warmup, daemon=True).start()
        else:
            self._ready.set()
        # Streams bypass the MicroBatcher, so each holds its own KV cache
        # + decode loop on the device; unlike the single-worker batched
        # path they'd be unbounded without a cap (ThreadingHTTPServer is
        # thread-per-connection).
        self._stream_slots = threading.Semaphore(max(1, int(max_streams)))
        # Auth/limiter/counter state is shared across handler threads;
        # SecurityManager and RateLimiter are not thread-safe themselves.
        self.state_lock = threading.Lock()
        # POST handlers between request read and reply write (drain waits
        # for them before the listener shuts down).
        self._posts_lock = threading.Lock()
        self._posts_active = 0
        self.t0 = time.time()
        self.requests = 0
        self.tokens_out = 0
        self.max_new_tokens_cap = max_new_tokens_cap
        self.secure = secure
        self.security = None
        self.limiter = None
        self.validator = None
        if secure:
            from luminaai_tpu_torch.security.auth import SecurityManager
            from luminaai_tpu_torch.security.input_validator import InputValidator
            from luminaai_tpu_torch.security.rate_limiter import RateLimiter

            self.security = SecurityManager(persist_path=users_path)
            self.limiter = RateLimiter()
            self.validator = InputValidator()
            if bootstrap_user is not None:
                user, password = bootstrap_user
                self.security.create_user(user, password)

    # -- readiness ---------------------------------------------------------
    def mark_ready(self) -> None:
        self._ready.set()

    # -- graceful shutdown (docs/resilience.md) ----------------------------
    def begin_drain(self) -> None:
        """Stop admitting generation requests. /healthz stays 200 (the
        process is healthy) but advertises `draining` in the body and the
        serve_draining gauge; in-flight lanes keep decoding to completion."""
        if not self._draining:
            self._draining = True
            if self.telemetry:
                self.recorder.emit(
                    "drain_started", queue_depth=self._queue_depth()
                )
            logger.warning(
                "drain started: new generations rejected, in-flight work "
                "finishing (queue_depth=%d)", self._queue_depth(),
            )

    def _idle(self) -> bool:
        idle = getattr(self.batcher, "idle", None)
        return bool(idle()) if callable(idle) else True

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """begin_drain + wait (bounded) for in-flight generations to
        finish. Returns True when the scheduler went idle inside the
        grace window; False means the deadline expired with lanes still
        active (the caller shuts down anyway — bounded beats hung)."""
        self.begin_drain()
        deadline = time.time() + (
            self.drain_grace_s if timeout_s is None else float(timeout_s)
        )
        idle = False
        while time.time() < deadline:
            if self._idle():
                logger.info("drain complete: scheduler idle")
                idle = True
                break
            time.sleep(0.05)
        if not idle:
            idle = self._idle()
            if not idle:
                logger.warning(
                    "drain grace expired with work still in flight; "
                    "shutting down anyway"
                )
        if self.telemetry:
            self.recorder.emit("drain_finished", idle=idle)
        # Crash forensics: the event trail survives the shutdown as a
        # flightrec-*.jsonl dump next to the checkpoints (lumina events
        # replays it; docs/observability.md "Flight recorder").
        self.dump_flight_record("drain")
        # The server is done serving: stop the watchdog's monitor thread
        # (Trainer.close does the same) — a drained server must not keep
        # a poller alive in embedding processes that cycle servers. The
        # history sampler stops for the same reason.
        if getattr(self, "watchdog", None) is not None:
            self.watchdog.close()
        if self.history is not None:
            self.history.stop()
            if self._installed_history and get_history() is self.history:
                set_history(None)
        return idle

    def dump_flight_record(self, reason: str) -> Optional[str]:
        """Dump the wide-event ring buffer into flight_dir (no-op without
        one), plus the time-series history when SLO retention is on
        (`lumina top <dir>` replays it). Never raises — it rides
        shutdown paths."""
        if not self.flight_dir:
            return None
        if self.history is not None:
            self.history.dump_to_dir(
                self.flight_dir, reason,
                slo=self.slo.verdicts() if self.slo is not None else None,
            )
        return self.recorder.dump_to_dir(self.flight_dir, reason)

    def _queue_depth(self) -> int:
        qd = getattr(self.batcher, "queue_depth", None)
        return int(qd()) if callable(qd) else 0

    def _shed(self):
        """Load-shedding gate for generation endpoints: draining servers
        and full admission queues answer 503 + Retry-After immediately
        instead of queuing unboundedly (clients retry against a replica)."""
        if self._draining:
            return 503, {
                "error": "server draining; retry against another replica",
                "retry_after": 2,
            }
        depth = self._queue_depth()
        if self.max_queue_depth and depth >= self.max_queue_depth:
            if self.telemetry:
                self._m_overload.inc()
            # Rough time-to-queue-space: a slot's worth of queued work.
            slots = getattr(self.batcher, "max_batch", None) or getattr(
                getattr(self.batcher, "decoder", None), "num_slots", 8
            )
            return 503, {
                "error": f"overloaded: admission queue at {depth}; "
                         "retry later",
                "retry_after": max(1, depth // max(1, int(slots or 8))),
            }
        return None

    def _effective_timeout(self, body: Dict[str, Any]) -> Optional[float]:
        """Per-request deadline: the request's timeout_s can only SHORTEN
        the server's request_timeout_s cap (a client must not be able to
        pin a lane past the operator's bound)."""
        cap = self.request_timeout_s
        t = body.get("timeout_s")
        try:
            t = float(t) if t is not None else None
        except (TypeError, ValueError):
            t = None
        if t is not None and t <= 0:
            t = None
        if t is None:
            return cap
        return min(t, cap) if cap else t

    def _warmup(self) -> None:
        """A first generation through the real batcher path (it builds the
        kernels and runs every path a request takes), then open the
        /healthz gate. A failed warmup keeps the gate shut — a card whose
        kernels did not run must not take traffic — and shows the failure
        in the /healthz payload (503); only a request served later opens
        it (_reply_payload)."""
        self._warmup_error = None
        t0 = time.time()
        try:
            encode = getattr(
                getattr(self.engine.tokenizer, "backend", None),
                "encode", None,
            )
            prompt = encode("warmup") if callable(encode) else [1, 2, 3]
            with self.tracer.span("warmup"):
                self.batcher.submit(
                    list(prompt) or [1],
                    {"max_new_tokens": 2, "temperature": 0.0},
                )
            logger.info("warmup generation done in %.1fs", time.time() - t0)
        except Exception as e:
            logger.exception("warmup generation failed; /healthz stays 503")
            self._warmup_error = f"{type(e).__name__}: {e}"
            return
        self._ready.set()

    def _scheduler_state(self) -> Dict[str, Any]:
        """Live scheduler occupancy for /healthz and /stats consumers."""
        if self.continuous:
            st = self.batcher.stats()
            return {
                "scheduler": "continuous",
                "active_lanes": st.get("active_lanes", 0),
                "queue_depth": st.get("queue_depth", 0),
                "slots_free": st.get("kv_pool", {}).get("free"),
                "decode_steps": st.get("decode_steps", 0),
            }
        return {
            "scheduler": "micro_batch",
            "queue_depth": self.batcher.q.qsize(),
            "batches": self.batcher.batches,
        }

    def _staleness(self) -> Dict[str, Any]:
        """Liveness ages for /healthz: seconds since the scheduler's
        last decode tick and (when a trainer shares the process
        registry) since the last train step. `stale` is True only when
        a threshold is configured AND the process has work it is not
        advancing — an idle scheduler is quiet, not stale."""
        out: Dict[str, Any] = {}
        now = time.time()
        busy = False
        if self.continuous:
            last = getattr(self.batcher, "last_tick_ts", None)
            if last is not None:
                out["last_decode_tick_age_seconds"] = round(now - last, 3)
            st = self._scheduler_state()
            busy = bool(
                st.get("active_lanes") or st.get("queue_depth")
                or getattr(self.batcher, "_prefilling", None)
            )
        fam = self.registry.get("train_last_step_ts")
        if fam is not None:
            try:
                ts = float(fam.value)
            except (TypeError, ValueError):
                ts = float("nan")
            if ts == ts and ts > 0:  # NaN-safe: live train loop only
                out["last_step_age_seconds"] = round(now - ts, 3)
        thr = self.healthz_stale_after_s
        if thr:
            decode_stale = (
                busy
                and out.get("last_decode_tick_age_seconds") is not None
                and out["last_decode_tick_age_seconds"] > thr
            )
            train_stale = (
                out.get("last_step_age_seconds") is not None
                and out["last_step_age_seconds"] > thr
            )
            out["stale"] = bool(decode_stale or train_stale)
            out["stale_after_s"] = thr
        return out

    def history_route(
        self, seconds: Optional[float] = None,
        max_points: Optional[int] = None,
    ) -> tuple:
        """GET /metrics/history -> (status, payload): the ring's JSON
        snapshot. ONE implementation behind both entries — handle()
        (in-process, no query) and do_GET (parses ?seconds=&max_points=).
        Budget-guarded twice over: the ring's own capacity/series budget
        bounds the worst case, and the query params tighten a single
        response."""
        if self.history is None:
            return 404, {
                "error": "history ring disabled "
                         "(--no-slo or telemetry off)"
            }
        # Query values come off the wire: float() accepts nan/inf, and
        # int(nan) raises — a curl probe must get the full view, not a
        # handler traceback. Non-finite/non-positive -> unclamped.
        if seconds is not None and not (
            math.isfinite(float(seconds)) and seconds > 0
        ):
            seconds = None
        if max_points is not None:
            mp = float(max_points)
            max_points = (
                max(1, min(int(mp), 10_000))
                if math.isfinite(mp) and mp > 0
                else None
            )
        return 200, self.history.snapshot(
            window_s=seconds, max_points=max_points
        )

    def render_metrics(self) -> str:
        return self.registry.render_prometheus()

    # -- request handling --------------------------------------------------
    def handle(self, method: str, path: str, body: Dict[str, Any],
               token: Optional[str],
               request_id: Optional[str] = None) -> tuple:
        """Returns (status_code, payload dict). Pure-ish: no socket I/O.

        `request_id` is an inbound `X-Request-Id` (already validated by
        the HTTP handler): a fronting router minted it, and honoring it
        here means one id correlates the request across the router's and
        this replica's flight rings (`lumina events --request <id>`).
        Absent, we mint as before."""
        if method == "GET" and path == "/healthz":
            # Readiness (vs /health's liveness): 503 while the engine is
            # compiling/warming so orchestrators hold traffic, 200 with
            # scheduler occupancy once serving. The Dockerfile
            # HEALTHCHECK curls this route.
            if not self._ready.is_set():
                out = {
                    "status": "warming",
                    "uptime_s": round(time.time() - self.t0, 1),
                }
                warm_err = getattr(self, "_warmup_error", None)
                if warm_err:
                    out["status"] = "warmup_failed"
                    out["warmup_error"] = warm_err
                return 503, out
            # Draining stays 200: the process is healthy and finishing
            # in-flight work — a 5xx here would get it killed mid-drain.
            # Observers that care read `status` or the serve_draining
            # gauge (docker-compose.dev.yml's curl healthcheck tolerates
            # the drain window by construction). Staleness: ages since
            # the last decode tick / train step ride the body, and past
            # --healthz-stale-after a BUSY-but-silent process reports
            # "degraded" (still 200 — probes distinguish wedged from
            # dead; the watchdog owns aborting).
            status = "draining" if self._draining else "ok"
            out = {
                "uptime_s": round(time.time() - self.t0, 1),
                **self._scheduler_state(),
            }
            stale = self._staleness()
            out.update(stale)
            if status == "ok" and stale.get("stale"):
                status = "degraded"
            out["status"] = status
            warm_err = getattr(self, "_warmup_error", None)
            if warm_err:
                out["warmup_error"] = warm_err
            return 200, out
        if method == "GET" and path == "/slo":
            if self.slo is None:
                return 404, {
                    "error": "slo engine disabled "
                             "(--no-slo or telemetry off)"
                }
            return 200, self.slo.verdicts()
        if method == "GET" and path == "/metrics/history":
            return self.history_route()
        if method == "GET" and path == "/health":
            cfg = self.engine.config
            return 200, {
                "status": "ok",
                "uptime_s": round(time.time() - self.t0, 1),
                "model": {
                    "hidden_size": cfg.hidden_size,
                    "num_layers": cfg.num_layers,
                    "vocab_size": cfg.vocab_size,
                    "moe": bool(cfg.use_moe),
                },
                "secure": self.secure,
            }
        if method == "GET" and path == "/stats":
            out = {
                "requests": self.requests,
                "tokens_out": self.tokens_out,
                "uptime_s": round(time.time() - self.t0, 1),
                "batches": self.batcher.batches,
                "max_batch_seen": self.batcher.max_batch_seen,
                "scheduler": (
                    "continuous" if self.continuous else "micro_batch"
                ),
            }
            if self.continuous:
                out.update(self.batcher.stats())
            # The port's addition: what the engine serves (JAX keeps it
            # on the engine only).
            out["quantization"] = self.engine.quantization_info
            out["kv_cache_dtype"] = self.engine.config.kv_cache_dtype
            return 200, out
        if method == "POST" and path == "/v1/auth":
            if not self.secure:
                return 400, {"error": "server not in secure mode"}
            with self.state_lock:
                token = self.security.authenticate(
                    str(body.get("user", "")), str(body.get("password", ""))
                )
            if token is None:
                return 401, {"error": "authentication failed"}
            return 200, {"token": token}
        if method == "POST" and path in ("/v1/generate", "/v1/chat"):
            request_id = request_id or new_request_id()
            shed = self._shed()  # drain/overload: reject before auth work
            if shed is not None:
                self._count_shed(request_id, token, path)
                shed[1]["request_id"] = request_id
                return shed
            with self.state_lock:
                err, tenant = self._gate(body, token)
            if err is not None:
                return err
            return self._run_model(
                path, body, request_id=request_id, tenant=tenant
            )
        return 404, {"error": f"no route {method} {path}"}

    def _tenant_of(self, token: Optional[str]) -> str:
        """Tenant label outside the gate (shed accounting): hashed
        session identity or the shared anon tenant. One HMAC, no
        password work — cheap enough for the overload path."""
        if not self.secure or not token:
            return ANON_TENANT
        with self.state_lock:
            sess = self.security.validate_session(token)
        return tenant_hash(sess["username"]) if sess else ANON_TENANT

    def _count_shed(self, request_id: str, token: Optional[str],
                    route: str) -> None:
        # Same off switch as the scheduler's _event: telemetry off means
        # no accounting work at all (including the session-HMAC tenant
        # resolution), so the overhead A/B stays honest.
        if not self.telemetry:
            return
        tenant = self._tenant_of(token)
        self._m_tenant_shed.labels(tenant=tenant).inc()
        self.recorder.emit(
            "request_shed", request_id=request_id, tenant=tenant,
            route=route,
            reason="drain" if self._draining else "overload",
        )

    def _gate(self, body: Dict[str, Any], token: Optional[str]):
        """Admission checks: session token, per-tenant rate limiting,
        input validation. Returns (error_tuple | None, tenant_label) —
        the tenant is the hashed authenticated identity, so accounting,
        events AND limiter state never carry raw usernames.

        Two limiter layers compose here: the secure-mode sliding-window
        limiter (legacy request-count policy) and the optional per-tenant
        TOKEN BUCKET (--tenant-rate/--tenant-burst), which also applies
        to unauthenticated traffic via the shared anon tenant."""
        tenant = ANON_TENANT
        if self.secure:
            session = self.security.validate_session(token or "")
            if session is None:
                return (
                    (401, {"error": "missing or invalid token"}),
                    ANON_TENANT,
                )
            user = session.get("username", "anonymous")
            tenant = tenant_hash(user)
            # Limiter state is keyed by the HASHED tenant — the limiter's
            # bucket dict is introspectable (and dumpable in bug
            # reports), so raw identities must never appear in its keys.
            if not self.limiter.is_allowed(tenant, "chat"):
                return (429, {"error": "rate limit exceeded"}), tenant
        if self.tenant_bucket is not None and not self.tenant_bucket.allow(
            tenant
        ):
            retry = self.tenant_bucket.retry_after(tenant)
            return (
                429,
                {
                    "error": "tenant rate limit exceeded",
                    "retry_after": max(1, int(retry + 0.999)),
                },
            ), tenant
        if not self.secure:
            return None, tenant
        text = body.get("prompt") or body.get("message") or ""
        if not text and body.get("messages"):
            text = " ".join(
                str(m.get("content", "")) for m in body["messages"]
            )
        verdict = self.validator.validate_user_input(str(text))
        if not verdict.valid:
            return (400, {
                "error": f"input rejected: {'; '.join(verdict.errors)}"
            }), tenant
        return None, tenant

    # (name, clamp) — requests cannot push sampling params outside sane
    # bounds; max_new_tokens is capped so one request can't hold the decode
    # lock arbitrarily long (the rate limiter counts requests, not tokens).
    _OVERRIDE_CLAMPS = {
        "max_new_tokens": lambda v, cap: max(1, min(int(v), cap)),
        "temperature": lambda v, _: min(max(float(v), 0.0), 10.0),
        "top_p": lambda v, _: min(max(float(v), 0.0), 1.0),
        "top_k": lambda v, _: max(0, min(int(v), 10_000)),
        "repetition_penalty": lambda v, _: min(max(float(v), 0.5), 5.0),
    }

    def _parse_request(self, path: str, body: Dict[str, Any]):
        """Shared request parsing for the batched and streaming paths.

        Returns (error_tuple | None, prompt_ids, overrides, reply_key)."""
        overrides = {}
        for k, clamp in self._OVERRIDE_CLAMPS.items():
            if k in body:
                try:
                    overrides[k] = clamp(body[k], self.max_new_tokens_cap)
                except (TypeError, ValueError):
                    return (400, {"error": f"bad value for {k}"}), None, None, None
        if path == "/v1/chat":
            messages = body.get("messages")
            if not messages:
                msg = str(body.get("message", ""))
                if not msg:
                    return (400, {"error": "message(s) required"}), None, None, None
                messages = [{"role": "user", "content": msg}]
            for m in messages:
                if (
                    not isinstance(m, dict)
                    or not isinstance(m.get("role"), str)
                    or not isinstance(m.get("content"), str)
                ):
                    return (
                        400,
                        {
                            "error": "each message needs string "
                                     "'role' and 'content'"
                        },
                    ), None, None, None
            prompt_ids = self.engine.encode_chat(messages)
            reply_key = "reply"
        else:
            prompt = str(body.get("prompt", ""))
            if not prompt:
                return (400, {"error": "prompt required"}), None, None, None
            prompt_ids = self.engine.tokenizer.backend.encode(prompt)
            reply_key = "text"
        return None, prompt_ids, overrides, reply_key

    def _run_model(self, path: str, body: Dict[str, Any],
                   request_id: Optional[str] = None,
                   tenant: str = ANON_TENANT) -> tuple:
        t0 = time.time()
        request_id = request_id or new_request_id()
        err, prompt_ids, overrides, reply_key = self._parse_request(path, body)
        if err is not None:
            return err
        self._account_request(request_id, tenant, path, len(prompt_ids),
                              stream=False)
        if body.get("speculative"):
            out = self._run_speculative(
                prompt_ids, overrides, reply_key, t0,
                request_id=request_id, tenant=tenant,
            )
            if out is not None:
                return out
            # Not eligible (sampling params / engine support): fall
            # through to the batched path silently — speculation is an
            # accelerator hint, not a contract.
        # Concurrent requests with the same sampling params ride one
        # batched decode (MicroBatcher); sampling overrides go as generate
        # kwargs, so there is no config mutation to serialize.
        timeout_s = self._effective_timeout(body)
        # Identity riders ride BOTH schedulers' submit (each strips them
        # before its batch key / engine kwargs), so per-tenant series
        # and the flight trail stay honest on the --no-continuous
        # fallback path too. The deadline is a continuous-scheduler
        # contract (step-level eviction); MicroBatcher drops it.
        overrides = {
            **overrides, "request_id": request_id, "tenant": tenant,
        }
        if timeout_s:
            overrides["timeout_s"] = timeout_s
        try:
            tokens, stats = self.batcher.submit(prompt_ids, overrides)
        except RequestTimeout as e:
            return 504, {
                "error": str(e), "request_id": request_id, "tenant": tenant,
            }
        return self._reply_payload(
            tokens, stats, reply_key, t0,
            request_id=request_id, tenant=tenant,
        )

    def _account_request(self, request_id, tenant, route, prompt_tokens,
                         stream) -> None:
        """Per-tenant admission accounting + the request_received event
        (one choke point for the JSON and SSE paths). Rides the same
        off switch as the metrics."""
        if not self.telemetry:
            return
        self._m_tenant_requests.labels(tenant=tenant).inc()
        self._m_tenant_tokens_in.labels(tenant=tenant).inc(
            int(prompt_tokens)
        )
        self.recorder.emit(
            "request_received", request_id=request_id, tenant=tenant,
            route=route, stream=bool(stream),
            prompt_tokens=int(prompt_tokens),
        )

    def _reply_payload(self, tokens, stats, reply_key, t0,
                       request_id: Optional[str] = None,
                       tenant: Optional[str] = None, **extra) -> tuple:
        """Shared response building + stats booking for the batched and
        speculative generation paths."""
        out = {reply_key: self.engine.tokenizer.decode(tokens)}
        n_tok = int(stats.get("tokens_generated", 0))
        with self.state_lock:
            self.requests += 1
            self.tokens_out += n_tok
        if self.telemetry:
            self._m_request.observe(time.time() - t0)
            self._m_tokens_out.inc(n_tok)
            if tenant:
                self._m_tenant_tokens_out.labels(tenant=tenant).inc(n_tok)
        self.mark_ready()  # a served request is proof of readiness
        out.update(
            tokens=n_tok,
            latency_s=round(time.time() - t0, 3),
            stopped=stats.get("stopped"),
            **extra,
        )
        if request_id is not None:
            # Correlation contract: the id in this reply matches the
            # request's server-side events and /metrics tenant series.
            out["request_id"] = request_id
            out["tenant"] = tenant or ANON_TENANT
        return 200, out

    def _speculative_eligible(self, overrides) -> bool:
        """Whether a {"speculative": true} hint can be honored for these
        request params. Eligibility is judged on the RESOLVED params
        (config defaults fill omitted fields — a request without
        temperature usually samples): greedy, no repetition penalty.
        Shared by the JSON and SSE paths so the hint means one thing."""
        resolve = getattr(self.engine, "_resolve_gen_key", None)
        if resolve is None:
            return False
        key = resolve(
            overrides.get("max_new_tokens"),
            overrides.get("temperature"),
            overrides.get("top_p"),
            overrides.get("top_k"),
            overrides.get("repetition_penalty"),
        )
        return key[1] <= 0.0 and key[4] == 1.0

    def _run_speculative(self, prompt_ids, overrides, reply_key, t0,
                         request_id=None, tenant=None):
        """Greedy requests with {"speculative": true} run the engine's
        prompt-lookup speculative decode (exactly the greedy sequence,
        several tokens per device call on repetitive text). Single-stream
        like SSE, so it borrows the stream slot cap instead of the
        MicroBatcher; returns None when not eligible (sampling requested
        or the engine lacks the method) so the caller falls back."""
        if not hasattr(self.engine, "generate_speculative"):
            return None
        if not self._speculative_eligible(overrides):
            return None
        if not self._stream_slots.acquire(blocking=False):
            # All slots busy: fall back to the batched path rather than
            # erroring — the hint must never make a servable request fail.
            return None
        try:
            tokens, stats = self.engine.generate_speculative(
                prompt_ids,
                max_new_tokens=overrides.get("max_new_tokens"),
            )
        finally:
            self._stream_slots.release()
        return self._reply_payload(
            tokens, stats, reply_key, t0,
            request_id=request_id, tenant=tenant,
            speculative={
                "verify_calls": stats.get("verify_calls"),
                "tokens_per_verify": stats.get("tokens_per_verify"),
            },
        )

    # -- streaming (SSE) ---------------------------------------------------
    def start_stream(self, path: str, body: Dict[str, Any],
                     token: Optional[str],
                     request_id: Optional[str] = None):
        """Begin a streamed generation. Returns (error_tuple | None,
        events_generator | None). Streaming runs the engine's chunked
        decode directly (one stream per request thread) rather than the
        MicroBatcher — each stream owns its decode cadence; batched SSE
        would couple every client's latency to the slowest stream.
        An inbound `X-Request-Id` (router-minted) is honored like
        handle()'s, so stream events correlate across tiers."""
        request_id = request_id or new_request_id()
        shed = self._shed()  # drain/overload applies to streams too
        if shed is not None:
            self._count_shed(request_id, token, path)
            shed[1]["request_id"] = request_id
            return shed, None
        with self.state_lock:
            err, tenant = self._gate(body, token)
        if err is not None:
            return err, None
        if not self.continuous and not hasattr(
            self.engine, "generate_stream"
        ):
            return (501, {"error": "engine does not support streaming"}), None
        err, prompt_ids, overrides, reply_key = self._parse_request(path, body)
        if err is not None:
            return err, None
        self._account_request(request_id, tenant, path, len(prompt_ids),
                              stream=True)
        timeout_s = self._effective_timeout(body)
        if (
            body.get("speculative")
            and hasattr(self.engine, "generate_stream_speculative")
            and self._speculative_eligible(overrides)
            and self._stream_slots.acquire(blocking=False)
        ):
            # Greedy SSE with {"speculative": true}: the draft/verify
            # loop composes with the streaming contract — tokens arrive
            # in accepted-prefix bursts (engine
            # generate_stream_speculative). Single-stream like the JSON
            # speculative path, so it borrows the stream slot cap even
            # under the continuous scheduler; slots busy or sampled
            # params fall through to the normal stream — the hint never
            # makes a servable request fail. The per-request deadline
            # applies: speculative streams run outside the continuous
            # scheduler's overdue-lane eviction, so the engine's decode
            # loop enforces it instead (stopped='timeout').
            if timeout_s:
                overrides = {**overrides, "timeout_s": timeout_s}
            return None, _SlotStream(
                self._stream_events(
                    prompt_ids, overrides, reply_key, speculative=True,
                    request_id=request_id, tenant=tenant,
                ),
                self._stream_slots.release,
            )
        if self.continuous:
            # Identity riders for the scheduler's lifecycle events
            # (stripped before the batch key) + the deadline.
            overrides = {
                **overrides, "request_id": request_id, "tenant": tenant,
            }
            if timeout_s:
                overrides["timeout_s"] = timeout_s
            # Streams ride the shared continuous decode loop like any
            # other request — concurrency is bounded by the KV pool's
            # slots (excess queues), so the legacy per-stream slot cap
            # does not apply. Closing the generator cancels the lane.
            return None, self._stream_events(
                prompt_ids, overrides, reply_key,
                request_id=request_id, tenant=tenant,
            )
        if not self._stream_slots.acquire(blocking=False):
            return (
                503,
                {"error": "too many concurrent streams; retry shortly"},
            ), None
        return None, _SlotStream(
            self._stream_events(prompt_ids, overrides, reply_key,
                                request_id=request_id, tenant=tenant),
            self._stream_slots.release,
        )

    def _stream_events(self, prompt_ids, overrides, reply_key,
                       speculative: bool = False,
                       request_id: Optional[str] = None,
                       tenant: str = ANON_TENANT):
        """Yield SSE event dicts: {'token','delta'} per token, then a
        final {'done': True, <reply_key>: full_text, ...stats}.

        Deltas decode only the tokens since the last clean flush (O(1)
        amortized, not a full re-decode per token); a decode ending
        mid-codepoint (trailing U+FFFD from a split multi-byte char) is
        HELD — the empty delta is emitted now and the held tokens flush
        with the next clean boundary, so concatenated deltas reproduce
        the final text instead of baking replacement chars in. The done
        frame's text is authoritative (one decode of all tokens), and it
        carries a final 'delta' flushing any still-held tokens so the
        delta contract survives a stream that ENDS mid-codepoint.
        Aborted streams (client gone -> GeneratorExit) still count their
        streamed tokens into /stats via the finally block, which also
        releases the concurrency slot acquired in start_stream."""
        t0 = time.time()
        tok = self.engine.tokenizer
        tokens: List[int] = []
        base = 0  # tokens[:base] are flushed into deltas already
        counted = False
        stream_span = self.tracer.span("sse_stream", route=reply_key)
        span = stream_span.__enter__()

        def count(n: int) -> None:
            nonlocal counted
            if counted:
                return
            counted = True
            with self.state_lock:
                self.requests += 1
                self.tokens_out += n
            if self.telemetry:
                self._m_stream.observe(time.time() - t0)
                self._m_tokens_out.inc(n)
                if tenant:
                    self._m_tenant_tokens_out.labels(tenant=tenant).inc(n)
            span.set(tokens=n)
            self.mark_ready()

        # Continuous mode streams per-slot out of the shared scheduler
        # loop; legacy engines run their own chunked decode; speculative
        # greedy streams run the engine's draft/verify loop directly.
        # Every source honors the same contract (token ints, then a
        # stats dict).
        if speculative:
            src = self.engine.generate_stream_speculative(
                prompt_ids,
                max_new_tokens=overrides.get("max_new_tokens"),
                timeout_s=overrides.get("timeout_s"),
            )
        elif self.continuous:
            src = self.batcher.submit_stream(prompt_ids, overrides)
        else:
            src = self.engine.generate_stream(prompt_ids, **overrides)
        try:
            for item in src:
                if isinstance(item, dict):  # final stats yield
                    count(int(item.get("tokens_generated", 0)))
                    done_frame = {
                        "done": True,
                        reply_key: tok.decode(tokens),
                        # Flush tokens still held by the mid-codepoint
                        # delta hold (empty when the stream ended clean).
                        "delta": (
                            tok.decode(tokens[base:])
                            if base < len(tokens)
                            else ""
                        ),
                        "tokens": int(item.get("tokens_generated", 0)),
                        "latency_s": round(time.time() - t0, 3),
                        "stopped": item.get("stopped"),
                        # Correlation contract (docs/serving.md): the
                        # done frame carries the same id/tenant as the
                        # server-side events and /metrics series.
                        "request_id": (
                            request_id or item.get("request_id")
                        ),
                        "tenant": item.get("tenant", tenant),
                    }
                    if item.get("verify_calls") is not None:
                        # Speculative stream: the done frame carries the
                        # acceptance stats the JSON path reports.
                        done_frame["speculative"] = {
                            "verify_calls": item.get("verify_calls"),
                            "tokens_per_verify": item.get(
                                "tokens_per_verify"
                            ),
                        }
                    yield done_frame
                    return
                tokens.append(int(item))
                delta = tok.decode(tokens[base:])
                if delta and (
                    not delta.endswith("�")
                    # A genuinely invalid byte would hold forever — flush
                    # after 4 held tokens (a UTF-8 codepoint spans ≤4).
                    or len(tokens) - base >= 4
                ):
                    base = len(tokens)
                else:
                    delta = ""
                yield {"token": int(item), "delta": delta}
        except Exception as e:
            # Mid-stream failures (deadline eviction, decode error)
            # become a CORRELATABLE error frame — request_id + tenant —
            # instead of the handler's anonymous fallback frame. The
            # [DONE] terminator still follows from _reply_sse.
            # GeneratorExit (client gone) is BaseException: untouched.
            logger.warning("stream %s failed: %s", request_id, e)
            yield {
                "error": str(e),
                "request_id": request_id,
                "tenant": tenant,
            }
            return
        finally:
            count(len(tokens))
            stream_span.__exit__(None, None, None)
            close = getattr(src, "close", None)
            if close is not None:
                close()  # continuous: flags the lane cancelled

    # -- socket layer ------------------------------------------------------
    def export_page_by_key(self, key: str) -> Optional[bytes]:
        """One cached page's LPG1 bytes for a remote puller (GET
        /pages/<key>). None = not servable now (not resident, its bytes not
        yet written by a harvest copy or a remote pull, or no prefix
        cache): the puller books a failure and prefills locally, so
        refusing is always safe. The page is refcount-pinned across the
        copy to the host, so eviction cannot reassign its arena page
        mid-serialization. The handler thread makes the model's card
        current first (by index): the copy then runs on that card's
        stream, after the worker's harvest copies."""
        batcher = getattr(self, "batcher", None)
        decoder = getattr(batcher, "decoder", None)
        cache = getattr(decoder, "prefix_cache", None)
        pool = getattr(decoder, "pool", None)
        if cache is None or pool is None or pool.caches is None:
            return None
        # pin_key refuses a page inserted but not yet written: its arena
        # bytes are still the previous occupant's.
        pid = cache.pin_key(key)
        if pid is None:
            return None
        try:
            _set_device(getattr(batcher, "_device", None))
            return pool.export_page(pid)
        except Exception:
            logger.exception("page export failed for %s", key[:16])
            return None
        finally:
            cache.release([pid])

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.info("%s %s", self.address_string(), fmt % args)

            _KNOWN_ROUTES = (
                "/", "/chat", "/health", "/healthz", "/metrics",
                "/metrics/history", "/slo", "/stats",
                "/v1/generate", "/v1/chat", "/v1/auth", "/pages",
            )

            def _count(self, code: int) -> None:
                if server.telemetry:
                    # Unknown paths collapse into one label value: a
                    # scanner probing random routes must not be able to
                    # mint unbounded label cardinality.
                    route = self.path.split("?", 1)[0]
                    if route.startswith("/pages/"):
                        # One label for every per-key page fetch.
                        route = "/pages"
                    elif route not in self._KNOWN_ROUTES:
                        route = "<other>"
                    server._m_http.labels(
                        route=route, code=str(code)
                    ).inc()

            def _reply(self, code: int, payload: Dict[str, Any]) -> None:
                self._count(code)
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                if isinstance(payload, dict) and "retry_after" in payload:
                    # Overload/drain 503s carry the standard header so
                    # off-the-shelf clients and LBs back off correctly.
                    self.send_header(
                        "Retry-After", str(int(payload["retry_after"]))
                    )
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _reply_text(self, code: int, text: str,
                            content_type: str) -> None:
                self._count(code)
                data = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _token(self) -> Optional[str]:
                auth = self.headers.get("Authorization", "")
                return auth[7:] if auth.startswith("Bearer ") else None

            def _request_id(self) -> Optional[str]:
                # Inbound X-Request-Id (router-minted). Validated so a
                # hostile client can't inject log/JSONL garbage into two
                # tiers of flight rings; anything dubious is ignored and
                # the server mints its own as before.
                rid = self.headers.get("X-Request-Id", "")
                return rid if REQUEST_ID_RX.fullmatch(rid) else None

            def do_GET(self):
                # Health probes often add query strings (cache busting);
                # route on the bare path.
                path, _, query = self.path.partition("?")
                if path == "/metrics/history":
                    # Windowed-history query params (?seconds=&max_points=)
                    # parse here — handle() stays query-string-free; the
                    # route logic itself lives once, in history_route().
                    from urllib.parse import parse_qs

                    qs = parse_qs(query)

                    def _num(key):
                        try:
                            return float(qs[key][0]) if key in qs else None
                        except (TypeError, ValueError):
                            return None

                    self._reply(*server.history_route(
                        seconds=_num("seconds"),
                        max_points=_num("max_points"),
                    ))
                    return
                if path == "/metrics":
                    # Prometheus text exposition: the one non-JSON API
                    # route. Rendered outside handle() so a scrape can
                    # never be confused with a model request.
                    self._reply_text(
                        200,
                        server.render_metrics(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    return
                if path in ("/", "/chat"):
                    # Built-in chat page (the ref's Electron app role —
                    # serving/webui.py). Static: auth gates the API calls
                    # the page makes, not the page itself.
                    from luminaai_tpu_torch.serving.webui import PAGE

                    data = PAGE.encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/html; charset=utf-8"
                    )
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if path.startswith("/pages/"):
                    # Cross-replica page export: raw LPG1 bytes, not JSON
                    # (the puller's parser validates the frame itself).
                    key = path[len("/pages/"):]
                    if not PAGE_KEY_RX.fullmatch(key):
                        self._reply(404, {"error": "bad page key"})
                        return
                    payload = server.export_page_by_key(key)
                    if payload is None:
                        self._reply(404, {"error": "page not available"})
                        return
                    self._count(200)
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "application/octet-stream"
                    )
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                code, payload = server.handle(
                    "GET", path, {}, self._token()
                )
                self._reply(code, payload)

            def _reply_sse(self, events) -> None:
                """Server-sent events: one `data: <json>` frame per event,
                closing with `data: [DONE]` (the OpenAI-style stream
                terminator clients already know how to parse)."""
                try:
                    # Header writes live INSIDE the try: a client gone
                    # before headers raises BrokenPipeError, and the
                    # handler below must still events.close() or the
                    # stream slot leaks (permanent 503s at the cap).
                    self._count(200)
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    for ev in events:
                        self.wfile.write(
                            b"data: " + json.dumps(ev).encode() + b"\n\n"
                        )
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                except (BrokenPipeError, ConnectionResetError):
                    logger.info("stream client disconnected")
                    events.close()  # stop decoding for a gone client
                except Exception as e:
                    # Headers are already sent: a raised-through error
                    # would make do_POST write a second status line into
                    # the open SSE body. Emit an error frame instead.
                    logger.exception("stream failed mid-flight")
                    try:
                        self.wfile.write(
                            b"data: "
                            + json.dumps({"error": str(e)}).encode()
                            + b"\n\ndata: [DONE]\n\n"
                        )
                    except OSError:
                        pass
                    events.close()

            def do_POST(self):
                # Counted until the reply is written, so a drain's
                # shutdown waits for the replies of the requests it let
                # finish.
                with server._posts_lock:
                    server._posts_active += 1
                try:
                    self._post()
                finally:
                    with server._posts_lock:
                        server._posts_active -= 1

            def _post(self):
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
                path = self.path.split("?", 1)[0]
                try:
                    with server.tracer.span(
                        "http_request", route=path,
                        stream=bool(body.get("stream")),
                    ):
                        if (
                            body.get("stream")
                            and path in ("/v1/generate", "/v1/chat")
                        ):
                            err, events = server.start_stream(
                                path, body, self._token(),
                                request_id=self._request_id(),
                            )
                            if err is not None:
                                self._reply(*err)
                            else:
                                self._reply_sse(events)
                            return
                        code, payload = server.handle(
                            "POST", path, body, self._token(),
                            request_id=self._request_id(),
                        )
                except Exception as e:  # surface as 500, keep serving
                    logger.exception("request failed")
                    code, payload = 500, {"error": str(e)}
                self._reply(code, payload)

        return Handler

    def make_httpd(self, host: str = "127.0.0.1", port: int = 5001):
        """The HTTP server bound to (host, port); port 0 picks a free one
        (read it back from `httpd.server_address`)."""
        return ThreadingHTTPServer((host, port), self.make_handler())

    def close(self) -> None:
        """Stop the threads this server started (the scheduler's worker,
        the history sampler, the watchdog), for embedders that cycle
        servers."""
        close = getattr(self.batcher, "close", None)
        if callable(close):
            close()
        if getattr(self, "watchdog", None) is not None:
            self.watchdog.close()
        if self.history is not None:
            self.history.stop()
            if self._installed_history and get_history() is self.history:
                set_history(None)

    def serve_forever(self, host: str = "127.0.0.1", port: int = 5001):
        httpd = self.make_httpd(host, port)

        def _graceful(sig, frame):  # pragma: no cover - signal-driven
            logger.warning(
                "signal %s: draining (grace %.0fs) before shutdown",
                sig, self.drain_grace_s,
            )

            def _stop():
                self.drain()
                # The drained requests' handlers still write their
                # replies: wait for them (bounded) before shutting down.
                deadline = time.time() + self.drain_grace_s
                while self._posts_active and time.time() < deadline:
                    time.sleep(0.01)
                httpd.shutdown()

            # shutdown() must not run on the serve_forever thread (it
            # joins the poll loop), and a signal handler must return fast.
            threading.Thread(target=_stop, daemon=True).start()

        import signal as _signal

        try:
            _signal.signal(_signal.SIGTERM, _graceful)
            _signal.signal(_signal.SIGINT, _graceful)
        except ValueError:  # pragma: no cover - non-main thread (tests)
            pass
        logger.info("serving on http://%s:%d (secure=%s)",
                    *httpd.server_address[:2], self.secure)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()


def serve(
    engine,
    checkpoint: Optional[str] = None,
    host: str = "127.0.0.1",
    port: int = 5001,
    secure: bool = False,
    bootstrap_user: Optional[tuple] = None,
    num_slots: int = 8,
    page_size: int = 128,
    continuous: Any = "auto",
    admission_window_ms: float = 0.0,
    telemetry: bool = True,
    trace_jsonl: Optional[str] = None,
    trace_jax: bool = False,
    latency_buckets=None,
    request_timeout_s: Optional[float] = None,
    max_queue_depth: int = 128,
    drain_grace_s: float = 30.0,
    flight_dir: Optional[str] = None,
    max_tenants: int = 64,
    prefill_chunk_tokens: Optional[int] = None,
    prefix_cache_pages: Optional[int] = None,
    prefix_cache_tenant_quota: Optional[int] = None,
    tenant_rate_per_s: Optional[float] = None,
    tenant_burst: Optional[int] = None,
    watchdog: bool = True,
    watchdog_abort: bool = False,
    watchdog_k: Optional[float] = None,
    watchdog_floor_s: Optional[float] = None,
    slo: bool = True,
    slo_config: Optional[str] = None,
    healthz_stale_after_s: Optional[float] = None,
    page_share: Optional[str] = None,
    page_share_self_url: Optional[str] = None,
    page_pull_timeout_s: Optional[float] = None,
    page_share_max_inflight: Optional[int] = None,
    quantize: Optional[str] = None,
    kv_cache_dtype: Optional[str] = None,
):
    """Serve an engine (CLI `serve`; the CLI builds the engine from
    --checkpoint, --weights or --seed, with --adapter merged, and its
    --quantize / --kv-cache-dtype in the engine's config). The JAX serve()
    builds its engine here from a checkpoint; `quantize` and
    `kv_cache_dtype` apply to the given engine as JAX applies them to the
    one it builds (an engine already quantized passes through).
    `trace_jax` (the JAX flag's name) mirrors every span as a
    torch.profiler.record_function range, and traces spans without a
    --trace-jsonl file too (kept in memory)."""
    if quantize is not None or kv_cache_dtype is not None:
        engine.configure(quantize=quantize, kv_cache_dtype=kv_cache_dtype)
    if page_share and not page_share_self_url:
        # Peers reach this replica at the address it serves on; an
        # explicit --page-share-self overrides (NAT, name-based balancers).
        page_share_self_url = f"http://{host}:{port}"
    tracer = NULL_TRACER
    if trace_jsonl or trace_jax:
        tracer = SpanTracer(jsonl_path=trace_jsonl,
                            profiler_ranges=trace_jax)
    ChatServer(
        engine, secure=secure, bootstrap_user=bootstrap_user,
        continuous=continuous, num_slots=num_slots, page_size=page_size,
        admission_window_ms=admission_window_ms,
        prefill_chunk_tokens=prefill_chunk_tokens,
        prefix_cache_pages=prefix_cache_pages,
        prefix_cache_tenant_quota=prefix_cache_tenant_quota,
        tenant_rate_per_s=tenant_rate_per_s,
        tenant_burst=tenant_burst,
        telemetry=telemetry,
        tracer=tracer,
        request_timeout_s=request_timeout_s,
        max_queue_depth=max_queue_depth,
        drain_grace_s=drain_grace_s,
        # Drain dumps the wide-event ring next to the checkpoint (or the
        # working dir) so a SIGTERM'd server leaves a queryable trail.
        flight_dir=flight_dir or checkpoint or ".",
        max_tenants=max_tenants,
        watchdog=("auto" if watchdog else None),
        watchdog_abort=watchdog_abort,
        watchdog_k=watchdog_k,
        watchdog_floor_s=watchdog_floor_s,
        slo=slo,
        slo_config=slo_config,
        healthz_stale_after_s=healthz_stale_after_s,
        # Cross-replica page sharing (--page-share <router url>).
        page_share=page_share,
        page_share_self_url=page_share_self_url,
        page_pull_timeout_s=page_pull_timeout_s,
        page_share_max_inflight=page_share_max_inflight,
        latency_buckets=(
            tuple(latency_buckets)
            if latency_buckets
            else DEFAULT_LATENCY_BUCKETS
        ),
        # Gate /healthz behind a first generation: probes hold traffic
        # until the kernels are built and have run.
        warmup=True,
    ).serve_forever(host, port)
