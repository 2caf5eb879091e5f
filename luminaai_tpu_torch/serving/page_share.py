"""Cross-replica KV page sharing: the keying rule and the page transfer
client (the port's copy of luminaai_tpu/serving/page_share.py; the same
keys, the same conversations, the same counters).

The router lands shared prompts on one replica by prefix-hash affinity,
but each replica's radix prefix cache is its own: on failover or
rebalance another replica would prefill again the pages the fleet
already computed. This module is the host-side plane that closes that
gap, with a ROUTER-CENTERED INDEX and DIRECT PAGE PULLS:

    replica A --POST /pages/report--> router     (harvest landed: keys)
    replica B --POST /pages/lookup--> router     (cold chain: who owns?)
    replica B --GET  /pages/<key>---> replica A  (page bytes, LPG1 frame)

The router holds chain keys and owner URLs, never page bytes; the bulk
transfer goes replica to replica once per pull. A transfer failure is
degraded to a local prefill by the puller
(`StepwiseDecoder._try_remote_pull`): a dead owner costs at most one
pull deadline, never a wedged admission.

THE SHARED KEYING RULE (the router's affinity hash and the cache's chain
ownership both use it): the cache keys whole token pages with a hash
chained over the prefix (inference/prefix_cache.page_chain_keys), never a
partial tail page. The router cannot tokenize, so it mirrors that shape
at the character level: the request's prefix text (`prompt`, else the
FIRST chat message, the system prompt), NFKC-normalized, capped at the
prefix budget, cut to WHOLE `AFFINITY_BLOCK_CHARS`-char blocks. A prompt
too short to fill one block has no cacheable chain either and keys on its
raw text, for load spread only. The fleet page index (exact sha256 chain
keys) is the authoritative owner map.

Stdlib HTTP only: no torch here. The byte-fetch seam (`fetch_page`) is
where fault injectors drop or stall pulls.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
import unicodedata
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence, Tuple

from luminaai_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)

__all__ = [
    "AFFINITY_BLOCK_CHARS",
    "request_prefix_text",
    "affinity_key",
    "PageShareClient",
]

# Char-level analog of the cache's token page_size (pages are 16-64
# tokens in practice; one block ~ one short page of English text).
AFFINITY_BLOCK_CHARS = 64

# A page payload is page_size rows of every KV leaf — generously bounded
# so a confused owner can never balloon the puller's memory.
MAX_PAGE_PAYLOAD_BYTES = 64 * 1024 * 1024


def request_prefix_text(body: Dict[str, Any]) -> str:
    """The request text whose prefix identifies its cache chain:
    `prompt` verbatim, else the FIRST chat message (system prompt —
    the part shared across a template's requests), else `message`."""
    if "prompt" in body:
        return str(body.get("prompt", ""))
    msgs = body.get("messages")
    if isinstance(msgs, list) and msgs:
        return json.dumps(msgs[0], sort_keys=True, default=str)
    return str(body.get("message", ""))


def affinity_key(path: str, body: Dict[str, Any],
                 prefix_chars: int = 256) -> str:
    """Routing identity under the shared keying rule (module docstring).
    Whole-block truncation mirrors `page_chain_keys` never keying a
    partial tail page; sub-block prompts (uncacheable anyway) keep
    their raw text so short unrelated prompts still spread."""
    text = unicodedata.normalize(
        "NFKC", request_prefix_text(body)
    )[: max(0, int(prefix_chars))]
    whole = (len(text) // AFFINITY_BLOCK_CHARS) * AFFINITY_BLOCK_CHARS
    if whole > 0:
        text = text[:whole]
    return path + "\x00" + text


class PageShareClient:
    """One replica's handle on the fleet page plane.

    Owns the three replica-side conversations (report, lookup, fetch)
    plus their telemetry. All I/O is stdlib HTTP against injectable
    seams: `post_json` for the router control conversations and
    `fetch_page` for the owner byte pull (the faults.py injection
    point). Every failure mode degrades to "not shared": a dead router
    means cold admissions, never errors.

    `self_url` is how OTHER replicas reach this one — the advertised
    URL sent with reports and excluded from lookups. Servers binding
    port 0 set it after the listener exists.
    """

    def __init__(
        self,
        router_url: str,
        self_url: str = "",
        timeout_s: float = 2.0,
        max_inflight: int = 2,
        registry: Any = None,
        recorder: Any = None,
        retry: Optional[RetryPolicy] = None,
        clock=time.monotonic,
    ):
        self.router_url = str(router_url).rstrip("/")
        self.self_url = str(self_url).rstrip("/")
        self.timeout_s = max(0.05, float(timeout_s))
        self.recorder = recorder
        self._clock = clock
        # Pull concurrency bound: a replica mid-rebalance must not turn
        # into a page-transfer firehose; an admission that cannot take
        # a pull slot RIGHT NOW just prefills locally (non-blocking).
        self._inflight = threading.BoundedSemaphore(
            max(1, int(max_inflight))
        )
        # Per-page fetch retry, bounded by the overall pull deadline the
        # decoder enforces; transfer failure must never be worse than a
        # cache miss, so the ladder is short.
        self.retry = retry or RetryPolicy(
            max_attempts=2, base_delay_s=0.05, max_delay_s=0.2,
            timeout_s=self.timeout_s, registry=None, recorder=None,
        )
        # Counters survive a None registry as no-ops via _Null.
        self._m_pulls = _metric(
            registry, "counter", "serve_prefix_remote_pulls_total",
            "Remote page pulls attempted (per page)")
        self._m_pull_failures = _metric(
            registry, "counter",
            "serve_prefix_remote_pull_failures_total",
            "Remote page pulls that failed (per page; admission "
            "degraded to local prefill)")
        self._m_bytes = _metric(
            registry, "counter", "serve_page_transfer_bytes_total",
            "Bytes of KV page payload pulled from other replicas")
        self._m_pull_s = _metric(
            registry, "histogram", "serve_page_pull_seconds",
            "Per-page remote pull latency (fetch + parse)")
        self._m_reports = _metric(
            registry, "counter", "serve_page_reports_total",
            "Harvest ownership reports posted to the router")

    # -- low-level transport (stdlib; both methods are test seams) -------
    def post_json(
        self, base_url: str, path: str, body: Dict[str, Any],
        timeout_s: Optional[float] = None,
    ) -> Tuple[int, Dict[str, Any]]:
        u = urllib.parse.urlsplit(base_url)
        conn = http.client.HTTPConnection(
            u.hostname, u.port or 80,
            timeout=timeout_s or self.timeout_s,
        )
        try:
            conn.request(
                "POST", path, body=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            raw = resp.read()
            try:
                doc = json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                doc = {}
            return resp.status, doc
        finally:
            conn.close()

    def get_bytes(
        self, base_url: str, path: str,
        timeout_s: Optional[float] = None,
    ) -> Tuple[int, bytes]:
        u = urllib.parse.urlsplit(base_url)
        conn = http.client.HTTPConnection(
            u.hostname, u.port or 80,
            timeout=timeout_s or self.timeout_s,
        )
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read(MAX_PAGE_PAYLOAD_BYTES + 1)
        finally:
            conn.close()

    # -- control plane ---------------------------------------------------
    def report(self, keys: Sequence[str]) -> bool:
        """Tell the router this replica owns these chain keys. Best
        effort: ownership is a hint, not a ledger — a lost report costs
        one missed sharing opportunity, so errors are swallowed."""
        keys = [str(k) for k in keys]
        if not keys or not self.self_url:
            return False
        try:
            status, _ = self.post_json(
                self.router_url, "/pages/report",
                {"replica": self.self_url, "keys": keys},
            )
        except OSError as e:
            logger.debug("page report failed: %s", e)
            return False
        if status == 200:
            self._m_reports.inc(len(keys))
            return True
        return False

    def report_async(self, keys: Sequence[str]) -> None:
        """report() off the scheduler tick (daemon thread): index
        freshness is worth zero decode latency."""
        keys = [str(k) for k in keys]
        if not keys or not self.self_url:
            return
        threading.Thread(
            target=self.report, args=(keys,),
            name="page-share-report", daemon=True,
        ).start()

    def lookup(
        self, keys: Sequence[str], have: int = 0
    ) -> Tuple[Optional[str], List[str]]:
        """Ask the router who owns this chain beyond the `have` pages
        already resident locally. Returns (owner url, covered prefix
        of `keys`) or (None, []) — on ANY failure the admission just
        proceeds cold."""
        keys = [str(k) for k in keys]
        if not keys:
            return None, []
        try:
            status, doc = self.post_json(
                self.router_url, "/pages/lookup",
                {"keys": keys, "have": int(have),
                 "exclude": self.self_url},
            )
        except OSError as e:
            logger.debug("page lookup failed: %s", e)
            return None, []
        if status != 200 or not doc.get("owner"):
            return None, []
        owned = [k for k in doc.get("keys", []) if isinstance(k, str)]
        # The owner's chain must be a prefix of ours — anything else is
        # a stale/garbled index entry and pulling it would splice the
        # wrong bytes.
        if owned != keys[: len(owned)]:
            return None, []
        return str(doc["owner"]).rstrip("/"), owned

    # -- pull slots ------------------------------------------------------
    def try_begin_pull(self) -> bool:
        """Non-blocking pull-slot acquire; False = at max_inflight, the
        caller treats the admission as a plain miss."""
        return self._inflight.acquire(blocking=False)

    def end_pull(self) -> None:
        self._inflight.release()

    # -- data plane ------------------------------------------------------
    def fetch_page(self, owner_url: str, key: str,
                   timeout_s: Optional[float] = None) -> bytes:
        """Pull ONE page's framed bytes from its owner. Raises OSError
        on transport failure / non-200 / oversize — the caller books
        the failure and falls back to local prefill. Fault injectors
        (`testing/faults.drop_page_pulls`) wrap exactly this method."""
        t = self.timeout_s if timeout_s is None else max(
            0.05, float(timeout_s)
        )
        t0 = self._clock()
        try:
            status, payload = self.retry.call(
                self.get_bytes, owner_url, f"/pages/{key}",
                timeout_s=t, op="page_pull",
            )
        except Exception:
            self._observe_pull(key, owner_url, t0, ok=False, nbytes=0)
            raise
        if status != 200:
            self._observe_pull(key, owner_url, t0, ok=False, nbytes=0)
            raise OSError(f"page owner answered {status} for {key[:16]}")
        if len(payload) > MAX_PAGE_PAYLOAD_BYTES:
            self._observe_pull(key, owner_url, t0, ok=False, nbytes=0)
            raise OSError("page payload exceeds size bound")
        self._observe_pull(key, owner_url, t0, ok=True,
                           nbytes=len(payload))
        return payload

    def _observe_pull(self, key: str, owner: str, t0: float,
                      ok: bool, nbytes: int) -> None:
        dt = max(0.0, self._clock() - t0)
        self._m_pulls.inc()
        if ok:
            self._m_bytes.inc(nbytes)
        else:
            self._m_pull_failures.inc()
        self._m_pull_s.observe(dt)
        if self.recorder is not None:
            self.recorder.emit(
                "page_pull", key=key[:16], owner=owner, ok=ok,
                bytes=nbytes, seconds=round(dt, 4),
            )


class _Null:
    """No-op metric stand-in for a None registry (telemetry off)."""

    def inc(self, amount: float = 1.0) -> None:
        pass

    def observe(self, value: float, count: int = 1) -> None:
        pass


def _metric(registry: Any, kind: str, name: str, help_text: str):
    if registry is None:
        return _Null()
    return getattr(registry, kind)(name, help_text)
