"""(The port's copy of luminaai_tpu/inference/prefix_cache.py: the same
chained page hashes, byte for byte, and the same bookkeeping.)

Radix prefix cache over the paged KV pool (ROADMAP item 2).

Real chat traffic is dominated by shared prefixes — system prompts,
few-shot templates, multi-turn history — yet a cold admission re-runs
prefill from token zero for content that is byte-identical across
requests. This module is the HOST-side index that lets the serving stack
skip that work: prompt-token pages are content-hashed with a hash
CHAINED over the prefix (a page's key encodes every token before it, so
two prompts share a cached page only when their entire prefixes match),
and cached pages live in a reserved arena region of the same device pool
the lanes decode from. On admission, the StepwiseDecoder looks up the
longest cached page chain, splices the arena pages into the lane's
GLOBAL page table (ops/ragged_paged_attention.py global_pages — the
attention gather reads them in place, no bytes move), and runs chunked
prefill only on the uncached suffix. Copy-on-write falls out of the page
granularity: shared pages are read-only by construction (decode rows and
the divergent suffix land in the lane's own identity-mapped pages), so
"the first divergent token allocates a private page" is simply the
lane's own page the write was always headed for.

Pure host bookkeeping — no torch imports, no device tensors. The decoder
owns the device side (harvest copies, table splices); the cache owns
WHICH arena page holds WHAT and the sharing/eviction invariants:

  - refcounts: a page referenced by a live lane is never evicted
    (acquire() pins under the lock; release() unpins in
    ContinuousScheduler._release_slot via StepwiseDecoder.release_slot);
  - chain order: a page is evictable only when no cached page chains
    THROUGH it (children == 0) — eviction eats chains from the tail, so
    the index never holds a suffix whose prefix is gone;
  - LRU: among evictable pages, the least-recently-used goes first
    (a deterministic touch counter, not wall time);
  - per-tenant quota: pages are attributed to the tenant that inserted
    them; a tenant at quota evicts ITS OWN evictable pages first and is
    refused otherwise — one hot tenant cannot flush everyone else's
    cached prefixes (docs/serving.md "Prefix cache + tenant QoS").
"""

from __future__ import annotations

import hashlib
import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


def page_chain_keys(
    tokens: Sequence[int], page_size: int, n_pages: Optional[int] = None
) -> List[str]:
    """Chained content hashes for the FULL pages of a token sequence:
    key_i = sha256(key_{i-1} || tokens[i*ps:(i+1)*ps]). Only whole pages
    are keyed — a partially-filled tail page is recomputed by the
    admission's suffix prefill, never cached."""
    ps = int(page_size)
    full = len(tokens) // ps
    if n_pages is not None:
        full = min(full, n_pages)
    keys: List[str] = []
    h = b""
    for i in range(full):
        page = tokens[i * ps:(i + 1) * ps]
        payload = h + b"," + ",".join(str(int(t)) for t in page).encode()
        h = hashlib.sha256(payload).digest()
        keys.append(h.hex())
    return keys


@dataclass
class _CachedPage:
    """One arena-resident cached page: its chain key, physical arena
    page (GLOBAL pool page id), and the sharing/eviction accounting."""

    key: str
    page_id: int
    parent_key: Optional[str]
    tenant: str
    refs: int = 0
    children: int = 0
    last_use: int = 0
    hits: int = 0
    # False from insert() until the decoder has written the page's bytes
    # (mark_landed): pin_key() never hands an unwritten page to an export.
    landed: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class _EvictedInfo:
    pages: int = 0
    keys: List[str] = field(default_factory=list)


class RadixPrefixCache:
    """Host-side radix/prefix index mapping token-page chains to cached
    arena pages, with refcounted sharing and LRU eviction.

    arena_page_ids: the GLOBAL pool page ids reserved for cached pages
    (the decoder carves them out of slots past its lane range).
    page_size: tokens per page (the pool's row granularity).
    tenant_quota: max arena pages any one tenant may hold (0 = no bound).
    recorder: optional FlightRecorder; evictions emit `prefix_evict`
    events (the scheduler wires its recorder in, honoring the telemetry
    off switch by leaving it None).
    """

    def __init__(
        self,
        arena_page_ids: Sequence[int],
        page_size: int,
        tenant_quota: int = 0,
        recorder: Any = None,
    ):
        self.page_size = int(page_size)
        self.capacity = len(arena_page_ids)
        self.tenant_quota = max(0, int(tenant_quota))
        self.recorder = recorder
        self._free: List[int] = list(arena_page_ids)[::-1]
        self._index: Dict[str, _CachedPage] = {}
        # Reverse map page_id -> chain key so release() (every request
        # completion) is O(pages released), not O(cache size).
        self._by_page: Dict[int, str] = {}
        self._clock = 0
        self._lock = threading.RLock()
        # Counters (stats()/telemetry gauges read these under the lock).
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.tokens_saved = 0
        self.pages_spliced = 0
        self._tenant_pages: Dict[str, int] = {}
        # In-flight dedup (ROADMAP item 2): chain keys whose pages are
        # being computed by a live admission RIGHT NOW. A concurrent
        # identical prefix parks behind the pending entry instead of
        # re-running the whole prefill cold — before this, N same-prefix
        # admissions landing before the first harvest all missed.
        self._pending: Dict[str, int] = {}
        self.dedup_waits = 0

    # -- lookup / pin ------------------------------------------------------
    def lookup(
        self,
        tokens: Sequence[int],
        max_pages: Optional[int] = None,
        keys: Optional[List[str]] = None,
    ) -> Tuple[List[str], List[int]]:
        """Longest cached page chain for this prompt (read-only, no
        pinning). Returns (chain keys, arena page ids). `keys` reuses a
        precomputed chain (the decoder hashes each prompt once per
        admission, not once per cache call)."""
        with self._lock:
            if keys is None:
                keys = page_chain_keys(tokens, self.page_size, max_pages)
            matched_keys: List[str] = []
            matched_ids: List[int] = []
            for key in keys:
                ent = self._index.get(key)
                if ent is None:
                    break
                matched_keys.append(key)
                matched_ids.append(ent.page_id)
            return matched_keys, matched_ids

    def acquire(
        self,
        tokens: Sequence[int],
        max_pages: Optional[int] = None,
        keys: Optional[List[str]] = None,
    ) -> Tuple[List[int], int]:
        """Pin the longest cached prefix for a lane being admitted.
        Returns (arena page ids, matched token rows). Pinning happens
        atomically under the lock, so an acquired page can never be
        LRU-evicted before the lane's table points at it ("no lane
        admitted pointing at an evicted page")."""
        with self._lock:
            matched_keys, matched_ids = self.lookup(
                tokens, max_pages, keys=keys
            )
            self._clock += 1
            for key in matched_keys:
                ent = self._index[key]
                ent.refs += 1
                ent.hits += 1
                ent.last_use = self._clock
            if matched_keys:
                self.hits += 1
                self.pages_spliced += len(matched_keys)
                self.tokens_saved += len(matched_keys) * self.page_size
            else:
                self.misses += 1
            return matched_ids, len(matched_ids) * self.page_size

    def release(self, page_ids: Sequence[int]) -> None:
        """Unpin a lane's spliced pages (its slot is being freed). The
        pages stay cached — surviving lane eviction is the whole point —
        they just become LRU-evictable once nobody references them."""
        if not page_ids:
            return
        with self._lock:
            for pid in page_ids:
                key = self._by_page.get(int(pid))
                ent = self._index.get(key) if key is not None else None
                if ent is not None and ent.refs > 0:
                    ent.refs -= 1

    def pin_pages(self, page_ids: Sequence[int]) -> None:
        """Refcount-pin pages by arena id (release() unpins). Used by
        the decoder's deferred harvest queue: a freshly-inserted page
        whose device copy has not flushed yet must not be LRU-evicted
        (and its arena slot reassigned) by a later insert's pressure."""
        if not page_ids:
            return
        with self._lock:
            for pid in page_ids:
                key = self._by_page.get(int(pid))
                ent = self._index.get(key) if key is not None else None
                if ent is not None:
                    ent.refs += 1

    def pin_key(self, key: str) -> Optional[int]:
        """Refcount-pin ONE cached page by chain key, returning its arena
        page id (None when not resident, or inserted but its bytes not yet
        written: a queued harvest copy or a remote pull still running).
        The page export route (GET /pages/<key>) pins across the copy to
        the host, so eviction cannot reassign the arena page
        mid-serialization; release([page_id]) unpins. Insert and this
        check share the lock, so no export sees a page between its insert
        and its write."""
        with self._lock:
            ent = self._index.get(key)
            if ent is None or not ent.landed:
                return None
            ent.refs += 1
            self._clock += 1
            ent.last_use = self._clock
            return ent.page_id

    def mark_landed(self, page_ids: Sequence[int]) -> None:
        """These arena pages' bytes are written (a flushed harvest copy,
        an imported remote page): pin_key() may now serve them."""
        with self._lock:
            for pid in page_ids:
                key = self._by_page.get(int(pid))
                ent = self._index.get(key) if key is not None else None
                if ent is not None:
                    ent.landed = True

    def keys_for_pages(self, page_ids: Sequence[int]) -> List[str]:
        """Chain keys currently backing these arena page ids (unknown ids
        are skipped): a flushed harvest's dst pages mapped back to the
        keys the replica reports to the fleet index."""
        with self._lock:
            out: List[str] = []
            for pid in page_ids:
                key = self._by_page.get(int(pid))
                if key is not None and key in self._index:
                    out.append(key)
            return out

    # -- insert / evict ----------------------------------------------------
    def _evictable(self, tenant: Optional[str] = None) -> List[_CachedPage]:
        ents = [
            e for e in self._index.values()
            if e.refs == 0 and e.children == 0
            and (tenant is None or e.tenant == tenant)
        ]
        return sorted(ents, key=lambda e: e.last_use)

    def _evict_one(
        self, tenant: Optional[str] = None, exclude: frozenset = frozenset()
    ) -> bool:
        ents = [e for e in self._evictable(tenant) if e.key not in exclude]
        if not ents:
            return False
        ent = ents[0]
        del self._index[ent.key]
        self._by_page.pop(ent.page_id, None)
        if ent.parent_key is not None:
            parent = self._index.get(ent.parent_key)
            if parent is not None:
                parent.children -= 1
        self._free.append(ent.page_id)
        self._tenant_pages[ent.tenant] = max(
            0, self._tenant_pages.get(ent.tenant, 0) - 1
        )
        self.evictions += 1
        if self.recorder is not None:
            self.recorder.emit(
                "prefix_evict", page_id=ent.page_id, tenant=ent.tenant,
                hits=ent.hits, reason="lru",
            )
        return True

    def insert(
        self, tokens: Sequence[int], from_page: int, tenant: str = "anon"
    ) -> List[Tuple[int, int]]:
        """Register the full pages [from_page, len(tokens)//page_size) of
        a just-prefilled prompt. Returns [(prompt page index, arena page
        id)] assignments for pages NOT already cached — the decoder then
        copies those pages' K/V from the lane's slot into the arena (the
        one-time cost a cached prefix is amortized over). Pages refused
        by the arena/tenant budget are simply skipped; a chain prefix
        without its tail is still a valid (shorter) cached prefix."""
        with self._lock:
            keys = page_chain_keys(tokens, self.page_size)
            protected = frozenset(keys)  # never evict this prompt's chain
            out: List[Tuple[int, int]] = []
            self._clock += 1
            for j in range(len(keys)):
                key = keys[j]
                ent = self._index.get(key)
                if ent is not None:
                    ent.last_use = self._clock
                    continue
                if j < from_page:
                    # A parent page this prompt spliced (or would have):
                    # it must exist for the chain to continue; if it was
                    # never cached the chain is broken — stop.
                    break
                # Budget: tenant quota first (evict own pages only), then
                # the global arena (LRU across evictable pages). The
                # chain being inserted is protected from its own
                # eviction pressure.
                if self.tenant_quota and self._tenant_pages.get(
                    tenant, 0
                ) >= self.tenant_quota:
                    if not self._evict_one(tenant, exclude=protected):
                        break
                if not self._free and not self._evict_one(
                    exclude=protected
                ):
                    break
                page_id = self._free.pop()
                parent_key = keys[j - 1] if j > 0 else None
                if parent_key is not None:
                    parent = self._index.get(parent_key)
                    if parent is None:  # pragma: no cover - excluded above
                        self._free.append(page_id)
                        break
                    parent.children += 1
                self._index[key] = _CachedPage(
                    key=key, page_id=page_id, parent_key=parent_key,
                    tenant=tenant, last_use=self._clock,
                )
                self._by_page[page_id] = key
                self._tenant_pages[tenant] = (
                    self._tenant_pages.get(tenant, 0) + 1
                )
                self.inserts += 1
                out.append((j, page_id))
            return out

    def forget(self, page_ids: Sequence[int]) -> int:
        """Unwind freshly-inserted pages whose device copy FAILED: the
        index must never point at an arena page that was not actually
        written (a later hit would splice uninitialized K/V). Children-
        last removal keeps chain consistency; not counted as eviction
        (no prefix_evict event — nothing real was cached)."""
        wanted = {int(p) for p in page_ids}
        removed = 0
        with self._lock:
            while wanted:
                ent = next(
                    (
                        e for e in self._index.values()
                        if e.page_id in wanted and e.children == 0
                    ),
                    None,
                )
                if ent is None:
                    break  # pragma: no cover - foreign/parented ids
                del self._index[ent.key]
                self._by_page.pop(ent.page_id, None)
                if ent.parent_key is not None:
                    parent = self._index.get(ent.parent_key)
                    if parent is not None:
                        parent.children -= 1
                self._free.append(ent.page_id)
                self._tenant_pages[ent.tenant] = max(
                    0, self._tenant_pages.get(ent.tenant, 0) - 1
                )
                self.inserts = max(0, self.inserts - 1)
                wanted.discard(ent.page_id)
                removed += 1
        return removed

    # -- in-flight dedup ---------------------------------------------------
    def has_pending_prefix(self, keys: Sequence[str]) -> bool:
        """True when this prompt's FIRST non-resident page is being
        computed by another live admission — the caller should park and
        re-check instead of prefilling the same prefix cold."""
        with self._lock:
            for key in keys:
                if key in self._index:
                    continue
                return key in self._pending
            return False

    def claim_pending(
        self, keys: Sequence[str], owner: int = 0
    ) -> List[str]:
        """Claim the non-resident tail of this chain for the caller's
        harvest. Stops at a key another admission already owns (its
        harvest will cover it). Returns the claimed keys; the caller
        MUST release_pending() them when its harvest lands or its lane
        dies — a leaked claim would park followers until their wait
        budget expires."""
        with self._lock:
            out: List[str] = []
            for key in keys:
                if key in self._index:
                    continue
                if key in self._pending:
                    break
                self._pending[key] = owner
                out.append(key)
            return out

    def release_pending(self, keys: Sequence[str]) -> None:
        with self._lock:
            for key in keys:
                self._pending.pop(key, None)

    def note_dedup_wait(self) -> None:
        with self._lock:
            self.dedup_waits += 1

    def pending_pages(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- introspection -----------------------------------------------------
    def pages_cached(self) -> int:
        with self._lock:
            return len(self._index)

    def page_refs(self) -> int:
        """Sum of live lane references over cached pages (the sharing
        fan-out /metrics watches)."""
        with self._lock:
            return sum(e.refs for e in self._index.values())

    def tenant_pages(self, tenant: str) -> int:
        with self._lock:
            return self._tenant_pages.get(tenant, 0)

    def hit_rate(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return (self.hits / total) if total else 0.0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity_pages": self.capacity,
                "pages_cached": len(self._index),
                "pages_free": len(self._free),
                "page_refs": sum(e.refs for e in self._index.values()),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hit_rate(), 4),
                "inserts": self.inserts,
                "evictions": self.evictions,
                "tokens_saved": self.tokens_saved,
                "pages_spliced": self.pages_spliced,
                "tenant_quota": self.tenant_quota,
                "tenants": dict(self._tenant_pages),
                "pending_pages": len(self._pending),
                "dedup_waits": self.dedup_waits,
            }
