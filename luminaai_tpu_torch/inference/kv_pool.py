"""Slot-paged KV cache pool for continuous batching (PyTorch counterpart of
luminaai_tpu/inference/kv_pool.py).

One preallocated pool per layer and side, laid out
`[num_slots, pages, page_size, kv_heads, head_dim]`. Requests are admitted
into slots; all accounting (free-list, per-slot lengths, reuse counters,
page tables) is host-side numpy, so admission never reads device memory.
The device tensors are updated in place by the attention layers, through
the flat `[num_slots, pages * page_size, kv_heads, head_dim]` views that
`to_flat` returns (views of the same storage, never copies).

With the prefix cache on, the decoder allocates the tensors with arena
slots PAST the lane range (total slots = num_slots + arena slots): the pool
accounts for the lanes only, and the arena's pages are reached through the
decoder's global page table; those arena pages are what the fleet's
page sharing exports and imports (export_page / import_page, in the JAX
pool's LPG1 wire format, byte for byte).

With kv_cache_dtype='int8' each side of a layer is a pair (codes int8,
scales fp32 [..., 1]) instead of one tensor, as in the JAX cache tree;
`map_sides` and `cache_leaves` walk either form, the leaves in JAX's
flatten order (per layer: k codes, k scales, v codes, v scales).
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# A layer's (k, v); each side a tensor or an int8 (codes, scales) pair.
KVPair = Tuple[Any, Any]

# Wire format for one serialized KV page (cross-replica page pulls), the
# JAX pool's: magic, 4-byte big-endian header length, JSON header
# {"page_size": int, "leaves": [{"shape": [...], "dtype": "..."}]}, then
# each leaf's C-order bytes in layer order (layer 0 k, layer 0 v, layer 1
# k, ...; int8 pools: layer 0 k codes, k scales, v codes, v scales, ...),
# each leaf [page_size, kv_heads, head_dim or 1] after any leading axes.
PAGE_WIRE_MAGIC = b"LPG1"

# The numpy dtype names the JAX pool writes for the cache dtypes the port
# holds, and the torch dtypes they frame. bfloat16 is numpy's name under
# ml_dtypes; here it maps straight to torch.bfloat16, whose bytes are the
# same. An int8 pool's codes are "int8", its scales "float32".
_WIRE_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def parse_page_payload(payload: bytes) -> List[torch.Tensor]:
    """Decode a PAGE_WIRE_MAGIC-framed payload into per-leaf CPU tensors
    (layer order), views of one copy of the payload. Raises ValueError on
    any framing mismatch: truncated, trailing or mislabeled bytes never
    reach the arena."""
    if payload[:4] != PAGE_WIRE_MAGIC:
        raise ValueError("bad page payload magic")
    if len(payload) < 8:
        raise ValueError("truncated page payload header")
    hlen = int.from_bytes(payload[4:8], "big")
    try:
        header = json.loads(bytes(payload[8:8 + hlen]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"bad page payload header: {e}") from e
    if not isinstance(header, dict):
        raise ValueError("bad page payload header: not an object")
    data = bytearray(payload)
    off = 8 + hlen
    out: List[torch.Tensor] = []
    for meta in header.get("leaves", []):
        try:
            dt = _WIRE_DTYPES[str(meta["dtype"])]
            shape = tuple(int(d) for d in meta["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad page payload leaf {meta!r}") from e
        if any(d < 0 for d in shape):
            raise ValueError(f"bad page payload leaf shape {shape}")
        count = math.prod(shape)
        n = count * dt.itemsize
        if off + n > len(data):
            raise ValueError("truncated page payload body")
        leaf = (torch.frombuffer(data, dtype=dt, count=count, offset=off)
                if count else torch.empty((0,), dtype=dt))
        out.append(leaf.view(shape))
        off += n
    if off != len(payload):
        raise ValueError("trailing bytes after page payload")
    return out


def map_sides(fn: Callable[[torch.Tensor], Any],
              caches: Sequence[KVPair]) -> List[KVPair]:
    """fn applied to every tensor of per-layer (k, v) caches, the
    structure kept (an int8 side stays a (codes, scales) pair)."""

    def side(x):
        return tuple(fn(t) for t in x) if isinstance(x, tuple) else fn(x)

    return [(side(k), side(v)) for k, v in caches]


def cache_leaves(caches: Sequence[KVPair]) -> List[torch.Tensor]:
    """Every tensor of the caches in JAX's tree-flatten order."""
    out: List[torch.Tensor] = []
    for kv in caches:
        for x in kv:
            out.extend(x if isinstance(x, tuple) else (x,))
    return out


def to_paged(caches: Sequence[KVPair], pages: int, page_size: int) -> List[KVPair]:
    """[..., C, heads, dim] -> [..., pages, page_size, heads, dim] views."""
    return map_sides(
        lambda x: x.view(x.shape[:-3] + (pages, page_size) + x.shape[-2:]),
        caches)


def to_flat(caches: Sequence[KVPair], pages: int, page_size: int) -> List[KVPair]:
    """Inverse of to_paged: the [..., pages * page_size, heads, dim] views
    the attention layers read and write."""
    return map_sides(
        lambda x: x.view(x.shape[:-4] + (pages * page_size,) + x.shape[-2:]),
        caches)


class PagedKVPool:
    """Host-side slot accounting over a preallocated paged KV cache list.

    caches: per-layer (k, v) tensors in paged layout (None for
    accounting-only use). alloc()/free() manage the slot free-list; lengths
    tracks rows in use per slot; reuses counts slots handed out again.
    """

    def __init__(
        self,
        caches: Optional[List[KVPair]],
        num_slots: int,
        pages: int,
        page_size: int,
    ):
        if num_slots < 1 or pages < 1 or page_size < 1:
            raise ValueError(
                f"pool needs >=1 slot/page/row, got "
                f"{num_slots}/{pages}/{page_size}"
            )
        self.caches = caches
        self.num_slots = int(num_slots)
        self.pages = int(pages)
        self.page_size = int(page_size)
        self.lengths = np.zeros((num_slots,), np.int64)
        # Per-slot page table: logical page j of slot s lives at physical
        # page page_tables[s, j] of the slot's own page axis. Identity,
        # reset at alloc and free; the kernel follows it.
        self.page_tables = np.tile(
            np.arange(pages, dtype=np.int32), (num_slots, 1)
        )
        # LIFO free-list: the most recently freed slot is re-issued first.
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._allocated: set = set()
        self.reuses = 0
        self.slot_uses = np.zeros((num_slots,), np.int64)
        # The scheduler worker allocates and frees while HTTP threads read
        # stats().
        self._lock = threading.RLock()

    @property
    def slot_tokens(self) -> int:
        """Token capacity of one slot (pages * page_size rows)."""
        return self.pages * self.page_size

    # -- cross-replica page transfer (the fleet's page sharing) -----------
    def _leaves(self) -> List[torch.Tensor]:
        if self.caches is None:
            raise RuntimeError("accounting-only pool has no cache tensors")
        return cache_leaves(self.caches)

    def _locate(self, gid: int) -> Tuple[int, int]:
        """Global page id -> physical (slot, page), bounds-checked against
        the tensors' PHYSICAL slot axis: the prefix-cache arena lives in
        slots past num_slots, and arena pages are what the fleet moves."""
        slot, page = divmod(int(gid), self.pages)
        physical = self._leaves()[0].shape[-5]
        if not (0 <= slot < physical):
            raise ValueError(
                f"page id {gid} outside pool "
                f"({physical} physical slots x {self.pages} pages)"
            )
        return slot, page

    def export_page(self, gid: int) -> bytes:
        """Serialize ONE physical page (global id = slot * pages + page):
        every leaf's [page_size, heads, dim] slice (an int8 pool's codes
        and [page_size, heads, 1] scales), copied to the host on the
        current stream (ordered after every copy enqueued
        before it, the harvest flush included)."""
        slot, page = self._locate(gid)
        metas, blobs = [], []
        for leaf in self._leaves():
            host = leaf[..., slot, page, :, :, :].contiguous().cpu()
            metas.append({"shape": list(host.shape),
                          "dtype": _WIRE_NAMES[host.dtype]})
            blobs.append(host.view(-1).view(torch.uint8).numpy().tobytes())
        header = json.dumps(
            {"page_size": self.page_size, "leaves": metas}
        ).encode("utf-8")
        return b"".join(
            [PAGE_WIRE_MAGIC, len(header).to_bytes(4, "big"), header]
            + blobs
        )

    def import_page(self, gid: int, payload: bytes) -> int:
        """Write a pulled page's bytes into physical page `gid`, in place.
        Every leaf is checked against this pool's layout BEFORE any tensor
        is written (a payload of another geometry or dtype raises); then
        each leaf goes host -> card through one staging copy into
        t[..., slot, page], synchronously. Returns the payload size."""
        slot, page = self._locate(gid)
        arrs = parse_page_payload(payload)
        leaves = self._leaves()
        if len(arrs) != len(leaves):
            raise ValueError(
                f"page payload has {len(arrs)} leaves, pool has "
                f"{len(leaves)}"
            )
        for arr, leaf in zip(arrs, leaves):
            want = tuple(leaf.shape[:-5]) + tuple(leaf.shape[-3:])
            if tuple(arr.shape) != want or arr.dtype != leaf.dtype:
                raise ValueError(
                    f"page leaf mismatch: got {tuple(arr.shape)}/"
                    f"{_WIRE_NAMES[arr.dtype]}, pool wants {want}/"
                    f"{_WIRE_NAMES.get(leaf.dtype, leaf.dtype)}"
                )
        with torch.inference_mode():
            for arr, leaf in zip(arrs, leaves):
                leaf[..., slot, page, :, :, :].copy_(arr)
        if leaves[0].is_cuda:
            torch.cuda.current_stream(leaves[0].device).synchronize()
        return len(payload)

    def free_count(self) -> int:
        return len(self._free)

    def has_free(self) -> bool:
        return bool(self._free)

    def alloc(self) -> int:
        """Hand out a free slot. Raises when exhausted; a slot is never
        live twice."""
        with self._lock:
            if not self._free:
                raise RuntimeError("KV pool exhausted: no free slots")
            slot = self._free.pop()
            if slot in self._allocated:  # pragma: no cover - invariant guard
                raise RuntimeError(f"slot {slot} double-allocated")
            self._allocated.add(slot)
            self.page_tables[slot] = np.arange(self.pages, dtype=np.int32)
            if self.slot_uses[slot] > 0:
                self.reuses += 1
            self.slot_uses[slot] += 1
            return slot

    def free(self, slot: int) -> None:
        """Return a slot. Stale rows are not zeroed: every reader masks by
        length, and the next occupant writes each row before reading it."""
        with self._lock:
            if slot not in self._allocated:
                raise ValueError(f"slot {slot} is not allocated")
            self._allocated.remove(slot)
            self.lengths[slot] = 0
            self.page_tables[slot] = np.arange(self.pages, dtype=np.int32)
            self._free.append(slot)

    def allocated_slots(self) -> List[int]:
        with self._lock:
            return sorted(self._allocated)

    def page_table_array(self) -> np.ndarray:
        """[num_slots, pages] int32 snapshot of the page tables."""
        with self._lock:
            return self.page_tables.copy()

    def lengths_array(self) -> np.ndarray:
        """[num_slots] int32 snapshot of rows resident per slot (0 for free
        slots): the `lengths` operand of the decode kernel."""
        with self._lock:
            return self.lengths.astype(np.int32)

    def pages_in_use(self) -> int:
        """Pages holding live rows (each allocated slot's length rounded up
        to whole pages)."""
        with self._lock:
            return sum(
                -(-int(self.lengths[s]) // self.page_size)
                for s in self._allocated
            )

    def fragmentation_rows(self) -> int:
        """Rows allocated by page rounding but not holding KV."""
        with self._lock:
            live = int(sum(int(self.lengths[s]) for s in self._allocated))
            return self.pages_in_use() * self.page_size - live

    def _length_summary(self) -> dict:
        """Min/mean/max live length over allocated slots (0s when idle)."""
        with self._lock:
            vals = [int(self.lengths[s]) for s in self._allocated]
        if not vals:
            return {"min": 0, "mean": 0.0, "max": 0}
        return {
            "min": min(vals),
            "mean": round(sum(vals) / len(vals), 1),
            "max": max(vals),
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_slots": self.num_slots,
                "pages": self.pages,
                "page_size": self.page_size,
                "slot_tokens": self.slot_tokens,
                "in_use": len(self._allocated),
                "free": len(self._free),
                "reuses": self.reuses,
                "pages_in_use": self.pages_in_use(),
                "pages_total": self.num_slots * self.pages,
                "fragmentation_rows": self.fragmentation_rows(),
                "lengths": self._length_summary(),
            }
