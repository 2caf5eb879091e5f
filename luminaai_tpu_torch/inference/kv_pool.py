"""Slot-paged KV cache pool for continuous batching (PyTorch counterpart of
luminaai_tpu/inference/kv_pool.py).

One preallocated pool per layer and side, laid out
`[num_slots, pages, page_size, kv_heads, head_dim]`. Requests are admitted
into slots; all accounting (free-list, per-slot lengths, reuse counters,
page tables) is host-side numpy, so admission never reads device memory.
The device tensors are updated in place by the attention layers, through
the flat `[num_slots, pages * page_size, kv_heads, head_dim]` views that
`to_flat` returns (views of the same storage, never copies).

The JAX pool's LPG1 page export/import (cross-replica page sharing) is not
ported in this slice.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

KVPair = Tuple[torch.Tensor, torch.Tensor]


def to_paged(caches: Sequence[KVPair], pages: int, page_size: int) -> List[KVPair]:
    """[..., C, heads, dim] -> [..., pages, page_size, heads, dim] views."""

    def one(x: torch.Tensor) -> torch.Tensor:
        return x.view(x.shape[:-3] + (pages, page_size) + x.shape[-2:])

    return [(one(k), one(v)) for k, v in caches]


def to_flat(caches: Sequence[KVPair], pages: int, page_size: int) -> List[KVPair]:
    """Inverse of to_paged: the [..., pages * page_size, heads, dim] views
    the attention layers read and write."""

    def one(x: torch.Tensor) -> torch.Tensor:
        return x.view(x.shape[:-4] + (pages * page_size,) + x.shape[-2:])

    return [(one(k), one(v)) for k, v in caches]


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

    def page_table_array(self) -> np.ndarray:
        """[num_slots, pages] int32 snapshot of the page tables."""
        with self._lock:
            return self.page_tables.copy()

    def pages_in_use(self) -> int:
        """Pages holding live rows (each allocated slot's length rounded up
        to whole pages)."""
        with self._lock:
            return sum(
                -(-int(self.lengths[s]) // self.page_size)
                for s in self._allocated
            )

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
            }
