"""Step-wise generation over the slot-paged KV pool (PyTorch counterpart of
luminaai_tpu/inference/generate.py: samplers, the parts of GenerationEngine
the server uses, and StepwiseDecoder with the prefix cache off).

The JAX package jits each piece; here the host drives eager PyTorch on one
device, and every device call of a decoder comes from the thread that owns
it (the scheduler's worker). The decoder's entry points run under
torch.inference_mode(): the model's forward records gradients otherwise.
Prefill writes a request's rows straight into its pool slot (the JAX
decoder prefills a fresh cache and inserts it), and decode steps write one
row per lane in place before attention reads it.

Sampling uses one torch.Generator per lane, seeded from the request's
seed: seeded sampling is reproducible within the port, but it does not draw
JAX's numbers. Greedy decoding involves no randomness and matches the JAX
decoder token for token (tests/test_torch_generate.py).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.inference.kv_pool import PagedKVPool, to_flat, to_paged
from luminaai_tpu_torch.ops.ragged_paged_attention import LaneMeta

NEG_INF = -1e30

GREEDY_SAMPLE_KEY = (0.0, 0, 1.0, 1.0)  # (temperature, top_k, top_p, rep)


# ---------------------------------------------------------------------------
# Sampling (over the last axis; batched rows are lanes)
# ---------------------------------------------------------------------------
def apply_repetition_penalty(
    logits: torch.Tensor, counts: torch.Tensor, penalty: float
) -> torch.Tensor:
    """CTRL-style penalty on every token generated so far."""
    if penalty == 1.0:
        return logits
    scaled = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(counts > 0, scaled, logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering. Keeps at least one token."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens whose cumulative mass (exclusive) is below p.
    keep_sorted = (cum - probs) < p
    kth = torch.where(keep_sorted, sorted_logits, torch.inf).min(
        dim=-1, keepdim=True
    ).values
    return torch.where(logits < kth, NEG_INF, logits)


def sample_token(
    logits: torch.Tensor,
    counts: torch.Tensor,
    generators: Sequence[torch.Generator],
    *,
    temperature: float,
    top_k: int,
    top_p: float,
    repetition_penalty: float,
) -> torch.Tensor:
    """logits/counts [N, V] -> token ids [N] (int64). Greedy is one argmax;
    sampling draws row i from generators[i]."""
    logits = apply_repetition_penalty(
        logits.float(), counts, repetition_penalty
    )
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(temperature, 0.01)
    logits = apply_top_p(apply_top_k(logits, top_k), top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.cat([
        torch.multinomial(probs[i], 1, generator=g)
        for i, g in enumerate(generators)
    ])


def _bucket_len(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class GenerationEngine:
    """A model + tokenizer + config: the request plumbing the server and
    the step-wise decoder share. The model holds its weights on its
    device."""

    def __init__(self, model, tokenizer, config: Config):
        self.model = model
        self.tokenizer = tokenizer
        self.config = config
        self.max_context = config.seq_length

    @property
    def _stop_set(self):
        tok = self.tokenizer
        return {tok.eos_token_id, tok.pad_token_id, tok.im_end}

    def _resolve_gen_key(
        self, max_new_tokens, temperature, top_p, top_k, repetition_penalty
    ):
        """(max_new, temperature, top_k, top_p, rep_penalty) with config
        defaults filled."""
        cfg = self.config
        return (
            int(max_new_tokens or cfg.max_new_tokens),
            float(cfg.temperature if temperature is None else temperature),
            int(cfg.top_k if top_k is None else top_k),
            float(cfg.top_p if top_p is None else top_p),
            float(
                cfg.repetition_penalty
                if repetition_penalty is None
                else repetition_penalty
            ),
        )

    def _trim_prompt(
        self, prompt, max_new: int, capacity: Optional[int] = None
    ) -> List[int]:
        """Keep the prompt tail that fits the context budget (>= 1 token)."""
        cap = self.max_context if capacity is None else capacity
        max_prompt = max(1, cap - max_new - 1)
        p = list(prompt)
        return p[-max_prompt:] if len(p) > max_prompt else p

    def encode_chat(self, messages: List[Dict[str, str]]) -> List[int]:
        """Conversation -> prompt ids, with an open assistant turn."""
        tok = self.tokenizer
        prompt: List[int] = []
        for m in messages:
            body = tok.backend.encode(m.get("content", ""))
            prompt += [tok.im_start, tok.get_role_token(m["role"]), *body,
                       tok.im_end]
        prompt += [tok.im_start, tok.get_role_token("assistant")]
        return prompt

    def make_stepwise(
        self,
        num_slots: int = 8,
        page_size: int = 128,
        max_slot_tokens: Optional[int] = None,
    ) -> "StepwiseDecoder":
        return StepwiseDecoder(
            self,
            num_slots=num_slots,
            page_size=page_size,
            max_slot_tokens=max_slot_tokens,
        )


class StepwiseDecoder:
    """Step-wise decode over a slot-paged KV pool (continuous batching).

    The host owns the loop: prefill_into_slot / start_prefill +
    advance_prefill write a request's prompt rows into its slot and sample
    its first token; decode_step advances every active lane one token.
    The scheduler admits and evicts between steps.
    """

    def __init__(
        self,
        engine: GenerationEngine,
        num_slots: int = 8,
        page_size: int = 128,
        max_slot_tokens: Optional[int] = None,
    ):
        self.engine = engine
        self.model = engine.model
        self.device = self.model.device
        cap = int(max_slot_tokens or engine.max_context)
        page_size = max(1, int(page_size))
        pages = max(1, -(-cap // page_size))
        num_slots = max(1, int(num_slots))
        caches = self.model.init_cache(num_slots, pages * page_size)
        self.pool = PagedKVPool(
            to_paged(caches, pages, page_size),
            num_slots=num_slots,
            pages=pages,
            page_size=page_size,
        )
        # Flat [slots, C, Hkv, D] views of the pool: what the layers write.
        self._flat = to_flat(self.pool.caches, pages, page_size)
        self.num_slots = num_slots
        self.slot_tokens = pages * page_size
        # Decode stays inside the engine's context contract even where page
        # rounding leaves slack rows.
        self.token_capacity = min(self.slot_tokens, engine.max_context)
        self._tokens = np.zeros((num_slots,), np.int64)
        self._pos = np.zeros((num_slots,), np.int64)
        self._active = np.zeros((num_slots,), bool)
        self._counts = torch.zeros(
            (num_slots, engine.config.vocab_size), dtype=torch.int32,
            device=self.device,
        )
        self._gens = [
            torch.Generator(device=self.device).manual_seed(0)
            for _ in range(num_slots)
        ]
        self._stop_ids = torch.tensor(
            sorted(engine._stop_set), dtype=torch.int64, device=self.device
        )
        self.steps = 0
        self.prefill_forwards = 0  # model forwards of prefill rows
        self.prefill_chunk = min(
            engine.config.prefill_chunk_size, self.token_capacity
        )
        self._refresh_table()

    def _refresh_table(self) -> None:
        """Device copy of the pool's page tables (identity in this slice)."""
        self._table = torch.as_tensor(
            self.pool.page_table_array(), device=self.device
        )

    # -- slot lifecycle ----------------------------------------------------
    def has_free_slot(self) -> bool:
        return self.pool.has_free()

    def acquire_slot(self) -> int:
        return self.pool.alloc()

    def release_slot(self, slot: int) -> None:
        self._active[slot] = False
        self.pool.free(slot)

    def lane_full(self, slot: int) -> bool:
        """Next decode row would overflow the slot's token budget."""
        return int(self._pos[slot]) >= self.token_capacity

    # -- device pieces -----------------------------------------------------
    def _lane(self, slot: int, rows: int):
        """Per-layer (k, v) views of one slot's first `rows` rows."""
        return [(k[slot:slot + 1, :rows], v[slot:slot + 1, :rows])
                for k, v in self._flat]

    def _prefill_rows(self, ids: np.ndarray, slot: int, start: int,
                      length: int, rows: int, last: int) -> torch.Tensor:
        """Run prompt rows ids[0] at positions start.. (rows past `length`
        are padding, position -1) into the slot's first `rows` rows;
        return the fp32 logits [1, V] of row `last`."""
        dev = self.device
        pos = start + np.arange(ids.shape[1])
        positions = np.where(pos < length, pos, -1)[None]
        self.prefill_forwards += 1
        hidden, _ = self.model(
            torch.as_tensor(ids, dtype=torch.int64, device=dev),
            positions=torch.as_tensor(positions, device=dev),
            kv_caches=self._lane(slot, rows),
            cache_index=torch.tensor([start], device=dev),
            return_hidden=True,
        )
        return self.model.embedder.decode(hidden[:, last])

    def _active_extent(self) -> int:
        """Resident-extent bound in ROWS for the decode step: a power-of-two
        page count covering every active lane's rows (>= 1 page, <= the
        slot's pages). The plain version reads only this many rows; the
        kernel follows each lane's length."""
        ps = self.pool.page_size
        need = 1
        if self._active.any():
            need = int(self._pos[self._active].max()) + 1
        pages_needed = -(-need // ps)
        p = 1
        while p < pages_needed:
            p *= 2
        return min(p, self.pool.pages) * ps

    @torch.inference_mode()
    def step_logits(self, backend: Optional[str] = None) -> torch.Tensor:
        """One decode forward for every lane at its current (token, pos):
        writes each lane's row, attends, returns fp32 logits [slots, V].
        Does not sample or advance any state, so it can be re-run (the
        rows it writes are rewritten identically by the next step).
        backend: 'ragged' (kernel; the default) or 'plain'."""
        dev = self.device
        lengths = np.where(self._active, self._pos + 1, 0).astype(np.int32)
        meta = LaneMeta(
            lengths=torch.as_tensor(lengths, device=dev),
            page_table=self._table,
            backend=backend,
            window=self.engine.config.attention_window,
            page_size=self.pool.page_size,
            extent=self._active_extent(),
        )
        pos = torch.as_tensor(self._pos, device=dev)
        logits, _ = self.model(
            torch.as_tensor(self._tokens, device=dev)[:, None],
            positions=pos[:, None],
            kv_caches=self._flat,
            cache_index=pos,
            lane_meta=meta,
        )
        return logits[:, -1]

    # -- scheduler-facing API ----------------------------------------------
    @torch.inference_mode()
    def prefill_into_slot(
        self,
        slot: int,
        prompt_tokens: Sequence[int],
        max_new_tokens: int = 1,
        sample_key: Optional[Tuple] = None,
        seed: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Write a request's prompt KV into pool slot `slot` (one bucketed
        forward) and sample its first token. Returns {"token": int | None,
        "prompt_tokens", "is_stop"}."""
        sample_key = sample_key or GREEDY_SAMPLE_KEY
        max_new = max(1, int(max_new_tokens))
        if not list(prompt_tokens):
            raise ValueError("prefill_into_slot needs a non-empty prompt")
        prompt = self.engine._trim_prompt(
            prompt_tokens, max_new, capacity=self.token_capacity
        )
        L = len(prompt)
        bucket = min(_bucket_len(L), self.slot_tokens)
        ps = self.pool.page_size
        # A page-aligned prefix of the slot: rows past it keep the previous
        # occupant's stale K/V, which no mask admits before it is rewritten.
        rows = min(-(-bucket // ps) * ps, self.slot_tokens)
        ids = np.zeros((1, bucket), dtype=np.int64)
        ids[0, :L] = prompt
        logits = self._prefill_rows(ids, slot, 0, L, rows, L - 1)
        self._refresh_table()
        return self._finish_prefill(slot, logits, L, max_new, sample_key,
                                    seed)

    def _finish_prefill(self, slot, logits, L, max_new, sample_key, seed):
        """Sample token #1, set the host lane state, return the info dict."""
        gen = torch.Generator(device=self.device).manual_seed(
            seed if seed is not None else (time.time_ns() & 0xFFFFFFFF)
        )
        first = int(sample_token(
            logits,
            torch.zeros_like(logits, dtype=torch.int32),
            [gen],
            temperature=sample_key[0], top_k=sample_key[1],
            top_p=sample_key[2], repetition_penalty=sample_key[3],
        )[0])
        is_stop = first in self.engine._stop_set
        self.pool.lengths[slot] = L
        self._tokens[slot] = first
        self._pos[slot] = L
        self._active[slot] = (not is_stop) and max_new > 1
        self._counts[slot] = 0
        if not is_stop:
            self._counts[slot, first] += 1
        self._gens[slot] = gen
        return {
            "token": None if is_stop else first,
            "prompt_tokens": L,
            "is_stop": is_stop,
        }

    # -- chunked prefill (scheduler-interleaved admission) -----------------
    def start_prefill(
        self,
        slot: int,
        prompt_tokens: Sequence[int],
        max_new_tokens: int = 1,
        sample_key: Optional[Tuple] = None,
        seed: Optional[int] = None,
    ) -> Optional[Dict[str, Any]]:
        """Begin a CHUNKED prefill into `slot`: returns the host-side state
        for advance_prefill, or None when chunking is off or the prompt
        fits one chunk (callers then use prefill_into_slot). The lane stays
        inactive until the final chunk activates it."""
        if not self.prefill_chunk:
            return None
        sample_key = sample_key or GREEDY_SAMPLE_KEY
        max_new = max(1, int(max_new_tokens))
        if not list(prompt_tokens):
            raise ValueError("start_prefill needs a non-empty prompt")
        prompt = self.engine._trim_prompt(
            prompt_tokens, max_new, capacity=self.token_capacity
        )
        L = len(prompt)
        chunk = self.prefill_chunk
        if L <= chunk:
            # One chunk stalls no one longer than a chunk anyway, and the
            # bucketed path touches only a page-aligned prompt prefix.
            return None
        st: Dict[str, Any] = {
            "slot": slot, "length": L, "chunk": chunk, "next": 0,
            "n_chunks": 0, "sample_key": sample_key, "seed": seed,
            "max_new": max_new, "prompt": prompt,
        }
        self._arm_prefill(st)
        return st

    def _park_lane(self, slot: int, rows: int) -> None:
        """Interleaved decode steps still write one (garbage) row per lane:
        park a mid-prefill lane's write row at the slot's LAST row, which no
        chunk writes (prompts are bounded to token_capacity - 1) and which
        a lane decoding there overwrites before its mask admits it."""
        self._pos[slot] = self.slot_tokens - 1
        self._active[slot] = False
        self.pool.lengths[slot] = rows

    def _arm_prefill(self, st: Dict[str, Any]) -> None:
        slot, prompt, L = st["slot"], st["prompt"], st["length"]
        chunk = st["chunk"]
        n = -(-L // chunk)
        ids = np.zeros((1, n * chunk), np.int64)
        ids[0, :L] = prompt
        self._park_lane(slot, 0)
        self._refresh_table()
        st.update(ids=ids, n_chunks=n)

    @torch.inference_mode()
    def advance_prefill(
        self, st: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """Run ONE prefill chunk. Returns None while chunks remain; the
        final chunk samples token #1, activates the lane, and returns
        prefill_into_slot's info dict."""
        c, chunk, slot, L = st["next"], st["chunk"], st["slot"], st["length"]
        start = c * chunk
        # The JAX decoder clips this index inside the jitted chunk; here it
        # is a host integer, clamped explicitly.
        last = min(max(L - 1 - start, 0), chunk - 1)
        logits = self._prefill_rows(
            st["ids"][:, start:start + chunk], slot, start, L,
            self.slot_tokens, last,
        )
        st["next"] = c + 1
        if st["next"] < st["n_chunks"]:
            self.pool.lengths[slot] = min((c + 1) * chunk, L)
            return None
        return self._finish_prefill(
            slot, logits, L, st["max_new"], st["sample_key"], st["seed"]
        )

    @torch.inference_mode()
    def decode_step(
        self, sample_key: Optional[Tuple] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Advance every active lane one token. Returns (tokens[S],
        produced[S], eos[S]): `produced` lanes emitted tokens[slot] this
        step; `eos` lanes hit a stop token (dropped) and were
        deactivated."""
        temperature, top_k, top_p, rep = sample_key or GREEDY_SAMPLE_KEY
        was_active = self._active.copy()
        logits = self.step_logits()
        active = torch.as_tensor(was_active, device=self.device)
        nxt = sample_token(
            logits, self._counts, self._gens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=rep,
        )
        nxt = torch.where(
            active, nxt, torch.as_tensor(self._tokens, device=self.device)
        )
        lanes = torch.arange(self.num_slots, device=self.device)
        self._counts[lanes, nxt] += active.to(torch.int32)
        eos = active & torch.isin(nxt, self._stop_ids)
        nxt_h = nxt.cpu().numpy()
        eos_h = eos.cpu().numpy()
        self._tokens = nxt_h.copy()
        self._pos[was_active] += 1
        self.pool.lengths[was_active] += 1
        self._active &= ~eos_h
        self.steps += 1
        produced = was_active & ~eos_h
        return nxt_h, produced, eos_h
