"""Generation over a KV cache (PyTorch counterpart of
luminaai_tpu/inference/generate.py: samplers, GenerationEngine's
single-request, batched and speculative paths, and StepwiseDecoder with
the radix prefix cache).

The JAX package jits each piece; here the host drives eager PyTorch on one
device. Entry points run under torch.inference_mode(): the model's
forward records gradients otherwise.

Single request (`generate`, `generate_stream`, `chat_response`): the
prompt is prefilled in chunks of config.prefill_chunk_size rows into a
fresh per-request cache [1, max_context, Hkv, D] (the JAX
`_prefill_chunked`, with its re-anchor of a final chunk that would
overhang the cache; without chunking, one power-of-two bucket), then a
Python loop decodes one row per step at the scalar offset start + i, as
the JAX engine passes it. Prefill rows take the plain paged attention;
each decode row goes through the ragged decode kernel (B5) on the card,
the pages being the cache's identity layout. Under attention_window the
cache rolls (the JAX layout; models/transformer.py init_cache): C =
ceil(window / 128) * 128 slots, one bucket prefilled through the banded
flash forward (B1), decode rows at slot pos % C read through the plain
slot mask, as JAX leaves that layout to XLA. The JAX loop is a
lax.while_loop that splits its key once per token; here one
torch.Generator seeded from the request's seed draws once per sampled
token, so `generate_stream` yields exactly the tokens `generate` returns
at the same seed.

Batched (`generate_batch`, the MicroBatcher's path): every prompt gets a
lane of one cache [B, max_context, Hkv, D] (C slots each under a window:
per-lane rolling caches, `rolling_lanes`, as JAX's vmap of the
single-request path gives every lane its own); one bucketed prefill
forward writes all lanes, then each decode step runs every lane through
B5 (the slot mask on rolling lanes; the JAX vmapped while_loop), a
finished lane riding along until the last one stops. Speculative
(`generate_speculative`, `generate_stream_speculative`): greedy decode
with prompt-lookup drafts; each round feeds the last accepted token and
up to k-1 drafted ones as one k-row forward (rows written at their
positions, attention through the plain paged version, as the JAX
verify's Sq > 1 goes to its XLA reference) and accepts drafts while each
is the greedy choice.

Step-wise (`StepwiseDecoder`, continuous batching): prefill writes a
request's rows straight into its pool slot (the JAX decoder prefills a
fresh cache and inserts it), and decode steps write one row per lane in
place before attention reads it. With the prefix cache on, the pool holds
arena slots past the lane range; an admission splices the cached pages of
its prompt's prefix into its row of a GLOBAL page table, prefills only the
uncached suffix, and its freshly computed full pages are copied into the
arena (`index_copy_` on each layer's pool tensors, on the stream the next
decode step reads from). Decode then hands B5 the global table: lanes
read the shared arena pages in place.

Quantized serving (the JAX engine's, generate.py:189-201): the engine
applies its config's quantization_method to the model in place
(training/quantization.quantize_model) and keeps `quantization_info`;
every cache it allocates takes its config's kv_cache_dtype (int8: codes
and per-row scales, each side a pair), and the splice, harvest and page
copies move every leaf.

Sampling draws from torch.Generators: seeded sampling is reproducible
within the port, but it does not draw JAX's numbers. Greedy decoding
involves no randomness and matches the JAX decoder token for token
(tests/test_torch_generate.py, tests/test_torch_chat.py,
tests/test_torch_prefix_decode.py).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.inference.kv_pool import (
    PagedKVPool,
    cache_leaves,
    map_sides,
    to_flat,
    to_paged,
)
from luminaai_tpu_torch.ops.ragged_paged_attention import LaneMeta

logger = logging.getLogger(__name__)

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


def ngram_propose(
    history: Sequence[int], k: int, max_ngram: int = 3
) -> List[int]:
    """Prompt-lookup draft: find the most recent earlier occurrence of the
    history's trailing n-gram (longest n first) and propose the k tokens
    that followed it; [] when no n-gram recurs. Reference implementation
    (O(len * n) scan); the decode loop uses _NgramIndex, whose proposals
    are identical."""
    h = list(history)
    n_h = len(h)
    for n in range(min(max_ngram, n_h - 1), 0, -1):
        tail = h[n_h - n:]
        for i in range(n_h - n - 1, -1, -1):
            if h[i:i + n] == tail:
                cont = h[i + n: i + n + k]
                if cont:
                    return cont
    return []


class _NgramIndex:
    """Incremental prompt-lookup index: each n-gram maps to its two most
    recent end offsets, so a round's proposal is O(max_ngram) dict hits
    instead of a rescan of the history. Proposals match ngram_propose:
    the latest EARLIER occurrence, longest n first (the tail's own
    occurrence is ent[0] with an empty continuation, so ent[1] supplies
    the match)."""

    def __init__(self, history: Sequence[int], max_ngram: int = 3):
        self.h: List[int] = list(history)
        self.max_n = max_ngram
        self.map: Dict[tuple, List[Optional[int]]] = {}
        for end in range(1, len(self.h) + 1):
            self._register(end)

    def _register(self, end: int) -> None:
        h = self.h
        for n in range(1, self.max_n + 1):
            if end - n < 0:
                break
            key = tuple(h[end - n:end])
            ent = self.map.get(key)
            if ent is None:
                self.map[key] = [end, None]
            elif ent[0] != end:
                self.map[key] = [end, ent[0]]

    def append(self, token: int) -> None:
        self.h.append(token)
        self._register(len(self.h))

    def propose(self, k: int) -> List[int]:
        h = self.h
        L = len(h)
        for n in range(min(self.max_n, L - 1), 0, -1):
            ent = self.map.get(tuple(h[L - n:]))
            if not ent:
                continue
            for end in ent:
                if end is not None:
                    cont = h[end:end + k]
                    if cont:
                        return cont
        return []


class GenerationEngine:
    """A model + tokenizer + config: single-request generation, and the
    request plumbing the server and the step-wise decoder share. The
    model holds its weights on its device; config.quantization_method
    ('int8' | 'int4') quantizes them in place here, as the JAX engine
    quantizes its params."""

    def __init__(self, model, tokenizer, config: Config,
                 max_context: Optional[int] = None):
        self.model = model
        self.tokenizer = tokenizer
        self.config = config
        self.max_context = max_context or config.seq_length
        self.decode_forwards = 0  # single-request and batched decode steps
        self.verify_forwards = 0  # speculative verify forwards
        self.quantization_info: Dict[str, Any] = {}
        self.configure(quantize=config.quantization_method)

    def configure(self, quantize: Optional[str] = None,
                  kv_cache_dtype: Optional[str] = None) -> None:
        """Set quantization_method / kv_cache_dtype on the config and
        quantize the model (idempotent over weights already quantized);
        caches allocated after this take the new dtype."""
        from luminaai_tpu_torch.training.quantization import quantize_model

        if kv_cache_dtype is not None:
            self.config.kv_cache_dtype = kv_cache_dtype
        if quantize is not None:
            self.config.quantization_method = quantize
            self.quantization_info = quantize_model(self.model, self.config)

    def init_cache(self, batch: int, rows: int, rolling: bool = True):
        """The model's caches in this engine's kv_cache_dtype (the engine's
        config decides, as in JAX, not the model's); rolling as the
        model's init_cache (a windowed request's cache holds C slots)."""
        return self.model.init_cache(batch, rows,
                                     kv_cache_dtype=self.config.kv_cache_dtype,
                                     rolling=rolling)

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

    # -- single-request prefill ------------------------------------------
    def _prefill_chunk_len(self) -> int:
        """Chunk length for chunked prefill; 0 when disabled or under
        attention_window (the JAX engine keeps the bucket there)."""
        chunk = int(getattr(self.config, "prefill_chunk_size", 0) or 0)
        if chunk <= 0 or self.config.attention_window is not None:
            return 0
        return min(chunk, self.max_context)

    def _prefill_rows(self, caches, ids: np.ndarray, start: int,
                      length: int) -> torch.Tensor:
        """Feed prompt rows ids[0] at positions start.. (rows at or past
        `length` are padding, position -1, not written) into `caches`;
        return the fp32 logits [1, V] of the prompt's last row within
        them (clamped to the chunk, as the JAX chunk clips it)."""
        dev = self.model.device
        S = ids.shape[1]
        pos = start + np.arange(S)
        positions = np.where(pos < length, pos, -1)[None]
        hidden, _ = self.model(
            torch.as_tensor(ids, dtype=torch.int64, device=dev),
            positions=torch.as_tensor(positions, device=dev),
            kv_caches=caches,
            cache_index=start,
            return_hidden=True,
        )
        last = min(max(length - 1 - start, 0), S - 1)
        return self.model.embedder.decode(hidden[:, last])

    def _prefill_chunked(self, prompt: List[int], chunk: int):
        """ceil(L / chunk) chunks into a fresh cache -> (logits of the
        last prompt row [1, V], caches). An empty prompt still runs one
        all-padding chunk."""
        L = len(prompt)
        n = max(1, -(-L // chunk))
        ids = np.zeros((1, n * chunk), dtype=np.int64)
        ids[0, :L] = prompt
        caches = self.init_cache(1, self.max_context)
        logits = None
        for c in range(n):
            start = c * chunk
            if start + chunk > self.max_context:
                # The chunk grid overhangs a cache whose extent is not
                # chunk aligned: the JAX engine re-anchors the chunk to
                # end at the cache edge (XLA would clamp its write there),
                # re-feeding overlap rows that rewrite identical K/V. The
                # port writes rows by position, so either window fills
                # the same rows; it re-anchors alike to run the same
                # chunks.
                start = self.max_context - chunk
            logits = self._prefill_rows(
                caches, ids[:, start:start + chunk], start, L)
        return logits, caches

    def _prefill_and_sample_first(self, prompt_tokens, gen_key, seed):
        """Trim, prefill (chunked, or one power-of-two bucket), sample
        token #1. Returns (first_token, caches, counts [1, V], generator,
        prompt_len, first_is_stop)."""
        prompt = self._trim_prompt(prompt_tokens, gen_key[0])
        length = len(prompt)
        chunk = self._prefill_chunk_len()
        if chunk:
            logits, caches = self._prefill_chunked(prompt, chunk)
        else:
            bucket = min(_bucket_len(length), self.max_context)
            ids = np.zeros((1, bucket), dtype=np.int64)
            ids[0, :length] = prompt
            caches = self.init_cache(1, self.max_context)
            logits = self._prefill_rows(caches, ids, 0, length)
        counts = torch.zeros_like(logits, dtype=torch.int32)
        gen = torch.Generator(device=self.model.device).manual_seed(
            seed if seed is not None else (time.time_ns() & 0xFFFFFFFF)
        )
        first = int(self._sample(logits, counts, gen, gen_key))
        return (first, caches, counts, gen, length,
                first in self._stop_set)

    def _sample(self, logits, counts, gen, gen_key) -> int:
        return int(sample_token(
            logits, counts, [gen],
            temperature=gen_key[1], top_k=gen_key[2], top_p=gen_key[3],
            repetition_penalty=gen_key[4],
        )[0])

    def _decode_logits(self, caches, token: int, pos: int,
                       backend: Optional[str] = None) -> torch.Tensor:
        """One decode row: `token` at position `pos` written into the
        cache at the scalar offset pos (slot pos % C of a rolling cache),
        attending rows 0..pos (the band) -> fp32 logits [1, V]. backend:
        None (the decode kernel on the card; a rolling cache's slot mask
        is plain) or 'plain' (the oracle re-run)."""
        dev = self.model.device
        self.decode_forwards += 1
        logits, _ = self.model(
            torch.tensor([[token]], device=dev),
            positions=torch.tensor([[pos]], device=dev),
            kv_caches=caches,
            cache_index=pos,
            lane_meta=LaneMeta(backend=backend),
        )
        return logits[:, -1]

    @torch.inference_mode()
    def _stream(self, prompt_tokens, gen_key, seed) -> Iterator[Any]:
        """Yield each generated token id, then the stats dict (the JAX
        generate's schema). The loop decodes up to max_new - 1 rows after
        the first token; a stop token ends it and is dropped."""
        max_new = gen_key[0]
        t0 = time.time()
        first, caches, counts, gen, length, first_is_stop = (
            self._prefill_and_sample_first(prompt_tokens, gen_key, seed)
        )
        produced = 0
        stopped = "eos" if first_is_stop else "length"
        if not first_is_stop:
            yield first
            produced = 1
            counts[0, first] += 1
            token = first
            for i in range(max_new - 1):
                nxt = self._sample(self._decode_logits(
                    caches, token, length + i), counts, gen, gen_key)
                counts[0, nxt] += 1
                if nxt in self._stop_set:
                    stopped = "eos"
                    break
                yield nxt
                produced += 1
                token = nxt
        dt = time.time() - t0
        yield {
            "tokens_generated": produced,
            "seconds": round(dt, 3),
            "tokens_per_second": round(produced / max(dt, 1e-9), 1),
            "prompt_tokens": length,
            "stopped": stopped,
        }

    # -- public API --------------------------------------------------------
    def generate(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        repetition_penalty: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> Tuple[List[int], Dict[str, Any]]:
        """Returns (generated_token_ids, stats)."""
        *tokens, stats = self.generate_stream(
            prompt_tokens, max_new_tokens, temperature, top_p, top_k,
            repetition_penalty, seed,
        )
        return tokens, stats

    def generate_stream(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        repetition_penalty: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> Iterator[Any]:
        """Yield generated token ids as they decode, then a stats dict
        (generate's schema; every other yield is an int). The same loop
        as generate: the same tokens and `stopped` at the same seed."""
        gen_key = self._resolve_gen_key(
            max_new_tokens, temperature, top_p, top_k, repetition_penalty
        )
        return self._stream(prompt_tokens, gen_key, seed)

    # -- speculative decoding (prompt lookup) ------------------------------
    def _verify(self, caches, ids: List[int], start: int) -> np.ndarray:
        """One speculative verify forward: k rows (the last accepted token
        and the drafts, -1 for a missing draft) at positions start.., their
        cache rows written in the same pass; returns the greedy argmax at
        every fed row [k]. Sq = k > 1 takes the plain paged attention (a
        rolling cache's slot mask), as the JAX verify's multi-row forward
        takes its XLA reference."""
        dev = self.model.device
        k = len(ids)
        self.verify_forwards += 1
        logits, _ = self.model(
            torch.tensor([ids], dtype=torch.int64, device=dev),
            positions=torch.arange(start, start + k, device=dev)[None],
            kv_caches=caches,
            cache_index=start,
            lane_meta=LaneMeta(),
            multi_row_update=True,
        )
        return torch.argmax(logits[0], dim=-1).cpu().numpy()

    def generate_speculative(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: Optional[int] = None,
        draft_k: int = 8,
        seed: Optional[int] = None,
    ) -> Tuple[List[int], Dict[str, Any]]:
        """Greedy decode with prompt-lookup (n-gram) speculative drafts:
        exactly the greedy generate() sequence, several tokens per verify
        forward on repetitive text. A blocking collector over
        generate_stream_speculative."""
        tokens: List[int] = []
        stats: Dict[str, Any] = {}
        for item in self.generate_stream_speculative(
            prompt_tokens, max_new_tokens=max_new_tokens,
            draft_k=draft_k, seed=seed,
        ):
            if isinstance(item, dict):
                stats = item
            else:
                tokens.append(int(item))
        return tokens, stats

    @torch.inference_mode()
    def generate_stream_speculative(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: Optional[int] = None,
        draft_k: int = 8,
        seed: Optional[int] = None,
        timeout_s: Optional[float] = None,
    ):
        """Streaming prompt-lookup speculative decode (the generate_stream
        contract: token ints as they are ACCEPTED, then one stats dict with
        verify_calls and tokens_per_verify). Each round verifies up to
        draft_k - 1 drafted tokens plus the model's own next prediction in
        one k-row forward, accepts drafts while each IS the greedy choice
        given its verified prefix, and takes the model's prediction at the
        divergence as a bonus. timeout_s bounds the loop (checked per
        round; stopped='timeout'). Under a rolling cache (attention_window)
        a k-row verify needs C - window >= k - 1 slots of slack, or later
        rows would evict earlier rows' in-band keys: the draft is capped
        there, and with no slack (window % 128 == 0) the stream is the
        plain greedy one, its deadline kept (JAX generate.py:570-600)."""
        max_new = int(max_new_tokens or self.config.max_new_tokens)
        k = max(2, int(draft_k))
        w = self.config.attention_window
        if w is not None and self.max_context <= self.config.seq_length:
            slots = min(self.max_context, -(-w // 128) * 128)
            if slots < self.config.seq_length:  # the cache rolls
                k = min(k, slots - w + 1)
                if k < 2:
                    yield from self._greedy_with_deadline(
                        prompt_tokens, max_new, seed, timeout_s)
                    return
        gen_key = (max_new, 0.0, 0, 1.0, 1.0)  # greedy, no penalty
        t0 = time.time()
        # Room for the verify overshoot (up to k-1 cache rows past the
        # final token) so cache writes stay in range.
        prompt = self._trim_prompt(prompt_tokens, max_new + k)
        first, caches, _, _, length, first_is_stop = (
            self._prefill_and_sample_first(prompt, gen_key, seed)
        )
        verify_calls = 0
        produced = 0
        stopped = "length"
        if first_is_stop:
            stopped = "eos"
        elif max_new >= 1:
            yield int(first)
            produced = 1
            index = _NgramIndex(list(prompt) + [int(first)])
            stop = self._stop_set
            pos = length  # next cache row to write
            token = int(first)  # accepted, not yet fed
            while produced < max_new:
                if timeout_s is not None and time.time() - t0 > timeout_s:
                    stopped = "timeout"
                    break
                draft = index.propose(k - 1)
                ids = [token] + draft + [-1] * (k - 1 - len(draft))
                nxt = self._verify(caches, ids, pos)
                verify_calls += 1
                j = 0
                while j < k - 1 and int(nxt[j]) == ids[j + 1]:
                    j += 1
                accepted = [int(ids[m + 1]) for m in range(j)] + [int(nxt[j])]
                done = False
                for t in accepted:
                    if t in stop:
                        stopped = "eos"
                        done = True
                        break
                    yield int(t)
                    produced += 1
                    index.append(t)
                    if produced >= max_new:
                        done = True
                        break
                # Rows 0..j carried accepted tokens; the next round
                # re-feeds from pos + j + 1, overwriting stale drafted rows
                # before they can be attended.
                pos += j + 1
                token = accepted[-1]
                if done:
                    break
        dt = time.time() - t0
        yield {
            "tokens_generated": produced,
            "seconds": round(dt, 3),
            "tokens_per_second": round(produced / max(dt, 1e-9), 1),
            "prompt_tokens": length,
            "stopped": stopped,
            "verify_calls": verify_calls,
            "tokens_per_verify": round(produced / max(verify_calls, 1), 2),
        }

    def _greedy_with_deadline(self, prompt_tokens, max_new: int, seed,
                              timeout_s: Optional[float]):
        """The plain greedy stream, ended with stopped='timeout' once
        timeout_s has passed (checked per token): speculation's fallback
        where a rolling cache leaves no slack for a verify."""
        start = time.time()
        produced = 0
        src = self.generate_stream(prompt_tokens, max_new_tokens=max_new,
                                   temperature=0.0, repetition_penalty=1.0,
                                   seed=seed)
        for item in src:
            yield item
            if isinstance(item, dict):
                return
            produced += 1
            if timeout_s is not None and time.time() - start > timeout_s:
                src.close()
                dt = time.time() - start
                yield {
                    "tokens_generated": produced,
                    "seconds": round(dt, 3),
                    "tokens_per_second": round(produced / max(dt, 1e-9), 1),
                    "prompt_tokens": len(prompt_tokens),
                    "stopped": "timeout",
                }
                return

    # -- batched generation (the MicroBatcher's path) ----------------------
    @torch.inference_mode()
    def generate_batch(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        repetition_penalty: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> List[Tuple[List[int], Dict[str, Any]]]:
        """Decode B prompts concurrently (ragged lengths). Each prompt
        owns a lane of one cache; one bucketed prefill forward fills every
        lane (rows past a lane's length are padding), then each step
        decodes every lane through B5 until all lanes stopped (a stop
        token or the budget), as the JAX vmapped while_loop runs until
        every lane's cond is false. A finished lane's row is rewritten and
        discarded; only live lanes sample. One prompt takes generate()."""
        if not prompts:
            return []
        if len(prompts) == 1:
            tokens, stats = self.generate(
                prompts[0], max_new_tokens, temperature, top_p, top_k,
                repetition_penalty, seed,
            )
            stats["batch_size"] = 1
            stats["batch_tokens_per_second"] = stats["tokens_per_second"]
            return [(tokens, stats)]
        gen_key = self._resolve_gen_key(
            max_new_tokens, temperature, top_p, top_k, repetition_penalty
        )
        max_new = gen_key[0]
        dev = self.model.device
        t0 = time.time()
        B = len(prompts)
        rows = [self._trim_prompt(p, max_new) for p in prompts]
        lengths = [max(1, len(r)) for r in rows]
        bucket = min(_bucket_len(max(lengths)), self.max_context)
        ids = np.zeros((B, bucket), dtype=np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
        pos = np.arange(bucket)[None]
        positions = np.where(pos < np.asarray(lengths)[:, None], pos, -1)
        caches = self.init_cache(B, self.max_context)
        hidden, _ = self.model(
            torch.as_tensor(ids, device=dev),
            positions=torch.as_tensor(positions, device=dev),
            kv_caches=caches,
            cache_index=torch.zeros((B,), dtype=torch.int64, device=dev),
            return_hidden=True,
            rolling_lanes=True,
        )
        last = torch.as_tensor([n - 1 for n in lengths], device=dev)
        logits = self.model.embedder.decode(
            hidden[torch.arange(B, device=dev), last])
        base = seed if seed is not None else (time.time_ns() & 0xFFFFFFFF)
        gens = [torch.Generator(device=dev).manual_seed(base + i)
                for i in range(B)]
        counts = torch.zeros((B, logits.shape[-1]), dtype=torch.int32,
                             device=dev)
        kw = dict(temperature=gen_key[1], top_k=gen_key[2],
                  top_p=gen_key[3], repetition_penalty=gen_key[4])
        first = sample_token(logits, counts, gens, **kw).cpu().numpy()
        stop_set = self._stop_set
        out: List[List[int]] = [[] for _ in range(B)]
        live = np.ones((B,), bool)
        hit_stop = np.zeros((B,), bool)
        for i in range(B):
            if int(first[i]) in stop_set:
                live[i] = False
                hit_stop[i] = True
            else:
                out[i].append(int(first[i]))
                counts[i, int(first[i])] += 1
                if max_new <= 1:
                    live[i] = False
        tokens = first.astype(np.int64)
        cur = np.asarray(lengths, np.int64)  # next row each lane writes
        while live.any():
            self.decode_forwards += 1
            step, _ = self.model(
                torch.as_tensor(tokens, device=dev)[:, None],
                positions=torch.as_tensor(cur, device=dev)[:, None],
                kv_caches=caches,
                cache_index=torch.as_tensor(cur, device=dev),
                lane_meta=LaneMeta(),
                rolling_lanes=True,
            )
            idx = np.flatnonzero(live)
            sel = torch.as_tensor(idx, device=dev)
            nxt = sample_token(step[sel, -1], counts[sel],
                               [gens[i] for i in idx], **kw).cpu().numpy()
            for i, t in zip(idx, nxt):
                t = int(t)
                counts[i, t] += 1
                if t in stop_set:
                    live[i] = False
                    hit_stop[i] = True
                    continue
                out[i].append(t)
                tokens[i] = t
                cur[i] += 1
                if len(out[i]) >= max_new:
                    live[i] = False
        dt = time.time() - t0
        results: List[Tuple[List[int], Dict[str, Any]]] = []
        total = 0
        for i in range(B):
            total += len(out[i])
            results.append((out[i], {
                "tokens_generated": len(out[i]),
                "prompt_tokens": lengths[i],
                "stopped": "eos" if hit_stop[i] else "length",
                "seconds": round(dt, 3),
                "tokens_per_second": round(len(out[i]) / max(dt, 1e-9), 1),
                "batch_size": B,
            }))
        agg = round(total / max(dt, 1e-9), 1)
        for _, st in results:
            st["batch_tokens_per_second"] = agg
        return results

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

    def chat_response(
        self, messages: List[Dict[str, str]], **kw
    ) -> Tuple[str, Dict[str, Any]]:
        """Encode a conversation, generate, decode assistant text."""
        tokens, stats = self.generate(self.encode_chat(messages), **kw)
        return self.tokenizer.decode(tokens), stats

    def make_stepwise(
        self,
        num_slots: int = 8,
        page_size: int = 128,
        max_slot_tokens: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = None,
        prefix_cache_pages: Optional[int] = None,
        prefix_cache_tenant_quota: Optional[int] = None,
    ) -> "StepwiseDecoder":
        return StepwiseDecoder(
            self,
            num_slots=num_slots,
            page_size=page_size,
            max_slot_tokens=max_slot_tokens,
            prefill_chunk_tokens=prefill_chunk_tokens,
            prefix_cache_pages=prefix_cache_pages,
            prefix_cache_tenant_quota=prefix_cache_tenant_quota,
        )


class StepwiseDecoder:
    """Step-wise decode over a slot-paged KV pool (continuous batching).

    The host owns the loop: prefill_into_slot / start_prefill +
    advance_prefill write a request's prompt rows into its slot and sample
    its first token; decode_step advances every active lane one token.
    The scheduler admits and evicts between steps.

    With prefix_cache_pages > 0 (None: the engine config's), a budget of
    arena pages is carved out as extra pool slots past the lane range and
    a RadixPrefixCache (inference/prefix_cache.py) indexes them. The
    decoder then keeps a GLOBAL page table [num_slots, pages] (entry (s, j)
    is the pool page slot * pages + page that logical page j of lane s
    reads): identity, except where an admission spliced its matched prefix
    onto arena pages. Admissions run the chunked path (the splice and the
    suffix-only prefill live there), and every decode step hands the
    global table to the attention (LaneMeta.global_pages), so B5 reads the
    shared pages in place.
    """

    # In-flight dedup bound: a parked follower proceeds cold after this
    # many re-check ticks even if the pending entry never clears.
    DEDUP_WAIT_TICKS = 512

    def __init__(
        self,
        engine: GenerationEngine,
        num_slots: int = 8,
        page_size: int = 128,
        max_slot_tokens: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = None,
        prefix_cache_pages: Optional[int] = None,
        prefix_cache_tenant_quota: Optional[int] = None,
    ):
        from luminaai_tpu_torch.inference.prefix_cache import (
            RadixPrefixCache,
        )

        self.engine = engine
        self.model = engine.model
        self.device = self.model.device
        cfg = engine.config
        cap = int(max_slot_tokens or engine.max_context)
        page_size = max(1, int(page_size))
        pages = max(1, -(-cap // page_size))
        num_slots = max(1, int(num_slots))
        if prefix_cache_pages is None:
            prefix_cache_pages = int(getattr(cfg, "prefix_cache_pages", 0) or 0)
        if prefix_cache_tenant_quota is None:
            prefix_cache_tenant_quota = int(
                getattr(cfg, "prefix_cache_tenant_quota", 0) or 0
            )
        if prefill_chunk_tokens is None:
            prefill_chunk_tokens = int(
                getattr(cfg, "prefill_chunk_size", 0) or 0
            )
        if prefix_cache_pages > 0 and prefill_chunk_tokens <= 0:
            # The suffix-only prefill rides the chunked path; a cache
            # without chunking has no splice path.
            logger.warning(
                "prefix cache disabled: chunked prefill is off "
                "(prefill_chunk_tokens=0)"
            )
            prefix_cache_pages = 0
        arena_slots = (
            -(-prefix_cache_pages // pages) if prefix_cache_pages > 0 else 0
        )
        self.total_slots = num_slots + arena_slots
        caches = engine.init_cache(self.total_slots, pages * page_size,
                                   rolling=False)
        # Lane accounting covers the first num_slots rows only; the arena
        # slots are reached through global page-table entries.
        self.pool = PagedKVPool(
            to_paged(caches, pages, page_size),
            num_slots=num_slots,
            pages=pages,
            page_size=page_size,
        )
        # Flat [total_slots, C, Hkv, D] views of the pool: what the layers
        # write (lanes) and the attention reads (lanes and arena).
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
            (num_slots, cfg.vocab_size), dtype=torch.int32,
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
        self.prefill_chunk = max(
            0, min(int(prefill_chunk_tokens), self.token_capacity)
        )
        self.prefix_cache = None
        if arena_slots > 0:
            arena_ids = [
                (num_slots + a) * pages + p
                for a in range(arena_slots)
                for p in range(pages)
            ][:max(prefix_cache_pages, 1)]
            self.prefix_cache = RadixPrefixCache(
                arena_ids, page_size=page_size,
                tenant_quota=prefix_cache_tenant_quota,
            )
        # Global page table (authoritative only with the prefix cache on).
        self._gtable = (
            np.arange(num_slots, dtype=np.int32)[:, None] * pages
            + np.arange(pages, dtype=np.int32)[None, :]
        )
        # Arena pages each lane references (unpinned in release_slot).
        self._leases: Dict[int, List[int]] = {}
        # Chain keys each mid-prefill lane claimed as their harvester.
        self._pending_claims: Dict[int, List[str]] = {}
        # Deferred harvest copies (src global id, dst arena id); one bulk
        # copy per flush_harvests(). Queued dst pages are refcount-pinned,
        # and the cache marks them landed only after the copy.
        self._harvest_queue: List[Tuple[int, int]] = []
        self.harvest_copy_calls = 0
        self.harvest_flushes = 0
        # Cross-replica page plane: the scheduler injects a
        # serving/page_share.PageShareClient here; start_prefill then asks
        # the fleet index for chains resident on another replica and
        # imports their pages before the local acquire. _landed_keys holds
        # chain keys whose BYTES are arena-resident (flushed harvest or
        # completed pull), drained by the scheduler into ownership
        # reports; a key is never reported while its copy is queued.
        self.page_share = None
        self._landed_keys: List[str] = []
        self.remote_hits = 0
        self.remote_pull_failures = 0
        self._refresh_table()

    def _refresh_table(self) -> None:
        """Device copy of the authoritative page table: the global table
        with the prefix cache on (splices retarget it), the pool's local
        identity table otherwise."""
        if self.prefix_cache is not None:
            self._table = torch.as_tensor(self._gtable, device=self.device)
        else:
            self._table = torch.as_tensor(
                self.pool.page_table_array(), device=self.device
            )

    def _reset_gtable_row(self, slot: int) -> None:
        self._gtable[slot] = (
            slot * self.pool.pages
            + np.arange(self.pool.pages, dtype=np.int32)
        )

    # -- slot lifecycle ----------------------------------------------------
    def has_free_slot(self) -> bool:
        return self.pool.has_free()

    def acquire_slot(self) -> int:
        slot = self.pool.alloc()
        if self.prefix_cache is not None:
            # A queued harvest may read from the slot being recycled: its
            # pages land in the arena before the new occupant writes.
            self.flush_harvests()
            self._reset_gtable_row(slot)
            self._refresh_table()
        return slot

    def release_slot(self, slot: int) -> None:
        self._active[slot] = False
        if self.prefix_cache is not None:
            # The lane's spliced pages drop their pin (they stay cached)
            # and its table row goes back to identity, so no stale alias
            # rides into the next occupant.
            self.prefix_cache.release(self._leases.pop(slot, []))
            claims = self._pending_claims.pop(slot, None)
            if claims:
                self.prefix_cache.release_pending(claims)
            self._reset_gtable_row(slot)
            self._refresh_table()
        self.pool.free(slot)

    def active_count(self) -> int:
        return int(self._active.sum())

    def lane_full(self, slot: int) -> bool:
        """Next decode row would overflow the slot's token budget."""
        return int(self._pos[slot]) >= self.token_capacity

    # -- device pieces -----------------------------------------------------
    def _lane(self, slot: int, rows: int):
        """Per-layer (k, v) views of one slot's first `rows` rows."""
        return map_sides(lambda t: t[slot:slot + 1, :rows], self._flat)

    def _forward_rows(self, ids: np.ndarray, caches, start: int,
                      length: int, last: int) -> torch.Tensor:
        """Run prompt rows ids[0] at positions start.. (rows past `length`
        are padding, position -1) through one lane's `caches`; return the
        fp32 logits [1, V] of row `last`."""
        dev = self.device
        pos = start + np.arange(ids.shape[1])
        positions = np.where(pos < length, pos, -1)[None]
        self.prefill_forwards += 1
        hidden, _ = self.model(
            torch.as_tensor(ids, dtype=torch.int64, device=dev),
            positions=torch.as_tensor(positions, device=dev),
            kv_caches=caches,
            cache_index=torch.tensor([start], device=dev),
            return_hidden=True,
        )
        return self.model.embedder.decode(hidden[:, last])

    def _prefill_rows(self, ids: np.ndarray, slot: int, start: int,
                      length: int, rows: int, last: int) -> torch.Tensor:
        """_forward_rows into the slot's own first `rows` rows."""
        return self._forward_rows(ids, self._lane(slot, rows), start,
                                  length, last)

    def _prefill_rows_cached(self, ids: np.ndarray, slot: int, start: int,
                             length: int, last: int, p0: int
                             ) -> torch.Tensor:
        """A chunk of a lane whose first p0 logical pages are spliced
        arena pages (the JAX `_get_chunk_prefill_cached`): the lane's
        logical view is gathered through its global table row, the chunk
        runs on it, and the pages the chunk wrote (all private: the chunk
        starts at or past p0 pages) land back in the lane's own storage.
        Shared prefix bytes are never copied into the slot."""
        P, ps = self.pool.pages, self.pool.page_size
        idx = torch.as_tensor(self._gtable[slot], dtype=torch.int64,
                              device=self.device)
        views = map_sides(
            lambda t: t.reshape(t.shape[0] * P, *t.shape[2:]).index_select(
                0, idx).reshape(1, P * ps, *t.shape[3:]),
            self.pool.caches)
        logits = self._forward_rows(ids, views, start, length, last)
        end = min(start + ids.shape[1], length)
        j0, j1 = max(start // ps, p0), min(-(-end // ps), P)
        if j1 > j0:
            for t, vt in zip(cache_leaves(self.pool.caches),
                             cache_leaves(views)):
                t[slot, j0:j1] = vt.view(P, ps, *t.shape[3:])[j0:j1]
        return logits

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
        backend: None (the engine config's), 'ragged' (the kernel) or
        'plain'. With the prefix cache on the table holds global ids."""
        dev = self.device
        use_global = self.prefix_cache is not None
        lengths = np.where(self._active, self._pos + 1, 0).astype(np.int32)
        meta = LaneMeta(
            lengths=torch.as_tensor(lengths, device=dev),
            page_table=self._table,
            backend=backend,
            window=self.engine.config.attention_window,
            page_size=self.pool.page_size,
            extent=self._active_extent(),
            identity_pages=not use_global,
            global_pages=use_global,
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
        tenant: str = "anon",
    ) -> Optional[Dict[str, Any]]:
        """Begin a CHUNKED prefill into `slot`: returns the host-side state
        for advance_prefill, or None when chunking is off or the prompt
        fits one chunk and hits no cached page (callers then use
        prefill_into_slot). The lane stays inactive until the final chunk
        activates it.

        With the prefix cache on, the longest cached page chain of the
        prompt is pinned and spliced into the lane's global page table
        (_arm_prefill), and chunks run over the uncached suffix only; the
        last prompt row is always recomputed (its logits sample token #1).
        When the prompt's first non-resident page is being computed by
        another live admission, the lane parks (`waiting`) and re-checks
        each advance_prefill until that harvest lands (in-flight dedup)."""
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
        ps = self.pool.page_size
        st: Dict[str, Any] = {
            "slot": slot, "length": L, "chunk": chunk, "next": 0,
            "n_chunks": 0, "sample_key": sample_key, "seed": seed,
            "max_new": max_new, "prompt": prompt, "tenant": tenant,
            "start_rows": 0, "p0": 0,
        }
        if self.prefix_cache is not None:
            from luminaai_tpu_torch.inference.prefix_cache import (
                page_chain_keys,
            )

            # One chained hash of the prompt per admission, shared by the
            # peek and the pin. The peek books nothing.
            chain = page_chain_keys(prompt, ps, (L - 1) // ps)
            st["chain"] = chain
            peek_keys, _ = self.prefix_cache.lookup(prompt, keys=chain)
            if len(peek_keys) < len(chain) and (
                self.prefix_cache.has_pending_prefix(chain)
            ):
                self.prefix_cache.note_dedup_wait()
                st["waiting"] = True
                st["wait_ticks"] = 0
                self._park_lane(slot, 0)
                return st
            if len(peek_keys) < len(chain) and self.page_share is not None:
                # A cold (or partly cold) chain: pull the pages another
                # replica already computed BEFORE the acquire, turning
                # this admission into a local hit; any failure leaves it
                # exactly the miss it was.
                if self._try_remote_pull(slot, prompt, chain,
                                         len(peek_keys), st):
                    peek_keys, _ = self.prefix_cache.lookup(
                        prompt, keys=chain
                    )
            if L <= chunk and not peek_keys:
                return None
        elif L <= chunk:
            # One chunk stalls no one longer than a chunk anyway, and the
            # bucketed path touches only a page-aligned prompt prefix.
            return None
        self._arm_prefill(st)
        return st

    def _try_remote_pull(
        self,
        slot: int,
        prompt: Sequence[int],
        chain: List[str],
        have: int,
        st: Dict[str, Any],
    ) -> int:
        """Pull this chain's non-resident pages from their fleet owner into
        the local arena. Returns the pages imported; 0 means "proceed as
        the plain miss you were".

        Fleet lookup, then a pull slot (bounded, non-blocking), then a
        pending claim on the keys (concurrent same-chain admissions park
        behind it as behind a local harvest, so N arrivals cost one pull),
        then arena pages through the cache's insert(), then each page
        fetched and imported IN CHAIN ORDER under one deadline. The import
        is synchronous inside the admission (one scheduler worker), so no
        acquire can splice a page whose bytes have not landed; each page
        is marked landed as its import returns, so the export route
        (pin_key) refuses it until then. On a
        failure mid-chain the imported prefix stays (a valid shorter
        chain) and the unwritten tail is released and forgotten."""
        client = self.page_share
        cache = self.prefix_cache
        ps = self.pool.page_size
        try:
            owner, owned = client.lookup(chain, have=have)
        except Exception:  # a sick router never blocks admission
            logger.debug("page-share lookup failed", exc_info=True)
            return 0
        if owner is None or len(owned) <= have:
            return 0
        if not client.try_begin_pull():
            return 0
        deadline = time.monotonic() + client.timeout_s
        claimed = cache.claim_pending(owned, owner=slot)
        imported: List[int] = []
        imported_keys: List[str] = []
        nbytes = 0
        failed = False
        try:
            assignments = cache.insert(
                list(prompt[: len(owned) * ps]), from_page=have,
                tenant=st.get("tenant", "anon"),
            )
            if not assignments:
                return 0
            cache.pin_pages([pid for _, pid in assignments])
            try:
                for j, pid in assignments:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise OSError("page pull deadline exceeded")
                    payload = client.fetch_page(
                        owner, chain[j], timeout_s=remaining
                    )
                    nbytes += self.pool.import_page(pid, payload)
                    cache.mark_landed([pid])
                    imported.append(pid)
                    imported_keys.append(chain[j])
            except Exception as e:
                failed = True
                self.remote_pull_failures += 1
                logger.warning(
                    "page pull from %s failed after %d/%d page(s): %s",
                    owner, len(imported), len(assignments), e,
                )
                tail = [
                    pid for _, pid in assignments if pid not in imported
                ]
                cache.release(tail)
                cache.forget(tail)
            cache.release(imported)
            if imported:
                # The pulled pages are arena-resident here too now:
                # advertise them so the next replica may pull from here.
                self._landed_keys.extend(imported_keys)
            st["remote"] = {
                "owner": owner,
                "pulled": len(imported),
                "tokens": len(imported) * ps,
                "bytes": nbytes,
                "failed": failed,
            }
            if imported:
                self.remote_hits += 1
            return len(imported)
        finally:
            cache.release_pending(claimed)
            client.end_pull()

    def _park_lane(self, slot: int, rows: int) -> None:
        """Interleaved decode steps still write one (garbage) row per lane:
        park a mid-prefill lane's write row at the slot's LAST row, which no
        chunk writes (prompts are bounded to token_capacity - 1) and which
        a lane decoding there overwrites before its mask admits it. (The
        last row is always a private page: splices cover at most
        (L - 1) // page_size full pages.)"""
        self._pos[slot] = self.slot_tokens - 1
        self._active[slot] = False
        self.pool.lengths[slot] = rows

    def _arm_prefill(self, st: Dict[str, Any]) -> None:
        """Resolve a prefill state into a runnable one: pin and splice the
        cached prefix (books the hit or miss), claim the non-resident tail
        for this lane's harvest, size the chunk ids, park the lane."""
        slot, prompt, L = st["slot"], st["prompt"], st["length"]
        chunk = st["chunk"]
        hit_ids: List[int] = []
        hit_rows = 0
        if self.prefix_cache is not None:
            # A queued harvest lands before any acquire: a hit on a page
            # whose copy has not run would splice unwritten K/V.
            self.flush_harvests()
            chain = st["chain"]
            hit_ids, hit_rows = self.prefix_cache.acquire(prompt, keys=chain)
            st["pending_keys"] = self.prefix_cache.claim_pending(
                chain, owner=slot
            )
            if st["pending_keys"]:
                self._pending_claims[slot] = st["pending_keys"]
        n = -(-(L - hit_rows) // chunk)
        ids = np.zeros((1, hit_rows + n * chunk), np.int64)
        ids[0, :L] = prompt
        if hit_ids:
            self._leases[slot] = list(hit_ids)
            self._gtable[slot, :len(hit_ids)] = np.asarray(hit_ids, np.int32)
            self._refresh_table()
        self._park_lane(slot, hit_rows)
        if self.prefix_cache is None:
            self._refresh_table()
        st.update(ids=ids, n_chunks=n, start_rows=hit_rows, p0=len(hit_ids))
        st.pop("waiting", None)

    @torch.inference_mode()
    def advance_prefill(
        self, st: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """Run ONE prefill chunk. Returns None while chunks remain; the
        final chunk samples token #1, activates the lane, and returns
        prefill_into_slot's info dict (plus a `prefix` block with the hit
        and harvest accounting when the cache is on). Chunks start at
        `start_rows`, the spliced prefix extent. A `waiting` state re-checks
        its leader instead of computing; once the leader's harvest lands
        (or it dies, or the wait budget runs out) it arms and runs its
        first chunk in the same call."""
        if st.get("waiting"):
            st["wait_ticks"] += 1
            cache = self.prefix_cache
            if (
                cache is not None
                and cache.has_pending_prefix(st["chain"])
                and st["wait_ticks"] < self.DEDUP_WAIT_TICKS
            ):
                return None
            self._arm_prefill(st)
        c, chunk, slot, L = st["next"], st["chunk"], st["slot"], st["length"]
        base = int(st.get("start_rows", 0))
        p0 = int(st.get("p0", 0))
        start = base + c * chunk
        # The JAX decoder clips this index inside the jitted chunk; here it
        # is a host integer, clamped explicitly.
        last = min(max(L - 1 - start, 0), chunk - 1)
        ids = st["ids"][:, start:start + chunk]
        if p0:
            logits = self._prefill_rows_cached(ids, slot, start, L, last, p0)
        else:
            logits = self._prefill_rows(ids, slot, start, L,
                                        self.slot_tokens, last)
        st["next"] = c + 1
        if st["next"] < st["n_chunks"]:
            self.pool.lengths[slot] = min(base + (c + 1) * chunk, L)
            return None
        info = self._finish_prefill(
            slot, logits, L, st["max_new"], st["sample_key"], st["seed"]
        )
        if self.prefix_cache is not None:
            harvested = self._harvest(slot, st)
            claims = self._pending_claims.pop(slot, None)
            if claims:
                self.prefix_cache.release_pending(claims)
            info["prefix"] = {
                "hit_pages": p0,
                "tokens_saved": base,
                "pages_harvested": harvested,
                "tenant": st.get("tenant", "anon"),
                "dedup_wait_ticks": int(st.get("wait_ticks", 0)),
                # The cross-replica pull's accounting (None for a purely
                # local admission): the scheduler books remote hits and
                # prefix_remote_hit events from it.
                "remote": st.get("remote"),
            }
        return info

    # -- prefix-cache harvest ----------------------------------------------
    def _harvest(self, slot: int, st: Dict[str, Any]) -> int:
        """Register this prompt's freshly computed full pages in the
        prefix cache and queue their copy from the lane's slot into the
        arena; flush_harvests() runs every queued copy as one bulk copy.
        Queued dst pages are pinned. Returns the pages queued."""
        assignments = self.prefix_cache.insert(
            st["prompt"], from_page=int(st.get("p0", 0)),
            tenant=st.get("tenant", "anon"),
        )
        if not assignments:
            return 0
        P = self.pool.pages
        self.prefix_cache.pin_pages([pid for _, pid in assignments])
        self._harvest_queue.extend(
            (slot * P + j, pid) for j, pid in assignments
        )
        return len(assignments)

    def flush_harvests(self) -> int:
        """Run every queued harvest as one bulk page copy: each layer's k
        and v pool tensors take `index_copy_` of their source pages, on the
        current stream (the one the next decode step reads from). Called
        by the scheduler once per tick and before any cache acquire or
        slot reuse. Returns the pages flushed; when the copy fails, the
        queued inserts are forgotten so the index never points at
        unwritten arena pages."""
        if not self._harvest_queue:
            return 0
        pairs, self._harvest_queue = self._harvest_queue, []
        dst_ids = [d for _, d in pairs]
        self.harvest_flushes += 1
        try:
            self.harvest_copy_calls += 1
            self._copy_pages([s for s, _ in pairs], dst_ids)
        except Exception:
            logger.exception(
                "prefix-cache harvest copy failed; unwinding %d page(s)",
                len(pairs),
            )
            self.prefix_cache.release(dst_ids)
            self.prefix_cache.forget(dst_ids)
            return 0
        self.prefix_cache.release(dst_ids)
        # The copy is enqueued on the current stream, ahead of anything an
        # export enqueues later: only now may the export route serve
        # these pages.
        self.prefix_cache.mark_landed(dst_ids)
        if self.page_share is not None:
            self._landed_keys.extend(self.prefix_cache.keys_for_pages(dst_ids))
        return len(pairs)

    def drain_landed_keys(self) -> List[str]:
        """Chain keys whose page bytes became arena-resident since the last
        drain (harvest flushes and completed remote pulls), for the
        scheduler's ownership reports to the router's fleet index."""
        out, self._landed_keys = self._landed_keys, []
        return out

    @torch.inference_mode()
    def _copy_pages(self, src: List[int], dst: List[int]) -> None:
        """Copy whole pages (global ids slot * pages + page) inside the
        pool: every leaf (each layer's k and v, an int8 pool's codes and
        scales), in one index_copy_ each."""
        s = torch.as_tensor(src, dtype=torch.int64, device=self.device)
        d = torch.as_tensor(dst, dtype=torch.int64, device=self.device)
        P = self.pool.pages
        for t in cache_leaves(self.pool.caches):
            flat = t.view(t.shape[0] * P, *t.shape[2:])
            flat.index_copy_(0, d, flat.index_select(0, s))

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
