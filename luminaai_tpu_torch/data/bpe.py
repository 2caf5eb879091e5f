"""Trainable byte-level BPE tokenizer (the port's copy of
luminaai_tpu/data/bpe.py).

The reference can only consume pretrained tiktoken vocabularies
(ref Src/Main_Scripts/core/tokenizer.py:36 — cl100k_base etc.), which
need network access to fetch; this module trains a vocabulary offline on
the user's own corpus. Training's merge loop runs in C++ when available
(native/bpe.cpp, incremental pair-index algorithm) with a bit-identical
Python fallback; encode is pure Python with a per-word LRU, fast enough
because pretokens repeat heavily.

Token id layout: 0-255 raw bytes, 256+i for merge i. ConversationTokenizer
layers its ChatML specials on top of n_vocab, so a trained BPE drops in as
a backend: ConversationTokenizer(model_name="bpe:/path/to/tok.json").
"""

from __future__ import annotations

import json
import logging
import re
from collections import Counter
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# GPT-2-style pretokenization, simplified to stdlib `re`: leading-space
# word pieces, number runs, punctuation runs, whitespace runs. Merges
# never cross pretoken boundaries, which keeps words re-usable cache keys.
_PRETOK = re.compile(
    r" ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+"
)


def pretokenize(text: str) -> List[str]:
    return _PRETOK.findall(text)


def _merge_loop_python(
    words: List[List[int]], counts: List[int], n_merges: int
) -> List[Tuple[int, int]]:
    """Reference implementation of native/bpe.cpp (same algorithm, same
    deterministic tie-break: highest count, then smallest (a, b) pair)."""
    pair_count: Counter = Counter()
    pair_words: Dict[Tuple[int, int], set] = {}
    for w, seq in enumerate(words):
        for p in zip(seq, seq[1:]):
            pair_count[p] += counts[w]
            pair_words.setdefault(p, set()).add(w)

    merges: List[Tuple[int, int]] = []
    for produced in range(n_merges):
        best, best_count = None, 0
        for p, c in pair_count.items():
            if c > best_count or (c == best_count and best_count > 0 and p < best):
                best, best_count = p, c
        if best is None or best_count < 2:
            break
        new_id = 256 + produced
        merges.append(best)
        for w in list(pair_words.get(best, ())):
            seq = words[w]
            cnt = counts[w]
            for p in zip(seq, seq[1:]):
                pair_count[p] -= cnt
                if pair_count[p] <= 0:
                    del pair_count[p]
                if p in pair_words:
                    pair_words[p].discard(w)
            out: List[int] = []
            i = 0
            while i < len(seq):
                if (
                    i + 1 < len(seq)
                    and seq[i] == best[0]
                    and seq[i + 1] == best[1]
                ):
                    out.append(new_id)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            words[w] = out
            for p in zip(out, out[1:]):
                pair_count[p] += cnt
                pair_words.setdefault(p, set()).add(w)
        pair_count.pop(best, None)
        pair_words.pop(best, None)
    return merges


def train_bpe(
    texts: Iterable[str],
    vocab_size: int = 8192,
    use_native: bool = True,
) -> "BPETokenizer":
    """Learn a BPE vocab from an iterable of texts.

    vocab_size counts the 256 byte tokens; merges = vocab_size - 256.
    """
    n_merges = max(0, vocab_size - 256)
    word_counts: Counter = Counter()
    for text in texts:
        word_counts.update(pretokenize(text))
    words = [list(w.encode("utf-8")) for w in word_counts]
    counts = list(word_counts.values())
    logger.info(
        "bpe: %d unique pretokens, %d corpus words, target %d merges",
        len(words), sum(counts), n_merges,
    )

    merges: Optional[Sequence[Tuple[int, int]]] = None
    if use_native and words:
        from luminaai_tpu_torch.native import bpe_train_native

        flat = np.asarray(
            [t for w in words for t in w], dtype=np.int32
        )
        offsets = np.zeros(len(words) + 1, dtype=np.int64)
        np.cumsum([len(w) for w in words], out=offsets[1:])
        got = bpe_train_native(
            flat, offsets, np.asarray(counts, dtype=np.int64), n_merges
        )
        if got is not None:
            merges = [tuple(int(x) for x in row) for row in got]
    if merges is None:
        merges = _merge_loop_python(
            [list(w) for w in words], counts, n_merges
        )
    return BPETokenizer(list(merges))


class BPETokenizer:
    """Encoder/decoder over a learned merge list (backend-protocol
    compatible: encode/decode/n_vocab/name)."""

    name = "bpe"

    def __init__(self, merges: List[Tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        self.ranks: Dict[Tuple[int, int], int] = {
            tuple(m): i for i, m in enumerate(self.merges)
        }
        # token id → byte string, for O(1) decode
        self._bytes: List[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])
        self.n_vocab = 256 + len(self.merges)
        # per-instance cache (distinct vocabs must not share entries)
        self._encode_word = lru_cache(maxsize=65536)(self._encode_word_raw)

    def _encode_word_raw(self, word: str) -> Tuple[int, ...]:
        seq: List[int] = list(word.encode("utf-8"))
        while len(seq) > 1:
            best_rank, best_i = None, -1
            for i in range(len(seq) - 1):
                r = self.ranks.get((seq[i], seq[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            seq[best_i : best_i + 2] = [256 + best_rank]
        return tuple(seq)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for word in pretokenize(text):
            out.extend(self._encode_word(word))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(
            self._bytes[i] for i in ids if 0 <= i < self.n_vocab
        ).decode("utf-8", errors="replace")

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"version": 1, "type": "byte_bpe", "merges": self.merges},
                f,
            )

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            data = json.load(f)
        if data.get("type") != "byte_bpe":
            raise ValueError(f"{path} is not a byte_bpe tokenizer file")
        return cls([tuple(m) for m in data["merges"]])
