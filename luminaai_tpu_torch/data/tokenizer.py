"""Byte-level ChatML tokenizer (trimmed copy of luminaai_tpu/data/tokenizer.py).

The port serves the byte backend only: 256 byte ids, then the ChatML
special tokens in the JAX package's order, padded to a multiple of 128.
The ids are therefore the JAX tokenizer's ids for the same text.
"""

from __future__ import annotations

from typing import List, Sequence

SPECIAL_TOKEN_NAMES = (
    "<|im_start|>",
    "<|im_end|>",
    "<|user|>",
    "<|assistant|>",
    "<|system|>",
    "<|human|>",
    "<|ai|>",
    "<|bot|>",
    "<|thought|>",
    "<|tool|>",
    "<|error|>",
    "<|truncated|>",
    "<|endoftext|>",
    "<|pad|>",
)

ROLE_ALIASES = {
    "user": "<|user|>",
    "prompter": "<|user|>",
    "human": "<|human|>",
    "assistant": "<|assistant|>",
    "ai": "<|ai|>",
    "bot": "<|bot|>",
    "system": "<|system|>",
    "thought": "<|thought|>",
    "tool": "<|tool|>",
}


class _ByteBackend:
    """Self-contained byte-level base tokenizer (vocab 256)."""

    n_vocab = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace"
        )


class ConversationTokenizer:
    """The encode/decode surface the serving path uses."""

    def __init__(self):
        self.backend = _ByteBackend()
        base = self.backend.n_vocab
        self.special_tokens = {
            name: base + i for i, name in enumerate(SPECIAL_TOKEN_NAMES)
        }
        self._reverse_special = {v: k for k, v in self.special_tokens.items()}
        raw_vocab = base + len(self.special_tokens)
        self.vocab_size = -(-raw_vocab // 128) * 128
        self.pad_token_id = self.special_tokens["<|pad|>"]
        self.eos_token_id = self.special_tokens["<|endoftext|>"]
        self.im_start = self.special_tokens["<|im_start|>"]
        self.im_end = self.special_tokens["<|im_end|>"]
        self._role_token = {
            role: self.special_tokens[tag] for role, tag in ROLE_ALIASES.items()
        }

    def encode_text(self, text: str) -> List[int]:
        return self.backend.encode(text)

    def decode(
        self, token_ids: Sequence[int], skip_special_tokens: bool = True
    ) -> str:
        """Ids past the byte range (special tokens, and any id a model with
        a larger vocab emits) end a byte run; specials print only when
        asked for."""
        out: List[str] = []
        run: List[int] = []
        for t in (int(x) for x in token_ids):
            if t in self._reverse_special or t >= self.backend.n_vocab:
                if run:
                    out.append(self.backend.decode(run))
                    run = []
                if not skip_special_tokens and t in self._reverse_special:
                    out.append(self._reverse_special[t])
            else:
                run.append(t)
        if run:
            out.append(self.backend.decode(run))
        return "".join(out)

    def get_role_token(self, role: str) -> int:
        return self._role_token.get(role, self._role_token["user"])
