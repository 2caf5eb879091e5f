"""Conversation tokenizer with ChatML-style role tags and loss masking (the
port's copy of luminaai_tpu/data/tokenizer.py).

Backends: 'byte' (self-contained byte level) and 'bpe:PATH' (a byte-level
BPE trained offline by data/bpe.py). The JAX package's 'tiktoken:' and
'hf:' backends need a downloaded vocabulary and a package outside the
port's imports (torch, numpy, the standard library); they are refused
here. The special tokens follow the backend's vocabulary in the JAX
order and the vocab pads to a multiple of 128, so the ids are the JAX
tokenizer's ids for the same text. Loss masks/weights come out as numpy
arrays ready for the train step's `loss_mask` / `loss_weights` keys.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

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

# Roles whose tokens receive the assistant loss weight (the model should
# learn to produce these; ref core/dataset.py:523 _create_loss_weights).
ASSISTANT_ROLES = frozenset({"assistant", "ai", "bot"})

TRUNCATION_STRATEGIES = ("right", "left", "middle")


class _ByteBackend:
    """Self-contained byte-level base tokenizer (vocab 256)."""

    n_vocab = 256
    name = "byte"

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace"
        )


def _make_backend(model_name: str):
    """Resolve a backend spec: 'byte' or 'bpe:PATH'. A BPE file the user
    named must load (a failure raises, as in the JAX package)."""
    if model_name in ("byte", "bytes"):
        return _ByteBackend()
    if model_name.startswith("bpe:"):
        from luminaai_tpu_torch.data.bpe import BPETokenizer

        return BPETokenizer.load(model_name.split(":", 1)[1])
    raise NotImplementedError(
        f"tokenizer backend {model_name!r} is not ported: the port runs "
        "'byte' and 'bpe:PATH' (tiktoken and HF vocabularies wait until "
        "their files are in the repository)"
    )


@dataclass
class TokenizationStats:
    """(ref tokenizer.py:25)"""

    conversations_processed: int = 0
    tokens_generated: int = 0
    validation_errors: int = 0
    truncations: int = 0
    encode_seconds: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class ConversationTokenizer:
    """Chat-template tokenizer producing tokens + loss masks/weights.

    Conversation format (ref): {"messages": [{"role": r, "content": c}]}.
    Layout per turn: <|im_start|> <role-token> ...content... <|im_end|>;
    assistant-role content (and its <|im_end|>) is marked in loss_mask with
    loss_weights = assistant_loss_weight.
    """

    def __init__(
        self,
        model_name: str = "byte",
        max_context_length: int = 8192,
        validation_level: str = "strict",
        assistant_loss_weight: float = 1.5,
        vocab_alignment: int = 128,
    ):
        self.backend = _make_backend(model_name)
        self.model_name = self.backend.name
        self.max_context_length = max_context_length
        self.validation_level = validation_level
        self.assistant_loss_weight = assistant_loss_weight

        base = self.backend.n_vocab
        self.special_tokens = {
            name: base + i for i, name in enumerate(SPECIAL_TOKEN_NAMES)
        }
        self._reverse_special = {v: k for k, v in self.special_tokens.items()}
        raw_vocab = base + len(self.special_tokens)
        self.vocab_size = (
            (raw_vocab + vocab_alignment - 1) // vocab_alignment
        ) * vocab_alignment
        self.pad_token_id = self.special_tokens["<|pad|>"]
        self.eos_token_id = self.special_tokens["<|endoftext|>"]
        self.im_start = self.special_tokens["<|im_start|>"]
        self.im_end = self.special_tokens["<|im_end|>"]
        self._role_token = {
            role: self.special_tokens[tag] for role, tag in ROLE_ALIASES.items()
        }
        self.stats = TokenizationStats()
        self._lock = threading.RLock()

    # -- validation (ref :169) -------------------------------------------
    def validate_conversation(
        self, conversation: Dict[str, Any]
    ) -> Tuple[bool, List[str]]:
        errors: List[str] = []
        msgs = conversation.get("messages")
        if not isinstance(msgs, list) or not msgs:
            errors.append("missing or empty 'messages'")
            return False, errors
        for i, m in enumerate(msgs):
            if not isinstance(m, dict):
                errors.append(f"message {i} not a dict")
                continue
            role = m.get("role", "")
            if role not in self._role_token:
                errors.append(f"message {i} unknown role {role!r}")
            content = m.get("content")
            if not isinstance(content, str) or (
                self.validation_level == "strict" and not content.strip()
            ):
                errors.append(f"message {i} invalid content")
        return not errors, errors

    # -- encoding (ref :251 encode_conversation) --------------------------
    def encode_conversation(
        self,
        conversation: Dict[str, Any],
        max_length: Optional[int] = None,
        truncation_strategy: str = "right",
        pad_to_length: Optional[int] = None,
    ) -> Optional[Dict[str, np.ndarray]]:
        t0 = time.time()
        ok, errors = self.validate_conversation(conversation)
        if not ok:
            with self._lock:
                self.stats.validation_errors += 1
            if self.validation_level == "strict":
                return None
        max_length = max_length or self.max_context_length

        tokens: List[int] = []
        weights: List[float] = []
        for msg in conversation.get("messages", []):
            role = msg.get("role", "user")
            content = msg.get("content", "") or ""
            role_tok = self._role_token.get(role, self._role_token["user"])
            is_assistant = role in ASSISTANT_ROLES
            w = self.assistant_loss_weight if is_assistant else 0.0
            body = self.backend.encode(content)
            turn = [self.im_start, role_tok, *body, self.im_end]
            # Structure tokens learn at weight 0 (prompt side) or full
            # weight on the assistant side, including the closing tag so
            # the model learns to stop.
            turn_w = [0.0, 0.0, *([w] * len(body)), w]
            tokens.extend(turn)
            weights.extend(turn_w)
        # Trailing EOS trains only when the conversation actually ends on
        # an assistant turn; otherwise (user/system-final multi-turn data)
        # weighting it would teach the model to emit EOS right after user
        # prompts.
        msgs = conversation.get("messages", [])
        ends_on_assistant = bool(msgs) and msgs[-1].get("role") in ASSISTANT_ROLES
        tokens.append(self.eos_token_id)
        weights.append(self.assistant_loss_weight if ends_on_assistant else 0.0)

        if len(tokens) > max_length:
            tokens, weights = self._truncate(
                tokens, weights, max_length, truncation_strategy
            )
            with self._lock:
                self.stats.truncations += 1

        if pad_to_length is not None and len(tokens) < pad_to_length:
            deficit = pad_to_length - len(tokens)
            tokens = tokens + [self.pad_token_id] * deficit
            weights = weights + [0.0] * deficit

        arr = np.asarray(tokens, dtype=np.int32)
        w = np.asarray(weights, dtype=np.float32)
        with self._lock:
            self.stats.conversations_processed += 1
            self.stats.tokens_generated += int((arr != self.pad_token_id).sum())
            self.stats.encode_seconds += time.time() - t0
        return {
            "input_ids": arr,
            "loss_mask": (w > 0).astype(np.float32),
            "loss_weights": np.where(w > 0, w, 1.0).astype(np.float32),
        }

    def _truncate(self, tokens, weights, max_length, strategy):
        """(ref :392 _apply_truncation)"""
        if strategy not in TRUNCATION_STRATEGIES:
            strategy = "right"
        marker = self.special_tokens["<|truncated|>"]
        if strategy == "right":
            return tokens[: max_length - 1] + [marker], weights[: max_length - 1] + [0.0]
        if strategy == "left":
            return [marker] + tokens[-(max_length - 1):], [0.0] + weights[-(max_length - 1):]
        half = (max_length - 1) // 2
        return (
            tokens[:half] + [marker] + tokens[-(max_length - 1 - half):],
            weights[:half] + [0.0] + weights[-(max_length - 1 - half):],
        )

    def encode_batch(
        self,
        conversations: Sequence[Dict[str, Any]],
        max_length: Optional[int] = None,
        pad_to_length: Optional[int] = None,
    ) -> List[Dict[str, np.ndarray]]:
        out = []
        for conv in conversations:
            enc = self.encode_conversation(
                conv, max_length=max_length, pad_to_length=pad_to_length
            )
            if enc is not None:
                out.append(enc)
        return out

    def encode_text(self, text: str) -> List[int]:
        """Plain text (base-training documents, no chat structure)."""
        return self.backend.encode(text)

    # -- decoding (ref :416) ----------------------------------------------
    def decode(
        self, token_ids: Sequence[int], skip_special_tokens: bool = True
    ) -> str:
        out: List[str] = []
        run: List[int] = []
        for t in np.asarray(token_ids).tolist():
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

    # -- helpers (ref :525-568) -------------------------------------------
    def is_special_token(self, token_id: int) -> bool:
        return token_id in self._reverse_special

    def get_role_token(self, role: str) -> int:
        return self._role_token.get(role, self._role_token["user"])

    def get_special_tokens(self) -> Dict[str, int]:
        return dict(self.special_tokens)

    def get_vocab_size(self) -> int:
        return self.vocab_size

    def estimate_tokens(self, text: str) -> int:
        return len(self.backend.encode(text))

    def get_stats(self) -> Dict[str, Any]:
        return self.stats.to_dict()

    def reset_stats(self) -> None:
        self.stats = TokenizationStats()

    def __repr__(self) -> str:
        return (
            f"ConversationTokenizer(backend={self.model_name!r}, "
            f"vocab={self.vocab_size}, special={len(self.special_tokens)})"
        )
