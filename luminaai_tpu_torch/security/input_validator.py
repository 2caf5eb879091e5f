"""User-input and conversation-payload validation.

Covers the reference InputValidator (ref: Src/Main_Scripts/security/
input_validator.py:17 — conversation/message/content checks, sanitization,
user-input screening). Additions specific to this framework: chat-template
smuggling detection — raw role tags like <|im_start|> inside user content
would let a user forge assistant/system turns in the token stream.

The port's copy of luminaai_tpu/security/input_validator.py (standard library only).
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from typing import Any, Dict, List

MAX_CONTENT_CHARS = 32_768
MAX_MESSAGES = 256
VALID_ROLES = ("system", "user", "assistant", "tool")

# Chat-template special tags must never arrive via user text.
_TEMPLATE_TAGS = re.compile(r"<\|[a-z_]+\|>", re.IGNORECASE)
# Control chars except \n\t\r.
_CONTROL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")
# Crude script/injection probes (ref input_validator.py suspicious patterns).
_SUSPICIOUS = re.compile(
    r"(<script\b|javascript:|data:text/html|\beval\s*\(|\bexec\s*\()",
    re.IGNORECASE,
)


@dataclass
class ValidationResult:
    """(ref input_validator.py:9)"""

    valid: bool
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    sanitized: Any = None

    def merge(self, other: "ValidationResult") -> None:
        self.valid = self.valid and other.valid
        self.errors.extend(other.errors)
        self.warnings.extend(other.warnings)


class InputValidator:
    """Structural + content validation with sanitization (ref :17)."""

    def __init__(
        self,
        max_content_chars: int = MAX_CONTENT_CHARS,
        max_messages: int = MAX_MESSAGES,
        strip_template_tags: bool = True,
    ):
        self.max_content_chars = max_content_chars
        self.max_messages = max_messages
        self.strip_template_tags = strip_template_tags

    # -- conversations (ref :45) ------------------------------------------
    def validate_conversation(
        self, conversation: Dict[str, Any]
    ) -> ValidationResult:
        result = ValidationResult(valid=True)
        if not isinstance(conversation, dict):
            return ValidationResult(False, errors=["conversation not a dict"])
        msgs = conversation.get("messages")
        if not isinstance(msgs, list) or not msgs:
            return ValidationResult(False, errors=["missing/empty messages"])
        if len(msgs) > self.max_messages:
            result.valid = False
            result.errors.append(f"too many messages (> {self.max_messages})")
            return result
        sanitized_msgs = []
        for i, msg in enumerate(msgs):
            mr = self._validate_message(msg)
            if not mr.valid:
                mr.errors = [f"message {i}: {e}" for e in mr.errors]
            result.merge(mr)
            if mr.sanitized is not None:
                sanitized_msgs.append(mr.sanitized)
        result.sanitized = {**conversation, "messages": sanitized_msgs}
        return result

    def _validate_message(self, message: Any) -> ValidationResult:
        """(ref :86)"""
        if not isinstance(message, dict):
            return ValidationResult(False, errors=["not a dict"])
        role = message.get("role")
        if role not in VALID_ROLES:
            return ValidationResult(False, errors=[f"bad role {role!r}"])
        content = message.get("content")
        if not isinstance(content, str):
            return ValidationResult(False, errors=["content not a string"])
        cr = self._validate_content(content)
        if cr.sanitized is not None:
            cr.sanitized = {**message, "content": cr.sanitized}
        return cr

    def _validate_content(self, content: str) -> ValidationResult:
        """(ref :127)"""
        result = ValidationResult(valid=True)
        if len(content) > self.max_content_chars:
            result.valid = False
            result.errors.append(
                f"content too long ({len(content)} > {self.max_content_chars})"
            )
            return result
        if _TEMPLATE_TAGS.search(content):
            result.warnings.append("template tags stripped from content")
        if _SUSPICIOUS.search(content):
            result.warnings.append("suspicious pattern in content")
        result.sanitized = self.sanitize(content)
        return result

    # -- free-form user input (ref :172) ----------------------------------
    def validate_user_input(self, user_input: Any) -> ValidationResult:
        if not isinstance(user_input, str):
            return ValidationResult(False, errors=["input not a string"])
        if not user_input.strip():
            return ValidationResult(False, errors=["empty input"])
        return self._validate_content(user_input)

    # -- sanitization (ref :158) ------------------------------------------
    def sanitize(self, content: str) -> str:
        content = unicodedata.normalize("NFC", content)
        content = _CONTROL.sub("", content)
        if self.strip_template_tags:
            content = _TEMPLATE_TAGS.sub("", content)
        return content
