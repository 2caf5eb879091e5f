"""OASST processing, dataset validation, sample-data generation.

Covers ref: Src/Main_Scripts/utils/data_processing.py — :13
process_oasst_data (role normalization, validation, jsonl out), :83
validate_data_comprehensive (structure/role/length checks + token stats),
:227 create_sample_data.

The port's copy of luminaai_tpu/data/processing.py (`data sample`,
`data oasst`, `data validate`).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_ROLE_NORMALIZE = {
    "prompter": "user",
    "human": "user",
    "user": "user",
    "assistant": "assistant",
    "ai": "assistant",
    "bot": "assistant",
    "system": "system",
}


def process_oasst_data(
    input_path: str,
    output_path: str,
    max_conversations: Optional[int] = None,
) -> int:
    """Normalize OASST-style jsonl into the framework's conversation schema
    (ref data_processing.py:13). Returns number of valid conversations."""
    if not Path(input_path).exists():
        raise FileNotFoundError(input_path)
    stats = {"processed": 0, "valid": 0, "errors": 0}
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    with open(input_path) as fin, open(output_path, "w") as fout:
        for line_no, line in enumerate(fin, 1):
            if max_conversations and stats["valid"] >= max_conversations:
                break
            line = line.strip()
            if not line:
                continue
            try:
                data = json.loads(line)
            except json.JSONDecodeError:
                stats["errors"] += 1
                continue
            stats["processed"] += 1
            messages = []
            for msg in data.get("messages", []):
                role = _ROLE_NORMALIZE.get(
                    str(msg.get("role", "")).lower(), "user"
                )
                content = (msg.get("content") or "").strip()
                if content:
                    messages.append({"role": role, "content": content})
            if len(messages) >= 2 and any(
                m["role"] == "assistant" for m in messages
            ):
                fout.write(json.dumps({
                    "conversation_id": data.get(
                        "conversation_id", f"conv_{line_no}"
                    ),
                    "messages": messages,
                    "metadata": {"source": "oasst",
                                 "processed_at": time.time()},
                }) + "\n")
                stats["valid"] += 1
    logger.info("oasst: %s", stats)
    return stats["valid"]


def validate_data_comprehensive(
    data_path: str, tokenizer, max_check: int = 5000
) -> Dict[str, Any]:
    """Structural + token-level dataset report (ref :83)."""
    issues: Dict[str, int] = {
        "bad_json": 0, "missing_messages": 0, "bad_roles": 0,
        "empty_content": 0, "no_assistant": 0, "too_long": 0,
    }
    token_counts = []
    n = 0
    with open(data_path) as f:
        for i, line in enumerate(f):
            if i >= max_check:
                break
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                conv = json.loads(line)
            except json.JSONDecodeError:
                issues["bad_json"] += 1
                continue
            msgs = conv.get("messages")
            if not isinstance(msgs, list) or len(msgs) < 2:
                issues["missing_messages"] += 1
                continue
            roles = [m.get("role") for m in msgs]
            if any(r not in _ROLE_NORMALIZE for r in roles):
                issues["bad_roles"] += 1
            if any(not (m.get("content") or "").strip() for m in msgs):
                issues["empty_content"] += 1
            if "assistant" not in {
                _ROLE_NORMALIZE.get(r, "") for r in roles
            }:
                issues["no_assistant"] += 1
            enc = tokenizer.encode_conversation(conv)
            if enc is not None:
                t = int(enc["input_ids"].shape[0])
                token_counts.append(t)
                if t > tokenizer.max_context_length:
                    issues["too_long"] += 1
    valid = n - sum(issues.values())
    report = {
        "path": data_path,
        "checked": n,
        "valid": max(0, valid),
        "issues": issues,
        "token_stats": {
            "mean": float(np.mean(token_counts)) if token_counts else 0.0,
            "p50": float(np.percentile(token_counts, 50)) if token_counts else 0.0,
            "p95": float(np.percentile(token_counts, 95)) if token_counts else 0.0,
            "max": int(np.max(token_counts)) if token_counts else 0,
        },
    }
    return report


_SAMPLE_TOPICS = [
    ("What is a mixture-of-experts model?",
     "A mixture-of-experts (MoE) model routes each token to a small subset "
     "of expert networks, so capacity grows without growing per-token "
     "compute."),
    ("Write a Python function that adds two numbers.",
     "Sure! Here's a simple function:\n\n```python\ndef add_numbers(a, b):\n"
     "    return a + b\n```"),
    ("Explain what a TPU systolic array does.",
     "A systolic array streams operands through a grid of multiply-"
     "accumulate units, so matrix multiplications proceed without "
     "re-fetching operands from memory at every step."),
    ("How do I reverse a list in Python?",
     "Use slicing: `my_list[::-1]`, or in place with `my_list.reverse()`."),
    ("What causes gradient explosions?",
     "Repeated multiplication by large Jacobians during backpropagation; "
     "mitigations include gradient clipping, careful initialization, and "
     "normalization layers."),
]


def create_sample_data(output_path: str, num_conversations: int = 100) -> int:
    """Synthetic conversations for smoke tests/demos (ref :227)."""
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w") as f:
        for i in range(num_conversations):
            q, a = _SAMPLE_TOPICS[i % len(_SAMPLE_TOPICS)]
            f.write(json.dumps({
                "conversation_id": f"sample_{i}",
                "messages": [
                    {"role": "user", "content": f"{q} (variant {i})"},
                    {"role": "assistant", "content": a},
                ],
            }) + "\n")
    return num_conversations
