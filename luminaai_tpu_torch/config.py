"""Configuration for the PyTorch/CUDA port (trimmed copy of luminaai_tpu/config.py).

The port keeps its own copy of the fields its serving slice reads, with the
JAX package's defaults and validation, so a `Config` built with the same
keyword arguments describes the same model on both sides. Fields for
parallelism, training runtime, monitoring and MoE routing stay in the JAX
package until the slices that need them are ported; `use_moe=True` is kept
as a field (the presets set it) and refused where a model is built.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

PRECISIONS = ("auto", "fp32", "bf16", "mixed_bf16", "fp16", "mixed_fp16")


@dataclass
class Config:
    """Model + serving configuration (the subset the port reads)."""

    # --- Model architecture ---
    vocab_size: int = 50304
    hidden_size: int = 512
    num_layers: int = 8
    num_heads: int = 8
    num_kv_heads: Optional[int] = 4
    seq_length: int = 1024
    intermediate_size: Optional[int] = None  # auto: 8/3 * hidden, rounded
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    init_std: float = 0.02
    # RoPE rotation math: 'fp32' (exact tables) or 'bf16' (rotation in the
    # compute dtype; only the products round differently).
    rope_dtype: str = "fp32"
    # Chunked prefill: prompts longer than one chunk prefill in fixed
    # chunks of this many tokens, interleaved with decode steps by the
    # scheduler. 0 disables (bucketed prefill for every prompt).
    prefill_chunk_size: int = 64
    # Sliding-window attention width (None = full causal). The slot-paged
    # pool never rolls, so the window is a per-lane band mask.
    attention_window: Optional[int] = None

    # --- MoE (the presets set it, as the JAX presets do; not ported) ---
    use_moe: bool = False

    # --- Precision ---
    precision: str = "auto"  # auto|fp32|bf16|mixed_bf16|fp16|mixed_fp16

    # --- Generation ---
    max_new_tokens: int = 512
    temperature: float = 0.8
    top_p: float = 0.9
    top_k: int = 50
    repetition_penalty: float = 1.05

    seed: int = 42

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size is None:
            # SwiGLU sizing: 8/3 * hidden, rounded up to a multiple of 128.
            raw = int(8 * self.hidden_size / 3)
            self.intermediate_size = ((raw + 127) // 128) * 128
        self.validate()

    def validate(self) -> None:
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("hidden_size must be divisible by num_heads")
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.precision not in PRECISIONS:
            raise ValueError(f"invalid precision {self.precision}")
        if self.rope_dtype not in ("fp32", "bf16"):
            raise ValueError(f"invalid rope_dtype {self.rope_dtype}")
        if self.prefill_chunk_size < 0:
            raise ValueError(
                "prefill_chunk_size must be >= 0 (0 disables chunked prefill)"
            )
        if self.attention_window is not None and self.attention_window <= 0:
            raise ValueError(
                f"attention_window must be positive, got "
                f"{self.attention_window}"
            )

    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def resolve_precision(self) -> str:
        p = self.precision
        if p == "auto":
            return "mixed_bf16"
        if p == "fp16":
            return "bf16"
        if p == "mixed_fp16":
            return "mixed_bf16"
        return p

    def compute_dtype(self) -> torch.dtype:
        """The model's compute dtype, as LuminaTransformer.dtype in the
        JAX package derives it (from the training precision)."""
        return torch.bfloat16 if "bf16" in self.resolve_precision() else (
            torch.float32
        )


class ConfigPresets:
    """The JAX package's presets that the port's slice serves. Each keeps
    the JAX preset's architecture fields; pass `use_moe=False` (the CLI's
    `--dense`) to serve the dense model at the preset's widths."""

    @staticmethod
    def debug() -> Config:
        return Config(
            vocab_size=1024,
            hidden_size=128,
            num_layers=2,
            num_heads=2,
            num_kv_heads=1,
            seq_length=256,
            intermediate_size=256,
            use_moe=True,
        )

    @staticmethod
    def debug_300m() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=768,
            num_layers=6,
            num_heads=4,
            num_kv_heads=2,
            seq_length=1024,
            use_moe=True,
        )

    @staticmethod
    def b1() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=2048,
            num_layers=16,
            num_heads=16,
            num_kv_heads=4,
            seq_length=2048,
            use_moe=True,
        )

    _PRESETS = ("debug", "debug_300m", "b1")

    @classmethod
    def available(cls) -> List[str]:
        return list(cls._PRESETS)

    @classmethod
    def get(cls, name: str, **overrides: Any) -> Config:
        if name not in cls._PRESETS:
            raise ValueError(
                f"Unknown preset: {name}. Available: {cls.available()}"
            )
        return dataclasses.replace(getattr(cls, name)(), **overrides)


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """The port's device rule: None means the card. Raises when CUDA is
    absent; only an explicit CPU device runs on the CPU (the tests)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev
