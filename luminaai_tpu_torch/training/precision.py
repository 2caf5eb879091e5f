"""Precision plan of a training run (trimmed port of luminaai_tpu/training/precision.py).

'mixed' means bf16 compute with fp32 parameters, gradients and optimizer
state, exactly how the model modules are written (a trainable build keeps
fp32 parameters and casts them to the compute dtype at each use). The
casts stay explicit in the layers: there is no autocast context and no
loss scaling (bf16 has fp32's exponent range). fp16 modes alias to bf16
(Config.resolve_precision).
"""

from __future__ import annotations

import dataclasses

import torch

from luminaai_tpu_torch.config import Config


@dataclasses.dataclass
class PrecisionPlan:
    """Resolved dtypes for one training run."""

    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype  # logits and loss accumulate in fp32 always


class PrecisionManager:
    """Resolve `config.precision` into a PrecisionPlan."""

    def __init__(self, config: Config):
        compute = config.compute_dtype()  # what the model's layers use
        name = config.resolve_precision() if compute == torch.bfloat16 else (
            "fp32"
        )
        self.plan = PrecisionPlan(name, torch.float32, compute, torch.float32)
