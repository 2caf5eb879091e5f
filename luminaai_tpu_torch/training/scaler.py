"""Chinchilla compute-optimal scaling, convergence detection, the
adaptive curriculum and compute-efficiency tracking (the port's copy of
luminaai_tpu/training/scaler.py).

Covers the reference ChinchillaScaler (ref: Src/Main_Scripts/training/
chinchilla_scaler.py — optimal token budget = tokens_per_param × N, epoch/
step derivation from dataset size, convergence detector with patience,
learning-velocity curriculum, compute-efficiency tracking). Pure host-side
planning: nothing here touches the device.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from luminaai_tpu_torch.config import Config

# Dense bf16 tensor-core peak of an H100 SXM, FLOP/s (the figure PERF.md
# and chip_smoke.py divide model FLOPs by).
H100_BF16_PEAK_FLOPS = 989e12


@dataclass
class ScalingPlan:
    """Resolved training budget (ref chinchilla_scaler.py budget calc)."""

    total_params: int
    active_params: int
    optimal_tokens: int
    tokens_per_step: int
    recommended_steps: int
    recommended_epochs: float
    dataset_tokens: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class ChinchillaScaler:
    """Compute-optimal budget planning for a config + dataset size."""

    def __init__(self, config: Config):
        self.config = config

    def plan(self, dataset_tokens: Optional[int] = None) -> ScalingPlan:
        cfg = self.config
        total = cfg.estimate_parameters()
        active = cfg.estimate_active_parameters()
        # Chinchilla: ~20 tokens per parameter; for MoE, scale by ACTIVE
        # params (the FLOPs driver), matching ref MoE-aware budgeting.
        basis = active if cfg.use_moe else total
        optimal_tokens = int(cfg.tokens_per_param * basis)
        tokens_per_step = cfg.batch_size * cfg.seq_length
        steps = max(1, optimal_tokens // tokens_per_step)
        epochs = (
            optimal_tokens / dataset_tokens if dataset_tokens else float("nan")
        )
        return ScalingPlan(
            total_params=total,
            active_params=active,
            optimal_tokens=optimal_tokens,
            tokens_per_step=tokens_per_step,
            recommended_steps=steps,
            recommended_epochs=round(epochs, 2) if dataset_tokens else 0.0,
            dataset_tokens=dataset_tokens,
        )

    def apply(self, dataset_tokens: Optional[int] = None) -> int:
        """Set config.max_steps from the plan (ref applies to epochs).
        Returns the step budget."""
        plan = self.plan(dataset_tokens)
        self.config.max_steps = plan.recommended_steps
        return plan.recommended_steps


class AdaptiveCurriculum:
    """Learning-velocity → difficulty signal (ref chinchilla_scaler.py:155
    AdaptiveCurriculumManager).

    Velocity is the recent mean per-update loss reduction. Difficulty in
    [0.2, 0.9] rises while the model is learning fast and falls back
    toward easy data when progress stalls. The orchestrator applies it:
    PackedDataset's length-quantile curriculum admits documents up to the
    difficulty quantile of the length distribution at the next epoch.
    """

    def __init__(self, window: int = 50, recent: int = 10):
        self.window = window
        self.recent = recent
        self._velocity: List[float] = []
        self._prev_loss: Optional[float] = None

    def update(self, loss: float) -> None:
        if not math.isfinite(loss):
            return
        if self._prev_loss is not None:
            self._velocity.append(self._prev_loss - loss)
            if len(self._velocity) > self.window:
                self._velocity = self._velocity[-self.window:]
        self._prev_loss = loss

    def difficulty(self) -> float:
        """Recommended difficulty in [0.2, 0.9]; 0.3 until warmed up. The
        two branches meet at velocity 0, so the map is continuous."""
        if len(self._velocity) < self.recent:
            return 0.3
        v = float(np.mean(self._velocity[-self.recent:]))
        if v >= 0.0:
            return min(0.9, 0.5 + v * 20.0)
        return max(0.2, 0.5 - abs(v) * 10.0)


class ConvergenceDetector:
    """Early-stop signal on flattening eval loss (ref convergence detector).

    Relative-improvement test with patience, plus a minimum-steps guard so
    warmup noise never triggers it.
    """

    def __init__(
        self,
        patience: int = 5,
        min_relative_improvement: float = 1e-3,
        min_steps: int = 100,
    ):
        self.patience = patience
        self.min_rel = min_relative_improvement
        self.min_steps = min_steps
        self.best: Optional[float] = None
        self.stale = 0
        self.history: List[float] = []

    def update(self, eval_loss: float, step: int) -> bool:
        """Returns True when converged (stop recommended)."""
        self.history.append(eval_loss)
        if self.best is None or eval_loss < self.best * (1.0 - self.min_rel):
            self.best = eval_loss
            self.stale = 0
            return False
        if step < self.min_steps:
            # Warmup noise must not bank staleness toward the patience
            # budget — only count once past the minimum-steps guard.
            self.stale = 0
            return False
        self.stale += 1
        return self.stale >= self.patience


@dataclass
class ComputeEfficiencyTracker:
    """Achieved vs peak FLOPs (MFU) (ref compute-efficiency tracker).

    Peak defaults to the H100's dense bf16 tensor-core rate (989 TFLOP/s
    per card); pass `peak_flops` for other parts. Model FLOPs use the
    standard 6·N·T transformer estimate on ACTIVE params.
    """

    active_params: int
    n_chips: int = 1
    peak_flops: float = H100_BF16_PEAK_FLOPS
    _samples: List[Dict[str, float]] = field(default_factory=list)

    def record(self, tokens: int, seconds: float) -> Dict[str, float]:
        model_flops = 6.0 * self.active_params * tokens
        achieved = model_flops / max(seconds, 1e-9)
        mfu = achieved / (self.peak_flops * self.n_chips)
        sample = {
            "tokens_per_sec": tokens / max(seconds, 1e-9),
            "tflops_per_sec": achieved / 1e12,
            "mfu": mfu,
            "ts": time.time(),
        }
        self._samples.append(sample)
        return sample

    def summary(self) -> Dict[str, float]:
        if not self._samples:
            return {}
        n = len(self._samples)
        return {
            "mean_mfu": sum(s["mfu"] for s in self._samples) / n,
            "mean_tokens_per_sec": sum(s["tokens_per_sec"]
                                       for s in self._samples) / n,
            "samples": n,
        }
