"""Chinchilla compute-optimal scaling + convergence detection (the port's
copy of luminaai_tpu/training/scaler.py).

Covers the reference ChinchillaScaler (ref: Src/Main_Scripts/training/
chinchilla_scaler.py — optimal token budget = tokens_per_param × N, epoch/
step derivation from dataset size, convergence detector with patience).
Pure host-side planning: it shapes the step budget the Trainer runs to;
nothing here touches the device. The adaptive curriculum and the
compute-efficiency tracker come with the orchestrator that calls them
(ROADMAP A5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from luminaai_tpu_torch.config import Config


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
