"""Adaptive training orchestration (port of luminaai_tpu/training/orchestrator.py).

Covers the reference AdaptiveTrainingOrchestrator stack (ref: Src/
Main_Scripts/training/orchestrator.py — :79 MetaLearningEngine, :303
AdaptiveHyperparameterOptimizer, :389 ArchitectureEvolution, :453
RealTimeAnalytics, :630 ProductionMonitoring, :673 orchestrator core).
The orchestrator rides the Trainer's `step_callback`, synchronous with the
loop, so interventions (which rebuild the train step or the model) never
race a step, and there is no cross-thread state to lock.

All decisions are host-side numpy on scalars the train step already
produced, the same code as the JAX module's, so the same metric stream
gives the same decisions on both sides. Every intervention carries a
reason + confidence and respects a cooldown (intervention_cooldown_steps).

Over a mesh of more than one rank (the Trainer's `mesh`) every rank
observes the step's metrics, which the sharded step already reduced over
the ranks; the readings that are a rank's own (step times, tokens/s,
memory) are reduced first (one all-reduce: the slowest rank's times and
throughput, the largest memory). At a health check rank 0 alone decides,
one broadcast carries its decision (or none) and the healthy step the
rollback fences to, and every rank executes it, so every rank takes the
same decision at the same step and rebuilds its shards alike.
"""

from __future__ import annotations

import json
import logging
import math
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.training.scaler import AdaptiveCurriculum

logger = logging.getLogger(__name__)


@dataclass
class AdaptiveDecision:
    """One proposed intervention (ref orchestrator.py:70)."""

    kind: str  # lr_adjust | rollback | add_expert | prune_expert |
    # clip_tighten | capacity_* | temperature_* | batch_size |
    # expert_dropout | weight_decay
    params: Dict[str, Any]
    reason: str
    confidence: float  # 0..1
    step: int
    applied: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class AdaptiveHyperparameterOptimizer:
    """LR adjustment rules (ref orchestrator.py:303).

    Plateau → raise LR; divergence → cut LR; steady progress → mild raise;
    high grad norms → cut. Operates on the recent loss/grad windows.
    """

    def __init__(self, min_gap_steps: int = 50):
        self.buffer: deque = deque(maxlen=50)
        self.last_adjustment_step = -10**9
        self.min_gap_steps = min_gap_steps

    def observe(self, step: int, loss: float, grad_norm: float) -> None:
        self.buffer.append((step, loss, grad_norm))

    def propose(self, step: int) -> Optional[Dict[str, Any]]:
        if step - self.last_adjustment_step < self.min_gap_steps:
            return None
        if len(self.buffer) < 20:
            return None
        losses = [l for _, l, _ in self.buffer]
        very_recent = losses[-5:]
        older = losses[-15:-10]
        recent_mean = float(np.mean(very_recent))
        older_mean = float(np.mean(older)) if older else recent_mean
        recent_std = float(np.std(very_recent))
        grad_norms = [g for _, _, g in list(self.buffer)[-5:]]

        if float(np.mean(grad_norms)) > 10.0:
            return self._mark(step, dict(
                action="decrease", factor=0.7, confidence=0.7,
                reasoning=f"high grad norms (mean {np.mean(grad_norms):.1f})",
            ))
        if recent_mean > older_mean + 0.3:
            return self._mark(step, dict(
                action="decrease", factor=0.5, confidence=0.8,
                reasoning=f"loss diverging {older_mean:.3f}->{recent_mean:.3f}",
            ))
        if recent_std < 0.01 and recent_mean > 0.5:
            return self._mark(step, dict(
                action="increase", factor=1.5, confidence=0.5,
                reasoning=f"loss plateau (std {recent_std:.4f})",
            ))
        if recent_mean < older_mean - 0.1 and recent_std < 0.05:
            return self._mark(step, dict(
                action="increase", factor=1.2, confidence=0.4,
                reasoning="steady improvement, accelerating",
            ))
        return None

    def _mark(self, step, d):
        self.last_adjustment_step = step
        return d


class ArchitectureEvolution:
    """Expert add/prune decisions from utilization (ref orchestrator.py:389).

    Utilization is the per-expert load factor (1.0 == balanced) the MoE layer
    already reports; windows are averaged to ignore batch noise.
    """

    def __init__(self, window: int = 20):
        self.util_window: deque = deque(maxlen=window)
        self.drop_window: deque = deque(maxlen=window)

    def observe(
        self, expert_utilization: np.ndarray, drop_rate: float = 0.0
    ) -> None:
        self.util_window.append(np.asarray(expert_utilization, dtype=np.float64))
        self.drop_window.append(float(drop_rate))

    def reset(self) -> None:
        """Clear windows after an applied evolution — old observations have
        the previous expert count's shape and meaning."""
        self.util_window.clear()
        self.drop_window.clear()

    def propose(self) -> Optional[Dict[str, Any]]:
        if len(self.util_window) < self.util_window.maxlen:
            return None
        if len({u.shape for u in self.util_window}) != 1:
            # Expert count changed mid-window without a reset() — drop the
            # stale prefix rather than crash the training loop.
            self.reset()
            return None
        util = np.mean(np.stack(self.util_window), axis=0)
        drop = float(np.mean(self.drop_window))
        E = util.size
        # util is the load factor per expert (1.0 == perfectly balanced);
        # capacity pressure shows up as token drops, not as util (which
        # normalizes to ~1 by construction).
        if drop > 0.10 and util.min() > 0.5:
            return dict(
                action="add_expert", confidence=0.5,
                reasoning=(
                    f"capacity-bound: {drop:.0%} tokens dropped with balanced "
                    f"experts (min util {util.min():.2f})"
                ),
            )
        dead = np.where(util < 0.05)[0]
        if dead.size > 0 and E > 2:
            return dict(
                action="prune_expert", expert_idx=int(dead[0]), confidence=0.6,
                reasoning=f"expert {int(dead[0])} utilization {util[dead[0]]:.3f}",
            )
        return None


class MoERoutingOptimizer:
    """Runtime capacity-factor / routing-temperature tuning
    (ref trainer.py:1450 adjust_capacity_factor, :1471
    adjust_routing_temperature, driven by trainer.py:804's utilization
    tracking). Sustained token drops → more capacity; sustained imbalance →
    hotter routing; sustained slack → reclaim capacity (it is live compute:
    every slot runs through the expert FFNs whether used or not).
    """

    def __init__(self, window: int = 10):
        self.drop_window: deque = deque(maxlen=window)
        self.util_window: deque = deque(maxlen=window)

    def observe(self, drop_rate: float, expert_utilization) -> None:
        self.drop_window.append(float(drop_rate))
        if expert_utilization is not None:
            self.util_window.append(
                np.asarray(expert_utilization, dtype=np.float64)
            )

    def reset(self) -> None:
        self.drop_window.clear()
        self.util_window.clear()

    def propose(self, config: Config) -> Optional[Dict[str, Any]]:
        if len(self.drop_window) < self.drop_window.maxlen:
            return None
        drop = float(np.mean(self.drop_window))
        cf = config.capacity_factor
        if drop > 0.15 and cf < 2.0:
            return dict(
                action="capacity_up", new_value=round(min(2.0, cf + 0.25), 2),
                confidence=0.7,
                reasoning=f"drop rate {drop:.1%} sustained at cf={cf}",
            )
        if drop < 0.005 and cf > 1.0:
            return dict(
                action="capacity_down", new_value=round(max(1.0, cf - 0.25), 2),
                confidence=0.4,
                reasoning=f"drop rate {drop:.2%}: capacity slack at cf={cf}",
            )
        if self.util_window and len(self.util_window) == self.util_window.maxlen:
            if len({u.shape for u in self.util_window}) != 1:
                self.reset()  # expert count changed mid-window
                return None
            util = np.mean(np.stack(self.util_window), axis=0)
            imbalance = float(np.std(util))  # 0 == perfectly balanced
            temp = config.routing_temperature
            if imbalance > 0.6 and temp < 2.0:
                return dict(
                    action="temperature_up",
                    new_value=round(min(2.0, temp * 1.25), 2),
                    confidence=0.5,
                    reasoning=f"expert imbalance (std {imbalance:.2f})",
                )
            if imbalance < 0.1 and temp > 1.0:
                return dict(
                    action="temperature_down",
                    new_value=round(max(1.0, temp / 1.25), 2),
                    confidence=0.4,
                    reasoning=f"routing balanced (std {imbalance:.2f}); "
                              "relaxing temperature toward 1.0",
                )
        return None


class BatchSizeOptimizer:
    """Effective-batch adaptation from gradient noise (ref trainer.py:1626
    adjust_batch_size's 'dynamic curriculum' role).

    Noisy gradients at a loss plateau mean the batch is too small for the
    current loss surface; doubling the global batch raises the
    signal-to-noise without touching LR. Disabled by default
    (config.enable_batch_size_optimization) since every change rebuilds the
    step.
    """

    def __init__(self, window: int = 20, max_growth: int = 4):
        self.buffer: deque = deque(maxlen=window)
        self.max_growth = max_growth
        self._initial_batch: Optional[int] = None

    def observe(self, loss: float, grad_norm: float) -> None:
        self.buffer.append((loss, grad_norm))

    def propose(self, config: Config) -> Optional[Dict[str, Any]]:
        if self._initial_batch is None:
            self._initial_batch = config.batch_size
        if len(self.buffer) < self.buffer.maxlen:
            return None
        losses = [l for l, _ in self.buffer]
        grads = [g for _, g in self.buffer]
        loss_flat = float(np.std(losses[-10:])) < 0.02
        g_mean = float(np.mean(grads))
        g_rel_std = float(np.std(grads)) / max(g_mean, 1e-9)
        if (
            loss_flat
            and g_rel_std > 0.5
            and config.batch_size * 2 <= self._initial_batch * self.max_growth
        ):
            self.buffer.clear()
            return dict(
                action="batch_up", new_value=config.batch_size * 2,
                confidence=0.5,
                reasoning=(
                    f"plateau with noisy grads (rel std {g_rel_std:.2f}): "
                    "raising effective batch"
                ),
            )
        return None


class RealTimeAnalytics:
    """Loss-dynamics fitting, convergence prediction, anomaly detection
    (ref orchestrator.py:453)."""

    def __init__(self):
        self.buffer: deque = deque(maxlen=1000)
        self.thresholds = {
            "loss_spike_std_multiplier": 2.0,
            "loss_spike_min_increase": 0.1,
            "gradient_explosion_threshold": 100.0,
            "gradient_explosion_relative": 10.0,
            "expert_collapse_threshold": 0.05,
            "min_buffer_size": 50,
            "recent_window": 10,
        }

    def update_threshold(self, name: str, value: float) -> None:
        if name in self.thresholds:
            self.thresholds[name] = value

    def observe(self, step: int, loss: float, grad_norm: float,
                expert_utilization: Optional[np.ndarray] = None) -> None:
        self.buffer.append(
            {"step": step, "loss": loss, "grad_norm": grad_norm,
             "expert_utilization": expert_utilization}
        )

    # -- dynamics (ref :497 analyze_loss_dynamics) ------------------------
    def analyze_loss_dynamics(self) -> Optional[Dict[str, Any]]:
        if len(self.buffer) < 10:
            return None
        recent = list(self.buffer)[-100:]
        losses = np.array([m["loss"] for m in recent], dtype=np.float64)
        steps = np.array([m["step"] for m in recent], dtype=np.float64)
        if not np.all(np.isfinite(losses)):
            return None
        l_mean, l_std = losses.mean(), losses.std() + 1e-8
        s_mean, s_std = steps.mean(), steps.std() + 1e-8
        nl, ns = (losses - l_mean) / l_std, (steps - s_mean) / s_std
        try:
            coeffs = np.polyfit(ns, nl, 2)
        except np.linalg.LinAlgError:
            slope = (nl[-1] - nl[0]) / max(ns[-1] - ns[0], 1e-9)
            coeffs = np.array([0.0, slope, nl[0]])
        return {
            "trend_direction": "decreasing" if coeffs[1] < 0 else "increasing",
            "trend_strength": abs(float(coeffs[1])),
            "curvature": "concave_up" if coeffs[0] > 0 else "concave_down",
            "predicted_convergence_step": self._predict_convergence(
                coeffs, steps[-1], s_mean, s_std, l_std
            ),
        }

    def _predict_convergence(self, coeffs, current_step, s_mean, s_std, l_std):
        """Quadratic extrapolation to d(loss)/d(step) < 1e-4 (ref :479)."""
        future = np.arange(current_step, current_step + 10_000, 10.0)
        nf = (future - s_mean) / s_std
        dl = (2 * coeffs[0] * nf + coeffs[1]) * (l_std / s_std)
        flat = np.where(np.abs(dl) < 1e-4)[0]
        return int(future[flat[0]]) if flat.size else None

    # -- trajectory (ref orchestrator.py:253 predict_training_trajectory) --
    def predict_training_trajectory(self) -> Optional[Dict[str, Any]]:
        """Classify where training is heading from the recent loss slope.

        Ref buckets by raw slope with a gap that mislabels slow convergence
        as divergence; here the sign decides the class and |slope| <= eps is
        the plateau band."""
        if len(self.buffer) < 10:
            return None
        losses = np.array(
            [m["loss"] for m in list(self.buffer)[-10:]], dtype=np.float64
        )
        if not np.all(np.isfinite(losses)):
            return None
        slope = float(np.polyfit(np.arange(losses.size), losses, 1)[0])
        if abs(slope) <= 1e-4:
            return {
                "prediction": "plateau",
                "confidence": 0.8,
                "suggested_action": "increase_lr_or_change_architecture",
                "expected_improvement": 0.1,
                "loss_slope": slope,
            }
        if slope < 0:
            return {
                "prediction": "healthy_convergence",
                "confidence": 0.9,
                "suggested_action": "continue",
                "expected_improvement": abs(slope) * 100,
                "loss_slope": slope,
            }
        return {
            "prediction": "potential_divergence",
            "confidence": 0.7,
            "suggested_action": "reduce_lr_or_add_regularization",
            "expected_improvement": 0.05,
            "loss_slope": slope,
        }

    # -- anomalies (ref :555 detect_training_anomalies) -------------------
    def detect_anomalies(self) -> List[Dict[str, Any]]:
        t = self.thresholds
        if len(self.buffer) < t["min_buffer_size"]:
            return []
        buf = list(self.buffer)
        rw = int(t["recent_window"])
        recent = [m["loss"] for m in buf[-rw:]]
        hist = [m["loss"] for m in buf[-50:-rw]]
        anomalies: List[Dict[str, Any]] = []
        if hist:
            r_mean, h_mean = float(np.mean(recent)), float(np.mean(hist))
            h_std = float(np.std(hist))
            inc = r_mean - h_mean
            if (
                r_mean > h_mean + t["loss_spike_std_multiplier"] * h_std
                and inc > t["loss_spike_min_increase"]
            ):
                anomalies.append({
                    "type": "loss_spike",
                    "severity": "critical" if inc > 1.0 else "high",
                    "description": f"loss {h_mean:.3f} -> {r_mean:.3f} (+{inc:.3f})",
                })
        gn = buf[-1]["grad_norm"]
        hist_gn = [m["grad_norm"] for m in buf[-50:-rw] if m["grad_norm"] > 0]
        explosion = gn > t["gradient_explosion_threshold"] or (
            bool(hist_gn)
            and gn > float(np.mean(hist_gn)) * t["gradient_explosion_relative"]
        )
        if explosion:
            anomalies.append({
                "type": "gradient_explosion", "severity": "critical",
                "description": f"grad norm {gn:.2f}",
            })
        util = buf[-1].get("expert_utilization")
        if util is not None and util.size:
            if (
                util.min() < t["expert_collapse_threshold"]
                and util.max() > 0.5 * util.size
            ):
                anomalies.append({
                    "type": "expert_collapse", "severity": "high",
                    "description": (
                        f"expert imbalance min={util.min():.3f} max={util.max():.3f}"
                    ),
                })
        return anomalies


def _local_reading(key: str) -> bool:
    """Whether a logged metric is a rank's own reading (wall time,
    throughput, memory), not a value the step reduced over the ranks."""
    return (key.endswith("_seconds") or key.startswith("tokens_per_sec")
            or "memory" in key)


def _process_rank() -> int:
    """This process's rank in a torch.distributed group (0 without one)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # pragma: no cover
        pass
    return 0


class MetaLearningEngine:
    """Cross-run learning: record outcomes, suggest starting hyperparameters
    (ref orchestrator.py:79). History persists as jsonl next to output_dir.
    """

    def __init__(self, history_path: str = "experiments/meta_history.jsonl"):
        self.path = Path(history_path)
        self.runs: List[Dict[str, Any]] = []
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                try:
                    self.runs.append(json.loads(line))
                except json.JSONDecodeError:
                    continue

    def record_training_outcome(
        self, config: Config, final_metrics: Dict[str, float]
    ) -> None:
        if _process_rank() != 0:
            return  # one history line per run, not per process
        entry = {
            "ts": time.time(),
            "params": config.estimate_parameters(),
            "lr": config.learning_rate,
            "batch_size": config.batch_size,
            "use_moe": config.use_moe,
            "num_experts": config.num_experts if config.use_moe else 0,
            "final_loss": final_metrics.get("eval_loss", final_metrics.get("loss")),
            "success_score": self._success_score(final_metrics),
        }
        self.runs.append(entry)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self.path.open("a") as f:
            f.write(json.dumps(entry) + "\n")

    @staticmethod
    def _success_score(metrics: Dict[str, float]) -> float:
        loss = metrics.get("eval_loss", metrics.get("loss"))
        if loss is None or not math.isfinite(loss):
            return 0.0
        return 1.0 / (1.0 + loss)

    def suggest_hyperparameters(self, config: Config) -> Dict[str, Any]:
        """Start-of-run suggestion from the most similar successful runs
        (ref :160,:200 similarity by param count / arch family)."""
        target_p = config.estimate_parameters()
        similar = [
            r for r in self.runs
            if r.get("use_moe") == config.use_moe
            and 0.2 < (r.get("params", 1) / max(target_p, 1)) < 5.0
            and r.get("success_score", 0) > 0.2
        ]
        if not similar:
            return {}
        best = sorted(similar, key=lambda r: -r["success_score"])[:3]
        return {
            "learning_rate": float(np.median([r["lr"] for r in best])),
            "batch_size": int(np.median([r["batch_size"] for r in best])),
            "based_on_runs": len(best),
        }


class ProductionMonitoring:
    """Drift + safety heuristics over generated text (ref orchestrator.py:630,
    whose implementation was a random-score placeholder; this one measures
    real signals: token-distribution Jensen-Shannon drift and lexicon-based
    safety flags)."""

    def monitor_semantic_drift(
        self, generated_texts: List[str], reference_corpus: List[str]
    ) -> Optional[Dict[str, Any]]:
        if not generated_texts or not reference_corpus:
            return None
        p = self._word_dist(generated_texts)
        q = self._word_dist(reference_corpus)
        vocab = set(p) | set(q)
        pv = np.array([p.get(w, 1e-9) for w in vocab])
        qv = np.array([q.get(w, 1e-9) for w in vocab])
        pv, qv = pv / pv.sum(), qv / qv.sum()
        m = 0.5 * (pv + qv)
        js = 0.5 * np.sum(pv * np.log(pv / m)) + 0.5 * np.sum(qv * np.log(qv / m))
        drift = float(js / math.log(2))  # 0 (identical) .. 1 (disjoint)
        if drift > 0.3:
            return {
                "alert": "semantic_drift", "score": drift,
                "severity": "high" if drift > 0.6 else "medium",
                "recommendation": "distribution shift vs reference corpus",
            }
        return None

    _FLAG_TERMS = (
        "kill yourself", "bomb making", "child sexual", "credit card number",
        "social security number",
    )

    def track_safety_metrics(
        self, generated_content: List[str]
    ) -> Optional[List[Dict[str, Any]]]:
        alerts = []
        for text in generated_content:
            low = text.lower()
            hits = [t for t in self._FLAG_TERMS if t in low]
            if hits:
                alerts.append({
                    "metric": "flagged_content", "terms": hits,
                    "severity": "high", "excerpt": text[:80],
                })
        return alerts or None

    @staticmethod
    def _word_dist(texts: List[str]) -> Dict[str, float]:
        counts: Dict[str, float] = {}
        for t in texts:
            for w in t.lower().split():
                counts[w] = counts.get(w, 0) + 1
        return counts


class AdaptiveTrainingOrchestrator:
    """Core loop: observe → analyze → decide → intervene (ref :673).

    Attach to a Trainer and call `run()`; it installs itself as the
    trainer's step callback, evaluates every `health_check_interval` steps,
    and dispatches at most one intervention per cooldown window.
    """

    def __init__(self, trainer, config: Optional[Config] = None):
        self.trainer = trainer
        self.config = config or trainer.config
        self.hyper = AdaptiveHyperparameterOptimizer()
        self.evolution = ArchitectureEvolution()
        self.routing = MoERoutingOptimizer()
        self.batcher = BatchSizeOptimizer()
        self.analytics = RealTimeAnalytics()
        self.meta = MetaLearningEngine(
            f"{self.config.output_dir}/meta_history.jsonl"
        )
        self.production = ProductionMonitoring()
        self.curriculum = AdaptiveCurriculum()
        self._applied_difficulty: Optional[float] = None
        self.decisions: List[AdaptiveDecision] = []
        self._last_intervention_step = -10**9
        self._last_health_check_step = 0
        # Rollback fence: last step where loss looked healthy (near its
        # running best). Periodic saves continue during a *finite* loss
        # spike, so "latest checkpoint" may hold diverged weights — restore
        # at/before this step instead.
        self._best_loss = float("inf")
        self._last_healthy_step = 0
        self._collapse_free_checks = 0
        self._edropout_enabled_by_me = False
        self._base_lr = self.config.learning_rate
        self.analytics.thresholds["gradient_explosion_threshold"] = (
            self.config.grad_norm_threshold
        )
        self.analytics.thresholds["expert_collapse_threshold"] = (
            self.config.expert_collapse_threshold
        )

    # -- wiring -----------------------------------------------------------
    def run(self, oom_protect: bool = True) -> Dict[str, Any]:
        """Train under adaptive control; returns trainer summary + decisions.

        oom_protect wraps the loop in the trainer's backoff ladder (ref
        Main.py:292 wrap_orchestrator_with_oom_protection).
        """
        suggestion = self.meta.suggest_hyperparameters(self.config)
        if suggestion:
            logger.info("meta-learning suggestion (informational): %s", suggestion)
        self.trainer.step_callback = self.on_metrics
        summary = (
            self.trainer.train_with_oom_protection()
            if oom_protect
            else self.trainer.train()
        )
        self.meta.record_training_outcome(
            self.config, summary.get("final_metrics", {})
        )
        summary["adaptive_decisions"] = [d.to_dict() for d in self.decisions]
        summary["trajectory"] = self.analytics.predict_training_trajectory()
        return summary

    # -- over a mesh ----------------------------------------------------------
    def _mesh(self):
        mesh = getattr(self.trainer, "mesh", None)
        return mesh if mesh is not None and mesh.size > 1 else None

    def _agreed_readings(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """The metrics with each rank's own readings reduced over the
        ranks: the largest times and memory, the smallest throughput."""
        keys = sorted(k for k, v in metrics.items()
                      if isinstance(v, float) and _local_reading(k))
        if not keys or self._mesh() is None:
            return metrics
        import torch
        import torch.distributed as dist

        # MAX over -x gives the smallest throughput.
        sign = [-1.0 if k.startswith("tokens_per_sec") else 1.0
                for k in keys]
        t = torch.tensor([s * metrics[k] for s, k in zip(sign, keys)],
                         dtype=torch.float64, device=self._mesh().device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out = dict(metrics)
        out.update({k: s * float(v) for s, k, v in zip(sign, keys,
                                                       t.tolist())})
        return out

    def _agreed(self, decision: Optional[AdaptiveDecision]
                ) -> Optional[AdaptiveDecision]:
        """Rank 0's decision (and its rollback fence) on every rank."""
        if self._mesh() is None:
            return decision
        import torch.distributed as dist

        box = [(decision, self._last_healthy_step)]
        dist.broadcast_object_list(box, src=0)
        decision, self._last_healthy_step = box[0]
        return decision

    # -- per-interval hook -------------------------------------------------
    def on_metrics(self, step: int, metrics: Dict[str, float]) -> None:
        metrics = self._agreed_readings(metrics)
        loss = metrics.get("loss", float("nan"))
        grad_norm = metrics.get("grad_norm", 0.0)
        util = metrics.get("expert_utilization")
        util = np.asarray(util) if util is not None else None
        self.analytics.observe(step, loss, grad_norm, util)
        self.hyper.observe(step, loss, grad_norm)
        self.batcher.observe(loss, grad_norm)
        self.curriculum.update(loss)
        if util is not None:
            self.evolution.observe(util, metrics.get("moe_drop_rate", 0.0))
        if self.config.use_moe and "moe_drop_rate" in metrics:
            self.routing.observe(metrics["moe_drop_rate"], util)
        if math.isfinite(loss):
            if loss < self._best_loss:
                self._best_loss = loss
            if loss <= self._best_loss + max(0.25, 0.1 * abs(self._best_loss)):
                self._last_healthy_step = step

        # Elapsed-based cadence: callbacks arrive at the trainer's log
        # granularity, which need not divide health_check_interval.
        if step - self._last_health_check_step < self.config.health_check_interval:
            return
        self._last_health_check_step = step
        decision = None
        if _process_rank() == 0 or self._mesh() is None:
            decision = self._gated(step, self._decide(step))
        decision = self._agreed(decision)
        if decision is not None:
            self._execute(decision)

    def _gated(self, step: int, decision: Optional[AdaptiveDecision]
               ) -> Optional[AdaptiveDecision]:
        """The decision past the cooldown and the confidence floor."""
        if decision is None:
            return None
        if step - self._last_intervention_step < self.config.intervention_cooldown_steps:
            logger.info("intervention suppressed by cooldown: %s", decision.kind)
            return None
        if decision.confidence < self.config.min_override_threshold:
            logger.info(
                "intervention below confidence floor: %s (%.2f)",
                decision.kind, decision.confidence,
            )
            return None
        return decision

    # -- decision fusion (ref :929 _process_real_time_metrics) -------------
    def _decide(self, step: int) -> Optional[AdaptiveDecision]:
        anomalies = self.analytics.detect_anomalies()
        if any(a["type"] == "expert_collapse" for a in anomalies):
            self._collapse_free_checks = 0
        else:
            self._collapse_free_checks += 1
        for a in anomalies:
            if a["severity"] == "critical" and self.config.emergency_override_enabled:
                kind = (
                    "rollback" if a["type"] == "loss_spike" else "lr_emergency"
                )
                return AdaptiveDecision(
                    kind=kind, params={"anomaly": a}, reason=a["description"],
                    confidence=0.9, step=step,
                )
            if a["type"] == "expert_collapse":
                self._collapse_free_checks = 0
                # Gate on the TRAINER's config: that is the object the
                # intervention mutates (self.config may be a caller-supplied
                # copy), and a mismatch here would re-fire + rebuild every
                # health check.
                if (
                    self.trainer.config.use_moe
                    and self.trainer.config.expert_dropout_rate == 0.0
                ):
                    # First response: force routing to spread (ref
                    # trainer.py:1495); clip tightening is the follow-up if
                    # collapse persists with dropout already on.
                    return AdaptiveDecision(
                        kind="expert_dropout", params={"rate": 0.1},
                        reason=a["description"], confidence=0.6, step=step,
                    )
                return AdaptiveDecision(
                    kind="clip_tighten", params={"anomaly": a},
                    reason=a["description"], confidence=0.5, step=step,
                )

        if (
            self._edropout_enabled_by_me
            and self.trainer.config.expert_dropout_rate > 0.0
            and self._collapse_free_checks >= 5
        ):
            # Dropout served its purpose; leaving the Bernoulli mask on for
            # the rest of the run would keep perturbing healthy routing.
            # Only reverts a rate THIS orchestrator enabled — a user-config
            # rate is policy, not an intervention.
            return AdaptiveDecision(
                kind="expert_dropout", params={"rate": 0.0},
                reason=(
                    f"expert collapse cleared for {self._collapse_free_checks}"
                    " consecutive health checks"
                ),
                confidence=0.7, step=step,
            )

        warmup_steps = int(
            self.trainer.total_steps * self.config.warmup_ratio
        )
        in_body = (
            step > warmup_steps
            and step < 0.9 * self.trainer.total_steps
        )
        if (
            self.config.enable_adaptive_lr
            and self.config.allow_scheduler_override
            and in_body
        ):
            # Never second-guess the schedule during warmup (the plateau
            # heuristic would read the tiny ramping LR as "stuck" and pin
            # training at ~0 LR) or in the terminal decay phase (a plateau
            # at min_lr is the schedule finishing, not a problem).
            prop = self.hyper.propose(step)
            if prop is not None:
                return AdaptiveDecision(
                    kind="lr_adjust",
                    params={"factor": prop["factor"], "action": prop["action"]},
                    reason=prop["reasoning"],
                    confidence=prop.get("confidence", 0.5),
                    step=step,
                )

        if self.config.enable_architecture_evolution:
            prop = self.evolution.propose()
            if prop is not None:
                return AdaptiveDecision(
                    kind=prop["action"],
                    params={k: v for k, v in prop.items() if k != "action"},
                    reason=prop["reasoning"],
                    confidence=prop.get("confidence", 0.5),
                    step=step,
                )

        if self.config.use_moe and self.config.enable_moe_routing_optimization:
            prop = self.routing.propose(self.config)
            if prop is not None:
                return AdaptiveDecision(
                    kind=prop["action"],
                    params={"new_value": prop["new_value"]},
                    reason=prop["reasoning"],
                    confidence=prop.get("confidence", 0.5),
                    step=step,
                )

        if self.config.enable_batch_size_optimization and in_body:
            prop = self.batcher.propose(self.config)
            if prop is not None:
                return AdaptiveDecision(
                    kind="batch_size",
                    params={"new_value": prop["new_value"]},
                    reason=prop["reasoning"],
                    confidence=prop.get("confidence", 0.5),
                    step=step,
                )

        if (
            self.config.enable_mod_capacity_adaptation
            and self.trainer.config.use_mod
        ):
            # Phase-scheduled MoD compute ratio (ref Main.py
            # mod_capacity_adaptation: more computation early, aggressive
            # savings late). Phases split total steps in thirds; fire only
            # when the trainer's live value differs from the target so the
            # rebuild happens once per boundary.
            sched = self.config.mod_capacity_schedule
            phase = min(
                len(sched) - 1,
                int(len(sched) * step / max(1, self.trainer.total_steps)),
            )
            target = float(sched[phase])
            if abs(self.trainer.config.mod_capacity_factor - target) > 1e-6:
                return AdaptiveDecision(
                    kind="mod_capacity",
                    params={"new_value": target},
                    reason=(
                        f"training phase {phase + 1}/{len(sched)}: "
                        f"scheduled MoD compute ratio {target}"
                    ),
                    confidence=0.8,
                    step=step,
                )

        if self.config.enable_adaptive_curriculum and in_body:
            # Learning-velocity curriculum (ref chinchilla_scaler.py:155):
            # re-aim the data loader's difficulty when the recommendation
            # has moved materially from what's applied. Epoch-granular and
            # rebuild-free, so the confidence bar is easy to meet.
            d = self.curriculum.difficulty()
            prev = self._applied_difficulty
            if prev is None or abs(d - prev) >= 0.15:
                return AdaptiveDecision(
                    kind="curriculum",
                    params={"difficulty": round(d, 3)},
                    reason=(
                        "learning velocity recommends difficulty "
                        f"{d:.2f} (applied: "
                        f"{'none' if prev is None else f'{prev:.2f}'})"
                    ),
                    confidence=0.6,
                    step=step,
                )

        if self.config.enable_adaptive_wd and in_body:
            # Slow sustained loss rise that never trips the spike/divergence
            # rules above: add regularization (ref trainer.py:1792's stated
            # use: adapting weight decay to training phase / overfitting).
            # Gate and base read the TRAINER's config — the object the
            # intervention mutates (self.config may be a caller copy).
            wd_now = self.trainer.config.weight_decay
            traj = self.analytics.predict_training_trajectory()
            if (
                traj is not None
                and traj["prediction"] == "potential_divergence"
                and wd_now < 0.1
            ):
                return AdaptiveDecision(
                    kind="weight_decay",
                    params={
                        "new_value": round(
                            min(0.1, max(wd_now, 0.005) * 2), 4
                        )
                    },
                    reason=(
                        f"loss creeping up (slope {traj['loss_slope']:.2e}): "
                        f"{traj['suggested_action']}"
                    ),
                    confidence=0.5,
                    step=step,
                )
        return None

    # -- dispatch (ref :1040 _execute_adaptive_decision) --------------------
    def _execute(self, decision: AdaptiveDecision) -> None:
        t = self.trainer
        kind = decision.kind
        applied = False
        try:
            if kind == "lr_adjust":
                current = self._current_lr()
                new_lr = current * decision.params["factor"]
                new_lr = float(np.clip(new_lr, self.config.min_lr, 1e-1))
                t.adjust_learning_rate(new_lr, reason=decision.reason)
                applied = True
            elif kind == "lr_emergency":
                t.adjust_learning_rate(
                    max(self._current_lr() * 0.1, self.config.min_lr),
                    reason=f"EMERGENCY: {decision.reason}",
                )
                applied = True
            elif kind == "rollback":
                # Fence to the last healthy step: periodic saves keep
                # landing during a finite divergence, so the newest
                # checkpoint may hold spiked weights.
                if t.rollback(
                    to_step=self._last_healthy_step, reason=decision.reason
                ):
                    applied = True
                    self._reset_windows_after_rollback()
                else:
                    # No healthy checkpoint: a newer (spiked) one would only
                    # re-diverge — cut LR instead.
                    logger.warning("no healthy checkpoint; cutting LR instead")
                    t.adjust_learning_rate(
                        max(self._current_lr() * 0.1, self.config.min_lr),
                        reason=f"EMERGENCY (no checkpoint): {decision.reason}",
                    )
                    applied = True
            elif kind in ("add_expert", "prune_expert"):
                applied = t.evolve_experts(
                    kind,
                    expert_idx=decision.params.get("expert_idx"),
                    reason=decision.reason,
                )
                if applied:
                    self.evolution.reset()  # old-shape windows are stale
            elif kind == "clip_tighten":
                t.set_grad_clip(
                    max(0.1, t.config.grad_clip_norm * 0.5),
                    reason=decision.reason,
                )
                applied = True
            elif kind in ("capacity_up", "capacity_down"):
                t.adjust_capacity_factor(
                    decision.params["new_value"], reason=decision.reason
                )
                self.routing.reset()  # window measured the old capacity
                applied = True
            elif kind in ("temperature_up", "temperature_down"):
                t.adjust_routing_temperature(
                    decision.params["new_value"], reason=decision.reason
                )
                self.routing.reset()
                applied = True
            elif kind == "batch_size":
                applied = t.adjust_batch_size(
                    decision.params["new_value"], reason=decision.reason
                )
            elif kind == "mod_capacity":
                t.adjust_mod_capacity(
                    decision.params["new_value"], reason=decision.reason
                )
                applied = (
                    t.config.mod_capacity_factor
                    == decision.params["new_value"]
                )
            elif kind == "expert_dropout":
                t.enable_expert_dropout(
                    decision.params["rate"], reason=decision.reason
                )
                applied = (
                    t.config.expert_dropout_rate == decision.params["rate"]
                )
                if applied:
                    self._edropout_enabled_by_me = decision.params["rate"] > 0
                    self._collapse_free_checks = 0
            elif kind == "weight_decay":
                t.adjust_weight_decay(
                    decision.params["new_value"], reason=decision.reason
                )
                applied = True
            elif kind == "curriculum":
                applied = t.set_data_difficulty(
                    decision.params["difficulty"], reason=decision.reason
                )
                # Remember the target even when the loader has no
                # curriculum hook, so the decision doesn't re-fire on
                # every subsequent health check.
                self._applied_difficulty = decision.params["difficulty"]
            decision.applied = applied
            if applied:
                # An infeasible no-op must not burn the cooldown window.
                # After a rollback, steps replay from the restored point, so
                # anchor the cooldown there (decision.step would push it
                # into the future and over-extend suppression).
                self._last_intervention_step = min(
                    decision.step, t.global_step
                )
        except Exception as e:  # pragma: no cover - defensive
            logger.error("intervention %s failed: %s", kind, e)
        self.decisions.append(decision)
        if self.config.log_lr_decisions:
            logger.info("decision: %s", decision.to_dict())

    def _reset_windows_after_rollback(self) -> None:
        """Observations from the abandoned timeline would poison baselines
        (spike data in history windows, non-monotonic steps)."""
        self.analytics.buffer.clear()
        self.hyper.buffer.clear()
        self.evolution.reset()
        self._last_health_check_step = self.trainer.global_step

    def _current_lr(self) -> float:
        if self.trainer._lr_override is not None:
            return self.trainer._lr_override
        try:
            return float(self.trainer.schedule(self.trainer.global_step))
        except Exception:
            return self._base_lr
