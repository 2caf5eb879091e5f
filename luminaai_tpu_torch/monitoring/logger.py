"""Metrics collection, alerting and training-health monitoring (the port's
copy of luminaai_tpu/monitoring/logger.py, without its optional Weights &
Biases mirror: the port imports torch, numpy and the standard library
only, and the jsonl log is the source of truth on both sides).

Covers the reference monitoring stack (ref: Src/Main_Scripts/monitoring/
logger.py:29 MetricsCollector, :276 TrainingHealthMonitor) — windowed metric
stats, threshold/trend alerts, loss-spike and NaN detection, gradient-norm
watch, health score, phase tracking, jsonl export and health reports. Host-
side pure Python: it consumes scalars the train step already computed, so it
adds no device work and never blocks dispatch (values arrive as floats
the trainer already read at its log-cadence sync).
"""

from __future__ import annotations

import json
import logging
import math
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class TrainingAlert:
    """One raised alert (ref logger.py:18)."""

    severity: str  # 'info' | 'warning' | 'critical'
    message: str
    metric: str
    value: float
    step: int
    timestamp: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class MetricsCollector:
    """Windowed metric store with threshold/trend alerting (ref logger.py:29)."""

    def __init__(
        self,
        window_size: int = 100,
        loss_spike_threshold: float = 2.0,
        grad_norm_threshold: float = 100.0,
        registry=None,
        recorder=None,
    ):
        self.window_size = window_size
        self.loss_spike_threshold = loss_spike_threshold
        self.grad_norm_threshold = grad_norm_threshold
        self.metrics: Dict[str, deque] = {}
        self.alerts: List[TrainingAlert] = []
        # Event-spine unification (monitoring/events.py): alerts land on
        # the SAME flight recorder the serving/trainer events use, so a
        # crash dump carries the alert trail, not a parallel half-trail.
        from luminaai_tpu_torch.monitoring.events import get_recorder

        self._recorder = recorder if recorder is not None else get_recorder()
        # Optional bridge into the unified telemetry registry
        # (monitoring/telemetry.py): alerts become a labeled counter on
        # the same /metrics surface the serving stack exports.
        self._alerts_total = None
        if registry is not None:
            self._alerts_total = registry.counter(
                "training_alerts_total",
                "Training alerts raised, by severity",
                labelnames=("severity",),
            )

    def add_metric(self, name: str, value: float, step: int) -> None:
        value = float(value)
        window = self.metrics.setdefault(name, deque(maxlen=self.window_size))
        self._check_alerts(name, value, step, window)
        window.append((step, value))

    def add_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        for name, value in metrics.items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            self.add_metric(name, v, step)

    # -- alert rules (ref logger.py:66-170) ------------------------------
    def _check_alerts(self, name, value, step, window) -> None:
        if math.isnan(value) or math.isinf(value):
            self._alert("critical", f"{name} is {value}", name, value, step)
            return
        if "loss" in name and window:
            recent = [v for _, v in list(window)[-10:]]
            mean = sum(recent) / len(recent)
            if mean > 0 and value > mean * self.loss_spike_threshold:
                self._alert(
                    "warning",
                    f"loss spike: {value:.4f} vs recent mean {mean:.4f}",
                    name, value, step,
                )
        if name == "grad_norm" and value > self.grad_norm_threshold:
            self._alert(
                "warning",
                f"grad norm {value:.1f} exceeds {self.grad_norm_threshold}",
                name, value, step,
            )
        if name == "learning_rate" and value < 0:
            self._alert("warning", f"negative LR {value}", name, value, step)
        if name == "moe_drop_rate" and value > 0.5:
            self._alert(
                "warning", f"MoE dropping {value:.0%} of tokens", name, value, step
            )

    def _alert(self, severity, message, metric, value, step) -> None:
        alert = TrainingAlert(severity, message, metric, value, step)
        self.alerts.append(alert)
        if self._alerts_total is not None:
            self._alerts_total.labels(severity=severity).inc()
        self._recorder.emit(
            "alert", severity=severity, metric=metric,
            value=(float(value) if math.isfinite(value) else str(value)),
            step=step, message=message,
        )
        log = logger.critical if severity == "critical" else logger.warning
        log("[%s] step %d: %s", severity.upper(), step, message)

    def get_recent_alerts(self, minutes: float = 5.0) -> List[TrainingAlert]:
        cutoff = time.time() - minutes * 60
        return [a for a in self.alerts if a.timestamp >= cutoff]

    # -- summaries (ref logger.py:205,223,246) ---------------------------
    def get_metric_summary(self, name: str) -> Dict[str, Any]:
        window = self.metrics.get(name)
        if not window:
            return {}
        values = [v for _, v in window]
        return {
            "current": values[-1],
            "mean": sum(values) / len(values),
            "min": min(values),
            "max": max(values),
            "count": len(values),
            "trend": self._trend(values),
        }

    @staticmethod
    def _trend(values: List[float]) -> str:
        if len(values) < 10:
            return "insufficient_data"
        half = len(values) // 2
        first = sum(values[:half]) / half
        second = sum(values[half:]) / (len(values) - half)
        if abs(first) < 1e-12:
            return "stable"
        change = (second - first) / abs(first)
        if change < -0.02:
            return "decreasing"
        if change > 0.02:
            return "increasing"
        return "stable"

    def get_health_score(self) -> float:
        """0-100 composite (ref logger.py:246): penalize alerts, reward a
        decreasing loss trend."""
        score = 100.0
        recent = self.get_recent_alerts(10.0)
        score -= 25.0 * sum(a.severity == "critical" for a in recent)
        score -= 5.0 * sum(a.severity == "warning" for a in recent)
        loss = self.get_metric_summary("loss")
        if loss:
            if loss.get("trend") == "increasing":
                score -= 15.0
            elif loss.get("trend") == "decreasing":
                score += 5.0
        return max(0.0, min(100.0, score))


class TrainingHealthMonitor:
    """Step logging + periodic health checks + reports (ref logger.py:276).

    Writes one jsonl line per logged step under `log_dir` and keeps a
    rolling health assessment the orchestrator polls for interventions.
    """

    PHASES = ("warmup", "early", "steady", "converging")

    def __init__(
        self,
        log_dir: Optional[str] = None,
        loss_spike_threshold: float = 2.0,
        grad_norm_threshold: float = 100.0,
        health_check_interval: int = 100,
        registry: Optional[Any] = None,
        recorder: Optional[Any] = None,
    ):
        # Unified-telemetry bridge: every scalar logged here is mirrored
        # as a `training_<name>` gauge in the shared registry, so the
        # serving /metrics endpoint (or any colocated exporter) exposes
        # training health through the exact same pipe. None disables.
        self._registry = registry
        if registry is not None:
            from luminaai_tpu_torch.monitoring.telemetry import weak_callback

            self._health_gauge = registry.gauge(
                "training_health_score",
                "Composite 0-100 training health (alerts + loss trend)",
            )
            # Weak ref: the process registry outlives any one monitor.
            self._health_gauge.set_function(
                weak_callback(self, lambda m: m.collector.get_health_score())
            )
        # One structured trail, not two half-trails: every scalar logged
        # here ALSO lands as a train_step event on the process flight
        # recorder (monitoring/events.py), so the jsonl file (durable,
        # full history) and the ring buffer (last-N, crash-dumpable,
        # `lumina events`-queryable) tell the same story.
        from luminaai_tpu_torch.monitoring.events import get_recorder

        self._recorder = recorder if recorder is not None else get_recorder()
        self.collector = MetricsCollector(
            loss_spike_threshold=loss_spike_threshold,
            grad_norm_threshold=grad_norm_threshold,
            registry=registry,
            recorder=self._recorder,
        )
        self.health_check_interval = health_check_interval
        self.phase = "warmup"
        self.start_time = time.time()
        # (seconds, steps) pairs between log calls — log cadence may be
        # sparser than 1 (the trainer logs every log_every steps).
        self.step_times: deque = deque(maxlen=100)
        self._last_log: Optional[tuple] = None  # (time, step)
        self.log_path: Optional[Path] = None
        if log_dir:
            is_primary = True  # one process (multi-GPU: a later slice)
            if is_primary:
                d = Path(log_dir)
                d.mkdir(parents=True, exist_ok=True)
                self.log_path = d / "metrics.jsonl"

    def log_step(self, step: int, metrics: Dict[str, Any],
                 event: str = "train_step") -> None:
        now = time.time()
        if self._last_log is not None and step > self._last_log[1]:
            self.step_times.append((now - self._last_log[0], step - self._last_log[1]))
        if self._last_log is None or step > self._last_log[1]:
            self._last_log = (now, step)

        scalars = {}
        for k, v in metrics.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            scalars[k] = f
        self.collector.add_metrics(scalars, step)
        self._recorder.emit(
            event, step=step,
            # Envelope keys (and `step`, bound above) can't ride as
            # kwargs — a metric named like one would TypeError.
            **{k: v for k, v in scalars.items()
               if k not in ("v", "ts", "type", "seq", "step")},
        )
        self._update_phase(step, scalars)
        if self._registry is not None:
            self._mirror_to_registry(step, scalars)

        if self.log_path is not None:
            with self.log_path.open("a") as f:
                f.write(json.dumps({"step": step, "ts": now, **scalars}) + "\n")

    @staticmethod
    def _metric_name(key: str) -> str:
        """Logged scalar key -> valid exposition metric name."""
        safe = "".join(
            c if (c.isalnum() or c == "_") else "_" for c in key
        ).strip("_") or "unnamed"
        return f"training_{safe}"

    def _mirror_to_registry(self, step: int, scalars: Dict[str, float]) -> None:
        import math as _math

        r = self._registry
        for k, v in scalars.items():
            if not _math.isfinite(v):
                continue  # NaN/Inf are alert material, not gauge values
            try:
                r.gauge(
                    self._metric_name(k), f"Training scalar '{k}' (latest)"
                ).set(v)
            except ValueError:
                # A scalar key colliding with an existing non-gauge metric
                # must not kill training; the jsonl log still has it.
                continue
        r.gauge(
            "training_step", "Latest logged global step"
        ).set(step)

    def _update_phase(self, step: int, metrics: Dict[str, float]) -> None:
        """Rough phase model (ref logger.py:340 _update_training_phase)."""
        loss = self.collector.get_metric_summary("loss")
        if step < 100:
            self.phase = "warmup"
        elif loss.get("trend") == "decreasing":
            self.phase = "early" if step < 1000 else "steady"
        elif loss.get("trend") == "stable" and step > 1000:
            self.phase = "converging"

    def steps_per_second(self) -> float:
        total_s = sum(s for s, _ in self.step_times)
        total_steps = sum(n for _, n in self.step_times)
        if total_s <= 0:
            return 0.0
        return total_steps / total_s

    def get_health_summary(self) -> Dict[str, Any]:
        score = self.collector.get_health_score()
        return {
            "health_score": score,
            "status": self._status(score),
            "phase": self.phase,
            "steps_per_second": round(self.steps_per_second(), 3),
            "uptime_minutes": round((time.time() - self.start_time) / 60, 1),
            "recent_alerts": [a.to_dict() for a in self.collector.get_recent_alerts()],
            "loss": self.collector.get_metric_summary("loss"),
            "grad_norm": self.collector.get_metric_summary("grad_norm"),
        }

    @staticmethod
    def _status(score: float) -> str:
        if score >= 80:
            return "healthy"
        if score >= 60:
            return "degraded"
        if score >= 40:
            return "unstable"
        return "critical"

    def save_health_report(self, path: str) -> None:
        report = {
            "generated": time.time(),
            "summary": self.get_health_summary(),
            "metrics": {
                name: self.collector.get_metric_summary(name)
                for name in self.collector.metrics
            },
            "alerts": [a.to_dict() for a in self.collector.alerts[-100:]],
        }
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(report, indent=1))
