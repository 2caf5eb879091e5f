"""(The port's copy of luminaai_tpu/monitoring/slo.py.)

SLO engine: declarative objectives + multi-window burn-rate alerts.

The time-series ring (monitoring/timeseries.py) retains windowed history;
this module judges it. Each `Objective` declares what "good" means for
one service-level indicator — a latency quantile under a target, an
error ratio under a budget, a goodput fraction above a floor, a step
time within a factor of its own rolling median — and the engine
evaluates every objective over TWO windows at sampling cadence, Google
SRE-workbook style:

  - FAST window (default 60s): burn rate >= `fast_burn` pages. A full-on
    incident (every sample violating) burns the budget `1/budget`x as
    fast as allowed; with the default budget of 0.1 that is 10x, so the
    default fast_burn of 10 pages only on a totally-bad fast window —
    high precision, minutes of detection latency.
  - SLOW window (default 600s): burn rate >= `slow_burn` (default 2)
    warns. Catches the slow bleed the fast window forgives.

Burn rate is `violating fraction / budget` for threshold objectives and
`error ratio / target` for ratio objectives — 1.0 means "spending the
error budget exactly as fast as allowed".

State machine per objective: ok -> warn|page fires IMMEDIATELY (one
`slo_burn` flight event + `slo_burn_alerts_total{objective,severity}`);
downward transitions require `clear_evals` consecutive evaluations below
`clear_ratio` of the firing threshold — the hysteresis that keeps a
flapping indicator from re-paging every sample. Every transition (fire
AND clear) books a `slo_burn` event into the flight recorder, so a
forensic dump replays the alert history (`lumina events --type
slo_burn`).

Nothing here touches torch or the hot path: evaluation is pure host
arithmetic over ring windows, riding the sampler's cadence via
`ring.on_sample`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from luminaai_tpu_torch.monitoring.timeseries import TimeSeriesRing

logger = logging.getLogger(__name__)

__all__ = [
    "Objective",
    "SLOEngine",
    "default_train_objectives",
    "default_serve_objectives",
    "load_slo_config",
    "objectives_for",
    "STATES",
]

# Severity ladder; transitions compare by index.
STATES = ("ok", "warn", "page")


@dataclasses.dataclass
class Objective:
    """One declarative service-level objective.

    Threshold form (`series` set): good means `latest op target` — the
    violating fraction of window samples is judged against `budget`.
    With `baseline` set, the target is RELATIVE: good means
    `value op target * baseline_value` (step-time vs rolling median).

    Ratio form (`bad` set): good means bad/(bad+good) <= target, where
    bad/good are counter DELTA series summed over the window and
    `target` doubles as the error budget (an allowed error RATE).
    """

    name: str
    description: str = ""
    series: Optional[str] = None
    op: str = "<="                 # "<=" or ">="
    target: float = 0.0
    budget: float = 0.1            # allowed violating fraction
    baseline: Optional[str] = None
    bad: Optional[Tuple[str, ...]] = None
    good: Optional[Tuple[str, ...]] = None
    min_samples: int = 2
    # Grace period from ring start before this objective is judged at
    # all. For LIFETIME-ratio indicators (goodput fraction) the early
    # value is structurally low — the first compile dominates elapsed —
    # and paging every cold start is noise, not signal. Per-window
    # indicators (latency quantiles) default to 0: they only exist once
    # traffic flows.
    warmup_s: float = 0.0

    def __post_init__(self):
        if self.op not in ("<=", ">="):
            raise ValueError(f"objective {self.name}: op must be <= or >=")
        if self.warmup_s < 0:
            raise ValueError(
                f"objective {self.name}: warmup_s must be >= 0"
            )
        if (self.series is None) == (self.bad is None):
            raise ValueError(
                f"objective {self.name}: exactly one of series/bad required"
            )
        if self.bad is not None:
            self.bad = tuple(self.bad)
            if not self.good:
                raise ValueError(
                    f"objective {self.name}: ratio form needs good series"
                )
            self.good = tuple(self.good)
            if not 0.0 < self.target <= 1.0:
                raise ValueError(
                    f"objective {self.name}: ratio target must be in (0, 1]"
                )
        elif not 0.0 < self.budget <= 1.0:
            raise ValueError(
                f"objective {self.name}: budget must be in (0, 1]"
            )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Objective":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"objective {d.get('name', '?')}: unknown keys "
                f"{sorted(unknown)} (one of {sorted(known)})"
            )
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        return {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in out.items()
            if v is not None and v != ""
        }


class _ObjState:
    __slots__ = ("state", "clear_streak", "fires")

    def __init__(self):
        self.state = "ok"
        self.clear_streak = 0
        self.fires = 0


class SLOEngine:
    """Evaluates objectives over the ring's fast/slow windows and owns
    the per-objective alert state machine."""

    def __init__(
        self,
        ring: TimeSeriesRing,
        objectives: Sequence[Objective],
        registry=None,
        recorder=None,
        program: str = "serve",
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        fast_burn: float = 10.0,
        slow_burn: float = 2.0,
        clear_ratio: float = 0.5,
        clear_evals: int = 2,
        clock=time.time,
    ):
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.ring = ring
        self.objectives: List[Objective] = list(objectives)
        self.program = str(program)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        if not self.fast_window_s < self.slow_window_s:
            raise ValueError("fast window must be shorter than slow window")
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.clear_ratio = float(clear_ratio)
        self.clear_evals = max(1, int(clear_evals))
        self._clock = clock
        self._lock = threading.Lock()
        self._states: Dict[str, _ObjState] = {
            o.name: _ObjState() for o in self.objectives
        }
        self._evaluations = 0
        self._last: Optional[Dict[str, Any]] = None
        self.recorder = recorder
        self._m_alerts = self._g_burn = self._g_state = None
        if registry is not None:
            # Objective names are config-declared (not attacker-supplied)
            # but the label budget is declared anyway — the LX009 rule's
            # spirit: no labeled family without a cardinality bound.
            self._m_alerts = registry.counter(
                "slo_burn_alerts_total",
                "Burn-rate alerts fired, by objective and severity "
                "(docs/observability.md \"SLOs & burn rate\")",
                labelnames=("objective", "severity"),
                max_label_values=64,
            )
            self._g_burn = registry.gauge(
                "slo_burn_rate",
                "Latest burn rate per objective and window (1.0 = "
                "spending error budget exactly as fast as allowed)",
                labelnames=("objective", "window"),
                max_label_values=64,
            )
            self._g_state = registry.gauge(
                "slo_state",
                "Alert state per objective (0 ok, 1 warn, 2 page)",
                labelnames=("objective",),
                max_label_values=64,
            )

    def attach(self) -> "SLOEngine":
        """Evaluate after every ring sample (the normal wiring), and
        advertise this engine on the ring so a live `lumina top` attach
        can read the verdict table without a side channel."""
        self.ring.on_sample(lambda _ring, now: self.evaluate(now=now))
        self.ring.slo = self
        return self

    # -- indicator math ----------------------------------------------------
    def _burn(
        self, obj: Objective, window_s: float, now: float
    ) -> Dict[str, Any]:
        """One objective over one window -> burn rate + evidence."""
        if obj.bad is not None:
            bad = self.ring.window_sum(obj.bad, window_s, now=now)
            good = self.ring.window_sum(obj.good, window_s, now=now)
            total = bad + good
            if total < obj.min_samples:
                # min_samples applies to ratio objectives too: one shed
                # request against zero admissions (startup, lull) is a
                # ratio of 1.0 but not evidence worth paging on.
                return {
                    "burn": 0.0,
                    "value": None,
                    "bad": bad,
                    "total": total,
                    "samples": int(total),
                }
            ratio = (bad / total) if total > 0 else 0.0
            return {
                "burn": ratio / obj.target,
                "value": round(ratio, 6),
                "bad": bad,
                "total": total,
                "samples": int(total),
            }
        pts = self.ring.window(obj.series, window_s, now=now)
        if len(pts) < obj.min_samples:
            return {"burn": 0.0, "value": None, "samples": len(pts)}
        base_pts = (
            self.ring.window(obj.baseline, window_s, now=now)
            if obj.baseline
            else None
        )
        violations = 0
        judged = 0
        last_value = None
        for ts, v in pts:
            target = obj.target
            if base_pts is not None:
                # Most recent baseline at/before this sample: a spike
                # must be judged against the regime it interrupted.
                base = None
                for bts, bv in base_pts:
                    if bts <= ts:
                        base = bv
                if base is None or base <= 0:
                    continue
                target = obj.target * base
            judged += 1
            last_value = v
            ok = v <= target if obj.op == "<=" else v >= target
            if not ok:
                violations += 1
        if judged < obj.min_samples:
            return {"burn": 0.0, "value": last_value, "samples": judged}
        frac = violations / judged
        return {
            "burn": frac / obj.budget,
            "value": last_value,
            "violating": violations,
            "samples": judged,
        }

    # -- evaluation + state machine ---------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = self._clock() if now is None else float(now)
        verdicts: Dict[str, Any] = {}
        with self._lock:
            self._evaluations += 1
            for obj in self.objectives:
                warming = (
                    obj.warmup_s > 0
                    and now - self.ring.created_ts < obj.warmup_s
                )
                if warming:
                    # Objective grace: judged as healthy-with-no-burn
                    # until the run is old enough for its indicator to
                    # mean anything (goodput during first compile).
                    fast = {"burn": 0.0, "value": None, "samples": 0}
                    slow = fast
                else:
                    fast = self._burn(obj, self.fast_window_s, now)
                    slow = self._burn(obj, self.slow_window_s, now)
                desired = "ok"
                if fast["burn"] >= self.fast_burn:
                    desired = "page"
                elif slow["burn"] >= self.slow_burn:
                    desired = "warn"
                st = self._states[obj.name]
                prev = st.state
                transition = None
                if STATES.index(desired) > STATES.index(st.state):
                    # Upward: fire immediately.
                    st.state = desired
                    st.clear_streak = 0
                    st.fires += 1
                    transition = "fire"
                elif STATES.index(desired) < STATES.index(st.state):
                    # Downward: hysteresis — only after clear_evals
                    # consecutive evaluations comfortably below the
                    # firing threshold (clear_ratio), so a flapping
                    # indicator cannot re-page every sample.
                    below = (
                        fast["burn"] < self.clear_ratio * self.fast_burn
                        and (
                            desired == "warn"
                            or slow["burn"]
                            < self.clear_ratio * self.slow_burn
                        )
                    )
                    st.clear_streak = st.clear_streak + 1 if below else 0
                    if st.clear_streak >= self.clear_evals:
                        st.state = desired
                        st.clear_streak = 0
                        transition = "clear"
                else:
                    st.clear_streak = 0
                verdicts[obj.name] = {
                    "state": st.state,
                    "burn_fast": round(fast["burn"], 4),
                    "burn_slow": round(slow["burn"], 4),
                    "value": fast.get("value"),
                    "target": obj.target,
                    "op": obj.op,
                    "baseline": obj.baseline,
                    "samples_fast": fast.get("samples", 0),
                    "samples_slow": slow.get("samples", 0),
                    "fires": st.fires,
                    "ok": st.state == "ok",
                    **({"warming": True} if warming else {}),
                }
                if self._g_burn is not None:
                    self._g_burn.labels(
                        objective=obj.name, window="fast"
                    ).set(fast["burn"])
                    self._g_burn.labels(
                        objective=obj.name, window="slow"
                    ).set(slow["burn"])
                    self._g_state.labels(objective=obj.name).set(
                        STATES.index(st.state)
                    )
                if transition is not None:
                    severity = st.state if transition == "fire" else prev
                    if transition == "fire" and self._m_alerts is not None:
                        self._m_alerts.labels(
                            objective=obj.name, severity=st.state
                        ).inc()
                    if self.recorder is not None:
                        self.recorder.emit(
                            "slo_burn",
                            program=self.program,
                            objective=obj.name,
                            transition=transition,
                            severity=severity,
                            state=st.state,
                            prev_state=prev,
                            burn_fast=round(fast["burn"], 4),
                            burn_slow=round(slow["burn"], 4),
                            value=fast.get("value"),
                            target=obj.target,
                        )
                    logger.log(
                        logging.WARNING
                        if transition == "fire"
                        else logging.INFO,
                        "slo %s: %s %s -> %s (burn fast %.2f / slow "
                        "%.2f, value %s vs target %s)",
                        obj.name, transition, prev, st.state,
                        fast["burn"], slow["burn"],
                        fast.get("value"), obj.target,
                    )
            out = {
                "v": 1,
                "ts": round(now, 3),
                "program": self.program,
                "windows": {
                    "fast_s": self.fast_window_s,
                    "slow_s": self.slow_window_s,
                    "fast_burn": self.fast_burn,
                    "slow_burn": self.slow_burn,
                },
                "evaluations": self._evaluations,
                "alerting": sorted(
                    n for n, s in self._states.items() if s.state != "ok"
                ),
                "objectives": verdicts,
            }
            self._last = out
            return out

    def verdicts(self) -> Dict[str, Any]:
        """Last evaluation (evaluating fresh when none ran yet) — the
        payload `/slo`, bench extras and `lumina top` share."""
        with self._lock:
            last = self._last
        return last if last is not None else self.evaluate()

    def state(self, name: str) -> str:
        with self._lock:
            return self._states[name].state


# -- default objectives (Config slo_* knobs) -------------------------------
def default_serve_objectives(cfg) -> List[Objective]:
    """Serving SLOs over the scheduler/server series PR 2 and PR 7
    already export (docs/observability.md lists them)."""
    return [
        Objective(
            name="serve_ttft_p95",
            description="p95 time-to-first-token within target",
            series="serve_ttft_seconds:p95",
            op="<=", target=cfg.slo_ttft_p95_s, budget=cfg.slo_budget,
        ),
        Objective(
            name="serve_decode_p50",
            description="median per-token decode latency within target",
            series="serve_token_latency_seconds:p50",
            op="<=", target=cfg.slo_decode_p50_s, budget=cfg.slo_budget,
        ),
        Objective(
            name="serve_error_rate",
            description="shed + timed-out requests within error budget",
            bad=(
                "serving_overload_rejections_total",
                "serving_requests_timed_out_total",
            ),
            good=("serve_admissions_total",),
            target=cfg.slo_error_rate,
        ),
    ]


def default_train_objectives(cfg) -> List[Objective]:
    return [
        Objective(
            name="train_goodput",
            description="goodput fraction above floor",
            series="training_goodput_fraction",
            op=">=", target=cfg.slo_goodput_fraction,
            budget=cfg.slo_budget,
            # Goodput is a LIFETIME ratio: during the first compile it
            # is structurally ~0, so judging it before one slow window
            # has elapsed would page every cold start (found driving a
            # real preempted run — not a hypothetical).
            warmup_s=cfg.slo_slow_window_s,
        ),
        Objective(
            name="train_step_time",
            description="windowed step-time p95 within a factor of the "
                        "rolling median (regression, not absolute speed)",
            series="train_step_seconds:p95",
            baseline="train_step_seconds_median",
            op="<=", target=cfg.slo_step_time_factor,
            budget=cfg.slo_budget,
        ),
    ]


def load_slo_config(path: str) -> List[Objective]:
    """Parse a --slo-config JSON file: either a bare list of objective
    dicts or {"objectives": [...]}. Replaces (not extends) the
    defaults, so an override file states the whole contract."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if isinstance(doc, dict):
        doc = doc.get("objectives")
    if not isinstance(doc, list) or not doc:
        raise ValueError(
            f"{path}: expected a non-empty objective list (or "
            "{'objectives': [...]})"
        )
    return [Objective.from_dict(d) for d in doc]


def objectives_for(
    program: str, cfg, slo_config: Optional[str] = None
) -> List[Objective]:
    """Resolve the objective set: --slo-config JSON override when given,
    else the Config-knob defaults for `program`."""
    if slo_config:
        return load_slo_config(slo_config)
    if program == "train":
        return default_train_objectives(cfg)
    return default_serve_objectives(cfg)


def build_slo_stack(
    cfg,
    registry=None,
    recorder=None,
    program: str = "serve",
    slo_config: Optional[str] = None,
    clock=time.time,
) -> Tuple[TimeSeriesRing, SLOEngine]:
    """ONE constructor for the ring + attached engine pair: the trainer,
    the serving server, and bench all build through here, so every
    slo_* Config knob is read in exactly one place and a new knob cannot
    silently diverge across the three call sites. `slo_config` (the
    CLI override path) wins over cfg.slo_config when given."""
    ring = TimeSeriesRing(
        registry,
        interval_s=getattr(cfg, "slo_sample_interval_s", 5.0),
        capacity=getattr(cfg, "slo_ring_points", 720),
        max_series=getattr(cfg, "slo_max_series", 256),
        clock=clock,
    )
    engine = SLOEngine(
        ring,
        objectives_for(
            program, cfg,
            slo_config or getattr(cfg, "slo_config", None),
        ),
        registry=registry,
        recorder=recorder,
        program=program,
        fast_window_s=getattr(cfg, "slo_fast_window_s", 60.0),
        slow_window_s=getattr(cfg, "slo_slow_window_s", 600.0),
        fast_burn=getattr(cfg, "slo_fast_burn", 10.0),
        slow_burn=getattr(cfg, "slo_slow_burn", 2.0),
        clock=clock,
    ).attach()
    return ring, engine
