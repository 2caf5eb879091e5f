"""(The port's copy of luminaai_tpu/monitoring/top.py: the same
history, verdicts and router fleet table render the same frame.)

`lumina top`: a live terminal view over the time-series ring.

Renders the operator's five questions — how fast, how slow, how busy,
how healthy, who's burning budget — as sparkline rows over the ring's
retained history (monitoring/timeseries.py) plus the SLO engine's
verdict table (monitoring/slo.py). Three sources, one renderer:

  - a running server: `lumina top --url http://host:5001` polls
    `GET /metrics/history` + `GET /slo`;
  - a dumped history file (tshist-*.json, written next to the flightrec
    dumps on drain/forensics): `lumina top <path>` — post-mortem view;
  - the in-process default ring (no argument; tests and embedders).

Rendering is a PURE function of (history snapshot, slo verdicts) — no
clocks, no terminal queries — so `--once` output is deterministic and
golden-testable, and `--json` is the same data without the drawing.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "sparkline",
    "top_payload",
    "render_top",
    "history_rate",
    "DEFAULT_ROWS",
]

_SPARK = "▁▂▃▄▅▆▇█"

# (label, series, kind) rows probed in order; rows whose series are
# absent from the history are skipped, so one renderer serves train,
# serve, and colocated processes.
DEFAULT_ROWS: Tuple[Tuple[str, str, str], ...] = (
    ("serve tok/s", "serve_tokens_out_total", "rate"),
    ("ttft p95 s", "serve_ttft_seconds:p95", "value"),
    ("decode p50 s", "serve_token_latency_seconds:p50", "value"),
    ("active lanes", "serve_active_lanes", "value"),
    ("queue depth", "serve_queue_depth", "value"),
    ("train tok/s", "train_tokens_per_sec", "value"),
    ("goodput", "training_goodput_fraction", "value"),
    ("step p95 s", "train_step_seconds:p95", "value"),
)

_TENANT_RX = re.compile(r"^tenant_tokens_out_total\{tenant=(.+)\}$")


def sparkline(values: List[float], width: int = 24) -> str:
    """Unicode sparkline of the LAST `width` values, min-max scaled.
    Constant (or single-point) series render mid-height so "flat" and
    "empty" stay visually distinct."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[3] * len(vals)
    span = hi - lo
    return "".join(
        _SPARK[min(len(_SPARK) - 1, int((v - lo) / span * len(_SPARK)))]
        for v in vals
    )


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    v = float(v)
    a = abs(v)
    if a >= 1e6:
        return f"{v / 1e6:.1f}M"
    if a >= 1e4:
        return f"{v / 1e3:.1f}k"
    if a >= 100 or v == int(v):
        return f"{int(round(v))}"
    if a >= 1:
        return f"{v:.2f}"
    return f"{v:.4f}"


def _points(
    history: Dict[str, Any], name: str, window_s: Optional[float]
) -> List[List[float]]:
    pts = history.get("series", {}).get(name) or []
    if window_s:
        floor = float(history.get("ts", 0.0)) - float(window_s)
        pts = [p for p in pts if p[0] >= floor]
    return pts


def history_rate(
    history: Dict[str, Any], name: str, window_s: Optional[float] = None
) -> List[float]:
    """Per-second rates from a counter-delta series (delta / interval)."""
    interval = max(1e-9, float(history.get("interval_s", 1.0)))
    return [p[1] / interval for p in _points(history, name, window_s)]


def top_payload(
    history: Dict[str, Any],
    slo: Optional[Dict[str, Any]] = None,
    window_s: Optional[float] = None,
    top_k: int = 4,
    fleet: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The machine form behind both `--json` and the drawn frame."""
    rows: Dict[str, Dict[str, Any]] = {}
    for label, series, kind in DEFAULT_ROWS:
        if kind == "rate":
            vals = history_rate(history, series, window_s)
        else:
            vals = [p[1] for p in _points(history, series, window_s)]
        if not vals:
            continue
        rows[label] = {
            "series": series,
            "last": round(vals[-1], 6),
            "min": round(min(vals), 6),
            "max": round(max(vals), 6),
            "points": len(vals),
            "values": [round(v, 6) for v in vals],
        }
    tenants: List[Dict[str, Any]] = []
    for name in history.get("series", {}):
        m = _TENANT_RX.match(name)
        if not m:
            continue
        total = sum(p[1] for p in _points(history, name, window_s))
        tenants.append({"tenant": m.group(1), "tokens_out": int(total)})
    tenants.sort(key=lambda t: (-t["tokens_out"], t["tenant"]))
    return {
        "ts": history.get("ts"),
        "interval_s": history.get("interval_s"),
        "samples": history.get("samples"),
        "series_count": history.get("series_count"),
        "overflow_points": history.get("overflow_points", 0),
        "window_s": window_s,
        "rows": rows,
        "tenants": tenants[: max(0, int(top_k))],
        "slo": slo,
        "fleet": fleet,
    }


def render_top(
    history: Dict[str, Any],
    slo: Optional[Dict[str, Any]] = None,
    source: str = "live",
    window_s: Optional[float] = None,
    top_k: int = 4,
    spark_width: int = 32,
    fleet: Optional[Dict[str, Any]] = None,
) -> str:
    """One drawn frame. Pure: everything comes from the payloads
    (history + slo from a replica, or a router's /fleet table)."""
    pay = top_payload(history, slo, window_s=window_s, top_k=top_k,
                      fleet=fleet)
    out: List[str] = []
    out.append(
        f"lumina top — {source} — samples={pay['samples']} "
        f"series={pay['series_count']} interval={pay['interval_s']}s"
        + (
            f" overflow={pay['overflow_points']}"
            if pay.get("overflow_points")
            else ""
        )
    )
    out.append("")
    if pay["rows"]:
        label_w = max(len(lbl) for lbl in pay["rows"]) + 2
        for label, row in pay["rows"].items():
            spark = sparkline(row["values"], width=spark_width)
            out.append(
                f"{label:<{label_w}}{spark:<{spark_width + 2}}"
                f"{_fmt(row['last']):>8}  "
                f"[{_fmt(row['min'])} .. {_fmt(row['max'])}]"
            )
    elif not fleet:
        out.append("(no series in window — is telemetry/history on?)")
    if pay["tenants"]:
        out.append("")
        out.append(f"top tenants (tokens out{', windowed' if window_s else ''}):")
        for t in pay["tenants"]:
            out.append(f"  {t['tenant']:<20}{t['tokens_out']:>10}")
    if slo and slo.get("objectives"):
        out.append("")
        out.append(
            f"slo ({slo.get('program', '?')}; fast "
            f"{slo['windows']['fast_s']}s/slow {slo['windows']['slow_s']}s):"
        )
        hdr = (
            f"  {'objective':<22}{'state':<7}{'burn f/s':>12}"
            f"{'value':>10}{'target':>10}"
        )
        out.append(hdr)
        for name, v in sorted(slo["objectives"].items()):
            mark = {"ok": " ", "warn": "!", "page": "!!"}.get(
                v["state"], "?"
            )
            out.append(
                f"{mark:<2}{name:<22}{v['state']:<7}"
                f"{v['burn_fast']:>6.2f}/{v['burn_slow']:<5.2f}"
                f"{_fmt(v.get('value')):>10}"
                f"{v['op']:>4}{_fmt(v['target']):>6}"
                + (" ×median" if v.get("baseline") else "")
            )
        alerting = slo.get("alerting") or []
        if alerting:
            out.append(f"  ALERTING: {', '.join(alerting)}")
    if fleet and fleet.get("replicas"):
        reps = fleet["replicas"]
        out.append("")
        out.append(
            f"fleet — {fleet.get('status', '?')} "
            f"({fleet.get('available', '?')}/{len(reps)} available, "
            f"{fleet.get('breakers_open', 0)} breaker(s) open):"
        )
        out.append(
            f"  {'replica':<10}{'status':<10}{'breaker':<11}"
            f"{'infl':>5}{'reqs':>7}{'fails':>7}{'p95 s':>8}  slo"
        )
        for r in reps:
            slo_cell = "-"
            if r.get("slo"):
                alerting = r["slo"].get("alerting") or []
                slo_cell = (
                    "ALERT:" + ",".join(alerting) if alerting else "ok"
                )
            shed = r.get("shed_for_s") or 0
            status = r.get("status", "?") + (
                f"+shed{shed:g}s" if shed else ""
            )
            mark = " " if r.get("breaker") == "closed" else "!"
            out.append(
                f"{mark:<2}{r.get('replica', '?'):<10}{status:<10}"
                f"{r.get('breaker', '?'):<11}"
                f"{_fmt(r.get('inflight')):>5}"
                f"{_fmt(r.get('requests')):>7}"
                f"{_fmt(r.get('failures')):>7}"
                f"{_fmt(r.get('p95_s')):>8}  {slo_cell}"
            )
    return "\n".join(out) + "\n"
