"""(The port's copy of luminaai_tpu/monitoring/timeseries.py.)

In-process time-series retention over the metrics registry.

Every telemetry surface so far answers "what is the value NOW": a
/metrics scrape between two incidents looks healthy, and "are we meeting
TTFT over the last 5 minutes vs the last hour" is unanswerable without
an external Prometheus that dev boxes and TPU-pod smoke runs don't have.
This module is the missing retention tier: a fixed-memory ring of
samples taken FROM the existing registry (monitoring/telemetry.py) on a
background thread, held in-process so the SLO engine (monitoring/slo.py),
`GET /metrics/history`, and `lumina top` can all ask windowed questions
without any external infrastructure.

Sampling semantics per family type:

  - counters are stored as DELTAS per sample interval (the registry's
    raw value is monotone-from-zero in-process, so the first sample's
    delta against an implicit 0 baseline is exact). Rates fall out as
    delta / interval; window sums as sums of deltas.
  - gauges are stored as-is (NaN — e.g. a collected weak callback — is
    skipped, not stored as a lie).
  - histograms are stored as WINDOWED quantiles: the delta of the
    cumulative bucket counts between consecutive samples is itself a
    histogram of just that interval's observations, and the Prometheus
    interpolation rule over those delta counts yields p50/p95/p99 of
    the interval — not the process-lifetime quantiles the live
    histogram reports. A `:count` series carries the interval's
    observation count so consumers can weight or ignore thin windows.

Design constraints, in order:

  1. Fixed memory by construction: `capacity` points per series
     (deque maxlen) and a hard `max_series` budget. When the budget is
     exhausted, NEW series collapse into the shared `_overflow` series
     (which counts suppressed points per tick) — mirroring the
     registry's own label-budget `_overflow` contract, so a hostile
     label can cost one series, never unbounded host memory.
  2. Never on the device path: the sampler reads host-side registry
     state on its own daemon thread. Gauge callbacks run exactly as
     they do for a /metrics scrape. No torch import.
  3. Lock discipline: registry/child locks are taken while GATHERING
     raw values, the ring's own lock only while storing — the sampler
     can never deadlock against a producer emitting mid-sample, and
     `snapshot()` (scrape) stays safe against concurrent `sample_once()`
     (contract-tested in tests/test_slo.py's race test).

Durability rides the flight-recorder pattern: `dump_to_dir()` writes a
`tshist-*.json` snapshot next to the flightrec dumps so `lumina top`
can attach to a dead process's history.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "HISTORY_SCHEMA_VERSION",
    "DUMP_PREFIX",
    "OVERFLOW_SERIES",
    "TimeSeriesRing",
    "windowed_quantile",
    "load_history",
    "latest_history_dump",
    "get_history",
    "set_history",
]

# Bump when the snapshot envelope changes shape; new series appearing is
# not a schema change (readers must tolerate unknown names).
HISTORY_SCHEMA_VERSION = 1

DUMP_PREFIX = "tshist-"

# Series-budget overflow sink (mirrors telemetry.OVERFLOW_LABEL): once
# max_series distinct series exist, points for NEW series land here as a
# suppressed-point count — bounded memory, visible loss.
OVERFLOW_SERIES = "_overflow"


def windowed_quantile(
    bounds: List[float], counts: List[int], q: float
) -> Optional[float]:
    """Prometheus-rule interpolated quantile over DELTA bucket counts.

    `counts` has len(bounds) + 1 entries (the +Inf bucket last), exactly
    the shape of Histogram._counts — but holding one interval's
    observations rather than the process lifetime's. Same interpolation
    as Histogram.quantile, so windowed and lifetime quantiles agree when
    the window IS the lifetime, and monotonicity in q holds for the same
    reason (one frozen cumulative distribution)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):
                return bounds[-1]  # +Inf bucket clamps to last finite
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * ((rank - (cum - c)) / c)
    return bounds[-1]  # pragma: no cover - rank <= total always


class TimeSeriesRing:
    """Bounded in-process history of the registry's metric families.

    Series are keyed `name` (unlabeled) or `name{k=v,...}` (sorted
    labels), with histogram families fanning out into `:p50`, `:p95`,
    `:p99` and `:count` suffixed series. Each series is a deque of
    (ts, value) capped at `capacity` points.
    """

    def __init__(
        self,
        registry=None,
        interval_s: float = 5.0,
        capacity: int = 720,
        max_series: int = 256,
        clock: Callable[[], float] = time.time,
    ):
        if registry is None:
            from luminaai_tpu_torch.monitoring.telemetry import get_registry

            registry = get_registry()
        self.registry = registry
        self.interval_s = max(0.05, float(interval_s))
        self.capacity = max(2, int(capacity))
        self.max_series = max(1, int(max_series))
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, "deque[Tuple[float, float]]"] = {}
        # Counter baselines (raw value at last sample; implicit 0 start)
        # and histogram cumulative-count baselines.
        self._last_counter: Dict[str, float] = {}
        self._last_hist: Dict[str, List[int]] = {}
        self._samples = 0
        self._overflow_points = 0  # lifetime suppressed points
        self._created_ts = clock()
        self._listeners: List[Callable[["TimeSeriesRing", float], None]] = []
        # The SLO engine judging this ring, advertised by
        # SLOEngine.attach() — lets a live `lumina top` attach render
        # the verdict table (reference cycle is fine; gc handles it).
        self.slo = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- sampling ----------------------------------------------------------
    @staticmethod
    def _key(fam, child) -> str:
        labels = ",".join(
            f"{k}={v}" for k, v in sorted(child._labels.items())
        )
        return f"{fam.name}{{{labels}}}" if labels else fam.name

    def sample_once(self, now: Optional[float] = None) -> int:
        """Take one sample of every family in the registry. Returns the
        number of points stored. Safe to call concurrently with
        producers, scrapes, and the background thread (idempotence is
        NOT implied — each call is its own interval for delta series)."""
        now = self._clock() if now is None else float(now)
        # Phase 1: gather raw values holding only registry/child locks
        # (gauge callbacks may take arbitrary locks of their own — the
        # ring's lock must not be held around them).
        gathered: List[Tuple[str, str, Any]] = []
        for fam in self.registry.families():
            for child in fam.children():
                key = self._key(fam, child)
                if fam.type == "histogram":
                    counts, _, _ = child._frozen()
                    gathered.append(
                        (key, "histogram", (list(child._bounds), counts))
                    )
                elif fam.type == "counter":
                    gathered.append((key, "counter", child.value))
                else:
                    gathered.append((key, "gauge", child.value))
        # Phase 2: store under the ring's own lock.
        stored = 0
        with self._lock:
            for key, typ, raw in gathered:
                if typ == "gauge":
                    stored += self._push(key, now, raw)
                elif typ == "counter":
                    last = self._last_counter.get(key, 0.0)
                    delta = float(raw) - last
                    self._last_counter[key] = float(raw)
                    if delta < 0:
                        continue  # registry swapped/reset: new baseline
                    stored += self._push(key, now, delta)
                else:
                    bounds, counts = raw
                    last = self._last_hist.get(key)
                    self._last_hist[key] = counts
                    if last is None or len(last) != len(counts):
                        deltas = counts
                    else:
                        deltas = [c - p for c, p in zip(counts, last)]
                        if any(d < 0 for d in deltas):
                            continue  # reset: re-baseline, skip interval
                    n = sum(deltas)
                    stored += self._push(key + ":count", now, float(n))
                    if n > 0:
                        for q, suffix in (
                            (0.50, ":p50"), (0.95, ":p95"), (0.99, ":p99"),
                        ):
                            stored += self._push(
                                key + suffix, now,
                                windowed_quantile(bounds, deltas, q),
                            )
            self._samples += 1
        for fn in list(self._listeners):
            try:
                fn(self, now)
            except Exception:  # a broken listener must not stop sampling
                logger.exception("time-series sample listener failed")
        return stored

    def _push(self, name: str, ts: float, value) -> int:
        """Store one point (lock held). Returns 1 if stored."""
        if value is None:
            return 0
        value = float(value)
        if math.isnan(value):
            return 0
        dq = self._series.get(name)
        if dq is None:
            if (
                len(self._series) >= self.max_series
                and name != OVERFLOW_SERIES
            ):
                # Budget exhausted: mirror the label-budget contract —
                # the point collapses into the shared overflow series
                # (counting suppressed points, not summing their values,
                # which would be meaningless across series).
                self._overflow_points += 1
                odq = self._series.get(OVERFLOW_SERIES)
                if odq is None:
                    odq = self._series[OVERFLOW_SERIES] = deque(
                        maxlen=self.capacity
                    )
                if odq and odq[-1][0] == ts:
                    odq[-1] = (ts, odq[-1][1] + 1.0)
                else:
                    odq.append((ts, 1.0))
                return 0
            dq = self._series[name] = deque(maxlen=self.capacity)
        dq.append((ts, value))
        return 1

    def on_sample(
        self, fn: Callable[["TimeSeriesRing", float], None]
    ) -> None:
        """Register a post-sample callback (the SLO engine evaluates
        here, so alerts ride the sampling cadence with no extra thread)."""
        self._listeners.append(fn)

    # -- background sampler ------------------------------------------------
    def start(self) -> None:
        """Start the daemon sampler thread (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="timeseries-sampler", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # pragma: no cover - must never die silently
                logger.exception("time-series sampling failed")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    # -- reads -------------------------------------------------------------
    @property
    def created_ts(self) -> float:
        """When this ring started observing (objective warmup grace)."""
        return self._created_ts

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def window(
        self, name: str, seconds: float, now: Optional[float] = None
    ) -> List[Tuple[float, float]]:
        """Points of `name` with ts >= now - seconds, in time order."""
        now = self._clock() if now is None else float(now)
        floor = now - float(seconds)
        with self._lock:
            dq = self._series.get(name)
            if dq is None:
                return []
            return [(ts, v) for ts, v in dq if ts >= floor]

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            dq = self._series.get(name)
            return dq[-1][1] if dq else None

    def window_sum(
        self, names, seconds: float, now: Optional[float] = None
    ) -> float:
        """Sum of points across delta (counter) series over the window —
        the 'events in the last W seconds' primitive ratio SLOs need."""
        total = 0.0
        for n in names:
            total += sum(v for _, v in self.window(n, seconds, now=now))
        return total

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "samples": self._samples,
                "series": len(self._series),
                "capacity": self.capacity,
                "max_series": self.max_series,
                "interval_s": self.interval_s,
                "overflow_points": self._overflow_points,
            }

    def snapshot(
        self,
        window_s: Optional[float] = None,
        max_points: Optional[int] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """JSON-friendly history dump. Budget-guarded by construction:
        at most `capacity` points per series and `max_series` series,
        tightened further by window_s / max_points for HTTP consumers
        (`GET /metrics/history?seconds=...`)."""
        now = self._clock() if now is None else float(now)
        floor = now - float(window_s) if window_s else None
        with self._lock:
            series: Dict[str, List[List[float]]] = {}
            for name, dq in self._series.items():
                pts = [
                    [round(ts, 3), round(v, 6)]
                    for ts, v in dq
                    if floor is None or ts >= floor
                ]
                if max_points is not None and len(pts) > max_points:
                    pts = pts[-max_points:]
                if pts:
                    series[name] = pts
            return {
                "v": HISTORY_SCHEMA_VERSION,
                "ts": round(now, 3),
                "created_ts": round(self._created_ts, 3),
                "interval_s": self.interval_s,
                "samples": self._samples,
                "series_count": len(self._series),
                "overflow_points": self._overflow_points,
                "series": series,
            }

    # -- durability --------------------------------------------------------
    def dump(self, path: str, slo: Optional[Dict[str, Any]] = None) -> int:
        """Write the full history snapshot as JSON (optionally embedding
        the SLO engine's last verdicts, so `lumina top <dump>` can draw
        the alert table post-mortem). Returns the series count written.
        Atomic (tmp + rename) like the flight recorder."""
        snap = self.snapshot()
        if slo is not None:
            snap["slo"] = slo
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(snap, fh, default=str)
        os.replace(tmp, path)
        return len(snap["series"])

    def dump_to_dir(
        self, directory: str, reason: str = "",
        slo: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Dump into `directory` as tshist-<utc>-<reason>.json. Rides
        shutdown/forensic paths: never raises (mirrors
        FlightRecorder.dump_to_dir)."""
        from luminaai_tpu_torch.monitoring.events import _safe_reason

        try:
            os.makedirs(directory, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            base = f"{DUMP_PREFIX}{stamp}-{_safe_reason(reason)}"
            path = os.path.join(directory, f"{base}.json")
            i = 0
            while os.path.exists(path):  # never overwrite a forensic dump
                i += 1
                path = os.path.join(
                    directory, f"{base}-{os.getpid()}.{i}.json"
                )
            n = self.dump(path, slo=slo)
            logger.info("time-series history: %d series -> %s", n, path)
            return path
        except Exception as e:
            logger.warning("time-series history dump failed: %s", e)
            return None


# -- dump readers (lumina top, tests) --------------------------------------
def load_history(path: str) -> Dict[str, Any]:
    """Load a tshist-*.json dump (or any TimeSeriesRing.snapshot JSON).
    Raises ValueError when the file is not a history snapshot."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or not isinstance(
        doc.get("series"), dict
    ):
        raise ValueError(f"{path} is not a time-series history snapshot")
    return doc


def latest_history_dump(directory: str) -> Optional[str]:
    """Newest tshist-*.json under `directory`, or None."""
    try:
        names = [
            n for n in os.listdir(directory)
            if n.startswith(DUMP_PREFIX) and n.endswith(".json")
        ]
    except OSError:
        return None
    if not names:
        return None
    paths = [os.path.join(directory, n) for n in names]
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


# -- process-wide default ring ---------------------------------------------
# Unlike the registry/recorder defaults there is no always-on instance:
# sampling costs a thread, so the first program that WANTS history
# (trainer, serving) installs its ring here and `lumina top` (no args,
# in-process) reads it.
_default_history: Optional[TimeSeriesRing] = None
_default_lock = threading.Lock()


def get_history() -> Optional[TimeSeriesRing]:
    return _default_history


def set_history(
    ring: Optional[TimeSeriesRing],
) -> Optional[TimeSeriesRing]:
    """Install the process-default ring (trainer/server at start; tests
    swap and restore). Returns the previous ring."""
    global _default_history
    with _default_lock:
        prev = _default_history
        _default_history = ring
        return prev
