"""Hang watchdog and step-time anomaly sentinel (the port's copy of
luminaai_tpu/monitoring/watchdog.py, single process).

A stuck collective, a wedged kernel, or a straggling host hangs a run
SILENTLY: the loop blocks inside a device sync, no exception is
raised, and the reservation burns until a human notices. This module is
the runtime tripwire:

  - `HangWatchdog`: a heartbeat armed by the training loop and the
    serving scheduler. Producers `beat()` at their synced boundaries
    (the trainer at log cadence, right after the float() window sync;
    the scheduler after each decode step). A daemon thread watches the
    gap since the last beat against a ROBUST threshold — k x rolling
    median (+MAD guard) of recent beat intervals, floored — and when it
    trips: emits a `hang_suspected` flight event, writes ALL-thread
    stacks plus the flight ring next to the checkpoints, bumps
    `{training,serving}_hangs_total`, reattributes the stalled seconds
    to the goodput ledger's `hang` cause, and (opt-in `abort=True`,
    `--watchdog-abort`) exits RESUMABLE_EXIT=75 so the orchestrator
    restarts the job instead of burning the reservation. Warmup-aware
    by construction: the trainer arms AFTER the first-compile sync and
    nothing fires until `warmup` intervals exist, so a first compile
    (minutes on flagship shapes) can never trip it.

  - `StepTimeSentinel`: online robust stats over step durations. Each
    observation is checked against the rolling median/MAD BEFORE it
    joins the window (a spike must not defend itself), emitting
    `step_anomaly` events and `<prefix>_{median,mad}` gauges. Reset on
    recompile — a new executable is a new timing regime.

  - `host_step_skew`: the spread of the ranks' wall clocks at the log
    window's sync (the straggler signal), over one small all-gather when
    a process group of more than one rank is up; 0.0 otherwise.

Everything here is host-side wall clock: zero new syncs enter the step
path, and the monitor thread holds no device state.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "RESUMABLE_EXIT",
    "RobustStats",
    "HangWatchdog",
    "StepTimeSentinel",
    "dump_all_stacks",
]

# Mirrors cli.RESUMABLE_EXIT: orchestrators treat 75 (EX_TEMPFAIL) as
# "restart me", distinct from a real failure.
RESUMABLE_EXIT = 75

# MAD -> sigma for a normal distribution; used to turn the MAD guard
# into comparable units with the median.
_MAD_SIGMA = 1.4826


class RobustStats:
    """Rolling median/MAD over the last `window` observations. Sorting a
    <=128-element window at beat/log cadence is microseconds — robust
    beats clever here."""

    def __init__(self, window: int = 64):
        self._buf: "deque[float]" = deque(maxlen=max(2, int(window)))

    def add(self, x: float) -> None:
        self._buf.append(float(x))

    def __len__(self) -> int:
        return len(self._buf)

    def median(self) -> float:
        if not self._buf:
            return 0.0
        s = sorted(self._buf)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def mad(self) -> float:
        """Median absolute deviation (raw, not sigma-scaled)."""
        if not self._buf:
            return 0.0
        med = self.median()
        s = sorted(abs(x - med) for x in self._buf)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def clear(self) -> None:
        self._buf.clear()


def dump_all_stacks(path: str) -> Optional[str]:
    """Write every live thread's Python stack to `path` (the hang
    forensics a restart would otherwise destroy). Never raises — it
    rides the watchdog's firing path."""
    try:
        names = {t.ident: t.name for t in threading.enumerate()}
        with open(path, "w", encoding="utf-8") as fh:
            for tid, frame in sys._current_frames().items():
                fh.write(
                    f"--- thread {names.get(tid, '?')} (ident={tid}) ---\n"
                )
                fh.write("".join(traceback.format_stack(frame)))
                fh.write("\n")
        return path
    except Exception as e:  # pragma: no cover - filesystem failures
        logger.warning("all-thread stack dump failed: %s", e)
        return None


class HangWatchdog:
    """Heartbeat monitor: detect -> dump -> (abort | keep watching).

    Producers call `beat()` at synced boundaries; `arm()`/`disarm()`
    bracket the active region (an idle scheduler or a finished trainer
    must never trip); `pause()` brackets legitimately-slow host work
    (eval, blocking checkpoint saves) — the interval spanning a pause is
    excluded from the stats and cannot fire.

    Threshold: k * (median + MAD_sigma) of the rolling beat intervals,
    floored at `floor_s` — k x rolling median with the MAD term guarding
    noisy windows, armed only once `warmup` intervals exist.
    """

    def __init__(
        self,
        kind: str = "training",
        registry=None,
        recorder=None,
        dump_dir: Optional[str] = None,
        k: float = 10.0,
        floor_s: float = 30.0,
        warmup: int = 3,
        window: int = 64,
        poll_s: float = 1.0,
        abort: bool = False,
        ledger=None,
        clock=time.monotonic,
        exit_fn=os._exit,
    ):
        self.kind = str(kind)
        self.dump_dir = dump_dir
        self.k = float(k)
        self.floor_s = float(floor_s)
        self.warmup = max(1, int(warmup))
        self.poll_s = max(0.01, float(poll_s))
        self.abort = bool(abort)
        self.ledger = ledger
        self._clock = clock
        self._exit_fn = exit_fn
        self._lock = threading.Lock()
        self._stats = RobustStats(window)
        self._armed = False
        self._paused = 0
        self._skip_next = False
        self._fired = False
        self._last_beat: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.fires = 0  # lifetime hang_suspected count (tests, /stats)
        if recorder is None:
            from luminaai_tpu_torch.monitoring.events import get_recorder

            recorder = get_recorder()
        self.recorder = recorder
        self._m_hangs = None
        if registry is not None:
            self._m_hangs = registry.counter(
                f"{self.kind}_hangs_total",
                "Suspected hangs: a step/tick exceeded the robust "
                "k x rolling-median threshold (docs/observability.md)",
            )

    # -- producer API -----------------------------------------------------
    def arm(self) -> None:
        """Start watching from NOW (the first interval begins here).
        Lazily spawns the monitor thread — an unarmed watchdog costs
        nothing."""
        with self._lock:
            self._armed = True
            self._last_beat = self._clock()
            self._fired = False
            self._skip_next = False
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._monitor,
                    name=f"{self.kind}-watchdog",
                    daemon=True,
                )
                self._thread.start()

    def disarm(self) -> None:
        with self._lock:
            self._armed = False
            self._last_beat = None

    def beat(self) -> None:
        """One synced boundary passed. Records the interval into the
        rolling stats (unless flagged skip: pause exits, recompiles) and
        re-enables firing for the next stall."""
        now = self._clock()
        with self._lock:
            if not self._armed:
                return
            if self._last_beat is not None and not self._skip_next:
                self._stats.add(now - self._last_beat)
            self._last_beat = now
            self._skip_next = False
            self._fired = False

    def skip_next(self) -> None:
        """Exclude the in-flight interval from the stats and from firing
        (recompile boundaries: a rebuild is a new timing regime, and its
        one long step is expected). Also clears the rolling window."""
        with self._lock:
            self._skip_next = True
            self._stats.clear()
            self._last_beat = self._clock()

    @contextlib.contextmanager
    def pause(self):
        """Suspend firing across legitimately-slow host work (eval,
        blocking checkpoint saves). The spanning interval is excluded
        from the stats on exit."""
        with self._lock:
            self._paused += 1
        try:
            yield
        finally:
            with self._lock:
                self._paused -= 1
                self._skip_next = True
                self._last_beat = self._clock()

    def close(self) -> None:
        self.disarm()
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    # -- reads ------------------------------------------------------------
    def threshold_s(self) -> Optional[float]:
        """Current firing threshold, or None while warming up."""
        with self._lock:
            return self._threshold_locked()

    def _threshold_locked(self) -> Optional[float]:
        if len(self._stats) < self.warmup:
            return None
        med = self._stats.median()
        mad = self._stats.mad() * _MAD_SIGMA
        return max(self.floor_s, self.k * (med + mad))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "kind": self.kind,
                "armed": self._armed,
                "intervals": len(self._stats),
                "median_s": round(self._stats.median(), 6),
                "mad_s": round(self._stats.mad(), 6),
                "threshold_s": self._threshold_locked(),
                "fires": self.fires,
                "abort": self.abort,
            }

    # -- monitor thread ---------------------------------------------------
    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                if (
                    not self._armed
                    or self._paused
                    or self._fired
                    or self._last_beat is None
                ):
                    continue
                thr = self._threshold_locked()
                if thr is None:
                    continue  # warmup: first compile can never trip
                stalled = self._clock() - self._last_beat
                if stalled <= thr:
                    continue
                self._fired = True
                self.fires += 1
                med = self._stats.median()
                mad = self._stats.mad()
            self._fire(stalled, thr, med, mad)

    def _fire(self, stalled: float, thr: float, med: float, mad: float):
        """Detect -> record -> dump -> (abort | continue). Never raises:
        a broken dump path must not kill the monitor."""
        logger.critical(
            "%s hang suspected: %.1fs since last heartbeat "
            "(threshold %.1fs = k=%.1f x rolling median %.3fs, MAD %.3fs)",
            self.kind, stalled, thr, self.k, med, mad,
        )
        if self._m_hangs is not None:
            self._m_hangs.inc()
        if self.ledger is not None:
            try:
                # The stall was accruing to whatever cause is open
                # (usually productive); move it where it belongs.
                self.ledger.reattribute("hang", stalled)
            except Exception:  # pragma: no cover - ledger must not kill us
                pass
        stacks_path = None
        dump_path = None
        if self.dump_dir:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
                stacks_path = dump_all_stacks(
                    os.path.join(
                        self.dump_dir,
                        f"stacks-{stamp}-{os.getpid()}-hang.txt",
                    )
                )
            except Exception as e:  # pragma: no cover
                logger.warning("stack dump failed: %s", e)
        self.recorder.emit(
            "hang_suspected",
            kind=self.kind,
            stalled_s=round(stalled, 3),
            threshold_s=round(thr, 3),
            median_s=round(med, 6),
            mad_s=round(mad, 6),
            k=self.k,
            stacks=stacks_path,
            abort=self.abort,
        )
        if self.dump_dir:
            dump_path = self.recorder.dump_to_dir(
                self.dump_dir, reason=f"{self.kind}_hang_suspected"
            )
        if self.abort:
            logger.critical(
                "--watchdog-abort: exiting %d (resumable) so the "
                "orchestrator restarts instead of burning the "
                "reservation; forensics: %s / %s",
                RESUMABLE_EXIT, stacks_path, dump_path,
            )
            # The run is WEDGED inside a sync — a graceful save cannot
            # land. os._exit skips atexit/finally by design: the last
            # periodic checkpoint plus the dumps above are the record.
            self._exit_fn(RESUMABLE_EXIT)


class StepTimeSentinel:
    """Online step-time anomaly detection over robust rolling stats.

    `observe(seconds)` checks the value against the PRIOR window
    (median/MAD) before adding it: anomalous when it exceeds BOTH
    `k x median` (ratio: it is many steps' worth of time) and
    `median + guard_sigmas x MAD_sigma` (significance: the window is not
    just noisy). Emits one `step_anomaly` event per anomaly, keeps
    `<prefix>_median` / `<prefix>_mad` gauges fresh, and counts into
    `step_time_anomalies_total{program}`.
    """

    def __init__(
        self,
        registry=None,
        recorder=None,
        prefix: str = "train_step_seconds",
        program: str = "train",
        k: float = 4.0,
        guard_sigmas: float = 6.0,
        window: int = 64,
        warmup: int = 5,
        enabled: bool = True,
    ):
        self.enabled = bool(enabled)
        if not self.enabled:
            registry = recorder = None  # no gauges, no events, no cost
        self.program = str(program)
        self.k = float(k)
        self.guard_sigmas = float(guard_sigmas)
        self.warmup = max(2, int(warmup))
        self._stats = RobustStats(window)
        self._lock = threading.Lock()
        self.anomalies = 0
        self.recorder = recorder
        self._g_median = self._g_mad = self._m_anomalies = None
        if registry is not None:
            self._g_median = registry.gauge(
                f"{prefix}_median",
                f"Rolling median of observed {self.program} step seconds",
            )
            self._g_mad = registry.gauge(
                f"{prefix}_mad",
                f"Rolling MAD of observed {self.program} step seconds",
            )
            self._m_anomalies = registry.counter(
                "step_time_anomalies_total",
                "Step durations flagged anomalous vs the rolling "
                "median/MAD, by program",
                labelnames=("program",),
            )

    def observe(self, seconds: float, step: Optional[int] = None) -> bool:
        """Feed one step duration; returns True when flagged anomalous."""
        if not self.enabled:
            return False
        seconds = float(seconds)
        with self._lock:
            n = len(self._stats)
            med = self._stats.median()
            mad_sigma = self._stats.mad() * _MAD_SIGMA
            anomalous = (
                n >= self.warmup
                and med > 0
                and seconds > self.k * med
                and seconds > med + self.guard_sigmas * mad_sigma
            )
            self._stats.add(seconds)
            new_med = self._stats.median()
            new_mad = self._stats.mad()
            if anomalous:
                self.anomalies += 1
        if self._g_median is not None:
            self._g_median.set(new_med)
            self._g_mad.set(new_mad)
        if anomalous:
            if self._m_anomalies is not None:
                self._m_anomalies.labels(program=self.program).inc()
            if self.recorder is not None:
                self.recorder.emit(
                    "step_anomaly",
                    program=self.program,
                    seconds=round(seconds, 6),
                    median_s=round(med, 6),
                    mad_s=round(mad_sigma / _MAD_SIGMA, 6),
                    k=self.k,
                    **({"step": step} if step is not None else {}),
                )
        return anomalous

    def reset(self) -> None:
        """New timing regime (recompile): forget the old distribution."""
        with self._lock:
            self._stats.clear()


def host_step_skew(registry=None) -> float:
    """Per-rank step-completion skew at the caller's sync point (the JAX
    watchdog.host_step_skew, :463): each rank's wall clock when it
    reaches the log window's sync, max - min over the ranks. One tiny
    all-gather of the (hi, lo) split of the clock (hi whole multiples of
    4096 s, exact in fp32, lo the rest), only when a process group of
    more than one rank is up; 0.0 with no collective otherwise. Sets the
    `host_step_skew_seconds` gauge when a registry is passed."""
    import torch
    import torch.distributed as dist

    skew = 0.0
    if dist.is_initialized() and dist.get_world_size() > 1:
        now = time.time()
        hi = float(int(now) // 4096)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        mine = torch.tensor([hi, now - hi * 4096.0], dtype=torch.float32,
                            device=dev)
        out = torch.empty(2 * dist.get_world_size(), dtype=torch.float32,
                          device=dev)
        dist.all_gather_into_tensor(out, mine)
        g = out.cpu().double().reshape(-1, 2)
        full = g[:, 0] * 4096.0 + g[:, 1]
        skew = float(full.max() - full.min())
    if registry is not None:
        registry.gauge(
            "host_step_skew_seconds",
            "Spread (max - min) of per-host wall clocks at the last "
            "log-window sync — the straggler signal (0.0 single-host)",
        ).set(skew)
    return skew
