"""A torch.profiler Chrome trace read into device intervals.

A frozen copy of the port's trace reader (luminaai_tpu_torch/monitoring/
attribution.py `rows_from_torch_trace`, `_union_us`): each device event
(kernel, copy, memset) with the `record_function` scopes open on the
launching thread at its launch, matched by the CUDA correlation id, and
the busy time as the union of the device intervals. Kept here so that a
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_STEP_MARKS = ("ProfilerStep#",)

# Kernel names (the CUDA sources' __global__ functions) of the port's
# hand-written kernels.
FLASH = {"B1": "flash_fwd", "B2": "flash_bwd_dq", "B3": "flash_bwd_dkv"}
GMM = "grouped_kernel"
DECODE = "ragged_decode_kernel"
# Gaps labelled by the host op at their start, longest first.
LABELLED_GAPS = 2000


def kernel_of(name: str) -> Optional[str]:
    """B1-B5 of a device event's name, or None."""
    for k, prefix in FLASH.items():
        if prefix in name:
            return k
    if GMM in name:
        # grouped_kernel<BM, BN, kMode>: kMode 2 is tgmm (B4b).
        return "B4b" if name.replace(" ", "").split(">")[0].endswith(
            ",2") else "B4a"
    if DECODE in name:
        return "B5"
    return None


def union_us(intervals: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        busy += t1 - max(t0, end)
        end = t1
    return busy


@dataclass
class DeviceEvent:
    name: str
    ts: float  # us
    dur: float  # us
    scopes: List[str]


@dataclass
class HostSpan:
    name: str
    ts: float
    dur: float


@dataclass
class Trace:
    device: List[DeviceEvent]
    scopes: List[HostSpan]  # record_function ranges
    host_ops: List[HostSpan]  # cpu ops and annotations, for idle labels


def read_trace(trace: Mapping[str, Any]) -> Trace:
    events = trace.get("traceEvents", trace) if isinstance(
        trace, Mapping) else trace
    scopes: Dict[Any, List[tuple]] = {}
    launches: Dict[Any, tuple] = {}
    device, scope_spans, host_ops = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        args = ev.get("args") or {}
        if cat == "user_annotation":
            name = ev.get("name", "")
            if not name.startswith(_STEP_MARKS):
                t0 = float(ev["ts"])
                key = (ev.get("pid"), ev.get("tid"))
                scopes.setdefault(key, []).append(
                    (t0, t0 + float(ev.get("dur", 0)), name))
                scope_spans.append(HostSpan(name, t0,
                                            float(ev.get("dur", 0))))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (
                (ev.get("pid"), ev.get("tid")), float(ev["ts"]))
        elif cat in _DEVICE_CATS:
            device.append(ev)
        if cat in ("cpu_op", "user_annotation", "python_function"):
            host_ops.append(HostSpan(ev.get("name", ""), float(ev["ts"]),
                                     float(ev.get("dur", 0))))
    # Scopes nest on a thread: sweep each thread's launches in time order
    # with the stack of the scopes open at each.
    open_at: Dict[Any, List[str]] = {}
    by_thread: Dict[Any, List[tuple]] = {}
    for corr, (key, t) in launches.items():
        by_thread.setdefault(key, []).append((t, corr))
    for key, lst in by_thread.items():
        sc = sorted(scopes.get(key, []), key=lambda x: (x[0], -x[1]))
        stack: List[tuple] = []
        i = 0
        for t, corr in sorted(lst, key=lambda x: x[0]):
            while i < len(sc) and sc[i][0] <= t:
                while stack and stack[-1][1] < sc[i][0]:
                    stack.pop()
                stack.append(sc[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            open_at[corr] = [name for _, _, name in stack]
    rows = [DeviceEvent(ev.get("name", ""), float(ev["ts"]),
                        float(ev.get("dur", 0)),
                        open_at.get((ev.get("args") or {}).get("correlation"),
                                    []))
            for ev in device]
    rows.sort(key=lambda r: r.ts)
    return Trace(rows, scope_spans, host_ops)


def clip(tr: Trace, t0: float, t1: float) -> Trace:
    """The events of [t0, t1] (us): device events that start inside it,
    host spans that start inside it."""
    return Trace([e for e in tr.device if t0 <= e.ts <= t1],
                 [s for s in tr.scopes if t0 <= s.ts <= t1],
                 [s for s in tr.host_ops if t0 <= s.ts <= t1])


def device_span(tr: Trace) -> Tuple[float, float]:
    """(first device event's start, last one's end) in us; (0, 0) when
    the trace holds no device event."""
    if not tr.device:
        return 0.0, 0.0
    return (min(e.ts for e in tr.device),
            max(e.ts + e.dur for e in tr.device))


def busy_us(tr: Trace) -> float:
    return union_us([(e.ts, e.ts + e.dur) for e in tr.device])


def kernel_time_s(tr: Trace) -> Dict[str, float]:
    """Device seconds of B1-B5 by kernel."""
    out: Dict[str, float] = {}
    for e in tr.device:
        k = kernel_of(e.name)
        if k:
            out[k] = out.get(k, 0.0) + e.dur * 1e-6
    return out


def kernel_launches(tr: Trace) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for e in tr.device:
        k = kernel_of(e.name)
        if k:
            out[k] = out.get(k, 0) + 1
    return out


def scope_time_s(tr: Trace, scope: str) -> float:
    """Device seconds of the events launched inside `scope`."""
    return sum(e.dur for e in tr.device if scope in e.scopes) * 1e-6


def scope_count(tr: Trace, scope: str) -> int:
    return sum(1 for s in tr.scopes if s.name == scope)


def _short(name: str, n: int = 96) -> str:
    name = name.replace("\n", " ").replace("\t", " ")
    return name if len(name) <= n else name[:n]


def breakdown(tr: Trace, t0: float, t1: float, top: int = 10) -> Dict:
    """The device operations that took most time, and the idle gaps of
    the window summed by what the host was doing when each began: the
    innermost host op open at the gap's start (or "host: none")."""
    ops: Dict[str, float] = {}
    for e in tr.device:
        ops[_short(e.name)] = ops.get(_short(e.name), 0.0) + e.dur * 1e-6
    gaps: List[Tuple[float, float]] = []
    end = t0
    for e in sorted(tr.device, key=lambda e: e.ts):
        if e.ts > end:
            gaps.append((end, e.ts))
        end = max(end, e.ts + e.dur)
    if t1 > end:
        gaps.append((end, t1))
    # Label the longest gaps by the innermost host op open at their
    # start: the latest-starting op on the host that is still open.
    host = sorted(tr.host_ops, key=lambda s: s.ts)
    starts = [s.ts for s in host]
    idle: Dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for g0, g1 in gaps[:LABELLED_GAPS]:
        label = "host: none"
        i = bisect.bisect_right(starts, g0) - 1
        lo = i - 20000
        while i >= 0 and i > lo:
            if host[i].ts + host[i].dur >= g0:
                label = _short(host[i].name)
                break
            i -= 1
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
    rest = sum(g1 - g0 for g0, g1 in gaps[LABELLED_GAPS:]) * 1e-6
    if rest > 0:
        idle["(shorter gaps)"] = rest
    by = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gi = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in by],
            "idle_gaps": [[k, v] for k, v in gi]}
