"""Tracing and profiling utilities (port of luminaai_tpu/utils/profiling.py).

The JAX file's pieces, over torch:

- `profiling_context(trace_dir)`: a torch.profiler trace of the enclosed
  region, CPU and CUDA activities (CUDA where the card is there), written
  into trace_dir as a Chrome trace (`<name>.pt.trace.json`, what
  chrome://tracing and Perfetto open, and what
  monitoring/attribution.attribute_torch_trace_dir reads); without a
  trace_dir, a no-op scope so call sites stay unconditional.
- `annotate(name)`: a named host range inside such a trace
  (`torch.profiler.record_function`).
- `profile_function`: a timing decorator that waits for the card before
  it reads the clock.
- `StepTimer`: timing windows over spans of steps, synchronized with the
  card at each boundary, so a window times execution, not the enqueue.
- `SectionTimer`: named wall-clock sections for host-side phases.

CUDA launches return before the card finishes: every timing boundary
here synchronizes the card (`torch.cuda.synchronize`) when a tensor of
the timed result, or the `sync` argument, lives on it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import torch

TRACE_SUFFIX = ".pt.trace.json"


def _cuda_devices(obj: Any) -> set:
    """The CUDA devices of the tensors in a (nested) result."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        out = set()
        for x in obj:
            out |= _cuda_devices(x)
        return out
    return set()


def _sync(obj: Any) -> None:
    """Wait for the card(s) holding obj's tensors."""
    for dev in _cuda_devices(obj):
        torch.cuda.synchronize(dev)


def profiler_activities() -> list:
    """CPU, and CUDA where a card is present."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_trace():
    """A started torch.profiler session (CPU and CUDA activities); stop
    it with `stop_trace`."""
    from torch.profiler import profile

    prof = profile(activities=profiler_activities())
    prof.start()
    return prof


def stop_trace(prof, trace_dir: str, name: str = "trace") -> str:
    """Stop a session from `start_trace` (after the card finishes) and
    write its Chrome trace as trace_dir/<name>.pt.trace.json."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, name + TRACE_SUFFIX)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiling_context(
    trace_dir: Optional[str] = None, enabled: bool = True,
    name: str = "trace",
):
    """Capture a CPU + CUDA trace of the enclosed region into trace_dir
    (see the module docstring); a no-op scope without one."""
    if not enabled or trace_dir is None:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, trace_dir, name)


def annotate(name: str):
    """Label a host-side region inside a trace
    (`torch.profiler.record_function`); a context manager."""
    return torch.profiler.record_function(name)


def profile_function(func: Callable) -> Callable:
    """Timing decorator that waits for the card.

    Timings accumulate on `wrapper.timings`; `wrapper.summary()` reports
    count/mean/max. The card holding the result's tensors is synchronized
    before the clock stops, so a time includes the work the call
    enqueued."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        _sync(result)
        wrapper.timings.append(time.perf_counter() - t0)
        return result

    wrapper.timings = []
    wrapper.summary = lambda: {
        "count": len(wrapper.timings),
        "mean_s": sum(wrapper.timings) / max(len(wrapper.timings), 1),
        "max_s": max(wrapper.timings, default=0.0),
    }
    return wrapper


class StepTimer:
    """Card-synchronized step timing windows.

    `timer.start()` before a span of steps, `timer.stop(n_steps, n_tokens,
    sync=out)` after: `sync` is any result of the last step (its card is
    synchronized before the clock stops; with no sync given, every card
    is, where one is present). Aggregates tokens/s and step time per
    window."""

    def __init__(self):
        self.windows: List[Dict[str, float]] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int, n_tokens: int, sync: Any = None
             ) -> Dict[str, float]:
        if sync is not None:
            _sync(sync)
        elif torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        window = {
            "seconds": dt,
            "steps": n_steps,
            "tokens": n_tokens,
            "step_ms": dt / max(n_steps, 1) * 1e3,
            "tokens_per_sec": n_tokens / dt if dt > 0 else 0.0,
        }
        self.windows.append(window)
        self._t0 = None
        return window

    def summary(self) -> Dict[str, float]:
        if not self.windows:
            return {"windows": 0}
        tot_s = sum(w["seconds"] for w in self.windows)
        tot_tok = sum(w["tokens"] for w in self.windows)
        tot_steps = sum(w["steps"] for w in self.windows)
        return {
            "windows": len(self.windows),
            "seconds": tot_s,
            "steps": tot_steps,
            "tokens": tot_tok,
            "step_ms": tot_s / max(tot_steps, 1) * 1e3,
            "tokens_per_sec": tot_tok / tot_s if tot_s > 0 else 0.0,
        }


class SectionTimer:
    """Named wall-clock sections for host-side phases (data loading,
    checkpointing, eval), beside StepTimer's synchronized windows."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }
