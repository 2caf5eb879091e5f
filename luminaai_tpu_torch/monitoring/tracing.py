"""Request/step span tracing: context-manager spans with JSONL export
(the port's copy of luminaai_tpu/monitoring/tracing.py).

The metrics registry (telemetry.py) answers "how fast is the system" in
aggregate; this module answers "where did THIS request's time go". A
`SpanTracer` hands out context-manager spans (queue wait, prefill,
time-to-first-token, SSE stream, train step...) that record wall-clock
start/duration, parent/child nesting per thread, and free-form
attributes, and appends each finished span as one JSON line — the same
sink shape the training health monitor already writes, greppable and
pandas-loadable without a collector deployment.

Optionally each span also opens a `torch.profiler.record_function`
range of its name (`profiler_ranges`, the CLI's `serve --trace-jax`, the
JAX flag's name), so when a torch.profiler trace is being captured the
host-side spans show up as named regions on its timeline, beside the
card's kernels they caused. Every failure there degrades to plain host
spans: tracing must never take down serving.

Disabled tracers (the default for serving: `--trace-jsonl` opts in) cost
one attribute check per span — no objects, no lock, no I/O.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Dict, IO, Optional

logger = logging.getLogger(__name__)

__all__ = ["Span", "SpanTracer", "NULL_TRACER"]

_ids = itertools.count(1)


class Span:
    """One timed region. Mutable while open (`set(key=value)` adds
    attributes, e.g. tokens generated — known only at the end); frozen
    into a dict when the context exits."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "t0", "duration_s",
        "attrs", "error",
    )

    def __init__(self, name: str, trace_id: int, parent_id: Optional[int],
                 attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.t0 = time.time()
        self.duration_s: Optional[float] = None
        self.attrs = attrs
        self.error: Optional[str] = None

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "ts": round(self.t0, 6),
            "duration_s": (
                round(self.duration_s, 6)
                if self.duration_s is not None
                else None
            ),
        }
        if self.error:
            out["error"] = self.error
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class _NullSpan:
    """Shared no-op span for disabled tracers: set() swallows attrs so
    call sites never branch on whether tracing is on."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _OpenSpan:
    """Context manager binding one Span to the tracer's per-thread stack
    (parenting) and, optionally, a torch.profiler.record_function range."""

    __slots__ = ("_tracer", "_span", "_t0", "_range")

    def __init__(self, tracer: "SpanTracer", span: Span):
        self._tracer = tracer
        self._span = span
        self._t0 = 0.0
        self._range = None

    def __enter__(self) -> Span:
        tracer = self._tracer
        stack = tracer._stack()
        stack.append(self._span)
        if tracer.profiler_ranges:
            try:
                import torch

                self._range = torch.profiler.record_function(
                    self._span.name)
                self._range.__enter__()
            except (ImportError, RuntimeError):  # host spans only
                self._range = None
        self._t0 = time.perf_counter()
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            try:
                self._range.__exit__(exc_type, exc, tb)
            except RuntimeError:
                pass
        span = self._span
        span.duration_s = time.perf_counter() - self._t0
        if exc is not None:
            span.error = f"{type(exc).__name__}: {exc}"
        tracer = self._tracer
        stack = tracer._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # mis-nested exit (generator close order)
            stack.remove(span)
        tracer._record(span)
        return False


class SpanTracer:
    """Span factory + JSONL writer.

    `tracer.span("prefill", slot=3)` returns a context manager yielding
    a Span; on exit the span (duration, attrs, error) is appended to the
    JSONL file under a lock. Nesting is per-thread: a span opened inside
    another on the same thread records it as parent, and the outermost
    span starts a new trace id — in serving, the per-request span, so
    every child carries the request's trace id.
    """

    def __init__(
        self,
        jsonl_path: Optional[str] = None,
        enabled: bool = True,
        max_spans_in_memory: int = 1000,
        profiler_ranges: bool = False,
    ):
        self.enabled = bool(enabled)
        self.profiler_ranges = bool(profiler_ranges)
        self.jsonl_path = jsonl_path
        self._write_lock = threading.Lock()
        self._file: Optional[IO[str]] = None
        self._tls = threading.local()
        self._trace_ids = itertools.count(1)
        # Ring of recent finished spans for in-process inspection
        # (/healthz debugging, tests) without re-reading the file.
        self._recent: list = []
        self._max_recent = int(max_spans_in_memory)
        self.spans_recorded = 0
        self.dropped_writes = 0
        if jsonl_path:
            try:
                d = os.path.dirname(os.path.abspath(jsonl_path))
                os.makedirs(d, exist_ok=True)
                self._file = open(jsonl_path, "a")
            except OSError as e:
                logger.warning(
                    "span jsonl %s unwritable (%s); spans kept in memory "
                    "only", jsonl_path, e,
                )
                self._file = None

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **attrs: Any):
        """Open a span. Returns a context manager yielding the Span (or
        a shared no-op when disabled)."""
        if not self.enabled:
            return _NULL_SPAN
        stack = self._stack()
        if stack:
            parent = stack[-1]
            s = Span(name, parent.trace_id, parent.span_id, attrs)
        else:
            s = Span(name, next(self._trace_ids), None, attrs)
        return _OpenSpan(self, s)

    def _record(self, span: Span) -> None:
        with self._write_lock:
            self.spans_recorded += 1
            self._recent.append(span)
            if len(self._recent) > self._max_recent:
                del self._recent[: len(self._recent) - self._max_recent]
            if self._file is not None:
                try:
                    self._file.write(json.dumps(span.to_dict()) + "\n")
                    self._file.flush()
                except (OSError, ValueError):
                    self.dropped_writes += 1

    def recent(self, name: Optional[str] = None) -> list:
        with self._write_lock:
            spans = list(self._recent)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans

    def close(self) -> None:
        with self._write_lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


# Shared disabled tracer: the zero-cost default every instrumented
# component falls back to when tracing is off.
NULL_TRACER = SpanTracer(enabled=False)
