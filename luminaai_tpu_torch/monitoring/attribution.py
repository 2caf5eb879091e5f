"""Performance attribution (port of luminaai_tpu/monitoring/attribution.py):
where a step's FLOPs, bytes and milliseconds go.

Three layers, each usable alone, with the JAX module's names:

1. **Step-cost accounting** (`compiled_cost_metrics`): JAX asks XLA's cost
   model about a compiled step. torch has no compiled program to ask, so
   the port runs the step once under torch's FLOP counter
   (`torch.utils.flop_counter.FlopCounterMode`) with the kernel wrappers'
   FLOP window open (ops/_flops.py: the counter does not see the CUDA
   kernels, which launch through ctypes), and reads the CUDA allocator's
   peak around it. It exports `compiled_flops_per_step` and the memory
   gauges next to the analytic 6·N·T estimate, and flags a divergence
   beyond `MFU_DIVERGENCE_THRESHOLD` (remat recompute and attention are
   outside 6·N·T, so a remat step reads well above it). On the CPU the
   plain attention forward runs inside the operator `lumina::flash_fwd`,
   which the counter does not enter, so a CPU count lacks it.

2. **Trace attribution** (`classify_op` / `attribute_trace`): the
   per-subsystem step breakdown. `classify_op` keeps the JAX rules (XLA
   scope paths) and maps the port's own CUDA kernel names and profiler
   scopes onto the same subsystems: `flash_*` kernels (B1-B3) to
   attn_flash_kernels, `grouped_kernel` (B4a/B4b) and the `experts`
   scope to moe_expert_matmul, the chunked CE's `fused_ce` scope
   (ops/fused.py) to ce_loss, the `moe` scope (routing and the sort
   dispatch) to moe_route_dispatch, the `attention` scope (projections,
   RoPE) to attn_proj_rope, copies to data_formatting, and a kernel
   launched outside every scope (the autograd engine's backward kernels,
   the optimizer) to the unattributed bucket. `attribute_torch_trace_dir`
   reads a torch.profiler Chrome trace (what the Trainer's profiling
   window writes) in place of JAX's xplane reader.

3. **Export** (`export_attribution` and the gauges of
   `compiled_cost_metrics`): the registry gauges JAX exports, under its
   names, and one JSONL record per capture.

`donation_audit` checks what JAX's buffer donation guarantees: that the
step updates the parameter and moment storage in place (the same data
pointers before and after the step), at the same 0.90 coverage rule.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry, get_registry

__all__ = [
    "DONATION_COVERAGE_THRESHOLD",
    "MFU_DIVERGENCE_THRESHOLD",
    "SUBSYSTEMS",
    "OpRow",
    "TraceAttribution",
    "analytic_train_flops",
    "attribute_torch_trace_dir",
    "attribute_trace",
    "classify_op",
    "compiled_cost_metrics",
    "donation_audit",
    "export_attribution",
    "rows_from_torch_trace",
    "storage_ptrs",
    "tree_bytes",
]

# Analytic (6·N·T) vs counted-FLOPs divergence beyond this fraction is
# flagged: the MFU headline and the step disagree about the work.
MFU_DIVERGENCE_THRESHOLD = 0.10

# A step must update at least this fraction of its resident-state bytes
# in place; below it, parameter or moment storage is copied each step.
DONATION_COVERAGE_THRESHOLD = 0.90


# ---------------------------------------------------------------------------
# op classification
# ---------------------------------------------------------------------------

# Canonical subsystem names, in the order reports print them (the JAX
# module's).
SUBSYSTEMS = (
    "attn_flash_kernels",
    "ce_loss",
    "moe_expert_matmul",
    "moe_route_dispatch",
    "attn_proj_rope",
    "data_formatting",
    "unattributed(optimizer+dispatch_bwd)",
    "other",
)

_EXPERT_MATMUL_RE = re.compile(r"egch,ehf|egcf,efh|gmm|/experts/")

# The port's kernels by name (csrc/*.cu), as the profiler names them.
_FLASH_KERNEL = "flash_"
_GROUPED_KERNEL = "grouped_kernel"
# The port's profiler scopes (torch.profiler.record_function): the chunked
# CE (ops/fused.py), the MoE layer and its expert FFN (models/moe.py), the
# attention block (models/layers.py).
CE_SCOPE = "fused_ce"
MOE_SCOPE = "moe"
EXPERTS_SCOPE = "experts"
ATTENTION_SCOPE = "attention"


def classify_op(fw_name: str, category: str = "", source: str = "",
                kernel: str = "") -> str:
    """Map one op onto a model subsystem.

    `fw_name` is the scope path: JAX's named-scope path, or for a port
    kernel the profiler scopes open where it was launched, as
    "/outer/inner/" ("" outside every scope); `category` the op category
    ("data formatting" for copies); `source` the source-info column;
    `kernel` the port's CUDA kernel name. The rules are ordered
    most-specific-first; an op outside every scope is the optimizer's or
    the backward's glue and reports as its own bucket."""
    if ("attention" in fw_name and "pallas_call" in fw_name) or (
            _FLASH_KERNEL in kernel):
        return "attn_flash_kernels"
    if ("bch,vh->bcv" in fw_name or "fused.py" in source
            or f"/{CE_SCOPE}/" in fw_name):
        return "ce_loss"
    if _EXPERT_MATMUL_RE.search(fw_name) or _GROUPED_KERNEL in kernel:
        return "moe_expert_matmul"
    if f"/{MOE_SCOPE}/" in fw_name:
        return "moe_route_dispatch"
    if f"{ATTENTION_SCOPE}/" in fw_name or "qkv" in fw_name:
        return "attn_proj_rope"
    if category == "data formatting":
        return "data_formatting"
    if not fw_name.strip():
        return "unattributed(optimizer+dispatch_bwd)"
    return "other"


@dataclass
class OpRow:
    """One profiled op. `self_time_us` is its total self time across the
    whole trace window (all steps); `kernel` the port's CUDA kernel name
    (empty for a JAX hlo_stats row)."""

    self_time_us: float
    fw_name: str = ""
    category: str = ""
    source: str = ""
    bound_by: str = "?"
    kernel: str = ""


@dataclass
class TraceAttribution:
    """Per-subsystem step breakdown of one trace window; a torch trace
    also carries the card's busy time a step (the union of its device
    intervals)."""

    n_steps: int
    ms_per_step: Dict[str, float]
    fraction: Dict[str, float]
    dominant_bound: Dict[str, str]
    total_ms_per_step: float
    top_ops: List[Dict[str, Any]] = field(default_factory=list)
    device_busy_ms_per_step: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "n_steps": self.n_steps,
            "total_ms_per_step": round(self.total_ms_per_step, 3),
            "subsystems": {
                name: {
                    "ms_per_step": round(self.ms_per_step[name], 3),
                    "fraction": round(self.fraction[name], 4),
                    "bound": self.dominant_bound[name],
                }
                for name in self.ms_per_step
            },
            "top_ops": self.top_ops,
        }
        if self.device_busy_ms_per_step is not None:
            out["device_busy_ms_per_step"] = round(
                self.device_busy_ms_per_step, 3)
        return out


def attribute_trace(
    rows: Iterable[OpRow], n_steps: int = 1, top_k: int = 10
) -> TraceAttribution:
    """Fold profiled ops into the per-subsystem step breakdown.

    Subsystems are sorted by time (heaviest first) in the result dicts;
    `fraction` is of total self time, so it sums to ~1 regardless of how
    many steps the window covered."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    groups: Dict[str, float] = {}
    bounds: Dict[str, Dict[str, float]] = {}
    kept: List[OpRow] = []
    for r in rows:
        t = float(r.self_time_us or 0.0)
        g = classify_op(r.fw_name or "", r.category or "", r.source or "",
                        r.kernel or "")
        groups[g] = groups.get(g, 0.0) + t
        bounds.setdefault(g, {})
        b = r.bound_by or "?"
        bounds[g][b] = bounds[g].get(b, 0.0) + t
        kept.append(r)
    total = sum(groups.values())
    order = sorted(groups, key=lambda g: -groups[g])
    kept.sort(key=lambda r: -float(r.self_time_us or 0.0))
    return TraceAttribution(
        n_steps=n_steps,
        ms_per_step={g: groups[g] / n_steps / 1e3 for g in order},
        fraction={g: (groups[g] / total if total else 0.0) for g in order},
        dominant_bound={
            g: max(bounds[g], key=bounds[g].get) if bounds[g] else "?"
            for g in order
        },
        total_ms_per_step=total / n_steps / 1e3,
        top_ops=[
            {
                "ms_per_step": round(
                    float(r.self_time_us or 0.0) / n_steps / 1e3, 3
                ),
                "category": (r.category or "")[:24],
                "bound": r.bound_by or "?",
                "fw_name": ((r.fw_name or "") + (r.kernel or ""))[-90:],
            }
            for r in kept[:top_k]
        ],
    )


# ---------------------------------------------------------------------------
# torch.profiler traces
# ---------------------------------------------------------------------------

# Device events of a Chrome trace, and the category copies report under.
_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "data formatting",
                "gpu_memset": "data formatting"}
# Ranges that mark steps, not model scopes: torch.profiler's own step
# marks and the Trainer's (training/trainer.py).
_STEP_MARKS = ("ProfilerStep#", "train_step ")


def _union_us(intervals: List[tuple]) -> float:
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        busy += t1 - max(t0, end)
        end = t1
    return busy


def rows_from_torch_trace(trace: Mapping[str, Any]):
    """(OpRows, device busy µs) of a torch.profiler Chrome trace: one row
    per device event (kernels, copies, memsets), its scope path the
    record_function ranges open on the launching thread at its launch
    (matched by the CUDA correlation id), the step marks left out. Busy
    is the union of the device intervals."""
    events = trace.get("traceEvents", trace) if isinstance(
        trace, Mapping) else trace
    scopes: Dict[Any, List[tuple]] = {}
    launches: Dict[Any, tuple] = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        args = ev.get("args") or {}
        if cat == "user_annotation":
            name = ev.get("name", "")
            if not name.startswith(_STEP_MARKS):
                t0 = float(ev["ts"])
                scopes.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                    (t0, t0 + float(ev.get("dur", 0)), name))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (
                (ev.get("pid"), ev.get("tid")), float(ev["ts"]))
        elif cat in _DEVICE_CATS:
            device.append(ev)
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
    rows, intervals = [], []
    for ev in device:
        t0, dur = float(ev["ts"]), float(ev.get("dur", 0))
        intervals.append((t0, t0 + dur))
        path = open_at.get((ev.get("args") or {}).get("correlation"), [])
        rows.append(OpRow(
            self_time_us=dur,
            fw_name="".join(f"/{p}" for p in path) + ("/" if path else ""),
            category=_DEVICE_CATS[ev.get("cat")],
            kernel=ev.get("name", ""),
        ))
    return rows, _union_us(intervals)


def latest_torch_trace(outdir: str) -> Optional[str]:
    """Newest *.pt.trace.json under outdir (None without one)."""
    from luminaai_tpu_torch.utils.profiling import TRACE_SUFFIX

    paths = glob.glob(os.path.join(outdir, "*" + TRACE_SUFFIX))
    return max(paths, key=os.path.getmtime) if paths else None


def attribute_torch_trace_dir(
    outdir: str, n_steps: int = 1, top_k: int = 10
) -> TraceAttribution:
    """Attribute the newest torch.profiler trace under `outdir` (the
    Trainer's window writes `<outdir>/steps<a>-<b>.pt.trace.json`);
    raises RuntimeError when there is none. A trace without device
    events (a CPU run) attributes nothing: no subsystem, 0 ms."""
    path = latest_torch_trace(outdir)
    if path is None:
        raise RuntimeError(f"no *.pt.trace.json under {outdir}")
    with open(path) as f:
        rows, busy_us = rows_from_torch_trace(json.load(f))
    attr = attribute_trace(rows, n_steps, top_k)
    attr.device_busy_ms_per_step = busy_us / n_steps / 1e3
    return attr


def export_attribution(
    attr: TraceAttribution,
    registry: Optional[MetricsRegistry] = None,
    jsonl_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Publish a breakdown: per-subsystem gauges in the registry
    (`attribution_ms_per_step{subsystem=...}` etc.) and, when
    `jsonl_path` is given, one appended JSON record. Returns the record."""
    registry = registry or get_registry()
    g_ms = registry.gauge(
        "attribution_ms_per_step",
        "Per-subsystem self time per train step from the last trace window",
        labelnames=("subsystem",),
    )
    g_frac = registry.gauge(
        "attribution_fraction",
        "Per-subsystem fraction of total step self time",
        labelnames=("subsystem",),
    )
    for name in attr.ms_per_step:
        g_ms.labels(subsystem=name).set(attr.ms_per_step[name])
        g_frac.labels(subsystem=name).set(attr.fraction[name])
    registry.gauge(
        "attribution_total_ms_per_step",
        "Total attributed self time per step from the last trace window",
    ).set(attr.total_ms_per_step)
    record = attr.to_dict()
    if jsonl_path:
        os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
        with open(jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
    return record


# ---------------------------------------------------------------------------
# step-cost accounting
# ---------------------------------------------------------------------------

def analytic_train_flops(active_params: int, tokens_per_step: int) -> float:
    """The 6·N·T transformer estimate MFU headlines use (fwd 2NT + bwd
    4NT, on ACTIVE params). Per whole step across all chips."""
    return 6.0 * float(active_params) * float(tokens_per_step)


def compiled_cost_metrics(
    fn: Callable,
    *args,
    program: str = "train",
    registry: Optional[MetricsRegistry] = None,
    analytic_flops: Optional[float] = None,
    divergence_threshold: float = MFU_DIVERGENCE_THRESHOLD,
    state: Any = None,
    **kwargs,
) -> Dict[str, Any]:
    """Run fn(*args, **kwargs) ONCE under the FLOP counter and the
    kernels' FLOP window, and export what it cost.

    Pass the step the caller runs anyway (the Trainer passes its first
    step): the call is real, its effects stay. FLOPs are the counter's
    aten FLOPs plus the kernels' own counts (`cost_model.kernel_flops`
    splits them out); memory, on the card, is the allocator's view: the
    bytes allocated before the call (`argument_bytes`: the resident
    state and inputs), its peak (`peak_bytes`), the peak's growth
    (`temp_bytes`) and what is allocated after (`output_bytes`); with
    `state` (any tree of tensors: the TrainState), `alias_bytes` counts
    the state bytes whose storage the call updated in place (the same
    data pointer before and after), what donation_audit divides.

    Returns a JSON-able dict; a call that raises gives
    `{"available": False, "reason": ...}`. With `analytic_flops`, the
    cross-check `divergence = counted / analytic - 1`, flagged when
    |divergence| > `divergence_threshold`."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from luminaai_tpu_torch.ops import _flops

    on_card = torch.cuda.is_available() and _on_cuda(args, kwargs, state)
    before_ptrs = storage_ptrs(state) if state is not None else None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated0 = torch.cuda.memory_allocated()
    try:
        with FlopCounterMode(display=False) as counter, \
                _flops.kernel_flops() as window:
            fn(*args, **kwargs)
            if on_card:
                torch.cuda.synchronize()
        kernel = _flops.totals(window)
    except Exception as e:
        return {"available": False,
                "reason": f"step under the FLOP counter failed: "
                          f"{type(e).__name__}: {e}"}
    aten = int(counter.get_total_flops())
    flops = float(aten + sum(kernel.values()))
    out: Dict[str, Any] = {"available": True, "program": program}
    out["cost_model"] = {
        "flops_per_step": flops,
        "aten_flops": aten,
        "kernel_flops": kernel,
    }
    mem: Dict[str, Any] = {}
    if on_card:
        peak = torch.cuda.max_memory_allocated()
        mem = {"argument_bytes": int(allocated0),
               "output_bytes": int(torch.cuda.memory_allocated()),
               "temp_bytes": int(peak - allocated0),
               "peak_bytes": int(peak)}
    if before_ptrs is not None:
        after = storage_ptrs(state)
        mem["alias_bytes"] = int(sum(
            n for key, (ptr, n) in before_ptrs.items()
            if after.get(key, (None, 0))[0] == ptr))
    out["memory"] = mem or None

    if analytic_flops:
        xc: Dict[str, Any] = {
            "analytic_flops_per_step": analytic_flops,
            "compiled_flops_per_step": flops,
        }
        if flops:
            div = flops / analytic_flops - 1.0
            xc["divergence"] = round(div, 4)
            xc["flagged"] = bool(abs(div) > divergence_threshold)
            xc["threshold"] = divergence_threshold
        else:
            xc["divergence"] = None
            xc["flagged"] = False
            xc["note"] = "no counted flops to cross-check"
        out["mfu_crosscheck"] = xc

    _export_cost_gauges(out, program, registry)
    return out


def _tensors(tree) -> Iterable:
    """The tensors (and arrays) of a tree: dicts, lists, tuples,
    dataclasses, and objects with a tensors() method (the optimizer
    states)."""
    import torch

    if tree is None:
        return
    if isinstance(tree, torch.Tensor) or (
            hasattr(tree, "dtype") and hasattr(tree, "nbytes")):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif callable(getattr(tree, "tensors", None)):
        yield from _tensors(list(tree.tensors()))
    elif is_dataclass(tree) and not isinstance(tree, type):
        for f in fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _nbytes(t) -> int:
    import torch

    if isinstance(t, torch.Tensor):
        return int(t.numel()) * int(t.element_size())
    return int(t.nbytes)


def tree_bytes(tree) -> int:
    """Total buffer bytes of a tree of tensors (a TrainState, an
    optimizer state, a list): the resident-state denominator the donation
    audit divides by. Each tensor counts at its stored width."""
    return sum(_nbytes(t) for t in _tensors(tree))


def storage_ptrs(tree) -> Dict[int, tuple]:
    """{position: (data pointer, bytes)} of a tree's tensors, in their
    order: what donation_audit compares across a step."""
    import torch

    return {i: (t.data_ptr() if isinstance(t, torch.Tensor) else id(t),
                _nbytes(t))
            for i, t in enumerate(_tensors(tree))}


def _on_cuda(args, kwargs, state) -> bool:
    import torch

    for t in _tensors([list(args), dict(kwargs), state]):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return True
    return False


def donation_audit(
    memory: Optional[Mapping[str, Any]],
    donated_bytes: float,
    *,
    expected: bool = True,
    program: str = "train",
    registry: Optional[MetricsRegistry] = None,
    threshold: float = DONATION_COVERAGE_THRESHOLD,
) -> Dict[str, Any]:
    """Audit whether a step updates its state in place.

    `memory` is the dict `compiled_cost_metrics` returns under "memory"
    (given `state`, it carries `alias_bytes`: the state bytes whose
    storage kept its data pointer across the step); `donated_bytes` the
    resident bytes of that state (`tree_bytes(state)`). So

        coverage = alias_bytes / donated_bytes

    is the fraction of the state updated IN PLACE. Coverage below
    `threshold` with `expected=True` means parameter or moment storage is
    replaced each step, and the card carries the state twice at the
    update. Flags, never raises."""
    out: Dict[str, Any] = {
        "available": bool(memory) and "alias_bytes" in (memory or {}),
        "program": program,
        "donated_bytes": int(donated_bytes) if donated_bytes else 0,
        "donation_expected": bool(expected),
    }
    if not out["available"]:
        out["reason"] = "no in-place record of the state from this step"
        return out
    alias = float(memory.get("alias_bytes") or 0.0)
    temp = float(memory.get("temp_bytes") or 0.0)
    out["alias_bytes"] = int(alias)
    out["temp_bytes"] = int(temp)
    if donated_bytes:
        cov = alias / float(donated_bytes)
        out["coverage"] = round(cov, 4)
        out["temp_to_state_ratio"] = round(temp / float(donated_bytes), 4)
        out["flagged"] = bool(expected and cov < threshold)
        out["threshold"] = threshold
    else:
        out["coverage"] = None
        out["flagged"] = False
        out["reason"] = "donated_bytes unknown"
    registry = registry or get_registry()
    if out.get("coverage") is not None:
        registry.gauge(
            "donation_alias_coverage",
            "state bytes updated in place / resident state bytes of the "
            "step (1.0 = full in-place update)",
            labelnames=("program",),
        ).labels(program=program).set(out["coverage"])
        registry.gauge(
            "donation_audit_flagged",
            "1 when an in-place update was expected but its coverage fell "
            "below the threshold",
            labelnames=("program",),
        ).labels(program=program).set(1.0 if out["flagged"] else 0.0)
    return out


def _export_cost_gauges(
    out: Dict[str, Any], program: str, registry: Optional[MetricsRegistry]
) -> None:
    registry = registry or get_registry()
    cm = out.get("cost_model") or {}
    mem = out.get("memory") or {}

    def gset(name, help_text, value):
        if value is None or (
            isinstance(value, float) and not math.isfinite(value)
        ):
            return
        registry.gauge(name, help_text, labelnames=("program",)).labels(
            program=program
        ).set(float(value))

    gset(
        "compiled_flops_per_step",
        "Counted FLOPs of one step (torch's FLOP counter plus the "
        "kernels' own counts)",
        cm.get("flops_per_step"),
    )
    gset(
        "compiled_hbm_peak_bytes",
        "Peak allocated card bytes during one step",
        mem.get("peak_bytes"),
    )
    gset(
        "compiled_hbm_argument_bytes",
        "Card bytes allocated before the step (resident state, inputs)",
        mem.get("argument_bytes"),
    )
    gset(
        "compiled_hbm_output_bytes",
        "Card bytes allocated after the step",
        mem.get("output_bytes"),
    )
    gset(
        "compiled_hbm_temp_bytes",
        "Growth of allocated card bytes to the step's peak",
        mem.get("temp_bytes"),
    )
    xc = out.get("mfu_crosscheck") or {}
    gset(
        "analytic_flops_per_step",
        "6·N·T analytic FLOPs the MFU headline assumes",
        xc.get("analytic_flops_per_step"),
    )
    if xc.get("divergence") is not None:
        gset(
            "compiled_mfu_divergence",
            "counted/analytic FLOPs ratio minus 1; |x|>0.1 is flagged",
            xc.get("divergence"),
        )
        gset(
            "compiled_mfu_divergence_flagged",
            "1 when the analytic-vs-counted FLOPs cross-check tripped",
            1.0 if xc.get("flagged") else 0.0,
        )
