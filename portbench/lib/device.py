"""The device a run uses, read the same way in every driver."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def describe(device, count: int = 1) -> dict:
    """`device` of the result line; memory_peak_bytes is the fullest
    card's allocator peak (read before the reference runs)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def profile_steps(device, run_step: Callable[[], None], n: int,
                  host_ops: bool, before_active: Callable[[], Any]
                  ) -> Dict[str, Any]:
    """One warm step and `n` more under torch.profiler, of which only the
    `n` are recorded: the warm step pays the profiler's start-up, which
    would otherwise land inside the window. The card is synced before
    the recorded steps and after them, so the trace holds their device
    work and nothing else. `host_ops` False records the device's events
    and the CUDA runtime's calls alone (no host ops, no scopes): the
    lightest trace, for the window's busy and idle time. Returns the
    profiler ("prof"), the host seconds of the recorded steps ("host_s")
    and what `before_active` returned just before them ("mark")."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = []
    if host_ops or device.type != "cuda":
        acts.append(ProfilerActivity.CPU)
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    box: Dict[str, Any] = {}
    plan = schedule(wait=0, warmup=1, active=n, repeat=1)
    with profile(activities=acts, schedule=plan,
                 on_trace_ready=lambda p: box.setdefault("prof", p)) as prof:
        run_step()
        prof.step()
        sync(device)
        box["mark"] = before_active()
        t0 = time.perf_counter()
        for i in range(n):
            run_step()
            if i == n - 1:
                sync(device)
                box["host_s"] = time.perf_counter() - t0
            prof.step()
    box.setdefault("prof", prof)
    return box
