"""What a per-layer metric reader gets: the traced window's records."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from portbench.lib import device as dev
from portbench.lib.flops import Shapes
from portbench.lib.trace import Trace


@dataclass
class Window:
    trace: Trace  # the light trace's device events (no host ops, scopes)
    window_s: float  # its first device event to the end of its last
    busy_s: float  # union of the device intervals inside it
    cell: Dict[str, Any]  # portbench/cells/<cell>.json
    config: Dict[str, Any]  # the configuration's `config` block
    shapes: Shapes
    # True where the profiler's launches of B1-B5 disagreed with the
    # program's launch counters in every try: kernel shares are left out.
    lossy: bool = False
    # The same steps traced with host ops and record_function scopes
    # (heavier on the host: read it for device time by scope, not for
    # idle time), and whether its launches disagreed in every try.
    scopes: Optional[Trace] = None
    scopes_lossy: bool = False
    # Driver facts about the window: steps, tokens, requests, counters.
    facts: Dict[str, Any] = field(default_factory=dict)

    def fact(self, key: str, default: Optional[Any] = None) -> Any:
        return self.facts.get(key, default)


def timed_steps(step: Callable[[int], Any], seconds: float, device,
                log=None) -> Tuple[int, float, List[Any]]:
    """Run step(0), step(1), ... back to back until `seconds` have passed
    on the host clock, then wait for the card: (steps, seconds from the
    first launch to the end of the last step's work, each step's
    result). At most two steps are in flight, so the host cannot run far
    ahead of the card; every step launched is in the count and in the
    time."""
    marks: List = []
    results = []
    n = 0
    t0 = time.perf_counter()
    while True:
        results.append(step(n))
        n += 1
        if device.type == "cuda":
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            if len(marks) > 2:
                marks[-3].synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    dev.sync(device)
    wall = time.perf_counter() - t0
    if log and len(marks) > 1:
        gaps = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
        log(f"window: {n} steps in {wall:.3f} s; step ms min "
            f"{gaps[0]:.1f} median {gaps[len(gaps) // 2]:.1f} max "
            f"{gaps[-1]:.1f}")
    return n, wall, results
