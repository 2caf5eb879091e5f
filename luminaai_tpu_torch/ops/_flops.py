"""FLOPs the kernel wrappers report for their launches.

torch's FLOP counter (torch.utils.flop_counter.FlopCounterMode) counts the
aten operators it dispatches. The port's kernels launch through ctypes,
inside autograd Functions and a custom operator, so the counter never
sees them: without their own counts a step's attention and expert
products would read as zero FLOPs. Each wrapper therefore reports the
FLOPs of every launch, from the launch's shapes, into the windows open at
the time (`kernel_flops`); outside a window it reports nothing and reads
nothing from the device.

The counts are those chip_smoke.py's bounds use: B1 4 x D, B2 6 x D and
B3 8 x D per attended (q, k) pair and q head (ops/flash_attention.py
`band_pairs`), B4a and B4b 2 x K x N per kept row (the group sizes'
sum, a device value: a window holds it as a tensor until it is read).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Union

import torch

Count = Union[int, torch.Tensor]

_windows: List[Dict[str, Count]] = []


def active() -> bool:
    """Whether a window is open (the wrappers count only then)."""
    return bool(_windows)


def report(kernel: str, flops: Count) -> None:
    """Add one launch's FLOPs to every open window."""
    for w in _windows:
        w[kernel] = w.get(kernel, 0) + flops


@contextlib.contextmanager
def kernel_flops() -> Iterator[Dict[str, Count]]:
    """A window over the launches in its block: {kernel: FLOPs}. Read the
    totals with `totals` after the block."""
    w: Dict[str, Count] = {}
    _windows.append(w)
    try:
        yield w
    finally:
        _windows.remove(w)


def totals(window: Dict[str, Count]) -> Dict[str, int]:
    """A window's counts as ints (reads device sums: a host sync)."""
    return {k: int(v) for k, v in window.items()}
