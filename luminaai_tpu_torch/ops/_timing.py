"""Card time of a callable, by CUDA events: the kernel checks of
chip_smoke.py and scripts/bisect_kernels.py time every kernel with these.

- `cuda_ms`: back-to-back calls, the host's launch work included where a
  call's kernel is shorter than its Python.
- `graph_ms`: the same calls captured in one CUDA graph and replayed, the
  card's time without the host's between launches.
"""

from __future__ import annotations

import torch


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """ms a call of fn, over `iters` back-to-back calls after `warmup`."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """ms a call of fn, from `iters` calls captured in one CUDA graph and
    replayed `replays` times. fn launches on torch's current stream (the
    capture stream); only this thread's calls are checked during the
    capture, so a server thread may run beside it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms
