"""lm_head_roofline.train: the fused LM head and CE's chunks against
their roofline. Each `fused_ce` profiler range is one chunk's logits
product, log-sum-exp and label pick (the forward and its recompute in the
backward; the backward's products run outside the scope). Bound: each
chunk's FLOPs at the bf16 peak or its bytes at HBM bandwidth
(portbench/lib/flops.py), over the device time of the kernels launched
inside the ranges. Read from the trace with host ops and scopes: device
time by scope, which the profiler's host cost does not stretch."""

from portbench.lib import flops, trace

SCOPE = "fused_ce"


def read(w):
    if w.scopes is None or w.scopes_lossy:
        return None
    n = trace.scope_count(w.scopes, SCOPE)
    t = trace.scope_time_s(w.scopes, SCOPE)
    if not n or t <= 0:
        return None
    c = w.config
    seq = c["seq_length"]
    chunk = max(1, min(c.get("loss_chunk_size", 256), seq))
    while seq % chunk:
        chunk -= 1
    rows = w.fact("micro_batch") * chunk
    return 100.0 * n * flops.lm_head_chunk(w.shapes, rows)["bound_s"] / t
