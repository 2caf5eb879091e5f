"""gmm_roofline.train: the expert kernels B4a and B4b against their
roofline: the grouped products of every MoE layer and micro-batch of the
traced steps at tokens x top_k rows, the work the inputs ask for
(portbench/lib/flops.py), over the device time of the kernels by name.
The launches the bound counts are held against the trace's."""

from portbench.lib import flops, trace


def read(w):
    n = trace.kernel_launches(w.trace)
    t = trace.kernel_time_s(w.trace)
    busy = t.get("B4a", 0.0) + t.get("B4b", 0.0)
    if busy <= 0 or w.lossy or not w.shapes.experts:
        return None
    mb, seq = w.fact("micro_batch"), w.fact("seq")
    units = w.fact("steps") * w.fact("accum") * w.shapes.layers
    want = flops.gmm_launches(w.fact("recompute_ffn"))
    if any(n.get(k, 0) != units * want[k] for k in want):
        return None
    per = flops.gmm_step_bound_s(w.shapes, mb, seq, w.fact("recompute_ffn"))
    return 100.0 * units * (per["B4a"] + per["B4b"]) / busy
