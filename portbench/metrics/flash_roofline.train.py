"""flash_roofline.train: the attention kernels B1-B3 against their
roofline: the bound of each traced launch at the cell's shapes (causal
pairs of each micro-batch's sequences, portbench/lib/flops.py), summed,
over the device time of the kernels B1-B3 by name."""

from portbench.lib import flops, trace


def read(w):
    n = trace.kernel_launches(w.trace)
    t = trace.kernel_time_s(w.trace)
    kinds = [k for k in ("B1", "B2", "B3") if n.get(k)]
    busy = sum(t.get(k, 0.0) for k in kinds)
    if not kinds or busy <= 0 or w.lossy:
        return None
    mb, seq = w.fact("micro_batch"), w.fact("seq")
    bound = sum(n[k] * flops.flash_bound_s(k, w.shapes, mb, seq)
                for k in kinds)
    return 100.0 * bound / busy
