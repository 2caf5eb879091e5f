"""device_idle_pct.train: the share of the traced training window in
which no kernel, copy or memset ran on the card. Read from the light
trace (device events and CUDA runtime calls only, after a warm step
under the profiler), from its first device event to the end of its
last."""


def read(w):
    if w.window_s <= 0 or w.busy_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
