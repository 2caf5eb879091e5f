"""mfu.train: the whole training step's share of the card's bf16 peak:
the model FLOPs of the traced run's untraced steps over their seconds on
the host's clock, between two syncs (no profiler on: its host cost
would count as the step's). Model FLOPs: forward and backward (3x the
forward) of every sequence of every step, attention and the LM head
included, recomputation not (portbench/lib/flops.py)."""

from portbench.lib.flops import PEAK_BF16_FLOPS, train_step_flops


def read(w):
    steps, seconds = w.fact("steps"), w.fact("untraced_s")
    if not steps or not seconds or seconds <= 0 or w.busy_s <= 0:
        return None
    c = w.config
    flops = steps * train_step_flops(w.shapes, c["batch_size"],
                                     c["seq_length"])
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS
