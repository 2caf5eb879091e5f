"""Shared pieces of the benchmark's CPU tests: tiny widths of each cell."""

from __future__ import annotations

TINY = {"vocab_size": 512, "hidden_size": 128, "num_layers": 2,
        "num_heads": 4, "num_kv_heads": 2, "seq_length": 64,
        "intermediate_size": 256, "batch_size": 4, "loss_chunk_size": 32}
CELLS = ("b1.train", "flagship_tuned.train")


def tiny(cell: str, **config) -> dict:
    """Overrides that run `cell` at tiny widths on the CPU (the cell's
    accumulation kept at 2 where it has one)."""
    c = dict(TINY, **config)
    if cell.startswith("b1."):
        c.setdefault("gradient_accumulation_steps", 2)
    return {"config": c, "params": {"batches": 6, "trace_steps": 2}}


def fp32(cell: str) -> dict:
    """tiny() with the program computing in float32 too."""
    return tiny(cell, precision="fp32", rope_dtype="fp32",
                adam_mu_dtype=None)
