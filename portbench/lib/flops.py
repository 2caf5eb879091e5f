"""The yardstick's operation and byte counts, from shapes alone.

Kept with the benchmark so that a change to the program cannot move it.
A model's shapes are the configuration's (`shapes(config)`); every count
is of the work the inputs ask for: expert rows are tokens x top_k, an
attention head attends the causal pairs of its sequence, and nothing is
counted for recomputation in `train_step_flops` (model FLOPs). The
kernel bounds count each input byte read once and each output byte
written once.

Peaks: one NVIDIA H100 SXM, dense, from NVIDIA's data sheet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2
FP32 = 4


@dataclass(frozen=True)
class Shapes:
    vocab: int
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    experts: int  # 0: dense SwiGLU layers
    top_k: int


def shapes(config: Dict) -> Shapes:
    """Shapes of a configuration's `config` block (the port's Config
    fields; an intermediate size left out is 8/3 hidden, rounded up to
    a multiple of 128, as the configuration's model sizes it)."""
    h = config["hidden_size"]
    ffn = config.get("intermediate_size") or ((int(8 * h / 3) + 127)
                                              // 128) * 128
    moe = config.get("use_moe", False)
    return Shapes(
        vocab=config["vocab_size"], hidden=h, layers=config["num_layers"],
        heads=config["num_heads"],
        kv_heads=config.get("num_kv_heads") or config["num_heads"],
        head_dim=h // config["num_heads"], ffn=ffn,
        experts=config.get("num_experts", 8) if moe else 0,
        top_k=config.get("moe_top_k", 2) if moe else 0)


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal head attends over one sequence."""
    return seq * (seq + 1) // 2


def forward_flops_per_sequence(s: Shapes, seq: int) -> float:
    """Model FLOPs of one forward pass over one sequence: projections,
    causal attention, router, the top_k experts' (or the dense) FFN and
    the LM head."""
    h, d = s.hidden, s.head_dim
    per_token = (2 * h * (s.heads + 2 * s.kv_heads) * d  # wqkv
                 + 2 * s.heads * d * h)  # wo
    if s.experts:
        per_token += 2 * h * s.experts  # router
        per_token += s.top_k * (2 * h * 2 * s.ffn + 2 * s.ffn * h)
    else:
        per_token += 2 * h * 2 * s.ffn + 2 * s.ffn * h
    attn = 4 * d * s.heads * causal_pairs(seq)  # Q.K^T and P.V
    return s.layers * (per_token * seq + attn) + 2 * h * s.vocab * seq


def train_step_flops(s: Shapes, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: forward and backward (3x the
    forward) over `batch` sequences; recomputation not counted."""
    return 3.0 * batch * forward_flops_per_sequence(s, seq)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# FLOPs per attended pair, q head and unit of head_dim: B1 Q.K^T, P.V;
# B2 S, dP, dQ; B3 S^T, dP^T, dV, dK.
FLASH_PAIR_FLOPS = {"B1": 4, "B2": 6, "B3": 8}


def flash_bound_s(kernel: str, s: Shapes, batch: int, seq: int) -> float:
    """Bound of one launch of B1, B2 or B3 over [batch, seq] causal rows:
    q, k, v (and dO, O-side stats) read once, outputs written once."""
    flops = (FLASH_PAIR_FLOPS[kernel] * s.head_dim * batch * s.heads
             * causal_pairs(seq))
    q = batch * seq * s.heads * s.head_dim * BF16
    kv = batch * seq * s.kv_heads * s.head_dim * BF16
    stats = batch * seq * s.heads * FP32
    if kernel == "B1":
        nbytes = q + 2 * kv + q + stats  # q, k, v in; o, lse out
    elif kernel == "B2":
        nbytes = 2 * q + 2 * kv + 2 * stats + q  # q, dO, k, v, lse, delta; dQ
    else:
        nbytes = 2 * q + 2 * kv + 2 * stats + 2 * kv  # ...; dK, dV
    return bound_s(flops, nbytes)


def _gmm_bound(rows: int, k: int, n: int, experts: int,
               weight_out: bool) -> float:
    """One grouped product over `rows` routed rows: [rows, k] x [E, k, n]
    (or, for a weight gradient, [k, rows] x [rows, n] -> [E, k, n])."""
    flops = 2.0 * rows * k * n
    w = experts * k * n * BF16
    if weight_out:
        nbytes = rows * k * BF16 + rows * n * BF16 + w
    else:
        nbytes = rows * k * BF16 + w + rows * n * BF16
    return bound_s(flops, nbytes)


def gmm_step_bound_s(s: Shapes, micro_batch: int, seq: int,
                     recompute_ffn: bool) -> Dict[str, float]:
    """Bound of the grouped products (B4a, B4b) of one MoE layer and
    micro-batch of a training step, at tokens x top_k rows: the forward's
    two products (again when the FFN is recomputed), the backward's two
    input gradients (B4a) and two weight gradients (B4b)."""
    rows = micro_batch * seq * s.top_k
    h, f, e = s.hidden, s.ffn, s.experts
    fwd = _gmm_bound(rows, h, 2 * f, e, False) + _gmm_bound(rows, f, h, e,
                                                             False)
    b4a = fwd * (2 if recompute_ffn else 1)
    b4a += _gmm_bound(rows, h, f, e, False)  # d(act) = dY . wo^T
    b4a += _gmm_bound(rows, 2 * f, h, e, False)  # dX = d(gate, up) . wi^T
    b4b = (_gmm_bound(rows, f, h, e, True)  # d wo
           + _gmm_bound(rows, h, 2 * f, e, True))  # d wi
    return {"B4a": b4a, "B4b": b4b}


def gmm_launches(recompute_ffn: bool) -> Dict[str, int]:
    """Launches of B4a and B4b per MoE layer and micro-batch."""
    return {"B4a": 6 if recompute_ffn else 4, "B4b": 2}


def lm_head_chunk(s: Shapes, rows: int) -> Dict[str, float]:
    """One chunk of the fused LM head and CE over `rows` rows: the fp32
    logits product [rows, H] x [H, V] (the head's values in fp32, hidden
    rows in the compute dtype), its log-sum-exp and label pick."""
    flops = 2.0 * rows * s.hidden * s.vocab
    nbytes = (rows * s.hidden * BF16 + s.vocab * s.hidden * FP32
              + rows * s.vocab * FP32)
    return {"flops": flops, "bytes": nbytes,
            "bound_s": bound_s(flops, nbytes)}
