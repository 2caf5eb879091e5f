"""Fused loss and gradient ops (PyTorch counterpart of luminaai_tpu/ops/fused.py).

The JAX package leaves these to XLA (no Pallas kernel), so the port writes
them as plain PyTorch: a single logsumexp pass, the label logit gathered
instead of a one-hot [B, S, V], fp32 accumulation. The fused LM-head loss
runs the head matmul per sequence chunk under torch.utils.checkpoint, so
only one chunk's logits [B, c, V] exist at a time, in the forward and
again in the backward (recomputed), and [B, S, V] logits never do.

Chunk logits are an fp32 product of the hidden rows and the head's
compute-dtype values (bf16 operands, fp32 accumulation and output, as the
JAX einsum with preferred_element_type=float32 gives). On the card this
fp32 GEMM is slower than a bf16 one; its time is in PERF.md.

Metric values are detached scalars; the loss keeps its graph.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    loss_mask: Optional[torch.Tensor] = None,
    loss_weights: Optional[torch.Tensor] = None,
    z_loss_weight: float = 0.0,
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted masked CE. logits [B, S, V]; labels [B, S], already
    shifted by the caller; loss_mask zeroes padding; loss_weights carries
    per-token emphasis."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if label_smoothing > 0.0:
        smooth = lse - logits.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth

    weights = torch.ones_like(nll)
    if loss_mask is not None:
        weights = weights * loss_mask.float()
    if loss_weights is not None:
        weights = weights * loss_weights.float()

    denom = weights.sum().clamp(min=1.0)
    loss = (nll * weights).sum() / denom
    metrics = {
        "ce_loss": loss.detach(),
        "perplexity": torch.exp(loss.detach().clamp(max=20.0)),
        "tokens_in_loss": (weights > 0).sum().float(),
    }
    if z_loss_weight > 0.0:
        in_loss = weights > 0
        z = (torch.square(lse) * in_loss).sum() / denom * z_loss_weight
        loss = loss + z
        metrics["z_loss"] = z.detach()
    metrics["total_loss"] = loss.detach()
    return loss, metrics


def fused_lm_head_cross_entropy(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    labels: torch.Tensor,
    loss_mask: Optional[torch.Tensor] = None,
    loss_weights: Optional[torch.Tensor] = None,
    z_loss_weight: float = 0.0,
    label_smoothing: float = 0.0,
    chunk_size: int = 256,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LM head + CE fused over sequence chunks; the same (loss, metrics)
    as the unfused path. hidden [B, S, H] (final-norm output); embedding
    [V, H] (the tied head's fp32 table); labels/mask/weights as in
    cross_entropy_loss."""
    weights = torch.ones(hidden.shape[:2], dtype=torch.float32,
                         device=hidden.device)
    if loss_mask is not None:
        weights = weights * loss_mask.float()
    if loss_weights is not None:
        weights = weights * loss_weights.float()

    nll_sum, w_sum, z_sum, n_tok = fused_lm_head_ce_sums(
        hidden, embedding, labels, weights,
        label_smoothing=label_smoothing, chunk_size=chunk_size,
    )
    denom = w_sum.clamp(min=1.0)
    loss = nll_sum / denom
    metrics = {
        "ce_loss": loss.detach(),
        "perplexity": torch.exp(loss.detach().clamp(max=20.0)),
        "tokens_in_loss": n_tok.detach(),
    }
    if z_loss_weight > 0.0:
        z = z_sum / denom * z_loss_weight
        loss = loss + z
        metrics["z_loss"] = z.detach()
    metrics["total_loss"] = loss.detach()
    return loss, metrics


def _chunk_stats(head, h_c, l_c, w_c, label_smoothing):
    """(nll_sum, w_sum, z_sum, n_tok) of one chunk, as one [4] tensor."""
    logits = h_c.float() @ head.t()  # [B, c, V] fp32
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, l_c.long()[..., None])[..., 0]
    nll = lse - label_logit
    if label_smoothing > 0.0:
        smooth = lse - logits.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    in_loss = (w_c > 0).float()
    return torch.stack([
        (nll * w_c).sum(),
        w_c.sum(),
        (torch.square(lse) * in_loss).sum(),
        in_loss.sum(),
    ])


def fused_lm_head_ce_sums(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    label_smoothing: float = 0.0,
    chunk_size: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum-form fused CE: (nll_sum, w_sum, z_sum, n_tok), un-normalised.
    The chunk is the largest size <= chunk_size that divides S."""
    B, S, H = hidden.shape
    c = max(1, min(chunk_size, S))
    while S % c:
        c -= 1
    # The head's compute-dtype values as the fp32 operand, made once and
    # shared by every chunk (the JAX chunk body casts it per chunk).
    head = embedding.to(hidden.dtype).float()
    recompute = torch.is_grad_enabled() and (
        hidden.requires_grad or head.requires_grad
    )
    total = torch.zeros(4, dtype=torch.float32, device=hidden.device)
    for start in range(0, S, c):
        args = (head, hidden[:, start:start + c], labels[:, start:start + c],
                weights[:, start:start + c], label_smoothing)
        if recompute:
            total = total + checkpoint(_chunk_stats, *args,
                                       use_reentrant=False)
        else:
            total = total + _chunk_stats(*args)
    return total[0], total[1], total[2], total[3]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm over a list of tensors, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def clip_by_global_norm(
    grads: Sequence[torch.Tensor], max_norm: float
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Returns (clipped_grads, pre_clip_norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [(g * scale).to(g.dtype) for g in grads], norm
