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

Under tensor parallelism the embedding and the head are cut by
vocabulary (parallel/sharding.py's 'vocab' -> tensor rule): tensor rank t
holds rows [t V/tp, (t+1) V/tp). The lookup and both CEs then run
vocab-parallel (Megatron's vocab-parallel embedding and CE) over the
port's differentiable collectives: the lookup takes this rank's rows and
zeros elsewhere and sums over the tensor group; the CE shifts the local
logits by their all-reduced max (detached), sums the shifted exp-sum,
the target logit (0 off this rank's range) and, with label smoothing,
the logits' sum over the group in one all-reduce, and the hidden rows
enter through copy_to so that their gradient sums over the ranks. The
body is written once over a reducer: `GroupReducer` (one slice a rank,
all-reduces over a process group) or `LocalReducer` (every slice in one
process: `virtual_vocab_ce_sums` / `virtual_vocab_lookup`, which the card
check and the tests run, as ops/ring_attention.py's
virtual_ring_attention plays the ring).

Metric values are detached scalars; the loss keeps its graph.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from luminaai_tpu_torch.monitoring.attribution import CE_SCOPE
from luminaai_tpu_torch.parallel.mesh import copy_to, reduce_from


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    loss_mask: Optional[torch.Tensor] = None,
    loss_weights: Optional[torch.Tensor] = None,
    z_loss_weight: float = 0.0,
    label_smoothing: float = 0.0,
    tensor_group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted masked CE. logits [B, S, V]; labels [B, S], already
    shifted by the caller; loss_mask zeroes padding; loss_weights carries
    per-token emphasis. Under `tensor_group` the logits are this tensor
    rank's vocab slice [B, S, V/tp] (Embedder.decode's) and the CE is
    vocab-parallel over the group."""
    logits = logits.float()
    if tensor_group is None:
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
        nll = lse - label_logit
        if label_smoothing > 0.0:
            smooth = lse - logits.mean(dim=-1)
            nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    else:
        nll, lse = _vocab_nll([logits], *_group_slices(logits.shape[-1],
                                                       tensor_group),
                              labels, label_smoothing,
                              GroupReducer(tensor_group))

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
    tensor_group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LM head + CE fused over sequence chunks; the same (loss, metrics)
    as the unfused path. hidden [B, S, H] (final-norm output); embedding
    [V, H] (the tied head's fp32 table; this tensor rank's [V/tp, H] slice
    under `tensor_group`); labels/mask/weights as in cross_entropy_loss."""
    weights = torch.ones(hidden.shape[:2], dtype=torch.float32,
                         device=hidden.device)
    if loss_mask is not None:
        weights = weights * loss_mask.float()
    if loss_weights is not None:
        weights = weights * loss_weights.float()

    sums = fused_lm_head_ce_sums(
        hidden, embedding, labels, weights,
        label_smoothing=label_smoothing, chunk_size=chunk_size,
        tensor_group=tensor_group,
    )
    return ce_from_sums(*sums, z_loss_weight=z_loss_weight)


def ce_from_sums(nll_sum, w_sum, z_sum, n_tok, z_loss_weight: float = 0.0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of the fused CE's [4] sums: the weighted mean NLL,
    plus the z-loss under z_loss_weight."""
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
    """(nll_sum, w_sum, z_sum, n_tok) of one chunk, as one [4] tensor,
    inside the profiler scope `fused_ce` (monitoring/attribution.py): the
    forward and its recompute in the backward."""
    with torch.profiler.record_function(CE_SCOPE):
        return _chunk_sums(head, h_c, l_c, w_c, label_smoothing)


def _chunk_sums(head, h_c, l_c, w_c, label_smoothing):
    logits = h_c.float() @ head.t()  # [B, c, V] fp32
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, l_c.long()[..., None])[..., 0]
    nll = lse - label_logit
    if label_smoothing > 0.0:
        smooth = lse - logits.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return _stats(nll, lse, w_c)


def _stats(nll, lse, w_c):
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
    tensor_group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum-form fused CE: (nll_sum, w_sum, z_sum, n_tok), un-normalised.
    The chunk is the largest size <= chunk_size that divides S. Under
    `tensor_group`, `embedding` is this tensor rank's vocab slice (rows
    [t V/tp, (t+1) V/tp) of the head) and the CE is vocab-parallel: every
    rank of the group gets the whole vocabulary's sums."""
    if tensor_group is not None:
        starts, vocab = _group_slices(embedding.shape[0], tensor_group)
        return _vocab_ce_sums(hidden, [embedding], starts, vocab,
                              GroupReducer(tensor_group), labels, weights,
                              label_smoothing, chunk_size)
    # The head's compute-dtype values as the fp32 operand, made once and
    # shared by every chunk (the JAX chunk body casts it per chunk).
    head = embedding.to(hidden.dtype).float()
    return _chunked(_chunk_stats, (head,), [head], hidden, labels, weights,
                    label_smoothing, chunk_size)


def _chunked(body, lead, heads, hidden, labels, weights, label_smoothing,
             chunk_size):
    """body(*lead, h_c, l_c, w_c, label_smoothing)'s [4] sums over the
    sequence chunks, each chunk under torch.utils.checkpoint when a
    gradient is wanted of the hidden rows or of `heads` (its logits
    recomputed in the backward)."""
    B, S, H = hidden.shape
    c = max(1, min(chunk_size, S))
    while S % c:
        c -= 1
    recompute = torch.is_grad_enabled() and (
        hidden.requires_grad or any(h.requires_grad for h in heads)
    )
    total = torch.zeros(4, dtype=torch.float32, device=hidden.device)
    for start in range(0, S, c):
        args = (*lead, hidden[:, start:start + c],
                labels[:, start:start + c], weights[:, start:start + c],
                label_smoothing)
        if recompute:
            total = total + checkpoint(body, *args, use_reentrant=False)
        else:
            total = total + body(*args)
    return total[0], total[1], total[2], total[3]


# --------------------------------------------------------------------------
# vocab-parallel lookup and CE
# --------------------------------------------------------------------------


class GroupReducer:
    """One vocab slice a rank over the ranks of a process group (the
    tensor group): each rank passes its own slice's partials, and sums
    and maxima are all-reduces over the group. `copy` is Megatron's f
    (identity forward, the backward sums the cotangents over the group),
    `sum` its g (all-reduce forward, identity backward), `max` detached."""

    def __init__(self, group):
        self.group = group

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.group)

    def sum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        (x,) = parts
        return reduce_from(x, self.group)

    def max(self, parts: List[torch.Tensor]) -> torch.Tensor:
        (x,) = parts
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y


class LocalReducer:
    """Every vocab slice in this process (the virtual forms): sums and
    maxima over the list; autograd sums the cotangents of a shared
    input itself."""

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def sum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def max(self, parts: List[torch.Tensor]) -> torch.Tensor:
        out = parts[0].detach()
        for p in parts[1:]:
            out = torch.maximum(out, p.detach())
        return out


def _group_slices(rows: int, group) -> Tuple[List[int], int]:
    """([first vocab id of this rank's slice], the whole vocab) for a
    slice of `rows` rows on each rank of `group` (tensor rank t holds rows
    [t rows, (t+1) rows): a group numbers its ranks in tensor order)."""
    return [dist.get_rank(group) * rows], rows * dist.get_world_size(group)


def _even_slices(t: torch.Tensor, n: int) -> Tuple[List[torch.Tensor],
                                                   List[int]]:
    """t's rows cut into n equal slices (views) and their first rows."""
    V = t.shape[0]
    if n < 1 or V % n:
        raise ValueError(f"vocab {V} does not divide into {n} slices")
    rows = V // n
    return list(t.split(rows)), [k * rows for k in range(n)]


def _vocab_nll(logits: List[torch.Tensor], starts: List[int], vocab: int,
               labels: torch.Tensor, label_smoothing: float, red
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse) over the whole vocabulary from logits cut by it:
    logits[k] [.., V_k] fp32 are columns [starts[k], starts[k] + V_k) of
    the whole [.., vocab] logits. The shift is the all-reduced max,
    detached (the lse does not depend on it); the shifted exp-sum, the
    target logit (0 off a slice's range) and, with label smoothing, the
    logits' sum are reduced in one sum."""
    m = red.max([lg.detach().amax(dim=-1) for lg in logits])
    labels = labels.long()
    parts = []
    for lg, lo in zip(logits, starts):
        local = labels - lo
        inside = (local >= 0) & (local < lg.shape[-1])
        target = lg.gather(-1, local.clamp(0, lg.shape[-1] - 1)[..., None]
                           )[..., 0]
        cols = [torch.exp(lg - m[..., None]).sum(dim=-1),
                torch.where(inside, target, torch.zeros_like(target))]
        if label_smoothing > 0.0:
            cols.append(lg.sum(dim=-1))
        parts.append(torch.stack(cols, dim=-1))
    s = red.sum(parts)
    lse = m + torch.log(s[..., 0])
    nll = lse - s[..., 1]
    if label_smoothing > 0.0:
        smooth = lse - s[..., 2] / vocab
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll, lse


def _vocab_chunk_stats(heads, starts, vocab, red, h_c, l_c, w_c,
                       label_smoothing):
    """_chunk_stats over the head cut by vocabulary: `heads` the slices'
    fp32 operands, `starts` their first vocab ids."""
    with torch.profiler.record_function(CE_SCOPE):
        h = red.copy(h_c.float())
        logits = [h @ head.t() for head in heads]  # [B, c, V_k] fp32
        nll, lse = _vocab_nll(logits, starts, vocab, l_c, label_smoothing,
                              red)
        return _stats(nll, lse, w_c)


def _vocab_ce_sums(hidden, slices, starts, vocab, red, labels, weights,
                   label_smoothing, chunk_size):
    heads = [s.to(hidden.dtype).float() for s in slices]
    return _chunked(_vocab_chunk_stats, (heads, starts, vocab, red), heads,
                    hidden, labels, weights, label_smoothing, chunk_size)


def virtual_vocab_ce_sums(
    hidden: torch.Tensor,
    head: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    n: int,
    label_smoothing: float = 0.0,
    chunk_size: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """fused_lm_head_ce_sums with the whole head [V, H] cut into n vocab
    slices in this process: the vocab-parallel CE's body over n virtual
    tensor ranks (LocalReducer), the same sums and gradients up to the
    order of the sums."""
    slices, starts = _even_slices(head, n)
    return _vocab_ce_sums(hidden, slices, starts, head.shape[0],
                          LocalReducer(), labels, weights, label_smoothing,
                          chunk_size)


def _vocab_lookup(tables, starts, tokens, red, dtype):
    """The rows of `tokens` from a table cut by vocabulary: each slice
    gives its own rows in `dtype` and zeros for the others, then the
    reducer sums them (exact: one term of each sum is not zero)."""
    parts = []
    for table, lo in zip(tables, starts):
        local = tokens.long() - lo
        inside = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)].to(dtype)
        parts.append(torch.where(inside[..., None], rows,
                                 torch.zeros_like(rows)))
    return red.sum(parts)


def vocab_parallel_lookup(table: torch.Tensor, tokens: torch.Tensor,
                          tensor_group, dtype=None) -> torch.Tensor:
    """table[tokens] in `dtype` (the table's by default) where each rank
    of `tensor_group` holds its vocab slice `table` (rows [t V/tp,
    (t+1) V/tp)): its rows, zeros elsewhere, summed over the group
    (reduce_from: the gradient reaches each rank's rows unchanged)."""
    starts, _ = _group_slices(table.shape[0], tensor_group)
    return _vocab_lookup([table], starts, tokens,
                         GroupReducer(tensor_group), dtype or table.dtype)


def virtual_vocab_lookup(embedding: torch.Tensor, tokens: torch.Tensor,
                         n: int, dtype=None) -> torch.Tensor:
    """embedding[tokens] through the vocab-parallel lookup's body over n
    slices of the whole table in this process (equal to the whole
    lookup)."""
    slices, starts = _even_slices(embedding, n)
    return _vocab_lookup(slices, starts, tokens, LocalReducer(),
                         dtype or embedding.dtype)


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
