"""Mixture-of-depths token routing (PyTorch counterpart of luminaai_tpu/models/mod.py).

A learned router picks, per sequence, the top C = max(1, int(S *
capacity_factor)) tokens (indices sorted, so causal order is kept); the
wrapped FFN runs on those rows only, gathered into [G, C, H], and its
output, times the router's sigmoid with the straight-through estimator
(forward 1, backward d sigmoid), is scatter-added back to their positions
in the compute dtype; the other tokens pass through the residual. A BCE
aux loss pulls the router's probabilities toward the realised selection.

Ties in the top-k go to the lower position, as jax.lax.top_k breaks them.
The JAX `stat_pmean_axes` (a pipeline's manual mesh axes) has no
counterpart on one card.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from luminaai_tpu_torch.config import Config

# The router's init std (the JAX MoDRouter's normal(0.01)); the bias
# starts at zero.
MOD_ROUTER_INIT_STD = 0.01


def mod_capacity(seq: int, capacity_factor: float) -> int:
    """Tokens per sequence that get the full FFN."""
    return max(1, int(seq * capacity_factor))


class MoDRouter(nn.Module):
    """Scores tokens; selects the top mod_capacity(S) per sequence, at
    the config's mod_capacity_factor and mod_routing_temperature as they
    stand at the call (Trainer.adjust_mod_capacity changes the first).

    Parameters (fp32 in every build, as routing runs in fp32): `router`
    [H, 1] and `bias` [1]."""

    def __init__(self, config: Config, dtype=torch.bfloat16, device=None,
                 trainable: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.router = nn.Parameter(
            torch.empty(config.hidden_size, 1, dtype=torch.float32,
                        device=device),
            requires_grad=trainable)
        self.bias = nn.Parameter(
            torch.zeros(1, dtype=torch.float32, device=device),
            requires_grad=trainable)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [G, S, H] -> (indices [G, C] int64 ascending, gate [G, C] in
        the compute dtype, BCE aux loss scalar fp32)."""
        G, S, _ = x.shape
        cfg = self.config
        capacity = mod_capacity(S, cfg.mod_capacity_factor)
        logits = ((x.float() @ self.router)[..., 0] + self.bias) / (
            cfg.mod_routing_temperature)  # [G, S]
        probs = torch.sigmoid(logits)
        # Stable descending sort: ties keep the lower position first.
        order = torch.sort(logits.detach(), dim=-1, descending=True,
                           stable=True).indices[:, :capacity]
        indices = torch.sort(order, dim=-1).values
        sel = torch.gather(probs, 1, indices)
        gate = sel + (1.0 - sel).detach()  # straight-through
        target = torch.zeros((G, S), dtype=torch.float32, device=x.device)
        target.scatter_(1, indices, 1.0)
        eps = 1e-6
        bce = -(target * torch.log(probs + eps)
                + (1 - target) * torch.log(1 - probs + eps)).mean()
        return indices, gate.to(self.dtype), bce


def apply_mod(router: MoDRouter, inner: Callable[[torch.Tensor],
                                                 torch.Tensor],
              x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run `inner` ([G, C, H] -> [G, C, H]) on the router's tokens only;
    zeros elsewhere (the block adds the result to its residual). Returns
    (out [G, S, H] in x's dtype, {"mod_aux_loss", "mod_compute_ratio"})."""
    from luminaai_tpu_torch.parallel.mesh import (
        active_mesh,
        gather_sum,
        mean_over,
    )

    mesh = active_mesh()
    sp = mesh.shape["sequence"] if mesh is not None else 1
    if sp > 1:  # the capacity is per whole sequence (as in MoE routing)
        Sl = x.shape[1]
        x = gather_sum(x, mesh.group("sequence"), dim=1)
    G, S, H = x.shape
    indices, gate, aux = router(x)
    rows = indices[..., None].expand(G, indices.shape[1], H)
    selected = torch.gather(x, 1, rows)
    out_sel = inner(selected) * gate[..., None]
    out = torch.zeros_like(x).scatter_add(1, rows, out_sel.to(x.dtype))
    if mesh is not None and mesh.stat_axes:
        aux = mean_over(aux, mesh.group(*mesh.stat_axes))
    if sp > 1:
        i0 = mesh.coords["sequence"] * Sl
        out = out[:, i0:i0 + Sl]
    metrics = {
        "mod_aux_loss": aux,
        "mod_compute_ratio": torch.tensor(indices.shape[-1] / S,
                                          dtype=torch.float32,
                                          device=x.device),
    }
    return out, metrics
