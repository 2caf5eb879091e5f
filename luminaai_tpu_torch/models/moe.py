"""Mixture-of-experts layer (PyTorch counterpart of luminaai_tpu/models/moe.py).

Top-k routed expert FFN with per-group expert capacity, as the JAX
`MoELayer` computes it: x [G, S, H] holds G routing groups (the batch
rows; in decode one lane each) of S tokens; each expert takes at most C =
ceil8(int(cf * S * k / E)) (token, choice) pairs per group, granted
round-major (every token's first choice in sequence order, then the second
choices); pairs past capacity are dropped and their gate is 0.

- Router: fp32 logits x @ router [H, E], divided by the temperature; in
  training Gaussian routing noise and whole-expert dropout, drawn from the
  train step's torch.Generator (not JAX's numbers) before the layer loop,
  so a block recomputed under checkpoint routes as its forward did.
- `sort_routing`, `slot_rows`: `_sort_routing` (:35) and `_slot_rows`
  (:95).
- Dispatch 'sort' (:335-384, :453-463): a scatter into [E, G, C, H]
  capacity buffers, dense expert products, a gather back by slot.
- Dispatch 'gmm' (`gmm_local`, :837-929): the pairs sorted by expert into
  one buffer padded up to 128 rows, the two expert products through the
  grouped matmul (ops/gmm.py, kernel B4 on the card), with the JAX
  `row_kept` operand masks kept though the port's kernel writes zeros.
- The load-balancing and z losses and the router-health metrics (:468-507).

'gather', 'einsum' and 'a2a' dispatch, int8 experts and the multi-device
branches (the JAX `_gmm_path` under shard_map, `_a2a_path`) are not ported
(ROADMAP queue A); they are refused where the layer is built.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.ops.gmm import grouped_matmul

# The megablox m tile: the sorted row buffer is padded up to it (the JAX
# _GMM_ROW_TILE); pad rows sit past sum(group_sizes).
GMM_ROW_TILE = 128
PORTED_DISPATCH = ("sort", "gmm")
# The router's init std (the JAX layer's default_init(0.02), not init_std).
ROUTER_INIT_STD = 0.02
# Hook, as the JAX package's _GMM_OVERRIDE: a grouped-matmul function with
# grouped_matmul's signature to run instead of it (chip_smoke.py re-runs a
# step through the plain version with it). None runs ops/gmm's.
GMM_OVERRIDE = None


def expert_capacity(config: Config, seq: int) -> int:
    """Per-group expert capacity C for groups of `seq` tokens."""
    c = max(1, int(config.capacity_factor * seq * config.moe_top_k
                   / config.num_experts))
    if c >= 8:
        c = ((c + 7) // 8) * 8
    return c


def sort_routing(probs: torch.Tensor, top_k: int, capacity: int):
    """Sort-based top-k assignment with per-expert capacity (the JAX
    `_sort_routing`). probs [G, S, E] -> (slot [G, S, k] int64 flat slot
    e * C + pos, E * C for a dropped pair; gate [G, S, k] renormalised
    top-k probabilities, 0 where dropped; dropped [G, S] 1.0 where a token
    lost a slot; counts [G, E] kept pairs per expert)."""
    G, S, E = probs.shape
    C, n = capacity, S * top_k
    # Stable descending sort: ties keep the lower expert first, as
    # jax.lax.top_k does.
    vals, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, choice = vals[..., :top_k], choice[..., :top_k]
    gates = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    # Pair p = r * S + s: round-major FIFO priority.
    e_flat = choice.transpose(1, 2).reshape(G, n)
    ar = torch.arange(n, device=probs.device)
    order = torch.argsort(e_flat * n + ar, dim=-1)
    e_sorted = torch.gather(e_flat, 1, order)
    counts_all = F.one_hot(e_flat, E).sum(dim=1)  # [G, E] before capacity
    starts = torch.cumsum(counts_all, dim=1) - counts_all
    pos_sorted = ar - torch.gather(starts, 1, e_sorted)
    slot_sorted = torch.where(pos_sorted < C, e_sorted * C + pos_sorted,
                              E * C)
    slot_flat = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    slot = slot_flat.reshape(G, top_k, S).transpose(1, 2)
    keep = slot < E * C
    gate = torch.where(keep, gates, torch.zeros_like(gates))
    dropped = (1.0 - keep.to(probs.dtype)).sum(-1).clamp(0.0, 1.0)
    counts = torch.minimum(counts_all, torch.tensor(C, device=probs.device))
    return slot, gate, dropped, counts


def slot_rows(buf_egch: torch.Tensor, slot: torch.Tensor, capacity: int):
    """Rows [G, S, k, H] of an expert-major [E, G, C, H] buffer by flat
    slot id; a dropped pair's sentinel clamps onto an arbitrary row that
    `kept` [G, S, k, 1] annihilates (the JAX `_slot_rows`)."""
    E, G = buf_egch.shape[0], slot.shape[0]
    sl = torch.clamp(slot, max=E * capacity - 1)
    groups = torch.arange(G, device=slot.device)[:, None, None]
    rows = buf_egch[sl // capacity, groups, sl % capacity]
    kept = (slot < E * capacity).to(buf_egch.dtype)[..., None]
    return rows, kept


def gmm_local(x: torch.Tensor, probs: torch.Tensor, wi: torch.Tensor,
              wo: torch.Tensor, *, top_k: int, capacity: int, dtype,
              gmm_fn=grouped_matmul):
    """The ragged grouped-matmul expert FFN of one device (the JAX
    `_gmm_local` with ep_axis None). Returns (out [G, S, H], tokens per
    expert [E] fp32, dropped [G, S]). Nothing here reads the device on the
    host: the group sizes stay a device tensor."""
    G, S, H = x.shape
    E, k, C = wi.shape[0], top_k, capacity
    n = G * S * k
    slot, gate, dropped, counts = sort_routing(probs, k, C)
    gate = gate.to(dtype)
    # Pair p = ((g * S) + s) * k + r -> its expert; dropped pairs get E and
    # sort after every real expert's run (excluded through group_sizes).
    e_pair = torch.where(slot < E * C, slot // C, E).reshape(-1)
    group_sizes = counts.sum(0).to(torch.int32)
    perm = torch.argsort(e_pair, stable=True)
    x_flat = x.to(dtype).reshape(G * S, H)
    n_pad = -(-n // GMM_ROW_TILE) * GMM_ROW_TILE
    row_kept = (torch.arange(n_pad, device=x.device)[:, None]
                < group_sizes.sum())
    rows = x_flat[perm // k]
    if n_pad != n:
        rows = F.pad(rows, (0, 0, 0, n_pad - n))
    lhs = torch.where(row_kept, rows, torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device))
    fused = gmm_fn(lhs, wi.to(dtype), group_sizes, dtype)
    gate_act, up = torch.chunk(fused, 2, dim=-1)
    act = torch.where(row_kept, F.silu(gate_act) * up,
                      torch.zeros((), dtype=fused.dtype, device=x.device))
    yrow = gmm_fn(act.contiguous(), wo.to(dtype), group_sizes, dtype)
    yrow = torch.where(row_kept, yrow,
                       torch.zeros((), dtype=yrow.dtype, device=x.device))[:n]
    inv_perm = torch.argsort(perm)
    y_pairs = yrow[inv_perm].reshape(G, S, k, H)
    out = torch.einsum("gskh,gsk->gsh", y_pairs, gate)
    return out, group_sizes.to(torch.float32), dropped


class MoELayer(nn.Module):
    """Top-k routed expert FFN.

    Parameters: `router` [H, E] (fp32 in every build: routing runs in
    fp32), `wi` [E, H, 2F] (gate and up fused, as the JAX layer) and `wo`
    [E, F, H]; fp32 with gradients in a trainable build (cast to the
    compute dtype at each use), the compute dtype otherwise.
    """

    def __init__(self, config: Config, dtype=torch.bfloat16, device=None,
                 trainable: bool = False):
        super().__init__()
        if config.moe_dispatch not in PORTED_DISPATCH:
            raise NotImplementedError(
                f"moe_dispatch={config.moe_dispatch!r} is not ported yet "
                f"(ROADMAP queue A); the port runs {PORTED_DISPATCH}"
            )
        self.config = config
        self.dtype = dtype
        H, E, Fi = config.hidden_size, config.num_experts, (
            config.intermediate_size)
        kw = dict(dtype=torch.float32 if trainable else dtype, device=device)
        self.router = nn.Parameter(
            torch.empty(H, E, dtype=torch.float32, device=device),
            requires_grad=trainable,
        )
        self.wi = nn.Parameter(torch.empty(E, H, 2 * Fi, **kw),
                               requires_grad=trainable)
        self.wo = nn.Parameter(torch.empty(E, Fi, H, **kw),
                               requires_grad=trainable)

    def draw_routing(self, G: int, S: int,
                     generator: Optional[torch.Generator],
                     device) -> Optional[Dict[str, torch.Tensor]]:
        """The training-time random draws of one forward (routing noise
        [G, S, E] standard normal, expert-dropout uniforms [E]), or None
        when the config draws none. The model draws them before the layer
        loop, so a block recomputed under checkpoint routes the same way."""
        cfg = self.config
        draws = {}
        if cfg.routing_noise_std > 0:
            draws["noise"] = torch.randn(
                (G, S, cfg.num_experts), generator=generator, device=device,
                dtype=torch.float32)
        if cfg.expert_dropout_rate > 0:
            draws["expert_u"] = torch.rand(
                cfg.num_experts, generator=generator, device=device)
        return draws or None

    def route(self, x: torch.Tensor,
              draws: Optional[Dict[str, torch.Tensor]] = None):
        """(fp32 router logits, softmax probabilities) [G, S, E]; `draws`
        (draw_routing) adds the training-time noise and expert dropout."""
        cfg = self.config
        logits = x.float() @ self.router
        logits = logits / cfg.routing_temperature
        draws = draws or {}
        if "noise" in draws:
            logits = logits + draws["noise"] * cfg.routing_noise_std
        if "expert_u" in draws:
            # Whole-expert dropout: a Bernoulli subset of experts leaves
            # routing for this step; keep all where the draw kept none.
            keep = draws["expert_u"] < 1.0 - cfg.expert_dropout_rate
            keep = keep | ~keep.any()
            logits = torch.where(keep, logits,
                                 torch.full_like(logits, -1e9))
        return logits, torch.softmax(logits, dim=-1)

    def forward(self, x: torch.Tensor,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x [G, S, H] -> (out [G, S, H] in the compute dtype, metrics).
        Deterministic unless `draws` (draw_routing) are given."""
        cfg = self.config
        G, S, H = x.shape
        E, k = cfg.num_experts, cfg.moe_top_k
        C = expert_capacity(cfg, S)
        logits, probs = self.route(x, draws)

        if cfg.moe_dispatch == "gmm":
            out, tokens_per_expert, dropped = gmm_local(
                x, probs, self.wi, self.wo, top_k=k, capacity=C,
                dtype=self.dtype, gmm_fn=GMM_OVERRIDE or grouped_matmul,
            )
        else:  # sort
            slot, gate, dropped, counts = sort_routing(probs, k, C)
            gate = gate.to(self.dtype)
            tok = torch.arange(S, device=x.device)[:, None].expand(S, k)
            tok = tok.reshape(-1)
            # Spill row E*C absorbs the dropped pairs and is sliced off.
            buf = torch.zeros(G, E * C + 1, H, dtype=self.dtype,
                              device=x.device)
            groups = torch.arange(G, device=x.device)[:, None]
            buf = buf.index_put((groups, slot.reshape(G, S * k)),
                                x.to(self.dtype)[:, tok])
            expert_in = buf[:, : E * C].reshape(G, E, C, H).transpose(0, 1)
            fused = torch.einsum("egch,ehf->egcf", expert_in,
                                 self.wi.to(self.dtype))
            gate_act, up = torch.chunk(fused, 2, dim=-1)
            act = F.silu(gate_act) * up
            expert_out = torch.einsum("egcf,efh->egch", act,
                                      self.wo.to(self.dtype))
            y, _ = slot_rows(expert_out, slot, C)
            out = torch.einsum("gskh,gsk->gsh", y, gate)
            tokens_per_expert = counts.to(torch.float32).sum(0)
        if cfg.expert_output_scaling != 1.0:
            out = out * cfg.expert_output_scaling

        # Aux losses and router health (fp32).
        f = tokens_per_expert / (G * S * k + 1e-9)
        p = probs.mean(dim=(0, 1))
        lse2 = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        entropy = -torch.mean(
            torch.sum(probs * torch.log(probs + 1e-9), dim=-1))
        aux_loss = torch.clamp(
            torch.sum(f * p) * E * cfg.load_balancing_weight, max=1.0)
        metrics = {
            "moe_aux_loss": aux_loss,
            "moe_z_loss": lse2 * cfg.router_z_loss_weight,
            "moe_drop_rate": dropped.mean(),
            "expert_utilization": f * E,  # 1.0 == perfectly balanced
            "moe_router_entropy": entropy,
            "moe_max_expert_share": f.max() / (f.sum() + 1e-9),
        }
        return out.to(self.dtype), metrics
