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
- Dispatch 'gather' (:347-371): the same buffers filled by a row gather
  through the inverted slot->token table, with the gather-only backward
  of `_dispatch_gather` (:114-170, `DispatchGather`).
- Dispatch 'einsum' (:385-395): `top_k_routing` (`_top_k_routing`,
  :172), one-hot [G, S, E, C] dispatch and combine products.
- Dispatch 'gmm' (`gmm_local`, :837-929): the pairs sorted by expert into
  one buffer padded up to 128 rows, the two expert products through the
  grouped matmul (ops/gmm.py, kernel B4 on the card), with the JAX
  `row_kept` operand masks kept though the port's kernel writes zeros.
- The load-balancing and z losses and the router-health metrics (:468-507).

The expert products of 'sort', 'gather' and 'einsum' are the dense
[E, G, C, .] torch matmuls (XLA's in JAX). int8 experts (quantized
serving: `wi`/`wo` QuantizedTensors over axis 1) run one int8 product an
expert (ops/quantized.int8_expert, JAX :420-435), and send 'gmm' and
'a2a' to 'gather' as the JAX layer does (:303-310): the grouped-matmul
kernel is bf16 only.

Over a mesh (parallel/mesh.active_mesh; the JAX `_gmm_path` under
shard_map, :515-647, and `_a2a_path`, :649-790): each expert rank holds
E / ep experts and each tensor rank its share of F (gate and up columns
of wi, rows of wo, parallel/sharding.py). 'gmm' (and 'sort', 'gather',
'einsum') run this rank's experts over the rank's tokens, the partial
outputs summed over the (expert, tensor) group; 'a2a' routes this rank's
1/ep of the groups to their experts' ranks (parallel/expert_dispatch.py)
and gathers the outputs back; without an expert axis 'a2a' is the local
grouped matmul, as in JAX. Under sequence parallelism the layer routes
the gathered whole sequences (capacity is per sequence) and keeps its
rows. The load-balancing and z statistics average over the batch's ranks
(Mesh.stat_axes), so the aux losses are the global batch's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.monitoring.attribution import EXPERTS_SCOPE, MOE_SCOPE
from luminaai_tpu_torch.ops.gmm import grouped_matmul
from luminaai_tpu_torch.ops.quantized import QuantizedTensor, int8_expert
from luminaai_tpu_torch.parallel.mesh import (
    active_mesh,
    all_gather,
    copy_to,
    gather_rows,
    gather_sum,
    mean_over,
    psum,
    reduce_from,
)

# The megablox m tile: the sorted row buffer is padded up to it (the JAX
# _GMM_ROW_TILE); pad rows sit past sum(group_sizes).
GMM_ROW_TILE = 128
PORTED_DISPATCH = ("sort", "gather", "einsum", "gmm", "a2a")
# The router's init std (the JAX layer's default_init(0.02), not init_std).
ROUTER_INIT_STD = 0.02
# Hook, as the JAX package's _GMM_OVERRIDE: a grouped-matmul function with
# grouped_matmul's signature to run instead of it (chip_smoke.py re-runs a
# step through the plain version with it). None runs ops/gmm's.
GMM_OVERRIDE = None


def _model_group(mesh):
    """The (expert, tensor) group whose ranks hold the partials of one
    expert FFN (None where both axes are 1)."""
    if mesh is None or mesh.shape["expert"] * mesh.shape["tensor"] == 1:
        return None
    return mesh.group("expert", "tensor")


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
    # [G, E] before capacity. A comparison, not F.one_hot, which checks
    # the ids' range with a host read on the CPU.
    experts = torch.arange(E, device=probs.device)
    counts_all = (e_flat[..., None] == experts).sum(dim=1)
    starts = torch.cumsum(counts_all, dim=1) - counts_all
    pos_sorted = ar - torch.gather(starts, 1, e_sorted)
    slot_sorted = torch.where(pos_sorted < C, e_sorted * C + pos_sorted,
                              E * C)
    slot_flat = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    slot = slot_flat.reshape(G, top_k, S).transpose(1, 2)
    keep = slot < E * C
    gate = torch.where(keep, gates, torch.zeros_like(gates))
    dropped = (1.0 - keep.to(probs.dtype)).sum(-1).clamp(0.0, 1.0)
    # clamp, not a minimum against torch.tensor(C, device=...): that copy
    # from pageable host memory makes the host wait for the card.
    counts = counts_all.clamp(max=C)
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


class DispatchGather(torch.autograd.Function):
    """expert_in[e, g, c] = x[g, inv_egc[e, g, c]], zero where the slot is
    unfilled (inv == S), with the JAX `_dispatch_gather` adjoint: the
    table is a bijection on kept slots and token t's kept slots are
    slot[g, t, :], so d_x is a row gather too (slot_rows), summed over the
    token's k choices; no H-wide scatter."""

    @staticmethod
    def forward(ctx, x, inv_egc, slot, capacity):
        G, S, _ = x.shape
        filled = (inv_egc < S)[..., None].to(x.dtype)
        groups = torch.arange(G, device=x.device)[None, :, None]
        ctx.save_for_backward(slot)
        ctx.capacity = capacity
        return x[groups, torch.clamp(inv_egc, max=S - 1)] * filled

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        rows, kept = slot_rows(g, slot, ctx.capacity)
        return (rows * kept).sum(dim=2), None, None, None


def top_k_routing(probs: torch.Tensor, top_k: int, capacity: int):
    """Greedy top-k assignment with per-expert capacity (the JAX
    `_top_k_routing`): k rounds of argmax (ties to the lower expert), each
    token's position in its expert's buffer counted in sequence order
    after the earlier rounds' kept pairs. Returns (dispatch, combine)
    [G, S, E, C] in probs' dtype (combine carries the renormalised top-k
    gate) and dropped [G, S]."""
    G, S, E = probs.shape
    dispatch = probs.new_zeros((G, S, E, capacity))
    combine = probs.new_zeros((G, S, E, capacity))
    denom = torch.topk(probs, top_k, dim=-1).values.sum(-1) + 1e-9
    expert_count = torch.zeros((G, E), dtype=torch.int32,
                               device=probs.device)
    cap = torch.arange(capacity, device=probs.device)
    experts = torch.arange(E, device=probs.device)  # F.one_hot syncs
    masked = probs
    drops = probs.new_zeros((G, S))
    for _ in range(top_k):
        choice = torch.argmax(masked, dim=-1)  # [G, S]
        onehot = (choice[..., None] == experts).to(probs.dtype)
        pos_in_expert = (torch.cumsum(onehot, dim=1) - onehot
                         + expert_count[:, None, :])
        pos = (pos_in_expert * onehot).sum(-1)
        within = (pos < capacity).to(probs.dtype)
        gate = torch.gather(probs, -1, choice[..., None])[..., 0] / denom
        # jax.nn.one_hot of a position past the buffer is all zeros.
        slot = (pos.long()[..., None] == cap).to(probs.dtype)
        contrib = onehot[..., None] * slot[:, :, None, :] * (
            within[..., None, None])
        dispatch = dispatch + contrib
        combine = combine + contrib * gate[..., None, None]
        drops = drops + (1.0 - within)
        expert_count = expert_count + torch.einsum(
            "gse,gs->ge", onehot, within).to(torch.int32)
        masked = masked * (1.0 - onehot)
    return dispatch, combine, drops.clamp(0.0, 1.0)


def gmm_local(x: torch.Tensor, probs: torch.Tensor, wi: torch.Tensor,
              wo: torch.Tensor, *, top_k: int, capacity: int, dtype,
              gmm_fn=grouped_matmul, ep_index: int = 0):
    """The ragged grouped-matmul expert FFN of one rank (the JAX
    `_gmm_local`). wi/wo hold E_l of the E = probs.shape[-1] experts,
    those from ep_index * E_l (expert parallel): pairs routed elsewhere
    sort to the excluded tail as dropped ones do, so `out` is this rank's
    partial. Returns (out [G, S, H], tokens per expert [E] fp32, dropped
    [G, S]). Nothing here reads the device on the host: the group sizes
    stay a device tensor."""
    G, S, H = x.shape
    E, k, C = probs.shape[-1], top_k, capacity
    E_l = wi.shape[0]
    n = G * S * k
    slot, gate, dropped, counts = sort_routing(probs, k, C)
    gate = gate.to(dtype)
    # Pair p = ((g * S) + s) * k + r -> its expert; dropped pairs get E and
    # sort after every real expert's run (excluded through group_sizes).
    e_pair = torch.where(slot < E * C, slot // C, E).reshape(-1)
    counts_e = counts.sum(0).to(torch.int32)
    group_sizes = counts_e
    if E_l != E:
        e_lo = ep_index * E_l
        loc = e_pair - e_lo
        e_pair = torch.where((loc >= 0) & (loc < E_l), loc, E_l)
        group_sizes = counts_e[e_lo:e_lo + E_l]
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
    with torch.profiler.record_function(EXPERTS_SCOPE):
        fused = gmm_fn(lhs, wi.to(dtype), group_sizes, dtype)
        gate_act, up = torch.chunk(fused, 2, dim=-1)
        act = torch.where(row_kept, F.silu(gate_act) * up,
                          torch.zeros((), dtype=fused.dtype,
                                      device=x.device))
        yrow = gmm_fn(act.contiguous(), wo.to(dtype), group_sizes, dtype)
    yrow = torch.where(row_kept, yrow,
                       torch.zeros((), dtype=yrow.dtype, device=x.device))[:n]
    inv_perm = torch.argsort(perm)
    y_pairs = yrow[inv_perm].reshape(G, S, k, H)
    out = torch.einsum("gskh,gsk->gsh", y_pairs, gate)
    return out, counts_e.to(torch.float32), dropped


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

    def _expert_product(self, x, w, spec: str) -> torch.Tensor:
        if isinstance(w, QuantizedTensor):
            return int8_expert(x, w, self.dtype)
        return torch.einsum(spec, x, w.to(self.dtype))

    def _experts(self, expert_in: torch.Tensor, mesh) -> torch.Tensor:
        """The expert FFN over capacity buffers [E, G, C, H]. On a mesh
        this rank runs its E_l experts (from expert index * E_l) over its
        share of F (tensor parallel), the partials sum over the tensor
        group and the experts' outputs gather over the expert group."""
        mp = _model_group(mesh)
        if mp is not None:
            lo = mesh.coords["expert"] * self.wi.shape[0]
            expert_in = copy_to(expert_in, mp)[lo:lo + self.wi.shape[0]]
        fused = self._expert_product(expert_in, self.wi, "egch,ehf->egcf")
        gate_act, up = torch.chunk(fused, 2, dim=-1)
        act = F.silu(gate_act) * up
        out = self._expert_product(act, self.wo, "egcf,efh->egch")
        if mp is not None:
            out = reduce_from(out, mesh.group("tensor"))
            out = gather_rows(out, mesh.group("expert"), 0)
        return out

    def _a2a(self, x, probs, capacity: int, mesh):
        """The a2a dispatch over the mesh's expert group (the JAX
        `_a2a_path`, :649): this rank routes its 1/ep of the groups,
        parallel/expert_dispatch.a2a_expert_ffn exchanges them, and the
        outputs gather back over the expert group. Returns (out,
        tokens_per_expert [E], dropped [G, S], stats)."""
        from luminaai_tpu_torch.parallel.expert_dispatch import (
            a2a_expert_ffn,
            export_plan_gauges,
            make_dispatch_plan,
        )

        cfg = self.config
        G, S, H = x.shape
        ep, e = mesh.shape["expert"], mesh.coords["expert"]
        if G % ep:
            raise ValueError(
                f"a2a dispatch needs batch groups ({G}) divisible by "
                f"the expert axis ({ep}) — EP borrows the data dimension")
        G_l, dcn = G // ep, max(1, cfg.expert_dcn_size)
        plan = make_dispatch_plan(
            ep=ep, dcn_size=dcn, local_groups=G_l, seq=S,
            top_k=cfg.moe_top_k, capacity=capacity,
            num_experts=cfg.num_experts, hidden=H,
            itemsize=torch.tensor([], dtype=self.dtype).element_size(),
            overlap_chunks=max(1, cfg.moe_a2a_overlap_chunks), dp_groups=G)
        export_plan_gauges(plan)
        mp = _model_group(mesh)
        rows = slice(e * G_l, (e + 1) * G_l)
        eg = mesh.group("expert")
        out, tpe, dropped, stats = a2a_expert_ffn(
            copy_to(x, mp)[rows], copy_to(probs, mp)[rows], self.wi,
            self.wo, top_k=cfg.moe_top_k, capacity=capacity,
            num_experts=cfg.num_experts, dtype=self.dtype,
            gmm_fn=GMM_OVERRIDE or grouped_matmul, ep_group=eg,
            ep_index=e, plan=plan,
            tiers=mesh.tier_groups("expert", dcn) if dcn > 1 else None,
            tp_group=mesh.group("tensor"))
        tok = mesh.group("data", "fsdp", "expert")
        stats = {n: psum(v, tok) for n, v in stats.items()}
        return (gather_rows(out, eg, 0), psum(tpe, eg),
                all_gather(dropped, eg, axis=0), stats)

    def forward(self, x: torch.Tensor,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x [G, S, H] -> (out [G, S, H] in the compute dtype, metrics).
        Deterministic unless `draws` (draw_routing) are given. Runs inside
        the profiler scope `moe`, its expert FFN inside `moe/experts`
        (monitoring/attribution.py)."""
        with torch.profiler.record_function(MOE_SCOPE):
            return self._route_and_combine(x, draws)

    def _route_and_combine(self, x, draws):
        cfg = self.config
        mesh = active_mesh()
        sp = mesh.shape["sequence"] if mesh is not None else 1
        if sp > 1:
            # Routing capacity is per whole sequence: every sequence rank
            # routes the gathered sequence and keeps its own rows.
            Sl = x.shape[1]
            x = gather_sum(x, mesh.group("sequence"), dim=1)
        G, S, H = x.shape
        E, k = cfg.num_experts, cfg.moe_top_k
        C = expert_capacity(cfg, S)
        logits, probs = self.route(x, draws)

        mode = cfg.moe_dispatch
        if mode in ("gmm", "a2a") and isinstance(self.wi, QuantizedTensor):
            mode = "gather"  # the grouped-matmul kernel is bf16 only
        ep = mesh.shape["expert"] if mesh is not None else 1
        stats = {}
        if mode == "a2a" and ep > 1:
            out, tokens_per_expert, dropped, stats = self._a2a(
                x, probs, C, mesh)
        elif mode in ("gmm", "a2a"):
            # 'a2a' without an expert axis is the local grouped matmul,
            # as in JAX.
            mp = _model_group(mesh)
            out, tokens_per_expert, dropped = gmm_local(
                copy_to(x, mp), copy_to(probs, mp), self.wi, self.wo,
                top_k=k, capacity=C, dtype=self.dtype,
                gmm_fn=GMM_OVERRIDE or grouped_matmul,
                ep_index=mesh.coords["expert"] if mesh is not None else 0,
            )
            out = reduce_from(out, mp)
        else:
            if mode == "einsum":
                dispatch, combine_w, dropped = top_k_routing(probs, k, C)
                dispatch = dispatch.to(self.dtype)
                combine_w = combine_w.to(self.dtype)
                expert_in = torch.einsum("gsec,gsh->egch", dispatch,
                                         x.to(self.dtype))
                tokens_per_expert = dispatch.float().sum(dim=(0, 1, 3))
            else:  # sort, gather
                slot, gate, dropped, counts = sort_routing(probs, k, C)
                gate = gate.to(self.dtype)
                tok = torch.arange(S, device=x.device)[:, None].expand(S, k)
                tok = tok.reshape(-1)
                groups = torch.arange(G, device=x.device)[:, None]
                if mode == "gather":
                    # slot -> token table (S where unfilled; the spill
                    # column E*C takes the dropped pairs), then a row
                    # gather straight into the [E, G, C, H] layout.
                    inv = torch.full((G, E * C + 1), S, dtype=torch.long,
                                     device=x.device)
                    inv = inv.index_put((groups, slot.reshape(G, S * k)),
                                        tok.expand(G, S * k))
                    inv_egc = inv[:, : E * C].reshape(G, E, C).transpose(
                        0, 1)
                    expert_in = DispatchGather.apply(
                        x.to(self.dtype), inv_egc, slot, C)
                else:
                    # Spill row E*C absorbs the dropped pairs and is
                    # sliced off.
                    buf = torch.zeros(G, E * C + 1, H, dtype=self.dtype,
                                      device=x.device)
                    buf = buf.index_put((groups, slot.reshape(G, S * k)),
                                        x.to(self.dtype)[:, tok])
                    expert_in = buf[:, : E * C].reshape(G, E, C, H)
                    expert_in = expert_in.transpose(0, 1)
                tokens_per_expert = counts.to(torch.float32).sum(0)
            with torch.profiler.record_function(EXPERTS_SCOPE):
                expert_out = self._experts(expert_in, mesh)
            if mode == "einsum":
                out = torch.einsum("gsec,egch->gsh", combine_w, expert_out)
            else:
                y, _ = slot_rows(expert_out, slot, C)
                out = torch.einsum("gskh,gsk->gsh", y, gate)
        if cfg.expert_output_scaling != 1.0:
            out = out * cfg.expert_output_scaling

        # Aux losses and router health (fp32), over the global batch: on
        # a mesh the means over this rank's groups average over the
        # batch's ranks (Mesh.stat_axes; () for per-shard statistics).
        f = tokens_per_expert / (G * S * k + 1e-9)
        p = probs.mean(dim=(0, 1))
        lse2 = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        entropy = -torch.mean(
            torch.sum(probs * torch.log(probs + 1e-9), dim=-1))
        drop = dropped.mean()
        if mesh is not None and mesh.stat_axes:
            g = mesh.group(*mesh.stat_axes)
            f, p, lse2, entropy = (mean_over(t, g)
                                   for t in (f, p, lse2, entropy))
            drop = mean_over(drop, g)
        aux_loss = torch.clamp(
            torch.sum(f * p) * E * cfg.load_balancing_weight, max=1.0)
        metrics = {
            "moe_aux_loss": aux_loss,
            "moe_z_loss": lse2 * cfg.router_z_loss_weight,
            "moe_drop_rate": drop,
            "expert_utilization": f * E,  # 1.0 == perfectly balanced
            "moe_router_entropy": entropy,
            "moe_max_expert_share": f.max() / (f.sum() + 1e-9),
        }
        metrics.update(stats)
        if sp > 1:
            i0 = mesh.coords["sequence"] * Sl
            out = out[:, i0:i0 + Sl]
        return out.to(self.dtype), metrics
