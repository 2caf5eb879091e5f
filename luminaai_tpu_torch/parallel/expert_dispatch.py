"""Expert parallelism by all-to-all token dispatch (port of luminaai_tpu/parallel/expert_dispatch.py).

moe_dispatch='a2a': tokens shard over (data, fsdp, expert); each expert
rank routes its own groups, packs the kept (token, choice) pairs into
per-destination buckets, exchanges the per-destination counts first and
then the buckets over the expert group (`all_to_all_single`), runs its
local experts over exactly the rows it received (the grouped matmul: B4a
forward, B4b in the backward, ops/gmm.py), and sends the rows back the
same way. Routing and capacity are `sort_routing`'s, so the outputs equal
the 'sort' / 'gmm' dispatches of one rank (tests/test_torch_expert_dispatch.py).

  - `DispatchPlan` / `make_dispatch_plan` / `next_pow2`: the JAX static
    plan (:90, :180), the same pow2 bucket bound and byte counts;
  - `export_plan_gauges` (:230): ep_a2a_bytes{stage} in the port's
    registry;
  - `hierarchical_groups` (:255), `hierarchical_all_to_all` (:290): the
    expert axis factored as nodes x cards (`expert_dcn_size`), stage 1
    inside a node, stage 2 across nodes along fixed rails; one flat
    exchange when there is one node;
  - `a2a_expert_ffn` (:340): one rank's routed-token expert FFN, its
    buckets split into `n_chunks` whose exchanges are issued one chunk
    ahead of the expert products;
  - `expert_a2a_probe` (:528): a timed exchange over the expert group.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from luminaai_tpu_torch.parallel.mesh import all_to_all, reduce_from

logger = logging.getLogger(__name__)

__all__ = [
    "DispatchPlan",
    "make_dispatch_plan",
    "hierarchical_groups",
    "hierarchical_all_to_all",
    "a2a_expert_ffn",
    "expert_a2a_probe",
    "next_pow2",
]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    n = max(1, int(n))
    p = 1
    while p < n:
        p *= 2
    return p


# --------------------------------------------------------------------------
# static plan: bucket bound + byte accounting
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Static shape/byte plan for one a2a dispatch (per expert shard).

    Everything here is derived from config shapes at trace time — the
    numbers describe the traced program, not a run — which is what lets
    bench extras and the comms auditor price the dispatch without
    hardware. Byte formulas (one direction; dispatch+combine doubles
    them):

      payload_bytes   = ep * bucket_rows * hidden * itemsize
                        (the bucketed token buffer one shard sends)
      stage ici bytes = payload * (ici-1)/ici   (leaves the chip, stays
                        on-host)
      stage dcn bytes = payload * (dcn-1)/dcn   (crosses hosts)

    The replicated-gather baseline these replace (gmm/einsum dispatch
    with tokens replicated over 'expert' + a full-activation psum over
    the expert axis) moves, per shard per direction,
    ring-allreduce-style ~2*(ax-1)/ax of the full [G_dp, S, H] token
    tensor across the expert axis — `baseline_*_bytes` below. The a2a
    advantage is structural: its payload shards the batch over the
    expert axis (G_local = G_dp/ep) and carries only routed tokens, so
    dcn bytes scale like cf*k/ep of the baseline's.
    """

    ep: int               # expert-axis size (dcn * ici)
    dcn: int              # host tier size (1 = single stage)
    ici: int              # per-host tier size
    local_groups: int     # G_l: batch groups per expert shard
    seq: int
    top_k: int
    capacity: int         # per-(group, expert) token capacity
    experts_local: int    # E / ep
    hidden: int
    itemsize: int         # payload dtype bytes
    bucket_rows: int      # B: pow2-bucketed per-destination row bound
    n_chunks: int         # overlap chunks (stage-2/compute pipelining)
    dp_groups: int        # G_dp: groups per (data,fsdp) shard (baseline)

    @property
    def pair_rows(self) -> int:
        return self.local_groups * self.seq * self.top_k

    @property
    def payload_bytes(self) -> int:
        return self.ep * self.bucket_rows * self.hidden * self.itemsize

    @property
    def counts_bytes(self) -> int:
        return self.ep * self.experts_local * 4

    def stage_bytes(self, stage: str) -> int:
        """One-direction off-device payload bytes for a stage ('ici' or
        'dcn'); 0 when the stage has one participant."""
        ax = self.ici if stage == "ici" else self.dcn
        return int(self.payload_bytes * (ax - 1) / ax) if ax > 1 else 0

    @property
    def a2a_dcn_bytes(self) -> int:
        """DCN-crossing bytes per shard per step (dispatch + combine)."""
        return 2 * self.stage_bytes("dcn")

    @property
    def baseline_psum_bytes(self) -> int:
        """The replicated path's expert-axis psum payload: the full
        per-(data,fsdp)-shard token activation, ring-reduced over the
        expert axis (~2x(ep-1)/ep of it leaves each shard)."""
        act = self.dp_groups * self.seq * self.hidden * self.itemsize
        return int(2 * act * (self.ep - 1) / self.ep) if self.ep > 1 else 0

    @property
    def baseline_dcn_bytes(self) -> int:
        """DCN-crossing share of the replicated path's expert psum."""
        act = self.dp_groups * self.seq * self.hidden * self.itemsize
        return int(2 * act * (self.dcn - 1) / self.dcn) if self.dcn > 1 else 0

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(
            payload_bytes=self.payload_bytes,
            counts_bytes=self.counts_bytes,
            ici_stage_bytes=self.stage_bytes("ici"),
            dcn_stage_bytes=self.stage_bytes("dcn"),
            a2a_dcn_bytes=self.a2a_dcn_bytes,
            baseline_psum_bytes=self.baseline_psum_bytes,
            baseline_dcn_bytes=self.baseline_dcn_bytes,
        )
        return d


def make_dispatch_plan(
    *,
    ep: int,
    dcn_size: int,
    local_groups: int,
    seq: int,
    top_k: int,
    capacity: int,
    num_experts: int,
    hidden: int,
    itemsize: int,
    overlap_chunks: int = 1,
    dp_groups: Optional[int] = None,
) -> DispatchPlan:
    """Resolve the static dispatch plan for one expert shard.

    bucket_rows is the pow2-bucketed bound on tokens any one destination
    shard can receive from this shard: kept pairs are capped both by the
    local pair count (G_l*S*k) and by the destination's capacity budget
    (G_l * E_local * C), so the bucket never overflows — routing-drop
    semantics stay exactly _sort_routing's, which is what pins a2a
    bit-comparable to the gather path."""
    if dcn_size < 1 or ep % dcn_size:
        raise ValueError(
            f"expert_dcn_size {dcn_size} must divide the expert axis {ep}"
        )
    e_l = num_experts // ep
    n_pairs = local_groups * seq * top_k
    bound = min(n_pairs, local_groups * e_l * capacity)
    bucket = next_pow2(bound)
    chunks = max(1, int(overlap_chunks))
    while bucket % chunks:
        chunks -= 1
    return DispatchPlan(
        ep=ep,
        dcn=dcn_size,
        ici=ep // dcn_size,
        local_groups=local_groups,
        seq=seq,
        top_k=top_k,
        capacity=capacity,
        experts_local=e_l,
        hidden=hidden,
        itemsize=itemsize,
        bucket_rows=bucket,
        n_chunks=chunks,
        dp_groups=dp_groups if dp_groups is not None else local_groups * ep,
    )


def export_plan_gauges(plan: DispatchPlan, registry=None) -> None:
    """ep_a2a_bytes{stage} gauges from the static plan. Best-effort: the
    plan is built at trace time inside the model forward, so this must
    never break a trace over a telemetry hiccup."""
    try:
        from luminaai_tpu_torch.monitoring.telemetry import get_registry

        registry = registry or get_registry()
        g = registry.gauge(
            "ep_a2a_bytes",
            "Static per-shard one-direction payload bytes of the expert "
            "a2a dispatch per stage (from the DispatchPlan, trace time)",
            labelnames=("stage",),
        )
        g.labels(stage="ici").set(float(plan.stage_bytes("ici")))
        g.labels(stage="dcn").set(float(plan.stage_bytes("dcn")))
    except Exception:  # pragma: no cover - telemetry must not break traces
        logger.debug("ep_a2a_bytes gauge export failed", exc_info=True)


# --------------------------------------------------------------------------
# hierarchical all-to-all
# --------------------------------------------------------------------------


def hierarchical_groups(
    ep: int, dcn: int
) -> Tuple[List[List[int]], List[List[int]]]:
    """Factor a single expert axis of size ep = dcn*ici into the two
    collective tiers. Shard s = h*ici + i (hosts outermost — matching
    how contiguous device blocks land on hosts for the trailing mesh
    axes). Stage 1 groups are the contiguous per-host blocks (ICI);
    stage 2 groups are the strided cross-host rails (DCN) — the comms
    auditor uses exactly this contiguous-vs-strided signature to
    classify a collective's tier."""
    ici = ep // dcn
    stage1 = [[h * ici + i for i in range(ici)] for h in range(dcn)]
    stage2 = [[h * ici + i for h in range(dcn)] for i in range(ici)]
    return stage1, stage2


def _stage1(x, group):
    """In-node exchange: [dcn, ici_dest, ...] -> [dcn, ici_src, ...]."""
    return all_to_all(x, group, split_axis=1, concat_axis=1)


def _stage2(x, group):
    """Cross-node exchange along the rails: [dcn_dest, ici, ...] ->
    [dcn_src, ici, ...]; an involution, so the combine reuses it."""
    return all_to_all(x, group, split_axis=0, concat_axis=0)


def hierarchical_all_to_all(x: torch.Tensor, group, *, tiers=None,
                            dcn_size: int = 1) -> torch.Tensor:
    """Destination-major bucket exchange over `group` (x [ep, ...], its
    leading dim the destination rank's index in the expert axis) ->
    [ep, ...] indexed by source: what one flat tiled all-to-all gives,
    staged in-node then across nodes when `tiers` (Mesh.tier_groups)
    factor the axis into dcn_size nodes."""
    if tiers is None or dcn_size <= 1:
        return all_to_all(x, group, split_axis=0, concat_axis=0)
    ep = x.shape[0]
    r = x.reshape((dcn_size, ep // dcn_size) + tuple(x.shape[1:]))
    r = _stage1(r, tiers[0])
    r = _stage2(r, tiers[1])
    return r.reshape(x.shape)


def _counts_exchange(cnt_de: torch.Tensor, group) -> torch.Tensor:
    """[ep_dest, E_l] int32 -> [ep_src, E_l] (no gradient)."""
    if group is None:
        return cnt_de
    out = torch.empty_like(cnt_de)
    dist.all_to_all_single(out, cnt_de.contiguous(), group=group)
    return out


def a2a_expert_ffn(
    x: torch.Tensor,
    router_probs: torch.Tensor,
    wi: torch.Tensor,
    wo: torch.Tensor,
    *,
    top_k: int,
    capacity: int,
    num_experts: int,
    dtype,
    gmm_fn,
    ep_group,
    ep_index: int,
    plan: DispatchPlan,
    tiers=None,
    tp_group=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
           Dict[str, torch.Tensor]]:
    """One expert rank's routed-token expert FFN (the JAX body, :340).

    x [G_l, S, H] and router_probs [G_l, S, E] are this rank's own token
    groups; wi [E_l, H, 2F] / wo [E_l, F, H] its local experts (F split
    over `tp_group` when tensor parallelism composes: the partial rows sum
    over it before the combine exchange). Returns (out [G_l, S, H],
    tokens_per_expert [E] of the local groups, dropped [G_l, S], stats
    {ep_tokens_routed, ep_tokens_dcn} local; the caller sums them)."""
    from luminaai_tpu_torch.models.moe import GMM_ROW_TILE, sort_routing

    G, S, H = x.shape
    E, k, C = num_experts, top_k, capacity
    E_l = wi.shape[0]
    ep, dcn, ici = plan.ep, plan.dcn, plan.ici
    B = plan.bucket_rows
    N = G * S * k
    dev = x.device

    slot, gate, dropped, counts = sort_routing(router_probs, k, C)
    gate = gate.to(dtype)

    # --- pack: destination-major buckets (expert-major order is
    # destination-major order: experts are contiguous per rank) ---------
    e_pair = torch.where(slot < E * C, slot // C, E).reshape(-1)
    d_pair = torch.where(e_pair < E, e_pair // E_l, ep)
    perm = torch.argsort(e_pair, stable=True)
    cnt_de = counts.sum(0).to(torch.int32).reshape(ep, E_l)
    cnt_d = cnt_de.sum(1)
    dstart = torch.cumsum(cnt_d, 0) - cnt_d
    dest_sorted = d_pair[perm]
    pos = torch.arange(N, device=dev) - dstart[dest_sorted.clamp(max=ep - 1)]
    valid = dest_sorted < ep
    flat = torch.where(valid, dest_sorted * B + pos, ep * B)
    # slot -> sorted rank (an int scatter), then ONE row gather.
    inv = torch.full((ep * B + 1,), N, dtype=torch.long, device=dev)
    inv[flat] = torch.arange(N, device=dev)
    inv = inv[: ep * B]
    tok_sorted = perm // k
    x_flat = x.to(dtype).reshape(G * S, H)
    filled = (inv < N)[:, None].to(dtype)
    sb = (x_flat[tok_sorted[inv.clamp(max=N - 1)]] * filled).reshape(
        ep, B, H)

    # --- counts first (the padding-free contract) ------------------------
    rcnt = _counts_exchange(cnt_de, ep_group)        # [ep_src, E_l]
    rtot = rcnt.sum(1)
    rcum = torch.cumsum(rcnt, 1)

    hier = tiers is not None and dcn > 1
    if hier:
        sb = _stage1(sb.reshape(dcn, ici, B, H), tiers[0])
    n_chunks = plan.n_chunks
    Bc = B // n_chunks

    def exchange(piece):
        if hier:
            return _stage2(piece, tiers[1])
        return all_to_all(piece, ep_group, split_axis=0, concat_axis=0)

    def ffn_chunk(rb_c, row0):
        r_ids = row0 + torch.arange(Bc, device=dev)
        # expert of bucket row r from source s: how many of source s's
        # per-expert runs end at or before r.
        e_loc = torch.searchsorted(rcum.contiguous(),
                                   r_ids.expand(ep, Bc).contiguous()
                                   .to(rcum.dtype), right=True)
        live = r_ids[None, :] < rtot[:, None]
        key = torch.where(live, e_loc, E_l).reshape(-1)
        M = ep * Bc
        p2 = torch.argsort(key, stable=True)
        gs = torch.bincount(key, minlength=E_l + 1)[:E_l].to(torch.int32)
        Mp = -(-M // GMM_ROW_TILE) * GMM_ROW_TILE
        rows = rb_c.reshape(M, H)[p2]
        if Mp != M:
            rows = F.pad(rows, (0, 0, 0, Mp - M))
        row_kept = torch.arange(Mp, device=dev)[:, None] < gs.sum()
        zero = torch.zeros((), dtype=rows.dtype, device=dev)
        lhs = torch.where(row_kept, rows, zero)
        fused = gmm_fn(lhs, wi.to(dtype), gs, dtype)
        gate_act, up = torch.chunk(fused, 2, dim=-1)
        act = torch.where(row_kept, F.silu(gate_act) * up, zero)
        yrow = gmm_fn(act.contiguous(), wo.to(dtype), gs, dtype)
        yrow = torch.where(row_kept, yrow, zero)[:M]
        # Row-parallel epilogue: one output copy rides the combine.
        yrow = reduce_from(yrow, tp_group)
        inv2 = torch.argsort(p2)
        return yrow[inv2].reshape(ep, Bc, H)

    def piece_of(c):
        if hier:
            return sb[:, :, c * Bc:(c + 1) * Bc, :]
        return sb[:, c * Bc:(c + 1) * Bc, :]

    back = []
    for c in range(n_chunks):
        rb_c = exchange(piece_of(c))
        if hier:
            rb_c = rb_c.reshape(ep, Bc, H)
        yb_c = ffn_chunk(rb_c, c * Bc)
        if hier:
            yb_c = yb_c.reshape(dcn, ici, Bc, H)
        back.append(exchange(yb_c))
    cb = torch.cat(back, dim=2 if hier else 1)
    if hier:
        cb = _stage1(cb, tiers[0]).reshape(ep, B, H)

    # --- unpack + gate-weight on the home rank ---------------------------
    cbf = cb.reshape(ep * B, H)
    y_sorted = cbf[flat.clamp(max=ep * B - 1)] * valid[:, None].to(dtype)
    inv_perm = torch.argsort(perm)
    y_pairs = y_sorted[inv_perm].reshape(G, S, k, H)
    out = torch.einsum("gskh,gsk->gsh", y_pairs, gate)

    my_node = ep_index // ici
    dest_node = torch.arange(ep, device=dev) // ici
    routed = cnt_d.sum().to(torch.float32)
    routed_dcn = torch.where(dest_node != my_node, cnt_d,
                             torch.zeros_like(cnt_d)).sum().to(torch.float32)
    stats = {"ep_tokens_routed": routed, "ep_tokens_dcn": routed_dcn}
    return out, counts.sum(0).to(torch.float32), dropped, stats


def expert_a2a_probe(mesh, payload_mb: float = 4.0, iters: int = 5,
                     registry=None) -> Dict[str, Any]:
    """Time a real bucket exchange of ~payload_mb a rank over the mesh's
    expert group (two stages where the mesh built expert tiers); exports
    diagnose_expert_a2a_seconds{stage}."""
    from luminaai_tpu_torch.monitoring.telemetry import get_registry

    registry = registry or get_registry()
    ep = mesh.shape["expert"]
    dcn = mesh.dcn("expert")
    tiers = mesh.tier_groups("expert", dcn) if dcn > 1 else None
    out: Dict[str, Any] = {"ep": ep, "dcn": dcn, "ici": ep // dcn,
                           "stages": {}}
    H = 128
    rows = max(1, int(payload_mb * 1e6 / 4 / H / ep))
    x = torch.ones((ep, rows, H), dtype=torch.float32, device=mesh.device)
    group = mesh.group("expert")
    name = "two_stage" if tiers else "single_stage"
    try:
        with torch.no_grad():
            hierarchical_all_to_all(x, group, tiers=tiers, dcn_size=dcn)
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            for _ in range(iters):
                hierarchical_all_to_all(x, group, tiers=tiers, dcn_size=dcn)
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
        dt = (time.perf_counter() - t0) / iters
        payload = ep * rows * H * 4
        out["stages"][name] = {
            "payload_mb": round(payload / 1e6, 2),
            "mean_seconds": round(dt, 6),
            "algo_gbps": round(payload / max(dt, 1e-9) / 1e9, 3),
        }
        registry.gauge(
            "diagnose_expert_a2a_seconds",
            "Mean timed expert-dispatch all-to-all per stage at last "
            "diagnose", labelnames=("stage",),
        ).labels(stage=name).set(dt)
    except Exception as e:  # a probe must not wedge its caller
        out["stages"][name] = {"error": f"{type(e).__name__}: {e}"}
    return out
