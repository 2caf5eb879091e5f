"""Hierarchical gradient reduction (port of luminaai_tpu/parallel/grad_reduce.py).

`grad_reduce="hierarchical"`: the (data, fsdp) ranks hold the whole model
(no FSDP2 sharding), each accumulates its micro-batches' gradients in fp32
with `torch.autograd.grad` (the one-card step), and then ONE sync reduces
them: the gradient list flattens into fp32 buckets
(`grad_reduce_bucket_mb`, at least `grad_reduce_overlap_chunks` of them);
each bucket reduce-scatters over fsdp, then over the in-node factor of the
data axis (NVLink), crosses nodes once by an all-reduce over the strided
rails of `gradient_dcn_size` groups of the data axis (optionally in bf16,
`grad_reduce_dcn_dtype`), and all-gathers back. The buckets are issued
asynchronously, so bucket k's inter-node hop runs beside bucket k-1's
gathers. The result equals a flat all-reduce of the gradients up to the
order of the fp32 sums (tests/test_torch_grad_reduce.py holds it at 1e-6).

`GradReducePlan` / `make_grad_reduce_plan` are the JAX module's (the same
byte counts), `export_grad_reduce_gauges` writes them to the port's
registry, `make_hierarchical_grad_fn` is the gradient stage of the sharded
step (parallel/train_step.py), and `grad_reduce_probe` times a sync over
the initialized process group.

Loss semantics are the JAX module's (:337-420): each rank scales its CE by
its share of the global loss weight (one scalar all-reduce) and the MoE aux
losses by 1/world, the per-shard balance the JAX hierarchical path trains
with.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

__all__ = [
    "GradReducePlan",
    "make_grad_reduce_plan",
    "export_grad_reduce_gauges",
    "hierarchical_grad_sync",
    "make_hierarchical_grad_fn",
    "grad_reduce_probe",
]


@dataclasses.dataclass(frozen=True)
class GradReducePlan:
    """Static shape/byte plan for one hierarchical gradient sync.

    Derived purely from gradient avals and config at trace time — the
    numbers describe the traced program, not a run — so bench extras and
    the comms auditor can price the sync without hardware. Per shard,
    per optimizer step:

      ici-tier bytes = the reduce-scatter + all-gather legs: the full
        fp32 bucket payload enters/leaves each shard once each way,
        ring-style (~2*(t-1)/t of it off-chip for a tier of t shards).
      dcn bytes      = the grouped psum over the cross-host rails: each
        shard's SCATTERED chunk (1/ici_tier of the payload) rides a
        ring over the dcn hosts, at `dcn_itemsize` width.

    The flat GSPMD baseline moves the whole fp32 gradient through one
    logical all-reduce whose DCN-crossing share is ~2*(dcn-1)/dcn of
    the full payload — `flat_dcn_bytes`. The hierarchical advantage is
    structural: DCN traffic scales like 1/ici_tier (× 1/2 again under
    bf16 compression) of the flat baseline's.
    """

    world: int            # data * fsdp shards participating in the sync
    dcn: int              # host tier size (1 = single-stage fallback)
    data_size: int
    fsdp_size: int
    grad_bytes: int       # fp32 bytes of the flattened gradient
    padded_bytes: int     # after bucket/scatter padding
    n_buckets: int
    bucket_bytes: int     # per-bucket fp32 bytes (padded/n_buckets)
    overlap_chunks: int
    dcn_itemsize: int     # 4 (fp32) or 2 (bf16-over-DCN)

    @property
    def ici_tier(self) -> int:
        """Shards reduced per host before anything crosses DCN."""
        return self.world // self.dcn

    def stage_bytes(self, stage: str) -> int:
        """One-direction off-device payload bytes per shard for a tier;
        0 when the tier has one participant."""
        if stage == "ici":
            t = self.ici_tier
            return (
                int(self.padded_bytes * (t - 1) / t) if t > 1 else 0
            )
        scattered = self.padded_bytes // max(1, self.ici_tier)
        scattered = scattered * self.dcn_itemsize // 4
        d = self.dcn
        return int(scattered * (d - 1) / d) if d > 1 else 0

    @property
    def hier_dcn_bytes(self) -> int:
        """DCN-crossing bytes per shard per step (reduce + broadcast
        halves of the rail psum)."""
        return 2 * self.stage_bytes("dcn")

    @property
    def flat_dcn_bytes(self) -> int:
        """The implicit GSPMD baseline: one full-width fp32 all-reduce,
        ~2*(dcn-1)/dcn of the whole gradient crossing hosts."""
        d = self.dcn
        return (
            int(2 * self.grad_bytes * (d - 1) / d) if d > 1 else 0
        )

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(
            ici_tier=self.ici_tier,
            ici_stage_bytes=self.stage_bytes("ici"),
            dcn_stage_bytes=self.stage_bytes("dcn"),
            hier_dcn_bytes=self.hier_dcn_bytes,
            flat_dcn_bytes=self.flat_dcn_bytes,
        )
        return d


def make_grad_reduce_plan(
    *,
    grad_elems: int,
    data_size: int,
    fsdp_size: int,
    dcn_size: int = 1,
    bucket_mb: float = 32.0,
    overlap_chunks: int = 1,
    dcn_dtype: Optional[str] = None,
) -> GradReducePlan:
    """Resolve the static bucket layout for a gradient of `grad_elems`
    fp32 elements on a (data, fsdp) grid.

    Bucket count = max(size-derived count, overlap_chunks); the flat
    vector pads to a multiple of n_buckets * scatter_factor so every
    bucket reduce-scatters evenly over the ici tier."""
    data_size = max(1, int(data_size))
    fsdp_size = max(1, int(fsdp_size))
    dcn = max(1, int(dcn_size))
    if data_size % dcn:
        raise ValueError(
            f"gradient_dcn_size {dcn} must divide the data axis "
            f"{data_size}"
        )
    world = data_size * fsdp_size
    grad_bytes = int(grad_elems) * 4
    bucket_bytes = max(1, int(bucket_mb * 2**20))
    n_buckets = max(
        -(-grad_bytes // bucket_bytes), max(1, int(overlap_chunks))
    )
    n_buckets = min(n_buckets, max(1, int(grad_elems)))
    scatter = fsdp_size * (data_size // dcn)
    quantum = n_buckets * scatter
    padded = -(-max(1, int(grad_elems)) // quantum) * quantum
    return GradReducePlan(
        world=world,
        dcn=dcn,
        data_size=data_size,
        fsdp_size=fsdp_size,
        grad_bytes=grad_bytes,
        padded_bytes=padded * 4,
        n_buckets=n_buckets,
        bucket_bytes=padded * 4 // n_buckets,
        overlap_chunks=max(1, int(overlap_chunks)),
        dcn_itemsize=2 if dcn_dtype == "bf16" else 4,
    )




def export_grad_reduce_gauges(plan: GradReducePlan, registry=None) -> None:
    """grad_reduce_bytes{stage} gauges from the static plan. Best-effort
    — the plan is built at trace time inside the train step, so this
    must never break a trace over a telemetry hiccup (same contract as
    expert_dispatch.export_plan_gauges)."""
    try:
        from luminaai_tpu_torch.monitoring.telemetry import get_registry

        registry = registry or get_registry()
        g = registry.gauge(
            "grad_reduce_bytes",
            "Static per-shard one-direction payload bytes of the "
            "hierarchical gradient sync per tier (from the "
            "GradReducePlan, trace time)",
            labelnames=("stage",),
        )
        g.labels(stage="ici").set(float(plan.stage_bytes("ici")))
        g.labels(stage="dcn").set(float(plan.stage_bytes("dcn")))
        registry.gauge(
            "grad_reduce_buckets",
            "Size-bucketed chunk count of the hierarchical gradient "
            "sync at last trace",
        ).set(float(plan.n_buckets))
    except Exception:  # pragma: no cover - telemetry must not break traces
        logger.debug("grad_reduce_bytes gauge export failed", exc_info=True)


def _stage_groups(mesh, data_size: int, dcn: int):
    """(fsdp group, in-node data group, cross-node data rail group)."""
    if dcn > 1:
        g1, g2 = mesh.tier_groups("data", dcn)
    else:
        g1, g2 = mesh.group("data"), None
    return mesh.group("fsdp"), g1, g2


def hierarchical_grad_sync(
    grads: List[torch.Tensor],
    mesh,
    *,
    dcn_size: int = 1,
    bucket_mb: float = 32.0,
    overlap_chunks: int = 1,
    dcn_dtype: Optional[str] = None,
    plan_out: Optional[Dict[str, Any]] = None,
    registry=None,
) -> List[torch.Tensor]:
    """Sum each rank's partial gradients over the mesh's (data, fsdp)
    ranks, staged in-node then across nodes; returns new tensors in the
    leaves' dtypes."""
    if not grads:
        return grads
    data_size = mesh.shape["data"]
    fsdp_size = mesh.shape["fsdp"]
    sizes = [g.numel() for g in grads]
    total = sum(sizes)
    plan = make_grad_reduce_plan(
        grad_elems=total, data_size=data_size, fsdp_size=fsdp_size,
        dcn_size=dcn_size, bucket_mb=bucket_mb,
        overlap_chunks=overlap_chunks, dcn_dtype=dcn_dtype,
    )
    if plan_out is not None:
        plan_out["plan"] = plan
    export_grad_reduce_gauges(plan, registry=registry)
    dcn = plan.dcn
    ici_d = data_size // dcn
    g_fsdp, g1, g2 = _stage_groups(mesh, data_size, dcn)
    padded = plan.padded_bytes // 4
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    if padded != total:
        flat = torch.nn.functional.pad(flat, (0, padded - total))
    cl = padded // plan.n_buckets
    f_n = fsdp_size if g_fsdp is not None else 1
    d_n = ici_d if (g1 is not None and ici_d > 1) else 1

    # Reduce-scatter every bucket first (asynchronously), then the rail
    # all-reduces, then the gathers: bucket k's cross-node hop overlaps
    # bucket k-1's in-node work.
    scattered = []
    for k in range(plan.n_buckets):
        c = flat[k * cl:(k + 1) * cl].contiguous()
        work = []
        if f_n > 1:
            out = torch.empty(cl // f_n, dtype=c.dtype, device=c.device)
            work.append(dist.reduce_scatter_tensor(out, c, group=g_fsdp,
                                                   async_op=True))
            c = out
        scattered.append((c, work))
    rails = []
    for c, work in scattered:
        for w in work:
            w.wait()
        if d_n > 1:
            out = torch.empty(c.numel() // d_n, dtype=c.dtype,
                              device=c.device)
            dist.reduce_scatter_tensor(out, c, group=g1)
            c = out
        w = None
        if dcn > 1:
            if dcn_dtype == "bf16":
                c = c.to(torch.bfloat16)
            w = dist.all_reduce(c, group=g2, async_op=True)
        rails.append((c, w))
    pieces = []
    for c, w in rails:
        if w is not None:
            w.wait()
        c = c.to(torch.float32)
        if d_n > 1:
            out = torch.empty(c.numel() * d_n, dtype=c.dtype,
                              device=c.device)
            dist.all_gather_into_tensor(out, c, group=g1)
            c = out
        if f_n > 1:
            out = torch.empty(c.numel() * f_n, dtype=c.dtype,
                              device=c.device)
            dist.all_gather_into_tensor(out, c, group=g_fsdp)
            c = out
        pieces.append(c)
    out = torch.cat(pieces)[:total]
    synced, offset = [], 0
    for g, size in zip(grads, sizes):
        synced.append(out[offset:offset + size].reshape(g.shape).to(g.dtype))
        offset += size
    return synced


def make_hierarchical_grad_fn(config, mesh, accumulate: Callable
                              ) -> Callable:
    """The gradient stage of the sharded step under
    grad_reduce='hierarchical': `accumulate(params, batch, generator)`
    gives this rank's fp32 partial gradients (its local loss already
    scaled to its share, parallel/train_step.py); they return summed over
    (data, fsdp) by the hierarchical sync. The function carries a
    `plan_box` holding the GradReducePlan after its first call."""
    data_size = mesh.shape["data"]
    dcn = int(config.gradient_dcn_size)
    if data_size % dcn:
        raise ValueError(
            f"gradient_dcn_size {dcn} must divide the mesh data axis "
            f"({data_size})"
        )
    plan_box: Dict[str, Any] = {}

    def fn(params, batch, generator):
        grads, metrics = accumulate(params, batch, generator)
        grads = hierarchical_grad_sync(
            grads, mesh, dcn_size=dcn,
            bucket_mb=config.grad_reduce_bucket_mb,
            overlap_chunks=config.grad_reduce_overlap_chunks,
            dcn_dtype=config.grad_reduce_dcn_dtype, plan_out=plan_box,
        )
        return grads, metrics

    fn.plan_box = plan_box
    return fn


def grad_reduce_probe(mesh, payload_mb: float = 4.0, iters: int = 5,
                      registry=None) -> Dict[str, Any]:
    """Time a real hierarchical gradient sync of ~payload_mb over the
    mesh's data axis (fsdp 1), in one stage, or in two when
    gradient_dcn_size groups were built (`Mesh.tier_groups`); exports
    diagnose_grad_reduce_seconds{stage} gauges."""
    from luminaai_tpu_torch.monitoring.telemetry import (
        MetricsRegistry,
        get_registry,
    )

    registry = registry or get_registry()
    world = mesh.shape["data"]
    dcn = mesh.dcn("data")
    out: Dict[str, Any] = {"world": world, "dcn": dcn,
                           "ici": world // dcn, "stages": {}}
    elems = max(world * world, int(payload_mb * 1e6 / 4))
    elems = -(-elems // (world * world)) * world * world
    x = torch.ones(elems, dtype=torch.float32, device=mesh.device)
    sink = MetricsRegistry()
    name = "two_stage" if dcn > 1 else "single_stage"

    def run():
        return hierarchical_grad_sync([x], mesh, dcn_size=dcn, bucket_mb=1.0,
                                      overlap_chunks=2, registry=sink)

    try:
        run()
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        dt = (time.perf_counter() - t0) / iters
        out["stages"][name] = {
            "payload_mb": round(elems * 4 / 1e6, 2),
            "mean_seconds": round(dt, 6),
            "algo_gbps": round(elems * 4 / max(dt, 1e-9) / 1e9, 3),
        }
        registry.gauge(
            "diagnose_grad_reduce_seconds",
            "Mean timed hierarchical gradient-sync per stage at last "
            "diagnose", labelnames=("stage",),
        ).labels(stage=name).set(dt)
    except Exception as e:  # a probe must not wedge its caller
        out["stages"][name] = {"error": f"{type(e).__name__}: {e}"}
    return out
