"""Audits over what the port dispatches: recompile surface, host syncs,
sharding coverage, collectives (the counterpart of
luminaai_tpu/analysis/jaxpr_audit.py; torch has no jaxpr, so these audits
run the port's programs at audit_config sizes on the CPU and watch the
aten ops and collectives they dispatch).

- `detect_host_syncs` runs a callable under a TorchDispatchMode and
  counts, by op and by the port's call site, what makes the host wait
  for the card: `aten._local_scalar_dense` (.item(), int(), bool() of a
  tensor), data-dependent-shape ops (nonzero, boolean-mask indexing,
  masked_select, unique, repeat_interleave, bincount), copies from a
  device to the host and dispatched copies from pageable host memory to
  a device. A CPU tensor's .tolist() / .numpy() reads its memory without
  a dispatch, so the CPU run cannot see those: astlint's LX002 finds them
  in source, and on the card they show as copies. A tensor built from
  host data on a device (torch.tensor(x, device=...)) copies below the
  dispatcher, out of the mode's sight.
  A sync a kernel wrapper makes by design is on ALLOWED_HOST_SYNCS with
  its op, call site and reason; any other fails the `host_syncs` verdict.

- `enumerate_recompile_surface` runs the train step and the decode
  programs over the variants JAX's `_train_variants` / `_decode_variants`
  enumerate (scan_layers on/off x gmm/einsum dispatch; chunked prefill at
  two prompt lengths, scalar-offset decode, [B]-offset decode) and hashes
  each variant by its dispatched aten op sequence with shapes and dtypes.
  The distinct count per program is the number of CUDA-graph captures a
  graph-replayed port would need (ROADMAP P2), as JAX's is the number of
  executables XLA compiles.

- `audit_sharding_coverage` checks that every parameter of the port's
  model has its logical axes (PARAM_LOGICAL_AXES, the JAX model's
  annotations) and that each of them has a rule in parallel/sharding.py's
  table.

- `enumerate_collectives`, `audit_ep_dispatch`, `audit_grad_reduce` count
  the port's collectives and their bytes for one MoE layer and one train
  step on an 8-rank mesh of torch's `fake` process-group backend, in this
  one process (the collectives move nothing; the recorder fills their
  outputs as a world of identical ranks would). They pin the
  inequalities JAX pins: the a2a dispatch's cross-node bytes below the
  replicated gather's, the hierarchical gradient sync's below the flat
  all-reduce's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import traceback
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "audit_config",
    "detect_host_syncs",
    "enumerate_recompile_surface",
    "audit_sharding_coverage",
    "enumerate_collectives",
    "audit_ep_dispatch",
    "audit_grad_reduce",
    "op_signature",
    "run_audits",
]


def audit_config(**overrides):
    """Micro config for the auditors (JAX jaxpr_audit.py:70): every
    code-path discriminator the enumerator forks on (MoE dispatch, GQA
    heads, chunked prefill) is live, every size knob minimal."""
    from luminaai_tpu_torch.config import ConfigPresets

    cfg = ConfigPresets.debug()
    base = dict(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
        num_kv_heads=1, seq_length=64, intermediate_size=128, batch_size=2,
        gradient_accumulation_steps=1, num_experts=4, moe_top_k=2,
        data_parallel_size=1, use_flash_attention=False,
        routing_noise_std=0.0, precision="fp32",
    )
    base.update(overrides)
    cfg = dataclasses.replace(cfg, **base)
    cfg.normalize_parallelism()
    return cfg


# --------------------------------------------------------------------------
# dispatch recording
# --------------------------------------------------------------------------

_SCALAR_READ = "aten._local_scalar_dense"
_DATA_DEPENDENT = frozenset({
    "aten.nonzero", "aten.masked_select", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive", "aten.repeat_interleave",
    "aten.bincount", "aten.argwhere",
})

# (op, call site) -> why the sync is there by design. Call sites are
# "path:function" of the innermost frame in luminaai_tpu_torch/.
ALLOWED_HOST_SYNCS: Dict[Tuple[str, str], str] = {
}


def _op_name(func) -> str:
    """'aten.index' for the overload aten.index.Tensor."""
    return str(func).rsplit(".", 1)[0]


def _call_site() -> str:
    for fr in reversed(traceback.extract_stack()[:-3]):
        path = fr.filename.replace("\\", "/")
        if "/luminaai_tpu_torch/" in path and "/analysis/" not in path:
            rel = path[path.rindex("/luminaai_tpu_torch/") + 1:]
            return f"{rel}:{fr.name}"
    return "<outside the port>"


def _sync_kind(name: str, args, out) -> bool:
    if name == _SCALAR_READ or name in _DATA_DEPENDENT:
        return True
    if name == "aten.index" and any(
            torch.is_tensor(i) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 else ()) if i is not None):
        return True
    if name in ("aten._to_copy", "aten.copy_") and torch.is_tensor(out):
        src = args[1] if name == "aten.copy_" else args[0]
        if not torch.is_tensor(src) or src.device == out.device:
            return False
        if out.device.type == "cpu":
            return True  # to the host
        # From pageable host memory the copy waits for the card's stream.
        return src.device.type == "cpu" and not src.is_pinned()
    return False


def _describe(x) -> str:
    if torch.is_tensor(x):
        return f"{str(x.dtype).removeprefix('torch.')}{list(x.shape)}"
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_describe(v) for v in x) + ")"
    return ""


class _Recorder(TorchDispatchMode):
    """Records each dispatched op (name, output shapes and dtypes) and
    the host syncs with their call sites."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []
        self.syncs: Dict[str, int] = {}
        self.sites: Dict[Tuple[str, str], int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _op_name(func)
        self.ops.append(f"{name}->{_describe(out)}")
        if _sync_kind(name, args, out):
            self.syncs[name] = self.syncs.get(name, 0) + 1
            key = (name, _call_site())
            self.sites[key] = self.sites.get(key, 0) + 1
        return out


def _sync_report(rec: _Recorder) -> Dict[str, Any]:
    return {
        "by_op": dict(rec.syncs),
        "sites": [{"op": op, "site": site, "count": n,
                   "allowed": ALLOWED_HOST_SYNCS.get((op, site))}
                  for (op, site), n in sorted(rec.sites.items())],
        "total": sum(rec.syncs.values()),
    }


def detect_host_syncs(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run fn(*args, **kwargs) and report its host syncs: {"by_op":
    {op: n}, "sites": [{op, site, count, allowed}], "total": n}."""
    rec = _Recorder()
    with rec:
        fn(*args, **kwargs)
    return _sync_report(rec)


def op_signature(fn: Callable, *args, program: str, variant: str,
                 **kwargs) -> Dict[str, Any]:
    """Run fn twice, the second time under the recorder: the variant's
    signature (sha256 of its aten op sequence with output shapes and
    dtypes), its op count and its host syncs (the jaxpr_signature of
    JAX's audit). The first call warms what a layer builds once (the
    RoPE tables), as a CUDA graph is captured after a warm-up."""
    fn(*args, **kwargs)
    rec = _Recorder()
    with rec:
        fn(*args, **kwargs)
    digest = hashlib.sha256("\n".join(rec.ops).encode()).hexdigest()[:16]
    return {"program": program, "variant": variant, "signature": digest,
            "n_ops": len(rec.ops), "host_syncs": _sync_report(rec)}


# --------------------------------------------------------------------------
# recompile surface
# --------------------------------------------------------------------------


def _train_variants(cfg) -> List[Dict[str, Any]]:
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.parallel.train_step import (
        init_train_state,
        make_train_step,
    )
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    out = []
    ids = torch.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.seq_length),
                        generator=torch.Generator().manual_seed(0))
    for scan in (False, True):
        for dispatch in ("einsum", "gmm"):
            vcfg = dataclasses.replace(cfg, scan_layers=scan,
                                       moe_dispatch=dispatch)
            model = init_params(LuminaTransformer(vcfg, device="cpu",
                                                  trainable=True), 0)
            schedule = make_schedule(vcfg, 100)
            tx = make_optimizer(vcfg, 100, schedule)
            state = init_train_state(model, tx, 0)
            step = make_train_step(vcfg, model, schedule, tx)
            out.append(op_signature(
                step, state, {"input_ids": ids}, program="train",
                variant=f"scan={'on' if scan else 'off'}/{dispatch}"))
    return out


class _AuditTokenizer:
    """Minimal tokenizer contract for GenerationEngine; never decodes."""

    eos_token_id = 1
    pad_token_id = 0
    im_end = 2

    class backend:
        @staticmethod
        def encode(text):
            return [3]

    @staticmethod
    def decode(tokens):
        return " ".join(str(t) for t in tokens)


_DECODE_PREFILL_SCENARIOS = (32, 64)  # prompt lengths to serve


@torch.inference_mode()
def _decode_variants(cfg) -> List[Dict[str, Any]]:
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.inference.generate import (
        GREEDY_SAMPLE_KEY,
        GenerationEngine,
    )
    from luminaai_tpu_torch.models.transformer import LuminaTransformer

    model = init_params(LuminaTransformer(cfg, device="cpu"), 0)
    engine = GenerationEngine(model, _AuditTokenizer(), cfg)
    out = []
    # Chunked prefill: every prompt length runs the one fixed-chunk step.
    chunk = engine._prefill_chunk_len()
    for scenario in _DECODE_PREFILL_SCENARIOS:
        prompt = [3 + (i % 50) for i in range(scenario)]
        out.append(op_signature(
            engine._prefill_chunked, prompt, chunk, program="decode",
            variant=f"prefill/prompt={scenario}/chunk={chunk}"))

    # Scalar-offset decode: one single-request step.
    _, caches = engine._prefill_chunked([3] * 8, chunk)
    out.append(op_signature(engine._decode_logits, caches, 5, 8,
                            program="decode", variant="decode/scalar_offset"))

    # [B]-offset decode: the continuous-batching step over the slot pool.
    decoder = engine.make_stepwise(num_slots=2, page_size=16)
    for slot, prompt in enumerate(([3, 4, 5], [6, 7, 8, 9, 10])):
        decoder.prefill_into_slot(decoder.acquire_slot(), prompt,
                                  max_new_tokens=8)
    out.append(op_signature(decoder.decode_step, GREEDY_SAMPLE_KEY,
                            program="decode",
                            variant="decode/batched_cache_index"))
    return out


def enumerate_recompile_surface(
    cfg=None,
    programs: Sequence[str] = ("train", "decode"),
    registry=None,
) -> Dict[str, Any]:
    """Run every variant of the train/decode programs and report the
    distinct op-sequence signatures per program.

    Returns {"programs": {name: {"variants": [...], "distinct_signatures":
    N}}, "total_variants": V, "total_distinct": D, "host_syncs": {...}}
    (host_syncs aggregates every variant's syncs by op and site)."""
    cfg = cfg or audit_config()
    per_program: Dict[str, Any] = {}
    by_op: Dict[str, int] = {}
    sites: Dict[Tuple[str, str], int] = {}
    total_variants = 0
    all_signatures: set = set()
    for program in programs:
        if program == "train":
            variants = _train_variants(cfg)
        elif program == "decode":
            variants = _decode_variants(cfg)
        else:
            raise ValueError(f"unknown program {program!r}")
        signatures = {v["signature"] for v in variants}
        all_signatures |= signatures
        total_variants += len(variants)
        for v in variants:
            for op, n in v["host_syncs"]["by_op"].items():
                by_op[op] = by_op.get(op, 0) + n
            for s in v["host_syncs"]["sites"]:
                key = (s["op"], s["site"])
                sites[key] = sites.get(key, 0) + s["count"]
        per_program[program] = {"variants": variants,
                                "distinct_signatures": len(signatures)}
    out = {
        "programs": per_program,
        "total_variants": total_variants,
        "total_distinct": len(all_signatures),
        "host_syncs": {
            "by_op": by_op,
            "sites": [{"op": op, "site": site, "count": n,
                       "allowed": ALLOWED_HOST_SYNCS.get((op, site))}
                      for (op, site), n in sorted(sites.items())],
        },
        "note": (
            "each variant run once on the CPU at audit_config sizes: "
            "distinct aten op sequences (shapes, dtypes) per program = "
            "the CUDA-graph captures needed to replay the enumerated "
            "scenarios (ROADMAP P2)"),
    }
    _export_surface_gauges(out, registry)
    return out


def _unallowed(host_syncs: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [s for s in host_syncs["sites"] if not s["allowed"]]


def _export_surface_gauges(out: Dict[str, Any], registry) -> None:
    from luminaai_tpu_torch.monitoring.telemetry import get_registry

    registry = registry or get_registry()
    g = registry.gauge(
        "analysis_recompile_surface",
        "Distinct dispatched op-sequence signatures per program at last "
        "audit (the CUDA-graph captures the enumerated scenarios need)",
        labelnames=("program",),
    )
    for program, rec in out["programs"].items():
        g.labels(program=program).set(float(rec["distinct_signatures"]))
    registry.gauge(
        "analysis_host_sync_ops",
        "Host syncs outside ALLOWED_HOST_SYNCS found in the enumerated "
        "hot-path programs at last audit (expected 0)",
    ).set(float(sum(s["count"] for s in _unallowed(out["host_syncs"]))))


# --------------------------------------------------------------------------
# sharding coverage
# --------------------------------------------------------------------------

# Each parameter's logical axes by its name's last two parts (the JAX
# model's nn.with_logical_partitioning names; wqkv fuses wq, wk and wv's
# head columns, wi the gate and up columns).
PARAM_LOGICAL_AXES: Dict[str, Tuple[Any, ...]] = {
    "embedder.embedding": ("vocab", "embed"),
    "embedder.lm_head": ("vocab", "embed"),
    "attn_norm.scale": ("embed",),
    "ffn_norm.scale": ("embed",),
    "final_norm.scale": ("embed",),
    "attention.wqkv": ("embed", ("heads", "kv_heads", "head_dim")),
    "attention.wo": (("heads", "head_dim"), "embed"),
    "ffn.wi": ("embed", "mlp_fused"),
    "ffn.wo": ("mlp", "embed"),
    "moe.router": ("embed", None),
    "moe.wi": ("expert", "embed", "mlp_fused"),
    "moe.wo": ("expert", "mlp", "embed"),
    "mod_router.router": ("embed", None),
}


def audit_sharding_coverage(cfg=None, registry=None) -> Dict[str, Any]:
    """Every parameter of the model: flagged when PARAM_LOGICAL_AXES has
    no entry for it, when the entry's rank differs from the parameter's,
    or when one of its logical axes has no rule in parallel/sharding.py's
    table. Exports gauges, never raises."""
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.monitoring.telemetry import get_registry
    from luminaai_tpu_torch.parallel.sharding import logical_axis_rules

    cfg = cfg or audit_config()
    ruled = {lg for lg, _ in logical_axis_rules(cfg)}
    model = LuminaTransformer(cfg, device="meta")
    annotated = 0
    flagged: List[Dict[str, Any]] = []
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[-2:])
        axes = PARAM_LOGICAL_AXES.get(key)
        reason = None
        if axes is None:
            reason = "no logical axes"
        elif len(axes) != p.dim():
            reason = f"{len(axes)} logical axes for {p.dim()} dims"
        else:
            names = [a for ax in axes if ax is not None
                     for a in (ax if isinstance(ax, tuple) else (ax,))]
            missing = [a for a in names if a not in ruled]
            if missing:
                reason = f"no sharding rule for {missing}"
        if reason is None:
            annotated += 1
        else:
            flagged.append({"path": name, "shape": list(p.shape),
                            "reason": reason})
    total = annotated + len(flagged)
    out: Dict[str, Any] = {
        "total_leaves": total,
        "annotated_leaves": annotated,
        "unannotated_leaves": len(flagged),
        "coverage": round(annotated / total, 4) if total else None,
        "flagged": flagged[:50],
        "note": ("a parameter with no logical axes, or an axis with no "
                 "rule, gets no layout of parallel/sharding.py's table"),
    }
    registry = registry or get_registry()
    if out["coverage"] is not None:
        registry.gauge(
            "sharding_annotation_coverage",
            "Fraction of parameters whose logical axes all have a "
            "sharding rule at last audit (1.0 = fully covered)",
        ).set(out["coverage"])
    registry.gauge(
        "sharding_unannotated_leaves",
        "Parameters without a covered layout at last audit",
    ).set(float(len(flagged)))
    return out


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

# torch.distributed function -> the JAX primitive it stands for.
COLLECTIVE_PRIMITIVES: Dict[str, str] = {
    "all_reduce": "psum",
    "reduce_scatter_tensor": "reduce_scatter",
    "all_gather_into_tensor": "all_gather",
    "all_to_all_single": "all_to_all",
    "batch_isend_irecv": "ppermute",
}


def _stage(ranks: Sequence[int], axis_ranks: Sequence[int]) -> str:
    """The tier of a collective from its group's ranks, as JAX's
    `_a2a_stage` reads axis_index_groups: the whole axis is the flat
    single-stage exchange; contiguous members (in the axis's order) the
    in-node stage-1 blocks ('ici'); strided members the cross-node
    stage-2 rails ('dcn')."""
    pos = sorted(axis_ranks.index(r) for r in ranks if r in axis_ranks)
    if len(pos) == len(axis_ranks):
        return "flat"
    return "ici" if all(b - a == 1 for a, b in zip(pos, pos[1:])) else "dcn"


@contextlib.contextmanager
def _recording(axis_ranks: Sequence[int]) -> Iterator[List[Dict[str, Any]]]:
    """Patch the torch.distributed collectives the port calls: record
    each (primitive, group ranks, stage, payload bytes), then fill its
    outputs as a world of identical ranks would (nothing is sent)."""
    import torch.distributed as dist

    ops: List[Dict[str, Any]] = []
    saved = {n: getattr(dist, n) for n in COLLECTIVE_PRIMITIVES}

    def record(name, group, payload):
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(dist.get_world_size())))
        ops.append({"primitive": COLLECTIVE_PRIMITIVES[name],
                    "ranks": list(ranks),
                    "stage": _stage(ranks, axis_ranks),
                    "payload_bytes": int(payload.numel()
                                         * payload.element_size())})
        return len(ranks)

    class _Done:
        def wait(self):
            return True

    def all_reduce(t, op=None, group=None, async_op=False):
        record("all_reduce", group, t)
        return _Done() if async_op else None

    def reduce_scatter_tensor(out, t, op=None, group=None, async_op=False):
        n = record("reduce_scatter_tensor", group, t)
        out.copy_(t.reshape(n, *out.shape)[0])
        return _Done() if async_op else None

    def all_gather_into_tensor(out, t, group=None, async_op=False):
        n = record("all_gather_into_tensor", group, t)
        out.copy_(t.expand(n, *t.shape).reshape(out.shape))
        return _Done() if async_op else None

    def all_to_all_single(out, t, output_split_sizes=None,
                          input_split_sizes=None, group=None,
                          async_op=False):
        record("all_to_all_single", group, t)
        out.copy_(t)
        return _Done() if async_op else None

    def batch_isend_irecv(p2p_ops):
        sends = [o for o in p2p_ops if o.op is saved_isend]
        recvs = [o for o in p2p_ops if o.op is not saved_isend]
        record("batch_isend_irecv", p2p_ops[0].group, sends[0].tensor)
        for s, r in zip(sends, recvs):
            r.tensor.copy_(s.tensor)
        return [_Done() for _ in p2p_ops]

    saved_isend = dist.isend
    fakes = {"all_reduce": all_reduce,
             "reduce_scatter_tensor": reduce_scatter_tensor,
             "all_gather_into_tensor": all_gather_into_tensor,
             "all_to_all_single": all_to_all_single,
             "batch_isend_irecv": batch_isend_irecv}
    for n, f in fakes.items():
        setattr(dist, n, f)
    try:
        yield ops
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def _census(ops: List[Dict[str, Any]]) -> Dict[str, Any]:
    counts: Dict[str, int] = {}
    bytes_by: Dict[str, int] = {}
    for rec in ops:
        p = rec["primitive"]
        counts[p] = counts.get(p, 0) + 1
        bytes_by[p] = bytes_by.get(p, 0) + rec["payload_bytes"]
    return {"ops": ops, "counts": counts, "bytes_by_primitive": bytes_by}


def enumerate_collectives(fn: Callable, *args, axis_ranks=None,
                          **kwargs) -> Dict[str, Any]:
    """Census of the collectives fn(*args, **kwargs) issues through
    torch.distributed: per-op records (primitive, ranks, stage against
    `axis_ranks`, the axis the tiers factor; default every rank, payload
    bytes), counts and bytes by primitive. Needs an initialized process
    group (the audits below use torch's `fake` backend)."""
    import torch.distributed as dist

    axis = list(axis_ranks if axis_ranks is not None
                else range(dist.get_world_size()))
    with _recording(axis) as ops:
        fn(*args, **kwargs)
    return _census(ops)


AUDIT_WORLD = 8
DCN = 2


@contextlib.contextmanager
def _fake_world(n: int = AUDIT_WORLD):
    """A process group of n ranks in this process (torch's `fake`
    backend: rank 0 of n, collectives never wait for peers)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the collective audits need a process without "
                           "a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _off_host() -> float:
    return (DCN - 1) / DCN


def audit_ep_dispatch(registry=None) -> Dict[str, Any]:
    """The a2a expert dispatch priced against the replicated gather (the
    gmm path) on an 8-rank expert mesh factored dcn 2 x ici 4, one MoE
    layer forward each (JAX jaxpr_audit.py:286): a2a cross-node bytes =
    the stage-2 ('dcn') exchange payloads x (dcn-1)/dcn; gather's = the
    expert-spanning all-reduce payloads x 2(dcn-1)/dcn (the hierarchical
    ring's lower bound). The pin: a2a below gather."""
    from luminaai_tpu_torch.models.moe import MoELayer, expert_capacity
    from luminaai_tpu_torch.parallel.expert_dispatch import (
        make_dispatch_plan,
    )
    from luminaai_tpu_torch.parallel.mesh import build_mesh, use_mesh
    from luminaai_tpu_torch.parallel.sharding import param_index, take

    ep = AUDIT_WORLD
    cfg = audit_config(
        batch_size=8, num_experts=8, moe_top_k=2, capacity_factor=1.25,
        moe_dispatch="a2a", expert_parallel_size=ep, expert_dcn_size=DCN,
        moe_a2a_overlap_chunks=2,
    )
    x = torch.randn(cfg.batch_size, cfg.seq_length, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(0))

    def trace_layer(layer_cfg):
        mesh = build_mesh(layer_cfg, torch.device("cpu"))
        layer = MoELayer(layer_cfg, dtype=torch.float32, device="cpu")
        torch.nn.init.normal_(layer.router, std=0.02,
                              generator=torch.Generator().manual_seed(1))
        for attr in ("wi", "wo"):
            full = torch.randn(getattr(layer, attr).shape,
                               generator=torch.Generator().manual_seed(2))
            idx = param_index(f"layers.0.moe.{attr}", full.shape,
                              layer_cfg, mesh.shape, mesh.coords)
            setattr(layer, attr, torch.nn.Parameter(take(full, idx) * 0.02,
                                                    requires_grad=False))
        with use_mesh(mesh), torch.no_grad():
            return enumerate_collectives(layer, x,
                                         axis_ranks=mesh.group_ranks(
                                             ("expert",)))

    with _fake_world():
        a2a = trace_layer(cfg)
        gather = trace_layer(dataclasses.replace(cfg, moe_dispatch="gmm"))

    a2a_dcn = sum(int(r["payload_bytes"] * _off_host()) for r in a2a["ops"]
                  if r["primitive"] == "all_to_all" and r["stage"] == "dcn")
    gather_dcn = sum(int(2 * r["payload_bytes"] * _off_host())
                     for r in gather["ops"] if r["primitive"] == "psum")
    plan = make_dispatch_plan(
        ep=ep, dcn_size=DCN, local_groups=cfg.batch_size // ep,
        seq=cfg.seq_length, top_k=cfg.moe_top_k,
        capacity=expert_capacity(cfg, cfg.seq_length),
        num_experts=cfg.num_experts, hidden=cfg.hidden_size, itemsize=4,
        overlap_chunks=cfg.moe_a2a_overlap_chunks,
        dp_groups=cfg.batch_size)
    out = {
        "available": True,
        "mesh": {"devices": AUDIT_WORLD, "expert": ep, "dcn": DCN,
                 "ici": ep // DCN},
        "routing": (f"{cfg.num_experts} experts top-{cfg.moe_top_k} "
                    f"cf {cfg.capacity_factor}, seq {cfg.seq_length}, "
                    f"batch {cfg.batch_size}"),
        "plan": plan.to_dict(),
        "a2a": {
            "counts": a2a["counts"],
            "bytes_by_primitive": a2a["bytes_by_primitive"],
            "stages": {stage: sum(r["payload_bytes"] for r in a2a["ops"]
                                  if r["stage"] == stage
                                  and r["primitive"] == "all_to_all")
                       for stage in ("flat", "ici", "dcn")},
        },
        "replicated_gather": {
            "counts": gather["counts"],
            "bytes_by_primitive": gather["bytes_by_primitive"],
        },
        "a2a_dcn_bytes": a2a_dcn,
        "gather_dcn_bytes": gather_dcn,
        "a2a_below_gather": bool(a2a_dcn < gather_dcn),
        "note": ("one MoE layer forward on an 8-rank fake mesh (dcn 2): "
                 "a2a dcn bytes = stage-2 exchange payloads x (dcn-1)/dcn; "
                 "baseline = the gmm path's expert-spanning all-reduces "
                 "x 2(dcn-1)/dcn"),
    }
    _export_dcn_gauge(registry, "ep_dispatch_audit_dcn_bytes",
                      "DCN-crossing payload bytes per MoE layer step at "
                      "last ep-dispatch audit",
                      {"a2a": a2a_dcn, "replicated_gather": gather_dcn})
    return out


def audit_grad_reduce(registry=None) -> Dict[str, Any]:
    """The hierarchical gradient sync priced against the flat one on an
    8-rank data mesh factored dcn 2 x ici 4 (JAX jaxpr_audit.py:441):
    one sharded train step each of grad_reduce flat / hierarchical x
    accumulation 1 / 2. Flat: FSDP2's full-width all-reduces over the
    data ranks, cross-node bytes 2(dcn-1)/dcn x their payload (JAX
    counts the implicit GSPMD all-reduce the same way); hierarchical:
    the stage='dcn' rail all-reduces x 2(dcn-1)/dcn. The pin:
    hierarchical below flat."""
    from luminaai_tpu_torch.parallel.grad_reduce import (
        make_grad_reduce_plan,
    )
    from luminaai_tpu_torch.parallel.mesh import build_mesh, use_mesh
    from luminaai_tpu_torch.parallel.sharding import init_sharded_state
    from luminaai_tpu_torch.parallel.train_step import (
        make_sharded_train_step,
        shard_batch,
    )
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    dp = AUDIT_WORLD
    base = audit_config(
        batch_size=2 * dp, data_parallel_size=dp, use_moe=False,
        grad_reduce="hierarchical", gradient_dcn_size=DCN,
        grad_reduce_overlap_chunks=2,
    )
    ids = torch.randint(0, base.vocab_size, (base.batch_size,
                                             base.seq_length),
                        generator=torch.Generator().manual_seed(0))

    def census(cfg):
        mesh = build_mesh(cfg, torch.device("cpu"))
        schedule = make_schedule(cfg, 100)
        tx = make_optimizer(cfg, 100, schedule)
        model, state = init_sharded_state(cfg, mesh, tx, 0)
        step = make_sharded_train_step(cfg, model, schedule, tx, mesh)
        with use_mesh(mesh):
            batch = shard_batch({"input_ids": ids}, mesh, cfg)
            rec = enumerate_collectives(step, state, batch,
                                        axis_ranks=mesh.group_ranks(
                                            ("data",)))
        rec["grad_elems"] = sum(p.numel() for p in model.parameters())
        return rec

    variants: Dict[str, Any] = {}
    with _fake_world():
        for mode in ("flat", "hierarchical"):
            for accum in (1, 2):
                cfg = dataclasses.replace(base, grad_reduce=mode,
                                          gradient_accumulation_steps=accum)
                variants[f"{mode}/accum{accum}"] = census(cfg)

    hier, flat = variants["hierarchical/accum1"], variants["flat/accum1"]
    grad_bytes = hier["grad_elems"] * 4
    hier_dcn = sum(int(2 * r["payload_bytes"] * _off_host())
                   for r in hier["ops"]
                   if r["primitive"] == "psum" and r["stage"] == "dcn")
    flat_dcn = sum(int(2 * r["payload_bytes"] * _off_host())
                   for r in flat["ops"]
                   if r["primitive"] in ("psum", "reduce_scatter")
                   and r["stage"] == "flat" and r["payload_bytes"] > 4)
    plan = make_grad_reduce_plan(
        grad_elems=hier["grad_elems"], data_size=dp, fsdp_size=1,
        dcn_size=DCN, bucket_mb=base.grad_reduce_bucket_mb,
        overlap_chunks=base.grad_reduce_overlap_chunks,
        dcn_dtype=base.grad_reduce_dcn_dtype)
    out = {
        "available": True,
        "mesh": {"devices": AUDIT_WORLD, "data": dp, "dcn": DCN,
                 "ici": dp // DCN},
        "grad_bytes": grad_bytes,
        "plan": plan.to_dict(),
        "variants": {name: {"counts": rec["counts"],
                            "bytes_by_primitive": rec["bytes_by_primitive"]}
                     for name, rec in variants.items()},
        "hier_stages": {stage: sum(r["payload_bytes"] for r in hier["ops"]
                                   if r["stage"] == stage)
                        for stage in ("ici", "dcn")},
        "hier_dcn_bytes": hier_dcn,
        "flat_dcn_bytes": flat_dcn,
        "hier_below_flat": bool(hier_dcn < flat_dcn),
        "note": ("one sharded train step per variant on an 8-rank fake "
                 "mesh (dcn 2): hierarchical dcn bytes = the rail "
                 "all-reduce payloads x 2(dcn-1)/dcn; flat = FSDP2's "
                 "full-width gradient all-reduces x 2(dcn-1)/dcn (scalar "
                 "loss reductions left out of both)"),
    }
    _export_dcn_gauge(registry, "grad_reduce_audit_dcn_bytes",
                      "DCN-crossing gradient-sync payload bytes per step "
                      "at last grad-reduce audit",
                      {"hierarchical": hier_dcn, "flat": flat_dcn})
    return out


def _export_dcn_gauge(registry, name: str, doc: str,
                      values: Dict[str, int]) -> None:
    from luminaai_tpu_torch.monitoring.telemetry import get_registry

    g = (registry or get_registry()).gauge(name, doc, labelnames=("path",))
    for path, v in values.items():
        g.labels(path=path).set(float(v))


# --------------------------------------------------------------------------
# combined entry point (what `analyze` calls)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class AuditVerdict:
    """One auditor's pass/fail plus its full report."""

    name: str
    ok: bool
    detail: Dict[str, Any]


def run_audits(
    cfg=None, registry=None, programs: Sequence[str] = ("train", "decode")
) -> Tuple[List[AuditVerdict], Dict[str, Any]]:
    """Run the auditors; the verdicts drive `analyze`'s exit code, the
    report rides in --json. An audit that crashes fails its verdict: an
    unenumerable surface means the audit lost its subject, not that the
    repo is clean."""
    cfg = cfg or audit_config()
    verdicts: List[AuditVerdict] = []
    try:
        surface = enumerate_recompile_surface(cfg, programs=programs,
                                              registry=registry)
        bad = _unallowed(surface["host_syncs"])
        verdicts.append(AuditVerdict(
            "host_syncs", ok=not bad,
            detail={"unallowed": bad,
                    "by_op": surface["host_syncs"]["by_op"]}))
    except Exception as e:  # the gate reports a crash as a failure
        surface = {"error": f"{type(e).__name__}: {e}"}
        verdicts.append(AuditVerdict("host_syncs", ok=False, detail=surface))
    try:
        coverage = audit_sharding_coverage(cfg, registry=registry)
        verdicts.append(AuditVerdict(
            "sharding_coverage", ok=coverage["unannotated_leaves"] == 0,
            detail={"coverage": coverage["coverage"],
                    "unannotated_leaves": coverage["unannotated_leaves"],
                    "flagged": coverage["flagged"]}))
    except Exception as e:
        coverage = {"error": f"{type(e).__name__}: {e}"}
        verdicts.append(AuditVerdict("sharding_coverage", ok=False,
                                     detail=coverage))
    report = {"recompile_surface": surface, "sharding_coverage": coverage}
    return verdicts, report
