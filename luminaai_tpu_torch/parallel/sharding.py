"""Logical-axis sharding of the model and its train state (port of luminaai_tpu/parallel/sharding.py).

The JAX package annotates every parameter with logical axis names and
maps them onto mesh axes by one rule table (`LOGICAL_AXIS_RULES`, the JAX
table, with `logical_axis_rules`' fallbacks). The port applies the same
table to its modules:

  - 'embed' -> fsdp: FSDP2 `fully_shard`, one unit per block and the root
    (embedding, final norm), over `Mesh.fsdp`: sharded over fsdp and
    replicated over data x sequence (HSDP), parameters all-gathered
    before a unit's forward and resharded after it, gradients
    reduce-scattered (ZeRO-3). The optimizer's moments are built on the
    local shards, so they live on the same shards. FSDP2 shards dimension
    0 where JAX shards the 'embed' dimension: the same bytes a rank, the
    same numbers. Under grad_reduce='hierarchical' nothing is
    FSDP-sharded: the (data, fsdp) ranks hold the model and
    parallel/grad_reduce.py sums their gradients.
  - 'heads' / 'kv_heads' / 'mlp' / 'mlp_fused' -> tensor: each tensor rank
    holds its q heads' and kv heads' columns of the fused wqkv (all kv
    columns where the kv heads do not divide, the JAX kv_heads fallback),
    the matching rows of wo, and its gate and up columns of the SwiGLU
    and expert wi (the matched halves JAX's gmm path passes) with the
    matching rows of wo; the layers sum the partial outputs over the
    tensor group (models/layers.py, models/moe.py). These are local
    slices with the collectives written out, not DTensors: the port's
    projections are raw parameters in fused layouts (wqkv, gate|up),
    which `parallelize_module`'s column split cannot cut by head.
    'vocab' -> tensor is not applied: the embedding and head stay whole
    on every tensor rank.
  - 'expert' -> expert: each expert rank holds num_experts / ep experts.

`init_sharded_state` builds the one-rank model from the seed on every
rank, cuts each rank's slices out of it and shards it, so N ranks hold
exactly the one-rank model's values; `ShardedTrainState.gather_full` /
`load_full` move a whole state (the one-rank layout, what checkpoints
store) in and out of the shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.parallel.mesh import Mesh
from luminaai_tpu_torch.parallel.train_step import TrainState

# (logical axis, mesh axis/axes), first match wins (the JAX table).
LOGICAL_AXIS_RULES: Tuple[Tuple[str, Any], ...] = (
    ("layers", "pipe"),
    ("embed", "fsdp"),
    ("vocab", "tensor"),
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("mlp", "tensor"),
    ("mlp_fused", "tensor"),
    ("expert", "expert"),
    ("head_dim", None),
    ("activation_batch", ("data", "fsdp")),
    ("activation_length", "sequence"),
    ("activation_embed", None),
    ("activation_heads", "tensor"),
    ("activation_kv_heads", "tensor"),
    ("activation_vocab", "tensor"),
    ("activation_exp_batch", ("data", "fsdp")),
)


def logical_axis_rules(config: Optional[Config] = None):
    """The rule table, adjusted where a mapping would not divide: kv heads
    fewer than (or not a multiple of) the tensor ranks replicate the kv
    projections over tensor; pipeline x sequence drops activation_length
    (the JAX function, :63)."""
    rules = list(LOGICAL_AXIS_RULES)
    if config is not None and config.tensor_parallel_size > 1:
        if config.num_kv_heads % config.tensor_parallel_size != 0:
            rules = [
                (lg, None if lg in ("kv_heads", "activation_kv_heads")
                 else m) for lg, m in rules
            ]
    if (config is not None and config.pipeline_parallel_size > 1
            and config.sequence_parallel_size > 1):
        rules = [(lg, None if lg == "activation_length" else m)
                 for lg, m in rules]
    return tuple(rules)


def _rule(rules, logical: str):
    for lg, m in rules:
        if lg == logical:
            return m
    return None


def param_index(name: str, full_shape, config: Config,
                shape: Dict[str, int], coords: Dict[str, int]
                ) -> Dict[int, torch.Tensor]:
    """{dim: indices} of the one-rank parameter `name` that the rank at
    `coords` holds under tensor and expert parallelism ({} for a whole
    parameter). FSDP's dim-0 shards come on top of these."""
    rules = logical_axis_rules(config)
    tp = shape["tensor"] if _rule(rules, "heads") == "tensor" else 1
    t = coords["tensor"] if tp > 1 else 0
    ep, e = shape["expert"], coords["expert"]
    kind = name.rsplit(".", 2)
    owner, attr = (kind[-2], kind[-1]) if len(kind) >= 2 else ("", name)
    idx: Dict[int, torch.Tensor] = {}

    def span(lo, n):
        return torch.arange(lo, lo + n)

    if owner == "attention" and tp > 1:
        d = config.head_dim()
        nq, nkv = config.num_heads, config.num_kv_heads
        nq_l = nq // tp
        q = span(t * nq_l * d, nq_l * d)
        if attr == "wqkv":
            if _rule(rules, "kv_heads") == "tensor":
                nkv_l = nkv // tp
                kv = span(t * nkv_l * d, nkv_l * d)
                cols = [q, nq * d + kv, (nq + nkv) * d + kv]
            else:
                cols = [q, span(nq * d, 2 * nkv * d)]
            idx[1] = torch.cat(cols)
        elif attr == "wo":
            idx[0] = q
    elif owner in ("ffn", "moe") and attr in ("wi", "wo"):
        base = 1 if owner == "moe" else 0
        if owner == "moe" and ep > 1:
            el = full_shape[0] // ep
            idx[0] = span(e * el, el)
        if tp > 1:
            if attr == "wi":
                f = full_shape[base + 1] // 2
                fl = f // tp
                idx[base + 1] = torch.cat([span(t * fl, fl),
                                           span(f + t * fl, fl)])
            else:
                fl = full_shape[base] // tp
                idx[base] = span(t * fl, fl)
    return idx


def take(full: torch.Tensor, index: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The slice of `full` that `index` (param_index) selects."""
    for dim, ix in index.items():
        full = full.index_select(dim, ix.to(full.device))
    return full.contiguous()


def put(full: torch.Tensor, index: Dict[int, torch.Tensor],
        piece: torch.Tensor) -> None:
    """full[index] = piece, in place (the inverse of take)."""
    if not index:
        full.copy_(piece)
        return
    nd = full.ndim
    ixs = []
    for dim in range(nd):
        ix = index.get(dim, torch.arange(full.shape[dim]))
        view = [1] * nd
        view[dim] = -1
        ixs.append(ix.to(full.device).view(view))
    full[tuple(ixs)] = piece.to(full.dtype)


def _row_split(index: Dict[int, torch.Tensor], local: torch.Tensor,
               row: int, fsdp_sharded: bool, mesh: Mesh):
    """The group a parameter's int8-moment rows span (None where every
    row lies on this rank)."""
    if local.ndim == 1 and fsdp_sharded:
        return mesh.group("fsdp")
    if local.ndim - 1 in index and row == local.shape[-1]:
        # A tensor-parallel cut through the last dimension (wi's gate|up
        # columns): the one-rank row is the whole last dimension.
        return mesh.group("tensor")
    return None


@dataclasses.dataclass
class ShardedTrainState(TrainState):
    """TrainState over this rank's shards: `params` are the local tensors
    the optimizer updates in place (views of the FSDP2 shards), `dparams`
    the module's parameters (DTensors under FSDP2), `index` each one's
    param_index; `full_shapes` the one-rank shapes."""

    mesh: Optional[Mesh] = None
    dparams: List[torch.Tensor] = dataclasses.field(default_factory=list)
    index: List[Dict[int, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    full_shapes: List[Tuple[int, ...]] = dataclasses.field(
        default_factory=list)
    config: Optional[Config] = None
    sharded = True

    # -- whole-state transfers (checkpoints) -------------------------------
    def _gather(self, i: int, local: torch.Tensor, kind: str = "param"
                ) -> Optional[torch.Tensor]:
        """The one-rank tensor of parameter i's `local` (laid out as its
        local shard: the parameter or a moment; kind 'scale' for int8
        scales), on the CPU on rank 0 (None elsewhere). Collective."""
        from torch.distributed.tensor import DTensor

        p, mesh = self.dparams[i], self.mesh
        local = local.detach()
        full_shape = self._full_shape(i, kind)
        if isinstance(p, DTensor) and local.ndim >= 1:
            shape = (p.shape[0],) + tuple(local.shape[1:])
            local = DTensor.from_local(
                local.contiguous(), p.device_mesh, p.placements,
                shape=torch.Size(shape), stride=_contiguous_stride(shape),
                run_check=False).full_tensor()
        mp = mesh.group("expert", "tensor")
        if mp is None or not self.index[i]:
            pieces = [(self._index(i, kind, mesh.coords), local)]
        else:
            n = dist.get_world_size(mp)
            buf = torch.empty(n * local.numel(), dtype=local.dtype,
                              device=local.device)
            dist.all_gather_into_tensor(buf, local.reshape(-1).contiguous(),
                                        group=mp)
            buf = buf.view((n,) + tuple(local.shape))
            pieces = []
            for j, r in enumerate(mesh.group_ranks(("expert", "tensor"))):
                coords = dict(mesh.coords, expert=_coord(mesh, r, "expert"),
                              tensor=_coord(mesh, r, "tensor"))
                pieces.append((self._index(i, kind, coords), buf[j]))
        if mesh.rank != 0:
            return None
        full = torch.empty(full_shape, dtype=local.dtype)
        for ix, piece in pieces:
            put(full, ix, piece.cpu())
        return full

    def _full_row(self, i: int) -> int:
        """The one-rank int8 row of parameter i: its local row, or the
        whole last dimension where the local row is the local last
        dimension (a row cut over ranks: _row_split)."""
        row = self.opt_state.rows[i]
        if row == self.params[i].shape[-1]:
            return self.full_shapes[i][-1]
        return row

    def _full_shape(self, i: int, kind: str) -> Tuple[int, ...]:
        shape = tuple(self.full_shapes[i])
        if kind != "scale":
            return shape
        row = self._full_row(i)
        return shape[:-1] + (() if row == shape[-1]
                             else (shape[-1] // row,))

    def _index(self, i: int, kind: str, coords) -> Dict[int, torch.Tensor]:
        ix = param_index(self.names[i], self.full_shapes[i], self.config,
                         self.mesh.shape, coords)
        if kind != "scale":
            return ix
        return _scale_index(ix, len(self.full_shapes[i]), self._full_row(i),
                            self.full_shapes[i][-1])

    def gather_full(self) -> Optional[TrainState]:
        """The whole state in the one-rank layout, on the CPU, on rank 0
        (None on the others). Collective: every rank calls it."""
        opt = self.opt_state

        def full(ts, kind="param"):
            return [self._gather(i, t, kind) for i, t in enumerate(ts)]

        params = full(self.params)
        if opt.form == "int8":
            from luminaai_tpu_torch.training.optimizer import AdamInt8State

            new_opt = AdamInt8State(
                count=opt.count, mu_codes=full(opt.mu_codes),
                mu_scales=full(opt.mu_scales, "scale"),
                nu_codes=full(opt.nu_codes),
                nu_scales=full(opt.nu_scales, "scale"),
                rows=[self._full_row(i) for i in range(len(opt.rows))])
        else:
            from luminaai_tpu_torch.training.optimizer import AdamWState

            new_opt = AdamWState(count=opt.count, mu=full(opt.mu),
                                 nu=full(opt.nu))
        if self.mesh.rank != 0:
            return None
        return TrainState(step=self.step, params=params, opt_state=new_opt,
                          generator=self.generator, names=list(self.names))

    def host_template(self) -> TrainState:
        """An empty whole state on the CPU for a checkpoint restore."""
        opt = self.opt_state

        def like(ts):
            return [torch.empty(s, dtype=t.dtype)
                    for s, t in zip(self.full_shapes, ts)]

        if opt.form == "int8":
            from luminaai_tpu_torch.training.optimizer import (
                AdamInt8State,
                _q8,
            )

            scales = [_q8(torch.zeros(s), self._full_row(i))[1]
                      for i, s in enumerate(self.full_shapes)]
            new_opt = AdamInt8State(
                count=0, mu_codes=like(opt.mu_codes), mu_scales=scales,
                nu_codes=like(opt.nu_codes),
                nu_scales=[t.clone() for t in scales],
                rows=[self._full_row(i) for i in range(len(opt.rows))])
        else:
            from luminaai_tpu_torch.training.optimizer import AdamWState

            new_opt = AdamWState(count=0, mu=like(opt.mu), nu=like(opt.nu))
        return TrainState(step=0, params=like(self.params),
                          opt_state=new_opt,
                          generator=torch.Generator(
                              device=self.generator.device),
                          names=list(self.names))

    def load_full(self, full: TrainState) -> None:
        """Copy a whole state (the one-rank layout, any device) into the
        shards: every rank takes its slices."""
        opt, src = self.opt_state, full.opt_state

        def copy_into(locals_, fulls, kind="param"):
            for i, (dst, f) in enumerate(zip(locals_, fulls)):
                dst.copy_(self._local_of(i, f, dst, kind))

        with torch.no_grad():
            copy_into(self.params, full.params)
            if opt.form == "int8":
                copy_into(opt.mu_codes, src.mu_codes)
                copy_into(opt.nu_codes, src.nu_codes)
                copy_into(opt.mu_scales, src.mu_scales, "scale")
                copy_into(opt.nu_scales, src.nu_scales, "scale")
            else:
                copy_into(opt.mu, src.mu)
                copy_into(opt.nu, src.nu)
        opt.count = src.count
        self.step = full.step
        self.generator.set_state(full.generator.get_state())

    def _local_of(self, i: int, full: torch.Tensor, dst: torch.Tensor,
                  kind: str) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        piece = take(full.to(dst.device),
                     self._index(i, kind, self.mesh.coords))
        if isinstance(self.dparams[i], DTensor) and piece.ndim >= 1:
            piece = _fsdp_local(piece, self.dparams[i])
        return piece.reshape(dst.shape)


def _coord(mesh: Mesh, rank: int, axis: str) -> int:
    from luminaai_tpu_torch.parallel.mesh import _unravel

    dims = [mesh.shape[a] for a in mesh.axes]
    return _unravel(rank, dims)[mesh.axes.index(axis)]


def _scale_index(index: Dict[int, torch.Tensor], ndim: int, row: int,
                 last: int) -> Dict[int, torch.Tensor]:
    """A parameter's param_index carried to its int8 scales (one per row
    of `row` elements along the last dimension; no row dimension where
    the row is the whole last dimension): the last dimension's indices
    become row indices, or drop where the row is the whole dimension (the
    scale is then the same on every rank of the cut: _q8's group
    reduction)."""
    out = {d: ix for d, ix in index.items() if d < ndim - 1}
    if ndim - 1 in index and row != last:
        out[ndim - 1] = index[ndim - 1][::row] // row
    return out


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _fsdp_local(piece: torch.Tensor, p) -> torch.Tensor:
    """This rank's FSDP2 dim-0 chunk of `piece` (torch.chunk, as FSDP2's
    Shard(0) cuts; empty past the last chunk)."""
    mesh = p.device_mesh
    dim = mesh.ndim - 1  # the shard dimension (HSDP: replicate, shard)
    chunks = torch.chunk(piece, mesh.size(dim), dim=0)
    i = mesh.get_local_rank(dim)
    if i < len(chunks):
        return chunks[i]
    return piece.new_empty((0,) + tuple(piece.shape[1:]))


def shard_model(model, mesh: Mesh, config: Config):
    """Cut this rank's tensor/expert slices out of a whole (one-rank)
    trainable model in place and shard it with FSDP2 over mesh.fsdp (not
    under grad_reduce='hierarchical'). Returns ({name: param_index},
    {name: one-rank shape})."""
    index, shapes = {}, {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            shapes[name] = tuple(p.shape)
            ix = param_index(name, p.shape, config, mesh.shape, mesh.coords)
            index[name] = ix
            if ix:
                p.data = take(p.data, ix)
    if config.grad_reduce == "flat" and mesh.fsdp is not None:
        from torch.distributed.fsdp import fully_shard

        for layer in model.layers:
            fully_shard(layer, mesh=mesh.fsdp)
        fully_shard(model, mesh=mesh.fsdp)
    return index, shapes


def local_tensor(p: torch.Tensor) -> torch.Tensor:
    """The tensor a rank updates for parameter p (its FSDP2 shard)."""
    from torch.distributed.tensor import DTensor

    return p.to_local() if isinstance(p, DTensor) else p


def init_sharded_state(config: Config, mesh: Mesh, tx, seed: int,
                       model=None):
    """(model, ShardedTrainState): the one-rank model built from `seed`
    (or `model`, whole), this rank's slices cut and FSDP2-sharded, the
    optimizer's moments on the local shards. N ranks then hold exactly
    the one-rank model's values."""
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer

    if model is None:
        model = init_params(
            LuminaTransformer(config, device=mesh.device, trainable=True),
            seed)
    index, shapes = shard_model(model, mesh, config)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    names = [n for n, _ in named]
    dparams = [p for _, p in named]
    with torch.no_grad():
        params = [local_tensor(p) for p in dparams]
    opt_state = tx.init(params, names)
    if opt_state.form == "int8":
        opt_state.groups = [
            _row_split(index[n], t, r, local_tensor(p) is not p, mesh)
            for n, t, r, p in zip(names, params, opt_state.rows, dparams)]
    gen = torch.Generator(device=mesh.device).manual_seed(int(seed))
    state = ShardedTrainState(
        step=0, params=params, opt_state=opt_state, generator=gen,
        names=names, mesh=mesh, dparams=dparams,
        index=[index[n] for n in names],
        full_shapes=[shapes[n] for n in names], config=config)
    return model, state
