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
  - 'vocab' -> tensor: tensor rank t holds rows [t V/tp, (t+1) V/tp) of
    the embedding (and of the untied lm_head), and the moments built on
    them; FSDP2 shards dimension 0 of that [V/tp, H] slice where JAX
    shards 'embed' (the same bytes a rank). The lookup and both CEs run
    vocab-parallel over the tensor group (models/layers.py Embedder,
    ops/fused.py). A vocabulary that does not divide over the tensor
    ranks is refused, as JAX's sharded init refuses it (no padding).
  - 'expert' -> expert: each expert rank holds num_experts / ep experts.

  - 'layers' -> pipe: stage p holds layers [p L / P, (p + 1) L / P)
    (parallel/pipeline.py); the embedding and final norm are on every
    stage, as JAX keeps them outside the stages.

`init_sharded_state` builds the parameters born sharded: the model on
the meta device, another stage's layers dropped, the tensor/expert
slices cut and FSDP2 applied there, then only this rank's storage
materialized and filled one whole parameter at a time (the one-rank
`convert.init_params` draws, in its order, each dropped once its slice
is kept), so N ranks hold exactly the one-rank model's values and a rank
never holds more than its shards and the largest single parameter.
`ShardedTrainState.gather_full` / `load_full` move a whole state (the
one-rank layout, what checkpoints store) in and out of the shards, over
the pipeline stages too.
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
    vocab_tp = shape["tensor"] if _rule(rules, "vocab") == "tensor" else 1
    ep, e = shape["expert"], coords["expert"]
    kind = name.rsplit(".", 2)
    owner, attr = (kind[-2], kind[-1]) if len(kind) >= 2 else ("", name)
    idx: Dict[int, torch.Tensor] = {}

    def span(lo, n):
        return torch.arange(lo, lo + n)

    if owner == "embedder" and attr in ("embedding", "lm_head") and (
            vocab_tp > 1):
        rows = full_shape[0] // vocab_tp
        idx[0] = span(coords["tensor"] * rows, rows)
    elif owner == "attention" and tp > 1:
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
    param_index; `full_shapes` the one-rank shapes. Under pipeline stages
    a rank holds the embedding, the final norm and its stage's layers;
    `all_names` / `all_shapes` / `all_rows` describe the whole one-rank
    model (its names in order, shapes and int8 moment rows)."""

    mesh: Optional[Mesh] = None
    dparams: List[torch.Tensor] = dataclasses.field(default_factory=list)
    index: List[Dict[int, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    full_shapes: List[Tuple[int, ...]] = dataclasses.field(
        default_factory=list)
    config: Optional[Config] = None
    all_names: List[str] = dataclasses.field(default_factory=list)
    all_shapes: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    all_rows: Dict[str, int] = dataclasses.field(default_factory=dict)
    sharded = True

    # -- whole-state transfers (checkpoints) -------------------------------
    def _stage_lead(self) -> bool:
        """Whether this rank gathers its stage's tensors: all its mesh
        coordinates but the pipe one are 0 (rank 0 without stages)."""
        return all(c == 0 for a, c in self.mesh.coords.items()
                   if a != "pipe")

    def _gather(self, i: int, local: torch.Tensor, kind: str = "param"
                ) -> Optional[torch.Tensor]:
        """The one-rank tensor of parameter i's `local` (laid out as its
        local shard: the parameter or a moment; kind 'scale' for int8
        scales), on the CPU on its stage's lead rank (None elsewhere).
        Collective over the stage's ranks."""
        from torch.distributed.tensor import DTensor

        p, mesh = self.dparams[i], self.mesh
        local = local.detach().to(mesh.device)
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
        if not self._stage_lead():
            return None
        full = torch.empty(full_shape, dtype=local.dtype)
        for ix, piece in pieces:
            put(full, ix, piece.cpu())
        return full

    def _full_row(self, i: int) -> int:
        """The one-rank int8 row of parameter i."""
        return self.all_rows[self.names[i]]

    def _full_shape(self, i: int, kind: str) -> Tuple[int, ...]:
        return _kind_shape(self.names[i], tuple(self.full_shapes[i]), kind,
                           self.all_rows)

    def _index(self, i: int, kind: str, coords) -> Dict[int, torch.Tensor]:
        ix = param_index(self.names[i], self.full_shapes[i], self.config,
                         self.mesh.shape, coords)
        if kind != "scale":
            return ix
        return _scale_index(ix, len(self.full_shapes[i]), self._full_row(i),
                            self.full_shapes[i][-1])

    def _kinds(self):
        """[(key, the local tensors, kind)] of every per-parameter list."""
        opt = self.opt_state
        if opt.form == "int8":
            return [("params", self.params, "param"),
                    ("mu_codes", opt.mu_codes, "param"),
                    ("mu_scales", opt.mu_scales, "scale"),
                    ("nu_codes", opt.nu_codes, "param"),
                    ("nu_scales", opt.nu_scales, "scale")]
        return [("params", self.params, "param"), ("mu", opt.mu, "param"),
                ("nu", opt.nu, "param")]

    def _collect_stages(self, kind: str, dtype,
                        mine: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """Rank 0 receives every other stage's gathered layers from that
        stage's lead rank (in all_names order; the others send theirs).
        Returns the whole {name: tensor} on rank 0."""
        mesh = self.mesh
        P = mesh.shape["pipe"]
        if P == 1 or not self._stage_lead():
            return mine
        stage = mesh.coords["pipe"]
        if stage > 0:
            for name in self.names:
                if stage_of(name, self.config) == stage:
                    dist.send(mine[name].to(mesh.device).contiguous(), 0)
            return mine
        out = dict(mine)
        for q in range(1, P):
            src = mesh._rank_of({**{a: 0 for a in mesh.axes}, "pipe": q})
            for name in self.all_names:
                if stage_of(name, self.config) != q:
                    continue
                shape = _kind_shape(name, self.all_shapes[name], kind,
                                    self.all_rows)
                buf = torch.empty(shape, dtype=dtype, device=mesh.device)
                dist.recv(buf, src)
                out[name] = buf.cpu()
        return out

    def gather_full(self) -> Optional[TrainState]:
        """The whole state in the one-rank layout, on the CPU, on rank 0
        (None on the others). Collective: every rank calls it."""
        opt = self.opt_state
        whole = {}
        for key, ts, kind in self._kinds():
            mine = {n: self._gather(i, t, kind)
                    for i, (n, t) in enumerate(zip(self.names, ts))}
            mine = self._collect_stages(kind, ts[0].dtype, mine)
            whole[key] = [mine.get(n) for n in self.all_names]
        if self.mesh.rank != 0:
            return None
        if opt.form == "int8":
            from luminaai_tpu_torch.training.optimizer import AdamInt8State

            new_opt = AdamInt8State(
                count=opt.count, mu_codes=whole["mu_codes"],
                mu_scales=whole["mu_scales"], nu_codes=whole["nu_codes"],
                nu_scales=whole["nu_scales"],
                rows=[self.all_rows[n] for n in self.all_names])
        else:
            from luminaai_tpu_torch.training.optimizer import AdamWState

            new_opt = AdamWState(count=opt.count, mu=whole["mu"],
                                 nu=whole["nu"])
        return TrainState(step=self.step, params=whole["params"],
                          opt_state=new_opt, generator=self.generator,
                          names=list(self.all_names))

    def host_template(self) -> TrainState:
        """An empty whole state on the CPU for a checkpoint restore."""
        opt = self.opt_state

        def like(ts, kind="param"):
            return [torch.empty(_kind_shape(n, self.all_shapes[n], kind,
                                            self.all_rows),
                                dtype=ts[0].dtype) for n in self.all_names]

        if opt.form == "int8":
            from luminaai_tpu_torch.training.optimizer import AdamInt8State

            new_opt = AdamInt8State(
                count=0, mu_codes=like(opt.mu_codes),
                mu_scales=like(opt.mu_scales, "scale"),
                nu_codes=like(opt.nu_codes),
                nu_scales=like(opt.nu_scales, "scale"),
                rows=[self.all_rows[n] for n in self.all_names])
        else:
            from luminaai_tpu_torch.training.optimizer import AdamWState

            new_opt = AdamWState(count=0, mu=like(opt.mu), nu=like(opt.nu))
        return TrainState(step=0, params=like(self.params),
                          opt_state=new_opt,
                          generator=torch.Generator(
                              device=self.generator.device),
                          names=list(self.all_names))

    def load_full(self, full: TrainState) -> None:
        """Copy a whole state (the one-rank layout, any device) into the
        shards: every rank takes its slices, by name."""
        opt, src = self.opt_state, full.opt_state
        at = {n: j for j, n in enumerate(full.names)}
        srcs = {"params": full.params}
        if opt.form == "int8":
            srcs.update(mu_codes=src.mu_codes, mu_scales=src.mu_scales,
                        nu_codes=src.nu_codes, nu_scales=src.nu_scales)
        else:
            srcs.update(mu=src.mu, nu=src.nu)
        with torch.no_grad():
            for key, ts, kind in self._kinds():
                for i, (name, dst) in enumerate(zip(self.names, ts)):
                    f = srcs[key][at[name]]
                    dst.copy_(self._local_of(i, f, dst, kind))
        opt.count = src.count
        self.step = full.step
        self.generator.set_state(full.generator.get_state())

    def _local_of(self, i: int, full: torch.Tensor, dst: torch.Tensor,
                  kind: str) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        piece = take(full.to(self.mesh.device),
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


def stage_of(name: str, config: Config) -> Optional[int]:
    """The pipeline stage holding parameter `name` (the 'layers' -> pipe
    rule: stage p holds layers [p L / P, (p + 1) L / P)); None for the
    embedding and final norm, which every stage holds."""
    if not name.startswith("layers."):
        return None
    per = config.num_layers // max(1, config.pipeline_parallel_size)
    return int(name.split(".", 2)[1]) // per


def stage_layers(config: Config, stage: int) -> range:
    """The layer indices of pipeline stage `stage`."""
    per = config.num_layers // max(1, config.pipeline_parallel_size)
    return range(stage * per, (stage + 1) * per)


def _kind_shape(name: str, shape: Tuple[int, ...], kind: str,
                rows: Dict[str, int]) -> Tuple[int, ...]:
    """The one-rank shape of parameter `name`'s tensor of `kind` (its
    int8 scales: one per row of rows[name] along the last dimension)."""
    if kind != "scale":
        return tuple(shape)
    row = rows[name]
    return tuple(shape[:-1]) + (() if row == shape[-1]
                                else (shape[-1] // row,))


class AbsentLayer(torch.nn.Module):
    """The place in model.layers of a layer another pipeline stage
    holds: no parameters, never called."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this layer lives on another pipeline stage")


def local_tensor(p: torch.Tensor) -> torch.Tensor:
    """The tensor a rank updates for parameter p (its FSDP2 shard)."""
    from torch.distributed.tensor import DTensor

    return p.to_local() if isinstance(p, DTensor) else p


def _draw(name: str, shape, config: Config, gen: torch.Generator,
          device) -> torch.Tensor:
    """One whole parameter's init value (convert.init_value): the only
    whole tensor born-sharded init allocates."""
    from luminaai_tpu_torch.convert import init_value

    return init_value(name, shape, config, gen, device)


def init_sharded_state(config: Config, mesh: Mesh, tx, seed: int,
                       model=None, params: Optional[Dict[str, Any]] = None):
    """(model, ShardedTrainState), born sharded: the model built on the
    meta device, another stage's layers dropped (AbsentLayer), this rank's
    tensor/expert slices cut, FSDP2 applied (one unit a local layer and
    the root; not under grad_reduce='hierarchical'), then only the local
    storage materialized on mesh.device and filled parameter by parameter
    in the one-rank order from `params` ({name: whole tensor}), from
    `model` (a whole model) or else from `seed` (convert.init_params'
    draws, every parameter drawn whole and dropped once its slice is
    kept). The optimizer's moments are built on the local shards. N ranks
    then hold exactly the one-rank model's values."""
    from luminaai_tpu_torch.models.transformer import LuminaTransformer

    tp = mesh.shape["tensor"]
    if (tp > 1 and _rule(logical_axis_rules(config), "vocab") == "tensor"
            and config.vocab_size % tp):
        raise ValueError(
            f"vocab_size {config.vocab_size} does not divide over "
            f"tensor_parallel_size {tp}: the embedding and head are cut by "
            "vocabulary over the tensor ranks")
    if model is not None:
        params = dict(model.named_parameters())
    local_model = LuminaTransformer(config, device="meta", trainable=True)
    all_shapes = {n: tuple(p.shape)
                  for n, p in local_model.named_parameters()}
    all_names = list(all_shapes)
    row_of = getattr(tx, "row_of", lambda name, p: p.shape[-1])
    all_rows = {n: int(row_of(n, p))
                for n, p in local_model.named_parameters()}
    if mesh.shape["pipe"] > 1:
        mine = set(stage_layers(config, mesh.coords["pipe"]))
        for i in range(config.num_layers):
            if i not in mine:
                local_model.layers[i] = AbsentLayer()
    index = {}
    with torch.no_grad():
        for name, p in local_model.named_parameters():
            ix = param_index(name, p.shape, config, mesh.shape, mesh.coords)
            index[name] = ix
            if ix:
                p.data = take(p.data, ix)
    if config.grad_reduce == "flat" and mesh.fsdp is not None:
        from torch.distributed.fsdp import fully_shard

        for layer in local_model.layers:
            if not isinstance(layer, AbsentLayer):
                fully_shard(layer, mesh=mesh.fsdp)
        fully_shard(local_model, mesh=mesh.fsdp)
    local_model.to_empty(device=mesh.device)
    local_model.device = mesh.device
    named = dict(local_model.named_parameters())
    gen = torch.Generator(device=mesh.device).manual_seed(int(seed))
    with torch.no_grad():
        for name in all_names:
            if params is not None:
                if name not in named:
                    continue
                full = params[name].detach().to(mesh.device)
            else:  # every draw, in order: the generator's sequence
                full = _draw(name, all_shapes[name], config, gen,
                             mesh.device)
            if name in named:
                p = named[name]
                piece = take(full, index[name])
                dst = local_tensor(p)
                if dst is not p and piece.ndim >= 1:
                    piece = _fsdp_local(piece, p)
                dst.copy_(piece.reshape(dst.shape))
            del full
    local_model.embedder.round_()
    named = [(n, p) for n, p in local_model.named_parameters()
             if p.requires_grad]
    names = [n for n, _ in named]
    dparams = [p for _, p in named]
    with torch.no_grad():
        local = [local_tensor(p) for p in dparams]
    opt_state = tx.init(local, names)
    if opt_state.form == "int8":
        opt_state.groups = [
            _row_split(index[n], t, r, local_tensor(p) is not p, mesh)
            for n, t, r, p in zip(names, local, opt_state.rows, dparams)]
    state = ShardedTrainState(
        step=0, params=local, opt_state=opt_state,
        generator=torch.Generator(device=mesh.device).manual_seed(int(seed)),
        names=names, mesh=mesh, dparams=dparams,
        index=[index[n] for n in names],
        full_shapes=[all_shapes[n] for n in names], config=config,
        all_names=all_names, all_shapes=all_shapes, all_rows=all_rows)
    return local_model, state
