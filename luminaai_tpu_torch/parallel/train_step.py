"""Train and eval steps with gradient accumulation (port of luminaai_tpu/parallel/train_step.py).

The step's contract, on one card (`make_train_step`) and over a mesh
(`make_sharded_train_step`, below):

  - labels are the inputs shifted left by one, with the last position and
    any loss_mask / loss_weights shifted to the predicted token;
  - the loss is the fused LM-head CE (config.fused_lm_head_ce) or CE over
    full logits, plus the model's aux loss (the MoE layers' load-balancing
    and z losses); the MoE router metrics ride along in the metrics, and
    the routing noise is drawn from the state's generator;
  - gradients accumulate over `gradient_accumulation_steps` micro-batches
    (rows [i*mb, (i+1)*mb) of the batch) in fp32 as sum(g_i / accum);
    metrics average over micro-batches, except tokens_in_loss, summed;
  - then clip by global norm (reporting the pre-clip norm), apply AdamW
    in the config's moment form (fp32, bf16 mu or int8), and report
    grad_norm and the learning rate of this update.

Over a mesh with pipeline stages the sharded step is
parallel/pipeline.py's (the JAX dispatch, train_step.py:215-220).

config.dropout is accepted and read by no layer, as in the JAX package
(its layers never apply it).

The parameters and optimizer state are updated in place (TrainState holds
the model's parameter tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.ops.fused import (
    clip_by_global_norm,
    cross_entropy_loss,
    fused_lm_head_cross_entropy,
    global_norm,
)
from luminaai_tpu_torch.training.optimizer import AdamW, Schedule

Batch = Dict[str, torch.Tensor]


def check_trainable(config: Config) -> None:
    """Refuse training settings the port does not run: the batch must
    split into the accumulation's micro-batches; a pipelined layer stack
    must be one homogeneous segment (parallel/pipeline.py)."""
    if config.pipeline_parallel_size > 1:
        from luminaai_tpu_torch.parallel.pipeline import pipeline_compatible

        ok, why = pipeline_compatible(config)
        if not ok:
            raise ValueError(f"config not pipeline-compatible: {why}")
    if config.batch_size % max(1, config.gradient_accumulation_steps):
        raise ValueError(
            f"batch_size {config.batch_size} is not a multiple of "
            f"gradient_accumulation_steps "
            f"{config.gradient_accumulation_steps}"
        )


def shift_labels(batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token labels and their validity mask from input_ids; the last
    position has no target."""
    ids = batch["input_ids"]
    labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
    valid = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    valid[:, -1] = 0.0
    return labels, valid


def shift_with_labels(x: torch.Tensor) -> torch.Tensor:
    """Left-shift a per-position tensor so index i refers to the predicted
    token (ids[i+1]), matching shift_labels."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


def _shifted_mask_weights(
    batch: Batch, valid: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    loss_mask = batch.get("loss_mask")
    mask = valid if loss_mask is None else valid * shift_with_labels(
        loss_mask
    )
    weights = batch.get("loss_weights")
    if weights is not None:
        weights = shift_with_labels(weights)
    return mask, weights


def _ce(config: Config, model, model_out, labels, mask, weights,
        z_loss_weight: float = 0.0, label_smoothing: float = 0.0):
    """The fused LM-head CE (no [B, S, V] logits) or CE over full logits,
    as config.fused_lm_head_ce says; vocab-parallel over the active
    mesh's tensor group where the head is cut by vocabulary."""
    tg = model.embedder.vocab_group()
    if config.fused_lm_head_ce:
        return fused_lm_head_cross_entropy(
            model_out, model.embedder.head_weight(), labels,
            loss_mask=mask, loss_weights=weights,
            z_loss_weight=z_loss_weight, label_smoothing=label_smoothing,
            chunk_size=config.loss_chunk_size, tensor_group=tg,
        )
    return cross_entropy_loss(
        model_out, labels, loss_mask=mask, loss_weights=weights,
        z_loss_weight=z_loss_weight, label_smoothing=label_smoothing,
        tensor_group=tg,
    )


def make_loss_fn(config: Config, model) -> Callable:
    """loss_fn(batch, generator) -> (total loss, metrics)."""

    def loss_fn(batch: Batch, generator: Optional[torch.Generator] = None):
        model_out, aux = model(
            batch["input_ids"], deterministic=False,
            return_hidden=config.fused_lm_head_ce, generator=generator,
        )
        labels, valid = shift_labels(batch)
        mask, weights = _shifted_mask_weights(batch, valid)
        loss, metrics = _ce(
            config, model, model_out, labels, mask, weights,
            z_loss_weight=config.z_loss_weight,
            label_smoothing=config.label_smoothing,
        )
        total = loss + aux.get("aux_loss", 0.0)
        for k, v in aux.items():
            metrics[k] = v.detach()
        metrics["loss"] = total.detach()
        return total, metrics

    return loss_fn


def _accumulate_grads(loss_fn, params: List[torch.Tensor], batch: Batch,
                      generator: Optional[torch.Generator],
                      accum_steps: int):
    """(fp32 grads summed as sum(g_i / accum), metrics) over micro-batch
    slices of the batch."""
    if accum_steps <= 1:
        loss, metrics = loss_fn(batch, generator)
        return list(torch.autograd.grad(loss, params)), metrics

    micro = {
        k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])
        for k, v in batch.items()
    }
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    stack: List[Dict[str, torch.Tensor]] = []
    for i in range(accum_steps):
        loss, metrics = loss_fn({k: v[i] for k, v in micro.items()},
                                generator)
        grads = torch.autograd.grad(loss, params)
        for a, g in zip(acc, grads):
            a.add_(g.float() / accum_steps)
        del loss, grads
        stack.append(metrics)
    metrics = {
        k: torch.stack([m[k] for m in stack]).sum(0)
        if k == "tokens_in_loss"
        else torch.stack([m[k] for m in stack]).mean(0)
        for k in stack[0]
    }
    return acc, metrics


@dataclasses.dataclass
class TrainState:
    """Parameters (the model's tensors, updated in place), optimizer
    state, step count and the step's random generator (the JAX TrainState
    without sharding; the optimizer itself is not stored, as there).
    `names` are the parameters' state_dict keys, in the order of `params`
    and of the Adam moments (checkpoints store them by name)."""

    step: int
    params: List[torch.Tensor]
    opt_state: Any  # optimizer.AdamWState or AdamInt8State
    generator: torch.Generator
    names: List[str] = dataclasses.field(default_factory=list)

    def apply_gradients(self, grads: List[torch.Tensor], tx: AdamW) -> float:
        lr = tx.apply(self.params, grads, self.opt_state)
        self.step += 1
        return lr


def init_train_state(model, tx: AdamW, seed: int) -> TrainState:
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if not named:
        raise ValueError("the model has no trainable parameters: build it "
                         "with trainable=True")
    params = [p for _, p in named]
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    names = [n for n, _ in named]
    return TrainState(step=0, params=params,
                      opt_state=tx.init(params, names), generator=gen,
                      names=names)


def make_train_step(
    config: Config,
    model,
    schedule: Optional[Schedule],
    tx: AdamW,
    loss_fn: Optional[Callable] = None,
):
    """step(state, batch) -> (state, metrics); batch tensors on the
    model's device. The state is updated in place and returned. Under
    pipeline stages without a mesh every stage plays in this process
    (parallel/pipeline.py virtual_pipeline_step)."""
    check_trainable(config)
    if config.pipeline_parallel_size > 1 and loss_fn is None:
        from luminaai_tpu_torch.parallel.pipeline import (
            make_pipeline_train_step,
        )

        return make_pipeline_train_step(config, model, schedule, tx)
    loss_fn = loss_fn or make_loss_fn(config, model)
    accum = config.gradient_accumulation_steps

    def train_step(state: TrainState, batch: Batch):
        grads, metrics = _accumulate_grads(
            loss_fn, state.params, batch, state.generator, accum
        )
        if config.grad_clip_norm > 0:
            grads, grad_norm = clip_by_global_norm(grads,
                                                   config.grad_clip_norm)
        else:  # clipping off; still report the norm
            grad_norm = global_norm(grads)
        lr = state.apply_gradients(grads, tx)
        metrics["grad_norm"] = grad_norm
        if schedule is not None:
            metrics["learning_rate"] = torch.tensor(lr, dtype=torch.float32)
        return state, metrics

    return train_step


def make_eval_step(config: Config, model, loss_fn: Optional[Callable] = None):
    """eval(state, batch) -> metrics: forward only, deterministic, no
    z-loss or label smoothing (as the JAX eval step)."""

    @torch.no_grad()
    def eval_loss(batch: Batch):
        model_out, aux = model(
            batch["input_ids"], deterministic=True,
            return_hidden=config.fused_lm_head_ce,
        )
        labels, valid = shift_labels(batch)
        mask, weights = _shifted_mask_weights(batch, valid)
        loss, metrics = _ce(config, model, model_out, labels, mask, weights)
        for k, v in aux.items():
            metrics[k] = v
        metrics["loss"] = loss + aux.get("aux_loss", 0.0)
        return metrics

    if config.pipeline_parallel_size > 1 and loss_fn is None:
        from luminaai_tpu_torch.parallel.pipeline import (
            make_pipeline_eval_step,
        )

        return make_pipeline_eval_step(config, model)
    run_loss = loss_fn or eval_loss

    def call(state: Optional[TrainState], batch: Batch):
        return run_loss(batch)

    return call


# --------------------------------------------------------------------------
# the sharded step (JAX train_step.py:195 over a mesh)
# --------------------------------------------------------------------------

# Metrics scaled by a rank's share of the loss weight, then summed (JAX
# grad_reduce._WSCALE_KEYS).
_WSCALE_KEYS = ("ce_loss", "total_loss", "z_loss")


def local_rows(batch_size: int, accum: int, n: int, i: int) -> torch.Tensor:
    """The rows of a global batch that batch rank i of n holds: its 1/n of
    every micro-batch (rows [j * mb + i * mb / n, ...) for micro-batch j
    of mb rows), so micro-batch j over the ranks is the one-rank step's
    micro-batch j. One contiguous block without accumulation."""
    accum = max(1, accum)
    mb = batch_size // accum
    if batch_size % accum or mb % n:
        raise ValueError(
            f"batch_size {batch_size} does not split into {accum} "
            f"micro-batches over {n} batch ranks")
    ml = mb // n
    return torch.cat([torch.arange(j * mb + i * ml, j * mb + (i + 1) * ml)
                      for j in range(accum)])


def shard_batch(batch: Batch, mesh, config: Config) -> Batch:
    """This rank's rows (local_rows over the mesh's (data, fsdp) ranks) of
    a global batch; a batch of the local size passes unchanged."""
    n = mesh.axis_size("data", "fsdp")
    B = next(iter(batch.values())).shape[0]
    if n == 1 or B != config.batch_size:
        return batch
    rows = local_rows(B, micro_batches(config), n,
                      mesh.axis_index("data", "fsdp"))
    return {k: v[rows.to(v.device)] for k, v in batch.items()}


def micro_batches(config: Config) -> int:
    """The micro-batches a step splits its batch into: the pipeline's
    microbatches under pipeline stages, else the accumulation steps."""
    if config.pipeline_parallel_size > 1:
        return config.pipeline_microbatches or config.pipeline_parallel_size
    return max(1, config.gradient_accumulation_steps)


def _make_local_loss(config: Config, model, mesh, red_group, n_red: int,
                     train: bool):
    """loss(batch, generator) -> (this rank's share of the global loss,
    global metrics): the JAX _make_local_loss_fn (grad_reduce.py:383).
    The batch holds this rank's rows over the whole sequence; labels and
    masks shift there, then this rank's sequence chunk is kept. The CE
    scales by local weight / global weight (one scalar all-reduce), the
    aux losses by 1/n_red; the metrics come back global."""
    from luminaai_tpu_torch.parallel.mesh import psum, use_mesh

    sp, si = mesh.shape["sequence"], mesh.coords["sequence"]

    def loss(batch: Batch, generator: Optional[torch.Generator] = None):
        labels, valid = shift_labels(batch)
        mask, weights = _shifted_mask_weights(batch, valid)
        ids = batch["input_ids"]
        if sp > 1:
            sl = ids.shape[1] // sp
            cut = slice(si * sl, (si + 1) * sl)
            ids, labels, mask = ids[:, cut], labels[:, cut], mask[:, cut]
            if weights is not None:
                weights = weights[:, cut]
        with use_mesh(mesh):
            model_out, aux = model(ids, deterministic=not train,
                                   return_hidden=config.fused_lm_head_ce,
                                   generator=generator)
            ce, metrics = _ce(
                config, model, model_out, labels, mask, weights,
                z_loss_weight=config.z_loss_weight if train else 0.0,
                label_smoothing=config.label_smoothing if train else 0.0)
        w = mask if weights is None else mask * weights
        raw = w.sum()
        wscale = raw.clamp(min=1.0) / psum(raw, red_group).clamp(min=1.0)
        aux_loss = aux.get("aux_loss", torch.zeros((), device=ids.device))
        scaled = ce * wscale + aux_loss * (1.0 / n_red)
        out: Dict[str, torch.Tensor] = {}
        for k, v in {**metrics, **{k: v.detach() for k, v in aux.items()}
                     }.items():
            if k == "perplexity":
                continue
            if k == "tokens_in_loss":
                out[k] = psum(v, red_group)
            elif k.startswith("ep_tokens"):  # summed in the MoE layer
                out[k] = v
            elif k in _WSCALE_KEYS:
                out[k] = psum(v * wscale, red_group)
            else:
                out[k] = psum(v, red_group) / n_red
        out["loss"] = psum(scaled.detach(), red_group)
        if "ce_loss" in out:
            out["perplexity"] = torch.exp(out["ce_loss"].clamp(max=20.0))
        return scaled, out

    return loss


def _mean_metrics(stack: List[Dict[str, torch.Tensor]]):
    return {
        k: torch.stack([m[k] for m in stack]).sum(0)
        if k == "tokens_in_loss"
        else torch.stack([m[k] for m in stack]).mean(0)
        for k in stack[0]
    }


def sharded_global_norm(state, grads: List[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of gradients held as this rank's pieces: each
    piece's square sum weighs 1 / (the ranks holding the same piece), one
    all-reduce over the world (optax's global_norm of the sharded tree)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    mesh, cfg = state.mesh, state.config
    world, tp = mesh.size, mesh.shape["tensor"]
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for p, g, ix, name in zip(state.dparams, grads, state.index,
                              state.names):
        pieces = mesh.shape["fsdp"] if isinstance(p, DTensor) else 1
        if name.startswith("layers."):  # one pipeline stage holds it
            pieces *= mesh.shape["pipe"]
        if ".moe." in name and 0 in ix:
            pieces *= mesh.shape["expert"]
        tp_cut = bool(set(ix) - {0}) if ".moe." in name else bool(ix)
        g = g.float()
        if tp_cut and name.endswith("attention.wqkv") and (
                cfg.num_kv_heads % tp):
            # The kv columns are whole on every tensor rank (the JAX
            # kv_heads fallback); the q columns are cut.
            nq = cfg.num_heads // tp * cfg.head_dim()
            total = total + g[:, :nq].square().sum() * (pieces * tp / world)
            total = total + g[:, nq:].square().sum() * (pieces / world)
            continue
        if tp_cut:
            pieces *= tp
        total = total + g.square().sum() * (pieces / world)
    if dist.is_initialized() and world > 1:
        dist.all_reduce(total)
    return torch.sqrt(total)


def make_sharded_train_step(config: Config, model, schedule, tx, mesh):
    """step(state, batch) -> (state, metrics) over the mesh: `state` a
    parallel.sharding.ShardedTrainState, `batch` this rank's rows
    (shard_batch) over the whole sequence.

    grad_reduce 'flat': FSDP2 reduce-scatters the gradients into `.grad`
    (backward(), not autograd.grad, which never fills it), with the
    gradient sync held back on every micro-batch but the last; each
    rank's loss is scaled by the reduce group's size so that FSDP2's
    average is the sum of the ranks' shares, and the fp32 gradients equal
    sum(g_i / accum) over the one-rank micro-batches. 'hierarchical': the
    one-card functional accumulation on each rank, then
    grad_reduce.hierarchical_grad_sync. Then the global norm over every
    shard, clipping, and AdamW on the local shards."""
    from luminaai_tpu_torch.parallel.grad_reduce import (
        make_hierarchical_grad_fn,
    )

    check_trainable(config)
    accum = max(1, config.gradient_accumulation_steps)
    # The batch must split into each micro-batch's share of every batch
    # rank: refuse here, not at the first batch.
    local_rows(config.batch_size, micro_batches(config),
               mesh.axis_size("data", "fsdp"), 0)
    if config.pipeline_parallel_size > 1:
        from luminaai_tpu_torch.parallel.pipeline import (
            make_pipeline_train_step,
        )

        return make_pipeline_train_step(config, model, schedule, tx, mesh)
    hierarchical = config.grad_reduce == "hierarchical"
    # The JAX hierarchical region trains with per-shard MoE statistics.
    mesh.stat_axes = () if hierarchical else ("data", "fsdp")
    red = ("data", "fsdp") if hierarchical else ("data", "fsdp", "sequence")
    red_group, n_red = mesh.group(*red), mesh.axis_size(*red)
    loss_fn = _make_local_loss(config, model, mesh, red_group, n_red, True)
    fsdp = hasattr(model, "set_requires_gradient_sync")

    def micro(batch: Batch):
        return [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                 for k, v in batch.items()} for i in range(accum)]

    def accumulate_fsdp(state, batch, generator):
        stack = []
        for i, mb in enumerate(micro(batch)):
            if fsdp:
                model.set_requires_gradient_sync(i == accum - 1)
            scaled, metrics = loss_fn(mb, generator)
            (scaled * (n_red / accum)).backward()
            stack.append(metrics)
        grads = [local_grad(p) for p in state.dparams]
        for p in state.dparams:
            p.grad = None
        return grads, _mean_metrics(stack)

    def accumulate_local(params, batch, generator):
        return _accumulate_grads(loss_fn, params, batch, generator, accum)

    hier_fn = (make_hierarchical_grad_fn(config, mesh, accumulate_local)
               if hierarchical else None)

    def train_step(state, batch: Batch):
        if hierarchical:
            grads, metrics = hier_fn(state.dparams, batch, state.generator)
        else:
            grads, metrics = accumulate_fsdp(state, batch, state.generator)
        grad_norm = sharded_global_norm(state, grads)
        if config.grad_clip_norm > 0:
            scale = torch.clamp(config.grad_clip_norm / (grad_norm + 1e-6),
                                max=1.0)
            grads = [(g * scale).to(g.dtype) for g in grads]
        lr = state.apply_gradients(grads, tx)
        metrics["grad_norm"] = grad_norm
        if schedule is not None:
            metrics["learning_rate"] = torch.tensor(lr, dtype=torch.float32)
        return state, metrics

    return train_step


def local_grad(p: torch.Tensor) -> torch.Tensor:
    """This rank's piece of p's gradient (its FSDP2 shard), fp32 zeros
    where the parameter took none."""
    from torch.distributed.tensor import DTensor

    g = p.grad
    if g is None:
        local = p.to_local() if isinstance(p, DTensor) else p
        return torch.zeros_like(local, dtype=torch.float32)
    return g.to_local() if isinstance(g, DTensor) else g


def make_sharded_eval_step(config: Config, model, mesh):
    """eval(state, batch) -> global metrics over the mesh (forward only,
    deterministic, no z-loss or label smoothing, as make_eval_step); the
    pipelined eval under pipeline stages."""
    if config.pipeline_parallel_size > 1:
        from luminaai_tpu_torch.parallel.pipeline import (
            make_pipeline_eval_step,
        )

        return make_pipeline_eval_step(config, model, mesh)
    red = ("data", "fsdp") if config.grad_reduce == "hierarchical" else (
        "data", "fsdp", "sequence")
    loss_fn = _make_local_loss(config, model, mesh, mesh.group(*red),
                               mesh.axis_size(*red), False)

    @torch.no_grad()
    def call(state, batch: Batch):
        return loss_fn(batch)[1]

    return call
