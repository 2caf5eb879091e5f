"""Train and eval steps with gradient accumulation (port of luminaai_tpu/parallel/train_step.py).

One card, no mesh: the JAX step's sharding, donation and gradient-sync
machinery has nothing to do here. What stays is the step's contract:

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
    """Refuse training settings the port does not run on one card: the
    batch must split into the accumulation's micro-batches ('a2a' MoE
    dispatch, which needs an expert mesh, is refused where the model is
    built)."""
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
    as config.fused_lm_head_ce says."""
    if config.fused_lm_head_ce:
        return fused_lm_head_cross_entropy(
            model_out, model.embedder.head_weight(), labels,
            loss_mask=mask, loss_weights=weights,
            z_loss_weight=z_loss_weight, label_smoothing=label_smoothing,
            chunk_size=config.loss_chunk_size,
        )
    return cross_entropy_loss(
        model_out, labels, loss_mask=mask, loss_weights=weights,
        z_loss_weight=z_loss_weight, label_smoothing=label_smoothing,
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
    model's device. The state is updated in place and returned."""
    check_trainable(config)
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

    run_loss = loss_fn or eval_loss

    def call(state: Optional[TrainState], batch: Batch):
        return run_loss(batch)

    return call
