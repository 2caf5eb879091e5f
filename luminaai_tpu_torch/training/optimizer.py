"""Optimizer and learning-rate schedules (port of luminaai_tpu/training/optimizer.py).

The schedules reproduce optax's `linear_schedule`, `cosine_decay_schedule`
(with alpha), `constant_schedule` and `join_schedules` at optax's step
count: the learning rate of update t (t = 0, 1, ...) is schedule(t), so the
first update of a warmup schedule has lr 0.

`AdamW` is optax.adamw written out over tensors: Adam moments in fp32
(b1 * mu + (1 - b1) * g, b2 * nu + (1 - b2) * g^2), bias correction with
the incremented count (1 - decay**count in fp32, as optax computes it), update mu_hat / (sqrt(nu_hat) + eps), plus
weight_decay * param on the parameters the decay mask selects (ndim >= 2),
times -lr. It updates the parameters and moments in place (the JAX
TrainState is replaced functionally; here in place saves a copy of both).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from luminaai_tpu_torch.config import Config

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule (polynomial with power 1, no delay)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedule i+1 takes over at boundary i, counted
    from that boundary."""

    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def make_schedule(config: Config, total_steps: int) -> Schedule:
    """Warmup + decay schedule, as the JAX make_schedule builds it."""
    warmup_steps = max(1, int(total_steps * config.warmup_ratio))
    peak = config.learning_rate
    floor = min(config.min_lr, peak)
    if not config.use_lr_scheduler:
        return constant_schedule(peak)

    warmup = linear_schedule(0.0, peak, warmup_steps)
    decay_steps = max(1, total_steps - warmup_steps)
    kind = config.lr_scheduler
    if kind == "cosine":
        decay = cosine_decay_schedule(
            peak, decay_steps, alpha=floor / max(peak, 1e-12)
        )
    elif kind == "linear":
        decay = linear_schedule(peak, floor, decay_steps)
    elif kind == "constant":
        decay = constant_schedule(peak)
    elif kind == "wsd":
        stable_steps = int(decay_steps * 0.8)
        decay = join_schedules(
            [
                constant_schedule(peak),
                linear_schedule(peak, floor, decay_steps - stable_steps),
            ],
            [stable_steps],
        )
    else:  # validated by Config
        raise ValueError(f"unknown scheduler {kind}")
    return join_schedules([warmup, decay], [warmup_steps])


def _decay_mask(param: torch.Tensor) -> bool:
    """Weight decay on matrices only: norm scales are excluded. The port's
    fused wqkv [H, (nq + 2 nkv) d] and wo [nq d, H] are matrices, as the
    JAX wq/wk/wv [H, n, d] and wo [nq, d, H] are."""
    return param.ndim >= 2


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """optax.adamw over a list of parameters, applied in place."""

    def __init__(self, learning_rate: Schedule, b1: float, b2: float,
                 eps: float, weight_decay: float,
                 mask: Callable[[torch.Tensor], bool] = _decay_mask):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = mask

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        def zeros():
            return [torch.zeros_like(p, dtype=torch.float32) for p in params]

        return AdamWState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: AdamWState) -> float:
        """One update of every parameter in place; returns the learning
        rate it used, schedule(count)."""
        lr = self.learning_rate(state.count)
        count = state.count + 1
        # optax computes 1 - decay**count in fp32 (its count is an int32
        # array): at b2 = 0.999 that is 1.3e-5 off the exact value, which
        # moves every update by ~6e-6; compute it as optax does.
        bc1 = float(1 - np.float32(self.b1) ** np.float32(count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(count))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = g.float()
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_(torch.square(g).mul_(1 - self.b2))
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay and self.mask(p):
                update = update + self.weight_decay * p.float()
            p.add_(update.mul_(-lr).to(p.dtype))
        state.count = count
        return lr


def make_optimizer(
    config: Config,
    total_steps: int,
    schedule: Optional[Schedule] = None,
) -> AdamW:
    """AdamW with the config's schedule. Gradient clipping lives in the
    train step (it reports the pre-clip norm)."""
    if config.adam_state_quantization == "int8":
        raise NotImplementedError(
            "adam_state_quantization='int8' (scale_by_adam_int8) is not "
            "ported yet; train with fp32 Adam moments"
        )
    if config.adam_mu_dtype == "bf16":
        raise NotImplementedError(
            "adam_mu_dtype='bf16' is not ported yet; train with fp32 Adam "
            "moments"
        )
    if schedule is None:
        schedule = make_schedule(config, total_steps)
    return AdamW(schedule, config.beta1, config.beta2, config.eps,
                 config.weight_decay)
