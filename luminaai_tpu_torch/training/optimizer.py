"""Optimizer and learning-rate schedules (port of luminaai_tpu/training/optimizer.py).

The schedules reproduce optax's `linear_schedule`, `cosine_decay_schedule`
(with alpha), `constant_schedule` and `join_schedules` at optax's step
count: the learning rate of update t (t = 0, 1, ...) is schedule(t), so the
first update of a warmup schedule has lr 0.

`AdamW` is optax.adamw written out over tensors: Adam moments
(b1 * mu + (1 - b1) * g, b2 * nu + (1 - b2) * g^2), bias correction with
the incremented count (1 - decay**count in fp32, as optax computes it),
update mu_hat / (sqrt(nu_hat) + eps), plus weight_decay * param on the
parameters the decay mask selects (ndim >= 2), times -lr. It updates the
parameters and moments in place (the JAX TrainState is replaced
functionally; here in place saves a copy of both). The moments take one
of three forms (`moment_form`, from the config as the JAX make_optimizer
reads it):

  - 'fp32': both moments fp32 (optax.adamw);
  - 'bf16': the first moment stored in bf16 (optax.adamw with
    mu_dtype=bfloat16). As optax's scale_by_adam: b1 * mu is a bf16
    product (the decay rounded to bf16 first, as JAX's weak-typed scalar
    is), promoted to fp32 for the sum with (1 - b1) * g; the update uses
    that fp32 moment, which is then rounded to bf16 (nearest even) to be
    stored. That is the program optax traces, bit for bit; XLA's CPU
    compiler, under jit, skips the product's bf16 rounding;
  - 'int8': JAX `scale_by_adam_int8`, `AdamWInt8`: both moments stored
    as int8 codes with fp32 absmax scales per row (the JAX parameter's
    last dimension: head_dim for the port's fused wqkv, whose JAX wq, wk
    and wv end in d), mu quantised linearly, nu in the sqrt domain; then
    the same decayed weights and learning rate as AdamW.

`describe_optimizer_memory` gives the resident bytes by dtype, as JAX's
does over the optax state.

With config.host_offload_optimizer (JAX sharding.py:140-165, :255-292;
DeepSpeed's cpu_offload) every moment lives in host memory between
steps, pinned where the parameters are on the card, and the update
streams each parameter's moments to the parameter's device, runs the
same arithmetic there and copies them back (`_MomentStream`): the next
parameter's moments load on a side stream while this one updates, so at
most two parameters' moments are on the card at once. The count is a
host integer either way. On the CPU the copies go host to host; the
results are bitwise those of the moments kept beside the parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

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


def moment_form(config: Config) -> str:
    """The form of the Adam moments the config asks for: 'fp32', 'bf16'
    or 'int8'."""
    if config.adam_state_quantization == "int8":
        return "int8"
    return "bf16" if config.adam_mu_dtype == "bf16" else "fp32"


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    # The moments live in host memory (host_offload_optimizer).
    offloaded: bool = False
    # Per parameter, whether weight decay applies (AdamW.decay_of; None:
    # the mask of each tensor).
    decay: Optional[List[bool]] = None

    @property
    def form(self) -> str:
        return ("bf16" if self.mu and self.mu[0].dtype == torch.bfloat16
                else "fp32")

    def tensors(self) -> List[torch.Tensor]:
        return [*self.mu, *self.nu]

    def moment_lists(self) -> List[List[torch.Tensor]]:
        return [self.mu, self.nu]


@dataclasses.dataclass
class AdamInt8State:
    """JAX ScaleByAdamInt8State: int8 codes shaped like each parameter and
    fp32 scales, one per row of `rows[i]` elements along its last
    dimension ([*shape[:-1]] when the row is the whole last dimension,
    else [*shape[:-1], shape[-1] // row])."""

    count: int
    mu_codes: List[torch.Tensor]
    mu_scales: List[torch.Tensor]
    nu_codes: List[torch.Tensor]
    nu_scales: List[torch.Tensor]
    rows: List[int]
    # Per parameter, the process group its rows span on a mesh (a row
    # split over tensor-parallel or fsdp ranks): the row's absmax is
    # reduced over it, so the scales are the one-rank model's. None: no
    # parameter's rows are split.
    groups: Optional[List[Any]] = None
    offloaded: bool = False
    decay: Optional[List[bool]] = None
    form = "int8"

    def tensors(self) -> List[torch.Tensor]:
        return [*self.mu_codes, *self.mu_scales, *self.nu_codes,
                *self.nu_scales]

    def moment_lists(self) -> List[List[torch.Tensor]]:
        return [self.mu_codes, self.mu_scales, self.nu_codes,
                self.nu_scales]


def _zeros(p: torch.Tensor, dtype, offload: bool) -> torch.Tensor:
    """A zero moment for parameter p: beside it, or with `offload` in
    host memory (pinned where p is on the card), never on the card."""
    if not offload:
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device="cpu",
                       pin_memory=p.device.type == "cuda")


def _pinned_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Host tensor t, pinned where parameter p is on the card."""
    return t.pin_memory() if p.device.type == "cuda" else t


class _MomentStream:
    """One update's moments of an offloaded state on `device`, a
    parameter at a time: fetch(i) gives parameter i's moments there (the
    next parameter's then load on a side stream), store(i) copies them
    back into host memory, finish() waits for the last copies."""

    def __init__(self, lists, device: torch.device):
        self.lists, self.device = lists, device
        self.cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.ahead = None  # (i, tensors, event)

    def _load(self, i: int):
        if not self.cuda:
            return i, [lst[i].clone() for lst in self.lists], None
        with torch.cuda.stream(self.side):
            ts = [lst[i].to(self.device, non_blocking=True)
                  for lst in self.lists]
            ev = torch.cuda.Event()
            ev.record(self.side)
        return i, ts, ev

    def fetch(self, i: int) -> List[torch.Tensor]:
        got = self.ahead if self.ahead and self.ahead[0] == i else (
            self._load(i))
        _, ts, ev = got
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in ts:
                t.record_stream(cur)
        n = len(self.lists[0])
        self.ahead = self._load(i + 1) if i + 1 < n else None
        return ts

    def store(self, i: int, ts: List[torch.Tensor]) -> None:
        for lst, t in zip(self.lists, ts):
            lst[i].copy_(t, non_blocking=self.cuda)

    def finish(self) -> None:
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()


def _moments(state, params):
    """(fetch(i), store(i, tensors), finish()) over the state's moments:
    in place where they live beside the parameters, else streamed."""
    lists = state.moment_lists()
    if not getattr(state, "offloaded", False) or not params:
        return (lambda i: [lst[i] for lst in lists], lambda i, ts: None,
                lambda: None)
    stream = _MomentStream(lists, params[0].device)
    return stream.fetch, stream.store, stream.finish


def _bias_corrections(b1: float, b2: float, count: int):
    """1 - decay**count in fp32 (optax's count is an int32 array): at b2 =
    0.999 that is 1.3e-5 off the exact value, which moves every update by
    ~6e-6; computed as optax computes it."""
    return (float(1 - np.float32(b1) ** np.float32(count)),
            float(1 - np.float32(b2) ** np.float32(count)))


class AdamW:
    """optax.adamw over a list of parameters, applied in place; mu_dtype
    torch.bfloat16 stores the first moment in bf16."""

    form = "fp32"

    def __init__(self, learning_rate: Schedule, b1: float, b2: float,
                 eps: float, weight_decay: float,
                 mask: Callable[[torch.Tensor], bool] = _decay_mask,
                 mu_dtype: Optional[torch.dtype] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = mask
        self.mu_dtype = mu_dtype or torch.float32
        if self.mu_dtype == torch.bfloat16:
            self.form = "bf16"
            # JAX's weak-typed decay meets a bf16 moment as a bf16 value.
            self._b1_mu = torch.tensor(b1, dtype=torch.bfloat16)

    offload = False  # host_offload_optimizer: moments in host memory

    def init(self, params: Sequence[torch.Tensor],
             names: Optional[Sequence[str]] = None) -> AdamWState:
        off = self.offload
        return AdamWState(
            count=0, mu=[_zeros(p, self.mu_dtype, off) for p in params],
            nu=[_zeros(p, torch.float32, off) for p in params], offloaded=off,
            decay=self._decays(params, names))

    # decay_of(name, param): whether a named parameter decays (set by
    # make_optimizer for scanned layer stacks); None: mask(param).
    decay_of = None

    def _decays(self, params, names) -> Optional[List[bool]]:
        if self.decay_of is None or names is None:
            return None
        return [bool(self.decay_of(n, p)) for n, p in zip(names, params)]

    def _finish(self, p: torch.Tensor, update: torch.Tensor,
                lr: float, decay: Optional[bool] = None) -> None:
        """Decayed weights, then -lr, into the parameter in place."""
        if decay is None:
            decay = self.mask(p)
        if self.weight_decay and decay:
            update = update + self.weight_decay * p.float()
        p.add_(update.mul_(-lr).to(p.dtype))

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: AdamWState) -> float:
        """One update of every parameter in place; returns the learning
        rate it used, schedule(count)."""
        lr = self.learning_rate(state.count)
        count = state.count + 1
        bc1, bc2 = _bias_corrections(self.b1, self.b2, count)
        fetch, store, finish = _moments(state, params)
        for i, (p, g) in enumerate(zip(params, grads)):
            g = g.float()
            mu, nu = fetch(i)
            if mu.dtype == torch.float32:
                mu.mul_(self.b1).add_((1 - self.b1) * g)
                m32 = mu
            else:
                m32 = (1 - self.b1) * g + mu * self._b1_mu.to(mu.device)
            nu.mul_(self.b2).add_(torch.square(g).mul_(1 - self.b2))
            update = (m32 / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if m32 is not mu:
                mu.copy_(m32)  # rounded to bf16, nearest even
            self._finish(p, update, lr,
                         state.decay[i] if state.decay else None)
            store(i, (mu, nu))
        finish()
        state.count = count
        return lr


def _q8(x: torch.Tensor, row: int, group=None):
    """Row-wise absmax int8 codes and fp32 scales (JAX `_q8`) over rows of
    `row` elements along the last dimension; round half to even as
    jnp.round. `group`: the ranks holding the other pieces of each row
    (their absmax is the row's)."""
    shape = x.shape
    xr = x.reshape(*shape[:-1], shape[-1] // row, row)
    amax = xr.abs().amax(dim=-1)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    # The true quotient on the card too (ops/quantized.quantize_array).
    scale = amax / amax.new_tensor(127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(xr / safe[..., None]), -127, 127)
    if row == shape[-1]:
        scale = scale.reshape(shape[:-1])
    return codes.to(torch.int8).reshape(shape), scale


def _dq8(codes: torch.Tensor, scale: torch.Tensor, row: int):
    shape = codes.shape
    c = codes.reshape(*shape[:-1], shape[-1] // row, row).float()
    s = scale.reshape(*shape[:-1], shape[-1] // row)
    return (c * s[..., None]).reshape(shape)


class AdamWInt8(AdamW):
    """JAX scale_by_adam_int8 chained with add_decayed_weights (the decay
    mask) and the learning rate, as its make_optimizer chains them.
    `row_of(name, param)` gives a parameter's quantisation row (default:
    its last dimension)."""

    form = "int8"

    def __init__(self, *args, row_of: Optional[
            Callable[[Optional[str], torch.Tensor], int]] = None, **kw):
        super().__init__(*args, **kw)
        self.row_of = row_of or (lambda name, p: p.shape[-1])

    def init(self, params: Sequence[torch.Tensor],
             names: Optional[Sequence[str]] = None) -> AdamInt8State:
        names = list(names) if names is not None else [None] * len(params)
        rows = [int(self.row_of(n, p)) for n, p in zip(names, params)]

        off = self.offload

        def codes():
            return [_zeros(p, torch.int8, off) for p in params]

        def scales():
            out = []
            for p, r in zip(params, rows):
                s_ = _q8(_zeros(p, torch.float32, off), r)[1]
                out.append(_pinned_like(s_, p) if off else s_)
            return out

        return AdamInt8State(count=0, mu_codes=codes(), mu_scales=scales(),
                             nu_codes=codes(), nu_scales=scales(), rows=rows,
                             offloaded=off,
                             decay=self._decays(params, names))

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], state: AdamInt8State) -> float:
        lr = self.learning_rate(state.count)
        count = state.count + 1
        bc1, bc2 = _bias_corrections(self.b1, self.b2, count)
        b1, b2 = self.b1, self.b2
        fetch, store, finish = _moments(state, params)
        for i, (p, g) in enumerate(zip(params, grads)):
            row = state.rows[i]
            group = state.groups[i] if state.groups else None
            g = g.float()
            mu_c, mu_s, nu_c, nu_s = fetch(i)
            mu = b1 * _dq8(mu_c, mu_s, row) + ((1.0 - b1) * g)
            nu_sqrt = _dq8(nu_c, nu_s, row)
            nu = b2 * nu_sqrt * nu_sqrt + (1.0 - b2) * g * g
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            for codes, scales, x in ((mu_c, mu_s, mu),
                                     (nu_c, nu_s, torch.sqrt(nu))):
                c, s_ = _q8(x, row, group)
                codes.copy_(c)
                scales.copy_(s_)
            self._finish(p, update, lr,
                         state.decay[i] if state.decay else None)
            store(i, (mu_c, mu_s, nu_c, nu_s))
        finish()
        state.count = count
        return lr


# optax keeps two int32 counters beside the moments: scale_by_adam's (or
# scale_by_adam_int8's) count and the schedule's.
_OPTAX_COUNTERS = {"int32": 8}


def describe_optimizer_memory(opt_state) -> Dict[str, object]:
    """Resident bytes of the optimizer state by dtype (JAX
    describe_optimizer_memory over the optax state: the moments in their
    stored widths, int8 codes and their fp32 scales, and optax's two int32
    counters), largest first."""
    from luminaai_tpu_torch.monitoring.attribution import tree_bytes

    by_dtype: Dict[str, int] = dict(_OPTAX_COUNTERS)
    for t in opt_state.tensors():
        key = str(t.dtype).removeprefix("torch.")  # JAX's dtype names
        by_dtype[key] = by_dtype.get(key, 0) + tree_bytes([t])
    return {
        "total_bytes": sum(by_dtype.values()),
        "by_dtype": dict(sorted(by_dtype.items(), key=lambda kv: -kv[1])),
    }


def make_adam(form: str, schedule: Schedule, b1: float, b2: float,
              eps: float, weight_decay: float,
              row_of=None) -> AdamW:
    """The Adam of a moment form (moment_form)."""
    if form == "int8":
        return AdamWInt8(schedule, b1, b2, eps, weight_decay, row_of=row_of)
    return AdamW(schedule, b1, b2, eps, weight_decay,
                 mu_dtype=torch.bfloat16 if form == "bf16" else None)


def make_optimizer(
    config: Config,
    total_steps: int,
    schedule: Optional[Schedule] = None,
) -> AdamW:
    """AdamW with the config's schedule and moment form. Gradient clipping
    lives in the train step (it reports the pre-clip norm)."""
    if schedule is None:
        schedule = make_schedule(config, total_steps)
    d = config.head_dim()

    def row_of(name: Optional[str], p: torch.Tensor) -> int:
        # The fused wqkv [H, (nq + 2 nkv) d] is JAX's wq/wk/wv [H, n, d].
        if name is not None and name.endswith("attention.wqkv"):
            return d
        return p.shape[-1]

    tx = make_adam(moment_form(config), schedule, config.beta1,
                   config.beta2, config.eps, config.weight_decay,
                   row_of=row_of)
    tx.offload = bool(config.host_offload_optimizer)
    if config.scan_layers:
        # JAX's decay mask (ndim >= 2) meets the scanned tree's stacked
        # layer parameters, whose leading layer axis makes every one of
        # them (norm scales, MoD bias) a decayed matrix.
        tx.decay_of = lambda name, p: p.ndim >= 2 or name.startswith(
            "layers.")
    return tx
